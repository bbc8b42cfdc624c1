"""A raw COCO-2014 + VQA v2 corpus drawn from a seed, laid out as the
adapters read the real one:

    {datadir}/coco2014/annotations/instances_train2014.json
    {datadir}/coco2014/train/COCO_train2014_000000000000.jpg ...
    {datadir}/vqa/train/v2_OpenEnded_mscoco_train2014_questions.json
    {datadir}/vqa/train/v2_mscoco_train2014_annotations.json

Images are blocks of 16 x 16 pixels of one random colour (so JPEG keeps
them small and the detector sees edges); every image has one to three
instances of three categories; question q is about image q % n_images and
its multiple-choice answer is ``answers[q % len(answers)]``, with 10
annotator answers of which three to ten agree (the rest another answer of
the set), so every answer clears the VQA adapter's minimum frequency when
``n_questions >= 10 * len(answers)``. With ``shapes="polygons"`` each
instance is a convex polygon of 6 to 10 vertices inside its box (the box
is its bounding box) instead of the box's rectangle.

The writers of the other raw layouts the adapters read, each drawn from
its own seed:

* ``write_funsd``: FUNSD forms, ``{datadir}/funsd/annotations/*.json``;
* ``write_docvqa``: DocVQA OCR results,
  ``{datadir}/docvqavisn/annotations/{doc}.json``, and questions,
  ``{datadir}/docvqa/docvqa_{split}.json``, each answer a run of the
  document's words;
* ``write_gqa``: Visual Genome images, ``{datadir}/visualgenome/{split}/
  {id}.jpg``, and GQA questions, ``{datadir}/gqa/{split}_balanced_questions
  .json``; ``write_vgqa``: VGQA questions over the same images;
* ``write_clevrref``: CLEVR-ref+ scenes with (start, run) point-run masks
  and their PNG images (``{datadir}/clevrref/...``), and the same scenes
  as CLEVR scenes with pixel coordinates (``{datadir}/clevr/...``);
* ``write_cococaptions``: COCO captions of ``write_corpus``' images.

OCR words are whole words of the port's BERT vocabulary, some with a
``##`` suffix glued on (two or more sub-tokens), some capitalised.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from PIL import Image

from vltk_tpu_torch import vars as V

CATEGORIES = ({"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}, {"id": 3, "name": "traffic light"})
ANSWERS = ("yes", "no", "2", "red")


def block_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 of 16 x 16 blocks of one random colour each."""
    blocks = rng.integers(0, 256, (-(-h // 16), -(-w // 16), 3), dtype=np.uint8)
    return np.repeat(np.repeat(blocks, 16, axis=0), 16, axis=1)[:h, :w]


def _convex_polygon(rng: np.random.Generator, x0: float, y0: float, bw: float, bh: float) -> List[float]:
    """A flat xy list of 6-10 vertices on the ellipse inscribed in the box."""
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, int(rng.integers(6, 11))))
    xs = x0 + bw / 2 * (1 + np.cos(angles))
    ys = y0 + bh / 2 * (1 + np.sin(angles))
    return [round(float(v), 2) for xy in zip(xs, ys) for v in xy]


def write_corpus(datadir: str, n_images: int = 64, n_questions: int = 512, hw: Tuple[int, int] = (480, 640),
                 seed: int = 0, answers: Sequence[str] = ANSWERS, img_format: str = "jpg",
                 shapes: str = "boxes") -> str:
    """Write the corpus under ``datadir``; returns ``datadir``."""
    if shapes not in ("boxes", "polygons"):
        raise ValueError(f"shapes must be 'boxes' or 'polygons', not {shapes!r}")
    rng = np.random.default_rng(seed)
    h, w = hw
    ann_dir = os.path.join(datadir, "coco2014", "annotations")
    img_dir = os.path.join(datadir, "coco2014", "train")
    vqa_dir = os.path.join(datadir, "vqa", "train")
    for d in (ann_dir, img_dir, vqa_dir):
        os.makedirs(d, exist_ok=True)

    images, instances = [], []
    for i in range(n_images):
        name = f"COCO_train2014_{i:012d}.{img_format}"
        Image.fromarray(block_image(rng, h, w)).save(os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = float(rng.integers(0, w // 2)), float(rng.integers(0, h // 2))
            bw, bh = float(rng.integers(8, w // 2)), float(rng.integers(8, h // 2))
            category = int(rng.integers(1, len(CATEGORIES) + 1))
            if shapes == "polygons":
                poly = _convex_polygon(rng, x0, y0, bw, bh)
                xs, ys = poly[0::2], poly[1::2]
                bbox = [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]
            else:
                poly = [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]
                bbox = [x0, y0, bw, bh]
            instances.append({
                "id": len(instances), "image_id": i, "bbox": bbox, "category_id": category,
                "segmentation": [poly], "area": bbox[2] * bbox[3], "iscrowd": 0,
            })
    with open(os.path.join(ann_dir, "instances_train2014.json"), "w") as f:
        json.dump({"images": images, "annotations": instances, "categories": list(CATEGORIES)}, f)

    questions, annotations = [], []
    for q in range(n_questions):
        main = answers[q % len(answers)]
        other = answers[(q + 1 + int(rng.integers(0, len(answers) - 1))) % len(answers)]
        agree = int(rng.integers(3, 11))
        questions.append({"question_id": q, "image_id": q % n_images,
                          "question": f"What is the colour of object {q} near the {CATEGORIES[q % 3]['name']}?"})
        annotations.append({
            "question_id": q, "image_id": q % n_images, "multiple_choice_answer": main,
            "answers": [{"answer": main}] * agree + [{"answer": other}] * (10 - agree),
        })
    with open(os.path.join(vqa_dir, "v2_OpenEnded_mscoco_train2014_questions.json"), "w") as f:
        json.dump({"questions": questions}, f)
    with open(os.path.join(vqa_dir, "v2_mscoco_train2014_annotations.json"), "w") as f:
        json.dump({"annotations": annotations}, f)
    return datadir


# ----------------------------------------------------------------- OCR words

FORM_LABELS = ("question", "answer", "header", "other")
_WORDS: Dict[str, List[str]] = {}


def _vocab_words() -> Tuple[List[str], List[str]]:
    """(whole ASCII words of 2+ letters, ## suffixes) of the BERT vocabulary."""
    if not _WORDS:
        with open(V.VOCABPATH, encoding="utf-8") as f:
            vocab = [line.strip() for line in f]
        _WORDS["whole"] = [t for t in vocab if t.isascii() and t.isalpha() and len(t) >= 2]
        _WORDS["suffix"] = [t[2:] for t in vocab if t.startswith("##") and t[2:].isascii() and t[2:].isalpha()]
    return _WORDS["whole"], _WORDS["suffix"]


def ocr_words(rng: np.random.Generator, n: int) -> List[str]:
    """``n`` words: a whole vocabulary word, with a suffix glued on 30% of
    the time, capitalised 20% of the time."""
    whole, suffix = _vocab_words()
    out = []
    for _ in range(n):
        word = whole[int(rng.integers(len(whole)))]
        if rng.random() < 0.3:
            word += suffix[int(rng.integers(len(suffix)))]
        if rng.random() < 0.2:
            word = word.capitalize()
        out.append(word)
    return out


def _layout(words: Sequence[str], page_hw: Tuple[int, int], line_h: int = 20) -> List[List[int]]:
    """xyxy pixel boxes of ``words`` set in lines across the page (6 px a
    character, 4 px between words), wrapping at the right margin."""
    h, w = page_hw
    boxes, x, y = [], 10, 10
    for word in words:
        width = 6 * len(word) + 2
        if x + width > w - 10:
            x, y = 10, y + line_h
        boxes.append([x, y, x + width, min(y + line_h - 6, h - 1)])
        x += width + 4
    return boxes


def _write_json(path: str, payload) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)


def write_funsd(datadir: str, n_forms: int = 64, n_words: int = 780, seed: int = 0,
                page_hw: Tuple[int, int] = (1000, 762)) -> str:
    """FUNSD forms of ``n_words`` words each, in entities of 1-8 words with
    a label of ``FORM_LABELS`` ("header" becomes "other" in the adapter),
    word boxes xyxy in pixels of a ``page_hw`` page."""
    rng = np.random.default_rng(seed)
    for f in range(n_forms):
        words = ocr_words(rng, n_words)
        boxes = _layout(words, page_hw)
        form, i = [], 0
        while i < n_words:
            k = min(int(rng.integers(1, 9)), n_words - i)
            label = FORM_LABELS[int(rng.integers(len(FORM_LABELS)))]
            entity = [{"text": words[j], "box": boxes[j]} for j in range(i, i + k)]
            xs = [b["box"] for b in entity]
            form.append({"id": len(form), "label": label, "words": entity,
                         "text": " ".join(words[i : i + k]),
                         "box": [min(b[0] for b in xs), min(b[1] for b in xs), max(b[2] for b in xs),
                                 max(b[3] for b in xs)], "linking": []})
            i += k
        _write_json(os.path.join(datadir, "funsd", V.ANNOTATION_DIR, f"form_{f:04d}.json"), {"form": form})
    return datadir


def _eight_point(box: Sequence[int], skew: int) -> List[int]:
    """An xyxy box as Azure's 8-point polygon, the right edge ``skew`` px
    lower (a slightly rotated scan)."""
    x0, y0, x1, y1 = box
    return [x0, y0, x1, y0 + skew, x1, y1 + skew, x0, y1]


def write_docvqa(datadir: str, n_docs: int = 64, n_words: int = 700, questions_per_doc: int = 2, seed: int = 0,
                 split: str = "train", page_hw: Tuple[int, int] = (1000, 900)) -> str:
    """DocVQA: one OCR result a document (lines of up to 12 words, 8-point
    boxes, a skew of 0-2 px), and ``questions_per_doc`` questions a
    document whose answer is a run of 1-3 of its words (lowercased)."""
    rng = np.random.default_rng(seed)
    questions = []
    for d in range(n_docs):
        words = ocr_words(rng, n_words)
        boxes = _layout(words, page_hw)
        lines, i = [], 0
        while i < n_words:
            # a line ends after 12 words or where the layout wrapped
            j = i + 1
            while j < n_words and j - i < 12 and boxes[j][1] == boxes[i][1]:
                j += 1
            skew = int(rng.integers(0, 3))
            words_of_line = [{"boundingBox": _eight_point(boxes[k], skew), "text": words[k], "confidence": "High"}
                             for k in range(i, j)]
            line_box = [boxes[i][0], boxes[i][1], boxes[j - 1][2], boxes[i][3]]
            lines.append({"boundingBox": _eight_point(line_box, skew), "text": " ".join(words[i:j]),
                          "words": words_of_line})
            i = j
        doc = f"doc_{d:04d}"
        _write_json(os.path.join(datadir, "docvqavisn", V.ANNOTATION_DIR, f"{doc}.json"), {
            "status": "Succeeded",
            "recognitionResults": [{"page": 1, "clockwiseOrientation": 0.0, "width": page_hw[1],
                                    "height": page_hw[0], "unit": "pixel", "lines": lines}],
        })
        for q in range(questions_per_doc):
            k = int(rng.integers(1, 4))
            start = int(rng.integers(0, n_words - k))
            answer = " ".join(words[start : start + k]).lower()
            questions.append({"questionId": len(questions), "question": f"What is written after \"{words[start - 1]}\"?",
                              "image": f"documents/{doc}.png", "docId": d, "answers": [answer],
                              "data_split": split})
    _write_json(os.path.join(datadir, "docvqa", f"docvqa_{split}.json"), {"dataset_split": split, "data": questions})
    return datadir


# ------------------------------------------------------------ Visual Genome

GQA_ANSWERS = ("yes", "no", "left", "right", "white", "man", "table", "2")
GQA_OPERATIONS = ("select", "relate", "filter color", "query name", "verify", "choose rel", "exist")


def vg_ids(n_images: int) -> List[int]:
    """Visual Genome image ids of the synthetic images."""
    return [2354000 + i for i in range(n_images)]


def write_gqa(datadir: str, n_images: int = 64, n_questions: int = 512, hw: Tuple[int, int] = (480, 640),
              seed: int = 0, split: str = "train", answers: Sequence[str] = GQA_ANSWERS) -> str:
    """``n_images`` JPEGs under ``visualgenome/{split}`` (blocks of colour,
    as ``write_corpus``' images) and GQA's balanced questions of ``split``:
    question q is about image q % n_images, its answer
    ``answers[q % len(answers)]``, its program 2-4 operations; half the
    image ids carry GQA's "n" prefix."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img_dir = os.path.join(datadir, "visualgenome", split)
    os.makedirs(img_dir, exist_ok=True)
    ids = vg_ids(n_images)
    for vgid in ids:
        Image.fromarray(block_image(rng, h, w)).save(os.path.join(img_dir, f"{vgid}.jpg"))
    data = {}
    for q in range(n_questions):
        vgid = ids[q % n_images]
        ops = [GQA_OPERATIONS[int(i)] for i in rng.integers(0, len(GQA_OPERATIONS), int(rng.integers(2, 5)))]
        answer = answers[q % len(answers)]
        data[str(20000000 + q)] = {
            "imageId": ("n" if q % 2 else "") + str(vgid),
            "question": f"Is the {GQA_OPERATIONS[q % len(GQA_OPERATIONS)].split()[0]}ed object {q % 7} on the left?",
            "answer": answer, "fullAnswer": f"The answer is {answer}.", "isBalanced": True,
            "semantic": [{"operation": op, "argument": str(k), "dependencies": list(range(k))}
                         for k, op in enumerate(ops)],
        }
    _write_json(os.path.join(datadir, "gqa", f"{split}_balanced_questions.json"), data)
    return datadir


def write_vgqa(datadir: str, n_images: int = 64, n_questions: int = 256, seed: int = 0,
               answers: Sequence[str] = GQA_ANSWERS) -> str:
    """VGQA's ``qa_train.json`` over ``write_gqa``'s image ids: one group an
    image; answers cycle through ``answers`` except every 16th, which is
    rare and dropped at the adapter's minimum frequency."""
    rng = np.random.default_rng(seed)
    ids = vg_ids(n_images)
    groups = [{"id": vgid, "qas": []} for vgid in ids]
    for q in range(n_questions):
        answer = f"rare {q}" if q % 16 == 15 else answers[q % len(answers)]
        groups[q % n_images]["qas"].append({
            "qa_id": 900000 + q, "image_id": ids[q % n_images], "answer": answer,
            "question": f"What is next to object {int(rng.integers(0, 50))}?",
        })
    _write_json(os.path.join(datadir, "vgqa", "qa_train.json"), groups)
    return datadir


# ------------------------------------------------------------------- CLEVR

CLEVR_ATTRS = {"color": ("gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow"),
               "shape": ("cube", "sphere", "cylinder"), "size": ("large", "small"),
               "material": ("rubber", "metal")}


def _ellipse_runs(x0: int, y0: int, bw: int, bh: int, w: int) -> List[int]:
    """(start, run) pairs, row-major over a width-``w`` image, of the
    ellipse inscribed in the box."""
    out = []
    cy, cx, ry, rx = y0 + bh / 2, x0 + bw / 2, bh / 2, bw / 2
    for y in range(y0, y0 + bh):
        t = 1 - ((y + 0.5 - cy) / ry) ** 2
        if t <= 0:
            continue
        half = rx * t ** 0.5
        a, b = int(np.ceil(cx - half)), int(np.floor(cx + half))
        if b > a:
            out += [y * w + a, b - a]
    return out


def write_clevrref(datadir: str, n_images: int = 8, hw: Tuple[int, int] = (320, 480), seed: int = 0,
                   split: str = "train", max_objects: int = 10) -> str:
    """CLEVR-ref+ scenes of 3 to ``max_objects`` objects (their attributes,
    boxes xywh and elliptic masks as "start,run,..." strings over the
    row-major raw image) and their PNGs under ``clevrref/{split}``; the same
    scenes as CLEVR scenes (pixel coordinates of each object's centre and a
    depth) under ``clevr/annotations``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    img_dir = os.path.join(datadir, "clevrref", split)
    os.makedirs(img_dir, exist_ok=True)
    ref_scenes, scenes = [], []
    for i in range(n_images):
        name = f"CLEVR_{split}_{i:06d}.png"
        Image.fromarray(block_image(rng, h, w)).save(os.path.join(img_dir, name))
        objects, bboxes, masks = [], {}, {}
        for k in range(int(rng.integers(3, max_objects + 1))):
            bw, bh = int(rng.integers(w // 10 + 4, w // 3 + 5)), int(rng.integers(h // 10 + 4, h // 3 + 5))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            obj = {a: vals[int(rng.integers(len(vals)))] for a, vals in CLEVR_ATTRS.items()}
            obj["pixel_coords"] = [x0 + bw / 2, y0 + bh / 2, round(float(rng.uniform(5, 15)), 3)]
            objects.append(obj)
            bboxes[str(k + 1)] = [x0, y0, bw, bh]
            masks[str(k + 1)] = ",".join(str(v) for v in _ellipse_runs(x0, y0, bw, bh, w))
        ref_scenes.append({"image_index": i, "image_filename": name, "split": split, "objects": objects,
                           "obj_bbox": bboxes, "obj_mask": masks})
        scenes.append({"image_index": i, "image_filename": name, "split": split, "objects": objects})
    _write_json(os.path.join(datadir, "clevrref", V.ANNOTATION_DIR, f"clevr_ref+_{split}_scenes.json"),
                {"scenes": ref_scenes})
    _write_json(os.path.join(datadir, "clevr", V.ANNOTATION_DIR, f"CLEVR_{split}_scenes.json"), {"scenes": scenes})
    return datadir


def write_cococaptions(datadir: str, n_images: int = 64, per_image: int = 5, seed: int = 0) -> str:
    """COCO captions (``captions_train2014.json``) of ``write_corpus``'
    images, ``per_image`` a image."""
    rng = np.random.default_rng(seed)
    images = [{"id": i, "file_name": f"COCO_train2014_{i:012d}.jpg"} for i in range(n_images)]
    annotations = []
    for i in range(n_images):
        for _ in range(per_image):
            words = " ".join(ocr_words(rng, int(rng.integers(6, 14)))).lower()
            annotations.append({"id": len(annotations), "image_id": i, "caption": f"a {words}."})
    _write_json(os.path.join(datadir, "cococaptions", "captions_train2014.json"),
                {"images": images, "annotations": annotations})
    return datadir
