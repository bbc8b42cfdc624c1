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
``n_questions >= 10 * len(answers)``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

CATEGORIES = ({"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}, {"id": 3, "name": "traffic light"})
ANSWERS = ("yes", "no", "2", "red")


def write_corpus(datadir: str, n_images: int = 64, n_questions: int = 512, hw: Tuple[int, int] = (480, 640),
                 seed: int = 0, answers: Sequence[str] = ANSWERS, img_format: str = "jpg") -> str:
    """Write the corpus under ``datadir``; returns ``datadir``."""
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
        blocks = rng.integers(0, 256, (-(-h // 16), -(-w // 16), 3), dtype=np.uint8)
        pixels = np.repeat(np.repeat(blocks, 16, axis=0), 16, axis=1)[:h, :w]
        Image.fromarray(pixels).save(os.path.join(img_dir, name))
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = float(rng.integers(0, w // 2)), float(rng.integers(0, h // 2))
            bw, bh = float(rng.integers(8, w // 2)), float(rng.integers(8, h // 2))
            instances.append({
                "id": len(instances), "image_id": i, "bbox": [x0, y0, bw, bh],
                "category_id": int(rng.integers(1, len(CATEGORIES) + 1)),
                "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]],
                "area": bw * bh, "iscrowd": 0,
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
