"""Adapter-side helpers: the port's copy of ``vltk_tpu/utils/adapters.py``.

Padding (``pad_tensor``, ``truncate_and_pad_list``); segmentation -> mask
(``polygon_to_mask``, ``seg_to_mask``, ``rle_decode``, ``rle_encode``,
``imagepoints_to_mask``, ``resize_binary_mask``); boxes (``rescale_box``,
``normalize_boxes_xyxy``, ``xywh_to_xyxy``, ``xyxy_to_xywh``); VQA answer
normalisation (``clean_label``, ``soft_score``; the answer tables are the
port's own copies); DocVQA span grounding (``get_span_via_jaccard``); OCR
prediction aggregation (``map_ocr_predictions``); the COCO annotation
forward (``basic_coco_annotations``); ``histogram_from_counter``.

The three decoders run the native library (``native/src/maskops.cpp``,
the JAX package's source) and raise when it cannot be built. Their NumPy /
PIL versions (``rle_decode_plain``, ``imagepoints_to_mask_plain``,
``polygon_to_mask_plain``) are the plain versions the tests hold them
against: the first two equal the native ones bit for bit, the PIL polygon
fill agrees up to boundary pixels.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image, ImageDraw

from vltk_tpu_torch import vars as V


def pad_tensor(arr: np.ndarray, max_len: int, value: float = 0.0, axis: int = 0) -> np.ndarray:
    """``arr`` padded with ``value`` (or truncated) along ``axis`` to
    exactly ``max_len``; returned as it is when it already fits."""
    arr = np.asarray(arr)
    cur = arr.shape[axis]
    if cur == max_len:
        return arr
    if cur > max_len:
        slicer = [slice(None)] * arr.ndim
        slicer[axis] = slice(0, max_len)
        return arr[tuple(slicer)]
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, max_len - cur)
    return np.pad(arr, pad_width, constant_values=value)


def truncate_and_pad_list(lst: Sequence, max_len: int, value: Any = 0) -> List:
    lst = list(lst)[:max_len]
    return lst + [value] * (max_len - len(lst))


# segmentation -> mask


def polygon_to_mask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """COCO polygons (flat xy lists) -> (h, w) uint8 mask: the native
    scanline fill at pixel centres plus each edge's outline."""
    from vltk_tpu_torch.native import masks

    return masks.polygons_fill(polygons, int(height), int(width))


def polygon_to_mask_plain(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """PIL's outline + fill of the same polygons: equal to
    ``polygon_to_mask`` up to boundary pixels."""
    img = Image.new("L", (int(width), int(height)), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(float(poly[i]), float(poly[i + 1])) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=np.uint8)


def seg_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """Polygons, or an uncompressed RLE dict ({counts, size}), -> (h, w)
    uint8 mask; a compressed RLE string raises."""
    if isinstance(segmentation, dict):
        counts = segmentation.get("counts")
        h, w = segmentation.get("size", (height, width))
        if isinstance(counts, list):
            return rle_decode(counts, int(h), int(w))
        raise ValueError("compressed RLE strings are not supported host-side yet")
    return polygon_to_mask(segmentation, height, width)


def rle_decode(counts: Sequence[int], height: int, width: int) -> np.ndarray:
    """Uncompressed COCO RLE (column-major run lengths, zeros first) ->
    (h, w) uint8 mask (native)."""
    from vltk_tpu_torch.native import masks

    return masks.rle_decode(counts, int(height), int(width))


def rle_decode_plain(counts: Sequence[int], height: int, width: int) -> np.ndarray:
    """``rle_decode`` in numpy. A negative count is a zero-length run that
    still toggles, as in the native decoder."""
    flat = np.zeros(height * width, dtype=np.uint8)
    pos = 0
    val = 0
    for run in counts:
        run = max(int(run), 0)
        if val:
            flat[pos : pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((width, height)).T


def rle_encode(mask: np.ndarray) -> List[int]:
    """Inverse of ``rle_decode``: column-major uncompressed counts."""
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)
    changes = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate(([0], changes, [flat.size])))
    if flat.size and flat[0] == 1:
        runs = np.concatenate(([0], runs))
    return runs.astype(int).tolist()


def imagepoints_to_mask(points: Sequence[float], size: Tuple[int, int]) -> np.ndarray:
    """CLEVR-ref (start, run) pairs over the flattened row-major mask ->
    (h, w) uint8 mask (native)."""
    from vltk_tpu_torch.native import masks

    return masks.points_decode(points, int(size[0]), int(size[1]))


def imagepoints_to_mask_plain(points: Sequence[float], size: Tuple[int, int]) -> np.ndarray:
    """``imagepoints_to_mask`` in numpy: a negative start clamps to 0, a
    run of at most 0 is skipped, as in the native decoder."""
    h, w = int(size[0]), int(size[1])
    flat = np.zeros(h * w, dtype=np.uint8)
    pts = list(points)
    for i in range(0, len(pts) - 1, 2):
        start, run = max(int(pts[i]), 0), int(pts[i + 1])
        if run <= 0:
            continue
        flat[start : start + run] = 1
    return flat.reshape((h, w))


def resize_binary_mask(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of a binary mask to (h, w) (PIL)."""
    h, w = int(size[0]), int(size[1])
    img = Image.fromarray((np.asarray(mask) > 0).astype(np.uint8) * 255)
    img = img.resize((w, h), resample=Image.NEAREST)
    return (np.asarray(img) > 127).astype(np.uint8)


# boxes


def rescale_box(boxes: np.ndarray, wh_scale: Sequence[float]) -> np.ndarray:
    """Scale boxes by per-axis (w_scale, h_scale): x by the first, y by the
    second."""
    boxes = np.asarray(boxes, dtype=np.float32).copy()
    if boxes.size == 0:
        return boxes
    sw, sh = float(wh_scale[0]), float(wh_scale[1])
    boxes[..., 0] *= sw
    boxes[..., 2] *= sw
    boxes[..., 1] *= sh
    boxes[..., 3] *= sh
    return boxes


def normalize_boxes_xyxy(boxes, rawsize_hw) -> np.ndarray:
    """Raw-pixel xyxy boxes (N, D, 4) -> [0, 1] by each row's raw extent
    ``rawsize_hw`` (N, 2) as (h, w), at least 1 pixel: the LXMERT position
    convention."""
    hw = np.asarray(rawsize_hw, np.float32)
    wh = np.maximum(hw[:, [1, 0, 1, 0]], 1.0)
    return np.clip(np.asarray(boxes, np.float32) / wh[:, None, :], 0.0, 1.0)


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, dtype=np.float32)
    out = boxes.copy()
    out[..., 2] = boxes[..., 0] + boxes[..., 2]
    out[..., 3] = boxes[..., 1] + boxes[..., 3]
    return out


def xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, dtype=np.float32)
    out = boxes.copy()
    out[..., 2] = boxes[..., 2] - boxes[..., 0]
    out[..., 3] = boxes[..., 3] - boxes[..., 1]
    return out


# VQA answer normalisation
_LABEL_MAPS: Optional[Tuple[Dict[str, str], Dict[str, str]]] = None
_PUNCT_RE = re.compile(r"[\.\?\!\,\*#:;'\"\(\)\[\]/\\]")
_ARTICLE_RE = re.compile(r"\b(a|an|the)\b")


def _label_maps() -> Tuple[Dict[str, str], Dict[str, str]]:
    global _LABEL_MAPS
    if _LABEL_MAPS is None:
        with open(os.path.join(V.LIBDATA, "contractions.json")) as f:
            contractions = json.load(f)
        with open(os.path.join(V.LIBDATA, "convert_answers.json")) as f:
            answers = json.load(f)
        _LABEL_MAPS = (contractions, answers)
    return _LABEL_MAPS


def clean_label(answer: str) -> str:
    """A free-form VQA answer lowercased, without punctuation and articles,
    number words and contractions mapped."""
    contractions, answer_map = _label_maps()
    ans = _ARTICLE_RE.sub("", _PUNCT_RE.sub("", answer.lower().strip()))
    words = [contractions.get(answer_map.get(w, w), answer_map.get(w, w)) for w in ans.split()]
    return " ".join(words).strip()


def soft_score(occurrences: int) -> float:
    """VQA soft accuracy of an answer given by ``occurrences`` annotators."""
    return {0: 0.0, 1: 0.3, 2: 0.6, 3: 0.9}.get(occurrences, 1.0)


def basic_coco_annotations(
    json_files: Union[Mapping[str, Dict], Iterable[Tuple[str, Dict]]],
) -> List[Dict[str, Any]]:
    """COCO-format instances -> one {imgid, boxes, poly, labels} entry per
    image. Image ids are the file-name stems, so they join with VQA's
    adjusted ids and the image files; RLE instances get no polygon."""
    if isinstance(json_files, Mapping):
        json_files = json_files.items()
    entries: Dict[str, Dict[str, Any]] = {}
    for _fname, data in json_files:
        if data is None:
            continue
        categories = {c["id"]: c["name"] for c in data.get("categories", [])}
        id_to_stem = {
            i["id"]: os.path.splitext(i["file_name"])[0] for i in data.get("images", []) if "file_name" in i
        }
        for ann in data.get("annotations", []):
            imgid = str(id_to_stem.get(ann["image_id"], ann["image_id"]))
            entry = entries.setdefault(imgid, {V.imgid: imgid, V.boxes: [], V.polygons: [], V.labels: []})
            entry[V.boxes].append([float(x) for x in ann.get("bbox", (0, 0, 0, 0))])
            seg = ann.get("segmentation") or []
            if isinstance(seg, dict):
                seg = []
            entry[V.polygons].append([[float(p) for p in poly] for poly in seg])
            entry[V.labels].append(categories.get(ann.get("category_id"), "unknown"))
    return list(entries.values())


# DocVQA answers -> OCR word spans


def _jaccard(a: str, b: str) -> float:
    sa, sb = set(a), set(b)
    if not sa and not sb:
        return 1.0
    union = len(sa | sb)
    return len(sa & sb) / union if union else 0.0


def get_span_via_jaccard(
    words: Sequence[str], answer: str, threshold: float = 0.56
) -> Tuple[Optional[Tuple[int, int]], float]:
    """The inclusive (start, end) word span whose concatenation best matches
    ``answer``: character-set Jaccard times the square root of the length
    ratio, over spans of at most the answer's word count + 2; the first
    span of the best score wins. Returns (span or None below ``threshold``,
    the best score)."""
    answer_norm = answer.lower().replace(" ", "")
    n = len(words)
    if n == 0 or not answer_norm:
        return None, 0.0
    ans_words = max(1, len(answer.split()))
    best: Tuple[float, Optional[Tuple[int, int]]] = (0.0, None)
    max_span = min(n, ans_words + 2)
    for start in range(n):
        joined = ""
        for end in range(start, min(n, start + max_span)):
            joined += str(words[end]).lower().replace(" ", "")
            sim = _jaccard(joined, answer_norm)
            len_ratio = min(len(joined), len(answer_norm)) / max(len(joined), len(answer_norm), 1)
            sim *= len_ratio ** 0.5
            if sim > best[0]:
                best = (sim, (start, end))
    if best[0] < threshold:
        return None, best[0]
    return best[1], best[0]


# OCR prediction aggregation


def map_ocr_predictions(
    predictions: Sequence[int],
    tokenmap: Sequence[int],
    mode: str = "majority",
    ignore_id: int = -100,
) -> List[int]:
    """Sub-token predictions -> one a word, through the word -> sub-token
    count map: the majority (ties: the first seen) or the first sub-token's
    (``mode="first"``). A word of zero sub-tokens gives ``ignore_id``, so the
    output stays aligned with the words; the map's padding (``ignore_id``)
    ends it."""
    out: List[int] = []
    idx = 0
    for n_sub in tokenmap:
        n_sub = int(n_sub)
        if n_sub == ignore_id:
            break
        if n_sub <= 0:
            out.append(ignore_id)
            continue
        chunk = list(predictions[idx : idx + n_sub])
        idx += n_sub
        if not chunk:
            break
        if mode == "first":
            out.append(chunk[0])
        else:
            out.append(Counter(chunk).most_common(1)[0][0])
    return out


def histogram_from_counter(counter: Counter, top_k: int = 30) -> str:
    """ASCII bars of the ``top_k`` most common labels, longest 40 wide."""
    items = counter.most_common(top_k)
    if not items:
        return "(empty)"
    peak = max(v for _, v in items)
    lines = []
    for name, count in items:
        bar = "#" * max(1, int(40 * count / peak))
        lines.append(f"{str(name)[:24]:>24} | {bar} {count}")
    return "\n".join(lines)
