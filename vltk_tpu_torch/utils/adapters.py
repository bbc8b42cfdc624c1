"""Adapter-side helpers: copies of ``pad_tensor``, ``truncate_and_pad_list``,
``rescale_box``, ``normalize_boxes_xyxy``, ``clean_label``, ``soft_score``
and ``basic_coco_annotations`` from ``vltk_tpu/utils/adapters.py``. The
answer tables ``clean_label`` reads are the port's own copies."""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

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
