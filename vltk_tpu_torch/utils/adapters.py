"""List and box helpers of the OCR chain and the LXMERT experiments: copies
of ``truncate_and_pad_list``, ``rescale_box`` and ``normalize_boxes_xyxy``
from ``vltk_tpu/utils/adapters.py``."""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


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
