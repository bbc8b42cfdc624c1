"""List and box helpers of the OCR chain: copies of ``truncate_and_pad_list``
and ``rescale_box`` from ``vltk_tpu/utils/adapters.py``."""

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
