"""Anchor generation: plain functions, fixed shapes.

Port of ``vltk_tpu/models/anchors.py``. The table is built in numpy (the
same float32 arithmetic as the reference) and handed over as a tensor.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """(A, 4) xyxy anchors centred at the origin: size-major, ratio-minor,
    w = sqrt(area/ar), h = ar*w."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(
    feat_hw: Tuple[int, int],
    stride: int = 16,
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    offset: float = 0.0,
    device=None,
) -> torch.Tensor:
    """(H*W*A, 4) anchors for one feature map, ordered (y, x, anchor) to
    line up with the NHWC flatten of the RPN outputs."""
    h, w = feat_hw
    base = cell_anchors(sizes, aspect_ratios)  # (A, 4)
    shifts_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # (H, W) each, row-major in y
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    anchors = (shifts + base[None]).reshape(-1, 4)
    return torch.from_numpy(np.ascontiguousarray(anchors)).to(device)
