"""Box algebra on tensors: xyxy convention, batched, fixed shapes.

Port of ``vltk_tpu/ops/boxes.py``; each function keeps the reference's
operation order so float32 results round the same way.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# clamp such that exp(dw) maps a 16px anchor to at most ~1000px
DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def apply_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    scale_clamp: float = DEFAULT_SCALE_CLAMP,
) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas against xyxy ``boxes``.

    deltas: (..., K*4) — K class-specific transforms per box.
    boxes:  (..., 4).
    Returns (..., K*4) decoded xyxy boxes.
    """
    boxes = boxes.to(deltas.dtype)
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = torch.clamp(deltas[..., 2::4] / ww, max=scale_clamp)
    dh = torch.clamp(deltas[..., 3::4] / wh, max=scale_clamp)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w,
            pred_ctr_y + 0.5 * pred_h,
        ],
        dim=-1,
    )  # (..., K, 4)
    return out.reshape(deltas.shape)


def encode_deltas(
    src: torch.Tensor,
    target: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Inverse of :func:`apply_deltas`."""
    sw = src[..., 2] - src[..., 0]
    sh = src[..., 3] - src[..., 1]
    scx = src[..., 0] + 0.5 * sw
    scy = src[..., 1] + 0.5 * sh
    tw = target[..., 2] - target[..., 0]
    th = target[..., 3] - target[..., 1]
    tcx = target[..., 0] + 0.5 * tw
    tcy = target[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    return torch.stack(
        [
            wx * (tcx - scx) / sw,
            wy * (tcy - scy) / sh,
            ww * torch.log(tw / sw),
            wh * torch.log(th / sh),
        ],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, size_hw: torch.Tensor) -> torch.Tensor:
    """Clamp xyxy boxes into [0, w] x [0, h]. ``size_hw`` is (..., 2) and
    broadcasts against the box batch dims minus the last box axis, e.g.
    (N, 2) sizes for (N, P, 4) boxes."""
    h = size_hw[..., 0:1]
    w = size_hw[..., 1:2]
    if boxes.dim() == 1:
        h, w = h.reshape(()), w.reshape(())

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0), hi)

    return torch.stack(
        [
            clip(boxes[..., 0], w),
            clip(boxes[..., 1], h),
            clip(boxes[..., 2], w),
            clip(boxes[..., 3], h),
        ],
        dim=-1,
    )


def nonempty_mask(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """True where both sides exceed ``threshold``."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    return (widths > threshold) & (heights > threshold)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0
    )


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
