"""Batched image preprocessing on the device: shortest-edge resize onto a
fixed canvas, BGR swap, caffe-mean normalise, zero pad.

Port of ``vltk_tpu/ops/image_ops.py``. The reference resizes with
``jax.image.scale_and_translate`` (linear, no antialias) using a per-image
traced scale onto a static canvas. ``F.interpolate`` cannot take a
per-image scale, so the resize here is a gather-and-lerp that rebuilds the
reference's sampling: the same sample positions, the same two-tap triangle
weights normalised by their sum (which is what replicates the edge texel),
and the same zero weight for samples outside the input canvas.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# caffe BGR pixel means of the VG FRCNN
CAFFE_BGR_MEAN = (102.9801, 115.9465, 122.7717)

_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)


def shortest_edge_scale(
    raw_hw: torch.Tensor, short: float, maximum: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image resize scale and target (h, w), float32."""
    rh = raw_hw[..., 0].to(torch.float32)
    rw = raw_hw[..., 1].to(torch.float32)
    scale = short / torch.minimum(rh, rw)
    over = torch.maximum(rh, rw) * scale > maximum
    scale = torch.where(over, maximum / torch.maximum(rh, rw), scale)
    new_h = torch.floor(rh * scale + 0.5)
    new_w = torch.floor(rw * scale + 0.5)
    return scale, torch.stack([new_h, new_w], dim=-1)


def _linear_taps(in_size: int, out_size: int, scale: torch.Tensor, content: torch.Tensor):
    """Two-tap linear resampling along one axis, per image.

    scale: (N,) output/input ratio; content: (N,) int rows (or cols) of
    real content — taps past it read the edge texel, as the reference's
    edge replication of the host pad does.
    Returns (idx0, idx1) (N, out) int64 and (w0, w1) (N, out) float32.
    """
    dev = scale.device
    inv_scale = 1.0 / scale
    pos = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = pos[None, :] * inv_scale[:, None] - 0.5  # (N, out)
    i0 = torch.floor(sample_f)
    i1 = i0 + 1.0
    # triangle kernel weight of each tap; a tap outside [0, in_size) has no
    # input row, so it contributes nothing to the sum
    t0 = torch.clamp(1.0 - torch.abs(sample_f - i0), min=0.0)
    t1 = torch.clamp(1.0 - torch.abs(sample_f - i1), min=0.0)
    t0 = torch.where((i0 >= 0) & (i0 <= in_size - 1), t0, torch.zeros_like(t0))
    t1 = torch.where((i1 >= 0) & (i1 <= in_size - 1), t1, torch.zeros_like(t1))
    total = t0 + t1
    ok = torch.abs(total) > _WEIGHT_EPS
    denom = torch.where(total != 0, total, torch.ones_like(total))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    keep = ok & inside
    w0 = torch.where(keep, t0 / denom, torch.zeros_like(t0))
    w1 = torch.where(keep, t1 / denom, torch.zeros_like(t1))
    last = (content.to(torch.int64) - 1)[:, None]
    idx0 = torch.minimum(torch.clamp(i0.to(torch.int64), 0, in_size - 1), last)
    idx1 = torch.minimum(torch.clamp(i1.to(torch.int64), 0, in_size - 1), last)
    return idx0, idx1, w0, w1


def preprocess_batch(
    images: torch.Tensor,
    raw_sizes: torch.Tensor,
    canvas_hw: Tuple[int, int] = (1344, 1344),
    short: float = 800.0,
    maximum: float = 1333.0,
    mean: Sequence[float] = CAFFE_BGR_MEAN,
    std: Sequence[float] = (1.0, 1.0, 1.0),
    bgr: bool = True,
):
    """Resize + normalise + pad a fixed-shape batch.

    Args:
      images: (N, Hr, Wr, 3) raw RGB pixels (uint8 or float), each image in
        the top-left (raw_h, raw_w) corner of the raw canvas.
      raw_sizes: (N, 2) int raw (h, w) per image.
      canvas_hw: output canvas; must cover the (short, maximum) targets.

    Returns dict:
      img: (N, ch, cw, 3) float32, BGR caffe-normalised, zero beyond content.
      sizes: (N, 2) float32 resized content (h, w).
      scales_yx: (N, 2) float32 raw/resized ratio.
    """
    ch, cw = canvas_hw
    n, hr, wr, _ = images.shape
    dev = images.device
    images = images.to(torch.float32)
    raw_sizes = raw_sizes.to(dev)
    _, new_hw = shortest_edge_scale(raw_sizes, float(short), float(maximum))
    raw_f = raw_sizes.to(torch.float32)
    sy = new_hw[:, 0] / raw_f[:, 0]
    sx = new_hw[:, 1] / raw_f[:, 1]

    y0, y1, wy0, wy1 = _linear_taps(hr, ch, sy, raw_sizes[:, 0])
    x0, x1, wx0, wx1 = _linear_taps(wr, cw, sx, raw_sizes[:, 1])

    bi = torch.arange(n, device=dev)[:, None]
    rows = (
        wy0[..., None, None] * images[bi, y0]
        + wy1[..., None, None] * images[bi, y1]
    )  # (N, ch, Wr, 3)
    bi3 = bi[:, :, None]
    ri = torch.arange(ch, device=dev)[None, :, None]
    resized = (
        wx0[:, None, :, None] * rows[bi3, ri, x0[:, None, :]]
        + wx1[:, None, :, None] * rows[bi3, ri, x1[:, None, :]]
    )  # (N, ch, cw, 3)
    if bgr:
        resized = resized.flip(-1)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    out = (resized - mean_t) / std_t
    # zero outside the resized content (pad AFTER normalise)
    rr = torch.arange(ch, dtype=torch.float32, device=dev)
    cc = torch.arange(cw, dtype=torch.float32, device=dev)
    inside = (rr[None, :, None] < new_hw[:, 0, None, None]) & (
        cc[None, None, :] < new_hw[:, 1, None, None]
    )
    out = torch.where(inside[..., None], out, torch.zeros((), device=dev))
    scales_yx = raw_f / new_hw
    return {"img": out, "sizes": new_hw, "scales_yx": scales_yx}
