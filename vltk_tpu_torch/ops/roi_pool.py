"""RoIPool, plain PyTorch: exact torchvision RoIPool semantics.

Port of ``vltk_tpu/ops/roi_pool.py`` (``_roi_bin_edges``,
``roi_pool_offsets``), batched over images. This is the plain version of
the CUDA kernel in ``ops/roi_pool_kernel.py``: the CPU path of the model
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.

Semantics: box corners are scaled by ``spatial_scale`` and rounded half
away from zero; bin i spans [floor(i*R/P), ceil((i+1)*R/P)) from the
corner, clipped to the map; the bin value is the max over its cells and an
empty bin is 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def round_half_away(scaled: torch.Tensor) -> torch.Tensor:
    """The reference's rounding of scaled corners: floor(s + 0.5) for
    s >= 0, ceil(s - 0.5) below. (``torch.round`` rounds half to even.)"""
    return torch.where(
        scaled >= 0, torch.floor(scaled + 0.5), torch.ceil(scaled - 0.5)
    ).to(torch.int32)


def roi_bin_edges(
    boxes: torch.Tensor, spatial_scale: float, h: int, w: int, output_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer bin edges: boxes (..., 4) -> hstart, hend, wstart, wend,
    each (..., output_size) int64, clipped to the map."""
    ps = output_size
    roi = round_half_away(boxes.to(torch.float32) * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = roi[..., 0], roi[..., 1], roi[..., 2], roi[..., 3]
    roi_w = torch.clamp(x2 - x1 + 1, min=1)[..., None]
    roi_h = torch.clamp(y2 - y1 + 1, min=1)[..., None]
    grid = torch.arange(ps, dtype=torch.int64, device=boxes.device)
    hstart = torch.clamp(grid * roi_h // ps + y1[..., None], 0, h)
    hend = torch.clamp(((grid + 1) * roi_h + ps - 1) // ps + y1[..., None], 0, h)
    wstart = torch.clamp(grid * roi_w // ps + x1[..., None], 0, w)
    wend = torch.clamp(((grid + 1) * roi_w + ps - 1) // ps + x1[..., None], 0, w)
    return hstart, hend, wstart, wend


def bin_max(
    features: torch.Tensor,
    hstart: torch.Tensor,
    hend: torch.Tensor,
    wstart: torch.Tensor,
    wend: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max over the cells of every bin by a loop over in-bin offsets (one
    masked gather-max per offset).

    Args:
      features: (B, H, W, C).
      hstart, hend: (B, P, R) row ranges [hstart, hend) of the R bin rows.
      wstart, wend: (B, P, S) column ranges of the S bin columns.

    Returns the max (B, P, R, S, C) in the features' dtype (-inf where the
    bin is empty; NaN propagates) and the emptiness (B, P, R, S, 1).
    """
    b, h, w, c = features.shape
    lh = hend - hstart
    lw = wend - wstart
    # the widest bin of THIS data, so bins of any extent are covered
    max_bh = max(int(lh.max()) if lh.numel() else 0, 1)
    max_bw = max(int(lw.max()) if lw.numel() else 0, 1)

    flat = features.reshape(b, h * w, c)
    bi = torch.arange(b, device=features.device)[:, None, None, None]
    acc = None
    for i in range(max_bh):
        iy = torch.clamp(hstart + i, 0, h - 1)  # (B, P, R)
        in_y = (hstart + i) < hend
        for j in range(max_bw):
            ix = torch.clamp(wstart + j, 0, w - 1)
            in_x = (wstart + j) < wend
            idx = iy[..., :, None] * w + ix[..., None, :]  # (B, P, R, S)
            vals = flat[bi, idx]  # (B, P, R, S, C)
            mask = (in_y[..., :, None] & in_x[..., None, :])[..., None]
            if acc is None:
                acc = torch.where(mask, vals, torch.full_like(vals, float("-inf")))
            else:
                acc = torch.where(mask, torch.maximum(acc, vals), acc)
    empty = ((lh <= 0)[..., :, None] | (lw <= 0)[..., None, :])[..., None]
    return acc, empty


def roi_pool(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """Exact RoIPool.

    Args:
      features: (B, H, W, C) feature maps.
      boxes: (B, P, 4) xyxy in input-image coordinates.

    Returns (B, P, output_size, output_size, C) in the features' dtype.
    """
    h, w = features.shape[1:3]
    acc, empty = bin_max(features, *roi_bin_edges(boxes, spatial_scale, h, w, output_size))
    return torch.where(empty, torch.zeros((), dtype=features.dtype, device=features.device), acc)
