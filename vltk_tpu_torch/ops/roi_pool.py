"""RoIPool and RoIAlign, plain PyTorch.

Port of ``vltk_tpu/ops/roi_pool.py``, batched over images:

* :func:`roi_pool_offsets` -- the offset loop (one masked gather-max per
  in-bin offset). The plain version of the forward kernel K1
  (``ops/roi_pool_kernel.py``): the CPU path of the model runs it, and
  ``chip_smoke.py`` holds K1 against it on the card.
* :func:`roi_pool` -- JAX's sparse-table formulation (power-of-two range
  maxima, four lookups a bin). Equal to the offset loop on boxes within the
  map plus one cell; its VJP is the RoIPool gradient of the JAX package on
  every backend.
* :func:`roi_pool_plain_vjp` -- that VJP exactly: the plain version of the
  backward kernel K10 (``csrc/roi_pool_bwd.cu``).
* :func:`roi_align` -- bilinear RoIAlign with a fixed sampling grid.

RoIPool semantics: box corners are scaled by ``spatial_scale`` and rounded
half away from zero; bin i spans [floor(i*R/P), ceil((i+1)*R/P)) from the
corner, clipped to the map; the bin value is the max over its cells and an
empty bin is 0.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

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


def roi_pool_offsets(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """Exact RoIPool by the offset loop (``bin_max``): any bin extent.

    Args:
      features: (B, H, W, C) feature maps.
      boxes: (B, P, 4) xyxy in input-image coordinates.

    Returns (B, P, output_size, output_size, C) in the features' dtype.
    """
    h, w = features.shape[1:3]
    acc, empty = bin_max(features, *roi_bin_edges(boxes, spatial_scale, h, w, output_size))
    return torch.where(empty, torch.zeros((), dtype=features.dtype, device=features.device), acc)


# ------------------------------------------------------------ sparse table


def table_levels(h: int, w: int, output_size: int) -> Tuple[int, int, int, int]:
    """(max_bin_h, max_bin_w, kh_levels, kw_levels) of JAX's sparse table:
    the static bin-extent bounds (clipped to the map) and the number of
    power-of-two levels along each axis."""
    max_bin_h = min(math.ceil((h + 1) / output_size) + 1, h)
    max_bin_w = min(math.ceil((w + 1) / output_size) + 1, w)
    return (max_bin_h, max_bin_w, int(math.floor(math.log2(max_bin_h))) + 1,
            int(math.floor(math.log2(max_bin_w))) + 1)


def _shift_max(x: torch.Tensor, shift: int, dim: int, maximum: Callable) -> torch.Tensor:
    """max(x[i], x[min(i + shift, n - 1)]) along ``dim``: one doubling step
    of the table, the last entry repeated past the edge as JAX's slices do."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(n, device=x.device) + min(shift, n - 1), max=n - 1)
    return maximum(x, x.index_select(dim, idx))


def _sparse_table_pool(features, boxes, output_size, spatial_scale, maximum):
    """JAX's ``roi_pool`` batched, with ``maximum`` for every max it takes."""
    b, h, w, c = features.shape
    hstart, hend, wstart, wend = roi_bin_edges(boxes, spatial_scale, h, w, output_size)
    max_bin_h, max_bin_w, kh_levels, kw_levels = table_levels(h, w, output_size)

    # tables[kw * kh_levels + kh][y, x] = max over features[y:y+2^kh, x:x+2^kw]
    w_tables = [features]
    for k in range(1, kw_levels):
        w_tables.append(_shift_max(w_tables[-1], 1 << (k - 1), 2, maximum))
    tables = []
    for col in w_tables:
        tables.append(col)
        for k in range(1, kh_levels):
            col = _shift_max(col, 1 << (k - 1), 1, maximum)
            tables.append(col)
    flat = torch.stack(tables, dim=1).reshape(b, kw_levels * kh_levels * h * w, c)

    lut = torch.tensor(
        [0] + [int(math.floor(math.log2(n))) for n in range(1, max(h, w) + 2)],
        dtype=torch.int64, device=features.device,
    )
    lh, lw = hend - hstart, wend - wstart  # (B, P, S)
    kh = lut[torch.clamp(lh, 1, max_bin_h)]
    kw = lut[torch.clamp(lw, 1, max_bin_w)]
    ys = (hstart, torch.clamp(hend - (1 << kh), min=0))
    xs = (wstart, torch.clamp(wend - (1 << kw), min=0))
    base = (kw[..., None, :] * kh_levels + kh[..., :, None]) * (h * w)  # (B, P, S, S)
    bi = torch.arange(b, device=features.device)[:, None, None, None]

    def take(y, x):
        return flat[bi, base + y[..., :, None] * w + x[..., None, :]]  # (B, P, S, S, C)

    out = maximum(maximum(take(ys[0], xs[0]), take(ys[0], xs[1])),
                  maximum(take(ys[1], xs[0]), take(ys[1], xs[1])))
    empty = ((lh <= 0)[..., :, None] | (lw <= 0)[..., None, :])[..., None]
    return torch.where(empty, torch.zeros((), dtype=out.dtype, device=out.device), out)


def roi_pool(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """JAX's sparse-table RoIPool: every bin's max is the max of four table
    lookups (two a side, each at the bin's power-of-two level, clipped to
    the table's levels). (B, H, W, C), (B, P, 4) -> (B, P, S, S, C)."""
    return _sparse_table_pool(features, boxes, output_size, spatial_scale, torch.maximum)


class _BalancedMax(torch.autograd.Function):
    """``torch.maximum`` with JAX's gradient (``lax.max``'s
    ``_balanced_eq``): each operand equal to the result gets the cotangent,
    halved when both are; with a NaN result neither gets anything (where
    ``torch.maximum``'s backward gives it to both)."""

    @staticmethod
    def forward(ctx, x, y):
        z = torch.maximum(x, y)
        ctx.save_for_backward(x, y, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        ex, ey = (x == z).to(g.dtype), (y == z).to(g.dtype)
        return g * (ex / (1 + ey)), g * (ey / (1 + ex))


def roi_pool_plain_vjp(
    features: torch.Tensor,
    boxes: torch.Tensor,
    grad_out: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """JAX's RoIPool cotangent: the VJP of :func:`roi_pool` with JAX's max
    rule, so a bin's cotangent goes down its four lookups and the table's
    doubling steps, halved at every tie (exact dyadic shares), an empty bin
    or a bin whose max is NaN giving nothing. Summed in float32 and cast to
    the features' dtype once, as the kernel K10 does (JAX's bfloat16 VJP
    sums in bfloat16). Boxes get no gradient. Returns (B, H, W, C)."""
    f = features.detach().to(torch.float32).requires_grad_()
    with torch.enable_grad():
        out = _sparse_table_pool(f, boxes.detach(), output_size, spatial_scale, _BalancedMax.apply)
        (grad,) = torch.autograd.grad(out, f, grad_out.to(torch.float32))
    return grad.to(features.dtype)


# --------------------------------------------------------------- RoIAlign


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign (the mean of ``sampling_ratio``^2 bilinear samples a bin,
    sample points clipped to the map), as JAX's ``roi_align``, batched:
    (B, H, W, C), (B, P, 4) xyxy input-image coordinates -> (B, P, S, S, C)
    in the features' dtype, summed in float32."""
    b, h, w, c = features.shape
    dev = features.device
    offset = 0.5 if aligned else 0.0
    scaled = boxes.to(torch.float32) * spatial_scale - offset
    x1, y1 = scaled[..., 0], scaled[..., 1]
    roi_w, roi_h = scaled[..., 2] - x1, scaled[..., 3] - y1
    if not aligned:
        roi_w, roi_h = torch.clamp(roi_w, min=1.0), torch.clamp(roi_h, min=1.0)
    bin_w = (roi_w / output_size)[..., None]
    bin_h = (roi_h / output_size)[..., None]
    grid = torch.arange(output_size, dtype=torch.float32, device=dev)
    flat = features.reshape(b, h * w, c)
    bi = torch.arange(b, device=dev)[:, None, None, None]

    def gather(iy, ix):
        return flat[bi, iy[..., :, None] * w + ix[..., None, :]].to(torch.float32)

    acc = torch.zeros((*boxes.shape[:2], output_size, output_size, c), dtype=torch.float32, device=dev)
    for k in range(sampling_ratio * sampling_ratio):
        sy, sx = divmod(k, sampling_ratio)
        py = torch.clamp(y1[..., None] + (grid + (sy + 0.5) / sampling_ratio) * bin_h, 0.0, h - 1.0)
        px = torch.clamp(x1[..., None] + (grid + (sx + 0.5) / sampling_ratio) * bin_w, 0.0, w - 1.0)
        y0, x0 = torch.floor(py).to(torch.int64), torch.floor(px).to(torch.int64)
        y1i, x1i = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
        wy = (py - y0.to(torch.float32))[..., :, None, None]
        wx = (px - x0.to(torch.float32))[..., None, :, None]
        acc = acc + (
            gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x1i) * (1 - wy) * wx
            + gather(y1i, x0) * wy * (1 - wx)
            + gather(y1i, x1i) * wy * wx
        )
    return (acc / (sampling_ratio * sampling_ratio)).to(features.dtype)
