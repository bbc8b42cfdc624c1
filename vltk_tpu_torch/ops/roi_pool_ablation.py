"""The RoIPool ablation variants, plain PyTorch.

Port of ``tools/probe_roipool_ablation.py``: four variants of the
separable-max RoIPool design (a row-range-max table built once per image,
pass 1 reading one table row per row bin into a ``rowmax`` scratch, pass 2
taking a windowed column max per column bin), used to measure which phase
dominates. These are the plain versions of the CUDA kernels K6-K9 in
``csrc/roi_pool_ablation.cu`` (dispatchers in
``ops/roi_pool_ablation_kernel.py``), written for what they return, not
step by step as the kernels compute it.

The common part: box corners are ``boxes / 16`` rounded half away from
zero, bins as ``ops/roi_pool.py:roi_bin_edges`` with 14 x 14 bins. Every
variant caps a bin's extent as its TPU body did:

- rows: at most ``max_bh = min(ceil((H + 1) / 14) + 1, H)`` rows from the
  bin's first row (the table has ``max_bh`` levels);
- columns, v2 window (``full``, ``stackwrite``, ``pool_grouped``):
  columns [ws, we) that lie in [x0, x0 + max_bw) with
  ``x0 = clip(ws, 0, W - max_bw)``;
- columns, v3 window (``v3``, ``pool_grouped_v3``): columns [ws, we)
  that lie in [8 * (ws // 8), + win), ``win = 2 * ceil(max_bw / 8) * 8``.

So the RoIPool modes equal exact RoIPool only for boxes within the map
plus one cell (bins no wider than the caps), as proposals clipped to the
image are. A bin whose max is at or below -5e29 (compared in float32), or
that is empty, is 0.

The modes of ``pool``:
- ``full`` (v2) and ``v3``: RoIPool as above;
- ``noP1``: pass 1 replaced by feature row i: out[i, j] = max over the
  column bin j of row i (0 if empty);
- ``noP2``: pass 2 replaced by column j: out[i, j] = max over the row bin
  i of column j, or the raw sentinel ``NEG`` (-1e30 in the features'
  dtype) for an empty row bin;
- ``noBoth``: out[i, j] = features[i, j].

``pool_contig`` returns the channel-blocked layout (B, C/cb, P, 14, 14, cb)
with modes ``full`` / ``stackwrite`` (RoIPool, v2) and ``p1only`` /
``zeroOut`` (zeros). ``pool_grouped`` (v2) and ``pool_grouped_v3`` (v3)
return RoIPool with G RoIs per step of the TPU grid.

Where the TPU versions are undefined the port raises ``ValueError``: P not
a multiple of G (the TPU grid then reads the next image's boxes and leaves
rows unwritten), C not a multiple of cb for ``pool_contig``, H < 14 for
``noP1``/``noBoth`` and W < 14 for ``noP2``/``noBoth`` (they read feature
row or column i < 14). Where the v3 window of an empty right-edge bin
would reach past the TPU scratch (W a multiple of 8), the port returns
the empty bin's 0. ``cb`` fixes only ``pool_contig``'s layout; the other
variants' results do not depend on it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vltk_tpu_torch.ops.roi_pool import bin_max, roi_bin_edges

OUT_SIZE = 14
SPATIAL_SCALE = 1.0 / 16
NEG = -1e30  # the TPU bodies' sentinel, cast to the features' dtype

POOL_MODES = ("full", "v3", "noP1", "noP2", "noBoth")
CONTIG_MODES = ("full", "stackwrite", "p1only", "zeroOut")


def caps(h: int, w: int) -> Tuple[int, int]:
    """(max_bh, max_bw): the table's levels and the v2 column window."""
    max_bh = min(math.ceil((h + 1) / OUT_SIZE) + 1, h)
    max_bw = min(math.ceil((w + 1) / OUT_SIZE) + 1, w)
    return max_bh, max_bw


def v3_window(max_bw: int) -> int:
    """Width of the v3 pass-2 window, a multiple of 8 that holds any
    max_bw-wide range starting in its first 8 columns."""
    return 2 * ((max_bw + 7) // 8) * 8


def neg_value(dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(NEG, dtype=torch.float32).to(dtype)


def check_args(
    features: torch.Tensor,
    boxes: torch.Tensor,
    mode: str = "full",
    modes: Tuple[str, ...] = POOL_MODES,
    cb: int = 128,
    group: int = 1,
    contig: bool = False,
) -> None:
    """Raise ``ValueError`` on what the variants do not define."""
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(
            f"roi_pool_ablation: want features (B,H,W,C) and boxes (B,P,4), got "
            f"{tuple(features.shape)} and {tuple(boxes.shape)}"
        )
    if boxes.shape[0] != features.shape[0]:
        raise ValueError("roi_pool_ablation: features and boxes disagree on the batch")
    if mode not in modes:
        raise ValueError(f"roi_pool_ablation: mode {mode!r} not in {modes}")
    b, h, w, c = features.shape
    if cb < 1 or (contig and c % cb):
        raise ValueError(f"roi_pool_ablation: channel block {cb} does not divide C={c}")
    if group < 1 or boxes.shape[1] % group:
        raise ValueError(f"roi_pool_ablation: {boxes.shape[1]} RoIs are not a multiple of the group {group}")
    if mode in ("noP1", "noBoth") and h < OUT_SIZE:
        raise ValueError(f"roi_pool_ablation: mode {mode} reads feature row i < 14, H={h}")
    if mode in ("noP2", "noBoth") and w < OUT_SIZE:
        raise ValueError(f"roi_pool_ablation: mode {mode} reads feature column j < 14, W={w}")


def capped_edges(boxes: torch.Tensor, h: int, w: int, window: str):
    """Bin edges with the row cap and the v2 or v3 column window."""
    max_bh, max_bw = caps(h, w)
    hs, he, ws, we = roi_bin_edges(boxes, SPATIAL_SCALE, h, w, OUT_SIZE)
    he = torch.minimum(he, hs + max_bh)
    if window == "v2":
        x0 = torch.clamp(ws, 0, w - max_bw)
        we = torch.minimum(we, x0 + max_bw)
    else:
        we = torch.minimum(we, ws // 8 * 8 + v3_window(max_bw))
    return hs, he, ws, we


def _zero_empty(m: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
    zero = (m.float() <= NEG / 2) | empty
    return torch.where(zero, torch.zeros((), dtype=m.dtype, device=m.device), m)


def _roipool(features: torch.Tensor, boxes: torch.Tensor, window: str) -> torch.Tensor:
    h, w = features.shape[1:3]
    return _zero_empty(*bin_max(features, *capped_edges(boxes, h, w, window)))


def _fixed_bins(boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bins of one row or column each, [k, k + 1) for k < 14."""
    k = torch.arange(OUT_SIZE, device=boxes.device).expand(*boxes.shape[:2], OUT_SIZE)
    return k, k + 1


def pool(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128) -> torch.Tensor:
    """(B, H, W, C), (B, P, 4) -> (B, P, 14, 14, C); modes as the module
    docstring says."""
    check_args(features, boxes, mode, POOL_MODES, cb)
    b, h, w, c = features.shape
    p = boxes.shape[1]
    if mode in ("full", "v3"):
        return _roipool(features, boxes, "v2" if mode == "full" else "v3")
    if mode == "noBoth":
        return features[:, None, :OUT_SIZE, :OUT_SIZE].expand(b, p, OUT_SIZE, OUT_SIZE, c).clone()
    hs, he, ws, we = capped_edges(boxes, h, w, "v2")
    if mode == "noP1":
        return _zero_empty(*bin_max(features, *_fixed_bins(boxes), ws, we))
    m, empty = bin_max(features, hs, he, *_fixed_bins(boxes))  # noP2
    return torch.where(empty, neg_value(features.dtype).to(features.device), m)


def to_contig(out: torch.Tensor, cb: int) -> torch.Tensor:
    """(B, P, 14, 14, C) -> the channel-blocked (B, C/cb, P, 14, 14, cb)."""
    b, p, s, _, c = out.shape
    return out.reshape(b, p, s, s, c // cb, cb).permute(0, 4, 1, 2, 3, 5).contiguous()


def from_contig(out: torch.Tensor) -> torch.Tensor:
    """(B, C/cb, P, 14, 14, cb) -> (B, P, 14, 14, C)."""
    b, n_cb, p, s, _, cb = out.shape
    return out.permute(0, 2, 3, 4, 1, 5).reshape(b, p, s, s, n_cb * cb)


def pool_contig(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128) -> torch.Tensor:
    """(B, H, W, C), (B, P, 4) -> (B, C/cb, P, 14, 14, cb): RoIPool (v2
    window) for ``full`` and ``stackwrite``, zeros for ``p1only`` and
    ``zeroOut``."""
    check_args(features, boxes, mode, CONTIG_MODES, cb, contig=True)
    b, h, w, c = features.shape
    if mode in ("p1only", "zeroOut"):
        return features.new_zeros(b, c // cb, boxes.shape[1], OUT_SIZE, OUT_SIZE, cb)
    return to_contig(_roipool(features, boxes, "v2"), cb)


def pool_grouped(features: torch.Tensor, boxes: torch.Tensor, group: int = 8, cb: int = 128) -> torch.Tensor:
    """RoIPool with the v2 window, G RoIs per step: (B, P, 14, 14, C)."""
    check_args(features, boxes, cb=cb, group=group)
    return _roipool(features, boxes, "v2")


def pool_grouped_v3(features: torch.Tensor, boxes: torch.Tensor, group: int = 4, cb: int = 128) -> torch.Tensor:
    """RoIPool with the v3 window, G RoIs per step: (B, P, 14, 14, C)."""
    check_args(features, boxes, cb=cb, group=group)
    return _roipool(features, boxes, "v3")
