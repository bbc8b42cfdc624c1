"""Fixed-budget greedy NMS, plain PyTorch.

Port of ``vltk_tpu/ops/nms.py:nms_fixed``: exactly ``max_out`` greedy
selection steps, each taking the highest-scoring live box (the lowest index
among equal scores, as ``argmax`` does) and removing every box whose IoU
with it is strictly above the threshold. The result is the ordered greedy
keep-set padded with -1, plus a validity mask.

This is the plain version of the CUDA kernel in ``ops/nms_kernel.py``: the
CPU path of the model runs it, and ``chip_smoke.py`` holds the kernel
against it on the card. The reference's TPU execution knobs (blocked
greedy, scan unroll, batch chunking) change the program shape, never the
keep-set, so the port has none of them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e10


def _iou_one_vs_all(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one box per row (R, 4) against (R, K, 4) -> (R, K), in the
    reference's operation order (area of the selected box first)."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = torch.clamp(box[:, 2] - box[:, 0], min=0) * torch.clamp(
        box[:, 3] - box[:, 1], min=0
    )
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0
    )
    union = area1[:, None] + area - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def row_thresholds(
    iou_threshold: Union[float, torch.Tensor], rows: int, device
) -> torch.Tensor:
    """(R,) float32 thresholds from a scalar or a per-row tensor."""
    t = torch.as_tensor(iou_threshold, dtype=torch.float32, device=device)
    return t.expand(rows).contiguous() if t.dim() == 0 else t.reshape(rows)


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: Union[float, torch.Tensor],
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed output budget, batched over rows.

    Args:
      boxes: (R, K, 4) xyxy float32 (or (K, 4) for one row).
      scores: (R, K).
      iou_threshold: a float, or an (R,) tensor of per-row thresholds;
        a box is removed when IoU > threshold (strict).
      max_out: number of selection steps.
      valid: optional (R, K) bool — False entries are never selected.

    Returns:
      keep: (R, max_out) int32 indices into each row, -1 where fewer survive.
      keep_valid: (R, max_out) bool.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    r, k = scores.shape
    dev = scores.device
    boxes = boxes.to(torch.float32)
    live = scores.to(torch.float32)
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    thr = row_thresholds(iou_threshold, r, dev)
    rows = torch.arange(r, device=dev)
    keep = torch.full((r, max_out), -1, dtype=torch.int32, device=dev)
    for step in range(max_out):
        idx = torch.argmax(live, dim=1)
        ok = live[rows, idx] > NEG_INF / 2
        if not bool(ok.any()):
            break  # nothing live in any row: the rest stays -1
        ious = _iou_one_vs_all(boxes[rows, idx], boxes)
        suppress = ious > thr[:, None]
        suppress[rows, idx] = True  # a zero-area box has IoU 0 with itself
        live = torch.where(ok[:, None] & suppress, torch.full_like(live, NEG_INF), live)
        keep[:, step] = torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32)
    keep_valid = keep >= 0
    if single:
        return keep[0], keep_valid[0]
    return keep, keep_valid


def batched_nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Category-aware greedy NMS (JAX's ``batched_nms_fixed``): each
    category is shifted to its own coordinate island, ``idxs * (max box
    coordinate + 1)``, so boxes of different categories never overlap, and
    one ``nms_fixed_auto`` call takes every row (the kernel K2 on the card).

    Args: boxes (K, 4) or (R, K, 4), scores and idxs (K,) or (R, K), valid
    optional like scores; the coordinate bound is each row's own. Returns
    keep (max_out,) or (R, max_out) int32, -1 padded, and its mask."""
    from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto

    if boxes.shape[-2] == 0:
        lead = boxes.shape[:-2]
        return (torch.full((*lead, max_out), -1, dtype=torch.int32, device=boxes.device),
                torch.zeros((*lead, max_out), dtype=torch.bool, device=boxes.device))
    max_coord = boxes.flatten(-2).amax(-1) + 1.0  # () or (R,)
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord[..., None])[..., None]
    return nms_fixed_auto(shifted, scores, iou_threshold, max_out, valid=valid)
