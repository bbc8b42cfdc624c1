"""Detection training objectives, fixed shapes, batched over images.

Port of ``vltk_tpu/models/detection_loss.py``:

* :func:`subsample_mask` -- a boolean sample of up to ``num_samples``
  entries at the requested positive fraction, by random priorities;
* :func:`rpn_losses` -- objectness BCE and box L1 on anchors matched at
  (0.3, 0.7) with low-quality promotion;
* :func:`fast_rcnn_losses` -- class cross-entropy (background = the last
  class) and class-specific box L1 on proposals matched at 0.5.

JAX draws each image's priorities as ``jax.random.uniform(rng_i, (n,))``
from ``jax.random.split(rng, N)``. Here they come in as a tensor ``u`` of
the entries' shape, or are drawn in [0, 1) from ``generator`` (a
``torch.Generator`` on the logits' device), so a test can feed JAX's draws
and get JAX's sample masks exactly, and an experiment can draw from its
own saved RNG state.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vltk_tpu_torch.ops.boxes import box_iou, encode_deltas
from vltk_tpu_torch.ops.matcher import match_quality


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth-L1; ``beta <= 0`` is pure L1."""
    a = diff.abs()
    if beta <= 0:
        return a
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def _safe_boxes(b: torch.Tensor) -> torch.Tensor:
    """Width and height made at least 1e-3, so ``encode_deltas``' log and
    division stay finite on padded or degenerate boxes: an inf in the
    branch a ``where`` drops still turns its gradient into NaN, so this
    runs before the arithmetic. A no-op on real boxes."""
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, torch.maximum(x2, x1 + 1e-3), torch.maximum(y2, y1 + 1e-3)], dim=-1)


def _masked_rank(priority: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the ``mask``-selected ones along the last
    axis (a stable sort; masked-out entries rank last)."""
    score = torch.where(mask, priority, torch.full_like(priority, float("inf")))
    order = torch.argsort(score, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    arange = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return ranks.scatter_(-1, order, arange)


def draw_priorities(shape, device, generator: Optional[torch.Generator] = None, u=None) -> torch.Tensor:
    """``u`` as float32 on ``device``, or a uniform draw from ``generator``."""
    if u is not None:
        return torch.as_tensor(u, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, device=device)


def subsample_mask(
    labels: torch.Tensor,
    u: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
) -> torch.Tensor:
    """Sample mask over ``labels`` in {-1 ignore, 0 negative, 1 positive}
    (..., n) by priorities ``u`` of the same shape: the up to
    ``int(num_samples * positive_fraction)`` positives of lowest priority,
    then the remainder from the negatives."""
    pos = labels == 1
    neg = labels == 0
    n_pos = torch.clamp(pos.sum(-1, keepdim=True), max=int(num_samples * positive_fraction))
    sel_pos = pos & (_masked_rank(u, pos) < n_pos)
    n_neg = torch.minimum(num_samples - n_pos, neg.sum(-1, keepdim=True))
    sel_neg = neg & (_masked_rank(u, neg) < n_neg)
    return sel_pos | sel_neg


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (N, G, ...) rows at idx (N, A) -> (N, A, ...)."""
    idx = idx.to(torch.int64)
    return torch.gather(t, 1, idx.reshape(*idx.shape, *([1] * (t.dim() - 2))).expand(*idx.shape, *t.shape[2:]))


def rpn_losses(
    anchors: torch.Tensor,
    objectness_logits: torch.Tensor,
    anchor_deltas: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    iou_thresholds: Sequence[float] = (0.3, 0.7),
    iou_labels: Sequence[int] = (0, -1, 1),
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    smooth_l1_beta: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN's losses.

    Args:
      anchors: (A, 4).
      objectness_logits: (N, A), flattened as ``propose`` reads them.
      anchor_deltas: (N, A, 4).
      gt_boxes: (N, G, 4) xyxy; gt_valid (N, G) bool.
      u: (N, A) sampling priorities, else drawn from ``generator``.

    Returns (objectness_loss, localization_loss): each the batch mean of a
    per-image sum over the sampled anchors, over ``batch_size_per_image``.
    """
    n, a = objectness_logits.shape
    u = draw_priorities((n, a), objectness_logits.device, generator, u)
    iou = box_iou(gt_boxes, anchors.expand(n, *anchors.shape))  # (N, G, A)
    matches, match_labels = match_quality(
        iou, iou_thresholds, iou_labels, allow_low_quality_matches=True, gt_valid=gt_valid,
    )
    sample = subsample_mask(match_labels, u, batch_size_per_image, positive_fraction)
    pos = sample & (match_labels == 1)

    target = (match_labels == 1).to(torch.float32)
    logit = objectness_logits.to(torch.float32)
    bce = torch.maximum(logit, torch.zeros_like(logit)) - logit * target + torch.log1p(torch.exp(-logit.abs()))
    obj = torch.where(sample, bce, torch.zeros_like(bce)).sum(-1)

    matched_gt = _safe_boxes(_gather_rows(gt_boxes, matches))  # (N, A, 4)
    target_deltas = encode_deltas(_safe_boxes(anchors), matched_gt, tuple(bbox_reg_weights))
    l1 = smooth_l1(anchor_deltas.to(torch.float32) - target_deltas, smooth_l1_beta).sum(-1)
    loc = torch.where(pos, l1, torch.zeros_like(l1)).sum(-1)
    norm = float(batch_size_per_image)
    return obj.mean() / norm, loc.mean() / norm


def fast_rcnn_losses(
    proposals: torch.Tensor,
    prop_valid: torch.Tensor,
    obj_logits: torch.Tensor,
    box_deltas: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    iou_threshold: float = 0.5,
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    box_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
    smooth_l1_beta: float = 0.0,
    cls_agnostic_bbox_reg: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RoI heads' losses.

    Args:
      proposals: (N, P, 4), detached here (regression targets, never
        trained: the RPN gets no gradient through them); prop_valid (N, P).
      obj_logits: (N, P, C+1), background the last class.
      box_deltas: (N, P, C*4), or (N, P, 4) class-agnostic.
      gt_boxes (N, G, 4), gt_classes (N, G) int, gt_valid (N, G).
      u: (N, P) sampling priorities, else drawn from ``generator``.

    Returns (cls_loss, box_loss) scalars.
    """
    n, p = obj_logits.shape[:2]
    num_classes = obj_logits.shape[-1] - 1
    proposals = proposals.detach()
    u = draw_priorities((n, p), obj_logits.device, generator, u)
    iou = box_iou(gt_boxes, proposals)  # (N, G, P)
    iou = torch.where(prop_valid[:, None, :], iou, torch.zeros_like(iou))
    matches, match_labels = match_quality(iou, (iou_threshold,), (0, 1), gt_valid=gt_valid)
    match_labels = torch.where(prop_valid, match_labels, torch.full_like(match_labels, -1))
    sample = subsample_mask(match_labels, u, batch_size_per_image, positive_fraction)
    fg = sample & (match_labels == 1)

    gt_cls = _gather_rows(gt_classes, matches).to(torch.int64)
    cls_target = torch.where(fg, gt_cls, torch.full_like(gt_cls, num_classes))
    logp = F.log_softmax(obj_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, cls_target[..., None])[..., 0]
    cls = torch.where(sample, nll, torch.zeros_like(nll)).sum(-1)

    matched_gt = _safe_boxes(_gather_rows(gt_boxes, matches))
    target_deltas = encode_deltas(_safe_boxes(proposals), matched_gt, tuple(box_reg_weights))
    if cls_agnostic_bbox_reg:
        sel = box_deltas.reshape(n, p, 4)
    else:
        flat = box_deltas.reshape(n, p, num_classes, 4)
        idx = torch.clamp(cls_target, 0, num_classes - 1)[..., None, None].expand(n, p, 1, 4)
        sel = torch.gather(flat, 2, idx)[:, :, 0]
    l1 = smooth_l1(sel.to(torch.float32) - target_deltas, smooth_l1_beta).sum(-1)
    box = torch.where(fg, l1, torch.zeros_like(l1)).sum(-1)
    norm = float(batch_size_per_image)
    return cls.mean() / norm, box.mean() / norm
