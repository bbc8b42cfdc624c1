"""IoU-threshold matching with low-quality promotion.

Port of ``vltk_tpu/ops/matcher.py:match_quality``: every prediction gets
its best ground truth (the first on a tie, as ``argmax`` takes it) and the
label of the threshold stratum its quality falls in; padded ground-truth
rows (``gt_valid`` False) get quality -1, so they fall in the first
stratum and are never the argmax while a real row exists.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def match_quality(
    quality: torch.Tensor,
    thresholds: Sequence[float],
    labels: Sequence[int],
    *,
    allow_low_quality_matches: bool = False,
    gt_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each prediction at most one ground truth.

    Args:
      quality: (..., M, N) match quality (IoU), M ground truths x N
        predictions; leading dims batch.
      thresholds: ascending thresholds, e.g. (0.3, 0.7).
      labels: a label in {-1, 0, 1} a stratum, ``len(thresholds) + 1``.
      allow_low_quality_matches: promote to 1, for every real ground truth,
        each prediction whose quality equals that ground truth's best (ties
        included).
      gt_valid: optional (..., M) bool of real ground-truth rows.

    Returns matches (..., N) int32 and match_labels (..., N) int8.
    """
    thresholds = list(thresholds)
    if not thresholds[0] > 0 or any(lo > hi for lo, hi in zip(thresholds, thresholds[1:])):
        raise ValueError(f"thresholds must be positive and ascending, got {thresholds}")
    if len(labels) != len(thresholds) + 1 or any(l not in (-1, 0, 1) for l in labels):
        raise ValueError(f"want len(thresholds) + 1 labels in {{-1, 0, 1}}, got {labels}")
    bounds = [float("-inf")] + thresholds + [float("inf")]

    quality = quality.to(torch.float32)
    if gt_valid is not None:
        quality = torch.where(gt_valid[..., :, None], quality, torch.full_like(quality, -1.0))
    matched_vals, matches = quality.max(dim=-2)  # the first maximal index
    match_labels = torch.zeros(matched_vals.shape, dtype=torch.int8, device=quality.device)
    for label, lo, hi in zip(labels, bounds[:-1], bounds[1:]):
        in_stratum = (matched_vals >= lo) & (matched_vals < hi)
        match_labels = torch.where(in_stratum, torch.full_like(match_labels, label), match_labels)

    if allow_low_quality_matches:
        is_best = quality == quality.amax(dim=-1, keepdim=True)  # (..., M, N)
        if gt_valid is not None:
            is_best = is_best & gt_valid[..., :, None]
        match_labels = torch.where(is_best.any(dim=-2), torch.ones_like(match_labels), match_labels)
    return matches.to(torch.int32), match_labels
