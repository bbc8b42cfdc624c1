"""Region Proposal Network: fixed shapes, batched.

Port of ``vltk_tpu/models/rpn.py``: per-image top-k by objectness, decode,
clip, min-size mask, greedy NMS under a fixed ``post_nms_topk`` budget,
(N, P, 4) boxes plus a validity mask. The NMS runs through
``ops.nms_kernel.nms_fixed_auto`` (the CUDA kernel on the card). The
reference's ``nms_block``/``nms_unroll``/``nms_chunk`` knobs shape its TPU
program, never the keep-set, so ``propose`` has none of them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.ops.boxes import apply_deltas, clip_boxes, nonempty_mask
from vltk_tpu_torch.ops.nms import NEG_INF
from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto


def apply_ignorey(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    ignorey: torch.Tensor,
    scale_x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The document-image y-band exclusion/clip of the reference RPN as
    mask algebra, batched: boxes (N, P, 4), valid (N, P), ignorey (N, J, 2)
    raw-image bands, scale_x (N,).

    Per band (divided by the x-scale): proposals whose y-extent holds the
    whole band are dropped; every other proposal is clipped to the nearer
    band edge (``trunc`` of the edge; ties clip neither). The reference's
    ``below_band`` escape is kept as written, quirks included.
    """
    ymin, ymax = boxes[..., 1], boxes[..., 3]
    for j in range(ignorey.shape[1]):
        y0 = (ignorey[:, j, 0] / scale_x)[:, None]
        y1 = (ignorey[:, j, 1] / scale_x)[:, None]
        drop = (y1 <= ymax) & (y0 >= ymin)
        valid = valid & ~drop
        below_band = (ymin > y1) & (ymax > y0)  # box entirely past the band
        to_clip = ~below_band
        d_top = torch.abs(y1 - ymax)
        d_bot = torch.abs(y0 - ymin)
        ymax_new = torch.where(to_clip & (d_top < d_bot), torch.trunc(y0).expand_as(ymax), ymax)
        ymin = torch.where(to_clip & (d_bot < d_top), torch.trunc(y1).expand_as(ymin), ymin)
        ymax = ymax_new
    return torch.stack([boxes[..., 0], ymin, boxes[..., 2], ymax], dim=-1), valid


class RPNHead(nn.Module):
    """3x3 conv -> (1x1 objectness, 1x1 deltas). The reference builds it
    without a dtype, so it computes in float32 even when the backbone runs
    bf16; so does this one."""

    def __init__(self, in_channels: int, num_anchors: int = 15, hidden_channels: int = 512):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(hidden_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(hidden_channels, num_anchors * 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, H, W, C) -> logits (N, H, W, A), deltas (N, H, W, A*4),
        float32."""
        t = F.relu(self.conv(x.permute(0, 3, 1, 2).to(torch.float32)))
        logits = self.objectness_logits(t).permute(0, 2, 3, 1)
        deltas = self.anchor_deltas(t).permute(0, 2, 3, 1)
        return logits, deltas


def topk_lower_index_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with equal values taken lower index
    first, as ``lax.top_k`` does (``torch.topk`` promises no tie order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def propose(
    logits: torch.Tensor,
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    image_sizes: torch.Tensor,
    *,
    nms_thresh: float = 0.7,
    pre_nms_topk: int = 6000,
    post_nms_topk: int = 1000,
    min_box_side_len: float = 0.0,
    bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
    ignorey: Optional[torch.Tensor] = None,
    scales_yx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode + select the top proposals of a batch (single level, C4).

    Args:
      logits: (N, Hf, Wf, A) objectness.
      deltas: (N, Hf, Wf, A*4).
      anchors: (Hf*Wf*A, 4) in (y, x, a) order.
      image_sizes: (N, 2) float (h, w) of each image's content.
      ignorey: optional (N, J, 2) y-bands; needs ``scales_yx``.

    Returns:
      boxes (N, post_nms_topk, 4), scores (N, post_nms_topk) logits
      (NEG_INF where invalid), valid (N, post_nms_topk) bool.
    """
    n = logits.shape[0]
    flat_logits = logits.reshape(n, -1).to(torch.float32)
    flat_deltas = deltas.reshape(n, -1, 4)

    k = min(pre_nms_topk, flat_logits.shape[1])
    top_scores, top_idx = topk_lower_index_first(flat_logits, k)  # (N, k)
    top_deltas = torch.gather(flat_deltas, 1, top_idx[..., None].expand(n, k, 4))
    top_anchors = anchors[top_idx]  # (N, k, 4)

    boxes = apply_deltas(
        top_deltas.to(torch.float32), top_anchors, weights=tuple(bbox_reg_weights)
    )
    valid = torch.ones((n, k), dtype=torch.bool, device=boxes.device)
    if ignorey is not None and scales_yx is not None:
        boxes, valid = apply_ignorey(
            boxes, valid, ignorey.to(torch.float32),
            scales_yx[:, 1].to(torch.float32),
        )
    boxes = clip_boxes(boxes, image_sizes.to(torch.float32))
    valid = valid & nonempty_mask(boxes, threshold=min_box_side_len)
    keep, keep_valid = nms_fixed_auto(
        boxes, top_scores, nms_thresh, post_nms_topk, valid=valid
    )
    safe = torch.clamp(keep, min=0).to(torch.int64)
    out_boxes = torch.gather(boxes, 1, safe[..., None].expand(n, post_nms_topk, 4))
    out_scores = torch.gather(top_scores, 1, safe)
    out_scores = torch.where(keep_valid, out_scores, torch.full_like(out_scores, NEG_INF))
    return out_boxes, out_scores, keep_valid
