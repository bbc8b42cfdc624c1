"""RoI heads: RoIPool + res5 + class / box / attribute predictors.

Port of ``vltk_tpu/models/roi_heads.py``. Every image carries exactly P
proposals, so pool -> res5 -> heads is one batched workload. The
reference's ``roi_chunk`` scan becomes a loop over chunks of
``max(roi_chunk // N, 1)`` RoIs per image: each chunk pools its own box
slice (``ops.roi_pool_kernel.roi_pool_auto``, the CUDA kernel on the card)
and reduces it through res5 at once, so the full (N*P, 14, 14, C) pooled
tensor never exists. Every chunk runs the same res5 modules, so the int8
path (``int8=True``) uses one set of recorded scales for all; without
them each chunk quantizes by its own maxima, the last chunk padded with
zero boxes to the chunk size as JAX's scan pads it. RoIPool reads the
float res4 map either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.models.backbone import Res5Head
from vltk_tpu_torch.models.layers import compute_dtype
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto


class FastRCNNOutputLayers(nn.Module):
    """cls_score (C+1), bbox_pred (C*4), and the VG attribute head: the
    embedding of the argmax class (over all C+1 logits, background
    included), concatenated onto the pooled feature -> fc -> attr scores."""

    def __init__(
        self,
        num_classes: int = 1600,
        num_attrs: int = 400,
        input_size: int = 2048,
        cls_agnostic_bbox_reg: bool = False,
        use_attr: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.use_attr = use_attr
        self.cls_score = nn.Linear(input_size, num_classes + 1)
        num_reg = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = nn.Linear(input_size, num_reg * 4)
        if use_attr:
            self.cls_embedding = nn.Embedding(num_classes + 1, input_size // 8)
            self.fc_attr = nn.Linear(input_size + input_size // 8, input_size // 4)
            self.attr_score = nn.Linear(input_size // 4, num_attrs + 1)

    def _linear(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, layer.weight, self.dtype)
        return F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))

    def forward(
        self, x: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        scores = self._linear(self.cls_score, x)
        deltas = self._linear(self.bbox_pred, x)
        if not self.use_attr:
            return scores, None, deltas
        max_class = torch.argmax(scores, dim=-1)
        table = self.cls_embedding.weight
        emb = F.embedding(max_class, table.to(self.dtype or table.dtype))
        attr = torch.cat([x.to(emb.dtype), emb], dim=-1)
        attr = F.relu(self._linear(self.fc_attr, attr))
        attr_scores = self._linear(self.attr_score, attr)
        return scores, attr_scores, deltas


class Res5RoIHeads(nn.Module):
    """RoIPool(S x S, 1/stride) -> res5 -> global mean -> predictors."""

    def __init__(
        self,
        num_classes: int = 1600,
        num_attrs: int = 400,
        res2_out_channels: int = 256,
        num_groups: int = 1,
        width_per_group: int = 64,
        stride_in_1x1: bool = True,
        pooler_resolution: int = 14,
        feature_stride: int = 16,
        res5_halve: bool = False,
        use_attr: bool = True,
        cls_agnostic_bbox_reg: bool = False,
        dtype: Optional[torch.dtype] = None,
        roi_chunk: Optional[int] = None,
        int8: bool = False,
    ):
        super().__init__()
        self.pooler_resolution = pooler_resolution
        self.feature_stride = feature_stride
        self.roi_chunk = roi_chunk
        self.int8 = int8
        self.res5 = Res5Head(
            res2_out_channels=res2_out_channels,
            num_groups=num_groups,
            width_per_group=width_per_group,
            stride_in_1x1=stride_in_1x1,
            halve=res5_halve,
            dtype=dtype,
            int8=int8,
        )
        self.box_predictor = FastRCNNOutputLayers(
            num_classes=num_classes,
            num_attrs=num_attrs,
            input_size=res2_out_channels * 8,
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            use_attr=use_attr,
            dtype=dtype,
        )

    def _pool_res5(self, features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Pool one (N, Pc) box slice and reduce it: -> (N, Pc, 2048)."""
        n, pc = boxes.shape[:2]
        res = self.pooler_resolution
        pooled = roi_pool_auto(
            features, boxes, output_size=res, spatial_scale=1.0 / self.feature_stride
        )  # (N, Pc, res, res, C)
        y = self.res5(pooled.reshape(n * pc, res, res, features.shape[-1]))
        return y.mean(dim=(1, 2)).reshape(n, pc, -1)

    def forward(
        self, features: torch.Tensor, boxes: torch.Tensor
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
        """features (N, Hf, Wf, C); boxes (N, P, 4) xyxy image coords.

        Returns (obj_logits, attr_logits, box_deltas, pooled_features),
        all (N, P, ...).
        """
        n, p = boxes.shape[:2]
        features = features.contiguous()
        if self.roi_chunk is not None and n * p > self.roi_chunk:
            pc = max(int(self.roi_chunk) // n, 1)
            if self.int8 and p % pc:
                # a chunk's dynamic int8 scales read its pad rows too
                boxes = torch.cat([boxes, boxes.new_zeros((n, pc - p % pc, 4))], dim=1)
            chunks = [
                self._pool_res5(features, boxes[:, s:s + pc]) for s in range(0, boxes.shape[1], pc)
            ]
            feat = torch.cat(chunks, dim=1)[:, :p].reshape(n * p, -1)
        else:
            feat = self._pool_res5(features, boxes).reshape(n * p, -1)
        obj_logits, attr_logits, deltas = self.box_predictor(feat)

        def unflat(t):
            return None if t is None else t.reshape(n, p, *t.shape[1:])

        return unflat(obj_logits), unflat(attr_logits), unflat(deltas), unflat(feat)
