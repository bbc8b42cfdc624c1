"""Faster R-CNN (ResNet-C4 + VG attribute head), batched, fixed shapes.

Port of ``vltk_tpu/models/frcnn.py``. ``FRCNNConfig`` is the port's own
copy of the reference dataclass with the same field set; the model's
submodules carry the reference torch names (``backbone``,
``proposal_generator.rpn_head``, ``roi_heads``), so a reference state dict
loads as it is.

The reference's retry-NMS over a threshold list runs here as one batched
NMS over (image, threshold) rows, and the first threshold whose keep count
reaches ``min_detections`` is taken (the last one when none does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vltk_tpu_torch.models.anchors import grid_anchors
from vltk_tpu_torch.models.backbone import ResNetC4
from vltk_tpu_torch.models.layers import ConvNorm, FrozenBatchNorm, calibrate_int8_scales, lecun_normal_
from vltk_tpu_torch.models.roi_heads import Res5RoIHeads
from vltk_tpu_torch.models.rpn import RPNHead, propose
from vltk_tpu_torch.ops.boxes import apply_deltas, clip_boxes
from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class FRCNNConfig:
    """Static model hyper-parameters; the field set of the reference's
    ``FRCNNConfig``. Defaults are the VG extraction setup: nms list
    [0.5, 1.0, 0.1], min = max = 36 detections."""

    # backbone
    depth: int = 101
    stem_out_channels: int = 64
    res2_out_channels: int = 256
    num_groups: int = 1
    width_per_group: int = 64
    stride_in_1x1: bool = True
    caffe_maxpool: bool = True
    feature_stride: int = 16
    # anchors / RPN
    anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512)
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)
    anchor_offset: float = 0.0
    rpn_hidden_channels: int = 512
    rpn_nms_thresh: float = 0.7
    pre_nms_topk: int = 6000
    post_nms_topk: int = 1000
    min_box_side_len: float = 0.0
    rpn_bbox_reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    # the reference's TPU program-shape knobs for its NMS (blocked greedy,
    # scan unroll, batch chunking); kept so configs carry over, ignored
    # here: the keep-set is the same whatever they say
    rpn_nms_block: int = 64
    rpn_nms_unroll: int = 4
    rpn_nms_chunk: int = 16
    # RoI heads
    num_classes: int = 1600
    num_attrs: int = 400
    pooler_resolution: int = 14
    res5_halve: bool = False
    use_attr: bool = True
    cls_agnostic_bbox_reg: bool = False
    box_reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0)
    # detection selection
    nms_thresh_list: Sequence[float] = (0.5, 1.0, 0.1)
    min_detections: int = 36
    max_detections: int = 36
    # compute dtype for convs/matmuls (None -> float32); params stay f32
    dtype: Optional[str] = None
    # int8 path for every bottleneck conv (res2-4 and res5): per-channel
    # weights, per-tensor activations, int32 sums; calibrate_int8 records
    # static activation scales
    int8: bool = False
    # res5 RoI chunking: pool + res5 run per chunk of this many RoIs when
    # batch * proposals exceeds it. None = one pass.
    roi_chunk: Optional[int] = 2400
    # rematerialise backbone blocks in a backward pass (training only;
    # inference never sees a backward, so it does nothing here)
    remat: bool = False

    @classmethod
    def vg_extraction(cls, **overrides) -> "FRCNNConfig":
        """The VG 36-box extraction parity geometry: 6000 pre-NMS and 300
        post-NMS proposals, bf16 compute."""
        kwargs = dict(pre_nms_topk=6000, post_nms_topk=300, dtype="bfloat16")
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def fast_extraction(cls, **overrides) -> "FRCNNConfig":
        """Throughput preset (not detection parity): 100 proposals, bf16."""
        kwargs = dict(
            pre_nms_topk=2000, post_nms_topk=100, dtype="bfloat16", roi_chunk=1600,
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def int8_extraction(cls, **overrides) -> "FRCNNConfig":
        """The parity geometry on the int8 conv path; the extraction step
        calibrates it on its first batch (``calibrate_int8``)."""
        kwargs = dict(dtype="bfloat16", int8=True, pre_nms_topk=6000, post_nms_topk=300)
        kwargs.update(overrides)
        return cls(**kwargs)

    #: named extraction presets: name -> (factory, overrides)
    PRESETS = {
        "parity_300": ("vg_extraction", {}),
        "props_200": ("vg_extraction", dict(pre_nms_topk=4000, post_nms_topk=200)),
        "props_150": ("vg_extraction", dict(pre_nms_topk=3000, post_nms_topk=150)),
        "props_100": ("fast_extraction", {}),
        "fast": ("fast_extraction", {}),
        "int8_300": ("int8_extraction", {}),
        "int8_200": ("int8_extraction", dict(pre_nms_topk=4000, post_nms_topk=200)),
        "int8_150": ("int8_extraction", dict(pre_nms_topk=3000, post_nms_topk=150)),
        "int8_100": (
            "int8_extraction",
            dict(pre_nms_topk=2000, post_nms_topk=100, roi_chunk=1600),
        ),
        "production": ("int8_extraction", {}),
    }

    @classmethod
    def named_preset(cls, name: str, **overrides) -> "FRCNNConfig":
        """Build a named extraction preset."""
        if name not in cls.PRESETS:
            raise ValueError(f"unknown preset {name!r}; known: {sorted(cls.PRESETS)}")
        factory, kw = cls.PRESETS[name]
        return getattr(cls, factory)(**{**kw, **overrides})

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.aspect_ratios)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.dtype is None else _DTYPES[str(self.dtype)]


def _select_detections(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    nms_thresh_list: Sequence[float],
    min_detections: int,
    max_detections: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's retry-NMS, batched: NMS at every threshold of the
    list for every image in one call over (N*T) rows, then per image the
    first threshold whose keep count reaches ``min_detections``, or the
    last threshold when none does.

    boxes (N, P, 4), scores (N, P), valid (N, P) -> keep, keep_valid (N, D).
    """
    n, p = scores.shape
    t = len(nms_thresh_list)
    thr = torch.tensor(nms_thresh_list, dtype=torch.float32, device=boxes.device)
    keeps, valids = nms_fixed_auto(
        boxes[:, None].expand(n, t, p, 4).reshape(n * t, p, 4),
        scores[:, None].expand(n, t, p).reshape(n * t, p),
        thr.repeat(n),
        max_detections,
        valid=valid[:, None].expand(n, t, p).reshape(n * t, p),
    )
    keeps = keeps.reshape(n, t, max_detections)
    valids = valids.reshape(n, t, max_detections)
    stop = valids.sum(dim=2) >= min_detections  # (N, T)
    first = torch.argmax(stop.to(torch.int32), dim=1)  # first True, 0 if none
    choice = torch.where(stop.any(dim=1), first, torch.full_like(first, t - 1))
    rows = torch.arange(n, device=boxes.device)
    return keeps[rows, choice], valids[rows, choice]


class RPN(nn.Module):
    """The proposal generator: ``rpn_head`` + anchors + :func:`propose`."""

    def __init__(self, cfg: FRCNNConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.rpn_head = RPNHead(in_channels, cfg.num_anchors, cfg.rpn_hidden_channels)
        self._anchors: Dict[Tuple, torch.Tensor] = {}

    def anchors(self, feat_hw: Tuple[int, int], device) -> torch.Tensor:
        key = (*feat_hw, str(device))
        if key not in self._anchors:
            cfg = self.cfg
            self._anchors[key] = grid_anchors(
                feat_hw, stride=cfg.feature_stride, sizes=cfg.anchor_sizes,
                aspect_ratios=cfg.aspect_ratios, offset=cfg.anchor_offset,
                device=device,
            )
        return self._anchors[key]

    def forward(self, feats, image_sizes, scales_yx=None, ignorey=None):
        cfg = self.cfg
        logits, deltas = self.rpn_head(feats)
        anchors = self.anchors((feats.shape[1], feats.shape[2]), feats.device)
        boxes, scores, valid = propose(
            logits, deltas, anchors, image_sizes,
            nms_thresh=cfg.rpn_nms_thresh,
            pre_nms_topk=cfg.pre_nms_topk,
            post_nms_topk=cfg.post_nms_topk,
            min_box_side_len=cfg.min_box_side_len,
            bbox_reg_weights=cfg.rpn_bbox_reg_weights,
            ignorey=ignorey,
            scales_yx=scales_yx,
        )
        return logits, deltas, anchors, boxes, scores, valid


class FRCNN(nn.Module):
    """End-to-end batched inference: images -> fixed-D detections."""

    def __init__(self, cfg: FRCNNConfig = FRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        self.backbone = ResNetC4(
            depth=cfg.depth,
            stem_out_channels=cfg.stem_out_channels,
            res2_out_channels=cfg.res2_out_channels,
            num_groups=cfg.num_groups,
            width_per_group=cfg.width_per_group,
            stride_in_1x1=cfg.stride_in_1x1,
            caffe_maxpool=cfg.caffe_maxpool,
            dtype=dtype,
            int8=cfg.int8,
        )
        self.proposal_generator = RPN(cfg, self.backbone.out_channels)
        self.roi_heads = Res5RoIHeads(
            num_classes=cfg.num_classes,
            num_attrs=cfg.num_attrs,
            res2_out_channels=cfg.res2_out_channels,
            num_groups=cfg.num_groups,
            width_per_group=cfg.width_per_group,
            stride_in_1x1=cfg.stride_in_1x1,
            pooler_resolution=cfg.pooler_resolution,
            feature_stride=cfg.feature_stride,
            res5_halve=cfg.res5_halve,
            use_attr=cfg.use_attr,
            cls_agnostic_bbox_reg=cfg.cls_agnostic_bbox_reg,
            dtype=dtype,
            roi_chunk=cfg.roi_chunk,
            int8=cfg.int8,
        )

    def forward(
        self,
        images: torch.Tensor,
        image_sizes: torch.Tensor,
        scales_yx: Optional[torch.Tensor] = None,
        ignorey: Optional[torch.Tensor] = None,
        return_raw: bool = False,
    ):
        """Args:
          images: (N, H, W, 3) BGR caffe-normalised, padded to the canvas.
          image_sizes: (N, 2) float (h, w) of the content inside the pad.
          scales_yx: optional (N, 2); boxes are multiplied back to raw-image
            coordinates.
          ignorey: optional (N, J, 2) document y-bands for the RPN.
          return_raw: also return the pre-postprocess tensors under "raw".

        Returns a dict: boxes (N, D, 4), obj_ids (N, D), obj_probs (N, D),
        attr_ids (N, D), attr_probs (N, D), roi_features (N, D, 2048),
        preds_per_image (N,), mask (N, D), D = cfg.max_detections.
        """
        cfg = self.cfg
        feats = self.backbone(images)
        logits, deltas, anchors, prop_boxes, prop_scores, prop_valid = (
            self.proposal_generator(feats, image_sizes, scales_yx, ignorey)
        )
        obj_logits, attr_logits, box_deltas, pooled = self.roi_heads(feats, prop_boxes)
        obj_logits = obj_logits.to(torch.float32)
        box_deltas = box_deltas.to(torch.float32)
        pooled = pooled.to(torch.float32)
        if attr_logits is not None:
            attr_logits = attr_logits.to(torch.float32)

        out = _postprocess(
            cfg, prop_boxes, prop_valid, obj_logits, attr_logits, box_deltas,
            pooled, image_sizes, scales_yx,
        )
        if return_raw:
            n = logits.shape[0]
            out["raw"] = {
                "rpn_logits": logits.to(torch.float32).reshape(n, -1),
                "rpn_deltas": deltas.to(torch.float32).reshape(n, -1, 4),
                "anchors": anchors,
                "proposals": prop_boxes,
                "prop_scores": prop_scores,
                "prop_valid": prop_valid,
                "obj_logits": obj_logits,
                "attr_logits": attr_logits,
                "box_deltas": box_deltas,
            }
        return out


def _postprocess(
    cfg: FRCNNConfig,
    prop_boxes: torch.Tensor,
    prop_valid: torch.Tensor,
    obj_logits: torch.Tensor,
    attr_logits: Optional[torch.Tensor],
    box_deltas: torch.Tensor,
    pooled: torch.Tensor,
    image_sizes: torch.Tensor,
    scales_yx: Optional[torch.Tensor],
):
    """Softmax, class-specific decode, retry-NMS down to D detections,
    gather, rescale to raw coordinates, mask."""
    n, p = obj_logits.shape[:2]
    d = cfg.max_detections

    probs = torch.softmax(obj_logits, dim=-1)  # (N, P, C+1)
    fg = probs[..., :-1]  # drop background
    max_scores = torch.amax(fg, dim=-1)
    max_classes = torch.argmax(fg, dim=-1)

    if cfg.cls_agnostic_bbox_reg:
        sel_deltas = box_deltas
    else:
        flat = box_deltas.reshape(n, p, cfg.num_classes, 4)
        sel_deltas = torch.gather(
            flat, 2, max_classes[..., None, None].expand(n, p, 1, 4)
        ).squeeze(2)
    decoded = apply_deltas(sel_deltas, prop_boxes, weights=tuple(cfg.box_reg_weights))
    clipped = clip_boxes(decoded, image_sizes.to(torch.float32))
    keep, keep_valid = _select_detections(
        clipped, max_scores, prop_valid, cfg.nms_thresh_list,
        cfg.min_detections, cfg.max_detections,
    )

    safe = torch.clamp(keep, min=0).to(torch.int64)  # (N, D)

    def take(t):
        idx = safe.reshape(n, d, *([1] * (t.dim() - 2))).expand(n, d, *t.shape[2:])
        return torch.gather(t, 1, idx)

    out_boxes = take(clipped)
    out_scores = take(max_scores)
    out_classes = take(max_classes)
    out_feats = take(pooled)

    if attr_logits is not None:
        attr_fg = torch.softmax(attr_logits[..., :-1], dim=-1)
        out_attr_probs = take(torch.amax(attr_fg, dim=-1))
        out_attrs = take(torch.argmax(attr_fg, dim=-1))
    else:
        out_attr_probs = torch.zeros((n, d), dtype=torch.float32, device=pooled.device)
        out_attrs = torch.full((n, d), -1, dtype=torch.int64, device=pooled.device)

    if scales_yx is not None:
        sy = scales_yx[:, 0][:, None].to(out_boxes.dtype)
        sx = scales_yx[:, 1][:, None].to(out_boxes.dtype)
        out_boxes = torch.stack(
            [
                out_boxes[..., 0] * sx,
                out_boxes[..., 1] * sy,
                out_boxes[..., 2] * sx,
                out_boxes[..., 3] * sy,
            ],
            dim=-1,
        )

    m = keep_valid
    mf = m[..., None].to(out_boxes.dtype)
    minus1 = torch.full_like(out_classes, -1)
    return {
        "boxes": out_boxes * mf,
        "obj_ids": torch.where(m, out_classes, minus1).to(torch.int32),
        "obj_probs": torch.where(m, out_scores, torch.zeros_like(out_scores)),
        "attr_ids": torch.where(m, out_attrs, torch.full_like(out_attrs, -1)).to(torch.int32),
        "attr_probs": torch.where(m, out_attr_probs, torch.zeros_like(out_attr_probs)),
        "roi_features": out_feats * m[..., None].to(out_feats.dtype),
        "preds_per_image": m.sum(dim=1).to(torch.int32),
        "mask": m,
    }


def calibrate_int8(model: FRCNN, batches) -> Dict[str, torch.Tensor]:
    """Static int8 calibration of an int8 FRCNN (JAX's ``calibrate_int8``):
    each ``(images, image_sizes[, scales_yx])`` batch runs through the
    model's unchunked twin (the same modules with ``roi_chunk=None``), so
    every res5 conv sees all of a batch's RoIs at once, as the JAX package
    calibrates; the recorded scales then serve the chunked model too.
    Returns ``{module name: act_max}``, loaded in ``model`` as well. Keep
    calibration batches small (at most 4 images at the parity geometry):
    the unchunked pooled tensor is large."""
    heads = model.roi_heads
    saved, heads.roi_chunk = heads.roi_chunk, None
    try:
        return calibrate_int8_scales(model, [tuple(batch) for batch in batches])
    finally:
        heads.roi_chunk = saved


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights with the reference's (flax) initialisers:
    lecun-normal conv and linear kernels, zero biases, identity frozen
    norms, fan-in normal class embedding. Deterministic for a seed
    whatever the device: the numbers are drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (ConvNorm, nn.Conv2d)):
                w = mod.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_(lecun_normal_(torch.empty(w.shape), fan_in, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(lecun_normal_(torch.empty(mod.weight.shape), mod.in_features, gen))
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = mod.weight
                w.copy_(lecun_normal_(torch.empty(w.shape), w.shape[1], gen))
            elif isinstance(mod, FrozenBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model
