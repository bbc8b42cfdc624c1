"""The VG Faster R-CNN R-101-C4 extractor in plain PyTorch, float32: the
yardstick that the extraction cell is held against.

Written from the detectron / ``unc-nlp/frcnn-vg-finetuned`` description:

* preprocess: shortest edge to ``short`` (long edge at most ``maximum``),
  linear resampling without antialias at pixel centres, the edge texel
  repeated past the content, RGB -> BGR, caffe means subtracted, zero pad
  onto the canvas;
* ResNet C4: a 7x7/2 stem with frozen BN and relu, a 3x3/2 max pool in ceil
  mode, res2-res4 bottlenecks (stride in the 1x1), frozen BN after every
  conv;
* RPN: 3x3 conv, relu, objectness and deltas for 15 anchors a cell (sizes
  32-512 by ratios 0.5, 1, 2, ordered y, x, anchor), the top ``pre_nms_topk``
  logits (stable order), decode, clip, non-empty, greedy NMS at
  ``rpn_nms_thresh`` down to ``post_nms_topk``;
* RoI heads: RoIPool 14x14 at 1/16 (corners rounded half away from zero,
  bin i over [floor(i R / 14), ceil((i + 1) R / 14)) clipped to the map, an
  empty bin 0), res5 with dilation 2 and stride 1, the spatial mean, the
  class and box layers, the attribute head on the embedding of the argmax
  class over all logits;
* postprocess: softmax, the best foreground class, its box decoded with
  weights (10, 10, 5, 5) and clipped, greedy NMS at each threshold of
  ``nms_thresh_list`` until one keeps ``min_detections``, boxes scaled back
  to raw pixels.

Parameters are a flat ``{name: tensor}`` dict under the detectron names.
The stages are separate functions, so the check can run each on what the
stage before gave it: the RPN head on a given map, res5 on given
proposals, the predictors on given pooled features. Nothing here imports
the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import fake_int8

Spec = List[Tuple[str, Tuple[int, ...], Tuple[str, float]]]

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
NEG = -1e10


# ------------------------------------------------------------- parameters


def _conv_norm(prefix: str, cin: int, cout: int, k: int, mult: float) -> Spec:
    out = [(prefix + ".weight", (cout, cin, k, k), ("normal", mult / math.sqrt(cin * k * k)))]
    for leaf, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
        out.append((f"{prefix}.norm.{leaf}", (cout,), ("const", v)))
    return out


def _stage(prefix: str, n: int, cin: int, cout: int, bottleneck: int, mult: float) -> Spec:
    out: Spec = []
    for i in range(n):
        c = cin if i == 0 else cout
        out += _conv_norm(f"{prefix}.{i}.conv1", c, bottleneck, 1, mult)
        out += _conv_norm(f"{prefix}.{i}.conv2", bottleneck, bottleneck, 3, mult)
        out += _conv_norm(f"{prefix}.{i}.conv3", bottleneck, cout, 1, mult)
        if c != cout:
            out += _conv_norm(f"{prefix}.{i}.shortcut", c, cout, 1, mult)
    return out


def param_spec(cfg: Dict) -> Spec:
    """(name, shape, init) of every parameter and frozen-norm buffer, with
    the configuration's ``weight_init``: lecun-normal scales times
    ``conv_mult`` for the trunk's and the RPN's kernels, ``res5_conv_mult``
    for res5's and ``box_delta_mult`` for the two box-delta layers, zero
    biases, identity norms."""
    init = cfg["weight_init"]
    cm, dm = init["conv_mult"], init["box_delta_mult"]
    stem, c2, bw = cfg["stem_out_channels"], cfg["res2_out_channels"], cfg["num_groups"] * cfg["width_per_group"]
    spec = _conv_norm("backbone.stem.conv1", 3, stem, 7, cm)
    cin, cout = stem, c2
    for idx, n in enumerate(BLOCKS[cfg["depth"]][:3]):
        spec += _stage(f"backbone.res{idx + 2}", n, cin, cout, bw * 2 ** idx, cm)
        cin, cout = cout, cout * 2
    a = len(cfg["anchor_sizes"]) * len(cfg["aspect_ratios"])
    hid = cfg["rpn_hidden_channels"]
    r = "proposal_generator.rpn_head."
    spec += [(r + "conv.weight", (hid, cin, 3, 3), ("normal", cm / math.sqrt(cin * 9))),
             (r + "conv.bias", (hid,), ("const", 0.0)),
             (r + "objectness_logits.weight", (a, hid, 1, 1), ("normal", cm / math.sqrt(hid))),
             (r + "objectness_logits.bias", (a,), ("const", 0.0)),
             (r + "anchor_deltas.weight", (4 * a, hid, 1, 1), ("normal", dm / math.sqrt(hid))),
             (r + "anchor_deltas.bias", (4 * a,), ("const", 0.0))]
    spec += _stage("roi_heads.res5", 3, cin, cin * 2, bw * 8, init["res5_conv_mult"])
    d, ncls, natt = c2 * 8, cfg["num_classes"], cfg["num_attrs"]
    b = "roi_heads.box_predictor."
    for name, (fo, fi), mult in (("cls_score", (ncls + 1, d), 1.0), ("bbox_pred", (4 * ncls, d), dm),
                                 ("fc_attr", (d // 4, d + d // 8), 1.0), ("attr_score", (natt + 1, d // 4), 1.0)):
        spec += [(b + name + ".weight", (fo, fi), ("normal", mult / math.sqrt(fi))),
                 (b + name + ".bias", (fo,), ("const", 0.0))]
    spec.append((b + "cls_embedding.weight", (ncls + 1, d // 8), ("normal", 1.0 / math.sqrt(d // 8))))
    return spec


# ------------------------------------------------------------- preprocess


def _taps(in_size: int, out_size: int, ratio: torch.Tensor, content: torch.Tensor):
    """Two-tap linear weights along one axis, per image: sample centres at
    (i + 0.5) / ratio - 0.5, triangle weights, taps off the input dropped
    and the rest normalised, taps past the content clamped to its edge."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=ratio.device) + 0.5)[None] / ratio[:, None] - 0.5
    lo = torch.floor(pos)
    taps, weights = [], []
    for t in (lo, lo + 1):
        w = torch.clamp(1 - (pos - t).abs(), min=0) * ((t >= 0) & (t <= in_size - 1))
        taps.append(torch.minimum(t.clamp(0, in_size - 1).long(), content.long()[:, None] - 1))
        weights.append(w)
    total = weights[0] + weights[1]
    ok = (total.abs() > 1000 * float(np.finfo(np.float32).eps)) & (pos >= -0.5) & (pos <= in_size - 0.5)
    weights = [torch.where(ok, w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
               for w in weights]
    return taps, weights


def preprocess(raw: torch.Tensor, raw_hw: torch.Tensor, g: Dict):
    """(n, Hr, Wr, 3) uint8 RGB, (n, 2) raw sizes -> (image (n, ch, cw, 3)
    BGR normalised, content sizes (n, 2), raw / resized ratios (n, 2))."""
    ch, cw = g["canvas"]
    n, hr, wr, _ = raw.shape
    rh, rw = raw_hw[:, 0].float(), raw_hw[:, 1].float()
    scale = g["short"] / torch.minimum(rh, rw)
    scale = torch.where(torch.maximum(rh, rw) * scale > g["maximum"], g["maximum"] / torch.maximum(rh, rw), scale)
    new = torch.stack([torch.floor(rh * scale + 0.5), torch.floor(rw * scale + 0.5)], -1)
    (y0, y1), (wy0, wy1) = _taps(hr, ch, new[:, 0] / rh, raw_hw[:, 0])
    (x0, x1), (wx0, wx1) = _taps(wr, cw, new[:, 1] / rw, raw_hw[:, 1])
    img = raw.float()
    bi = torch.arange(n, device=raw.device)[:, None]
    rows = wy0[..., None, None] * img[bi, y0] + wy1[..., None, None] * img[bi, y1]
    bj = bi[:, :, None]
    ri = torch.arange(ch, device=raw.device)[None, :, None]
    out = wx0[:, None, :, None] * rows[bj, ri, x0[:, None]] + wx1[:, None, :, None] * rows[bj, ri, x1[:, None]]
    out = out.flip(-1) - torch.tensor(g["pixel_mean_bgr"], device=raw.device)
    inside = ((torch.arange(ch, device=raw.device)[None, :, None] < new[:, 0, None, None])
              & (torch.arange(cw, device=raw.device)[None, None, :] < new[:, 1, None, None]))
    return torch.where(inside[..., None], out, torch.zeros(())), new, raw_hw.float() / new


# --------------------------------------------------------------- backbone


def _cn(p, prefix, x, stride=1, pad=0, dil=1, relu=True):
    """Conv (no bias) + frozen BN (+ relu), NCHW float32."""
    y = F.conv2d(x, p[prefix + ".weight"], None, stride, pad, dil)
    mul = p[prefix + ".norm.weight"] * torch.rsqrt(p[prefix + ".norm.running_var"] + 1e-5)
    add = p[prefix + ".norm.bias"] - p[prefix + ".norm.running_mean"] * mul
    y = y * mul[None, :, None, None] + add[None, :, None, None]
    return F.relu(y) if relu else y


def _block(p, prefix, x, stride, dil):
    y = _cn(p, prefix + ".conv1", x, stride)
    y = _cn(p, prefix + ".conv2", y, 1, dil, dil)
    y = _cn(p, prefix + ".conv3", y, relu=False)
    sc = _cn(p, prefix + ".shortcut", x, stride, relu=False) if prefix + ".shortcut.weight" in p else x
    return F.relu(y + sc)


def backbone(p, cfg, img: torch.Tensor) -> torch.Tensor:
    """(n, H, W, 3) -> the stride-16 res4 map, NCHW."""
    x = _cn(p, "backbone.stem.conv1", img.permute(0, 3, 1, 2), 2, 3)
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    for idx, n in enumerate(BLOCKS[cfg["depth"]][:3]):
        for i in range(n):
            x = _block(p, f"backbone.res{idx + 2}.{i}", x, 2 if idx > 0 and i == 0 else 1, 1)
    return x


# -------------------------------------------------------------------- RPN


def anchors(cfg, fh: int, fw: int, device) -> torch.Tensor:
    cell = []
    for size in cfg["anchor_sizes"]:
        for ar in cfg["aspect_ratios"]:
            w = math.sqrt(float(size) ** 2 / ar)
            h = ar * w
            cell.append([-w / 2, -h / 2, w / 2, h / 2])
    cell = torch.tensor(cell, dtype=torch.float32, device=device)
    s = cfg["feature_stride"]
    ys = (torch.arange(fh, dtype=torch.float32, device=device) + cfg["anchor_offset"]) * s
    xs = (torch.arange(fw, dtype=torch.float32, device=device) + cfg["anchor_offset"]) * s
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    shift = torch.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    return (shift + cell[None]).reshape(-1, 4)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """(..., 4) deltas against (..., 4) xyxy boxes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    clamp = math.log(1000.0 / 16)
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = torch.clamp(deltas[..., 2] / weights[2], max=clamp)
    dh = torch.clamp(deltas[..., 3] / weights[3], max=clamp)
    px, py = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def clip(boxes: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """Clamp into [0, w] x [0, h]; ``hw`` (n, 2) against (n, k, 4)."""
    h, w = hw[:, None, 0], hw[:, None, 1]
    return torch.stack([torch.minimum(boxes[..., 0].clamp(min=0), w), torch.minimum(boxes[..., 1].clamp(min=0), h),
                        torch.minimum(boxes[..., 2].clamp(min=0), w), torch.minimum(boxes[..., 3].clamp(min=0), h)], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) x (..., m, 4) -> (..., n, m)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[..., 2] - x[..., 0]).clamp(min=0) * (x[..., 3] - x[..., 1]).clamp(min=0)  # noqa: E731
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def greedy_nms(boxes, scores, valid, thresh, keep: int):
    """Per row: ``keep`` greedy steps, each taking the best live box (the
    lowest index on a tie) and removing the boxes above ``thresh`` IoU with
    it. (r, k, 4), (r, k), (r, k), (r,) -> indices (r, keep) (-1 when
    none), valid (r, keep)."""
    r = scores.shape[0]
    live = torch.where(valid, scores.float(), torch.full_like(scores.float(), NEG))
    rows = torch.arange(r, device=boxes.device)
    out = torch.full((r, keep), -1, dtype=torch.long, device=boxes.device)
    for t in range(keep):
        idx = live.argmax(1)
        ok = live[rows, idx] > NEG / 2
        gone = iou(boxes[rows, idx][:, None], boxes)[:, 0] > thresh[:, None]
        gone[rows, idx] = True
        live = torch.where(ok[:, None] & gone, torch.full_like(live, NEG), live)
        out[:, t] = torch.where(ok, idx, torch.full_like(idx, -1))
    return out, out >= 0


def _conv(p, name, x, padding=0, quant=None):
    w = p[name + ".weight"]
    if quant == "int8":
        x, w = fake_int8(x, False), fake_int8(w, True)
    return F.conv2d(x, w, p[name + ".bias"], padding=padding)


def _lin(p, name, x, quant=None):
    w = p[name + ".weight"]
    if quant == "int8":
        x, w = fake_int8(x, False), fake_int8(w, True)
    return F.linear(x, w, p[name + ".bias"])


def rpn(p, feat: torch.Tensor, quant: Optional[str] = None):
    """res4 map (n, C, h, w) -> objectness (n, h, w, A) and deltas (n, h, w,
    4A). ``quant="int8"``: every product on int8 operands (per-tensor
    activations, per-output-channel weights), the control's precision."""
    r = "proposal_generator.rpn_head."
    t = F.relu(_conv(p, r + "conv", feat, 1, quant))
    logit = _conv(p, r + "objectness_logits", t, 0, quant).permute(0, 2, 3, 1)
    delta = _conv(p, r + "anchor_deltas", t, 0, quant).permute(0, 2, 3, 1)
    return logit, delta


def proposals(cfg, logit: torch.Tensor, delta: torch.Tensor, sizes: torch.Tensor):
    """The RPN's outputs -> proposals (n, post, 4) and their validity: the
    top ``pre_nms_topk`` logits (stable order), decode, clip, non-empty,
    greedy NMS down to ``post_nms_topk``."""
    n, fh, fw, _ = logit.shape
    logit, delta = logit.reshape(n, -1), delta.reshape(n, -1, 4)
    k = min(cfg["pre_nms_topk"], logit.shape[1])
    score, idx = torch.sort(logit, dim=1, descending=True, stable=True)
    score, idx = score[:, :k], idx[:, :k]
    boxes = clip(decode(delta.gather(1, idx[..., None].expand(n, k, 4)), anchors(cfg, fh, fw, logit.device)[idx],
                        cfg["rpn_bbox_reg_weights"]), sizes)
    side = cfg["min_box_side_len"]
    valid = ((boxes[..., 2] - boxes[..., 0]) > side) & ((boxes[..., 3] - boxes[..., 1]) > side)
    thr = torch.full((n,), cfg["rpn_nms_thresh"], device=logit.device)
    keep, kv = greedy_nms(boxes, score, valid, thr, cfg["post_nms_topk"])
    return boxes.gather(1, keep.clamp(min=0)[..., None].expand(-1, -1, 4)), kv


# -------------------------------------------------------------- RoI heads


def roi_pool(feat: torch.Tensor, boxes: torch.Tensor, size: int, scale: float) -> torch.Tensor:
    """(C, h, w) map, (k, 4) boxes -> (k, C, size, size), by a loop over the
    offsets inside the widest bin."""
    c, h, w = feat.shape
    s = boxes * scale
    r = torch.where(s >= 0, torch.floor(s + 0.5), torch.ceil(s - 0.5)).long()
    x1, y1, x2, y2 = r.unbind(-1)
    rw, rh = (x2 - x1 + 1).clamp(min=1)[:, None], (y2 - y1 + 1).clamp(min=1)[:, None]
    g = torch.arange(size, device=feat.device)[None]
    hs = (g * rh // size + y1[:, None]).clamp(0, h)
    he = (((g + 1) * rh + size - 1) // size + y1[:, None]).clamp(0, h)
    ws = (g * rw // size + x1[:, None]).clamp(0, w)
    we = (((g + 1) * rw + size - 1) // size + x1[:, None]).clamp(0, w)
    flat = feat.reshape(c, h * w)
    acc = torch.full((boxes.shape[0], c, size, size), float("-inf"), device=feat.device)
    for i in range(max(int((he - hs).max()), 1)):
        yy = (hs + i).clamp(max=h - 1)
        iny = (hs + i) < he
        for j in range(max(int((we - ws).max()), 1)):
            xx = (ws + j).clamp(max=w - 1)
            inx = (ws + j) < we
            v = flat[:, (yy[:, :, None] * w + xx[:, None, :])].permute(1, 0, 2, 3)
            m = (iny[:, :, None] & inx[:, None, :])[:, None]
            acc = torch.where(m, torch.maximum(acc, v), acc)
    empty = ((he - hs) <= 0)[:, :, None] | ((we - ws) <= 0)[:, None, :]
    return torch.where(empty[:, None], torch.zeros(()), acc)


def pooled(p, cfg, feat: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """One image: (C, h, w) map and (k, 4) boxes -> res5's pooled features
    (k, 2048)."""
    x = roi_pool(feat, boxes, cfg["pooler_resolution"], 1.0 / cfg["feature_stride"])
    for i in range(3):
        x = _block(p, f"roi_heads.res5.{i}", x, 1, 2)
    return x.mean(dim=(2, 3))


def predictors(p, pooled: torch.Tensor, classes: Optional[torch.Tensor] = None, quant: Optional[str] = None):
    """Pooled features (k, 2048) -> class logits (k, C+1), box deltas (k,
    4C), attribute logits (k, A+1). The attribute head embeds ``classes``
    (by default the argmax of these class logits over all of them).
    ``quant`` as in ``rpn``."""
    b = "roi_heads.box_predictor."
    cls = _lin(p, b + "cls_score", pooled, quant)
    emb = F.embedding(cls.argmax(-1) if classes is None else classes, p[b + "cls_embedding.weight"])
    attr = _lin(p, b + "attr_score", F.relu(_lin(p, b + "fc_attr", torch.cat([pooled, emb], -1), quant)), quant)
    return cls, _lin(p, b + "bbox_pred", pooled, quant), attr


def detect(cfg, props, pvalid, cls, deltas, sizes):
    """One image's postprocess on its proposals (k, 4): -> detection
    indices into the proposals (D,), their validity, every proposal's best
    class and its decoded, clipped box (k, 4)."""
    fg = torch.softmax(cls, -1)[:, :-1]
    score, best = fg.max(-1)
    k = props.shape[0]
    d = deltas.reshape(k, -1, 4)[torch.arange(k, device=props.device), best]
    boxes = clip(decode(d, props, cfg["box_reg_weights"])[None], sizes[None])[0]
    thr = torch.tensor(cfg["nms_thresh_list"], dtype=torch.float32, device=props.device)
    t = len(cfg["nms_thresh_list"])
    keep, kv = greedy_nms(boxes[None].expand(t, k, 4), score[None].expand(t, k), pvalid[None].expand(t, k), thr,
                          cfg["max_detections"])
    enough = kv.sum(1) >= cfg["min_detections"]
    choice = int(enough.nonzero()[0]) if bool(enough.any()) else t - 1
    return keep[choice], kv[choice], best, boxes
