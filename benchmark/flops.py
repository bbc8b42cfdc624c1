"""The yardstick's arithmetic: the chip's peaks, model FLOPs from a
configuration and an input's real size, and a kernel's least time.

A multiply-add counts as two operations. Model FLOPs count the matrix
products and convolutions a forward needs on the real content: the resized
image and not the canvas pad, the real tokens and not the pad. A training
step counts three forwards.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

# NVIDIA H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, nflops: float, flops_per_s: float = PEAK_BF16_FLOPS) -> float:
    """The least time: bytes read once and written once over the memory
    rate, or operations over the peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, nflops / flops_per_s)


# ---------------------------------------------------------------- LayoutLM


def layoutlm_forward(cfg: Dict, length: int) -> float:
    """One document of ``length`` real tokens through the encoder and the
    token head: the four attention projections, the two feed-forward
    products, scores and context over the real keys."""
    h, i, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    per_layer = 8 * length * h * h + 4 * length * h * i + 4 * length * length * h
    return n * per_layer + 2 * length * h * cfg["num_labels"]


def attention_pairs(lengths: Sequence[int]) -> float:
    """Query-key pairs among real tokens of each row."""
    return float(sum(int(x) ** 2 for x in lengths))


def attention_forward_flops(pairs: float, heads: int, head_dim: int) -> float:
    return 4.0 * pairs * heads * head_dim


def attention_backward_flops(pairs: float, heads: int, head_dim: int) -> float:
    """Scores recomputed, then dP, dV, dQ and dK: five products."""
    return 10.0 * pairs * heads * head_dim


# ------------------------------------------------------------------- FRCNN


def _out(size: int, k: int, stride: int, pad: int, dil: int = 1) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _bottleneck(h, w, cin, cout, mid, stride):
    """FLOPs and output size of one bottleneck (stride in the 1x1)."""
    ho, wo = _out(h, 1, stride, 0), _out(w, 1, stride, 0)
    f = _conv(ho, wo, cin, mid, 1) + _conv(ho, wo, mid, mid, 3) + _conv(ho, wo, mid, cout, 1)
    if cin != cout:
        f += _conv(ho, wo, cin, cout, 1)
    return f, ho, wo


def resized_size(raw_h: int, raw_w: int, short: float, maximum: float):
    """The content size after the shortest-edge resize."""
    scale = short / min(raw_h, raw_w)
    if max(raw_h, raw_w) * scale > maximum:
        scale = maximum / max(raw_h, raw_w)
    return int(math.floor(raw_h * scale + 0.5)), int(math.floor(raw_w * scale + 0.5))


def frcnn_image(cfg: Dict, h: int, w: int) -> float:
    """One image of content h x w: the R-C4 trunk, the RPN head, res5 and
    the predictors over ``post_nms_topk`` proposals."""
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[cfg["depth"]]
    stem, c = cfg["stem_out_channels"], cfg["res2_out_channels"]
    mid = cfg["num_groups"] * cfg["width_per_group"]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    f = _conv(h, w, 3, stem, 7)
    h, w = math.ceil((h - 3) / 2) + 1, math.ceil((w - 3) / 2) + 1
    cin = stem
    for idx, n in enumerate(blocks[:3]):
        for b in range(n):
            g, h, w = _bottleneck(h, w, cin if b == 0 else c, c, mid, 2 if idx > 0 and b == 0 else 1)
            f += g
        cin, c, mid = c, c * 2, mid * 2
    a = len(cfg["anchor_sizes"]) * len(cfg["aspect_ratios"])
    hid = cfg["rpn_hidden_channels"]
    f += _conv(h, w, cin, hid, 3) + _conv(h, w, hid, 5 * a, 1)
    s = cfg["pooler_resolution"]
    roi = 0.0
    for b in range(3):
        g, _, _ = _bottleneck(s, s, cin if b == 0 else c, c, mid, 1)
        roi += g
    d, ncls, natt = c, cfg["num_classes"], cfg["num_attrs"]
    roi += 2.0 * d * (ncls + 1 + 4 * ncls) + 2.0 * (d + d // 8) * (d // 4) + 2.0 * (d // 4) * (natt + 1)
    return f + cfg["post_nms_topk"] * roi
