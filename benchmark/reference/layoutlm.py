"""LayoutLM token classification in plain PyTorch, float32: the yardstick
that the port's document cells are held against.

Written from the published architecture (HF ``LayoutLMForTokenClassification``
without its pooler): word, position, token-type and 2-D box embeddings
summed before a LayerNorm (the x table read at x0 and x1, the y table at y0
and y1, height and width tables at y1 - y0 and x1 - x0), then post-LN BERT
layers with exact-erf GELU, then a linear head. Pad keys get the additive
-10000 mask. Parameters are a flat ``{name: tensor}`` dict under the HF
names, so one seeded dict feeds both this and the program.

``quant="int8"`` fake-quantizes the six projection sites of every layer
(query, key, value, attention output, intermediate, output) as an int8
path does: per-tensor symmetric activations, per-output-channel weights,
round half to even, the product in float32, the gradient straight
through. ``quant="fp8"`` trains them as float8 training's hybrid recipe
does: the operands rounded to e4m3 under a per-tensor scale, and the
gradient that reaches each product from above rounded to e5m2 under its
own. Those are the precisions below the configuration's bfloat16: the
control the comparison must fail.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import fake_int8

Spec = List[Tuple[str, Tuple[int, ...], Tuple[str, float]]]

_PROJ = ("attention.self.query", "attention.self.key", "attention.self.value",
         "attention.output.dense", "intermediate.dense", "output.dense")


def param_spec(cfg: Dict) -> Spec:
    """(name, shape, init) of every parameter: normal(0, initializer_range)
    for tables and projections, zero biases, unit LayerNorms."""
    h, inter, std = cfg["hidden_size"], cfg["intermediate_size"], cfg["initializer_range"]
    e = "layoutlm.embeddings."
    out: Spec = [
        (e + "word_embeddings.weight", (cfg["vocab_size"], h), ("normal", std)),
        (e + "position_embeddings.weight", (cfg["max_position_embeddings"], h), ("normal", std)),
    ]
    for t in "xyhw":
        out.append((e + f"{t}_position_embeddings.weight", (cfg["max_2d_position_embeddings"], h), ("normal", std)))
    out.append((e + "token_type_embeddings.weight", (cfg["type_vocab_size"], h), ("normal", std)))
    out += [(e + "LayerNorm.weight", (h,), ("const", 1.0)), (e + "LayerNorm.bias", (h,), ("const", 0.0))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layoutlm.encoder.layer.{i}."
        for site in _PROJ:
            fan_out, fan_in = {"intermediate.dense": (inter, h), "output.dense": (h, inter)}.get(site, (h, h))
            out += [(p + site + ".weight", (fan_out, fan_in), ("normal", std)),
                    (p + site + ".bias", (fan_out,), ("const", 0.0))]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(p + ln + ".weight", (h,), ("const", 1.0)), (p + ln + ".bias", (h,), ("const", 0.0))]
    out += [("classifier.weight", (cfg["num_labels"], h), ("normal", std)),
            ("classifier.bias", (cfg["num_labels"],), ("const", 0.0))]
    return out


def _fake_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """A float8 round trip under a per-tensor scale (the largest magnitude
    to the format's largest); straight-through gradient."""
    m = x.detach().abs().amax()
    s = torch.where(m > 0, m / torch.finfo(dtype).max, torch.ones_like(m))
    q = (x.detach() / s).to(dtype).float() * s
    return x + (q - x).detach()


class _E5M2Gradient(torch.autograd.Function):
    """Identity forward; the gradient from above rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g, torch.float8_e5m2)


def _linear(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    w, b = p[name + ".weight"], p[name + ".bias"]
    if quant == "int8":
        x, w = fake_int8(x, False), fake_int8(w, True)
    elif quant == "fp8":
        return _E5M2Gradient.apply(F.linear(_fake_fp8(x), _fake_fp8(w), b))
    return F.linear(x, w, b)


def _ln(p, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def logits(p: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor, boxes: torch.Tensor,
           mask: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """(n, s) ids, (n, s, 4) 0-1000 xyxy boxes, (n, s) 0/1 mask -> (n, s,
    num_labels) float32 logits."""
    eps = cfg["layer_norm_eps"]
    n, s = ids.shape
    top = cfg["max_2d_position_embeddings"] - 1
    b = boxes.long().clamp(0, top)
    e = "layoutlm.embeddings."
    tab = lambda t, i: F.embedding(i, p[e + t + ".weight"])  # noqa: E731
    x = (tab("word_embeddings", ids.long())
         + tab("position_embeddings", torch.arange(s, device=ids.device)[None].expand(n, s))
         + tab("token_type_embeddings", torch.zeros_like(ids, dtype=torch.long))
         + tab("x_position_embeddings", b[..., 0]) + tab("y_position_embeddings", b[..., 1])
         + tab("x_position_embeddings", b[..., 2]) + tab("y_position_embeddings", b[..., 3])
         + tab("h_position_embeddings", (b[..., 3] - b[..., 1]).clamp(0, top))
         + tab("w_position_embeddings", (b[..., 2] - b[..., 0]).clamp(0, top)))
    x = _ln(p, e + "LayerNorm", x, eps)
    heads = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // heads
    bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layoutlm.encoder.layer.{i}."
        q, k, v = (_linear(p, pre + f"attention.self.{t}", x, quant).view(n, s, heads, dh).transpose(1, 2)
                   for t in ("query", "key", "value"))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + bias, dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(n, s, -1)
        x = _ln(p, pre + "attention.output.LayerNorm", x + _linear(p, pre + "attention.output.dense", ctx, quant), eps)
        y = F.gelu(_linear(p, pre + "intermediate.dense", x, quant), approximate="none")
        x = _ln(p, pre + "output.LayerNorm", x + _linear(p, pre + "output.dense", y, quant), eps)
    return F.linear(x, p["classifier.weight"], p["classifier.bias"])


def probabilities(p, cfg, ids, boxes, mask, rows: int = 8, quant: Optional[str] = None) -> torch.Tensor:
    """Softmax of ``logits`` in blocks of ``rows`` documents, so that the
    float32 attention fits beside nothing else."""
    with torch.no_grad():
        return torch.cat([torch.softmax(logits(p, cfg, ids[i:i + rows], boxes[i:i + rows], mask[i:i + rows], quant), -1)
                          for i in range(0, ids.shape[0], rows)])


def token_loss_sum(lg: torch.Tensor, labels: torch.Tensor, ignore: int = -100) -> torch.Tensor:
    """Sum of the token cross entropies over labelled positions."""
    valid = labels != ignore
    nll = -torch.log_softmax(lg.float(), -1).gather(-1, torch.where(valid, labels, 0).long()[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum()


def decays(name: str) -> bool:
    """Weight decay on every parameter but biases and LayerNorm parameters."""
    return not (name.endswith(".bias") or ".LayerNorm." in name)


def train_steps(p0: Dict[str, torch.Tensor], cfg: Dict, opt: Dict, batches: Iterable[Dict[str, torch.Tensor]],
                rows: int = 8, quant: Optional[str] = None, fault: Optional[str] = None):
    """Clipped AdamW steps from ``p0`` over ``batches`` (keys ids, boxes,
    mask, labels): the global-norm clip, then AdamW (torch's update: decay
    by lr * wd, bias-corrected moments, eps outside the root), the learning
    rate from a linear warmup and a linear decay over ``opt["total_steps"]``
    with the first update at lr 0. The loss is the mean token cross entropy
    of the whole batch, its gradient summed over blocks of ``rows``.

    ``fault="half_batch"``: each step sees only the first half of its
    batch, the mean taken over that half (a planted fault).

    Returns (losses, first gradient by leaf after the clip, parameters after
    the last step)."""
    p = {k: v.detach().clone().float().requires_grad_() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    total = opt["total_steps"]
    warm = max(int(total * opt["warmup_ratio"]), 1)
    decay = max(total - warm, 1)
    losses, first = [], None
    for t, batch in enumerate(batches):
        if fault == "half_batch":
            batch = {k: x[: x.shape[0] // 2] for k, x in batch.items()}
        count = float((batch["labels"] != -100).sum().clamp(min=1))
        for x in p.values():
            x.grad = None
        loss = 0.0
        for i in range(0, batch["ids"].shape[0], rows):
            sl = {k: x[i:i + rows] for k, x in batch.items()}
            part = token_loss_sum(logits(p, cfg, sl["ids"], sl["boxes"], sl["mask"], quant), sl["labels"]) / count
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {k: x.grad for k, x in p.items()}
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
            clip = opt["clip_grad_norm"]
            if clip > 0 and norm >= clip:
                for g in grads.values():
                    g.mul_(clip / norm)
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            lr = opt["learning_rate"] * (t / warm if t < warm else 1.0 - min(t - warm, decay) / decay)
            step = t + 1
            for k, x in p.items():
                g = grads[k]
                if decays(k):
                    x.mul_(1.0 - lr * opt["weight_decay"])
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                x.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
    return losses, first, {k: x.detach() for k, x in p.items()}
