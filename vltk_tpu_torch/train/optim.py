"""Optimizer factory: AdamW, linear warmup and decay, global-norm clipping.

Counterpart of ``vltk_tpu/train/optim.py``, whose optax chain is
``clip_by_global_norm`` then ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside
the square root, decoupled weight decay on a mask). Here it is
``torch.optim.AdamW`` with two parameter groups (decay, no decay) and a
``LambdaLR`` schedule; the clip runs inside the optimizer's ``step``, as it
runs inside the optax chain, with optax's rule (``g * max_norm / norm``
when ``norm >= max_norm``, on the device, no host sync).

The schedule is optax's ``join_schedules`` of two linear pieces with the
optimizer's update count as its argument, so the first update gets lr 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

_NO_DECAY_MODULES = ("ln", "layernorm", "norm")


def linear_warmup_linear_decay(total_steps: int, warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """The factor on the base lr after ``count`` updates: 0 -> 1 over the
    warmup, then 1 -> 0 over the remainder (clipped at 0)."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps - warmup, 1)

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        return 1.0 - min(count - warmup, decay) / decay

    return factor


def decays(name: str) -> bool:
    """The JAX package's ``_decay_mask`` on torch names: no decay for
    biases and for every parameter of a LayerNorm (``LayerNorm.weight`` is
    flax's ``scale``); decay for everything else, embedding tables
    included."""
    *mods, leaf = name.split(".")
    if leaf == "bias":
        return False
    return not any(m.lower() in _NO_DECAY_MODULES for m in mods)


def param_groups(model: nn.Module, weight_decay: float) -> List[Dict]:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return [
        {"params": [p for n, p in named if decays(n)], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n)], "weight_decay": 0.0},
    ]


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the gradients to a global L2 norm of
    ``clip_grad_norm`` (0 = no clip)."""

    def __init__(self, params: Iterable, clip_grad_norm: float = 0.0, **kwargs):
        super().__init__(params, **kwargs)
        self.clip_grad_norm = float(clip_grad_norm or 0.0)

    @torch.no_grad()
    def clip_(self) -> None:
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if not grads or self.clip_grad_norm <= 0:
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2.0)))
        scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm), self.clip_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    def step(self, closure=None):
        self.clip_()
        return super().step(closure)


def make_optimizer(
    model: nn.Module, train_config, total_steps: int, freeze_patterns=(),
) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) with the semantics of the JAX package's
    ``make_optimizer``: step the optimizer, then the scheduler."""
    if freeze_patterns:
        raise NotImplementedError(
            "freeze_patterns are flax path regexes and match no torch name yet (ROADMAP A.13)"
        )
    opt = ClippedAdamW(
        param_groups(model, train_config.weight_decay),
        clip_grad_norm=getattr(train_config, "clip_grad_norm", 0.0),
        lr=train_config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )
    schedule = linear_warmup_linear_decay(total_steps, train_config.warmup_ratio)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
