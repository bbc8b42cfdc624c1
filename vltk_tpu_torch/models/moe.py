"""Mixture-of-experts feed-forward block of the port.

Counterpart of ``vltk_tpu/models/moe.py``: ``moe_capacity``,
``top_k_routing`` (GShard's static dispatch plan: fixed (T, E, C) one-hot
dispatch and combine tensors, tokens past an expert's capacity dropped)
and ``MoEFeedForward``, the post-LN residual block that takes the dense
feed-forward's place in every LXMERT, LayoutLM and VisualBERT layer when
``cfg.moe_experts > 0``.

HF has no MoE, so the names are the port's own. A layer's block sits at
``moe`` (``lang_moe`` / ``visn_moe`` in LXMERT's cross-modality layers)
and holds ``router.{weight,bias}`` (an ``nn.Linear`` h -> E), the stacked
expert weights ``wi`` (E, h, f), ``bi`` (E, f), ``wo`` (E, f, h), ``bo``
(E, h) in flax's layout, and ``LayerNorm.{weight,bias}``.

Numerics as in flax: the router runs in float32 (on the card under
PyTorch's default of no TF32 for matmuls), the dispatch and the experts in
``compute_dtype`` with exact GELU, the combine in float32 so a dropped
token comes back exactly 0, and the LayerNorm of the residual sum in
float32. The Switch load-balance loss ``moe_aux_loss_weight * E *
sum(fraction * mean(probs))`` (flax sows it into ``"losses"``) is kept on
the block after each forward as ``aux_loss``, a tensor in the autograd
graph; ``moe_aux_losses(model)`` reads every block's in the order of the
forward's calls.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.parallel.mesh import current_mesh

# orders the blocks' forward calls, so ``moe_aux_losses`` returns the terms
# in the order flax sows them
_CALLS = itertools.count()


def moe_capacity(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert token capacity ``ceil(k * T / E * factor)``,
    rounded up to a multiple of 8 (at least 8). The rounding decides which
    tokens drop, so it is part of the result."""
    cap = math.ceil(top_k * tokens / num_experts * capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def top_k_routing(router_probs: torch.Tensor, top_k: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard's static dispatch plan from (T, E) float32 router
    probabilities.

    Each of the ``top_k`` rounds takes every token's best remaining expert
    (the first index on a tie), queues the tokens in order behind the
    slots earlier rounds used, and keeps those whose place is below
    ``capacity``. Returns ``dispatch`` (T, E, C) 0/1, ``combine`` (T, E, C)
    (dispatch times the kept gates, renormalised to sum to 1 a token over
    the kept choices, floor 1e-9) and ``fraction`` (E,), the share of
    tokens whose first choice was each expert; all float32."""
    t, e = router_probs.shape
    probs = router_probs
    used = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    masked = probs
    dispatch_parts: List[torch.Tensor] = []
    weight_parts: List[torch.Tensor] = []
    first_choice = None
    for k in range(top_k):
        idx = masked.argmax(dim=-1)
        if k == 0:
            first_choice = idx
        onehot = F.one_hot(idx, e).float()
        gate = (probs * onehot).sum(-1)
        pos = onehot.cumsum(0) - onehot
        pos_in_expert = (pos * onehot).sum(-1) + (used[None, :].float() * onehot).sum(-1)
        fits = pos_in_expert < capacity
        slot_id = torch.where(fits, pos_in_expert, torch.full_like(pos_in_expert, capacity)).long()
        slot = F.one_hot(slot_id, capacity + 1).float()[..., :capacity]
        dispatch_parts.append(onehot[:, :, None] * slot[:, None, :])
        weight_parts.append(gate)
        used = used + onehot.sum(0).int()
        masked = torch.where(onehot > 0, torch.full_like(masked, -math.inf), masked)
    dispatch = sum(dispatch_parts)
    kept = [d.sum(dim=(1, 2)) for d in dispatch_parts]
    denom = torch.clamp(sum(w * kp for w, kp in zip(weight_parts, kept)), min=1e-9)
    combine = sum((w / denom)[:, None, None] * d for w, d in zip(weight_parts, dispatch_parts))
    fraction = _mean0(F.one_hot(first_choice, e).float())
    return dispatch, combine, fraction


def _mean0(x: torch.Tensor) -> torch.Tensor:
    """The mean over dim 0 as XLA takes it: the sum times the float32
    reciprocal of the count (a division can differ by an ulp)."""
    return x.sum(0) * torch.tensor(1.0 / x.shape[0], dtype=torch.float32, device=x.device)


class MoEFeedForward(nn.Module):
    """Post-LN residual MoE block, in place of the dense feed-forward:
    ``LayerNorm(x + dropout(mixture of the top-k experts' GELU MLPs))``.
    ``cfg`` is an ``LxmertConfig`` (or a subclass) with ``moe_experts > 0``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        e, h, f = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = nn.Linear(h, e)
        # flax's initialiser: normal(0, initializer_range) expert stacks
        self.wi = nn.Parameter(torch.randn(e, h, f) * cfg.initializer_range)
        self.bi = nn.Parameter(torch.zeros(e, f))
        self.wo = nn.Parameter(torch.randn(e, f, h) * cfg.initializer_range)
        self.bo = nn.Parameter(torch.zeros(e, h))
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.aux_loss = None
        self._call = -1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mesh = current_mesh()
        if mesh is not None and mesh.replica_size > 1:
            # JAX routes the global batch's tokens at one capacity; a rank
            # routing its own block would drop other tokens
            raise NotImplementedError("an MoE block under a data or seq axis > 1 waits for ROADMAP A.14b")
        dt = cfg.compute_dtype
        n, s, h = x.shape
        e = cfg.moe_experts
        tokens = n * s
        cap = moe_capacity(tokens, e, cfg.moe_top_k, cfg.moe_capacity_factor)
        xt = x.reshape(tokens, h)
        logits = F.linear(xt.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, fraction = top_k_routing(probs, cfg.moe_top_k, cap)
        self.aux_loss = cfg.moe_aux_loss_weight * (e * (fraction * _mean0(probs)).sum())
        self._call = next(_CALLS)

        xe = torch.einsum("tec,th->ech", dispatch.to(dt), xt.to(dt))
        y = torch.bmm(xe, self.wi.to(dt)) + self.bi[:, None, :].to(dt)
        y = F.gelu(y, approximate="none")
        y = torch.bmm(y, self.wo.to(dt)) + self.bo[:, None, :].to(dt)
        yt = torch.einsum("tec,ech->th", combine, y.float()).to(dt)
        y = self.dropout(yt.view(n, s, h))
        return self.LayerNorm(x + y)


def moe_aux_losses(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{module name: aux loss}`` of every MoE block of ``model`` that ran
    a forward, in the order of the calls (flax's ``"losses"`` terms). The
    tensors carry their gradient; add them to a loss to train the routers."""
    ran = [(m._call, name, m.aux_loss) for name, m in model.named_modules()
           if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    return {name: loss for _, name, loss in sorted(ran, key=lambda r: r[0])}
