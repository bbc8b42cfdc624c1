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

Under a mesh the block routes as JAX routes the global batch: the
router's (T, E) float32 probabilities are gathered over the ``data`` ranks
(and the ``seq`` ranks of a cut stream) in the global (batch, seq) order,
placed by each rank's coordinates, and every rank computes the same plan
at ``moe_capacity`` of the global token count and keeps its tokens' rows.
The gather's backward is a reduce-scatter, so the router's gradient after
the data-parallel reduce is JAX's. Each rank fills its partial (E, C, h)
slots from its tokens and the token ranks sum them (all-reduce; a slot
holds one token, so the sum is exact). With ``LXMERT_MOE_RULES`` the
stacks are cut over ``expert`` (and each expert's hidden dim over
``model``): a rank runs its E/ep experts, combines over them in float32,
and the expert ranks sum the mixture (all-reduce, then the cast to the
compute type). All-reduces rather than all-to-alls: every rank holds the
whole plan, and the slots of a rank's experts are one all-reduce away.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.parallel import collectives as C
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

    def forward(self, x: torch.Tensor, seq_cut: bool = False) -> torch.Tensor:
        """``x``: (n, s, h), under a mesh this rank's block of the global
        batch (rows over ``data``; columns over ``seq`` where ``seq_cut``).
        The tokens are routed as the global batch's, at one capacity."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        n, s, h = x.shape
        e = cfg.moe_experts
        route = _TokenRoute.of(current_mesh(), n, s, seq_cut)
        xt = x.reshape(n * s, h)
        logits = F.linear(xt.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        if route is not None:
            probs = route.gather(probs.view(n, s, e)).reshape(-1, e)
        cap = moe_capacity(probs.shape[0], e, cfg.moe_top_k, cfg.moe_capacity_factor)
        dispatch, combine, fraction = top_k_routing(probs, cfg.moe_top_k, cap)
        self.aux_loss = cfg.moe_aux_loss_weight * (e * (fraction * _mean0(probs)).sum())
        self._call = next(_CALLS)
        if route is not None:  # this rank's tokens' rows of the plan
            dispatch, combine = route.local(dispatch), route.local(combine)

        layout = getattr(self, "ep", None)  # set by parallel.shard_params
        if layout is not None and layout.expert_cut:
            # this rank's experts; the other expert ranks hold the same tokens
            # and the rest. The tokens and the plan enter whole, so the
            # backward's sum over the expert ranks puts their shares together
            group, e0 = layout.mesh.group("expert"), layout.mesh.coord("expert") * self.wi.shape[0]
            xt, combine = C.copy_to_tp(xt, group, "ep_copy"), C.copy_to_tp(combine, group, "ep_copy")
            dispatch, combine = (t.narrow(1, e0, self.wi.shape[0]) for t in (dispatch, combine))
        xe = torch.einsum("tec,th->ech", dispatch.to(dt), xt.to(dt))
        if route is not None:
            # every (expert, slot) holds at most one token: the ranks' partial
            # slots sum exactly
            xe = C.sum_partials(xe, route.group)
        y = self._experts(xe, layout, dt)
        yt = torch.einsum("tec,ech->th", combine, y.float())
        if layout is not None and layout.expert_cut:
            yt = C.reduce_from_tp(yt, layout.mesh.group("expert"), "moe_combine_reduce")
        y = self.dropout(yt.to(dt).view(n, s, h))
        return self.LayerNorm(x + y)

    def _experts(self, xe: torch.Tensor, layout, dt: torch.dtype) -> torch.Tensor:
        """The experts' GELU MLPs on their slots (E, C, h); each column- then
        row-cut over ``model`` where the layout says, ``bo`` added once after
        the model axis' sum."""
        model_cut = layout is not None and layout.model_cut
        if model_cut:
            xe = C.copy_to_tp(xe, layout.mesh.group("model"))
        y = torch.bmm(xe, self.wi.to(dt)) + self.bi[:, None, :].to(dt)
        y = F.gelu(y, approximate="none")
        y = torch.bmm(y, self.wo.to(dt))
        if model_cut:
            y = C.reduce_from_tp(y, layout.mesh.group("model"))
        return y + self.bo[:, None, :].to(dt)


@dataclasses.dataclass(frozen=True)
class ExpertLayout:
    """How ``parallel.shard_params`` cut a block's expert stacks: their
    leading expert dim over ``expert`` and/or each expert's hidden dim
    over ``model``."""

    mesh: object
    expert_cut: bool
    model_cut: bool


@dataclasses.dataclass(frozen=True)
class _TokenRoute:
    """Where this rank's tokens sit in the global batch: the group of ranks
    that hold the other tokens of the replica (``data``, and ``seq`` where
    the stream is cut), each rank's block at its (data, seq) coordinates,
    and this rank's rows of the global row-major (batch, seq) order."""

    group: object
    places: Tuple[Tuple[int, int], ...]
    rows: torch.Tensor

    @staticmethod
    def of(mesh, n: int, s: int, seq_cut: bool) -> Optional["_TokenRoute"]:
        axes = [a for a in ("data", "seq") if a in getattr(mesh, "shape", {}) and (a == "data" or seq_cut)]
        if not axes:
            return None
        group = mesh.group(axes[0]) if len(axes) == 1 else mesh.replica_group
        names = mesh.axis_names
        grid = tuple(mesh.shape[a] for a in names)

        def place(rank: int) -> Tuple[int, int]:
            coord = dict(zip(names, np.unravel_index(rank, grid)))
            return int(coord.get("data", 0)), int(coord["seq"]) if seq_cut else 0

        places = tuple(place(r) for r in dist.get_process_group_ranks(group))
        d, q = place(dist.get_rank())
        cols = s * (1 + max(p[1] for p in places))
        start = d * n * cols + q * s
        rows = (start + torch.arange(n)[:, None] * cols + torch.arange(s)[None, :]).reshape(-1)
        return _TokenRoute(group, places, rows)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """(n, s, ...) of this rank -> (N, S, ...) of the global batch."""
        return C.gather_tokens(local, self.group, self.places)

    def local(self, plan: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (N * S, ...) tensor: a view where they are
        one run, else a gather."""
        first, count = int(self.rows[0]), self.rows.numel()
        if int(self.rows[-1]) == first + count - 1:
            return plan.narrow(0, first, count)
        return plan.index_select(0, self.rows.to(plan.device))


def moe_aux_losses(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``{module name: aux loss}`` of every MoE block of ``model`` that ran
    a forward, in the order of the calls (flax's ``"losses"`` terms). The
    tensors carry their gradient; add them to a loss to train the routers."""
    ran = [(m._call, name, m.aux_loss) for name, m in model.named_modules()
           if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    return {name: loss for _, name, loss in sorted(ran, key=lambda r: r[0])}
