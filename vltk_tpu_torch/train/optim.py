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

``freeze_patterns`` are JAX's ``with_frozen`` regexes, searched in each
parameter's torch name with dots turned into ``/`` (JAX searches the
``/``-joined flax path): a matching parameter is left out of the optimizer,
so it gets no AdamW step and no weight decay, and the clip norm is taken
over the trained parameters alone, as optax's clip sits in the ``"train"``
branch of ``multi_transform``. Frozen parameters keep ``requires_grad``:
their gradients are computed and not applied, as in JAX.

Under a mesh the clip's norm is the global one, over every TP shard and
every ZeRO slice (each slice's square counted once over the axes it is
replicated on, then summed over the mesh), and ``zero1_axis`` turns on
ZeRO-1: each rank of that axis keeps and updates only its slice of every
parameter's AdamW moments, on the JAX layout (``parallel.sharding.
zero1_state_shardings``: the first free dim the axis divides, on top of
the TP spec), then the updated parameter slices are all-gathered.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.parallel.sharding import linear_weights

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


def frozen(name: str, patterns: Sequence[str]) -> bool:
    """Whether any regex of ``patterns`` is found in ``name`` with dots as
    ``/``."""
    path = name.replace(".", "/")
    return any(re.search(p, path) for p in patterns)


def param_groups(model: nn.Module, weight_decay: float, freeze_patterns: Sequence[str] = ()) -> List[Dict]:
    named = [(n, p) for n, p in model.named_parameters()
             if p.requires_grad and not frozen(n, freeze_patterns)]
    return [
        {"params": [p for n, p in named if decays(n)], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n)], "weight_decay": 0.0},
    ]


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the gradients to a global L2 norm of
    ``clip_grad_norm`` (0 = no clip).

    ``mesh`` (with ``shardings``, name -> the parameter's ``NamedSharding``,
    ``names``, id -> name, ``global_shapes`` and ``linear``, the names of
    the (out, in) weights) makes the norm global over the mesh;
    ``zero1_axis`` keeps this rank's slice of each parameter's moments
    only (``slices``: (parameter, the tensor AdamW updates, its dim or
    None)) and all-gathers the updated slices after each step."""

    def __init__(self, params: Iterable, clip_grad_norm: float = 0.0, mesh=None, shardings=None,
                 names=None, global_shapes=None, linear=(), zero1_axis: Optional[str] = None, **kwargs):
        groups = [dict(g) for g in params]
        self.mesh, self.zero1_axis = mesh, zero1_axis if mesh is not None else None
        self.slices: List[Tuple[torch.Tensor, torch.Tensor, Optional[int]]] = []
        self._reps: List[float] = []
        if mesh is not None:
            from vltk_tpu_torch.parallel.mesh import P
            from vltk_tpu_torch.parallel.sharding import moment_spec

            for g in groups:
                updated = []
                for p in g["params"]:
                    name = names[id(p)]
                    spec = shardings[name].spec if name in shardings else P()
                    moment, dim = spec, None
                    if self.zero1_axis is not None:
                        moment = moment_spec(spec, global_shapes[name], mesh, self.zero1_axis, name in linear)
                        dim = next((i for i, e in enumerate(moment) if e == self.zero1_axis), None)
                    sl = p
                    if dim is not None:
                        step = p.shape[dim] // mesh.axis_size(self.zero1_axis)
                        sl = p.detach().narrow(dim, mesh.coord(self.zero1_axis) * step, step).clone()
                    self.slices.append((p, sl, dim))
                    updated.append(sl)
                    # how many ranks hold this slice's values: each counts 1/r of its norm
                    axes = {a for e in moment if e is not None for a in ((e,) if isinstance(e, str) else e)}
                    self._reps.append(float(mesh.size // _prod(mesh.axis_size(a) for a in axes)))
                g["params"] = updated
        super().__init__(groups, **kwargs)
        self.clip_grad_norm = float(clip_grad_norm or 0.0)
        self._rep_cache = None

    def _attach_slice_grads(self) -> None:
        for p, sl, dim in self.slices:
            if sl is p:
                continue
            if p.grad is None:
                sl.grad = None
            else:
                step = sl.shape[dim]
                sl.grad = p.grad.narrow(dim, self.mesh.coord(self.zero1_axis) * step, step).contiguous()

    @torch.no_grad()
    def clip_(self) -> None:
        if self.clip_grad_norm <= 0:
            return
        owned = [(p, i) for i, p in enumerate(q for g in self.param_groups for q in g["params"])
                 if p.grad is not None]
        if not owned:
            return
        grads = [p.grad for p, _ in owned]
        sq = torch.stack(torch._foreach_norm(grads, 2.0)).square()
        if self.mesh is not None:
            # a value held by r ranks is counted 1/r times by each (the
            # divisors stay on the device: a host list copied each step
            # would wait for the backward)
            key = tuple(i for _, i in owned)
            if self._rep_cache is None or self._rep_cache[0] != key:
                self._rep_cache = (key, torch.tensor([self._reps[i] for i in key], device=sq.device))
            sq = sq / self._rep_cache[1]
        total = sq.sum()
        if self.mesh is not None:
            C.all_reduce_(total, self.mesh.world_group, "clip_norm_reduce")
        norm = total.sqrt()
        scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm), self.clip_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def _gather_slices(self) -> None:
        items = [(p, sl, dim) for p, sl, dim in self.slices if sl is not p]
        if not items:
            return
        gathered = C.all_gather_flat([sl for _, sl, _ in items], self.mesh.group(self.zero1_axis), "zero_gather")
        torch._foreach_copy_([p for p, _, _ in items],
                             [parts.movedim(0, dim).reshape(p.shape) for (p, _, dim), parts in zip(items, gathered)])

    def step(self, closure=None):
        if self.slices:
            self._attach_slice_grads()
        self.clip_()
        loss = super().step(closure)
        if self.zero1_axis is not None:
            self._gather_slices()
        return loss


def _prod(values) -> int:
    out = 1
    for v in values:
        out *= int(v)
    return out


def make_optimizer(
    model: nn.Module, train_config, total_steps: int, freeze_patterns=(), mesh=None,
    zero1_axis: Optional[str] = None,
) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) with the semantics of the JAX package's
    ``make_optimizer``: step the optimizer, then the scheduler. Parameters
    matching ``freeze_patterns`` are not trained. Under ``mesh`` the
    parameters' shardings are those ``parallel.shard_params`` recorded on
    the model (replicated when it was not cut); ``zero1_axis``: ZeRO-1."""
    for p in freeze_patterns:
        re.compile(p)  # a bad pattern raises here, as JAX's with_frozen does
    if zero1_axis is not None and (mesh is None or zero1_axis not in mesh.shape):
        raise ValueError(f"zero1_axis={zero1_axis!r} needs a mesh with that axis")
    opt = ClippedAdamW(
        param_groups(model, train_config.weight_decay, freeze_patterns),
        clip_grad_norm=getattr(train_config, "clip_grad_norm", 0.0),
        mesh=mesh, shardings=getattr(model, "_vltk_shardings", {}),
        names={id(p): n for n, p in model.named_parameters()},
        global_shapes=getattr(model, "_vltk_global_shapes", None) or {n: tuple(p.shape) for n, p in model.named_parameters()},
        linear=linear_weights(model), zero1_axis=zero1_axis,
        lr=train_config.learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )
    schedule = linear_warmup_linear_decay(total_steps, train_config.warmup_ratio)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
