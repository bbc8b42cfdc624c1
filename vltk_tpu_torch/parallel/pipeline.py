"""Pipeline parallelism over the ``pipe`` mesh axis: GPipe as one SPMD
program.

Counterpart of ``vltk_tpu/parallel/pipeline.py``. The L homogeneous
layers' parameters are stacked on a leading (L,) dim
(``stack_layer_params``, from the port's per-layer state-dict names such
as ``encoder.layer.{i}.attention.self.query.weight``), and each ``pipe``
rank runs only its L/P contiguous layers. The schedule is JAX's, static:
M + P - 1 ticks for M microbatches over P stages; at tick t stage 0 takes
microbatch min(t, M - 1), every stage applies its layers to what it holds,
hands the result to the next stage, and the last stage keeps output
t - (P - 1) once that is >= 0. The output is replicated over ``pipe`` by
one all-reduce to which only the last stage contributes.

Differences of idiom from JAX's ``shard_map`` + ``lax.scan``:

* a stage skips the compute of its bubble ticks (JAX computes them on
  zeros and discards the result), never the tick's exchange;
* the hand-off is one neighbour exchange a tick (``collectives.pipe_shift``:
  stage 0 receives zeros, the last stage sends nothing, as JAX's partial
  ``ppermute``), whose backward is the exchange the other way. The
  exchanges of a call are chained in the autograd graph, so every rank
  runs their backward in the same reverse tick order, also a rank that
  discards what it received;
* the replicating all-reduce has an identity backward: every pipe rank
  computes the same loss from the replicated output.

``layer_fn(layer_params, x_mb) -> x_mb`` applies one layer to one
microbatch; ``layer_params`` maps layer-relative names to one layer's
tensors (views of the stack, so the gradients land in it). For a real
layer, ``torch.func.functional_call(template_layer, layer_params, args)``
is the idiom.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping

import torch

from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.parallel.mesh import Mesh


def stack_layer_params(params: Mapping[str, torch.Tensor], prefix: str, count: int) -> Dict[str, torch.Tensor]:
    """``params[f"{prefix}{i}.{name}"]`` for i in [0, count) stacked into
    ``{name: (count, ...) tensor}``. The layers must be homogeneous (the
    same names and shapes), as the encoders' ``encoder.layer.{i}`` are."""
    names = None
    for i in range(count):
        pattern = re.compile(rf"^{re.escape(prefix)}{i}\.(.+)$")
        mine = sorted(m.group(1) for m in map(pattern.match, params) if m)
        if names is None:
            names = mine
        elif mine != names:
            raise ValueError(f"layer {prefix}{i} holds other parameters than {prefix}0")
    if not names:
        raise ValueError(f"no parameter of {prefix}0 ... {prefix}{count - 1}")
    return {name: torch.stack([params[f"{prefix}{i}.{name}"] for i in range(count)]) for name in names}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor], prefix: str, count: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params` (checkpoint interop)."""
    return {f"{prefix}{i}.{name}": t[i] for name, t in stacked.items() for i in range(count)}


def _leaves(x):
    """(leaves, rebuild) of a tensor, or a tuple, list or dict of them."""
    if torch.is_tensor(x):
        return [x], lambda v: v[0]
    if isinstance(x, dict):
        keys = list(x)
        return [x[k] for k in keys], lambda v: dict(zip(keys, v))
    if isinstance(x, (tuple, list)):
        return list(x), lambda v: type(x)(v)
    raise TypeError(f"a microbatch stream is a tensor, or a tuple, list or dict of tensors; got {type(x)}")


def gpipe_spmd(
    layer_fn: Callable,
    stacked_params: Mapping[str, torch.Tensor],
    x,
    *,
    mesh: Mesh,
    axis: str = "pipe",
    data_axis: str = None,
):
    """Run ``layer_fn`` L times over ``x``'s microbatches, GPipe-style.

    Args:
      layer_fn: ``(layer_params, x_mb) -> x_mb``, one layer on one
        microbatch (the same structure back).
      stacked_params: the whole layer stack (the same on every rank),
        leaves shaped ``(L, ...)``; L must divide by the ``axis`` size.
        Each rank runs its L/P contiguous layers, views of the stack.
      x: the global microbatch stream, a tensor or a tuple, list or dict of
        tensors, every leaf shaped ``(M, mb, ...)``; leaves other than the
        hidden state (masks) ride along with their microbatch.
      mesh: a mesh with ``axis``; other axes pass through untouched.
      data_axis: optional mesh axis to cut every leaf's microbatch dim
        (dim 1) over: each data slice runs its own pipeline over the same
        layers. mb must divide by its size.

    Returns the processed stream, same structure as ``x``, replicated over
    ``axis``: with ``data_axis`` this rank's (M, mb/dp, ...) block, else
    the whole stream.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no {axis!r} axis")
    stages = mesh.shape[axis]
    if not stacked_params:
        raise ValueError("stacked_params is empty")
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {stages} pipeline stages")
    leaves, rebuild = _leaves(x)
    if data_axis is not None:
        if data_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no {data_axis!r} axis")
        dp = mesh.shape[data_axis]
        for leaf in leaves:
            if leaf.ndim < 2 or leaf.shape[1] % dp != 0:
                raise ValueError(
                    f"every x leaf needs a dim-1 microbatch size divisible by {data_axis}={dp}; "
                    f"got shape {tuple(leaf.shape)}")
        step = leaves[0].shape[1] // dp
        leaves = [t.narrow(1, mesh.coord(data_axis) * step, step) for t in leaves]
    m = leaves[0].shape[0]
    stage, group = mesh.coord(axis), mesh.group(axis)
    per_stage = n_layers // stages
    mine = {k: v.narrow(0, stage * per_stage, per_stage) for k, v in stacked_params.items()}
    layers = [dict(zip(mine, values)) for values in zip(*(v.unbind(0) for v in mine.values()))]

    def apply_stage(h):
        for layer_params in layers:
            h = layer_fn(layer_params, h)
        return h

    # one scalar that threads every exchange of the call (collectives._PipeShift)
    link = torch.zeros((), device=leaves[0].device, requires_grad=torch.is_grad_enabled())
    held = [torch.zeros_like(t[0]) for t in leaves]
    outputs: List[List[torch.Tensor]] = []
    for t in range(m + stages - 1):
        inp = [leaf[min(t, m - 1)] for leaf in leaves] if stage == 0 else held
        if stage <= t < stage + m:  # microbatch t - stage is here; else a bubble
            y, _ = _leaves(apply_stage(rebuild(inp)))
        else:
            y = [torch.zeros_like(v) for v in inp]
        if stage == stages - 1 and t >= stages - 1:
            outputs.append(y)
        link, held = C.pipe_shift(y, link, group)
    if stage != stages - 1:  # only the last stage contributes to the sum
        outputs = [[torch.zeros_like(t[0]) for t in leaves] for _ in range(m)]
    stacked = [torch.stack([o[i] for o in outputs]) for i in range(len(leaves))]
    return rebuild(C.pipe_replicate(stacked, link, group))
