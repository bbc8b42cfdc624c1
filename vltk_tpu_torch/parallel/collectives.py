"""The collectives the port calls where XLA inserts its own.

The JAX package annotates shardings and XLA's partitioner adds the
all-reduces, all-to-alls and permutes; eager PyTorch calls them by hand.
Every function here is an ``autograd.Function`` whose backward is stated
in its docstring:

* ``copy_to_tp`` / ``reduce_from_tp``: Megatron's pair around a
  column-then-row parallel block (forward identity / backward all-reduce,
  and the reverse); the gradients of the model axis' replicated values
  come out equal on every rank of the axis. Not
  ``torch.distributed.nn.functional.all_reduce``: its backward all-reduces
  again, a gradient ``tp`` times too large.
* ``gather_seq`` (forward all-gather along a dim, backward reduce-scatter)
  and ``split_seq`` (forward this rank's chunk, backward the gradient
  padded with zeros): the true adjoints, for the sequence axis, whose
  ranks' parameter gradients are summed afterwards (``reduce_gradients``).
* ``all_to_all``: Ulysses' layout switch, its inverse the backward.
* ``rotate``: the ring's neighbour send, to rank i + 1 forward and the
  cotangent to i - 1 backward (an ``all_to_all_single`` with one non-empty
  split, which also runs on a one-rank group).

Each collective call adds one to its kind in ``COUNTS``, beside the
kernels' launch counters; ``reset_counts()`` sets them to 0. No path
skips a collective because its group has one rank.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

#: kind -> collective calls since the last ``reset_counts()``
COUNTS: collections.Counter = collections.Counter()
KINDS = (
    "dp_grad_reduce",     # data x seq gradient all-reduce, one a step (flat buffer)
    "dp_metric_reduce",   # the step's metrics averaged over the data axis
    "loss_count_reduce",  # valid-token counts of the masked losses, over the data axis
    "tp_copy",            # backward all-reduce at a column-parallel input
    "tp_reduce",          # forward all-reduce at a row-parallel output
    "vocab_reduce",       # forward all-reduce of the vocab-sharded embedding lookup
    "zero_gather",        # ZeRO-1: the updated parameter slices, one a step
    "clip_norm_reduce",   # the global gradient norm's square over the mesh
    "seq_gather",         # all-gather along the sequence axis
    "seq_reduce_scatter", # its backward
    "ulysses_all_to_all",
    "ring_rotate",
)

_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    return {k: COUNTS[k] for k in KINDS}


def all_reduce_(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """In-place sum over ``group``, counted as ``kind``."""
    COUNTS[kind] += 1
    dist.all_reduce(t, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Forward identity; backward all-reduce over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, "tp_copy"), None


class _ReduceFromTP(torch.autograd.Function):
    """Forward all-reduce over the model axis; backward identity."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce_(x.clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group, kind: str = "tp_reduce") -> torch.Tensor:
    return _ReduceFromTP.apply(x, group, kind)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    COUNTS["seq_gather"] += 1
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _gather(out, x.reshape(-1), group=group)
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim)


def _reduce_scatter_dim(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    COUNTS["seq_reduce_scatter"] += 1
    n = dist.get_world_size(group)
    parts = torch.stack(g.chunk(n, dim), 0).contiguous()
    out = torch.empty((parts[0].numel(),), dtype=g.dtype, device=g.device)
    _reduce_scatter(out, parts.reshape(-1), group=group)
    return out.view(parts.shape[1:])


class _GatherSeq(torch.autograd.Function):
    """Forward: the ranks' chunks concatenated along ``dim`` in rank
    order; backward: the gradient's chunks summed over the ranks, each
    rank keeping its own (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    """Forward: this rank's chunk along ``dim``; backward: its gradient in
    place, zeros elsewhere (no communication)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of length {x.shape[dim]} does not split over {n} sequence ranks")
        ctx.dim, ctx.shape, ctx.index, ctx.step = dim, x.shape, r, x.shape[dim] // n
        return x.narrow(dim, r * ctx.step, ctx.step).clone()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.index * ctx.step, ctx.step).copy_(g)
        return out, None, None


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _GatherSeq.apply(x, group, dim)


def split_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _SplitSeq.apply(x, group, dim)


def _all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    COUNTS["ulysses_all_to_all"] += 1
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of length {x.shape[split_dim]} does not split over {n} ranks")
    inp = torch.stack(x.chunk(n, split_dim), 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), cat_dim)


class _AllToAll(torch.autograd.Function):
    """Chunk ``split_dim`` over the ranks, send chunk j to rank j, and
    concatenate what arrives along ``cat_dim`` in rank order; the
    backward is the same exchange with the two dims swapped."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return _all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.cat_dim, ctx.split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int) -> torch.Tensor:
    return _AllToAll.apply(x, group, split_dim, cat_dim)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    COUNTS["ring_rotate"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    sends, recvs = [0] * n, [0] * n
    sends[(r + shift) % n] = flat.numel()
    recvs[(r - shift) % n] = flat.numel()
    dist.all_to_all_single(out, flat, recvs, sends, group=group)
    return out.view_as(x)


class _Rotate(torch.autograd.Function):
    """Forward: send to rank i + 1, receive from i - 1 (group ranks);
    backward: the cotangent the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -1), None


def rotate(x: torch.Tensor, group) -> torch.Tensor:
    return _Rotate.apply(x, group)


def _flat_all_reduce(tensors: List[torch.Tensor], group, kind: str, divisor: int) -> None:
    """Sum ``tensors`` over ``group`` through one flat buffer a dtype and
    divide them by ``divisor``, in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        all_reduce_(flat, group, kind)
        flat.div_(divisor)
        parts, offset = [], 0
        for t in same:
            parts.append(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        torch._foreach_copy_(same, parts)


def all_gather_flat(tensors: List[torch.Tensor], group, kind: str) -> List[torch.Tensor]:
    """Every rank's copy of each of ``tensors`` (same shapes on every rank)
    through one flat all-gather a dtype: -> a (ranks, *shape) tensor each."""
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for index in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in index])
        full = torch.empty((n * flat.numel(),), dtype=flat.dtype, device=flat.device)
        COUNTS[kind] += 1
        _gather(full, flat, group=group)
        full = full.view(n, flat.numel())
        offset = 0
        for i in index:
            t = tensors[i]
            out[i] = full[:, offset:offset + t.numel()].reshape((n,) + tuple(t.shape))
            offset += t.numel()
    return out


def reduce_gradients(parameters: Iterable[torch.Tensor], mesh) -> None:
    """The data-parallel reduce: every gradient summed over the mesh's
    replica axes (data x seq) and divided by their size, so a step's
    update is that of the mean loss over the replicas."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if grads:
        _flat_all_reduce(grads, mesh.replica_group, "dp_grad_reduce", mesh.replica_size)


def mean_over_data(values: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the data axis (what JAX's step reports
    over the global batch when each rank's value is its share times dp)."""
    if not values or "data" not in mesh.shape:
        return values
    keys = list(values)
    stacked = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    all_reduce_(stacked, mesh.group("data"), "dp_metric_reduce")
    stacked.div_(mesh.shape["data"])
    return {k: stacked[i] for i, k in enumerate(keys)}
