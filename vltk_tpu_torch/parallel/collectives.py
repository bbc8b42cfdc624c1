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
* ``pipe_shift``: GPipe's hand-off, rank i to i + 1 with no wrap-around
  (the first rank receives zeros, the last sends nothing), its backward
  the same exchange the other way; every rank joins it in tick order.
* ``gather_tokens`` (forward all-gather of blocks placed by their mesh
  coordinates, backward reduce-scatter) and ``sum_partials`` (forward and
  backward all-reduce): the MoE block's global routing and its slot
  partials.

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
    "pipe_shift",            # GPipe: the hand-off between neighbouring stages, one a tick (and its backward)
    "pipe_replicate",        # GPipe: the output all-reduce over the pipe axis
    "moe_route_gather",      # MoE: the router probabilities of the global batch's tokens
    "moe_route_reduce_scatter",  # its backward
    "moe_dispatch_reduce",   # MoE: the expert slots' partials summed over data x seq (forward and backward)
    "moe_combine_reduce",    # MoE: the mixture's partials summed over the expert axis
    "ep_copy",               # MoE: backward all-reduce over the expert axis at the expert region's inputs
    "preempt_agree",         # the SIGTERM flag's MAX over the mesh, one a step
)

_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    return {k: COUNTS[k] for k in KINDS}


def all_reduce_(t: torch.Tensor, group, kind: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place sum (or ``op``) over ``group``, counted as ``kind``."""
    COUNTS[kind] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Forward identity; backward all-reduce over the model axis."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, ctx.kind), None, None


class _ReduceFromTP(torch.autograd.Function):
    """Forward all-reduce over the model axis; backward identity."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return all_reduce_(x.clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp(x: torch.Tensor, group, kind: str = "tp_copy") -> torch.Tensor:
    return _CopyToTP.apply(x, group, kind)


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


def _pack(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another, in one uint8 buffer."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """Tensors shaped and typed as ``like`` from ``_pack``'s buffer."""
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].clone().view(t.dtype).view(t.shape))
        offset += n
    return out


def _shift(tensors: List[torch.Tensor], group, direction: int) -> List[torch.Tensor]:
    """Send ``tensors`` to group rank r + ``direction`` and receive the same
    shapes from r - ``direction``, without wrapping around: the rank with no
    sender gets zeros, the one with no receiver sends nothing. One
    ``all_to_all_single`` of bytes, which every rank of the group joins."""
    COUNTS["pipe_shift"] += 1
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    sends, recvs = [0] * n, [0] * n
    if 0 <= r + direction < n:
        sends[r + direction] = nbytes
    if 0 <= r - direction < n:
        recvs[r - direction] = nbytes
    device = tensors[0].device
    flat = _pack(tensors) if sum(sends) else torch.empty((0,), dtype=torch.uint8, device=device)
    out = torch.empty((sum(recvs),), dtype=torch.uint8, device=device)
    dist.all_to_all_single(out, flat, recvs, sends, group=group)
    if not sum(recvs):
        return [torch.zeros_like(t) for t in tensors]
    return _unpack(out, tensors)


class _PipeShift(torch.autograd.Function):
    """Forward: the stream's leaves from stage i to i + 1; backward: their
    cotangents from i + 1 to i. ``link`` (a scalar that requires grad)
    comes out again as the next tick's, so every rank's shifts form one
    chain in the autograd graph and run their backward exchanges in the
    reverse tick order, also where a stage discards what it received."""

    @staticmethod
    def forward(ctx, group, link, *leaves):
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in leaves]
        return (link.clone(), *_shift(list(leaves), group, 1))

    @staticmethod
    def backward(ctx, g_link, *grads):
        floating = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_shift(floating, ctx.group, -1) if floating else [])
        return (None, g_link, *(next(back) if f else None for f in ctx.floating))


def pipe_shift(leaves: List[torch.Tensor], link: torch.Tensor, group):
    """-> (next link, the leaves stage i - 1 sent)."""
    out = _PipeShift.apply(group, link, *leaves)
    return out[0], list(out[1:])


class _PipeReplicate(torch.autograd.Function):
    """Forward: the leaves summed over the pipe group (only the last stage
    holds outputs, the others zeros), one all-reduce a dtype; backward:
    identity, since every pipe rank computes the same loss from the
    replicated output (an all-reduce here would make the last stage's
    gradient P times too large). ``link`` ends the shifts' chain."""

    @staticmethod
    def forward(ctx, group, link, *leaves):
        out = [t.clone() for t in leaves]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in out:
            by_dtype.setdefault(t.dtype, []).append(t)
        for same in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            all_reduce_(flat, group, "pipe_replicate")
            torch._foreach_copy_(same, [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in same]), same)])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *grads)


def pipe_replicate(leaves: List[torch.Tensor], link: torch.Tensor, group) -> List[torch.Tensor]:
    return list(_PipeReplicate.apply(group, link, *leaves))


class _GatherTokens(torch.autograd.Function):
    """Forward: every rank's (n, s, ...) block of tokens, all-gathered and
    laid out at its place in a grid of blocks, ``places[g]`` = (block row,
    block column) of group rank g; backward: the gradient's blocks summed
    over the ranks, each rank keeping its own (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, places):
        COUNTS["moe_route_gather"] += 1
        g = dist.get_world_size(group)
        rows, cols = 1 + max(p[0] for p in places), 1 + max(p[1] for p in places)
        x = x.contiguous()
        full = torch.empty((g * x.numel(),), dtype=x.dtype, device=x.device)
        _gather(full, x.reshape(-1), group=group)
        order = sorted(range(g), key=lambda k: places[k])  # grid order -> group rank
        blocks = full.view((g,) + tuple(x.shape))[order]
        ctx.group, ctx.order, ctx.shape, ctx.grid = group, order, tuple(x.shape), (rows, cols)
        out = blocks.view((rows, cols) + tuple(x.shape)).transpose(1, 2)
        return out.reshape((rows * x.shape[0], cols * x.shape[1]) + tuple(x.shape[2:]))

    @staticmethod
    def backward(ctx, grad):
        COUNTS["moe_route_reduce_scatter"] += 1
        (rows, cols), shape = ctx.grid, ctx.shape
        blocks = grad.reshape((rows, shape[0], cols, shape[1]) + shape[2:]).transpose(1, 2)
        blocks = blocks.reshape((rows * cols,) + shape)
        by_rank = torch.empty_like(blocks)
        by_rank[ctx.order] = blocks
        out = torch.empty((blocks[0].numel(),), dtype=grad.dtype, device=grad.device)
        _reduce_scatter(out, by_rank.reshape(-1), group=ctx.group)
        return out.view(shape), None, None


def gather_tokens(x: torch.Tensor, group, places) -> torch.Tensor:
    return _GatherTokens.apply(x, group, tuple(tuple(p) for p in places))


class _SumPartials(torch.autograd.Function):
    """Forward and backward: all-reduce over ``group``. For a sum whose
    result every rank uses for a loss of its own (the MoE slots that the
    data x seq ranks fill from their tokens), the cotangent of a partial
    is the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce_(x.clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, ctx.kind), None, None


def sum_partials(x: torch.Tensor, group, kind: str = "moe_dispatch_reduce") -> torch.Tensor:
    return _SumPartials.apply(x, group, kind)


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
    update is that of the mean loss over the replicas. A mesh with neither
    axis (``model``, ``pipe`` or ``expert`` alone) has nothing to reduce:
    its ranks hold the same tokens."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if grads and mesh.replica_axes:
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
