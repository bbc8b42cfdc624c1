"""Mesh construction and batch sharding over ``torch.distributed``.

Counterpart of ``vltk_tpu/parallel/mesh.py``. JAX lays a named grid over
the devices of one program; here every rank is a process, and the mesh
is a named ``DeviceMesh`` over the process group that is up, rank ``r``
at coordinate ``np.unravel_index(r, sizes)``, the order of JAX's
``np.array(devices).reshape(sizes)``. The backend follows the device:
NCCL on ``cuda``, gloo on ``cpu``; a group on another backend raises, and
nothing switches to the other one.

Where JAX places a global array with a ``NamedSharding``, each rank here
holds its own slice: ``shard_batch`` cuts the leading dim of every array
of a global batch by the rank's ``data`` coordinate, and
``NamedSharding.local`` cuts any tensor by its spec.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import socket
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vltk_tpu_torch import DeviceLike, resolve_device

#: the axes whose ranks hold different tokens of one model replica; their
#: gradients are summed (``Mesh.replica_group``). The ``model``, ``expert``
#: and ``pipe`` ranks of a replica hold the same tokens, as in JAX, where
#: the batch is sharded over ``data`` alone
REPLICA_AXES = ("data", "seq")
#: offset of the model-parallel generator's seed from the run's seed
#: (Megatron's tracker uses the same constant)
_MODEL_SEED_OFFSET = 2718


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a tensor dim, an axis name, a
    tuple of axis names, or ``None`` (replicated along that dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over the ranks of a process group.

    ``shape`` maps axis name -> size in axis order; ``coordinate`` is this
    rank's place in the grid (``None`` for a rank outside a mesh built
    from the first ranks of a larger group); ``group(axis)`` is the
    process group along one axis, ``replica_group`` the one along every
    axis of ``REPLICA_AXES`` the mesh has, ``world_group`` all its ranks.
    ``model_generator`` is the generator of dropout on tensors cut over
    ``model`` (``seed_model_parallel``).
    """

    def __init__(self, names: Sequence[str], sizes: Sequence[int], device: torch.device):
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))
        self.device = device
        self.size = int(np.prod(sizes))
        grid = np.arange(self.size).reshape(tuple(sizes))
        self.device_mesh = _device_mesh(device, grid, self.axis_names)
        rank = dist.get_rank()
        self.coordinate: Optional[Tuple[int, ...]] = (
            tuple(int(c) for c in np.unravel_index(rank, grid.shape)) if rank < self.size else None)
        self.world_group = (dist.group.WORLD if self.size == dist.get_world_size()
                            else dist.new_group(list(range(self.size))))
        self.replica_axes = tuple(a for a in self.axis_names if a in REPLICA_AXES)
        self.replica_group = _axes_group(grid, self.axis_names, self.replica_axes, self.device_mesh)
        self._model_generator: Optional[torch.Generator] = None

    @property
    def is_member(self) -> bool:
        return self.coordinate is not None

    def axis_size(self, axis: str) -> int:
        """The axis' size; 1 for an axis the mesh lacks."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``; 0 for an axis the mesh lacks."""
        if axis not in self.shape:
            return 0
        if self.coordinate is None:
            raise ValueError(f"rank {dist.get_rank()} is outside the mesh {self.shape}")
        return self.coordinate[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def replica_size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.replica_axes])) if self.replica_axes else 1

    @property
    def replica_index(self) -> int:
        """This rank's index among the replicas: its (data, seq)
        coordinates, row-major; equal across the ``model`` axis."""
        index = 0
        for axis in self.replica_axes:
            index = index * self.shape[axis] + self.coord(axis)
        return index

    def seed_model_parallel(self, seed: int) -> torch.Generator:
        """(Re)seed the model-parallel generator from the run's seed, this
        rank's replica index and its ``model`` coordinate (Megatron's
        tracker): the ranks that hold other heads of one replica draw other
        masks. Returns it."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((seed + _MODEL_SEED_OFFSET + self.replica_index * self.axis_size("model")
                         + self.coord("model")) % 2 ** 63)
        self._model_generator = gen
        return gen

    @property
    def model_generator(self) -> torch.Generator:
        """The generator of dropout inside a tensor-parallel region; seeded
        from the default generator's initial seed on first use unless
        ``seed_model_parallel`` ran."""
        if self._model_generator is None:
            self.seed_model_parallel(torch.initial_seed())
        return self._model_generator

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _device_mesh(device: torch.device, grid: np.ndarray, names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device.type, torch.as_tensor(grid), mesh_dim_names=names)


def _axes_group(grid: np.ndarray, names: Tuple[str, ...], axes: Tuple[str, ...], device_mesh):
    """The process group along several axes at once (every rank that
    differs from this one only in ``axes``). Built on every rank, as
    ``new_group`` must be; a single axis reuses the ``DeviceMesh``'s."""
    if not axes:
        return None
    if len(axes) == 1:
        return device_mesh.get_group(axes[0]) if dist.get_rank() < grid.size else None
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    ranks = np.transpose(grid, rest + keep).reshape(-1, int(np.prod([grid.shape[i] for i in keep])))
    mine = None
    for members in ranks.tolist():
        group = dist.new_group(members)
        if dist.get_rank() in members:
            mine = group
    return mine


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on cuda needs the NCCL backend, and this torch has none")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def _ensure_group(device: torch.device) -> None:
    """Check the group that is up against the device's backend, or start
    one: from ``torchrun``'s environment when it set one, else a one-rank
    group on a free local port (the sizes were checked against one rank)."""
    backend = _backend_for(device)
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend not in {b.split(":")[-1] for b in have.split(",")}:
            raise RuntimeError(f"the process group runs {have}, and a mesh on {device.type} needs {backend}")
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)


def _device(device: DeviceLike) -> torch.device:
    """The rank's device: ``cuda`` means ``cuda:LOCAL_RANK`` under torchrun."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def resolve_axes(axes: Sequence[Tuple[str, int]], total: int) -> Tuple[list, list, int]:
    """JAX's sizing rules: at most one axis -1, which takes what the fixed
    axes leave of ``total`` devices (their product must divide it);
    without one the product must fit in ``total`` and the first ranks are
    taken. -> (names, sizes, devices used)."""
    names = [a[0] for a in axes]
    sizes = [int(a[1]) for a in axes]
    n_free = sizes.count(-1)
    if n_free > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {tuple(axes)}")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if n_free == 1:
        if total % fixed != 0:
            raise ValueError(f"{total} devices not divisible by fixed axes product {fixed}")
        sizes[sizes.index(-1)] = total // fixed
        used = total
    else:
        used = int(np.prod(sizes))
        if used > total:
            raise ValueError(f"mesh {dict(axes)} needs {used} devices, have {total}")
    return names, sizes, used


def make_mesh(mesh_config=None, *, device: DeviceLike = None) -> Mesh:
    """A ``Mesh`` from a ``MeshConfig`` (default: one ``data`` axis over
    every rank) over the process group that is up, on ``device`` (CUDA
    unless the caller asks for the CPU). With no group up it starts one
    from ``torchrun``'s environment, or a one-rank group when the mesh
    needs one device."""
    axes = (("data", -1),) if mesh_config is None else tuple(tuple(a) for a in mesh_config.axes)
    if not axes:
        raise ValueError("a mesh needs at least one axis")
    # the sizes' errors come before the device's and before any group starts
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    names, sizes, _ = resolve_axes(axes, world)
    dev = _device(device)
    _ensure_group(dev)
    return Mesh(names, sizes, dev)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("vltk_mesh", default=None)


def current_mesh() -> Optional[Mesh]:
    """The mesh set by the innermost ``use_mesh``, or ``None``."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the one the models and losses read (JAX's ``with
    mesh:``)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh; ``local(t)`` is this rank's block of ``t``."""

    mesh: Mesh
    spec: PartitionSpec

    def axes_of(self, dim: int) -> Tuple[str, ...]:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def block(self, dim: int, length: int) -> slice:
        """This rank's range along ``dim`` of a global length: the axes of
        the entry row-major, as JAX lays a tuple entry out."""
        axes = self.axes_of(dim)
        if not axes:
            return slice(0, length)
        parts, index = 1, 0
        for axis in axes:
            parts *= self.mesh.axis_size(axis)
            index = index * self.mesh.axis_size(axis) + self.mesh.coord(axis)
        if length % parts:
            raise ValueError(f"dim {dim} of length {length} does not split over {axes} ({parts} parts)")
        step = length // parts
        return slice(index * step, (index + 1) * step)

    def local(self, t):
        """This rank's block of a global tensor or array."""
        return t[tuple(self.block(d, t.shape[d]) for d in range(len(self.spec)))]


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding of a batch-leading array: first dim over ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's part of a (nested) global batch: every tensor or array
    of one or more dims cut along its leading dim by the rank's ``axis``
    coordinate (the dim must divide, as JAX's ``device_put`` requires);
    scalars and other objects are kept whole."""
    data = batch_sharding(mesh, axis)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if (torch.is_tensor(x) or isinstance(x, np.ndarray)) and x.ndim >= 1 and x.dtype != object:
            return data.local(x)
        return x

    return put(batch)
