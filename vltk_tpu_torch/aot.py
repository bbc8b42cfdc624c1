"""Exported serving bundles of the port (``torch.export``).

Counterpart of ``vltk_tpu/aot.py``. The JAX package lowers a jitted step
once into a serialized StableHLO artifact with the parameters baked in as
constants; here ``export_step`` traces a step with ``torch.export.export``
into an ``ExportedProgram`` that carries the module's weights (and any
calibrated int8 scales), and ``save_bundle`` writes it with
``torch.export.save``. A serving host loads the program and calls it: no
model source, no checkpoint file, no retrace. The kernels on the serving
paths (K1 RoIPool, K2 greedy NMS, K3 flash attention) are registered ops
(``torch.ops.vltk_tpu_torch.*``, ``ops/``), so the program keeps them:
on the card it launches the hand kernels, on the CPU it runs their plain
versions. ``load_bundle`` imports ``vltk_tpu_torch.ops`` first so the ops
are registered before ``torch.export.load``.

Bundle layout (one zip file, as the JAX package's):

    manifest.json      {"format": 1, "meta": {...},
                        "artifacts": [names], "files": [names]}
    <name>.pt2         a ``torch.export.save``d program, one per step
    files/<name>       opaque side files (e.g. the tokenizer vocab)

A program runs on the device it was exported on. JAX's ``platforms=``
(cross-lowering for several backends) has no counterpart: ``export_step``
takes ``platforms`` only as the one device type of its example inputs and
raises on anything else, and ``load_bundle(path, device=...)`` raises when
the device asked for is not the program's.

Sharded serving (JAX's data-parallel export: the batch cut over a
``data`` mesh, the parameters replicated, the output data-sharded; the
program holds no collective): ``export_step(..., mesh=)`` traces the
per-rank program on the rank's B/dp block of the example batch and
returns a ``ShardedProgram``; the manifest records its ``nr_devices`` and
partition specs. ``load_bundle(path, mesh=)`` refuses a mesh of another
size (serving needs a same-size mesh, as in JAX), and the loaded step
takes the global inputs, runs the rank's block and returns ``(the rank's
output block, its NamedSharding)``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_FORMAT = 1
_SUFFIX = ".pt2"


class _Step(torch.nn.Module):
    """A step function as a module; ``modules`` are registered so their
    weights travel with the exported program as its state."""

    def __init__(self, fn: Callable, modules: Optional[Dict[str, torch.nn.Module]] = None):
        super().__init__()
        self._fn = fn
        self.held = torch.nn.ModuleDict(modules or {})

    def forward(self, *args):
        return self._fn(*args)


def _device_type(example_args: Sequence[Any]) -> str:
    types = {a.device.type for a in example_args if torch.is_tensor(a)}
    if len(types) != 1:
        raise ValueError(f"export_step: the example inputs lie on {sorted(types)}; want one device")
    return types.pop()


#: the partition spec of every input and output of a sharded program: the
#: batch dim over ``data``
_DATA_SPEC = ("data",)


@dataclasses.dataclass
class ShardedProgram:
    """A per-rank program of a data-parallel step: it runs on one rank's
    block of a batch cut over a mesh of ``nr_devices`` ranks."""

    program: torch.export.ExportedProgram
    nr_devices: int
    in_specs: Tuple[Tuple[str, ...], ...]

    def manifest(self) -> Dict[str, Any]:
        return {"nr_devices": self.nr_devices, "in_specs": [list(s) for s in self.in_specs],
                "out_spec": list(_DATA_SPEC)}


def export_step(
    fn: Callable,
    example_args: Sequence[torch.Tensor],
    *,
    modules: Optional[Dict[str, torch.nn.Module]] = None,
    platforms: Optional[Sequence[str]] = None,
    mesh=None,
):
    """Trace ``fn`` (a module or a function of tensors) at the example
    shapes, without autograd, and return the ``ExportedProgram``. The
    example values are ignored: the program pins their shapes, dtypes and
    device. ``modules`` (a function's models) are held by the traced
    module, so their weights are the program's state.

    ``platforms``: the JAX package lowers for several backends at once; a
    torch program runs on the device it was traced on, so the only value
    taken is that device type alone (``("cuda",)`` or ``("cpu",)``).

    ``mesh`` (a ``parallel.Mesh`` with a ``data`` axis): the example
    inputs are the global batch's tensors; the program is traced on this
    rank's block of every input's leading dim and returned as a
    ``ShardedProgram``.
    """
    if mesh is not None:
        from vltk_tpu_torch.parallel.mesh import NamedSharding, P

        if "data" not in mesh.shape:
            raise ValueError(f"export_step: a sharded program cuts its batch over 'data'; the mesh is {mesh.shape}")
        block = NamedSharding(mesh, P(*_DATA_SPEC))
        program = export_step(fn, [block.local(a) for a in example_args], modules=modules, platforms=platforms)
        return ShardedProgram(program, mesh.size, (_DATA_SPEC,) * len(example_args))
    device = _device_type(example_args)
    if platforms is not None:
        want = tuple(str(p) for p in platforms)
        if want != (device,):
            raise ValueError(
                f"export_step: platforms={want!r} cannot be honoured; a program runs on the device of its "
                f"example inputs ({device!r}), so platforms must be ({device!r},) or None"
            )
    module = fn if isinstance(fn, torch.nn.Module) else _Step(fn, modules)
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args), strict=False)


def save_bundle(
    path: str,
    exported: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
    files: Optional[Dict[str, bytes]] = None,
) -> str:
    """Write programs (or their saved bytes), metadata and side files as
    one zip."""
    meta = dict(meta or {})
    files = dict(files or {})
    manifest = {"format": _FORMAT, "meta": meta, "artifacts": sorted(exported), "files": sorted(files)}
    sharded = {name: p.manifest() for name, p in exported.items() if isinstance(p, ShardedProgram)}
    if sharded:
        manifest["sharding"] = sharded
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        for name, program in exported.items():
            program = program.program if isinstance(program, ShardedProgram) else program
            if isinstance(program, (bytes, bytearray)):
                data = bytes(program)
            else:
                buf = io.BytesIO()
                torch.export.save(program, buf)
                data = buf.getvalue()
            # stored, not deflated: a program is mostly float weights, which
            # deflate barely shrinks and slowly
            zf.writestr(f"{name}{_SUFFIX}", data, compress_type=zipfile.ZIP_STORED)
        for name, data in files.items():
            zf.writestr(f"files/{name}", data)
    return path


def program_device(program: torch.export.ExportedProgram) -> str:
    """The device type a program was traced on: that of its inputs' example
    values (its state may also hold small CPU constants)."""
    vals = {n.name: n.meta.get("val") for n in program.graph.nodes if n.op == "placeholder"}
    types = {vals[name].device.type for name in program.graph_signature.user_inputs
             if isinstance(vals[name], torch.Tensor)}
    if len(types) != 1:
        raise ValueError(f"the exported program's inputs lie on {sorted(types)}; want one device")
    return types.pop()


@dataclasses.dataclass
class AotBundle:
    """A loaded bundle: ``fns[name](*args)`` runs the program on its
    device (``platforms[name]``, one device type)."""

    fns: Dict[str, Callable]
    meta: Dict[str, Any]
    files: Dict[str, bytes]
    platforms: Dict[str, Tuple[str, ...]]

    def __getitem__(self, name: str) -> Callable:
        return self.fns[name]


def _input_specs(program: torch.export.ExportedProgram):
    """(shape, dtype) of each user input the program was traced at."""
    specs = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    return [(tuple(specs[name].shape), specs[name].dtype) for name in program.graph_signature.user_inputs]


def _runner(program: torch.export.ExportedProgram) -> Callable:
    module = program.module()
    specs = _input_specs(program)

    def run(*args):
        if len(args) != len(specs):
            raise ValueError(f"the program takes {len(specs)} inputs, got {len(args)}")
        for i, (arg, (shape, dtype)) in enumerate(zip(args, specs)):
            if tuple(arg.shape) != shape or arg.dtype != dtype:
                raise ValueError(
                    f"input {i}: shape {tuple(arg.shape)} dtype {arg.dtype}; the program was exported for "
                    f"shape {shape} dtype {dtype}"
                )
        with torch.no_grad():
            return module(*args)

    return run


def _sharded_runner(run: Callable, sharding: Dict[str, Any], mesh) -> Callable:
    """The global inputs -> (this rank's output block, its NamedSharding)."""
    from vltk_tpu_torch.parallel.mesh import NamedSharding, P

    blocks = [NamedSharding(mesh, P(*spec)) for spec in sharding["in_specs"]]
    out = NamedSharding(mesh, P(*sharding["out_spec"]))

    def sharded(*args):
        if len(args) != len(blocks):
            raise ValueError(f"the program takes {len(blocks)} inputs, got {len(args)}")
        return run(*(b.local(a) for b, a in zip(blocks, args))), out

    return sharded


def load_bundle(path: str, device: Optional[str] = None, mesh=None) -> AotBundle:
    """Read a bundle. ``device`` (a device type or a device): the device it
    must run on; raises ``ValueError`` when a program was traced on
    another (None takes the programs as they are). A sharded program needs
    ``mesh``, a ``parallel.Mesh`` of its ``nr_devices`` ranks (else
    ``ValueError``); its step takes the global inputs and returns this
    rank's output block with its sharding."""
    import vltk_tpu_torch.ops  # noqa: F401 - registers the kernels' ops before the load

    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{path}: unsupported bundle format {manifest.get('format')!r} (want {_FORMAT})")
        fns: Dict[str, Callable] = {}
        platforms: Dict[str, Tuple[str, ...]] = {}
        for name in manifest["artifacts"]:
            sharding = manifest.get("sharding", {}).get(name)
            if sharding is not None and getattr(mesh, "size", None) != sharding["nr_devices"]:
                raise ValueError(
                    f"{path}: program {name!r} serves on a mesh of {sharding['nr_devices']} ranks; "
                    f"got {'no mesh' if mesh is None else f'a mesh of {mesh.size}'}")
            program = torch.export.load(io.BytesIO(zf.read(f"{name}{_SUFFIX}")))
            kind = program_device(program)
            if device is not None and torch.device(device).type != kind:
                raise ValueError(
                    f"{path}: program {name!r} was exported on {kind!r} and cannot run on device={device!r}; "
                    f"export it again on that device"
                )
            fns[name] = _runner(program) if sharding is None else _sharded_runner(_runner(program), sharding, mesh)
            platforms[name] = (kind,)
        files = {name: zf.read(f"files/{name}") for name in manifest["files"]}
    return AotBundle(fns=fns, meta=manifest["meta"], files=files, platforms=platforms)


def bundle_manifest(path: str) -> Dict[str, Any]:
    """Read just the manifest (no program is loaded)."""
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("manifest.json"))
