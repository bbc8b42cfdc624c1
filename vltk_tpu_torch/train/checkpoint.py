"""Checkpoint save and resume, on ``torch.save`` state dicts.

Counterpart of ``vltk_tpu/train/checkpoint.py`` with the same on-disk
layout and resume rules, ``.pt`` files in place of flax msgpack:
``{name}_epoch_{n}.pt`` (the model's state dict) and
``{name}_optim_epoch_{n}.pt`` (optimizer and scheduler state dicts) per
completed epoch, ``info.json`` (epoch, name, step, RNG state, ...) and
``config.json`` beside them; one ``{name}_epoch_{n}_mid.pt`` file for a
mid-epoch (periodic or preemption) save that holds all three, so it is
consistent at any kill instant. Every file is written to a temporary name,
fsynced and renamed (atomic), and the directory is fsynced after.

Under a mesh every rank holds its own blocks, so the save is sharded
(JAX's orbax ``save_checkpoint_sharded``): ``{name}_epoch_{n}[_mid]_sharded/``
holds one ``rank{r}.pt`` a rank, each written by its rank alone (atomic,
as above), and ``layout.json`` (world size, mesh axes), which rank 0
writes after every rank's file is durable: the directory counts only
once it is there. A restore needs the same mesh, and gives every rank its
own blocks back bitwise.
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def _host_snapshot(obj):
    """A CPU copy of a (nested) state dict that later in-place updates of
    the live tensors cannot reach: an asynchronous writer serialises it
    while training goes on."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_snapshot(v) for v in obj)
    return obj


def _epoch_file(ckpt_dir: str, name: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"{name}_epoch_{epoch}.pt")


def _optim_file(ckpt_dir: str, name: str, epoch: int) -> str:
    # name-scoped: a crash save (name + "_crash") never clobbers the
    # periodic checkpoint's optimizer state
    return os.path.join(ckpt_dir, f"{name}_optim_epoch_{epoch}.pt")


def _mid_file(ckpt_dir: str, name: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"{name}_epoch_{epoch}_mid.pt")


def _epochs(ckpt_dir: str, pattern: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(pattern)
    return sorted(int(m.group(1)) for fn in os.listdir(ckpt_dir) if (m := pat.match(fn)))


def _saved_epochs(ckpt_dir: str, name: str) -> List[int]:
    return _epochs(ckpt_dir, re.escape(name) + r"_epoch_(\d+)\.pt$")


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + rename, then fsync the directory: a host crash leaves
    the old file or the new one, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _to_bytes(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(
    ckpt_dir: str, name: str, epoch: int, model_state: Dict[str, torch.Tensor],
    optim_state: Optional[Dict[str, Any]] = None, info: Optional[Dict[str, Any]] = None,
    config=None, info_filename: str = "info.json",
) -> str:
    """End-of-epoch save: model file, optimizer file, ``info_filename``,
    ``config.json``. Returns the model file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _epoch_file(ckpt_dir, name, epoch)
    _atomic_write_bytes(path, _to_bytes(_host_snapshot(model_state)))
    if optim_state is not None:
        _atomic_write_bytes(_optim_file(ckpt_dir, name, epoch), _to_bytes(_host_snapshot(optim_state)))
    full_info = {"epoch": epoch, "name": name, **(info or {})}
    _atomic_write_bytes(
        os.path.join(ckpt_dir, info_filename), json.dumps(full_info, indent=2, default=str).encode()
    )
    if config is not None and hasattr(config, "to_dict"):
        _atomic_write_bytes(
            os.path.join(ckpt_dir, "config.json"),
            json.dumps(config.to_dict(), indent=2, default=str).encode(),
        )
    return path


def latest_epoch(ckpt_dir: str, name: str) -> Optional[int]:
    """Highest saved epoch for ``name``."""
    epochs = _saved_epochs(ckpt_dir, name)
    return epochs[-1] if epochs else None


def load_checkpoint(
    ckpt_dir: str, name: str, epoch: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]], Dict[str, Any]]:
    """(model state, optimizer state or None, info) of ``epoch`` (default:
    the latest), on the CPU."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir, name)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint for {name!r} in {ckpt_dir}")
    model_state = _load(_epoch_file(ckpt_dir, name, epoch))
    opt_path = _optim_file(ckpt_dir, name, epoch)
    optim_state = _load(opt_path) if os.path.exists(opt_path) else None
    info: Dict[str, Any] = {"epoch": epoch}
    info_path = os.path.join(ckpt_dir, "info.json")
    if os.path.exists(info_path):
        with open(info_path) as f:
            info.update(json.load(f))
    return model_state, optim_state, info


class AsyncCheckpointWriter:
    """Serialise and write checkpoints off the step loop: the caller pays
    only the device-to-host snapshot; ``torch.save`` and the fsynced rename
    run on a background thread. At most one save is in flight (submitting
    the next waits for the previous), and a writer exception is raised by
    the next ``submit()`` or ``wait()``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as exc:  # raised by the next submit/wait
                self._exc = exc

        self._thread = threading.Thread(target=run, name="vltk-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save is durable; raise its failure."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def save_mid_checkpoint(
    ckpt_dir: str, name: str, epoch: int, model_state, optim_state, info: Dict[str, Any],
    writer: Optional[AsyncCheckpointWriter] = None,
) -> str:
    """Mid-epoch checkpoint as ONE atomic file (model, optimizer, info), so
    that a kill between renames cannot pair new weights with a stale resume
    record. With ``writer`` the write runs on its thread; the snapshot is
    taken here either way."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "model": _host_snapshot(model_state),
        "optim": _host_snapshot(optim_state),
        "info_json": json.dumps({"epoch": epoch, "name": name, **info}, default=str),
    }
    path = _mid_file(ckpt_dir, name, epoch)
    write = lambda: _atomic_write_bytes(path, _to_bytes(payload))  # noqa: E731
    if writer is None:
        write()
    else:
        writer.submit(write)
    return path


def latest_mid_epoch(ckpt_dir: str, name: str) -> Optional[int]:
    epochs = _epochs(ckpt_dir, re.escape(name) + r"_epoch_(\d+)_mid\.pt$")
    return epochs[-1] if epochs else None


def load_mid_checkpoint(ckpt_dir: str, name: str, epoch: int):
    """(model state, optimizer state, info) of a mid-epoch file."""
    payload = _load(_mid_file(ckpt_dir, name, epoch))
    return payload["model"], payload["optim"], json.loads(payload["info_json"])


def clear_mid_checkpoints(ckpt_dir: str, name: str, upto_epoch: int) -> None:
    """Remove the mid-epoch files a completed epoch's save supersedes."""
    for epoch in _epochs(ckpt_dir, re.escape(name) + r"_epoch_(\d+)_mid\.pt$"):
        if epoch <= upto_epoch:
            try:
                os.remove(_mid_file(ckpt_dir, name, epoch))
            except FileNotFoundError:
                pass


def prune_checkpoints(ckpt_dir: str, name: str, keep: int) -> None:
    """Delete all but the ``keep`` highest-epoch checkpoints of ``name``
    (model and optimizer files); ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return
    for epoch in _saved_epochs(ckpt_dir, name)[:-keep]:
        for path in (_epoch_file(ckpt_dir, name, epoch), _optim_file(ckpt_dir, name, epoch)):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# sharded checkpoints: one file a rank
# ---------------------------------------------------------------------------


def _sharded_dir(ckpt_dir: str, name: str, epoch: int, mid: bool) -> str:
    return os.path.join(ckpt_dir, f"{name}_epoch_{epoch}{'_mid' if mid else ''}_sharded")


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(mesh) -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=None if mesh is None else mesh.world_group)


def _layout(mesh) -> Dict[str, Any]:
    world = _rank_world()[1] if mesh is None else mesh.size
    return {"world": world, "axes": [] if mesh is None else [[k, v] for k, v in mesh.shape.items()]}


def save_checkpoint_sharded(ckpt_dir: str, name: str, epoch: int, state_tree, mesh=None, mid: bool = False,
                            collective: bool = True) -> str:
    """Every rank writes its (nested) state of local tensors as
    ``rank{r}.pt``; then rank 0 writes ``layout.json``. Collective over
    the mesh's ranks; ``collective=False`` (a crash save, whose peers may
    be stuck) waits for no other rank. Returns the directory."""
    rank, _ = _rank_world()
    path = _sharded_dir(ckpt_dir, name, epoch, mid)
    os.makedirs(path, exist_ok=True)
    _atomic_write_bytes(os.path.join(path, f"rank{rank}.pt"), _to_bytes(_host_snapshot(state_tree)))
    if collective:
        _barrier(mesh)
    if rank == 0:
        layout = {"epoch": epoch, "name": name, **_layout(mesh)}
        _atomic_write_bytes(os.path.join(path, "layout.json"), json.dumps(layout).encode())
    if collective:
        _barrier(mesh)
    return path


def sharded_epochs(ckpt_dir: str, name: str, mid: bool = False) -> List[int]:
    """Epochs with a complete sharded save (``layout.json`` present)."""
    suffix = "_mid_sharded" if mid else "_sharded"
    return [e for e in _epochs(ckpt_dir, re.escape(name) + r"_epoch_(\d+)" + suffix + "$")
            if os.path.exists(os.path.join(_sharded_dir(ckpt_dir, name, e, mid), "layout.json"))]


def _same_structure(got, want, where: str = "state") -> None:
    """``got`` has ``want``'s keys and tensor shapes; an empty dict in
    ``want`` (a fresh optimizer's state) takes anything."""
    if isinstance(want, dict) and want:
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{where}: keys {sorted(map(str, got)) if isinstance(got, dict) else got!r} "
                             f"differ from the template's")
        for k in want:
            _same_structure(got[k], want[k], f"{where}.{k}")
    elif torch.is_tensor(want) and (not torch.is_tensor(got) or got.shape != want.shape):
        raise ValueError(f"{where}: shape {getattr(got, 'shape', None)} differs from the template's {tuple(want.shape)}")


def load_checkpoint_sharded(ckpt_dir: str, name: str, template_tree=None, epoch: Optional[int] = None,
                            mesh=None, mid: bool = False):
    """This rank's state of a sharded save (default: the latest complete
    one), on the CPU. The save's layout must be this mesh's; with a
    ``template_tree`` (the live state) the names and block shapes must be
    its, so a restore never changes a layout."""
    if epoch is None:
        epochs = sharded_epochs(ckpt_dir, name, mid)
        if not epochs:
            raise FileNotFoundError(f"no sharded checkpoint for {name!r} in {ckpt_dir}")
        epoch = epochs[-1]
    path = _sharded_dir(ckpt_dir, name, epoch, mid)
    with open(os.path.join(path, "layout.json")) as f:
        saved = json.load(f)
    here = _layout(mesh)
    if (saved["world"], saved["axes"]) != (here["world"], here["axes"]):
        raise ValueError(f"checkpoint {path} was saved on mesh {saved['axes']} of {saved['world']} ranks, "
                         f"not on this one ({here['axes']}, {here['world']} ranks)")
    state = _load(os.path.join(path, f"rank{_rank_world()[0]}.pt"))
    if template_tree is not None:
        _same_structure(state, template_tree)
    return state


def remove_sharded(ckpt_dir: str, name: str, epochs, mid: bool = False) -> None:
    """Delete the sharded saves of ``epochs`` (rank 0 only)."""
    import shutil

    if _rank_world()[0] != 0:
        return
    for epoch in epochs:
        shutil.rmtree(_sharded_dir(ckpt_dir, name, epoch, mid), ignore_errors=True)
