"""Checkpoint save and resume, on ``torch.save`` state dicts.

Counterpart of ``vltk_tpu/train/checkpoint.py`` with the same on-disk
layout and resume rules, ``.pt`` files in place of flax msgpack:
``{name}_epoch_{n}.pt`` (the model's state dict) and
``{name}_optim_epoch_{n}.pt`` (optimizer and scheduler state dicts) per
completed epoch, ``info.json`` (epoch, name, step, RNG state, ...) and
``config.json`` beside them; one ``{name}_epoch_{n}_mid.pt`` file for a
mid-epoch (periodic or preemption) save that holds all three, so it is
consistent at any kill instant. Every file is written to a temporary name,
fsynced and renamed (atomic), and the directory is fsynced after. The
sharded save waits for parallelism (ROADMAP A.14).
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


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
