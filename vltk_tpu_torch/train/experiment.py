"""SimpleExperiment: the experiment lifecycle of the port.

Counterpart of ``vltk_tpu/train/experiment.py``, with its lifecycle
(dirs, seed, loaders, model, optimizer, resume), loops (epochs x (train,
eval)), ``test_run`` / ``break_loop_on_test``, ``steps_log.json`` and
``epoch_log.txt``, per-epoch and mid-epoch checkpoints with exact resume
(replay-skip of the batches already trained), the SIGTERM preemption save
and the crash save. Differences of idiom: the model is an ``nn.Module`` on
an explicit device (CUDA unless the caller passes ``device="cpu"``), the
optimizer is ``torch.optim.AdamW`` with a ``LambdaLR`` schedule, and the
RNG is torch's, seeded from ``config.train.seed`` and saved (CPU and CUDA
state) in every checkpoint's info.

Under a mesh (``mesh=parallel.make_mesh(...)``, ``rules`` such as
``parallel.LXMERT_RULES``): the model is built whole on every rank and
cut by the rules (``parallel.shard_params``), every rank loads the global
batch and keeps its ``data`` block (``parallel.shard_batch``, JAX's
``shard_batch`` placement; the loader's host shards would split the
global order differently and are refused), the step reduces the
gradients over data x seq, ``config.mesh.zero1_axis`` turns on ZeRO-1,
the RNG is seeded per replica (seed + its data x seq index, the same on
every rank of the ``model``, ``expert`` and ``pipe`` axes, whose ranks are
replicas of one another's tokens), dropout on heads cut over ``model``
draws from the mesh's model-parallel generator (seeded from the seed, the
replica and the model coordinate, and saved with the RNG state),
checkpoints are sharded, one file a rank
(``checkpoint.save_checkpoint_sharded``), and the SIGTERM flag is agreed
over the mesh (a MAX all-reduce before every step's stop decision), so
every rank stops and saves after the same step.

User surface:

  * ``build_model()`` -> ``nn.Module``  [required]
  * ``loss_fn(model, batch)`` -> (loss, dict of scalar tensors)  [required]
  * ``eval_metrics(model, batch)`` -> dict of scalar tensors  [optional]
  * ``prepare_batch(batch)`` -> dict of arrays  [optional filter]
  * ``epoch_logstr(epoch, train_m, eval_m)``  [optional]
"""

from __future__ import annotations

import abc
import base64
import json
import os
import signal
import sys
import time
from typing import Any, Dict, Iterable

import numpy as np
import torch
from torch import nn

from vltk_tpu_torch import DeviceLike, resolve_device
from vltk_tpu_torch.data.loader import device_put_iter
from vltk_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    clear_mid_checkpoints,
    latest_epoch,
    latest_mid_epoch,
    load_checkpoint,
    load_checkpoint_sharded,
    load_mid_checkpoint,
    prune_checkpoints,
    remove_sharded,
    save_checkpoint,
    save_checkpoint_sharded,
    save_mid_checkpoint,
    sharded_epochs,
)
from vltk_tpu_torch.train.optim import make_optimizer
from vltk_tpu_torch.train.steps import make_eval_step, make_train_step


def _b64(t: torch.Tensor) -> str:
    return base64.b64encode(t.cpu().numpy().tobytes()).decode()


def _unb64(s: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(base64.b64decode(s), dtype=np.uint8).copy())


class SimpleExperiment(abc.ABC):
    name: str = "experiment"

    def __init__(self, config, loaders=None, mesh=None, rules=None, device: DeviceLike = None):
        if rules is not None and mesh is None:
            raise ValueError("sharding rules need a mesh")
        if mesh is not None:
            if not mesh.is_member:
                raise ValueError(f"this rank is outside the mesh {mesh.shape}")
            if device is not None and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's ({mesh.device})")
            if int(getattr(config.data, "shard_count", None) or 1) > 1:
                raise ValueError(
                    "under a mesh every rank loads the global batch and keeps its data block; "
                    "leave data.shard_count unset")
            device = mesh.device
        self.config = config
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        self._init_dirs()
        self._init_seed()
        self._init_loaders(loaders)
        self._init_models()
        self._init_optim()
        self._init_checkpoint()

    # -- lifecycle -----------------------------------------------------------

    def _init_dirs(self) -> None:
        self.logdir = os.path.join(self.config.logdir, self.name)
        os.makedirs(self.logdir, exist_ok=True)
        self.ckpt_dir = self.config.checkpoint_dir or os.path.join(self.logdir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            # one step log a rank; the checkpoints stay shared
            self.logdir = os.path.join(self.logdir, f"rank{torch.distributed.get_rank()}")
            os.makedirs(self.logdir, exist_ok=True)
        # one writer for every checkpoint, so renames stay strictly ordered
        self._ckpt_writer = AsyncCheckpointWriter()

    def _init_seed(self) -> None:
        # the CPU and every CUDA device; one stream a replica under a mesh
        offset = self.mesh.replica_index if self.mesh is not None else 0
        torch.manual_seed(self.config.train.seed + offset)
        if self.mesh is not None:
            self.mesh.seed_model_parallel(self.config.train.seed)

    def _init_loaders(self, loaders) -> None:
        if loaders is None:
            from vltk_tpu_torch.data.builder import init_datasets

            loaders = init_datasets(self.config)
        self.train_loader, self.eval_loader = loaders
        if self.train_loader is None:
            raise ValueError("experiment requires a train loader")

    def _init_models(self) -> None:
        self.model: nn.Module = self.build_model().to(self.device)
        if self.rules is not None:
            from vltk_tpu_torch.parallel import shard_params

            shard_params(self.model, self.rules, self.mesh)

    def _init_optim(self) -> None:
        steps_per_epoch = max(len(self.train_loader), 1)
        self.total_steps = steps_per_epoch * self.config.train.epochs
        self.optimizer, self.scheduler = make_optimizer(
            self.model, self.config.train, self.total_steps, mesh=self.mesh, zero1_axis=self._zero1_axis())
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.optimizer, self.scheduler,
            accum_steps=int(getattr(self.config.train, "accum_steps", 1)), mesh=self.mesh,
        )
        self.eval_step = make_eval_step(self.model, self._eval_metric_fn, mesh=self.mesh)
        self.start_epoch = 0
        self.global_step = 0
        self._skip_steps = 0  # batches to replay-skip on a mid-epoch resume
        self._preempted = False  # this rank saw SIGTERM
        self._stopping = False  # the ranks agreed to stop after this step

    def _zero1_axis(self):
        """``config.mesh.zero1_axis`` under a mesh, else None."""
        return getattr(self.config.mesh, "zero1_axis", None) if self.mesh is not None else None

    def _init_checkpoint(self) -> None:
        """Resume from the newest checkpoint: the highest completed epoch,
        unless a later epoch has a mid-epoch save, which re-enters that
        epoch step by step."""
        if self.mesh is not None:
            full = (sharded_epochs(self.ckpt_dir, self.name) or [None])[-1]
            mid = (sharded_epochs(self.ckpt_dir, self.name, mid=True) or [None])[-1]
        else:
            full = latest_epoch(self.ckpt_dir, self.name)
            mid = latest_mid_epoch(self.ckpt_dir, self.name)
        # a mid file of an epoch <= full is a leftover the epoch's save supersedes
        use_mid = mid is not None and (full is None or mid > full)
        epoch = mid if use_mid else full
        if epoch is None:
            return
        if self.mesh is not None:
            state = load_checkpoint_sharded(self.ckpt_dir, self.name, epoch=epoch, mesh=self.mesh, mid=use_mid)
            model_state, optim_state, info = state["model"], state["optim"], json.loads(state["info_json"])
        elif use_mid:
            model_state, optim_state, info = load_mid_checkpoint(self.ckpt_dir, self.name, epoch)
        else:
            model_state, optim_state, info = load_checkpoint(self.ckpt_dir, self.name, epoch)
        self.model.load_state_dict(model_state)
        if optim_state is not None:
            self.optimizer.load_state_dict(optim_state["optimizer"])
            self.scheduler.load_state_dict(optim_state["scheduler"])
        self.global_step = int(info.get("step", 0))
        if use_mid:
            # re-enter the interrupted epoch; the loader's order replays
            self.start_epoch = epoch
            self._skip_steps = int(info.get("step_in_epoch", 0))
        else:
            self.start_epoch = epoch + 1
        rng = info.get("rng")
        if rng is not None:
            # the exact RNG stream: resumed steps draw the dropout masks the
            # uninterrupted run would
            torch.set_rng_state(_unb64(rng["cpu"]))
            if rng.get("cuda") and torch.cuda.is_available():
                torch.cuda.set_rng_state_all([_unb64(s) for s in rng["cuda"]])
            if rng.get("model_parallel") and self.mesh is not None:
                self.mesh.model_generator.set_state(_unb64(rng["model_parallel"]))

    # -- user surface --------------------------------------------------------

    @abc.abstractmethod
    def build_model(self) -> nn.Module:
        """-> the model, on the CPU; the experiment moves it to its device."""

    @abc.abstractmethod
    def loss_fn(self, model: nn.Module, batch: Dict[str, Any]):
        """-> (scalar loss tensor, dict of scalar metric tensors)"""

    def eval_metrics(self, model: nn.Module, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {}

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Keep the numeric arrays; drop strings and objects."""
        return {
            k: v for k, v in batch.items()
            if (isinstance(v, np.ndarray) and v.dtype != object) or torch.is_tensor(v)
        }

    def epoch_logstr(self, epoch, train_metrics, eval_metrics) -> str:
        parts = [f"epoch={epoch}"]
        parts += [f"train_{k}={float(v):.5f}" for k, v in train_metrics.items()]
        parts += [f"eval_{k}={float(v):.5f}" for k, v in eval_metrics.items()]
        return " ".join(parts)

    # -- loops ---------------------------------------------------------------

    def __call__(self) -> Dict[str, Any]:
        self._current_epoch = self.start_epoch
        restore = self._install_preemption_handler()
        try:
            return self.outer_loop()
        except BaseException:
            if self.config.save_on_crash:
                # best effort: a failing crash save must not hide the error
                try:
                    self.save(epoch=self._current_epoch, crash=True)
                except Exception as exc:
                    print(f"crash save failed: {exc!r}", file=sys.stderr)
            raise
        finally:
            restore()

    def _install_preemption_handler(self):
        """SIGTERM (a preemption notice) sets a flag; the inner loop stops at
        the next step boundary and the outer loop writes a mid-epoch save.
        Returns a thunk that restores the previous handler."""

        def _on_term(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread: the flag can be set directly
            return lambda: None

        def restore():
            if prev is not None:  # None: a handler not installed from Python
                signal.signal(signal.SIGTERM, prev)

        return restore

    def outer_loop(self) -> Dict[str, Any]:
        last: Dict[str, Any] = {}
        for epoch in range(self.start_epoch, self.config.train.epochs):
            self._current_epoch = epoch
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            self._steps_done_in_epoch = 0
            train_m = self.inner_loop(epoch)
            # under a mesh only the agreed flag: a rank's own may have been
            # set after the last agreement
            if self._stopping if self.mesh is not None else self._preempted:
                # the authoritative preemption save, then stop
                self.save_mid(epoch, step_in_epoch=self._steps_done_in_epoch, wait=True)
                return {"epoch": epoch, "train": train_m, "preempted": True}
            eval_m = self.eval_loop()
            self.save(epoch)
            self.write_epoch(self.epoch_logstr(epoch, train_m, eval_m))
            last = {"epoch": epoch, "train": train_m, "eval": eval_m}
            if self.config.test_run and self.config.break_loop_on_test:
                break
        return last

    def inner_loop(self, epoch: int) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        count = 0
        skip, self._skip_steps = self._skip_steps, 0
        self._steps_done_in_epoch = skip  # batches consumed, the skipped prefix included
        save_every = int(getattr(self.config.train, "save_every_steps", 0))
        t0 = time.perf_counter()
        with open(os.path.join(self.logdir, "steps_log.json"), "a") as log:
            # metrics are fetched ONE STEP LATE: reading the step just
            # launched would make the host wait for the card every step;
            # step i's values are read once step i + 1 is queued behind it
            pending = None  # (step id, device metrics)

            def drain(p):
                step_id, m = p
                host = {k: float(v) for k, v in m.items()}
                for k, v in host.items():
                    totals[k] = totals.get(k, 0.0) + v
                log.write(json.dumps({
                    "epoch": epoch, "step": step_id,
                    "sec": round(time.perf_counter() - t0, 4), **host,
                }) + "\n")

            for batch in self._device_batches(self.train_loader, skip=skip):
                metrics = self.train_step(batch)
                self.global_step += 1
                count += 1
                if pending is not None:
                    drain(pending)
                pending = (self.global_step, metrics)
                if count % 16 == 0:
                    log.flush()
                self._steps_done_in_epoch = skip + count
                if save_every and count % save_every == 0:
                    self.save_mid(epoch, step_in_epoch=skip + count)
                self._stopping = self._agree_preempted()
                if self._stopping or self.config.test_run:
                    break
            if pending is not None:
                drain(pending)
        return {k: v / max(count, 1) for k, v in totals.items()}

    def _agree_preempted(self) -> bool:
        """The stop decision after a step: this rank's SIGTERM flag, under a
        mesh the MAX of every rank's (one all-reduce), so a signal that
        reached one rank first stops them all after the same step."""
        if self.mesh is None:
            return self._preempted
        from vltk_tpu_torch.parallel import collectives as C

        flag = torch.tensor([int(self._preempted)], dtype=torch.int32, device=self.mesh.device)
        C.all_reduce_(flag, self.mesh.world_group, "preempt_agree", op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    def eval_loop(self) -> Dict[str, float]:
        if self.eval_loader is None:
            return {}
        totals: Dict[str, float] = {}
        count = 0
        pending = None  # the same one-step-late fetch as inner_loop

        def drain(m):
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)

        for batch in self._device_batches(self.eval_loader):
            metrics = self.eval_step(batch)
            count += 1
            if pending is not None:
                drain(pending)
            pending = metrics
            if self.config.test_run:
                break
        if pending is not None:
            drain(pending)
        return {k: v / max(count, 1) for k, v in totals.items()}

    def _eval_metric_fn(self, model: nn.Module, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return self.eval_metrics(model, batch)

    def _device_batches(self, loader, skip: int = 0) -> Iterable[Dict[str, Any]]:
        """The loader's prepared batches on the device
        (``data.loader.device_put_iter``: pinned buffers and a side stream
        on CUDA, batch i + 1 queued before batch i is handed out). A
        mid-epoch resume replays the order without the first ``skip``
        batches (at the index level through ``loader.iter_from`` where the
        loader has it)."""
        if skip and hasattr(loader, "iter_from"):
            it, skip = loader.iter_from(skip), 0
        else:
            it = loader
        prepared = (self.prepare_batch(batch) for i, batch in enumerate(it) if i >= skip)
        if self.mesh is not None:
            from vltk_tpu_torch.parallel import shard_batch

            prepared = (shard_batch(b, self.mesh) for b in prepared)
        return device_put_iter(prepared, device=self.device)

    # -- persistence and logging --------------------------------------------

    def _resume_info(self) -> Dict[str, Any]:
        rng = {"cpu": _b64(torch.get_rng_state())}
        if self.device.type == "cuda":
            rng["cuda"] = [_b64(s) for s in torch.cuda.get_rng_state_all()]
        if self.mesh is not None:
            rng["model_parallel"] = _b64(self.mesh.model_generator.get_state())
        return {"step": self.global_step, "rng": rng}

    def _optim_state(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "scheduler": self.scheduler.state_dict()}

    def save(self, epoch: int, crash: bool = False) -> None:
        # the in-flight periodic save first: clear_mid_checkpoints must
        # order after it, and its failure must surface here
        self._ckpt_writer.wait()
        if self.mesh is not None:
            self._save_sharded(epoch, crash)
            return
        # a crash save gets its own names, so it never pairs pre-crash
        # weights with the crash step in the main files
        save_checkpoint(
            self.ckpt_dir, self.name if not crash else f"{self.name}_crash", epoch,
            self.model.state_dict(), self._optim_state(), info=self._resume_info(),
            config=self.config, info_filename="crash_info.json" if crash else "info.json",
        )
        if not crash:
            clear_mid_checkpoints(self.ckpt_dir, self.name, epoch)
            prune_checkpoints(self.ckpt_dir, self.name, int(getattr(self.config.train, "keep_checkpoints", 0)))

    def save_mid(self, epoch: int, step_in_epoch: int, wait: bool = False) -> None:
        """Periodic or preemption save: one atomic file. Periodic saves
        write on the background writer (``train.async_save``); ``wait=True``
        (the preemption save) blocks until the file is durable. Under a
        mesh the save is sharded and synchronous."""
        if self.mesh is not None:
            info = {"epoch": epoch, "name": self.name, **self._resume_info(), "step_in_epoch": int(step_in_epoch)}
            save_checkpoint_sharded(self.ckpt_dir, self.name, epoch, self._sharded_state(info), self.mesh, mid=True)
            return
        save_mid_checkpoint(
            self.ckpt_dir, self.name, epoch, self.model.state_dict(), self._optim_state(),
            info={**self._resume_info(), "step_in_epoch": int(step_in_epoch)},
            writer=self._ckpt_writer,
        )
        if wait or not bool(getattr(self.config.train, "async_save", True)):
            self._ckpt_writer.wait()

    def _sharded_state(self, info: Dict[str, Any]) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optim": self._optim_state(),
                "info_json": json.dumps(info, default=str)}

    def _save_sharded(self, epoch: int, crash: bool) -> None:
        name = self.name if not crash else f"{self.name}_crash"
        info = {"epoch": epoch, "name": name, **self._resume_info()}
        save_checkpoint_sharded(self.ckpt_dir, name, epoch, self._sharded_state(info), self.mesh, collective=not crash)
        if crash:
            return
        remove_sharded(self.ckpt_dir, self.name, [e for e in sharded_epochs(self.ckpt_dir, self.name, mid=True)
                                                   if e <= epoch], mid=True)
        keep = int(getattr(self.config.train, "keep_checkpoints", 0))
        if keep > 0:
            remove_sharded(self.ckpt_dir, self.name, sharded_epochs(self.ckpt_dir, self.name)[:-keep])

    def write_epoch(self, line: str) -> None:
        with open(os.path.join(self.logdir, "epoch_log.txt"), "a") as f:
            f.write(line + "\n")

    def write_iter(self, record: Dict[str, Any]) -> None:
        """One step's record as a line of ``steps_log.json``."""
        with open(os.path.join(self.logdir, "steps_log.json"), "a") as f:
            f.write(json.dumps(record) + "\n")
