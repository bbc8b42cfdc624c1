"""ComplexExperiment: several named train and eval loops an epoch.

Counterpart of ``vltk_tpu/train/complex.py``: ``Loop`` (with
``eval_instance``) and ``ComplexExperiment``, which runs every declared
loop each epoch in declaration order over one shared model and optimizer.
Each train loop has its own step (its own objective), each eval loop its
own metrics; a train loop without a ``loss_fn`` uses the experiment's
``loss_fn``, an eval loop without a ``metric_fn`` its ``eval_metrics``.

Every step writes a record to ``steps_log.json`` (``write_iter``: loop,
epoch, global step, seconds into the loop and the step's metrics, read on
the host each step, as JAX reads them), and every epoch a line to
``epoch_log.txt`` and a checkpoint.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

from vltk_tpu_torch.train.experiment import SimpleExperiment
from vltk_tpu_torch.train.optim import make_optimizer
from vltk_tpu_torch.train.steps import make_eval_step, make_train_step


@dataclasses.dataclass
class Loop:
    """One named train or eval unit. ``loss_fn(model, batch) -> (loss,
    aux dict)`` for a train loop, ``metric_fn(model, batch) -> dict`` for
    an eval loop; None takes the experiment's own."""

    name: str
    loader: Any
    train: bool = True
    loss_fn: Optional[Callable] = None
    metric_fn: Optional[Callable] = None

    @classmethod
    def eval_instance(cls, name: str, loader, metric_fn=None) -> "Loop":
        return cls(name=name, loader=loader, train=False, metric_fn=metric_fn)


class _Empty:
    """The placeholder train loader: the loops bring their own."""

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())


class ComplexExperiment(SimpleExperiment):
    """Runs every declared loop each epoch, in declaration order. The user
    surface adds ``loops() -> Sequence[Loop]``, called once, on the first
    run (after the model and optimizer exist)."""

    def __init__(self, config, loaders=None, mesh=None, rules=None, device=None):
        self._declared_loops: Optional[Sequence[Loop]] = None
        super().__init__(config, loaders=loaders or (_Empty(), None), mesh=mesh, rules=rules, device=device)

    @abc.abstractmethod
    def loops(self) -> Sequence[Loop]:
        """Declare the loops."""

    def _get_loops(self) -> Sequence[Loop]:
        if self._declared_loops is None:
            self._declared_loops = list(self.loops())
            self._make_steps()
        return self._declared_loops

    def _make_steps(self) -> None:
        """One step a loop, over the current optimizer and scheduler."""
        accum = int(getattr(self.config.train, "accum_steps", 1))
        self._steps: Dict[str, Callable] = {}
        for loop in self._declared_loops:
            if loop.train:
                self._steps[loop.name] = make_train_step(
                    self.model, loop.loss_fn or self.loss_fn, self.optimizer, self.scheduler, accum_steps=accum,
                )
            else:
                self._steps[loop.name] = make_eval_step(self.model, loop.metric_fn or self._eval_metric_fn)

    def _rebuild_optimizer(self, total_steps: int) -> None:
        """The optimizer and schedule over ``total_steps``, as JAX swaps the
        optax transformation and keeps its state: the moments and the
        update count carry over (a resumed run's), and the lr is the new
        schedule's at that count. Each loop's step is rebuilt on them."""
        count = self.scheduler.last_epoch
        state = self.optimizer.state_dict()
        self.total_steps = total_steps
        self.optimizer, self.scheduler = make_optimizer(self.model, self.config.train, total_steps)
        self.optimizer.load_state_dict(state)
        factor = self.scheduler.lr_lambdas[0]
        self.scheduler.last_epoch = count
        for group, base in zip(self.optimizer.param_groups, self.scheduler.base_lrs):
            group["lr"] = base * factor(count)
        self.scheduler._last_lr = [group["lr"] for group in self.optimizer.param_groups]
        self._make_steps()

    def outer_loop(self) -> Dict[str, Any]:
        # the schedule was built over the placeholder loader (no steps); now
        # that the loops exist, rebuild it over the true steps an epoch
        loops = self._get_loops()
        steps_per_epoch = sum(len(loop.loader) for loop in loops if loop.train)
        total = max(steps_per_epoch, 1) * self.config.train.epochs
        if total != self.total_steps:
            self._rebuild_optimizer(total)

        last: Dict[str, Any] = {}
        for epoch in range(self.start_epoch, self.config.train.epochs):
            self._current_epoch = epoch
            epoch_metrics: Dict[str, Dict[str, float]] = {}
            for loop in loops:
                if hasattr(loop.loader, "set_epoch"):
                    loop.loader.set_epoch(epoch)
                if loop.train:
                    epoch_metrics[loop.name] = self._run_train_loop(loop, epoch)
                else:
                    epoch_metrics[loop.name] = self._run_eval_loop(loop)
            self.save(epoch)
            self.write_epoch(f"epoch={epoch} " + " ".join(
                f"{name}_{k}={float(v):.5f}" for name, m in epoch_metrics.items() for k, v in m.items()
            ))
            last = {"epoch": epoch, **epoch_metrics}
            if self.config.test_run and self.config.break_loop_on_test:
                break
        return last

    def _run_train_loop(self, loop: Loop, epoch: int) -> Dict[str, float]:
        step = self._steps[loop.name]
        totals: Dict[str, float] = {}
        count = 0
        t0 = time.perf_counter()
        for batch in self._device_batches(loop.loader):
            metrics = step(batch)
            self.global_step += 1
            count += 1
            host = {k: float(v) for k, v in metrics.items()}
            for k, v in host.items():
                totals[k] = totals.get(k, 0.0) + v
            self.write_iter({
                "loop": loop.name, "epoch": epoch, "step": self.global_step,
                "sec": round(time.perf_counter() - t0, 4), **host,
            })
            if self.config.test_run:
                break
        return {k: v / max(count, 1) for k, v in totals.items()}

    def _run_eval_loop(self, loop: Loop) -> Dict[str, float]:
        step = self._steps[loop.name]
        totals: Dict[str, float] = {}
        count = 0
        for batch in self._device_batches(loop.loader):
            metrics = step(batch)
            count += 1
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            if self.config.test_run:
                break
        return {k: v / max(count, 1) for k, v in totals.items()}
