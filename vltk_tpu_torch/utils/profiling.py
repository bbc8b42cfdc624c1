"""Timing and tracing hooks: counterpart of ``vltk_tpu/utils/profiling.py``.

* ``get_duration``: wall-clock decorator (the call's seconds in
  ``wrapper.last_duration``);
* ``trace``: a ``torch.profiler`` capture (CPU, and CUDA when a card is
  present) written as a TensorBoard / Chrome trace into ``logdir``;
* ``StepTimer``: step times that wait for the card (``torch.cuda
  .synchronize`` where JAX calls ``block_until_ready``);
* ``annotate``: a named range in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


def get_duration(func: Callable) -> Callable:
    """Wall-clock decorator: the last call's seconds in ``.last_duration``."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        wrapper.last_duration = time.perf_counter() - t0
        return out

    wrapper.last_duration = None
    return wrapper


@contextlib.contextmanager
def trace(logdir: str, with_host: bool = True):
    """Profile the block with ``torch.profiler`` and write its trace into
    ``logdir`` (``trace_{pid}.json``, for TensorBoard or chrome://tracing).
    The profiler object is yielded, so ``key_averages()`` can be read
    after the block. ``with_host=False`` records the card's activity
    alone (CPU alone without a card)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if with_host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named range inside a ``trace`` (host and card timelines)."""
    return torch.profiler.record_function(name)


def _wait(result: Any) -> None:
    """Wait for the card's work behind ``result`` (a tensor, or a dict,
    list or tuple of them)."""
    leaves = result.values() if isinstance(result, dict) else result if isinstance(result, (list, tuple)) else [result]
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Step times of a device loop. ``tic()`` before the step;
    ``toc(n_items, result)`` waits for the card when ``result`` holds CUDA
    tensors, then records. ``summary()``: steps, mean / p50 / p99 seconds
    and items/s, the first (warm-up) step left out."""

    def __init__(self):
        self.times: list = []
        self.items: list = []
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, n_items: int = 1, result: Any = None) -> float:
        if result is not None:
            _wait(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        self.items.append(n_items)
        return dt

    def summary(self, skip_first: bool = True) -> Dict[str, float]:
        times = self.times[1:] if skip_first and len(self.times) > 1 else self.times
        items = self.items[1:] if skip_first and len(self.items) > 1 else self.items
        if not times:
            return {}
        total = sum(times)
        srt = sorted(times)
        return {
            "steps": len(times),
            "mean_s": total / len(times),
            "p50_s": srt[len(srt) // 2],
            "p99_s": srt[min(len(srt) - 1, int(len(srt) * 0.99))],
            "items_per_s": (sum(items) / total) if total > 0 else 0.0,
        }
