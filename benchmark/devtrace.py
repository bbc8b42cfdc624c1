"""The traced window: ``torch.profiler`` over the last part of a run's
window, reduced to what the per-layer metrics read.

``Trace`` starts and stops the profiler at step boundaries, each after a
synchronise, so the kernels in its window are those the steps inside it
launched. ``summary`` gives the busy seconds (the union of the device
intervals: kernels, copies and sets, not user annotations) and the
breakdown: the device operations that took most time, and the idle gaps by
the innermost host op that was running in the middle of each. ``ops``
gives the device time under the host ops of a name (their own kernels and
their children's, so a ``record_function`` range counts the kernels inside
it, not its own span on the device timeline). Shapes are not recorded:
the readers take them from the configuration and the traffic, which keeps
the profiler's own host time down.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch


def busy_union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint, sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """Profile the steps between ``start()`` and ``stop()``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = 0.0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and not hasattr(self, "_t1")

    def stop(self) -> None:
        self._sync()
        self._t1 = time.perf_counter()
        self.prof.stop()
        self.window_s = self._t1 - self._t0

    def _split(self):
        if not hasattr(self, "_host"):
            from torch.autograd import DeviceType

            self._host, self._dev = [], []
            for e in self.prof.events():
                if e.device_type == DeviceType.CPU:
                    self._host.append(e)
                elif not getattr(e, "is_user_annotation", False) and not e.name.startswith("Optimizer."):
                    self._dev.append(e)
        return self._host, self._dev

    def summary(self, top: int = 10) -> Dict:
        """Window, busy seconds and the breakdown (worked out once)."""
        if getattr(self, "_summary", None) is not None:
            return self._summary
        host, dev = self._split()
        merged = busy_union([(e.time_range.start, e.time_range.end) for e in dev])
        by_name = defaultdict(float)
        for e in dev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        self._summary = {
            "window_s": self.window_s,
            "busy_s": sum(e - s for s, e in merged) * 1e-6,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": self._gaps(merged, host)[:top],
        }
        return self._summary

    def ops(self, match) -> List[float]:
        """Host ops whose name satisfies ``match`` and that sit inside no op
        of the same name: the device seconds under each."""
        host, _ = self._split()

        def device_us(e) -> float:
            own = sum(k.duration for k in e.kernels if k.name != e.name)
            return own + sum(device_us(c) for c in e.cpu_children)

        out = []
        for e in host:
            if not match(e.name):
                continue
            parent = e.cpu_parent
            while parent is not None and parent.name != e.name:
                parent = parent.cpu_parent
            if parent is None:
                out.append(device_us(e) * 1e-6)
        return out

    @staticmethod
    def _gaps(merged, host, longest: int = 400):
        """Idle gaps between busy intervals, summed by the innermost host op
        running at each gap's middle (the longest ``longest`` gaps)."""
        if len(merged) < 2 or not host:
            return []
        gaps = sorted(((merged[i + 1][0] - merged[i][1], (merged[i + 1][0] + merged[i][1]) / 2)
                       for i in range(len(merged) - 1)), reverse=True)[:longest]
        starts = np.array([e.time_range.start for e in host], dtype=np.float64)
        ends = np.array([e.time_range.end for e in host], dtype=np.float64)
        names = [e.name for e in host]
        out = defaultdict(float)
        for length, mid in gaps:
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = names[inside[np.argmax(starts[inside])]] if inside.size else "no host op"
            out[name] += length * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])
