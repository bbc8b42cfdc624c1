"""Finds a cell's pieces by name and runs it once.

``BENCHMARK.json`` at the root of the checkout names the cells, their
configuration and traffic, and the metrics. The pieces are files found by
name, so a later cell or metric is new files and a new entry, never an
edit:

* ``configs/<config>.json``: the configuration as it is run (the ``file``
  of its entry in ``BENCHMARK.json``);
* ``traffic/<traffic>.json``: the traffic mix: which ``driver`` runs it,
  which ``entry`` of the program it drives, and the parameters of the
  general generator (``generate.py``);
* ``workloads/<cell>.json``: the cell's limits for the comparison that
  decides ``correct``;
* ``drivers/<driver>.py``: set-up, warm-up, the measured window and the
  traced window of one kind of traffic;
* ``entries/<entry>.py``: the program's entry point as that traffic drives
  it, the model FLOPs of its work, and the comparison with the plain
  reference (``reference/``);
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx, window,
  trace)`` -> a number, or None when it finds nothing to read; a metric
  named ``<family>.<cells>`` without a file of its own is read by
  ``metrics/<family>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vltk_tpu"})


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, loaded by path (names may hold
    dots), or else ``<kind>/<family>.py`` for a name ``<family>.<rest>``."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    family = os.path.join(BENCH_DIR, kind, name.split(".")[0] + ".py")
    if not os.path.isfile(path) and os.path.isfile(family):
        path, name = family, name.split(".")[0]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Context:
    """One run of one cell: what its pieces read."""

    name: str
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    variant: Optional[str] = None  # a control or a planted fault (tests only)
    t_start: float = 0.0
    notes: Dict = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Seconds from the process's start to the end of a phase of the
        set-up, printed beside the readings."""
        self.notes.setdefault("setup_split", {})[phase] = round(time.time() - self.t_start, 3)


def cell_context(name: str, seed: int, seconds: float, trace: bool, root: str = ROOT,
                 overrides: Optional[Dict] = None) -> Context:
    """The ``Context`` of cell ``name``; ``overrides`` (tests) replace keys
    of the configuration and the traffic (``{"config": {...}, "traffic":
    {...}}``)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell named {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))["limits"]
    overrides = overrides or {}
    _merge(config, overrides.get("config", {}))
    _merge(traffic, overrides.get("traffic", {}))
    cell = dict(cell, end_to_end=_metrics_of(spec["end_to_end"], name),
                per_layer=_metrics_of(spec["per_layer"], name))
    return Context(name, cell, config, traffic, limits, int(seed), float(seconds), bool(trace))


def _merge(base: Dict, extra: Dict) -> None:
    """``extra`` into ``base``, nested groups key by key."""
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def _metrics_of(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a missing or non-finite
    reading fails."""
    out = {}
    for key, limit in limits.items():
        v = readings.get(key)
        out[key] = {"value": float("nan") if v is None else float(v), "limit": float(limit)}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())


def device_info(ctx: Context) -> Dict:
    import torch

    dev = ctx.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def free_device(ctx: Context) -> None:
    import torch

    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


def run(ctx: Context) -> Dict:
    """Set-up, warm-up, the window (traced or not), the metrics, then the
    comparison with the reference once the program is freed. Returns the
    result's JSON object."""
    driver = load_module("drivers", ctx.traffic["driver"])
    entry = load_module("entries", ctx.traffic["entry"])
    window, trace, judged = driver.run(ctx, entry)
    device = device_info(ctx)
    metrics = {}
    group = ctx.cell["per_layer"] if ctx.trace else ctx.cell["end_to_end"]
    for m in group:
        value = load_module("metrics", m["name"]).read(ctx, window, trace)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result: Dict[str, Any] = {"correct": False, "attempted": int(window["attempted"]),
                              "failed": int(window["failed"]), "metrics": metrics, "device": device}
    if trace is not None:
        summary = trace.summary()
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
        trace.prof = None
    del trace
    t0 = time.perf_counter()
    readings = judged()  # frees the program, then runs the reference
    checks = judge(readings, ctx.limits)
    result["correct"] = passed(checks) and window["failed"] == 0
    ctx.notes["check_s"] = time.perf_counter() - t0
    ctx.notes["readings"] = readings
    result["checks"] = checks
    return result
