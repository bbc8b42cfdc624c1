"""Ablation probe of the RoIPool design on the card: which phase dominates?

    python -m vltk_tpu_torch.tools.probe_roipool_ablation [--iters 20] [--device cuda|cpu]
        [--b 8] [--h 52] [--w 84] [--c 1024] [--p 300]

Counterpart of ``tools/probe_roipool_ablation.py`` (JAX on the TPU). Makes
the probe's inputs (bf16 features (8, 52, 84, 1024) and 300 boxes per
image, from a numpy ``default_rng(0)`` as the JAX probe draws them) and
times, with CUDA events over ``--iters`` calls queued while the card
sleeps (so the wrappers' host work, a 358 MB table allocation and a
``ctypes`` call, stays out of the span), after two warm-up calls:

* ``shipped``: RoIPool K1 (``ops/roi_pool_kernel.py``), the reference of
  every comparison;
* ``table``: the row-range-max table build on its own (a phase of every
  variant below);
* K6 ``pool`` in its modes full, v3, noP1, noP2, noBoth; K7
  ``pool_contig`` in full, stackwrite, p1only, zeroOut (cb 128, or the
  largest power of two dividing C below that); K8 ``pool_grouped`` and K9
  ``pool_grouped_v3`` at G = 4 and 12 (the JAX ``main`` times K9 at those
  two; P must be a multiple of 12).

Each line prints the time and, for the modes that compute RoIPool, whether
the result is bitwise equal to K1's (the channel-blocked layout moved
back). The modes that remove a phase are not RoIPool (see
``ops/roi_pool_ablation.py``), so they are timed only. The last line is
one JSON object with every row. ``--device cpu`` runs the plain versions
and times them on the host clock (use small sizes there).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from vltk_tpu_torch.ops import roi_pool_ablation as plain
from vltk_tpu_torch.ops.roi_pool_ablation_kernel import (
    build_table_cuda,
    pool_auto,
    pool_contig_auto,
    pool_grouped_auto,
    pool_grouped_v3_auto,
)
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto
from vltk_tpu_torch.tools.variants import queued_ms

SHAPE = (8, 52, 84, 1024, 300)  # b, h, w, c, p


def make_inputs(b: int, h: int, w: int, c: int, p: int, device, seed: int = 0):
    """bf16 features (B, H, W, C) and float32 boxes (B, P, 4) inside the
    (16 H, 16 W) image, drawn as the JAX probe and bench draw them."""
    rng = np.random.default_rng(seed)
    feat = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(device, torch.bfloat16)
    boxes = np.zeros((b, p, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, w * 16 - 2, (b, p))
    boxes[..., 1] = rng.uniform(0, h * 16 - 2, (b, p))
    boxes[..., 2] = np.minimum(boxes[..., 0] + rng.uniform(1, w * 16, (b, p)), w * 16 - 1)
    boxes[..., 3] = np.minimum(boxes[..., 1] + rng.uniform(1, h * 16, (b, p)), h * 16 - 1)
    return feat, torch.from_numpy(boxes).to(device)


def timed(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean ms of one call after two warm-up calls: on the card, CUDA
    events over ``iters`` calls queued while it sleeps
    (``tools.variants.queued_ms``); the host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return queued_ms(fn, iters)
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def variants(feat: torch.Tensor, boxes: torch.Tensor) -> Dict[str, Callable[[], torch.Tensor]]:
    """Every variant and mode, as called (``pool_contig`` returns its
    channel-blocked layout)."""
    cb = math.gcd(128, feat.shape[-1])
    out: Dict[str, Callable[[], torch.Tensor]] = {}
    for mode in plain.POOL_MODES:
        out[f"pool {mode}"] = lambda mode=mode: pool_auto(feat, boxes, mode)
    for mode in plain.CONTIG_MODES:
        out[f"pool_contig {mode}"] = lambda mode=mode: pool_contig_auto(feat, boxes, mode, cb)
    for g in (4, 12):
        out[f"pool_grouped G={g}"] = lambda g=g: pool_grouped_auto(feat, boxes, g)
        out[f"pool_grouped_v3 G={g}"] = lambda g=g: pool_grouped_v3_auto(feat, boxes, g)
    return out


#: the variants whose result is RoIPool (the others remove a phase)
ROIPOOL = ("pool full", "pool v3", "pool_contig full", "pool_contig stackwrite",
           "pool_grouped G=4", "pool_grouped G=12", "pool_grouped_v3 G=4", "pool_grouped_v3 G=12")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def run(feat: torch.Tensor, boxes: torch.Tensor, iters: int = 20) -> List[dict]:
    """Times K1, the table build and every variant; checks the RoIPool ones
    against K1 bitwise. Returns one row per line printed."""
    dev = feat.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    shipped = lambda: roi_pool_auto(feat, boxes, 14, 1.0 / 16)  # noqa: E731
    want = shipped()
    rows = [{"variant": "shipped", "ms": timed(shipped, iters, dev), "same_as_shipped": True}]
    if dev.type == "cuda":
        rows.append({"variant": "table", "ms": timed(lambda: build_table_cuda(feat), iters, dev),
                     "same_as_shipped": None})
    for label, fn in variants(feat, boxes).items():
        same = None
        if label in ROIPOOL:
            got = plain.from_contig(fn()) if label.startswith("pool_contig") else fn()
            same = bool(torch.equal(_bits(got), _bits(want)))
        rows.append({"variant": label, "ms": timed(fn, iters, dev), "same_as_shipped": same})
    for r in rows:
        r["device"] = name
        tail = "" if r["same_as_shipped"] is None else f"  (numerics match: {r['same_as_shipped']})"
        print(f"{r['variant']}: {r['ms']:.4f} ms on {name}{tail}")
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag, default in zip(("b", "h", "w", "c", "p"), SHAPE):
        ap.add_argument(f"--{flag}", type=int, default=default)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_roipool_ablation: no CUDA device (pass --device cpu for the plain versions)")
    feat, boxes = make_inputs(args.b, args.h, args.w, args.c, args.p, dev)
    rows = run(feat, boxes, args.iters)
    print(json.dumps({"shape": [args.b, args.h, args.w, args.c, args.p], "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
