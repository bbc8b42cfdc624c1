"""RoIPool micro-benchmark: the CUDA kernel K1 against its plain version,
and a sweep of K1's block shapes on the extraction step's own inputs.

    python -m vltk_tpu_torch.tools.bench_roipool [--b 8] [--h 52] [--w 84] [--c 1024]
        [--p 300] [--iters 20] [--kernels cuda,plain] [--device cuda|cpu]
    python -m vltk_tpu_torch.tools.bench_roipool --shapes 222,221,... [--iters 20]
        [--variant FILE ...]

Counterpart of ``tools/bench_roipool.py`` (the Pallas kernel against the
XLA path on the TPU), with ``--kernels cuda,plain`` in place of
``pallas,xla``. Inputs as the probe draws them
(``tools.probe_roipool_ablation.make_inputs``: bf16, numpy
``default_rng(0)``); each kernel is timed as the probe times it
(``timed``: CUDA events over ``--iters`` calls queued while the card
sleeps, after two warm-up calls; the host clock on ``--device cpu``,
where only ``plain`` runs). The JAX tool's ``--cb``
(the Pallas kernel's channel block) has no counterpart.

``--shapes`` (needs the card) builds ``csrc/roi_pool.cu`` once per block
shape with ``-DK1_SHAPE`` (digits "bb u t": column bins a thread, cells
unrolled, threads in 128s; see the source), one nvcc per shape, all
started together, into ``vltk_tpu_torch/_build/sweep/``, and prints what
``-Xptxas -v`` says of its kernels. Each ``--variant`` names an edited copy
of ``csrc/roi_pool.cu`` (kept where git ignores it), built at every shape
too. The inputs are the main path's: the features and proposals that one
B=8 extraction step (``adapters.frcnn.setup(preset="parity_300")`` at full
width, seeded weights and images) hands K1, kept by a hook on the RoI
heads. Every build is held bitwise against the plain version on both paths
(the scalar one on a copy of the features one element into its storage; a
variant's result is printed, not held), then timed on both paths with
calls queued while the card sleeps, in the order given, then reversed, so
that drift shows; the vector path is timed on the probe's inputs too.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import roi_pool_kernel as RK
from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_cuda
from vltk_tpu_torch.tools.probe_roipool_ablation import SHAPE, make_inputs, timed
from vltk_tpu_torch.tools.variants import card_name, compile_variant, queued_ms, unaligned

# the extraction step as chip_smoke.py drives it: the 832x1344 canvas
# holds a 480x640 image resized to 800 on its short side
CANVAS, RAW_CANVAS, RAW_HW = (832, 1344), (512, 672), (480, 640)


def parse_shapes(text: str):
    """``"222,..."`` -> [222, ...]: column bins 01-14 (the leading digits),
    a nonzero unroll and thread count."""
    shapes = []
    for item in text.split(","):
        x = int(item)
        if not (1 <= x // 100 <= 14 and x // 10 % 10 and x % 10):
            raise ValueError(f"K1 block shape {item}: want digits 'bb u t', bb 01-14, u and t nonzero")
        shapes.append(x)
    return shapes


def step_inputs(dev, batch: int = 8):
    """The (features, boxes) that one extraction step hands K1: parity_300
    at full width, seeded random weights tamed as for the smoke run, seeded
    random images; kept by a forward pre-hook on the RoI heads."""
    from vltk_tpu_torch.adapters.frcnn import setup, tame_random_weights

    bundle, _ = setup(preset="parity_300", batch_size=batch, device=dev, resized_canvas=CANVAS,
                      short=800.0, maximum=1333.0)
    tame_random_weights(bundle["model"])
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, *RAW_CANVAS, 3), dtype=np.uint8)).to(dev)
    sizes = torch.tensor([RAW_HW] * batch, dtype=torch.int32, device=dev)
    kept = {}
    hook = bundle["model"].roi_heads.register_forward_pre_hook(
        lambda _module, args: kept.update(features=args[0], boxes=args[1]))
    try:
        bundle["step"](raw, sizes)
    finally:
        hook.remove()
    feat, boxes = kept["features"].contiguous(), kept["boxes"].contiguous()
    del bundle, kept
    torch.cuda.empty_cache()
    return feat, boxes


def _label(key) -> str:
    shape, src = key
    return f"{shape:04d}" if src is None else f"{shape:04d} {os.path.basename(src)}"


def build(shapes, variants=()):
    """One library per shape and source (None: the shipped
    ``csrc/roi_pool.cu``; else a variant's path); returns {(shape, source):
    bound library}."""
    procs = {}
    for src in (None, *variants):
        for x in shapes:
            tag = f"{x:04d}" if src is None else f"{x:04d}_{len(procs)}"
            procs[(x, src)] = compile_variant(src or "roi_pool.cu", "roi_pool", [f"-DK1_SHAPE={x}"], tag)
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for K1 {_label(key)}:\n{out}")
        print(f"{_label(key)} ptxas: " + "; ".join(_build.ptxas_lines(out)))
        libs[key] = RK.bind(ctypes.CDLL(so))
    return libs


def sweep(shapes, step: tuple, probe: tuple, iters: int, variants=()) -> dict:
    """Each build checked bitwise against the plain version on both paths
    at the step's inputs, then timed; returns {(shape, source): {case: [ms
    in the order given, ms reversed]}} with cases "step" and "step scalar"
    (the step's inputs on each path) and "probe" (the vector path on the
    probe's inputs)."""
    libs = build(shapes, variants)
    feat, boxes = step
    want = roi_pool_offsets(feat, boxes, 14, 1.0 / 16)
    cases = {"step": (feat, boxes), "step scalar": (unaligned(feat), boxes), "probe": probe}
    for key, lib in libs.items():
        for path, case in (("vector", "step"), ("scalar", "step scalar")):
            got, took = RK.launch(lib, *cases[case], 14, 1.0 / 16)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            print(f"{_label(key)}: bitwise_equal={same} ({took} path)")
            if key[1] is None and (not same or took != path):
                raise SystemExit(f"bench_roipool: K1 shape {_label(key)} != plain on the {path} path")
    del want
    keys = list(libs)
    times = {key: {case: [] for case in cases} for key in keys}
    for order in (keys, keys[::-1]):
        for key in order:
            for case, (f, b) in cases.items():
                times[key][case].append(queued_ms(lambda: RK.launch(libs[key], f, b, 14, 1.0 / 16), iters))
    for key in keys:
        print(f"{_label(key)}: " + ", ".join(f"{case} {t[0]:.4f} / {t[1]:.4f} ms" for case, t in times[key].items())
              + " (order given / reversed)")
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag, default in zip(("b", "h", "w", "c", "p"), SHAPE):
        ap.add_argument(f"--{flag}", type=int, default=default)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", default="cuda", help="comma list from {cuda,plain}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shapes", default="", help="comma list of K1 block shapes to build and time")
    ap.add_argument("--variant", action="append", default=[],
                    help="--shapes: an edited copy of csrc/roi_pool.cu, built and timed beside it")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_roipool: no CUDA device (pass --device cpu --kernels plain)")
    if args.shapes:
        shapes = parse_shapes(args.shapes)
        if dev.type != "cuda":
            raise SystemExit("bench_roipool: --shapes builds CUDA kernels and needs the card")
        step = step_inputs(dev)
        print(f"K1 block shapes on the B=8 extraction step's inputs {tuple(step[0].shape)} {step[0].dtype} x "
              f"{step[1].shape[1]} and on the probe's ({args.b}, {args.h}, {args.w}, {args.c}) bf16 x {args.p}, "
              f"on {card_name()}")
        probe = make_inputs(args.b, args.h, args.w, args.c, args.p, dev)
        return sweep(shapes, step, probe, args.iters, args.variant)
    feat, boxes = make_inputs(args.b, args.h, args.w, args.c, args.p, dev)
    kernels = {
        "cuda": lambda f, b: roi_pool_cuda(f, b, 14, 1.0 / 16),
        "plain": lambda f, b: roi_pool_offsets(f, b, 14, 1.0 / 16),
    }
    names = args.kernels.split(",")
    unknown = [n for n in names if n not in kernels]
    if unknown:
        ap.error(f"unknown kernels {unknown}: choose from {sorted(kernels)}")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {}
    for name in names:
        result[name] = ms = timed(lambda: kernels[name](feat, boxes), args.iters, dev)
        print(
            f"{name}: {ms:.4f} ms for ({args.b}, {args.p}) RoIs over "
            f"({args.h}, {args.w}, {args.c}) bf16 on {where}"
        )
    return result


if __name__ == "__main__":
    main()
