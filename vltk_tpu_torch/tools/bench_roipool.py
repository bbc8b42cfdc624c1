"""RoIPool micro-benchmark: the CUDA kernel K1 against its plain version.

    python -m vltk_tpu_torch.tools.bench_roipool [--b 8] [--h 52] [--w 84] [--c 1024]
        [--p 300] [--iters 20] [--kernels cuda,plain] [--device cuda|cpu]

Counterpart of ``tools/bench_roipool.py`` (the Pallas kernel against the
XLA path on the TPU), with ``--kernels cuda,plain`` in place of
``pallas,xla``. Inputs as the probe draws them
(``tools.probe_roipool_ablation.make_inputs``: bf16, numpy
``default_rng(0)``); each kernel is timed with CUDA events over
``--iters`` back-to-back calls after two warm-up calls (the host clock on
``--device cpu``, where only ``plain`` runs). The JAX tool's ``--cb``
(the Pallas kernel's channel block) has no counterpart: K1 picks its own
channel chunk.
"""

from __future__ import annotations

import argparse

import torch

from vltk_tpu_torch.ops.roi_pool import roi_pool
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_cuda
from vltk_tpu_torch.tools.probe_roipool_ablation import SHAPE, make_inputs, timed


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag, default in zip(("b", "h", "w", "c", "p"), SHAPE):
        ap.add_argument(f"--{flag}", type=int, default=default)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernels", default="cuda", help="comma list from {cuda,plain}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_roipool: no CUDA device (pass --device cpu --kernels plain)")
    kernels = {
        "cuda": lambda f, b: roi_pool_cuda(f, b, 14, 1.0 / 16),
        "plain": lambda f, b: roi_pool(f, b, 14, 1.0 / 16),
    }
    names = args.kernels.split(",")
    unknown = [n for n in names if n not in kernels]
    if unknown:
        ap.error(f"unknown kernels {unknown}: choose from {sorted(kernels)}")
    feat, boxes = make_inputs(args.b, args.h, args.w, args.c, args.p, dev)
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
