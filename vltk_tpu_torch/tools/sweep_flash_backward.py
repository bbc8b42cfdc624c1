"""Block-shape sweep of the flash-attention backward kernels K5 and K4.

    python -m vltk_tpu_torch.tools.sweep_flash_backward [--shapes 133:133,223:133,...]
        [--n 8] [--s 1024] [--real 819] [--iters 30]

Counterpart of the block-size sweeps of ``tools/probe_flash.py`` (which
hands the TPU kernel other ``block_sizes``). Here a block shape is three
digits: warpgroups of 64 resident rows per block, blocks an SM keeps (which
caps a thread's registers), stages of the TMA ring. Each ``K5:K4`` pair of
``--shapes`` builds ``csrc/flash_attention_bwd.cu`` with ``-DDQ_SHAPE`` and
``-DDKV_SHAPE`` (one nvcc per pair, all started together) into
``vltk_tpu_torch/_build/sweep/``, prints what ``-Xptxas -v`` says of the
two bf16 kernels, holds the build's gradients against the plain backward
(2^-6 of each gradient's largest magnitude, as ``chip_smoke.py`` does),
and times K5 (with di) and K4 with CUDA events over ``--iters`` calls
after two warm-up calls, at bf16 (n, s, 12, 64) with ``--real`` real
tokens in every row: the training inputs by default. The pairs are timed
in the order given, then in the reverse order. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import flash_attention_kernel as FK
from vltk_tpu_torch.ops.flash_attention import flash_self_attention_backward

DEFAULT_SHAPES = "133:133,223:133,222:124,213:213"
TOL = 2.0 ** -6


def parse_shapes(text: str):
    """``"133:133,..."`` -> [(133, 133), ...]: three nonzero digits each,
    warpgroups 1 or 2, at least 2 stages."""
    pairs = []
    for item in text.split(","):
        dq, _, dkv = item.partition(":")
        shape = (int(dq), int(dkv))
        for x in shape:
            if not (100 <= x <= 299 and "0" not in str(x) and x % 10 >= 2):
                raise ValueError(f"block shape {x}: want three digits 1-9, warpgroups 1 or 2, stages >= 2")
        pairs.append(shape)
    return pairs


def build(pairs):
    """One library per (K5, K4) shape pair; returns {pair: bound library}."""
    out_dir = os.path.join(_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, "flash_attention_bwd.cu")
    procs = {}
    for dq, dkv in pairs:
        so = os.path.join(out_dir, f"libflash_attention_bwd_{dq}_{dkv}.so")
        cmd = [_build.nvcc_path(), *_build._flags("flash_attention_bwd"), f"-DDQ_SHAPE={dq}",
               f"-DDKV_SHAPE={dkv}", "-o", so, src]
        procs[(dq, dkv)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for pair, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for shapes {pair}:\n{out}")
        bwd = [line for line in _build.ptxas_lines(out) if "_bf16" in line or "Performance Loss" in line]
        print(f"{pair[0]}:{pair[1]} ptxas: " + "; ".join(bwd))
        libs[pair] = FK.bind_bwd(ctypes.CDLL(so))
    return libs


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=DEFAULT_SHAPES, help="comma list of K5:K4 block shapes")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--s", type=int, default=1024)
    ap.add_argument("--real", type=int, default=819, help="real tokens in every row")
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    pairs = parse_shapes(args.shapes)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_flash_backward: no CUDA device (the kernels run on the card only)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(6)
    shape = (args.n, args.s, 12, FK.HEAD_DIM)
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    mask = torch.zeros(args.n, args.s, device=dev)
    mask[:, : args.real] = 1
    ids = mask.to(torch.int32)
    o, stats = FK.flash_attention_fwd_residuals_cuda(q, k, v, mask, FK.HEAD_DIM)
    want = flash_self_attention_backward(q, k, v, mask, o, stats, do, FK.HEAD_DIM)
    libs = build(pairs)
    where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    default = FK._bwd_lib
    times = {pair: [] for pair in pairs}
    try:
        for pair in pairs + pairs[::-1]:
            FK._bwd_lib = lambda lib=libs[pair]: lib
            got = FK.flash_attention_backward_cuda(q, k, v, mask, o, stats, do, FK.HEAD_DIM)
            err = max(float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want))
            if err > TOL:
                raise SystemExit(f"sweep_flash_backward: shapes {pair} differ from the plain backward: {err}")
            di = FK.flash_attention_dq_cuda(q, k, v, do, ids, stats, o)[1]
            k5 = _ms(lambda: FK.flash_attention_dq_cuda(q, k, v, do, ids, stats, o), args.iters)
            k4 = _ms(lambda: FK.flash_attention_dkv_cuda(q, k, v, do, ids, stats, di), args.iters)
            times[pair].append((k5, k4))
            print(f"K5 {pair[0]} {k5:.4f} ms, K4 {pair[1]} {k4:.4f} ms, sum {k5 + k4:.4f} ms at {shape} bf16, "
                  f"{args.real} real of {args.s}, on {where}; max rel err {err:.2e}")
    finally:
        FK._bwd_lib = default
    return times


if __name__ == "__main__":
    main()
