"""Block-shape sweep of the flash-attention kernels: the backward pair K5
and K4, or with ``--forward`` the forward K3.

    python -m vltk_tpu_torch.tools.sweep_flash_backward [--shapes 133:133,223:133,...]
        [--n 8] [--s 1024] [--real 819] [--iters 30]
    python -m vltk_tpu_torch.tools.sweep_flash_backward --forward [--shapes 1341,1331,...]
        [--n 32] [--s 1024] [--real 1024] [--iters 30] [--variant FILE ...]

Counterpart of the block-size sweeps of ``tools/probe_flash.py`` (which
hands the TPU kernel other ``block_sizes``). A backward block shape is three
digits: warpgroups of 64 resident rows per block, blocks an SM keeps (which
caps a thread's registers), stages of the TMA ring. Each ``K5:K4`` pair of
``--shapes`` builds ``csrc/flash_attention_bwd.cu`` with ``-DDQ_SHAPE`` and
``-DDKV_SHAPE`` (one nvcc per pair, all started together) into
``vltk_tpu_torch/_build/sweep/``, prints what ``-Xptxas -v`` says of the
two bf16 kernels, holds the build's gradients against the plain backward
(2^-6 of each gradient's largest magnitude, as ``chip_smoke.py`` does),
and times K5 (with di) and K4 with CUDA events over ``--iters`` calls
after two warm-up calls (queued ahead while the card sleeps, so the span
holds no host time), at bf16 (n, s, 12, 64) with ``--real`` real
tokens in every row: the training inputs by default. A forward block shape
is four digits: the three above and the key tile in 64-row units (1 or 2);
each builds ``csrc/flash_attention.cu`` with ``-DFWD_SHAPE``, is held
against the plain version (2^-6 absolute, as ``chip_smoke.py``) and timed
without and with the row statistics, at the serving inputs by default.
Each ``--variant`` names an edited copy of ``csrc/flash_attention.cu``
(kept where git ignores it): every shape is built from it too and timed
beside the shipped source in the same run, its error printed but not
held to the tolerance, so that a copy with a part taken out (an ablation)
shows what that part costs.
The shapes are timed in the order given, then in the reverse order. Needs
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import flash_attention_kernel as FK
from vltk_tpu_torch.ops.flash_attention import flash_self_attention, flash_self_attention_backward
from vltk_tpu_torch.tools.variants import card_name, compile_variant, queued_ms

DEFAULT_SHAPES = "133:133,223:133,222:124,213:213"
DEFAULT_FWD_SHAPES = "2231,2241,2131,1321,1331,1232"
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


def parse_fwd_shapes(text: str):
    """``"1341,..."`` -> [1341, ...]: four nonzero digits each, warpgroups 1
    or 2, at least 2 stages, a key tile of 1 or 2 boxes of 64 rows."""
    shapes = []
    for item in text.split(","):
        x = int(item)
        if not (1000 <= x <= 2999 and "0" not in str(x) and x // 10 % 10 >= 2 and x % 10 <= 2):
            raise ValueError(f"forward block shape {x}: want four digits 1-9, warpgroups 1 or 2, "
                             "stages >= 2, key tile 1 or 2")
        shapes.append(x)
    return shapes


def _label(key) -> str:
    shape, src = key
    return str(shape) if src is None else f"{shape} {os.path.basename(src)}"


def build_fwd(shapes, variants=()):
    """One library per forward shape and source (None: the shipped
    ``csrc/flash_attention.cu``; else a variant's path); returns {(shape,
    source): bound library}."""
    procs = {}
    for src in (None, *variants):
        for x in shapes:
            tag = f"{x}" if src is None else f"{x}_{len(procs)}"
            procs[(x, src)] = compile_variant(src or "flash_attention.cu", "flash_attention", [f"-DFWD_SHAPE={x}"], tag)
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for forward {_label(key)}:\n{out}")
        fwd = [line for line in _build.ptxas_lines(out) if "_bf16" in line or "Performance Loss" in line]
        print(f"{_label(key)} ptxas: " + "; ".join(fwd))
        libs[key] = FK.bind_fwd(ctypes.CDLL(so))
    return libs


def build(pairs):
    """One library per (K5, K4) shape pair; returns {pair: bound library}."""
    procs = {
        (dq, dkv): compile_variant("flash_attention_bwd.cu", "flash_attention_bwd",
                            [f"-DDQ_SHAPE={dq}", f"-DDKV_SHAPE={dkv}"], f"{dq}_{dkv}")
        for dq, dkv in pairs
    }
    libs = {}
    for pair, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for shapes {pair}:\n{out}")
        bwd = [line for line in _build.ptxas_lines(out) if "_bf16" in line or "Performance Loss" in line]
        print(f"{pair[0]}:{pair[1]} ptxas: " + "; ".join(bwd))
        libs[pair] = FK.bind_bwd(ctypes.CDLL(so))
    return libs


def sweep_forward(shapes, n: int, s: int, real: int, iters: int, dev, variants=()) -> dict:
    """K3 at each forward shape, from the shipped source and each variant:
    checked (a variant's error only printed), then timed without and with
    the row statistics; returns {(shape, source): [(ms, ms with
    statistics), ...]}."""
    gen = torch.Generator().manual_seed(7)
    shape = (n, s, 12, FK.HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    mask = torch.zeros(n, s, device=dev)
    mask[:, :real] = 1
    want = flash_self_attention(q, k, v, mask, FK.HEAD_DIM)
    libs = build_fwd(shapes, variants)
    where = card_name()
    default = FK._lib
    keys = list(libs)
    times = {key: [] for key in keys}
    try:
        for key in keys + keys[::-1]:
            FK._lib = lambda lib=libs[key]: lib
            got = FK.flash_attention_cuda(q, k, v, mask, FK.HEAD_DIM)
            err = float((got.float() - want.float()).abs().max())
            if key[1] is None and err > TOL:
                raise SystemExit(f"sweep_flash_backward: forward shape {key[0]} differs from the plain version: {err}")
            ms = queued_ms(lambda: FK.flash_attention_cuda(q, k, v, mask, FK.HEAD_DIM), iters)
            stats_ms = queued_ms(lambda: FK.flash_attention_fwd_residuals_cuda(q, k, v, mask, FK.HEAD_DIM), iters)
            times[key].append((ms, stats_ms))
            print(f"K3 {_label(key)} {ms:.4f} ms, with statistics {stats_ms:.4f} ms at {shape} bf16, {real} real of {s}, "
                  f"on {where}; max abs err {err:.2e}")
    finally:
        FK._lib = default
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true", help="sweep K3's shapes instead of K5:K4 pairs")
    ap.add_argument("--shapes", default=None, help="comma list of K5:K4 block shapes (or K3 shapes with --forward)")
    ap.add_argument("--n", type=int, default=None, help="batch rows (8; 32 with --forward)")
    ap.add_argument("--s", type=int, default=1024)
    ap.add_argument("--real", type=int, default=None, help="real tokens in every row (819; s with --forward)")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--variant", action="append", default=[],
                    help="--forward: an edited copy of csrc/flash_attention.cu, built and timed beside it")
    args = ap.parse_args(argv)
    if args.forward:
        shapes = parse_fwd_shapes(args.shapes or DEFAULT_FWD_SHAPES)
    else:
        pairs = parse_shapes(args.shapes or DEFAULT_SHAPES)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_flash_backward: no CUDA device (the kernels run on the card only)")
    dev = torch.device("cuda", 0)
    if args.forward:
        real = args.s if args.real is None else args.real
        return sweep_forward(shapes, args.n or 32, args.s, real, args.iters, dev,
                             [os.path.abspath(x) for x in args.variant])
    gen = torch.Generator().manual_seed(6)
    shape = (args.n or 8, args.s, 12, FK.HEAD_DIM)
    real = 819 if args.real is None else args.real
    q, k, v, do = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    mask = torch.zeros(shape[0], args.s, device=dev)
    mask[:, :real] = 1
    ids = mask.to(torch.int32)
    o, stats = FK.flash_attention_fwd_residuals_cuda(q, k, v, mask, FK.HEAD_DIM)
    want = flash_self_attention_backward(q, k, v, mask, o, stats, do, FK.HEAD_DIM)
    libs = build(pairs)
    where = card_name()
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
            k5 = queued_ms(lambda: FK.flash_attention_dq_cuda(q, k, v, do, ids, stats, o), args.iters)
            k4 = queued_ms(lambda: FK.flash_attention_dkv_cuda(q, k, v, do, ids, stats, di), args.iters)
            times[pair].append((k5, k4))
            print(f"K5 {pair[0]} {k5:.4f} ms, K4 {pair[1]} {k4:.4f} ms, sum {k5 + k4:.4f} ms at {shape} bf16, "
                  f"{real} real of {args.s}, on {where}; max rel err {err:.2e}")
    finally:
        FK._bwd_lib = default
    return times


if __name__ == "__main__":
    main()
