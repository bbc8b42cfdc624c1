"""Block shapes and channel slabs of K6-K9, the RoIPool ablation kernels,
timed on the probe's inputs.

    python -m vltk_tpu_torch.tools.sweep_roipool_ablation [--shapes 222,221,...]
        [--slabs 0,256,...] [--k89-blocks 1,9,...] [--iters 20]

Builds ``csrc/roi_pool_ablation.cu`` once per (shape, slab, blocks) with
``-DK67_SHAPE`` (digits "bb u t" as K1's: column bins a thread, cells
unrolled, threads in 128s), ``-DK67_SLAB`` (the channels of the table
that one wave of blocks reads; 0: all of C) and ``-DK89_MIN_BLOCKS`` (the
blocks of K8 and K9 an SM must hold at once, __launch_bounds__'s second
argument, which steers their registers; 0: none given), one nvcc per
build, all
started together, into ``vltk_tpu_torch/_build/sweep/``, and prints what
``-Xptxas -v`` says of the bf16 vector kernels timed. On the probe's inputs
(``tools.probe_roipool_ablation.make_inputs``: bf16 (8, 52, 84, 1024) x
300), every build's K6 ``full``, K7 ``full`` and ``stackwrite``, and K8 and
K9 at G = 4 and 12 are held bitwise against the shipped build, then timed
with the table build alone, each call queued while the card sleeps, in the
order given, then reversed, so that drift shows. Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, Tuple

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import roi_pool_ablation_kernel as K
from vltk_tpu_torch.tools.bench_roipool import parse_shapes
from vltk_tpu_torch.tools.probe_roipool_ablation import SHAPE, make_inputs
from vltk_tpu_torch.tools.variants import card_name, compile_variant, queued_ms

# (label, call on features, boxes and a library)
CALLS = (
    ("pool full", lambda f, b, lib: K.pool_cuda(f, b, "full", lib=lib)),
    ("pool_contig full", lambda f, b, lib: K.pool_contig_cuda(f, b, "full", 128, lib=lib)),
    ("pool_contig stackwrite", lambda f, b, lib: K.pool_contig_cuda(f, b, "stackwrite", 128, lib=lib)),
    ("pool_grouped G=4", lambda f, b, lib: K.pool_grouped_cuda(f, b, 4, lib=lib)),
    ("pool_grouped G=12", lambda f, b, lib: K.pool_grouped_cuda(f, b, 12, lib=lib)),
    ("pool_grouped_v3 G=4", lambda f, b, lib: K.pool_grouped_v3_cuda(f, b, 4, lib=lib)),
    ("pool_grouped_v3 G=12", lambda f, b, lib: K.pool_grouped_v3_cuda(f, b, 12, lib=lib)),
    ("table", lambda f, b, lib: K.build_table_cuda(f, lib=lib)),
)
KERNELS = ("roi_ablation_pool_full_bf16_vector", "roi_ablation_contig_full_bf16_vector",
           "roi_ablation_contig_stackwrite_bf16_vector", "roi_ablation_grouped_v2_bf16_vector",
           "roi_ablation_grouped_v3_bf16_vector", "roi_ablation_build_bf16_vector")


def parse_slabs(text: str) -> List[int]:
    """``"0,256"`` -> [0, 256]: channels of a slab, 0 for all of C."""
    slabs = [int(item) for item in text.split(",")]
    if any(s < 0 for s in slabs):
        raise ValueError(f"channel slabs {text}: want channels >= 0")
    return slabs


def parse_blocks(text: str) -> List[int]:
    """``"0,1,9"`` -> [0, 1, 9]: K8/K9 blocks an SM must hold, 0 for none
    given."""
    blocks = [int(item) for item in text.split(",")]
    if any(b < 0 for b in blocks):
        raise ValueError(f"K8/K9 blocks {text}: want blocks >= 0")
    return blocks


Key = Tuple[int, int, int]  # (shape, slab, K8/K9 blocks an SM)


def _label(key: Key) -> str:
    return f"{key[0]:04d} slab {key[1] or 'C'} K8/K9 blocks {key[2]}"


def build(keys) -> Dict[Key, ctypes.CDLL]:
    """One bound library per (shape, slab, blocks), all nvcc processes
    started together."""
    procs = {key: compile_variant("roi_pool_ablation.cu", "roi_pool_ablation",
                                  [f"-DK67_SHAPE={key[0]}", f"-DK67_SLAB={key[1]}", f"-DK89_MIN_BLOCKS={key[2]}"],
                                  "_".join(map(str, key)))
             for key in keys}
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for K6-K9 {_label(key)}:\n{out}")
        lines = [line for line in _build.ptxas_lines(out) if line.startswith(KERNELS)]
        print(f"{_label(key)} ptxas: " + "; ".join(lines))
        libs[key] = K.bind(ctypes.CDLL(so))
    return libs


def sweep(keys, iters: int) -> dict:
    """Each build held bitwise against the shipped one on the probe's
    inputs, then timed; returns {(shape, slab, blocks): {label: [ms in the
    order given, ms reversed]}}."""
    libs = build(keys)
    feat, boxes = make_inputs(*SHAPE, torch.device("cuda", 0))
    for label, call in CALLS[:-1]:
        want = call(feat, boxes, None)
        for key, lib in libs.items():
            got = call(feat, boxes, lib)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise SystemExit(f"sweep_roipool_ablation: {label} of {_label(key)} != the shipped build")
            del got
        print(f"{label}: every build bitwise equal to the shipped one")
        del want
    times = {key: {label: [] for label, _ in CALLS} for key in keys}
    for order in (list(keys), list(keys)[::-1]):
        for key in order:
            for label, call in CALLS:
                times[key][label].append(queued_ms(lambda: call(feat, boxes, libs[key]), iters))
    for key in keys:
        print(f"{_label(key)}: " + "; ".join(
            f"{label} {t[0]:.4f} / {t[1]:.4f} ms" for label, t in times[key].items()))
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="221", help="K67_SHAPE digits 'bb u t', comma-separated")
    ap.add_argument("--slabs", default="256", help="K67_SLAB channels (0: all of C), comma-separated")
    ap.add_argument("--k89-blocks", default="1", help="K89_MIN_BLOCKS (0: none given), comma-separated")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    keys = [(shape, slab, blocks) for shape in parse_shapes(args.shapes) for slab in parse_slabs(args.slabs)
            for blocks in parse_blocks(args.k89_blocks)]
    if not torch.cuda.is_available():
        raise SystemExit("sweep_roipool_ablation: no CUDA device (the builds run on the card)")
    print(card_name())
    print(f"inputs: the probe's, bf16 {SHAPE[:4]} x {SHAPE[4]}; times: given order / reversed")
    return sweep(keys, args.iters)


if __name__ == "__main__":
    main()
