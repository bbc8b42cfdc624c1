"""Time K10 (``csrc/roi_pool_bwd.cu``, the RoIPool backward) on the card
beside ablated copies of it, edited copies and a parent checkout's K10.

    python -m vltk_tpu_torch.tools.bench_roipool_bwd [--ablate]
        [--variant edited_copy.cu ...] [--parent DIR]

Inputs (seeded; bf16, B=2, 300 proposal-like RoIs inside the 800 x 1067
content of the canvas, 14 x 14 bins, C=1024): ``relu``, a relu of a normal
map on 52 x 84 (half the cells zero, so most ties are whole bins of zeros:
K10's plateaus); ``tie_heavy``, a relu of integers in [-3, 3] on 52 x 84
(maxima tie in most bins, not only on zeros); ``tie_84x84``, the same on the
1344 x 1344 canvas's 84 x 84 map (two row bands in bf16). Every build is
timed on each (median of three readings of five calls queued while the card
sleeps), beside its largest difference from ``roi_pool_plain_vjp``.

``--ablate`` adds two edited copies of the shipped source, written into
``_build/sweep/``: ``no_adds`` turns every shared-memory atomic into a
store that never happens (the scans, the tie passes and the write-out
alone) and ``no_ties`` skips the mask walk of ties that are not plateaus;
their times apart from the shipped one's split the kernel. ``--parent``
builds the K10 of another checkout (for the first design of K10, the one
with a cast pass, its C interface with a float32 scratch) and times it in
the same process.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import roi_pool_kernel as RK
from vltk_tpu_torch.ops.roi_pool import roi_pool_plain_vjp, table_levels
from vltk_tpu_torch.tools.variants import SWEEP_DIR, card_name, compile_variant, queued_ms

CASES = {"relu": (52, 84), "tie_heavy": (52, 84), "tie_84x84": (84, 84)}
# the edits of --ablate: (name, the shipped text, its replacement)
ABLATIONS = {
    "no_adds": [("atomicAdd(", "K10_NO_ADD(")],
    "no_ties": [("if (ties) add_ties(cells, bin, scan, g, ties, sums, r0, r1, W);", "")],
}
NO_ADD = "#define K10_NO_ADD(p, v) do { if ((v) == 1234.5f) *(p) = (v); } while (0)\n"


def inputs(case: str, dev, b: int = 2, p: int = 300, c: int = 1024):
    """(features, boxes, grad_out) of one case, seeded."""
    h, w = CASES[case]
    gen = torch.Generator().manual_seed(19)
    if case == "relu":
        feat = torch.relu(torch.randn(b, h, w, c, generator=gen))
    else:
        feat = torch.relu(torch.randint(-3, 4, (b, h, w, c), generator=gen).float())
    content = torch.tensor([min(1067.0, 16.0 * w), min(800.0, 16.0 * h)])  # the image inside the canvas
    xy = torch.rand(b, p, 2, generator=gen) * content
    wh = torch.rand(b, p, 2, generator=gen) ** 2 * content
    boxes = torch.cat([xy, torch.minimum(xy + wh, content)], dim=-1)
    g = torch.randn(b, p, 14, 14, c, generator=gen)
    return feat.to(dev, torch.bfloat16), boxes.to(dev), g.to(dev, torch.bfloat16)


def ablated(name: str) -> str:
    """An edited copy of the shipped source (``ABLATIONS[name]``) under
    ``_build/sweep/``; returns its path."""
    with open(os.path.join(_build.CSRC, "roi_pool_bwd.cu")) as f:
        src = f.read()
    for old, new in ABLATIONS[name]:
        if old not in src:
            raise RuntimeError(f"--ablate {name}: the shipped source no longer holds {old!r}")
        src = src.replace(old, new)
    if name == "no_adds":
        src = src.replace("namespace {\n", NO_ADD + "namespace {\n", 1)
    os.makedirs(SWEEP_DIR, exist_ok=True)
    path = os.path.join(SWEEP_DIR, f"roi_pool_bwd_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def bind(so: str, src: str):
    """(library, takes_scratch): the C interface of a K10 build; a source
    with a cast pass (``cast_out``) is the first design's, which sums into a
    float32 scratch."""
    lib = ctypes.CDLL(os.path.abspath(so))
    with open(src) as f:
        scratch = "cast_out" in f.read()
    fn = lib.roi_pool_backward
    if scratch:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, scratch


def launch(lib, scratch: bool, feat, boxes, g):
    """One call of a build on the planner's tiles (the shipped planner)."""
    b, h, w, c = feat.shape
    mh, mw, _, _ = table_levels(h, w, g.shape[2])
    out = torch.empty_like(feat)
    stream = torch.cuda.current_stream().cuda_stream
    if scratch:
        acc = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
        err = lib.roi_pool_backward(feat.data_ptr(), boxes.data_ptr(), g.data_ptr(), acc.data_ptr(), out.data_ptr(),
                                    b, h, w, c, boxes.shape[1], g.shape[2], 1 / 16, mh, mw, 1, stream)
    else:
        plan = RK.plan_backward(h, w, c, feat.dtype)
        err = lib.roi_pool_backward(feat.data_ptr(), boxes.data_ptr(), g.data_ptr(), out.data_ptr(), b, h, w, c,
                                    boxes.shape[1], g.shape[2], 1 / 16, mh, mw, 1, int(plan.v > 1),
                                    int(plan.staged), plan.band_rows, stream)
    _build.check(err, "roi_pool_backward")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ablate", action="store_true", help="time the no_adds and no_ties copies too")
    ap.add_argument("--variant", action="append", default=[], help="an edited copy of csrc/roi_pool_bwd.cu")
    ap.add_argument("--parent", help="a checkout whose K10 is timed beside")
    args = ap.parse_args(argv)

    builds = {"shipped": os.path.join(_build.CSRC, "roi_pool_bwd.cu")}
    if args.ablate:
        builds.update({name: ablated(name) for name in ABLATIONS})
    for k, path in enumerate(args.variant):
        builds[f"variant{k}: {path}"] = path
    if args.parent:
        builds["parent"] = os.path.join(args.parent, "vltk_tpu_torch", "csrc", "roi_pool_bwd.cu")
    started = {name: compile_variant(src, "roi_pool_bwd", [], f"bench{k}")
               for k, (name, src) in enumerate(builds.items())}
    libs = {}
    for name, (so, proc) in started.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        print(f"{name}: " + "; ".join(line for line in _build.ptxas_lines(out) if "bf16_vector:" in line
                                      or "roi_pool_bwd:" in line))
        libs[name] = bind(so, builds[name])

    dev = torch.device("cuda", 0)
    print(card_name())
    for case in CASES:
        feat, boxes, g = inputs(case, dev)
        want = roi_pool_plain_vjp(feat, boxes, g, 14, 1 / 16).float()
        for name, (lib, scratch) in libs.items():
            err = float((launch(lib, scratch, feat, boxes, g).float() - want).abs().max())
            runs = sorted(queued_ms(lambda: launch(lib, scratch, feat, boxes, g), 5) for _ in range(3))
            print(f"{case:10s} {name:40s} {runs[1]:.4f} ms (runs {', '.join(f'{x:.4f}' for x in runs)}) "
                  f"max_abs_err {err:.3g}", flush=True)
        del feat, boxes, g, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
