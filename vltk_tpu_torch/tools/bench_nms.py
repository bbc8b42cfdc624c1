"""Greedy-NMS benchmark: K2's time split into the wrapper's device ops and
the kernel, on ``chip_smoke.py``'s rows and on the B=8 extraction step's
own inputs, with how far the greedy sweep reaches on each.

    python -m vltk_tpu_torch.tools.bench_nms [--batch 8] [--iters 20] [--clusters 1,2,4,8] [--tf32]
        [--variant FILE ...]
    python -m vltk_tpu_torch.tools.bench_nms --device cpu [--batch 1] [--no-step]

The cases are the two calls of one extraction step: the RPN's (B, 6000)
-> 300 at 0.7 and the retry-NMS's (3B, 300) -> 36 at 0.5 / 1.0 / 0.1,
each on two inputs: ``smoke_calls`` (seeded clustered boxes, as
``chip_smoke.py`` phase 5 draws them) and the step's own (``step_calls``:
``adapters.frcnn.setup(preset="parity_300")`` at full width on the
832x1344 canvas, seeded tamed weights and images, recorded by wrapping
``nms_fixed_auto`` at its two call sites for one step). For every case it
prints, for each row, the sorted rank of the last keep and the number of
live candidates (how far the greedy sweep reaches), and from a CPU replay
of K2's word loop (``sweep_pairs``) the boxes greedy reads (the candidates
up to the last keep, or all when the budget is not reached) and three IoU
counts: greedy's, which the bound counts (each candidate the sweep needs
against the keeps before it, up to the first that removes it), K2's (what
its word loop evaluates) and a full K x K mask's.

On the card it then times, each as the median of five readings of
``--iters`` calls queued while the card sleeps, with the range: the whole
call (``nms_fixed_cuda``), the wrapper's device ops alone
(``nms_kernel.prepare``) and the kernel alone on prepared inputs
(``nms_kernel.launch``), plus the device time of every kernel of the call
by name from a ``torch.profiler`` trace. ``--clusters`` also times the
kernel at each of those cluster sizes (rows of the call are each one
thread-block cluster) and checks that every size keeps the same boxes.
Each ``--variant`` names an edited copy of ``csrc/nms.cu`` (kept where git
ignores it), built, checked against the shipped kernel's keeps and timed
beside it; copies that return after a phase (the keys, the sort, the first
word's boxes) split the kernel's time by their differences.
``--tf32`` runs the step twice more, with ``torch.backends.cudnn.allow_tf32``
on and off, and prints per image how many of the RPN's 300 kept anchors
differ between the two. ``--device cpu`` runs the plain version on the
smoke rows (and, without ``--no-step``, nothing of the step: the full-width
model is for the card).
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np
import torch

from vltk_tpu_torch.ops import nms_kernel as NK
from vltk_tpu_torch.ops.nms import NEG_INF, _iou_one_vs_all, nms_fixed, row_thresholds

CANVAS, RAW_CANVAS, RAW_HW = (832, 1344), (512, 672), (480, 640)
WORD = 64  # candidates a word of K2's sweep


def nms_case(gen: torch.Generator, rows: int, k: int, dev):
    """Clustered, heavily overlapping boxes (as proposals are), with score
    ties, zero-area boxes, invalid entries and one row with no candidate."""
    centers = torch.rand(rows, max(k // 40, 1), 2, generator=gen) * torch.tensor([1000.0, 760.0])
    pick = torch.randint(0, centers.shape[1], (rows, k), generator=gen)
    ctr = torch.gather(centers, 1, pick[..., None].expand(rows, k, 2))
    ctr = ctr + torch.randn(rows, k, 2, generator=gen) * 12
    wh = 20 + torch.rand(rows, k, 2, generator=gen) * 200
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.randn(rows, k, generator=gen)
    scores[:, : k // 10] = torch.round(scores[:, : k // 10] * 4) / 4  # ties
    boxes[:, 5, 2] = boxes[:, 5, 0]  # zero area
    boxes[:, 6] = boxes[:, 5]
    valid = torch.rand(rows, k, generator=gen) > 0.05
    valid[-1] = False
    return boxes.to(dev), scores.to(dev), valid.to(dev)


def smoke_calls(batch: int, dev) -> list:
    """The RPN and detection calls as ``chip_smoke.py`` phase 5 draws them
    (one generator, seed 2, RPN rows first)."""
    gen = torch.Generator().manual_seed(2)
    calls = []
    for name, rows, k, max_out, thr in (
        ("rpn", batch, 6000, 300, 0.7),
        ("detections", batch * 3, 300, 36, torch.tensor([0.5, 1.0, 0.1]).repeat(batch)),
    ):
        boxes, scores, valid = nms_case(gen, rows, k, dev)
        thr = thr.to(dev) if torch.is_tensor(thr) else thr
        calls.append(dict(name=name, boxes=boxes, scores=scores, thresh=thr, max_out=max_out, valid=valid))
    return calls


def extraction(dev, batch: int = 8):
    """(bundle, raw images, sizes) of the extraction step as
    ``chip_smoke.py`` drives it."""
    from vltk_tpu_torch.adapters.frcnn import setup, tame_random_weights

    bundle, _ = setup(preset="parity_300", batch_size=batch, device=dev, resized_canvas=CANVAS,
                      short=800.0, maximum=1333.0)
    tame_random_weights(bundle["model"])
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, *RAW_CANVAS, 3), dtype=np.uint8)).to(dev)
    sizes = torch.tensor([RAW_HW] * batch, dtype=torch.int32, device=dev)
    return bundle, raw, sizes


def step_calls(bundle, raw, sizes) -> list:
    """Runs one extraction step with ``nms_fixed_auto`` wrapped at its two
    call sites (``models/rpn.py``, ``models/frcnn.py``) and the RPN's top-k
    wrapped too; returns the two calls' inputs and keeps, the RPN call with
    ``anchors``: the anchor index of each pre-NMS candidate."""
    from vltk_tpu_torch.models import frcnn, rpn

    calls, topk = [], {}
    real_nms, real_topk = rpn.nms_fixed_auto, rpn.topk_lower_index_first

    def recorder(name):
        def wrapped(boxes, scores, iou_threshold, max_out, valid=None):
            keep, keep_valid = real_nms(boxes, scores, iou_threshold, max_out, valid)
            calls.append(dict(name=name, boxes=boxes, scores=scores, thresh=iou_threshold,
                              max_out=max_out, valid=valid, keep=keep, **topk))
            topk.clear()
            return keep, keep_valid
        return wrapped

    def topk_recorder(x, k):
        out = real_topk(x, k)
        topk["anchors"] = out[1]
        return out

    rpn.nms_fixed_auto, frcnn.nms_fixed_auto = recorder("rpn"), recorder("detections")
    rpn.topk_lower_index_first = topk_recorder
    try:
        bundle["step"](raw, sizes)
    finally:
        rpn.nms_fixed_auto = frcnn.nms_fixed_auto = real_nms
        rpn.topk_lower_index_first = real_topk
    if [c["name"] for c in calls] != ["rpn", "detections"]:
        raise SystemExit(f"bench_nms: recorded calls {[c['name'] for c in calls]}, want rpn then detections")
    return calls


def _sorted_live(scores, valid):
    live = scores.float()
    if valid is not None:
        live = torch.where(valid, live, torch.full_like(live, NEG_INF))
    s, order = torch.sort(live, dim=1, descending=True, stable=True)
    return s, order, (s > NEG_INF / 2).sum(1)


def reach(keep: torch.Tensor, scores, valid):
    """Per row: the sorted rank of the last keep (-1 if none) and the number
    of live candidates."""
    _, order, n_cand = _sorted_live(scores, valid)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    kept_rank = torch.gather(rank, 1, keep.clamp(min=0).long())
    last = torch.where(keep >= 0, kept_rank, torch.full_like(kept_rank, -1)).max(dim=1).values
    return last.tolist(), n_cand.tolist()


def _pairwise_over(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """(m, n) bool: IoU(a_i, b_j) > t, in the plain version's arithmetic."""
    return _iou_one_vs_all(a, b[None].expand(a.shape[0], *b.shape)) > t


def _tests_to_first_hit(hit: torch.Tensor) -> torch.Tensor:
    """Per column of a (keeps, candidates) hit matrix: the keeps tested in
    keep order up to the first hit, all of them without one."""
    n = hit.shape[0]
    if n == 0:
        return torch.zeros(hit.shape[1], dtype=torch.long)
    return torch.where(hit.any(0), hit.int().argmax(0) + 1, torch.full((hit.shape[1],), n))


def sweep_pairs(boxes, scores, valid, thresh, max_out: int):
    """A CPU replay of K2's word loop, row by row. Returns (greedy's IoUs,
    K2's IoUs, words visited, candidates greedy reads, keep (R, max_out)).
    Greedy's counts are what the data needs: each candidate up to the last
    keep (or every candidate, if the budget is not reached) is read and
    tested against the keeps before it, up to the first that removes it.
    K2's adds what its word loop evaluates beyond that: the whole last word,
    and the upper triangle of each word's candidates that no earlier keep
    removed."""
    boxes, scores = boxes.detach().cpu().float(), scores.detach().cpu().float()
    valid = None if valid is None else valid.cpu()
    s, order, n_cand = _sorted_live(scores, valid)
    r = scores.shape[0]
    thr = row_thresholds(thresh.cpu() if torch.is_tensor(thresh) else thresh, r, "cpu")
    keep = torch.full((r, max_out), -1, dtype=torch.int32)
    greedy = kernel = words = read = 0
    for i in range(r):
        nc, t = int(n_cand[i]), float(thr[i])
        if nc and torch.isnan(s[i, 0]):
            continue  # a NaN score: the whole row stays -1
        sb = boxes[i, order[i, :nc]]
        kept = []
        for lo in range(0, nc, WORD):
            if len(kept) >= max_out:
                break
            hi = min(lo + WORD, nc)
            words += 1
            before = len(kept)
            pull = _pairwise_over(sb[kept], sb[lo:hi], t)  # (keeps so far, word)
            pulled = _tests_to_first_hit(pull)
            alive = ~pull.any(0)
            kernel += int(pulled.sum()) + int(alive.sum()) * (int(alive.sum()) - 1) // 2
            sup = _pairwise_over(sb[lo:hi], sb[lo:hi], t)
            mine = []  # this word's keeps, as word positions
            for b in range(hi - lo):
                if len(kept) >= max_out:
                    break
                read += 1
                if not alive[b]:
                    greedy += int(pulled[b])
                    continue
                hit = sup[mine, b] if mine else torch.zeros(0, dtype=torch.bool)
                greedy += before + int(_tests_to_first_hit(hit[:, None])[0])
                if not bool(hit.any()):
                    keep[i, len(kept)] = int(order[i, lo + b])
                    kept.append(lo + b)
                    mine.append(b)
    return greedy, kernel, words, read, keep


def spread(fn, iters: int, runs: int = 5):
    """``runs`` readings of ``queued_ms(fn, iters)``, sorted."""
    from vltk_tpu_torch.tools.variants import queued_ms

    return sorted(queued_ms(fn, iters) for _ in range(runs))


def show(times) -> str:
    return f"{times[len(times) // 2]:.4f} [{times[0]:.4f}-{times[-1]:.4f}] ms"


def kernel_split(fn, iters: int) -> dict:
    """Device microseconds per call of every kernel ``fn`` launches, by
    name, from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name[:80]] += (e.time_range.end - e.time_range.start) / iters
    return dict(sorted(per.items(), key=lambda kv: -kv[1]))


def describe(label: str, call: dict) -> dict:
    """Reach and pair counts of one case (any device; counts on the CPU)."""
    keep = call.get("keep")
    if keep is None:
        keep, _ = nms_fixed(call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
    last, live = reach(keep, call["scores"], call["valid"])
    greedy, model, words, read, replay = sweep_pairs(call["boxes"], call["scores"], call["valid"],
                                                     call["thresh"], call["max_out"])
    if not torch.equal(replay, keep.cpu()):
        raise SystemExit(f"bench_nms: the CPU replay of K2's word loop disagrees with the keeps on {label}")
    full = sum(n * (n - 1) // 2 for n in live)
    print(f"{label}: last-keep sorted rank per row {last}; live candidates {live}; boxes greedy reads {read}")
    print(f"{label}: IoU pairs: greedy's (the bound's) {greedy}, K2's modelled {model} over {words} words, "
          f"a full mask's {full}")
    return dict(last_keep_rank=last, live=live, boxes_read=read, greedy_pairs=greedy, kernel_pairs=model,
                words=words, mask_pairs=full)


def build_variants(variants) -> dict:
    """{label: bound library}: each edited copy of ``csrc/nms.cu``, one nvcc
    each, all started together into ``_build/sweep/``."""
    import ctypes
    import os

    from vltk_tpu_torch.ops import _build
    from vltk_tpu_torch.tools.variants import compile_variant

    procs = {}
    for i, src in enumerate(variants):
        procs[os.path.basename(src)] = compile_variant(src, "nms", [], f"variant{i}")
    libs = {}
    for label, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for K2 {label}:\n{out}")
        print(f"K2 {label} ptxas: " + "; ".join(_build.ptxas_lines(out)))
        libs[label] = NK.bind(ctypes.CDLL(so))
    return libs


def time_case(label: str, call: dict, iters: int, clusters, libs=None) -> dict:
    """Whole call, wrapper ops and kernel on the card; per-kernel split;
    each cluster size checked and timed; each other build timed, whether
    it keeps the same boxes printed beside it (the output is a fresh
    ``torch.empty``, so a copy that returns before writing it reads as the
    memory a launch before it left there)."""
    args = (call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
    want, _ = NK.nms_fixed_cuda(*args)
    prep = NK.prepare(call["boxes"], call["scores"], call["thresh"], call["valid"])
    out = dict(call_ms=spread(lambda: NK.nms_fixed_cuda(*args), iters),
               prep_ms=spread(lambda: NK.prepare(call["boxes"], call["scores"], call["thresh"], call["valid"]),
                              iters),
               kernel_ms=spread(lambda: NK.launch(prep, call["max_out"]), iters),
               split_us=kernel_split(lambda: NK.nms_fixed_cuda(*args), iters))
    print(f"{label}: call {show(out['call_ms'])}, wrapper ops {show(out['prep_ms'])}, "
          f"kernel alone {show(out['kernel_ms'])}")
    print(f"{label}: device us per call by kernel: " + "; ".join(f"{n} {us:.2f}" for n, us in out["split_us"].items()))
    for cl in clusters:
        got, _ = NK.launch(prep, call["max_out"], cluster=cl)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"bench_nms: cluster {cl} keeps other boxes than the default on {label}")
        out[f"cluster_{cl}_ms"] = t = spread(lambda: NK.launch(prep, call["max_out"], cluster=cl), iters)
        print(f"{label}: kernel at cluster {cl}: {show(t)}")
    for name, lib in (libs or {}).items():
        got, _ = NK.launch(prep, call["max_out"], lib=lib)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = t = spread(lambda: NK.launch(prep, call["max_out"], lib=lib), iters)
        print(f"{label}: K2 {name}: {show(t)}, same keeps: {torch.equal(got, want)}")
    return out


def tf32_keep_difference(bundle, raw, sizes) -> list:
    """Per image: how many of the RPN's kept anchors with the RPN head's
    float32 conv in TF32 (cuDNN's default) are not kept without TF32."""
    kept = {}
    before = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            rpn_call = step_calls(bundle, raw, sizes)[0]
            keep = rpn_call["keep"].long()
            anchors = torch.gather(rpn_call["anchors"], 1, keep.clamp(min=0))
            kept[tf32] = [set(a[k >= 0].tolist()) for a, k in zip(anchors.cpu(), keep.cpu())]
    finally:
        torch.backends.cudnn.allow_tf32 = before
    return [len(a - b) for a, b in zip(kept[True], kept[False])]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clusters", default="", help="comma list of cluster sizes to check and time")
    ap.add_argument("--tf32", action="store_true", help="RPN keeps with the RPN head's conv in TF32 and not")
    ap.add_argument("--no-step", action="store_true", help="only the smoke rows")
    ap.add_argument("--variant", action="append", default=[],
                    help="an edited copy of csrc/nms.cu, built and timed beside it")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = dev.type == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("bench_nms: no CUDA device (pass --device cpu)")
    clusters = [int(c) for c in args.clusters.split(",") if c]
    if (clusters or args.variant) and not card:
        raise SystemExit("bench_nms: --clusters and --variant launch kernels and need the card")
    if card:
        from vltk_tpu_torch.tools.variants import card_name

        print(f"K2 on {card_name()}")
    libs = build_variants(args.variant) if card and args.variant else {}
    cases = [(f"smoke {c['name']}", c) for c in smoke_calls(args.batch, dev)]
    bundle = None
    if card and not args.no_step:
        bundle, raw, sizes = extraction(dev, args.batch)
        cases += [(f"step {c['name']}", c) for c in step_calls(bundle, raw, sizes)]
    result = {}
    for label, call in cases:
        rows, k = call["scores"].shape
        print(f"{label}: ({rows}, {k}) -> {call['max_out']}")
        result[label] = describe(label, call)
        if card:
            result[label].update(time_case(label, call, args.iters, clusters, libs))
        else:
            import time

            t0 = time.perf_counter()
            nms_fixed(call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
            result[label]["plain_cpu_s"] = time.perf_counter() - t0
    if args.tf32:
        if bundle is None:
            raise SystemExit("bench_nms: --tf32 runs the extraction step and needs the card")
        diff = tf32_keep_difference(bundle, raw, sizes)
        print(f"RPN keeps that differ per image, TF32 on vs off (of {args.batch} x 300): {diff}")
        result["tf32_rpn_keep_difference"] = diff
    print(json.dumps({"bench_nms": result}))
    return result


if __name__ == "__main__":
    main()
