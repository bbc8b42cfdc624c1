#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts on the card.

    python3 chip_smoke.py        # from the repository root, one NVIDIA card

It drives the port only (``vltk_tpu_torch``; nothing of JAX or of the JAX
package):

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the main paths from ``csrc/`` (one
   nvcc per source, started together) and prints the build time and each
   kernel's registers and spills (``-Xptxas -v``);
3. prints K1's block shape and its registers and spills, and holds the
   RoIPool kernel K1 against its plain PyTorch version, bitwise, in float32
   and bf16, at the extraction shapes of B=8 and B=16, on both of its
   paths (16-byte vectors on the aligned map, one element a thread on a
   copy one element into its storage; the wrapper's per-path counts show
   which ran); times both paths and the plain version at both step shapes
   (the median of five readings of 20 calls queued ahead, with the spread);
4. prints the block shape of the ablation kernels K6-K9 and the
   registers, spills, shared memory and resident warps of K6-K9 and the
   table build (the bf16 vector path must spill nothing and use under 4 KB
   of shared memory); holds K6-K9 (``pool``, ``pool_contig``,
   ``pool_grouped``, ``pool_grouped_v3``) against their plain versions,
   bitwise, every mode, at (2, 52, 84, 1024) float32 and (8, 52, 84, 1024)
   bf16 x 300 RoIs (K7 at cb 128, K8/K9 at G 4 and 12, also against K6
   ``full`` / ``v3``), on both paths (16-byte vectors; one element a
   thread on a copy one element into its storage) and on a copy with NaN
   and -inf cells (NaN in the same places), and the RoIPool modes against
   K1; times every mode and the table build alone (the median of five
   readings queued ahead, with the spread), K6's and K7's ``full`` and K8
   and K9 at G 4 on the scalar path, and the plain versions at the bf16
   shape, and prints the phase split; then runs the probe's path
   (``tools.probe_roipool_ablation.run``: every variant timed and checked
   against K1 on the probe's inputs) with the launch counts set to 0,
   checks that K6-K9 were launched there, all on the vector path, and
   prints each one's loss there, launches x (ms - bound);
5. prints K2's registers and spills, holds the greedy-NMS kernel K2
   against its plain version, exact keep indices and masks, at the RPN
   shape (B, 6000) -> 300 and the detection shape (B*3, 300) -> 36 for B=8
   and B=16, at the cluster size the wrapper picks and at every other one,
   and on rows with a NaN coordinate and a NaN score (JAX's keeps); times
   both calls (each call's median of five readings, with the spread), with
   how far the greedy sweep reaches;
6. prints K3's registers and spills, and holds the flash-attention kernel
   K3 against its plain version at every position, with its row
   statistics (1e-5) and two calls bitwise equal: bf16 at the serving
   shape (32, 1024, 12, 64) with rows padded to other lengths, bf16 at
   s=197, f32 at a small shape, and masks whose whole key tiles K3 skips
   (alternating blocks of 64 and of 128 real and pad positions,
   real-pad-real, a row of one real token) at s = 256, 1000 and 1024 in
   bf16 and f32; times the kernel, the plain version and
   ``scaled_dot_product_attention`` with the same boolean mask (the
   yardstick; the port never calls it) and without it on all-real rows,
   then the kernel on the padded serving rows and, with its statistics, at
   the training inputs;
7. runs the 36-box extraction (``adapters.frcnn.setup(preset="parity_300")``:
   R-101-C4, 1600 classes, 400 attributes, bf16) at full width on the
   832x1344 canvas with seeded random weights, tamed so activations stay
   finite; checks the packed output and that K1 and K2 were launched on
   that run (K2 twice a step), and prints images/s at B=8 and B=16; then
   times K1 on the features and proposals that the B=8 step handed it
   (kept by a hook on the RoI heads), checked bitwise there too, and K2 on
   the two calls of one more B=8 step (recorded at their call sites), held
   exactly at every cluster size there too;
8. runs a small f32 FRCNN on the card and on the CPU with the same weights
   and compares them key by key (the CPU path is the one the test suite
   holds against the JAX package);
9. serves composed VQA with ``predict.VQAPredictor`` at full width
   (the parity_300 FRCNN, tamed, then LXMERT-base: 9 language, 5 visual
   and 5 cross layers, hidden 768, 12 heads, 3129 answers, bf16; seeded
   random weights; questions of 20 tokens) on the extraction canvas: three
   requests (8 pairs; 8 pairs with one image larger than the raw canvas;
   the first request's first 5 pairs, so 3 pad rows), scores finite in
   [0, 1] and ranked, boxes finite and inside each caller's image, K1
   launched once (vector path) and K2 twice a bucket and no other kernel,
   the padded bucket's real rows equal to the same pairs in the full
   bucket; times the step at B=8 on device-resident inputs and the FRCNN
   part alone (samples/s, the LXMERT share by difference, peak memory);
   then runs the first bucket with cuDNN's TF32 off and prints how many
   final boxes, object ids and top-1 answers move (measured, not checked);
10. runs a small f32 composed predictor on the card and on the CPU with
   the same weights (three pairs at batch 2, a pad row) and compares
   answers, their order, object ids and box counts exactly, scores
   (1e-4) and boxes (rtol/atol 1e-3);
11. serves documents with ``predict.DocTokenClassifier`` at LayoutLM-base
   width (12 layers, hidden 768, 12 heads, bf16, seeded random weights,
   max_seq_length 1024, attention_impl "auto"): three requests of four
   synthetic documents, one per word within the budget, K3 launched 12
   times per forward; then times the classifier step at the JAX bench.py
   geometry (B=32, seq 1024) on the dense route and on K3, with documents/s
   and peak memory;
12. runs a small f32 LayoutLM on the card and on the CPU with the flash
   route forced on both sides (K3 on the card, the plain version on the
   CPU) and compares the real positions;
13. holds the flash-attention backward kernels K5 (dq, and the fused
   ``di = sum(o * do)``) and K4 (dk, dv), and K3's row statistics, against
   the plain backward: bf16 at the training shape (8, 1024, 12, 64) with
   rows of 1024, 819, 129 and 1 real tokens, bf16 with alternating 64-row
   blocks of real and pad (whole tiles the kernels skip), bf16 at s=197,
   ``mask=None``, f32 at a small shape; di against its torch expression;
   checks that two backward calls are bitwise equal; times K5, K4, the
   plain backward, the torch di pass K5 replaces, and
   ``scaled_dot_product_attention``'s backward with the same boolean mask,
   measured directly after one forward (the yardstick; the port never
   calls it);
14. trains ``OCRTokenExperiment`` at LayoutLM-base width (bf16, seq 1024,
   attention dropout 0, hidden dropout 0.1, seeded random weights, AdamW
   lr 1e-5 with warmup, decay and clip 1.0) for one epoch of 8 batches of
   B=8 drawn as the JAX bench.py draws them (20% pad tail, -100 labels on
   the pad) and repeated: the loss is finite and falls, K3, K4 and K5 run
   12 times per step, ``steps_log.json`` and a checkpoint are written; then
   times the step on the K3/K4/K5 route and on the dense route (sequences/s,
   ms/step, peak memory);
15. compares one full-width bf16 step's parameter gradients on the flash
   route against the dense route (relative L2 per tensor);
16. trains a small f32 LayoutLM two steps on the card and on the CPU with
   the flash route forced on both sides and compares loss, gradients and
   the parameters after the AdamW update;
17. serves document span QA with ``predict.DocSpanQA`` at LayoutLM-base
   width (bf16, seeded random weights, attention_impl "auto", a 64-token
   question and a 960-token document, so seq 1024 and the question's pad
   is a hole in mid-stream): three requests (4, 4 and 3 pairs, so the last
   bucket has a pad row) of synthetic documents with questions of 5-40
   words, K3 launched 12 times a forward and no other kernel, each answer
   a span of its document whose text is the span's words, the padded
   bucket's log-probabilities and answers bitwise equal to the same pairs
   in a full bucket; times the span step at B=32, seq 1024, on the dense
   route and on K3 (questions/s, ms/step, peak memory) and, apart, the host
   decode (``_best_span`` over up to 959 positions a row);
18. runs a small f32 DocSpanQA on the card and on the CPU, flash route
   forced on both sides, and compares log-probabilities at real positions
   (1e-4) and answers (equal);
19. trains ``DocVQASpanExperiment`` at LayoutLM-base width for an epoch of
   8 steps at B=8, seq 1024 (64 question + 960 OCR tokens, a 20% pad tail;
   hidden dropout 0.1, attention dropout 0, lr 1e-5): finite losses,
   ``span_acc`` logged, K3, K5 and K4 12 times each a step and no other
   kernel; times the step (sequences/s, peak memory);
20. one f32 span training step of a small LayoutLM on the card and on the
   CPU, flash route forced on both sides: loss (1e-5) and gradients (1e-4);
21. trains ``LxmertVQAExperiment`` and ``LxmertPretrainExperiment`` (all
   four tasks) at LXMERT-base (9/5/5 layers, 768, 3129 answers, bf16
   compute, float32 parameters) for 4 steps each at B=32 (20-token
   questions, 36 boxes of 2048 features): finite losses, every
   pretraining term logged, no kernel launched (none is expected on this
   path); times each step (samples/s, peak memory);
22. one f32 pretraining step's losses of a small LXMERT on the card and on
   the CPU, every term within 1e-5;
23. the int8 presets, after the bf16 paths they mirror: extraction with
   ``setup(preset="production")`` (int8_300: every bottleneck conv on the
   int8 path) on the parity run's tamed weights, B=8 and B=16: the first
   step calibrates on its first 4 images (one unchunked forward: K1 once,
   K2 twice) and the scales are finite, positive and reused; K1 and K2 as
   parity_300's; images/s, step ms and peak beside parity_300's of this
   run, box agreement @IoU 0.5 and matched feature cosine against
   parity_300 (reported, not gated: tamed random weights); then
   ``tools.probe_int8`` at 2400 RoIs (bf16 vs int8 per res5 conv, the
   int8 split into quantize / product / rescale) and the space-to-depth
   stem against the plain stem (f32 to 1e-5 of the output's scale, both
   timed in bf16 at B=8); ``VQAPredictor`` with int8_300 and LXMERT-base
   int8 (both scale sets recorded on the first request, then three
   requests reuse them: K1 3, K2 6, K3 0; the padded bucket equal to the
   full one; samples/s beside bf16's); ``DocTokenClassifier`` and
   ``DocSpanQA`` at LayoutLM-base int8, seq 1024, B=32 (K3 12 a forward,
   documents/s and questions/s beside bf16's, labels against bf16's
   reported); tiny f32 int8 FRCNN, LXMERT and LayoutLM card vs CPU with
   the same scales (1e-4, or 1e-2 of the output's scale where an int8
   rounding flip reached it); last (after 24-29), the int8 products (``torch._int_mm``
   behind im2col) against the exact route on the card, bitwise, at every
   conv geometry and (M, K, N) those paths ran, an M <= 16 product and a
   NaN activation (0, as on the CPU);
24. ViT-B/16 at 224, bf16, B=64 (seeded random weights): the K3 route
   (``attention_impl="flash"``: 12 launches a forward, no other kernel),
   the dense route and int8 (the six projection sites of each layer,
   calibrated on the first 8 images; its product geometries join those
   checked last), the two float routes' pooled outputs within 2^-4, every
   output finite; images/s of each; then K3 at (64, 197, 12, 64) with no
   mask against its plain version, timed beside SDPA without a mask and
   its byte bound;
25. VisualBERT at visualbert-vqa width (12 layers, 768, 2048-d regions),
   bf16, B=32, 128 text tokens of 8-128 real and 36 regions (164 positions,
   the text pad a hole in mid-stream): the K3 route (12 launches) against
   the dense route on the logits (2^-6), both timed; K3 at (32, 164, 12,
   64) with that mask against its plain version, timed beside SDPA with the
   boolean mask;
26. LXMERT-base's widths with the MoE feed-forward (8 experts, top 2,
   capacity factor 1.25) at every feed-forward site, its depth cut from
   9 / 5 / 5 to 3 / 2 / 2 layers (9 sites, ~0.4 B parameters) to keep the
   script's time, bf16, B=32, 20 tokens, 36 boxes: one forward with 9
   finite, positive aux terms, then 4 steps of ``LxmertVQAExperiment``
   (finite losses, no kernel), the step timed with its peak memory;
27. ``serving.for_doc`` over LayoutLM-base's ``DocTokenClassifier`` (seq
   1024, batch 4): 11 concurrent single documents from threads, answers
   equal to one direct batched call, K3 12 launches a bucket, latency
   percentiles; every wait with a timeout;
28. small f32 ViT (K3 vs dense), VisualBERT (K3 vs plain flash) and MoE
   LXMERT (logits and aux terms) card vs CPU;
29. the host data plane through the user's entry points: a raw COCO-2014 +
   VQA corpus from seed 0 (64 JPEGs of 480 x 640, 512 questions, 4
   answers) -> the coco2014 and vqa adapters' Arrow tables ->
   ``FRCNN.extract`` (parity_300, B=8, seeded tamed weights from a state
   dict: K1 8 and K2 16 launches, no other kernel) -> 8 stored rows
   bitwise equal to a direct call of the step on the same decoded batch ->
   ``Experiments.get("data")`` on ``build(config)`` (extractor "frcnn",
   B=32, 4 loader threads) -> ``LxmertVQAExperiment`` with
   ``loaders=None``, LXMERT-base bf16, an epoch of 16 steps (finite
   losses, no kernel); prints the ETL seconds, images/s through the
   extraction pipeline, the host fetch a batch (median, p90), the step in
   two more epochs each with the loader and without it (one host batch
   16 times through the same loop and feed), alternated, the bare step on
   one device-resident batch, and whether the loader kept up (with it
   within 10% of without);
30. documents from raw JSON: 64 seeded FUNSD forms of 780 words (~1000
   sub-tokens) -> the ``funsd`` adapter -> ``build(config)`` with
   ``auxtokenize, ocrboxfixed, tokenlabels`` at seq 1024 ->
   ``OCRTokenExperiment`` at LayoutLM-base bf16, B=8, one epoch of 8
   steps; 64 seeded DocVQA documents of 700 words with two questions each
   -> ``docvqavisn`` and ``docvqa`` (answers grounded by Jaccard) ->
   ``build`` with ``span`` at question 64 + document 960 ->
   ``DocVQASpanExperiment``, one epoch of 16 steps (finite losses, K3, K4
   and K5 12 launches each a step, no other kernel); prints the ETL
   seconds, the host fetch a batch, the step with and without the loader
   (alternated, as phase 29) and the bare step;
31. GQA on Visual Genome: 64 seeded 480 x 640 VG JPEGs and 512 GQA
   questions -> the ``gqa`` adapter -> ``FRCNN.extract(dataset_name=
   "visualgenome")`` (parity_300, B=8: K1 8, K2 16; 8 stored rows bitwise
   equal to a direct step) -> ``build`` joining the questions with the VG
   features -> ``LxmertVQAExperiment`` at LXMERT-base bf16, B=32, one epoch
   (finite losses, no kernel); then ``HostDecodeFRCNN`` over the same
   images inline and with 4 spawned worker processes (merged table equal
   to the inline one; images/s, the stage seconds and ``os.cpu_count()``
   printed), ``FRCNN.extract(host_workers=2)`` refused with ``ValueError``,
   and the mask processors through ``build`` on seeded CLEVR-ref and
   COCO-polygon corpora against the plain NumPy / PIL decodes (point runs
   bitwise; polygons bitwise to the native fill, which lies within one
   pixel of PIL's boundary), and the native fill of the committed polygons
   of ``tests/data/polygon_fill.json`` bitwise against the JAX package's
   fill of them: the native library built with this machine's ``g++``;
32. (right after 13, with the kernel phases) holds the RoIPool backward
   kernel K10 (``csrc/roi_pool_bwd.cu``) against ``roi_pool_plain_vjp`` at
   the detection training step's shape (2, 52, 84, 1024) x 300 RoIs and at
   the 1344 x 1344 canvas's (2, 84, 84, 1024): bitwise in bf16 and float32
   on cotangents of small integers times 2^-4 (every float32 sum exact in
   any order; a second call bitwise equal), on a relu map (zero plateaus)
   with NaN cells, a -inf block, empty and off-map bins and bins of
   power-of-two extent, and within the sum-order bound on random ones;
   one launch a call on the path its planner picks (``vector``; bf16 at
   84 x 84 ``vector_banded``), its shared memory equal to the kernel's
   count; prints its tiles; times it (median of five readings queued
   ahead) at B=2, at the extraction batch B=8 and at 84 x 84 beside its
   byte bound and the plain VJP;
33. detection training at full width, bench.py's ``--train frcnn`` step in
   the port: R-101-C4 with ``FRCNNConfig(post_nms_topk=300,
   dtype="bfloat16")`` (6000 pre-NMS proposals, 1600 classes, 400
   attributes), seeded tamed weights, B=2 on the 832 x 1344 canvas with 8
   seeded ground-truth boxes an image, ``rpn_losses`` at 256 and
   ``fast_rcnn_losses`` at 128 an image, SGD at 1e-4 for 8 steps: K1 once,
   K10 once and K2 twice a step (K1 and K10 on their vector paths), finite losses and
   gradients; K10 timed on the step's own inputs; the RPN head without a
   gradient from the RoI losses alone; ``remat`` at B=2 (its first step's
   loss and gradients against the plain run's, beside the plain step
   repeated) and at B=4; two AdamW steps with ``freeze_patterns=
   ("^backbone/",)`` (every backbone tensor bitwise unchanged, the heads
   moved); step ms, steps/s and peak of each run;
34. the detection experiments from raw COCO JSON: 16 seeded images (480 x
   640) -> the coco2014 adapter -> ``build(config)`` (36 detections,
   segmentation ignored, the 1344 x 1344 canvas) ->
   ``FRCNNDetectExperiment`` at R-101-C4 bf16 (class head sized from the
   label table), B=2, one epoch of 8 steps and the eval loop (finite
   losses, ``map50`` in [0, 1], K1 24, K10 8, K2 48 launches; K10 on its
   two-band path, timed on the first step's own inputs), the step
   with and without the loader; a ``ComplexExperiment`` over the same model
   (a detection train loop and an eval loop, both run); one LXMERT-base VQA
   step at B=32 with ``remat`` against the same step without it (equal
   loss, the peak of each);
35. prints the ``kernels`` JSON line (each kernel also with its launches on
   the two span paths, the four int8 paths, ViT, VisualBERT, MoE LXMERT,
   the server, the data plane's extraction and training, the raw FUNSD and
   DocVQA trainers, GQA's extraction and training, detection training and
   the detection experiment; K3 also with its times and bounds at ViT's
   and VisualBERT's shapes), then the device line last.

Any failed check raises: the script exits non-zero and prints no result.
It also fails without a CUDA device and outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the tensor
# cores (the max / IoU arithmetic of K1 and K2), bf16 dense on the tensor
# cores (the products of K3, K4 and K5)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

RAW_CANVAS = (512, 672)  # bench.py GEOM["full"]: raw canvas, content, canvas
RAW_HW = (480, 640)
CANVAS = (832, 1344)
FEAT_HW = (CANVAS[0] // 16, CANVAS[1] // 16)  # the res4 map: 52 x 84
N_ROI = 300
C_RES4 = 1024  # res4 channels of R-101-C4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# clock cycles the card sleeps before a timed span (~20 ms at the H100's
# 1.98 GHz), time for the host to queue every call of the span
QUEUE_AHEAD_CYCLES = 40_000_000


def cuda_ms(fn, reps: int, warmup: int = 2, ahead: bool = True) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``reps``
    back-to-back calls after ``warmup`` calls. With ``ahead`` the card
    sleeps first, so that the host has queued the calls before the first
    event fires: the span holds the card's time alone, not the host's time
    per call (a kernel shorter than its wrapper's host work reads the
    latter without it). A ``fn`` that waits for the card is timed with its
    host gaps either way."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spread_ms(fn, reps: int = 20, runs: int = 5):
    """``runs`` readings of ``cuda_ms(fn, reps)``, sorted: the spread of
    repeated timings; the median stands for the kernel."""
    return sorted(cuda_ms(fn, reps) for _ in range(runs))


def show(times) -> str:
    return f"{times[len(times) // 2]:.4f} ms (runs {', '.join(f'{x:.4f}' for x in times)})"


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bitwise_view(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bitwise_view(a), bitwise_view(b))


# --------------------------------------------------------------------- K1


def roi_boxes(gen: torch.Generator, b: int, p: int, dev) -> torch.Tensor:
    """Proposal-like boxes inside the resized content (800 x 1067 of the
    canvas), plus the edge cases: zero size, the full canvas, negative and
    off-map corners, corners on the rounding half."""
    h, w = 800.0, 1067.0
    xy = torch.rand(b, p, 2, generator=gen) * torch.tensor([w, h])
    wh = torch.rand(b, p, 2, generator=gen) ** 2 * torch.tensor([w, h])
    boxes = torch.cat([xy, torch.minimum(xy + wh, torch.tensor([w, h]))], dim=-1)
    boxes[0, 0] = torch.tensor([40.0, 40.0, 40.0, 40.0])
    boxes[0, 1] = torch.tensor([0.0, 0.0, CANVAS[1] - 1.0, CANVAS[0] - 1.0])
    boxes[0, 2] = torch.tensor([-40.0, -24.0, 30.0, 50.0])
    boxes[0, 3] = torch.tensor([CANVAS[1] + 100.0, 10.0, CANVAS[1] + 300.0, 60.0])
    boxes[0, 4] = torch.tensor([-90.0, -90.0, -20.0, -20.0])
    boxes[0, 5] = torch.tensor([7.5, 8.0, 23.5, 24.0])
    return boxes.to(dev)


def roi_pool_ops(boxes: torch.Tensor, c: int, hw=FEAT_HW) -> float:
    """Max comparisons this data needs: cells of every bin times C (on the
    52 x 84 map unless ``hw`` says otherwise)."""
    from vltk_tpu_torch.ops.roi_pool import roi_bin_edges

    hs, he, ws, we = roi_bin_edges(boxes, 1.0 / 16, hw[0], hw[1], 14)
    cells = (he - hs).clamp(min=0)[..., :, None] * (we - ws).clamp(min=0)[..., None, :]
    return float(cells.sum()) * c


def roi_pool_bytes_requested(boxes: torch.Tensor, c: int, itemsize: int):
    """(direct, separable): a model of the bytes K1 requests from the
    feature map on these boxes, counted on the host, not read from a
    counter on the card. Direct: every bin's cells; separable (K1's order):
    every map row of a RoI once times the cells of all its column bins
    (consecutive bin rows overlap, so a RoI's rows are the one span
    [hstart of bin 0, hend of the last bin))."""
    from vltk_tpu_torch.ops.roi_pool import roi_bin_edges

    hs, he, ws, we = roi_bin_edges(boxes, 1.0 / 16, FEAT_HW[0], FEAT_HW[1], 14)
    rows, cols = (he - hs).clamp(min=0).double(), (we - ws).clamp(min=0).double()
    direct = float((rows.sum(-1) * cols.sum(-1)).sum())
    separable = float(((he[..., -1] - hs[..., 0]).clamp(min=0).double() * cols.sum(-1)).sum())
    return direct * c * itemsize, separable * c * itemsize


def roi_pool_path_run(feat, boxes, want_path: str):
    """K1 once, through ``roi_pool_cuda``; checks the path it took by the
    wrapper's per-path counts."""
    from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto, roi_pool_cuda

    before = dict(roi_pool_auto.path_launches)
    got = roi_pool_cuda(feat, boxes, 14, 1 / 16)
    took = [k for k, v in roi_pool_auto.path_launches.items() if v != before[k]]
    check(took == [want_path], f"roi_pool took the {took} path, want {want_path}")
    return got


def phase_roi_pool(dev, ptxas) -> dict:
    from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets
    from vltk_tpu_torch.ops.roi_pool_kernel import _lib, roi_pool_auto, roi_pool_cuda
    from vltk_tpu_torch.tools.variants import unaligned

    print(f"roi_pool K1_SHAPE={_lib().roi_pool_shape():04d} ptxas: " + ("; ".join(ptxas) if ptxas else "cached build"))
    gen = torch.Generator().manual_seed(1)
    c = C_RES4
    # the last two cases are the shapes of the extraction step: one launch
    # over 300 RoIs at B=8, two over 150 RoIs each at B=16 (roi_chunk 2400).
    # Every case runs both paths: the vector path on the aligned map, the
    # scalar path on a copy one element into its storage
    timed, worst = [], 0.0
    for b, p, dtype in ((2, N_ROI, torch.float32), (2, N_ROI, torch.bfloat16),
                        (8, N_ROI, torch.bfloat16), (16, N_ROI // 2, torch.bfloat16)):
        feat = torch.relu(torch.randn(b, *FEAT_HW, c, generator=gen)).to(dev, dtype)
        # ties and negatives: every map has a block of exact zeros and one
        # of negative values
        feat[:, :4, :4] = -torch.rand(b, 4, 4, c, generator=gen).to(dev, dtype)
        boxes = roi_boxes(gen, b, p, dev)
        want = roi_pool_offsets(feat, boxes, 14, 1 / 16)
        scalar_feat = unaligned(feat)
        for path, f in (("vector", feat), ("scalar", scalar_feat)):
            got = roi_pool_path_run(f, boxes, path)
            torch.cuda.synchronize()
            eq = bitwise_equal(got, want)
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            print(f"roi_pool {tuple(feat.shape)} {dtype} x {p} boxes, {path} path: bitwise_equal={eq} "
                  f"max_abs_err={err}")
            check(eq, f"roi_pool kernel ({path} path) != plain at {tuple(feat.shape)} {dtype}")
            del got
        if b < 8:
            continue
        # the median of five readings of 20 calls queued ahead, as for K3
        runs = spread_ms(lambda: roi_pool_cuda(feat, boxes, 14, 1 / 16))
        scalar_runs = spread_ms(lambda: roi_pool_cuda(scalar_feat, boxes, 14, 1 / 16), reps=5, runs=3)
        plain_ms = cuda_ms(lambda: roi_pool_offsets(feat, boxes, 14, 1 / 16), reps=2, warmup=1)
        nbytes = feat.numel() * 2 + boxes.numel() * 4 + want.numel() * 2
        bound_ms, bound_by = bound(nbytes, roi_pool_ops(boxes, c))
        direct, separable = roi_pool_bytes_requested(boxes, c, 2)
        print(
            f"roi_pool timing {tuple(feat.shape)} bf16 x {p}: kernel {show(runs)}, scalar path {show(scalar_runs)}, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {runs[2] / bound_ms:.2f}x the bound; "
            f"modelled bytes requested {separable / 1e9:.3f} GB in K1's separable order ({direct / 1e9:.3f} GB direct); "
            f"no single PyTorch call computes RoIPool"
        )
        timed.append((runs, scalar_runs, plain_ms, bound_ms, bound_by))
        del want, scalar_feat
        torch.cuda.empty_cache()
    # features that want a gradient go through the autograd Function: K1
    # once, and the output keeps the graph for K10 (phase 32)
    before = roi_pool_auto.launches
    out = roi_pool_auto(feat.detach().requires_grad_(), boxes, 14, 1 / 16)
    check(out.grad_fn is not None and roi_pool_auto.launches == before + 1,
          "roi_pool_auto with grad: no graph, or K1 not launched once")
    del out
    print("roi_pool with grad: K1 once, the output keeps its graph for K10")
    # the kernels line reports the B=8 step's shape
    runs, scalar_runs, plain_ms, bound_ms, bound_by = timed[0]
    return {
        "name": "roi_pool",
        "route": "cuda",
        "source": "vltk_tpu_torch/csrc/roi_pool.cu",
        "replaces": "vltk_tpu/ops/pallas_kernels.py:187",
        "max_abs_err": worst,
        "ms": runs[2],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_runs": runs,
        "scalar_ms": scalar_runs[1],
    }


def capture_roi_inputs(model):
    """A forward pre-hook on the RoI heads that keeps the (features, boxes)
    of the last call: what the extraction step hands K1. Returns the store
    and the hook's handle."""
    store = {}

    def hook(_module, args):
        store["features"], store["boxes"] = args[0], args[1]

    return store, model.roi_heads.register_forward_pre_hook(hook)


def time_roi_pool_on_proposals(entry: dict, store: dict) -> None:
    """K1 timed on the features and proposals of the B=8 extraction step,
    checked bitwise against the plain version there; adds
    ``proposals_ms`` and its bound to the K1 entry."""
    from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets
    from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_cuda

    feat, boxes = store["features"], store["boxes"].contiguous()
    check(tuple(feat.shape) == (8, *FEAT_HW, C_RES4) and tuple(boxes.shape) == (8, N_ROI, 4),
          f"captured K1 inputs {tuple(feat.shape)}, {tuple(boxes.shape)}")
    got = roi_pool_path_run(feat, boxes, "vector")
    torch.cuda.synchronize()
    eq = bitwise_equal(got, roi_pool_offsets(feat, boxes, 14, 1 / 16))
    check(eq, "roi_pool kernel != plain on the extraction step's proposals")
    runs = spread_ms(lambda: roi_pool_cuda(feat, boxes, 14, 1 / 16))
    nbytes = (feat.numel() + got.numel()) * feat.element_size() + boxes.numel() * 4
    bound_ms, bound_by = bound(nbytes, roi_pool_ops(boxes, C_RES4))
    direct, separable = roi_pool_bytes_requested(boxes, C_RES4, feat.element_size())
    print(f"roi_pool timing on the B=8 step's proposals {tuple(feat.shape)} {feat.dtype} x {N_ROI}: "
          f"bitwise_equal={eq}, kernel {show(runs)}, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{runs[2] / bound_ms:.2f}x the bound; modelled bytes requested {separable / 1e9:.3f} GB in K1's "
          f"separable order ({direct / 1e9:.3f} GB direct)")
    entry["proposals_ms"] = runs[2]
    entry["proposals_bound_ms"] = bound_ms


# ----------------------------------------------------------------- K6-K9


def ablation_cases():
    """(name, label, kernel call, plain call, computes RoIPool) for every
    variant x mode: K7 at cb 128, K8/K9 at G 4 and 12 (300 RoIs are not a
    multiple of the default 8). Each call returns the variant's own layout."""
    from vltk_tpu_torch.ops import roi_pool_ablation as plain
    from vltk_tpu_torch.ops import roi_pool_ablation_kernel as K

    cases = []
    for mode in plain.POOL_MODES:
        cases.append(("pool", f"pool {mode}", lambda f, b, m=mode: K.pool_cuda(f, b, m),
                      lambda f, b, m=mode: plain.pool(f, b, m), mode in ("full", "v3")))
    for mode in plain.CONTIG_MODES:
        cases.append(("pool_contig", f"pool_contig {mode}", lambda f, b, m=mode: K.pool_contig_cuda(f, b, m, 128),
                      lambda f, b, m=mode: plain.pool_contig(f, b, m, 128), mode in ("full", "stackwrite")))
    for g in (4, 12):
        cases.append(("pool_grouped", f"pool_grouped G={g}", lambda f, b, g=g: K.pool_grouped_cuda(f, b, g),
                      lambda f, b, g=g: plain.pool_grouped(f, b, g), True))
        cases.append(("pool_grouped_v3", f"pool_grouped_v3 G={g}", lambda f, b, g=g: K.pool_grouped_v3_cuda(f, b, g),
                      lambda f, b, g=g: plain.pool_grouped_v3(f, b, g), True))
    return cases


def ablation_work(label: str, feat: torch.Tensor, boxes: torch.Tensor, out: torch.Tensor):
    """(bytes, operations) of one call: the modes that return zeros write
    their output and need no input; the others read the map and the boxes
    once and write once. Operations: one max per cell of every bin (capped
    as the mode caps it: a row bin x one column for noP2, one row x a
    column bin for noP1), times C."""
    from vltk_tpu_torch.ops import roi_pool_ablation as plain

    nbytes = out.numel() * out.element_size()
    if label.endswith(("p1only", "zeroOut")):
        return nbytes, 0.0
    nbytes += feat.numel() * feat.element_size() + boxes.numel() * 4
    if label.endswith("noBoth"):
        return nbytes, 0.0
    h, w, c = feat.shape[1:]
    hs, he, ws, we = plain.capped_edges(boxes, h, w, "v3" if "v3" in label else "v2")
    rows, cols = (he - hs).clamp(min=0).double(), (we - ws).clamp(min=0).double()
    if label.endswith("noP1"):
        return nbytes, float(cols.sum()) * 14 * c
    if label.endswith("noP2"):
        return nbytes, float(rows.sum()) * 14 * c
    return nbytes, float((rows[..., :, None] * cols[..., None, :]).sum()) * c


def nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN in the same places, every other value bitwise equal."""
    nan = torch.isnan(want.float())
    return (got.dtype == want.dtype and got.shape == want.shape and torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(bitwise_view(got)[~nan], bitwise_view(want)[~nan]))


def with_nonfinite_cells(feat: torch.Tensor) -> torch.Tensor:
    """A copy of the map with NaN cells, runs of -inf along a row, a column
    and across channels (bins whose max is -inf, written as 0) and +inf
    cells."""
    f = feat.clone()
    f[0, 10, :, :4] = float("nan")  # a row under 14: every mode reads it
    f[-1, 30, 40, 7] = float("nan")
    f[0, 3, :, 5] = float("-inf")
    f[-1, :, 60, :] = float("-inf")
    f[0, 20:26, 30:40] = float("-inf")
    f[-1, 5, 70, 1] = float("inf")
    return f


def ablation_ptxas(lines, threads: int) -> dict:
    """Prints the ptxas lines of K6-K9 and the table build (registers,
    spills, static shared memory; they launch with no dynamic shared
    memory) with the warps an SM holds at their register counts in blocks
    of ``threads``, and checks that the bf16 vector path spills nothing and
    uses under 4 KB of shared memory a block. Returns {kernel: {registers, spill_stores, smem, warps_per_sm}}."""
    kernels = {}
    for line in lines:
        name, _, text = line.partition(": ")
        if not name.startswith(("roi_ablation_pool_", "roi_ablation_contig_", "roi_ablation_grouped_",
                                "roi_ablation_build_")):
            continue
        k = kernels.setdefault(name, {"registers": 0, "spill_stores": 0, "smem": 0})
        for key, pattern in (("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                             ("smem", r"(\d+) bytes smem")):
            m = re.search(pattern, text)
            if m:
                k[key] = int(m.group(1))
    if not kernels:
        print("roi_pool_ablation K6-K9 ptxas: cached build")
        return kernels
    warps = threads // 32
    for name, k in sorted(kernels.items()):
        # registers are allocated in 256s a warp, 64K an SM; at most 64
        # warps and 32 blocks an SM
        per_warp = -(-k["registers"] * 32 // 256) * 256
        k["warps_per_sm"] = min(65536 // max(per_warp, 1) // warps, 32, 64 // warps) * warps
        print(f"roi_pool_ablation ptxas {name}: {k['registers']} registers, {k['spill_stores']} bytes spill stores, "
              f"{k['smem']} bytes static shared memory, {k['warps_per_sm']} resident warps an SM (from the registers)")
    vector = {n: k for n, k in kernels.items() if n.endswith("_bf16_vector")}
    check(len(vector) == 12, f"ptxas lines of {len(vector)} bf16 vector K6-K9/build kernels, want 12")
    check(all(k["spill_stores"] == 0 for k in vector.values()), "a K6-K9 bf16 vector kernel spills")
    check(all(k["smem"] < 4096 for k in vector.values()), "a K6-K9 bf16 vector kernel uses 4 KB of shared memory")
    return kernels


def grouped_waves(kernels: dict, shape: int, b: int, c: int, p: int) -> None:
    """Prints the grids of K8 and K9 on the bf16 vector path at G = 1 (K6's
    grid), 4 and 12 (threads, blocks of the compiled shape) against the
    blocks the card holds at once at their register counts: the waves."""
    bins, threads = shape // 100, 128 * (shape % 10)
    groups = -(-14 // bins)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("roi_ablation_grouped_v2_bf16_vector", "roi_ablation_grouped_v3_bf16_vector"):
        if name not in kernels:
            continue
        resident = kernels[name]["warps_per_sm"] // (threads // 32) * sms
        for g in (1, 4, 12):
            n = b * (p // g) * groups * (c // 8)
            blocks = -(-n // threads)
            print(f"{name} grid at G={g}: {n} threads, {blocks} blocks of {threads}; {resident} blocks resident "
                  f"({kernels[name]['registers']} registers, {sms} SMs): {blocks / resident:.2f} waves")


def table_reads(boxes: torch.Tensor, h: int, w: int, c: int, itemsize: int) -> float:
    """Bytes of the row-max table that K6 ``full`` and K8 load on these
    boxes: each live row bin's table row over its capped column windows."""
    from vltk_tpu_torch.ops import roi_pool_ablation as plain

    hs, he, ws, we = plain.capped_edges(boxes, h, w, "v2")
    live, cols = ((he - hs) > 0).double(), (we - ws).clamp(min=0).double()
    return float((live.sum(-1) * cols.sum(-1)).sum()) * c * itemsize


# each ablation kernel and the case that stands for it in the kernels line
KERNEL_LABELS = (("pool", "pool full"), ("pool_contig", "pool_contig full"), ("pool_grouped", "pool_grouped G=4"),
                 ("pool_grouped_v3", "pool_grouped_v3 G=4"))


def phase_roi_ablation(dev, ptxas) -> list:
    """K6-K9 against their plain versions, bitwise, every mode, at the
    probe's map in float32 (B=2) and bf16 (B=8) x 300 RoIs on
    ``roi_boxes``; the RoIPool modes also against K1, K8 and K9 also
    against K6 ``full`` / ``v3``. Every variant also on its scalar path (an
    unaligned copy of the map) and on a copy with NaN and -inf cells (NaN
    in the same places). Times every mode and the table build (the median
    of five readings of 20 calls queued ahead), K1 and the plain versions
    at the bf16 shape; then runs the probe's path once and counts its
    launches by path. Returns the four kernels-line entries."""
    from vltk_tpu_torch.ops import KERNEL_WRAPPERS
    from vltk_tpu_torch.ops import roi_pool_ablation as plain
    from vltk_tpu_torch.ops.roi_pool_ablation_kernel import (
        _lib,
        build_table_cuda,
        pool_auto,
        pool_contig_auto,
        pool_cuda,
        pool_grouped_auto,
        pool_grouped_v3_auto,
    )
    from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_cuda
    from vltk_tpu_torch.tools import probe_roipool_ablation as probe
    from vltk_tpu_torch.tools.variants import unaligned

    lib = _lib()
    print(f"roi_pool_ablation K67_SHAPE={lib.roi_ablation_shape():04d} K67_SLAB={lib.roi_ablation_slab()} "
          f"K89_MIN_BLOCKS={lib.roi_ablation_grouped_min_blocks()}")
    kernels = ablation_ptxas(ptxas, threads=128 * (lib.roi_ablation_shape() % 10))
    grouped_waves(kernels, lib.roi_ablation_shape(), 8, C_RES4, N_ROI)
    path_counts = {name: KERNEL_WRAPPERS[name].path_launches for name, _ in KERNEL_LABELS}

    def run_on(name, kernel, feat, boxes, want_path):
        before = dict(path_counts[name])
        got = kernel(feat, boxes)
        torch.cuda.synchronize()
        took = [k for k, v in path_counts[name].items() if v != before[k]]
        check(took == [want_path], f"{name} took the {took} path, want {want_path}")
        return got

    gen = torch.Generator().manual_seed(8)
    cases = ablation_cases()
    worst = {}
    for b, dtype in ((2, torch.float32), (8, torch.bfloat16)):
        feat = torch.randn(b, *FEAT_HW, C_RES4, generator=gen).to(dev, dtype)
        boxes = roi_boxes(gen, b, N_ROI, dev)
        k1 = roi_pool_cuda(feat, boxes, 14, 1 / 16)
        scalar_feat = unaligned(feat)
        for name, label, kernel, ref, is_roipool in cases:
            want = ref(feat, boxes)
            got = run_on(name, kernel, feat, boxes, "vector")
            eq = bitwise_equal(got, want)
            err = float((got.float() - want.float()).abs().max())
            worst[name] = max(worst.get(name, 0.0), err)
            same_k1 = same_k6 = None
            if is_roipool:
                same_k1 = bitwise_equal(plain.from_contig(got) if name == "pool_contig" else got, k1)
            if name.startswith("pool_grouped"):
                same_k6 = bitwise_equal(got, pool_cuda(feat, boxes, "v3" if name.endswith("v3") else "full"))
            del got
            scalar_eq = bitwise_equal(run_on(name, kernel, scalar_feat, boxes, "scalar"), want)
            print(f"{label} {tuple(feat.shape)} {dtype} x {N_ROI}: bitwise_equal={eq} max_abs_err={err} "
                  f"equal_to_K1={same_k1} equal_to_K6={same_k6} scalar_path_bitwise_equal={scalar_eq}")
            check(eq, f"{label} kernel != plain at {tuple(feat.shape)} {dtype}")
            check(scalar_eq, f"{label} scalar path != plain at {tuple(feat.shape)} {dtype}")
            check(same_k1 is not False, f"{label} != K1 at {tuple(feat.shape)} {dtype}")
            check(same_k6 is not False, f"{label} != K6 at {tuple(feat.shape)} {dtype}")
            del want
        del scalar_feat
        # NaN and -inf cells: every variant on both paths
        special = with_nonfinite_cells(feat)
        special_scalar = unaligned(special)
        for name, label, kernel, ref, _ in cases:
            want = ref(special, boxes)
            ok = [nan_equal(run_on(name, kernel, f, boxes, path), want)
                  for f, path in ((special, "vector"), (special_scalar, "scalar"))]
            n_nan = int(torch.isnan(want.float()).sum())
            print(f"{label} {tuple(feat.shape)} {dtype} with NaN and -inf cells: {n_nan} NaN outputs; "
                  f"vector path nan_equal={ok[0]}, scalar path nan_equal={ok[1]}")
            check(all(ok), f"{label} != plain with NaN and -inf cells at {tuple(feat.shape)} {dtype}")
            check(n_nan > 0 or label.endswith(("p1only", "zeroOut")), f"{label}: no NaN reached the output")
            del want
        del special, special_scalar
        torch.cuda.empty_cache()

    # timed at the bf16 shape of the loop's last pass: the median of five
    # readings of 20 calls queued ahead of a sleeping card, the range beside
    rows = {}
    k1_ms = cuda_ms(lambda: roi_pool_cuda(feat, boxes, 14, 1 / 16), reps=20)
    table_runs = spread_ms(lambda: build_table_cuda(feat))
    table_ms = table_runs[2]
    levels = plain.caps(*FEAT_HW)[0]
    t_bound, _ = bound(feat.numel() * 2 * (1 + levels), 0.0)
    print(f"roi_pool_ablation table build {tuple(feat.shape)} bf16 ({levels} levels): {show(table_runs)}, "
          f"bound {t_bound:.4f} ms (bytes); K1 {k1_ms:.4f} ms; table loads of K6 full on roi_boxes "
          f"{table_reads(boxes, *FEAT_HW, C_RES4, 2) / 1e9:.3f} GB")
    for name, label, kernel, ref, _ in cases:
        out = kernel(feat, boxes)
        runs = spread_ms(lambda: kernel(feat, boxes))
        plain_ms = cuda_ms(lambda: ref(feat, boxes), reps=2, warmup=1)
        bound_ms, bound_by = bound(*ablation_work(label, feat, boxes, out))
        rows[label] = {"ms": runs[2], "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "ms_runs": runs}
        print(f"{label} timing {tuple(feat.shape)} bf16 x {N_ROI}: kernel {show(runs)} (table build included), "
              f"{runs[2] / bound_ms:.2f}x the bound; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del out
    scalar_feat = unaligned(feat)
    for label, kernel in (("pool full", lambda f: pool_auto(f, boxes, "full")),
                          ("pool_contig full", lambda f: pool_contig_auto(f, boxes, "full", 128)),
                          ("pool_grouped G=4", lambda f: pool_grouped_auto(f, boxes, 4)),
                          ("pool_grouped_v3 G=4", lambda f: pool_grouped_v3_auto(f, boxes, 4))):
        runs = spread_ms(lambda: kernel(scalar_feat), reps=5, runs=3)
        rows[label]["scalar_ms"] = runs[1]
        print(f"{label} timing on the scalar path (unaligned copy): {show(runs)}")
    del scalar_feat
    r = {k: v["ms"] for k, v in rows.items()}
    print(
        f"roi_pool_ablation phase split (ms, bf16 {tuple(feat.shape)} x {N_ROI}): build {table_ms:.4f}; "
        f"K7 zeroOut - build (per-block cost + contiguous zero write) {r['pool_contig zeroOut'] - table_ms:.4f}; "
        f"pass 1 (p1only - zeroOut) {r['pool_contig p1only'] - r['pool_contig zeroOut']:.4f}; "
        f"pass 2 + tile (full - p1only) {r['pool_contig full'] - r['pool_contig p1only']:.4f}; "
        f"K6 noBoth - build {r['pool noBoth'] - table_ms:.4f}; full - noP1 {r['pool full'] - r['pool noP1']:.4f}; "
        f"full - noP2 {r['pool full'] - r['pool noP2']:.4f}"
    )
    del feat, boxes, k1
    torch.cuda.empty_cache()

    # the probe's path: its inputs, every variant timed and checked against K1
    feat, boxes = probe.make_inputs(*probe.SHAPE, dev)
    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    for counts in path_counts.values():
        counts.update(vector=0, scalar=0)
    probe_rows = probe.run(feat, boxes, iters=5)
    print(f"table loads of K6 full on the probe's boxes {table_reads(boxes, *FEAT_HW, C_RES4, 2) / 1e9:.3f} GB")
    launches = {name: KERNEL_WRAPPERS[name].launches for name in path_counts}
    by_path = {name: dict(counts) for name, counts in path_counts.items()}
    check(all(r["same_as_shipped"] is not False for r in probe_rows), "probe: a RoIPool variant != K1")
    check(all(n > 0 for n in launches.values()), f"probe path launched {launches}")
    check(all(by_path[n]["vector"] == launches[n] for n in by_path), f"probe path took the scalar path: {by_path}")
    print("probe_run " + json.dumps({"launches": launches, "launches_by_path": by_path, "rows": probe_rows}))
    probe_ms = {r["variant"]: r["ms"] for r in probe_rows}
    for name, label in KERNEL_LABELS:
        loss = launches[name] * (probe_ms[label] - rows[label]["bound_ms"])
        print(f"{label} on the probe's path: {probe_ms[label]:.4f} ms, {launches[name]} launches, "
              f"{probe_ms[label] / rows[label]['bound_ms']:.2f}x the bound, loss {loss:.2f} ms a probe call")
    del feat, boxes
    torch.cuda.empty_cache()

    entries = []
    for (name, label), line in zip(KERNEL_LABELS, (446, 217, 177, 83)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "vltk_tpu_torch/csrc/roi_pool_ablation.cu",
            "replaces": f"tools/probe_roipool_ablation.py:{line}",
            "launches": launches[name],
            "max_abs_err": worst[name],
            **rows[label],
            "library_ms": None,
        })
    return entries


# --------------------------------------------------------------------- K2


# JAX's nms_fixed on the rows of tests/test_torch_ops.py::TestNMSAgainstJAX:
# a NaN coordinate gives its box IoU 0 with every box; a valid NaN score
# leaves its row empty
NAN_BOXES = [[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, float("nan"), 10], [2, 2, 12, 12]]
NAN_ROWS = (([0.9, 0.8, 0.95, 0.7], [2, 0, 3, -1]), ([0.9, float("nan"), 0.95, 0.7], [-1, -1, -1, -1]))


def nms_bound(call: dict, keep: torch.Tensor):
    """(bytes, operations) that greedy needs on this call's data
    (``tools.bench_nms.sweep_pairs``): every score and validity flag read
    once, the boxes of the candidates the sweep reads (16 bytes each: up to
    the last keep, or all when the budget is not reached), the keeps (int32)
    and their validity (bool) written once; ~15 float32 operations and one
    compare per IoU that greedy needs."""
    from vltk_tpu_torch.tools.bench_nms import sweep_pairs

    greedy, _, _, read, replay = sweep_pairs(call["boxes"], call["scores"], call["valid"], call["thresh"],
                                             call["max_out"])
    check(torch.equal(replay, keep.cpu()), "the CPU replay of K2's word loop disagrees with its keeps")
    nbytes = read * 16 + call["scores"].numel() * 4 + keep.numel() * 5
    if call["valid"] is not None:
        nbytes += call["valid"].numel()
    return nbytes, greedy * 16


def keep_err(got: torch.Tensor, want) -> float:
    """max |got - want| over two keep-index tensors (0 where equal)."""
    want = torch.as_tensor(want, device=got.device)
    return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0


def nms_held(call: dict, what: str):
    """K2 at every cluster size and at the wrapper's pick against the plain
    version, exact keep indices and masks; returns the plain keeps and the
    largest |kernel - plain| over the keep indices of every launch."""
    from vltk_tpu_torch.ops.nms import nms_fixed
    from vltk_tpu_torch.ops.nms_kernel import CLUSTERS, nms_fixed_cuda

    args = (call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
    want, want_v = nms_fixed(*args)
    err = 0.0
    for cl in (None, *CLUSTERS):
        got, got_v = nms_fixed_cuda(*args, _cluster=cl)
        torch.cuda.synchronize()
        err = max(err, keep_err(got, want))
        check(torch.equal(got, want) and torch.equal(got_v, want_v),
              f"nms kernel != plain on {what} at cluster {cl or 'picked'}")
    return want, err


def phase_nms(dev, batch: int, ptxas=()) -> dict:
    """K2 held against the plain version on chip_smoke's rows at the two
    call shapes of a B-image step (every cluster size) and on the NaN rows;
    timed at both shapes."""
    from vltk_tpu_torch.ops.nms import nms_fixed
    from vltk_tpu_torch.ops.nms_kernel import nms_fixed_cuda, plan
    from vltk_tpu_torch.tools.bench_nms import reach, smoke_calls

    if ptxas:
        print("nms ptxas: " + "; ".join(ptxas))
    err = 0.0
    for scores, want in NAN_ROWS:
        for cl in (None, 1, 2):
            got, _ = nms_fixed_cuda(torch.tensor(NAN_BOXES, device=dev), torch.tensor(scores, device=dev),
                                    0.5, 4, _cluster=cl)
            err = max(err, keep_err(got, want))
            check(got.tolist() == want, f"nms NaN row {scores}: kernel {got.tolist()}, JAX {want}")
    print(f"nms NaN rows: the kernel gives JAX's keeps {[w for _, w in NAN_ROWS]} at every cluster size tried")
    ms = plain_ms = nbytes = nops = 0.0
    for call in smoke_calls(batch, dev):
        rows, k = call["scores"].shape
        what = f"{call['name']} ({rows}, {k}) -> {call['max_out']}"
        want, call_err = nms_held(call, f"the smoke {what} rows")
        err = max(err, call_err)
        last = [x for x in reach(want, call["scores"], call["valid"])[0] if x >= 0]
        cl, smem = plan(k, call["max_out"])
        print(f"nms {what}: exact_keep=True at every cluster size, kept={int((want >= 0).sum())}, "
              f"last-keep sorted rank {min(last)}-{max(last)} in the rows with a keep; the wrapper's "
              f"cluster {cl}, {smem} bytes of dynamic shared memory a CTA")
        check(bool((want >= 0).any()), f"nms {what}: nothing kept")
        args = (call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
        # the median of five readings of 20 calls queued ahead, with the spread
        runs_k = spread_ms(lambda: nms_fixed_cuda(*args))
        t_p = cuda_ms(lambda: nms_fixed(*args), reps=2, warmup=1)
        call_bytes, call_ops = nms_bound(call, want)
        b_ms, b_by = bound(call_bytes, call_ops)
        print(f"nms timing {what}: kernel {show(runs_k)}, plain {t_p:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        ms, plain_ms = ms + runs_k[2], plain_ms + t_p
        nbytes, nops = nbytes + call_bytes, nops + call_ops
    bound_ms, bound_by = bound(nbytes, nops)
    return {
        "name": "nms_fixed",
        "route": "cuda",
        "source": "vltk_tpu_torch/csrc/nms.cu",
        "replaces": "vltk_tpu/ops/nms.py:50",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def time_nms_on_step(entry: dict, calls: list) -> None:
    """K2 held (every cluster size) and timed on the two calls of one B=8
    extraction step, as ``tools.bench_nms.step_calls`` records them; adds
    ``step_ms`` and its bound to the K2 entry and folds the step's keep
    errors into its ``max_abs_err``."""
    from vltk_tpu_torch.ops.nms_kernel import nms_fixed_cuda
    from vltk_tpu_torch.tools.bench_nms import reach

    total = nbytes = nops = 0.0
    for call in calls:
        rows, k = call["scores"].shape
        what = f"{call['name']} ({rows}, {k}) -> {call['max_out']}"
        want, err = nms_held(call, f"the B=8 step's {what} call")
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        check(torch.equal(want, call["keep"]), f"the step's {what} keeps differ from the plain version's")
        last, live = reach(want, call["scores"], call["valid"])
        args = (call["boxes"], call["scores"], call["thresh"], call["max_out"], call["valid"])
        runs = spread_ms(lambda: nms_fixed_cuda(*args))
        call_bytes, call_ops = nms_bound(call, want)
        b_ms, b_by = bound(call_bytes, call_ops)
        print(f"nms on the B=8 step's {what} inputs: exact_keep=True at every cluster size, kernel {show(runs)}, "
              f"bound {b_ms:.6f} ms ({b_by}); last-keep sorted rank {min(last)}-{max(last)} of {min(live)}-{max(live)} live")
        total, nbytes, nops = total + runs[2], nbytes + call_bytes, nops + call_ops
    entry["step_ms"] = total
    entry["step_bound_ms"] = bound(nbytes, nops)[0]


# --------------------------------------------------------------------- K3

FLASH_SHAPE = (32, 1024, 12, 64)  # (n, s, nh, dh): bench.py --infer layoutlm
# bf16: 2 ulps at |x| ~ 1 (the kernel rounds p to bf16 after an online
# rescale, the plain version after the exact row max); f32: sums in
# another order
FLASH_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}


def flash_case(gen: torch.Generator, shape, lengths, dtype, dev):
    """q, k, v and a mask whose row i is real on its first lengths[i]
    positions, or, where lengths[i] is a list of (start, stop) spans, on
    those spans."""
    n, s, nh, dh = shape
    q, k, v = (torch.randn(n, s, nh, dh, generator=gen).to(dev, dtype) for _ in range(3))
    mask = torch.zeros(n, s)
    for i, row in enumerate(lengths):
        for start, stop in ([(0, row)] if isinstance(row, int) else row):
            mask[i, start:stop] = 1
    return q, k, v, mask.to(dev)


def flash_work(ids: torch.Tensor, nh: int, dh: int, itemsize: int):
    """(bytes, operations) of one call: q, k, v read and out written once,
    ids read once; 4 dh operations (two products) for every (query, key)
    pair whose ids match, counted on this data with the zero tail that pads
    s to a multiple of 128 (id 0)."""
    n, s = ids.shape
    full = torch.nn.functional.pad(ids, (0, (-s) % 128))
    pairs = sum(float((row.unique(return_counts=True)[1].double() ** 2).sum()) for row in full)
    return 4 * n * s * nh * dh * itemsize + ids.numel() * 4, 4 * dh * nh * pairs


def alternating_rows(n: int, s: int, width: int = 64):
    """Masks of blocks of one id: alternating blocks of ``width`` real and
    ``width`` pad positions (starting real, then starting pad), and a row
    real on [0, 192) and [s - 320, s) (on every position where s <= 512)."""
    rows = [[(j, j + width) for j in range(0, s, 2 * width)], [(j, j + width) for j in range(width, s, 2 * width)],
            [(0, 192), (s - 320, s)]]
    return (rows * n)[:n]


def phase_flash(dev, ptxas) -> dict:
    from vltk_tpu_torch.ops.flash_attention import flash_self_attention, flash_self_attention_fwd_residuals
    from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_cuda, flash_attention_fwd_residuals_cuda

    print("flash_attention ptxas: " + ("; ".join(ptxas) if ptxas else "cached build"))
    gen = torch.Generator().manual_seed(4)
    n, s, nh, dh = FLASH_SHAPE
    main_lengths = [1024, 700, 129, 1] + torch.randint(1, s + 1, (n - 4,), generator=gen).tolist()
    # masks of whole 64-row tiles of one id. The bf16 kernel skips a key
    # tile that no query of its block (128 rows) shares an id with: with
    # alternating 128-row blocks, real-pad-real (at s = 1000 and 1024) and
    # a row real on [0, 128) only (block 0 reads its own two tiles and no
    # other) or pad there only; alternating 64-row blocks and one real token put both ids in
    # every block, so nothing is skipped there, but every tile is masked
    # for half its rows, or for all but one row
    skips = [("alternating 64-row blocks", alternating_rows), ("alternating 128-row blocks",
             lambda n, s: alternating_rows(n, s, 128)), ("one real token", lambda n, s: [1, [(s // 2, s // 2 + 1)], s, 7]),
             ("real on [0, 128) only, or pad there only", lambda n, s: [128, [(128, s)], 1, s])]
    cases = [
        ("serving shape, padded rows", FLASH_SHAPE, main_lengths, torch.bfloat16, True),
        ("s=197", (4, 197, nh, dh), [197, 150, 1, 197], torch.bfloat16, True),
        ("s=197, mask=None", (4, 197, nh, dh), [197] * 4, torch.bfloat16, False),
        ("f32", (2, 256, 2, dh), [256, 100], torch.float32, True),
    ] + [
        (f"{name}, s={length}", (4, length, nh, dh) if dtype == torch.bfloat16 else (4, length, 2, dh),
         rows(4, length), dtype, True)
        for name, rows in skips for length in (256, 1000, 1024) for dtype in (torch.bfloat16, torch.float32)
    ]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in full f32
    worst = 0.0
    try:
        for name, shape, lengths, dtype, use_mask in cases:
            q, k, v, mask = flash_case(gen, shape, lengths, dtype, dev)
            m = mask if use_mask else None
            got = flash_attention_cuda(q, k, v, m, dh)
            again = flash_attention_cuda(q, k, v, m, dh)
            got_r, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, m, dh)
            torch.cuda.synchronize()
            want, stats = flash_self_attention_fwd_residuals(q, k, v, m, dh)
            err = float((got.float() - want.float()).abs().max())
            stat_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(stats_k, stats))
            same = bitwise_equal(got, again) and bitwise_equal(got, got_r)
            ok = got.shape == want.shape and bool(torch.isfinite(got).all()) and err <= FLASH_TOL[dtype]
            print(f"flash_attention {name} {tuple(shape)} {dtype}: max_abs_err={err} (tol {FLASH_TOL[dtype]}); "
                  f"stats rel err {stat_err:.2e} (1e-5); bitwise repeatable {same}")
            check(ok, f"flash attention kernel != plain ({name})")
            check(stat_err <= 1e-5, f"K3 row statistics != plain ({name}): {stat_err}")
            check(same, f"flash attention kernel not deterministic ({name})")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

    # timed at bench.py's inputs: every row real. Each time is the median
    # of five readings of 20 calls queued ahead (``cuda_ms``)
    q, k, v, mask = flash_case(gen, FLASH_SHAPE, [s] * n, torch.bfloat16, dev)
    runs = spread_ms(lambda: flash_attention_cuda(q, k, v, mask, dh))
    ms = runs[2]
    plain_ms = cuda_ms(lambda: flash_self_attention(q, k, v, mask, dh), reps=3, warmup=1)
    ids = mask.to(torch.int32)
    same = ids[:, None, :, None] == ids[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_runs = spread_ms(lambda: sdpa(qt, kt, vt, attn_mask=same))
    library_ms = sdpa_runs[2]
    # the same function on these all-real rows, without the mask: PyTorch's
    # own flash backend, what a tuned kernel reaches on this card
    unmasked_runs = spread_ms(lambda: sdpa(qt, kt, vt))
    unmasked_ms = unmasked_runs[2]
    nbytes, nops = flash_work(ids, nh, dh, 2)
    bound_ms, bound_by = bound(nbytes, nops, BF16_OPS_PER_S)
    print(
        f"flash_attention timing {FLASH_SHAPE} bf16: kernel {show(runs)}, plain {plain_ms:.4f} ms, "
        f"SDPA with the boolean mask {show(sdpa_runs)}, without it {show(unmasked_runs)}, "
        f"bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nops:.3e} operations, {nbytes:.3e} bytes; {n * nh * s * s:.2e} exponentials), "
        f"{ms / bound_ms:.2f}x the bound, {library_ms / ms:.2f}x faster than SDPA with the mask"
    )
    # where skipping applies: the serving smoke's padded rows
    q, k, v, mask = flash_case(gen, FLASH_SHAPE, main_lengths, torch.bfloat16, dev)
    padded_runs = spread_ms(lambda: flash_attention_cuda(q, k, v, mask, dh))
    p_bytes, p_ops = flash_work(mask.to(torch.int32), nh, dh, 2)
    p_bound, _ = bound(p_bytes, p_ops, BF16_OPS_PER_S)
    print(f"flash_attention timing {FLASH_SHAPE} bf16, the padded rows of the correctness case: kernel "
          f"{show(padded_runs)}, bound {p_bound:.4f} ms ({p_ops:.3e} operations)")
    # with the row statistics, at the training inputs: every row 819 real
    tn, ts = TRAIN_FLASH_SHAPE[0], TRAIN_FLASH_SHAPE[1]
    q, k, v, mask = flash_case(gen, TRAIN_FLASH_SHAPE, [int(ts * 0.8)] * tn, torch.bfloat16, dev)
    stats_runs = spread_ms(lambda: flash_attention_fwd_residuals_cuda(q, k, v, mask, dh))
    # the same calls with the host's time per call in the span, as the
    # training step meets them (the kernel is shorter than its wrapper)
    host_runs = sorted(
        cuda_ms(lambda: flash_attention_fwd_residuals_cuda(q, k, v, mask, dh), reps=20, ahead=False) for _ in range(5)
    )
    t_bytes, t_ops = flash_work(mask.to(torch.int32), nh, dh, 2)
    t_bound, _ = bound(t_bytes + 2 * tn * nh * ts * 4, t_ops, BF16_OPS_PER_S)
    print(f"flash_attention timing {TRAIN_FLASH_SHAPE} bf16 with statistics, 819 real of 1024: kernel "
          f"{show(stats_runs)}, bound {t_bound:.4f} ms ({t_ops:.3e} operations); back to back without the "
          f"queue ahead, host gaps included: {show(host_runs)}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "vltk_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vltk_tpu/models/lxmert.py:244",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        # SDPA on the same all-real rows without the mask: PyTorch's own
        # flash backend, beside the masked call above
        "library_unmasked_ms": unmasked_ms,
        "padded_ms": padded_runs[2],
        "train_stats_ms": stats_runs[2],
    }


# ----------------------------------------------------------------- K4, K5

TRAIN_FLASH_SHAPE = (8, 1024, 12, 64)  # (n, s, nh, dh): bench.py --train layoutlm
# relative to each tensor's largest magnitude. bf16: p and ds are rounded
# to bf16 at the same points as in the plain version, from float32 values
# that differ in the last bits, so an element may land one ulp (2^-8) apart;
# float32: sums in another order
BWD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30))


def backward_work(ids: torch.Tensor, nh: int, dh: int, itemsize: int, products: int, inputs: int, outputs: int):
    """(bytes, operations) of one backward kernel: ``inputs`` (n, s, nh, dh)
    tensors read once (K4: q, k, v, do; K5 also o), ids and three float32
    row vectors read or written once (K4 reads m, l, di; K5 reads m, l and
    writes di), ``outputs`` gradients written once; 2 dh operations per
    product for every (query, key) pair of the s real positions whose ids
    match (the kernels skip the zero tail, which adds nothing to the
    gradients, and the tiles whose ids cannot match)."""
    n, s = ids.shape
    pairs = sum(float((row.unique(return_counts=True)[1].double() ** 2).sum()) for row in ids)
    nbytes = (inputs + outputs) * n * s * nh * dh * itemsize + ids.numel() * 4 + 3 * n * nh * s * 4
    return nbytes, 2 * products * dh * nh * pairs


def phase_flash_backward(dev):
    """K3's statistics, K5 (dq, di) and K4 (dk, dv) against the plain
    backward, di against its torch expression; determinism; timing at the
    training shape. Returns the two kernels-line entries."""
    from vltk_tpu_torch.ops.flash_attention import (
        flash_self_attention_backward,
        flash_self_attention_fwd_residuals,
    )
    from vltk_tpu_torch.ops.flash_attention_kernel import (
        flash_attention_backward_cuda,
        flash_attention_dkv_cuda,
        flash_attention_dq_cuda,
        flash_attention_fwd_residuals_cuda,
    )

    gen = torch.Generator().manual_seed(6)
    n, s, nh, dh = TRAIN_FLASH_SHAPE
    main_lengths = [1024, 819, 129, 1] + torch.randint(1, s + 1, (n - 4,), generator=gen).tolist()
    cases = (
        ("training shape, padded rows", TRAIN_FLASH_SHAPE, main_lengths, torch.bfloat16, True),
        ("alternating 64-row blocks", (4, s, nh, dh), alternating_rows(4, s), torch.bfloat16, True),
        ("s=197", (4, 197, nh, dh), [197, 150, 1, 197], torch.bfloat16, True),
        ("s=197, mask=None", (4, 197, nh, dh), [197] * 4, torch.bfloat16, False),
        ("f32", (2, 256, 2, dh), [256, 100], torch.float32, True),
    )
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"dkv": 0.0, "dq": 0.0}
    try:
        for name, shape, lengths, dtype, use_mask in cases:
            q, k, v, mask = flash_case(gen, shape, lengths, dtype, dev)
            do = torch.randn(shape, generator=gen).to(dev, dtype)
            m = mask if use_mask else None
            o, stats = flash_self_attention_fwd_residuals(q, k, v, m, dh)
            _, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, m, dh)
            torch.cuda.synchronize()
            stat_err = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) for a, b in zip(stats_k, stats))
            check(stat_err <= 1e-5, f"K3 row statistics != plain ({name}): {stat_err}")
            got = flash_attention_backward_cuda(q, k, v, m, o, stats, do, dh)
            again = flash_attention_backward_cuda(q, k, v, m, o, stats, do, dh)
            ids = (torch.ones(shape[:2], device=dev) if m is None else m).to(torch.int32)
            _, di = flash_attention_dq_cuda(q, k, v, do, ids, tuple(x.contiguous() for x in stats), o)
            torch.cuda.synchronize()
            want = flash_self_attention_backward(q, k, v, m, o, stats, do, dh)
            di_want = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
            di_err = rel_err(di, di_want)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            same = all(bitwise_equal(a, b) for a, b in zip(got, again))
            print(
                f"flash backward {name} {tuple(shape)} {dtype}: stats rel err {stat_err:.2e} (1e-5); "
                f"dq/dk/dv rel err {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol {BWD_TOL[dtype]}); "
                f"max abs err {max(abs_errs):.3e}; fused di rel err {di_err:.2e} (1e-6); bitwise repeatable {same}"
            )
            check(finite and max(errs) <= BWD_TOL[dtype], f"flash backward kernels != plain ({name})")
            check(di_err <= 1e-6, f"K5's di != sum(o * do) ({name}): {di_err}")
            check(same, f"flash backward not deterministic ({name})")
            if dtype == torch.bfloat16:
                worst["dq"] = max(worst["dq"], abs_errs[0])
                worst["dkv"] = max(worst["dkv"], abs_errs[1], abs_errs[2])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

    # timed at bench.py's training inputs: every row 819 real tokens
    q, k, v, mask = flash_case(gen, TRAIN_FLASH_SHAPE, [int(s * 0.8)] * n, torch.bfloat16, dev)
    do = torch.randn(TRAIN_FLASH_SHAPE, generator=gen).to(dev, torch.bfloat16)
    o, stats = flash_attention_fwd_residuals_cuda(q, k, v, mask, dh)
    ids = mask.to(torch.int32).contiguous()
    _, di = flash_attention_dq_cuda(q, k, v, do, ids, stats, o)
    k5_ms = cuda_ms(lambda: flash_attention_dq_cuda(q, k, v, do, ids, stats, o), reps=20)
    k4_ms = cuda_ms(lambda: flash_attention_dkv_cuda(q, k, v, do, ids, stats, di), reps=20)
    # the torch pass that K5's prologue replaces, for comparison only
    di_torch_ms = cuda_ms(lambda: (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous(), reps=20)
    plain_ms = cuda_ms(lambda: flash_self_attention_backward(q, k, v, mask, o, stats, do, dh), reps=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    same = ids[:, None, :, None] == ids[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    # SDPA's backward measured directly: one forward, then CUDA events
    # around the backward alone; beside it the earlier yardstick, (forward +
    # backward) - forward from two separate loops
    out = sdpa(qt, kt, vt, attn_mask=same)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), reps=10)
    fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=same), reps=10)
    fwd_bwd_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=same), (qt, kt, vt), dot), reps=10
    )
    del out
    entries = []
    for name, ms, products, inputs, outputs, src_line in (
        ("flash_attention_dkv", k4_ms, 4, 4, 2, 941), ("flash_attention_dq", k5_ms, 3, 5, 1, 1287),
    ):
        nbytes, nops = backward_work(ids, nh, dh, 2, products, inputs, outputs)
        bound_ms, bound_by = bound(nbytes, nops, BF16_OPS_PER_S)
        print(
            f"{name} timing {TRAIN_FLASH_SHAPE} bf16 (819 real of 1024): kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nops:.3e} operations, {nbytes:.3e} bytes), "
            f"{ms / bound_ms:.2f}x the bound"
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "vltk_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{src_line}",
            "max_abs_err": worst["dkv" if outputs == 2 else "dq"],
            "ms": ms,
            # the plain backward computes dq, dk and dv together: its whole
            # time stands beside each kernel
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # SDPA's backward, measured directly, which computes dq, dk and
            # dv together, beside each kernel
            "library_ms": library_ms,
        })
    print(
        f"flash backward timing {TRAIN_FLASH_SHAPE} bf16: K5 (with di) {k5_ms:.4f} + K4 {k4_ms:.4f} "
        f"= {k4_ms + k5_ms:.4f} ms against SDPA's backward with the boolean mask {library_ms:.4f} ms "
        f"(measured directly; {(k4_ms + k5_ms) / library_ms:.3f}x); earlier yardstick: forward {fwd_ms:.4f} ms, "
        f"forward + backward {fwd_bwd_ms:.4f} ms, difference {fwd_bwd_ms - fwd_ms:.4f} ms; the torch di pass "
        f"K5 replaces {di_torch_ms:.4f} ms; plain backward {plain_ms:.4f} ms"
    )
    return entries


# ----------------------------------------------------------- the main path


def step_images(dev, batch: int):
    """The extraction step's seeded raw images and their sizes."""
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, *RAW_CANVAS, 3), dtype=np.uint8)).to(dev)
    return raw, torch.tensor([RAW_HW] * batch, dtype=torch.int32, device=dev)


def run_extraction(bundle, batch: int, steps: int, wrappers) -> dict:
    """Drives the extraction step with every launch count set to 0 first;
    K1 and K2 must have launched, K3 must not."""
    step = bundle["step"]
    raw, sizes = step_images(bundle["device"], batch)
    for w in wrappers.values():
        w.launches = 0
    paths = wrappers["roi_pool"].path_launches
    paths.update(dict.fromkeys(paths, 0))
    packed = step(raw, sizes)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        packed = step(raw, sizes)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    runs = steps + 1
    # K1 once a step at B=8, twice at B=16 (one launch per roi_chunk of
    # 2400 RoIs), all on the vector path
    check(launches["roi_pool"] == runs * -(-batch * N_ROI // bundle["cfg"].roi_chunk) and paths["scalar"] == 0,
          f"K1 launched {launches['roi_pool']} times ({paths}) over {runs} steps at B={batch}")
    # K2 once for the RPN and once for the detection selection
    check(launches["nms"] == 2 * runs, f"K2 launched {launches['nms']} times over {runs} steps at B={batch}")
    check(tuple(packed.shape) == (batch, 36, 2048 + 6), f"packed shape {tuple(packed.shape)}")
    check(bool(torch.isfinite(packed).all()), "packed output is not finite")
    preds = (packed[..., -2] >= 0).sum(dim=1)
    check(bool((preds > 0).all()), f"an image has no detection: {preds.tolist()}")
    for name in ("roi_pool", "nms"):
        check(launches[name] > 0, f"kernel {name} was not launched on the extraction path")
    for name in ("flash_attention", "flash_attention_dkv", "flash_attention_dq"):
        check(launches[name] == 0, f"{name} launched on the extraction path")
    return {
        "batch": batch,
        "images_per_s": batch * steps / dt,
        "step_ms": dt / steps * 1e3,
        "launches": launches,
        "roi_pool_paths": dict(paths),
        "launches_per_step": {k: v / runs for k, v in launches.items()},
        "preds_per_image": preds.tolist(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def phase_small_reference(dev) -> None:
    """A small f32 FRCNN on the card against the same model on the CPU."""
    from vltk_tpu_torch.models import FRCNN, FRCNNConfig, init_weights

    cfg = FRCNNConfig(
        depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4,
        rpn_hidden_channels=16, anchor_sizes=(16, 32), pre_nms_topk=64,
        post_nms_topk=16, num_classes=7, num_attrs=5, pooler_resolution=7,
        min_detections=4, max_detections=4,
    )
    cpu = init_weights(FRCNN(cfg).eval(), seed=3)
    gpu = FRCNN(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    gen = torch.Generator().manual_seed(3)
    images = torch.rand(2, 64, 64, 3, generator=gen) * 100 - 50
    sizes = torch.tensor([[64.0, 64.0], [48.0, 56.0]])
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu(images, sizes)
            got = gpu(images.to(dev), sizes.to(dev))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    worst = 0.0
    for key, w in want.items():
        g = got[key].cpu()
        if w.dtype.is_floating_point:
            check(torch.allclose(g, w, rtol=1e-3, atol=1e-3), f"small FRCNN {key}: card != CPU")
            worst = max(worst, float((g - w).abs().max()))
        else:
            check(torch.equal(g, w), f"small FRCNN {key}: card != CPU")
    print(f"small f32 FRCNN card vs CPU: ids/masks exact, max_abs_err={worst} (rtol/atol 1e-3)")


# --------------------------------------------------- the composed VQA path

VQA_BIG_HW = (1000, 1400)  # larger than the raw canvas 512 x 672: shrunk on the host by 0.48
VQA_SHRUNK_HW = (480, 672)


def vqa_requests(rng: np.random.Generator):
    """Three requests: 8 pairs of 480x640 images; 8 pairs with one image
    larger than the raw canvas; the first 5 pairs of the first request
    (a bucket with 3 pad rows)."""
    first = [rng.integers(0, 256, (*RAW_HW, 3), dtype=np.uint8) for _ in range(8)]
    second = [rng.integers(0, 256, (*RAW_HW, 3), dtype=np.uint8) for _ in range(8)]
    second[3] = rng.integers(0, 256, (*VQA_BIG_HW, 3), dtype=np.uint8)
    from vltk_tpu_torch.trace import VQA_QUESTIONS

    questions = list(VQA_QUESTIONS)
    return [(first, questions), (second, questions[::-1]), (first[:5], questions[:5])]


def check_vqa_results(images, results) -> None:
    """Scores finite in [0, 1] and ranked; boxes finite and inside each
    caller's image; at least one box on most rows."""
    check(len(results) == len(images), "one VQA result per pair")
    with_boxes = 0
    for img, res in zip(images, results):
        scores = np.array([s for _, s in res["topk"]])
        check(bool(np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()),
              f"VQA scores outside [0, 1]: {scores}")
        check(bool((np.diff(scores) <= 0).all()) and res["answer"] == res["topk"][0][0], "VQA top-k not ranked")
        boxes = res["boxes"]
        h, w = img.shape[:2]
        check(boxes.shape == (36, 4) and bool(np.isfinite(boxes).all()), f"VQA boxes {boxes.shape} not finite")
        inside = (boxes >= -1e-3).all() and (boxes[:, [0, 2]] <= w + 1e-3).all() and (boxes[:, [1, 3]] <= h + 1e-3).all()
        check(bool(inside), f"VQA boxes outside the {h}x{w} image")
        with_boxes += res["num_boxes"] > 0
    check(with_boxes >= 0.75 * len(results), f"only {with_boxes} of {len(results)} pairs have a box")


def differing(got, want) -> dict:
    """How many final boxes (slot by slot, and boxes found in no slot of
    the other run), object ids and top-1 answers of two runs of the same
    pairs differ, and the largest score and box differences."""
    def unmatched(g, w):
        return int((np.abs(g[:, None, :] - w[None, :, :]).max(-1).min(-1) > 1e-3).sum())

    return {
        "boxes": int(sum(np.any(g["boxes"] != w["boxes"], axis=-1).sum() for g, w in zip(got, want))),
        "boxes_in_no_slot": sum(unmatched(g["boxes"], w["boxes"]) for g, w in zip(got, want)),
        "object_ids": int(sum((g["objects"] != w["objects"]).sum() for g, w in zip(got, want))),
        "top1": int(sum(g["answer"] != w["answer"] for g, w in zip(got, want))),
        "of": [len(got) * 36, len(got) * 36, len(got)],
        "max_score_diff": max(max(abs(a[1] - b[1]) for a, b in zip(g["topk"], w["topk"])) for g, w in zip(got, want)),
        "max_box_diff": float(max(np.abs(g["boxes"] - w["boxes"]).max() for g, w in zip(got, want))),
    }


def vqa_bucket(pred, images):
    """What ``pred`` hands the card for one bucket of ``images``: the
    collated raw images and sizes (an oversized image shrunk), padded to
    the batch with 0 x 0 rows. Returns (raw sizes before padding, raw
    images, sizes) with the last two on the card."""
    from vltk_tpu_torch.adapters.frcnn import collate

    collated = collate(pred._entries(images), pred.raw_canvas)
    put = lambda a: torch.from_numpy(pred._pad_chunk(a)).to(pred.device)  # noqa: E731
    return collated["rawsize"], put(collated["image"]), put(collated["rawsize"].astype(np.float32))


def pad_row_kernel_inputs(pred, images):
    """Runs the FRCNN part of a bucket with pad rows and keeps what it hands
    K1 (features, proposals) and K2 (its two calls' inputs and keeps)."""
    from vltk_tpu_torch.tools.bench_nms import step_calls

    _, raw, sizes = vqa_bucket(pred, images)
    store, hook = capture_roi_inputs(pred.frcnn)
    try:
        calls = step_calls({"step": pred.detect}, raw, sizes)
    finally:
        hook.remove()
    return store["features"], store["boxes"].contiguous(), calls


def hold_kernels_on_pad_rows(pred, images) -> dict:
    """K1 and K2 held against their plain versions on the inputs of a
    bucket of ``len(images)`` real rows and pad rows (raw size 0 x 0), pad
    rows included: K1 NaN in the same places and every other value
    bitwise equal, K2 exact keeps and masks at every cluster size and
    equal to the keeps the bucket used. Returns what the pad rows held
    and K2's largest keep error."""
    from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets

    real = len(images)
    feat, boxes, calls = pad_row_kernel_inputs(pred, images)
    got = roi_pool_path_run(feat, boxes, "vector")
    want = roi_pool_offsets(feat, boxes, 14, 1 / 16)
    torch.cuda.synchronize()
    check(nan_equal(got, want), "roi_pool kernel != plain on the padded VQA bucket (pad rows included)")
    held = {
        "pad_rows": feat.shape[0] - real,
        "pad_proposals_nonfinite": int((~torch.isfinite(boxes[real:])).any(-1).sum()),
        "pad_features_nonfinite": int((~torch.isfinite(feat[real:].float())).sum()),
        "roi_pool_nan_out_pad_rows": int(torch.isnan(got[real:].float()).sum()),
        "roi_pool_nan_out_real_rows": int(torch.isnan(got[:real].float()).sum()),
    }
    err = 0.0
    for call in calls:
        keep, call_err = nms_held(call, f"the padded VQA bucket's {call['name']} call")
        check(torch.equal(keep, call["keep"]), f"the padded VQA bucket's {call['name']} keeps differ from the plain version's")
        err = max(err, call_err)
        held[call["name"] + "_pad_rows_kept"] = int((keep[real * keep.shape[0] // feat.shape[0]:] >= 0).sum())
    print(f"VQA padded bucket, K1 and K2 against their plain versions on its own inputs, pad rows included: "
          f"K1 NaN in the same places and bitwise equal elsewhere, K2 exact keeps at every cluster size; {held}")
    held["nms_max_abs_err"] = err
    return held


def time_vqa_step(pred, dev, steps: int) -> dict:
    """The composed step and the FRCNN part alone at B=8 on device-resident
    inputs: K steps, one synchronise each."""
    from vltk_tpu_torch.trace import vqa_inputs

    raw, sizes, ids, tmask = vqa_inputs(pred, 8, dev)
    timed = {}
    for name, fn in (("step", lambda: pred.step(raw, sizes, ids, tmask)), ("frcnn", lambda: pred.detect(raw, sizes))):
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
        timed[name + "_ms"] = (time.perf_counter() - t0) / steps * 1e3
        timed[name + "_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if name == "step":
            check(bool(torch.isfinite(out["scores"]).all()), "VQA step scores are not finite")
    timed["samples_per_s"] = 8 * 1e3 / timed["step_ms"]
    timed["lxmert_ms_by_difference"] = timed["step_ms"] - timed["frcnn_ms"]
    return timed


def phase_vqa(dev, wrappers, smi: str) -> dict:
    """The composed VQA path: VQAPredictor at full width (parity_300 FRCNN,
    LXMERT-base bf16) serves three requests; K1 once and K2 twice a bucket,
    K3 never; the padded bucket's real rows against the full bucket's; the
    step timed; TF32 off on the first bucket, counted."""
    from vltk_tpu_torch.trace import VQA_SEQ, build_vqa

    pred = build_vqa(8, dev)  # tamed FRCNN weights, so that detections exist
    fc, lc = pred.frcnn_config, pred.lxmert_config
    check(
        (fc.depth, fc.num_classes, fc.num_attrs, fc.pre_nms_topk, fc.post_nms_topk, fc.max_detections,
         fc.dtype) == (101, 1600, 400, 6000, 300, 36, "bfloat16"),
        f"parity_300 config {fc}",
    )
    check(
        (lc.l_layers, lc.r_layers, lc.x_layers, lc.hidden_size, lc.num_heads, lc.head_dim,
         lc.intermediate_size, lc.vocab_size, lc.num_answers, lc.visual_feat_dim, lc.dtype,
         lc.attention_impl) == (9, 5, 5, 768, 12, 64, 3072, 30522, 3129, 2048, "bfloat16", "xla"),
        f"LXMERT-base config {lc}",
    )
    requests = vqa_requests(np.random.default_rng(0))

    for w in wrappers.values():
        w.launches = 0
    paths = wrappers["roi_pool"].path_launches
    paths.update(dict.fromkeys(paths, 0))
    t0 = time.perf_counter()
    answers = [pred(images, questions) for images, questions in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    paths = dict(paths)
    buckets = len(requests)
    check(launches["roi_pool"] == buckets and paths["scalar"] == 0,
          f"K1 launched {launches['roi_pool']} times ({paths}) over {buckets} buckets")
    check(launches["nms"] == 2 * buckets, f"K2 launched {launches['nms']} times over {buckets} buckets")
    others = {k: v for k, v in launches.items() if k not in ("roi_pool", "nms")}
    check(not any(others.values()), f"other kernels launched on the VQA path: {others}")
    for (images, _), results in zip(requests, answers):
        check_vqa_results(images, results)
    shrunk = vqa_bucket(pred, requests[1][0])[0][3]
    check(tuple(shrunk) == VQA_SHRUNK_HW, f"the oversized image's raw size after collate: {tuple(shrunk)}")
    pad = differing(answers[2], answers[0][:5])
    print(f"VQA padded bucket (5 real + 3 pad rows) vs the same pairs in a full bucket: {pad}")
    check(pad["boxes"] == 0 and pad["object_ids"] == 0 and pad["top1"] == 0 and pad["max_score_diff"] <= 1e-3,
          f"padded bucket's real rows differ from the full bucket's: {pad}")
    print(
        f"VQA requests: 8 + 8 + 5 pairs, {serve_s:.3f} s with host prep; launches {launches} over "
        f"{buckets} buckets (K1 paths {paths}); boxes per pair {[r['num_boxes'] for r in answers[0]]}"
    )
    pad_rows = hold_kernels_on_pad_rows(pred, requests[2][0])

    timed = time_vqa_step(pred, dev, steps=5)
    print(
        f"VQA step B=8 parity_300 + LXMERT-base bf16, seq {VQA_SEQ}, 36 boxes, canvas {CANVAS[0]}x{CANVAS[1]}: "
        f"{timed['samples_per_s']:.2f} samples/s ({timed['step_ms']:.3f} ms/step over 5 steps), FRCNN alone "
        f"{timed['frcnn_ms']:.3f} ms, LXMERT by difference {timed['lxmert_ms_by_difference']:.3f} ms; "
        f"peak {timed['step_peak_mem_gb']:.2f} GB on {smi}"
    )

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        no_tf32 = pred(*requests[0])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tf32 = differing(no_tf32, answers[0])
    print(f"VQA first bucket with cudnn TF32 off vs the default run (C.3, measured only): {tf32}")
    return {"launches": launches, "roi_pool_paths": paths, "padded_vs_full": pad, "pad_rows": pad_rows, "timed": timed,
            "tf32_off_vs_default": tf32, "num_boxes": [[r["num_boxes"] for r in a] for a in answers]}


def phase_small_vqa(dev) -> None:
    """A small f32 composed predictor on the card against the same one on
    the CPU: three pairs at batch_size 2, so the second bucket has a pad
    row."""
    from vltk_tpu_torch.models import FRCNNConfig
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.predict import VQAPredictor

    kw = dict(
        frcnn_config=FRCNNConfig(
            depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4,
            rpn_hidden_channels=16, anchor_sizes=(16, 32), pre_nms_topk=64, post_nms_topk=16,
            num_classes=7, num_attrs=5, pooler_resolution=7, min_detections=4, max_detections=4,
        ),
        lxmert_config=LxmertConfig(hidden_size=48, num_heads=2, intermediate_size=96, l_layers=2,
                                   x_layers=1, r_layers=1, max_position_embeddings=32),
        batch_size=2, max_seq_length=12, raw_canvas=(64, 64), resized_canvas=(64, 64), short=32.0, maximum=64.0,
    )
    answers = ["yes", "no", "red", "2", "cat"]
    cpu = VQAPredictor(answers, device="cpu", **kw)
    gpu = VQAPredictor(answers, device=dev, frcnn_params=cpu.frcnn.state_dict(),
                       lxmert_params=cpu.lxmert.state_dict(), **kw)
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((48, 56), (64, 40), (100, 80))]
    questions = ["what color is it?", "is there a cat?", "how many?"]
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, got = cpu(images, questions), gpu(images, questions)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    score_err = max(max(abs(a[1] - b[1]) for a, b in zip(g["topk"], w["topk"])) for g, w in zip(got, want))
    box_err = float(max(np.abs(g["boxes"] - w["boxes"]).max() for g, w in zip(got, want)))
    for g, w in zip(got, want):
        check([a for a, _ in g["topk"]] == [a for a, _ in w["topk"]] and g["num_boxes"] == w["num_boxes"]
              and np.array_equal(g["objects"], w["objects"]), "small VQA: card != CPU (answers, boxes or ids)")
        check(np.allclose(g["boxes"], w["boxes"], rtol=1e-3, atol=1e-3), "small VQA: card != CPU (boxes)")
    print(f"small f32 VQA predictor card vs CPU: answers, order, ids and box counts exact, "
          f"max score err {score_err:.3e} (1e-4), max box err {box_err:.3e} px (rtol/atol 1e-3, as phase 8)")
    check(score_err <= 1e-4, "small VQA: card != CPU (scores)")


# ------------------------------------------------------ the document path

DOC_LABELS = ["other", "question", "answer", "header"]
DOC_SEQ = 1024
# three requests of four documents: word counts below and above the
# 1023-sub-token budget (the long ones are truncated)
DOC_REQUESTS = ((40, 300, 700, 1500), (1000, 5, 650, 900), (120, 1022, 480, 2000))


def synthetic_documents(rng: np.random.Generator, words_of_vocab, counts):
    """Pages of words drawn from the vocabulary (a quarter of them two
    words glued, so they split into several sub-tokens) with seeded boxes
    on a 2200 x 1700 page."""
    docs = []
    words_of_vocab = np.asarray(words_of_vocab)  # a list would be converted on every draw
    for n_words in counts:
        words = [
            str(rng.choice(words_of_vocab)) + (str(rng.choice(words_of_vocab)) if rng.random() < 0.25 else "")
            for _ in range(n_words)
        ]
        xy = rng.integers(0, 1500, (n_words, 2))
        boxes = np.concatenate([xy, xy + rng.integers(5, 200, (n_words, 2))], axis=1)
        docs.append({"words": words, "boxes": boxes.tolist(), "size": (2200, 1700)})
    return docs


def words_within_budget(tok, words) -> int:
    """How many words the predictor must label: those whose first
    sub-token starts before the last ([SEP]) slot, of the first
    max_len - 1 words."""
    pieces = [max(len(p), 1) for p in tok.encode_words(words)][: DOC_SEQ - 1]
    starts = np.concatenate([[0], np.cumsum(pieces)[:-1]])
    return int((starts < DOC_SEQ - 1).sum())


def time_doc_step(clf, ids, boxes, mask, steps: int):
    clf.step(ids, boxes, mask)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        probs = clf.step(ids, boxes, mask)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(probs).all()), "document step output is not finite")
    return ids.shape[0] * steps / dt, dt / steps * 1e3, torch.cuda.max_memory_allocated() / 1e9


def phase_document(dev, wrappers, smi: str) -> dict:
    """The document path: requests through DocTokenClassifier at LayoutLM-base
    width, then the classifier step at the bench geometry on both routes."""
    import dataclasses

    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocTokenClassifier
    from vltk_tpu_torch.trace import bench_documents

    cfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=DOC_SEQ)
    check(
        (cfg.l_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.intermediate_size,
         cfg.vocab_size, cfg.coord_vocab, cfg.attention_impl) == (12, 768, 12, 64, 3072, 30522, 1024, "auto"),
        f"LayoutLM-base config {cfg}",
    )
    clf = DocTokenClassifier(DOC_LABELS, config=cfg, batch_size=4, max_seq_length=DOC_SEQ, device=dev)
    with open(V.VOCABPATH) as f:
        vocab_words = [w for w in f.read().split("\n") if w.isascii() and w.isalpha()]
    rng = np.random.default_rng(0)
    requests = [synthetic_documents(rng, vocab_words, counts) for counts in DOC_REQUESTS]

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    answers = [clf(docs) for docs in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    forwards = len(requests)  # four documents fill one batch of 4
    check(launches["flash_attention"] == 12 * forwards,
          f"flash attention launched {launches['flash_attention']} times over {forwards} forwards")
    check(launches["roi_pool"] == 0 and launches["nms"] == 0, f"extraction kernels on the document path: {launches}")
    check(launches["flash_attention_dkv"] == 0 and launches["flash_attention_dq"] == 0,
          f"backward kernels on the serving path: {launches}")
    n_words = []
    for docs, out in zip(requests, answers):
        check(len(out) == len(docs), "one result per document")
        for doc, res in zip(docs, out):
            want = words_within_budget(clf.tokenizer, doc["words"])
            check(len(res) == want, f"{len(res)} labelled words, want {want}")
            check([r["word"] for r in res] == doc["words"][:want], "labelled words out of order")
            scores = np.array([r["score"] for r in res])
            check(all(r["label"] in DOC_LABELS for r in res), "label outside the label set")
            check(bool(np.isfinite(scores).all() and (scores > 0).all() and (scores <= 1).all()),
                  "scores outside (0, 1]")
            n_words.append(want)
    print(
        f"document requests: {len(requests)} x 4 documents, words labelled {n_words}, "
        f"{serve_s:.3f} s with host prep; launches {launches} over {forwards} forwards"
    )

    ids, boxes, mask = bench_documents(32, cfg.vocab_size, dev)
    dense_clf = DocTokenClassifier(
        DOC_LABELS, params=clf.model.state_dict(), config=dataclasses.replace(cfg, attention_impl="xla"),
        batch_size=32, max_seq_length=DOC_SEQ, device=dev, tokenizer=clf.tokenizer,
    )
    timed = {}
    for attn, model in (("xla", dense_clf), ("auto", clf)):
        docs_s, step_ms, peak = time_doc_step(model, ids, boxes, mask, steps=5)
        timed[attn] = {"documents_per_s": docs_s, "step_ms": step_ms, "peak_mem_gb": peak}
        route = "dense route" if attn == "xla" else "K3 flash route"
        print(
            f"LayoutLM-base doc step B=32 seq {DOC_SEQ} bf16 attention_impl={attn} ({route}): "
            f"{docs_s:.2f} documents/s ({step_ms:.3f} ms/step over 5 steps) on {smi}; peak {peak:.2f} GB"
        )
    with torch.inference_mode():
        agree = (dense_clf.step(ids, boxes, mask) - clf.step(ids, boxes, mask)).abs().max()
    print(f"doc step, K3 route vs dense route on all-real documents: max |dprob| = {float(agree):.3e}")
    return {"launches": launches, "words": n_words, "timed": timed}


def phase_small_layoutlm(dev) -> None:
    """A small f32 LayoutLM on the card against the same model on the CPU,
    the flash route forced on both sides: K3 on the card, the plain
    version on the CPU (the gate is opened for the CPU's device too)."""
    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, init_weights
    from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto

    cfg = LayoutLMConfig(
        vocab_size=1000, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
        max_position_embeddings=256, attention_impl="flash",
    )
    cpu = init_weights(LayoutLMForTokenClassification(cfg).eval(), seed=5)
    gpu = LayoutLMForTokenClassification(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 1000, (3, 256)))
    boxes = torch.from_numpy(np.sort(rng.integers(0, 1000, (3, 256, 2, 2)), axis=2).reshape(3, 256, 4))
    mask = torch.zeros(3, 256)
    for i, length in enumerate((256, 200, 77)):
        mask[i, :length] = 1
    gate = PX._flash_applicable
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    before = flash_attention_auto.launches
    PX._flash_applicable = lambda s, det, drop, device: s >= 128 and (det or drop == 0.0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = cpu(ids, boxes, mask)
            got = gpu(ids.to(dev), boxes.to(dev), mask.to(dev)).cpu()
    finally:
        PX._flash_applicable = gate
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check(flash_attention_auto.launches - before == cfg.l_layers, "small LayoutLM did not run K3 in every layer")
    real = mask.bool()
    err = float((got[real] - want[real]).abs().max())
    print(f"small f32 LayoutLM, flash route, card (K3) vs CPU (plain) at real positions: max_abs_err={err} (1e-4)")
    check(torch.allclose(got[real], want[real], rtol=1e-4, atol=1e-4), "small LayoutLM: card != CPU")


# ------------------------------------------------------ the training path

TRAIN_BATCH = 8
TRAIN_STEPS = 8  # one epoch of 8 batches
# 1e-5, not the 1e-4 of a fine-tune from pretrained weights: with 8 steps
# the warmup is one update, and AdamW's first step at 1e-4 (a step of ~lr on
# every weight of a randomly initialised model) throws the loss up ~4x on
# both attention routes alike before it decays back; at 1e-5 the epoch ends
# below where it began (`python -m vltk_tpu_torch.trace --model layoutlm
# --train --lrs 1e-4 1e-5` prints both curves)
TRAIN_LR = 1e-5
# relative L2 per parameter tensor, flash route vs dense route, one bf16
# step: the dense route rounds the scores to bf16 three times (product,
# / sqrt(dh), + bias) and the probabilities once, the flash route keeps the
# scores in float32 and rounds p once; a few bf16 ulps (2^-8 = 3.9e-3) of
# relative difference per layer, carried through 12 layers
ROUTE_GRAD_BOUND = 5e-2


def time_train_step(exp, host_batch, steps: int = 5, batch: int = TRAIN_BATCH):
    """(samples/s, ms a step, peak GB) of the experiment's train step on one
    device-resident batch of ``batch`` rows, after a warm-up step."""
    data = next(iter(exp._device_batches([host_batch])))
    exp.train_step(data)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = exp.train_step(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(metrics["loss"])), "timed training step: loss not finite")
    return batch * steps / dt, dt / steps * 1e3, torch.cuda.max_memory_allocated() / 1e9


def phase_training(dev, wrappers, smi: str) -> dict:
    """The training path: OCRTokenExperiment at LayoutLM-base width for one
    epoch, then the step timed on both attention routes."""
    import dataclasses
    import tempfile

    from vltk_tpu_torch.trace import layoutlm_train_config, train_documents, train_experiment

    cfg = layoutlm_train_config("auto")
    check(
        (cfg.l_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
         cfg.coord_vocab, cfg.max_position_embeddings, cfg.dtype, cfg.attention_impl, cfg.attention_dropout,
         cfg.hidden_dropout) == (12, 768, 12, 64, 3072, 30522, 1024, 1024, "bfloat16", "auto", 0.0, 0.1),
        f"LayoutLM-base training config {cfg}",
    )
    host = {k: v.numpy() for k, v in train_documents(TRAIN_BATCH, cfg.vocab_size, cfg.num_labels, "cpu").items()}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as logdir:
        exp = train_experiment(cfg, os.path.join(logdir, "auto"), [host] * TRAIN_STEPS, TRAIN_LR)
        check(exp.device.type == "cuda", f"experiment on {exp.device}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        result = exp()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        with open(os.path.join(exp.logdir, "steps_log.json")) as f:
            log = [json.loads(line) for line in f]
        losses = [r["loss"] for r in log]
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"training losses {losses}")
        first, last = np.mean(losses[:2]), np.mean(losses[-2:])
        check(last < first, f"training loss did not fall: first two {first}, last two {last}")
        for name in ("flash_attention", "flash_attention_dkv", "flash_attention_dq"):
            check(launches[name] == 12 * TRAIN_STEPS,
                  f"{name} launched {launches[name]} times over {TRAIN_STEPS} steps (want 12 per step)")
        check(launches["roi_pool"] == 0 and launches["nms"] == 0, f"extraction kernels on the training path: {launches}")
        ckpt = os.path.join(exp.ckpt_dir, "ocr_tokens_epoch_0.pt")
        check(os.path.exists(ckpt) and os.path.exists(os.path.join(exp.ckpt_dir, "info.json")),
              "no checkpoint written")
        print(
            f"training: OCRTokenExperiment LayoutLM-base bf16 seq 1024 B={TRAIN_BATCH}, {TRAIN_STEPS} steps in "
            f"{train_s:.2f} s with checkpointing; losses {[round(x, 5) for x in losses]}; "
            f"token_acc {result['train'].get('token_acc')}; launches {launches}"
        )
        timed = {}
        xla = train_experiment(dataclasses.replace(cfg, attention_impl="xla"), os.path.join(logdir, "xla"), [host],
                               TRAIN_LR)
        for attn, e in (("auto", exp), ("xla", xla)):
            seq_s, step_ms, peak = time_train_step(e, host, steps=5)
            timed[attn] = {"sequences_per_s": seq_s, "step_ms": step_ms, "peak_mem_gb": peak}
            route = "K3/K4/K5 flash route" if attn == "auto" else "dense route"
            print(
                f"LayoutLM-base train step B={TRAIN_BATCH} seq 1024 bf16 attention_impl={attn} ({route}): "
                f"{seq_s:.2f} sequences/s ({step_ms:.3f} ms/step over 5 steps) on {smi}; peak {peak:.2f} GB"
            )
        del exp, xla
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "train_s": train_s, "timed": timed}


def phase_route_gradients(dev) -> None:
    """One full-width bf16 step's parameter gradients, flash route against
    dense route, same weights and batch, dropout 0."""
    import dataclasses

    from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification, init_weights, token_classification_loss
    from vltk_tpu_torch.trace import layoutlm_train_config, train_documents

    cfg = layoutlm_train_config("auto", hidden_dropout=0.0)
    b = train_documents(TRAIN_BATCH, cfg.vocab_size, cfg.num_labels, dev)
    state = init_weights(LayoutLMForTokenClassification(cfg), seed=0).state_dict()
    grads = {}
    for impl in ("auto", "xla"):
        model = LayoutLMForTokenClassification(dataclasses.replace(cfg, attention_impl=impl))
        model.load_state_dict(state)
        model.to(dev).train()
        logits = model(b["vtext"], b["tokenbox"], b["visual_attention_mask"])
        token_classification_loss(logits, b["tokenlabels"]).backward()
        grads[impl] = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
        del model
    errs = {}
    for name, g in grads["auto"].items():
        if name.endswith("attention.self.key.bias"):
            continue  # zero but for rounding on both routes: softmax ignores a bias on every key
        ref = grads["xla"][name]
        errs[name] = float((g - ref).norm() / ref.norm().clamp(min=1e-30))
    worst = max(errs, key=errs.get)
    print(
        f"flash vs dense route, one bf16 step at full width: relative L2 of {len(errs)} parameter gradients "
        f"median {np.median(list(errs.values())):.3e}, max {errs[worst]:.3e} ({worst}; bound {ROUTE_GRAD_BOUND})"
    )
    check(errs[worst] <= ROUTE_GRAD_BOUND, f"flash route gradients differ from the dense route's: {worst}")
    torch.cuda.empty_cache()


def phase_small_layoutlm_train(dev) -> None:
    """Two f32 training steps of a small LayoutLM on the card and on the CPU
    with the flash route forced on both sides (K3, K4, K5 on the card, the
    plain versions on the CPU): loss 1e-5, gradients 1e-4, parameters after
    the AdamW update 1e-5. The first update has lr 0 (the schedule), so the
    second step is the one that moves the weights."""
    import copy

    from vltk_tpu_torch.config import TrainConfig
    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.layoutlm import (
        LayoutLMConfig,
        LayoutLMForTokenClassification,
        init_weights,
        token_classification_loss,
    )
    from vltk_tpu_torch.ops import KERNEL_WRAPPERS
    from vltk_tpu_torch.train import make_optimizer, make_train_step

    cfg = LayoutLMConfig(
        vocab_size=1000, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
        max_position_embeddings=256, attention_impl="flash", attention_dropout=0.0, hidden_dropout=0.0,
    )
    cpu = init_weights(LayoutLMForTokenClassification(cfg), seed=7)
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(7)
    mask = np.zeros((3, 256), np.float32)
    for i, length in enumerate((256, 200, 77)):
        mask[i, :length] = 1
    labels = rng.integers(0, cfg.num_labels, (3, 256))
    labels[mask == 0] = -100
    batch = {
        "ids": torch.from_numpy(rng.integers(0, 1000, (3, 256))),
        "boxes": torch.from_numpy(np.sort(rng.integers(0, 1000, (3, 256, 2, 2)), axis=2).reshape(3, 256, 4)),
        "mask": torch.from_numpy(mask), "labels": torch.from_numpy(labels),
    }

    def loss_fn(model, b):
        return token_classification_loss(model(b["ids"], b["boxes"], b["mask"]), b["labels"]), {}

    gate = PX._flash_applicable
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    PX._flash_applicable = lambda s, det, drop, device: s >= 128 and (det or drop == 0.0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = lambda: [KERNEL_WRAPPERS[k].launches for k in ("flash_attention", "flash_attention_dkv", "flash_attention_dq")]  # noqa: E731
    before = counts()
    out = {}
    try:
        for side, model in (("cpu", cpu), ("gpu", gpu)):
            opt, sched = make_optimizer(model, TrainConfig(learning_rate=1e-3), total_steps=10)
            step = make_train_step(model, loss_fn, opt, sched)
            b = {k: v.to(model.classifier.weight.device) for k, v in batch.items()}
            losses = [float(step(b)["loss"]) for _ in range(2)]
            out[side] = (losses, {n: (p.grad.cpu(), p.detach().cpu()) for n, p in model.named_parameters()})
    finally:
        PX._flash_applicable = gate
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check([a - b for a, b in zip(counts(), before)] == [4, 4, 4], "small training steps did not run K3, K4, K5 per layer")
    loss_err = max(abs(a - b) for a, b in zip(out["cpu"][0], out["gpu"][0]))
    grad_err = max(float((out["gpu"][1][n][0] - g).abs().max()) for n, (g, _) in out["cpu"][1].items())
    # the key bias's gradient is zero but for rounding; AdamW normalises
    # that rounding into a full-size step of either sign, so its weights
    # are left out of the parameter comparison
    param_err = max(float((out["gpu"][1][n][1] - p).abs().max()) for n, (_, p) in out["cpu"][1].items()
                    if not n.endswith("attention.self.key.bias"))
    print(
        f"small f32 LayoutLM training, flash route, card (K3/K4/K5) vs CPU (plain), 2 steps: loss err {loss_err:.2e} "
        f"(1e-5), grad err {grad_err:.2e} (1e-4), param err after AdamW {param_err:.2e} (1e-5)"
    )
    check(loss_err <= 1e-5 and grad_err <= 1e-4 and param_err <= 1e-5, "small LayoutLM training: card != CPU")


# ------------------------------------------- document span QA (serving)

SPAN_Q, SPAN_DOC = 64, 960  # question and document budgets: seq 1024, so K3 takes it
# three requests of four (document, question) pairs, the last of three, so
# its bucket of 4 has a pad row
SPAN_REQUESTS = ((40, 300, 700, 1500), (1000, 5, 650, 900), (120, 958, 480))
SPAN_BATCH = 32  # the timed step: the document step's bench geometry


def span_questions(rng: np.random.Generator, words_of_vocab, n: int):
    """Questions of 5-40 words drawn from the vocabulary, so the question's
    pad hole in the stream has many widths."""
    return [" ".join(rng.choice(words_of_vocab, int(rng.integers(5, 41)))) for _ in range(n)]


def check_span_answers(docs, results) -> None:
    check(len(results) == len(docs), "one answer per pair")
    for doc, res in zip(docs, results):
        sw, ew = res["start_word"], res["end_word"]
        check(0 <= sw <= ew < len(doc["words"]), f"span ({sw}, {ew}) outside a document of {len(doc['words'])} words")
        check(res["answer"] == " ".join(doc["words"][sw:ew + 1]), "answer text is not the span's words")
        check(bool(np.isfinite(res["score"])) and res["score"] <= 0.0, f"span score {res['score']}")


def phase_span(dev, wrappers, smi: str) -> dict:
    """Document span QA: DocSpanQA at LayoutLM-base width, seq 1024 (64
    question + 960 OCR sub-tokens), serves three requests (K3 12 times a
    forward, the question's pad a hole in mid-stream); the padded bucket's
    rows against a full bucket's; the span step timed at B=32 on both
    routes, and the host decode apart."""
    import dataclasses

    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocSpanQA, _best_span

    cfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=SPAN_Q + SPAN_DOC)
    check(
        (cfg.l_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.intermediate_size,
         cfg.vocab_size, cfg.coord_vocab, cfg.attention_impl) == (12, 768, 12, 64, 3072, 30522, 1024, "auto"),
        f"LayoutLM-base config {cfg}",
    )
    qa = DocSpanQA(config=cfg, batch_size=4, question_len=SPAN_Q, doc_len=SPAN_DOC, device=dev)
    with open(V.VOCABPATH) as f:
        vocab_words = [w for w in f.read().split("\n") if w.isascii() and w.isalpha()]
    rng = np.random.default_rng(1)
    requests = [(synthetic_documents(rng, vocab_words, counts), span_questions(rng, vocab_words, len(counts)))
                for counts in SPAN_REQUESTS]

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    answers = [qa(docs, questions) for docs, questions in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    forwards = len(requests)
    check(launches["flash_attention"] == 12 * forwards,
          f"flash attention launched {launches['flash_attention']} times over {forwards} span forwards")
    others = {k: v for k, v in launches.items() if k != "flash_attention"}
    check(not any(others.values()), f"other kernels on the span serving path: {others}")
    for (docs, _), results in zip(requests, answers):
        check_span_answers(docs, results)
    (ids, boxes, mask), _, _, _ = qa.prepare(*requests[0])
    holes = int(((mask[:, :-1] == 0) & (mask[:, 1:] == 1)).sum())
    check(holes == 4, f"{holes} pad holes in the first bucket's 4 rows")
    print(
        f"span requests: 4 + 4 + 3 pairs, {serve_s:.3f} s with host prep; launches {launches} over {forwards} "
        f"forwards; answers {[[(r['start_word'], r['end_word']) for r in a] for a in answers]}"
    )

    # the padded bucket (3 pairs + a pad row) against the same 3 pairs in a
    # full bucket (a fourth real pair): bitwise, log-probabilities and answers
    docs, questions = requests[2]
    (ids, boxes, mask), _, _, _ = qa.prepare(docs + requests[0][0][:1], questions + requests[0][1][:1])
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    full = qa.step(put(ids), put(boxes), put(mask))
    padded = qa.step(*(put(np.concatenate([a[:3], np.zeros_like(a[:1])])) for a in (ids, boxes, mask)))
    same = all(torch.equal(f[:3], p[:3]) for f, p in zip(full, padded))
    check(same and qa(docs + requests[0][0][:1], questions + requests[0][1][:1])[:3] == answers[2],
          "padded span bucket's real rows differ from the full bucket's")
    print("span padded bucket (3 real + 1 pad row) vs the same pairs in a full bucket: log-probs and answers bitwise equal")

    # the step at B=32, seq 1024, on both routes
    docs32 = synthetic_documents(rng, vocab_words, rng.integers(200, 1500, SPAN_BATCH))
    questions32 = span_questions(rng, vocab_words, SPAN_BATCH)
    (ids, boxes, mask), d_mask, _, _ = qa.prepare(docs32, questions32)
    ids, boxes, mask = put(ids), put(boxes), put(mask)
    timed = {}
    for attn in ("xla", "auto"):
        model = DocSpanQA(params=qa.model.state_dict(), config=dataclasses.replace(cfg, attention_impl=attn),
                          batch_size=SPAN_BATCH, question_len=SPAN_Q, doc_len=SPAN_DOC, tokenizer=qa.tokenizer,
                          device=dev)
        model.step(ids, boxes, mask)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            s_lp, e_lp = model.step(ids, boxes, mask)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        check(bool(torch.isfinite(s_lp).all() and torch.isfinite(e_lp).all()), "span step output is not finite")
        peak = torch.cuda.max_memory_allocated() / 1e9
        timed[attn] = {"questions_per_s": SPAN_BATCH * 1e3 / step_ms, "step_ms": step_ms, "peak_mem_gb": peak}
        route = "dense route" if attn == "xla" else "K3 flash route"
        print(
            f"LayoutLM-base span step B={SPAN_BATCH} seq {SPAN_Q + SPAN_DOC} bf16 attention_impl={attn} ({route}): "
            f"{timed[attn]['questions_per_s']:.2f} questions/s ({step_ms:.3f} ms/step over 5 steps, device queue "
            f"and host) on {smi}; peak {peak:.2f} GB"
        )
        del model
    s_np, e_np = s_lp.cpu().numpy(), e_lp.cpu().numpy()
    regions = [SPAN_Q + max(min(int(d_mask[j].sum()), SPAN_DOC - 1), 1) for j in range(SPAN_BATCH)]
    t0 = time.perf_counter()
    for j in range(SPAN_BATCH):
        _best_span(s_np[j], e_np[j], SPAN_Q, regions[j], qa.max_span)
    decode_ms = (time.perf_counter() - t0) * 1e3
    timed["host_decode_ms"] = decode_ms
    print(
        f"span host decode (_best_span, numpy) over the B={SPAN_BATCH} bucket's rows of {min(regions) - SPAN_Q}-"
        f"{max(regions) - SPAN_Q} positions: {decode_ms:.3f} ms a bucket on the host CPU "
        f"({decode_ms / SPAN_BATCH:.3f} ms a row), beside {timed['auto']['step_ms']:.3f} ms of the K3 step"
    )
    del qa
    torch.cuda.empty_cache()
    return {"launches": launches, "timed": timed, "serve_s": serve_s}


def phase_small_span(dev) -> None:
    """A small f32 DocSpanQA on the card against the same one on the CPU,
    the flash route forced on both sides (K3 on the card, the plain version
    on the CPU): log-probabilities at real positions (1e-4) and the answers
    (equal)."""
    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto
    from vltk_tpu_torch.predict import DocSpanQA

    cfg = LayoutLMConfig(hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
                         max_position_embeddings=256, attention_impl="flash")
    cpu = DocSpanQA(config=cfg, batch_size=2, question_len=24, doc_len=232, device="cpu")
    gpu = DocSpanQA(params=cpu.model.state_dict(), config=cfg, batch_size=2, question_len=24, doc_len=232,
                    tokenizer=cpu.tokenizer, device=dev)
    with open(V.VOCABPATH) as f:
        vocab_words = [w for w in f.read().split("\n") if w.isascii() and w.isalpha()]
    rng = np.random.default_rng(9)
    docs = synthetic_documents(rng, vocab_words, (60, 400, 7))
    questions = [" ".join(rng.choice(vocab_words, n)) for n in (3, 15, 8)]
    (ids, boxes, mask), _, _, _ = cpu.prepare(docs, questions)
    gate = PX._flash_applicable
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    before = flash_attention_auto.launches
    PX._flash_applicable = lambda s, det, drop, device: s >= 128 and (det or drop == 0.0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = cpu.step(*(torch.from_numpy(a) for a in (ids, boxes, mask)))
        got = [x.cpu() for x in gpu.step(*(torch.from_numpy(a).to(dev) for a in (ids, boxes, mask)))]
        answers = (cpu(docs, questions), gpu(docs, questions))
    finally:
        PX._flash_applicable = gate
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check(flash_attention_auto.launches - before == 3 * cfg.l_layers, "small DocSpanQA did not run K3 in every layer")
    real = torch.from_numpy(mask) > 0
    err = max(float((g[real] - w[real]).abs().max()) for g, w in zip(got, want))
    same = [(a["start_word"], a["end_word"]) for a in answers[0]] == [(a["start_word"], a["end_word"]) for a in answers[1]]
    print(f"small f32 DocSpanQA, flash route, card (K3) vs CPU (plain): log-prob err at real positions {err:.2e} "
          f"(1e-4), answers equal: {same}")
    check(err <= 1e-4 and same, "small DocSpanQA: card != CPU")


# ------------------------------------------- document span QA (training)


def span_train_batch(batch: int, vocab_size: int, seed: int = 0, q_len: int = SPAN_Q, doc_len: int = SPAN_DOC):
    """A DocVQA span batch as the loader gives it: questions of 5-40 real
    tokens of ``q_len`` (the rest pad, a hole in mid-stream once
    concatenated), OCR ids with a 20% pad tail, boxes (x0 y0 in [0, 900),
    w h in [1, 100)), answer spans of 1-8 tokens inside the real OCR, one
    row unanswerable (-100)."""
    rng = np.random.default_rng(seed)
    q_real = rng.integers(5, 41, batch).clip(max=q_len)
    q_mask = (np.arange(q_len)[None] < q_real[:, None]).astype(np.int32)
    ocr_real = int(doc_len * 0.8)
    ocr_mask = (np.arange(doc_len)[None] < ocr_real).astype(np.int32).repeat(batch, 0)
    xy0 = rng.integers(0, 900, (batch, doc_len, 2))
    start = rng.integers(0, ocr_real - 8, batch).astype(np.int32)
    end = (start + rng.integers(0, 8, batch)).astype(np.int32)
    start[-1] = end[-1] = -100
    return {
        "input_ids": (rng.integers(1000, vocab_size, (batch, q_len)) * q_mask).astype(np.int32),
        "text_attention_mask": q_mask,
        "vtext": (rng.integers(1000, vocab_size, (batch, doc_len)) * ocr_mask).astype(np.int32),
        "tokenbox": np.concatenate([xy0, xy0 + rng.integers(1, 100, (batch, doc_len, 2))], -1).astype(np.float32),
        "visual_attention_mask": ocr_mask,
        "span_start": start,
        "span_end": end,
    }


def span_experiment(cfg, logdir: str, loader, lr: float, device, q_len: int = SPAN_Q, doc_len: int = SPAN_DOC):
    """A ``DocVQASpanExperiment`` for one epoch over ``loader``: seeded
    random weights, AdamW at ``lr``, weight decay 0.01, warmup 0.1, clip 1."""
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import DocVQASpanExperiment

    class Experiment(DocVQASpanExperiment):
        model_config = cfg

    config = Config()
    config.logdir = logdir
    config.data.lang.update({"max_seq_length": q_len, "max_visual_seq_length": doc_len})
    config.train.update({"epochs": 1, "learning_rate": lr, "weight_decay": 0.01, "warmup_ratio": 0.1,
                         "clip_grad_norm": 1.0})
    return Experiment(config, loaders=(loader, None), device=device)


def phase_span_training(dev, wrappers, smi: str) -> dict:
    """DocVQASpanExperiment at LayoutLM-base width: one epoch of 8 steps at
    B=8, seq 1024 (64 question + 960 OCR, a 20% pad tail), hidden dropout
    0.1, attention dropout 0, lr 1e-5; K3, K5, K4 12 times each a step."""
    import tempfile

    from vltk_tpu_torch.trace import layoutlm_train_config

    cfg = layoutlm_train_config("auto")
    host = span_train_batch(TRAIN_BATCH, cfg.vocab_size)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_span_") as logdir:
        exp = span_experiment(cfg, logdir, [host] * TRAIN_STEPS, TRAIN_LR, device=dev)
        check(exp.device == dev, f"experiment on {exp.device}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        result = exp()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        with open(os.path.join(exp.logdir, "steps_log.json")) as f:
            log = [json.loads(line) for line in f]
        losses = [r["loss"] for r in log]
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"span training losses {losses}")
        check(all("span_acc" in r for r in log) and "span_acc" in result["train"], "span_acc not reported")
        for name in ("flash_attention", "flash_attention_dkv", "flash_attention_dq"):
            check(launches[name] == 12 * TRAIN_STEPS,
                  f"{name} launched {launches[name]} times over {TRAIN_STEPS} span steps (want 12 per step)")
        others = {k: v for k, v in launches.items() if not k.startswith("flash_attention")}
        check(not any(others.values()), f"other kernels on the span training path: {others}")
        print(
            f"span training: DocVQASpanExperiment LayoutLM-base bf16 seq {SPAN_Q}+{SPAN_DOC} B={TRAIN_BATCH}, "
            f"{TRAIN_STEPS} steps in {train_s:.2f} s with checkpointing; losses {[round(x, 5) for x in losses]}; "
            f"span_acc {result['train']['span_acc']}; launches {launches}"
        )
        seq_s, step_ms, peak = time_train_step(exp, host)
        print(
            f"LayoutLM-base span train step B={TRAIN_BATCH} seq 1024 bf16 (K3/K4/K5 flash route): {seq_s:.2f} "
            f"sequences/s ({step_ms:.3f} ms/step over 5 steps) on {smi}; peak {peak:.2f} GB"
        )
        del exp
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "train_s": train_s,
            "timed": {"sequences_per_s": seq_s, "step_ms": step_ms, "peak_mem_gb": peak}}


def phase_small_span_train(dev) -> None:
    """One f32 span training step of a small LayoutLM on the card and on the
    CPU, flash route forced on both sides (K3, K5, K4 on the card, the
    plain versions on the CPU), on a batch whose question pad is a hole in
    mid-stream: loss 1e-5, gradients 1e-4."""
    import tempfile

    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.ops import KERNEL_WRAPPERS

    cfg = LayoutLMConfig(vocab_size=2000, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
                         max_position_embeddings=256, attention_impl="flash", attention_dropout=0.0,
                         hidden_dropout=0.0)
    host = span_train_batch(3, cfg.vocab_size, seed=3, q_len=32, doc_len=224)
    gate = PX._flash_applicable
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    PX._flash_applicable = lambda s, det, drop, device: s >= 128 and (det or drop == 0.0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    counts = lambda: [KERNEL_WRAPPERS[k].launches for k in ("flash_attention", "flash_attention_dkv", "flash_attention_dq")]  # noqa: E731
    before = counts()
    out = {}
    try:
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_small_span_") as logdir:
            for side, device in (("cpu", "cpu"), ("gpu", dev)):
                exp = span_experiment(cfg, os.path.join(logdir, side), [host], 1e-3, device, q_len=32, doc_len=224)
                batch = next(iter(exp._device_batches([host])))
                exp.model.train()
                loss, _ = exp.loss_fn(exp.model, batch)
                loss.backward()
                out[side] = (float(loss.detach()), {n: p.grad.cpu() for n, p in exp.model.named_parameters()})
    finally:
        PX._flash_applicable = gate
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check([a - b for a, b in zip(counts(), before)] == [2, 2, 2], "small span step did not run K3, K4, K5 per layer")
    loss_err = abs(out["cpu"][0] - out["gpu"][0])
    grad_err = max(float((out["gpu"][1][n] - g).abs().max()) for n, g in out["cpu"][1].items())
    print(f"small f32 span training step, flash route, card (K3/K4/K5) vs CPU (plain): loss err {loss_err:.2e} "
          f"(1e-5), grad err {grad_err:.2e} (1e-4)")
    check(loss_err <= 1e-5 and grad_err <= 1e-4, "small span training step: card != CPU")


# ------------------------------------------------------- LXMERT trainers

LXMERT_TRAIN_BATCH, LXMERT_TRAIN_STEPS = 32, 4
LXMERT_SEQ, LXMERT_BOXES = 20, 36
PRETRAIN_TASKS = dict(task_mask_lm=True, task_obj_predict=True, task_matched=True, task_qa=True)


def lxmert_train_batch(batch: int, cfg, seed: int = 0, seq: int = LXMERT_SEQ, boxes: int = LXMERT_BOXES):
    """A VQA batch of precomputed region features as the loader gives it:
    questions of 6-20 real tokens in the BERT id range, ``boxes`` regions
    of ``visual_feat_dim`` features (a few rows with fewer valid), raw-pixel
    boxes with their raw size (normalised by ``prepare_batch``), answers as
    up to 10 sparse ids with soft scores."""
    rng = np.random.default_rng(seed)
    t_real = rng.integers(6, seq + 1, batch)
    tmask = (np.arange(seq)[None] < t_real[:, None]).astype(np.int32)
    v_real = np.where(rng.random(batch) < 0.25, rng.integers(10, boxes, batch), boxes)
    vmask = (np.arange(boxes)[None] < v_real[:, None]).astype(np.float32)
    raw = np.stack([rng.integers(300, 800, batch), rng.integers(300, 1000, batch)], 1).astype(np.float32)
    xy0 = rng.uniform(0, 0.8, (batch, boxes, 2))
    rel = np.concatenate([xy0, xy0 + rng.uniform(0.05, 0.2, (batch, boxes, 2))], -1)
    labels = np.full((batch, 10), -100, np.int32)
    n_ans = rng.integers(1, 11, batch)
    for i, k in enumerate(n_ans):
        labels[i, :k] = rng.choice(cfg.num_answers, k, replace=False)
    return {
        "input_ids": np.where(tmask > 0, rng.integers(1000, cfg.vocab_size, (batch, seq)), 0).astype(np.int32),
        "text_attention_mask": tmask,
        "features": (np.abs(rng.normal(size=(batch, boxes, cfg.visual_feat_dim))) * vmask[..., None])
        .astype(np.float32),
        "boxes": (rel * np.concatenate([raw[:, ::-1], raw[:, ::-1]], 1)[:, None]).astype(np.float32),
        "rawsize": raw,
        "boxes_mask": vmask,
        "labels": labels,
        "scores": rng.choice([0.3, 0.6, 0.9, 1.0], (batch, 10)).astype(np.float32),
    }


def lxmert_experiment(cls, cfg, logdir: str, loader, lr: float, device, **tasks):
    from vltk_tpu_torch.config import Config

    class Experiment(cls):
        model_config = cfg

    config = Config()
    config.logdir = logdir
    config.data.lang.update({"max_seq_length": LXMERT_SEQ})
    config.data.update({"max_detections": LXMERT_BOXES})
    config.train.update({"epochs": 1, "learning_rate": lr, "weight_decay": 0.01, "warmup_ratio": 0.1,
                         "clip_grad_norm": 1.0, **tasks})
    return Experiment(config, loaders=(loader, None), device=device)


def phase_lxmert_train(dev, wrappers, smi: str) -> dict:
    """LxmertVQAExperiment and LxmertPretrainExperiment (all four tasks) at
    LXMERT-base (9/5/5 layers, 768, 12 heads, 3129 answers, bf16 compute,
    float32 parameters), B=32, 20-token questions, 36 boxes of 2048
    features: an epoch of 4 steps each, finite losses, every pretraining
    term logged, and no kernel launched (the 20-token stream is below the
    flash gate and cross-attention never takes flash)."""
    import tempfile

    from vltk_tpu_torch.experiments import LxmertPretrainExperiment, LxmertVQAExperiment
    from vltk_tpu_torch.models.lxmert import LxmertConfig

    cfg = LxmertConfig(dtype="bfloat16")
    check(
        (cfg.l_layers, cfg.r_layers, cfg.x_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim,
         cfg.intermediate_size, cfg.vocab_size, cfg.num_answers, cfg.visual_feat_dim) ==
        (9, 5, 5, 768, 12, 64, 3072, 30522, 3129, 2048),
        f"LXMERT-base config {cfg}",
    )
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_lxmert_") as logdir:
        for name, cls, tasks, terms in (
            ("vqa", LxmertVQAExperiment, {}, ("vqa_score",)),
            ("pretrain", LxmertPretrainExperiment, PRETRAIN_TASKS, ("mlm_loss", "matched_loss", "feat_loss",
                                                                   "qa_loss")),
        ):
            host = [lxmert_train_batch(LXMERT_TRAIN_BATCH, cfg, seed=i) for i in range(LXMERT_TRAIN_STEPS)]
            exp = lxmert_experiment(cls, cfg, os.path.join(logdir, name), host, 1e-5, device=dev, **tasks)
            check(exp.device == dev, f"experiment on {exp.device}")
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            exp()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
            check(not any(launches.values()), f"kernels launched on the LXMERT {name} training path: {launches}")
            with open(os.path.join(exp.logdir, "steps_log.json")) as f:
                log = [json.loads(line) for line in f]
            check(len(log) == LXMERT_TRAIN_STEPS and all(np.isfinite(r["loss"]) for r in log),
                  f"LXMERT {name} losses {log}")
            for term in terms:
                check(all(term in r and np.isfinite(r[term]) for r in log), f"LXMERT {name}: {term} not logged")
            samples_s, step_ms, peak = time_train_step(exp, host[0], batch=LXMERT_TRAIN_BATCH)
            out[name] = {"launches": launches, "losses": [r["loss"] for r in log], "train_s": train_s,
                         "samples_per_s": samples_s, "step_ms": step_ms, "peak_mem_gb": peak,
                         **{term: [r[term] for r in log] for term in terms}}
            print(
                f"LXMERT-base {name} training B={LXMERT_TRAIN_BATCH}, {LXMERT_SEQ} tokens, {LXMERT_BOXES} boxes, bf16: "
                f"{LXMERT_TRAIN_STEPS} steps in {train_s:.2f} s; losses {[round(r['loss'], 5) for r in log]}; "
                f"no kernel launched (none is expected: the 20-token stream is below the flash gate, "
                f"cross-attention never takes flash); step {step_ms:.3f} ms, {samples_s:.2f} samples/s "
                f"over 5 steps on {smi}; peak {peak:.2f} GB"
            )
            del exp
            torch.cuda.empty_cache()
    return out


def phase_small_pretrain(dev) -> None:
    """One f32 pretraining step's losses (all four tasks) of a small LXMERT
    on the card and on the CPU, the same weights and the same corrupted
    batch: every loss term within 1e-5."""
    import tempfile

    from vltk_tpu_torch.experiments import LxmertPretrainExperiment
    from vltk_tpu_torch.models.lxmert import LxmertConfig

    cfg = LxmertConfig(hidden_size=48, num_heads=2, intermediate_size=96, l_layers=2, x_layers=1, r_layers=1,
                       visual_feat_dim=64, max_position_embeddings=32, num_answers=50, num_objects=30,
                       num_attrs=20, vocab_size=2000, hidden_dropout=0.0, attention_dropout=0.0)
    host = lxmert_train_batch(8, cfg, seed=5)  # 11 MLM labels survive the sentence swap
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_small_pretrain_") as logdir:
            for side, device in (("cpu", "cpu"), ("gpu", dev)):
                exp = lxmert_experiment(LxmertPretrainExperiment, cfg, os.path.join(logdir, side), [host], 1e-3,
                                        device=device, **PRETRAIN_TASKS)
                batch = next(iter(exp._device_batches([host])))  # each experiment's own generator, one seed
                exp.model.train()
                total, aux = exp.loss_fn(exp.model, batch)
                out[side] = {"total": float(total.detach()), **{k: float(v.detach()) for k, v in aux.items()}}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    check(set(out["cpu"]) == set(out["gpu"]) == {"total", "mlm_loss", "matched_loss", "feat_loss", "qa_loss"}
          and all(v > 0 for v in out["cpu"].values()), f"small pretraining terms {out}")
    err = max(abs(out["gpu"][k] - v) / max(abs(v), 1.0) for k, v in out["cpu"].items())
    print(f"small f32 LXMERT pretraining step, card vs CPU: losses {out['gpu']}, max err {err:.2e} (1e-5)")
    check(err <= 1e-5, "small LXMERT pretraining: card != CPU")


# ------------------------------------------------------ the int8 presets

INT8_TOL = 1e-4  # card vs CPU in f32 where no int8 rounding flip reached the output
INT8_FLIP = 1e-2  # one int8 step carried on, of the output's largest magnitude


class Int8Shapes:
    """Records the geometry of every int8 product the int8 layers run
    while ``recording()`` is open: each conv's map and kernel shapes,
    stride, padding, dilation and groups, and each dense product's (M, K,
    N). Wraps the names the layers call (``ops.int8.int8_conv2d`` and
    ``int8_matmul``); the products themselves are untouched."""

    def __init__(self):
        self.convs, self.dense = set(), set()

    def recording(self):
        from vltk_tpu_torch.ops import int8 as q8

        @contextlib.contextmanager
        def ctx():
            conv, mm = q8.int8_conv2d, q8.int8_matmul

            def conv_rec(x_q, w_q, stride=1, padding=0, dilation=1, groups=1, **kw):
                self.convs.add((tuple(x_q.shape), tuple(w_q.shape), stride, padding, dilation, groups))
                return conv(x_q, w_q, stride, padding, dilation, groups, **kw)

            def mm_rec(a, b):
                self.dense.add((a.shape[0], a.shape[1], b.shape[1]))
                return mm(a, b)

            q8.int8_conv2d, q8.int8_matmul = conv_rec, mm_rec
            try:
                yield
            finally:
                q8.int8_conv2d, q8.int8_matmul = conv, mm

        return ctx()


def int8_agreement(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Card vs CPU on an int8 model in f32: within INT8_TOL but where a
    float difference moved an activation across an int8 rounding boundary
    (at most a third of the elements, within INT8_FLIP of the output's
    scale). Returns the largest difference."""
    got, want = got.float().cpu(), want.float().cpu()
    off = ~torch.isclose(got, want, rtol=INT8_TOL, atol=INT8_TOL)
    err = float((got - want).abs().max())
    check(float(off.float().mean()) <= 1 / 3 and err <= INT8_FLIP * float(want.abs().max()),
          f"{what}: card != CPU ({int(off.sum())} of {off.numel()} off, max {err:.3e})")
    return err


def box_agreement(ref: torch.Tensor, got: torch.Tensor):
    """bench.py's preset-drift measures of a packed (B, 36, 2054) output
    against the parity one: the share of parity boxes matched by a box at
    IoU >= 0.5, and the mean cosine of the matched features."""
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    dim = ref.shape[-1] - 6
    ious, cos = [], []
    for b in range(ref.shape[0]):
        rb, gb = ref[b, :, dim:dim + 4], got[b, :, dim:dim + 4]
        rmask, gmask = ref[b, :, -2] >= 0, got[b, :, -2] >= 0
        for i in np.nonzero(rmask)[0]:
            a = rb[i]
            lt, rt = np.maximum(a[None, :2], gb[:, :2]), np.minimum(a[None, 2:], gb[:, 2:])
            inter = np.prod(np.clip(rt - lt, 0, None), axis=1)
            union = np.prod(np.clip(a[2:] - a[:2], 0, None)) + np.prod(np.clip(gb[:, 2:] - gb[:, :2], 0, None), 1) - inter
            iou = np.where(gmask, inter / (union + 1e-9), -1.0)
            j = int(np.argmax(iou))
            ious.append(max(iou[j], 0.0))
            if iou[j] >= 0.5:
                fa, fb = ref[b, i, :dim], got[b, j, :dim]
                cos.append(float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb) + 1e-9)))
    return float(np.mean(np.array(ious) >= 0.5)), float(np.mean(cos)) if cos else 0.0


def check_int8_scales(scales, model, what: str) -> None:
    from vltk_tpu_torch.models.layers import int8_layers

    check(scales is not None and set(scales) == set(int8_layers(model)),
          f"{what}: scales not recorded for every int8 layer")
    vals = torch.stack([v.float().cpu() for v in scales.values()])
    check(bool(torch.isfinite(vals).all() and (vals >= 0).all() and (vals > 0).float().mean() > 0.5),
          f"{what}: scales not finite and positive: {vals.min()} .. {vals.max()}")


def scales_reused(scales, model) -> bool:
    """The model's int8 layers still hold the very tensors of ``scales``."""
    from vltk_tpu_torch.models.layers import int8_scales

    now = int8_scales(model)
    return set(now) == set(scales) and all(now[k] is v for k, v in scales.items())


def phase_int8_extraction(dev, parity, parity_runs, wrappers, smi: str, shapes: Int8Shapes) -> dict:
    """``setup(preset="production")`` (int8_300) at full width on the parity
    canvas, on the parity bundle's tamed weights: the first batch
    calibrates (its first 4 images, unchunked) before the step runs; K1 and
    K2 launched on the vector path; the scales finite, positive and reused;
    images/s, step ms, peak beside parity_300's and the agreement with
    parity_300's boxes and features (reported, not gated)."""
    from vltk_tpu_torch.adapters.frcnn import setup
    from vltk_tpu_torch.models.frcnn import FRCNNConfig

    bundle, info = setup(preset="production", batch_size=8, device=dev, resized_canvas=CANVAS, short=800.0,
                         maximum=1333.0)
    cfg = bundle["cfg"]
    check(cfg == FRCNNConfig.named_preset("int8_300") and cfg.int8 and info["preset"] == "production",
          f"production is not int8_300: {cfg}")
    bundle["model"].load_state_dict(parity["model"].state_dict())  # the parity run's tamed weights
    raw, sizes = step_images(dev, 8)
    for w in wrappers.values():
        w.launches = 0
    with shapes.recording():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = bundle["step"](raw, sizes)  # calibrates on raw[:4], then steps
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        calib = {name: w.launches for name, w in wrappers.items()}
        scales = bundle["int8_scales"]
        check_int8_scales(scales, bundle["model"], "int8_300 extraction")
        # the calibration (one unchunked forward of 4 images) and the step
        check(calib["roi_pool"] == 2 and calib["nms"] == 4, f"first int8 step's launches {calib}")
        runs = {}
        for batch, steps in ((8, 5), (16, 3)):
            torch.cuda.reset_peak_memory_stats()
            runs[batch] = r = run_extraction(bundle, batch, steps, wrappers)
            check(bundle["int8_scales"] is scales and scales_reused(scales, bundle["model"]),
                  f"int8 scales were not reused at B={batch}")
            p = parity_runs[batch]
            print(
                f"extraction int8_300 (production) B={batch} canvas {CANVAS[0]}x{CANVAS[1]}: "
                f"{r['images_per_s']:.2f} images/s ({r['step_ms']:.2f} ms/step), peak {r['peak_mem_gb']:.2f} GB; "
                f"parity_300 in this run {p['images_per_s']:.2f} images/s ({p['step_ms']:.2f} ms/step), "
                f"peak {p['peak_mem_gb']:.2f} GB; launches {r['launches']} over {steps + 1} steps on {smi}"
            )
    with torch.inference_mode():
        ref = parity["step"](raw, sizes)
        got = bundle["step"](raw, sizes)
    check(torch.equal(got, first), "the calibrated first step and a later one differ on the same batch")
    agree, cosine = box_agreement(ref, got)
    print(f"int8_300 vs parity_300 on the B=8 batch (tamed random weights, reported only): box agreement "
          f"@IoU0.5 {agree:.4f}, mean matched feature cosine {cosine:.6f}; first step with calibration "
          f"{first_s:.3f} s; {len(scales)} int8 layers calibrated")
    return {"runs": runs, "calibration_launches": calib, "box_agreement": agree, "feature_cosine": cosine,
            "first_step_s": first_s, "layers": len(scales)}


def phase_int8_vqa(dev, wrappers, smi: str, bf16_timed: dict, shapes: Int8Shapes) -> dict:
    """VQAPredictor with the int8_300 FRCNN and LXMERT-base int8 (the JAX
    bench's composed row): the first request records both scale sets, then
    three requests reuse them with K1 3, K2 6, K3 0 launches; the padded
    bucket's real rows equal the full bucket's; samples/s beside bf16's."""
    from vltk_tpu_torch.trace import build_vqa

    pred = build_vqa(8, dev, int8=True)
    fc, lc = pred.frcnn_config, pred.lxmert_config
    check(fc.int8 and lc.int8 and (fc.post_nms_topk, lc.l_layers, lc.hidden_size, lc.dtype) == (300, 9, 768, "bfloat16"),
          f"int8 VQA configs {fc} {lc}")
    requests = vqa_requests(np.random.default_rng(0))
    check(pred.frcnn_scales is None and pred.lxmert_scales is None, "int8 VQA scales before the first request")
    with shapes.recording():
        pred(*requests[0])  # the first request: calibrates both models on its first 4 rows
        fs, ls = pred.frcnn_scales, pred.lxmert_scales
        check_int8_scales(fs, pred.frcnn, "int8 VQA FRCNN")
        check_int8_scales(ls, pred.lxmert, "int8 VQA LXMERT")
        for w in wrappers.values():
            w.launches = 0
        paths = wrappers["roi_pool"].path_launches
        paths.update(dict.fromkeys(paths, 0))
        answers = [pred(images, questions) for images, questions in requests]
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        paths = dict(paths)
    check(pred.frcnn_scales is fs and pred.lxmert_scales is ls and scales_reused(fs, pred.frcnn)
          and scales_reused(ls, pred.lxmert), "int8 VQA scales were not reused")
    check(launches["roi_pool"] == 3 and paths["scalar"] == 0 and launches["nms"] == 6,
          f"int8 VQA launches {launches} ({paths}) over 3 buckets")
    others = {k: v for k, v in launches.items() if k not in ("roi_pool", "nms")}
    check(not any(others.values()), f"other kernels launched on the int8 VQA path: {others}")
    for (images, _), results in zip(requests, answers):
        check_vqa_results(images, results)
    pad = differing(answers[2], answers[0][:5])
    check(pad["boxes"] == 0 and pad["object_ids"] == 0 and pad["top1"] == 0 and pad["max_score_diff"] == 0.0,
          f"int8 padded bucket's real rows differ from the full bucket's: {pad}")
    timed = time_vqa_step(pred, dev, steps=5)
    print(
        f"VQA int8 (int8_300 + LXMERT-base int8) B=8: {timed['samples_per_s']:.2f} samples/s "
        f"({timed['step_ms']:.3f} ms/step), FRCNN alone {timed['frcnn_ms']:.3f} ms, LXMERT by difference "
        f"{timed['lxmert_ms_by_difference']:.3f} ms, peak {timed['step_peak_mem_gb']:.2f} GB; bf16 in this run "
        f"{bf16_timed['samples_per_s']:.2f} samples/s ({bf16_timed['step_ms']:.3f} ms/step); launches {launches} "
        f"over 3 buckets; padded bucket equal to the full one; on {smi}"
    )
    return {"launches": launches, "timed": timed, "padded_vs_full": pad, "layers": [len(fs), len(ls)]}


def phase_int8_document(dev, wrappers, smi: str, doc_timed: dict, span_timed: dict, shapes: Int8Shapes) -> dict:
    """DocTokenClassifier and DocSpanQA at LayoutLM-base int8, seq 1024 on
    K3, B=32: the first request calibrates (its first 4 documents), a
    second runs K3 12 times a forward; documents/s and questions/s beside
    bf16's; the int8 and bf16 classifiers' labels compared (reported)."""
    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocSpanQA, DocTokenClassifier
    from vltk_tpu_torch.trace import bench_documents

    cfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=DOC_SEQ, int8=True)
    clf = DocTokenClassifier(DOC_LABELS, config=cfg, batch_size=32, max_seq_length=DOC_SEQ, device=dev)
    with open(V.VOCABPATH) as f:
        vocab_words = [w for w in f.read().split("\n") if w.isascii() and w.isalpha()]
    rng = np.random.default_rng(2)
    docs = synthetic_documents(rng, vocab_words, ([c for counts in DOC_REQUESTS for c in counts] * 3)[:32])
    out = {}
    with shapes.recording():
        clf(docs)  # calibrates on the first 4 documents of the bucket
        check_int8_scales(clf.int8_scales, clf.model, "int8 LayoutLM")
        scales = clf.int8_scales
        for w in wrappers.values():
            w.launches = 0
        labelled = clf(docs)
        launches = {name: w.launches for name, w in wrappers.items()}
        check(launches["flash_attention"] == 12 and sum(launches.values()) == 12,
              f"int8 document request: launches {launches} over one forward")
        check(clf.int8_scales is scales and scales_reused(scales, clf.model), "int8 LayoutLM scales were not reused")
        for doc, res in zip(docs, labelled):
            check(len(res) == words_within_budget(clf.tokenizer, doc["words"]), "int8 document: words labelled")
        ids, boxes, mask = bench_documents(32, cfg.vocab_size, dev)
        docs_s, step_ms, peak = time_doc_step(clf, ids, boxes, mask, steps=5)
        bf16 = DocTokenClassifier(DOC_LABELS, params=clf.model.state_dict(), config=LayoutLMConfig(
            dtype="bfloat16", max_position_embeddings=DOC_SEQ), batch_size=32, max_seq_length=DOC_SEQ, device=dev,
            tokenizer=clf.tokenizer)
        with torch.inference_mode():
            p8, pb = clf.step(ids, boxes, mask), bf16.step(ids, boxes, mask)
        same = float((p8.argmax(-1) == pb.argmax(-1)).float().mean())
        dprob = float((p8 - pb).abs().max())
        del bf16
        out["documents"] = {"launches": launches, "documents_per_s": docs_s, "step_ms": step_ms, "peak_mem_gb": peak,
                            "label_agreement_vs_bf16": same, "max_dprob_vs_bf16": dprob}
        b = doc_timed["auto"]
        print(f"LayoutLM-base int8 doc step B=32 seq {DOC_SEQ} on K3: {docs_s:.2f} documents/s ({step_ms:.3f} ms/step),"
              f" peak {peak:.2f} GB; bf16 in this run {b['documents_per_s']:.2f} documents/s ({b['step_ms']:.3f} "
              f"ms/step); labels equal to bf16's {same:.4f}, max |dprob| {dprob:.3e} (reported); launches "
              f"{launches} a request; on {smi}")
        del clf
        torch.cuda.empty_cache()

        scfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=SPAN_Q + SPAN_DOC, int8=True)
        qa = DocSpanQA(config=scfg, batch_size=SPAN_BATCH, question_len=SPAN_Q, doc_len=SPAN_DOC, device=dev)
        pages = synthetic_documents(rng, vocab_words, rng.integers(200, 1500, SPAN_BATCH))
        questions = span_questions(rng, vocab_words, SPAN_BATCH)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = qa(pages, questions)  # one request: calibration forward (4 rows), then the bucket
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        check(launches["flash_attention"] == 24 and sum(launches.values()) == 24,
              f"int8 span request: launches {launches} (12 calibrating + 12 serving)")
        check_span_answers(pages, results)
        check_int8_scales(qa.int8_scales, qa.model, "int8 span QA")
        (ids, boxes, mask), _, _, _ = qa.prepare(pages, questions)
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        ids, boxes, mask = put(ids), put(boxes), put(mask)
        qa.step(ids, boxes, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            s_lp, _ = qa.step(ids, boxes, mask)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        check(bool(torch.isfinite(s_lp).all()), "int8 span step output is not finite")
        out["span"] = {"launches": launches, "request_s": request_s, "questions_per_s": SPAN_BATCH * 1e3 / step_ms,
                       "step_ms": step_ms, "request_questions_per_s": SPAN_BATCH / request_s}
        b = span_timed["auto"]
        print(f"DocSpanQA int8 B={SPAN_BATCH} seq {SPAN_Q + SPAN_DOC}: one request {request_s:.3f} s with calibration "
              f"and host decode; step {step_ms:.3f} ms ({SPAN_BATCH * 1e3 / step_ms:.2f} questions/s); bf16 step in "
              f"this run {b['step_ms']:.3f} ms ({b['questions_per_s']:.2f} questions/s); launches {launches}")
        del qa
        torch.cuda.empty_cache()
    return out


def phase_small_int8(dev) -> None:
    """Tiny int8 FRCNN, LXMERT and LayoutLM in f32 on the card against the
    CPU with the same (CPU-calibrated) scales: the int8 products are exact
    on both, so only the float glue differs (TF32 off)."""
    from vltk_tpu_torch.models import FRCNN, FRCNNConfig, init_weights
    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.frcnn import calibrate_int8
    from vltk_tpu_torch.models.layers import calibrate_int8_scales, load_int8_scales
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification

    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(3)
    fcfg = FRCNNConfig(depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4,
                       rpn_hidden_channels=16, anchor_sizes=(16, 32), pre_nms_topk=64, post_nms_topk=16,
                       num_classes=7, num_attrs=5, pooler_resolution=7, min_detections=4, max_detections=4, int8=True)
    lcfg = PX.LxmertConfig(hidden_size=48, num_heads=2, intermediate_size=96, l_layers=2, x_layers=1, r_layers=1,
                           max_position_embeddings=32, visual_feat_dim=128, num_answers=5, int8=True)
    dcfg = LayoutLMConfig(vocab_size=1000, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
                          max_position_embeddings=64, int8=True)
    images = torch.rand(2, 64, 64, 3, generator=gen) * 100 - 50
    sizes = torch.tensor([[64.0, 64.0], [48.0, 56.0]])
    ids = torch.from_numpy(rng.integers(0, 1000, (3, 64)))
    vis = (torch.from_numpy(rng.integers(0, 1000, (3, 12))), torch.randn(3, 6, 128, generator=gen),
           torch.rand(3, 6, 4, generator=gen), torch.ones(3, 12), torch.ones(3, 6))
    doc = (ids, torch.from_numpy(np.sort(rng.integers(0, 1000, (3, 64, 2, 2)), axis=2).reshape(3, 64, 4)),
           torch.ones(3, 64))
    cases = (
        ("FRCNN", FRCNN(fcfg), lambda m: init_weights(m, seed=3),
         lambda m: calibrate_int8(m, [(images, sizes)]), (images, sizes)),
        ("LXMERT", PX.LxmertForVQA(lcfg), lambda m: PX.init_weights(m, seed=3),
         lambda m: calibrate_int8_scales(m, [vis]), vis),
        ("LayoutLM", LayoutLMForTokenClassification(dcfg), lambda m: PX.init_weights(m, seed=3),
         lambda m: calibrate_int8_scales(m, [doc]), doc),
    )
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, cpu, init, calibrate, inputs in cases:
            cpu = init(cpu.eval())
            scales = calibrate(cpu)
            gpu = type(cpu)(cpu.cfg).eval()
            gpu.load_state_dict(cpu.state_dict())
            gpu.to(dev)
            load_int8_scales(gpu, scales)
            with torch.inference_mode():
                want = cpu(*inputs)
                got = gpu(*(x.to(dev) for x in inputs))
            if name == "FRCNN":
                for key in ("obj_ids", "attr_ids", "mask"):
                    check(torch.equal(got[key].cpu(), want[key]), f"small int8 FRCNN {key}: card != CPU")
                err = max(int8_agreement(got[k], want[k], f"small int8 FRCNN {k}")
                          for k in ("boxes", "obj_probs", "roi_features"))
            else:
                err = int8_agreement(got, want, f"small int8 {name}")
            print(f"small f32 int8 {name} card vs CPU, the same {len(scales)} scales: max_abs_err={err:.3e} "
                  f"(1e-4, or 1e-2 of the output's scale where an int8 rounding flip reached it)")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_int8_products(dev, shapes: Int8Shapes) -> dict:
    """The int8 products on the card (``torch._int_mm`` behind im2col)
    against the exact route on the card, bitwise, at every conv geometry
    and dense (M, K, N) the int8 paths above ran, with random int8
    operands; also an M <= 16 product (padded rows), K and N off a multiple
    of 8, and a NaN in an activation (quantized to 0 on the card as on the
    CPU)."""
    from vltk_tpu_torch.ops import int8 as q8

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    t0 = time.perf_counter()
    for x_shape, w_shape, stride, padding, dilation, groups in sorted(shapes.convs):
        x, w = rand(x_shape), rand(w_shape)
        got = q8.int8_conv2d(x, w, stride, padding, dilation, groups)
        want = q8.int8_conv2d(x, w, stride, padding, dilation, groups, matmul=q8.int8_matmul_exact)
        check(torch.equal(got, want), f"int8 conv {x_shape} x {w_shape} s{stride} p{padding} d{dilation}: card != exact")
        del x, w, got, want
    dense = sorted(shapes.dense | {(8, 768, 768), (33, 12, 20)})
    for m, k, n in dense:
        a, b = rand((m, k)), rand((n, k)).t()
        check(torch.equal(q8.int8_matmul(a, b), q8.int8_matmul_exact(a, b)), f"int8 product {(m, k, n)}: card != exact")
    torch.cuda.synchronize()
    x = torch.randn((4096, 768), device=dev, dtype=torch.bfloat16)
    x[5, 7] = float("nan")
    q_card, _ = q8.quantize_per_tensor(x, torch.tensor(3.0, device=dev))
    q_cpu, _ = q8.quantize_per_tensor(x.cpu(), torch.tensor(3.0))
    check(torch.equal(q_card.cpu(), q_cpu) and int(q_card[5, 7]) == 0, "int8 quantize on the card != CPU (NaN -> 0)")
    secs = time.perf_counter() - t0
    print(f"int8 products, card route (torch._int_mm) vs exact route on the card: {len(shapes.convs)} conv geometries "
          f"and {len(dense)} dense (M, K, N) bitwise equal (M from {min(d[0] for d in dense)}); NaN -> 0 as on the "
          f"CPU; {secs:.1f} s")
    return {"convs": len(shapes.convs), "dense": len(dense), "seconds": secs}


def phase_probe_int8_and_stem(dev, parity, smi: str) -> dict:
    """``tools.probe_int8`` at roi_chunk RoIs (bf16 against int8 for each
    res5 conv, int8 split into quantize / product / rescale), and the s2d
    stem against the plain stem: f32 to 1e-5 of the output's scale (TF32
    off), both timed in bf16 at B=8 on the parity canvas."""
    from vltk_tpu_torch.models.layers import StemConvNorm
    from vltk_tpu_torch.tools import probe_int8
    from vltk_tpu_torch.tools.variants import queued_ms

    probe = probe_int8.run(dev, rois=2400, reps=5)
    check(all(r["int8_equals_exact"] for r in probe["convs"]), "probe_int8: card product != exact")
    raw, sizes = step_images(dev, 8)
    with torch.inference_mode():
        pre = parity["pre_fn"](raw, sizes)
        x = pre["img"].permute(0, 3, 1, 2)
        sd = parity["model"].backbone.stem.conv1.state_dict()
        stems = {}
        for s2d in (False, True):
            for dtype in (None, torch.bfloat16):
                stem = StemConvNorm(3, 64, dtype=dtype, use_s2d=s2d).eval()
                stem.load_state_dict(sd)
                stems[s2d, dtype] = stem.to(dev)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            want, got = stems[False, None](x), stems[True, None](x)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * scale, f"s2d stem != plain stem in f32: {err:.3e} of {scale:.3e}")
        plain_ms = queued_ms(lambda: stems[False, torch.bfloat16](x), 10)
        s2d_ms = queued_ms(lambda: stems[True, torch.bfloat16](x), 10)
    print(f"stem at B=8 on {CANVAS[0]}x{CANVAS[1]}: s2d vs plain in f32 max_abs_err {err:.3e} (1e-5 of {scale:.3e}); "
          f"bf16 plain {plain_ms:.3f} ms, s2d {s2d_ms:.3f} ms on {smi}")
    return {"probe": probe, "stem": {"f32_max_abs_err": err, "plain_ms": plain_ms, "s2d_ms": s2d_ms}}


# ------------------------------------- ViT, VisualBERT, the MoE block, the server

VIT_SHAPE = (64, 197, 12, 64)  # (n, s, nh, dh) of ViT-B/16's self-attention at B=64: bench.py --infer vit
VIT_STEPS = 10
# pooled outputs, K3 route against the dense route, bf16: the residual
# stream is bf16, so one rounding of the probabilities that differs between
# the routes can flip the stream's rounding (2^-7 at |x| ~ 1) in any of 24
# residual adds
VIT_ROUTE_TOL = 2.0 ** -4
VB_BATCH = 32
# classification logits, K3 route against the dense route, bf16 compute on
# a float32 residual stream: the probabilities round differently
VB_ROUTE_TOL = 2.0 ** -6
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25
# LXMERT-base's widths at a cut depth: at 9 / 5 / 5 layers (1.0 B
# parameters) the build and the epoch took ~56 s of the script
MOE_LAYERS = dict(l_layers=3, x_layers=2, r_layers=2)
SERVER_BATCH = 4
SERVER_WAIT_S = 600  # every wait of the server phase ends by then


def time_forward(fn, batch: int, steps: int):
    """(items/s, ms a step, peak GB) of ``fn()`` under inference mode over
    ``steps`` calls after a warm-up, host clock around synchronised work."""
    with torch.inference_mode():
        out = fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs = out if isinstance(out, tuple) else (out,)
    check(all(bool(torch.isfinite(o).all()) for o in outs), "timed forward: output not finite")
    return batch * steps / dt, dt / steps * 1e3, torch.cuda.max_memory_allocated() / 1e9


def counted(wrappers, fn):
    """``fn()`` under inference mode with every launch count set to 0 just
    before; returns its output and the counts read just after."""
    for w in wrappers.values():
        w.launches = 0
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def k3_at(label: str, shape, mask, gen, dev) -> dict:
    """K3 at one model's attention shape (random bf16 q, k, v): held against
    its plain version at every position (FLASH_TOL), two calls bitwise
    equal; timed (median of five readings queued ahead) beside the plain
    version and ``scaled_dot_product_attention`` computing the same
    function (no mask where every key is real, else the boolean mask of
    equal ids). The bound counts the s^2 (query, key) pairs of a row and
    head without a mask (ViT: 197^2, the function SDPA computes), else
    every pair whose ids match, the pad tail to 128 included."""
    from vltk_tpu_torch.ops.flash_attention import flash_self_attention
    from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_cuda

    n, s, nh, dh = shape
    q, k, v = (torch.randn(n, s, nh, dh, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    got = flash_attention_cuda(q, k, v, mask, dh)
    again = flash_attention_cuda(q, k, v, mask, dh)
    want = flash_self_attention(q, k, v, mask, dh)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    print(f"flash_attention at the {label} shape {tuple(shape)} bf16 mask={'None' if mask is None else 'ids'}: "
          f"max_abs_err={err} (tol {FLASH_TOL[torch.bfloat16]}); bitwise repeatable {bitwise_equal(got, again)}")
    check(bool(torch.isfinite(got).all()) and err <= FLASH_TOL[torch.bfloat16], f"K3 != plain at the {label} shape")
    check(bitwise_equal(got, again), f"K3 not deterministic at the {label} shape")
    runs = spread_ms(lambda: flash_attention_cuda(q, k, v, mask, dh))
    plain_ms = cuda_ms(lambda: flash_self_attention(q, k, v, mask, dh), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if mask is None:
        sdpa_runs = spread_ms(lambda: sdpa(qt, kt, vt))
        nbytes, nops = 4 * n * s * nh * dh * 2, 4 * dh * nh * n * s * s
    else:
        ids = mask.to(torch.int32)
        same = ids[:, None, :, None] == ids[:, None, None, :]
        sdpa_runs = spread_ms(lambda: sdpa(qt, kt, vt, attn_mask=same))
        nbytes, nops = flash_work(ids, nh, dh, 2)
    bound_ms, bound_by = bound(nbytes, nops, BF16_OPS_PER_S)
    print(f"flash_attention timing at the {label} shape: kernel {show(runs)}, plain {plain_ms:.4f} ms, SDPA "
          f"{'without a mask' if mask is None else 'with the boolean mask'} {show(sdpa_runs)}, bound {bound_ms:.4f} ms "
          f"({bound_by}: {nops:.3e} operations, {nbytes:.3e} bytes), {runs[2] / bound_ms:.2f}x the bound, "
          f"{sdpa_runs[2] / runs[2]:.2f}x SDPA's time")
    return {"shape": list(shape), "max_abs_err": err, "ms": runs[2], "ms_range": [runs[0], runs[-1]],
            "plain_ms": plain_ms, "library_ms": sdpa_runs[2], "bound_ms": bound_ms, "bound_by": bound_by}


def phase_vit(dev, wrappers, smi: str, shapes: "Int8Shapes") -> dict:
    """ViT-B/16 at 224, bf16, B=64 (bench.py --infer vit): the K3 route
    ("flash": 12 launches a forward, nothing else), the dense route and
    int8 (calibrated on the first 8 images, as bench.py), the pooled
    outputs of the two float routes against each other, images/s of each;
    then K3 at (64, 197, 12, 64) with no mask against its plain version,
    timed beside SDPA without a mask."""
    import dataclasses

    from vltk_tpu_torch.models.layers import calibrate_int8_scales
    from vltk_tpu_torch.models.vit import ViT
    from vltk_tpu_torch.trace import VIT_BATCH, build_vit

    flash, images = build_vit(VIT_BATCH, "flash", device=dev)
    cfg = flash.cfg
    check((cfg.hidden_size, cfg.num_heads, cfg.num_layers, cfg.intermediate_size, cfg.image_size, cfg.patch_size,
           cfg.num_patches, cfg.dtype) == (768, 12, 12, 3072, 224, 16, 196, "bfloat16"), f"ViT-B/16 config {cfg}")
    models = {"flash": flash}
    for name, over in (("xla", {}), ("int8", {"int8": True})):
        models[name] = ViT(dataclasses.replace(cfg, attention_impl="xla", **over)).to(dev).eval()
        models[name].load_state_dict(flash.state_dict())
    outs, launches = {}, {}
    for name in ("flash", "xla"):
        outs[name], launches[name] = counted(wrappers, lambda: models[name](images))
    check(launches["flash"]["flash_attention"] == cfg.num_layers and sum(launches["flash"].values()) == cfg.num_layers,
          f"ViT flash route launches {launches['flash']}")
    check(not any(launches["xla"].values()), f"kernels on ViT's dense route: {launches['xla']}")
    with shapes.recording():
        scales = calibrate_int8_scales(models["int8"], [(images[:8],)])
        outs["int8"], launches["int8"] = counted(wrappers, lambda: models["int8"](images))
    check(len(scales) == 6 * cfg.num_layers and all(bool(torch.isfinite(s) and s > 0) for s in scales.values()),
          "ViT int8 scales")
    for name, (seq, pooled) in outs.items():
        check(seq.shape == (VIT_BATCH, 197, 768) and pooled.shape == (VIT_BATCH, 768) and seq.dtype == torch.float32
              and bool(torch.isfinite(seq).all() and torch.isfinite(pooled).all()), f"ViT {name} outputs")
    route_err = float((outs["flash"][1] - outs["xla"][1]).abs().max())
    route_rel = float((outs["flash"][1] - outs["xla"][1]).norm() / outs["xla"][1].norm())
    seq_err = float((outs["flash"][0] - outs["xla"][0]).abs().max())
    int8_err = float((outs["int8"][1] - outs["xla"][1]).abs().max())
    print(f"ViT-B/16 B={VIT_BATCH} bf16: pooled, K3 route vs dense route max |d| = {route_err:.3e} "
          f"(tol {VIT_ROUTE_TOL}; relative L2 {route_rel:.3e}; sequence {seq_err:.3e}); int8 vs dense {int8_err:.3e} "
          f"(reported); "
          f"launches flash {launches['flash']['flash_attention']}, int8 {launches['int8']['flash_attention']}")
    check(route_err <= VIT_ROUTE_TOL, "ViT: K3 route != dense route")
    timed = {}
    for name in ("xla", "flash", "int8"):
        images_s, step_ms, peak = time_forward(lambda: models[name](images), VIT_BATCH, VIT_STEPS)
        timed[name] = {"images_per_s": images_s, "step_ms": step_ms, "peak_mem_gb": peak}
        print(f"ViT-B/16 224 B={VIT_BATCH} bf16 {name}: {images_s:.2f} images/s ({step_ms:.3f} ms/step over "
              f"{VIT_STEPS} steps) on {smi}; peak {peak:.2f} GB")
    del models, outs
    torch.cuda.empty_cache()
    k3 = k3_at("ViT", VIT_SHAPE, None, torch.Generator().manual_seed(15), dev)
    return {"launches": launches["flash"], "launches_by_route": launches, "route_err": route_err, "route_rel": route_rel,
            "int8_vs_dense": int8_err, "timed": timed, "k3": k3}


def phase_visualbert(dev, wrappers, smi: str) -> dict:
    """VisualBERT at visualbert-vqa width (12 layers, 768, 2048-d regions),
    bf16, B=32: 128 text tokens of varied real length and 36 regions (164
    positions, padded to 256 by K3; the text pad is a hole in mid-stream);
    the K3 route (12 launches a forward, nothing else) against the dense
    route on the classification logits; both timed; K3 at this shape with
    its mask against its plain version, timed beside SDPA with the boolean
    mask."""
    import dataclasses

    from vltk_tpu_torch.models.visualbert import VisualBertForClassification
    from vltk_tpu_torch.trace import VB_REGIONS, VB_TEXT, build_visualbert

    flash, (ids, feats, tmask, vmask) = build_visualbert(VB_BATCH, "flash", device=dev)
    cfg = flash.cfg
    check((cfg.l_layers, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.visual_feat_dim, cfg.vocab_size,
           cfg.dtype) == (12, 768, 12, 3072, 2048, 30522, "bfloat16"), f"VisualBERT config {cfg}")
    check(bool((tmask == 0).any()) and int(tmask.sum(1).min()) < VB_TEXT, "no text pad hole in the VisualBERT rows")
    dense = VisualBertForClassification(dataclasses.replace(cfg, attention_impl="xla")).to(dev).eval()
    dense.load_state_dict(flash.state_dict())
    models = {"flash": flash, "xla": dense}
    logits, launches = {}, {}
    for name, model in models.items():
        logits[name], launches[name] = counted(wrappers, lambda: model(ids, feats, None, tmask, vmask))
        check(logits[name].shape == (VB_BATCH, 2) and bool(torch.isfinite(logits[name]).all()),
              f"VisualBERT {name} logits")
    check(launches["flash"]["flash_attention"] == cfg.l_layers and sum(launches["flash"].values()) == cfg.l_layers,
          f"VisualBERT flash route launches {launches['flash']}")
    check(not any(launches["xla"].values()), f"kernels on VisualBERT's dense route: {launches['xla']}")
    err = float((logits["flash"] - logits["xla"]).abs().max())
    print(f"VisualBERT B={VB_BATCH} ({VB_TEXT} text of {int(tmask.sum(1).min())}-{int(tmask.sum(1).max())} real + "
          f"{VB_REGIONS} regions) bf16: logits, K3 route vs dense route max |d| = {err:.3e} (tol {VB_ROUTE_TOL})")
    check(err <= VB_ROUTE_TOL, "VisualBERT: K3 route != dense route")
    timed = {}
    for name, model in models.items():
        samples_s, step_ms, peak = time_forward(lambda: model(ids, feats, None, tmask, vmask), VB_BATCH, 10)
        timed[name] = {"samples_per_s": samples_s, "step_ms": step_ms, "peak_mem_gb": peak}
        print(f"VisualBERT B={VB_BATCH} bf16 {name}: {samples_s:.2f} samples/s ({step_ms:.3f} ms/step over 10 steps) "
              f"on {smi}; peak {peak:.2f} GB")
    mask = torch.cat([tmask, vmask], dim=1)
    del models, dense, flash
    torch.cuda.empty_cache()
    k3 = k3_at("VisualBERT", (VB_BATCH, VB_TEXT + VB_REGIONS, 12, 64), mask, torch.Generator().manual_seed(16), dev)
    return {"launches": launches["flash"], "route_err": err, "timed": timed, "k3": k3}


def phase_moe(dev, wrappers, smi: str) -> dict:
    """LXMERT-base's widths at ``MOE_LAYERS``' depth with the MoE
    feed-forward (8 experts, top 2, capacity factor 1.25) in all 9 of its
    feed-forward sites, bf16, B=32, 20 tokens and 36 boxes: a forward whose
    9 aux terms are finite and positive and
    logits finite, then ``LxmertVQAExperiment`` for an epoch of 4 steps
    (finite losses, no kernel: the streams are below the flash gate), the
    step timed with its peak memory."""
    import tempfile

    from vltk_tpu_torch.experiments import LxmertVQAExperiment
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.models.moe import moe_aux_losses

    cfg = LxmertConfig(dtype="bfloat16", moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                       moe_capacity_factor=MOE_CAPACITY, **MOE_LAYERS)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_moe_") as logdir:
        host = [lxmert_train_batch(LXMERT_TRAIN_BATCH, cfg, seed=i) for i in range(LXMERT_TRAIN_STEPS)]
        t0 = time.perf_counter()
        exp = lxmert_experiment(LxmertVQAExperiment, cfg, logdir, host, 1e-5, device=dev)
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in exp.model.parameters())
        check(3e8 < n_params < 5e8, f"MoE LXMERT has {n_params} parameters")
        data = next(iter(exp._device_batches([host[0]])))
        exp.model.eval()
        logits, launches = counted(wrappers, lambda: exp._logits(exp.model, data))
        aux = moe_aux_losses(exp.model)
        exp.model.train()
        check(len(aux) == cfg.l_layers + cfg.r_layers + 2 * cfg.x_layers == 9, f"{len(aux)} MoE aux terms")
        check(all(bool(torch.isfinite(v) and v > 0) for v in aux.values()), "MoE aux terms not finite and positive")
        check(bool(torch.isfinite(logits).all()) and logits.shape == (LXMERT_TRAIN_BATCH, cfg.num_answers),
              "MoE LXMERT logits")
        check(not any(launches.values()), f"kernels on the MoE LXMERT forward: {launches}")
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        exp()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {k: w.launches for k, w in wrappers.items()}
        check(not any(train_launches.values()), f"kernels on the MoE LXMERT training path: {train_launches}")
        with open(os.path.join(exp.logdir, "steps_log.json")) as f:
            log = [json.loads(line) for line in f]
        check(len(log) == LXMERT_TRAIN_STEPS and all(np.isfinite(r["loss"]) for r in log), f"MoE losses {log}")
        samples_s, step_ms, peak = time_train_step(exp, host[0], batch=LXMERT_TRAIN_BATCH)
        aux_values = [float(v) for v in aux.values()]
        print(
            f"MoE LXMERT-base widths, {cfg.l_layers} / {cfg.x_layers} / {cfg.r_layers} layers ({MOE_EXPERTS} experts, "
            f"top {MOE_TOP_K}, capacity factor {MOE_CAPACITY}; {n_params / 1e9:.3f} B parameters, built in "
            f"{build_s:.1f} s) B={LXMERT_TRAIN_BATCH} bf16: {len(aux)} aux terms "
            f"{min(aux_values):.5f}-{max(aux_values):.5f}; {LXMERT_TRAIN_STEPS} training steps in {train_s:.2f} s, "
            f"losses {[round(r['loss'], 5) for r in log]}; no kernel launched; step {step_ms:.3f} ms, "
            f"{samples_s:.2f} samples/s over 5 steps on {smi}; peak {peak:.2f} GB"
        )
        del exp
    torch.cuda.empty_cache()
    return {"launches": train_launches, "parameters": n_params, "aux": aux_values, "losses": [r["loss"] for r in log],
            "samples_per_s": samples_s, "step_ms": step_ms, "peak_mem_gb": peak}


def phase_server(dev, wrappers, smi: str) -> dict:
    """``serving.for_doc`` in front of the card's LayoutLM-base
    ``DocTokenClassifier`` (seq 1024, batch 4): a burst of 2 x 4 + 3
    concurrent single documents from threads released together; every
    caller's labels and scores equal the same document in one direct
    batched call, K3 launched 12 times a bucket the server ran; latency
    percentiles. Every wait has a timeout."""
    import threading

    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocTokenClassifier
    from vltk_tpu_torch.serving import for_doc

    cfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=DOC_SEQ)
    clf = DocTokenClassifier(DOC_LABELS, config=cfg, batch_size=SERVER_BATCH, max_seq_length=DOC_SEQ, device=dev)
    with open(V.VOCABPATH) as f:
        vocab_words = [w for w in f.read().split("\n") if w.isascii() and w.isalpha()]
    rng = np.random.default_rng(15)
    docs = synthetic_documents(rng, vocab_words, rng.integers(5, 1500, 2 * SERVER_BATCH + 3).tolist())
    want = clf(docs)  # one direct call: three buckets
    results, errors = {}, []
    barrier = threading.Barrier(len(docs))

    def caller(i):
        try:
            barrier.wait(timeout=SERVER_WAIT_S)
            t0 = time.perf_counter()
            results[i] = (srv.submit(docs[i]).result(timeout=SERVER_WAIT_S), time.perf_counter() - t0)
        except Exception as exc:  # reported below: the phase fails
            errors.append(repr(exc))

    for w in wrappers.values():
        w.launches = 0
    srv = for_doc(clf, max_delay_ms=20)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=caller, args=(i,)) for i in range(len(docs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SERVER_WAIT_S)
    srv.close(timeout=SERVER_WAIT_S)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    check(not any(th.is_alive() for th in threads) and not errors, f"server callers: {errors}")
    stats = srv.stats
    check(len(results) == len(docs) and stats["requests_served"] == len(docs), f"server stats {stats}")
    check(all(results[i][0] == want[i] for i in range(len(docs))), "server answers != one direct batched call")
    check(launches["flash_attention"] == 12 * stats["batches_run"]
          and sum(launches.values()) == launches["flash_attention"], f"server launches {launches}, {stats}")
    print(f"for_doc server (LayoutLM-base seq {DOC_SEQ}, batch {SERVER_BATCH}): {len(docs)} concurrent single "
          f"documents in {stats['batches_run']} buckets, {burst_s:.3f} s, {len(docs) / burst_s:.2f} documents/s on "
          f"{smi}; latency ms {stats['latency_ms']}; slowest bucket {stats['slowest_batch_ms']} ms; answers equal to "
          f"one direct call; K3 launches {launches['flash_attention']}")
    return {"launches": launches, "stats": stats, "burst_s": burst_s, "requests": len(docs)}


def phase_small_encoders(dev) -> None:
    """Small f32 ViT, VisualBERT and MoE LXMERT on the card against the same
    models on the CPU (TF32 off). ViT: the K3 route on the card (145 tokens,
    no mask) against the dense route on the CPU; VisualBERT: the flash route
    forced on both sides (K3 and the plain version), real positions; MoE:
    logits and the 24 aux terms."""
    from vltk_tpu_torch.models import lxmert as PX
    from vltk_tpu_torch.models.moe import moe_aux_losses
    from vltk_tpu_torch.models.visualbert import VisualBert, VisualBertConfig
    from vltk_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights
    from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto
    from vltk_tpu_torch.trace import visualbert_inputs

    gate = PX._flash_applicable
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    try:
        vcfg = ViTConfig(hidden_size=128, num_heads=2, num_layers=2, intermediate_size=256, image_size=192,
                         attention_impl="flash")
        cpu = init_vit_weights(ViT(vcfg), seed=7).eval()
        gpu = ViT(vcfg).to(dev).eval()
        gpu.load_state_dict(cpu.state_dict())
        images = torch.from_numpy(np.random.default_rng(7).normal(size=(3, 192, 192, 3)).astype(np.float32))
        before = flash_attention_auto.launches
        with torch.inference_mode():
            want, got = cpu(images), gpu(images.to(dev))
        check(flash_attention_auto.launches - before == vcfg.num_layers, "small ViT did not run K3 in every layer")
        errs["vit"] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))

        bcfg = VisualBertConfig(vocab_size=2000, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
                                visual_feat_dim=64, attention_impl="flash")
        cpu = PX.init_weights(VisualBert(bcfg), seed=8).eval()
        gpu = VisualBert(bcfg).to(dev).eval()
        gpu.load_state_dict(cpu.state_dict())
        ids, feats, tmask, vmask = visualbert_inputs(3, bcfg, "cpu", seed=8)
        PX._flash_applicable = lambda s, det, drop, device: s >= 128 and (det or drop == 0.0)
        before = flash_attention_auto.launches
        with torch.inference_mode():
            want = cpu(ids, feats, None, tmask, vmask)
            got = gpu(ids.to(dev), feats.to(dev), None, tmask.to(dev), vmask.to(dev))
        PX._flash_applicable = gate
        check(flash_attention_auto.launches - before == bcfg.l_layers, "small VisualBERT did not run K3")
        real = torch.cat([tmask, vmask], 1).bool()
        errs["visualbert"] = max(float((got[0].cpu() - want[0])[real].abs().max()),
                                 float((got[1].cpu() - want[1]).abs().max()))

        mcfg = PX.LxmertConfig(vocab_size=2000, hidden_size=64, num_heads=2, intermediate_size=128, visual_feat_dim=32,
                               num_answers=10, moe_experts=4, moe_top_k=2)
        cpu = PX.init_weights(PX.LxmertForVQA(mcfg), seed=9).eval()
        gpu = PX.LxmertForVQA(mcfg).to(dev).eval()
        gpu.load_state_dict(cpu.state_dict())
        batch = lxmert_train_batch(4, mcfg, seed=9)
        ins = [torch.from_numpy(batch[k]) for k in ("input_ids", "features", "boxes", "text_attention_mask",
                                                      "boxes_mask")]
        ins[0], ins[2] = ins[0].long(), ins[2] / 1000.0
        with torch.inference_mode():
            want = cpu(*ins)
            want_aux = moe_aux_losses(cpu)
            got = gpu(*(x.to(dev) for x in ins)).cpu()
            got_aux = moe_aux_losses(gpu)
        check(list(want_aux) == list(got_aux) and len(got_aux) == 24, "small MoE LXMERT aux terms")
        errs["moe"] = float((got - want).abs().max())
        errs["moe_aux"] = max(abs(float(got_aux[k]) - float(v)) / float(v) for k, v in want_aux.items())
    finally:
        PX._flash_applicable = gate
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"small f32 encoders, card vs CPU: ViT (K3 vs dense) {errs['vit']:.2e}, VisualBERT (K3 vs plain flash, real "
          f"positions) {errs['visualbert']:.2e}, MoE LXMERT logits {errs['moe']:.2e} (1e-4 each), aux terms "
          f"{errs['moe_aux']:.2e} relative (1e-5)")
    check(max(errs["vit"], errs["visualbert"], errs["moe"]) <= 1e-4 and errs["moe_aux"] <= 1e-5,
          "small encoders: card != CPU")


# ------------------------------------------------------- the host data plane

DATA_IMAGES, DATA_QUESTIONS = 64, 512  # 8 questions an image, 4 answers of 128 each
DATA_EXTRACT_BATCH = 8
DATA_TRAIN_BATCH = 32  # 16 steps an epoch
DATA_CHECKED_IMAGES = 8


def check_stored_rows(cls, bundle, extracted, img_dir: str, dev) -> float:
    """The stored rows of the last ``DATA_CHECKED_IMAGES`` images of an
    extracted table against one direct call of the step on the same decoded
    batch (the pipeline adds nothing), bitwise; returns the step's ms on
    device-resident inputs (3 calls)."""
    from vltk_tpu_torch.adapters.frcnn import unpack

    decode = cls.default_processor.build()
    ids = sorted(extracted.img_to_row_map)[-DATA_CHECKED_IMAGES:]
    entries = []
    for imgid in ids:
        entry = decode(os.path.join(img_dir, imgid + ".jpg"))
        entry["imgid"] = imgid
        entries.append(entry)
    batch = cls.collate(entries)
    images, sizes = torch.from_numpy(batch["image"]).to(dev), torch.from_numpy(batch["rawsize"]).to(dev)
    packed = bundle["step"](images, sizes).cpu().numpy()
    n_boxes = 0
    for want in unpack(packed, ids, batch["rawsize"]):
        got = extracted.get(want["imgid"])
        check(np.array_equal(got["features"], want["features"])
              and np.array_equal(got["boxes"], np.asarray(want["boxes"], np.float32))
              and got["object_ids"] == want["object_ids"] and got["attr_ids"] == want["attr_ids"],
              f"stored row of {want['imgid']} != the direct step")
        check(bool(np.isfinite(got["features"]).all()), f"{want['imgid']}: features not finite")
        n_boxes += sum(1 for o in got["object_ids"] if o >= 0)
    check(n_boxes > 0, "no detection in the checked images")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        bundle["step"](images, sizes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 3 * 1e3


def median_p90(ms) -> dict:
    return {"median": float(np.median(ms)), "p90": float(np.percentile(ms, 90))}


def loader_fetch_ms(loader, n_batches: int, what: str) -> dict:
    """The host alone: one epoch of the loader with no consumer; the time
    of each batch (median and p90 without the first, and the first)."""
    fetch = []
    t0 = time.perf_counter()
    for _ in loader:
        fetch.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
    check(len(fetch) == n_batches, f"{what}: the loader gave {len(fetch)} batches, not {n_batches}")
    return {**median_p90(fetch[1:]), "first": fetch[0]}


def epoch_step_ms(exp, train_loader, epoch: int, n_steps: int, what: str) -> list:
    """One more epoch of ``exp.inner_loop`` (prepare, device feed,
    one-step-late drain, the log) over ``train_loader``: the step times in
    ms, the log's clock between drained steps (each step's metrics are read
    once the next step is queued)."""
    log_path = os.path.join(exp.logdir, "steps_log.json")
    with open(log_path) as f:
        n0 = sum(1 for _ in f)
    exp.train_loader = train_loader
    if hasattr(train_loader, "set_epoch"):
        train_loader.set_epoch(epoch)
    exp.inner_loop(epoch)
    with open(log_path) as f:
        rows = [json.loads(line) for line in f][n0:]
    check(len(rows) == n_steps and all(np.isfinite(r["loss"]) for r in rows), f"{what} epoch {epoch}: {len(rows)} steps")
    return list(np.diff([r["sec"] for r in rows]) * 1e3)


def loader_against_control(exp, n_steps: int, what: str):
    """The step with and without the loader in the same loop: two more
    epochs each, over the loader and over ``n_steps`` copies of one host
    batch (no loader threads), alternated. Returns (that host batch,
    {"with": median_p90, "without": median_p90})."""
    loader_it, host_batch = exp.train_loader, next(iter(exp.train_loader))
    with_loader, without_loader = [], []
    for epoch in (1, 2):
        without_loader += epoch_step_ms(exp, [host_batch] * n_steps, epoch, n_steps, what)
        with_loader += epoch_step_ms(exp, loader_it, epoch, n_steps, what)
    exp.train_loader = loader_it
    return host_batch, {"with": median_p90(with_loader), "without": median_p90(without_loader)}


def phase_data(dev, wrappers, smi: str) -> dict:
    """The reference's canonical pipeline through the port's user entry
    points: a raw COCO-2014 + VQA corpus drawn from seed 0 (64 JPEGs of
    480 x 640, instances, 512 questions with 4 answers) -> the coco2014 and
    vqa adapters' Arrow tables -> ``FRCNN.extract`` (parity_300, B=8, the
    extraction phases' canvases, seeded and tamed weights read from a state
    dict: K1 8 and K2 16 launches, no other kernel) -> the stored features
    and boxes of 8 images bitwise equal to one direct call of the step on
    the same decoded batch -> ``Experiments.get("data")`` on ``build(config)``
    (extractor "frcnn", B=32, 4 loader threads) -> ``LxmertVQAExperiment``
    with ``loaders=None`` at LXMERT-base bf16, one epoch of 16 steps, finite
    losses and no kernel. Prints the ETL seconds, images/s through the
    extraction pipeline, the host fetch time a batch, the step with the
    loader and without it in the same loop, and the bare step on one
    device-resident batch."""
    import tempfile

    from vltk_tpu_torch import build
    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.adapters.frcnn import FRCNN, tame_random_weights
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import Experiments, LxmertVQAExperiment
    from vltk_tpu_torch.models.frcnn import FRCNN as FRCNNModel, FRCNNConfig, init_weights
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.tools.synthetic_corpus import write_corpus

    class ExtractionFRCNN(FRCNN):
        # the extraction phases' geometry (bench.py GEOM["full"])
        model_batch_size = DATA_EXTRACT_BATCH
        raw_canvas, resized_canvas = RAW_CANVAS, CANVAS

    out: dict = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_data_") as root:
        datadir = os.path.join(root, "data")
        t0 = time.perf_counter()
        write_corpus(datadir, DATA_IMAGES, DATA_QUESTIONS, hw=RAW_HW, seed=0)
        out["corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        coco = Adapters.get("coco2014").extract(datadir)
        vqa = Adapters.get("vqa").extract(datadir)["train"]
        out["etl_s"] = time.perf_counter() - t0
        check(len(coco) == DATA_IMAGES and len(vqa) == DATA_QUESTIONS
              and sorted(vqa.answer_frequencies) == ["2", "no", "red", "yes"],
              f"ETL: {len(coco)} images, {len(vqa)} questions, answers {vqa.answer_frequencies}")

        ckpt = os.path.join(root, "frcnn.pt")
        model = tame_random_weights(init_weights(FRCNNModel(FRCNNConfig.vg_extraction()), seed=0))
        torch.save(model.state_dict(), ckpt)
        del model
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extracted = ExtractionFRCNN.extract(datadir, dataset_name="coco2014", checkpoint=ckpt,
                                            preset="parity_300", device=dev)["train"]
        torch.cuda.synchronize()
        out["extract_s"] = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        steps = DATA_IMAGES // DATA_EXTRACT_BATCH
        check(launches["roi_pool"] == steps and launches["nms"] == 2 * steps
              and not any(v for k, v in launches.items() if k not in ("roi_pool", "nms")),
              f"extraction pipeline launches {launches} over {steps} steps (K1 {steps}, K2 {2 * steps} expected)")
        out["extraction_launches"] = launches
        check(len(extracted) == DATA_IMAGES and extracted.metadata["model_config"]["preset"] == "parity_300",
              f"extracted table: {len(extracted)} rows")
        # once more, warm: the first run also pays the card's first calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extracted = ExtractionFRCNN.extract(datadir, dataset_name="coco2014", checkpoint=ckpt,
                                            preset="parity_300", device=dev)["train"]
        torch.cuda.synchronize()
        out["extract_warm_s"] = time.perf_counter() - t0

        # the pipeline adds nothing: the stored rows of 8 images against one
        # direct call of the step on the same decoded batch, and that step
        # on device-resident inputs beside the pipeline's time a batch
        t0 = time.perf_counter()
        bundle, _ = ExtractionFRCNN.setup(checkpoint=ckpt, preset="parity_300", device=dev)
        out["setup_s"] = time.perf_counter() - t0
        out["direct_step_ms"] = check_stored_rows(ExtractionFRCNN, bundle, extracted,
                                                  os.path.join(datadir, "coco2014", "train"), dev)
        del bundle
        torch.cuda.empty_cache()

        config = Config()
        config.logdir = os.path.join(root, "logs")
        config.data.update({"datadir": datadir, "train_datasets": [["vqa", "train"]], "extractor": "frcnn",
                            "train_batch_size": DATA_TRAIN_BATCH, "num_workers": 4,
                            "max_detections": LXMERT_BOXES, "visual_dim": 2048})
        config.data.lang.update({"max_seq_length": LXMERT_SEQ})
        config.train.update({"epochs": 1, "learning_rate": 1e-5})
        report = Experiments.get("data")(config)()
        want_shapes = {"input_ids": (DATA_TRAIN_BATCH, LXMERT_SEQ), "features": (DATA_TRAIN_BATCH, LXMERT_BOXES, 2048),
                       "boxes": (DATA_TRAIN_BATCH, LXMERT_BOXES, 4), "rawsize": (DATA_TRAIN_BATCH, 2),
                       "labels": (DATA_TRAIN_BATCH, 16), "scores": (DATA_TRAIN_BATCH, 16)}
        check(all(report["train"].get(k) == v for k, v in want_shapes.items()), f"data experiment {report}")

        # the host alone: one epoch of the loader, no consumer
        out["fetch_ms"] = loader_fetch_ms(build(config)[0], DATA_QUESTIONS // DATA_TRAIN_BATCH, "data plane")

        cfg = LxmertConfig(dtype="bfloat16")

        class VQA(LxmertVQAExperiment):
            model_config = cfg

        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        exp = VQA(config, device=dev)
        out["experiment_init_s"] = time.perf_counter() - t0
        check(exp.model_config.num_answers == 4 and len(exp.train_loader) == DATA_QUESTIONS // DATA_TRAIN_BATCH,
              f"experiment: {exp.model_config.num_answers} answers, {len(exp.train_loader)} batches")
        t0 = time.perf_counter()
        exp()
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        check(not any(launches.values()), f"kernels launched on the LXMERT training path from build: {launches}")
        with open(os.path.join(exp.logdir, "steps_log.json")) as f:
            log = [json.loads(line) for line in f]
        check(len(log) == DATA_QUESTIONS // DATA_TRAIN_BATCH and all(np.isfinite(r["loss"]) for r in log),
              f"LXMERT from build: losses {log}")
        # the step with and without the loader in the same loop
        host_batch, loop = loader_against_control(exp, DATA_QUESTIONS // DATA_TRAIN_BATCH, "data plane")
        cold = np.diff([r["sec"] for r in log]) * 1e3
        samples_s, resident_ms, peak = time_train_step(exp, host_batch, batch=DATA_TRAIN_BATCH)
        out.update({
            "losses": [r["loss"] for r in log], "training_launches": launches,
            "step_ms_first_epoch": median_p90(cold), "step_ms_with_loader": loop["with"],
            "step_ms_without_loader": loop["without"],
            "step_ms_resident": resident_ms, "samples_per_s_resident": samples_s, "peak_mem_gb": peak,
        })
        # the loader's own share: the same loop with and without it
        out["loader_ms"] = out["step_ms_with_loader"]["median"] - out["step_ms_without_loader"]["median"]
        out["loop_and_feed_ms"] = out["step_ms_without_loader"]["median"] - resident_ms
        out["loader_kept_up"] = bool(out["step_ms_with_loader"]["median"]
                                     <= 1.1 * out["step_ms_without_loader"]["median"])
        del exp
        torch.cuda.empty_cache()

    pipeline_s = out["extract_s"] - out["setup_s"]
    warm_s = out["extract_warm_s"] - out["setup_s"]
    steps = DATA_IMAGES // DATA_EXTRACT_BATCH
    print(
        f"data plane on {smi}: corpus {out['corpus_s']:.2f} s; ETL (coco2014 + vqa -> Arrow) {out['etl_s']:.2f} s; "
        f"FRCNN.extract parity_300 B={DATA_EXTRACT_BATCH} over {DATA_IMAGES} images {out['extract_s']:.2f} s "
        f"({DATA_IMAGES / out['extract_s']:.2f} images/s with setup; setup alone {out['setup_s']:.2f} s, "
        f"{DATA_IMAGES / pipeline_s:.2f} images/s without), again warm {out['extract_warm_s']:.2f} s "
        f"({DATA_IMAGES / warm_s:.2f} images/s without setup: {warm_s / steps * 1e3:.1f} ms a batch against "
        f"{out['direct_step_ms']:.1f} ms for the step alone on device-resident inputs); "
        f"launches {out['extraction_launches']}; "
        f"{DATA_CHECKED_IMAGES} stored rows bitwise equal to the direct step"
    )
    print(
        f"data plane loader (B={DATA_TRAIN_BATCH}, 4 threads, 36 x 2048 features): host fetch a batch median "
        f"{out['fetch_ms']['median']:.2f} ms, p90 {out['fetch_ms']['p90']:.2f} ms (first {out['fetch_ms']['first']:.2f} "
        f"ms); LxmertVQAExperiment from build (LXMERT-base bf16, {len(out['losses'])} steps in {out['train_s']:.2f} s, "
        f"init {out['experiment_init_s']:.2f} s), the step median (p90) in ms: first epoch "
        f"{out['step_ms_first_epoch']['median']:.3f} ({out['step_ms_first_epoch']['p90']:.3f}); two more epochs "
        f"each, alternated, with the loader {out['step_ms_with_loader']['median']:.3f} "
        f"({out['step_ms_with_loader']['p90']:.3f}) and without it (one host batch 16 times, same loop and feed) "
        f"{out['step_ms_without_loader']['median']:.3f} ({out['step_ms_without_loader']['p90']:.3f}); bare step on "
        f"one device-resident batch {out['step_ms_resident']:.3f}; the loader's share {out['loader_ms']:.3f}, the "
        f"loop's and feed's {out['loop_and_feed_ms']:.3f}; loader kept up: {out['loader_kept_up']}; "
        f"losses {[round(x, 5) for x in out['losses']]}; peak {out['peak_mem_gb']:.2f} GB"
    )
    return out


# ------------------------------------------- documents from raw FUNSD and DocVQA

FORMS, FORM_WORDS = 64, 780  # ~1000 sub-tokens a form (a few cut at 1023)
DOCVQA_DOCS, DOCVQA_WORDS, DOCVQA_PER_DOC = 64, 700, 2  # ~900 sub-tokens a document
RAW_DOC_BATCH = 8
RAW_DOC_LR = 1e-4


def raw_doc_config(datadir: str, logdir: str, lang: dict, **data):
    from vltk_tpu_torch.config import Config

    config = Config()
    config.logdir = logdir
    config.data.update({"datadir": datadir, "train_batch_size": RAW_DOC_BATCH, "num_workers": 4,
                        "ignore_image": True, **data})
    config.data.lang.update(lang)
    config.train.update({"epochs": 1, "learning_rate": RAW_DOC_LR, "weight_decay": 0.01, "warmup_ratio": 0.1,
                         "clip_grad_norm": 1.0})
    return config


def train_from_raw(exp_cls, cfg, config, dev, wrappers, n_steps: int, what: str) -> dict:
    """``exp_cls`` at the model config ``cfg`` over ``build(config)``
    (``loaders=None``) for one epoch on the card: finite losses, K3, K4 and
    K5 12 launches each a step and no other kernel; then the loader's
    fetch, the step with and without the loader in the same loop, and the
    bare step on one device-resident batch."""
    from vltk_tpu_torch import build

    class Experiment(exp_cls):
        model_config = cfg

    fetch = loader_fetch_ms(build(config)[0], n_steps, what)
    t0 = time.perf_counter()
    exp = Experiment(config, device=dev)
    init_s = time.perf_counter() - t0
    check(len(exp.train_loader) == n_steps, f"{what}: {len(exp.train_loader)} batches")
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    result = exp()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        log = [json.loads(line) for line in f]
    losses = [r["loss"] for r in log]
    check(len(losses) == n_steps and all(np.isfinite(losses)), f"{what}: losses {losses}")
    for name in ("flash_attention", "flash_attention_dkv", "flash_attention_dq"):
        check(launches[name] == 12 * n_steps, f"{what}: {name} launched {launches[name]} times over {n_steps} steps "
              "(12 a step expected)")
    check(not any(v for k, v in launches.items() if not k.startswith("flash_attention")),
          f"{what}: other kernels launched {launches}")
    host_batch, loop = loader_against_control(exp, n_steps, what)
    samples_s, resident_ms, peak = time_train_step(exp, host_batch, batch=RAW_DOC_BATCH)
    out = {
        "launches": launches, "losses": losses, "train_s": train_s, "init_s": init_s, "fetch_ms": fetch,
        "metrics": {k: v for k, v in result["train"].items() if isinstance(v, float)},
        "step_ms_first_epoch": median_p90(np.diff([r["sec"] for r in log]) * 1e3),
        "step_ms_with_loader": loop["with"], "step_ms_without_loader": loop["without"],
        "step_ms_resident": resident_ms, "samples_per_s_resident": samples_s, "peak_mem_gb": peak,
    }
    out["loader_ms"] = loop["with"]["median"] - loop["without"]["median"]
    del exp
    torch.cuda.empty_cache()
    return out


def phase_raw_documents(dev, wrappers, smi: str) -> dict:
    """Documents from raw JSON through the port's user entry points: 64
    seeded FUNSD forms of 780 words (~1000 sub-tokens) -> the ``funsd``
    adapter's Arrow -> ``build(config)`` with ``auxtokenize, ocrboxfixed,
    tokenlabels`` at ``max_visual_seq_length`` 1024 -> ``OCRTokenExperiment``
    at LayoutLM-base (12 x 768, seq 1024, bf16), B=8, one epoch of 8 steps;
    64 seeded DocVQA documents of 700 words (~900 sub-tokens), two
    questions each -> ``docvqavisn`` and ``docvqa`` (answers grounded by
    Jaccard) -> ``build`` with ``auxtokenize, ocrboxfixed`` + ``span`` at
    question 64 + document 960 -> ``DocVQASpanExperiment``, B=8, one epoch
    of 16 steps. Each: finite losses, K3, K4 and K5 12 launches a step, the
    ETL seconds, the host fetch a batch, the step with and without the
    loader."""
    import tempfile

    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.experiments import DocVQASpanExperiment, OCRTokenExperiment
    from vltk_tpu_torch.tools.synthetic_corpus import write_docvqa, write_funsd
    from vltk_tpu_torch.trace import layoutlm_train_config

    cfg = layoutlm_train_config("auto")
    check((cfg.l_layers, cfg.hidden_size, cfg.num_heads, cfg.max_position_embeddings, cfg.dtype)
          == (12, 768, 12, 1024, "bfloat16"), f"LayoutLM-base config {cfg}")
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_docs_") as root:
        datadir = os.path.join(root, "data")
        t0 = time.perf_counter()
        write_funsd(datadir, FORMS, FORM_WORDS, seed=0)
        write_docvqa(datadir, DOCVQA_DOCS, DOCVQA_WORDS, DOCVQA_PER_DOC, seed=1)
        out["corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        forms = Adapters.get("funsd").extract(datadir)
        out["funsd_etl_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        docs = Adapters.get("docvqavisn").extract(datadir)
        questions = Adapters.get("docvqa").extract(datadir)["train"]
        out["docvqa_etl_s"] = time.perf_counter() - t0
        n_questions = DOCVQA_DOCS * DOCVQA_PER_DOC
        check(len(forms) == FORMS and len(docs) == DOCVQA_DOCS and len(questions) == n_questions,
              f"ETL: {len(forms)} forms, {len(docs)} documents, {len(questions)} grounded questions")

        funsd_config = raw_doc_config(datadir, os.path.join(root, "funsd"), {"max_visual_seq_length": 1024},
                                      train_datasets=[["funsd", "train"]],
                                      visn_processors=["auxtokenize", "ocrboxfixed", "tokenlabels"])
        out["funsd"] = train_from_raw(OCRTokenExperiment, cfg, funsd_config, dev, wrappers, FORMS // RAW_DOC_BATCH,
                                      "FUNSD from raw JSON")
        span_config = raw_doc_config(datadir, os.path.join(root, "docvqa"),
                                     {"max_seq_length": SPAN_Q, "max_visual_seq_length": SPAN_DOC},
                                     train_datasets=[["docvqa", "train"]], ignore_filepath=True,
                                     visn_processors=["auxtokenize", "ocrboxfixed"], visnlang_processors=["span"])
        out["docvqa"] = train_from_raw(DocVQASpanExperiment, cfg, span_config, dev, wrappers,
                                       n_questions // RAW_DOC_BATCH, "DocVQA from raw JSON")

    for key, what, etl in (("funsd", f"FUNSD ({FORMS} forms of {FORM_WORDS} words, seq 1024)", out["funsd_etl_s"]),
                           ("docvqa", f"DocVQA ({DOCVQA_DOCS} documents of {DOCVQA_WORDS} words, {n_questions} "
                                      f"questions, {SPAN_Q} + {SPAN_DOC})", out["docvqa_etl_s"])):
        r = out[key]
        print(
            f"raw documents on {smi}: {what}: ETL {etl:.2f} s; LayoutLM-base bf16 B={RAW_DOC_BATCH}, "
            f"{len(r['losses'])} steps in {r['train_s']:.2f} s (init {r['init_s']:.2f} s); launches {r['launches']}; "
            f"host fetch a batch median {r['fetch_ms']['median']:.2f} ms, p90 {r['fetch_ms']['p90']:.2f} ms; the step "
            f"median (p90) in ms: first epoch {r['step_ms_first_epoch']['median']:.3f} "
            f"({r['step_ms_first_epoch']['p90']:.3f}), with the loader {r['step_ms_with_loader']['median']:.3f} "
            f"({r['step_ms_with_loader']['p90']:.3f}), without it {r['step_ms_without_loader']['median']:.3f} "
            f"({r['step_ms_without_loader']['p90']:.3f}), bare {r['step_ms_resident']:.3f}; the loader's share "
            f"{r['loader_ms']:.3f}; losses {[round(x, 4) for x in r['losses']]}; {r['metrics']}; peak "
            f"{r['peak_mem_gb']:.2f} GB"
        )
    return out


# ------------------------------------- GQA on Visual Genome, the host pipeline, masks

GQA_IMAGES, GQA_QUESTIONS = 64, 512  # 8 answers of 64 questions each
HOSTPIPE_WORKERS = 4
MASK_IMAGES = 8


def near_boundary(diff: np.ndarray, plain: np.ndarray) -> bool:
    """Every pixel of ``diff`` lies within one pixel of a boundary pixel of
    ``plain`` (a pixel with a 4-neighbour of the other value)."""
    if not diff.any():
        return True
    h, w = plain.shape
    pad = np.pad(plain, 1, mode="edge")
    edge = np.zeros((h, w), bool)
    for dy, dx in ((0, 1), (1, 0), (2, 1), (1, 2)):
        edge |= pad[dy : dy + h, dx : dx + w] != plain
    grown = np.pad(edge, 1)
    near = np.zeros((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            near |= grown[dy : dy + h, dx : dx + w]
    return not (diff & ~near).any()


def check_mask_processors(root: str) -> dict:
    """The mask processors through ``build(config)`` on seeded CLEVR-ref
    (point runs) and COCO-polygon corpora, each instance held against the
    plain NumPy / PIL decode of the same raw annotation resized the same
    way: point runs bitwise; polygons bitwise to the native fill resized,
    and the native fill within one pixel of PIL's boundary. Then the
    native fill of the committed polygons of ``tests/data/polygon_fill.json``
    bitwise against the JAX package's fill of them."""
    from vltk_tpu_torch import build
    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.tools.synthetic_corpus import write_clevrref, write_corpus
    from vltk_tpu_torch.utils.adapters import (imagepoints_to_mask_plain, polygon_to_mask, polygon_to_mask_plain,
                                               resize_binary_mask)

    datadir = os.path.join(root, "masks")
    write_clevrref(datadir, MASK_IMAGES, hw=(320, 480), seed=0)
    write_corpus(datadir, MASK_IMAGES, 0, hw=RAW_HW, seed=1, shapes="polygons")
    out = {}
    for dataset, proc, key in (("clevrref", "rleprocessor", "RLE"), ("coco2014", "polygonprocessor", "poly")):
        raw = Adapters.get(dataset).extract(datadir)
        config = Config()
        config.data.update({"datadir": datadir, "train_datasets": [[dataset, "train"]], "train_batch_size": 4,
                            "num_workers": 0, "shuffle": False, "drop_last": False, "visn_processors": [proc],
                            "ignore_segmentation": False, "vision": {"size": (320, 480)}})
        config.data.lang.update({"max_visual_seq_length": 16})
        n_masks = n_pixels = n_off = 0
        for batch in build(config)[0]:
            for i, imgid in enumerate(batch["imgid"]):
                rawsize = tuple(int(x) for x in batch["rawsize"][i])
                size = tuple(int(x) for x in batch["size"][i])
                got = batch["segmentation"][i]
                check(got.dtype == np.uint8 and got.shape == (16, *size), f"{dataset}: masks {got.dtype} {got.shape}")
                for k, seg in enumerate(raw.get(imgid)[key]):
                    if key == "RLE":
                        want = resize_binary_mask(imagepoints_to_mask_plain(seg, rawsize), size)
                    else:
                        native = polygon_to_mask(seg, *rawsize)
                        plain = polygon_to_mask_plain(seg, *rawsize)
                        check(near_boundary(native != plain, plain), f"{imgid} instance {k}: the native polygon "
                              "fill differs from PIL's away from the boundary")
                        n_off += int((native != plain).sum())
                        want = resize_binary_mask(native, size)
                    check(np.array_equal(got[k], want), f"{dataset} {imgid} instance {k}: mask != the plain decode")
                    n_masks += 1
                    n_pixels += int(want.sum())
        check(n_masks > MASK_IMAGES and n_pixels > 0, f"{dataset}: {n_masks} masks, {n_pixels} pixels")
        out[dataset] = {"masks": n_masks, "pixels": n_pixels, "boundary_pixels_differing_from_pil": n_off}
    # this machine's build of maskops.cpp against fills the JAX package's
    # build made of committed polygons (tests/data/polygon_fill.json, which
    # tests/test_torch_masks.py writes and holds against JAX on the CPU)
    with open(os.path.join(HERE, "tests", "data", "polygon_fill.json")) as f:
        cases = json.load(f)["cases"]
    for i, case in enumerate(cases):
        h, w = case["height"], case["width"]
        want = np.repeat(np.arange(len(case["runs"])) % 2, case["runs"]).astype(np.uint8).reshape(h, w)
        check(np.array_equal(polygon_to_mask(case["polygons"], h, w), want),
              f"polygon fill case {i} ({h} x {w}) != the JAX package's native fill")
    check(len(cases) >= 20, f"{len(cases)} polygon fill cases")
    out["polygon_fill_fixture_cases_bitwise"] = len(cases)
    return out


def phase_gqa(dev, wrappers, smi: str) -> dict:
    """GQA over Visual Genome through the port's user entry points: 64
    seeded 480 x 640 VG JPEGs and 512 GQA questions (8 answers) -> the
    ``gqa`` adapter's Arrow -> ``FRCNN.extract(dataset_name="visualgenome")``
    (parity_300, B=8, seeded tamed weights from a state dict: K1 8 and K2
    16 launches) -> 8 stored rows bitwise equal to a direct step ->
    ``build(config)`` joining the questions with the VG features ->
    ``LxmertVQAExperiment`` at LXMERT-base bf16, B=32, one epoch of 16 steps
    (finite losses, no kernel). Then ``HostDecodeFRCNN`` over the same
    images inline and with 4 worker processes (the merged table equal to
    the inline one; images/s and the stage seconds), ``FRCNN.extract``
    with ``host_workers=2`` refused, and the mask processors against their
    plain versions (``check_mask_processors``)."""
    import tempfile

    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.adapters.frcnn import FRCNN, tame_random_weights
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.data.hostpipe import HostDecodeFRCNN, run_sharded_split
    from vltk_tpu_torch.experiments import LxmertVQAExperiment
    from vltk_tpu_torch.models.frcnn import FRCNN as FRCNNModel, FRCNNConfig, init_weights
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.tools.synthetic_corpus import GQA_ANSWERS, write_gqa

    class ExtractionFRCNN(FRCNN):
        model_batch_size = DATA_EXTRACT_BATCH
        raw_canvas, resized_canvas = RAW_CANVAS, CANVAS

    out: dict = {"cpu_count": os.cpu_count()}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_gqa_") as root:
        datadir = os.path.join(root, "data")
        img_dir = os.path.join(datadir, "visualgenome", "train")
        t0 = time.perf_counter()
        write_gqa(datadir, GQA_IMAGES, GQA_QUESTIONS, hw=RAW_HW, seed=0)
        out["corpus_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gqa = Adapters.get("gqa").extract(datadir, splits=["train"])["train"]
        out["etl_s"] = time.perf_counter() - t0
        check(len(gqa) == GQA_QUESTIONS and sorted(gqa.answer_frequencies) == sorted(GQA_ANSWERS),
              f"GQA ETL: {len(gqa)} questions, answers {gqa.answer_frequencies}")

        ckpt = os.path.join(root, "frcnn.pt")
        torch.save(tame_random_weights(init_weights(FRCNNModel(FRCNNConfig.vg_extraction()), seed=0)).state_dict(),
                   ckpt)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extracted = ExtractionFRCNN.extract(datadir, dataset_name="visualgenome", checkpoint=ckpt,
                                            preset="parity_300", device=dev)["train"]
        torch.cuda.synchronize()
        out["extract_s"] = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        steps = GQA_IMAGES // DATA_EXTRACT_BATCH
        check(launches["roi_pool"] == steps and launches["nms"] == 2 * steps
              and not any(v for k, v in launches.items() if k not in ("roi_pool", "nms")),
              f"VG extraction launches {launches} over {steps} steps (K1 {steps}, K2 {2 * steps} expected)")
        out["extraction_launches"] = launches
        check(len(extracted) == GQA_IMAGES, f"VG features: {len(extracted)} rows")
        t0 = time.perf_counter()
        bundle, _ = ExtractionFRCNN.setup(checkpoint=ckpt, preset="parity_300", device=dev)
        out["setup_s"] = time.perf_counter() - t0
        out["direct_step_ms"] = check_stored_rows(ExtractionFRCNN, bundle, extracted, img_dir, dev)
        del bundle
        torch.cuda.empty_cache()

        config = Config()
        config.logdir = os.path.join(root, "logs")
        config.data.update({"datadir": datadir, "train_datasets": [["gqa", "train"]], "extractor": "frcnn",
                            "train_batch_size": DATA_TRAIN_BATCH, "num_workers": 4,
                            "max_detections": LXMERT_BOXES, "visual_dim": 2048})
        config.data.lang.update({"max_seq_length": LXMERT_SEQ})
        config.train.update({"epochs": 1, "learning_rate": 1e-5})

        class VQA(LxmertVQAExperiment):
            model_config = LxmertConfig(dtype="bfloat16")

        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        exp = VQA(config, device=dev)
        out["experiment_init_s"] = time.perf_counter() - t0
        n_steps = GQA_QUESTIONS // DATA_TRAIN_BATCH
        check(exp.model_config.num_answers == len(GQA_ANSWERS) and len(exp.train_loader) == n_steps,
              f"GQA experiment: {exp.model_config.num_answers} answers, {len(exp.train_loader)} batches")
        batch = next(iter(exp.train_loader))
        check(batch["features"].shape == (DATA_TRAIN_BATCH, LXMERT_BOXES, 2048), f"GQA batch features {batch['features'].shape}")
        check(all(extracted.has(i) for i in batch["imgid"]) and bool(np.isfinite(batch["features"]).all())
              and np.array_equal(batch["features"][0], extracted.get(batch["imgid"][0])["features"]),
              "GQA batches do not carry the VG features of their images")
        t0 = time.perf_counter()
        exp()
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["training_launches"] = {k: w.launches for k, w in wrappers.items()}
        check(not any(out["training_launches"].values()), f"kernels on the GQA LXMERT path: {out['training_launches']}")
        with open(os.path.join(exp.logdir, "steps_log.json")) as f:
            log = [json.loads(line) for line in f]
        out["losses"] = [r["loss"] for r in log]
        check(len(log) == n_steps and all(np.isfinite(out["losses"])), f"GQA LXMERT losses {out['losses']}")
        out["step_ms"] = median_p90(np.diff([r["sec"] for r in log]) * 1e3)
        del exp
        torch.cuda.empty_cache()

        # the host pipeline: the same images, inline and over 4 processes
        t0 = time.perf_counter()
        inline = HostDecodeFRCNN.extract(datadir, dataset_name="visualgenome", host_workers=1)["train"]
        out["hostpipe_inline_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pooled = HostDecodeFRCNN.extract(datadir, dataset_name="visualgenome", host_workers=HOSTPIPE_WORKERS)["train"]
        out["hostpipe_pooled_s"] = time.perf_counter() - t0
        check(len(pooled) == GQA_IMAGES and pooled.table.equals(inline.table)
              and pooled.metadata == inline.metadata, "HostDecodeFRCNN: 4 workers' table != the inline one")
        out["hostpipe_pooled"] = pooled.host_stats["aggregate"]
        _, one = run_sharded_split(HostDecodeFRCNN, Adapters.get("visualgenome").load_imgid2path(datadir, "train"),
                                   os.path.join(root, "one.arrow"), num_workers=1)
        out["hostpipe_one_process"] = one["aggregate"]
        try:
            FRCNN.extract(datadir, dataset_name="visualgenome", host_workers=2)
            check(False, "FRCNN.extract(host_workers=2) did not raise")
        except ValueError as exc:
            check("host-only" in str(exc), f"FRCNN.extract(host_workers=2): {exc}")

        t0 = time.perf_counter()
        out["masks"] = check_mask_processors(root)
        out["masks_s"] = time.perf_counter() - t0

    pipeline_s = out["extract_s"] - out["setup_s"]
    one, pooled = out["hostpipe_one_process"], out["hostpipe_pooled"]
    stages = lambda a: ", ".join(f"{k} {a[k]:.2f}" for k in ("decode_s", "collate_s", "forward_s", "write_s"))  # noqa: E731
    print(
        f"GQA on Visual Genome on {smi}: ETL ({GQA_QUESTIONS} questions -> Arrow) {out['etl_s']:.2f} s; "
        f"FRCNN.extract(dataset_name='visualgenome') parity_300 B={DATA_EXTRACT_BATCH} over {GQA_IMAGES} images "
        f"{out['extract_s']:.2f} s ({GQA_IMAGES / pipeline_s:.2f} images/s without the {out['setup_s']:.2f} s setup; "
        f"the step alone {out['direct_step_ms']:.1f} ms); launches {out['extraction_launches']}; "
        f"{DATA_CHECKED_IMAGES} stored rows bitwise equal to the direct step; LxmertVQAExperiment from build "
        f"(LXMERT-base bf16, B={DATA_TRAIN_BATCH}, {len(out['losses'])} steps in {out['train_s']:.2f} s, init "
        f"{out['experiment_init_s']:.2f} s, step median {out['step_ms']['median']:.3f} ms, p90 "
        f"{out['step_ms']['p90']:.3f}); losses {[round(x, 4) for x in out['losses']]}"
    )
    print(
        f"host pipeline (HostDecodeFRCNN, {GQA_IMAGES} VG JPEGs of 480 x 640 onto the 1344 x 1344 canvas, B=8, "
        f"os.cpu_count() {out['cpu_count']}): extract inline (decode threads) {out['hostpipe_inline_s']:.2f} s "
        f"({GQA_IMAGES / out['hostpipe_inline_s']:.2f} images/s); one process {one['img_per_s']:.2f} images/s "
        f"(wall {one['wall_s']:.2f} s; {stages(one)} s); {pooled['workers']} processes {pooled['img_per_s']:.2f} "
        f"images/s, start-up bound, not a throughput: at {GQA_IMAGES} images the wall is the children's spawn and "
        f"imports (wall {pooled['wall_s']:.2f} s, extract {out['hostpipe_pooled_s']:.2f} s; summed {stages(pooled)} s);"
        f" merged table equal to the inline one (the check this run is for); FRCNN.extract(host_workers=2) raised ValueError; mask processors "
        f"against the plain decodes {out['masks']} in {out['masks_s']:.2f} s"
    )
    return out


# ------------------------------------------- K10, the RoIPool backward (32)

DET_BATCH = 2  # bench.py --train frcnn: B=2 on the 832 x 1344 canvas
DET_CONTENT = (800.0, 1067.0)  # a 480 x 640 image resized to short side 800
DET_GT = 8  # seeded ground-truth boxes an image
DET_STEPS = 8
DET_LR = 1e-4
RPN_PER_IMAGE, ROI_PER_IMAGE = 256, 128
# random cotangents: float32 sums in the atomics' order differ from the
# plain VJP's by at most ~n eps of the sum of the terms' magnitudes (n
# terms); bf16 adds one rounding of the cast
K10_SUM_TOL = 1e-5
K10_CAST_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def k10_close(got, want, feat, boxes, g) -> bool:
    """Within the sum-order bound of the terms' magnitudes (the plain VJP of
    |g|), plus one rounding of the cast in bf16."""
    from vltk_tpu_torch.ops.roi_pool import roi_pool_plain_vjp

    magnitude = roi_pool_plain_vjp(feat, boxes, g.abs(), 14, 1 / 16).float()
    err = (got.float() - want.float()).abs()
    return bool((err <= K10_SUM_TOL * magnitude + K10_CAST_RTOL[g.dtype] * want.float().abs()).all())


EXP_HW = (84, 84)  # the res4 map of the detection experiment's 1344 x 1344 canvas


def k10_inputs(gen: torch.Generator, b: int, dtype, dev, dyadic: bool, hw=FEAT_HW):
    """res4-like features (a relu map: zero plateaus; integer steps so that
    maxima tie) with NaN cells and a -inf block, proposal-like boxes with the
    edge cases of ``roi_boxes``, RoIs whose bins have power-of-two extents,
    and a cotangent of small integers times 2^-4 (every float32 sum exact in
    any order) or random; on the training canvas's 52 x 84 map or ``hw``."""
    h, w = hw
    feat = torch.relu(torch.randint(-3, 4, (b, h, w, C_RES4), generator=gen).float())
    feat[0, h // 5, w // 4, : C_RES4 // 16] = float("nan")
    feat[-1, h // 2: h // 2 + 4, w // 2: w // 2 + 4, C_RES4 // 10: C_RES4 // 5] = float("-inf")
    boxes = roi_boxes(gen, b, N_ROI, torch.device("cpu"))
    boxes[0, 6] = torch.tensor([0.0, 0.0, 28 * 16 - 1.0, 28 * 16 - 1.0])  # 14 x 14 bins of 2 x 2 cells
    boxes[-1, 7] = torch.tensor([64.0, 32.0, 64 + 56 * 16 - 1.0, 32 + 56 * 16 - 1.0])  # bins of 4 x 4
    shape = (b, N_ROI, 14, 14, C_RES4)
    g = torch.randint(-8, 9, shape, generator=gen) / 16 if dyadic else torch.randn(shape, generator=gen)
    return feat.to(dev, dtype), boxes.to(dev), g.to(dev, dtype)


def k10_bound(feat, boxes, g):
    """(bound_ms, bound_by): grad_out and the features read once, the
    gradient written once; the max comparisons of every bin's cells."""
    nbytes = g.numel() * g.element_size() + 2 * feat.numel() * feat.element_size() + boxes.numel() * 4
    return bound(nbytes, roi_pool_ops(boxes, feat.shape[-1], tuple(feat.shape[1:3])))


@contextlib.contextmanager
def first_call_of(module, name: str):
    """While the block runs, ``module.name`` records the arguments of its
    first call into the list this yields, and then calls through."""
    fn = getattr(module, name)
    recorded = []

    def record(*args):
        if not recorded:
            recorded.append(args)
        return fn(*args)

    setattr(module, name, record)
    try:
        yield recorded
    finally:
        setattr(module, name, fn)


def k10_call(feat, boxes, g, what: str):
    """K10 once: one launch, counted on the path its planner picks for the
    map. Returns (gradient, plan)."""
    from vltk_tpu_torch.ops.roi_pool_kernel import plan_backward, roi_pool_backward_auto, roi_pool_backward_cuda

    plan = plan_backward(*feat.shape[1:], feat.dtype)
    before = roi_pool_backward_auto.launches, dict(roi_pool_backward_auto.path_launches)
    got = roi_pool_backward_cuda(feat, boxes, g, 14, 1 / 16)
    torch.cuda.synchronize()
    paths = {k: v - before[1][k] for k, v in roi_pool_backward_auto.path_launches.items()}
    check(roi_pool_backward_auto.launches == before[0] + 1 and paths == {k: int(k == plan.path) for k in paths},
          f"K10 {what}: not one launch on the {plan.path} path ({paths})")
    return got, plan


def phase_roi_pool_backward(dev, ptxas) -> dict:
    """K10 against ``roi_pool_plain_vjp`` at the training step's shape
    (2, 52, 84, 1024) x 300 RoIs and at the 1344 x 1344 canvas's
    (2, 84, 84, 1024): bitwise on dyadic cotangents in bf16 and float32
    (ties, NaN and -inf cells, empty and off-map bins, power-of-two bins),
    within the stated tolerance on random ones; one launch a call on the
    planner's path; timed
    (median of five readings queued ahead) on the tie-heavy map at B=2, at
    the extraction batch B=8 and at 84 x 84, beside the bound and the plain
    VJP."""
    from vltk_tpu_torch.ops.roi_pool import roi_pool_plain_vjp
    from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_backward_cuda

    print("roi_pool_bwd ptxas: " + ("; ".join(ptxas) if ptxas else "cached build"))
    gen = torch.Generator().manual_seed(32)
    worst = 0.0
    plans = {}
    for hw in (FEAT_HW, EXP_HW):
        for dtype in (torch.bfloat16, torch.float32):
            for dyadic in (True, False):
                feat, boxes, g = k10_inputs(gen, DET_BATCH, dtype, dev, dyadic, hw)
                got, plan = k10_call(feat, boxes, g, f"{hw} {dtype}")
                plans[f"{hw[0]}x{hw[1]} {str(dtype)[6:]}"] = plan.__dict__
                want = roi_pool_plain_vjp(feat, boxes, g, 14, 1 / 16)
                err = float((got.float() - want.float()).abs().max())
                if dyadic:
                    ok = bitwise_equal(got, want)
                    worst = max(worst, err)
                    again, _ = k10_call(feat, boxes, g, f"{hw} {dtype} again")
                    repeat = bitwise_equal(again, got)
                    check(repeat, f"K10 {hw} {dtype}: two calls differ on dyadic cotangents")
                    del again
                else:
                    ok = k10_close(got, want, feat, boxes, g)
                nonzero = float((want != 0).float().mean())
                print(f"roi_pool_backward {tuple(feat.shape)} {dtype} x {N_ROI}, {'dyadic' if dyadic else 'random'} "
                      f"cotangent, {plan.path} path ({plan.slabs} slabs x {plan.bands} bands of {plan.band_rows} "
                      f"rows, {plan.smem_bytes} B shared a block): {'bitwise_equal' if dyadic else 'allclose'}={ok}"
                      f"{', a second call bitwise equal' if dyadic else ''} max_abs_err={err} "
                      f"(cells with a gradient {nonzero:.4f})")
                check(ok, f"K10 != plain VJP ({hw}, {dtype}, {'dyadic' if dyadic else 'random'})")
                del got, want
                torch.cuda.empty_cache()
    timed = {}
    for key, b, hw in (("tie_heavy", DET_BATCH, FEAT_HW), ("extraction_batch", 8, FEAT_HW),
                       ("canvas_1344", DET_BATCH, EXP_HW)):
        feat, boxes, g = k10_inputs(gen, b, torch.bfloat16, dev, dyadic=False, hw=hw)
        runs = spread_ms(lambda: roi_pool_backward_cuda(feat, boxes, g, 14, 1 / 16), reps=10)
        plain_ms = cuda_ms(lambda: roi_pool_plain_vjp(feat, boxes, g, 14, 1 / 16), reps=1, warmup=1)
        bound_ms, bound_by = k10_bound(feat, boxes, g)
        timed[key] = {"ms": runs[2], "ms_runs": runs, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "shape": list(feat.shape)}
        print(f"roi_pool_backward timing {tuple(feat.shape)} bf16 x {N_ROI} (tie-heavy integer relu map): kernel "
              f"{show(runs)}, plain VJP {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{runs[2] / bound_ms:.1f}x the bound; no single PyTorch call computes this gradient")
        del feat, boxes, g
        torch.cuda.empty_cache()
    print("roi_pool_backward plans " + json.dumps(plans))
    tie = timed["tie_heavy"]
    return {
        "name": "roi_pool_backward",
        "route": "cuda",
        "source": "vltk_tpu_torch/csrc/roi_pool_bwd.cu",
        "replaces": "vltk_tpu/ops/pallas_kernels.py:312",
        "max_abs_err": worst,
        "ms": tie["ms"],
        "plain_ms": tie["plain_ms"],
        "bound_ms": tie["bound_ms"],
        "bound_by": tie["bound_by"],
        "library_ms": None,
        "ms_runs": tie["ms_runs"],
        "extraction_batch": {k: timed["extraction_batch"][k] for k in ("ms", "ms_runs", "plain_ms", "bound_ms")},
        "canvas_1344": timed["canvas_1344"],
    }


# ------------------------------------------ detection training (33, 34)


def detection_batch(gen: torch.Generator, b: int, dev):
    """A training batch as ``FRCNNDetectExperiment.prepare_batch`` gives it
    at the parity canvas: caffe-normalised BGR-like values inside the
    800 x 1067 content, zeros in the pad, and ``DET_GT`` seeded boxes an
    image (sides 32-400 px) of classes in [0, 1600)."""
    h, w = DET_CONTENT
    images = torch.zeros(b, *CANVAS, 3)
    images[:, : int(h), : int(w)] = torch.randn(b, int(h), int(w), 3, generator=gen) * 50
    xy = torch.rand(b, DET_GT, 2, generator=gen) * torch.tensor([w - 400, h - 400])
    wh = 32 + torch.rand(b, DET_GT, 2, generator=gen) * 368
    return {
        "images": images.to(dev),
        "sizes": torch.tensor([[h, w]] * b, device=dev),
        "gt_boxes": torch.cat([xy, xy + wh], -1).to(dev),
        "gt_valid": torch.ones(b, DET_GT, dtype=torch.bool, device=dev),
        "gt_classes": torch.randint(0, 1600, (b, DET_GT), generator=gen).to(dev, torch.int32),
    }


def detection_loss(model, batch, parts=("rpn", "roi"), seed: int = 0):
    """bench.py's ``--train frcnn`` objective: ``rpn_losses`` at 256 anchors
    an image and ``fast_rcnn_losses`` at 128 proposals, priorities drawn
    from a generator on the card seeded with ``seed``."""
    from vltk_tpu_torch.models.detection_loss import fast_rcnn_losses, rpn_losses

    gen = torch.Generator(device=batch["images"].device).manual_seed(seed)
    raw = model(batch["images"], batch["sizes"], return_raw=True)["raw"]
    losses = []
    if "rpn" in parts:
        losses += rpn_losses(raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], batch["gt_boxes"],
                             batch["gt_valid"], generator=gen, batch_size_per_image=RPN_PER_IMAGE)
    if "roi" in parts:
        losses += fast_rcnn_losses(raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"],
                                   batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"], generator=gen,
                                   batch_size_per_image=ROI_PER_IMAGE)
    return losses


def detection_steps(model, opt, batch, steps: int, wrappers, what: str, sched=None) -> dict:
    """``steps`` training steps (zero the gradients, forward, the losses,
    backward, the optimizer's step), the counts set to 0 before each and
    read after it: K1 1, K10 1 and K2 2 a step, K1 and K10 on their vector
    paths, no other kernel; finite losses and gradients. Step ms from the host clock
    (each step ends in a synchronise), peak memory over the run."""
    paths = wrappers["roi_pool"].path_launches
    k10_paths = wrappers["roi_pool_backward"].path_launches
    losses, ms, grads0 = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        for w in wrappers.values():
            w.launches = 0
        paths.update(dict.fromkeys(paths, 0))
        k10_paths.update(dict.fromkeys(k10_paths, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        parts = detection_loss(model, batch, seed=i)
        loss = sum(parts)
        loss.backward()
        if i == 0:
            grads0 = {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.grad is not None}
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters() if p.grad is not None)
        opt.step()
        if sched is not None:
            sched.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: w.launches for k, w in wrappers.items()}
        want = {"roi_pool": 1, "roi_pool_backward": 1, "nms": 2}
        check(launches == {k: want.get(k, 0) for k in launches} and paths["scalar"] == 0
              and k10_paths["vector"] == 1, f"{what} step {i}: launches {launches}, K1 paths {paths}, K10 paths "
              f"{k10_paths}")
        losses.append([float(x.detach()) for x in parts])
        check(all(np.isfinite(losses[-1])) and finite, f"{what} step {i}: losses {losses[-1]}, finite grads {finite}")
    steady = ms[1:] if steps > 1 else ms
    return {"losses": losses, "step_ms": float(np.median(steady)), "step_ms_all": ms,
            "steps_per_s": 1e3 / float(np.median(steady)), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": launches, "grads0": grads0}


def grad_rel_err(a: dict, b: dict) -> float:
    """The largest ||a - b|| / ||b|| over the tensors of two gradients."""
    check(set(a) == set(b), "gradients of different tensors")
    return max(float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)) for n in b)


def phase_detection_training(dev, wrappers, smi: str) -> dict:
    """FRCNN fine-tuning at full width (bench.py --train frcnn in the port):
    R-101-C4 with ``FRCNNConfig(post_nms_topk=300, dtype="bfloat16")`` (6000
    pre-NMS proposals, 1600 classes, 400 attributes), seeded and tamed
    weights, B=2 on the 832 x 1344 canvas, 8 seeded ground-truth boxes an
    image; SGD at 1e-4 for 8 steps: K1 1, K10 1, K2 2 a step, finite losses
    and gradients. Then: the RPN head gets no gradient from the RoI losses
    alone; ``remat`` at B=2, its first step's loss and gradients against the
    plain run's (beside the plain run repeated, the noise of the atomics and
    of cuDNN's backward); ``remat`` at B=4; two AdamW steps with
    ``freeze_patterns=("^backbone/",)``: every backbone tensor bitwise
    unchanged, the heads moved. Step ms, steps/s and peak of each run."""
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.config import TrainConfig
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights
    from vltk_tpu_torch.ops import roi_pool_kernel as RK
    from vltk_tpu_torch.train.optim import make_optimizer

    cfg = FRCNNConfig(post_nms_topk=300, dtype="bfloat16")
    check((cfg.depth, cfg.pre_nms_topk, cfg.num_classes, cfg.num_attrs) == (101, 6000, 1600, 400), f"config {cfg}")
    t0 = time.perf_counter()
    state = tame_random_weights(init_weights(FRCNN(cfg), seed=0)).state_dict()
    init_s = time.perf_counter() - t0

    def model_of(c):
        m = FRCNN(c)
        m.load_state_dict(state)
        return m.to(dev).train()

    gen = torch.Generator().manual_seed(33)
    batch = detection_batch(gen, DET_BATCH, dev)
    with torch.no_grad():  # a ground-truth box on the first proposal: foreground for the box head
        proposals = model_of(cfg)(batch["images"], batch["sizes"], return_raw=True)["raw"]["proposals"]
    batch["gt_boxes"][:, 0] = torch.round(proposals[:, 0])
    out = {"init_s": init_s}

    model = model_of(cfg)
    # K10's inputs on the first step, to time it on the step's own proposals
    with first_call_of(RK, "roi_pool_backward_cuda") as recorded:
        plain = detection_steps(model, torch.optim.SGD(model.parameters(), lr=DET_LR), batch, DET_STEPS, wrappers,
                                "detection training")
    k10 = RK.roi_pool_backward_cuda
    out["plain"] = {k: v for k, v in plain.items() if k != "grads0"}
    print(f"detection training R-101-C4 bf16 B={DET_BATCH} canvas {CANVAS[0]}x{CANVAS[1]}, SGD {DET_LR}: "
          f"{DET_STEPS} steps, step {plain['step_ms']:.1f} ms ({plain['steps_per_s']:.2f} steps/s) on {smi}; "
          f"launches a step {plain['launches_per_step']}; peak {plain['peak_mem_gb']:.2f} GB; losses "
          f"(rpn_obj, rpn_loc, roi_cls, roi_box) first {np.round(plain['losses'][0], 5).tolist()} last "
          f"{np.round(plain['losses'][-1], 5).tolist()}")

    feat, boxes, g, s, scale = recorded[0]
    runs = spread_ms(lambda: k10(feat, boxes, g, s, scale), reps=10)
    plain_ms = cuda_ms(lambda: RK.roi_pool_plain_vjp(feat, boxes, g, s, scale), reps=1, warmup=1)
    bound_ms, bound_by = k10_bound(feat, boxes, g)
    tied = float((RK.roi_pool_plain_vjp(feat, boxes, g.abs(), s, scale) != 0).float().mean())
    out["k10_on_step"] = {"ms": runs[2], "ms_runs": runs, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "shape": list(feat.shape), "rois": boxes.shape[1],
                          "cells_with_a_gradient": tied}
    print(f"roi_pool_backward on the training step's own inputs {tuple(feat.shape)} {feat.dtype} x "
          f"{boxes.shape[1]}: {show(runs)}, plain VJP {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{runs[2] / bound_ms:.1f}x the bound; cells with a gradient {tied:.4f}")
    del recorded, feat, boxes, g

    # gradient reach: the RoI losses alone leave the RPN head untrained
    model.zero_grad(set_to_none=True)
    sum(detection_loss(model, batch, parts=("roi",))).backward()
    rpn = [p.grad for n, p in model.named_parameters() if n.startswith("proposal_generator.")]
    check(all(g is None or not g.any() for g in rpn), "fast_rcnn_losses alone gave the RPN head a gradient")
    check(model.roi_heads.box_predictor.cls_score.weight.grad.abs().sum() > 0, "no gradient to the RoI heads")
    print("gradient reach: fast_rcnn_losses alone give the RPN head no gradient (proposals detached)")
    del model
    torch.cuda.empty_cache()

    # the plain first step again (the run-to-run noise), then remat at B=2
    repeat = model_of(cfg)
    noise = detection_steps(repeat, torch.optim.SGD(repeat.parameters(), lr=DET_LR), batch, 1, wrappers, "repeat")
    del repeat
    torch.cuda.empty_cache()
    remat_cfg = dataclasses.replace(cfg, remat=True)
    model = model_of(remat_cfg)
    remat = detection_steps(model, torch.optim.SGD(model.parameters(), lr=DET_LR), batch, 2, wrappers, "remat B=2")
    noise_err = grad_rel_err(noise["grads0"], plain["grads0"])
    remat_err = grad_rel_err(remat["grads0"], plain["grads0"])
    loss_err = abs(sum(remat["losses"][0]) - sum(plain["losses"][0])) / abs(sum(plain["losses"][0]))
    out["remat"] = {"step_ms": remat["step_ms"], "peak_mem_gb": remat["peak_mem_gb"], "grad_rel_err": remat_err,
                    "repeat_grad_rel_err": noise_err, "loss_rel_err": loss_err,
                    "repeat_loss_rel_err": abs(sum(noise["losses"][0]) - sum(plain["losses"][0]))
                    / abs(sum(plain["losses"][0]))}
    print(f"remat B={DET_BATCH}: first-step loss rel err {loss_err:.3g}, gradients' largest relative norm error "
          f"{remat_err:.3g} (the plain step repeated: {noise_err:.3g}); step {remat['step_ms']:.1f} ms, peak "
          f"{remat['peak_mem_gb']:.2f} GB (plain {plain['peak_mem_gb']:.2f} GB)")
    check(loss_err <= 1e-3 and remat_err <= max(2.0 ** -5, 4 * noise_err),
          f"remat changes the step: loss {loss_err}, gradients {remat_err} (repeat {noise_err})")
    del model, remat, noise
    torch.cuda.empty_cache()

    model = model_of(remat_cfg)
    big = detection_batch(gen, 2 * DET_BATCH, dev)
    remat4 = detection_steps(model, torch.optim.SGD(model.parameters(), lr=DET_LR), big, 3, wrappers, "remat B=4")
    out["remat_b4"] = {k: v for k, v in remat4.items() if k != "grads0"}
    print(f"remat B={2 * DET_BATCH}: step {remat4['step_ms']:.1f} ms ({2 * DET_BATCH * remat4['steps_per_s']:.2f} "
          f"images/s), peak {remat4['peak_mem_gb']:.2f} GB; losses first "
          f"{np.round(remat4['losses'][0], 5).tolist()} last {np.round(remat4['losses'][-1], 5).tolist()}")
    del model, big, remat4
    torch.cuda.empty_cache()

    # freeze: AdamW over the heads only
    model = model_of(cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = make_optimizer(model, TrainConfig(learning_rate=1e-4, warmup_ratio=0.0), 4,
                                freeze_patterns=("^backbone/",))
    frozen = detection_steps(model, opt, batch, 2, wrappers, "frozen backbone", sched)
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    backbone = {n for n in before if n.startswith("backbone.")}
    check(not (moved & backbone), f"frozen backbone tensors moved: {sorted(moved & backbone)[:5]}")
    check("roi_heads.box_predictor.cls_score.weight" in moved and "proposal_generator.rpn_head.conv.weight" in moved,
          "the heads did not move")
    out["freeze"] = {"backbone_tensors": len(backbone), "moved": len(moved), "step_ms": frozen["step_ms"],
                     "peak_mem_gb": frozen["peak_mem_gb"]}
    print(f"freeze_patterns ^backbone/: {len(backbone)} backbone tensors bitwise unchanged, {len(moved)} head "
          f"tensors moved over 2 AdamW steps; step {frozen['step_ms']:.1f} ms, peak {frozen['peak_mem_gb']:.2f} GB")
    out["launches"] = {k: v * DET_STEPS for k, v in plain["launches_per_step"].items()}
    del model, before, opt
    torch.cuda.empty_cache()
    return out


DET_IMAGES = 16
DET_VISION_SIZE = (800, 1333)  # canvas_for -> 1344 x 1344


def phase_detection_experiments(dev, wrappers, smi: str) -> dict:
    """The experiments from raw COCO JSON: 16 images of the seeded corpus
    (480 x 640, three categories) -> the coco2014 adapter's Arrow table ->
    ``build(config)`` (max_detections 36, segmentation ignored, vision size
    (800, 1333): the 1344 x 1344 canvas) -> ``FRCNNDetectExperiment`` at
    R-101-C4 bf16 (tamed seeded weights, the class head sized from the label
    table), B=2: one epoch of 8 steps and the eval loop with ``map50``;
    launches counted over the run (train K1 1, K10 1, K2 2 a step, K10 on
    its two-band path; eval K1 and K2 in both of its passes); K10 timed on
    the first step's own inputs; the step with the loader and without it. Then a ``ComplexExperiment`` over the same model (one detection
    train loop, one eval loop, both run, finite losses), and one LXMERT-base
    VQA step at B=32 with ``remat`` against the same step without it."""
    import tempfile

    from vltk_tpu_torch import build
    from vltk_tpu_torch.adapters import Adapters
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import FRCNNDetectExperiment, LxmertVQAExperiment
    from vltk_tpu_torch.models.frcnn import FRCNNConfig
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.ops import roi_pool_kernel as RK
    from vltk_tpu_torch.tools.synthetic_corpus import write_corpus
    from vltk_tpu_torch.train import ComplexExperiment, Loop

    class Detect(FRCNNDetectExperiment):
        model_config = FRCNNConfig(post_nms_topk=300, dtype="bfloat16")

        def build_model(self):
            return tame_random_weights(super().build_model())

    class DetectLoops(ComplexExperiment, Detect):
        name = "frcnn_detect_loops"

        def loops(self):
            return [Loop("detect", self.train_loader), Loop.eval_instance("val", self.train_loader)]

    out: dict = {}
    n_steps = DET_IMAGES // DET_BATCH
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_detect_") as root:
        datadir = os.path.join(root, "data")
        write_corpus(datadir, DET_IMAGES, 16, hw=RAW_HW, seed=0)
        t0 = time.perf_counter()
        Adapters.get("coco2014").extract(datadir)
        out["etl_s"] = time.perf_counter() - t0
        config = Config()
        config.logdir = os.path.join(root, "logs")
        config.data.update(dict(datadir=datadir, train_datasets=(("coco2014", "train"),),
                                train_batch_size=DET_BATCH, num_workers=4, shuffle=False, drop_last=True,
                                max_detections=36, ignore_segmentation=True))
        config.data.vision.update({"size": DET_VISION_SIZE})
        config.train.update(dict(epochs=1, learning_rate=1e-4, weight_decay=0.0, warmup_ratio=0.0))
        train, _ = build(config)
        check(len(train) == n_steps, f"detection loader: {len(train)} batches")
        exp = Detect(config, loaders=(train, train), device=dev)
        classes = exp.model_config.num_classes
        check(exp.model_config.depth == 101 and classes == len(train.metadata_ids["labels"]),
              f"class head {classes}")
        for w in wrappers.values():
            w.launches = 0
        k10_paths = wrappers["roi_pool_backward"].path_launches
        k10_paths.update(dict.fromkeys(k10_paths, 0))
        # K10's inputs on the first step, to time it on the canvas's own proposals
        with first_call_of(RK, "roi_pool_backward_cuda") as recorded:
            t0 = time.perf_counter()
            result = exp()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        k10 = RK.roi_pool_backward_cuda
        launches = {k: w.launches for k, w in wrappers.items()}
        want = {"roi_pool": 3 * n_steps, "roi_pool_backward": n_steps, "nms": 6 * n_steps}
        check(launches == {k: want.get(k, 0) for k in launches}, f"detection experiment launches {launches}")
        # the 84 x 84 map: bf16 sums in two row bands
        check(k10_paths["vector_banded"] == n_steps, f"detection experiment K10 paths {k10_paths}")
        paths = dict(k10_paths)  # the epoch's, before the timing calls below add theirs
        feat, boxes, g, s, scale = recorded[0]
        runs = spread_ms(lambda: k10(feat, boxes, g, s, scale), reps=10)
        bound_ms, bound_by = k10_bound(feat, boxes, g)
        out["k10_on_step"] = {"ms": runs[2], "ms_runs": runs, "bound_ms": bound_ms, "bound_by": bound_by,
                              "shape": list(feat.shape), "rois": boxes.shape[1], "paths": paths}
        print(f"roi_pool_backward on the experiment step's own inputs {tuple(feat.shape)} {feat.dtype} x "
              f"{boxes.shape[1]} (vector_banded path): {show(runs)}, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{runs[2] / bound_ms:.1f}x the bound")
        del recorded, feat, boxes, g
        train_m, eval_m = result["train"], result["eval"]
        check(all(np.isfinite(v) for v in train_m.values()) and 0.0 <= eval_m["map50"] <= 1.0,
              f"detection experiment: train {train_m}, eval {eval_m}")
        _, loop = loader_against_control(exp, n_steps, "detection")
        out["experiment"] = {"launches": launches, "train": train_m, "eval": eval_m, "run_s": run_s,
                             "classes": classes, "step_ms_with_loader": loop["with"],
                             "step_ms_without_loader": loop["without"]}
        print(f"FRCNNDetectExperiment R-101-C4 bf16 from raw COCO JSON, {DET_IMAGES} images on the 1344x1344 "
              f"canvas, B={DET_BATCH}, {classes} classes: one epoch of {n_steps} steps and the eval loop in "
              f"{run_s:.1f} s; launches {launches} (train K1 1, K10 1, K2 2 a step; eval K1 1, K2 2 in each of "
              f"its two passes); loss {train_m['loss']:.5f}, map50 {eval_m['map50']:.4f}; step with the loader "
              f"{loop['with']['median']:.1f} ms, without {loop['without']['median']:.1f} ms on {smi}")
        del exp
        gc.collect()
        torch.cuda.empty_cache()

        config.logdir = os.path.join(root, "logs_loops")
        loops = DetectLoops(config, loaders=(train, None), device=dev)
        result = loops()
        torch.cuda.synchronize()
        check(set(result) == {"epoch", "detect", "val"} and all(np.isfinite(v) for v in result["detect"].values())
              and all(np.isfinite(v) for v in result["val"].values()), f"ComplexExperiment: {result}")
        with open(os.path.join(loops.logdir, "steps_log.json")) as f:
            records = [json.loads(line) for line in f]
        check([r["loop"] for r in records] == ["detect"] * n_steps and loops.total_steps == n_steps,
              f"ComplexExperiment records {[r['loop'] for r in records]}, total steps {loops.total_steps}")
        out["complex"] = {"detect": result["detect"], "val": result["val"]}
        print(f"ComplexExperiment (detect + val loops): detect loss {result['detect']['loss']:.5f}, val rpn_obj "
              f"{result['val']['rpn_obj']:.5f}, {n_steps} detect steps logged")
        del loops
        gc.collect()
        torch.cuda.empty_cache()

        lx = {}
        host = lxmert_train_batch(LXMERT_TRAIN_BATCH, LxmertConfig(), seed=0)
        for remat in (False, True):
            cfg = LxmertConfig(dtype="bfloat16", remat=remat)
            exp = lxmert_experiment(LxmertVQAExperiment, cfg, os.path.join(root, f"lxmert_{remat}"), [host], 1e-5,
                                    device=dev)
            data = next(iter(exp._device_batches([host])))
            torch.manual_seed(34)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            metrics = exp.train_step(data)
            torch.cuda.synchronize()
            lx[remat] = {"loss": float(metrics["loss"]), "step_ms": (time.perf_counter() - t0) * 1e3,
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "step_peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9}
            del exp, data, metrics
            gc.collect()  # the experiment's step holds its bound loss_fn: a cycle
            torch.cuda.empty_cache()
        rel = abs(lx[True]["loss"] - lx[False]["loss"]) / abs(lx[False]["loss"])
        check(rel <= 1e-3, f"LXMERT remat loss {lx[True]['loss']} != {lx[False]['loss']}")
        out["lxmert_remat"] = {"plain": lx[False], "remat": lx[True], "loss_rel_err": rel}
        print(f"LXMERT-base VQA step B={LXMERT_TRAIN_BATCH} bf16 (dropout on, one seed): loss {lx[False]['loss']:.6f}, "
              f"with remat {lx[True]['loss']:.6f} (rel err {rel:.3g}); peak {lx[False]['peak_mem_gb']:.2f} GB, "
              f"with remat {lx[True]['peak_mem_gb']:.2f} GB (above what the step started with: "
              f"{lx[False]['step_peak_gb']:.2f} / {lx[True]['step_peak_gb']:.2f} GB; first steps: "
              f"{lx[False]['step_ms']:.0f} / {lx[True]['step_ms']:.0f} ms)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import vltk_tpu_torch

    pkg = os.path.dirname(os.path.abspath(vltk_tpu_torch.__file__))
    check(os.path.dirname(pkg) == HERE, f"vltk_tpu_torch is not this checkout's ({pkg})")
    from vltk_tpu_torch.adapters.frcnn import setup, tame_random_weights
    from vltk_tpu_torch.ops import KERNEL_WRAPPERS, _build
    from vltk_tpu_torch.tools.bench_nms import step_calls

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    outputs = _build.build(["roi_pool", "roi_pool_bwd", "roi_pool_ablation", "nms", "flash_attention",
                            "flash_attention_bwd"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({', '.join(outputs) or 'cached'})")
    for name, out in outputs.items():
        for line in _build.ptxas_lines(out):
            print(f"  {name}: {line}")

    entries = [phase_roi_pool(dev, _build.ptxas_lines(outputs.get("roi_pool", "")))]
    ablation = phase_roi_ablation(dev, _build.ptxas_lines(outputs.get("roi_pool_ablation", "")))
    entries.append(phase_nms(dev, batch=8, ptxas=_build.ptxas_lines(outputs.get("nms", ""))))
    phase_nms(dev, batch=16)  # the B=16 step's shapes: checked and timed, not in the line
    entries.append(phase_flash(dev, _build.ptxas_lines(outputs.get("flash_attention", ""))))
    entries += phase_flash_backward(dev)
    entries.append(phase_roi_pool_backward(dev, _build.ptxas_lines(outputs.get("roi_pool_bwd", ""))))
    stamp("the build and the kernel phases (K10: phase 32)")

    bundle, info = setup(
        preset="parity_300", batch_size=8, device=dev,
        resized_canvas=CANVAS, short=800.0, maximum=1333.0,
    )
    cfg = bundle["cfg"]
    check(
        (cfg.depth, cfg.num_classes, cfg.num_attrs, cfg.pre_nms_topk, cfg.post_nms_topk,
         cfg.dtype) == (101, 1600, 400, 6000, 300, "bfloat16"),
        f"parity_300 config {cfg}",
    )
    tame_random_weights(bundle["model"])
    runs = {}
    for batch, steps in ((8, 5), (16, 3)):
        torch.cuda.reset_peak_memory_stats()
        if batch == 8:
            proposals, hook = capture_roi_inputs(bundle["model"])
        runs[batch] = r = run_extraction(bundle, batch, steps, KERNEL_WRAPPERS)
        if batch == 8:
            hook.remove()
            # K2's inputs: one more B=8 step with its two calls recorded,
            # after the launch counts were read
            nms_calls = step_calls(bundle, *step_images(dev, 8))
        print(
            f"extraction parity_300 B={batch} canvas {CANVAS[0]}x{CANVAS[1]} bf16: "
            f"{r['images_per_s']:.2f} images/s ({r['step_ms']:.2f} ms/step) on {smi}; "
            f"launches {r['launches']} over {steps + 1} steps; peak {r['peak_mem_gb']:.2f} GB; "
            f"preds/image {r['preds_per_image']}"
        )
    print("extraction_runs " + json.dumps(runs))
    stamp("extraction")
    time_roi_pool_on_proposals(entries[0], proposals)
    time_nms_on_step(next(e for e in entries if e["name"] == "nms_fixed"), nms_calls)
    del proposals, nms_calls

    int8_shapes = Int8Shapes()  # every int8 product geometry of the int8 paths, checked at the end
    int8_extraction = phase_int8_extraction(dev, bundle, runs, KERNEL_WRAPPERS, smi, int8_shapes)
    print("int8_extraction_run " + json.dumps(int8_extraction))
    torch.cuda.empty_cache()
    print("probe_int8_and_stem " + json.dumps(phase_probe_int8_and_stem(dev, bundle, smi)))
    torch.cuda.empty_cache()

    phase_small_reference(dev)
    stamp("the int8 extraction, the int8 probe and the small reference")
    del bundle
    torch.cuda.empty_cache()

    vqa = phase_vqa(dev, KERNEL_WRAPPERS, smi)
    k2 = next(e for e in entries if e["name"] == "nms_fixed")
    k2["max_abs_err"] = max(k2["max_abs_err"], vqa["pad_rows"].pop("nms_max_abs_err"))
    print("vqa_run " + json.dumps(vqa))
    phase_small_vqa(dev)
    torch.cuda.empty_cache()
    vqa_int8 = phase_int8_vqa(dev, KERNEL_WRAPPERS, smi, vqa["timed"], int8_shapes)
    print("int8_vqa_run " + json.dumps(vqa_int8))
    stamp("VQA")
    torch.cuda.empty_cache()

    doc = phase_document(dev, KERNEL_WRAPPERS, smi)
    print("document_run " + json.dumps(doc))
    phase_small_layoutlm(dev)

    train = phase_training(dev, KERNEL_WRAPPERS, smi)
    print("training_run " + json.dumps(train))
    phase_route_gradients(dev)
    phase_small_layoutlm_train(dev)
    stamp("documents and training")

    span = phase_span(dev, KERNEL_WRAPPERS, smi)
    print("span_run " + json.dumps(span))
    phase_small_span(dev)
    doc_int8 = phase_int8_document(dev, KERNEL_WRAPPERS, smi, doc["timed"], span["timed"], int8_shapes)
    print("int8_document_run " + json.dumps(doc_int8))
    phase_small_int8(dev)
    span_train = phase_span_training(dev, KERNEL_WRAPPERS, smi)
    print("span_training_run " + json.dumps(span_train))
    phase_small_span_train(dev)
    lxmert_train = phase_lxmert_train(dev, KERNEL_WRAPPERS, smi)
    print("lxmert_training_run " + json.dumps(lxmert_train))
    phase_small_pretrain(dev)
    stamp("span QA, int8 documents and the LXMERT trainers")
    vit = phase_vit(dev, KERNEL_WRAPPERS, smi, int8_shapes)
    print("vit_run " + json.dumps(vit))
    visualbert = phase_visualbert(dev, KERNEL_WRAPPERS, smi)
    print("visualbert_run " + json.dumps(visualbert))
    moe = phase_moe(dev, KERNEL_WRAPPERS, smi)
    print("moe_run " + json.dumps(moe))
    server = phase_server(dev, KERNEL_WRAPPERS, smi)
    print("server_run " + json.dumps(server))
    phase_small_encoders(dev)
    stamp("the other encoders and the server")
    data = phase_data(dev, KERNEL_WRAPPERS, smi)
    print("data_run " + json.dumps(data))
    stamp("the data plane (phase 29)")
    raw_docs = phase_raw_documents(dev, KERNEL_WRAPPERS, smi)
    print("raw_documents_run " + json.dumps(raw_docs))
    stamp("documents from raw JSON (phase 30)")
    gqa = phase_gqa(dev, KERNEL_WRAPPERS, smi)
    print("gqa_run " + json.dumps(gqa))
    stamp("GQA on Visual Genome (phase 31)")
    detection = phase_detection_training(dev, KERNEL_WRAPPERS, smi)
    print("detection_training_run " + json.dumps(detection))
    # K10's line: the time on the training step's own inputs (phase 32's
    # tie-heavy integer map stays beside it)
    k10 = next(e for e in entries if e["name"] == "roi_pool_backward")
    step_inputs = detection["k10_on_step"]
    k10.update(ms_tie_heavy=k10["ms"], plain_ms_tie_heavy=k10["plain_ms"], ms=step_inputs["ms"],
               ms_runs=step_inputs["ms_runs"], plain_ms=step_inputs["plain_ms"], bound_ms=step_inputs["bound_ms"],
               bound_by=step_inputs["bound_by"])
    stamp("detection training (phase 33)")
    detect_exp = phase_detection_experiments(dev, KERNEL_WRAPPERS, smi)
    print("detection_experiments_run " + json.dumps(detect_exp))
    # and on the 1344 x 1344 experiment's own inputs (phase 34)
    k10["canvas_1344"]["experiment_inputs"] = detect_exp["k10_on_step"]
    stamp("the detection experiments from raw COCO JSON (phase 34)")
    print("int8_products " + json.dumps(phase_int8_products(dev, int8_shapes)))

    # launches as counted on each kernel's main path: the B=8 extraction
    # run for K1 and K2, the document requests for K3, the training epoch
    # for K4 and K5, the detection training run for K10
    launches = {
        "roi_pool": runs[8]["launches"]["roi_pool"],
        "nms_fixed": runs[8]["launches"]["nms"],
        "flash_attention": doc["launches"]["flash_attention"],
        "flash_attention_dkv": train["launches"]["flash_attention_dkv"],
        "flash_attention_dq": train["launches"]["flash_attention_dq"],
        "roi_pool_backward": detection["launches"]["roi_pool_backward"],
    }
    for e in entries:
        e["launches"] = launches[e["name"]]
    # K6-K9: launches counted on the probe's path inside their phase. Every
    # kernel also carries its launches on the two span paths (K3 12 a
    # forward in serving; K3, K5, K4 12 each a step in training)
    for e in entries + ablation:
        key = {"nms_fixed": "nms"}.get(e["name"], e["name"])
        e["span_serving_launches"] = span["launches"].get(key, 0)
        e["span_training_launches"] = span_train["launches"].get(key, 0)
        # the int8 paths: extraction B=8 (6 steps), VQA (3 buckets), one
        # document and one span request
        e["int8_extraction_launches"] = int8_extraction["runs"][8]["launches"].get(key, 0)
        e["int8_vqa_launches"] = vqa_int8["launches"].get(key, 0)
        e["int8_document_launches"] = doc_int8["documents"]["launches"].get(key, 0)
        e["int8_span_launches"] = doc_int8["span"]["launches"].get(key, 0)
        # the other encoders (one forward each), MoE LXMERT's 4 training
        # steps and the server's burst
        e["vit_launches"] = vit["launches"].get(key, 0)
        e["visualbert_launches"] = visualbert["launches"].get(key, 0)
        e["moe_lxmert_launches"] = moe["launches"].get(key, 0)
        e["server_launches"] = server["launches"].get(key, 0)
        # the host data plane: the extraction pipeline's 8 steps (K1 8, K2
        # 16) and the LXMERT epoch from build (none)
        e["data_extraction_launches"] = data["extraction_launches"].get(key, 0)
        e["data_training_launches"] = data["training_launches"].get(key, 0)
        # documents from raw JSON (FUNSD 8 steps, DocVQA 16: K3, K5, K4 12
        # each a step) and GQA on VG (extraction K1 8, K2 16; LXMERT none)
        e["funsd_training_launches"] = raw_docs["funsd"]["launches"].get(key, 0)
        e["docvqa_training_launches"] = raw_docs["docvqa"]["launches"].get(key, 0)
        e["gqa_extraction_launches"] = gqa["extraction_launches"].get(key, 0)
        e["gqa_training_launches"] = gqa["training_launches"].get(key, 0)
        # detection training (8 steps at B=2: K1 1, K10 1, K2 2 a step) and
        # the detection experiment from raw COCO JSON (an epoch of 8 steps
        # and its eval loop)
        e["detection_training_launches"] = detection["launches"].get(key, 0)
        e["detection_experiment_launches"] = detect_exp["experiment"]["launches"].get(key, 0)
    # K3 at the attention shapes of ViT-B/16 (no mask) and VisualBERT
    k3 = next(e for e in entries if e["name"] == "flash_attention")
    for model, run in (("vit", vit), ("visualbert", visualbert)):
        k3.update({f"{model}_{k}": v for k, v in run["k3"].items()})
    print(json.dumps({"kernels": entries + ablation}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


# the guard matters: phase 31's spawned host-pipeline workers import this
# module again (as __mp_main__) and must not run the script
if __name__ == "__main__":
    sys.exit(main())
