"""Where the device time of a main path goes, on the card.

    python -m vltk_tpu_torch.trace [--batch 8] [--steps 3] [--repeats 3] [--preset parity_300|production|...]
    python -m vltk_tpu_torch.trace --model layoutlm [--attn auto|xla] [--batch 32] [--int8]
    python -m vltk_tpu_torch.trace --model layoutlm --train [--attn auto|xla] [--batch 8]
    python -m vltk_tpu_torch.trace --model layoutlm --train [--attn auto|xla] --lrs 1e-4 1e-5
    python -m vltk_tpu_torch.trace --model vqa [--batch 8] [--int8]
    python -m vltk_tpu_torch.trace --model vit [--attn flash|xla] [--batch 64] [--int8]
    python -m vltk_tpu_torch.trace --model visualbert [--attn flash|xla] [--batch 32]
    python -m vltk_tpu_torch.trace --model frcnn --train [--batch 2] [--remat]

``--model frcnn`` (default) builds the ``--preset`` extraction (default
``parity_300``: R-101-C4, 1600 classes, 400 attributes, bf16; ``production``
is ``int8_300``, calibrated by its first step) on the 832x1344 canvas with
seeded random tamed weights, as ``chip_smoke.py`` does. ``--int8`` puts
``--model vqa`` on the int8 FRCNN and LXMERT and ``--model layoutlm`` on
int8 LayoutLM, calibrated on the traced inputs before the first step. ``--model layoutlm``
builds the document classifier step (``predict.DocTokenClassifier.step``:
LayoutLM-base, 12 layers, hidden 768, bf16, seeded random weights) at the
JAX bench.py geometry: seq 1024, batch 32, ids and boxes from
``default_rng(0)``, device-resident; ``--attn auto`` sends every
self-attention through the flash kernel K3, ``--attn xla`` takes the dense
route. ``--train`` times the training step of ``OCRTokenExperiment``
instead (``make_train_step``: forward, token cross entropy, backward,
clipped AdamW, schedule) at the JAX bench.py ``--train layoutlm``
geometry: seq 1024, batch 8, a 20% pad tail with -100 labels on it,
attention dropout 0 (hidden dropout 0.1); on ``--attn auto`` K3 runs with
its statistics in the forward and K4 and K5 in the backward. ``--model
vqa`` builds the composed VQA step (``predict.VQAPredictor.step``: the
``parity_300`` FRCNN, tamed, then LXMERT-base in bf16 with seeded random
weights, 3129 answers) on the extraction canvas, with 8 questions of 20
tokens. ``--model vit`` builds ViT-B/16 at 224 (bf16, seeded random
weights; ``--int8`` calibrated on the first 8 images) over bench.py's 64
images from ``default_rng(0)``; ``--attn flash`` (its default) sends
each layer's self-attention (197 tokens, no mask) to K3. ``--model
visualbert`` builds the VisualBERT classifier at visualbert-vqa width (12
layers, 768, 2048-d regions; bf16) over 32 rows of 128 text tokens of
varied real length and 36 regions (164 positions, padded to 256 by K3),
``--attn flash`` (default) or ``xla``. ``--model frcnn --train`` times
bench.py's ``--train frcnn`` step in the port: R-101-C4 with
``FRCNNConfig(post_nms_topk=300, dtype="bfloat16")`` (6000 pre-NMS
proposals, 1600 classes, 400 attributes; ``--remat`` checkpoints the
backbone blocks), seeded tamed weights, batch 2 on the 832x1344 canvas
with 8 seeded ground-truth boxes an image (the first on a proposal),
``rpn_losses`` at 256 and ``fast_rcnn_losses`` at 128 an image, SGD at
1e-4: the RoIPool forward K1 and backward K10 once and the NMS K2 twice a
step. It prints:

* the step time over ``--repeats`` windows of ``--steps`` steps (host
  clock, synchronised), to show the spread;
* the device time of each stage of one step (CUDA events between the
  stages: preprocess, backbone, RPN head, propose, RoI heads, postprocess
  (and for VQA then LXMERT's embeddings with the box normalisation and
  the visual projection, language layers, visual layers, cross layers,
  pooler and answer head); or embeddings, encoder, head (also for ViT
  and VisualBERT); or forward, backward, optimizer);
* from a ``torch.profiler`` trace of ``--steps`` steps: device time by
  kernel class and the top kernels, and the device's busy share of the
  traced span (union of kernel intervals over first-start..last-end); on
  an int8 path also the device time under the int8 layers' quantize,
  int8 product and rescale ranges (``ops.int8.profile_scopes``, on only
  while the profiler runs).

The last line is one JSON object with all of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

RAW_CANVAS = (512, 672)
RAW_HW = (480, 640)
CANVAS = (832, 1344)

# kernel-name fragments -> class, first match wins
_CLASSES = (
    ("flash_fwd", "flash attention kernel"),
    ("flash_bwd_dkv", "flash dk/dv kernel (K4)"),
    ("flash_bwd_dq", "flash dq kernel (K5)"),
    ("roi_pool_bwd", "roi_pool backward kernel (K10)"),
    ("cast_out", "roi_pool backward kernel (K10)"),  # K10's cast pass
    ("roi_pool_", "roi_pool kernel"),  # K1: roi_pool_{bf16,f32}_{vector,scalar}
    ("gemm_s8", "int8 gemm"),  # torch._int_mm's cuBLASLt products (cutlass_80_..._i16832gemm_s8_...)
    ("imma", "int8 gemm"),
    ("nms_", "nms kernels"),
    ("sort", "sort"),
    ("radix", "sort"),
    ("conv", "conv / gemm"),
    ("gemm", "conv / gemm"),
    ("nvjet", "conv / gemm"),  # cuBLASLt / cuDNN matrix-product kernels
    ("xmma", "conv / gemm"),
    ("cutlass", "conv / gemm"),
    ("cudnn", "conv / gemm"),
    ("sm90", "conv / gemm"),
    ("nchwToNhwc", "layout"),
    ("nhwcToNchw", "layout"),
    ("softmax", "softmax"),
    ("layer_norm", "layer norm"),
    ("elementwise", "elementwise"),
    ("reduce", "reduction"),
    ("index", "gather / index"),
    ("gather", "gather / index"),
    ("scatter", "gather / index"),
    ("cat", "copy / cat"),
    ("copy", "copy / cat"),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for frag, cls in _CLASSES:
        if frag.lower() in low:
            return cls
    return "other"


def build_frcnn(batch: int, preset: str = "parity_300"):
    from vltk_tpu_torch.adapters.frcnn import setup, tame_random_weights

    bundle, _ = setup(
        preset=preset, batch_size=batch, device="cuda",
        resized_canvas=CANVAS, short=800.0, maximum=1333.0,
    )
    tame_random_weights(bundle["model"])
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(
        rng.integers(0, 256, (batch, *RAW_CANVAS, 3), dtype=np.uint8)
    ).cuda()
    sizes = torch.tensor([RAW_HW] * batch, dtype=torch.int32, device="cuda")
    return bundle, raw, sizes


DOC_SEQ = 1024  # bench.py --infer layoutlm: --seq default, batch 32 * 1024 // seq


def build_layoutlm(batch: int, attn: str, int8: bool = False):
    """The document classifier at LayoutLM-base width and the bench.py
    inputs: ids and boxes from default_rng(0), an all-real mask."""
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig
    from vltk_tpu_torch.predict import DocTokenClassifier

    cfg = LayoutLMConfig(dtype="bfloat16", max_position_embeddings=DOC_SEQ, attention_impl=attn, int8=int8)
    clf = DocTokenClassifier(
        ["other", "question", "answer", "header"], config=cfg,
        batch_size=batch, max_seq_length=DOC_SEQ, device="cuda",
    )
    ids, boxes, mask = bench_documents(batch, cfg.vocab_size, "cuda")
    return clf, ids, boxes, mask


VQA_SEQ = 20
VQA_QUESTIONS = (
    "what color is the car?", "how many people are in the picture?", "is there a dog on the grass?",
    "what is the man holding in his left hand?", "where is the cat sitting?", "is it raining?",
    "what sport is being played on the field today?", "which animal is bigger, the horse or the cow?",
)


def build_vqa(batch: int, device="cuda", int8: bool = False):
    """The composed VQA predictor at full width on the extraction canvas:
    parity_300 (tamed seeded weights), LXMERT-base bf16, 3129 answers; with
    ``int8`` the FRCNN is ``int8_300`` and LXMERT-base int8 (the JAX
    bench's composed row)."""
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.models.frcnn import FRCNNConfig
    from vltk_tpu_torch.models.lxmert import LxmertConfig
    from vltk_tpu_torch.predict import VQAPredictor

    configs = dict(frcnn_config=FRCNNConfig.int8_extraction(), lxmert_config=LxmertConfig(dtype="bfloat16", int8=True))
    pred = VQAPredictor(
        [f"answer {i}" for i in range(3129)], batch_size=batch, max_seq_length=VQA_SEQ, **(configs if int8 else {}),
        raw_canvas=RAW_CANVAS, resized_canvas=CANVAS, short=800.0, maximum=1333.0, device=device,
    )
    tame_random_weights(pred.frcnn)
    return pred


def vqa_inputs(pred, batch: int, device):
    """A device-resident bucket: seeded 480x640 raw images on the raw
    canvas, their sizes, and the questions' ids and masks."""
    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 256, (batch, *RAW_CANVAS, 3), dtype=np.uint8)).to(device)
    sizes = torch.tensor([RAW_HW] * batch, dtype=torch.float32, device=device)
    enc = pred.tokenizer.encode_batch([VQA_QUESTIONS[i % len(VQA_QUESTIONS)] for i in range(batch)])
    ids = torch.from_numpy(np.stack([e["input_ids"] for e in enc])).to(device)
    tmask = torch.from_numpy(np.stack([e["text_attention_mask"] for e in enc]).astype(np.float32)).to(device)
    return raw, sizes, ids, tmask


VIT_BATCH = 64  # bench.py --infer vit


def build_vit(batch: int, attn: str, int8: bool = False, device="cuda"):
    """ViT-B/16 at 224, bf16, seeded random weights, over bench.py's images
    (``default_rng(0)`` normal, NHWC, on the device); with ``int8`` the
    scales are calibrated on the first 8 images, as bench.py does."""
    from vltk_tpu_torch.models.layers import calibrate_int8_scales
    from vltk_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights

    cfg = ViTConfig(dtype="bfloat16", attention_impl=attn, int8=int8)
    model = init_vit_weights(ViT(cfg), seed=0).to(device).eval()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    images = images.to(device)
    if int8:
        calibrate_int8_scales(model, [(images[:min(batch, 8)],)])
    return model, images


VB_TEXT, VB_REGIONS = 128, 36  # visualbert-vqa: 128 text tokens, 36 regions


def visualbert_inputs(batch: int, cfg, device, seed: int = 0):
    """ids, region features, a text mask of real lengths 8-128 (the pad
    leaves a hole between text and regions), a visual mask (a quarter of
    the rows with 10-35 real regions), token types 0; on the device."""
    rng = np.random.default_rng(seed)
    t_real = rng.integers(8, VB_TEXT + 1, batch)
    tmask = (np.arange(VB_TEXT)[None] < t_real[:, None]).astype(np.float32)
    v_real = np.where(rng.random(batch) < 0.25, rng.integers(10, VB_REGIONS, batch), VB_REGIONS)
    vmask = (np.arange(VB_REGIONS)[None] < v_real[:, None]).astype(np.float32)
    ids = np.where(tmask > 0, rng.integers(1000, cfg.vocab_size, (batch, VB_TEXT)), 0)
    feats = np.abs(rng.normal(size=(batch, VB_REGIONS, cfg.visual_feat_dim))) * vmask[..., None]
    put = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    return put(ids, torch.int64), put(feats, torch.float32), put(tmask, torch.float32), put(vmask, torch.float32)


def build_visualbert(batch: int, attn: str, device="cuda"):
    """The VisualBERT classifier at visualbert-vqa width (12 layers, 768,
    12 heads, 2048-d regions), bf16, seeded random weights, and its inputs."""
    from vltk_tpu_torch.models.lxmert import init_weights
    from vltk_tpu_torch.models.visualbert import VisualBertConfig, VisualBertForClassification

    cfg = VisualBertConfig(dtype="bfloat16", attention_impl=attn)
    model = init_weights(VisualBertForClassification(cfg), seed=0).to(device).eval()
    return model, visualbert_inputs(batch, cfg, device)


def bench_documents(batch: int, vocab_size: int, device):
    """bench.py's LayoutLM inputs (--infer layoutlm), on the device."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab_size, (batch, DOC_SEQ))
    boxes = np.sort(rng.integers(0, 1000, (batch, DOC_SEQ, 2, 2)), axis=2).reshape(batch, DOC_SEQ, 4)
    put = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    return (put(ids, torch.int64), put(boxes, torch.int64),
            torch.ones((batch, DOC_SEQ), dtype=torch.float32, device=device))


TRAIN_SEQ = 1024  # bench.py --train layoutlm: --seq default, batch 8 * 1024 // seq


def train_documents(batch: int, vocab_size: int, num_labels: int, device):
    """bench.py's LayoutLM training inputs (--train layoutlm), on the
    device: ids, boxes (x0 y0 in [0, 900), w h in [1, 100)), a 20% pad
    tail, labels with -100 on the pad."""
    s = TRAIN_SEQ
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab_size, (batch, s))
    xy0 = rng.integers(0, 900, (batch, s, 2))
    wh = rng.integers(1, 100, (batch, s, 2))
    boxes = np.concatenate([xy0, xy0 + wh], axis=-1)
    mask = np.ones((batch, s), np.float32)
    mask[:, int(s * 0.8):] = 0.0
    labels = rng.integers(0, num_labels, (batch, s))
    labels[mask == 0.0] = -100
    put = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    return {"vtext": put(ids, torch.int32), "tokenbox": put(boxes, torch.int32),
            "visual_attention_mask": put(mask, torch.float32), "tokenlabels": put(labels, torch.int32)}


def layoutlm_train_config(attn: str, hidden_dropout: float = 0.1):
    """LayoutLM-base, bf16, seq 1024, attention dropout 0 (bench.py)."""
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    return LayoutLMConfig(dtype="bfloat16", max_position_embeddings=TRAIN_SEQ, attention_impl=attn,
                          attention_dropout=0.0, hidden_dropout=hidden_dropout)


def train_experiment(cfg, logdir: str, loader, lr: float = 1e-4):
    """An ``OCRTokenExperiment`` for one epoch over ``loader`` at the model
    config ``cfg``, seeded random weights, on CUDA; AdamW at ``lr`` with
    weight decay 0.01, warmup 0.1 and clip 1.0."""
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import OCRTokenExperiment

    class Experiment(OCRTokenExperiment):
        model_config = cfg

    config = Config()
    config.logdir = logdir
    config.data.lang.update({"max_visual_seq_length": cfg.max_position_embeddings})
    config.train.update({"epochs": 1, "learning_rate": lr, "weight_decay": 0.01,
                         "warmup_ratio": 0.1, "clip_grad_norm": 1.0})
    return Experiment(config, loaders=(loader, None), device="cuda")


def build_layoutlm_train(batch: int, attn: str, logdir: str):
    """The experiment over bench.py's training batch, and that batch on the
    device as its train step takes it."""
    cfg = layoutlm_train_config(attn)
    data = train_documents(batch, cfg.vocab_size, cfg.num_labels, "cuda")
    exp = train_experiment(cfg, logdir, [data])
    return exp, exp.prepare_batch(data)


def epoch_losses(batch: int, steps: int, lr: float, logdir: str, attn: str = "auto"):
    """The logged losses of one epoch of ``steps`` repeats of bench.py's
    training batch at ``lr`` (the epoch ``chip_smoke.py`` trains)."""
    cfg = layoutlm_train_config(attn)
    host = {k: v.numpy() for k, v in train_documents(batch, cfg.vocab_size, cfg.num_labels, "cpu").items()}
    exp = train_experiment(cfg, logdir, [host] * steps, lr)
    exp()
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        return [json.loads(line)["loss"] for line in f]


def timed_stages(names, run, steps: int):
    """Mean device ms of each stage over ``steps`` calls of ``run(mark)``,
    which calls ``mark()`` once as each stage ends."""
    totals = defaultdict(float)
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()

        def mark():
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        run(mark)
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: v / steps for k, v in totals.items()}


def stage_times_train(model, opt, loss_fn, data, steps: int, scheduler=None):
    """Mean device ms of forward (with the loss), backward and optimizer
    (the optimizer's step and the schedule's) over ``steps`` training
    steps."""
    model.train()

    def run(mark):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, data)
        mark()
        loss.backward()
        mark()
        opt.step()
        if scheduler is not None:
            scheduler.step()
        mark()

    return timed_stages(("forward", "backward", "optimizer"), run, steps)


DET_CONTENT = (800, 1067)  # a 480 x 640 image resized to short side 800
DET_GT = 8


def build_frcnn_train(batch: int, remat: bool = False):
    """(model, SGD optimizer, loss_fn(model, data) -> (loss, aux), data) of
    the detection training step (see the module's docstring)."""
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.models.detection_loss import fast_rcnn_losses, rpn_losses
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights

    cfg = FRCNNConfig(post_nms_topk=300, dtype="bfloat16", remat=remat)
    model = tame_random_weights(init_weights(FRCNN(cfg), seed=0)).cuda().train()
    gen = torch.Generator().manual_seed(0)
    h, w = DET_CONTENT
    images = torch.zeros(batch, *CANVAS, 3)
    images[:, :h, :w] = torch.randn(batch, h, w, 3, generator=gen) * 50
    xy = torch.rand(batch, DET_GT, 2, generator=gen) * torch.tensor([w - 400.0, h - 400.0])
    wh = 32 + torch.rand(batch, DET_GT, 2, generator=gen) * 368
    data = {
        "images": images.cuda(),
        "sizes": torch.tensor([[float(h), float(w)]] * batch, device="cuda"),
        "gt_boxes": torch.cat([xy, xy + wh], -1).cuda(),
        "gt_valid": torch.ones(batch, DET_GT, dtype=torch.bool, device="cuda"),
        "gt_classes": torch.randint(0, cfg.num_classes, (batch, DET_GT), generator=gen).cuda(),
    }
    with torch.no_grad():
        proposals = model(data["images"], data["sizes"], return_raw=True)["raw"]["proposals"]
    data["gt_boxes"][:, 0] = torch.round(proposals[:, 0])

    def loss_fn(m, d):
        sampler = torch.Generator(device="cuda").manual_seed(0)
        raw = m(d["images"], d["sizes"], return_raw=True)["raw"]
        obj, loc = rpn_losses(raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], d["gt_boxes"], d["gt_valid"],
                              generator=sampler, batch_size_per_image=256)
        cls, box = fast_rcnn_losses(raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"],
                                    d["gt_boxes"], d["gt_classes"], d["gt_valid"], generator=sampler,
                                    batch_size_per_image=128)
        return obj + loc + cls + box, {}

    return model, torch.optim.SGD(model.parameters(), lr=1e-4), loss_fn, data


@torch.inference_mode()
def stage_times_layoutlm(clf, ids, boxes, mask, steps: int):
    """Mean device ms of embeddings, encoder and head over ``steps``."""
    model = clf.model

    def run(mark):
        x = model.layoutlm.embeddings(ids, boxes)
        mark()
        for layer in model.layoutlm.encoder.layer:
            x = layer(x, mask)
        mark()
        torch.softmax(model.classifier(x).float(), dim=-1)
        mark()

    return timed_stages(("embeddings", "encoder", "head"), run, steps)


@torch.inference_mode()
def stage_times_vit(model, images, steps: int):
    """Mean device ms of embeddings (patch conv, CLS, positions), encoder
    and head (final LayerNorm, pooler) over ``steps``."""
    def run(mark):
        x = model.embed(images)
        mark()
        for layer in model.encoder.layer:
            x = layer(x)
        mark()
        x = model.layernorm(x.float())
        torch.tanh(model.pooler.dense(x[:, 0]))
        mark()

    return timed_stages(("embeddings", "encoder", "head"), run, steps)


@torch.inference_mode()
def stage_times_visualbert(model, ids, feats, tmask, vmask, steps: int):
    """Mean device ms of embeddings, encoder and head (pooler, classifier)."""
    vb = model.visual_bert
    mask = torch.cat([tmask, vmask], dim=1)

    def run(mark):
        x = vb.embeddings(ids, feats)
        mark()
        for layer in vb.encoder.layer:
            x = layer(x, mask)
        mark()
        model.cls(vb.pooler(x.float()))
        mark()

    return timed_stages(("embeddings", "encoder", "head"), run, steps)


FRCNN_STAGES = ("preprocess", "backbone", "rpn_head", "propose", "roi_heads", "postprocess")


def frcnn_stages(model, cfg, pre_fn, raw, sizes, mark):
    """The extraction step stage by stage, marking each end; returns the
    postprocessed output."""
    from vltk_tpu_torch.models.frcnn import _postprocess
    from vltk_tpu_torch.models.rpn import propose

    rpn = model.proposal_generator
    pre = pre_fn(raw, sizes)
    mark()
    feats = model.backbone(pre["img"])
    mark()
    logits, deltas = rpn.rpn_head(feats)
    mark()
    anchors = rpn.anchors((feats.shape[1], feats.shape[2]), feats.device)
    boxes, _, valid = propose(
        logits, deltas, anchors, pre["sizes"], nms_thresh=cfg.rpn_nms_thresh,
        pre_nms_topk=cfg.pre_nms_topk, post_nms_topk=cfg.post_nms_topk,
        min_box_side_len=cfg.min_box_side_len,
        bbox_reg_weights=cfg.rpn_bbox_reg_weights,
    )
    mark()
    obj, attr, deltas_b, pooled = model.roi_heads(feats, boxes)
    mark()
    out = _postprocess(
        cfg, boxes, valid, obj.float(), attr.float(), deltas_b.float(),
        pooled.float(), pre["sizes"], pre["scales_yx"],
    )
    mark()
    return out


@torch.inference_mode()
def stage_times(bundle, raw, sizes, steps: int):
    """Mean device ms of each stage of the extraction step."""
    return timed_stages(
        FRCNN_STAGES,
        lambda mark: frcnn_stages(bundle["model"], bundle["cfg"], bundle["pre_fn"], raw, sizes, mark),
        steps,
    )


@torch.inference_mode()
def stage_times_vqa(pred, raw, sizes, ids, tmask, steps: int):
    """Mean device ms of each stage of the composed VQA step: the
    extraction stages, then LXMERT's."""
    from vltk_tpu_torch.ops.image_ops import preprocess_batch
    from vltk_tpu_torch.predict import visual_inputs

    lx = pred.lxmert.lxmert
    enc = lx.encoder
    dt = lx.cfg.compute_dtype

    def pre_fn(r, s):
        return preprocess_batch(r, s, canvas_hw=pred._resized_canvas, short=pred._short, maximum=pred._maximum)

    def run(mark):
        det = frcnn_stages(pred.frcnn, pred.frcnn_config, pre_fn, raw, sizes, mark)
        feats, norm, vmask = visual_inputs(det, sizes)
        lang = lx.embeddings(ids)
        visn = enc.visn_fc(feats.to(dt), norm.to(dt))
        mark()
        for layer in enc.layer:
            lang = layer(lang, tmask)
        mark()
        for layer in enc.r_layers:
            visn = layer(visn, vmask)
        mark()
        for layer in enc.x_layers:
            lang, visn = layer(lang, tmask, visn, vmask)
        mark()
        torch.sigmoid(pred.lxmert.answer_head(lx.pooler(lang.float())))
        mark()

    names = FRCNN_STAGES + ("lxmert_embeddings", "language_layers", "visual_layers", "cross_layers", "head")
    return timed_stages(names, run, steps)


def busy_share(intervals):
    """Union of [start, end) intervals over the span they cover."""
    if not intervals:
        return None, 0.0
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in intervals) - intervals[0][0]
    return busy / span if span > 0 else None, span


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("frcnn", "layoutlm", "vqa", "vit", "visualbert"), default="frcnn")
    ap.add_argument("--attn", choices=("auto", "flash", "xla"), default=None,
                    help="layoutlm: attention_impl auto (the flash kernel at seq 1024, default) or xla; "
                         "vit, visualbert: flash (default) or xla")
    ap.add_argument("--train", action="store_true",
                    help="layoutlm, frcnn: the training step (bench.py --train)")
    ap.add_argument("--remat", action="store_true", help="frcnn --train: checkpointed backbone blocks")
    ap.add_argument("--lrs", type=float, nargs="+", default=None,
                    help="layoutlm --train: instead of tracing, print the losses of chip_smoke.py's "
                         "8-step epoch at each of these learning rates")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 8 (frcnn, vqa), 32 (layoutlm, visualbert), 8 (layoutlm --train), "
                         "2 (frcnn --train), 64 (vit)")
    ap.add_argument("--preset", default="parity_300", help="frcnn: the extraction preset (production = int8_300)")
    ap.add_argument("--int8", action="store_true", help="vqa, layoutlm, vit: the int8 serving presets")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    wants_flash = args.model in ("vit", "visualbert")
    if args.attn is None:
        args.attn = "flash" if wants_flash else "auto"
    if (args.attn == "flash") != wants_flash and args.attn != "xla":
        ap.error(f"--attn {args.attn} is not a route of --model {args.model}")
    if args.train and args.int8:
        ap.error("the int8 presets are for serving (round has a zero gradient)")
    if args.train and args.model not in ("layoutlm", "frcnn") or args.remat and not (args.train and args.model == "frcnn"):
        ap.error("--train is a mode of --model layoutlm and frcnn, --remat of --model frcnn --train")
    if not torch.cuda.is_available():
        raise SystemExit("trace: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)

    tmp = None
    if args.train and args.lrs:
        import tempfile

        for lr in args.lrs:
            with tempfile.TemporaryDirectory(prefix="vltk_trace_") as logdir:
                losses = epoch_losses(args.batch or 8, 8, lr, logdir, args.attn)
            print(json.dumps({"card": smi, "attn": args.attn, "lr": lr, "epoch_losses": losses}))
        return
    if args.model == "frcnn" and args.train:
        batch = args.batch or 2
        model, opt, loss_fn, data = build_frcnn_train(batch, args.remat)

        def step():
            model.zero_grad(set_to_none=True)
            loss_fn(model, data)[0].backward()
            opt.step()

        stages_fn = lambda: stage_times_train(model, opt, loss_fn, data, args.steps)  # noqa: E731
        unit = "images_per_s"
    elif args.model == "frcnn":
        batch = args.batch or 8
        bundle, raw, sizes = build_frcnn(batch, args.preset)
        step = lambda: bundle["step"](raw, sizes)  # noqa: E731
        stages_fn = lambda: stage_times(bundle, raw, sizes, args.steps)  # noqa: E731
        unit = "images_per_s"
    elif args.model == "vqa":
        batch = args.batch or 8
        pred = build_vqa(batch, int8=args.int8)
        raw, sizes, ids, tmask = vqa_inputs(pred, batch, "cuda")
        pred.calibrate_int8(raw, sizes, ids, tmask)  # int8: first bucket's scales
        step = lambda: pred.step(raw, sizes, ids, tmask)  # noqa: E731
        stages_fn = lambda: stage_times_vqa(pred, raw, sizes, ids, tmask, args.steps)  # noqa: E731
        unit = "samples_per_s"
    elif args.model == "vit":
        batch = args.batch or VIT_BATCH
        model, images = build_vit(batch, args.attn, args.int8)
        step = torch.inference_mode()(lambda: model(images))
        stages_fn = lambda: stage_times_vit(model, images, args.steps)  # noqa: E731
        unit = "images_per_s"
    elif args.model == "visualbert":
        batch = args.batch or 32
        model, (ids, feats, tmask, vmask) = build_visualbert(batch, args.attn)
        step = torch.inference_mode()(lambda: model(ids, feats, None, tmask, vmask))
        stages_fn = lambda: stage_times_visualbert(model, ids, feats, tmask, vmask, args.steps)  # noqa: E731
        unit = "samples_per_s"
    elif args.train:
        import tempfile

        batch = args.batch or 8
        tmp = tempfile.TemporaryDirectory(prefix="vltk_trace_")
        exp, data = build_layoutlm_train(batch, args.attn, tmp.name)
        step = lambda: exp.train_step(data)  # noqa: E731
        stages_fn = lambda: stage_times_train(exp.model, exp.optimizer, exp.loss_fn, data, args.steps,  # noqa: E731
                                              exp.scheduler)
        unit = "sequences_per_s"
    else:
        batch = args.batch or 32
        from vltk_tpu_torch.predict import _maybe_calibrate_doc_int8

        clf, ids, boxes, mask = build_layoutlm(batch, args.attn, args.int8)
        _maybe_calibrate_doc_int8(clf, ids, boxes, mask)
        step = lambda: clf.step(ids, boxes, mask)  # noqa: E731
        stages_fn = lambda: stage_times_layoutlm(clf, ids, boxes, mask, args.steps)  # noqa: E731
        unit = "documents_per_s"
    step()  # warm-up
    torch.cuda.synchronize()
    windows = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(f"step ms over {args.repeats} windows of {args.steps}: {windows}")

    stages = stages_fn()
    total = sum(stages.values())
    for name, ms in stages.items():
        print(f"stage {name:12s} {ms:9.3f} ms  {100 * ms / total:5.1f}%")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vltk_tpu_torch.ops.int8 import profile_scopes

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, profile_scopes():
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    # the int8 layers' ranges (host events): the device time of the kernels
    # that the ops inside each launched (its children's, not the range's
    # own, which is the range's span on the device timeline)
    int8_split = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("int8 "):
            int8_split[e.name[len("int8 "):]] += sum(c.device_time_total for c in e.cpu_children)
    # device events without the spans of user annotations (such as the
    # optimizer's ``Optimizer.step#...`` record), which are not kernels
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    by_class = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start  # us
        by_class[kernel_class(e.name)] += dur
        by_name[e.name][0] += dur
        by_name[e.name][1] += 1
        intervals.append((e.time_range.start, e.time_range.end))
    share, span = busy_share(intervals)
    kernel_ms = sum(by_class.values()) / 1e3 / args.steps
    print(f"profiler: {len(kernels)} kernels, {kernel_ms:.3f} device ms/step, busy share {share}")
    for part, us in int8_split.items():
        print(f"int8 {part:10s} {us / 1e3 / args.steps:9.3f} device ms/step")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"class {cls:22s} {us / 1e3 / args.steps:9.3f} ms/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        print(f"kernel {us / 1e3 / args.steps:8.3f} ms/step x{n // args.steps:4d}  {name[:110]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({
        "card": smi,
        "model": args.model,
        "train": bool(args.train),
        "peak_mem_gb": peak_gb,
        "attn": args.attn if args.model in ("layoutlm", "vit", "visualbert") else None,
        "preset": args.preset if args.model == "frcnn" and not args.train else None,
        "remat": bool(args.remat),
        "int8": bool(args.int8) if args.model != "frcnn" or args.train else bundle["cfg"].int8,
        "int8_ms_per_step": {k: v / 1e3 / args.steps for k, v in int8_split.items()},
        "batch": batch,
        "step_ms_windows": windows,
        unit: [batch * 1e3 / w for w in windows],
        "stage_ms": stages,
        "kernel_ms_per_step": kernel_ms,
        "kernels_per_step": len(kernels) / args.steps,
        "kernel_class_ms_per_step": {k: v / 1e3 / args.steps for k, v in by_class.items()},
        "busy_share": share,
        "traced_span_ms_per_step": span / 1e3 / args.steps,
        "top_kernels": [[name, us / 1e3 / args.steps, n // args.steps] for name, (us, n) in top],
    }))
    if tmp is not None:
        tmp.cleanup()


if __name__ == "__main__":
    main()
