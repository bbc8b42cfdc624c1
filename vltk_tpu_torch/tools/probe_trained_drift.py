"""Trained-weights preset drift: the direction trained weights move the
extraction presets' agreement (the port's copy of
``tools/probe_trained_drift.py``).

The preset drift harness (``tools/preset_drift.py``) runs at seeded tamed
weights, where the RPN's objectness does not follow the image, so
truncating proposals is measured at its worst. This probe trains its own
weights instead:

1. fine-tune the parity-geometry FRCNN (R-101-C4 on the 832 x 1344 canvas,
   the RPN and RoI losses of ``models/detection_loss.py``; on the card K1,
   K10 and K2 run every step) on learnable synthetic scenes: rectangles
   whose fill colour is their class, on a dark noisy background
   (``make_scenes``, the same numpy draws as the JAX probe's);
2. run the drift harness on fresh scenes twice, at the tamed start and at
   the trained weights, and diff the agreement columns.

    python -m vltk_tpu_torch.tools.probe_trained_drift --steps 300     # the card
    python -m vltk_tpu_torch.tools.probe_trained_drift --smoke --device cpu --steps 4

It prints JSON lines: the training's meta, the two harness results, their
difference, and what cuDNN's TF32 moves in ``parity_300`` at both weights
(``tf32_moves``: the RPN's keeps and the final boxes, with a control of two
forwards with TF32 on; on the CPU nothing).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from vltk_tpu_torch.tools import preset_drift

#: the columns diffed between the tamed and the trained run
AGREEMENT_COLUMNS = ("box_agreement@iou0.5", "feat_cosine_mean", "obj_id_agreement", "map50_vs_parity")


def make_scenes(rng, n, raw_canvas, content_hw, n_obj, n_classes, size_rng):
    """Learnable detection scenes on the raw uint8 canvas: dim noise
    (0..40), ``n_obj`` rectangles a scene whose fill is a per-class palette
    colour (+-12), in the top-left ``content_hw``; raw-space xyxy boxes and
    class ids. The draws are the JAX probe's, in its order."""
    H, W = content_hw
    lo, hi = size_rng
    imgs = np.zeros((n, *raw_canvas, 3), np.uint8)
    boxes = np.zeros((n, n_obj, 4), np.float32)
    classes = np.zeros((n, n_obj), np.int32)
    palette = rng.integers(100, 256, (n_classes, 3))
    for i in range(n):
        img = rng.integers(0, 40, (*raw_canvas, 3)).astype(np.int32)
        img[H:] = 0
        img[:, W:] = 0
        for j in range(n_obj):
            w = int(rng.integers(lo, hi))
            h = int(rng.integers(lo, hi))
            x0 = int(rng.integers(0, max(W - w, 1)))
            y0 = int(rng.integers(0, max(H - h, 1)))
            c = int(rng.integers(0, n_classes))
            img[y0:y0 + h, x0:x0 + w] = palette[c] + rng.integers(-12, 12, 3)
            boxes[i, j] = (x0, y0, x0 + w, y0 + h)
            classes[i, j] = c
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
    return imgs, boxes, classes


def train_frcnn(cfg, canvas, short, maximum, raw_imgs, raw_sizes, gt_boxes, gt_classes, batch: int, steps: int,
                lr: float, device, before_step: Optional[Callable] = None, after_step: Optional[Callable] = None):
    """Fine-tune from seeded tamed weights over the scenes' batches, cycled:
    SGD with momentum 0.9, the gradient clipped to norm 10, the rate ramped
    linearly from lr / 10 to lr over the first sixth of the steps (the JAX
    probe's optax chain). Each step's RPN (256 anchors an image) and RoI
    (128 proposals) losses draw their samples from a generator seeded with
    the step. ``before_step(i)`` / ``after_step(i)`` run around each step.
    Returns (tamed state dict, trained state dict, first loss, last loss,
    step ms per step)."""
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.models.detection_loss import fast_rcnn_losses, rpn_losses
    from vltk_tpu_torch.models.frcnn import FRCNN, init_weights
    from vltk_tpu_torch.ops.image_ops import preprocess_batch

    n = raw_imgs.shape[0]
    if n % batch:
        raise ValueError(f"{n} scenes do not split into batches of {batch}")
    batches = []
    with torch.no_grad():
        for k in range(n // batch):
            sl = slice(k * batch, (k + 1) * batch)
            pre = preprocess_batch(torch.from_numpy(raw_imgs[sl]).to(device),
                                   torch.from_numpy(np.asarray(raw_sizes[sl], np.float32)).to(device),
                                   canvas_hw=canvas, short=short, maximum=maximum)
            # scales_yx maps the canvas to raw pixels: canvas = raw / scale
            sc = pre["scales_yx"].float().cpu().numpy()
            bb = gt_boxes[sl].copy()
            bb[..., 0::2] /= sc[:, None, 1:2]
            bb[..., 1::2] /= sc[:, None, 0:1]
            batches.append((pre["img"], pre["sizes"], torch.from_numpy(bb).to(device),
                            torch.from_numpy(gt_classes[sl]).to(device)))
    gt_valid = torch.ones((batch, gt_boxes.shape[1]), dtype=torch.bool, device=device)

    model = tame_random_weights(init_weights(FRCNN(cfg), seed=0)).to(device)
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    warmup = max(steps // 6, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 0.1 + 0.9 * min(t, warmup) / warmup)

    losses, ms = [], []
    for i in range(steps):
        if before_step is not None:
            before_step(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        imgs, sizes, boxes, classes = batches[i % len(batches)]
        gen = torch.Generator(device=device).manual_seed(i + 1)
        opt.zero_grad(set_to_none=True)
        raw = model(imgs, sizes, return_raw=True)["raw"]
        parts = rpn_losses(raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], boxes, gt_valid,
                           generator=gen, batch_size_per_image=256)
        parts += fast_rcnn_losses(raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"], boxes,
                                  classes, gt_valid, generator=gen, batch_size_per_image=128)
        loss = sum(parts)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, 10.0)
        opt.step()
        sched.step()
        losses.append(float(loss.detach()))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if after_step is not None:
            after_step(i)
    if not np.isfinite(losses[-1]):
        raise RuntimeError(f"training diverged: last loss {losses[-1]}")
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return init_state, trained, losses[0], losses[-1], ms


def agreement_diff(tamed: dict, trained: dict) -> dict:
    """Per preset, trained minus tamed on each agreement column."""
    by_name = {r["preset"]: r for r in tamed["rows"]}
    return {
        r["preset"]: {c: r[c] - by_name[r["preset"]][c] for c in AGREEMENT_COLUMNS}
        for r in trained["rows"]
    }


def _moves(a, b) -> dict:
    """What differs between two forwards' (RPN keeps, final boxes): a keep
    of the RPN's NMS moves when its candidate is not in the other run's
    keep set; a final box slot when its box moves by more than half a
    pixel."""
    keep_a, boxes_a = a
    keep_b, boxes_b = b
    moved = (boxes_a - boxes_b).abs().amax(-1)
    return {
        "rpn_keeps_moved": int(sum(len(set(x.tolist()) - set(y.tolist())) for x, y in zip(keep_a, keep_b))),
        "rpn_keeps": int((keep_a >= 0).sum()),
        "rpn_keep_slots_reordered": int((keep_a != keep_b).sum()),
        "box_slots_moved_over_half_px": int((moved > 0.5).sum()),
        "box_slots_bitwise_different": int((moved > 0).sum()),
        "box_slots": int(moved.numel()),
        "box_max_abs_diff_px": float(moved.max()),
    }


def tf32_moves(cfg, state, raw: np.ndarray, raw_sizes: np.ndarray, geometry, device) -> dict:
    """What cuDNN's TF32 (PyTorch's default for convolutions) moves in one
    forward of the FRCNN at ``state`` on ``raw``: the forward with TF32 on
    against the forward with it off (``_moves``; the K2 call of the RPN
    recorded), beside ``"control"``, the same count between two forwards
    with TF32 on. Only a control of all zeros lets the first count be put
    down to TF32."""
    import vltk_tpu_torch.models.rpn as rpn_module
    from vltk_tpu_torch.models.frcnn import FRCNN
    from vltk_tpu_torch.models.pretrained import _materialise
    from vltk_tpu_torch.ops.image_ops import preprocess_batch

    _, canvas, short, maximum, _ = geometry
    model = _materialise(lambda: FRCNN(cfg), state, None, 0, device)
    raw_t = torch.from_numpy(raw).to(device)
    sizes_t = torch.from_numpy(np.asarray(raw_sizes, np.float32)).to(device)
    nms = rpn_module.nms_fixed_auto

    @torch.no_grad()
    def forward():
        keeps = []

        def recorded(*args, **kwargs):
            out = nms(*args, **kwargs)
            keeps.append(out[0].cpu())
            return out

        rpn_module.nms_fixed_auto = recorded
        try:
            pre = preprocess_batch(raw_t, sizes_t, canvas_hw=canvas, short=short, maximum=maximum)
            boxes = model(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])["boxes"].float().cpu()
        finally:
            rpn_module.nms_fixed_auto = nms
        return keeps[0], boxes

    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        on, on_again = forward(), forward()
        torch.backends.cudnn.allow_tf32 = False
        off = forward()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return {**_moves(on, off), "control": _moves(on, on_again)}


def run(smoke: bool = False, steps: int = 300, train_batch: int = 2, lr: float = 5e-3, roi_chunk=None, device=None,
        eval_batch: Optional[int] = None, before_step=None, after_step=None, quiet: bool = False) -> dict:
    """Train, then the harness at the tamed and the trained weights on the
    same fresh scenes, and ``tf32_moves`` at both. Returns {"meta",
    "tamed", "trained", "diff", "tf32", "tamed_state", "trained_state",
    "eval_scenes", "config"}."""
    from vltk_tpu_torch import resolve_device
    from vltk_tpu_torch.models.frcnn import FRCNNConfig

    dev = resolve_device(device)
    if smoke:
        raw_canvas, canvas, short, maximum, raw_hw = preset_drift.GEOM["smoke"]
        cfg = FRCNNConfig(dtype="bfloat16", post_nms_topk=16, pre_nms_topk=64, **preset_drift.SMOKE_TINY)
        n_obj, n_classes, size_rng = 3, 4, (10, 28)
        train_batch, eval_batch, steps = 2, 2, min(steps, 120)
    else:
        raw_canvas, canvas, short, maximum, raw_hw = preset_drift.GEOM["full"]
        cfg = FRCNNConfig(post_nms_topk=300, dtype="bfloat16", roi_chunk=roi_chunk)
        n_obj, n_classes, size_rng = 8, 16, (40, 160)
        eval_batch = eval_batch or 8

    rng = np.random.default_rng(7)
    n_train = train_batch * 8  # 8 distinct batches, cycled
    t_imgs, t_boxes, t_classes = make_scenes(rng, n_train, raw_canvas, raw_hw, n_obj, n_classes, size_rng)
    t_sizes = np.asarray([raw_hw] * n_train, np.float32)
    t0 = time.perf_counter()
    init_state, trained, first, last, step_ms = train_frcnn(
        cfg, canvas, short, maximum, t_imgs, t_sizes, t_boxes, t_classes, train_batch, steps, lr, dev,
        before_step, after_step,
    )
    meta = {
        "metric": "trained_drift_meta" + ("_smoke" if smoke else ""),
        "device": str(dev),
        "train_steps": steps,
        "train_batch": train_batch,
        "first_step_loss": first,
        "last_step_loss": last,
        "train_wall_s": time.perf_counter() - t0,
        "step_ms_median": float(np.median(step_ms[1:] if len(step_ms) > 1 else step_ms)),
    }
    if not quiet:
        print(json.dumps(meta))

    # fresh scenes of the same distribution, later in the same stream
    e_imgs, _, _ = make_scenes(rng, eval_batch, raw_canvas, raw_hw, n_obj, n_classes, size_rng)
    e_sizes = np.asarray([raw_hw] * eval_batch, np.float32)
    runs = {}
    for label, params in (("tamed-init-on-scenes", init_state), ("synthetic-trained", trained)):
        runs[label] = preset_drift.run_preset_drift(
            smoke=smoke, batch=eval_batch, params=params, raw=e_imgs, raw_sizes=e_sizes, label=label,
            roi_chunk=roi_chunk, device=dev, quiet=quiet,
        )
    diff = agreement_diff(runs["tamed-init-on-scenes"], runs["synthetic-trained"])
    if not quiet:
        print(json.dumps({"metric": "trained_minus_tamed" + ("_smoke" if smoke else ""), "diff": diff}))
    geometry = preset_drift.GEOM["smoke" if smoke else "full"]
    tf32 = {label: tf32_moves(cfg, state, e_imgs, e_sizes, geometry, dev)
            for label, state in (("tamed", init_state), ("trained", trained))}
    if not quiet:
        print(json.dumps({"metric": "tf32_off_vs_on" + ("_smoke" if smoke else ""), "parity_300": tf32}))
    return {"meta": meta, "tamed": runs["tamed-init-on-scenes"], "trained": runs["synthetic-trained"], "diff": diff,
            "tf32": tf32, "tamed_state": init_state, "trained_state": trained, "eval_scenes": (e_imgs, e_sizes),
            "config": cfg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--train-batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--roi_chunk", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(smoke=args.smoke, steps=args.steps, train_batch=args.train_batch, lr=args.lr, roi_chunk=args.roi_chunk,
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
