"""Preset drift of the extraction presets: the parity configuration and the
reduced ones on identical inputs and identical weights.

The port's copy of the JAX package's drift harness (``bench.py``:
``_full_drift_variants``, ``run_preset_drift``). Every preset runs the same
FRCNN weights on the same images; against the ``parity_300`` output as
ground truth each row reports the IoU-matched 36-box agreement (IoU >=
0.5), the mean matched IoU, the feature cosine and object-id agreement on
the matched pairs, VOC mAP@0.5 (``train/metrics.py:detection_map``) and the
preset's step time. A preset passes the production gate at box agreement
>= 0.95 and feature cosine >= 0.99. It is a measuring tool: it prints one
JSON object and writes nothing.

    python -m vltk_tpu_torch.tools.preset_drift              # the card, 10 presets at B=8
    python -m vltk_tpu_torch.tools.preset_drift --smoke --device cpu   # tiny, 3 presets

At seeded tamed weights (``adapters.frcnn.tame_random_weights``) the class
scores do not follow the RPN's objectness, so truncating proposals is
measured at its worst; ``tools/probe_trained_drift.py`` reruns the harness
at weights trained on learnable scenes.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

#: (raw canvas, canvas, short, maximum, raw content (h, w)): bench.py's
GEOM = {
    "smoke": ((64, 64), (64, 64), 48.0, 64.0, (48, 64)),
    "full": ((512, 672), (832, 1344), 800.0, 1333.0, (480, 640)),
}
#: the tiny detector of the smoke run (the JAX harness's ``tiny``)
SMOKE_TINY = dict(
    depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_hidden_channels=16,
    anchor_sizes=(16, 32), num_classes=7, num_attrs=5, pooler_resolution=7, min_detections=4, max_detections=4,
)
GATE = dict(box_agreement=0.95, feat_cosine=0.99)


def full_variants(canvas, short, maximum) -> List[tuple]:
    """The ten presets: (name, FRCNNConfig overrides, canvas, short, maximum)."""
    return [
        ("parity_300", dict(post_nms_topk=300, pre_nms_topk=6000), canvas, short, maximum),
        ("props_200", dict(post_nms_topk=200, pre_nms_topk=4000), canvas, short, maximum),
        ("props_150", dict(post_nms_topk=150, pre_nms_topk=3000), canvas, short, maximum),
        ("props_100", dict(post_nms_topk=100, pre_nms_topk=2000), canvas, short, maximum),
        ("canvas_600", dict(post_nms_topk=300, pre_nms_topk=6000), (608, 1024), 600.0, 1000.0),
        ("canvas_704", dict(post_nms_topk=300, pre_nms_topk=6000), (704, 1152), 700.0, 1150.0),
        ("int8_300", dict(post_nms_topk=300, pre_nms_topk=6000, int8=True), canvas, short, maximum),
        ("int8_200", dict(post_nms_topk=200, pre_nms_topk=4000, int8=True), canvas, short, maximum),
        ("int8_150", dict(post_nms_topk=150, pre_nms_topk=3000, int8=True), canvas, short, maximum),
        ("int8_100", dict(post_nms_topk=100, pre_nms_topk=2000, int8=True), canvas, short, maximum),
    ]


def smoke_variants(canvas, short, maximum) -> List[tuple]:
    return [
        ("parity_300", dict(SMOKE_TINY, post_nms_topk=16, pre_nms_topk=64), canvas, short, maximum),
        ("props_100", dict(SMOKE_TINY, post_nms_topk=8, pre_nms_topk=32), canvas, short, maximum),
        ("int8_300", dict(SMOKE_TINY, post_nms_topk=16, pre_nms_topk=64, int8=True), canvas, short, maximum),
    ]


def tamed_weights(cfg) -> Dict[str, torch.Tensor]:
    """Seeded (seed 0) FRCNN weights of ``cfg``, tamed so a full-depth
    forward stays finite."""
    from vltk_tpu_torch.adapters.frcnn import tame_random_weights
    from vltk_tpu_torch.models.frcnn import FRCNN, init_weights

    return tame_random_weights(init_weights(FRCNN(cfg), seed=0)).state_dict()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_step(model, canvas, short, maximum):
    """Device preprocess and the FRCNN, without autograd."""
    from vltk_tpu_torch.ops.image_ops import preprocess_batch

    @torch.no_grad()
    def step(raw, sizes):
        pre = preprocess_batch(raw, sizes, canvas_hw=canvas, short=short, maximum=maximum)
        return model(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])

    return step


def _row(name, out, ref, batch: int, ms: float) -> dict:
    """One preset's agreement with the parity output (the JAX harness's
    matching, on the host)."""
    from vltk_tpu_torch.train.metrics import detection_map

    feats, boxes, obj, probs, mask = (out[k] for k in ("roi_features", "boxes", "obj_ids", "obj_probs", "mask"))
    ref_feats, ref_boxes, ref_obj, ref_mask = (ref[k] for k in ("roi_features", "boxes", "obj_ids", "mask"))
    ious = np.full((batch, ref_boxes.shape[1]), np.nan)
    cos, objm = [], []
    for b in range(batch):
        for i in range(ref_boxes.shape[1]):
            if not ref_mask[b, i]:
                continue  # a padded reference slot is no ground truth
            a = ref_boxes[b, i]
            lt = np.maximum(a[None, :2], boxes[b, :, :2])
            rb = np.minimum(a[None, 2:], boxes[b, :, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[:, 0] * wh[:, 1]
            area_a = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
            area_b = np.clip(boxes[b, :, 2] - boxes[b, :, 0], 0, None) * np.clip(boxes[b, :, 3] - boxes[b, :, 1], 0,
                                                                                  None)
            u = area_a + area_b - inter + 1e-9
            iou_row = np.where(mask[b].astype(bool), inter / u, -1.0)
            j = int(np.argmax(iou_row))  # valid preset slots only
            ious[b, i] = max(iou_row[j], 0.0)
            if ious[b, i] >= 0.5:
                fa, fb = ref_feats[b, i], feats[b, j]
                cos.append(float(np.dot(fa, fb) / (np.linalg.norm(fa) * np.linalg.norm(fb) + 1e-9)))
                objm.append(float(ref_obj[b, i] == obj[b, j]))
    map50 = detection_map(boxes, probs, obj, mask.astype(bool), ref_boxes, ref_obj, ref_mask.astype(bool))
    matched = np.nan_to_num(ious) >= 0.5
    return {
        "preset": name,
        "box_agreement@iou0.5": round(float(np.mean(ious[~np.isnan(ious)] >= 0.5)), 4),
        "mean_matched_iou": round(float(np.mean(ious[matched])) if matched.any() else 0.0, 4),
        "feat_cosine_mean": round(float(np.mean(cos)) if cos else 0.0, 4),
        "obj_id_agreement": round(float(np.mean(objm)) if objm else 0.0, 4),
        "map50_vs_parity": round(float(map50), 4),
        "step_ms": ms,
        "imgs_per_sec": batch / (ms / 1e3),
    }


def run_preset_drift(
    smoke: bool = False,
    batch: int = 8,
    params: Optional[Dict[str, torch.Tensor]] = None,
    raw: Optional[np.ndarray] = None,
    raw_sizes: Optional[np.ndarray] = None,
    label: Optional[str] = None,
    roi_chunk: Optional[int] = None,
    device=None,
    timed_steps: int = 5,
    quiet: bool = False,
) -> dict:
    """Every preset on the same inputs and weights, rows against
    ``parity_300``. ``params``: an FRCNN state dict (default: seeded tamed
    weights of the parity preset); ``raw`` / ``raw_sizes``: (B, H, W, 3)
    uint8 images on one raw canvas and their (B, 2) content sizes (default:
    seeded noise, ``np.random.default_rng(0)``, as the JAX harness draws
    it). Prints the result as one JSON object unless ``quiet``; returns it,
    with each preset's outputs under ``"outputs"`` (not printed)."""
    from vltk_tpu_torch import resolve_device
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, calibrate_int8
    from vltk_tpu_torch.ops.image_ops import preprocess_batch
    from vltk_tpu_torch.models.pretrained import _materialise

    dev = resolve_device(device)
    supplied = params is not None
    raw_canvas, canvas, short, maximum, raw_hw = GEOM["smoke" if smoke else "full"]
    if smoke:
        batch = 2
        variants = smoke_variants(canvas, short, maximum)
    else:
        batch = min(batch, 8)
        variants = full_variants(canvas, short, maximum)
    if raw is None:
        rng = np.random.default_rng(0)
        raw = rng.integers(0, 256, size=(batch, *raw_canvas, 3)).astype(np.uint8)
        raw_sizes = np.asarray([raw_hw] * batch, np.int32)
    batch = int(raw.shape[0])
    raw_dev = torch.from_numpy(np.asarray(raw, np.uint8)).to(dev)
    sizes_dev = torch.from_numpy(np.asarray(raw_sizes, np.float32)).to(dev)

    outs, times = {}, {}
    for name, overrides, cvs, sh, mx in variants:
        cfg = FRCNNConfig(dtype="bfloat16", roi_chunk=roi_chunk, **overrides)
        if params is None:
            params = tamed_weights(cfg)
        model = _materialise(lambda: FRCNN(cfg), params, None, 0, dev)
        if cfg.int8:
            # static scales from one small batch, as an int8 deployment ships
            n = min(batch, 4)
            with torch.no_grad():
                pre = preprocess_batch(raw_dev[:n], sizes_dev[:n], canvas_hw=cvs, short=sh, maximum=mx)
                calibrate_int8(model, [(pre["img"], pre["sizes"], pre["scales_yx"])])
        step = make_step(model, cvs, sh, mx)
        out = step(raw_dev, sizes_dev)
        fetched = {k: out[k].float().cpu().numpy() for k in ("roi_features", "boxes", "obj_ids", "obj_probs",
                                                              "preds_per_image", "mask")}
        if fetched["preds_per_image"].min() <= 0:
            raise RuntimeError(f"{name}: an image without detections")
        outs[name] = fetched
        step(raw_dev, sizes_dev)  # one more warm step before the clock
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step(raw_dev, sizes_dev)
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / timed_steps * 1e3
        del model

    rows = [_row(name, outs[name], outs["parity_300"], batch, times[name]) for name, *_ in variants]
    for r in rows:
        r["production_gate"] = bool(r["box_agreement@iou0.5"] >= GATE["box_agreement"]
                                    and r["feat_cosine_mean"] >= GATE["feat_cosine"])
    passing = [r for r in rows if r["production_gate"]]
    best = max(passing, key=lambda r: r["imgs_per_sec"]) if passing else None
    result = {
        "metric": "frcnn_preset_drift" + (f"_{label}" if label else "") + ("_smoke" if smoke else ""),
        "weights": label or ("supplied-checkpoint" if supplied else "tamed-random"),
        "device": str(dev),
        "batch": batch,
        "gate": GATE,
        "production_pick": best["preset"] if best else None,
        "rows": rows,
    }
    if not quiet:
        print(json.dumps(result))
    result["outputs"] = outs
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="tiny detector, 3 presets")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--roi_chunk", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_preset_drift(smoke=args.smoke, batch=args.batch, roi_chunk=args.roi_chunk, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
