"""int8 serving fidelity at trained weights (the port's copy of
``tools/probe_int8_fidelity.py``).

Whether the static int8 serving path flips answers is a property of
trained weight and activation distributions, not of random ones. Without
a real checkpoint in the repository, each model is trained on a
learnable synthetic task, then its bf16 and int8 outputs are compared on
the same held-out inputs:

* ``lxmert``: VQA classification whose class is in the visual features
  (a class mean plus per-box noise over the 36 boxes), so the signal must
  pass the whole encoder the int8 path quantizes;
* ``layoutlm``: token classification at seq 1024, the label the quadrant
  of the token's box (on the card every self-attention runs K3 forward and
  K5 / K4 backward in training, 12 launches of each a step).

Each model trains with AdamW (optax's defaults: weight decay 1e-4) over
pre-generated batches, cycled (JAX's ``_train_fori``); the int8 twin loads
the trained weights and calibrates its static scales on one batch
(``models/layers.py:calibrate_int8_scales``). A row reports bf16 and int8
accuracy, top-1 agreement, the flip rate and the largest logit drift.

    python -m vltk_tpu_torch.tools.probe_int8_fidelity --steps 300     # the card
    python -m vltk_tpu_torch.tools.probe_int8_fidelity --smoke --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def train_cycled(model, loss_fn: Callable, batches: Dict[str, torch.Tensor], steps: int, lr: float,
                 before_step=None, after_step=None):
    """``steps`` AdamW steps (lr, weight decay 1e-4: optax's ``adamw``) over
    pre-generated batches (a leading batch-index axis), cycled, the model
    in training mode. Returns (first loss, last loss, step ms per step)."""
    n_batches = next(iter(batches.values())).shape[0]
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4)
    dev = next(model.parameters()).device
    torch.manual_seed(1)  # the dropout masks
    model.train()
    losses, ms = [], []
    for i in range(steps):
        if before_step is not None:
            before_step(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        batch = {k: v[i % n_batches] for k, v in batches.items()}
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if after_step is not None:
            after_step(i)
    model.eval()
    if not np.isfinite(losses[-1]):
        raise RuntimeError(f"training diverged: last loss {losses[-1]}")
    return losses[0], losses[-1], ms


def agreement_row(name, bf16_logits, int8_logits, labels, valid=None, extra=None, quiet: bool = False) -> dict:
    """Top-1 accuracy of each path and their agreement (JAX's
    ``_agreement_row``)."""
    bf16_top = np.argmax(bf16_logits, axis=-1)
    int8_top = np.argmax(int8_logits, axis=-1)
    if valid is None:
        valid = np.ones(bf16_top.shape, bool)
    agree = float((bf16_top == int8_top)[valid].mean())
    row = {
        "metric": f"int8_fidelity_{name}",
        "value": agree,
        "unit": "top1_agreement",
        "bf16_acc": float((bf16_top == labels)[valid].mean()),
        "int8_acc": float((int8_top == labels)[valid].mean()),
        "flip_rate": 1.0 - agree,
        "n_eval": int(valid.sum()),
        "logit_drift_max": float(np.max(np.abs(bf16_logits.astype(np.float32)
                                               - int8_logits.astype(np.float32))[valid])),
    }
    row.update(extra or {})
    if not quiet:
        print(json.dumps(row))
    return row


def _int8_twin(make, cfg, trained: torch.nn.Module, calib_args, device):
    from vltk_tpu_torch.models.layers import calibrate_int8_scales

    twin = make(dataclasses.replace(cfg, int8=True)).to(device)
    twin.load_state_dict(trained.state_dict())
    twin.eval()
    with torch.no_grad():
        scales = calibrate_int8_scales(twin, [calib_args])
    if not scales:
        raise RuntimeError("the int8 path did not engage")
    return twin


def _logits(model, args) -> np.ndarray:
    with torch.no_grad():
        return model(*args).float().cpu().numpy()


def run_lxmert(smoke: bool = False, steps: int = 300, lr: float = 1e-4, device=None, before_step=None,
               after_step=None, quiet: bool = False) -> dict:
    from vltk_tpu_torch import resolve_device
    from vltk_tpu_torch.models.lxmert import LxmertConfig, LxmertForVQA, init_weights, vqa_soft_loss

    dev = resolve_device(device)
    if smoke:
        dims = dict(vocab_size=64, hidden_size=16, num_heads=2, intermediate_size=32, l_layers=1, x_layers=1,
                    r_layers=1, visual_feat_dim=8, num_answers=8)
        b, s, v, n_classes = 4, 8, 4, 4
        steps, n_eval = min(steps, 60), 32
    else:
        dims = {}
        b, s, v, n_classes = 32, 20, 36, 32
        n_eval = 256
    cfg = LxmertConfig(dtype="bfloat16", **dims)
    rng = np.random.default_rng(11)
    mu = rng.normal(size=(n_classes, cfg.visual_feat_dim)).astype(np.float32)

    def make(n):
        classes = rng.integers(0, n_classes, n)
        feats = (mu[classes][:, None, :] + 0.5 * rng.normal(size=(n, v, cfg.visual_feat_dim))).astype(np.float32)
        return {
            "input_ids": rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32),
            "features": feats,
            "boxes": rng.uniform(0, 1, (n, v, 4)).astype(np.float32),
            "mask": np.ones((n, s), np.float32),
            "labels": classes.astype(np.int32),
        }

    s_batches = 8
    train = make(b * s_batches)
    batches = {k: torch.from_numpy(a.reshape(s_batches, b, *a.shape[1:])).to(dev) for k, a in train.items()}
    ev = make(n_eval)
    model = init_weights(LxmertForVQA(cfg), seed=0).to(dev)

    def loss_fn(m, batch):
        logits = m(batch["input_ids"], batch["features"], batch["boxes"], batch["mask"])
        target = torch.nn.functional.one_hot(batch["labels"].long(), cfg.num_answers).float()
        return vqa_soft_loss(logits, target)

    t0 = time.perf_counter()
    first, last, ms = train_cycled(model, loss_fn, batches, steps, lr, before_step, after_step)
    train_s = time.perf_counter() - t0
    eval_args = tuple(torch.from_numpy(ev[k]).to(dev) for k in ("input_ids", "features", "boxes", "mask"))
    bf16 = _logits(model, eval_args)
    twin = _int8_twin(LxmertForVQA, cfg, model, tuple(a[:8] for a in eval_args), dev)
    int8 = _logits(twin, eval_args)
    return agreement_row(
        "lxmert_vqa" + ("_smoke" if smoke else ""), bf16, int8, ev["labels"],
        extra={"train_steps": steps, "first_step_loss": first, "last_step_loss": last, "train_wall_s": train_s,
               "step_ms_median": float(np.median(ms[1:] if len(ms) > 1 else ms)), "device": str(dev)},
        quiet=quiet,
    )


def run_layoutlm(smoke: bool = False, steps: int = 300, lr: float = 1e-4, device=None, before_step=None,
                 after_step=None, quiet: bool = False) -> dict:
    from vltk_tpu_torch import resolve_device
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, token_classification_loss
    from vltk_tpu_torch.models.lxmert import init_weights

    dev = resolve_device(device)
    if smoke:
        dims = dict(vocab_size=64, hidden_size=16, num_heads=2, intermediate_size=32, l_layers=1,
                    max_position_embeddings=64)
        b, s = 4, 64
        steps, n_eval = min(steps, 60), 8
    else:
        dims = dict(max_position_embeddings=1024)
        b, s = 8, 1024
        n_eval = 32
    n_labels = 4  # the spatial quadrant of the token's box
    # attention dropout 0, so training takes the flash route on the card
    # (K3 forward, K5 and K4 backward), as the port's document trainers do
    cfg = LayoutLMConfig(dtype="bfloat16", num_labels=n_labels, attention_dropout=0.0, **dims)
    rng = np.random.default_rng(12)
    half = 512  # the coordinate space is 0..1023

    def make(n):
        ids = rng.integers(0, cfg.vocab_size, (n, s)).astype(np.int32)
        xy0 = rng.integers(0, 900, (n, s, 2))
        wh = rng.integers(1, 100, (n, s, 2))
        boxes = np.concatenate([xy0, xy0 + wh], -1).astype(np.int32)
        cx = (boxes[..., 0] + boxes[..., 2]) // 2
        cy = (boxes[..., 1] + boxes[..., 3]) // 2
        labels = (2 * (cy >= half) + (cx >= half)).astype(np.int32)
        mask = np.ones((n, s), np.float32)
        mask[:, int(s * 0.8):] = 0.0
        train_labels = labels.copy()
        train_labels[mask == 0.0] = -100
        return ids, boxes, mask, labels, train_labels

    s_batches = 4
    ids, boxes, mask, _, train_labels = make(b * s_batches)
    batches = {
        "ids": torch.from_numpy(ids.reshape(s_batches, b, s)).to(dev),
        "boxes": torch.from_numpy(boxes.reshape(s_batches, b, s, 4)).to(dev),
        "mask": torch.from_numpy(mask.reshape(s_batches, b, s)).to(dev),
        "labels": torch.from_numpy(train_labels.reshape(s_batches, b, s)).to(dev),
    }
    e_ids, e_boxes, e_mask, e_labels, _ = make(n_eval)
    model = init_weights(LayoutLMForTokenClassification(cfg), seed=0).to(dev)

    def loss_fn(m, batch):
        return token_classification_loss(m(batch["ids"], batch["boxes"], batch["mask"]), batch["labels"].long())

    t0 = time.perf_counter()
    first, last, ms = train_cycled(model, loss_fn, batches, steps, lr, before_step, after_step)
    train_s = time.perf_counter() - t0
    eval_args = tuple(torch.from_numpy(a).to(dev) for a in (e_ids, e_boxes, e_mask))
    bf16 = _logits(model, eval_args)
    twin = _int8_twin(LayoutLMForTokenClassification, cfg, model, tuple(a[:4] for a in eval_args), dev)
    int8 = _logits(twin, eval_args)
    return agreement_row(
        f"layoutlm_seq{s}" + ("_smoke" if smoke else ""), bf16, int8, e_labels, valid=e_mask.astype(bool),
        extra={"train_steps": steps, "first_step_loss": first, "last_step_loss": last, "train_wall_s": train_s,
               "step_ms_median": float(np.median(ms[1:] if len(ms) > 1 else ms)), "device": str(dev)},
        quiet=quiet,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--model", choices=("lxmert", "layoutlm", "both"), default="both")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(smoke=args.smoke, steps=args.steps, lr=args.lr, device=args.device)
    if args.model in ("lxmert", "both"):
        run_lxmert(**kw)
    if args.model in ("layoutlm", "both"):
        run_layoutlm(**kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
