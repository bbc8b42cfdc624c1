"""Fine-tuning LayoutLM on long pages through the port's
``OCRTokenExperiment.train_step``: the forward with K3, the token loss, the
backward with K4/K5, ``ClippedAdamW`` and the experiment's schedule.

Set-up builds one experiment (the seeded weights loaded through
``load_state_dict`` into a model made without weights), puts a pool of
seeded batches on the device, and drives the experiment's own
``train_step`` through its first ``reference_steps`` steps on the first
pool batches. What those steps leave is read then: each step's loss, every
leaf's first gradient as the optimizer got it (its first moment after one
step, over 1 - beta1) and every leaf's change over the steps. The window
goes on with the same object. The comparison replays those steps in the
float32 reference once the program is freed:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap`` / ``change_gap``: the largest gap between a leaf's norm and
  the reference's, over the larger of the reference leaf's norm and the
  median leaf's (``grad_worst`` / ``change_worst`` name the leaf);
* ``grad_gap_median`` / ``change_gap_median``: the median leaf's gap, which
  does not swing with the round-off of one small leaf.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out: they move by round-off alone.

Variants (planted faults, never in the benchmark's own runs): ``frozen``
steps without updating; ``half_batch`` takes the loss over the first half
of every batch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import flops, generate
from benchmark.entries.layoutlm_docs import port_config, seeded_weights
from benchmark.reference import layoutlm as ref
from benchmark.reference import reference_mode


def _experiment(ctx, state):
    from vltk_tpu_torch import vars as V
    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import OCRTokenExperiment
    from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification

    t = ctx.traffic
    cfg = port_config(ctx.config)
    half = ctx.variant == "half_batch"

    class Experiment(OCRTokenExperiment):
        model_config = cfg

        def build_model(self):
            with torch.device("meta"):
                model = LayoutLMForTokenClassification(cfg)
            model.to_empty(device=ctx.device)
            model.load_state_dict(state)
            return model

        def loss_fn(self, model, batch):
            if half:
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return super().loss_fn(model, batch)

    config = Config()
    config.logdir = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"bench_{os.getpid()}")
    config.data.lang.update({"max_visual_seq_length": int(t["seq"])})
    config.train.update({"epochs": 1, "learning_rate": t["learning_rate"], "weight_decay": t["weight_decay"],
                         "warmup_ratio": t["warmup_ratio"], "clip_grad_norm": t["clip_grad_norm"]})
    loader = range(int(t["total_steps"]))  # only its length is read: the schedule's span
    exp = Experiment(config, loaders=(loader, None), device=ctx.device)
    return exp, V


class TrainSystem:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.p0 = seeded_weights(ctx)
        self.exp, V = _experiment(ctx, self.p0)
        ctx.mark("program")
        self.docs = generate.documents(t, ctx.seed, ctx.config["vocab_size"], ctx.config["num_labels"])
        keys = {"ids": V.text, "boxes": V.tokenbox, "labels": V.tokenlabels, "mask": V.visual_attention_mask}
        self.pool = [{keys[k]: torch.from_numpy(np.ascontiguousarray(self.docs[k][i])).to(ctx.device) for k in keys}
                     for i in range(self.docs["ids"].shape[0])]
        self.batch = int(t["batch"])
        self.losses = []
        if ctx.variant == "frozen":
            self.exp.optimizer.step = lambda closure=None: None

    def step(self, i: int) -> None:
        self.losses.append(self.exp.train_step(self.pool[i % len(self.pool)])["loss"])

    def first_steps(self) -> None:
        """The first steps, through the window's own call, with what they
        leave read on the host."""
        n = int(self.ctx.traffic["reference_steps"])
        names = {id(p): k for k, p in self.exp.model.named_parameters()}
        for i in range(n):
            self.step(i)
            if i == 0:
                grads = {}
                for group in self.exp.optimizer.param_groups:
                    for p in group["params"]:
                        st = self.exp.optimizer.state.get(p, {})
                        g = st["exp_avg"] / (1 - 0.9) if "exp_avg" in st else torch.zeros_like(p)
                        grads[names[id(p)]] = float(g.float().norm())
        params = dict(self.exp.model.named_parameters())
        self.readings = {
            "losses": [float(x) for x in self.losses[:n]],
            "grad": grads,
            "change": {k: float((params[k].detach().float() - self.p0[k]).norm()) for k in grads},
        }
        del self.p0

    def work(self, i: int):
        return {"pairs": flops.attention_pairs(self.docs["lengths"][i % len(self.pool)])}

    def flops(self, i: int) -> float:
        return 3 * sum(flops.layoutlm_forward(self.ctx.config, int(n)) for n in self.docs["lengths"][i % len(self.pool)])

    def failed_steps(self) -> int:
        losses = torch.stack(self.losses[int(self.ctx.traffic["reference_steps"]):]) if self.losses else None
        return 0 if losses is None or losses.numel() == 0 else int((~torch.isfinite(losses)).sum())

    def check(self):
        ctx = self.ctx
        del self.exp, self.pool
        self.losses = []
        from benchmark import harness

        harness.free_device(ctx)
        n = int(ctx.traffic["reference_steps"])
        restore = reference_mode()
        try:
            batches = [{k: torch.from_numpy(np.ascontiguousarray(self.docs[k][i])).to(ctx.device)
                        for k in ("ids", "boxes", "mask", "labels")} for i in range(n)]
            p0 = seeded_weights(ctx)
            losses, first, last = ref.train_steps(p0, ctx.config, opt_settings(ctx), batches)
            return compare(self.readings, losses, {k: float(g.norm()) for k, g in first.items()},
                           {k: float((last[k] - p0[k]).norm()) for k in last})
        finally:
            restore()


def opt_settings(ctx):
    return {k: ctx.traffic[k] for k in ("learning_rate", "weight_decay", "warmup_ratio", "clip_grad_norm", "total_steps")}


def reference_control(ctx, variant: str):
    """The gaps of the reference put in the program's place, computed with
    ``variant`` (``int8`` or ``fp8``: the precisions below the
    configuration's bf16; ``half_batch``: a planted fault), against the plain reference, on the
    first pool batches of ``ctx.seed``."""
    t = ctx.traffic
    n = int(t["reference_steps"])
    docs = generate.documents(t, ctx.seed, ctx.config["vocab_size"], ctx.config["num_labels"])
    restore = reference_mode()
    try:
        batches = [{k: torch.from_numpy(np.ascontiguousarray(docs[k][i])).to(ctx.device)
                    for k in ("ids", "boxes", "mask", "labels")} for i in range(n)]
        p0 = seeded_weights(ctx)
        opt = opt_settings(ctx)
        kw = {"quant": variant} if variant in ("int8", "fp8") else {"fault": variant}
        losses, first, last = ref.train_steps(p0, ctx.config, opt, batches, **kw)
        prog = {"losses": losses, "grad": {k: float(g.norm()) for k, g in first.items()},
                "change": {k: float((last[k] - p0[k]).norm()) for k in last}}
        del first, last
        losses, first, last = ref.train_steps(p0, ctx.config, opt, batches)
        return compare(prog, losses, {k: float(g.norm()) for k, g in first.items()},
                       {k: float((last[k] - p0[k]).norm()) for k in last})
    finally:
        restore()


def compare(prog, losses, grad, change):
    """The gaps of a run against the reference's readings (norms by leaf
    name); those the cell's limits do not name are printed, not
    compared."""
    med_g = float(np.median(list(grad.values())))
    kept = [k for k in grad if grad[k] >= 1e-3 * med_g]
    med_c = float(np.median([change[k] for k in kept]))

    def gaps(a, b, med):
        return np.array([abs(a[k] - b[k]) / max(b[k], med) for k in kept])

    g, c = gaps(prog["grad"], grad, med_g), gaps(prog["change"], change, med_c)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses)]
    return {
        "loss_gap": max(loss),
        "grad_gap": float(g.max()),
        "change_gap": float(c.max()),
        "grad_gap_median": float(np.median(g)),
        "change_gap_median": float(np.median(c)),
        "grad_worst": kept[int(g.argmax())],
        "change_worst": kept[int(c.argmax())],
        "leaves_left_out": float(len(grad) - len(kept)),
    }


def build(ctx):
    return TrainSystem(ctx)
