"""Document labelling through the port's ``DocTokenClassifier.step``:
pre-encoded pages in, per-token label probabilities out.

The weights are seeded on the device and reach the program through
``params=``; the pool of documents is made on the host and pinned. Each
dispatch copies one batch in, queues the step and queues the copy of its
probabilities back into pinned memory; each collect waits for that copy
alone, so the next batch, dispatched before it, keeps the card busy. The
comparison runs the float32 reference over the sampled batches' documents
once the program is freed, and reads, over real tokens only:

* ``prob_gap``: the largest absolute difference of a probability;
* ``label_gap``: the largest amount by which the reference's log
  probability of the label the program ranks first lies below the
  reference's best (0 where they agree).

Variants (a control, or a planted fault, never in the benchmark's own
runs): ``int8`` serves the program's int8 preset; ``altered`` rotates the
label probabilities of the first document of every batch as the step
returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, generate, weights
from benchmark.drivers.batch_infer import sample_batches
from benchmark.reference import layoutlm as ref
from benchmark.reference import reference_mode

LABELS = ("other", "question", "answer", "header")


def port_config(cfg, int8: bool = False):
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    return LayoutLMConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"], l_layers=cfg["num_hidden_layers"],
        max_position_embeddings=cfg["max_position_embeddings"], type_vocab_size=cfg["type_vocab_size"],
        hidden_dropout=cfg["hidden_dropout_prob"], attention_dropout=cfg["attention_probs_dropout_prob"],
        layer_norm_eps=cfg["layer_norm_eps"], initializer_range=cfg["initializer_range"],
        num_labels=cfg["num_labels"], coord_vocab=cfg["max_2d_position_embeddings"], dtype=cfg["dtype"],
        int8=int8)


def seeded_weights(ctx):
    return weights.seeded(ref.param_spec(ctx.config), ctx.seed, ctx.device)


class DocSystem:
    def __init__(self, ctx):
        from vltk_tpu_torch.predict import DocTokenClassifier

        cfg, t = ctx.config, ctx.traffic
        self.ctx = ctx
        self.clf = DocTokenClassifier(
            list(LABELS[:cfg["num_labels"]]), params=seeded_weights(ctx),
            config=port_config(cfg, int8=ctx.variant == "int8"),
            batch_size=int(t["batch"]), max_seq_length=int(t["seq"]), device=ctx.device)
        ctx.mark("program")
        self.docs = generate.documents(t, ctx.seed, cfg["vocab_size"], cfg["num_labels"])
        pin = ctx.device.type == "cuda"
        self.host = [tuple(torch.from_numpy(np.ascontiguousarray(self.docs[k][i])) for k in ("ids", "boxes", "mask"))
                     for i in range(self.docs["ids"].shape[0])]
        if pin:
            self.host = [tuple(x.pin_memory() for x in b) for b in self.host]
        self.pool = list(range(len(self.host)))
        shape = (int(t["batch"]), int(t["seq"]), cfg["num_labels"])
        self.ring = [torch.empty(shape, pin_memory=pin) for _ in range(2)]
        self.turn = 0
        if ctx.variant == "int8":
            from vltk_tpu_torch.predict import _maybe_calibrate_doc_int8

            _maybe_calibrate_doc_int8(self.clf, *(x.to(ctx.device) for x in self.host[0]))

    def dispatch(self, i: int):
        ids, boxes, mask = (x.to(self.ctx.device, non_blocking=True) for x in self.host[i])
        probs = self.clf.step(ids, boxes, mask)
        if self.ctx.variant == "altered":
            probs = probs.clone()
            probs[0] = probs[0].roll(1, dims=-1)
        out = self.ring[self.turn]
        self.turn ^= 1
        out.copy_(probs, non_blocking=True)
        done = None
        if self.ctx.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return out, done

    def collect(self, state) -> np.ndarray:
        out, done = state
        if done is not None:
            done.synchronize()
        return out.numpy().copy()

    def items(self, i: int) -> int:
        return int(self.docs["ids"].shape[1])

    def failed(self, out: np.ndarray) -> int:
        return int((~np.isfinite(out).all(axis=(1, 2))).sum())

    def flops(self, i: int) -> float:
        return sum(flops.layoutlm_forward(self.ctx.config, int(n)) for n in self.docs["lengths"][i])

    def work(self, i: int):
        return {"pairs": flops.attention_pairs(self.docs["lengths"][i])}

    def sample(self):
        return sample_batches(self.ctx, len(self.pool))

    def check(self, kept):
        ctx = self.ctx
        del self.clf
        from benchmark import harness

        harness.free_device(ctx)
        restore = reference_mode()
        try:
            p = seeded_weights(ctx)
            prob_gap = label_gap = 0.0
            for i, out in sorted(kept.items()):
                ids, boxes, mask = (torch.from_numpy(np.ascontiguousarray(self.docs[k][i])).to(ctx.device)
                                    for k in ("ids", "boxes", "mask"))
                want = ref.probabilities(p, ctx.config, ids, boxes, mask).cpu().numpy().astype(np.float64)
                got = out.astype(np.float64)
                real = self.docs["mask"][i] > 0
                prob_gap = max(prob_gap, float(np.abs(got - want)[real].max()))
                logp = np.log(np.maximum(want, 1e-30))
                pick = np.take_along_axis(logp, got.argmax(-1)[..., None], -1)[..., 0]
                label_gap = max(label_gap, float((logp.max(-1) - pick)[real].max()))
        finally:
            restore()
        return {"prob_gap": prob_gap, "label_gap": label_gap}


def build(ctx):
    return DocSystem(ctx)
