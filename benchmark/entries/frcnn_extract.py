"""Visual Genome feature extraction through the port's extraction adapter,
as ``FRCNN.extract`` runs each batch: ``collate`` on the host, then
``forward_dispatch`` (pinned copy in, the step queued) and
``forward_collect`` (the packed output copied back and unpacked into one
entry an image). No JPEG decode and no Arrow write.

The seeded weights reach the program through ``load_state_dict``. The
comparison holds the sampled batches against the float32 reference
(``reference/frcnn.py``) once the program is freed. Where a stage makes
discrete choices (top-k, NMS, argmax) the reference follows the program's
own outputs of the stage before, which forward hooks keep for the sampled
batches, so that one flipped near tie cannot cascade:

* ``pooled_err``: res5's pooled features on the program's proposals,
  from the reference's own pixels and backbone, against the program's
  (mean relative L2 a proposal, the worst image): preprocess, the trunk,
  RoIPool and res5;
* ``rpn_head_err``: the RPN head's objectness and anchor deltas against
  the reference's head on the program's own res4 map (relative L2 of each,
  the worse, the worst image);
* ``head_err``: the class logits, box deltas and attribute logits against
  the reference's predictors on the program's own pooled features, the
  attribute head embedding the program's own class (relative L2 of each
  over the valid proposals, the worst);
* ``prop_mismatch``: proposals the reference's selection on the program's
  own objectness and deltas does not give (count over the judged images);
* ``post_mismatch``: entries (class, attribute, feature, raw-pixel box)
  that the reference's postprocess of the program's own head outputs does
  not give, and missing or extra detections (count).

Variants (a control, or a planted fault, never in the benchmark's own
runs): ``int8`` extracts on the program's int8 convolutions (calibrated on
the first batch, as its int8 presets are), and, since that path leaves the
RPN head and the predictors in the configuration's precision, puts the
reference computed on int8 operands in their place for ``rpn_head_err``
and ``head_err``; ``altered`` moves the first detection of every image by
one class as the step returns it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, generate, weights
from benchmark.drivers.batch_infer import sample_batches
from benchmark.reference import frcnn as ref
from benchmark.reference import reference_mode

FIELDS = ("depth", "stem_out_channels", "res2_out_channels", "num_groups", "width_per_group", "stride_in_1x1",
          "caffe_maxpool", "feature_stride", "anchor_sizes", "aspect_ratios", "anchor_offset",
          "rpn_hidden_channels", "rpn_nms_thresh", "pre_nms_topk", "post_nms_topk", "min_box_side_len",
          "rpn_bbox_reg_weights", "num_classes", "num_attrs", "pooler_resolution", "res5_halve", "use_attr",
          "cls_agnostic_bbox_reg", "box_reg_weights", "nms_thresh_list", "min_detections", "max_detections",
          "roi_chunk")
CHECKS = ("pooled_err", "rpn_head_err", "head_err", "prop_mismatch", "post_mismatch")


def detector(cfg):
    """The detector's part of the configuration: a nested ``frcnn`` group
    with the image geometry beside it."""
    return cfg["frcnn"]


class ExtractSystem:
    def __init__(self, ctx):
        from vltk_tpu_torch import vars as V
        from vltk_tpu_torch.adapters.frcnn import FRCNN

        d, t = detector(ctx.config), ctx.traffic
        self.ctx, self.V = ctx, V

        class Extraction(FRCNN):
            raw_canvas = tuple(t["raw_canvas"])
            resized_canvas = tuple(d["canvas"])
            short = float(d["short"])
            maximum = float(d["maximum"])
            model_batch_size = int(t["batch"])

        self.adapter = Extraction
        fields = {k: d[k] for k in FIELDS}
        fields["int8"] = ctx.variant == "int8"
        self.bundle, _ = Extraction.setup(batch_size=int(t["batch"]), dtype=d["dtype"], device=ctx.device, **fields)
        ctx.mark("program")
        self.bundle["model"].load_state_dict(weights.seeded(ref.param_spec(d), ctx.seed, ctx.device))
        ctx.mark("weights")
        model = self.bundle["model"]
        self._stage = {}
        model.proposal_generator.rpn_head.register_forward_hook(self._hook("rpn", with_input=True))
        model.proposal_generator.register_forward_hook(self._hook("proposals"))
        model.roi_heads.register_forward_hook(self._hook("heads"))
        imgs = generate.images(t, ctx.seed)
        b = int(t["batch"])
        self.pool = [Extraction.collate([{V.img: im, V.imgid: str(j + k)} for k, im in enumerate(imgs[j:j + b])])
                     for j in range(0, len(imgs), b)]
        self._index = {id(batch): i for i, batch in enumerate(self.pool)}
        self._sample = set(self.sample())
        self.stages = {}  # pool index -> the stage outputs of its last dispatch
        if ctx.variant == "altered":
            step = self.bundle["step"]
            ncls = d["num_classes"]

            def altered(raw, sizes):
                out = step(raw, sizes).clone()
                obj = out[:, 0, -2]
                out[:, 0, -2] = torch.where(obj >= 0, (obj + 1) % ncls, obj)
                return out

            self.bundle["step"] = altered

    def _hook(self, name, with_input=False):
        def keep(module, args, out):
            self._stage[name] = (args[0], *out) if with_input else out

        return keep

    def dispatch(self, batch):
        state = self.adapter.forward_dispatch(self.bundle, batch)
        i = self._index[id(batch)]
        if i in self._sample:
            # references to this dispatch's device tensors, no copy
            self.stages[i] = dict(self._stage)
        return state

    def collect(self, state):
        return self.adapter.forward_collect(self.bundle, state)

    def items(self, batch) -> int:
        return len(batch[self.V.imgid])

    def failed(self, out) -> int:
        return sum(int(not np.isfinite(e[self.V.features]).all()) for e in out)

    def flops(self, batch) -> float:
        d = detector(self.ctx.config)
        return sum(flops.frcnn_image(d, *flops.resized_size(int(h), int(w), d["short"], d["maximum"]))
                   for h, w in batch[self.V.rawsize])

    def work(self, batch):
        return {"images": len(batch[self.V.imgid])}

    def sample(self):
        return sample_batches(self.ctx, len(self.pool))

    def check(self, kept):
        ctx = self.ctx
        stages = {i: _to_host(self.stages[i]) for i in kept}
        del self.bundle, self.stages
        self._stage = {}
        from benchmark import harness

        harness.free_device(ctx)
        restore = reference_mode()
        try:
            with torch.no_grad():
                p = weights.seeded(ref.param_spec(detector(ctx.config)), ctx.seed, ctx.device)
                worst = dict.fromkeys(CHECKS, 0.0)
                for i, entries in sorted(kept.items()):
                    for k, v in self._judge(p, self.pool[i], entries, stages[i]).items():
                        worst[k] = worst[k] + v if k.endswith("mismatch") else max(worst[k], v)
        finally:
            restore()
        return worst

    def _judge(self, p, batch, entries, st):
        V, dev = self.V, self.ctx.device
        d = detector(self.ctx.config)
        control = self.ctx.variant == "int8"
        f32 = lambda x, n: torch.from_numpy(x[n]).to(dev).float()  # noqa: E731
        res4, logit_map, delta_map = st["rpn"]
        props, pvalid = st["proposals"][3], st["proposals"][5]
        cls, attr, deltas, pooled = st["heads"]
        raw = torch.from_numpy(batch[V.img]).to(dev)
        raw_hw = torch.from_numpy(batch[V.rawsize]).to(dev)
        r = dict.fromkeys(CHECKS, 0.0)
        for n in range(raw.shape[0]):
            img, sizes, scales = ref.preprocess(raw[n:n + 1], raw_hw[n:n + 1], d)
            feat = ref.backbone(p, d, img)
            # the RPN head on the program's own res4 map, then the selection
            # from the program's own objectness and deltas
            lm, dm = f32(logit_map, n)[None], f32(delta_map, n)[None]
            x = f32(res4, n).permute(2, 0, 1)[None]
            judged = ref.rpn(p, x, quant="int8") if control else (lm, dm)
            r["rpn_head_err"] = max(r["rpn_head_err"], *map(_rel, judged, ref.rpn(p, x)))
            sel, sel_valid = ref.proposals(d, lm, dm, sizes)
            theirs, tv = f32(props, n), torch.from_numpy(pvalid[n]).to(dev)
            r["prop_mismatch"] += _unmatched(theirs[tv], sel[0][sel_valid[0]]) + abs(int(tv.sum()) - int(sel_valid.sum()))
            # res5 on the program's proposals from the reference's own map
            mp, ml, ma, md = f32(pooled, n), f32(cls, n), f32(attr, n), f32(deltas, n)
            rp = ref.pooled(p, d, feat[0], theirs)
            rel = (mp - rp).norm(dim=1) / rp.norm(dim=1).clamp(min=1e-12)
            r["pooled_err"] = max(r["pooled_err"], float(rel[tv].mean()))
            # the predictors on the program's own pooled features
            judged = ref.predictors(p, mp, quant="int8") if control else (ml, md, ma)
            want = ref.predictors(p, mp, judged[0].argmax(-1))
            r["head_err"] = max(r["head_err"], *(_rel(a[tv], b[tv]) for a, b in zip(judged, want)))
            # the postprocess of the program's own head outputs
            keep, kv, best, boxes = ref.detect(d, theirs, tv, ml, md, sizes[0])
            keep = keep[kv]
            sy, sx = float(scales[0, 0]), float(scales[0, 1])
            want_boxes = torch.round(boxes[keep] * torch.tensor([sx, sy, sx, sy], device=dev)).cpu().numpy()
            want_attr = ma[keep, :-1].argmax(-1).cpu().numpy()
            e = entries[n]
            ids = np.asarray(e["object_ids"])
            real = ids >= 0
            m = min(int(real.sum()), len(keep))
            r["post_mismatch"] += abs(int(real.sum()) - len(keep))
            got_f = np.asarray(e[V.features])[:m]
            bad = ((ids[:m] != best[keep][:m].cpu().numpy())
                   | (np.asarray(e["attr_ids"])[:m] != want_attr[:m])
                   | (np.abs(np.asarray(e[V.boxes])[:m] - want_boxes[:m]).max(-1) > 1.0)
                   | (np.abs(got_f - mp[keep][:m].cpu().numpy()).max(-1) > 1e-6 * np.abs(got_f).max(-1)))
            r["post_mismatch"] += int(bad.sum())
        return r


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 gap of ``a`` from ``b``."""
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _unmatched(a: torch.Tensor, b: torch.Tensor) -> int:
    """Boxes of ``a`` with no box of ``b`` within 1e-3 pixels."""
    if not a.shape[0]:
        return 0
    if not b.shape[0]:
        return int(a.shape[0])
    return int(((a[:, None] - b[None]).abs().amax(-1).min(1).values > 1e-3).sum())


def _to_host(stage):
    """A dispatch's kept stage outputs as numpy arrays, floats as float32
    (None stays None)."""

    def conv(x):
        if not torch.is_tensor(x):
            return x
        return (x if x.dtype == torch.bool else x.float()).cpu().numpy()

    return {k: tuple(conv(x) for x in v) for k, v in stage.items()}


def build(ctx):
    return ExtractSystem(ctx)
