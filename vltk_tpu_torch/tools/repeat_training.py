"""Is the LayoutLM-base training step bitwise repeatable on the card, and
bitwise the same under a one-rank mesh?

    python -m vltk_tpu_torch.tools.repeat_training [--steps 3] [--deterministic] [--small]

Trains ``trace.layoutlm_train_config("auto")`` with dropout off (bf16, seq
1024, K3-K5 on the flash route; ``--small``: 2 layers) on bench.py's
training batch at B=8, clipped AdamW at lr 1e-5 with warmup 0.1, three
times from the same seeded weights: without a mesh, again without a mesh,
and under a one-rank ``(data 1, model 1)`` NCCL mesh with ``LXMERT_RULES``
and ZeRO-1. After each step it prints, for the repeat and for the mesh
run, the loss and which gradients and parameters are not bitwise those of
the first run. ``--deterministic`` runs all three under
``torch.use_deterministic_algorithms(True)``. ``chip_smoke.py`` phase 39
holds the mesh run to the mesh-less one bitwise under that mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--small", action="store_true", help="2 layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repeat_training: needs a CUDA device")
    from vltk_tpu_torch.config import Config, MeshConfig
    from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification, init_weights, token_classification_loss
    from vltk_tpu_torch.ops import _build
    from vltk_tpu_torch.parallel import LXMERT_RULES, make_mesh, shard_params
    from vltk_tpu_torch.trace import layoutlm_train_config, train_documents
    from vltk_tpu_torch.train.optim import make_optimizer
    from vltk_tpu_torch.train.steps import make_train_step

    _build.build(["flash_attention", "flash_attention_bwd"])
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(MeshConfig(axes=(("data", 1), ("model", 1))), device=dev)
    cfg = layoutlm_train_config("auto", hidden_dropout=0.0)
    if args.small:
        cfg = dataclasses.replace(cfg, l_layers=2)
    data = train_documents(8, cfg.vocab_size, cfg.num_labels, dev)
    batch = {"ids": data["vtext"], "boxes": data["tokenbox"], "mask": data["visual_attention_mask"],
             "labels": data["tokenlabels"]}
    train = Config().train
    train.update({"learning_rate": 1e-5, "weight_decay": 0.01, "warmup_ratio": 0.1, "clip_grad_norm": 1.0})

    def loss_fn(model, b):
        return token_classification_loss(model(b["ids"], b["boxes"], b["mask"]), b["labels"]), {}

    def run(m):
        torch.manual_seed(0)
        model = init_weights(LayoutLMForTokenClassification(cfg), seed=0).to(dev)
        if m is not None:
            shard_params(model, LXMERT_RULES, m)
        opt, sched = make_optimizer(model, train, args.steps + 1, mesh=m, zero1_axis="data" if m else None)
        step = make_train_step(model, loss_fn, opt, sched, mesh=m)
        out = []
        for _ in range(args.steps):
            loss = float(step(batch)["loss"])
            out.append((loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                        {n: p.detach().clone() for n, p in model.named_parameters()}))
        return out

    first = run(None)
    for tag, other in (("repeat", run(None)), ("one_rank_mesh", run(mesh))):
        for i, (a, b) in enumerate(zip(first, other)):
            grads = [n for n in a[1] if not torch.equal(a[1][n], b[1][n])]
            params = [n for n in a[2] if not torch.equal(a[2][n], b[2][n])]
            print(json.dumps({
                "run": tag, "deterministic": args.deterministic, "step": i, "loss": [a[0], b[0]],
                "grads_differ": len(grads), "params_differ": len(params), "first_differing": (grads or params)[:3],
            }))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
