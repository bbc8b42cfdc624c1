"""The multi-rank paths of the parallel layer on a real process group,
held against the mesh-less port on the same device.

    torchrun --nproc-per-node 4 -m vltk_tpu_torch.tools.check_parallel               # NCCL, a card a rank
    torchrun --nproc-per-node 4 -m vltk_tpu_torch.tools.check_parallel --device cpu  # gloo

Every rank builds the same seeded tiny models and batches, computes the
mesh-less reference itself and runs the sharded path; rank 0 prints one
JSON line a case with the ranks' worst errors, then ``{"ok": ...}``, and
the command exits 1 past a tolerance. The cases (4 ranks):

* ``gradients``: LayoutLM's token loss under ``data`` 2 x ``model`` 2
  (rows of 32, 20, 8 and 1 valid tokens): the loss and every local
  gradient block after the data-parallel reduce (1e-5 + 1e-4 relative);
* ``zero1_steps``: three clipped AdamW steps with ZeRO-1 on ``data``
  (the first at lr 0 of the warmup): losses and parameter blocks (1e-5;
  the key biases left out: their gradient is rounding, which Adam scales
  up to ~lr);
* ``checkpoint``: a sharded save and a restore into a fresh model and
  optimizer, bitwise;
* ``ulysses``: LXMERT (4 heads) under ``model`` 2 x ``seq`` 2 at seq 2048;
* ``ring``: LXMERT's ring backend under ``data`` 2 x ``seq`` 2 at seq 512,
  and ``ring_self_attention``'s gradients under ``seq`` 4 with a ragged
  mask (forwards 2e-5, gradients 1e-5);
* ``gpipe_pipe4``, ``gpipe_pipe2_data2``: ``gpipe_spmd`` over a toy stack
  of 8 layers (6 microbatches of 4) under ``pipe`` 4, and under ``pipe`` 2
  x ``data`` 2 with ``data_axis``: the output (1e-6) and the stack's
  gradients of sum(out^2), the stages' blocks summed over ``pipe`` (1e-5);
* ``moe_ep``: the MoE LXMERT (4 experts, top 2, capacity factor 0.5) under
  ``data`` 2 x ``expert`` 2 with ``LXMERT_MOE_RULES``: lang, visn, pooled
  (1e-5) and every local gradient block of a loss with the aux terms
  (1e-5 + 1e-4 relative).

The JAX package is the reference of the same cases on a CPU gloo group in
``tests/test_torch_parallel.py``; this tool shows the collectives behave
the same on the device's backend.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from vltk_tpu_torch.config import Config, MeshConfig
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, token_classification_loss
from vltk_tpu_torch.models.lxmert import Lxmert, LxmertConfig, init_weights
from vltk_tpu_torch.models.moe import moe_aux_losses
from vltk_tpu_torch.parallel import (
    LXMERT_MOE_RULES,
    LXMERT_RULES,
    gpipe_spmd,
    infer_shardings,
    make_mesh,
    ring_self_attention,
    shard_batch,
    shard_params,
    use_mesh,
)
from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.train.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
from vltk_tpu_torch.train.optim import make_optimizer
from vltk_tpu_torch.train.steps import make_train_step

DOC = dict(vocab_size=64, hidden_size=32, num_heads=4, intermediate_size=64, l_layers=2,
           max_position_embeddings=64, num_labels=3, hidden_dropout=0.0, attention_dropout=0.0)
LX = dict(vocab_size=64, hidden_size=16, num_heads=4, intermediate_size=32, l_layers=1, x_layers=1, r_layers=1,
          visual_feat_dim=8, num_answers=6, num_objects=5, num_attrs=3, hidden_dropout=0.0, attention_dropout=0.0)


def _lively(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter N(0, 0.3) (LayerNorm scales 1 + N(0, 0.1)): biases
    matter, unlike ``init_weights``' zeros."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.copy_(1.0 + 0.1 * noise if "LayerNorm.weight" in name else 0.3 * noise)
    return model


def _doc_batch(dev, seed: int = 0):
    rng = np.random.default_rng(seed)
    n, s = 4, 32
    mask = np.zeros((n, s), np.float32)
    for i, length in enumerate((32, 20, 8, 1)):
        mask[i, :length] = 1
    labels = rng.integers(0, 3, (n, s))
    labels[mask == 0] = -100
    boxes = np.sort(rng.integers(0, 1000, (n, s, 2, 2)), axis=2).reshape(n, s, 4)
    out = {"ids": rng.integers(0, 64, (n, s)), "boxes": boxes, "mask": mask, "labels": labels}
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def _token_loss(model, batch):
    logits = model(batch["ids"], batch["boxes"], batch["mask"])
    return token_classification_loss(logits, batch["labels"]), {}


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max()) if got.numel() else 0.0


def _rel_ok(got, want, atol: float, rtol: float) -> bool:
    got, want = got.detach().float(), want.detach().float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _blocks(model, reference: dict, mesh, rules=LXMERT_RULES) -> dict:
    """This rank's block of each global tensor of ``reference``, by the
    rules' shardings of the model's parameters."""
    specs = infer_shardings(model, rules, mesh)
    return {n: specs[n].local(t) for n, t in reference.items()}


def case_gradients(dev) -> dict:
    mesh = make_mesh(MeshConfig(axes=(("data", 2), ("model", 2))), device=dev)
    batch = _doc_batch(dev)
    ref = _lively(LayoutLMForTokenClassification(LayoutLMConfig(**DOC)), 1).to(dev)
    model = _lively(LayoutLMForTokenClassification(LayoutLMConfig(**DOC)), 1).to(dev)
    want_loss, _ = _token_loss(ref, batch)
    want_loss.backward()
    shard_params(model, LXMERT_RULES, mesh)
    with use_mesh(mesh):
        loss, _ = _token_loss(model, shard_batch(batch, mesh))
        loss.backward()
        C.reduce_gradients(model.parameters(), mesh)
        loss = C.mean_over_data({"loss": loss}, mesh)["loss"]
    want = _blocks(model, {n: p.grad for n, p in ref.named_parameters()}, mesh)
    got = {n: p.grad for n, p in model.named_parameters()}
    loss_err = abs(float(loss) - float(want_loss.detach()))
    ok = all(_rel_ok(got[n], want[n], 1e-5, 1e-4) for n in want) and loss_err <= 1e-6
    return {"loss_err": loss_err, "grad_err": max(_err(got[n], want[n]) for n in want), "ok": ok}


def _train_config():
    config = Config()
    config.train.update({"learning_rate": 5e-3, "weight_decay": 0.01, "warmup_ratio": 0.1, "clip_grad_norm": 1.0})
    return config.train


def case_zero1_steps(dev, ckpt_dir: str) -> dict:
    mesh = make_mesh(MeshConfig(axes=(("data", 2), ("model", 2))), device=dev)
    batches = [_doc_batch(dev, seed) for seed in range(3)]
    runs = []
    for m in (None, mesh):
        model = _lively(LayoutLMForTokenClassification(LayoutLMConfig(**DOC)), 2).to(dev)
        if m is not None:
            shard_params(model, LXMERT_RULES, m)
        opt, sched = make_optimizer(model, _train_config(), 10, mesh=m, zero1_axis="data" if m else None)
        step = make_train_step(model, _token_loss, opt, sched, mesh=m)
        losses = [float(step(b if m is None else shard_batch(b, m))["loss"]) for b in batches]
        runs.append((model, opt, losses))
    (ref, _, want_losses), (model, opt, losses) = runs
    # a key bias's gradient is 0 up to rounding (it shifts a softmax row by
    # a constant), and Adam scales the rounding up to ~lr: left out
    want = {n: t for n, t in _blocks(model, dict(ref.named_parameters()), mesh).items()
            if not n.endswith("key.bias")}
    got = dict(model.named_parameters())
    param_err = max(_err(got[n], want[n]) for n in want)
    # the sharded checkpoint: a fresh model and optimizer restored bitwise
    tree = {"model": model.state_dict(), "optim": opt.state_dict()}
    save_checkpoint_sharded(ckpt_dir, "check", 0, tree, mesh)
    fresh = _lively(LayoutLMForTokenClassification(LayoutLMConfig(**DOC)), 3).to(dev)
    shard_params(fresh, LXMERT_RULES, mesh)
    fresh_opt, _ = make_optimizer(fresh, _train_config(), 10, mesh=mesh, zero1_axis="data")
    state = load_checkpoint_sharded(ckpt_dir, "check", {"model": fresh.state_dict(), "optim": fresh_opt.state_dict()},
                                    mesh=mesh)
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["optim"])
    restored = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), fresh.state_dict().values()))
    moments = [(opt.state[a]["exp_avg"], fresh_opt.state[b]["exp_avg"])
               for a, b in zip((q for g in opt.param_groups for q in g["params"]),
                               (q for g in fresh_opt.param_groups for q in g["params"]))]
    restored = restored and all(torch.equal(a.to(b.device), b) for a, b in moments)
    loss_err = max(abs(a - b) for a, b in zip(losses, want_losses))
    return {"loss_err": loss_err, "param_err": param_err, "checkpoint_bitwise": restored,
            "ok": loss_err <= 1e-5 and param_err <= 1e-5 and restored}


def _lxmert_inputs(dev, n: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    out = {"ids": rng.integers(0, 64, (n, s)), "feats": rng.normal(size=(n, 4, 8)).astype(np.float32),
           "pos": rng.uniform(0, 1, (n, 4, 4)).astype(np.float32), "mask": np.ones((n, s), np.float32)}
    out["mask"][:, int(s * 0.9):] = 0
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def _seq_case(dev, axes, s: int, backend: str) -> dict:
    import dataclasses

    mesh = make_mesh(MeshConfig(axes=axes), device=dev)
    cfg = LxmertConfig(**LX, max_position_embeddings=s)
    inputs = _lxmert_inputs(dev, 4 if "data" in dict(axes) and dict(axes)["data"] > 1 else 2, s, 7)
    ref = _lively(Lxmert(cfg), 4).to(dev).eval()
    sp = _lively(Lxmert(dataclasses.replace(cfg, activation_sharding=True, seq_attention_sharding=True,
                                              seq_attention_backend=backend)), 4).to(dev).eval()
    shard_params(sp, LXMERT_RULES, mesh)
    with torch.no_grad():
        want = ref(inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
        local = shard_batch(inputs, mesh)
        with use_mesh(mesh):
            got = sp(local["ids"], local["feats"], local["pos"], local["mask"])
    rows = shard_batch({"lang": want[0], "pooled": want[2]}, mesh)
    errs = {"lang_err": _err(got[0], rows["lang"]), "pooled_err": _err(got[2], rows["pooled"])}
    return {**errs, "ok": max(errs.values()) <= 2e-5}


def case_ring_gradients(dev) -> dict:
    mesh = make_mesh(MeshConfig(axes=(("seq", 4),)), device=dev)
    gen = torch.Generator().manual_seed(0)
    n, s, nh, dh = 2, 64, 4, 8
    q, k, v = (torch.randn((n, s, nh, dh), generator=gen).to(dev) for _ in range(3))
    mask = (torch.rand((n, s), generator=gen) > 0.2).float().to(dev)
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    sc = torch.einsum("nqhd,nkhd->nhqk", full[0], full[1]) / dh ** 0.5 + (1.0 - mask)[:, None, None, :] * -10000.0
    want = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(sc, -1), full[2])
    (want ** 2).sum().backward()
    cols = slice(mesh.coord("seq") * s // 4, (mesh.coord("seq") + 1) * s // 4)
    blocks = [t[:, cols].clone().requires_grad_() for t in (q, k, v)]
    out = ring_self_attention(*blocks, mask[:, cols], mesh=mesh)
    # the global loss is the sum over ranks of each block's sum of squares
    (out ** 2).sum().backward()
    out_err = _err(out, want[:, cols])
    grad_err = max(_err(b.grad, f.grad[:, cols]) for b, f in zip(blocks, full))
    return {"out_err": out_err, "grad_err": grad_err, "ok": out_err <= 1e-5 and grad_err <= 1e-5}


def case_gpipe(dev, axes, data_axis) -> dict:
    mesh = make_mesh(MeshConfig(axes=axes), device=dev)
    gen = torch.Generator().manual_seed(5)
    layers, width, m, mb = 8, 8, 6, 4
    stack = {"w": (torch.randn((layers, width, width), generator=gen) * 0.3).to(dev),
             "b": (torch.randn((layers, width), generator=gen) * 0.1).to(dev)}
    x = torch.randn((m, mb, width), generator=gen).to(dev)

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    ref = {k: v.clone().requires_grad_() for k, v in stack.items()}
    want = x
    for i in range(layers):
        want = layer({k: v[i] for k, v in ref.items()}, want)
    (want ** 2).sum().backward()
    got = {k: v.clone().requires_grad_() for k, v in stack.items()}
    out = gpipe_spmd(layer, got, x, mesh=mesh, data_axis=data_axis)
    dp = mesh.axis_size(data_axis) if data_axis else 1
    ((out ** 2).sum() * dp).backward()
    C.reduce_gradients(got.values(), mesh)
    for v in got.values():  # each stage holds its layers' block: summed over pipe, the whole stack
        dist.all_reduce(v.grad, group=mesh.group("pipe"))
    rows = slice(None) if not data_axis else slice(mesh.coord(data_axis) * mb // dp, (mesh.coord(data_axis) + 1) * mb // dp)
    out_err = _err(out, want[:, rows])
    grad_err = max(_err(got[k].grad, ref[k].grad) for k in stack)
    return {"out_err": out_err, "grad_err": grad_err, "ok": out_err <= 1e-6 and grad_err <= 1e-5}


def _moe_loss(model, inputs):
    lang, visn, pooled = model(inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
    return (lang ** 2).mean() + (visn ** 2).mean() + (pooled ** 2).mean() + sum(moe_aux_losses(model).values())


def case_moe_ep(dev) -> dict:
    mesh = make_mesh(MeshConfig(axes=(("data", 2), ("expert", 2))), device=dev)
    cfg = LxmertConfig(**LX, moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
    inputs = _lxmert_inputs(dev, 4, 8, 9)
    ref = _lively(Lxmert(cfg), 6).to(dev)
    model = _lively(Lxmert(cfg), 6).to(dev)
    want = ref(inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
    _moe_loss(ref, inputs).backward()
    shard_params(model, LXMERT_MOE_RULES, mesh)
    with use_mesh(mesh):
        local = shard_batch(inputs, mesh)
        got = model(local["ids"], local["feats"], local["pos"], local["mask"])
        _moe_loss(model, local).backward()
        C.reduce_gradients(model.parameters(), mesh)
    rows = shard_batch({str(i): t for i, t in enumerate(want)}, mesh)
    out_err = max(_err(g, rows[str(i)]) for i, g in enumerate(got))
    grads = _blocks(model, {n: p.grad for n, p in ref.named_parameters()}, mesh, LXMERT_MOE_RULES)
    mine = {n: p.grad for n, p in model.named_parameters()}
    grad_err = max(_err(mine[n], grads[n]) for n in grads)
    ok = out_err <= 1e-5 and all(_rel_ok(mine[n], grads[n], 1e-5, 1e-4) for n in grads)
    return {"out_err": out_err, "grad_err": grad_err, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != 4:
        raise SystemExit("check_parallel: run it under torchrun --nproc-per-node 4")
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("check_parallel: no CUDA device (pass --device cpu for gloo)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.manual_seed(0)
    ckpt_dir = tempfile.mkdtemp(prefix="check_parallel_") if int(os.environ.get("RANK", "0")) == 0 else None
    results = {"gradients": case_gradients(dev)}
    shared = [ckpt_dir]
    dist.broadcast_object_list(shared, src=0)
    results["zero1_steps"] = case_zero1_steps(dev, shared[0])
    results["ulysses"] = _seq_case(dev, (("data", 1), ("seq", 2), ("model", 2)), 2048, "ulysses")
    results["ring"] = _seq_case(dev, (("data", 2), ("seq", 2)), 512, "ring")
    results["ring_gradients"] = case_ring_gradients(dev)
    results["gpipe_pipe4"] = case_gpipe(dev, (("pipe", 4),), None)
    results["gpipe_pipe2_data2"] = case_gpipe(dev, (("pipe", 2), ("data", 2)), "data")
    results["moe_ep"] = case_moe_ep(dev)
    gathered = [None] * world
    dist.all_gather_object(gathered, results)
    ok = all(r[case]["ok"] for r in gathered for case in r)
    if dist.get_rank() == 0:
        shutil.rmtree(shared[0], ignore_errors=True)
        backend = dist.get_backend()
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        for case in results:
            worst = {k: max(r[case][k] for r in gathered) if isinstance(results[case][k], float)
                     else all(r[case][k] for r in gathered) for k in results[case]}
            print(json.dumps({"case": case, "backend": backend, "device": name, "world": world, **worst}))
        print(json.dumps({"ok": ok, "backend": backend, "world": world}))
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
