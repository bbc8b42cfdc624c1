"""The port's parallel layer (``vltk_tpu_torch/parallel/``) on the CPU: one
gloo group of 4 ranks, spawned once for the module, runs every multi-rank
case; each result is held against the JAX package's output.

The cases mirror ``tests/test_parallel.py`` (mesh sizing and errors, rule
specs, ``shard_batch``, the TP forward and a TP training step, the
seq-sharded forward, Ulysses at 2048, ZeRO-1 moments, the sharded
checkpoint, LayoutLM and VisualBERT under Ulysses, ring attention and its
dropout, the ring LXMERT and a ring degree beyond the head count), plus a
data-parallel step whose ranks hold different valid-token counts, the
clip's global norm, and ``SimpleExperiment`` under ``data`` 2 x ``model``
2 against the JAX experiment. JAX's sharded runs are tied to its
unsharded ones by its own tests, so the port's sharded results are
compared with JAX's unsharded outputs at the same weights. Tolerances:
forwards JAX's own (``atol`` 1e-5 in float32; 2e-5 where JAX uses it);
gradients ``atol`` 1e-5 with ``rtol`` 1e-4 (float32 sums over ranks in
another order); optimizer steps and logged losses 1e-5 / 1e-4.

JAX's two HLO tests (``test_ulysses_train_backward_hlo_clean``,
``test_ring_train_backward_hlo_clean``) read XLA's compiled program for
involuntary rematerialisation and full-size all-gathers; eager PyTorch has
no such program, so they have no counterpart here.

Rank jobs are the module-level ``job_*`` functions: the ranks import this
module, torch, numpy and the port only (JAX is imported inside the tests),
run ``torch.set_num_threads(1)``, and exchange numpy arrays with the test.
"""

import dataclasses
import os
import queue
import socket
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vltk_tpu_torch import config as PC
from vltk_tpu_torch.parallel import (
    LXMERT_RULES,
    infer_shardings,
    make_mesh,
    shard_batch,
    shard_params,
    use_mesh,
    zero1_state_shardings,
)
from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.parallel import mesh as PM

WORLD = 4

LX = dict(vocab_size=64, hidden_size=16, num_heads=2, intermediate_size=32, l_layers=1, x_layers=1,
          r_layers=1, visual_feat_dim=8, max_position_embeddings=32, num_answers=6, num_objects=5,
          num_attrs=3, hidden_dropout=0.0, attention_dropout=0.0)
DOC = dict(vocab_size=64, hidden_size=32, num_heads=4, intermediate_size=64, l_layers=2,
           max_position_embeddings=64, num_labels=3, hidden_dropout=0.0, attention_dropout=0.0)


# ---------------------------------------------------------------- the ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, inbox, outbox):
    import datetime

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=90))
    while True:
        job = inbox.get()
        if job is None:
            break
        name, args = job
        try:
            outbox.put((rank, True, globals()[name](rank, *args)))
        except BaseException:  # noqa: BLE001 - handed to the test
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    """WORLD spawned processes in one gloo group; ``run(job, *args)`` runs
    ``job(rank, *args)`` on every rank and returns the results by rank."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.inboxes = [ctx.Queue() for _ in range(WORLD)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, WORLD, port, self.inboxes[r], self.outbox), daemon=True)
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, job, *args, timeout=150):
        for q in self.inboxes:
            q.put((job.__name__, args))
        results, errors = {}, []
        try:
            while len(results) + len(errors) < WORLD:
                rank, ok, value = self.outbox.get(timeout=timeout)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.broken = True
            raise AssertionError(f"{job.__name__}: no answer from ranks {sorted(set(range(WORLD)) - set(results))}")
        if errors:
            # ranks that failed while others went on may be out of step
            self.broken = self.broken or bool(results)
            raise AssertionError("\n".join(errors))
        return [results[r] for r in range(WORLD)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


_POOL = {}


@pytest.fixture(scope="module")
def ranks():
    def get():
        if _POOL.get("ranks") is None or _POOL["ranks"].broken:
            if _POOL.get("ranks") is not None:
                _POOL["ranks"].close()
            _POOL["ranks"] = Ranks()
        return _POOL["ranks"]

    yield types.SimpleNamespace(run=lambda job, *a, **k: get().run(job, *a, **k))
    if _POOL.get("ranks") is not None:
        _POOL.pop("ranks").close()


# ------------------------------------------------------------- rank helpers


def _mesh(axes):
    return make_mesh(PC.MeshConfig(axes=tuple(axes)), device="cpu")


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)) if isinstance(tree, np.ndarray) else tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _model(kind, cfg):
    from vltk_tpu_torch.models.layoutlm import LayoutLM, LayoutLMConfig, LayoutLMForTokenClassification
    from vltk_tpu_torch.models.lxmert import Lxmert, LxmertConfig
    from vltk_tpu_torch.models.visualbert import VisualBert, VisualBertConfig

    return {
        "lxmert": lambda: Lxmert(LxmertConfig(**cfg)),
        "layoutlm": lambda: LayoutLM(LayoutLMConfig(**cfg)),
        "layoutlm_tokens": lambda: LayoutLMForTokenClassification(LayoutLMConfig(**cfg)),
        "visualbert": lambda: VisualBert(VisualBertConfig(**cfg)),
    }[kind]()


_ARGS = {  # the forward's positional inputs, by model kind
    "lxmert": ("ids", "feats", "pos", "mask"),
    "layoutlm": ("ids", "boxes", "mask"),
    "layoutlm_tokens": ("ids", "boxes", "mask"),
    "visualbert": ("ids", "feats", None, "mask"),
}


def _built(kind, cfg, sd, mesh, rules):
    model = _model(kind, cfg)
    model.load_state_dict(_tensors(sd))
    if rules:
        shard_params(model, LXMERT_RULES, mesh)
    return model


def job_mesh(rank, axes_list):
    """Each mesh's shape and this rank's coordinate."""
    out = []
    for axes in axes_list:
        mesh = _mesh(axes)
        out.append((mesh.shape, mesh.coordinate))
    return out


def job_backend_is_not_switched(rank):
    """A mesh on cuda over the gloo group raises; no switch to gloo."""
    try:
        PM._ensure_group(torch.device("cuda"))
    except RuntimeError as exc:
        return str(exc)
    return None


def job_shard_batch(rank, batch):
    return _numpy(shard_batch(batch, _mesh((("data", 4),))))


def job_forward(rank, kind, cfg, sd, axes, inputs, rules=True):
    """The model's forward on this rank's data block under the mesh; the
    shapes each encoder layer saw."""
    mesh = _mesh(axes)
    model = _built(kind, cfg, sd, mesh, rules).eval()
    seen = []
    layers = [m for n, m in model.named_modules() if n.split(".")[-2:-1] in (["layer"], ["x_layers"])]
    for layer in layers:
        layer.register_forward_pre_hook(lambda m, args: seen.append(tuple(args[0].shape)))
    local = _tensors(shard_batch(inputs, mesh))
    C.reset_counts()
    with torch.no_grad(), use_mesh(mesh):
        out = model(*(local[k] if k else None for k in _ARGS[kind]))
    return {"out": _numpy(out if isinstance(out, tuple) else (out,)), "coord": mesh.coordinate,
            "seen": seen, "counts": C.counts()}


def _token_loss(model, batch):
    from vltk_tpu_torch.models.layoutlm import token_classification_loss

    logits = model(batch["ids"], batch["boxes"], batch["mask"])
    return token_classification_loss(logits, batch["labels"]), {}


def job_gradients(rank, cfg, sd, axes, batch):
    """One forward and backward of the token loss on this rank's block,
    then the data x seq reduce: (the loss averaged over ``data``, the
    local gradients, the coordinate)."""
    mesh = _mesh(axes)
    model = _built("layoutlm_tokens", cfg, sd, mesh, True)
    local = _tensors(shard_batch(batch, mesh))
    C.reset_counts()
    with use_mesh(mesh):
        loss, _ = _token_loss(model, local)
        loss.backward()
        C.reduce_gradients(model.parameters(), mesh)
        loss = C.mean_over_data({"loss": loss}, mesh)["loss"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {"loss": float(loss), "grads": _numpy(grads), "coord": mesh.coordinate, "counts": C.counts()}


def _train_config(**over):
    config = PC.Config()
    config.train.update(dict(dict(learning_rate=5e-3, weight_decay=0.01, warmup_ratio=0.0), **over))
    return config.train


def job_steps(rank, cfg, sd, axes, batches, zero1, clip):
    """AdamW steps of the token loss (``make_train_step`` under the mesh):
    the logged losses, the local parameters, the local moment slices."""
    from vltk_tpu_torch.train.optim import make_optimizer
    from vltk_tpu_torch.train.steps import make_train_step

    mesh = _mesh(axes)
    model = _built("layoutlm_tokens", cfg, sd, mesh, True)
    opt, sched = make_optimizer(model, _train_config(clip_grad_norm=clip), 100, mesh=mesh,
                                zero1_axis="data" if zero1 else None)
    step = make_train_step(model, _token_loss, opt, sched, mesh=mesh)
    C.reset_counts()
    losses = [float(step(_tensors(shard_batch(b, mesh)))["loss"]) for b in batches]
    return {"losses": losses, "params": _numpy(dict(model.named_parameters())), "moments": _moments(model, opt),
            "coord": mesh.coordinate, "counts": C.counts()}


def _moments(model, opt):
    """name -> this rank's ``exp_avg`` block (the optimizer keeps the
    tensors it updates in ``slices``, in ``param_groups``' order)."""
    from vltk_tpu_torch.train.optim import param_groups

    names = [n for g in param_groups(model, 0.0) for p in g["params"]
             for n, q in model.named_parameters() if q is p]
    return {n: _numpy(opt.state[sl]["exp_avg"]) for n, (_, sl, _) in zip(names, opt.slices)}


def job_checkpoint(rank, cfg, sd, axes, batch, ckpt_dir):
    """A ZeRO-1 step, a sharded save, a fresh model and optimizer restored
    from it: (saved, restored) local states."""
    from vltk_tpu_torch.train.checkpoint import load_checkpoint_sharded, save_checkpoint_sharded
    from vltk_tpu_torch.train.optim import make_optimizer
    from vltk_tpu_torch.train.steps import make_train_step

    mesh = _mesh(axes)
    fresh = []
    for _ in range(2):
        model = _built("layoutlm_tokens", cfg, sd, mesh, True)
        opt, _ = make_optimizer(model, _train_config(), 100, mesh=mesh, zero1_axis="data")
        fresh.append((model, opt))
    (model, opt), (model2, opt2) = fresh
    make_train_step(model, _token_loss, opt, mesh=mesh)(_tensors(shard_batch(batch, mesh)))
    tree = {"model": model.state_dict(), "optim": opt.state_dict()}
    save_checkpoint_sharded(ckpt_dir, "zero1", 0, tree, mesh)
    state = load_checkpoint_sharded(ckpt_dir, "zero1", {"model": model2.state_dict(), "optim": opt2.state_dict()},
                                    mesh=mesh)
    model2.load_state_dict(state["model"])
    opt2.load_state_dict(state["optim"])
    return {"saved": _numpy({"model": model.state_dict(), "optim": opt.state_dict()["state"]}),
            "restored": _numpy({"model": model2.state_dict(), "optim": opt2.state_dict()["state"]}),
            "moments": _moments(model2, opt2), "coord": mesh.coordinate,
            "files": sorted(os.listdir(os.path.join(ckpt_dir, "zero1_epoch_0_sharded")))}


def job_ring(rank, axes, q, k, v, mask, rate, seed):
    """``ring_self_attention`` on this rank's blocks, and with rate 0 the
    gradients of sum(out^2) for its q, k, v blocks."""
    from vltk_tpu_torch.parallel import ring_self_attention

    mesh = _mesh(axes)
    sp, dp, tp = (mesh.axis_size(a) for a in ("seq", "data", "model"))
    n, s, nh = q.shape[:3]
    rows = slice(mesh.coord("data") * n // dp, (mesh.coord("data") + 1) * n // dp)
    cols = slice(mesh.coord("seq") * s // sp, (mesh.coord("seq") + 1) * s // sp)
    heads = slice(mesh.coord("model") * nh // tp, (mesh.coord("model") + 1) * nh // tp)
    blocks = [torch.from_numpy(x[rows, cols, heads]).requires_grad_() for x in (q, k, v)]
    out = ring_self_attention(*blocks, torch.from_numpy(mask[rows, cols]), mesh=mesh, dropout_rate=rate,
                              dropout_seed=seed)
    grads = None
    if rate == 0.0:
        (out ** 2).sum().backward()
        grads = [b.grad.numpy() for b in blocks]
    return {"out": out.detach().numpy(), "grads": grads, "at": (rows, cols, heads)}


def job_experiment(rank, cfg, sd, axes, data, logdir, ckpt_dir, zero1):
    """``OCRTokenExperiment`` at the tiny size under the mesh (None: no
    mesh, rank 0 alone): its logged losses and local parameters."""
    import json

    from vltk_tpu_torch.experiments import OCRTokenExperiment
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    mesh = _mesh(axes) if axes else None
    if (mesh is None and rank != 0) or (mesh is not None and not mesh.is_member):
        return None
    config = PC.Config()
    config.logdir, config.checkpoint_dir = logdir, ckpt_dir
    config.train.update({"epochs": 1, "learning_rate": 5e-3})
    config.data.lang.update({"max_visual_seq_length": data[0]["vtext"].shape[1]})
    if zero1:
        config.mesh.update({"zero1_axis": "data"})

    class Tiny(OCRTokenExperiment):
        model_config = LayoutLMConfig(**cfg)

        def build_model(self):
            model = super().build_model()
            model.load_state_dict(_tensors(sd))
            return model

    kwargs = {"mesh": mesh, "rules": LXMERT_RULES} if mesh is not None else {"device": "cpu"}
    C.reset_counts()
    exp = Tiny(config, loaders=(data, None), **kwargs)
    exp()
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        log = [json.loads(line) for line in f]
    return {"log": log, "params": _numpy(dict(exp.model.named_parameters())),
            "coord": None if mesh is None else mesh.coordinate, "counts": C.counts()}


# ----------------------------------------------------------- test helpers


def lively(shapes, seed):
    """flax-shaped params at unit scale: kernels N(0, 1/fan_in), LayerNorm
    scales U(0.5, 1.5), embeddings N(0, 1), biases N(0, 0.1)."""
    import flax.traverse_util as tu

    rng = np.random.default_rng(seed)
    flat = tu.flatten_dict(shapes, sep="/")
    for k, v in flat.items():
        leaf, shape = k.rsplit("/", 1)[-1], tuple(v.shape)
        if leaf == "kernel":
            arr = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        elif leaf == "scale":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "embedding":
            arr = rng.normal(0, 1, shape)
        else:
            arr = rng.normal(0, 0.1, shape)
        flat[k] = arr.astype(np.float32)
    return tu.unflatten_dict(flat, sep="/")


def jax_side(kind, cfg, seed, *example):
    """(flax module, lively params, port state dict as numpy) at the
    config; ``example`` are init inputs (shapes only: ``jax.eval_shape``)."""
    import jax

    from vltk_tpu.models.layoutlm import LayoutLM, LayoutLMConfig, LayoutLMForTokenClassification
    from vltk_tpu.models.lxmert import Lxmert, LxmertConfig
    from vltk_tpu.models.visualbert import VisualBert, VisualBertConfig
    from vltk_tpu_torch.models import convert

    module = {
        "lxmert": lambda: Lxmert(LxmertConfig(**cfg)),
        "layoutlm": lambda: LayoutLM(LayoutLMConfig(**cfg)),
        "layoutlm_tokens": lambda: LayoutLMForTokenClassification(LayoutLMConfig(**cfg)),
        "visualbert": lambda: VisualBert(VisualBertConfig(**cfg)),
    }[kind]()
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example)["params"]
    params = lively(shapes, seed)
    to_torch = {"lxmert": convert.jax_lxmert_to_torch, "layoutlm": convert.jax_layoutlm_to_torch,
                "layoutlm_tokens": convert.jax_layoutlm_to_torch, "visualbert": convert.jax_visualbert_to_torch}
    sd = {k: v.numpy() for k, v in to_torch[kind](params).items()}
    return module, params, sd


def jit_apply(module, params, *args):
    import jax

    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params, *args)


def lxmert_inputs(rng, n, s, v=4, vocab=64, feat=8):
    return {"ids": rng.integers(0, vocab, (n, s)).astype(np.int64),
            "mask": np.ones((n, s), np.float32),
            "feats": rng.normal(size=(n, v, feat)).astype(np.float32),
            "pos": rng.uniform(0, 1, (n, v, 4)).astype(np.float32)}


def doc_batch(rng, n, s, lengths, vocab=64, labels=3):
    ids = rng.integers(0, vocab, (n, s)).astype(np.int64)
    boxes = np.sort(rng.integers(0, 1000, (n, s, 2, 2)), axis=2).reshape(n, s, 4).astype(np.int64)
    mask = np.zeros((n, s), np.float32)
    for i, length in enumerate(lengths):
        mask[i, :length] = 1
    lab = rng.integers(0, labels, (n, s)).astype(np.int64)
    lab[mask == 0] = -100
    return {"ids": ids, "boxes": boxes, "mask": mask, "labels": lab}


def data_blocks(results, pick=0):
    """Outputs of the ranks at (any data, model 0, seq 0), concatenated in
    data order: the global batch's output (each is whole along the seq)."""
    first = [r for r in results if r is not None and all(
        c == 0 for name, c in zip(("data", "seq", "model"), _coords(r)) if name != "data")]
    first.sort(key=lambda r: _coords(r)[0])
    return np.concatenate([r["out"][pick] for r in first], axis=0)


def _coords(result):
    """(data, seq, model) of a result whose job recorded the mesh axes."""
    return result["dsm"]


def with_axes(results, axes):
    """Add (data, seq, model) coordinates to each member rank's result."""
    names = [a for a, _ in axes]
    out = []
    for r in results:
        if r is None or r.get("coord") is None:
            out.append(None)
            continue
        coord = dict(zip(names, r["coord"]))
        out.append({**r, "dsm": tuple(coord.get(a, 0) for a in ("data", "seq", "model"))})
    return out


def global_grads(results, axes, global_sd):
    """Each parameter's gradient put back together from the model axis'
    blocks (read at data 0, seq 0), by the rules' specs."""
    mesh = types.SimpleNamespace(shape=dict(axes))
    specs = infer_shardings({k: torch.empty(v.shape) for k, v in global_sd.items()}, LXMERT_RULES, mesh)
    by_model = {r["dsm"][2]: r for r in results if r is not None and r["dsm"][:2] == (0, 0)}
    out = {}
    for name in global_sd:
        spec = specs[name].spec
        dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        parts = [by_model[m]["grads"][name] for m in sorted(by_model)]
        out[name] = parts[0] if dim is None else np.concatenate(parts, axis=dim)
    return out


def flax_grads_by_torch_name(kind, grads):
    """JAX's gradient tree -> {port name: array in the port's layout}."""
    import flax.traverse_util as tu

    from vltk_tpu_torch.models import convert

    to_torch = {"layoutlm_tokens": convert.jax_layoutlm_to_torch}[kind]
    return {k: v.numpy() for k, v in to_torch(tu.unflatten_dict(
        {k: np.asarray(v) for k, v in tu.flatten_dict(grads).items()})).items()}


# ------------------------------------------------------------------- mesh


def test_make_mesh_free_axis(ranks):
    """-1 takes the ranks the fixed axes leave; the grids are JAX's."""
    import jax

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import make_mesh as jax_make_mesh

    cases = [(("data", -1),), (("data", -1), ("model", 2)), (("data", 2), ("seq", 2))]
    results = ranks.run(job_mesh, cases)
    for i, axes in enumerate(cases):
        want = jax_make_mesh(JMesh(axes=axes), devices=jax.devices()[:WORLD])
        for rank, res in enumerate(results):
            shape, coord = res[i]
            assert shape == dict(want.shape)
            ids = np.vectorize(lambda d: d.id)(want.devices)
            assert tuple(int(c) for c in np.argwhere(ids == jax.devices()[rank].id)[0]) == coord


def test_make_mesh_errors(ranks):
    """The sizing errors carry JAX's texts, for ``pipe`` and ``expert``
    axes too; a fixed mesh smaller than the group takes the first ranks, as
    JAX takes the first devices; ``expert`` and ``pipe`` axes of any size
    the group allows build with JAX's grid; a cuda mesh over a gloo group
    raises and does not switch backend."""
    import jax

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import make_mesh as jax_make_mesh

    for axes, total in (((("data", -1), ("model", -1)), 4), ((("data", 3),), 2), ((("data", -1), ("model", 3)), 4),
                        ((("pipe", 3), ("expert", -1)), 4), ((("data", 1), ("expert", 8)), 4)):
        with pytest.raises(ValueError) as want:
            jax_make_mesh(JMesh(axes=axes), devices=jax.devices()[:total])
        with pytest.raises(ValueError) as got:
            PM.resolve_axes(axes, total)
        assert str(got.value) == str(want.value)
    assert PM.resolve_axes((("data", 1), ("expert", 2)), 4)[1] == [1, 2]
    assert PM.resolve_axes((("pipe", -1),), 4)[1] == [4]
    cases = [(("data", 2),), (("pipe", 2), ("expert", -1))]
    results = ranks.run(job_mesh, cases)
    want = jax_make_mesh(JMesh(axes=(("data", 2),)), devices=jax.devices()[:WORLD])
    members = [int(d.id) for d in want.devices.flat]
    assert [r[0][1] is not None for r in results] == [jax.devices()[i].id in members for i in range(WORLD)]
    assert [r[0][1] for r in results] == [(0,), (1,), None, None]
    want = jax_make_mesh(JMesh(axes=cases[1]), devices=jax.devices()[:WORLD])
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank, r in enumerate(results):
        assert r[1][0] == dict(want.shape) == {"pipe": 2, "expert": 2}
        assert tuple(int(c) for c in np.argwhere(ids == jax.devices()[rank].id)[0]) == r[1][1]
    for msg in ranks.run(job_backend_is_not_switched):
        assert msg is not None and "nccl" in msg.lower()


@pytest.mark.parametrize("kind", ["lxmert", "layoutlm", "visualbert"])
@pytest.mark.parametrize("axes", [(("data", 4), ("model", 2)), (("data", -1),)], ids=["data4-model2", "no-model"])
def test_rule_specs_equal_jax_key_by_key(kind, axes):
    """``infer_shardings`` under ``LXMERT_RULES`` equals JAX's, parameter
    by parameter through the converter's names (2-D kernels transposed);
    on a mesh without a ``model`` axis every spec replicates. The ZeRO-1
    moment specs equal JAX's ``zero1_state_shardings`` the same way."""
    import flax.traverse_util as tu
    import jax
    import optax

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import LXMERT_RULES as JRULES
    from vltk_tpu.parallel import infer_shardings as jax_infer
    from vltk_tpu.parallel import make_mesh as jax_make_mesh
    from vltk_tpu.parallel import zero1_state_shardings as jax_zero1
    from vltk_tpu.train.steps import TrainState
    from vltk_tpu_torch.models import convert

    cfg = {"lxmert": LX, "layoutlm": DOC, "visualbert": dict(DOC, visual_feat_dim=8)}[kind]
    example = {
        "lxmert": (np.zeros((1, 4), np.int32), np.zeros((1, 2, 8), np.float32), np.zeros((1, 2, 4), np.float32)),
        "layoutlm": (np.zeros((1, 4), np.int32), np.zeros((1, 4, 4), np.int32)),
        "visualbert": (np.zeros((1, 4), np.int32), np.zeros((1, 2, 8), np.float32)),
    }[kind]
    module, params, sd = jax_side(kind, cfg, 0, *example)
    jmesh = jax_make_mesh(JMesh(axes=axes))
    want = tu.flatten_dict(jax_infer(params, JRULES, jmesh))
    abstract = jax.eval_shape(lambda p: TrainState.create(apply_fn=None, params=p, tx=optax.adamw(1e-3)), params)
    want_mu = {tuple(str(k).strip(".[]'\"") for k in path): s for path, s in
               jax.tree_util.tree_leaves_with_path(jax_zero1(abstract, JRULES, jmesh, "data"))}
    name_of = {"lxmert": convert._lxmert_name, "layoutlm": convert._bert_name, "visualbert": convert._bert_name}[kind]
    mesh = types.SimpleNamespace(shape=dict(jmesh.shape))
    tensors = {k: torch.empty(v.shape) for k, v in sd.items()}
    got = infer_shardings(tensors, LXMERT_RULES, mesh)
    got_mu = zero1_state_shardings(tensors, LXMERT_RULES, mesh, "data")["exp_avg"]
    assert set(got) == {name_of(p) for p in want}
    sharded = 0
    for path, sharding in want.items():
        name = name_of(path)
        ndim = len(sd[name].shape)
        flip = (lambda e: e[::-1]) if path[-1] == "kernel" else (lambda e: e)
        pad = lambda spec: tuple(spec) + (None,) * (ndim - len(spec))  # noqa: E731
        assert pad(got[name].spec) == flip(pad(sharding.spec)), (path, name)
        mu = [s for p, s in want_mu.items() if p[-len(path):] == path and "mu" in p]
        assert len(mu) == 1, path
        assert pad(got_mu[name].spec) == flip(pad(mu[0].spec)), (path, name)
        sharded += any(e is not None for e in sharding.spec)
    assert sharded > 0 if "model" in jmesh.shape else sharded == 0


def test_shard_batch_places_leading_dim(ranks):
    """Rank r holds the block JAX's ``shard_batch`` puts on device r;
    scalars stay whole."""
    import jax

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import make_mesh as jax_make_mesh
    from vltk_tpu.parallel import shard_batch as jax_shard_batch

    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    results = ranks.run(job_shard_batch, {"x": x, "nested": {"y": x[:, 0].copy()}, "scale": 2.0})
    want = jax_shard_batch({"x": x}, jax_make_mesh(JMesh(axes=(("data", 4),)), devices=jax.devices()[:4]))["x"]
    by_device = {s.device.id: np.asarray(s.data) for s in want.addressable_shards}
    for rank, got in enumerate(results):
        np.testing.assert_array_equal(got["x"], by_device[jax.devices()[rank].id])
        np.testing.assert_array_equal(got["nested"]["y"], by_device[jax.devices()[rank].id][:, 0])
        assert got["scale"] == 2.0


# ------------------------------------------------------- tensor parallel


def test_tp_forward_matches_jax(ranks):
    """LXMERT under data 2 x model 2 (a head a rank, vocab-sharded words):
    lang and pooled equal JAX's unsharded forward at 1e-5; the model axis'
    ranks agree; the TP reduces ran."""
    rng = np.random.default_rng(0)
    inputs = lxmert_inputs(rng, 4, 8)
    module, params, sd = jax_side("lxmert", LX, 1, inputs["ids"][:1], inputs["feats"][:1], inputs["pos"][:1])
    lang, _, pooled = jit_apply(module, params, inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
    axes = (("data", 2), ("model", 2))
    results = with_axes(ranks.run(job_forward, "lxmert", LX, sd, axes, inputs), axes)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(lang), atol=1e-5)
    np.testing.assert_allclose(data_blocks(results, 2), np.asarray(pooled), atol=1e-5)
    for r in results:
        twin = next(o for o in results if o["dsm"][0] == r["dsm"][0] and o is not r)
        np.testing.assert_array_equal(r["out"][0], twin["out"][0])
        # 2 a layer (language, visual); the x-layer's 4 attentions (the
        # cross-attention both ways) and 2 feed-forwards
        assert r["counts"]["tp_reduce"] == 2 * 2 + 4 + 2 and r["counts"]["vocab_reduce"] == 1


_CACHE = {}


def _jax_token_gradients():
    """(batch, port state dict, JAX's loss, JAX's gradient by port name,
    the mean of the two data halves' losses) of the token loss, once."""
    if "grads" not in _CACHE:
        import jax

        from vltk_tpu.models.layoutlm import token_classification_loss as jax_loss

        batch = doc_batch(np.random.default_rng(1), 4, 32, (32, 20, 8, 1))
        module, params, sd = jax_side("layoutlm_tokens", DOC, 2, batch["ids"][:1], batch["boxes"][:1])

        def loss_fn(p):
            logits = module.apply({"params": p}, batch["ids"], batch["boxes"], batch["mask"])
            return jax_loss(logits, batch["labels"])

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        logits = np.asarray(jit_apply(module, params, batch["ids"], batch["boxes"], batch["mask"]))
        # what a mean of per-rank means over two data ranks would give
        halves = [float(jax_loss(logits[h], batch["labels"][h])) for h in (slice(0, 2), slice(2, 4))]
        _CACHE["grads"] = (batch, sd, float(loss), flax_grads_by_torch_name("layoutlm_tokens", grads),
                           float(np.mean(halves)))
    return _CACHE["grads"]


@pytest.mark.parametrize("axes", [(("data", 1), ("model", 4)), (("data", 4),), (("data", 2), ("model", 2))],
                         ids=["model4", "data4-uneven-counts", "data2-model2"])
def test_step_gradients_match_jax(ranks, axes):
    """The token loss of LayoutLM and its gradient: the ranks' losses
    averaged over ``data`` and the model axis' blocks put back together
    equal JAX's ``value_and_grad`` over the global batch (loss 1e-6,
    gradients atol 1e-5 / rtol 1e-4). The rows hold 32, 20, 8 and 1 valid
    tokens, so the data ranks' counts differ: a mean of per-rank means
    would miss JAX's loss."""
    batch, sd, want_loss, want, mean_of_means = _jax_token_gradients()
    results = with_axes(ranks.run(job_gradients, DOC, sd, axes, batch), axes)
    members = [r for r in results if r is not None]
    for r in members:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-6)
        assert r["counts"]["dp_grad_reduce"] == 1
    assert abs(mean_of_means - want_loss) > 1e-3
    got = global_grads(members, axes, sd)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-4, err_msg=name)


# ------------------------------------------------------ sequence parallel


def test_seq_sharded_forward_matches_jax(ranks):
    """``activation_sharding`` under data 2 x seq 2: every encoder layer
    sees its (n/2, s/2) block, and lang and pooled equal JAX's unsharded
    forward at 1e-5."""
    rng = np.random.default_rng(3)
    inputs = lxmert_inputs(rng, 4, 16)
    module, params, sd = jax_side("lxmert", LX, 3, inputs["ids"][:1], inputs["feats"][:1], inputs["pos"][:1])
    lang, _, pooled = jit_apply(module, params, inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
    axes = (("data", 2), ("seq", 2))
    cfg = dict(LX, activation_sharding=True)
    results = with_axes(ranks.run(job_forward, "lxmert", cfg, sd, axes, inputs), axes)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(lang), atol=1e-5)
    np.testing.assert_allclose(data_blocks(results, 2), np.asarray(pooled), atol=1e-5)
    for r in results:
        assert r["seen"][0] == (2, 8, 16)  # the language layer's block
        assert r["counts"]["seq_gather"] > 0


def _ulysses_case(ranks, kind, cfg, n, s, seed, axes=(("data", 1), ("seq", 2), ("model", 2)), full=False):
    """JAX's unsharded output and the ranks' results of the sequence-cut
    forward (``full``: also the state dict and the inputs)."""
    rng = np.random.default_rng(seed)
    if kind == "lxmert":
        inputs = lxmert_inputs(rng, n, s)
        example = (inputs["ids"][:1, :8], inputs["feats"][:1], inputs["pos"][:1])
        args = (inputs["ids"], inputs["feats"], inputs["pos"], inputs["mask"])
    elif kind == "layoutlm":
        inputs = {"ids": rng.integers(0, 64, (n, s)).astype(np.int64),
                  "boxes": rng.integers(0, 1000, (n, s, 4)).astype(np.int64),
                  "mask": np.ones((n, s), np.float32)}
        example = (inputs["ids"][:1, :8], inputs["boxes"][:1, :8])
        args = (inputs["ids"], inputs["boxes"], inputs["mask"])
    else:
        inputs = {"ids": rng.integers(0, 64, (n, s)).astype(np.int64),
                  "feats": rng.normal(size=(n, 4, 8)).astype(np.float32),
                  "mask": np.ones((n, s), np.float32)}
        example = (inputs["ids"][:1, :8], inputs["feats"][:1])
        args = (inputs["ids"], inputs["feats"], None, inputs["mask"])
    module, params, sd = jax_side(kind, cfg, seed, *example)
    want = jit_apply(module, params, *args)
    want = want if isinstance(want, tuple) else (want,)
    sp_cfg = dict(cfg, activation_sharding=True, seq_attention_sharding=True)
    results = with_axes(ranks.run(job_forward, kind, sp_cfg, sd, axes, inputs), axes)
    return (want, results, sd, inputs) if full else (want, results)


def test_ulysses_seq2048_matches_jax(ranks):
    """Ulysses (4 heads over model 2 x seq 2) at seq 2048: each layer sees
    1024 tokens, the layout switch is all-to-all, and lang and pooled equal
    JAX's unsharded forward at 2e-5."""
    cfg = dict(LX, num_heads=4, max_position_embeddings=2048)
    want, results = _ulysses_case(ranks, "lxmert", cfg, 2, 2048, 3)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(data_blocks(results, 2), np.asarray(want[2]), atol=2e-5)
    for r in results:
        assert r["seen"][0] == (2, 1024, 16)
        assert r["counts"]["ulysses_all_to_all"] == 8  # in and out of 2 language self-attentions


def test_layoutlm_ulysses_long_ocr_matches_jax(ranks):
    cfg = dict(DOC, hidden_size=16, intermediate_size=32, max_position_embeddings=1024)
    want, results = _ulysses_case(ranks, "layoutlm", cfg, 2, 1024, 4)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(want[0]), atol=2e-5)
    assert all(r["seen"][0] == (2, 512, 16) for r in results)


def test_visualbert_ulysses_matches_jax(ranks):
    """VisualBERT's (S + V) stream: 252 text + 4 region tokens."""
    cfg = dict(DOC, hidden_size=16, intermediate_size=32, visual_feat_dim=8, max_position_embeddings=512)
    want, results = _ulysses_case(ranks, "visualbert", cfg, 2, 252, 5)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(data_blocks(results, 1), np.asarray(want[1]), atol=2e-5)
    assert all(r["seen"][0] == (2, 128, 16) for r in results)


def _dense_attention(q, k, v, mask, dh):
    import jax
    import jax.numpy as jnp

    sc = jnp.einsum("nqhd,nkhd->nhqk", q, k) / np.sqrt(dh)
    sc = sc + (1.0 - mask)[:, None, None, :] * -10000.0
    return jnp.einsum("nhqk,nkhd->nqhd", jax.nn.softmax(sc, axis=-1), v)


def test_ring_attention_matches_dense_forward_and_grads(ranks):
    """``ring_self_attention`` on data 2 x seq 2 with a ragged key mask that
    travels with K/V: the output blocks and the gradients of sum(out^2)
    equal JAX's dense attention and ``jax.grad`` (1e-5)."""
    import jax

    rng = np.random.default_rng(0)
    n, s, nh, dh = 2, 32, 4, 8
    q, k, v = (rng.normal(size=(n, s, nh, dh)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(n, s)) > 0.2).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: _dense_attention(*a, mask, dh))(q, k, v))
    want_g = jax.jit(jax.grad(lambda *a: (_dense_attention(*a, mask, dh) ** 2).sum(), argnums=(0, 1, 2)))(q, k, v)
    results = ranks.run(job_ring, (("data", 2), ("seq", 2)), q, k, v, mask, 0.0, None)
    got, got_g = np.zeros_like(want), [np.zeros_like(want) for _ in range(3)]
    for r in results:
        got[r["at"]] = r["out"]
        for g, block in zip(got_g, r["grads"]):
            g[r["at"]] = block
    np.testing.assert_allclose(got, want, atol=1e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("axes", [(("data", 2), ("seq", 2)), (("seq", 2), ("model", 2))],
                         ids=["across-data", "across-model"])
def test_ring_dropout_masks_independent_across_shards(ranks, axes):
    """One (s, dh) block tiled over every example and head: with dropout
    the examples on different data ranks, and the heads on different
    model ranks, differ; a second run with the seed is bitwise the same;
    at rate 0 the ring equals JAX's dense attention."""
    rng = np.random.default_rng(1)
    n, s, nh, dh = 4, 32, 4, 8
    base = [rng.normal(size=(1, s, 1, dh)).astype(np.float32) for _ in range(3)]
    q, k, v = (np.tile(b, (n, 1, nh, 1)) for b in base)
    mask = np.ones((n, s), np.float32)

    def run(rate):
        out = np.zeros((n, s, nh, dh), np.float32)
        for r in ranks.run(job_ring, axes, q, k, v, mask, rate, 7):
            out[r["at"]] = r["out"]
        return out

    out = run(0.5)
    if axes[0][0] == "data":
        assert not np.array_equal(out[0], out[2]), "masks shared across data ranks"
    else:
        assert not np.array_equal(out[0, :, 0], out[0, :, 2]), "masks shared across model ranks"
    np.testing.assert_array_equal(out, run(0.5))
    import jax

    want = jax.jit(lambda *a: _dense_attention(*a, mask, dh))(q, k, v)
    np.testing.assert_allclose(run(0.0), np.asarray(want), atol=1e-5)


def test_ring_backend_lxmert_matches_jax(ranks):
    """LXMERT with the ring backend on data 2 x seq 2 at seq 512: lang and
    pooled equal JAX's unsharded forward at 2e-5; the K/V rotate."""
    cfg = dict(LX, num_heads=4, max_position_embeddings=512, seq_attention_backend="ring")
    want, results = _ulysses_case(ranks, "lxmert", cfg, 4, 512, 7, axes=(("data", 2), ("seq", 2)))
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(data_blocks(results, 2), np.asarray(want[2]), atol=2e-5)
    for r in results:
        assert r["seen"][0] == (2, 256, 16)
        assert r["counts"]["ring_rotate"] == 2 * 3 * 2 and r["counts"]["ulysses_all_to_all"] == 0


def test_ring_seq_degree_beyond_head_count(ranks):
    """2 heads over a 4-way seq axis, which Ulysses cannot split."""
    cfg = dict(LX, max_position_embeddings=512, seq_attention_backend="ring")
    want, results, sd, inputs = _ulysses_case(ranks, "lxmert", cfg, 2, 128, 11, axes=(("data", 1), ("seq", 4)),
                                              full=True)
    np.testing.assert_allclose(data_blocks(results, 0), np.asarray(want[0]), atol=2e-5)
    np.testing.assert_allclose(data_blocks(results, 2), np.asarray(want[2]), atol=2e-5)
    ulysses = dict(cfg, activation_sharding=True, seq_attention_sharding=True, seq_attention_backend="ulysses")
    with pytest.raises(AssertionError, match="Ulysses needs num_heads 2 divisible by model\\*seq 4"):
        ranks.run(job_forward, "lxmert", ulysses, sd, (("data", 1), ("seq", 4)), inputs)


# ----------------------------------------------------- ZeRO-1, clip, save


def test_zero1_moments_hold_one_slice_each(ranks):
    """ZeRO-1 over data 2 x model 2: every rank keeps 1/dp of each moment
    that the data axis divides, on JAX's layout (the first free dim, on
    top of the TP spec); the blocks put together are the whole moment, and
    two steps equal the run without ZeRO bitwise (each rank computes the
    same elementwise update on its slice)."""
    rng = np.random.default_rng(2)
    batches = [doc_batch(rng, 4, 32, (32, 20, 8, 1)) for _ in range(2)]
    _, _, sd = jax_side("layoutlm_tokens", DOC, 2, batches[0]["ids"][:1], batches[0]["boxes"][:1])
    axes = (("data", 2), ("model", 2))
    zero = with_axes(ranks.run(job_steps, DOC, sd, axes, batches, True, 0.0), axes)
    plain = with_axes(ranks.run(job_steps, DOC, sd, axes, batches, False, 0.0), axes)
    mesh = types.SimpleNamespace(shape=dict(axes))
    layout = zero1_state_shardings({k: torch.empty(v.shape) for k, v in sd.items()}, LXMERT_RULES, mesh)
    for z, p in zip(zero, plain):
        assert z["losses"] == p["losses"]
        for name, value in z["params"].items():
            np.testing.assert_array_equal(value, p["params"][name], err_msg=name)
        assert z["counts"]["zero_gather"] == 2 and p["counts"]["zero_gather"] == 0
        for name, moment in z["moments"].items():
            spec = layout["exp_avg"][name].spec
            full = p["moments"][name]
            if "data" in spec:
                dim = list(spec).index("data")
                assert moment.shape[dim] * 2 == full.shape[dim]
                step = moment.shape[dim]
                np.testing.assert_array_equal(moment, np.take(full, range(z["dsm"][0] * step, (z["dsm"][0] + 1) * step),
                                                              axis=dim), err_msg=name)
            else:
                np.testing.assert_array_equal(moment, full, err_msg=name)
    for name, sharding in layout["exp_avg"].items():  # no data axis: no dim was left to cut
        assert "data" in sharding.spec or all(e is not None for e in sharding.spec), name
    assert sum("data" in s.spec for s in layout["exp_avg"].values()) > len(sd) // 2


def test_clip_uses_the_global_norm(ranks):
    """Two clipped ZeRO-1 steps over data 2 x model 2 (the first at lr 0 of
    the warmup) equal the JAX package's train step (optax's
    ``clip_by_global_norm`` + ``adamw``) on the global batch (1e-5): the
    norm spans every TP block and ZeRO slice once. The clip is set to a
    quarter of the gradient's norm, so it bites."""
    import jax
    import optax

    from vltk_tpu import config as JC
    from vltk_tpu.models.layoutlm import token_classification_loss as jax_loss
    from vltk_tpu.train import optim as JO

    rng = np.random.default_rng(4)
    batches = [doc_batch(rng, 4, 32, (32, 20, 8, 1)) for _ in range(2)]
    module, params, sd = jax_side("layoutlm_tokens", DOC, 4, batches[0]["ids"][:1], batches[0]["boxes"][:1])

    def loss_fn(p, b, _rng):
        logits = module.apply({"params": p}, b["ids"], b["boxes"], b["mask"])
        return jax_loss(logits, b["labels"]), {}

    as_jax = [{k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in b.items()} for b in batches]
    grad_fn = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, None)[0]))
    clip = float(optax.global_norm(grad_fn(params, as_jax[1]))) / 4
    tcfg = JC.TrainConfig()
    tcfg.update({"learning_rate": 5e-3, "weight_decay": 0.01, "warmup_ratio": 0.0, "clip_grad_norm": clip})
    tx = JO.make_optimizer(tcfg, 100)  # JAX's train step is value_and_grad, then this chain
    update = jax.jit(tx.update)
    state, opt_state = params, tx.init(params)
    for b in as_jax:
        updates, opt_state = update(grad_fn(state, b), opt_state, state)
        state = optax.apply_updates(state, updates)
    want = flax_grads_by_torch_name("layoutlm_tokens", jax.device_get(state))
    axes = (("data", 2), ("model", 2))
    results = with_axes(ranks.run(job_steps, DOC, sd, axes, batches, True, clip), axes)
    for r in results:
        assert r["counts"]["clip_norm_reduce"] == 2
    got = global_grads([{**r, "grads": r["params"]} for r in results], axes, sd)
    for name in want:
        if name.endswith("key.bias"):
            # its gradient is 0 up to rounding (a key bias shifts a softmax
            # row by a constant), and Adam scales that rounding up to ~lr
            continue
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-5, err_msg=name)


def test_zero1_sharded_checkpoint_round_trip(ranks, tmp_path):
    """Each rank writes its own file; a restore onto the same mesh gives
    every parameter and moment slice back bitwise, still sliced; the saved
    moment blocks are JAX's ZeRO layout."""
    rng = np.random.default_rng(5)
    batch = doc_batch(rng, 4, 32, (32, 20, 8, 1))
    _, _, sd = jax_side("layoutlm_tokens", DOC, 5, batch["ids"][:1], batch["boxes"][:1])
    axes = (("data", 2), ("model", 2))
    results = ranks.run(job_checkpoint, DOC, sd, axes, batch, str(tmp_path))
    assert results[0]["files"] == ["layout.json"] + [f"rank{r}.pt" for r in range(WORLD)]
    for r in results:
        for name, value in r["saved"]["model"].items():
            np.testing.assert_array_equal(r["restored"]["model"][name], value)
        assert r["saved"]["optim"].keys() == r["restored"]["optim"].keys()
        for i, st in r["saved"]["optim"].items():
            for key, value in st.items():
                np.testing.assert_array_equal(r["restored"]["optim"][i][key], value)
        # still sliced as JAX lays ZeRO out: the word table (64, 32) cut
        # over model on its rows and over data on its columns; the
        # classifier (3, 32), which the data axis splits on dim 1 only
        assert r["moments"]["layoutlm.embeddings.word_embeddings.weight"].shape == (32, 16)
        assert r["moments"]["classifier.weight"].shape == (3, 16)


# --------------------------------------------------------------- experiment


def test_simple_experiment_data2_model2_matches_jax(ranks, tmp_path):
    """``OCRTokenExperiment`` under data 2 x model 2 with ZeRO-1, 3 steps:
    the logged losses equal the JAX experiment's (1e-4) and the port's
    mesh-less run's, and the final parameters put back together equal the
    mesh-less run's (1e-5)."""
    import json

    import jax

    from vltk_tpu import config as JC
    from vltk_tpu.experiments.ocr_tokens import OCRTokenExperiment as JExp
    from vltk_tpu.models.layoutlm import LayoutLMConfig as JCfg
    from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch

    rng = np.random.default_rng(8)
    s = 32
    data = []
    for _ in range(3):
        b = doc_batch(rng, 4, s, (32, 20, 8, 1))
        data.append({"vtext": b["ids"].astype(np.int32), "tokenbox": b["boxes"].astype(np.float32),
                     "tokenlabels": b["labels"].astype(np.int32),
                     "visual_attention_mask": b["mask"].astype(np.int32)})
    jconfig = JC.Config()
    jconfig.logdir = str(tmp_path / "jax")
    jconfig.train.update({"epochs": 1, "learning_rate": 5e-3})
    jconfig.data.lang.update({"max_visual_seq_length": s})

    class JTiny(JExp):
        model_config = JCfg(**DOC)

    jexp = JTiny(jconfig, loaders=(data, None))
    sd = {k: v.numpy() for k, v in jax_layoutlm_to_torch(jax.device_get(jexp.state.params)).items()}
    jexp()
    with open(os.path.join(jexp.logdir, "steps_log.json")) as f:
        want = [json.loads(line)["loss"] for line in f]
    axes = (("data", 2), ("model", 2))
    plain = ranks.run(job_experiment, DOC, sd, None, data, str(tmp_path / "plain"), str(tmp_path / "plain_ck"), False)
    meshed = with_axes(ranks.run(job_experiment, DOC, sd, axes, data, str(tmp_path / "mesh"),
                                 str(tmp_path / "mesh_ck"), True), axes)
    plain_losses = [r["loss"] for r in plain[0]["log"]]
    np.testing.assert_allclose(plain_losses, want, rtol=1e-4, atol=1e-4)
    for r in meshed:
        np.testing.assert_allclose([x["loss"] for x in r["log"]], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose([x["loss"] for x in r["log"]], plain_losses, rtol=1e-5, atol=1e-6)
        assert r["counts"]["zero_gather"] == 3 and r["counts"]["dp_grad_reduce"] == 3
    got = global_grads([{**r, "grads": r["params"]} for r in meshed], axes, sd)
    for name, value in plain[0]["params"].items():
        np.testing.assert_allclose(got[name], value, atol=1e-5, rtol=1e-5, err_msg=name)
    assert sorted(os.listdir(tmp_path / "mesh_ck" / "ocr_tokens_epoch_0_sharded")) == (
        ["layout.json"] + [f"rank{r}.pt" for r in range(WORLD)])


def test_one_rank_mesh_is_bitwise_the_mesh_less_run(ranks, tmp_path):
    """The one-rank mesh the card runs (data 1 x model 1, ZeRO-1 on data,
    rank 0 of the group): the collectives all run, and the losses and
    final parameters are bitwise those of the mesh-less experiment."""
    rng = np.random.default_rng(9)
    data = []
    for _ in range(3):
        b = doc_batch(rng, 4, 32, (32, 20, 8, 1))
        data.append({"vtext": b["ids"].astype(np.int32), "tokenbox": b["boxes"].astype(np.float32),
                     "tokenlabels": b["labels"].astype(np.int32),
                     "visual_attention_mask": b["mask"].astype(np.int32)})
    _, _, sd = jax_side("layoutlm_tokens", DOC, 9, data[0]["vtext"][:1], data[0]["tokenbox"][:1].astype(np.int32))
    axes = (("data", 1), ("model", 1))
    plain = ranks.run(job_experiment, DOC, sd, None, data, str(tmp_path / "p"), str(tmp_path / "pc"), False)[0]
    meshed = ranks.run(job_experiment, DOC, sd, axes, data, str(tmp_path / "m"), str(tmp_path / "mc"), True)
    assert meshed[1:] == [None] * (WORLD - 1)
    meshed = meshed[0]
    assert [x["loss"] for x in meshed["log"]] == [x["loss"] for x in plain["log"]]
    for name, value in plain["params"].items():
        np.testing.assert_array_equal(meshed["params"][name], value, err_msg=name)
    counts = meshed["counts"]
    for kind in ("dp_grad_reduce", "dp_metric_reduce", "zero_gather"):
        assert counts[kind] == 3, (kind, counts)
    assert counts["tp_reduce"] == 3 * 2 * DOC["l_layers"] and counts["tp_copy"] > 0
    assert counts["loss_count_reduce"] >= 3 and plain["counts"] == dict.fromkeys(C.KINDS, 0)


def job_check_tool(rank, ckpt_dir):
    """The cases of ``tools/check_parallel.py`` on the CPU group."""
    from vltk_tpu_torch.tools import check_parallel as T

    dev = torch.device("cpu")
    return {"gradients": T.case_gradients(dev), "zero1_steps": T.case_zero1_steps(dev, ckpt_dir),
            "ring_gradients": T.case_ring_gradients(dev), "gpipe_pipe4": T.case_gpipe(dev, (("pipe", 4),), None),
            "gpipe_pipe2_data2": T.case_gpipe(dev, (("pipe", 2), ("data", 2)), "data"),
            "moe_ep": T.case_moe_ep(dev)}


def test_check_parallel_tool_passes_on_the_gloo_group(ranks, tmp_path):
    """``tools.check_parallel`` (the multi-rank check run under torchrun on
    four cards) holds the sharded gradients, ZeRO-1 steps, the sharded
    checkpoint, the ring's gradients, GPipe on pipe 4 and on pipe 2 x data
    2, and the expert-parallel MoE against the mesh-less port; its cases
    pass on this group too (its Ulysses and ring forwards are this file's
    LXMERT cases against JAX; GPipe and the MoE are held against JAX in
    ``tests/test_torch_pipeline_moe.py``)."""
    for r in ranks.run(job_check_tool, str(tmp_path)):
        assert all(case["ok"] for case in r.values()), r


@pytest.mark.parametrize("tool,message", [("check_parallel", "torchrun --nproc-per-node 4"),
                                          ("repeat_training", "needs a CUDA device")])
def test_card_tools_refuse_to_run_elsewhere(tool, message, monkeypatch):
    """``tools.check_parallel`` outside a 4-rank torchrun and
    ``tools.repeat_training`` without a card exit with a message."""
    import importlib

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=message):
        importlib.import_module(f"vltk_tpu_torch.tools.{tool}").main([])


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the one-rank NCCL mesh")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_step_is_bitwise(cuda_device, monkeypatch):
    """On the card: ``make_mesh`` starts a one-rank NCCL group, and three
    ZeRO-1 steps of the tiny LayoutLM under data 1 x model 1 (the first at
    lr 0 of the warmup) equal the mesh-less steps bitwise, with every
    collective called. Both run on PyTorch's deterministic kernels: CUDA's
    default embedding backward sums a row's gradients in no fixed order."""
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, init_weights
    from vltk_tpu_torch.train.optim import make_optimizer
    from vltk_tpu_torch.train.steps import make_train_step

    batches = [{k: torch.from_numpy(v).to(cuda_device) for k, v in doc_batch(
        np.random.default_rng(i), 4, 32, (32, 20, 8, 1)).items()} for i in range(3)]
    mesh = make_mesh(PC.MeshConfig(axes=(("data", 1), ("model", 1))), device=cuda_device)
    assert dist.get_backend() == "nccl"
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = []
    torch.use_deterministic_algorithms(True)
    try:
        for m in (None, mesh):
            model = init_weights(LayoutLMForTokenClassification(LayoutLMConfig(**DOC)), 0).to(cuda_device)
            if m is not None:
                shard_params(model, LXMERT_RULES, m)
            opt, sched = make_optimizer(model, _train_config(clip_grad_norm=1.0, warmup_ratio=0.1), 10, mesh=m,
                                        zero1_axis="data" if m is not None else None)
            step = make_train_step(model, _token_loss, opt, sched, mesh=m)
            C.reset_counts()
            losses = [float(step(b)["loss"]) for b in batches]
            out.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}, C.counts()))
    finally:
        torch.use_deterministic_algorithms(False)
    assert out[0][0] == out[1][0]
    for name, value in out[0][1].items():
        assert torch.equal(out[1][1][name], value), name
    assert all(out[1][2][k] == 3 for k in ("dp_grad_reduce", "zero_gather", "clip_norm_reduce"))
    assert out[1][2]["tp_reduce"] == 3 * 2 * DOC["l_layers"]
