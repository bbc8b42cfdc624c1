"""GPipe (``vltk_tpu_torch/parallel/pipeline.py``), expert parallelism with
global routing (``models/moe.py`` under ``LXMERT_MOE_RULES``), the sharded
serving bundle (``aot.py``), the model-parallel dropout generator and the
agreed preemption flag, on the CPU: one gloo group of 4 ranks, spawned once
for the module, runs every multi-rank case, and each result is held
against the JAX package's unsharded output at the same weights.

The cases mirror ``tests/test_moe_pipeline.py`` (GPipe against the
sequential stack on ``pipe`` 4 and on ``pipe`` 2 x ``data`` 2 with
``data_axis``, its gradient, LXMERT's language layers through the pipeline
with the stack / unstack round trip, the validations, the MoE forward under
``data`` 2 x ``expert`` 2) and ``tests/test_aot.py::TestShardedExport``,
plus: global routing under ``data`` 4 where the capacity drops tokens (a
rank routing its own tokens would drop others), the seq-cut MoE under
``data`` 2 x ``seq`` 2, an MoE training step's gradients under ``data`` 2 x
``expert`` 2, attention dropout under ``model`` 2, a SIGTERM on one rank,
and ``SimpleExperiment`` under ``data`` 2 x ``pipe`` 2.

Tolerances: JAX's own where it has one (toy forwards ``atol`` 1e-6; LXMERT
forwards and the toy gradients 1e-5); the MoE gradients ``atol`` 1e-5 with
``rtol`` 1e-4 (float32 sums over ranks in another order, as in
``tests/test_torch_parallel.py``); the extraction bundle 1e-4, the port's
FRCNN tolerance against JAX (``tests/test_torch_models.py``: float32 convs
summed in another order than XLA's); logged losses 1e-4.

Rank jobs are the module-level ``job_*`` functions: the ranks import this
module, torch, numpy and the port only (JAX is imported inside the tests),
run ``torch.set_num_threads(1)``, and exchange numpy arrays with the test.
"""

import os
import queue
import signal
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_parallel import (  # noqa: F401 - job_experiment runs on the ranks
    DOC,
    LX,
    _free_port,
    _mesh,
    _model,
    _numpy,
    _tensors,
    doc_batch,
    jax_side,
    job_experiment,
    lively,
    lxmert_inputs,
)
from vltk_tpu_torch.parallel import LXMERT_MOE_RULES, LXMERT_RULES, gpipe_spmd, shard_batch, shard_params, use_mesh
from vltk_tpu_torch.parallel import collectives as C
from vltk_tpu_torch.parallel.pipeline import stack_layer_params, unstack_layer_params

WORLD = 4
MOE = dict(LX, moe_experts=4, moe_top_k=2)
TINY_FRCNN = dict(depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_hidden_channels=16,
                  anchor_sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0), pre_nms_topk=64, post_nms_topk=16,
                  num_classes=7, num_attrs=5, pooler_resolution=7, min_detections=4, max_detections=4)
CANVAS = (64, 64)


# ---------------------------------------------------------------- the ranks


def _serve(rank, world, port, inbox, outbox):
    import datetime

    torch.set_num_threads(1)
    # loaded while the first test computes JAX's side
    import torch.export as _export  # noqa: F401

    import vltk_tpu_torch.aot  # noqa: F401
    import vltk_tpu_torch.models  # noqa: F401

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
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

    def run(self, job, *args, timeout=120):
        return self.start(job, *args)(timeout)

    def start(self, job, *args):
        """Hand ``job`` to the ranks and return a function that waits for
        their results (the test computes JAX's reference meanwhile)."""
        for q in self.inboxes:
            q.put((job.__name__, args))
        return lambda timeout=120: self._collect(job, timeout)

    def _collect(self, job, timeout):
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

    yield types.SimpleNamespace(run=lambda job, *a, **k: get().run(job, *a, **k),
                                start=lambda job, *a: get().start(job, *a))
    if _POOL.get("ranks") is not None:
        _POOL.pop("ranks").close()


# ------------------------------------------------------------- rank jobs


def toy_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def job_gpipe(rank, axes, stack, x, data_axis):
    """The toy stack through ``gpipe_spmd``; the gradients of sum(out^2)
    over the global stream (each data slice's share times dp, then the data
    reduce): (output block, gradients of the whole stack, coordinates)."""
    mesh = _mesh(axes)
    stacked = {k: torch.from_numpy(v).requires_grad_() for k, v in stack.items()}
    C.reset_counts()
    out = gpipe_spmd(toy_layer, stacked, torch.from_numpy(x), mesh=mesh, data_axis=data_axis)
    scale = mesh.axis_size(data_axis) if data_axis else 1
    loss = (out ** 2).sum() * scale
    loss.backward()
    C.reduce_gradients(stacked.values(), mesh)
    return {"out": out.detach().numpy(), "loss": float(loss), "grads": {k: v.grad.numpy() for k, v in stacked.items()},
            "pipe": mesh.coord("pipe"), "data": mesh.coord("data"), "counts": C.counts()}


def job_gpipe_layers(rank, axes, cfg, sd, h, mask, m):
    """The port's ``TransformerLayer`` stack through ``gpipe_spmd`` with
    ``functional_call`` on one template layer: (the output, the round trip
    of ``stack_layer_params``)."""
    from vltk_tpu_torch.models.lxmert import LxmertConfig, TransformerLayer

    mesh = _mesh(axes)
    config = LxmertConfig(**cfg)
    template = TransformerLayer(config).eval()
    stacked = stack_layer_params(_tensors(sd), "encoder.layer.", config.l_layers)
    back = unstack_layer_params(stacked, "encoder.layer.", config.l_layers)

    def layer_fn(p, xm):
        hidden, mk = xm
        return torch.func.functional_call(template, p, (hidden, mk)), mk

    n, s, hid = h.shape
    xm = (torch.from_numpy(h).view(m, n // m, s, hid), torch.from_numpy(mask).view(m, n // m, s))
    with torch.no_grad():
        out, _ = gpipe_spmd(layer_fn, stacked, xm, mesh=mesh)
    return {"out": out.reshape(n, s, hid).numpy(),
            "round_trip": all(torch.equal(back[k], torch.from_numpy(v)) for k, v in sd.items())}


def _moe_model(cfg, sd, mesh, rules):
    model = _model("lxmert", cfg)
    model.load_state_dict(_tensors(sd))
    shard_params(model, rules, mesh)
    return model


def job_moe_forward(rank, cfg, sd, axes, inputs):
    """The MoE LXMERT's forward on this rank's block under
    ``LXMERT_MOE_RULES``: (lang, visn, pooled), the local expert stack's
    shape, the collectives."""
    mesh = _mesh(axes)
    model = _moe_model(cfg, sd, mesh, LXMERT_MOE_RULES).eval()
    local = _tensors(shard_batch(inputs, mesh))
    C.reset_counts()
    with torch.no_grad(), use_mesh(mesh):
        out = model(local["ids"], local["feats"], local["pos"], local["mask"])
    wi = dict(model.named_parameters())["encoder.layer.0.moe.wi"]
    return {"out": _numpy(out), "wi": tuple(wi.shape), "coord": dict(zip(mesh.axis_names, mesh.coordinate)),
            "counts": C.counts()}


def _moe_loss(model, local):
    from vltk_tpu_torch.models.moe import moe_aux_losses

    lang, visn, pooled = model(local["ids"], local["feats"], local["pos"], local["mask"])
    return (lang ** 2).mean() + (visn ** 2).mean() + (pooled ** 2).mean() + sum(moe_aux_losses(model).values())


def job_moe_gradients(rank, cfg, sd, axes, inputs):
    """One forward and backward of ``_moe_loss`` on this rank's block, then
    the data reduce: (loss, local gradients, coordinates)."""
    mesh = _mesh(axes)
    model = _moe_model(cfg, sd, mesh, LXMERT_MOE_RULES)
    local = _tensors(shard_batch(inputs, mesh))
    C.reset_counts()
    with use_mesh(mesh):
        loss = _moe_loss(model, local)
        loss.backward()
        C.reduce_gradients(model.parameters(), mesh)
        loss = C.mean_over_data({"loss": loss}, mesh)["loss"]
    return {"loss": float(loss.detach()), "grads": _numpy({n: p.grad for n, p in model.named_parameters()}),
            "coord": dict(zip(mesh.axis_names, mesh.coordinate)), "counts": C.counts()}


def job_sharded_bundle(rank, sd, images, sizes, path):
    """Rank 0 exports the data-parallel extraction step under ``data`` 4
    (the program of one rank's block) and saves it; every rank loads it on
    the mesh and runs it on the global inputs. Then a load on a mesh of
    another size: the error."""
    from vltk_tpu_torch.aot import bundle_manifest, export_step, load_bundle, save_bundle
    from vltk_tpu_torch.models import FRCNN, FRCNNConfig
    from vltk_tpu_torch.ops.image_ops import preprocess_batch

    mesh = _mesh((("data", 4),))
    model = FRCNN(FRCNNConfig(**TINY_FRCNN)).eval()
    model.load_state_dict(_tensors(sd))

    def fwd(img, sz):
        pre = preprocess_batch(img, sz, canvas_hw=CANVAS, short=48.0, maximum=64.0)
        return model(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])["roi_features"].float()

    args = (torch.from_numpy(images), torch.from_numpy(sizes))
    if rank == 0:
        save_bundle(path, {"extract": export_step(fwd, args, modules={"model": model}, mesh=mesh)})
    dist.barrier()
    out, sharding = load_bundle(path, mesh=mesh)["extract"](*args)
    other = _mesh((("data", 2),))
    try:
        load_bundle(path, mesh=other)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {"out": out.numpy(), "spec": tuple(sharding.spec), "data": mesh.coord("data"), "refused": refused,
            "manifest": bundle_manifest(path)["sharding"]}


def job_tp_dropout(rank, cfg, sd, batch, remat):
    """LayoutLM under ``data`` 2 x ``model`` 2 in training mode with
    dropout: each layer's attention context (this rank's heads) and the
    attention block's output (after the row-parallel reduce and its
    dropout), seeded as ``SimpleExperiment`` seeds; with ``remat`` also the
    gradients with and without recompute."""
    from vltk_tpu_torch.models.layoutlm import token_classification_loss

    mesh = _mesh((("data", 2), ("model", 2)))
    local = _tensors(shard_batch(batch, mesh))

    def run(remat_on):
        torch.manual_seed(0 + mesh.replica_index)
        mesh.seed_model_parallel(0)
        model = _model("layoutlm_tokens", dict(cfg, remat=remat_on))
        model.load_state_dict(_tensors(sd))
        shard_params(model, LXMERT_RULES, mesh)
        seen = {"context": [], "block": []}
        for layer in model.layoutlm.encoder.layer:
            att = layer.attention
            att.output.register_forward_pre_hook(lambda m, args: seen["context"].append(args[0].detach().numpy()))
            att.register_forward_hook(lambda m, args, out: seen["block"].append(out.detach().numpy()))
        model.train()
        with use_mesh(mesh):
            logits = model(local["ids"], local["boxes"], local["mask"])
            token_classification_loss(logits, local["labels"]).backward()
        return seen, {n: p.grad.numpy() for n, p in model.named_parameters()}

    seen, grads = run(False)
    out = {"context": seen["context"][:cfg["l_layers"]], "block": seen["block"][:cfg["l_layers"]],
           "data": mesh.coord("data"), "model": mesh.coord("model")}
    if remat:
        out["grads"], out["remat_grads"] = grads, run(True)[1]
    return out


def job_preempt(rank, cfg, sd, data, logdir, ckpt_dir, signal_at):
    """``OCRTokenExperiment`` under ``data`` 2 x ``model`` 2 with dropout.
    ``signal_at`` (rank, step): that rank alone sends itself SIGTERM during
    that step; the run stops, then a new experiment resumes it from the
    checkpoint. ``None``: the run uninterrupted. -> the logged steps of
    each run and the final parameters."""
    import json

    from vltk_tpu_torch.config import Config
    from vltk_tpu_torch.experiments import OCRTokenExperiment
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    mesh = _mesh((("data", 2), ("model", 2)))

    class Tiny(OCRTokenExperiment):
        model_config = LayoutLMConfig(**cfg)

        def build_model(self):
            model = super().build_model()
            model.load_state_dict(_tensors(sd))
            return model

    def experiment():
        config = Config()
        config.logdir, config.checkpoint_dir = logdir, ckpt_dir
        config.train.update({"epochs": 1, "learning_rate": 5e-3})
        config.data.lang.update({"max_visual_seq_length": data[0]["vtext"].shape[1]})
        return Tiny(config, loaders=(data, None), mesh=mesh, rules=LXMERT_RULES)

    runs = []
    exp = experiment()
    if signal_at is not None:
        step = exp.train_step

        def signalled(batch):
            metrics = step(batch)
            if (rank, exp.global_step + 1) == tuple(signal_at):
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics

        exp.train_step = signalled
        C.reset_counts()
        runs.append({"result": exp().get("preempted", False), "counts": C.counts(),
                     "files": sorted(os.listdir(ckpt_dir))})
        exp = experiment()
        runs.append({"start": exp.global_step})
    exp()
    with open(os.path.join(exp.logdir, "steps_log.json")) as f:
        log = [json.loads(line) for line in f]
    return {"runs": runs, "log": [(r["step"], r["loss"]) for r in log],
            "params": _numpy(dict(exp.model.named_parameters()))}


# ------------------------------------------------------------------- GPipe


def _toy_stack(rng, layers, width):
    return {"w": (rng.normal(size=(layers, width, width)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(layers, width)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("axes,data_axis", [((("pipe", 4),), None), ((("pipe", 2), ("data", 2)), "data")],
                         ids=["pipe4", "pipe2-data2-data_axis"])
def test_gpipe_matches_the_sequential_stack_and_its_gradient(ranks, axes, data_axis):
    """GPipe against JAX's sequential stack (``atol`` 1e-6, JAX's
    :258/:274) and ``jax.grad`` of sum(out^2) over the whole stack (1e-5,
    JAX's :327): the stage gradients put together over ``pipe`` (each rank
    holds a gradient only in its L/P layers), with ``data_axis`` after the
    data reduce. Each tick runs one shift a way; one replicating reduce."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    layers, width, m, mb = 8, 8, 6, 4
    stack = _toy_stack(rng, layers, width)
    x = rng.normal(size=(m, mb, width)).astype(np.float32)

    def seq(p):
        h = jnp.asarray(x)
        for i in range(layers):
            h = jnp.tanh(h @ p["w"][i] + p["b"][i])
        return h

    pending = ranks.start(job_gpipe, axes, stack, x, data_axis)
    want = np.asarray(seq(stack))
    want_loss, want_g = jax.value_and_grad(lambda p: jnp.sum(seq(p) ** 2))(stack)
    results = pending()
    stages = dict(axes)["pipe"]
    per = layers // stages
    for r in results:
        rows = slice(r["data"] * mb // 2, (r["data"] + 1) * mb // 2) if data_axis else slice(None)
        np.testing.assert_allclose(r["out"], want[:, rows], atol=1e-6)
        for k, g in r["grads"].items():
            mine = slice(r["pipe"] * per, (r["pipe"] + 1) * per)
            assert not np.any(np.delete(g, range(mine.start, mine.stop), axis=0)), "a gradient outside the stage"
        assert r["counts"]["pipe_shift"] == 2 * (m + stages - 1) and r["counts"]["pipe_replicate"] == 1
    if not data_axis:
        for r in results:
            np.testing.assert_allclose(r["loss"], float(want_loss), rtol=1e-5)
    got = {k: sum(r["grads"][k] for r in results if r["data"] == 0) for k in stack}
    for k in stack:
        np.testing.assert_allclose(got[k], np.asarray(want_g[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("axes", [(("pipe", 4),), (("pipe", 2), ("data", 2))], ids=["pipe4", "pipe2-data2"])
def test_gpipe_lxmert_lang_layers_match_jax(ranks, axes):
    """Four LXMERT ``TransformerLayer``s stacked (``stack_layer_params`` of
    the port's ``encoder.layer.{i}`` names; the round trip through
    ``unstack_layer_params`` is bitwise) run through the pipeline in 4
    microbatches of 2 equal JAX's layers applied in turn (1e-5, JAX's
    :354)."""
    import jax

    from vltk_tpu.models.lxmert import LxmertConfig as JCfg
    from vltk_tpu.models.lxmert import TransformerLayer as JLayer
    from vltk_tpu_torch.models import convert

    cfg = dict(LX, l_layers=4)
    rng = np.random.default_rng(5)
    n, s, m = 8, 8, 4
    h = rng.normal(size=(n, s, cfg["hidden_size"])).astype(np.float32)
    mask = np.ones((n, s), np.float32)
    mask[:, 6:] = 0.0
    layer = JLayer(JCfg(**cfg))
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0), h[:2], mask[:2])["params"]
    per_layer = [lively(shapes, i) for i in range(cfg["l_layers"])]
    sd = {k: v.numpy() for k, v in convert.jax_lxmert_to_torch(
        {f"layer_{i}": p for i, p in enumerate(per_layer)}).items()}
    pending = ranks.start(job_gpipe_layers, axes, cfg, sd, h, mask, m)
    want = h
    apply = jax.jit(lambda p, x: layer.apply({"params": p}, x, mask))
    for p in per_layer:
        want = apply(p, want)
    for r in pending():
        assert r["round_trip"]
        np.testing.assert_allclose(r["out"], np.asarray(want), atol=1e-5)


def test_gpipe_validations_raise_as_in_jax():
    """``ValueError`` where JAX's ``gpipe_spmd`` raises (:399 and :274): L
    not divisible by the stages, no such axis, a microbatch not divisible
    by ``data_axis``; and for an empty stack. Both sides raise before any
    collective."""
    import jax
    import jax.numpy as jnp

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import gpipe_spmd as jax_gpipe
    from vltk_tpu.parallel import make_mesh as jax_make_mesh

    def jtoy(p, x):
        return jnp.tanh(x @ p["w"])

    def fake(axes):
        return types.SimpleNamespace(axis_names=tuple(a for a, _ in axes), shape=dict(axes))

    cases = [
        ((("pipe", 4),), {"w": np.zeros((6, 2, 2), np.float32)}, np.zeros((2, 2, 2), np.float32), None),
        ((("data", 4),), {"w": np.zeros((4, 2, 2), np.float32)}, np.zeros((2, 2, 2), np.float32), None),
        ((("pipe", 2), ("data", 2)), {"w": np.zeros((4, 2, 2), np.float32)}, np.zeros((2, 3, 2), np.float32),
         "data"),
        ((("pipe", 2), ("data", 2)), {"w": np.zeros((4, 2, 2), np.float32)}, np.zeros((2, 2, 2), np.float32),
         "model"),
    ]
    for axes, stack, x, data_axis in cases:
        jmesh = jax_make_mesh(JMesh(axes=axes), devices=jax.devices()[:4])
        with pytest.raises(ValueError) as want:
            jax_gpipe(jtoy, stack, x, mesh=jmesh, data_axis=data_axis)
        with pytest.raises(ValueError) as got:
            gpipe_spmd(toy_layer, {k: torch.from_numpy(v) for k, v in stack.items()}, torch.from_numpy(x),
                       mesh=fake(axes), data_axis=data_axis)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty"):
        gpipe_spmd(toy_layer, {}, torch.zeros(2, 2, 2), mesh=fake((("pipe", 1),)))


def test_stack_layer_params_refuses_uneven_layers():
    sd = {"layer.0.w": torch.zeros(2), "layer.0.b": torch.zeros(1), "layer.1.w": torch.zeros(2)}
    with pytest.raises(ValueError, match="other parameters"):
        stack_layer_params(sd, "layer.", 2)
    stacked = stack_layer_params({k: v for k, v in sd.items() if k.endswith("w")}, "layer.", 2)
    assert stacked["w"].shape == (2, 2)


# ------------------------------------------------------ expert parallelism


_JAX = {}


def _jax_moe(cfg, seed, inputs):
    """(flax module, params, the port's state dict) of the MoE LXMERT."""
    return jax_side("lxmert", cfg, seed, inputs["ids"][:1], inputs["feats"][:1], inputs["pos"][:1])


def _jax_forward(module, params, inputs):
    """JAX's unsharded (lang, visn, pooled)."""
    import jax

    out = jax.jit(lambda p, *a: module.apply({"params": p}, *a))(
        params, *(inputs[k] for k in ("ids", "feats", "pos", "mask")))
    return [np.asarray(o) for o in out]


#: the forward cases' MoE LXMERT: capacity factor 0.25, so the 64 language
#: tokens' 128 choices meet 4 experts x 8 slots and tokens drop
DROPPING = dict(MOE, moe_capacity_factor=0.25)


def _dropping_case():
    """(inputs, port state dict, JAX's unsharded outputs) of the MoE forward
    cases at 4 x 16 tokens, computed once."""
    if "dropping" not in _JAX:
        inputs = lxmert_inputs(np.random.default_rng(6), 4, 16)
        module, params, sd = _jax_moe(DROPPING, 6, inputs)
        _JAX["dropping"] = (inputs, sd, module, params)
    return _JAX["dropping"]


def _dropping_want():
    if "dropping_want" not in _JAX:
        inputs, _, module, params = _dropping_case()
        _JAX["dropping_want"] = _jax_forward(module, params, inputs)
    return _JAX["dropping_want"]


def _by_data(results, key, pick, **fixed):
    """Output ``pick`` of the ranks at ``fixed`` coordinates, in data order."""
    rows = [r for r in results if all(r["coord"].get(a, 0) == c for a, c in fixed.items())]
    rows.sort(key=lambda r: r["coord"].get("data", 0))
    return np.concatenate([r[key][pick] for r in rows], axis=0)


@pytest.mark.parametrize("axes", [(("data", 2), ("expert", 2)), (("data", 2), ("expert", 3)), (("expert", 2), ("model", 2))],
                         ids=["data2-expert2", "expert3-does-not-divide", "expert2-model2"])
def test_moe_rule_specs_equal_jax_key_by_key(axes):
    """``infer_shardings`` under ``LXMERT_MOE_RULES`` equals JAX's for every
    parameter of the MoE LXMERT (flax kernels transposed, the expert stacks
    in flax's layout): the stacks' expert dim over ``expert`` and their
    hidden dim over ``model``, replicated per dim where the axis is missing
    or does not divide (4 experts over 3: JAX's ``_fit_spec``)."""
    import flax.traverse_util as tu
    import jax

    from vltk_tpu.config import MeshConfig as JMesh
    from vltk_tpu.parallel import LXMERT_MOE_RULES as JRULES
    from vltk_tpu.parallel import infer_shardings as jax_infer
    from vltk_tpu.parallel import make_mesh as jax_make_mesh
    from vltk_tpu_torch.models import convert
    from vltk_tpu_torch.parallel import infer_shardings

    example = (np.zeros((1, 4), np.int32), np.zeros((1, 2, 8), np.float32), np.zeros((1, 2, 4), np.float32))
    _, params, sd = jax_side("lxmert", MOE, 0, *example)
    jmesh = jax_make_mesh(JMesh(axes=axes), devices=jax.devices()[:int(np.prod([n for _, n in axes]))])
    want = tu.flatten_dict(jax_infer(params, JRULES, jmesh))
    got = infer_shardings({k: torch.empty(v.shape) for k, v in sd.items()}, LXMERT_MOE_RULES,
                          types.SimpleNamespace(shape=dict(jmesh.shape)))
    assert set(got) == {convert._lxmert_name(p, is_moe=True) for p in want}
    for path, sharding in want.items():
        name = convert._lxmert_name(path, is_moe=True)
        ndim = len(sd[name].shape)
        pad = lambda spec: tuple(spec) + (None,) * (ndim - len(spec))  # noqa: E731
        flip = (lambda e: e[::-1]) if path[-1] == "kernel" else (lambda e: e)
        assert pad(got[name].spec) == flip(pad(sharding.spec)), (path, name)
    wi = tuple(got["encoder.layer.0.moe.wi"].spec)
    assert (wi[:1] == ("expert",)) == (dict(axes)["expert"] == 2)


def test_moe_expert_parallel_forward_matches_jax(ranks):
    """The MoE LXMERT (4 experts, top 2) under data 2 x expert 2 with
    ``LXMERT_MOE_RULES``: every rank holds 2 of the 4 experts, and lang,
    visn and pooled equal JAX's unsharded forward (1e-5, JAX's :202). The
    routing gather, the slots' sum and the combine's sum ran."""
    inputs, sd, _, _ = _dropping_case()
    axes = (("data", 2), ("expert", 2))
    pending = ranks.start(job_moe_forward, DROPPING, sd, axes, inputs)
    want = _dropping_want()
    results = pending()
    for r in results:
        assert r["wi"] == (2, LX["hidden_size"], LX["intermediate_size"])
        assert r["counts"]["moe_route_gather"] == 4 and r["counts"]["moe_dispatch_reduce"] == 4
        assert r["counts"]["moe_combine_reduce"] == 4
    for pick in range(3):
        for expert in range(2):
            np.testing.assert_allclose(_by_data(results, "out", pick, expert=expert), want[pick], atol=1e-5)


def test_moe_global_routing_drops_the_tokens_jax_drops(ranks):
    """Under data 4 at capacity factor 0.25 the 64 language tokens' 128
    choices meet 4 experts x 8 slots, so tokens drop. The port routes the
    global batch at one capacity: lang, visn and pooled equal JAX's (1e-5).
    Each rank routing its own 16 tokens would drop others: the mesh-less
    forward of each block alone (held against JAX by
    ``tests/test_torch_moe.py``) differs from the whole batch's."""
    inputs, sd, _, _ = _dropping_case()
    pending = ranks.start(job_moe_forward, DROPPING, sd, (("data", 4),), inputs)
    model = _model("lxmert", DROPPING).eval()
    model.load_state_dict(_tensors(sd))
    with torch.no_grad():
        alone = np.concatenate([model(*(torch.from_numpy(inputs[k][i:i + 1]) for k in ("ids", "feats", "pos", "mask")))
                                [0].numpy() for i in range(4)])
    want = _dropping_want()
    results = pending()
    for pick in range(3):
        np.testing.assert_allclose(_by_data(results, "out", pick), want[pick], atol=1e-5)
    assert np.abs(alone - want[0]).max() > 1e-3, "rank-local routing would give JAX's answer"


def test_moe_seq_sharded_stream_routes_in_global_order(ranks):
    """``activation_sharding`` under data 2 x seq 2: the language stream is
    cut over ``seq`` (each rank holds 2 rows x 8 of 16 tokens, not a run of
    the global order), the visual stream is whole; both MoE kinds route the
    global tokens, and lang, visn and pooled equal JAX's unsharded forward
    (1e-5)."""
    inputs, sd, _, _ = _dropping_case()
    pending = ranks.start(job_moe_forward, dict(DROPPING, activation_sharding=True), sd, (("data", 2), ("seq", 2)),
                          inputs)
    want = _dropping_want()
    results = pending()
    for pick in range(3):
        np.testing.assert_allclose(_by_data(results, "out", pick, seq=0), want[pick], atol=1e-5)


def test_moe_expert_parallel_training_gradients_match_jax(ranks):
    """One training step's loss (mean lang^2 + mean visn^2 + mean pooled^2
    + the aux terms) under data 2 x expert 2: the loss and every gradient, the
    router's and the expert stacks' put together over ``expert``, equal
    ``jax.value_and_grad`` over the global batch (loss 1e-6; gradients
    ``atol`` 1e-5, ``rtol`` 1e-4)."""
    import flax.traverse_util as tu
    import jax
    import jax.numpy as jnp

    from vltk_tpu_torch.models import convert

    rng = np.random.default_rng(8)
    cfg = dict(MOE, moe_capacity_factor=0.5)
    inputs = lxmert_inputs(rng, 4, 8)
    module, params, sd = _jax_moe(cfg, 8, inputs)
    pending = ranks.start(job_moe_gradients, cfg, sd, (("data", 2), ("expert", 2)), inputs)

    def loss_fn(p):
        (lang, visn, pooled), mut = module.apply({"params": p}, inputs["ids"], inputs["feats"], inputs["pos"],
                                                 inputs["mask"], mutable=["losses"])
        aux = sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(mut["losses"]))
        return jnp.mean(lang ** 2) + jnp.mean(visn ** 2) + jnp.mean(pooled ** 2) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = {k: v.numpy() for k, v in convert.jax_lxmert_to_torch(
        tu.unflatten_dict({k: np.asarray(v) for k, v in tu.flatten_dict(grads).items()})).items()}
    results = pending()
    for r in results:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        assert r["counts"]["moe_route_reduce_scatter"] == 4 and r["counts"]["ep_copy"] > 0
    by_expert = sorted((r for r in results if r["coord"]["data"] == 0), key=lambda r: r["coord"]["expert"])
    for name, w in want.items():
        stack = name.rsplit(".", 1)[-1] in ("wi", "bi", "wo", "bo")
        got = np.concatenate([r["grads"][name] for r in by_expert]) if stack else by_expert[0]["grads"][name]
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-4, err_msg=name)
        if not stack:  # replicated over the expert axis: the same gradient
            np.testing.assert_array_equal(by_expert[1]["grads"][name], got, err_msg=name)
    assert any(np.abs(want[n]).max() > 0 for n in want if n.endswith("router.weight"))


# ------------------------------------------------------- the sharded bundle


def test_sharded_extraction_bundle_matches_jax(ranks, tmp_path):
    """JAX's ``TestShardedExport``: the data-parallel extraction step
    (batch over ``data`` 4, parameters replicated) exports as one rank's
    program, the manifest records 4 devices and the specs, and each rank's
    output block equals JAX's unsharded ``fwd`` (1e-4, the port's FRCNN
    tolerance); a load on a mesh of 2 ranks raises."""
    import jax
    import jax.numpy as jnp

    from vltk_tpu.models import FRCNN as JFRCNN
    from vltk_tpu.models import FRCNNConfig as JConfig
    from vltk_tpu.models.convert import torch_frcnn_to_jax
    from vltk_tpu.ops.image_ops import preprocess_batch as jax_preprocess
    from vltk_tpu_torch.models import FRCNN, FRCNNConfig
    from vltk_tpu_torch.models.frcnn import init_weights

    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 255, (16, 64, 64, 3)).astype(np.float32)
    sizes = np.asarray([[48.0, 64.0]] * 16, np.float32)
    sd = {k: v.numpy() for k, v in init_weights(FRCNN(FRCNNConfig(**TINY_FRCNN)), seed=0).state_dict().items()}
    pending = ranks.start(job_sharded_bundle, sd, raw, sizes, str(tmp_path / "dp.zip"))
    model, params = JFRCNN(JConfig(**TINY_FRCNN)), torch_frcnn_to_jax(sd)

    def fwd(p, img, sz):
        pre = jax_preprocess(img, sz, canvas_hw=CANVAS, short=48.0, maximum=64.0)
        out = model.apply({"params": p}, pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])
        return out["roi_features"].astype(jnp.float32)

    want = np.asarray(jax.jit(fwd)(params, raw, sizes))
    results = pending()
    got = np.concatenate([r["out"] for r in sorted(results, key=lambda r: r["data"])])
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for r in results:
        assert r["out"].shape[0] == 4 and r["spec"] == ("data",)
        assert r["manifest"] == {"extract": {"nr_devices": 4, "in_specs": [["data"], ["data"]],
                                             "out_spec": ["data"]}}
        assert r["refused"] is not None and "mesh of 4 ranks" in r["refused"]


# ------------------------------------------------------------- the repairs


def _identical_heads(sd, cfg):
    """Every head's rows of the q, k and v projections set to head 0's, so
    without dropout every head computes the same context."""
    dh = cfg["hidden_size"] // cfg["num_heads"]
    out = dict(sd)
    for name, w in sd.items():
        if any(f".{p}." in name for p in ("query", "key", "value")):
            out[name] = np.concatenate([w[:dh]] * cfg["num_heads"], axis=0)
    return out


def test_tp_attention_dropout_masks_differ_across_model_ranks(ranks):
    """Training under data 2 x model 2 with attention and hidden dropout
    0.5, every head's projections equal: global heads h and h + nh/2 (on
    the two model ranks) get different attention masks, as under JAX's one
    draw over the global heads, while the attention block's output after
    the row-parallel reduce and its hidden dropout is identical on both
    model ranks (the replicated region keeps the default generator). With
    ``remat`` the recompute replays the model-parallel draws: the gradients
    equal those without it."""
    cfg = dict(DOC, hidden_dropout=0.5, attention_dropout=0.5)
    batch = doc_batch(np.random.default_rng(3), 4, 32, (32, 32, 32, 32))
    _, _, sd = jax_side("layoutlm_tokens", DOC, 3, batch["ids"][:1], batch["boxes"][:1])
    sd = {k: v for k, v in _identical_heads(sd, cfg).items()}
    results = ranks.run(job_tp_dropout, cfg, sd, batch, True)
    dh = cfg["hidden_size"] // cfg["num_heads"]
    for d in range(2):
        pair = sorted((r for r in results if r["data"] == d), key=lambda r: r["model"])
        for layer in range(cfg["l_layers"]):
            a, b = pair[0]["context"][layer], pair[1]["context"][layer]
            assert a.shape[-1] == b.shape[-1] == 2 * dh
            for head in range(2):  # global heads head and head + 2
                assert not np.array_equal(a[..., head * dh:(head + 1) * dh], b[..., head * dh:(head + 1) * dh]), (
                    "the model ranks' heads drew the same attention mask")
            np.testing.assert_array_equal(pair[0]["block"][layer], pair[1]["block"][layer])
    for r in results:
        for name, g in r["grads"].items():
            np.testing.assert_allclose(r["remat_grads"][name], g, atol=1e-6, rtol=1e-6, err_msg=name)


def _doc_data(seed, steps):
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(steps):
        b = doc_batch(rng, 4, 32, (32, 20, 8, 1))
        data.append({"vtext": b["ids"].astype(np.int32), "tokenbox": b["boxes"].astype(np.float32),
                     "tokenlabels": b["labels"].astype(np.int32),
                     "visual_attention_mask": b["mask"].astype(np.int32)})
    return data


def test_sigterm_on_one_rank_stops_every_rank_after_the_same_step(ranks, tmp_path):
    """Rank 3 alone gets SIGTERM during step 2 of 4 (data 2 x model 2,
    dropout 0.1): the flag's MAX over the mesh stops every rank after step
    2, the sharded mid-epoch save is written, and a new experiment resumes
    at step 2 and ends bitwise equal to the uninterrupted run (losses and
    parameters), the model-parallel generator's state included."""
    cfg = dict(DOC, hidden_dropout=0.1, attention_dropout=0.1)
    data = _doc_data(11, 4)
    _, _, sd = jax_side("layoutlm_tokens", DOC, 11, data[0]["vtext"][:1], data[0]["tokenbox"][:1].astype(np.int32))
    plain = ranks.run(job_preempt, cfg, sd, data, str(tmp_path / "p"), str(tmp_path / "pc"), None)
    cut = ranks.run(job_preempt, cfg, sd, data, str(tmp_path / "c"), str(tmp_path / "cc"), (3, 2), timeout=60)
    for p, c in zip(plain, cut):
        first, second = c["runs"]
        assert first["result"] is True and first["counts"]["preempt_agree"] == 2
        assert len(first["files"]) == 1 and "mid" in first["files"][0], first["files"]
        assert second["start"] == 2
        assert c["log"] == p["log"] and [s for s, _ in p["log"]] == [1, 2, 3, 4]
        for name, value in p["params"].items():
            np.testing.assert_array_equal(c["params"][name], value, err_msg=name)


def test_simple_experiment_data2_pipe2_matches_jax(ranks, tmp_path):
    """``OCRTokenExperiment`` (one layer) under data 2 x pipe 2, 3 steps: the pipe ranks
    are replicas (the batch is cut over ``data`` alone, as JAX shards it),
    the logged losses equal the JAX experiment's (1e-4), and the two pipe
    ranks of a data slice end with the same parameters."""
    import json

    import jax

    from vltk_tpu import config as JC
    from vltk_tpu.experiments.ocr_tokens import OCRTokenExperiment as JExp
    from vltk_tpu.models.layoutlm import LayoutLMConfig as JCfg
    from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch

    data = _doc_data(12, 3)
    jconfig = JC.Config()
    jconfig.logdir = str(tmp_path / "jax")
    jconfig.train.update({"epochs": 1, "learning_rate": 5e-3})
    jconfig.data.lang.update({"max_visual_seq_length": 32})

    cfg = dict(DOC, l_layers=1)

    class JTiny(JExp):
        model_config = JCfg(**cfg)

        def build_model(self):  # the same init, compiled once rather than op by op
            self.model = self.model_cls(self.model_config)
            zeros = np.zeros((1, 32), np.int32)
            params = jax.jit(self.model.init)(jax.random.PRNGKey(0), zeros, np.zeros((1, 32, 4), np.int32))
            return self.model.apply, params["params"]

    jexp = JTiny(jconfig, loaders=(data, None))
    sd = {k: v.numpy() for k, v in jax_layoutlm_to_torch(jax.device_get(jexp.state.params)).items()}
    axes = (("data", 2), ("pipe", 2))
    pending = ranks.start(job_experiment, cfg, sd, axes, data, str(tmp_path / "m"), str(tmp_path / "mc"), False)
    jexp()
    with open(os.path.join(jexp.logdir, "steps_log.json")) as f:
        want = [json.loads(line)["loss"] for line in f]
    results = pending()
    for r in results:
        np.testing.assert_allclose([x["loss"] for x in r["log"]], want, rtol=1e-4, atol=1e-4)
        assert r["counts"]["dp_grad_reduce"] == 3 and r["counts"]["preempt_agree"] == 3
    by_coord = {tuple(r["coord"]): r for r in results}
    for d in range(2):
        for name, value in by_coord[(d, 0)]["params"].items():
            np.testing.assert_array_equal(by_coord[(d, 1)]["params"][name], value, err_msg=name)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the one-rank NCCL pipeline")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_one_rank_nccl_pipeline_is_the_sequential_stack(cuda_device):
    """On the card: ``gpipe_spmd`` over a one-rank NCCL ``pipe`` axis runs
    the tiny LayoutLM's two layers on 4 microbatches; the output and the
    stack's gradients are bitwise those of the layers applied in turn to
    the same microbatches (deterministic kernels), and the shifts and the
    replicating reduce ran."""
    from vltk_tpu_torch.config import MeshConfig
    from vltk_tpu_torch.models.layoutlm import LayoutLM, LayoutLMConfig
    from vltk_tpu_torch.models.lxmert import init_weights
    from vltk_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(axes=(("pipe", 1),)), device=cuda_device)
    assert dist.get_backend() == "nccl"
    cfg = LayoutLMConfig(**DOC)
    layers = init_weights(LayoutLM(cfg), seed=0).to(cuda_device).encoder.layer
    sd = {f"layer.{i}.{k}": v for i, layer in enumerate(layers) for k, v in layer.state_dict().items()}
    template = layers[0]
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((4, 2, 32, cfg.hidden_size), generator=gen).to(cuda_device)
    mask = torch.ones((4, 2, 32), device=cuda_device)

    def layer_fn(p, xm):
        return torch.func.functional_call(template, p, (xm[0], xm[1])), xm[1]

    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for piped in (False, True):
            stacked = {k: v.detach().clone().requires_grad_() for k, v in stack_layer_params(sd, "layer.", 2).items()}
            C.reset_counts()
            if piped:
                out = gpipe_spmd(layer_fn, stacked, (h, mask), mesh=mesh)[0]
            else:
                per = [dict(zip(stacked, v)) for v in zip(*(t.unbind(0) for t in stacked.values()))]
                outs = []
                for i in range(4):
                    xm = (h[i], mask[i])
                    for p in per:
                        xm = layer_fn(p, xm)
                    outs.append(xm[0])
                out = torch.stack(outs)
            (out.float() ** 2).sum().backward()
            runs.append((out.detach(), {k: v.grad for k, v in stacked.items()}, C.counts()))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(runs[0][0], runs[1][0])
    for k, g in runs[0][1].items():
        assert torch.equal(runs[1][1][k], g), k
    assert runs[1][2]["pipe_shift"] == 2 * 4 and runs[1][2]["pipe_replicate"] == 1
