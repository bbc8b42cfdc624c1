"""The port's mixture-of-experts feed-forward held against the JAX package
on the CPU.

Weights are flax ``init`` params carried across with the port's converters;
inputs are made with numpy from a seed. Tolerances:

* ``moe_capacity`` and the routing plan (dispatch, combine, fraction):
  exactly equal, ties included (the same float32 operations in the same
  order; first-index argmax);
* ``MoEFeedForward`` and the models in float32: rtol/atol 1e-5 (1e-4 for
  whole models, where flax's E[x^2] - E[x]^2 LayerNorm variance and torch's
  two-pass one drift apart by ~1e-6 a norm); in bf16, atol 3e-2 on
  unit-scale LayerNorm outputs (experts in bf16 with float32 sums in
  another order: a few bf16 ulps);
* the aux losses 1e-6 relative; gradients rtol 1e-4, atol 1e-6 of the
  model's largest gradient. Against JAX, LXMERT runs one layer of each
  kind (every kind of MoE site); LXMERT-base's depth, 24 sites, is held
  in the port alone (24 terms in flax's call order): tracing and
  compiling the 9 / 5 / 5 model in JAX take ~15 s alone and ~45 s of a
  six-worker run.
"""

import dataclasses
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from vltk_tpu.models import layoutlm as JL
from vltk_tpu.models import lxmert as JX
from vltk_tpu.models import moe as JM

from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models import moe as PM
from vltk_tpu_torch.models.convert import jax_layoutlm_to_torch, jax_lxmert_to_torch
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification

TINY = dict(
    vocab_size=64, hidden_size=32, num_heads=2, intermediate_size=48, l_layers=9, x_layers=5,
    r_layers=5, visual_feat_dim=16, max_position_embeddings=32, num_answers=6, num_objects=5, num_attrs=3,
    hidden_dropout=0.0, attention_dropout=0.0,
)


def t(a):
    return torch.from_numpy(np.array(a))


def jit_apply(module, variables, *args, **kwargs):
    """flax ``apply`` under ``jax.jit``: compiling the model once is faster
    here than running it op by op, which compiles every op on first use."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def random_params(model, seed, *args):
    """Params of flax's shapes (``eval_shape``: its init is not compiled),
    normal x 0.1 from a seed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    gen = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (gen.normal(size=a.shape) * 0.1).astype(np.float32), shapes)


def block_pair(rng, dtype=None, **moe):
    """A flax ``MoEFeedForward`` with unit-scale params in flax's shapes and
    the port's block loaded with them through the converter, and a
    unit-scale input."""
    jcfg = dataclasses.replace(JX.LxmertConfig(**TINY), dtype=dtype, **moe)
    x = rng.normal(size=(2, 24, TINY["hidden_size"])).astype(np.float32)
    jmod = JM.MoEFeedForward(jcfg)
    params = random_params(jmod, 3, x)
    port = PM.MoEFeedForward(PX.LxmertConfig(**dataclasses.asdict(jcfg))).eval()
    port.load_state_dict(sub(jax_layoutlm_to_torch({"layer_0": {"ffn": params}}), "encoder.layer.0.moe."),
                         strict=True)
    return jmod, params, port, x


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("experts", [1, 2, 3, 8, 16])
def test_moe_capacity_matches_jax(top_k, experts):
    for tokens in (1, 7, 8, 20, 64, 197, 640, 1152, 4096):
        for factor in (0.25, 0.5, 1.0, 1.25, 1.5, 2.0):
            assert PM.moe_capacity(tokens, experts, top_k, factor) == JM.moe_capacity(tokens, experts, top_k, factor)


def routing_probs(rng, t, e, ties):
    """(t, e) float32 softmax rows; with ``ties``, logits from {0, 1, 2} so
    rows hold exactly equal maxima."""
    logits = (rng.integers(0, 3, (t, e)) if ties else rng.normal(size=(t, e))).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_plan_equals_jax(rng, top_k, factor, ties):
    """Dispatch, combine and fraction bitwise equal to JAX's, with
    overflowing experts at small factors and exact ties."""
    t_, e = 96, 4
    probs = routing_probs(rng, t_, e, ties)
    cap = JM.moe_capacity(t_, e, top_k, factor)
    want = JM.top_k_routing(jnp.asarray(probs), top_k, cap)
    got = PM.top_k_routing(t(probs), top_k, cap)
    for g, w, name in zip(got, want, ("dispatch", "combine", "fraction")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if factor <= 0.5:
        assert float(got[0].sum()) < top_k * t_  # some choices were dropped


def test_routing_takes_the_first_index_on_a_tie():
    probs = torch.tensor([[0.4, 0.4, 0.2], [0.2, 0.4, 0.4], [0.3, 0.3, 0.4]])
    dispatch, _, fraction = PM.top_k_routing(probs, 2, 8)
    chosen = dispatch.sum(-1)
    assert chosen.tolist() == [[1, 1, 0], [0, 1, 1], [1, 0, 1]]
    assert fraction.tolist() == pytest.approx([1 / 3, 1 / 3, 1 / 3])


# ------------------------------------------------------------ the block


@pytest.mark.parametrize("dtype,atol", [(None, 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("top_k,factor", [(1, 1.25), (2, 1.25), (2, 0.5)])
def test_block_matches_flax(rng, dtype, atol, top_k, factor):
    jmod, params, port, x = block_pair(rng, dtype, moe_experts=4, moe_top_k=top_k, moe_capacity_factor=factor)
    want, state = jit_apply(jmod, {"params": params}, x, mutable=["losses"])
    got = port(t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=atol, atol=atol)
    np.testing.assert_allclose(float(port.aux_loss.detach()), float(state["losses"]["moe_aux"]), rtol=1e-6)


def test_single_expert_equals_dense_ffn(rng):
    """E = 1, k = 1 at ample capacity: every token through the one expert
    with weight 1, so the block is the dense feed-forward with the same
    weights, exactly."""
    cfg = PX.LxmertConfig(**TINY)
    dense = PX.FeedForward(cfg).eval()
    moe = PM.MoEFeedForward(dataclasses.replace(cfg, moe_experts=1, moe_top_k=1, moe_capacity_factor=1.5)).eval()
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in dense.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        moe.wi.copy_(dense.intermediate.dense.weight.T[None])
        moe.bi.copy_(dense.intermediate.dense.bias[None])
        moe.wo.copy_(dense.output.dense.weight.T[None])
        moe.bo.copy_(dense.output.dense.bias[None])
        moe.LayerNorm.load_state_dict(dense.output.LayerNorm.state_dict())
    x = t(rng.normal(size=(2, 8, TINY["hidden_size"])).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(moe(x).numpy(), dense(x).numpy(), rtol=0, atol=1e-6)


def test_dropped_tokens_keep_the_residual(rng):
    """64 tokens, two experts at capacity 8 (factor 0.25), one choice: at
    most 16 tokens are kept; a dropped token's expert output is exactly 0,
    so its row is LN(x)."""
    port = PM.MoEFeedForward(PX.LxmertConfig(**TINY, moe_experts=2, moe_top_k=1, moe_capacity_factor=0.25)).eval()
    PX.init_weights(port, seed=3)
    x = t(rng.normal(size=(4, 16, TINY["hidden_size"])).astype(np.float32))
    with torch.no_grad():
        out = port(x)
        ln = port.LayerNorm(x)
    same = (out == ln).all(-1)
    assert int(same.sum()) >= 64 - 16
    assert not bool(same.all())


# ------------------------------------------------------------ the models


def lxmert_inputs(rng, n=2, s=8, v=6):
    ids = rng.integers(0, TINY["vocab_size"], (n, s)).astype(np.int32)
    feats = rng.normal(size=(n, v, TINY["visual_feat_dim"])).astype(np.float32)
    pos = rng.uniform(0, 1, (n, v, 4)).astype(np.float32)
    mask = np.ones((n, s), np.float32)
    mask[1, 5:] = 0
    vmask = np.ones((n, v), np.float32)
    vmask[0, 4:] = 0
    return ids, feats, pos, mask, vmask


def flax_losses(tree, path=()):
    """The sown aux terms in insertion (call) order, by flax path."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flax_losses(value, path + (key,))
        else:
            yield path, value


def port_module_name(path) -> str:
    """flax path of a sown term (without ``moe_aux``) -> the port's module."""
    top, layer, ffn = path
    m = re.fullmatch(r"(r_|x_)?layer_(\d+)", layer)
    stack = {"": "layer", "r_": "r_layers", "x_": "x_layers"}[m.group(1) or ""]
    block = {"ffn": "moe", "lang_ffn": "lang_moe", "visn_ffn": "visn_moe"}[ffn]
    return f"{top}.encoder.{stack}.{m.group(2)}.{block}"


def moe_lxmert(depth, seed):
    """A flax ``LxmertForVQA`` with MoE at (language, cross, visual) depth,
    its params, and the port's model loaded with them."""
    l_layers, x_layers, r_layers = depth
    jcfg = JX.LxmertConfig(**{**TINY, "l_layers": l_layers, "x_layers": x_layers, "r_layers": r_layers},
                           moe_experts=4, moe_top_k=2)
    model = JX.LxmertForVQA(jcfg)
    ids, feats, pos, _, _ = lxmert_inputs(np.random.default_rng(5))
    params = random_params(model, seed, ids, feats, pos)
    port = PX.LxmertForVQA(PX.LxmertConfig(**dataclasses.asdict(jcfg))).eval()
    port.load_state_dict(jax_lxmert_to_torch(params), strict=True)
    return model, params, port


def flax_call_order(l_layers, x_layers, r_layers):
    """The flax paths of LXMERT's sown terms in the order of the calls:
    the language layers, the visual layers, then each cross layer's
    language and visual feed-forwards."""
    return ([("lxmert", f"layer_{i}", "ffn") for i in range(l_layers)]
            + [("lxmert", f"r_layer_{i}", "ffn") for i in range(r_layers)]
            + [("lxmert", f"x_layer_{i}", ffn) for i in range(x_layers) for ffn in ("lang_ffn", "visn_ffn")])


def test_lxmert_base_depth_gives_24_aux_terms_in_flax_order(rng):
    """LXMERT-base depth (9 / 5 / 5 layers) at tiny width: 24 MoE sites,
    whose terms come back finite, positive and in the order flax sows
    them (their values against flax: the next test, at one layer of each
    kind)."""
    port = PX.init_weights(PX.LxmertForVQA(PX.LxmertConfig(**TINY, moe_experts=4, moe_top_k=2)), seed=6).eval()
    ids, feats, pos, mask, vmask = lxmert_inputs(rng)
    with torch.no_grad():
        port(t(ids), t(feats), t(pos), t(mask), t(vmask))
    aux = PM.moe_aux_losses(port)
    assert list(aux) == [port_module_name(p) for p in flax_call_order(9, 5, 5)]
    assert len(aux) == 9 + 5 + 2 * 5 == 24
    assert all(bool(torch.isfinite(v) and v > 0) for v in aux.values())


def test_lxmert_logits_aux_terms_and_gradients_match_jax(rng):
    """One layer of each kind (language, visual, cross: 4 MoE sites, every
    kind of site LXMERT-base's 24 are): the logits, the aux terms in
    flax's order, and the gradients of mean(logits^2) + sum(aux) against
    ``jax.value_and_grad``; every router's gradient nonzero."""
    model, params, port = moe_lxmert((1, 1, 1), 7)
    ids, feats, pos, mask, vmask = lxmert_inputs(rng)

    def loss(p):
        logits, state = model.apply({"params": p}, ids, feats, pos, mask, vmask, mutable=["losses"])
        return jnp.mean(logits ** 2) + sum(v for _, v in flax_losses(state["losses"])), (logits, state["losses"])

    (want_loss, (want_logits, losses)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_aux = [(path, float(v)) for path, v in flax_losses(jax.device_get(losses))]
    assert [path for path, _ in want_aux] == flax_call_order(1, 1, 1)
    logits = port(t(ids), t(feats), t(pos), t(mask), t(vmask))
    aux = PM.moe_aux_losses(port)
    total = (logits ** 2).mean() + sum(aux.values())
    total.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    assert list(aux) == [port_module_name(path) for path, _ in want_aux]
    np.testing.assert_allclose([float(v.detach()) for v in aux.values()], [v for _, v in want_aux], rtol=1e-6)
    np.testing.assert_allclose(float(total.detach()), float(want_loss), rtol=1e-5)
    want_grads = jax_lxmert_to_torch(jax.device_get(grads))
    got_grads = dict(port.named_parameters())
    assert set(want_grads) == set(got_grads)
    # an exactly-zero gradient (a key bias) is rounding noise on both sides;
    # torch leaves None where nothing reached a tensor (the last cross
    # layer's visual experts feed only their aux term's router)
    atol = 1e-6 * max(float(g.abs().max()) for g in want_grads.values())
    for name, want in want_grads.items():
        grad = got_grads[name].grad
        got = np.zeros(want.shape, np.float32) if grad is None else grad.numpy()
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=atol, err_msg=name)
    routers = [n for n in got_grads if n.endswith("router.weight")]
    assert len(routers) == 4
    assert all(float(got_grads[n].grad.abs().max()) > 0 for n in routers)


def test_layoutlm_forward_with_moe_matches_flax(rng):
    tiny = dict(vocab_size=100, hidden_size=32, num_heads=2, intermediate_size=48, l_layers=1,
                max_position_embeddings=64, moe_experts=4, moe_top_k=2)
    jcfg = JL.LayoutLMConfig(**tiny)
    model = JL.LayoutLMForTokenClassification(jcfg)
    ids = rng.integers(0, 100, (2, 40)).astype(np.int32)
    boxes = np.sort(rng.integers(0, 1000, (2, 40, 2, 2)), axis=2).reshape(2, 40, 4).astype(np.int32)
    mask = np.ones((2, 40), np.float32)
    mask[1, 30:] = 0
    params = random_params(model, 7, ids, boxes)
    want = jit_apply(model, {"params": params}, ids, boxes, mask)
    port = LayoutLMForTokenClassification(LayoutLMConfig(**dataclasses.asdict(jcfg))).eval()
    sd = jax_layoutlm_to_torch(params)
    assert sum(".moe." in k for k in sd) == 8
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(t(ids), t(boxes), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert len(PM.moe_aux_losses(port)) == 1
