"""The port's VisualBERT held against the JAX package and HF on the CPU,
at tiny size (2 layers, hidden 32 or 128, 2-4 heads, 16-d region
features).

Weights are drawn at unit scale in flax's shapes and carried across with
``jax_visualbert_to_torch``; inputs are made with numpy from a seed, with
a padded question (a pad hole between the real text and the visual
tokens) and a padded visual row. Tolerances:

* float32 against flax: rtol/atol 1e-5 for the embeddings, 1e-4 for the
  encoder and the head (flax's E[x^2] - E[x]^2 LayerNorm variance against
  torch's two-pass one, ~1e-6 a norm through the layers);
* bf16 (the compute type of the projections; LayerNorm and the residual
  stay float32): 2^-6 of the output's largest magnitude (4 bf16 ulps) for
  the embeddings, 2^-5 after the layers (two layers of bf16 products that
  round differently now and then, then the float32 pooler over the CLS row);
* against HF: rtol 2e-4, atol 2e-5, as the JAX package's own HF test;
* the plain flash version on the stream with the hole against
  ``_flash_self_attention`` in Pallas interpret mode: 2e-5; the model on
  the flash route forced on the CPU against flax's dense route at real
  positions: 1e-4 (the routes differ at pad queries only).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu.models import lxmert as JX
from vltk_tpu.models import visualbert as JB

from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models import visualbert as PB
from vltk_tpu_torch.models.convert import jax_visualbert_to_torch
from vltk_tpu_torch.ops.flash_attention import flash_self_attention

TINY = dict(vocab_size=99, hidden_size=32, num_heads=4, intermediate_size=64, l_layers=2, visual_feat_dim=16,
            max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)
S, V = 10, 5
BF16_TOL = {"embeddings": 2.0 ** -6, "layers": 2.0 ** -5}


def t(a):
    return torch.from_numpy(np.array(a))


def jit_apply(module, variables, *args, **kwargs):
    """flax ``apply`` under ``jax.jit``: compiling the model once is faster
    here than running it op by op, which compiles every op on first use."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def lively(shapes, seed):
    """Params in flax's shapes at unit scale: kernels N(0, 1/fan_in),
    LayerNorm scales U(0.5, 1.5), embeddings N(0, 1), biases N(0, 0.1)."""
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


def vb_inputs(rng, n=3, s=S, v=V, cfg=TINY):
    """ids, features, a text mask whose row 1 has a pad tail (the hole
    before the visual tokens), a visual mask whose row 0 has 3 real
    regions, token types."""
    ids = rng.integers(0, cfg["vocab_size"], (n, s)).astype(np.int32)
    feats = rng.normal(size=(n, v, cfg["visual_feat_dim"])).astype(np.float32)
    mask = np.ones((n, s), np.float32)
    mask[1, s * 2 // 3:] = 0
    vmask = np.ones((n, v), np.float32)
    vmask[0, 3:] = 0
    types = rng.integers(0, 2, (n, s)).astype(np.int32)
    return ids, feats, mask, vmask, types


def pair(cls_j, cls_p, dtype=None, seed=0, **over):
    jcfg = JB.VisualBertConfig(**{**TINY, **over}, dtype=dtype)
    jmod = cls_j(jcfg)
    ids, feats, *_ = vb_inputs(np.random.default_rng(0), cfg={**TINY, **over})
    params = lively(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), ids, feats)["params"], seed)
    port = cls_p(PB.VisualBertConfig(**dataclasses.asdict(jcfg))).eval()
    return jmod, params, port


def close(got, want, dtype, atol, err_msg="", where="layers"):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    if dtype:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL[where] * float(np.abs(want).max()),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=atol, atol=atol, err_msg=err_msg)


def test_config_matches_jax():
    assert dataclasses.asdict(PB.VisualBertConfig()) == dataclasses.asdict(JB.VisualBertConfig())
    assert (PB.VisualBertConfig().l_layers, PB.VisualBertConfig().num_labels) == (12, 2)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_embeddings_match_flax(rng, dtype):
    jmod, params, port = pair(JB.VisualBertEmbeddings, PB.VisualBertEmbeddings, dtype)
    sd = sub(jax_visualbert_to_torch({"embeddings": params}), "embeddings.")
    port.load_state_dict(sd, strict=True)
    ids, feats, _, _, types = vb_inputs(rng)
    want = jit_apply(jmod, {"params": params}, ids, feats, types)
    with torch.no_grad():
        got = port(t(ids).long(), t(feats), t(types).long())
    assert got.dtype == torch.float32 and got.shape == (3, S + V, TINY["hidden_size"])
    close(got, want, dtype, 1e-5, where="embeddings")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_encoder_matches_flax(rng, dtype):
    """The whole stream on the dense route, pad positions included (both
    packages add -10000 to the pad keys), and the pooled CLS."""
    jmod, params, port = pair(JB.VisualBert, PB.VisualBert, dtype)
    port.load_state_dict(jax_visualbert_to_torch(params), strict=True)
    ids, feats, mask, vmask, types = vb_inputs(rng)
    want_seq, want_pool = jit_apply(jmod, {"params": params}, ids, feats, None, mask, vmask, types)
    with torch.no_grad():
        seq, pooled = port(t(ids).long(), t(feats), None, t(mask), t(vmask), t(types).long())
    assert seq.dtype == pooled.dtype == torch.float32
    close(seq, want_seq, dtype, 1e-4, "sequence")
    close(pooled, want_pool, dtype, 1e-4, "pooled")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_classifier_and_loss_match_flax(rng, dtype):
    jmod, params, port = pair(JB.VisualBertForClassification, PB.VisualBertForClassification, dtype)
    sd = jax_visualbert_to_torch(params)
    assert {k for k in sd if not k.startswith("visual_bert.")} == {"cls.weight", "cls.bias"}
    port.load_state_dict(sd, strict=True)
    ids, feats, mask, vmask, types = vb_inputs(rng)
    want = jit_apply(jmod, {"params": params}, ids, feats, None, mask, vmask, types)
    with torch.no_grad():
        got = port(t(ids).long(), t(feats), None, t(mask), t(vmask), t(types).long())
    assert got.shape == (3, 2) and got.dtype == torch.float32
    close(got, want, dtype, 1e-4)
    labels = np.array([0, 1, 1], np.int32)
    np.testing.assert_allclose(float(PB.classification_loss(got, t(labels))),
                               float(JB.classification_loss(jnp.asarray(got.numpy()), jnp.asarray(labels))),
                               rtol=1e-6)


def test_stream_longer_than_the_position_table_raises_as_jax(rng):
    ids, feats, *_ = vb_inputs(rng, s=70)
    jmod = JB.VisualBertEmbeddings(JB.VisualBertConfig(**TINY))
    with pytest.raises(ValueError, match="max_position_embeddings=64"):
        jmod.init(jax.random.PRNGKey(0), ids, feats)
    port = PB.VisualBertEmbeddings(PB.VisualBertConfig(**TINY))
    with pytest.raises(ValueError, match="max_position_embeddings=64"):
        port(t(ids).long(), t(feats))
    _, feats, *_ = vb_inputs(rng, v=65)
    with pytest.raises(ValueError, match="stream length 65"):
        port(t(ids[:, :10]).long(), t(feats))


def hf_config(transformers):
    return transformers.VisualBertConfig(
        vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        visual_embedding_dim=16, max_position_embeddings=64, type_vocab_size=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, special_visual_initialize=False,
    )


@pytest.mark.parametrize("headed", [False, True])
def test_hf_state_dicts_load_strictly_and_match_hf(rng, headed, monkeypatch):
    """HF ``VisualBertModel`` into ``VisualBert``, HF
    ``VisualBertForVisualReasoning`` (``visual_bert.`` and ``cls``) into
    ``VisualBertForClassification``."""
    monkeypatch.setenv("USE_TF", "0")  # HF's models here are torch ones: importing TensorFlow is ~10 s
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = hf_config(transformers)
    if headed:
        cfg.num_labels = 2
    hf = (transformers.VisualBertForVisualReasoning if headed else transformers.VisualBertModel)(cfg).eval()
    port = (PB.VisualBertForClassification if headed else PB.VisualBert)(PB.VisualBertConfig(**TINY)).eval()
    port.load_state_dict(hf.state_dict(), strict=True)
    ids, feats, mask, vmask, types = vb_inputs(rng)
    with torch.no_grad():
        out = hf(input_ids=t(ids).long(), attention_mask=t(mask).long(), token_type_ids=t(types).long(),
                 visual_embeds=t(feats), visual_attention_mask=t(vmask).long(),
                 visual_token_type_ids=torch.ones((3, V), dtype=torch.long))
        got = port(t(ids).long(), t(feats), None, t(mask), t(vmask), t(types).long())
    if headed:
        np.testing.assert_allclose(got.numpy(), out.logits.numpy(), rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got[0].numpy(), out.last_hidden_state.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), out.pooler_output.numpy(), rtol=2e-4, atol=2e-5)


def flash_stream(rng, n=2, s_text=100, v=36, dh=64):
    """q, k, v of a stream of ``s_text`` text and ``v`` visual positions
    (s = 136, padded to 256 inside), row 1's question real on its first 40
    positions only: a pad hole between real text and the visual tokens."""
    s = s_text + v
    q, k, vv = (rng.normal(size=(n, s, 2, dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((n, s), np.float32)
    mask[1, 40:s_text] = 0
    mask[0, s - 6:] = 0  # pad regions of row 0
    return q, k, vv, mask


def test_plain_flash_on_the_stream_with_a_hole_matches_pallas_interpret(rng):
    import jax.experimental.pallas.tpu as pltpu

    q, k, v, mask = flash_stream(rng)
    with pltpu.force_tpu_interpret_mode():
        want = JX._flash_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), 64)
    got = flash_self_attention(t(q), t(k), t(v), t(mask), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_forced_flash_route_matches_flax_at_real_positions(rng):
    """A 100-token question (row 1 real on 40) and 36 regions, so 136
    positions reach the 128 gate: the port's flash route, forced open on
    the CPU (the plain version in every layer), against flax's dense route
    where the mask is 1."""
    over = dict(hidden_size=128, num_heads=2, intermediate_size=128, max_position_embeddings=128)
    jmod, params, port = pair(JB.VisualBert, PB.VisualBert, seed=2, **over)
    port = PB.VisualBert(dataclasses.replace(port.cfg, attention_impl="flash")).eval()
    port.load_state_dict(jax_visualbert_to_torch(params), strict=True)
    ids, feats, mask, vmask, types = vb_inputs(rng, 2, s=100, v=36, cfg={**TINY, **over})
    mask[1, 40:] = 0
    want_seq, want_pool = jit_apply(jmod, {"params": params}, ids, feats, None, mask, vmask, types)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PX, "_flash_applicable", lambda s, det, drop, dev: s >= 128 and (det or drop == 0.0))
        mp.setattr(PX, "flash_attention_auto", lambda *a: calls.append(1) or flash_self_attention(*a))
        with torch.no_grad():
            seq, pooled = port(t(ids).long(), t(feats), None, t(mask), t(vmask), t(types).long())
    assert len(calls) == TINY["l_layers"]
    real = np.concatenate([mask, vmask], 1) > 0
    np.testing.assert_allclose(seq.numpy()[real], np.asarray(want_seq)[real], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool), rtol=1e-4, atol=1e-4)


def test_moe_visualbert_builds_and_runs(rng):
    """The lifted MoE guard reaches VisualBERT: each layer's feed-forward
    is the MoE block, against flax."""
    jmod, params, port = pair(JB.VisualBert, PB.VisualBert, seed=3, moe_experts=4, moe_top_k=2)
    sd = jax_visualbert_to_torch(params)
    assert sum(".moe.wi" in k for k in sd) == TINY["l_layers"]
    port.load_state_dict(sd, strict=True)
    ids, feats, mask, vmask, types = vb_inputs(rng)
    want_seq, _ = jit_apply(jmod, {"params": params}, ids, feats, None, mask, vmask, types)
    with torch.no_grad():
        seq, _ = port(t(ids).long(), t(feats), None, t(mask), t(vmask), t(types).long())
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), rtol=1e-4, atol=1e-4)
