"""The port's ViT held against the JAX package and HF on the CPU, at tiny
size (2 layers, hidden 24, 2 heads, 32x32 images of 16x16 patches).

Weights are drawn at unit scale in flax's shapes and carried across with
``jax_vit_to_torch``; inputs are made with numpy from a seed. Tolerances:

* float32, the blocks and the model against flax: rtol/atol 1e-5 (flax's
  E[x^2] - E[x]^2 LayerNorm variance against torch's two-pass one: ~1e-6);
  against HF: atol 3e-5, as the JAX package's own HF test;
* bf16 (a bf16 residual stream): 4 bf16 ulps of the output's largest
  magnitude, 2^-6 of it (sums of bf16 products in another order round
  differently now and then);
* ``"flash"`` against ``"xla"`` on the CPU: bitwise (the gate keeps the
  dense route off the card);
* the plain flash version at ViT's case (s = 197, ``mask=None``) against
  ``_flash_self_attention`` in Pallas interpret mode: 2e-5;
* int8 against flax's ``Int8Dense`` with the same scales: 1e-4, where an
  int8 rounding flip reached at most a third of the elements within 1e-2
  of the output's scale (``test_torch_int8.py``'s rule).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu.models import lxmert as JX
from vltk_tpu.models import vit as JV
from vltk_tpu.models.layers import calibrate_int8_variables

from vltk_tpu_torch.models import vit as PV
from vltk_tpu_torch.models.convert import jax_quant_to_torch, jax_vit_to_torch
from vltk_tpu_torch.models.layers import calibrate_int8_scales, load_int8_scales
from vltk_tpu_torch.ops.flash_attention import flash_self_attention

TINY = dict(hidden_size=24, num_heads=2, num_layers=2, intermediate_size=48, image_size=32, patch_size=16)
BF16_ULPS = 2.0 ** -6
TOL = 1e-4
FLIP = 1e-2


def t(a):
    return torch.from_numpy(np.array(a))


def jit_apply(module, variables, *args, **kwargs):
    """flax ``apply`` under ``jax.jit``: compiling the model once is faster
    here than running it op by op, which compiles every op on first use."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def lively(shapes, seed):
    """Params in flax's shapes at unit scale: kernels N(0, 1/fan_in),
    LayerNorm scales U(0.5, 1.5), the CLS token and positions N(0, 0.5),
    biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    flat = tu.flatten_dict(shapes, sep="/")
    for k, v in flat.items():
        leaf, shape = k.rsplit("/", 1)[-1], tuple(v.shape)
        if leaf == "kernel":
            arr = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "scale":
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("cls_token", "position_embeddings"):
            arr = rng.normal(0, 0.5, shape)
        else:
            arr = rng.normal(0, 0.1, shape)
        flat[k] = arr.astype(np.float32)
    return tu.unflatten_dict(flat, sep="/")


def images(rng, n=2):
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32)


def model_pair(dtype=None, seed=0, **over):
    """Flax ViT with lively params and the port's ViT loaded with them."""
    jcfg = JV.ViTConfig(**TINY, dtype=dtype, **over)
    jmodel = JV.ViT(jcfg)
    params = lively(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), images(np.random.default_rng(0), 1))["params"],
                    seed)
    port = PV.ViT(PV.ViTConfig(**dataclasses.asdict(jcfg))).eval()
    port.load_state_dict(jax_vit_to_torch(params), strict=True)
    return jmodel, params, port


def close_bf16(got, want, err_msg=""):
    got, want = f32(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULPS * float(np.abs(want).max()), err_msg=err_msg)


def test_config_matches_jax():
    assert dataclasses.asdict(PV.ViTConfig()) == dataclasses.asdict(JV.ViTConfig())
    cfg = PV.ViTConfig()
    assert (cfg.num_patches, cfg.compute_dtype) == (196, torch.float32)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block", ["att", "mlp"])
def test_blocks_match_flax(rng, block, dtype):
    """``_PreLNAttention`` and ``_PreLNMLP`` on a bf16 or float32 residual
    stream (the stream's type is the compute type after the embeddings)."""
    jcfg = JV.ViTConfig(**TINY, dtype=dtype)
    jmod = (JV._PreLNAttention if block == "att" else JV._PreLNMLP)(jcfg)
    dt = jnp.bfloat16 if dtype else jnp.float32
    x = jnp.asarray(rng.normal(size=(2, 5, TINY["hidden_size"])), dt)
    params = lively(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"], 3)
    port = (PV._PreLNAttention if block == "att" else PV._PreLNMLP)(PV.ViTConfig(**dataclasses.asdict(jcfg))).eval()
    port.load_state_dict(sub(jax_vit_to_torch({f"layer_0_{block}": params}), "encoder.layer.0."), strict=True)
    want = jit_apply(jmod, {"params": params}, x)
    with torch.no_grad():
        got = port(t(np.asarray(x.astype(jnp.float32))).to(port.cfg.compute_dtype))
    assert got.dtype == port.cfg.compute_dtype
    if dtype:
        close_bf16(got, want)
    else:
        np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_model_matches_flax(rng, dtype):
    jmodel, params, port = model_pair(dtype)
    imgs = images(rng)
    want_seq, want_pool = jit_apply(jmodel, {"params": params}, imgs)
    with torch.no_grad():
        seq, pooled = port(t(imgs))
    assert seq.dtype == pooled.dtype == torch.float32
    assert seq.shape == (2, 5, TINY["hidden_size"]) and pooled.shape == (2, TINY["hidden_size"])
    if dtype:
        close_bf16(seq, want_seq, "sequence")
        close_bf16(pooled, want_pool, "pooled")
    else:
        np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_flash_equals_xla_on_the_cpu(rng, dtype):
    _, _, dense = model_pair(dtype)
    flash = PV.ViT(dataclasses.replace(dense.cfg, attention_impl="flash")).eval()
    flash.load_state_dict(dense.state_dict())
    imgs = t(images(rng))
    with torch.no_grad():
        for a, b in zip(dense(imgs), flash(imgs)):
            assert torch.equal(a, b)


def test_auto_keeps_the_dense_route_at_224():
    """Under "auto", ViT's 197 tokens pad to 256 < 1024: dense, as JAX."""
    from vltk_tpu_torch.models.lxmert import _impl_wants_flash

    cfg = PV.ViTConfig(attention_impl="auto")
    assert not _impl_wants_flash(cfg, 1 + cfg.num_patches)
    assert _impl_wants_flash(dataclasses.replace(cfg, attention_impl="flash"), 1 + cfg.num_patches)


def test_plain_flash_at_the_vit_case_matches_pallas_interpret(rng):
    """s = 197 with ``mask=None``: an all-ones mask is synthesised before
    the pad to 256, so real queries never see the zero tail."""
    import jax.experimental.pallas.tpu as pltpu

    q, k, v = (rng.normal(size=(2, 197, 2, 64)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = JX._flash_self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 64)
    got = flash_self_attention(t(q), t(k), t(v), None, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def int8_close(got, want, err_msg=""):
    got, want = f32(got), np.asarray(want, np.float32)
    off = ~np.isclose(got, want, rtol=TOL, atol=TOL)
    assert off.mean() <= 1 / 3, f"{err_msg}: {int(off.sum())} of {off.size} elements off"
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP * float(np.abs(want).max()), err_msg=err_msg)


def test_int8_matches_flax_with_the_same_scales(rng):
    """The six projection sites a layer on int8 (the patch conv and the
    pooler float): calibration scales against flax's, then the static
    route with flax's scales carried by ``jax_quant_to_torch``."""
    jmodel, params, port = model_pair(int8=True, seed=4)
    imgs = images(rng, 3)
    quant = calibrate_int8_variables(lambda v, *b, mutable: jit_apply(jmodel, v, *b, mutable=mutable), params,
                                     [(imgs,)])
    scales = jax_quant_to_torch(quant, port)
    assert len(scales) == 6 * TINY["num_layers"]
    mine = calibrate_int8_scales(port, [(t(imgs),)])
    assert set(mine) == set(scales)
    for name in scales:
        np.testing.assert_allclose(float(mine[name]), float(scales[name]), rtol=1e-6, err_msg=name)
    load_int8_scales(port, scales)
    want_seq, want_pool = jit_apply(jmodel, {"params": params, "quant": quant}, imgs)
    with torch.no_grad():
        seq, pooled = port(t(imgs))
    int8_close(seq, want_seq, "sequence")
    int8_close(pooled, want_pool, "pooled")
    assert port.state_dict().keys() == PV.ViT(port.cfg).state_dict().keys()


def test_converter_gives_the_hf_names(rng):
    jmodel, params, port = model_pair()
    sd = jax_vit_to_torch(params)
    assert set(sd) == set(port.state_dict())
    flat = tu.flatten_dict(params, sep="/")
    np.testing.assert_array_equal(sd["embeddings.patch_embeddings.projection.weight"].numpy(),
                                  np.transpose(flat["patch_embed/kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["encoder.layer.1.attention.attention.key.weight"].numpy(),
                                  flat["layer_1_att/key/kernel"].T)
    np.testing.assert_array_equal(sd["encoder.layer.0.output.dense.bias"].numpy(), flat["layer_0_mlp/mlp_out/bias"])
    np.testing.assert_array_equal(sd["embeddings.cls_token"].numpy(), flat["cls_token"])


def test_hf_vit_state_dict_loads_strictly_and_matches_hf(rng, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")  # HF's models here are torch ones: importing TensorFlow is ~10 s
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ViTConfig(
        hidden_size=TINY["hidden_size"], num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"], intermediate_size=TINY["intermediate_size"],
        image_size=TINY["image_size"], patch_size=TINY["patch_size"], hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
    )
    torch.manual_seed(0)
    hf = transformers.ViTModel(hf_cfg).eval()
    port = PV.ViT(PV.ViTConfig(**TINY)).eval()
    port.load_state_dict(hf.state_dict(), strict=True)
    imgs = images(rng)
    with torch.no_grad():
        out = hf(pixel_values=t(imgs).permute(0, 3, 1, 2))
        seq, pooled = port(t(imgs))
    np.testing.assert_allclose(seq.numpy(), out.last_hidden_state.numpy(), atol=3e-5)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=3e-5)


def test_seeded_init_is_deterministic_and_finite(rng):
    a = PV.init_vit_weights(PV.ViT(PV.ViTConfig(**TINY)), seed=3)
    b = PV.init_vit_weights(PV.ViT(PV.ViTConfig(**TINY)), seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    with torch.no_grad():
        seq, pooled = a.eval()(t(images(rng)))
    assert bool(torch.isfinite(seq).all() and torch.isfinite(pooled).all())
