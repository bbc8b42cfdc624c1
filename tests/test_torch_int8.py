"""The int8 serving presets of the PyTorch port held against the JAX package
on the CPU: the quantize recipe and the int8 products (``ops/int8.py``),
``ConvNorm(int8=True)`` / ``Int8Linear`` against flax's ``Int8Conv`` /
``Int8Dense`` in their three modes, calibration, the tiny int8 FRCNN of
tests/test_torch_vqa.py, LXMERT and LayoutLM, the three predictors, every
extraction preset, the space-to-depth stem and the int8 probe's entry
point.

Weights are seeded with numpy (or the port's seeded initialisers, carried
into flax with the JAX package's converters); flax parameter shapes come
from ``jax.eval_shape``. The JAX FRCNN's calibration runs through a jitted
twin of ``vltk_tpu.models.calibrate_int8`` (its body under ``jax.jit``:
the unchunked int8 model applied with the ``"quant"`` collection mutable):
the function itself runs op by op, ~23 s for the tiny detector.
Tolerances:

* the int8 layers, the products and the weight quantization: bitwise (the
  products are exact integer sums; quantize and rescale are the same float32
  operations in the same order);
* recorded scales: 1e-6 relative (each is a max over float32 activations
  that the two packages compute with convolutions and sums in another
  order);
* models in float32: their float activations differ from JAX's by ~1e-7
  relative (convolutions, LayerNorm and sums in another order), and now
  and then that moves an activation across a rounding boundary of its int8
  grid: one product term changes by one quantization step, ~1/127 of the
  activation's range, and the layers after it carry the change. So a model
  output holds to 1e-4 except where such a flip reached it: at most a
  third of the elements (measured: 3 of 9 LXMERT logits, one row; 4 of 256
  RoI-head logits), and those within 1e-2 of the output's largest
  magnitude (measured 1.5e-3). A wiring fault (a site left float, a wrong
  or unshared scale) moves every element by the quantization noise itself
  and fails the share. Ids, masks, answers and labels are equal;
* predictors: VQA scores 1e-4, boxes within 1e-4 of the image's longer
  side, label scores and span scores 1e-4 (no flip reached them).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import vltk_tpu.models as JM
from vltk_tpu.models import FRCNN as JFRCNN
from vltk_tpu.models import FRCNNConfig as JFRCNNConfig
from vltk_tpu.models import layers as JLY
from vltk_tpu.models import layoutlm as JL
from vltk_tpu.models import lxmert as JX

from vltk_tpu_torch.models import FRCNN, FRCNNConfig, init_weights, jax_layoutlm_to_torch, jax_quant_to_torch
from vltk_tpu_torch.models import layers as PL
from vltk_tpu_torch.models import lxmert as PX
from vltk_tpu_torch.models.convert import jax_lxmert_to_torch
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification
from vltk_tpu_torch.ops import int8 as q8

from test_torch_vqa import (  # noqa: F401  (tiny_vocab is a fixture)
    ANSWERS, GEOM, QUESTIONS, S, TINY_FRCNN, TINY_LXMERT, _images, lively, lxmert_inputs, port_cfg, port_kwargs,
    tiny_vocab,
)

TOL = 1e-4
FLIP = 1e-2  # one int8 step carried through the layers after it, of the output's scale


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def rel_close(got, want, rtol=1e-6):
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@functools.lru_cache(maxsize=None)
def _calibrating_apply(cfg):
    model = JFRCNN(dataclasses.replace(cfg, int8=True, roi_chunk=None))
    return jax.jit(lambda v, img, sz, sc: model.apply(v, img, sz, scales_yx=sc, mutable=["quant"])[1]["quant"])


def int8_close(got, want, err_msg=""):
    """Within ``TOL`` but where an int8 rounding flip reached the output: at
    most a third of the elements, those within ``FLIP`` of the output's
    largest magnitude."""
    got, want = f32(got), np.asarray(want, np.float32)
    off = ~np.isclose(got, want, rtol=TOL, atol=TOL)
    assert off.mean() <= 1 / 3, f"{err_msg}: {int(off.sum())} of {off.size} elements off"
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP * float(np.abs(want).max()), err_msg=err_msg)


def jax_calibrate(cfg, params, batches):
    """``vltk_tpu.models.calibrate_int8``'s body under ``jax.jit``."""
    apply = _calibrating_apply(cfg)
    quant: dict = {}
    for images, sizes, *rest in batches:
        variables = {"params": params, **({"quant": quant} if quant else {})}
        quant = apply(variables, images, sizes, rest[0] if rest else None)
    return quant


def jitted_calibration(model, params, batches):
    """``vltk_tpu.models.layers.calibrate_int8_variables`` with the model's
    calibrating apply under ``jax.jit``; then the static apply, jitted."""
    calibrating = jax.jit(lambda v, *b: model.apply(v, *b, mutable=["quant"]))
    quant = JLY.calibrate_int8_variables(lambda v, *b, mutable, **kw: calibrating(v, *b), params, batches)
    return quant, jax.jit(lambda v, *b: model.apply(v, *b))


# ------------------------------------------------------------------- ops


class TestOps:
    @pytest.mark.parametrize("m,k,n", [(5, 16, 8), (40, 4608, 24), (3, 7, 5)])
    def test_exact_route_equals_the_int64_product(self, m, k, n):
        rng = np.random.default_rng(m)
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
        before = q8.int8_matmul.card_launches
        got = q8.int8_matmul(t(a), t(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(q8.int8_matmul(t(a), t(b.T).t()).numpy(), want)  # column-major b
        assert q8.int8_matmul.card_launches == before  # the CPU takes the exact route

    @pytest.mark.parametrize("geom", [
        (3, 1, 1, 1, 1), (1, 2, 0, 1, 1), (3, 1, 2, 2, 1), (1, 1, 0, 1, 1), (3, 2, 1, 1, 2), (5, 1, 0, 2, 1),
    ], ids=["3x3_pad1", "1x1_stride2", "3x3_dil2", "1x1", "3x3_stride2_groups2", "5x5_dil2"])
    def test_conv2d_matches_xla_int32(self, geom):
        k, s, p, d, g = geom
        rng = np.random.default_rng(k * 7 + s)
        x = rng.integers(-127, 128, (2, 13, 11, 8)).astype(np.int8)
        w = rng.integers(-127, 128, (k, k, 8 // g, 6)).astype(np.int8)
        want = jax.lax.conv_general_dilated(
            x, w, window_strides=(s, s), padding=[(p, p), (p, p)], rhs_dilation=(d, d),
            feature_group_count=g, dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
        )
        got = q8.int8_conv2d(t(x), t(w), s, p, d, g)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        exact = q8.int8_conv2d(t(x), t(w), s, p, d, g, matmul=q8.int8_matmul_exact)
        assert torch.equal(exact, got)

    def test_quantize_rounds_half_to_even_and_zeroes_nan(self):
        x = np.array([np.nan, 200.0, -200.0, 2.5, 3.5, -2.5], np.float32)
        x_q, s_x = q8.quantize_per_tensor(t(x), torch.tensor(127.0))
        want = jnp.clip(jnp.round(jnp.asarray(x) / 1.0), -127, 127).astype(jnp.int8)
        assert float(s_x) == 1.0 and x_q.dtype == torch.int8
        np.testing.assert_array_equal(x_q.numpy(), [0, 127, -127, 2, 4, -2])
        np.testing.assert_array_equal(x_q.numpy(), np.asarray(want))
        # a NaN anywhere makes the dynamic scale NaN, as jnp.max does
        assert torch.isnan(q8.activation_max(t(x)))
        # values near the half steps of s_x = 1/127, where a multiply by the
        # rounded reciprocal lands a step away from JAX's division
        s = np.float32(1.0) / np.float32(127.0)
        x = (np.arange(-253, 254, 2, dtype=np.float32) / np.float32(2)) * s
        x_q, s_x = q8.quantize_per_tensor(t(x), torch.tensor(1.0))
        want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / s), -127, 127).astype(jnp.int8))
        np.testing.assert_array_equal(x_q.numpy(), want)
        assert (np.round(x * (np.float32(1.0) / s)) != want).any()

    def test_operand_guards(self):
        a = torch.zeros((4, 8), dtype=torch.int8)
        with pytest.raises(TypeError, match="int8 operands"):
            q8.int8_matmul(a.float(), a.t())
        with pytest.raises(ValueError, match="do not multiply"):
            q8.int8_matmul(a, a)
        with pytest.raises(ValueError, match="groups"):
            q8.int8_conv2d(torch.zeros((1, 4, 4, 6), dtype=torch.int8), torch.zeros((1, 1, 4, 4), dtype=torch.int8))


# ---------------------------------------------------------------- layers

CONV_GEOMS = {"3x3_pad1": (3, 1, 1, 1), "1x1_stride2": (1, 2, 0, 1), "3x3_dil2": (3, 1, 2, 2)}
DTYPES = {"float32": (jnp.float32, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def layer_inputs(jdt, shape, seed=0):
    """Batch ``a`` (calibration) and batch ``b`` (served), ``a`` twice as
    wide, so the static and dynamic scales differ."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=shape).astype(np.float32)
    a = 2.0 * rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, jdt), jnp.asarray(b, jdt)


def torch_of(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)


def run_modes(jmod, params, port, to_port, from_port, xa, xb, mode):
    """(port output, JAX output, port act_max, JAX act_max) on batch ``b`` in
    ``mode``; static and calibrating start from the scale recorded on
    ``a``."""
    if mode == "dynamic":
        PL.load_int8_scales(port, {})
        return from_port(port(to_port(xb))), jmod.apply({"params": params}, xb), None, None
    quant_a = jmod.apply({"params": params}, xa, mutable=["quant"])[1]["quant"]
    PL.load_int8_scales(port, {"": torch.tensor(float(quant_a["act_max"]))})
    if mode == "static":
        return from_port(port(to_port(xb))), jmod.apply({"params": params, "quant": quant_a}, xb), None, None
    want, mutated = jmod.apply({"params": params, "quant": quant_a}, xb, mutable=["quant"])
    with PL.calibrating(port):
        got = from_port(port(to_port(xb)))
    return got, want, port.act_max, mutated["quant"]["act_max"]


class TestLayers:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("mode", ["dynamic", "static", "calibrating"])
    @pytest.mark.parametrize("geom", CONV_GEOMS)
    def test_int8_conv_matches_flax_bitwise(self, geom, mode, dtype):
        k, s, p, d = CONV_GEOMS[geom]
        jdt, pdt = DTYPES[dtype]
        xa, xb = layer_inputs(jdt, (2, 9, 11, 16))
        jmod = JLY.Int8Conv(features=8, kernel_size=(k, k), strides=(s, s), padding=(p, p), dilation=(d, d),
                            dtype=None if pdt is None else jdt)
        kernel = np.random.default_rng(1).normal(0, 0.25, (k, k, 16, 8)).astype(np.float32)
        port = PL.ConvNorm(16, 8, k, stride=s, padding=p, dilation=d, norm=False, dtype=pdt, int8=True)
        port.weight.data = t(kernel.transpose(3, 2, 0, 1))
        got, want, am, jam = run_modes(
            jmod, {"kernel": jnp.asarray(kernel)}, port, lambda x: torch_of(x).permute(0, 3, 1, 2),
            lambda y: y.permute(0, 2, 3, 1), xa, xb, mode)
        assert got.dtype == (pdt or torch.float32)
        np.testing.assert_array_equal(f32(got), np.asarray(want.astype(jnp.float32)))
        if mode == "calibrating":
            assert float(am) == float(jam)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("mode", ["dynamic", "static", "calibrating"])
    def test_int8_dense_matches_flax_bitwise(self, mode, dtype):
        jdt, pdt = DTYPES[dtype]
        xa, xb = layer_inputs(jdt, (3, 5, 16), seed=2)
        rng = np.random.default_rng(3)
        params = {"kernel": rng.normal(0, 0.25, (16, 24)).astype(np.float32),
                  "bias": rng.normal(0, 0.1, (24,)).astype(np.float32)}
        jmod = JLY.Int8Dense(features=24, dtype=None if pdt is None else jdt)
        port = PL.Int8Linear(16, 24)
        if pdt is not None:  # flax's dtype: the port passes it at the call
            port.forward = lambda x, _f=port.forward: _f(x, pdt)
        port.load_state_dict({"weight": t(params["kernel"].T), "bias": t(params["bias"])})
        got, want, am, jam = run_modes(
            jmod, jax.tree_util.tree_map(jnp.asarray, params), port,
            lambda x: torch_of(x), lambda y: y, xa, xb, mode)
        np.testing.assert_array_equal(f32(got), np.asarray(want.astype(jnp.float32)))
        if mode == "calibrating":
            assert float(am) == float(jam)

    def test_weight_quantization_matches_jax_bitwise(self):
        rng = np.random.default_rng(4)
        w = rng.normal(0, 0.3, (3, 3, 16, 8)).astype(np.float32)
        w[..., 5] = 0.0  # a dead channel: the 1e-8 floor
        s_w = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-8) / 127.0
        w_q = jnp.round(w / s_w).astype(jnp.int8)
        got_q, got_s = q8.quantize_weight_per_channel(t(w.transpose(3, 2, 0, 1)), axis=0)
        np.testing.assert_array_equal(got_q.permute(2, 3, 1, 0).numpy(), np.asarray(w_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_w))
        dense = w.reshape(-1, 8)  # (in, out)
        s_d = jnp.maximum(jnp.max(jnp.abs(dense), axis=0), 1e-8) / 127.0
        got_q, got_s = q8.quantize_weight_per_channel(t(dense.T), axis=0)
        np.testing.assert_array_equal(got_q.t().numpy(), np.asarray(jnp.round(dense / s_d).astype(jnp.int8)))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_d))

    def test_weight_cache_goes_stale_when_the_weight_changes(self):
        rng = np.random.default_rng(5)
        x = t(rng.normal(size=(1, 16, 7, 7)).astype(np.float32))
        w = t(rng.normal(0, 0.2, (8, 16, 3, 3)).astype(np.float32))

        def fresh(weight):
            m = PL.ConvNorm(16, 8, 3, padding=1, norm=False, int8=True)
            m.weight.data = weight.clone()
            return m(x)

        m = PL.ConvNorm(16, 8, 3, padding=1, norm=False, int8=True)
        m.weight.data = w.clone()
        y0 = m(x)
        cache = m._wq_cache
        assert torch.equal(m(x), y0) and m._wq_cache is cache  # reused
        m.load_state_dict({"weight": 2 * w})
        assert torch.equal(m(x), fresh(2 * w)) and not torch.equal(m(x), y0)
        with torch.no_grad():
            m.weight.mul_(0.25)
        assert torch.equal(m(x), fresh(0.5 * w))
        m.to(torch.float64)
        assert m._wq_cache is None
        assert torch.equal(m(x), fresh((0.5 * w).double()))

    def test_modes_and_scale_guards(self):
        m = PL.ConvNorm(4, 4, 1, norm=False, int8=True)
        assert PL.int8_layers(m) == {"": m} and PL.int8_scales(m) == {}
        with pytest.raises(KeyError, match="unexpected"):
            PL.load_int8_scales(m, {"": torch.tensor(1.0), "other": torch.tensor(1.0)})
        with pytest.raises(ValueError, match="no int8 layers"):
            PL.calibrate_int8_scales(PL.ConvNorm(4, 4, 1), [])
        x = torch.ones((1, 4, 2, 2))
        scales = PL.calibrate_int8_scales(m, [(x,), (3 * x,), (2 * x,)])
        assert float(scales[""]) == 3.0 and not m.calibrating  # the running max, mode restored
        assert "act_max" not in m.state_dict()


# --------------------------------------------------------- the s2d stem


class TestSpaceToDepthStem:
    @pytest.mark.parametrize("hw", [(32, 48), (33, 48)], ids=["even", "odd_falls_back"])
    def test_matches_jax_and_the_plain_stem(self, hw):
        rng = np.random.default_rng(6)
        x = rng.normal(0, 50, (2, *hw, 3)).astype(np.float32)
        params = {"conv": {"kernel": rng.normal(0, 0.1, (7, 7, 3, 8)).astype(np.float32)},
                  "norm": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                           "bias": rng.normal(0, 0.1, 8).astype(np.float32),
                           "mean": rng.normal(0, 0.1, 8).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}
        want = JLY.StemConvNorm(8, use_s2d=True).apply({"params": params}, jnp.asarray(x))
        sd = {"weight": t(params["conv"]["kernel"].transpose(3, 2, 0, 1)),
              "norm.weight": t(params["norm"]["scale"]), "norm.bias": t(params["norm"]["bias"]),
              "norm.running_mean": t(params["norm"]["mean"]), "norm.running_var": t(params["norm"]["var"])}
        outs = {}
        for s2d in (True, False):
            stem = PL.StemConvNorm(3, 8, use_s2d=s2d)
            stem.load_state_dict(sd)
            outs[s2d] = stem(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach()
        # float32 sums over 147 taps in another order: 1e-5 of the output's scale
        atol = 1e-5 * float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(outs[True].numpy(), np.asarray(want), rtol=1e-5, atol=atol)
        np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(), rtol=1e-5, atol=atol)

    def test_backbone_option(self):
        from vltk_tpu_torch.models.backbone import ResNetC4

        kw = dict(depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4)
        plain = init_weights(ResNetC4(**kw).eval(), seed=1)
        s2d = ResNetC4(**kw, stem_s2d=True).eval()
        s2d.load_state_dict(plain.state_dict())
        assert s2d.stem.conv1.use_s2d and not plain.stem.conv1.use_s2d
        x = t(np.random.default_rng(7).normal(0, 50, (1, 64, 64, 3)).astype(np.float32))
        with torch.no_grad():
            want = plain(x).numpy()
            np.testing.assert_allclose(s2d(x).numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------- FRCNN


@pytest.fixture(scope="module")
def frcnn():
    """The tiny int8 FRCNN: the port's seeded weights and their flax twin,
    two images, JAX's calibration on the first (jitted twin) and its
    static and dynamic outputs on both."""
    from vltk_tpu.models.convert import torch_frcnn_to_jax

    jcfg = JFRCNNConfig(**TINY_FRCNN, int8=True)
    model = init_weights(FRCNN(FRCNNConfig(**TINY_FRCNN, int8=True)).eval(), seed=0)
    params = torch_frcnn_to_jax(model.state_dict())
    rng = np.random.default_rng(8)
    imgs = (rng.normal(size=(2, 64, 64, 3)) * 50).astype(np.float32)
    sizes = np.array([[60.0, 60.0], [48.0, 56.0]], np.float32)
    quant = jax_calibrate(jcfg, params, [(imgs[:1], sizes[:1])])
    apply = jax.jit(lambda v, img, sz: JFRCNN(jcfg).apply(v, img, sz))
    static = apply({"params": params, "quant": quant}, imgs, sizes)
    dynamic = apply({"params": params}, imgs, sizes)
    return jcfg, params, model, imgs, sizes, quant, static, dynamic


def frcnn_close(got, want):
    np.testing.assert_array_equal(got["obj_ids"].numpy(), np.asarray(want["obj_ids"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for key in ("boxes", "obj_probs", "attr_probs", "roi_features"):
        int8_close(got[key], want[key], key)


class TestFRCNN:
    def run(self, model, imgs, sizes):
        with torch.inference_mode():
            return model(t(imgs), t(sizes))

    def run_chunked(self, model, imgs, sizes, roi_chunk):
        heads = model.roi_heads
        saved, heads.roi_chunk = heads.roi_chunk, roi_chunk
        try:
            return self.run(model, imgs, sizes)
        finally:
            heads.roi_chunk = saved

    def test_calibration_scales_equal_jax(self, frcnn):
        jcfg, params, model, imgs, sizes, quant, _, _ = frcnn
        from vltk_tpu_torch.models import calibrate_int8

        got = calibrate_int8(model, [(t(imgs[:1]), t(sizes[:1]))])
        want = jax_quant_to_torch(quant, model)
        assert set(got) == set(want) == set(PL.int8_layers(model))
        assert len(got) == 3 * (3 + 4 + 6) + 3 * 3  # every bottleneck conv of R-50 res2-4 and res5
        assert "backbone.res2.0.shortcut" not in got and "backbone.stem.conv1" not in got
        for name in got:
            rel_close(got[name], want[name])
        assert model.roi_heads.roi_chunk == FRCNNConfig().roi_chunk  # the twin's None was put back

    def test_static_matches_jax(self, frcnn):
        jcfg, params, model, imgs, sizes, quant, static, _ = frcnn
        PL.load_int8_scales(model, jax_quant_to_torch(quant, model))
        frcnn_close(self.run(model, imgs, sizes), static)

    def test_dynamic_matches_jax(self, frcnn):
        jcfg, params, model, imgs, sizes, quant, _, dynamic = frcnn
        PL.load_int8_scales(model, {})
        frcnn_close(self.run(model, imgs, sizes), dynamic)

    def test_chunked_static_equals_unchunked_static(self, frcnn):
        jcfg, params, model, imgs, sizes, quant, static, _ = frcnn
        PL.load_int8_scales(model, jax_quant_to_torch(quant, model))
        chunked = self.run_chunked(model, imgs, sizes, 12)  # 2 x 16 RoIs: chunks of 6 an image, the last padded
        unchunked = self.run_chunked(model, imgs, sizes, None)
        for key in chunked:
            assert torch.equal(chunked[key], unchunked[key]), key

    def test_chunked_dynamic_uses_chunk_local_maxima_as_jax(self, frcnn):
        """Without scales each chunk quantizes by its own maxima, the last
        chunk's pad rows (zero boxes) included, as JAX's scan does: the RoI
        heads on every proposal, 2 images x 16 RoIs in chunks of 6 an
        image."""
        from vltk_tpu.models.roi_heads import Res5RoIHeads as JHeads

        jcfg, params, model, *_ = frcnn
        rng = np.random.default_rng(14)
        feats = np.maximum(rng.normal(0, 1, (2, 8, 8, 64)), 0).astype(np.float32)
        # the cell a zero (pad) box pools is the map's largest and no real
        # box reaches it, so a pad row sets its chunk's maxima
        feats[:, 0, 0, :] = 8.0
        xy = rng.uniform(32, 80, (2, 16, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 28, (2, 16, 2))], -1).astype(np.float32)
        kw = dict(num_classes=7, num_attrs=5, res2_out_channels=16, width_per_group=4, pooler_resolution=7,
                  int8=True)
        want = {c: jax.jit(lambda p, f, b, c=c: JHeads(**kw, roi_chunk=c).apply({"params": p}, f, b))(
            params["roi_heads"], feats, boxes) for c in (12, None)}
        PL.load_int8_scales(model, {})
        heads = model.roi_heads
        for chunk in (12, None):
            saved, heads.roi_chunk = heads.roi_chunk, chunk
            try:
                with torch.inference_mode():
                    got = heads(t(feats), t(boxes))
            finally:
                heads.roi_chunk = saved
            for g, w, name in zip(got, want[chunk], ("obj", "attr", "deltas", "pooled")):
                int8_close(g, w, f"{name} {chunk}")
        # chunk-local maxima do change the pooled features
        assert np.abs(np.asarray(want[12][3]) - np.asarray(want[None][3])).max() > 1e-3


# --------------------------------------------------- LXMERT and LayoutLM


def state_dict_unchanged(make):
    """int8 on and off: the same state dict keys, shapes and dtypes, and a
    strict load of the float model's weights into the int8 one, whose
    scales stay out of the state dict."""
    ref, m8 = make(False), make(True)
    for m in PL.int8_layers(m8).values():
        m.act_max = torch.tensor(1.0)
    sd, sd8 = ref.state_dict(), m8.state_dict()
    assert list(sd) == list(sd8)
    assert all(sd[k].shape == sd8[k].shape and sd[k].dtype == sd8[k].dtype for k in sd)
    m8.load_state_dict(sd, strict=True)
    assert PL.int8_layers(m8) and not PL.int8_layers(ref)


class TestEncoders:
    @pytest.mark.parametrize("model", ["frcnn", "lxmert", "layoutlm"])
    def test_state_dict_is_unchanged_by_int8(self, model):
        make = {
            "frcnn": lambda q: FRCNN(FRCNNConfig(**TINY_FRCNN, int8=q)),
            "lxmert": lambda q: PX.LxmertForVQA(PX.LxmertConfig(**TINY_LXMERT, int8=q)),
            "layoutlm": lambda q: LayoutLMForTokenClassification(LayoutLMConfig(**TINY_LAYOUTLM, int8=q)),
        }[model]
        state_dict_unchanged(make)

    def test_lxmert_int8_sites(self):
        model = PX.LxmertForVQA(PX.LxmertConfig(**TINY_LXMERT, int8=True))
        names = set(PL.int8_layers(model))
        assert "lxmert.encoder.layer.0.attention.self.query" in names
        assert "lxmert.encoder.x_layers.0.visual_attention.att.value" in names
        assert "lxmert.encoder.x_layers.0.lang_output.dense" in names
        assert not any(s in n for n in names for s in ("visn_fc", "pooler", "answer_head", "embeddings"))
        layers = TINY_LXMERT["l_layers"] + TINY_LXMERT["r_layers"]
        # 6 sites a single-stream layer; a cross layer has three attention
        # blocks (q, k, v, output) and two feed-forwards
        assert len(names) == 6 * layers + TINY_LXMERT["x_layers"] * (3 * 4 + 2 * 2)

    def test_lxmert_calibrated_matches_flax(self):
        jcfg = JX.LxmertConfig(**TINY_LXMERT, int8=True)
        rng = np.random.default_rng(9)
        cal, served = lxmert_inputs(rng), lxmert_inputs(rng)
        shapes = jax.eval_shape(lambda: JX.LxmertForVQA(jcfg).init(jax.random.PRNGKey(0), *cal[:1], cal[2], cal[3]))
        params = lively(shapes["params"], rng)
        order = (0, 2, 3, 1, 4)  # ids, features, boxes, language mask, visual mask
        quant, apply = jitted_calibration(JX.LxmertForVQA(jcfg), params, [tuple(cal[i] for i in order)])
        want = apply({"params": params, "quant": quant}, *(served[i] for i in order))
        port = PX.LxmertForVQA(port_cfg(jcfg)).eval()
        port.load_state_dict(jax_lxmert_to_torch(params), strict=True)
        scales = PL.calibrate_int8_scales(port, [tuple(t(cal[i]) for i in order)])
        ref = jax_quant_to_torch(quant, port)
        assert set(scales) == set(ref) == set(PL.int8_layers(port))
        for name in scales:
            rel_close(scales[name], ref[name])
        with torch.inference_mode():
            got = port(*(t(served[i]) for i in order))
        int8_close(got, want, "logits")

    def test_layoutlm_calibrated_matches_flax(self):
        jcfg = JL.LayoutLMConfig(**TINY_LAYOUTLM, int8=True)
        rng = np.random.default_rng(10)
        cal, served = doc_inputs(rng), doc_inputs(rng)
        shapes = jax.eval_shape(lambda: JL.LayoutLMForTokenClassification(jcfg).init(
            jax.random.PRNGKey(0), cal[0], cal[1]))
        params = lively(shapes["params"], rng)
        quant, apply = jitted_calibration(JL.LayoutLMForTokenClassification(jcfg), params, [cal])
        want = apply({"params": params, "quant": quant}, *served)
        port = LayoutLMForTokenClassification(LayoutLMConfig(**dataclasses.asdict(jcfg))).eval()
        port.load_state_dict(jax_layoutlm_to_torch(params), strict=True)
        scales = PL.calibrate_int8_scales(port, [tuple(t(a) for a in cal)])
        ref = jax_quant_to_torch(quant, port)
        assert set(scales) == set(ref) and len(scales) == 6 * TINY_LAYOUTLM["l_layers"]
        for name in scales:
            rel_close(scales[name], ref[name])
        with torch.inference_mode():
            got = port(*(t(a) for a in served))
        mask = served[2] > 0
        int8_close(f32(got)[mask], np.asarray(want)[mask], "logits")

    def test_quant_converter_rejects_unknown_paths(self):
        model = PX.LxmertForVQA(PX.LxmertConfig(**TINY_LXMERT, int8=True))
        with pytest.raises(KeyError, match="no int8 layer"):
            jax_quant_to_torch({"lxmert": {"visn_fc": {"visn_fc": {"act_max": 1.0}}}}, model)
        with pytest.raises(KeyError, match="quant leaf"):
            jax_quant_to_torch({"lxmert": {"layer_0": {"att": {"query": {"kernel": 1.0}}}}}, model)


TINY_LAYOUTLM = dict(vocab_size=64, hidden_size=24, num_heads=2, intermediate_size=48, l_layers=2,
                     max_position_embeddings=32)
DOC_S = 16


def doc_inputs(rng, n=2):
    ids = rng.integers(0, 64, (n, DOC_S)).astype(np.int32)
    boxes = np.sort(rng.integers(0, 1000, (n, DOC_S, 2, 2)), axis=2).reshape(n, DOC_S, 4).astype(np.int32)
    mask = np.ones((n, DOC_S), np.float32)
    mask[1, 11:] = 0.0
    return ids, boxes, mask


# ------------------------------------------------------------ predictors


@pytest.fixture(scope="module")
def vqa(tiny_vocab, tmp_path_factory):
    """The JAX VQAPredictor and the port's, both with an int8 FRCNN
    ("frcnn") and both with an int8 FRCNN and LXMERT ("both"), batch 2:
    each answers one image (a bucket with a pad row, which the calibration
    slice holds), then the three pairs of test_torch_vqa.py."""
    from vltk_tpu.data.tokenizer import Tokenizer as JTok
    from vltk_tpu.models.convert import torch_frcnn_to_jax, torch_lxmert_to_jax
    from vltk_tpu.predict import VQAPredictor as JVQA

    from vltk_tpu_torch.models.frcnn import FRCNN as PF
    from vltk_tpu_torch.predict import VQAPredictor

    jl = JX.LxmertConfig(**TINY_LXMERT)
    frcnn_sd = init_weights(PF(FRCNNConfig(**TINY_FRCNN)), seed=0).state_dict()
    lxmert_sd = PX.init_weights(PX.LxmertForVQA(port_cfg(jl, num_answers=len(ANSWERS))), seed=1).state_dict()
    images = _images(tmp_path_factory.mktemp("images"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "calibrate_int8", jax_calibrate)
        for name, lcfg in (("frcnn", jl), ("both", dataclasses.replace(jl, int8=True))):
            ref = JVQA(
                ANSWERS, frcnn_config=JFRCNNConfig(**TINY_FRCNN, int8=True), lxmert_config=lcfg,
                frcnn_params=torch_frcnn_to_jax(frcnn_sd), lxmert_params=torch_lxmert_to_jax(lxmert_sd),
                tokenizer=JTok(name="NativeWordPiece", vocab_path=tiny_vocab, max_seq_length=S), **GEOM,
            )
            port = VQAPredictor(ANSWERS, **port_kwargs(ref, tiny_vocab))
            assert port.frcnn_scales is None and port.lxmert_scales is None
            runs = [(p(images[:1], QUESTIONS[:1], top_k=3), p(images, QUESTIONS, top_k=3)) for p in (ref, port)]
            out[name] = ref, port, runs
    return out


def vqa_close(got, want, sides):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["answer"] == w["answer"] and g["num_boxes"] == w["num_boxes"], i
        assert [a for a, _ in g["topk"]] == [a for a, _ in w["topk"]], i
        np.testing.assert_allclose([s for _, s in g["topk"]], [s for _, s in w["topk"]], rtol=0, atol=TOL)
        np.testing.assert_array_equal(g["objects"], np.asarray(w["objects"]))
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=TOL * sides[i], err_msg=str(i))


class TestVQAPredictor:
    @pytest.mark.parametrize("which", ["frcnn", "both"])
    def test_calibrates_once_and_matches_the_jax_predictor(self, vqa, which):
        ref, port, ((want1, want2), (got1, got2)) = vqa[which]
        vqa_close(got1, want1, [64])
        vqa_close(got2, want2, [64, 64, 128])
        fq = jax_quant_to_torch(ref._frcnn_variables["quant"], port.frcnn)
        assert set(fq) == set(port.frcnn_scales) == set(PL.int8_layers(port.frcnn))
        for name, value in port.frcnn_scales.items():
            assert np.isfinite(float(value))
            rel_close(value, fq[name])
        if which == "both":
            lq = jax_quant_to_torch(ref._lxmert_variables["quant"], port.lxmert)
            assert set(lq) == set(port.lxmert_scales) == set(PL.int8_layers(port.lxmert))
            for name, value in port.lxmert_scales.items():
                rel_close(value, lq[name])
        else:
            assert port.lxmert_scales is None and not PL.int8_layers(port.lxmert)
        # the second request reused the first one's scales
        for name, value in PL.int8_scales(port.frcnn).items():
            assert value is port.frcnn_scales[name]

    def test_calibration_runs_once(self, vqa):
        _, port, _ = vqa["both"]
        fs, ls = port.frcnn_scales, port.lxmert_scales
        port.calibrate_int8(None, None, None, None)  # both set: returns at once
        assert port.frcnn_scales is fs and port.lxmert_scales is ls


@pytest.fixture(scope="module")
def docs(tiny_vocab):
    """JAX and port DocTokenClassifier and DocSpanQA on LayoutLM int8 with
    the same lively weights, and both one request, then another."""
    from vltk_tpu.data.tokenizer import Tokenizer as JTok
    from vltk_tpu.predict import DocSpanQA as JSpan
    from vltk_tpu.predict import DocTokenClassifier as JDoc

    from vltk_tpu_torch.data.tokenizer import Tokenizer
    from vltk_tpu_torch.predict import DocSpanQA, DocTokenClassifier

    labels = ["other", "question", "answer", "header"]
    jcfg = JL.LayoutLMConfig(**TINY_LAYOUTLM, int8=True, num_labels=len(labels))
    pcfg = LayoutLMConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    z = (np.zeros((1, DOC_S), np.int32), np.zeros((1, DOC_S, 4), np.int32))
    tok = dict(vocab_path=tiny_vocab)
    page = [{"words": ["what", "is", "the", "cat", "on"], "boxes": [[0, 0, 9, 9], [10, 0, 19, 9], [20, 0, 29, 9],
                                                               [0, 20, 9, 29], [10, 20, 19, 29]]},
            {"words": ["box", "color"], "boxes": [[5, 5, 50, 50], [60, 60, 90, 90]], "size": (200, 100)}]
    out = {}
    params = lively(jax.eval_shape(lambda: JL.LayoutLMForTokenClassification(jcfg).init(
        jax.random.PRNGKey(0), *z))["params"], rng)
    ref = JDoc(labels, params=params, config=jcfg, batch_size=2, max_seq_length=DOC_S,
               tokenizer=JTok(name="NativeWordPiece", max_seq_length=DOC_S, **tok))
    port = DocTokenClassifier(labels, params=jax_layoutlm_to_torch(params), config=pcfg, batch_size=2,
                              max_seq_length=DOC_S, device="cpu", tokenizer=Tokenizer(max_seq_length=DOC_S, **tok))
    out["classifier"] = ref, port, [(p(page[:1]), p(page)) for p in (ref, port)]
    q_len, doc_len = 6, 10
    params = lively(jax.eval_shape(lambda: JL.LayoutLMForSpanQA(jcfg).init(
        jax.random.PRNGKey(0), *z))["params"], rng)
    ref = JSpan(params=params, config=jcfg, batch_size=2, question_len=q_len, doc_len=doc_len,
                tokenizer=JTok(name="NativeWordPiece", max_seq_length=q_len, **tok))
    port = DocSpanQA(params=jax_layoutlm_to_torch(params), config=pcfg, batch_size=2, question_len=q_len,
                     doc_len=doc_len, device="cpu", tokenizer=Tokenizer(max_seq_length=q_len, **tok))
    questions = ["what is the cat", "color"]
    out["span"] = ref, port, [(p(page[:1], questions[:1]), p(page, questions)) for p in (ref, port)]
    return out


class TestDocumentPredictors:
    def test_classifier_calibrates_once_and_matches_the_jax_predictor(self, docs):
        ref, port, ((want1, want2), (got1, got2)) = docs["classifier"]
        for got, want in ((got1, want1), (got2, want2)):
            for g_doc, w_doc in zip(got, want):
                assert [r["label"] for r in g_doc] == [r["label"] for r in w_doc]
                np.testing.assert_allclose([r["score"] for r in g_doc], [r["score"] for r in w_doc], atol=TOL)
        self.check_scales(ref, port)

    def test_span_qa_calibrates_once_and_matches_the_jax_predictor(self, docs):
        ref, port, ((want1, want2), (got1, got2)) = docs["span"]
        for got, want in ((got1, want1), (got2, want2)):
            for g, w in zip(got, want):
                assert (g["answer"], g["start_word"], g["end_word"]) == (w["answer"], w["start_word"], w["end_word"])
                np.testing.assert_allclose(g["score"], w["score"], atol=TOL)
        self.check_scales(ref, port)

    def test_concurrent_first_requests_calibrate_once(self, docs, monkeypatch):
        """Eight threads reach the first bucket together (a 1 us switch
        interval): one calibration, and every thread sees its scales."""
        import sys
        import threading

        from vltk_tpu_torch.predict import DocTokenClassifier, _maybe_calibrate_doc_int8

        _, port, _ = docs["classifier"]
        clf = DocTokenClassifier(["a", "b", "c", "d"], params=port.model.state_dict(), config=port.config,
                                 batch_size=2, max_seq_length=DOC_S, device="cpu", tokenizer=port.tokenizer)
        calls = []
        real = PL.calibrate_int8_scales
        monkeypatch.setattr(PL, "calibrate_int8_scales", lambda *a, **k: calls.append(1) or real(*a, **k))
        ids, boxes, mask = (t(a) for a in doc_inputs(np.random.default_rng(13)))
        seen = []
        threads = [threading.Thread(target=lambda: (_maybe_calibrate_doc_int8(clf, ids, boxes, mask),
                                                    seen.append(clf.int8_scales))) for _ in range(8)]
        saved = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        finally:
            sys.setswitchinterval(saved)
        assert not any(th.is_alive() for th in threads)
        assert len(calls) == 1 and len(seen) == 8 and all(s is seen[0] for s in seen)

    @staticmethod
    def check_scales(ref, port):
        want = jax_quant_to_torch(ref._quant, port.model)
        assert set(port.int8_scales) == set(want) == set(PL.int8_layers(port.model))
        for name, value in port.int8_scales.items():
            rel_close(value, want[name])
            assert PL.int8_scales(port.model)[name] is value  # the second request reused them


# ------------------------------------------------------------- presets


class TestPresets:
    def test_setup_takes_every_preset(self):
        from vltk_tpu_torch.adapters.frcnn import _resolve_config, setup

        tiny = {k: v for k, v in TINY_FRCNN.items() if k not in ("pre_nms_topk", "post_nms_topk")}
        for name in FRCNNConfig.PRESETS:
            cfg = _resolve_config(name, None, {})
            assert cfg == FRCNNConfig.named_preset(name)
            assert cfg.int8 == name.startswith(("int8", "production"))
            bundle, info = setup(preset=name, device="cpu", **tiny)  # the preset's fields, tiny widths
            assert bundle["cfg"] == FRCNNConfig.named_preset(name, **tiny) and info["preset"] == name
            assert bundle["int8_scales"] is None and bool(PL.int8_layers(bundle["model"])) == cfg.int8
        assert _resolve_config("production", None, {}) == _resolve_config("int8_300", None, {})
        assert dataclasses.asdict(FRCNNConfig.named_preset("production")) == dataclasses.asdict(
            JFRCNNConfig.named_preset("production"))
        with pytest.raises(ValueError, match="unknown preset"):
            _resolve_config("int4_300", None, {})

    def test_production_step_calibrates_on_its_first_batch(self):
        from vltk_tpu_torch.adapters.frcnn import setup

        tiny = {k: v for k, v in TINY_FRCNN.items() if k not in ("pre_nms_topk", "post_nms_topk")}
        bundle, info = setup(preset="production", device="cpu", resized_canvas=(64, 64), short=32.0,
                             maximum=64.0, **tiny)
        cfg = bundle["cfg"]
        assert cfg.int8 and (cfg.pre_nms_topk, cfg.post_nms_topk, cfg.dtype) == (6000, 300, "bfloat16")
        assert info["preset"] == "production" and bundle["int8_scales"] is None
        rng = np.random.default_rng(12)
        raw = t(rng.integers(0, 256, (6, 64, 64, 3)).astype(np.uint8))
        sizes = t(np.array([[48, 56]] * 6, np.int32))
        packed = bundle["step"](raw, sizes)
        scales = bundle["int8_scales"]
        assert packed.shape == (6, 4, 16 * 8 + 6) and bool(torch.isfinite(packed).all())
        assert set(scales) == set(PL.int8_layers(bundle["model"]))
        assert all(np.isfinite(float(v)) and float(v) > 0 for v in scales.values())
        # the first 4 images calibrated: the same as calibrating on them alone
        from vltk_tpu_torch.models import calibrate_int8

        pre = bundle["pre_fn"](raw[:4], sizes[:4])
        again = calibrate_int8(bundle["model"], [(pre["img"], pre["sizes"], pre["scales_yx"])])
        assert all(torch.equal(again[k], scales[k]) for k in scales)
        PL.load_int8_scales(bundle["model"], scales)
        assert torch.equal(bundle["step"](raw, sizes), packed) and bundle["int8_scales"] is scales


# --------------------------------------------------------------- probe


def test_probe_int8_entry_point_without_a_card(capsys):
    import json

    from vltk_tpu_torch.tools import probe_int8

    probe_int8.main(["--device", "cpu", "--rois", "2", "--reps", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["rois"] == 2
    assert [c["conv"] for c in out["convs"]] == ["1x1 1024->512", "3x3 d2 512->512", "1x1 512->2048"]
    assert all(c["int8_equals_exact"] for c in out["convs"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            probe_int8.main([])
