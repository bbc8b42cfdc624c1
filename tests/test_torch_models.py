"""Modules and the extraction slice of the PyTorch port held against the
JAX package on the CPU, float32.

Weights are the JAX package's flax ``init`` params with randomised frozen
batch-norm statistics, carried across with ``jax_frcnn_to_torch``. Each
stage is fed the same inputs in both packages, so that a near-tie in a
top-k cannot hide a fault in a later stage; each test states its
tolerance. Plus the guards of the port: the converter round trip, the
config field set, imports that never reach JAX, no silent CPU fallback.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu.models import FRCNN as JFRCNN
from vltk_tpu.models import FRCNNConfig as JConfig
from vltk_tpu.models import torch_frcnn_to_jax
from vltk_tpu.models.backbone import BasicStem, BottleneckBlock, Res5Head, ResNetC4
from vltk_tpu.models.roi_heads import Res5RoIHeads
from vltk_tpu.models.rpn import RPNHead, propose as jx_propose
from vltk_tpu.ops.image_ops import preprocess_batch as jx_preprocess

from vltk_tpu_torch.adapters import frcnn as pt_adapter
from vltk_tpu_torch.models import FRCNN, FRCNNConfig, jax_frcnn_to_torch
from vltk_tpu_torch.models.rpn import propose as pt_propose

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the TINY geometry of tests/test_models.py
TINY_KW = dict(
    depth=50,
    stem_out_channels=8,
    res2_out_channels=16,
    width_per_group=4,
    rpn_hidden_channels=16,
    anchor_sizes=(16, 32),
    aspect_ratios=(0.5, 1.0, 2.0),
    pre_nms_topk=64,
    post_nms_topk=16,
    num_classes=7,
    num_attrs=5,
    pooler_resolution=7,
    min_detections=4,
    max_detections=4,
)
RTOL = ATOL = 1e-4  # float32 convs summed in another order than XLA's


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg,
    )


@pytest.fixture(autouse=True)
def no_tf32():
    """Full float32 convs and matmuls wherever a card would run them."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope="module")
def tiny():
    """(jax params, port FRCNN, inputs) at TINY, f32, shared weights."""
    rng = np.random.default_rng(0)
    jcfg = JConfig(**TINY_KW)
    images = rng.uniform(-50, 50, (2, 64, 64, 3)).astype(np.float32)
    sizes = np.array([[64.0, 64.0], [48.0, 56.0]], np.float32)
    params = jax.jit(JFRCNN(cfg=jcfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(sizes)
    )["params"]
    flat = tu.flatten_dict(params, sep="/")
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if "/norm/" in k:
            if leaf in ("scale", "var"):
                flat[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
            else:
                flat[k] = jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
    params = tu.unflatten_dict(flat, sep="/")
    model = FRCNN(FRCNNConfig(**TINY_KW)).eval()
    model.load_state_dict(jax_frcnn_to_torch(params), strict=True)
    return params, model, images, sizes


class TestBackbone:
    def test_stem(self, tiny):
        params, model, images, _ = tiny
        want = BasicStem(out_channels=8).apply(
            {"params": params["backbone"]["stem"]}, jnp.asarray(images)
        )
        with torch.no_grad():
            close(model.backbone.stem(t(images)), want)

    @pytest.mark.parametrize("stage,block,stride", [("res2", "0", 1), ("res3", "0", 2), ("res4", "1", 1)])
    def test_bottleneck_block(self, tiny, stage, block, stride):
        params, model, _, _ = tiny
        cin = {"res2": 8, "res3": 16, "res4": 64}[stage]
        cout = {"res2": 16, "res3": 32, "res4": 64}[stage]
        x = np.random.default_rng(1).normal(size=(2, 12, 10, cin)).astype(np.float32)
        want = BottleneckBlock(
            out_channels=cout, bottleneck_channels=cout // 4, stride=stride
        ).apply({"params": params["backbone"][stage][block]}, jnp.asarray(x))
        with torch.no_grad():
            close(getattr(model.backbone, stage)[int(block)](t(x)), want)

    def test_resnet_c4_and_res5_head(self, tiny):
        params, model, images, _ = tiny
        want = ResNetC4(
            depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4
        ).apply({"params": params["backbone"]}, jnp.asarray(images))
        x = np.random.default_rng(2).normal(size=(5, 7, 7, 64)).astype(np.float32)
        want5 = Res5Head(res2_out_channels=16, width_per_group=4).apply(
            {"params": params["roi_heads"]["res5"]}, jnp.asarray(x)
        )
        with torch.no_grad():
            close(model.backbone(t(images)), want)
            close(model.roi_heads.res5(t(x)), want5)


@pytest.fixture(scope="module")
def jax_feats(tiny):
    params, _, images, _ = tiny
    feats = ResNetC4(
        depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4
    ).apply({"params": params["backbone"]}, jnp.asarray(images))
    return np.asarray(feats)


class TestRPN:
    def test_rpn_head(self, tiny, jax_feats):
        params, model, _, _ = tiny
        logits, deltas = RPNHead(num_anchors=6, hidden_channels=16).apply(
            {"params": params["rpn_head"]}, jnp.asarray(jax_feats)
        )
        with torch.no_grad():
            got_l, got_d = model.proposal_generator.rpn_head(t(jax_feats))
        close(got_l, logits)
        close(got_d, deltas)

    @pytest.mark.parametrize("bands", [False, True])
    def test_propose_on_jax_rpn_outputs(self, tiny, jax_feats, bands):
        """Fed JAX's own RPN outputs: the exact keep-set (valid mask and the
        boxes and scores it selects)."""
        params, model, _, sizes = tiny
        logits, deltas = RPNHead(num_anchors=6, hidden_channels=16).apply(
            {"params": params["rpn_head"]}, jnp.asarray(jax_feats)
        )
        anchors = model.proposal_generator.anchors(jax_feats.shape[1:3], "cpu")
        kw = dict(nms_thresh=0.7, pre_nms_topk=64, post_nms_topk=16)
        extra_j, extra_t = {}, {}
        if bands:
            ign = np.array([[[20.0, 30.0]], [[5.0, 9.0]]], np.float32)
            scl = np.array([[1.0, 1.5], [2.0, 0.8]], np.float32)
            extra_j = dict(ignorey=jnp.asarray(ign), scales_yx=jnp.asarray(scl))
            extra_t = dict(ignorey=t(ign), scales_yx=t(scl))
        want = jx_propose(
            logits, deltas, jnp.asarray(anchors.numpy()), jnp.asarray(sizes), **kw, **extra_j
        )
        got = pt_propose(t(logits), t(deltas), anchors, t(sizes), **kw, **extra_t)
        for g, w, name in zip(got, want, ("boxes", "scores", "valid")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


class TestRoIHeads:
    def test_res5_roi_heads_chunked_and_not(self, tiny, jax_feats):
        """roi_chunk on (a chunk count that leaves a short last chunk) and
        off: within float32 rounding of each other and within 1e-4 of JAX."""
        params, model, _, _ = tiny
        rng = np.random.default_rng(3)
        xy = rng.uniform(0, 50, (2, 16, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (2, 16, 2))], -1).astype(np.float32)
        heads = dict(
            num_classes=7, num_attrs=5, res2_out_channels=16, width_per_group=4,
            pooler_resolution=7,
        )
        want = Res5RoIHeads(**heads).apply(
            {"params": params["roi_heads"]}, jnp.asarray(jax_feats), jnp.asarray(boxes)
        )
        rh = model.roi_heads
        outs = []
        with torch.no_grad():
            for chunk in (None, 6):
                rh.roi_chunk = chunk
                outs.append(rh(t(jax_feats), t(boxes)))
        rh.roi_chunk = model.cfg.roi_chunk
        for i, name in enumerate(("obj_logits", "attr_logits", "deltas", "pooled")):
            close(outs[1][i], outs[0][i].numpy(), name, rtol=1e-6, atol=1e-6)
            close(outs[0][i], want[i], name)


def jax_outputs(params, images, sizes, scales, return_raw=False):
    model = JFRCNN(cfg=JConfig(**TINY_KW))
    fn = jax.jit(
        lambda p, im, s, sc: model.apply({"params": p}, im, s, scales_yx=sc, return_raw=return_raw)
    )
    return fn(params, jnp.asarray(images), jnp.asarray(sizes), jnp.asarray(scales))


EXACT_KEYS = ("obj_ids", "attr_ids", "preds_per_image", "mask")


class TestFRCNN:
    def test_frcnn_key_by_key_with_raw(self, tiny):
        """f32 end to end: floats rtol 1e-4, ids, masks and counts exact,
        and the return_raw tensors the same way."""
        params, model, images, sizes = tiny
        scales = np.array([[2.0, 0.5], [1.25, 1.25]], np.float32)
        want = jax_outputs(params, images, sizes, scales, return_raw=True)
        with torch.no_grad():
            got = model(t(images), t(sizes), scales_yx=t(scales), return_raw=True)
        assert set(got) == set(want)
        assert int(got["preds_per_image"].sum()) > 0
        for key in want:
            if key == "raw":
                continue
            if key in EXACT_KEYS:
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
            else:
                close(got[key], want[key], key)
        assert set(got["raw"]) == set(want["raw"])
        for key, w in want["raw"].items():
            g = got["raw"][key]
            if key == "prop_valid":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=key)
            else:
                close(g, w, key)

    def test_adapter_step_matches_jax_step(self, tiny, tmp_path):
        """setup(device="cpu", checkpoint=...) packed output against a JAX
        step built like the reference adapter's: features and boxes
        rtol 1e-4, ids exact."""
        params, model, _, _ = tiny
        ckpt = str(tmp_path / "frcnn.pt")
        torch.save(model.state_dict(), ckpt)
        geom = dict(resized_canvas=(64, 64), short=48.0, maximum=64.0)
        bundle, info = pt_adapter.setup(checkpoint=ckpt, device="cpu", **geom, **TINY_KW)
        assert info["visual_dim"] == 128 and bundle["device"].type == "cpu"
        rng = np.random.default_rng(4)
        raw = rng.integers(0, 256, (2, 56, 64, 3)).astype(np.uint8)
        raw_sizes = np.array([[48, 64], [40, 52]], np.int32)

        jmodel = JFRCNN(cfg=JConfig(**TINY_KW))

        @jax.jit
        def jstep(p, raw_images, rs):
            pre = jx_preprocess(raw_images, rs, canvas_hw=(64, 64), short=48.0, maximum=64.0)
            out = jmodel.apply({"params": p}, pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])
            return jnp.concatenate(
                [
                    out["roi_features"].astype(jnp.float32),
                    out["boxes"].astype(jnp.float32),
                    out["obj_ids"].astype(jnp.float32)[..., None],
                    out["attr_ids"].astype(jnp.float32)[..., None],
                ],
                axis=-1,
            )

        want = np.asarray(jstep(params, jnp.asarray(raw), jnp.asarray(raw_sizes)))
        got = bundle["step"](t(raw), t(raw_sizes)).numpy()
        assert got.shape == want.shape == (2, 4, 128 + 6)
        close(got[..., :-2], want[..., :-2], "features+boxes")
        np.testing.assert_array_equal(got[..., -2:], want[..., -2:])


class TestGuards:
    def test_converter_round_trip(self, tiny):
        params = tiny[0]
        back = torch_frcnn_to_jax(jax_frcnn_to_torch(params))
        a = tu.flatten_dict(params, sep="/")
        b = tu.flatten_dict(back, sep="/")
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)

    def test_config_field_set_matches_jax(self):
        port = {f.name for f in dataclasses.fields(FRCNNConfig)}
        ref = {f.name for f in dataclasses.fields(JConfig)}
        assert port == ref
        assert set(FRCNNConfig.PRESETS) == set(JConfig.PRESETS)
        for name in ("parity_300", "fast", "props_150"):
            assert dataclasses.asdict(FRCNNConfig.named_preset(name)) == dataclasses.asdict(
                JConfig.named_preset(name)
            )

    def test_port_imports_neither_jax_nor_vltk_tpu(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import vltk_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(vltk_tpu_torch.__path__, 'vltk_tpu_torch.')]\n"
            "assert len(mods) >= 49, mods\n"
            "assert {'vltk_tpu_torch.parallel', 'vltk_tpu_torch.parallel.mesh', 'vltk_tpu_torch.parallel.sharding',"
            " 'vltk_tpu_torch.parallel.collectives', 'vltk_tpu_torch.parallel.ring',"
            " 'vltk_tpu_torch.parallel.pipeline'} <= set(mods), mods\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax') or m.startswith(('jax.', 'flax.'))"
            " or m == 'vltk_tpu' or m.startswith('vltk_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(mods))\n"
        )
        res = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
        )
        assert res.returncode == 0, res.stderr
        src = open(os.path.join(REPO, "chip_smoke.py")).read()
        assert "import jax" not in src and "vltk_tpu." not in src.replace("vltk_tpu_torch", "")

    def test_entry_points_raise_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt_adapter.setup()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt_adapter.setup(preset="int8_300")  # the int8 presets too: no CPU fallback
        with pytest.raises(ValueError, match="unknown preset"):
            pt_adapter.setup(device="cpu", preset="int4_300")
