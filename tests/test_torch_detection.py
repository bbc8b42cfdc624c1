"""Detection training of the PyTorch port held against the JAX package on
the CPU: the RoIPool backward, RoIAlign, batched NMS, the matcher, the
detection losses and the gradients of a tiny FRCNN, remat, mAP and the
detection experiment.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``vltk_tpu_torch``; each test states its tolerance.
On CPU tensors the port's dispatchers run the kernels' plain versions:
``roi_pool_plain_vjp`` is the plain version of the backward kernel K10,
which ``chip_smoke.py`` and the ``cuda``-marked tests of
``tests/test_torch_kernels.py`` hold against it on the card.

The tiny FRCNN is the JAX detection tests' ``TINY`` (R-50-C4, stem 8,
res2 16, 7 classes, 32 proposals, 7 x 7 pooling). Its weights are flax
params drawn with numpy at the shapes ``jax.eval_shape`` gives (flax's own
``init`` of the detector takes ~20 s), carried to the port with
``convert.jax_frcnn_to_torch``; JAX's sampling priorities
(``jax.random.uniform`` of each image's key) are fed to the port, so both
sample the same anchors and proposals.
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

import flax.traverse_util as tu

from vltk_tpu.models import FRCNN as JFRCNN
from vltk_tpu.models import FRCNNConfig as JConfig
from vltk_tpu.models import fast_rcnn_losses as j_fast_rcnn_losses
from vltk_tpu.models import rpn_losses as j_rpn_losses
from vltk_tpu.models.detection_loss import subsample_mask as j_subsample_mask
from vltk_tpu.ops import batched_nms_fixed as j_batched_nms
from vltk_tpu.ops import match_quality as j_match_quality
from vltk_tpu.ops import roi_align as j_roi_align
from vltk_tpu.ops.pallas_kernels import _roi_pool_xla
from vltk_tpu.train import detection_map as j_detection_map

from vltk_tpu_torch import ops as pt_ops
from vltk_tpu_torch.experiments import Experiments, FRCNNDetectExperiment
from vltk_tpu_torch.models import FRCNN, FRCNNConfig, fast_rcnn_losses, jax_frcnn_to_torch, rpn_losses
from vltk_tpu_torch.models.detection_loss import subsample_mask
from vltk_tpu_torch.ops.roi_pool import roi_pool, roi_pool_plain_vjp
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto, roi_pool_backward_auto
from vltk_tpu_torch.train import detection_map

# tests/test_detection_train.py's TINY
TINY = dict(
    depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_hidden_channels=16,
    anchor_sizes=(16, 32), pre_nms_topk=64, post_nms_topk=32, num_classes=7, num_attrs=5,
    pooler_resolution=7, min_detections=4, max_detections=4,
)


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ---------------------------------------------------- RoIPool and its VJP


def _boxes(rng, b, p, h, w, lo=-60.0, grow=30.0):
    out = np.zeros((b, p, 4), np.float32)
    out[..., 0] = rng.uniform(lo, w * 16, (b, p))
    out[..., 1] = rng.uniform(lo, h * 16, (b, p))
    out[..., 2] = out[..., 0] + rng.uniform(0, w * grow, (b, p))
    out[..., 3] = out[..., 1] + rng.uniform(0, h * grow, (b, p))
    return out


def vjp_case(name):
    """(features (B, H, W, C) float32, boxes (B, P, 4), output size) of one
    case of the tie, NaN, empty-bin and edge rules of the RoIPool VJP."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "plateau":
        # one bin over a 3 x 5 plateau: dyadic shares 1/32 at the corners,
        # 1/16 along the edges, 1/8 inside (test_plateau_shares)
        feat = np.full((1, 8, 10, 2), -1.0, np.float32)
        feat[0, 1:4, 2:7] = 2.0
        return feat, np.array([[[32, 16, 6 * 16, 3 * 16]]], np.float32), 1
    if name == "integer_ties":  # values in -2..2: ties in most bins
        return (rng.integers(-2, 3, (2, 20, 24, 4)).astype(np.float32), _boxes(rng, 2, 12, 20, 24), 7)
    if name == "relu_zeros":  # a relu map: zero plateaus, as res4's
        feat = np.maximum(rng.standard_normal((2, 20, 24, 4)), 0).astype(np.float32)
        feat[1, 4:12, 6:16] = 0.0
        return feat, _boxes(rng, 2, 10, 20, 24), 7
    if name == "nonfinite":  # NaN bins give nothing; +-inf are values
        feat = rng.integers(-2, 3, (2, 20, 24, 4)).astype(np.float32)
        feat[0, 3, 5, :2] = np.nan
        feat[1, 10:14, 2:9, 1] = np.nan
        feat[0, 12:16, 12:20, 2] = np.inf
        feat[1, :6, :6, :] = -np.inf
        return feat, _boxes(rng, 2, 12, 20, 24), 7
    if name == "empty_and_off_map":
        feat = rng.integers(-2, 3, (2, 20, 24, 3)).astype(np.float32)
        boxes = _boxes(rng, 2, 8, 20, 24)
        boxes[0, 0] = [24 * 16 + 100, 10, 24 * 16 + 300, 60]  # right of the map
        boxes[0, 1] = [-90, -90, -20, -20]  # above and left
        boxes[1, 0] = [40, 40, 40, 40]  # zero size
        boxes[1, 1] = [3, 3, 3.5, 3.5]  # degenerate
        return feat, boxes, 7
    if name == "map_edge":  # bins on the last row and column
        feat = rng.integers(-1, 2, (1, 13, 21, 3)).astype(np.float32)
        boxes = np.array([[[21 * 16 - 60, 13 * 16 - 60, 21 * 16 + 40, 13 * 16 + 40],
                           [0, 13 * 16 - 20, 21 * 16 - 1, 13 * 16 - 1],
                           [21 * 16 - 17, 0, 21 * 16 - 1, 13 * 16 - 1]]], np.float32)
        return feat, boxes, 5
    if name == "power_of_two_bins":  # the two lookups of a side coincide
        feat = rng.integers(-1, 2, (1, 32, 40, 3)).astype(np.float32)
        boxes = np.array([[[0, 0, 27 * 16, 27 * 16], [16, 32, 16 + 13 * 16, 32 + 13 * 16],
                           [64, 0, 64 + 6 * 16, 6 * 16]]], np.float32)
        return feat, boxes, 7
    if name == "bins_past_the_table":  # boxes far larger than the map
        feat = rng.integers(-2, 3, (1, 16, 20, 3)).astype(np.float32)
        boxes = np.array([[[-400, -300, 900, 800], [-2000, 0, 2000, 255], [0, -900, 319, 900]]], np.float32)
        return feat, boxes, 5
    assert name == "parity_geometry"  # the 52 x 84 map, 14 x 14 bins of up to 5 x 8
    feat = np.maximum(rng.integers(-3, 4, (1, 52, 84, 2)), 0).astype(np.float32)
    boxes = np.zeros((1, 16, 4), np.float32)
    boxes[0, :, :2] = rng.uniform(0, 700, (16, 2))
    boxes[0, :, 2:] = np.minimum(boxes[0, :, :2] + rng.uniform(16, 800, (16, 2)), [1343, 831])
    boxes[0, 0] = [0, 0, 1343, 831]
    return feat, boxes, 14


VJP_CASES = ("plateau", "integer_ties", "relu_zeros", "nonfinite", "empty_and_off_map", "map_edge",
             "power_of_two_bins", "bins_past_the_table", "parity_geometry")


@jax.jit
def _jax_pool_and_vjp(feat, boxes, g):
    s = g.shape[2]
    out, vjp = jax.vjp(lambda f: _roi_pool_xla(f, boxes, s, 1 / 16), feat)
    return out, vjp(g)[0]


def jax_pool(feat, boxes, s):
    g = jnp.zeros((*boxes.shape[:2], s, s, feat.shape[-1]), jnp.asarray(feat).dtype)
    return np.asarray(_jax_pool_and_vjp(jnp.asarray(feat), jnp.asarray(boxes), g)[0])


def jax_vjp(feat, boxes, g, s):
    """JAX's RoIPool cotangent (the VJP of its XLA sparse table, the
    backward of ``roi_pool_pallas_ad`` too), one jitted call a shape."""
    return np.asarray(_jax_pool_and_vjp(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(g))[1])


class TestRoIPoolVJP:
    @pytest.mark.parametrize("case", VJP_CASES)
    def test_sparse_table_forward_equals_jax(self, case):
        """``roi_pool`` (the sparse table) bitwise equal to JAX's, NaN in the
        same places (f32)."""
        feat, boxes, s = vjp_case(case)
        got = roi_pool(t(feat), t(boxes), s, 1 / 16).numpy()
        want = jax_pool(feat, boxes, s)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("case", VJP_CASES)
    def test_dyadic_cotangents_exact(self, case):
        """Cotangents of small integers times 2^-4 sum exactly in any order:
        the plain VJP equals ``jax.vjp`` bitwise."""
        feat, boxes, s = vjp_case(case)
        rng = np.random.default_rng(1)
        g = (rng.integers(-8, 9, (*boxes.shape[:2], s, s, feat.shape[-1])) / 16).astype(np.float32)
        got = roi_pool_plain_vjp(t(feat), t(boxes), t(g), s, 1 / 16).numpy()
        np.testing.assert_array_equal(got, jax_vjp(feat, boxes, g, s))

    @pytest.mark.parametrize("case", VJP_CASES)
    def test_random_cotangents_f32(self, case):
        """Random float32 cotangents: the same shares, sums in another order
        (rtol 1e-6, atol 1e-6 of the largest cotangent for cancellation)."""
        feat, boxes, s = vjp_case(case)
        g = np.random.default_rng(2).standard_normal((*boxes.shape[:2], s, s, feat.shape[-1])).astype(np.float32)
        got = roi_pool_plain_vjp(t(feat), t(boxes), t(g), s, 1 / 16).numpy()
        np.testing.assert_allclose(got, jax_vjp(feat, boxes, g, s), rtol=1e-6, atol=1e-6 * np.abs(g).max())

    @pytest.mark.parametrize("case", VJP_CASES)
    def test_bf16(self, case):
        """bfloat16: JAX sums the scatter in bfloat16, the port in float32
        with one cast, so a cell that takes several shares may differ by the
        roundings of JAX's partial sums (rtol 2^-6, atol 2^-8 of the largest
        cotangent), in bfloat16."""
        feat, boxes, s = vjp_case(case)
        g = np.random.default_rng(3).standard_normal((*boxes.shape[:2], s, s, feat.shape[-1])).astype(np.float32)
        fb, gb = t(feat).to(torch.bfloat16), t(g).to(torch.bfloat16)
        got = roi_pool_plain_vjp(fb, t(boxes), gb, s, 1 / 16)
        assert got.dtype == torch.bfloat16
        want = jax_vjp(jnp.asarray(feat, jnp.bfloat16), boxes, jnp.asarray(g, jnp.bfloat16), s).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-6, atol=2**-8 * np.abs(g).max())

    def test_plateau_shares(self):
        """One bin over a 3 x 5 plateau: the cotangent 1 splits down the tree
        as 1/32 at the corners, 1/16 on the edges and 1/8 inside (not to one
        argmax as torchvision's, not uniformly)."""
        feat, boxes, s = vjp_case("plateau")
        g = np.zeros((1, 1, 1, 1, 2), np.float32)
        g[..., 0] = 1.0
        got = roi_pool_plain_vjp(t(feat), t(boxes), t(g), s, 1 / 16).numpy()[0, 1:4, 2:7, 0] * 32
        np.testing.assert_array_equal(got, [[1, 2, 2, 2, 1], [2, 4, 4, 4, 2], [1, 2, 2, 2, 1]])
        assert got.sum() == 32

    def test_nan_bins_give_nothing(self):
        """JAX's max gives a NaN result's cotangent to neither operand;
        autograd through ``torch.maximum`` gives it to both, which is why the
        plain VJP carries its own max."""
        feat = np.zeros((1, 4, 4, 1), np.float32)
        feat[0, 1, 1, 0] = np.nan
        boxes = np.array([[[0, 0, 63, 63]]], np.float32)
        g = np.ones((1, 1, 1, 1, 1), np.float32)
        got = roi_pool_plain_vjp(t(feat), t(boxes), t(g), 1, 1 / 16).numpy()
        np.testing.assert_array_equal(got, jax_vjp(feat, boxes, g, 1))
        assert not got.any()
        f = t(feat).requires_grad_()
        roi_pool(f, t(boxes), 1, 1 / 16).backward(t(g))
        assert f.grad.abs().sum() > 0

    def test_roi_pool_auto_differentiates_on_the_cpu(self):
        """With grad, ``roi_pool_auto`` is the autograd Function: the plain
        offset-loop forward (bitwise as before), ``roi_pool_plain_vjp`` for
        the features, no gradient for the boxes, no kernel launch; without
        grad no graph at all."""
        feat, boxes, s = vjp_case("integer_ties")
        g = np.random.default_rng(4).standard_normal((*boxes.shape[:2], s, s, feat.shape[-1])).astype(np.float32)
        f, b = t(feat).requires_grad_(), t(boxes).requires_grad_()
        launches = (roi_pool_auto.launches, roi_pool_backward_auto.launches)
        out = roi_pool_auto(f, b, s, 1 / 16)
        assert out.grad_fn is not None
        np.testing.assert_array_equal(out.detach().numpy(), pt_ops.roi_pool(t(feat), t(boxes), s, 1 / 16).numpy())
        out.backward(t(g))
        assert b.grad is None
        np.testing.assert_array_equal(f.grad.numpy(), roi_pool_plain_vjp(t(feat), t(boxes), t(g), s, 1 / 16).numpy())
        assert (roi_pool_auto.launches, roi_pool_backward_auto.launches) == launches
        with torch.no_grad():
            assert roi_pool_auto(f, b, s, 1 / 16).grad_fn is None


# ------------------------------------------------- RoIAlign, NMS, matcher


@pytest.mark.parametrize("aligned", [False, True])
def test_roi_align_matches_jax(aligned):
    """Batched ``roi_align`` against JAX's per image, f32: sample points are
    computed with and without fused multiply-adds, an ulp of a coordinate
    (~4e-6 at 50 cells) times the step between neighbours (atol 1e-4)."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 20, 24, 4)).astype(np.float32)
    boxes = _boxes(rng, 2, 6, 20, 24, lo=-20.0, grow=20.0)
    boxes[0, 0] = [0, 0, 160, 160]
    got = pt_ops.roi_align(t(feat), t(boxes), 7, 1 / 16, 2, aligned).numpy()
    want = np.stack([np.asarray(j_roi_align(jnp.asarray(feat[i]), jnp.asarray(boxes[i]), 7, 1 / 16, 2, aligned))
                     for i in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    const = pt_ops.roi_align(torch.ones(1, 20, 20, 4), t(boxes[:1]), 7, 1 / 16, 2, aligned)
    np.testing.assert_allclose(const.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("rows", [False, True])
def test_batched_nms_matches_jax(rows):
    """Category-aware NMS: keep indices and masks equal to JAX's, for one
    image and for rows of images (each row its own coordinate islands)."""
    rng = np.random.default_rng(6)
    boxes = np.concatenate([rng.uniform(0, 80, (3, 40, 2)), rng.uniform(0, 80, (3, 40, 2))], -1).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + np.abs(boxes[..., 2:] - boxes[..., :2]) / 2 + 1
    scores = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    scores[:, :4] = 0.5  # ties: lower index first
    idxs = rng.integers(0, 3, (3, 40)).astype(np.int32)
    boxes[:, 1] = boxes[:, 0]  # an exact duplicate, of another class where idxs differ
    want = [j_batched_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(idxs[i]), 0.5, 12)
            for i in range(3)]
    if rows:
        keep, valid = pt_ops.batched_nms_fixed(t(boxes), t(scores), t(idxs), 0.5, 12)
    else:
        got = [pt_ops.batched_nms_fixed(t(boxes[i]), t(scores[i]), t(idxs[i]), 0.5, 12) for i in range(3)]
        keep, valid = torch.stack([k for k, _ in got]), torch.stack([v for _, v in got])
    np.testing.assert_array_equal(keep.numpy(), np.stack([np.asarray(k) for k, _ in want]))
    np.testing.assert_array_equal(valid.numpy(), np.stack([np.asarray(v) for _, v in want]))
    empty_keep, empty_valid = pt_ops.batched_nms_fixed(torch.zeros(0, 4), torch.zeros(0), torch.zeros(0), 0.5, 3)
    assert empty_keep.tolist() == [-1, -1, -1] and not empty_valid.any()


MATCH_CASES = {
    "rpn_low_quality": ((0.3, 0.7), (0, -1, 1), True, [True, True, False]),
    "roi_heads": ((0.5,), (0, 1), False, [True, True, False]),
    "no_ground_truth": ((0.3, 0.7), (0, -1, 1), True, [False, False, False]),
    "all_real_ties": ((0.3, 0.7), (0, -1, 1), True, [True, True, True]),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_quality_matches_jax(case):
    """Matches and labels exactly JAX's: the first index on an argmax tie,
    padded rows at quality -1, low-quality promotion with ties."""
    thresholds, labels, low, valid = MATCH_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.choice([0.0, 0.2, 0.3, 0.5, 0.65, 0.7, 0.9], (3, 30)).astype(np.float32)
    q[1, 5] = q[0, 5]  # a tie between two ground truths
    q[0, 8:11] = q[0].max()  # a tie for a ground truth's best
    jm, jl = j_match_quality(jnp.asarray(q), thresholds, labels, allow_low_quality_matches=low,
                             gt_valid=jnp.asarray(valid))
    pm, pl = pt_ops.match_quality(t(q), thresholds, labels, allow_low_quality_matches=low, gt_valid=t(np.array(valid)))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    bm, bl = pt_ops.match_quality(t(np.stack([q, q])), thresholds, labels, allow_low_quality_matches=low,
                                  gt_valid=t(np.array([valid, valid])))
    assert torch.equal(bm[1], pm) and torch.equal(bl[0], pl)


SUBSAMPLE_CASES = {
    "few_positives": ([1] * 10 + [0] * 50 + [-1] * 20, 0, 32, 0.5),
    "positive_fraction": ([1] * 100 + [0] * 100, 1, 64, 0.25),
    "negatives_only": ([0] * 200, 0, 50, 0.5),
    "short_of_both": ([1] * 3 + [0] * 5 + [-1] * 40, 2, 32, 0.5),
}


@pytest.mark.parametrize("case", sorted(SUBSAMPLE_CASES))
def test_subsample_mask_with_jax_draws(case):
    """With JAX's priorities fed in, the sample mask equals JAX's exactly."""
    labels, seed, num, frac = SUBSAMPLE_CASES[case]
    labels = np.array(labels, np.int8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_subsample_mask(jnp.asarray(labels), key, num, frac))
    u = np.asarray(jax.random.uniform(key, (labels.shape[0],)))
    got = subsample_mask(t(labels), t(u), num, frac).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(subsample_mask(t(np.stack([labels] * 2)), t(np.stack([u] * 2)), num, frac)[1], got)


# ------------------------------------------------ losses and gradients


def flax_params(rng, images, sizes, cfg=TINY):
    shapes = jax.eval_shape(JFRCNN(cfg=JConfig(**cfg)).init, jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(sizes))["params"]
    out = {}
    for key, leaf in tu.flatten_dict(shapes, sep="/").items():
        shape, kind = leaf.shape, key.rsplit("/", 1)[-1]
        if kind in ("kernel", "embedding"):
            fan_in = shape[-1] if kind == "embedding" else int(np.prod(shape[:-1]))
            out[key] = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        elif kind == "bias":
            out[key] = rng.normal(0, 0.05, shape).astype(np.float32)
        else:
            out[key] = np.full(shape, 1.0 if kind in ("scale", "var") else 0.0, np.float32)
    return tu.unflatten_dict(out, sep="/")


def gt_batch(proposals):
    """Two images with fixed-shape (G=3) ground truth, the last row padded:
    a box of JAX's detection tests and, rounded to whole pixels, the first
    proposal of the image, so that the RoI heads have foreground."""
    boxes = np.array([[[0, 0, 0, 0], [4, 4, 28, 30], [0, 0, 0, 0]],
                      [[0, 0, 0, 0], [34, 30, 60, 58], [0, 0, 0, 0]]], np.float32)
    boxes[:, 0] = np.round(proposals[:, 0])
    valid = np.array([[1, 1, 0], [1, 1, 0]], bool)
    classes = np.array([[2, 5, 0], [1, 3, 0]], np.int32)
    return boxes, valid, classes


def priorities(key, n, k):
    """JAX's draws: image i's ``uniform(split(key, n)[i], (k,))``."""
    return np.stack([np.asarray(jax.random.uniform(r, (k,))) for r in jax.random.split(key, n)])


RPN_BATCH, ROI_BATCH = 64, 32


def port_losses(model, images, sizes, gt, u_rpn=None, u_roi=None, generator=None, parts=("rpn", "roi")):
    boxes, valid, classes = (t(a) for a in gt)
    raw = model(images, sizes, return_raw=True)["raw"]
    losses = []
    if "rpn" in parts:
        losses += rpn_losses(raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], boxes, valid, u_rpn,
                             generator=generator, batch_size_per_image=RPN_BATCH)
    if "roi" in parts:
        losses += fast_rcnn_losses(raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"],
                                   boxes, classes, valid, u_roi, generator=generator,
                                   batch_size_per_image=ROI_BATCH)
    return losses


@pytest.fixture(scope="class")
def detector():
    """Flax params, inputs, JAX's losses and gradients (one jitted
    value_and_grad) and the port's priorities for the same keys."""
    rng = np.random.default_rng(0)
    images = rng.uniform(-40, 40, (2, 64, 64, 3)).astype(np.float32)
    sizes = np.array([[64.0, 64.0], [64.0, 56.0]], np.float32)
    params = flax_params(rng, images, sizes)
    with torch.no_grad():
        proposals = port_model(params)(t(images), t(sizes), return_raw=True)["raw"]["proposals"]
    gt = gt_batch(proposals.numpy())
    model = JFRCNN(cfg=JConfig(**TINY))
    k_rpn, k_roi = jax.random.PRNGKey(2), jax.random.PRNGKey(3)

    def loss_fn(p):
        raw = model.apply({"params": p}, jnp.asarray(images), jnp.asarray(sizes), return_raw=True)["raw"]
        obj, loc = j_rpn_losses(raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], gt[0], gt[1], k_rpn,
                                batch_size_per_image=RPN_BATCH)
        cls, box = j_fast_rcnn_losses(raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"],
                                      gt[0], gt[2], gt[1], k_roi, batch_size_per_image=ROI_BATCH)
        return obj + loc + cls + box, jnp.stack([obj, loc, cls, box])

    (_, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    n_anchors = 4 * 4 * len(TINY["anchor_sizes"]) * 3
    return dict(
        params=params, images=images, sizes=sizes, gt=gt, parts=np.asarray(parts),
        grads=jax_frcnn_to_torch(grads), u_rpn=priorities(k_rpn, 2, n_anchors),
        u_roi=priorities(k_roi, 2, TINY["post_nms_topk"]),
    )


def port_model(params, **overrides):
    model = FRCNN(FRCNNConfig(**{**TINY, **overrides}))
    model.load_state_dict(jax_frcnn_to_torch(params), strict=True)
    return model.train()


def grads_of(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


class TestDetectionTraining:
    def test_losses_and_gradients_match_jax(self, detector):
        """The four losses (rtol 1e-5) and every trained tensor's gradient
        (within 1e-5 of its largest entry: float32 convolutions summed in
        another order) equal JAX's on the tiny FRCNN, the RoI head's box
        loss included (proposals match the ground truth)."""
        d = detector
        model = port_model(d["params"])
        parts = port_losses(model, t(d["images"]), t(d["sizes"]), d["gt"], t(d["u_rpn"]), t(d["u_roi"]))
        got = torch.stack(parts).detach().numpy()
        np.testing.assert_allclose(got, d["parts"], rtol=1e-5)
        assert (got > 0).all(), got
        sum(parts).backward()
        grads = grads_of(model)
        # the attribute head is not on the losses' path, in either package
        assert {n for n, _ in model.named_parameters()} - set(grads) == {
            n for n, _ in model.named_parameters() if ".cls_embedding." in n or "attr" in n}
        for name, g in grads.items():
            want = d["grads"][name].numpy()
            scale = np.abs(want).max()
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * scale + 1e-9, err_msg=name)
            assert scale > 0, name

    def test_fast_rcnn_losses_alone_leave_the_rpn_untrained(self, detector):
        """The proposals are detached targets: the RoI-head losses alone give
        the RPN head no gradient (as JAX's, which is zero), the backbone and
        the RoI heads one."""
        d = detector
        model = port_model(d["params"])
        sum(port_losses(model, t(d["images"]), t(d["sizes"]), d["gt"], u_roi=t(d["u_roi"]), parts=("roi",))).backward()
        grads = grads_of(model)
        assert not any(n.startswith("proposal_generator.") and g.abs().sum() > 0 for n, g in grads.items())
        assert grads["backbone.res4.0.conv1.weight"].abs().sum() > 0
        assert grads["roi_heads.box_predictor.cls_score.weight"].abs().sum() > 0

    @pytest.mark.parametrize("overrides", [dict(remat=True), dict(roi_chunk=12)], ids=["remat", "chunked_rois"])
    def test_memory_options_change_no_number(self, detector, overrides):
        """``remat`` (checkpointed backbone blocks) and RoIs pooled in
        chunks (several forward calls and plain backward calls adding into
        one gradient) give the plain run's loss and gradients (rtol 1e-6;
        the chunked res5 sums its batch in other groups)."""
        d = detector
        runs = []
        for kw in ({}, overrides):
            model = port_model(d["params"], **kw)
            loss = sum(port_losses(model, t(d["images"]), t(d["sizes"]), d["gt"], t(d["u_rpn"]), t(d["u_roi"])))
            loss.backward()
            runs.append((float(loss.detach()), grads_of(model)))
        assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-6)
        assert set(runs[0][1]) == set(runs[1][1])
        for name, g in runs[0][1].items():
            np.testing.assert_allclose(runs[1][1][name].numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(g.abs().max()), err_msg=name)

    def test_six_step_finetune_reduces_loss(self, detector):
        """Adam at 1e-3, the sampling priorities of one fixed seed every
        step (JAX's test fixes its key): finite gradients, falling loss."""
        d = detector
        model = port_model(d["params"])
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        losses = []
        for _ in range(6):
            opt.zero_grad(set_to_none=True)
            loss = sum(port_losses(model, t(d["images"]), t(d["sizes"]), d["gt"],
                                   generator=torch.Generator().manual_seed(100)))
            loss.backward()
            assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
            opt.step()
            losses.append(float(loss))
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ------------------------------------------------------------------- mAP


def _perfect():
    return (np.array([[[10, 10, 30, 30], [50, 50, 80, 90]]], np.float32), np.array([[True, True]]),
            np.array([[1, 2]]))


def map_case(name):
    """The five cases of JAX's TestDetectionMAP: (args, expected)."""
    gt_boxes, gt_valid, gt_classes = _perfect()
    if name == "perfect":
        return (gt_boxes, np.array([[0.9, 0.8]]), gt_classes, np.array([[True, True]]), gt_boxes, gt_classes,
                gt_valid), 1.0
    if name == "all_misses":
        return (gt_boxes + 1000.0, np.array([[0.9, 0.8]]), gt_classes, np.array([[True, True]]), gt_boxes,
                gt_classes, gt_valid), 0.0
    if name == "half_hits":
        preds = np.array([[[10, 10, 30, 30], [400, 400, 420, 420], [50, 50, 80, 90]]], np.float32)
        return (preds, np.array([[0.9, 0.95, 0.5]]), np.array([[1, 2, 2]]), np.array([[True] * 3]), gt_boxes,
                gt_classes, gt_valid), 0.75
    if name == "duplicates":
        preds = np.array([[[10, 10, 30, 30], [11, 11, 30, 30]]], np.float32)
        return (preds, np.array([[0.9, 0.8]]), np.array([[1, 1]]), np.array([[True, True]]), gt_boxes[:, :1],
                gt_classes[:, :1], gt_valid[:, :1]), 1.0
    assert name == "voc_no_fallback"
    gt = np.array([[[0, 0, 20, 20], [8, 0, 28, 20]]], np.float32)
    preds = np.array([[[0, 0, 20, 20], [2, 0, 22, 20]]], np.float32)
    return (preds, np.array([[0.9, 0.8]]), np.array([[1, 1]]), np.array([[True, True]]), gt,
            np.array([[1, 1]]), np.array([[True, True]])), 0.5


@pytest.mark.parametrize("case", ["perfect", "all_misses", "half_hits", "duplicates", "voc_no_fallback"])
def test_detection_map_matches_jax(case):
    """JAX's value exactly, on arrays and on tensors."""
    args, expected = map_case(case)
    got = detection_map(*args)
    assert got == j_detection_map(*args)
    assert got == pytest.approx(expected)
    assert detection_map(*(t(np.asarray(a)) for a in args)) == got


# ------------------------------------------------------------ experiment


def test_registry_resolves_frcnn_detect():
    assert Experiments.get("frcnn_detect") is FRCNNDetectExperiment
    assert Experiments.get("FRCNN_detect").name == "frcnn_detect"


def test_prepare_batch_is_bitwise_jax():
    """RGB -> BGR minus the caffe means, the pad zeroed, XYWH raw boxes ->
    XYXY resized, ``vlabels`` clipped to the class table: JAX's arrays."""
    from vltk_tpu.experiments.frcnn_detect import FRCNNDetectExperiment as JExp

    rng = np.random.default_rng(9)
    batch = {
        "image": rng.uniform(0, 255, (2, 32, 40, 3)).astype(np.float32),
        "size": np.array([[24, 40], [32, 30]], np.float32),
        "rawsize": np.array([[48, 80], [64, 50]], np.float32),
        "gt_boxes": rng.uniform(0, 40, (2, 5, 4)).astype(np.float32),
        "gt_boxes_mask": np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool),
        "vlabels": np.array([[0, 3, 9, 0, 0], [2, 0, 0, 0, 0]], np.int32),
    }
    batch["gt_boxes"][0, 2, 2] = 0.0  # zero width: not valid
    jexp, pexp = object.__new__(JExp), object.__new__(FRCNNDetectExperiment)
    jexp.model_config = JConfig(**TINY)
    pexp.model_config = FRCNNConfig(**TINY)
    want, got = jexp.prepare_batch(dict(batch)), pexp.prepare_batch(dict(batch))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_e2e_coco_finetune_with_map(tmp_path):
    """The whole path in the port: a seeded COCO-2014 corpus ->
    ``build(config)`` -> the vision loader (gt_boxes, vlabels) ->
    ``FRCNNDetectExperiment`` at the tiny size, two epochs with finite
    losses; then an experiment with an eval loader adds ``map50`` in
    [0, 1]. No kernel launches on the CPU."""
    import vltk_tpu_torch as vltk
    from vltk_tpu_torch.tools.synthetic_corpus import write_corpus

    write_corpus(str(tmp_path), n_images=4, n_questions=4, hw=(40, 56), seed=11)
    cfg = vltk.Config()
    cfg.logdir = str(tmp_path / "logs")
    cfg.data.update(dict(
        datadir=str(tmp_path), train_datasets=(("coco2014", "train"),), train_batch_size=2, num_workers=0,
        shuffle=False, drop_last=True, max_detections=6, ignore_segmentation=True,
    ))
    cfg.data.vision.update({"size": (48, 64)})
    cfg.train.update(dict(epochs=2, learning_rate=1e-3))

    class Tiny(FRCNNDetectExperiment):
        model_config = FRCNNConfig(**TINY)
        rpn_batch_per_image = 32
        roi_batch_per_image = 16

    launches = (roi_pool_auto.launches, roi_pool_backward_auto.launches)
    exp = Tiny(cfg, device="cpu")
    result = exp()
    for k in ("loss", "rpn_obj", "rpn_loc", "roi_cls", "roi_box"):
        assert np.isfinite(result["train"][k]), k
    assert result["train"]["loss"] > 0
    assert exp.model.roi_heads.box_predictor.cls_score.out_features == exp.model_config.num_classes + 1
    steps = [json.loads(line) for line in open(os.path.join(exp.logdir, "steps_log.json"))]
    assert len(steps) == 2 * len(exp.train_loader)

    cfg.logdir = str(tmp_path / "logs2")
    cfg.train.update({"epochs": 1})
    exp2 = Tiny(cfg, loaders=(exp.train_loader, exp.train_loader), device="cpu")
    result2 = exp2()
    assert 0.0 <= result2["eval"]["map50"] <= 1.0
    assert np.isfinite(result2["eval"]["rpn_obj"])
    assert (roi_pool_auto.launches, roi_pool_backward_auto.launches) == launches
    assert dataclasses.replace(exp2.model_config).num_classes == exp.model_config.num_classes
