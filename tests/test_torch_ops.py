"""Ops of the PyTorch port held against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``vltk_tpu_torch``; each test states its tolerance.
The CUDA kernels cannot run here: on CPU tensors the port's dispatchers run
the kernels' plain versions, which are what is compared. ``chip_smoke.py``
holds the kernels against those plain versions on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from vltk_tpu.models import anchors as jx_anchors
from vltk_tpu.ops import boxes as jx_boxes
from vltk_tpu.ops import image_ops as jx_image
from vltk_tpu.ops import nms as jx_nms
from vltk_tpu.ops.pallas_kernels import _roi_pool_xla, roi_pool_pallas

from vltk_tpu_torch.models import anchors as pt_anchors
from vltk_tpu_torch.ops import boxes as pt_boxes
from vltk_tpu_torch.ops import image_ops as pt_image
from vltk_tpu_torch.ops import nms as pt_nms
from vltk_tpu_torch.ops import roi_pool as pt_roi
from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand_boxes(rng, shape, lo=0.0, hi=200.0):
    xy = rng.uniform(lo, hi, (*shape, 2)).astype(np.float32)
    wh = rng.uniform(0.0, (hi - lo) / 2, (*shape, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


class TestBoxes:
    def test_box_functions_match_jax(self, rng):
        """f32 box algebra; exact up to 1 ulp-level rounding (rtol 1e-6)."""
        boxes = rand_boxes(rng, (3, 20))
        boxes[0, 0] = [5, 5, 5, 9]  # zero width
        deltas = rng.normal(0, 1, (3, 20, 8)).astype(np.float32)
        deltas[0, 1, 2] = 10.0  # past the scale clamp
        weights = (10.0, 10.0, 5.0, 5.0)
        sizes = np.array([[100, 150], [80, 60], [200, 200]], np.float32)
        cases = [
            (jx_boxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes), weights),
             pt_boxes.apply_deltas(t(deltas), t(boxes), weights)),
            (jx_boxes.encode_deltas(jnp.asarray(boxes[:, :5] + [0, 0, 1, 1]),
                                    jnp.asarray(boxes[:, 5:10] + [0, 0, 1, 1]), weights),
             pt_boxes.encode_deltas(t(boxes[:, :5] + np.float32([0, 0, 1, 1])),
                                    t(boxes[:, 5:10] + np.float32([0, 0, 1, 1])), weights)),
            (jax.vmap(jx_boxes.clip_boxes)(jnp.asarray(boxes), jnp.asarray(sizes)),
             pt_boxes.clip_boxes(t(boxes), t(sizes))),
            (jx_boxes.nonempty_mask(jnp.asarray(boxes), 3.0),
             pt_boxes.nonempty_mask(t(boxes), 3.0)),
            (jx_boxes.box_area(jnp.asarray(boxes)), pt_boxes.box_area(t(boxes))),
            (jx_boxes.box_iou(jnp.asarray(boxes), jnp.asarray(boxes[::-1])),
             pt_boxes.box_iou(t(boxes), t(boxes[::-1].copy()))),
        ]
        for i, (want, got) in enumerate(cases):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5, err_msg=str(i)
            )


class TestAnchors:
    @pytest.mark.parametrize("offset", [0.0, 0.5])
    def test_grid_anchors_match_jax(self, offset):
        """Same numpy arithmetic: exact."""
        kw = dict(stride=16, sizes=(16, 32, 64), aspect_ratios=(0.5, 1.0, 2.0), offset=offset)
        want = np.asarray(jx_anchors.grid_anchors((3, 5), **kw))
        got = pt_anchors.grid_anchors((3, 5), **kw).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            pt_anchors.cell_anchors(), jx_anchors.cell_anchors()
        )


def f64_resize_reference(imgs, raw_sizes, new_hw, canvas_hw, mean):
    """The reference's resize evaluated in float64: its triangle-kernel
    weight matrices (float32, as ``jax.image.scale_and_translate`` builds
    them) contracted with the edge-replicated image in float64."""

    def weight_mat(in_size, out_size, scale):
        inv = np.float32(1) / np.float32(scale)
        sf = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
        x = np.abs(sf[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
        w = np.maximum(np.float32(0), np.float32(1) - x)
        tot = w.sum(axis=0, keepdims=True)
        w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
        return np.where(((sf >= -0.5) & (sf <= in_size - 0.5))[None], w, 0).astype(np.float64)

    n, hr, wr, _ = imgs.shape
    out = np.zeros((n, *canvas_hw, 3))
    for i in range(n):
        (rh, rw), (nh, nw) = raw_sizes[i], new_hw[i]
        img = imgs[i][np.minimum(np.arange(hr), rh - 1)][:, np.minimum(np.arange(wr), rw - 1)]
        wy = weight_mat(hr, canvas_hw[0], np.float32(nh) / np.float32(rh))
        wx = weight_mat(wr, canvas_hw[1], np.float32(nw) / np.float32(rw))
        res = np.einsum("abc,ad,be->dec", img.astype(np.float64), wy, wx)[..., ::-1] - mean
        inside = (np.arange(canvas_hw[0])[:, None] < nh) & (np.arange(canvas_hw[1])[None] < nw)
        out[i] = np.where(inside[..., None], res, 0)
    return out


class TestPreprocess:
    @pytest.mark.parametrize(
        "raw_sizes,dtype",
        [
            # upscaling: short edge 30 -> 48, both orientations
            ([[30, 40], [40, 28]], np.uint8),
            # under the maximum clamp (long side 60 * 48/20 > 64) and a
            # downscale, float input
            ([[20, 60], [40, 56]], np.float32),
        ],
    )
    def test_preprocess_matches_jax(self, rng, raw_sizes, dtype):
        """Sizes and scales: rtol 1e-6. Pixels, on the 0-255 scale: within
        1e-4 of the reference's sampling evaluated in float64, and within
        2e-3 of JAX, whose XLA:CPU einsum was measured up to 1.3e-3 away
        from that float64 value on these inputs (the port's gather-and-lerp
        stays within 3e-5 of it)."""
        raw_canvas = (40, 56)
        imgs = rng.integers(0, 256, (2, *raw_canvas, 3)).astype(dtype)
        sizes = np.asarray(raw_sizes, np.int32)
        kw = dict(canvas_hw=(48, 64), short=48.0, maximum=64.0)
        want = jx_image.preprocess_batch(jnp.asarray(imgs), jnp.asarray(sizes), **kw)
        got = pt_image.preprocess_batch(t(imgs), t(sizes), **kw)
        for key in ("sizes", "scales_yx"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)
        exact = f64_resize_reference(
            imgs, sizes, got["sizes"].numpy(), kw["canvas_hw"],
            np.asarray(pt_image.CAFFE_BGR_MEAN),
        )
        np.testing.assert_allclose(got["img"].numpy(), exact, rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            got["img"].numpy(), np.asarray(want["img"]), rtol=0, atol=2e-3
        )


def roi_case(rng, b, h, w, c, p, dtype):
    """Features and boxes with the edge cases of the reference's RoIPool
    tests: zero-size, degenerate, negative and off-map boxes."""
    feat = rng.standard_normal((b, h, w, c)).astype(np.float32)
    boxes = np.zeros((b, p, 4), np.float32)
    boxes[..., 0] = rng.uniform(0, w * 16 - 2, (b, p))
    boxes[..., 1] = rng.uniform(0, h * 16 - 2, (b, p))
    boxes[..., 2] = np.minimum(boxes[..., 0] + rng.uniform(1, w * 16, (b, p)), w * 16 - 1)
    boxes[..., 3] = np.minimum(boxes[..., 1] + rng.uniform(1, h * 16, (b, p)), h * 16 - 1)
    boxes[0, 0] = [3, 3, 3.5, 3.5]  # degenerate tiny box
    boxes[0, 1] = [0, 0, w * 16 - 1, h * 16 - 1]  # full map: widest bins
    boxes[0, 2] = [40, 40, 40, 40]  # zero size
    boxes[0, 3] = [-40, -24, 30, 50]  # negative corner
    boxes[1, 0] = [w * 16 + 100, 10, w * 16 + 200, 60]  # off the map: empty
    boxes[1, 1] = [-90, -90, -20, -20]  # off the map, negative
    boxes[1, 2] = [7.5, 8.0, 23.5, 24.0]  # corners on the rounding half
    if dtype == "bfloat16":
        return jnp.asarray(feat, jnp.bfloat16), feat, boxes
    return jnp.asarray(feat), feat, boxes


class TestRoIPool:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_roi_pool_matches_pallas_and_xla(self, rng, dtype):
        """Exact equality with the Pallas kernel (interpret mode) and the
        XLA formulation, f32 and bf16."""
        feat_j, feat_np, boxes = roi_case(rng, 2, 20, 24, 8, 8, dtype)
        pallas = np.asarray(
            roi_pool_pallas(feat_j, jnp.asarray(boxes), 7, 1 / 16, interpret=True)
            .astype(jnp.float32)
        )
        xla = np.asarray(_roi_pool_xla(feat_j, jnp.asarray(boxes), 7, 1 / 16).astype(jnp.float32))
        feat_t = t(feat_np).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        launches = roi_pool_auto.launches
        got = roi_pool_auto(feat_t, t(boxes), 7, 1 / 16)
        assert got.dtype == feat_t.dtype and got.shape == (2, 8, 7, 7, 8)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), pallas)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), xla)
        assert roi_pool_auto.launches == launches  # CPU tensors launch no kernel

    def test_roi_pool_14_at_extraction_like_shape(self, rng):
        """The 14x14 pooler on a map whose bins reach the 5 x 8 extraction
        maximum, against the XLA formulation: exact."""
        feat_j, feat_np, boxes = roi_case(rng, 2, 28, 44, 4, 12, "float32")
        want = np.asarray(_roi_pool_xla(feat_j, jnp.asarray(boxes), 14, 1 / 16))
        got = pt_roi.roi_pool(t(feat_np), t(boxes), 14, 1 / 16)
        np.testing.assert_array_equal(got.numpy(), want)

    @staticmethod
    def _nonfinite_case(rng):
        """f32 features with NaN, +inf and -inf cells, and a 4 x 4 corner
        of -inf that the first box of image 1 covers alone, so that its
        bins' maxima are -inf."""
        feat_j, feat, boxes = roi_case(rng, 2, 20, 24, 8, 8, "float32")
        feat[0, 2, 3, :3] = np.nan
        feat[0, 9, 11, 5] = np.nan
        feat[0, 5, 5, 0] = np.inf
        feat[1, 7, 4, 2] = np.inf
        feat[0, 12, 8, 1] = -np.inf
        feat[1, :4, :4, :] = -np.inf
        boxes[1, 3] = [0, 0, 40, 40]  # cells 0..3: every bin -inf
        return jnp.asarray(feat), feat, boxes

    def test_roi_pool_nonfinite_matches_xla(self, rng):
        """NaN propagates, and +inf and -inf are values like any other, as
        in JAX's XLA formulation: NaN in the same places, equal elsewhere
        (f32)."""
        feat_j, feat, boxes = self._nonfinite_case(rng)
        want = np.asarray(_roi_pool_xla(feat_j, jnp.asarray(boxes), 7, 1 / 16))
        got = pt_roi.roi_pool(t(feat), t(boxes), 7, 1 / 16).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        finite = ~np.isnan(want)
        np.testing.assert_array_equal(got[finite], want[finite])
        assert np.isnan(got).any() and np.isposinf(got).any()
        assert (got[1, 3] == -np.inf).all()

    def test_roi_pool_pallas_zeroes_a_bin_whose_max_is_neg_inf(self, rng):
        """A known difference (ROADMAP, Pinned): the Pallas kernel takes a
        bin whose max is <= -5e29 for empty and gives 0
        (``pallas_kernels.py``, its ``m <= _NEG / 2`` test), where the
        port and the XLA formulation give -inf. Everywhere else, NaN
        included, the three agree."""
        feat_j, feat, boxes = self._nonfinite_case(rng)
        pallas = np.asarray(roi_pool_pallas(feat_j, jnp.asarray(boxes), 7, 1 / 16, interpret=True))
        got = pt_roi.roi_pool(t(feat), t(boxes), 7, 1 / 16).numpy()
        neg = got == -np.inf
        assert neg[1, 3].all()
        np.testing.assert_array_equal(pallas[neg], 0.0)
        np.testing.assert_array_equal(np.isnan(pallas), np.isnan(got))
        rest = ~neg & ~np.isnan(got)
        np.testing.assert_array_equal(pallas[rest], got[rest])

    def test_round_half_away_from_zero(self):
        s = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49, -0.49])
        np.testing.assert_array_equal(
            pt_roi.round_half_away(s).numpy(), [1, 2, 3, -1, -2, -3, 0, 0]
        )


def nms_case(rng, k, n_ties=6):
    boxes = rand_boxes(rng, (k,), 0.0, 120.0)
    scores = rng.uniform(0, 1, (k,)).astype(np.float32)
    scores[:n_ties] = 0.5  # equal scores: lower index first
    boxes[1] = boxes[0]  # a tied duplicate
    boxes[2] = [10, 10, 10, 30]  # zero area
    boxes[3] = [10, 10, 10, 30]  # the same zero-area box again
    valid = rng.uniform(0, 1, (k,)) > 0.15
    return boxes, scores, valid


class TestNMS:
    @pytest.mark.parametrize("thresh", [0.5, 1.0, 0.1, 0.7])
    def test_nms_matches_jax_scan_and_blocked(self, rng, thresh):
        """Exact keep indices against nms_fixed and nms_fixed_blocked,
        called directly, with ties, zero-area boxes and invalid entries."""
        rows = [nms_case(rng, 96) for _ in range(3)]
        boxes = np.stack([r[0] for r in rows])
        scores = np.stack([r[1] for r in rows])
        valid = np.stack([r[2] for r in rows])
        valid[2] = False  # a row with no candidate at all
        max_out = 40
        got_keep, got_valid = nms_fixed_auto(t(boxes), t(scores), thresh, max_out, valid=t(valid))
        assert got_keep.dtype == torch.int32 and got_keep.shape == (3, max_out)
        args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
        scan = jax.vmap(
            lambda b, s, v: jx_nms.nms_fixed(b, s, thresh, max_out, valid=v)
        )(*args)
        blocked = jax.vmap(
            lambda b, s, v: jx_nms.nms_fixed_blocked(b, s, thresh, max_out, valid=v, block=16)
        )(*args)
        for want_keep, want_valid in (scan, blocked):
            np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
            np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
        assert (got_keep[2] == -1).all()

    def test_per_row_thresholds(self, rng):
        """One call over rows with their own thresholds equals one call per
        threshold, and the single-row form equals the JAX scan."""
        boxes, scores, valid = nms_case(rng, 60)
        thr = torch.tensor([0.5, 1.0, 0.1])
        keep, kv = pt_nms.nms_fixed(
            t(np.stack([boxes] * 3)), t(np.stack([scores] * 3)), thr, 12,
            valid=t(np.stack([valid] * 3)),
        )
        for i, th in enumerate([0.5, 1.0, 0.1]):
            single, _ = pt_nms.nms_fixed(t(boxes), t(scores), float(th), 12, valid=t(valid))
            want, _ = jx_nms.nms_fixed(
                jnp.asarray(boxes), jnp.asarray(scores), jnp.float32(th), 12,
                valid=jnp.asarray(valid),
            )
            np.testing.assert_array_equal(keep[i].numpy(), single.numpy())
            np.testing.assert_array_equal(single.numpy(), np.asarray(want))


# a NaN coordinate gives its box IoU 0 with every box (maximum and minimum
# carry the NaN into the union, and the union test fails); a valid NaN score
# is argmax's first pick and no candidate, so its row keeps nothing
NAN_BOXES = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, np.nan, 10], [2, 2, 12, 12]], np.float32)


def clustered_rows(rng, rows, k):
    """Proposal-like rows: boxes clustered around k // 40 centres, logits
    with ties, a few invalid entries."""
    centers = rng.uniform(0, 1, (rows, k // 40, 2)) * [1000.0, 760.0]
    pick = rng.integers(0, k // 40, (rows, k))
    ctr = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 12, (rows, k, 2))
    wh = 20 + rng.uniform(0, 200, (rows, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.normal(0, 1, (rows, k)).astype(np.float32)
    scores[:, : k // 10] = np.round(scores[:, : k // 10] * 4) / 4
    valid = rng.uniform(0, 1, (rows, k)) > 0.05
    return boxes, scores, valid


class TestNMSAgainstJAX:
    @pytest.mark.parametrize(
        "scores,want",
        [([0.9, 0.8, 0.95, 0.7], [2, 0, 3, -1]), ([0.9, np.nan, 0.95, 0.7], [-1, -1, -1, -1])],
        ids=["nan_coordinate", "nan_score"],
    )
    def test_nan_rows(self, scores, want):
        """Exact keeps against nms_fixed and nms_fixed_blocked, one row and
        in a batch beside a row without NaN."""
        scores = np.array(scores, np.float32)
        for fn in (jx_nms.nms_fixed, lambda *a: jx_nms.nms_fixed_blocked(*a, block=2)):
            jk, jv = fn(jnp.asarray(NAN_BOXES), jnp.asarray(scores), 0.5, 4)
            np.testing.assert_array_equal(np.asarray(jk), want)
        keep, kv = nms_fixed_auto(t(NAN_BOXES), t(scores), 0.5, 4)
        assert keep.tolist() == want and kv.tolist() == [w >= 0 for w in want]
        other = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
        keep2, _ = pt_nms.nms_fixed(t(np.stack([NAN_BOXES] * 2)), t(np.stack([scores, other])), 0.5, 4)
        want_other, _ = jx_nms.nms_fixed(jnp.asarray(NAN_BOXES), jnp.asarray(other), 0.5, 4)
        assert keep2[0].tolist() == want
        np.testing.assert_array_equal(keep2[1].numpy(), np.asarray(want_other))

    def test_rpn_scale_row(self):
        """(1, 6000) -> 300 at 0.7, the RPN's call per image, against the
        JAX scan."""
        boxes, scores, valid = clustered_rows(np.random.default_rng(9), 1, 6000)
        keep, kv = nms_fixed_auto(t(boxes), t(scores), 0.7, 300, valid=t(valid))
        jk, jv = jx_nms.nms_fixed(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.7, 300,
                                  valid=jnp.asarray(valid[0]))
        np.testing.assert_array_equal(keep[0].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(kv[0].numpy(), np.asarray(jv))
        assert int(kv.sum()) == 300

    def test_retry_nms_shape(self):
        """3 rows of 300 -> 36 at 0.5 / 1.0 / 0.1 (the detection selection
        of one image), against nms_fixed and nms_fixed_blocked called
        directly."""
        boxes, scores, valid = clustered_rows(np.random.default_rng(10), 1, 300)
        thr = [0.5, 1.0, 0.1]
        keep, _ = nms_fixed_auto(t(np.repeat(boxes, 3, 0)), t(np.repeat(scores, 3, 0)),
                                 torch.tensor(thr), 36, valid=t(np.repeat(valid, 3, 0)))
        args = (jnp.asarray(boxes[0]), jnp.asarray(scores[0]))
        for i, th in enumerate(thr):
            for jk, _ in (jx_nms.nms_fixed(*args, th, 36, valid=jnp.asarray(valid[0])),
                          jx_nms.nms_fixed_blocked(*args, th, 36, valid=jnp.asarray(valid[0]), block=64)):
                np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))

    def test_bench_nms_replay_on_the_cpu(self):
        """tools.bench_nms --device cpu: its CPU replay of K2's word loop
        keeps what the plain version keeps on the smoke rows (it raises
        otherwise), and greedy's pair count is at most K2's."""
        from vltk_tpu_torch.tools import bench_nms

        out = bench_nms.main(["--device", "cpu", "--batch", "2"])
        for case in ("smoke rpn", "smoke detections"):
            assert 0 < out[case]["greedy_pairs"] <= out[case]["kernel_pairs"] < out[case]["mask_pairs"]
            assert out[case]["words"] > 0
        assert out["smoke rpn"]["last_keep_rank"][1] == -1  # the empty row
