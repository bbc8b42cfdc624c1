"""K10's tiles on the CPU: the planner of the RoIPool backward kernel and a
plain-torch emulation of its tiled sum, held against the plain VJP and JAX.

K10 (``csrc/roi_pool_bwd.cu``) runs one block a tile of the gradient: one
image, a slab of channels and a band of map rows, as
``ops/roi_pool_kernel.py:plan_backward`` plans them. A tile walks every bin
one of whose two row windows (the table's lookups) meets its band, and adds
into its own cells only. The kernel runs on the card alone; here the
planner's tiles are checked to cover every cell once within the
shared-memory budget, and ``tiled_vjp`` (below: nothing on the port's path
uses it) sums the plain VJP tile by tile as K10 does, clipped to each
tile's cells, in float32, cast once. Which bins a band walks is the
kernel's rule (``Bin::meets``), copied here as ``bins_of_band`` and held
against the windows' rows enumerated one by one. On dyadic cotangents
(small integers times 2^-4, exact in any order) the emulation must equal
``roi_pool_plain_vjp`` bitwise, and ``jax.vjp`` through ``_roi_pool_xla``
in float32, with bands cut small (one and three rows; three and seven on
the parity map) so that bins straddle them. This file checks the copy;
the kernel's own rule is held on the card by ``tests/test_torch_kernels.py``
(``cuda``), whose cases with a forced small budget
(``test_roi_pool_backward_bands_and_l2``) split bins across bands and
compare the kernel with the plain VJP bitwise.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from test_torch_detection import VJP_CASES, jax_vjp, t, vjp_case
from vltk_tpu_torch.ops.roi_pool import roi_bin_edges, roi_pool_plain_vjp, table_levels
from vltk_tpu_torch.ops.roi_pool_kernel import BACKWARD_PATHS, MAX_TABLE_BIN, SMEM_BUDGET, plan_backward
from vltk_tpu_torch.tools import bench_roipool_bwd

DTYPES = [torch.float32, torch.bfloat16]
# the parity map, the 1344 x 1344 canvas's map, the largest map the masks
# allow at 14 x 14 bins, tiny odd maps
PLANNER_MAPS = [(52, 84), (84, 84), (195, 195), (1, 1), (3, 5), (7, 3), (13, 21)]
# C a multiple of the 16-byte vector in both types, of float32's only, of
# neither, and the production width
PLANNER_CHANNELS = [8, 12, 3, 1024]
# random cotangents: float32 sums in another order, within ~n eps of the
# sum of the terms' magnitudes; bf16 adds one rounding of the cast (the
# bound chip_smoke.py and the card tests hold K10 to)
SUM_TOL = 1e-5
CAST_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def _feat_bytes(h, w, v, dtype):
    return (h * w * v * torch.empty((), dtype=dtype).element_size() + 15) // 16 * 16


def band(plan, k):
    """Rows [r0, r1) of the plan's band ``k`` (the last may end past the
    map)."""
    r0 = k * plan.band_rows
    return r0, r0 + plan.band_rows


def lookup_rows(extent: torch.Tensor, max_bin: int) -> torch.Tensor:
    """2^kh: the rows (or columns) of a bin's table lookups, for bins of
    ``extent`` cells (1 for an empty bin)."""
    return 2 ** torch.floor(torch.log2(extent.clamp(1, max_bin).double())).to(extent.dtype)


def bins_of_band(plan, k, hstart: torch.Tensor, hend: torch.Tensor, max_bin_h: int) -> torch.Tensor:
    """The bins (by their row edges) that a tile of band ``k`` walks: the
    non-empty ones either of whose two row windows (JAX's lookups, 2^kh
    rows from ``hstart`` and 2^kh ending at ``hend``) meets the band. A
    copy of K10's ``Bin::meets``."""
    r0, r1 = band(plan, k)
    n = lookup_rows(hend - hstart, max_bin_h)
    return (hend > hstart) & (((hstart < r1) & (hstart + n > r0)) | ((hend - n < r1) & (hend > r0)))


def _covered_once(plan, h, c) -> bool:
    """Every cell in exactly one tile. The tiles are the product of the row
    bands and the channel slabs (every band spans all columns), so a cell is
    covered once exactly when its row is in one band and its channel in one
    slab."""
    rows, channels = torch.zeros(h, dtype=torch.int32), torch.zeros(c, dtype=torch.int32)
    for k in range(plan.bands):
        r0, r1 = band(plan, k)
        assert r0 < h, "an empty band"
        rows[r0:r1] += 1
    for s in range(plan.slabs):
        channels[s * plan.v:(s + 1) * plan.v] += 1
    return bool((rows == 1).all() and (channels == 1).all())


def _row_budget(h, w, c, dtype, rows):
    """A shared-memory budget that leaves room for ``rows`` rows of sums a
    tile (with the features read through L2)."""
    v = plan_backward(h, w, c, dtype).v
    return rows * w * v * 4


class TestPlanner:
    @pytest.mark.parametrize("c", PLANNER_CHANNELS)
    @pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("hw", PLANNER_MAPS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
    def test_tiles_cover_every_cell_once_within_the_budget(self, hw, dtype, c):
        h, w = hw
        plan = plan_backward(h, w, c, dtype)
        assert plan.path in BACKWARD_PATHS
        assert _covered_once(plan, h, c)
        per_vector = 16 // torch.empty((), dtype=dtype).element_size()
        assert plan.v == (per_vector if c % per_vector == 0 else 1)
        assert plan.path.startswith("vector" if plan.v > 1 else "scalar")
        sums = plan.band_rows * w * plan.v * 4
        assert plan.smem_bytes == (_feat_bytes(h, w, plan.v, dtype) if plan.staged else 0) + sums
        assert plan.smem_bytes <= SMEM_BUDGET
        assert plan.path.endswith("_l2") != plan.staged
        assert plan.path.endswith("_banded") == (plan.staged and plan.bands > 1)

    @pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
    def test_unaligned_features_take_the_scalar_path(self, dtype):
        plan = plan_backward(52, 84, 1024, dtype, aligned=False)
        assert plan.path == "scalar" and plan.v == 1 and plan.slabs == 1024

    def test_the_main_maps_paths(self):
        """The training step's map keeps the slab and its sums in one tile
        (bf16: 70 KB of features, 140 KB of sums); the 1344 x 1344 canvas's
        84 x 84 map takes two bands in bf16, one in float32; the largest
        map reads its features through L2."""
        bf16 = plan_backward(52, 84, 1024, torch.bfloat16)
        assert (bf16.path, bf16.v, bf16.slabs, bf16.bands, bf16.smem_bytes) == ("vector", 8, 128, 1, 209664)
        big = plan_backward(84, 84, 1024, torch.bfloat16)
        assert (big.path, big.bands, big.band_rows) == ("vector_banded", 2, 42)
        assert plan_backward(84, 84, 1024, torch.float32).path == "vector"
        assert plan_backward(195, 195, 1024, torch.bfloat16).path == "vector_l2"
        assert plan_backward(195, 195, 3, torch.float32).path == "scalar_l2"

    def test_the_largest_map_is_the_masks(self):
        """195 x 195 is the largest map whose bins at 14 x 14 fit the
        15-cell masks; the wrapper refuses the next."""
        assert max(table_levels(195, 195, 14)[:2]) == MAX_TABLE_BIN
        assert max(table_levels(196, 196, 14)[:2]) > MAX_TABLE_BIN

    @pytest.mark.parametrize("rows", [1, 3, 7])
    @pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
    def test_small_budgets_band_the_map(self, dtype, rows):
        h, w, c = 20, 24, 16
        budget = _row_budget(h, w, c, dtype, rows)
        plan = plan_backward(h, w, c, dtype, budget=budget)
        assert plan.path == "vector_l2" and plan.smem_bytes <= budget
        assert plan.bands == math.ceil(h / rows) and plan.band_rows == math.ceil(h / plan.bands)
        assert _covered_once(plan, h, c)
        staged = plan_backward(h, w, c, dtype, budget=2 * _feat_bytes(h, w, 8, torch.bfloat16))
        assert _covered_once(staged, h, c)

    def test_a_budget_too_small_for_one_row_raises(self):
        with pytest.raises(ValueError, match="fits"):
            plan_backward(20, 24, 16, torch.float32, budget=100)


def _windows(hs, he, max_bin):
    """The rows of a bin's two row windows, enumerated."""
    n = 2 ** int(math.floor(math.log2(min(he - hs, max_bin))))
    return set(range(hs, hs + n)) | set(range(he - n, he))


def _case_edges(case):
    feat, boxes, s = vjp_case(case)
    h, w = feat.shape[1:3]
    hs, he, _, _ = roi_bin_edges(t(boxes), 1 / 16, h, w, s)
    return feat, boxes, s, hs, he, table_levels(h, w, s)[0]


class TestBins:
    @pytest.mark.parametrize("case", VJP_CASES)
    def test_lookup_rows(self, case):
        _, _, _, hs, he, max_bin = _case_edges(case)
        n = lookup_rows(he - hs, max_bin)
        for x, got in zip((he - hs).flatten().tolist(), n.flatten().tolist()):
            assert got == 2 ** int(math.floor(math.log2(min(max(x, 1), max_bin))))

    @pytest.mark.parametrize("rows", [1, 3])
    @pytest.mark.parametrize("case", VJP_CASES)
    def test_each_bin_goes_to_every_band_a_window_meets(self, case, rows):
        """Bins past the table included: their two windows sit at the bin's
        two ends, and a band between them is not walked."""
        feat, _, _, hs, he, max_bin = _case_edges(case)
        h, w, c = feat.shape[1:]
        plan = plan_backward(h, w, c, torch.float32, budget=_row_budget(h, w, c, torch.float32, rows))
        assigned = torch.stack([bins_of_band(plan, k, hs, he, max_bin) for k in range(plan.bands)], -1)
        for (a, b_), got in zip(zip(hs.flatten().tolist(), he.flatten().tolist()),
                                assigned.reshape(-1, plan.bands).tolist()):
            met = [False] * plan.bands
            if b_ > a:
                for r in _windows(a, b_, max_bin):
                    met[r // plan.band_rows] = True
            assert got == met

    def test_bins_past_the_table_skip_the_bands_between_their_windows(self):
        feat, _, _, hs, he, max_bin = _case_edges("bins_past_the_table")
        h, w, c = feat.shape[1:]
        plan = plan_backward(h, w, c, torch.float32, budget=_row_budget(h, w, c, torch.float32, 1))
        past = (he - hs) > 2 * lookup_rows(he - hs, max_bin)
        assert bool(past.any())
        i = past.flatten().nonzero()[0].item()
        a, b_ = hs.flatten()[i].item(), he.flatten()[i].item()
        walked = [bins_of_band(plan, k, hs, he, max_bin).flatten()[i].item() for k in range(plan.bands)]
        assert walked == [r in _windows(a, b_, max_bin) for r in range(plan.bands)]
        assert not all(walked[a:b_])


def tiled_vjp(features, boxes, g, output_size, spatial_scale, plan):
    """K10's sum emulated tile by tile: each tile (image, slab, band) takes
    the plain VJP in float32 of the bins the plan gives its band (the
    others' cotangents zeroed), on its slab's channels, and keeps its own
    cells; every cell is one tile's. The gradient is the tiles' float32
    sums, cast once to the features' dtype."""
    b, h, w, c = features.shape
    hs, he, _, _ = roi_bin_edges(boxes, spatial_scale, h, w, output_size)
    max_bin_h = table_levels(h, w, output_size)[0]
    f32, g32 = features.float(), g.float()
    out = torch.zeros(b, h, w, c, dtype=torch.float32)
    for k in range(plan.bands):
        r0, r1 = band(plan, k)
        walked = bins_of_band(plan, k, hs, he, max_bin_h)[..., :, None, None]  # bin (i, j): by its rows
        # the band's bins on every channel at once: channels never mix, so
        # each slab's tile is its channels of this sum
        part = roi_pool_plain_vjp(f32, boxes, torch.where(walked, g32, torch.zeros(())), output_size, spatial_scale)
        for s in range(plan.slabs):
            ch = slice(s * plan.v, (s + 1) * plan.v)
            out[:, r0:r1, :, ch] = part[:, r0:r1, :, ch]
    return out.to(features.dtype)


def _dyadic(boxes, s, c, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (*boxes.shape[:2], s, s, c)) / 16).astype(np.float32)


def _banded_plan(feat, dtype, rows):
    h, w, c = feat.shape[1:]
    plan = plan_backward(h, w, c, dtype, budget=_row_budget(h, w, c, dtype, rows))
    assert plan.band_rows <= rows
    return plan


# (case, rows of a band): 1 and 3 on the small maps; the parity map's bins
# span up to 5 rows, so 3- and 7-row bands split them too
BAND_CUTS = [(case, rows) for case in VJP_CASES for rows in ((3, 7) if case == "parity_geometry" else (1, 3))]


class TestTiledSum:
    @pytest.mark.parametrize("case,rows", BAND_CUTS)
    def test_dyadic_f32_equals_the_plain_vjp_and_jax(self, case, rows):
        feat, boxes, s = vjp_case(case)
        g = _dyadic(boxes, s, feat.shape[-1])
        plan = _banded_plan(feat, torch.float32, rows)
        got = tiled_vjp(t(feat), t(boxes), t(g), s, 1 / 16, plan)
        want = roi_pool_plain_vjp(t(feat), t(boxes), t(g), s, 1 / 16)
        assert torch.equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(got.numpy(), jax_vjp(feat, boxes, g, s))

    @pytest.mark.parametrize("case,rows", BAND_CUTS)
    def test_dyadic_bf16_equals_the_plain_vjp(self, case, rows):
        """bf16 features and cotangent: one cast of the float32 sums, as
        the plain VJP (JAX sums bf16 in bf16: not compared here)."""
        feat, boxes, s = vjp_case(case)
        fb = t(feat).to(torch.bfloat16)
        gb = t(_dyadic(boxes, s, feat.shape[-1], seed=4)).to(torch.bfloat16)
        plan = _banded_plan(feat, torch.bfloat16, rows)
        got = tiled_vjp(fb, t(boxes), gb, s, 1 / 16, plan)
        want = roi_pool_plain_vjp(fb, t(boxes), gb, s, 1 / 16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(_bits(got), _bits(want))

    def test_bins_straddle_the_bands(self):
        """The band cuts of these tests split bins: bins of the parity
        geometry span two 3-row bands and two 7-row bands, and those tiles
        alone sum them."""
        feat, _, _, hs, he, max_bin = _case_edges("parity_geometry")
        for rows in (3, 7):
            plan = _banded_plan(feat, torch.float32, rows)
            walked = torch.stack([bins_of_band(plan, k, hs, he, max_bin) for k in range(plan.bands)]).sum(0)
            assert int(walked.max()) >= 2

    @pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("case", VJP_CASES)
    def test_random_cotangents_within_the_bound(self, case, dtype):
        feat, boxes, s = vjp_case(case)
        g = np.random.default_rng(2).standard_normal((*boxes.shape[:2], s, s, feat.shape[-1])).astype(np.float32)
        f, gg = t(feat).to(dtype), t(g).to(dtype)
        got = tiled_vjp(f, t(boxes), gg, s, 1 / 16, _banded_plan(feat, dtype, 3)).float()
        want = roi_pool_plain_vjp(f, t(boxes), gg, s, 1 / 16).float()
        magnitude = roi_pool_plain_vjp(f, t(boxes), gg.abs(), s, 1 / 16).float()
        assert bool(((got - want).abs() <= SUM_TOL * magnitude + CAST_RTOL[dtype] * want.abs()).all())

    def test_the_training_maps_tiles_on_a_small_slab(self):
        """The parity map with the planner's own tiles (no forced budget)
        at a few channels: one band, slabs of 8 bf16 channels."""
        feat, boxes, s = vjp_case("parity_geometry")
        feat = np.repeat(feat, 8, axis=-1)
        g = _dyadic(boxes, s, 16)
        fb, gb = t(feat).to(torch.bfloat16), t(g).to(torch.bfloat16)
        plan = plan_backward(52, 84, 16, torch.bfloat16)
        assert (plan.path, plan.slabs, plan.bands) == ("vector", 2, 1)
        got = tiled_vjp(fb, t(boxes), gb, s, 1 / 16, plan)
        assert torch.equal(_bits(got), _bits(roi_pool_plain_vjp(fb, t(boxes), gb, s, 1 / 16)))


class TestBenchTool:
    @pytest.mark.parametrize("name", list(bench_roipool_bwd.ABLATIONS))
    def test_ablations_edit_the_shipped_source(self, name, tmp_path, monkeypatch):
        """Each ``--ablate`` copy finds its text in ``csrc/roi_pool_bwd.cu``
        and changes it."""
        monkeypatch.setattr(bench_roipool_bwd, "SWEEP_DIR", str(tmp_path))
        with open(bench_roipool_bwd.ablated(name)) as f:
            edited = f.read()
        for old, new in bench_roipool_bwd.ABLATIONS[name]:
            assert old not in edited and (not new or new in edited)
