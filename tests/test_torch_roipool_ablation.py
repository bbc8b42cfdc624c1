"""The RoIPool ablation variants of the port (plain versions, the CPU path
of the dispatchers) against ``tools/probe_roipool_ablation.py``'s Pallas
kernels in interpret mode, bitwise.

The probe is loaded by path; it sets two ``jax.config`` values when it is
imported, which are put back. Its four functions run at (2, 16, 20, 128) x
8 RoIs (W not a multiple of 8, H and W >= 14) with boxes that include a
zero-size box, boxes off the map, a box far larger than the map and one
wider than it in x only: the last two pin the bin-extent caps of the v2
and v3 windows. A copy of the map with NaN and -inf cells runs the RoIPool
modes (K8 and K9 at G = 4 among them) and the copies that keep raw values
(noP1, noP2). The JAX outputs are computed once per module.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vltk_tpu_torch.ops import roi_pool_ablation as plain
from vltk_tpu_torch.ops.roi_pool import roi_bin_edges, roi_pool_offsets
from vltk_tpu_torch.ops.roi_pool_ablation_kernel import (
    pool_auto,
    pool_contig_auto,
    pool_grouped_auto,
    pool_grouped_v3_auto,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 16, 20, 128)
N_BOX = 8
BF16_CASES = (("pool", "full"), ("pool", "v3"), ("pool", "noP2"), ("contig", "full"), ("grouped_v3", 4))


@pytest.fixture(scope="module")
def probe():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        spec = importlib.util.spec_from_file_location(
            "probe_roipool_ablation", os.path.join(REPO, "tools", "probe_roipool_ablation.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def make_case(dtype: str, nonfinite: bool = False):
    b, h, w, c = SHAPE
    rng = np.random.default_rng(42)
    feat = rng.standard_normal(SHAPE).astype(np.float32)
    if nonfinite:
        feat[0, 3, :, :4] = np.nan  # a row under 14, which every mode reads
        feat[1, 9, 11, 7] = np.nan
        feat[0, 6:9, 2:7] = -np.inf  # whole bins of -inf: written as 0 where the max is taken
        feat[1, :, 12] = -np.inf  # a column: noP2 copies -inf
        feat[0, 0, :14, 1] = -np.inf
        feat[1, 15, 19, 0] = np.inf
    xy = rng.uniform(0, [w * 16 - 2, h * 16 - 2], (b, N_BOX, 2))
    wh = rng.uniform(1, [w * 16, h * 16], (b, N_BOX, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w * 16 - 1, h * 16 - 1])], -1).astype(np.float32)
    boxes[0, 0] = [40, 40, 40, 40]  # zero size
    boxes[0, 1] = [-90, -90, -20, -20]  # off the map, top left
    boxes[0, 2] = [w * 16 + 100, 10, w * 16 + 300, 60]  # off the map, right
    boxes[0, 3] = [-1000, -1000, 3000, 3000]  # far larger than the map
    boxes[1, 0] = [-200, 20, 500, 200]  # wider than the map in x only
    boxes[1, 1] = [-40, -24, 30, 50]  # negative corners
    boxes[1, 2] = [7.5, 8, 23.5, 24]  # corners on the rounding half
    feat_j = jnp.asarray(feat, getattr(jnp, dtype))
    feat_t = torch.from_numpy(np.array(feat_j.astype(jnp.float32))).to(getattr(torch, dtype))
    return feat_j, feat_t, boxes


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def _torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same type, bit for bit."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(x))


def _jax_call(probe, fn, arg, feat_j, boxes):
    with pltpu.force_tpu_interpret_mode():
        if fn == "pool":
            out = probe.pool(feat_j, jnp.asarray(boxes), mode=arg)
        elif fn == "contig":
            out = probe.pool_contig(feat_j, jnp.asarray(boxes), mode=arg)
        elif fn == "grouped":
            out = probe.pool_grouped(feat_j, jnp.asarray(boxes), group=arg)
        else:
            out = probe.pool_grouped_v3(feat_j, jnp.asarray(boxes), group=arg)
        return _torch(jax.block_until_ready(out))


def _port_call(fn, arg, feat_t, boxes):
    bx = torch.from_numpy(boxes)
    if fn == "pool":
        return pool_auto(feat_t, bx, mode=arg)
    if fn == "contig":
        return pool_contig_auto(feat_t, bx, mode=arg)
    if fn == "grouped":
        return pool_grouped_auto(feat_t, bx, group=arg)
    return pool_grouped_v3_auto(feat_t, bx, group=arg)


F32_CASES = (
    [("pool", m) for m in plain.POOL_MODES]
    + [("contig", m) for m in plain.CONTIG_MODES]
    + [("grouped", g) for g in (4, 8)]
    + [("grouped_v3", g) for g in (4, 8)]
)


@pytest.fixture(scope="module")
def jax_outputs(probe):
    out = {}
    for dtype, cases in (("float32", F32_CASES), ("bfloat16", BF16_CASES)):
        feat_j, _, boxes = make_case(dtype)
        for fn, arg in cases:
            out[(dtype, fn, arg)] = _jax_call(probe, fn, arg, feat_j, boxes)
    return out


@pytest.mark.parametrize("fn,arg", F32_CASES)
def test_f32_bitwise_equal_to_pallas(jax_outputs, fn, arg):
    _, feat_t, boxes = make_case("float32")
    want = jax_outputs[("float32", fn, arg)]
    counts = [f.launches for f in (pool_auto, pool_contig_auto, pool_grouped_auto, pool_grouped_v3_auto)]
    got = _port_call(fn, arg, feat_t, boxes)
    assert counts == [f.launches for f in (pool_auto, pool_contig_auto, pool_grouped_auto, pool_grouped_v3_auto)]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn,arg", BF16_CASES)
def test_bf16_bitwise_equal_to_pallas(jax_outputs, fn, arg):
    _, feat_t, boxes = make_case("bfloat16")
    want = jax_outputs[("bfloat16", fn, arg)]
    got = _port_call(fn, arg, feat_t, boxes)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


NONFINITE_CASES = (
    [("pool", m) for m in ("full", "v3", "noP1", "noP2")]
    + [("contig", m) for m in ("full", "stackwrite")]
    + [("grouped", 4), ("grouped_v3", 4)]
)


@pytest.fixture(scope="module")
def jax_nonfinite(probe):
    out = {}
    for dtype in ("float32", "bfloat16"):
        feat_j, _, boxes = make_case(dtype, nonfinite=True)
        for fn, mode in NONFINITE_CASES:
            out[(dtype, fn, mode)] = _jax_call(probe, fn, mode, feat_j, boxes)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn,mode", NONFINITE_CASES)
def test_nonfinite_cells_match_pallas(jax_nonfinite, dtype, fn, mode):
    """On a map with NaN and -inf cells the plain versions equal the Pallas
    kernels: NaN in the same places, every other value bitwise (so the same
    -inf cells, and 0 where a bin's max is -inf)."""
    _, feat_t, boxes = make_case(dtype, nonfinite=True)
    want = jax_nonfinite[(dtype, fn, mode)]
    got = _port_call(fn, mode, feat_t, boxes)
    nan = torch.isnan(want.float())
    assert got.dtype == feat_t.dtype and got.shape == want.shape
    assert bool(nan.any()) and torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    if mode == "noP2":
        assert bool((got == float("-inf")).any())


def test_noP2_keeps_the_raw_sentinel_of_an_empty_row_bin(jax_outputs):
    """Boxes off the map have empty row bins: noP2 writes -1e30 rounded to
    the features' type there (no 0 substitution), as Pallas does."""
    for dtype in ("float32", "bfloat16"):
        got = jax_outputs[(dtype, "pool", "noP2")][0, 1]  # the box above and left of the map
        neg = plain.neg_value(getattr(torch, dtype))
        assert torch.equal(_bits(got), _bits(neg.expand_as(got)))


def test_caps_pin_the_reference_bin_extents():
    """RoIPool modes equal exact RoIPool on boxes within the map plus one
    cell, and differ from it on a box far larger than the map; the box
    wider than the map in x only is exact under the v3 window, not v2."""
    _, feat_t, boxes = make_case("float32")
    exact = roi_pool_offsets(feat_t, torch.from_numpy(boxes), 14, 1 / 16)
    v2 = plain.pool(feat_t, torch.from_numpy(boxes), "full")
    v3 = plain.pool(feat_t, torch.from_numpy(boxes), "v3")
    inside = torch.ones(2, N_BOX, dtype=torch.bool)
    inside[0, 3] = inside[1, 0] = False
    assert torch.equal(v2[inside], exact[inside]) and torch.equal(v3[inside], exact[inside])
    assert not torch.equal(v2[0, 3], exact[0, 3]) and not torch.equal(v3[0, 3], exact[0, 3])
    assert torch.equal(v3[1, 0], exact[1, 0]) and not torch.equal(v2[1, 0], exact[1, 0])


def test_v3_window_at_a_map_width_multiple_of_8():
    """W = 24: an empty right-edge bin has ws == W, where the Pallas v3
    window would read past its scratch. The port returns RoIPool (0 for
    the empty bin), equal to exact RoIPool for boxes inside the map."""
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((1, 16, 24, 8)).astype(np.float32))
    boxes = torch.tensor([[[320.0, 16.0, 640.0, 200.0], [0.0, 0.0, 383.0, 255.0], [100.0, 50.0, 300.0, 90.0]]])
    hs, he, ws, we = roi_bin_edges(boxes, 1 / 16, 16, 24, 14)
    assert int(ws[0, 0, -1]) == 24 and int(we[0, 0, -1]) == 24
    want = roi_pool_offsets(feat, boxes, 14, 1 / 16)
    for got in (plain.pool(feat, boxes, "v3"), plain.pool_grouped_v3(feat, boxes, group=3)):
        assert torch.equal(got, want)
    assert bool((want[0, 0, :, -1] == 0).all())


def test_contig_layout_round_trip():
    _, feat_t, boxes = make_case("float32")
    bx = torch.from_numpy(boxes)
    full = plain.pool(feat_t, bx, "full")
    contig = plain.pool_contig(feat_t, bx, "stackwrite", cb=32)
    assert contig.shape == (2, 4, N_BOX, 14, 14, 32)
    assert torch.equal(plain.from_contig(contig), full)
    assert torch.equal(plain.to_contig(full, 32), contig)


@pytest.mark.parametrize(
    "call",
    [
        lambda f, b: plain.pool_grouped(f, b, group=3),  # P = 8 not a multiple of G
        lambda f, b: plain.pool_grouped_v3(f, b, group=5),
        lambda f, b: plain.pool_contig(f, b, "full", cb=48),  # C = 128 not a multiple of cb
        lambda f, b: plain.pool(f[:, :13], b, "noP1"),  # H < 14
        lambda f, b: plain.pool(f[:, :, :13], b, "noP2"),  # W < 14
        lambda f, b: plain.pool(f[:, :13], b, "noBoth"),
        lambda f, b: plain.pool(f, b, "p1only"),  # a mode of another variant
        lambda f, b: plain.pool_contig(f, b, "v3"),
        lambda f, b: pool_grouped_auto(f, b, group=3),
    ],
)
def test_undefined_cases_raise(call):
    _, feat_t, boxes = make_case("float32")
    with pytest.raises(ValueError):
        call(feat_t, torch.from_numpy(boxes))


def test_modes_that_need_no_row_or_column_below_14_run_on_small_maps():
    feat = torch.randn(1, 5, 6, 4)
    boxes = torch.tensor([[[0.0, 0.0, 90.0, 70.0]]])
    assert torch.equal(plain.pool(feat, boxes, "full"), roi_pool_offsets(feat, boxes, 14, 1 / 16))
    assert plain.pool(feat[:, :, :], torch.zeros(1, 1, 4), "v3").shape == (1, 1, 14, 14, 4)


# ------------------------------------------------------------ entry points


def test_probe_runs_the_plain_versions_on_the_cpu(capsys):
    """``--device cpu`` at a small size: every variant runs, the RoIPool
    ones equal K1's plain version, and the last line is the JSON summary."""
    from vltk_tpu_torch.tools import probe_roipool_ablation as probe

    rows = probe.main(["--device", "cpu", "--b", "1", "--h", "16", "--w", "20", "--c", "24", "--p", "12",
                       "--iters", "1"])
    labels = [r["variant"] for r in rows]
    assert labels[0] == "shipped" and len(labels) == 1 + 5 + 4 + 4
    for r in rows:
        assert r["device"] == "cpu" and r["ms"] > 0
        assert r["same_as_shipped"] is (True if r["variant"] in probe.ROIPOOL + ("shipped",) else None)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"shape": [1, 16, 20, 24, 12]')


def test_probe_inputs_follow_the_jax_recipe():
    """The boxes of ``make_inputs`` are the JAX probe's draws from
    ``default_rng(0)`` after the features."""
    from vltk_tpu_torch.tools.probe_roipool_ablation import make_inputs

    feat, boxes = make_inputs(2, 16, 20, 8, 5, "cpu")
    rng = np.random.default_rng(0)
    want_feat = rng.standard_normal((2, 16, 20, 8))
    x1 = rng.uniform(0, 20 * 16 - 2, (2, 5))
    y1 = rng.uniform(0, 16 * 16 - 2, (2, 5))
    assert feat.dtype == torch.bfloat16
    np.testing.assert_array_equal(feat.float().numpy(), torch.from_numpy(want_feat.astype(np.float32)).bfloat16().float().numpy())
    np.testing.assert_array_equal(boxes[..., 0].numpy(), x1.astype(np.float32))
    np.testing.assert_array_equal(boxes[..., 1].numpy(), y1.astype(np.float32))
    assert bool((boxes[..., 2] <= 20 * 16 - 1).all() and (boxes[..., 3] <= 16 * 16 - 1).all())


def test_bench_times_the_plain_version_on_the_cpu():
    from vltk_tpu_torch.tools import bench_roipool

    small = ["--device", "cpu", "--b", "1", "--h", "16", "--w", "20", "--c", "8", "--p", "4", "--iters", "1"]
    assert set(bench_roipool.main(small + ["--kernels", "plain"])) == {"plain"}
    with pytest.raises(SystemExit):
        bench_roipool.main(small + ["--kernels", "xla"])
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        bench_roipool.main(small + ["--kernels", "cuda"])


def test_bench_parses_k1_block_shapes():
    """``--shapes`` takes K1's digits "bb u t": column bins 01-14, nonzero
    unroll and thread count; the order of the maxima is not a digit."""
    from vltk_tpu_torch.tools import bench_roipool

    assert bench_roipool.parse_shapes("222,1411,0111") == [222, 1411, 111]
    for bad in ("22", "1522", "202", "220", "10222"):
        with pytest.raises(ValueError):
            bench_roipool.parse_shapes(bad)


def test_ablation_kernels_pick_their_path_from_c_cb_and_alignment():
    """K6 and K7 take 16-byte vectors where C (and K7's cb) hold whole
    vectors, 8 bf16 or 4 float32 channels, and the base is aligned."""
    from vltk_tpu_torch.ops.roi_pool_ablation_kernel import kernel_path
    from vltk_tpu_torch.tools.variants import unaligned

    bf16 = torch.zeros(1, 4, 4, 72, dtype=torch.bfloat16)
    assert kernel_path(bf16) == kernel_path(bf16, 8) == kernel_path(bf16, 72) == "vector"
    assert kernel_path(bf16, 6) == kernel_path(bf16, 4) == kernel_path(unaligned(bf16)) == "scalar"
    f32 = torch.zeros(1, 4, 4, 12)
    assert kernel_path(f32) == kernel_path(f32, 4) == "vector"
    assert kernel_path(f32, 6) == kernel_path(torch.zeros(1, 4, 4, 9)) == "scalar"


def test_ablation_sweep_parses_its_builds_and_needs_the_card(monkeypatch):
    from vltk_tpu_torch.tools import sweep_roipool_ablation as sweep

    assert sweep.parse_slabs("0,256,128") == [0, 256, 128]
    with pytest.raises(ValueError):
        sweep.parse_slabs("256,-1")
    assert sweep.parse_blocks("0,1,9") == [0, 1, 9]
    with pytest.raises(ValueError):
        sweep.parse_blocks("1,-1")
    with pytest.raises(ValueError):
        sweep.main(["--shapes", "1522"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        sweep.main(["--shapes", "221", "--slabs", "0,256"])


def test_unaligned_copy_takes_the_scalar_path():
    """``tools.variants.unaligned`` keeps the values and moves the base off
    the 16-byte boundary, which sends RoIPool to its scalar path."""
    from vltk_tpu_torch.ops.roi_pool_kernel import kernel_path
    from vltk_tpu_torch.tools.variants import unaligned

    feat = torch.randn(2, 5, 6, 16).to(torch.bfloat16)
    moved = unaligned(feat)
    assert torch.equal(moved, feat) and moved.data_ptr() % 16 != 0
    assert kernel_path(feat.clone()) == "vector" and kernel_path(moved) == "scalar"
