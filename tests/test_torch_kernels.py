"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a CUDA device. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_kernels.py

They sweep shapes that ``chip_smoke.py`` (which checks the main paths'
shapes) does not: channel counts that are not a multiple of the block,
candidate counts around the 64-bit mask words, budgets larger than the
candidate count, rows with no candidate, every cluster size K2 takes
(one thread-block cluster a row) at the RPN shape and at K = 64 * CL +- 1,
each of its two sort paths and the row length beyond them that it refuses,
a sweep to the last candidate, negative thresholds, identical boxes, NaN
coordinates and scores, one launch a call; sequence lengths around the
64-key tile and the 128 pad block, padded rows down to length 1, masks
whose whole key tiles K3 skips, its statistics and its determinism; for the
backward kernels K5 and K4 also masks whose whole 64-row tiles share no id
(the tiles the kernels skip), masks of the span-QA stream
``[question | pad | OCR | pad]`` (a pad hole in mid-stream), K5's fused di, strided output gradients,
determinism, and the gradients that a training step on the card hands the
q/k/v projections; K1 and K10 under autograd, both of K1's paths
(16-byte vectors and one element a thread), bins wider than its unrolled
group, an unaligned base, NaN and infinite cells; K10 bitwise against the
plain VJP on dyadic cotangents (ties, NaN, empty and clipped bins, C not a
multiple of the warp or of a 16-byte vector, the 84 x 84 map, every path
its planner takes: row bands and features read through L2, also forced by
a small shared-memory budget), twice, with a stated tolerance on random
ones, its shared memory against the planner's, and its refusal of bins
past its mask;
for the RoIPool ablation kernels K6-K9 every mode in both types on maps
whose width is and is not a multiple of 8, channel counts that are not a
multiple of the kernel's chunk, and groups of RoIs; K6 and K7 on both of
their paths (16-byte vectors and one element a thread), with NaN and -inf
cells, and their per-path launch counts; the int8 products of the int8
presets (``torch._int_mm`` behind ``ops/int8.py``, not a kernel of this
package) bitwise against the exact route, with M <= 16 and K, N off a
multiple of 8, and the quantize's NaN -> 0 on the card.
"""

import functools

import pytest
import torch

from vltk_tpu_torch.ops.flash_attention import (
    flash_self_attention,
    flash_self_attention_backward,
    flash_self_attention_fwd_residuals,
)
from vltk_tpu_torch.ops.flash_attention_kernel import (
    flash_attention_auto,
    flash_attention_backward_cuda,
    flash_attention_cuda,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
    flash_attention_fwd_residuals_cuda,
)
from vltk_tpu_torch.ops.nms import nms_fixed
from vltk_tpu_torch.ops.nms_kernel import CLUSTERS, MAX_CANDIDATES, nms_fixed_auto, nms_fixed_cuda
from vltk_tpu_torch.ops import roi_pool_ablation as ablation
from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets, roi_pool_plain_vjp
from vltk_tpu_torch.ops.roi_pool_ablation_kernel import (
    build_table_cuda,
    pool_auto,
    pool_contig_auto,
    pool_contig_cuda,
    pool_cuda,
    pool_grouped_auto,
    pool_grouped_cuda,
    pool_grouped_v3_auto,
    pool_grouped_v3_cuda,
)
from vltk_tpu_torch.ops.roi_pool_kernel import (
    SMEM_BUDGET,
    plan_backward,
    roi_pool_auto,
    roi_pool_backward_auto,
    roi_pool_backward_cuda,
    roi_pool_cuda,
)
from vltk_tpu_torch.tools.bench_nms import nms_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype])


def _boxes(gen, b, p, h, w):
    xy = torch.rand(b, p, 2, generator=gen) * torch.tensor([w * 16.0, h * 16.0]) * 1.2 - 20
    wh = torch.rand(b, p, 2, generator=gen) * torch.tensor([w * 16.0, h * 16.0])
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[0, 0] = torch.tensor([8.0, 8.0, 8.0, 8.0])  # zero size on a half
    return boxes


def _expected_path(x: torch.Tensor) -> str:
    """The K1 path for contiguous features: 16-byte vectors where C is a
    multiple of 8 bf16 or 4 float32 channels and the base is aligned."""
    per_vector = 16 // x.element_size()
    return "vector" if x.shape[-1] % per_vector == 0 and x.data_ptr() % 16 == 0 else "scalar"


def _roi_pool_checked(feat, boxes, s):
    """K1 on the inputs: bitwise equal to the plain version, through the
    path that C and the alignment pick (counted on the wrapper)."""
    path = _expected_path(feat)
    before = dict(roi_pool_auto.path_launches)
    got = roi_pool_cuda(feat, boxes, s, 1 / 16)
    torch.cuda.synchronize()
    after = roi_pool_auto.path_launches
    assert {k: after[k] - before[k] for k in after} == {k: int(k == path) for k in after}
    want = roi_pool_offsets(feat, boxes, s, 1 / 16)
    assert got.shape == want.shape == (*boxes.shape[:2], s, s, feat.shape[-1])
    assert torch.equal(_bits(got), _bits(want))
    return got, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,w,c,p,s",
    [(1, 5, 7, 3, 4, 2), (2, 20, 24, 8, 6, 7), (3, 52, 84, 300, 50, 14), (1, 16, 16, 513, 9, 14),
     (2, 52, 84, 1024, 40, 14), (1, 20, 24, 2048, 8, 7)],
)
def test_roi_pool_kernel_bitwise(dev, dtype, b, h, w, c, p, s):
    """Bitwise equal to the plain version (max is exact in both types), on
    the vector path (C a multiple of 16 bytes' worth) and the scalar one."""
    gen = torch.Generator().manual_seed(b * 1000 + c)
    feat = torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
    boxes = _boxes(gen, b, p, h, w).to(dev)
    _roi_pool_checked(feat, boxes, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [7, 14])
def test_roi_pool_bins_wider_than_the_unroll(dev, dtype, s):
    """Boxes that span a (1, 200, 240, 64) map: bins of up to 36 columns
    and 30 rows, far past the kernel's unrolled group of columns."""
    gen = torch.Generator().manual_seed(s)
    feat = torch.randn(1, 200, 240, 64, generator=gen).to(dev, dtype)
    boxes = torch.tensor([[[0.0, 0.0, 240 * 16 - 1, 200 * 16 - 1], [-300.0, -100.0, 240 * 16 + 500, 200 * 16 + 50],
                           [100.0, 50.0, 3000.0, 3100.0], [16.0, 1600.0, 3800.0, 1700.0]]])
    _, path = _roi_pool_checked(feat, boxes.to(dev), s)
    assert path == "vector"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_pool_unaligned_base_takes_the_scalar_path(dev, dtype):
    """A view one element into its storage is not 16-byte aligned: the
    scalar path, bitwise equal to the plain version and to the vector
    path on an aligned copy."""
    gen = torch.Generator().manual_seed(3)
    b, h, w, c = 2, 52, 84, 256
    flat = torch.randn(b * h * w * c + 1, generator=gen).to(dev, dtype)
    feat = flat[1:].view(b, h, w, c)
    boxes = _boxes(gen, b, 30, h, w).to(dev)
    got, path = _roi_pool_checked(feat, boxes, 14)
    assert path == "scalar"
    aligned, path = _roi_pool_checked(feat.clone(), boxes, 14)
    assert path == "vector" and torch.equal(_bits(got), _bits(aligned))


def test_roi_pool_b16_step_shape(dev):
    """One of the two launches of the B=16 extraction step: (16, 52, 84,
    1024) bf16 x 150 RoIs, on the vector path."""
    gen = torch.Generator().manual_seed(16)
    feat = torch.relu(torch.randn(16, 52, 84, 1024, generator=gen)).to(dev, torch.bfloat16)
    boxes = _boxes(gen, 16, 150, 52, 84).to(dev)
    _, path = _roi_pool_checked(feat, boxes, 14)
    assert path == "vector"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 300])
def test_roi_pool_nonfinite_cells(dev, dtype, c):
    """NaN, +inf and -inf cells, and a corner of -inf that one box covers
    alone: NaN in the same places as the plain version, bitwise equal
    everywhere else; two calls bitwise equal."""
    gen = torch.Generator().manual_seed(c)
    b, h, w, p = 2, 52, 84, 40
    feat = torch.randn(b, h, w, c, generator=gen)
    feat[0, 10, 20, : c // 2] = float("nan")
    feat[1, 30, 40, 7] = float("nan")
    feat[0, 30, 60, 1] = float("inf")
    feat[1, 5, 60, :] = float("inf")
    feat[0, 40, 70, 3] = float("-inf")
    feat[1, :4, :4] = float("-inf")
    feat = feat.to(dev, dtype)
    boxes = _boxes(gen, b, p, h, w)
    boxes[1, 1] = torch.tensor([0.0, 0.0, 40.0, 40.0])  # the -inf corner alone
    boxes[0, 2] = torch.tensor([0.0, 0.0, 84 * 16 - 1.0, 52 * 16 - 1.0])  # every special cell of image 0
    boxes = boxes.to(dev)
    got = roi_pool_cuda(feat, boxes, 14, 1 / 16)
    again = roi_pool_cuda(feat, boxes, 14, 1 / 16)
    torch.cuda.synchronize()
    want = roi_pool_offsets(feat, boxes, 14, 1 / 16)
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])
    assert bool((got[1, 1] == float("-inf")).all()) and bool((got == float("inf")).any())
    assert torch.equal(_bits(got), _bits(again))


def test_roi_pool_rejects_what_it_does_not_take(dev):
    feat = torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        roi_pool_cuda(feat, torch.zeros(1, 2, 4, device=dev))
    with pytest.raises(ValueError):
        roi_pool_cuda(feat.float(), torch.zeros(1, 2, 4))  # boxes on the CPU


@pytest.mark.parametrize(
    "rows,k,max_out",
    [(1, 1, 4), (2, 63, 10), (3, 64, 64), (2, 65, 70), (4, 130, 20), (2, 1000, 300)],
)
@pytest.mark.parametrize("thresh", [0.5, 1.0, 0.1, 0.0])
def test_nms_kernel_exact(dev, rows, k, max_out, thresh):
    """Exact keep indices and masks against the plain argmax greedy, with
    ties, duplicates, zero-area boxes, invalid entries and an empty row."""
    gen = torch.Generator().manual_seed(rows * 7 + k)
    xy = torch.rand(rows, k, 2, generator=gen) * 100
    boxes = torch.cat([xy, xy + torch.rand(rows, k, 2, generator=gen) * 60], dim=-1)
    scores = torch.round(torch.randn(rows, k, generator=gen) * 3) / 3  # many ties
    if k > 3:
        boxes[:, 1] = boxes[:, 0]
        boxes[:, 2, 2] = boxes[:, 2, 0]  # zero area
    valid = torch.rand(rows, k, generator=gen) > 0.1
    if rows > 1:
        valid[-1] = False
    boxes, scores, valid = boxes.to(dev), scores.to(dev), valid.to(dev)
    got = nms_fixed_cuda(boxes, scores, thresh, max_out, valid)
    torch.cuda.synchronize()
    want = nms_fixed(boxes, scores, thresh, max_out, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_nms_per_row_thresholds_and_single_row(dev):
    gen = torch.Generator().manual_seed(5)
    xy = torch.rand(3, 200, 2, generator=gen) * 100
    boxes = torch.cat([xy, xy + 40], dim=-1).to(dev)
    scores = torch.rand(3, 200, generator=gen).to(dev)
    thr = torch.tensor([0.5, 1.0, 0.1], device=dev)
    got = nms_fixed_cuda(boxes, scores, thr, 36)
    want = nms_fixed(boxes, scores, thr, 36)
    assert torch.equal(got[0], want[0])
    one = nms_fixed_cuda(boxes[0], scores[0], 0.5, 36)
    assert torch.equal(one[0], want[0][0])


# NaN rows: JAX's nms_fixed gives these keeps (tests/test_torch_ops.py
# holds the plain version to it on the CPU). A NaN coordinate makes every
# IoU of its box 0; a valid NaN score is taken first by argmax and is no
# candidate, so nothing in its row is kept.
NAN_BOXES = [[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, float("nan"), 10], [2, 2, 12, 12]]
NAN_SCORES = [0.9, 0.8, 0.95, 0.7]
NAN_COORD_KEEP = [2, 0, 3, -1]
NAN_SCORE_KEEP = [-1, -1, -1, -1]


@functools.lru_cache(maxsize=None)
def _rpn_rows(max_out: int):
    """chip_smoke.py's RPN rows (8, 6000) at 0.7 and the plain keeps."""
    boxes, scores, valid = nms_case(torch.Generator().manual_seed(2), 8, 6000, "cuda")
    return boxes, scores, valid, nms_fixed(boxes, scores, 0.7, max_out, valid)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("max_out", [300, 1000])
def test_nms_every_cluster_size_keeps_the_same(dev, cluster, max_out):
    boxes, scores, valid, want = _rpn_rows(max_out)
    got = nms_fixed_cuda(boxes, scores, 0.7, max_out, valid, _cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [512, 513, 6144])
def test_nms_every_sort_path(dev, k):
    """K2 sorts a row by counting ranks up to 512 candidates, with CUB's
    block radix sort up to 6144; ties among the scores keep the lower index
    first on each path."""
    boxes, scores, valid = nms_case(torch.Generator().manual_seed(k), 3, k, dev)
    for max_out in (300, k):
        got = nms_fixed_cuda(boxes, scores, 0.6, max_out, valid)
        torch.cuda.synchronize()
        want = nms_fixed(boxes, scores, 0.6, max_out, valid)
        assert torch.equal(got[0], want[0]), max_out


def test_nms_refuses_rows_beyond_its_sort(dev):
    """A row longer than MAX_CANDIDATES (6144) raises on the card."""
    boxes, scores, valid = nms_case(torch.Generator().manual_seed(1), 1, MAX_CANDIDATES + 1, dev)
    with pytest.raises(ValueError, match="at most 6144"):
        nms_fixed_cuda(boxes, scores, 0.6, 300, valid)


@pytest.mark.parametrize("cluster", [None, 1, 4, 8])
def test_nms_sweep_runs_to_the_last_candidate(dev, cluster):
    """t = 1.0 removes only boxes with IoU above 1: every live candidate is
    kept, duplicates too, and the budget exceeds the live count."""
    gen = torch.Generator().manual_seed(11)
    xy = torch.rand(3, 700, 2, generator=gen) * 500
    boxes = torch.cat([xy, xy + 5 + torch.rand(3, 700, 2, generator=gen) * 100], dim=-1)
    boxes[:, 1] = boxes[:, 0]
    scores = torch.rand(3, 700, generator=gen)
    valid = torch.rand(3, 700, generator=gen) > 0.2
    boxes, scores, valid = boxes.to(dev), scores.to(dev), valid.to(dev)
    got = nms_fixed_cuda(boxes, scores, 1.0, 720, valid, _cluster=cluster)
    torch.cuda.synchronize()
    want = nms_fixed(boxes, scores, 1.0, 720, valid)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].sum(1), valid.sum(1).to(torch.int64))


@pytest.mark.parametrize("cluster", [None, 2])
def test_nms_negative_threshold_takes_no_early_out(dev, cluster):
    """Below 0 every pair suppresses, boxes that do not overlap and boxes
    with a NaN coordinate too (IoU 0 > t); -0.0 and 0.0 keep the early-out."""
    gen = torch.Generator().manual_seed(12)
    xy = torch.rand(4, 200, 2, generator=gen) * 1000
    boxes = torch.cat([xy, xy + 10], dim=-1)
    boxes[:, 3, 2] = float("nan")
    scores = torch.rand(4, 200, generator=gen)
    thr = torch.tensor([-0.5, -1e-30, -0.0, 0.0])
    boxes, scores, thr = boxes.to(dev), scores.to(dev), thr.to(dev)
    got = nms_fixed_cuda(boxes, scores, thr, 50, _cluster=cluster)
    torch.cuda.synchronize()
    want = nms_fixed(boxes, scores, thr, 50)
    assert torch.equal(got[0], want[0])
    assert got[1][:2].sum(1).tolist() == [1, 1]


def test_nms_identical_boxes_keep_one(dev):
    boxes = torch.tensor([[5.0, 5.0, 50.0, 40.0]]).expand(2, 300, 4).contiguous().to(dev)
    scores = torch.rand(2, 300, generator=torch.Generator().manual_seed(13)).to(dev)
    got = nms_fixed_cuda(boxes, scores, 0.5, 36)
    torch.cuda.synchronize()
    want = nms_fixed(boxes, scores, 0.5, 36)
    assert torch.equal(got[0], want[0]) and got[1].sum(1).tolist() == [1, 1]


@pytest.mark.parametrize("delta", [-1, 1])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_nms_candidates_around_whole_cluster_words(dev, cluster, delta):
    """K = 64 * CL +- 1: the last CTA holds one candidate more than whole
    words, or one word is one short."""
    k = 64 * cluster + delta
    gen = torch.Generator().manual_seed(k)
    xy = torch.rand(3, k, 2, generator=gen) * 200
    boxes = torch.cat([xy, xy + torch.rand(3, k, 2, generator=gen) * 80], dim=-1).to(dev)
    scores = (torch.round(torch.randn(3, k, generator=gen) * 3) / 3).to(dev)
    for max_out in (10, k):
        got = nms_fixed_cuda(boxes, scores, 0.3, max_out, _cluster=cluster)
        torch.cuda.synchronize()
        want = nms_fixed(boxes, scores, 0.3, max_out)
        assert torch.equal(got[0], want[0]), max_out


@pytest.mark.parametrize("cluster", [None, 2])
def test_nms_nan_rows_match_jax(dev, cluster):
    boxes = torch.tensor([NAN_BOXES, NAN_BOXES, [[0, 0, 10, 10]] * 4], device=dev)
    scores = torch.tensor([NAN_SCORES, [0.9, float("nan"), 0.95, 0.7], NAN_SCORES], device=dev)
    valid = torch.tensor([[True] * 4, [True] * 4, [True, False, True, True]], device=dev)
    scores[2, 1] = float("nan")  # an invalid NaN score is no NaN candidate
    got, got_valid = nms_fixed_cuda(boxes, scores, 0.5, 4, valid, _cluster=cluster)
    torch.cuda.synchronize()
    assert got[0].tolist() == NAN_COORD_KEEP
    assert got[1].tolist() == NAN_SCORE_KEEP
    want = nms_fixed(boxes, scores, 0.5, 4, valid)
    assert torch.equal(got, want[0]) and torch.equal(got_valid, want[1])


def test_nms_one_launch_per_call(dev):
    boxes, scores, valid, _ = _rpn_rows(300)
    before = nms_fixed_auto.launches
    for n in range(1, 4):
        nms_fixed_auto(boxes, scores, 0.7, 300, valid)
        assert nms_fixed_auto.launches == before + n
    nms_fixed_auto(boxes[0, :300], scores[0, :300], 0.5, 36)
    assert nms_fixed_auto.launches == before + 4


# bf16: 2 ulps at |x| ~ 1 (the kernel rounds p to bf16 after an online
# rescale, the plain version after the exact max); f32: sums in another order
FLASH_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [128, 197, 1000, 1024])
@pytest.mark.parametrize("padded", [False, True])
def test_flash_attention_kernel_matches_plain(dev, dtype, s, padded):
    """Every position against the plain version: all-real rows, or rows
    padded to other lengths (one down to a single real token)."""
    gen = torch.Generator().manual_seed(s * 10 + padded)
    n, nh = 3, 2
    q, k, v = (torch.randn(n, s, nh, 64, generator=gen).to(dev, dtype) for _ in range(3))
    mask = torch.ones(n, s)
    if padded:
        mask[1, s // 2:] = 0
        mask[2, 1:] = 0
    mask = mask.to(dev)
    for m in (mask, None):
        got = flash_attention_cuda(q, k, v, m, 64)
        torch.cuda.synchronize()
        want = flash_self_attention(q, k, v, m, 64)
        assert got.shape == want.shape == q.shape and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= FLASH_TOL[dtype], err


def _fwd_mask(kind: str, n: int, s: int) -> torch.Tensor:
    """Masks of 64-row blocks of one id. The bf16 kernel skips a key tile
    that no query of its 128-row block shares an id with, which happens in
    "alternating-128" (blocks of real and pad, starting real in row 0, pad
    in row 1, real again in row 2), "real-pad-real" (row 0 and 1 real, pad
    on [64, 192), real after; row 2 pad on [0, 192)) and "real-128" (row 0
    real on [0, 128) only, so its block 0 reads its own two tiles and no
    other; row 1 pad there only). "alternating-64" and "one-real" (a row of
    one real token, one real token in the middle of a pad row, an all-real
    row) put both ids in every block: nothing is skipped, every tile is
    masked for half its rows or for all but one."""
    mask = torch.ones(n, s)
    if kind.startswith("alternating"):
        width = int(kind.split("-")[1])
        block = (torch.arange(s) // width) % 2
        mask[0], mask[1], mask[2] = 1 - block, block, 1 - block
    elif kind == "real-pad-real":
        mask[:, 64:192] = 0
        mask[2, 0:128] = 0
    elif kind == "real-128":
        mask[0, 128:] = 0
        mask[1, :128] = 0
    elif kind == "one-real":
        mask[0, 1:] = 0
        mask[1] = 0
        mask[1, s // 2] = 1
    return mask


def _stats_err(got, want) -> float:
    return max(((a - b).abs() / b.abs().clamp(min=1.0)).max().item() for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [256, 1000, 1024])
@pytest.mark.parametrize("kind", ["alternating-64", "alternating-128", "real-pad-real", "real-128", "one-real"])
def test_flash_attention_skips_tiles_exactly(dev, dtype, s, kind):
    """K3 on masks of whole tiles of one id, on some of which it skips
    tiles (``_fwd_mask``): the output matches the plain version at every
    position, and the row statistics within 1e-5 (the float32 kernel, which
    skips nothing, too)."""
    gen = torch.Generator().manual_seed(s + len(kind))
    q, k, v = (torch.randn(3, s, 2, 64, generator=gen).to(dev, dtype) for _ in range(3))
    mask = _fwd_mask(kind, 3, s).to(dev)
    got = flash_attention_cuda(q, k, v, mask, 64)
    o_k, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    torch.cuda.synchronize()
    want, stats = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[dtype]
    assert torch.equal(_bits(got), _bits(o_k))
    assert _stats_err(stats_k, stats) <= 1e-5, _stats_err(stats_k, stats)


@pytest.mark.parametrize("s", [1, 197])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_short_and_ragged(dev, s, dtype):
    """s = 1 (one real key and 127 zero keys of the pad) and s = 197 (a
    ragged last tile): output and statistics, with the mask and without."""
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(3, s, 2, 64, generator=gen).to(dev, dtype) for _ in range(3))
    mask = torch.ones(3, s)
    mask[1, s // 2:] = 0
    mask[2] = 0
    for m in (mask.to(dev), None):
        o_k, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, m, 64)
        torch.cuda.synchronize()
        want, stats = flash_self_attention_fwd_residuals(q, k, v, m, 64)
        assert (o_k.float() - want.float()).abs().max().item() <= FLASH_TOL[dtype]
        assert _stats_err(stats_k, stats) <= 1e-5, _stats_err(stats_k, stats)


def test_flash_attention_is_bitwise_repeatable(dev):
    """No atomics: two calls on the same inputs give the same bits, with
    and without the statistics."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 1024, 3, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    mask = _fwd_mask("real-pad-real", 4, 1024).to(dev)
    a = flash_attention_cuda(q, k, v, mask, 64)
    b = flash_attention_cuda(q, k, v, mask, 64)
    (c, (m1, l1)), (d, (m2, l2)) = (flash_attention_fwd_residuals_cuda(q, k, v, mask, 64) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(c), _bits(d)) and torch.equal(_bits(a), _bits(c))
    assert torch.equal(_bits(m1), _bits(m2)) and torch.equal(_bits(l1), _bits(l2))


def test_flash_attention_reads_strided_views(dev):
    """q, k, v as head views of (n, s, nh * 64) projections, as the model
    passes them: no copy, same result as contiguous inputs."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 300, 3 * 3 * 64, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (t.view(2, 300, 3, 64) for t in x.split(3 * 64, dim=-1))
    got = flash_attention_cuda(q, k, v, None, 64)
    want = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), None, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_attention_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, None, 32)  # dh 32
    q = torch.zeros(1, 128, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q, q, None, 64)
    q = torch.zeros(1, 128, 2, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q, q.bfloat16(), None, 64)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q.cpu(), None, 64)


def test_dispatchers_count_kernel_launches_only(dev):
    feat = torch.rand(1, 8, 8, 4)
    boxes = torch.tensor([[[0.0, 0.0, 60.0, 60.0]]])
    q = torch.rand(1, 128, 1, 64)
    wrappers = (roi_pool_auto, nms_fixed_auto, flash_attention_auto, pool_auto, pool_contig_auto,
                pool_grouped_auto, pool_grouped_v3_auto)

    def run(feat, boxes, q):
        roi_pool_auto(feat, boxes, 2)
        nms_fixed_auto(boxes[0], torch.ones(1, device=boxes.device), 0.5, 1)
        flash_attention_auto(q, q, q, None, 64)
        pool_auto(feat, boxes, "v3")
        pool_contig_auto(feat, boxes, "full", cb=4)
        pool_grouped_auto(feat, boxes, group=1)
        pool_grouped_v3_auto(feat, boxes, group=1)

    before = tuple(w.launches for w in wrappers)
    run(feat, boxes, q)
    assert tuple(w.launches for w in wrappers) == before
    run(feat.to(dev), boxes.to(dev), q.to(dev))
    assert tuple(w.launches for w in wrappers) == tuple(b + 1 for b in before)


# backward: relative to each tensor's largest magnitude. bf16: p and ds are
# rounded to bf16 at the same points in both, but from float32 values that
# differ in the last bits (exp2 on pre-scaled scores, other sum orders), so a
# rounded element may land one ulp (2^-8 relative) apart, and so may each
# output; float32: sums in another order
BWD_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30)).item()


def _bwd_case(dev, dtype, s, padded, seed):
    """q, k, v, do (3, s, 2, 64) and a mask: all real (padded False), rows
    padded to s/2 and to 1 (True), or whole 64-row blocks of one id:
    "alternating" (64 real, 64 pad, ... and the reverse) or "real-pad-real"
    (a real block, a pad block, a real block)."""
    gen = torch.Generator().manual_seed(seed)
    n, nh = 3, 2
    q, k, v, do = (torch.randn(n, s, nh, 64, generator=gen).to(dev, dtype) for _ in range(4))
    mask = torch.ones(n, s)
    if padded is True:
        mask[1, s // 2:] = 0
        mask[2, 1:] = 0  # a row of length 1
    elif padded == "alternating":
        block = (torch.arange(s) // 64) % 2
        mask[0], mask[1], mask[2] = 1 - block, block, 1 - block
        mask[2, -1] = 0
    elif padded == "real-pad-real":
        mask[:, 64:192] = 0
        mask[2, 0:128] = 0
    return q, k, v, do, mask.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 128, 129, 197, 1000, 1024])
@pytest.mark.parametrize("padded", [False, True])
def test_flash_backward_kernels_match_plain(dev, dtype, s, padded):
    """K3's statistics against the plain version's, then K4 and K5 against
    the plain backward on the same inputs (the plain output and
    statistics), with the mask and with ``mask=None``."""
    q, k, v, do, mask = _bwd_case(dev, dtype, s, padded, s * 10 + padded)
    for m in (mask, None):
        o, stats = flash_self_attention_fwd_residuals(q, k, v, m, 64)
        o_k, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, m, 64)
        torch.cuda.synchronize()
        assert _rel_err(o_k, o) <= BWD_TOL[dtype]
        for got, want in zip(stats_k, stats):
            assert got.shape == want.shape == (3, 2, s) and got.dtype == torch.float32
            assert ((got - want).abs() / want.abs().clamp(min=1.0)).max().item() <= 1e-5
        got = flash_attention_backward_cuda(q, k, v, m, o, stats, do, 64)
        torch.cuda.synchronize()
        want = flash_self_attention_backward(q, k, v, m, o, stats, do, 64)
        for g, w in zip(got, want):
            assert g.shape == w.shape == q.shape and g.dtype == dtype
            assert bool(torch.isfinite(g).all())
            # at s = 1 a real row sees its one key only: p = 1 and o = v, so
            # ds = (do v - o do) * sm_scale is zero but for the order of two
            # float32 sums, and dq, dk there are rounding noise of either
            # sign; a tensor made only of such rows is held in absolute terms
            noise_only = s == 1 and w.float().abs().max().item() < 1e-5
            if noise_only:
                assert (g.float() - w.float()).abs().max().item() <= 1e-5
            else:
                assert _rel_err(g, w) <= BWD_TOL[dtype], _rel_err(g, w)


@pytest.mark.parametrize("s", [256, 1024])
@pytest.mark.parametrize("kind", ["alternating", "real-pad-real"])
def test_flash_backward_skips_tiles_exactly(dev, s, kind):
    """Masks whose whole 64-row tiles share no id, so the bf16 kernels skip
    tile pairs: every gradient still matches the plain backward, and so do
    the float32 kernels, which skip nothing."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, mask = _bwd_case(dev, dtype, s, kind, s + len(kind))
        o, stats = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
        got = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
        torch.cuda.synchronize()
        want = flash_self_attention_backward(q, k, v, mask, o, stats, do, 64)
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert _rel_err(g, w) <= BWD_TOL[dtype], _rel_err(g, w)


def _span_mask(q_len: int, s: int, q_real, ocr_real) -> torch.Tensor:
    """The span-QA stream's mask, ``[question | pad | OCR | pad]``: row i
    has q_real[i] real question tokens of q_len, then ocr_real[i] real OCR
    tokens, so the question's pad is a hole before the page's."""
    mask = torch.zeros(len(q_real), s)
    for i, (ql, ol) in enumerate(zip(q_real, ocr_real)):
        mask[i, :ql] = 1
        mask[i, q_len:q_len + ol] = 1
    return mask


# (question budget, s, real question tokens a row, real OCR tokens a row):
# the slice's serving shape (a full page, a page with a 20% pad tail, a
# one-token page), and a short stream whose hole straddles a 64-row tile
SPAN_CASES = [(64, 1024, (64, 5, 40), (960, 768, 1)), (20, 148, (3, 20, 1), (128, 60, 100))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SPAN_CASES, ids=["s1024", "s148"])
def test_flash_attention_on_span_masks(dev, dtype, case):
    """K3 on the span stream's mask: the output at every position against
    the plain version, the row statistics within 1e-5."""
    q_len, s, q_real, ocr_real = case
    gen = torch.Generator().manual_seed(s + q_len)
    q, k, v = (torch.randn(3, s, 2, 64, generator=gen).to(dev, dtype) for _ in range(3))
    mask = _span_mask(q_len, s, q_real, ocr_real).to(dev)
    got, stats_k = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    torch.cuda.synchronize()
    want, stats = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[dtype]
    assert torch.equal(_bits(got), _bits(flash_attention_cuda(q, k, v, mask, 64)))
    assert _stats_err(stats_k, stats) <= 1e-5, _stats_err(stats_k, stats)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SPAN_CASES, ids=["s1024", "s148"])
def test_flash_backward_on_span_masks(dev, dtype, case):
    """K5 then K4 on the span stream's mask against the plain backward, and
    the gradients autograd takes through ``flash_attention_auto`` (K3 with
    its statistics, K5, K4) against autograd of the plain version, at real
    query positions (the loss of the span head reads no other)."""
    q_len, s, q_real, ocr_real = case
    gen = torch.Generator().manual_seed(2 * s + q_len)
    q, k, v, do = (torch.randn(3, s, 2, 64, generator=gen).to(dev, dtype) for _ in range(4))
    mask = _span_mask(q_len, s, q_real, ocr_real).to(dev)
    o, stats = flash_self_attention_fwd_residuals(q, k, v, mask, 64)
    got = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
    torch.cuda.synchronize()
    want = flash_self_attention_backward(q, k, v, mask, o, stats, do, 64)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g, w) <= BWD_TOL[dtype], _rel_err(g, w)
    real = mask.bool()[..., None, None].to(dtype)
    grads = []
    for fn in (flash_attention_auto, flash_self_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, mask, 64) * real).float().mul(do.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for g, w in zip(*grads):
        assert _rel_err(g, w) <= BWD_TOL[dtype], _rel_err(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_fused_di(dev, dtype):
    """K5 returns di = sum(o * do) float32 (n, nh, s), the vector K4 reads,
    within 1e-6 of the largest magnitude of its torch expression (sums in
    another order)."""
    q, k, v, do, mask = _bwd_case(dev, dtype, 1000, True, 15)
    o, stats = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    ids = mask.to(torch.int32)
    dq, di = flash_attention_dq_cuda(q, k, v, do, ids, stats, o)
    torch.cuda.synchronize()
    want = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
    assert dq.shape == q.shape and di.shape == (3, 2, 1000) and di.dtype == torch.float32
    assert _rel_err(di, want) <= 1e-6, _rel_err(di, want)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, ids, stats, di)
    full = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), full):
        assert torch.equal(_bits(g), _bits(w))


def test_flash_backward_reads_a_strided_output_gradient(dev):
    """``do`` as a strided view (the gradient of a head view of a wider
    projection) gives the same gradients as its contiguous copy."""
    q, k, v, _, mask = _bwd_case(dev, torch.bfloat16, 300, True, 11)
    wide = torch.randn(3, 300, 2, 3 * 64, device=dev).bfloat16()
    do = wide[..., 64:128]
    assert not do.is_contiguous()
    o, stats = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    got = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
    want = flash_attention_backward_cuda(q, k, v, mask, o, stats, do.contiguous(), 64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_backward_is_deterministic(dev):
    """No atomics: two backward calls, and K5's di, are bitwise equal."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, mask = _bwd_case(dev, dtype, 1024, True, 12)
        o, stats = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
        a = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
        b = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
        di_a = flash_attention_dq_cuda(q, k, v, do, mask.int(), stats, o)[1]
        di_b = flash_attention_dq_cuda(q, k, v, do, mask.int(), stats, o)[1]
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))
        assert torch.equal(_bits(di_a), _bits(di_b))


def test_flash_backward_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
    stats = (torch.zeros(1, 2, 128, device=dev), torch.ones(1, 2, 128, device=dev))
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, q, q, None, q, stats, q, 32)  # dh 32
    q = torch.zeros(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_backward_cuda(q, q, q, None, q, stats, q.float(), 64)  # do dtype
    with pytest.raises(TypeError):
        flash_attention_backward_cuda(q.half(), q.half(), q.half(), None, q, stats, q, 64)


def test_autograd_routes_through_k3_k4_k5(dev):
    """Grad enabled and an input that requires it: K3, then K4 and K5 once
    each in the backward, gradients equal to the direct kernel calls."""
    q, k, v, do, mask = _bwd_case(dev, torch.bfloat16, 256, True, 13)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = lambda: (flash_attention_auto.launches, flash_attention_dkv_cuda.launches,  # noqa: E731
                      flash_attention_dq_cuda.launches)
    before = counts()
    out = flash_attention_auto(*leaves, mask, 64)
    out.backward(do)
    assert counts() == tuple(b + 1 for b in before)
    o, stats = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    want = flash_attention_backward_cuda(q, k, v, mask, o, stats, do, 64)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        flash_attention_auto(*leaves, mask, 64)
    assert counts()[1:] == tuple(b + 2 for b in before[1:])


def test_training_forward_on_the_card_gives_qkv_gradients(dev, monkeypatch):
    """The flash route in training mode (attention dropout 0) carries
    gradients: every q/k/v projection of every layer gets a non-zero one,
    close to the dense route's at this f32 size. The key bias is the
    exception on both routes: a bias on every key moves a query's scores by
    one constant, which softmax ignores, so its gradient is zero but for
    rounding."""
    import dataclasses

    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForTokenClassification, init_weights

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = LayoutLMConfig(vocab_size=500, hidden_size=128, num_heads=2, intermediate_size=256, l_layers=2,
                         max_position_embeddings=256, attention_impl="flash", attention_dropout=0.0,
                         hidden_dropout=0.0)
    gen = torch.Generator().manual_seed(14)
    ids = torch.randint(0, 500, (2, 256), generator=gen).to(dev)
    boxes = torch.randint(0, 1000, (2, 256, 4), generator=gen).sort(-1).values.to(dev)
    mask = torch.ones(2, 256, device=dev)
    grads = {}
    for impl in ("flash", "xla"):
        model = init_weights(LayoutLMForTokenClassification(dataclasses.replace(cfg, attention_impl=impl)), 14)
        model.to(dev).train()
        before = flash_attention_dkv_cuda.launches
        model(ids, boxes, mask).float().square().mean().backward()
        assert flash_attention_dkv_cuda.launches - before == (2 if impl == "flash" else 0)
        grads[impl] = {n: p.grad for n, p in model.named_parameters() if ".attention.self." in n}
    assert len(grads["flash"]) == 2 * 3 * 2
    for name, g in grads["flash"].items():
        assert g is not None and bool(torch.isfinite(g).all()), name
        if name.endswith("key.bias"):
            assert g.abs().max().item() < 1e-6, name
            continue
        assert g.abs().max().item() > 0, name
        assert _rel_err(g, grads["xla"][name]) <= 1e-3, name


def test_roi_pool_refuses_to_cut_the_gradient(dev):
    """Features that require grad on the card go through K1 and K10 (one
    launch each, the backward's gradient bitwise the plain VJP's on a
    dyadic cotangent, none for the boxes); without grad K1 alone runs and
    keeps no graph; on the CPU the plain versions carry the same
    gradient."""
    gen = torch.Generator().manual_seed(5)
    feat = torch.randint(-2, 3, (1, 8, 8, 4), generator=gen).float().to(dev).requires_grad_()
    boxes = torch.tensor([[[0.0, 0.0, 60.0, 60.0], [16.0, 8.0, 127.0, 127.0]]], device=dev)
    g = (torch.randint(-8, 9, (1, 2, 2, 2, 4), generator=gen) / 16).to(dev)
    before = (roi_pool_auto.launches, roi_pool_backward_auto.launches)
    out = roi_pool_auto(feat, boxes, 2)
    out.backward(g)
    torch.cuda.synchronize()
    assert (roi_pool_auto.launches, roi_pool_backward_auto.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach(), roi_pool_offsets(feat.detach(), boxes, 2, 1 / 16))
    want = roi_pool_plain_vjp(feat.detach(), boxes, g, 2, 1 / 16)
    assert torch.equal(_bits(feat.grad), _bits(want))
    with torch.no_grad():
        assert roi_pool_auto(feat, boxes, 2).grad_fn is None
    leaf = feat.detach().cpu().requires_grad_()
    roi_pool_auto(leaf, boxes.cpu(), 2).backward(g.cpu())
    assert torch.equal(leaf.grad, want.cpu())


# -------------------------------------------------- RoIPool backward, K10

# (b, h, w, c, p, s): maps with and without a multiple of the warp in C,
# the parity map (bins of up to 5 x 8 at 14 x 14), the 1344 x 1344
# canvas's 84 x 84 map (up to 8 x 8: the masks' 16 slots a side; in bf16
# its sums take two row bands), a map smaller than the pooled grid, a C that
# is no whole number of 16-byte vectors in bf16 (the scalar path), and a
# 130 x 130 map whose staged slab does not fit (features read through L2)
K10_SHAPES = [(2, 20, 24, 8, 12, 7), (2, 13, 21, 3, 6, 5), (1, 52, 84, 64, 40, 14), (1, 84, 84, 40, 24, 14),
              (1, 4, 4, 5, 3, 7), (1, 52, 84, 12, 20, 14), (1, 130, 130, 16, 8, 14)]
# the path each shape takes, per dtype (``plan_backward``)
K10_PATHS = {
    (1, 84, 84, 40, 24, 14): {torch.float32: "vector", torch.bfloat16: "vector_banded"},
    (1, 52, 84, 12, 20, 14): {torch.float32: "vector", torch.bfloat16: "scalar"},
    (1, 130, 130, 16, 8, 14): {torch.float32: "vector_l2", torch.bfloat16: "vector_l2"},
    (2, 13, 21, 3, 6, 5): {torch.float32: "scalar", torch.bfloat16: "scalar"},
}
# (shape, shared-memory budget the planner is given, path per dtype):
# budgets cut small so that bins straddle bands
K10_FORCED = [
    ((1, 20, 24, 16, 12, 7), 16000, {torch.float32: "vector", torch.bfloat16: "vector_banded"}),
    ((1, 20, 24, 16, 12, 7), 5000, {torch.float32: "vector_l2", torch.bfloat16: "vector_l2"}),
    ((2, 13, 21, 3, 6, 5), 1200, {torch.float32: "scalar_l2", torch.bfloat16: "scalar_banded"}),
]


def _k10_case(dev, dtype, b, h, w, c, p, s, dyadic=True):
    """Integer features (ties in most bins) with NaN, +inf and -inf cells
    and a zero plateau, boxes on and off the map and larger than it, and a
    cotangent of small integers times 2^-4 (or random)."""
    gen = torch.Generator().manual_seed(b * 1000 + h * 10 + c)
    feat = torch.randint(-2, 3, (b, h, w, c), generator=gen).float()
    feat[0, h // 2, w // 3, : max(c // 2, 1)] = float("nan")
    feat[0, -1, -1, 0] = float("inf")
    feat[-1, : h // 3, : w // 3, -1] = float("-inf")
    feat[-1, h // 2:, w // 2:, :] = 0.0
    boxes = _boxes(gen, b, p, h, w)
    boxes[0, 1] = torch.tensor([-300.0, -200.0, w * 40.0, h * 40.0])  # bins past the table's levels
    boxes[-1, -1] = torch.tensor([w * 16.0 + 50, 0.0, w * 16.0 + 90, 30.0])  # off the map: empty
    shape = (b, p, s, s, c)
    g = torch.randint(-8, 9, shape, generator=gen) / 16 if dyadic else torch.randn(shape, generator=gen)
    return feat.to(dev, dtype), boxes.to(dev), g.to(dev, dtype)


def _k10_checked(feat, boxes, g, s, budget=SMEM_BUDGET):
    """K10 once: one launch, counted on the path the planner picks."""
    b, h, w, c = feat.shape
    path = plan_backward(h, w, c, feat.dtype, budget=budget).path
    before = roi_pool_backward_auto.launches, dict(roi_pool_backward_auto.path_launches)
    got = roi_pool_backward_cuda(feat, boxes, g, s, 1 / 16, _budget=budget)
    torch.cuda.synchronize()
    after = roi_pool_backward_auto.path_launches
    assert roi_pool_backward_auto.launches == before[0] + 1
    assert {k: after[k] - before[1][k] for k in after} == {k: int(k == path) for k in after}
    assert got.dtype == feat.dtype and got.shape == feat.shape
    return got, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K10_SHAPES, ids=lambda sh: "x".join(map(str, sh)))
def test_roi_pool_backward_exact_on_dyadic_cotangents(dev, dtype, shape):
    """K10 bitwise equal to ``roi_pool_plain_vjp`` where every sum is exact
    in float32 in any order: ties, NaN bins, +-inf, empty and clipped
    bins, the features' dtype out, one launch on the planner's path (the
    stated one where ``K10_PATHS`` names it); a second call bitwise equal
    to the first."""
    *geom, s = shape
    feat, boxes, g = _k10_case(dev, dtype, *geom, s)
    got, path = _k10_checked(feat, boxes, g, s)
    if shape in K10_PATHS:
        assert path == K10_PATHS[shape][dtype]
    want = roi_pool_plain_vjp(feat, boxes, g, s, 1 / 16)
    assert torch.equal(_bits(got), _bits(want))
    assert got.abs().sum() > 0
    again, _ = _k10_checked(feat, boxes, g, s)
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K10_FORCED, ids=lambda c: f"{'x'.join(map(str, c[0]))}-{c[1]}")
def test_roi_pool_backward_bands_and_l2(dev, dtype, case):
    """A shared-memory budget cut small: the sums in row bands (bins that
    straddle them walked by each band's tiles) and the features read
    through L2; bitwise equal to the plain VJP on dyadic cotangents, twice,
    on the stated path."""
    (*geom, s), budget, paths = case
    feat, boxes, g = _k10_case(dev, dtype, *geom, s)
    got, path = _k10_checked(feat, boxes, g, s, budget)
    assert path == paths[dtype]
    want = roi_pool_plain_vjp(feat, boxes, g, s, 1 / 16)
    assert torch.equal(_bits(got), _bits(want))
    again, _ = _k10_checked(feat, boxes, g, s, budget)
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_roi_pool_backward_random_cotangents(dev, dtype):
    """Random cotangents: the same shares, float32 sums by shared-memory
    atomics in an order that varies from run to run: within 1e-5 of the sum
    of the terms' magnitudes (the plain VJP of |g|), plus, in bf16, one
    rounding of the cast (2^-7 of the value); two calls within the same
    bound of each other."""
    feat, boxes, g = _k10_case(dev, dtype, 1, 52, 84, 64, 40, 14, dyadic=False)
    got = roi_pool_backward_cuda(feat, boxes, g, 14, 1 / 16).float()
    again = roi_pool_backward_cuda(feat, boxes, g, 14, 1 / 16).float()
    want = roi_pool_plain_vjp(feat, boxes, g, 14, 1 / 16).float()
    magnitude = roi_pool_plain_vjp(feat, boxes, g.abs(), 14, 1 / 16).float()
    cast = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for x in (got, again):
        assert bool(((x - want).abs() <= 1e-5 * magnitude + cast * want.abs()).all())


def test_roi_pool_backward_refuses_bins_past_its_mask(dev):
    """A map whose largest bin exceeds 15 cells a side raises before any
    launch; C = 0 gives an empty result with no launch, P = 0 zeros."""
    feat = torch.zeros(1, 240, 16, 8, device=dev)
    boxes = torch.zeros(1, 2, 4, device=dev)
    before = roi_pool_backward_auto.launches
    with pytest.raises(ValueError, match="15"):
        roi_pool_backward_cuda(feat, boxes, torch.zeros(1, 2, 14, 14, 8, device=dev))
    assert roi_pool_backward_auto.launches == before
    empty = torch.ones(1, 20, 24, 8, device=dev, dtype=torch.bfloat16)
    none = roi_pool_backward_cuda(empty[..., :0], boxes, torch.zeros(1, 2, 14, 14, 0, device=dev))
    assert none.shape == (1, 20, 24, 0) and roi_pool_backward_auto.launches == before
    got = roi_pool_backward_cuda(empty, boxes[:, :0], torch.zeros(1, 0, 14, 14, 8, device=dev, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and not got.any()


# ------------------------------------------------- RoIPool ablation, K6-K9

# (b, h, w, c, p): the smallest map the noP* modes take; W a multiple of 8
# (the v3 window's edge) with C not a multiple of the 256-channel slab; the
# probe's map; a wide map
ABLATION_SHAPES = [(1, 14, 14, 8, 4), (2, 20, 24, 72, 12), (2, 52, 84, 256, 12), (1, 30, 200, 128, 6)]


def _ablation_case(dev, dtype, b, h, w, c, p):
    gen = torch.Generator().manual_seed(b * 100 + w + c)
    feat = torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
    boxes = _boxes(gen, b, p, h, w)
    boxes[0, 1] = torch.tensor([-1000.0, -1000.0, 3000.0, 3000.0])  # past every cap
    boxes[-1, -1] = torch.tensor([-90.0, -90.0, -20.0, -20.0])  # off the map: empty bins
    return feat, boxes.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ABLATION_SHAPES)
@pytest.mark.parametrize("mode", ablation.POOL_MODES)
def test_pool_kernel_bitwise(dev, dtype, shape, mode):
    feat, boxes = _ablation_case(dev, dtype, *shape)
    got = pool_cuda(feat, boxes, mode)
    torch.cuda.synchronize()
    want = ablation.pool(feat, boxes, mode)
    assert got.shape == want.shape == (shape[0], shape[4], 14, 14, shape[3])
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ABLATION_SHAPES)
@pytest.mark.parametrize("mode", ablation.CONTIG_MODES)
def test_pool_contig_kernel_bitwise(dev, dtype, shape, mode):
    feat, boxes = _ablation_case(dev, dtype, *shape)
    cb = 8 if shape[3] % 128 else 128
    got = pool_contig_cuda(feat, boxes, mode, cb)
    torch.cuda.synchronize()
    want = ablation.pool_contig(feat, boxes, mode, cb)
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ABLATION_SHAPES)
@pytest.mark.parametrize("v3", [False, True])
def test_pool_grouped_kernels_bitwise(dev, dtype, shape, v3):
    """K8 / K9 at every G in {1, 2, 4, 12, P} that divides P: equal to the
    plain version and to K6 ``full`` / ``v3``, bitwise."""
    feat, boxes = _ablation_case(dev, dtype, *shape)
    kernel, ref = (pool_grouped_v3_cuda, ablation.pool_grouped_v3) if v3 else (pool_grouped_cuda, ablation.pool_grouped)
    k6 = pool_cuda(feat, boxes, "v3" if v3 else "full")
    p = shape[4]
    for group in sorted({g for g in (1, 2, 4, 12, p) if p % g == 0}):
        got = kernel(feat, boxes, group)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref(feat, boxes, group))), group
        assert torch.equal(_bits(got), _bits(k6)), group


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_contig_tile_of_an_odd_channel_block(dev, dtype):
    """cb = 3 (C = 9): not a multiple of the vector width, so K7 takes its
    scalar path, one element a thread."""
    feat, boxes = _ablation_case(dev, dtype, 1, 20, 24, 9, 6)
    for mode in ablation.CONTIG_MODES:
        got = pool_contig_cuda(feat, boxes, mode, 3)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ablation.pool_contig(feat, boxes, mode, 3)))


def test_ablation_table_levels(dev):
    """Level l of the table is the max of rows y .. min(y + l, H - 1)."""
    feat = torch.randn(2, 20, 24, 40, device=dev).bfloat16()
    table = build_table_cuda(feat)
    torch.cuda.synchronize()
    assert table.shape == (ablation.caps(20, 24)[0], 2, 20, 24, 40)
    for lv in range(table.shape[0]):
        want = torch.stack([feat[:, y:y + lv + 1].amax(1) for y in range(20)], 1)
        assert torch.equal(_bits(table[lv]), _bits(want))


def test_ablation_roipool_modes_equal_k1_inside_the_map(dev):
    """On boxes within the map the capped windows cover every bin: the
    RoIPool modes are bitwise equal to K1."""
    gen = torch.Generator().manual_seed(21)
    feat = torch.randn(2, 52, 84, 128, generator=gen).to(dev, torch.bfloat16)
    xy = torch.rand(2, 24, 2, generator=gen) * torch.tensor([84 * 16.0, 52 * 16.0])
    boxes = torch.cat([xy, torch.minimum(xy + torch.rand(2, 24, 2, generator=gen) * 900,
                                         torch.tensor([84 * 16.0 - 1, 52 * 16.0 - 1]))], -1).to(dev)
    want = roi_pool_cuda(feat, boxes, 14, 1 / 16)
    outs = [pool_cuda(feat, boxes, "full"), pool_cuda(feat, boxes, "v3"), pool_grouped_cuda(feat, boxes, 4),
            pool_grouped_v3_cuda(feat, boxes, 12)]
    outs += [ablation.from_contig(pool_contig_cuda(feat, boxes, m, 64)) for m in ("full", "stackwrite")]
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(_bits(got), _bits(want))


# (name, C, cb, K6's path (and K8's and K9's), K7's path): an aligned map
# whose C and cb take 16-byte vectors; an unaligned copy of it; C = 9
# (cb = 3); cb = 6, which sends K7 alone to the scalar path
K67_PATH_CASES = [
    ("aligned", 72, 8, "vector", "vector"),
    ("unaligned", 72, 8, "scalar", "scalar"),
    ("odd_c", 9, 3, "scalar", "scalar"),
    ("odd_cb", 72, 6, "vector", "scalar"),
]


def _nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN in the same places, every other value bitwise equal."""
    nan = torch.isnan(want.float())
    return (got.shape == want.shape and torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(_bits(got)[~nan], _bits(want)[~nan]))


def _with_nonfinite_cells(feat: torch.Tensor) -> torch.Tensor:
    """A copy with NaN cells, a row and a column run of -inf (whole bins of
    -inf, written as 0; noP2's and noBoth's raw copies keep them) and a
    +inf cell."""
    f = feat.float().cpu()
    f[0, 3, :, :2] = float("nan")  # a row under 14: every mode reads it
    f[-1, 9, 11, -1] = float("nan")
    f[0, 6:9, 2:7] = float("-inf")
    f[-1, :, 12] = float("-inf")
    f[0, 0, :14, 1] = float("-inf")
    f[-1, 15, 20, 0] = float("inf")
    return f.to(feat.device, feat.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K67_PATH_CASES, ids=[c[0] for c in K67_PATH_CASES])
@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
def test_k6_k7_paths_every_mode(dev, dtype, case, nonfinite):
    """K6 and K7 on both paths, every mode, and K8 and K9 at G in {1, 2, 4,
    12} (P = 12): the wrapper picks the path before launching, each call
    adds one to ``launches`` and to the count of that path alone, and the
    result equals the plain version (NaN in the same places, every other
    value bitwise), also on maps with NaN and -inf cells."""
    from vltk_tpu_torch.tools.variants import unaligned

    name, c, cb, k6_path, k7_path = case
    feat, boxes = _ablation_case(dev, dtype, 2, 20, 24, c, 12)
    if nonfinite:
        feat = _with_nonfinite_cells(feat)
    if name == "unaligned":
        feat = unaligned(feat)
    calls = [(pool_auto, k6_path, mode, lambda f, b, m=mode: pool_cuda(f, b, m),
              lambda f, b, m=mode: ablation.pool(f, b, m)) for mode in ablation.POOL_MODES]
    calls += [(pool_contig_auto, k7_path, mode, lambda f, b, m=mode: pool_contig_cuda(f, b, m, cb),
               lambda f, b, m=mode: ablation.pool_contig(f, b, m, cb)) for mode in ablation.CONTIG_MODES]
    for g in (1, 2, 4, 12):
        calls += [(pool_grouped_auto, k6_path, f"grouped G={g}", lambda f, b, g=g: pool_grouped_cuda(f, b, g),
                   lambda f, b, g=g: ablation.pool_grouped(f, b, g)),
                  (pool_grouped_v3_auto, k6_path, f"grouped_v3 G={g}", lambda f, b, g=g: pool_grouped_v3_cuda(f, b, g),
                   lambda f, b, g=g: ablation.pool_grouped_v3(f, b, g))]
    for wrapper, path, mode, kernel, ref in calls:
        before, paths = wrapper.launches, dict(wrapper.path_launches)
        got = kernel(feat, boxes)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, mode
        assert wrapper.path_launches == {**paths, path: paths[path] + 1}, mode
        want = ref(feat, boxes)
        assert _nan_equal(got, want), (mode, path)
        if nonfinite and mode not in ("p1only", "zeroOut"):
            assert bool(torch.isnan(want.float()).any()), mode


def test_k6_k7_nonfinite_at_the_probe_width(dev):
    """bf16 (2, 52, 84, 1024) with NaN and -inf cells on the vector path,
    every K6 and K7 mode (K7 at cb 128), and K8 and K9 at G = 4 and 12,
    against the plain version."""
    gen = torch.Generator().manual_seed(52)
    feat = _with_nonfinite_cells(torch.randn(2, 52, 84, 1024, generator=gen).to(dev, torch.bfloat16))
    boxes = _boxes(gen, 2, 24, 52, 84).to(dev)
    for mode in ablation.POOL_MODES:
        got = pool_cuda(feat, boxes, mode)
        torch.cuda.synchronize()
        assert _nan_equal(got, ablation.pool(feat, boxes, mode)), mode
    for mode in ablation.CONTIG_MODES:
        got = pool_contig_cuda(feat, boxes, mode, 128)
        torch.cuda.synchronize()
        assert _nan_equal(got, ablation.pool_contig(feat, boxes, mode, 128)), mode
    for g in (4, 12):
        for kernel, ref in ((pool_grouped_cuda, ablation.pool_grouped), (pool_grouped_v3_cuda, ablation.pool_grouped_v3)):
            got = kernel(feat, boxes, g)
            torch.cuda.synchronize()
            assert _nan_equal(got, ref(feat, boxes, g)), (kernel.__name__, g)


def test_ablation_table_levels_on_both_paths(dev):
    """The build's two paths give the same table, NaN and -inf cells
    included; the unaligned copy takes the scalar path."""
    from vltk_tpu_torch.ops.roi_pool_ablation_kernel import kernel_path
    from vltk_tpu_torch.tools.variants import unaligned

    feat = _with_nonfinite_cells(torch.randn(2, 20, 24, 40, device=dev))
    moved = unaligned(feat)
    assert kernel_path(feat) == "vector" and kernel_path(moved) == "scalar"
    vec, sca = build_table_cuda(feat), build_table_cuda(moved, "scalar")
    torch.cuda.synchronize()
    assert _nan_equal(vec, sca)
    for lv in range(vec.shape[0]):
        want = torch.stack([feat[:, y:y + lv + 1].amax(1) for y in range(20)], 1)
        assert _nan_equal(vec[lv], want)


def test_ablation_kernels_reject_what_they_do_not_take(dev):
    feat = torch.zeros(1, 16, 16, 8, device=dev)
    boxes = torch.zeros(1, 4, 4, device=dev)
    with pytest.raises(TypeError):
        pool_cuda(feat.half(), boxes)
    with pytest.raises(TypeError):
        pool_contig_cuda(feat, boxes.double(), cb=8)
    with pytest.raises(ValueError):
        pool_grouped_cuda(feat, boxes.cpu(), 2)  # boxes on the CPU
    with pytest.raises(ValueError):
        pool_grouped_v3_cuda(feat, boxes, 3)  # P % G
    with pytest.raises(ValueError):
        pool_contig_cuda(feat, boxes, cb=3)  # C % cb
    with pytest.raises(ValueError):
        pool_cuda(feat[:, :13], boxes, "noBoth")  # H < 14
    with pytest.raises(ValueError):
        pool_cuda(feat, boxes[..., :3], "full")


# ------------------------------------------------- int8 products (cuBLASLt)


@pytest.mark.parametrize("m,k,n", [(17, 8, 8), (1, 768, 768), (16, 64, 64), (160, 768, 3072), (4096, 3072, 768),
                                   (301, 4, 12), (2400 * 196 // 64, 4608, 512)])
def test_int8_matmul_card_route_is_exact(dev, m, k, n):
    """``torch._int_mm`` (padded where its shape rules ask) against the exact
    route on the card, bitwise; M <= 16 and K, N off a multiple of 8 are
    padded; ``card_launches`` counts each product."""
    from vltk_tpu_torch.ops import int8 as q8

    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=gen)
    b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen).t()  # column-major
    before = q8.int8_matmul.card_launches
    got = q8.int8_matmul(a, b)
    assert q8.int8_matmul.card_launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, q8.int8_matmul_exact(a, b))
    assert torch.equal(q8.int8_matmul(a, b.contiguous()), got)  # a row-major b too


@pytest.mark.parametrize("geom", [(1, 1, 0, 1, 1), (1, 2, 0, 1, 1), (3, 1, 1, 1, 1), (3, 1, 2, 2, 1), (3, 2, 1, 1, 2)])
def test_int8_conv2d_card_route_is_exact(dev, geom):
    from vltk_tpu_torch.ops import int8 as q8

    k, s, p, d, g = geom
    gen = torch.Generator(device=dev).manual_seed(k * 10 + s)
    x = torch.randint(-127, 128, (4, 14, 14, 64), dtype=torch.int8, device=dev, generator=gen)
    w = torch.randint(-127, 128, (k, k, 64 // g, 32), dtype=torch.int8, device=dev, generator=gen)
    got = q8.int8_conv2d(x, w, s, p, d, g)
    assert torch.equal(got, q8.int8_conv2d(x, w, s, p, d, g, matmul=q8.int8_matmul_exact))


def test_int8_quantize_nan_is_zero_on_the_card(dev):
    from vltk_tpu_torch.ops import int8 as q8

    x = torch.tensor([float("nan"), 200.0, -200.0, 2.5, 3.5, -2.5, float("inf")], device=dev)
    x_q, _ = q8.quantize_per_tensor(x, torch.tensor(127.0, device=dev))
    assert x_q.cpu().tolist() == [0, 127, -127, 2, 4, -2, 127]
    big = torch.randn((4096, 768), device=dev, dtype=torch.bfloat16)
    big[7, 9] = float("nan")
    q_card, _ = q8.quantize_per_tensor(big, torch.tensor(3.0, device=dev))
    q_cpu, _ = q8.quantize_per_tensor(big.cpu(), torch.tensor(3.0))
    assert torch.equal(q_card.cpu(), q_cpu) and int(q_card[7, 9]) == 0


# ------------------------------------------------ the kernels as registered ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["vector", "scalar"])
def test_roi_pool_op_is_the_wrapper(dev, dtype, path):
    """``torch.ops.vltk_tpu_torch.roi_pool`` launches K1 as ``roi_pool_cuda``
    does, bitwise, on both of its paths, counted in the same counters."""
    gen = torch.Generator().manual_seed(40)
    c = 1024 if path == "vector" else 300 + 1
    feat = torch.randn(2, 52, 84, c, generator=gen).to(dev, dtype)
    boxes = _boxes(gen, 2, 50, 52, 84).to(dev)
    want = roi_pool_cuda(feat, boxes, 14, 1 / 16)
    before, paths = roi_pool_auto.launches, dict(roi_pool_auto.path_launches)
    got = torch.ops.vltk_tpu_torch.roi_pool(feat, boxes, 14, 1 / 16)
    torch.cuda.synchronize()
    assert roi_pool_auto.launches == before + 1
    assert {k: roi_pool_auto.path_launches[k] - paths[k] for k in paths} == {k: int(k == path) for k in paths}
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(roi_pool_auto(feat, boxes)), _bits(want))  # the eager path calls the op


@pytest.mark.parametrize("per_row", [False, True])
def test_nms_op_is_the_wrapper(dev, per_row):
    """``torch.ops.vltk_tpu_torch.nms_fixed`` launches K2 as
    ``nms_fixed_cuda`` does: the same keeps, one launch, one count."""
    gen = torch.Generator().manual_seed(41)
    boxes, scores, _ = nms_case(gen, 6, 6000, dev)
    thr = torch.tensor([0.3, 0.5, 0.7, 0.5, 0.6, 0.7], device=dev) if per_row else 0.7
    want = nms_fixed_cuda(boxes, scores, thr, 300)
    before = nms_fixed_auto.launches
    got = torch.ops.vltk_tpu_torch.nms_fixed(boxes, scores, thr if per_row else None, 0.0 if per_row else thr, 300,
                                             None)
    torch.cuda.synchronize()
    assert nms_fixed_auto.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(nms_fixed_auto(boxes, scores, thr, 300), want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_ops_are_the_wrappers(dev, dtype):
    """``torch.ops.vltk_tpu_torch.flash_attention`` and
    ``flash_attention_residuals`` launch K3 as ``flash_attention_cuda`` and
    ``flash_attention_fwd_residuals_cuda`` do: bitwise, one count each; so
    does ``FlashAttentionFunction``'s forward, which runs the latter op."""
    gen = torch.Generator().manual_seed(42)
    q, k, v = (torch.randn(3, 1024, 2, 64, generator=gen).to(dev, dtype) for _ in range(3))
    mask = torch.ones(3, 1024, device=dev)
    mask[1, 700:] = 0
    want = flash_attention_cuda(q, k, v, mask, 64)
    want_o, (want_m, want_l) = flash_attention_fwd_residuals_cuda(q, k, v, mask, 64)
    before = flash_attention_auto.launches
    got = torch.ops.vltk_tpu_torch.flash_attention(q, k, v, mask, 64)
    got_o, got_m, got_l = torch.ops.vltk_tpu_torch.flash_attention_residuals(q, k, v, mask, 64)
    torch.cuda.synchronize()
    assert flash_attention_auto.launches == before + 2
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(got_o), _bits(want_o))
    assert torch.equal(got_m, want_m) and torch.equal(got_l, want_l)
    assert torch.equal(_bits(flash_attention_auto(q, k, v, mask, 64)), _bits(want))
    before = flash_attention_auto.launches
    trained = flash_attention_auto(q.clone().requires_grad_(), k, v, mask, 64)
    torch.cuda.synchronize()
    assert flash_attention_auto.launches == before + 1 and torch.equal(_bits(trained.detach()), _bits(want))


def test_ops_raise_on_a_kernel_error(dev):
    """A launch the kernel refuses raises through the op; nothing gives way
    to the plain version on the card."""
    q = torch.randn(1, 128, 1, 32, device=dev)
    with pytest.raises(ValueError, match="head size"):
        torch.ops.vltk_tpu_torch.flash_attention(q, q, q, None, 32)
    boxes = torch.rand(1, MAX_CANDIDATES + 1, 4, device=dev)
    with pytest.raises(ValueError, match="candidates"):
        torch.ops.vltk_tpu_torch.nms_fixed(boxes, boxes[..., 0], None, 0.5, 10, None)
    with pytest.raises(TypeError, match="dtype"):
        torch.ops.vltk_tpu_torch.roi_pool(torch.zeros(1, 4, 4, 8, dtype=torch.float16, device=dev),
                                         torch.zeros(1, 1, 4, device=dev), 14, 1 / 16)
