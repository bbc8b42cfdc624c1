"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a CUDA device. On a machine with the card:

    python -m pytest -m cuda tests/test_torch_kernels.py

They sweep shapes that ``chip_smoke.py`` (which checks the main paths'
shapes) does not: channel counts that are not a multiple of the block,
candidate counts around the 64-bit mask words, budgets larger than the
candidate count, rows with no candidate; sequence lengths around the
64-key tile and the 128 pad block, padded rows down to length 1.
"""

import pytest
import torch

from vltk_tpu_torch.ops.flash_attention import flash_self_attention
from vltk_tpu_torch.ops.flash_attention_kernel import flash_attention_auto, flash_attention_cuda
from vltk_tpu_torch.ops.nms import nms_fixed
from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto, nms_fixed_cuda
from vltk_tpu_torch.ops.roi_pool import roi_pool
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto, roi_pool_cuda

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,w,c,p,s",
    [(1, 5, 7, 3, 4, 2), (2, 20, 24, 8, 6, 7), (3, 52, 84, 300, 50, 14), (1, 16, 16, 513, 9, 14)],
)
def test_roi_pool_kernel_bitwise(dev, dtype, b, h, w, c, p, s):
    """Bitwise equal to the plain version (max is exact in both types)."""
    gen = torch.Generator().manual_seed(b * 1000 + c)
    feat = torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
    boxes = _boxes(gen, b, p, h, w).to(dev)
    got = roi_pool_cuda(feat, boxes, s, 1 / 16)
    torch.cuda.synchronize()
    want = roi_pool(feat, boxes, s, 1 / 16)
    assert got.shape == want.shape == (b, p, s, s, c)
    assert torch.equal(_bits(got), _bits(want))


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
    wrappers = (roi_pool_auto, nms_fixed_auto, flash_attention_auto)
    before = tuple(w.launches for w in wrappers)
    roi_pool_auto(feat, boxes, 2)
    nms_fixed_auto(boxes[0], torch.ones(1), 0.5, 1)
    flash_attention_auto(q, q, q, None, 64)
    assert tuple(w.launches for w in wrappers) == before
    roi_pool_auto(feat.to(dev), boxes.to(dev), 2)
    nms_fixed_auto(boxes[0].to(dev), torch.ones(1, device=dev), 0.5, 1)
    qd = q.to(dev)
    flash_attention_auto(qd, qd, qd, None, 64)
    assert tuple(w.launches for w in wrappers) == tuple(b + 1 for b in before)
