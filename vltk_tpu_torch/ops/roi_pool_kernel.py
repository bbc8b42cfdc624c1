"""RoIPool dispatchers: the CUDA kernels ``csrc/roi_pool.cu`` (K1, the
forward) and ``csrc/roi_pool_bwd.cu`` (K10, the backward) for tensors on
the card, the plain versions (``ops/roi_pool.py``) for tensors on the CPU.

Counterpart of ``vltk_tpu/ops/pallas_kernels.py:roi_pool_auto``, which
dispatches to the Pallas kernel ``roi_pool_pallas`` on the TPU and
differentiates it through ``roi_pool_pallas_ad``: the Pallas forward, the
VJP of the XLA sparse-table ``roi_pool`` backward. Here, with features that
require a gradient while grad is enabled, ``roi_pool_auto`` runs one
``torch.autograd.Function``: K1 and K10 on the card, the plain forward and
``roi_pool_plain_vjp`` on the CPU. Boxes get no gradient (JAX's is zero).

``roi_pool_auto.launches`` counts K1's launches (CPU calls do not count),
and ``roi_pool_auto.path_launches`` splits them by the kernel's path:
``"vector"`` (16-byte loads and stores, 8 bf16 or 4 float32 channels a
thread) where C is a multiple of that width and the features start on a
16-byte boundary, ``"scalar"`` (one element a thread) otherwise.
``roi_pool_backward_auto.launches`` counts K10's, and its ``path_launches``
split them by the path ``plan_backward`` chose: ``"vector"`` (16-byte slabs
of channels) or ``"scalar"`` (one channel a slab), each plain (the map and
its sums in one tile's shared memory), ``_banded`` (the sums in row bands)
or ``_l2`` (the features read through L2).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.roi_pool import roi_pool_offsets, roi_pool_plain_vjp, table_levels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16


def _lib() -> ctypes.CDLL:
    return bind(_build.load("roi_pool"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/roi_pool.cu``
    (``tools/bench_roipool.py --shapes`` binds builds of other block
    shapes)."""
    fn = lib.roi_pool_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.roi_pool_shape.argtypes = []
    lib.roi_pool_shape.restype = ctypes.c_int
    return lib


def kernel_path(features: torch.Tensor) -> str:
    """``"vector"`` where C is a multiple of 16 bytes' worth of elements
    and the (contiguous) features start on a 16-byte boundary, else
    ``"scalar"``."""
    per_vector = VECTOR_BYTES // features.element_size()
    aligned = features.data_ptr() % VECTOR_BYTES == 0
    return "vector" if features.shape[-1] % per_vector == 0 and aligned else "scalar"


def _check(features: torch.Tensor, boxes: torch.Tensor) -> None:
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(
            f"roi_pool: want features (B,H,W,C) and boxes (B,P,4), got "
            f"{tuple(features.shape)} and {tuple(boxes.shape)}"
        )
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_pool kernel: unsupported dtype {features.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"roi_pool kernel: boxes must be float32, got {boxes.dtype}")
    if features.device != boxes.device or features.device.type != "cuda":
        raise ValueError("roi_pool kernel: features and boxes must share a CUDA device")
    if boxes.shape[0] != features.shape[0]:
        raise ValueError("roi_pool: features and boxes disagree on the batch")


def launch(
    lib: ctypes.CDLL,
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int,
    spatial_scale: float,
) -> tuple:
    """One launch of a build of the kernel on checked, contiguous inputs:
    returns (out, path). Counts nothing; ``roi_pool_cuda`` counts."""
    b, h, w, c = features.shape
    p = boxes.shape[1]
    path = kernel_path(features)
    out = torch.empty(
        (b, p, output_size, output_size, c), dtype=features.dtype, device=features.device
    )
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = lib.roi_pool_forward(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            b, h, w, c, p, output_size, float(spatial_scale),
            _DTYPE_CODE[features.dtype], int(path == "vector"), stream,
        )
    _build.check(err, f"roi_pool_forward launch ({path} path)")
    return out, path


def roi_pool_cuda(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """Launch the kernel: features (B, H, W, C) float32/bfloat16 and boxes
    (B, P, 4) float32, both on one CUDA device. The path (vector or
    scalar) follows from C and the features' alignment."""
    _check(features, boxes)
    out, path = launch(
        _lib(), features.contiguous(), boxes.contiguous(), output_size, spatial_scale
    )
    roi_pool_auto.launches += 1
    roi_pool_auto.path_launches[path] += 1
    return out


def _forward(features, boxes, output_size, spatial_scale):
    if features.device.type == "cpu":
        return roi_pool_offsets(features, boxes, output_size, spatial_scale)
    return roi_pool_cuda(features, boxes, output_size, spatial_scale)


class _RoIPool(torch.autograd.Function):
    """K1 forward and K10 backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, features, boxes, output_size, spatial_scale):
        ctx.save_for_backward(features, boxes)
        ctx.geometry = (output_size, spatial_scale)
        return _forward(features, boxes, output_size, spatial_scale)

    @staticmethod
    def backward(ctx, grad_out):
        features, boxes = ctx.saved_tensors
        grad = roi_pool_backward_auto(features, boxes, grad_out, *ctx.geometry)
        return grad, None, None, None


def roi_pool_auto(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """Batched RoIPool: (B, H, W, C), (B, P, 4) -> (B, P, S, S, C). The
    kernel on CUDA tensors (or an error), the plain version on CPU ones;
    differentiable in the features through K10 (or its plain version)."""
    if torch.is_grad_enabled() and features.requires_grad:
        return _RoIPool.apply(features, boxes, output_size, spatial_scale)
    return _forward(features, boxes, output_size, spatial_scale)


roi_pool_auto.launches = 0
roi_pool_auto.path_launches = {"vector": 0, "scalar": 0}


# ------------------------------------------------------------------- K10


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("roi_pool_bwd")
    fn = lib.roi_pool_backward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


#: K10 keeps a bin's row masks in 16 bits: each side's two lookups span at
#: most 2 * 2^k cells, so maps whose largest bin (``table_levels``) is at
#: most 15 cells a side (up to 195 x 195 cells at 14 x 14 bins; the parity
#: map is 52 x 84, bins of at most 5 x 8)
MAX_TABLE_BIN = 15
#: the shared memory a block may take on an H100 (227 KB)
SMEM_BUDGET = 232_448
#: K10's paths: 16-byte slabs of channels or one channel a slab, times
#: where the features are read from (shared memory, the whole map and the
#: sums in one tile; shared memory with the sums in row bands; L2)
BACKWARD_PATHS = tuple(f"{a}{p}" for a in ("vector", "scalar") for p in ("", "_banded", "_l2"))


@dataclass(frozen=True)
class BackwardPlan:
    """K10's tiles for one map: every tile is one image, ``v`` channels
    (a slab) and ``band_rows`` map rows (a band; the last may be shorter);
    ``staged``: the block holds the image's slab of the features in shared
    memory (else it reads them through L2); ``smem_bytes``: what a block
    takes (the staged slab, 16-byte aligned, and the band's float32 sums)."""

    path: str
    v: int
    slabs: int
    staged: bool
    band_rows: int
    bands: int
    smem_bytes: int


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def plan_backward(
    h: int, w: int, c: int, dtype: torch.dtype, aligned: bool = True, budget: int = SMEM_BUDGET
) -> BackwardPlan:
    """K10's tiles for a (B, h, w, c) map of ``dtype``, pure host
    arithmetic. A slab holds 16 bytes of channels where c is a multiple of
    that and the features and the cotangent start on 16-byte boundaries
    (``aligned``), else one channel. The block keeps the image's slab of
    the features and the float32 sums of the whole map in shared memory
    where both fit the ``budget``; else, where the slab takes at most half
    of it, the sums in row bands that fit beside it (``_banded``); else
    the sums in bands of what the budget holds, the features read through
    L2 (``_l2``). Bands are balanced to equal rows."""
    elt = torch.empty((), dtype=dtype).element_size()
    per_vector = VECTOR_BYTES // elt
    vector = aligned and c % per_vector == 0
    v = per_vector if vector else 1
    feat = _align16(h * w * v * elt)
    row = w * v * 4
    if feat + h * row <= budget:
        staged, rows, kind = True, h, ""
    elif 2 * feat <= budget and budget - feat >= row:
        staged, rows, kind = True, (budget - feat) // row, "_banded"
    else:
        staged, rows, kind = False, budget // row, "_l2"
    if rows < 1 or h < 1:
        raise ValueError(f"roi_pool backward kernel: no tile of a {h} x {w} map fits {budget} bytes")
    bands = -(-h // rows)
    rows = -(-h // bands)
    smem = (feat if staged else 0) + rows * row
    return BackwardPlan(("vector" if vector else "scalar") + kind, v, c // v, staged, rows, bands, smem)


def roi_pool_backward_cuda(
    features: torch.Tensor,
    boxes: torch.Tensor,
    grad_out: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
    _budget: int = SMEM_BUDGET,
) -> torch.Tensor:
    """Launch K10: the cotangent of the features (B, H, W, C) from that of
    the pooled (B, P, S, S, C), JAX's rule (``roi_pool_plain_vjp``),
    summed in float32 in shared memory and written once in the features'
    dtype; features float32 or bfloat16, boxes float32, on one CUDA
    device. One launch a call (none for an empty output), counted in
    ``roi_pool_backward_auto.launches`` and, by the planner's path, in
    ``.path_launches``. ``_budget`` (tests only) shrinks the shared memory
    the planner may give a block, to force bands or the L2 path."""
    _check(features, boxes)
    b, h, w, c = features.shape
    p = boxes.shape[1]
    if tuple(grad_out.shape) != (b, p, output_size, output_size, c):
        raise ValueError(f"roi_pool backward: grad_out {tuple(grad_out.shape)} does not match the pooled shape")
    max_bin_h, max_bin_w, _, _ = table_levels(h, w, output_size)
    if max(max_bin_h, max_bin_w) > MAX_TABLE_BIN:
        raise ValueError(
            f"roi_pool backward kernel: bins of up to {max_bin_h} x {max_bin_w} cells on a {h} x {w} map "
            f"exceed its {MAX_TABLE_BIN}-cell masks"
        )
    features = features.contiguous()
    grad_out = grad_out.to(features.dtype).contiguous()
    out = torch.empty_like(features)
    if out.numel() == 0:
        return out
    aligned = features.data_ptr() % VECTOR_BYTES == 0 and grad_out.data_ptr() % VECTOR_BYTES == 0
    plan = plan_backward(h, w, c, features.dtype, aligned, _budget)
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream(features.device).cuda_stream
        err = _bwd_lib().roi_pool_backward(
            features.data_ptr(), boxes.contiguous().data_ptr(), grad_out.data_ptr(), out.data_ptr(),
            b, h, w, c, p, output_size, float(spatial_scale), max_bin_h, max_bin_w,
            _DTYPE_CODE[features.dtype], int(plan.v > 1), int(plan.staged), plan.band_rows, stream,
        )
    _build.check(err, f"roi_pool_backward launch ({plan.path} path)")
    roi_pool_backward_auto.launches += 1
    roi_pool_backward_auto.path_launches[plan.path] += 1
    return out


def roi_pool_backward_auto(
    features: torch.Tensor,
    boxes: torch.Tensor,
    grad_out: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """The RoIPool backward: K10 on CUDA tensors (or an error), the plain
    VJP on CPU ones."""
    if features.device.type == "cpu":
        return roi_pool_plain_vjp(features, boxes, grad_out, output_size, spatial_scale)
    return roi_pool_backward_cuda(features, boxes, grad_out, output_size, spatial_scale)


roi_pool_backward_auto.launches = 0
roi_pool_backward_auto.path_launches = dict.fromkeys(BACKWARD_PATHS, 0)
