"""RoIPool dispatcher: the CUDA kernel ``csrc/roi_pool.cu`` for tensors on
the card, the plain version (``ops/roi_pool.py``) for tensors on the CPU.

Counterpart of ``vltk_tpu/ops/pallas_kernels.py:roi_pool_auto``, which
dispatches to the Pallas kernel ``roi_pool_pallas`` on the TPU.
``roi_pool_auto.launches`` counts kernel launches (CPU calls do not count),
and ``roi_pool_auto.path_launches`` splits them by the kernel's path:
``"vector"`` (16-byte loads and stores, 8 bf16 or 4 float32 channels a
thread) where C is a multiple of that width and the features start on a
16-byte boundary, ``"scalar"`` (one element a thread) otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.roi_pool import roi_pool

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


def roi_pool_auto(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int = 14,
    spatial_scale: float = 1.0 / 16,
) -> torch.Tensor:
    """Batched RoIPool: (B, H, W, C), (B, P, 4) -> (B, P, S, S, C). The
    kernel on CUDA tensors (or an error), the plain version on CPU ones.

    The kernel has no backward yet (ROADMAP A.12), and its output carries
    no ``grad_fn``: on the card, features that require a gradient while
    grad is enabled raise rather than lose it silently."""
    if features.device.type == "cpu":
        return roi_pool(features, boxes, output_size, spatial_scale)
    if torch.is_grad_enabled() and features.requires_grad:
        raise RuntimeError(
            "roi_pool on the card: the CUDA kernel has no backward yet (ROADMAP A.12), so it would cut "
            "the gradient to the features; call it under torch.no_grad() or torch.inference_mode(), "
            "or with features that do not require grad"
        )
    return roi_pool_cuda(features, boxes, output_size, spatial_scale)


roi_pool_auto.launches = 0
roi_pool_auto.path_launches = {"vector": 0, "scalar": 0}
