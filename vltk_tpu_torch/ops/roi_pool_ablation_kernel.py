"""Dispatchers of the RoIPool ablation variants: the CUDA kernels K6-K9 of
``csrc/roi_pool_ablation.cu`` for tensors on the card, the plain versions
of ``ops/roi_pool_ablation.py`` for tensors on the CPU.

Counterparts of ``pool``, ``pool_contig``, ``pool_grouped`` and
``pool_grouped_v3`` in ``tools/probe_roipool_ablation.py`` (Pallas on the
TPU). Every call on the card launches the table build, then the variant's
pool kernel; ``<dispatcher>.launches`` counts those calls (CPU calls do not
count). Each has two paths, picked before launching (``kernel_path``):
``"vector"`` (16-byte loads and stores, 8 bf16 or 4 float32 channels a
thread) where C, and K7's cb, are multiples of that width and the features
start on a 16-byte boundary, ``"scalar"`` (one element a thread)
otherwise; ``<dispatcher>.path_launches`` counts each. The table build
takes the same path.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops import roi_pool_ablation as plain
from vltk_tpu_torch.ops.roi_pool_ablation import OUT_SIZE, caps, check_args

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16
MODE_CODE = {"full": 0, "v3": 1, "noP1": 2, "noP2": 3, "noBoth": 4, "stackwrite": 5, "p1only": 6, "zeroOut": 7}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "roi_ablation_build_table": [_P, _P] + [_I] * 7 + [_P],
    "roi_ablation_pool": [_P] * 3 + [_I] * 10 + [_P],
    "roi_ablation_pool_contig": [_P] * 3 + [_I] * 11 + [_P],
    "roi_ablation_pool_grouped": [_P] * 3 + [_I] * 11 + [_P],
}


def _lib() -> ctypes.CDLL:
    return bind(_build.load("roi_pool_ablation"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/roi_pool_ablation.cu``
    (``tools/sweep_roipool_ablation.py`` binds builds of other block shapes
    and channel slabs)."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in ("roi_ablation_shape", "roi_ablation_slab", "roi_ablation_grouped_min_blocks"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _check_cuda(features: torch.Tensor, boxes: torch.Tensor) -> None:
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_pool_ablation kernel: unsupported dtype {features.dtype}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"roi_pool_ablation kernel: boxes must be float32, got {boxes.dtype}")
    if features.device != boxes.device or features.device.type != "cuda":
        raise ValueError("roi_pool_ablation kernel: features and boxes must share a CUDA device")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_path(features: torch.Tensor, cb: Optional[int] = None) -> str:
    """``"vector"`` where C (and ``cb``, K7's channel block) is a multiple
    of 16 bytes' worth of elements and the (contiguous) features start on a
    16-byte boundary, else ``"scalar"``."""
    per_vector = VECTOR_BYTES // features.element_size()
    widths = (features.shape[-1],) if cb is None else (features.shape[-1], cb)
    aligned = features.data_ptr() % VECTOR_BYTES == 0
    return "vector" if aligned and all(n % per_vector == 0 for n in widths) else "scalar"


def build_table_cuda(features: torch.Tensor, path: Optional[str] = None,
                     lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """The row-range-max table (max_bh, B, H, W, C): level l holds the max
    of rows y .. min(y + l, H - 1). Launches the build kernel alone (the
    variants launch it themselves) on ``path`` (default
    ``kernel_path(features)``), from ``lib`` (default the shipped build);
    no launch is counted."""
    features = features.contiguous()
    path = path or kernel_path(features)
    b, h, w, c = features.shape
    levels = caps(h, w)[0]
    table = torch.empty((levels, b, h, w, c), dtype=features.dtype, device=features.device)
    with torch.cuda.device(features.device):
        err = (lib or _lib()).roi_ablation_build_table(
            features.data_ptr(), table.data_ptr(), b, h, w, c, levels,
            _DTYPE_CODE[features.dtype], int(path == "vector"), _stream(features),
        )
    _build.check(err, f"roi_ablation_build_table launch ({path} path)")
    return table


def _launch(entry: str, features: torch.Tensor, boxes: torch.Tensor, out: torch.Tensor, *args: int,
            path: str, lib: Optional[ctypes.CDLL] = None) -> None:
    """The table build on ``path``, then the variant's kernel on the
    current stream; ``args`` are the entry's arguments after ``max_bw``."""
    lib = lib or _lib()
    features = features.contiguous()
    boxes = boxes.contiguous()
    table = build_table_cuda(features, path, lib)
    b, h, w, c = features.shape
    max_bh, max_bw = caps(h, w)
    with torch.cuda.device(features.device):
        err = getattr(lib, entry)(
            table.data_ptr(), boxes.data_ptr(), out.data_ptr(), b, h, w, c, boxes.shape[1],
            max_bh, max_bw, *args, _stream(features),
        )
    _build.check(err, f"{entry} launch ({path} path)")


def _nhwc_out(features: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    b, _, _, c = features.shape
    return torch.empty((b, boxes.shape[1], OUT_SIZE, OUT_SIZE, c), dtype=features.dtype, device=features.device)


def pool_cuda(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128,
              lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """K6: (B, H, W, C) float32/bf16, (B, P, 4) float32 on one CUDA device
    -> (B, P, 14, 14, C). ``cb`` is checked and otherwise unused: a
    thread owns 16 bytes of channels (one element on the scalar path).
    ``lib``: another build of the source (``bind``), for sweeps."""
    check_args(features, boxes, mode, plain.POOL_MODES, cb)
    _check_cuda(features, boxes)
    features = features.contiguous()
    path = kernel_path(features)
    out = _nhwc_out(features, boxes)
    _launch("roi_ablation_pool", features, boxes, out, MODE_CODE[mode], _DTYPE_CODE[features.dtype],
            int(path == "vector"), path=path, lib=lib)
    pool_auto.launches += 1
    pool_auto.path_launches[path] += 1
    return out


def pool_contig_cuda(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128,
                     lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """K7: -> (B, C/cb, P, 14, 14, cb); the same kernel body as K6, written
    into the channel-blocked layout."""
    check_args(features, boxes, mode, plain.CONTIG_MODES, cb, contig=True)
    _check_cuda(features, boxes)
    features = features.contiguous()
    path = kernel_path(features, cb)
    b, _, _, c = features.shape
    out = torch.empty(
        (b, c // cb, boxes.shape[1], OUT_SIZE, OUT_SIZE, cb), dtype=features.dtype, device=features.device
    )
    _launch("roi_ablation_pool_contig", features, boxes, out, MODE_CODE[mode], cb, _DTYPE_CODE[features.dtype],
            int(path == "vector"), path=path, lib=lib)
    pool_contig_auto.launches += 1
    pool_contig_auto.path_launches[path] += 1
    return out


def _pool_grouped(features: torch.Tensor, boxes: torch.Tensor, v3: int, group: int, cb: int,
                  lib: Optional[ctypes.CDLL]) -> torch.Tensor:
    """K8 (``v3`` 0) or K9 (1): G = ``group`` RoIs a thread, on the path
    ``kernel_path`` picks; counted on its dispatcher."""
    check_args(features, boxes, cb=cb, group=group)
    _check_cuda(features, boxes)
    features = features.contiguous()
    path = kernel_path(features)
    out = _nhwc_out(features, boxes)
    _launch("roi_ablation_pool_grouped", features, boxes, out, v3, group, _DTYPE_CODE[features.dtype],
            int(path == "vector"), path=path, lib=lib)
    wrapper = pool_grouped_v3_auto if v3 else pool_grouped_auto
    wrapper.launches += 1
    wrapper.path_launches[path] += 1
    return out


def pool_grouped_cuda(features: torch.Tensor, boxes: torch.Tensor, group: int = 8, cb: int = 128,
                      lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """K8: v2 RoIPool, G RoIs a thread -> (B, P, 14, 14, C); equal to K6
    ``full`` for every G that divides P."""
    return _pool_grouped(features, boxes, 0, group, cb, lib)


def pool_grouped_v3_cuda(features: torch.Tensor, boxes: torch.Tensor, group: int = 4, cb: int = 128,
                         lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """K9: v3 RoIPool, G RoIs a thread -> (B, P, 14, 14, C); equal to K6
    ``v3``."""
    return _pool_grouped(features, boxes, 1, group, cb, lib)


def pool_auto(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128) -> torch.Tensor:
    """K6 on CUDA tensors (or an error), the plain ``pool`` on CPU ones."""
    if features.device.type == "cpu":
        return plain.pool(features, boxes, mode, cb)
    return pool_cuda(features, boxes, mode, cb)


def pool_contig_auto(features: torch.Tensor, boxes: torch.Tensor, mode: str = "full", cb: int = 128) -> torch.Tensor:
    """K7 on CUDA tensors (or an error), the plain ``pool_contig`` on CPU ones."""
    if features.device.type == "cpu":
        return plain.pool_contig(features, boxes, mode, cb)
    return pool_contig_cuda(features, boxes, mode, cb)


def pool_grouped_auto(features: torch.Tensor, boxes: torch.Tensor, group: int = 8, cb: int = 128) -> torch.Tensor:
    """K8 on CUDA tensors (or an error), the plain ``pool_grouped`` on CPU ones."""
    if features.device.type == "cpu":
        return plain.pool_grouped(features, boxes, group, cb)
    return pool_grouped_cuda(features, boxes, group, cb)


def pool_grouped_v3_auto(features: torch.Tensor, boxes: torch.Tensor, group: int = 4, cb: int = 128) -> torch.Tensor:
    """K9 on CUDA tensors (or an error), the plain ``pool_grouped_v3`` on CPU ones."""
    if features.device.type == "cpu":
        return plain.pool_grouped_v3(features, boxes, group, cb)
    return pool_grouped_v3_cuda(features, boxes, group, cb)


for _fn in (pool_auto, pool_contig_auto, pool_grouped_auto, pool_grouped_v3_auto):
    _fn.launches = 0
    _fn.path_launches = {"vector": 0, "scalar": 0}
