"""Flash-attention dispatcher: the CUDA kernel ``csrc/flash_attention.cu``
for tensors on the card, the plain version (``ops/flash_attention.py``) for
tensors on the CPU.

Counterpart of ``vltk_tpu/models/lxmert.py:_flash_self_attention``, which
calls the Pallas TPU kernel. ``flash_attention_auto.launches`` counts kernel
launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.flash_attention import flash_self_attention

HEAD_DIM = 64  # the kernel's head size: that of every model config in the repo
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_forward
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can read it through strides (unit last
    stride; for bf16 16-byte aligned rows for cp.async), else a contiguous
    copy."""
    ok = x.stride(-1) == 1
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:-1])
    return x if ok else x.contiguous()


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """Launch the kernel: q, k, v (n, s, nh, 64) float32 or bfloat16 on one
    CUDA device, mask (n, s) or None. Same contract as the plain
    ``flash_self_attention``."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention: want q, k, v of one shape (n, s, nh, dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    n, s, nh, d = q.shape
    if d != HEAD_DIM or dh != HEAD_DIM:
        raise ValueError(f"flash attention kernel: head size {d} (dh={dh}); it takes {HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention kernel: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
            "it takes float32 or bfloat16, all three alike"
        )
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash attention kernel: q, k and v must share a CUDA device")
    if n * nh > 65535:
        raise ValueError(f"flash attention kernel: n * nh = {n * nh} exceeds the grid")
    if mask is None:
        ids = torch.ones((n, s), dtype=torch.int32, device=dev)
    else:
        if tuple(mask.shape) != (n, s) or mask.device != dev:
            raise ValueError(f"flash attention: mask {tuple(mask.shape)} on {mask.device}")
        ids = mask.to(torch.int32).contiguous()
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((n, s, nh, d), dtype=q.dtype, device=dev)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(), out.data_ptr(),
            n, s, nh, *strides, 1.0 / float(dh) ** 0.5, _DTYPE_CODE[q.dtype], stream,
        )
    _build.check(err, "flash_attention_forward launch")
    flash_attention_auto.launches += 1
    return out


def flash_attention_auto(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """(n, s, nh, dh) q/k/v -> attention with segment ids q = kv = mask.
    The kernel on CUDA tensors (or an error), the plain version on CPU
    ones."""
    if q.device.type == "cpu":
        return flash_self_attention(q, k, v, mask, dh)
    return flash_attention_cuda(q, k, v, mask, dh)


flash_attention_auto.launches = 0
