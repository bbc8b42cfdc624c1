"""Flash-attention dispatcher: the CUDA kernels for tensors on the card, the
plain versions (``ops/flash_attention.py``) for tensors on the CPU.

Counterpart of ``vltk_tpu/models/lxmert.py:_flash_self_attention``, which
calls the Pallas TPU kernel and, under ``jax.grad``, its custom VJP. On the
card the forward is K3 (``csrc/flash_attention.cu``) and the backward is K5
(dq, and ``di = sum(o * do)``, which JAX computes outside Pallas) then K4
(dk, dv, reading K5's di) (``csrc/flash_attention_bwd.cu``), joined by
``FlashAttentionFunction``.

Without autograd, ``flash_attention_auto`` calls K3 (or the plain version
on the CPU) through the registered op
``torch.ops.vltk_tpu_torch.flash_attention`` (``flash_attention_op``), which
``torch.export`` keeps in a serving bundle's program. With autograd,
``FlashAttentionFunction`` runs K3 with its row statistics through
``torch.ops.vltk_tpu_torch.flash_attention_residuals``.

Launch counters (CPU calls do not count): ``flash_attention_auto.launches``
for K3, ``flash_attention_dkv_cuda.launches`` for K4,
``flash_attention_dq_cuda.launches`` for K5.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.flash_attention import flash_self_attention, flash_self_attention_fwd_residuals

HEAD_DIM = 64  # the kernels' head size: that of every model config in the repo
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
Stats = Tuple[torch.Tensor, torch.Tensor]


def _lib() -> ctypes.CDLL:
    return bind_fwd(_build.load("flash_attention"))


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a build of ``csrc/flash_attention.cu``
    (``tools/sweep_flash_backward.py --forward`` binds builds of other
    block shapes)."""
    fn = lib.flash_attention_forward
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    return bind_bwd(_build.load("flash_attention_bwd"))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of ``csrc/flash_attention_bwd.cu``
    (``tools/sweep_flash_backward.py`` binds builds of other block shapes)."""
    for fn in (lib.flash_attention_backward_dkv, lib.flash_attention_backward_dq):
        fn.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it through strides (unit last
    stride; for bf16 a 16-byte aligned base and strides that are positive
    multiples of 8 elements, for TMA), else a contiguous copy."""
    ok = x.stride(-1) == 1
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0 for st in x.stride()[:-1])
    return x if ok else x.contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dh: int) -> None:
    """What every kernel takes: q, k, v (n, s, nh, 64) of one shape, one
    dtype (float32 or bfloat16) and one CUDA device."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash attention: want q, k, v of one shape (n, s, nh, dh), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    n, _, nh, d = q.shape
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


def _segment_ids(mask: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    n, s = q.shape[0], q.shape[1]
    if mask is None:
        return torch.ones((n, s), dtype=torch.int32, device=q.device)
    if tuple(mask.shape) != (n, s) or mask.device != q.device:
        raise ValueError(f"flash attention: mask {tuple(mask.shape)} on {mask.device}")
    return mask.to(torch.int32).contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _forward(q, k, v, ids, residuals: bool):
    """Launch K3; with ``residuals`` it also writes the row statistics."""
    n, s, nh, d = q.shape
    dev = q.device
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    out = torch.empty((n, s, nh, d), dtype=q.dtype, device=dev)
    m = l = None  # noqa: E741
    if residuals:
        m = torch.empty((n, nh, s), dtype=torch.float32, device=dev)
        l = torch.empty((n, nh, s), dtype=torch.float32, device=dev)  # noqa: E741
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(dev):
        err = _lib().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            n, s, nh, *strides, 1.0 / float(HEAD_DIM) ** 0.5, _DTYPE_CODE[q.dtype], _stream(dev),
        )
    _build.check(err, "flash_attention_forward launch")
    flash_attention_auto.launches += 1
    return out, (m, l)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """Launch K3: q, k, v (n, s, nh, 64) float32 or bfloat16 on one CUDA
    device, mask (n, s) or None. Same contract as the plain
    ``flash_self_attention``."""
    _check(q, k, v, dh)
    return _forward(q, k, v, _segment_ids(mask, q), residuals=False)[0]


def flash_attention_fwd_residuals_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> Tuple[torch.Tensor, Stats]:
    """K3 with its row statistics: the contract of the plain
    ``flash_self_attention_fwd_residuals`` (m, l float32 (n, nh, s))."""
    _check(q, k, v, dh)
    return _forward(q, k, v, _segment_ids(mask, q), residuals=True)


def _backward_launch(fn_name: str, q, k, v, do, o, ids, stats: Stats, di, dq, dk, dv) -> None:
    """One of the two backward entry points; the tensors it does not take
    are None."""
    n, s, nh, _ = q.shape
    dev = q.device
    m, l = stats  # noqa: E741
    views = (q, k, v, do, o, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(
        *[st for t in views for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
    )
    with torch.cuda.device(dev):
        err = getattr(_bwd_lib(), fn_name)(
            *[None if t is None else t.data_ptr() for t in views[:5]],
            ids.data_ptr(), m.data_ptr(), l.data_ptr(), di.data_ptr(),
            *[None if t is None else t.data_ptr() for t in views[5:]],
            n, s, nh, strides, 1.0 / float(HEAD_DIM) ** 0.5, _DTYPE_CODE[q.dtype], _stream(dev),
        )
    _build.check(err, f"{fn_name} launch")


def flash_attention_dq_cuda(q, k, v, do, ids, stats: Stats, o) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5: (dq, di) from q, k, v, do and the forward's output o (n, s,
    nh, 64, kernel views), ids (n, s) int32 and stats (m, l) float32 (n, nh,
    s) contiguous. di = sum(o * do) float32 (n, nh, s) is what K4 reads."""
    n, s, nh, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    di = torch.empty((n, nh, s), dtype=torch.float32, device=q.device)
    _backward_launch("flash_attention_backward_dq", q, k, v, do, o, ids, stats, di, dq, None, None)
    flash_attention_dq_cuda.launches += 1
    return dq, di


def flash_attention_dkv_cuda(q, k, v, do, ids, stats: Stats, di) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4: (dk, dv) from the inputs K5 takes but o, and K5's di."""
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _backward_launch("flash_attention_backward_dkv", q, k, v, do, None, ids, stats, di, None, dk, dv)
    flash_attention_dkv_cuda.launches += 1
    return dk, dv


def _backward(q, k, v, ids, o, stats: Stats, do):
    """K5 (dq and di), then K4 (dk, dv)."""
    for name, t in (("output gradient", do), ("output", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash attention backward: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device}; want {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    m, l = (t.contiguous() for t in stats)  # noqa: E741
    q, k, v, do, o = (_kernel_view(t) for t in (q, k, v, do, o))
    dq, di = flash_attention_dq_cuda(q, k, v, do, ids, (m, l), o)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, ids, (m, l), di)
    return dq, dk, dv


def flash_attention_backward_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
    o: torch.Tensor, stats: Stats, do: torch.Tensor, dh: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on the card: the contract of the plain
    ``flash_self_attention_backward``."""
    _check(q, k, v, dh)
    return _backward(q, k, v, _segment_ids(mask, q), o, stats, do)


class FlashAttentionFunction(torch.autograd.Function):
    """K3 forward with its row statistics (the registered op
    ``flash_attention_residuals``), K4 and K5 backward. Saves q, k, v, the
    mask, the output and the statistics."""

    @staticmethod
    def forward(ctx, q, k, v, mask, dh):
        out, m, l = flash_attention_residuals_op(q, k, v, mask, dh)  # noqa: E741
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, m, l = ctx.saved_tensors  # noqa: E741
        dq, dk, dv = _backward(q, k, v, _segment_ids(mask, q), out, (m, l), do)
        return dq, dk, dv, None, None


@torch.library.custom_op("vltk_tpu_torch::flash_attention", mutates_args=(), device_types="cuda")
def flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """K3 as a registered op (``torch.ops.vltk_tpu_torch.flash_attention``),
    so a program that ``torch.export`` traces keeps the kernel: on CUDA
    tensors ``flash_attention_cuda`` (same launch and counter), on CPU ones
    the plain version."""
    return flash_attention_cuda(q, k, v, mask, dh)


@flash_attention_op.register_kernel("cpu")
def _flash_attention_op_cpu(q, k, v, mask, dh):
    return flash_self_attention(q, k, v, mask, dh).contiguous()


@flash_attention_op.register_fake
def _flash_attention_op_fake(q, k, v, mask, dh):
    return q.new_empty(q.shape)


@torch.library.custom_op("vltk_tpu_torch::flash_attention_residuals", mutates_args=(), device_types="cuda")
def flash_attention_residuals_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor], dh: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 with its row statistics as a registered op: (out, m, l), the
    contract of ``flash_attention_fwd_residuals_cuda`` flattened.
    ``FlashAttentionFunction``'s forward."""
    out, (m, l) = flash_attention_fwd_residuals_cuda(q, k, v, mask, dh)  # noqa: E741
    return out, m, l


@flash_attention_residuals_op.register_kernel("cpu")
def _flash_attention_residuals_op_cpu(q, k, v, mask, dh):
    out, (m, l) = flash_self_attention_fwd_residuals(q, k, v, mask, dh)  # noqa: E741
    return out.contiguous(), m.contiguous(), l.contiguous()


@flash_attention_residuals_op.register_fake
def _flash_attention_residuals_op_fake(q, k, v, mask, dh):
    n, s, nh, _ = q.shape
    stats = (n, nh, s)
    return q.new_empty(q.shape), q.new_empty(stats, dtype=torch.float32), q.new_empty(stats, dtype=torch.float32)


def flash_attention_auto(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], dh: int,
) -> torch.Tensor:
    """(n, s, nh, dh) q/k/v -> attention with segment ids q = kv = mask.
    On CUDA tensors the kernels (or an error): K3 alone without autograd,
    ``FlashAttentionFunction`` (K3, then K4 and K5 in the backward) when
    grad is enabled and an input requires it. On CPU tensors the plain
    version, which autograd differentiates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cpu":
            return flash_self_attention(q, k, v, mask, dh)
        return FlashAttentionFunction.apply(q, k, v, mask, dh)
    return flash_attention_op(q, k, v, mask, dh)


flash_attention_auto.launches = 0
flash_attention_dkv_cuda.launches = 0
flash_attention_dq_cuda.launches = 0
