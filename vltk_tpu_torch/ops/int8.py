"""The int8 products of the serving presets, and the quantize recipe.

Counterpart of the arithmetic inside ``vltk_tpu/models/layers.py``
``Int8Conv`` / ``Int8Dense``. The JAX package computes the product in XLA
(``lax.conv_general_dilated`` / ``dot_general`` with
``preferred_element_type=int32``), not in a Pallas kernel, so the card
route here is a library product too: ``torch._int_mm`` (cuBLASLt, int8 x
int8 -> int32 on the tensor cores).

* ``int8_matmul(a, b)``: (M, K) int8 x (K, N) int8 -> (M, N) int32. On a
  CUDA tensor it calls ``torch._int_mm`` (zero rows and columns padded where
  its shape rules ask for them, and cut off again); on the CPU it takes the
  exact route, ``int8_matmul_exact``: a float64 product cast to int32. That
  is exact: every partial sum is an integer of magnitude below
  K * 127 * 127 < 2^53. Integer accumulation is exact on both routes, so the
  two agree bitwise.
* ``int8_conv2d``: an NHWC int8 map and an HWIO int8 kernel -> the NHWC
  int32 map, with stride, zero padding, dilation and groups. A 1x1
  stride-1 conv is a reshape of the map plus ``int8_matmul``; any other is
  an im2col (one copy of the strided window view to (M, kh*kw*C/g)) and one
  product a group. The im2col is chosen over kh*kw shifted products summed
  in int32: it writes and reads its (M, kh*kw*C) int8 copy once (2.17 GB for
  res5's dilated 3x3 at 2400 RoIs), where the sum would pass its (M, F)
  int32 accumulator nine times (0.96 GB each there).
* ``quantize_weight_per_channel`` / ``activation_max`` /
  ``quantize_per_tensor`` / ``rescale``: the recipe, op for op as JAX
  computes it (divide, not multiply by a reciprocal; round half to even;
  NaN -> 0 made explicit, since a float -> int8 cast of NaN is undefined in
  C++).

``F.conv2d`` is never used on int8 data: PyTorch's CPU build accumulates an
int8 convolution in 8 bits.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntPair = Union[int, Sequence[int]]

# the most rows the exact route turns into float64 at once (bounds its
# scratch memory: 65536 x 4608 float64 is 2.4 GB)
_EXACT_ROWS = 65536
# |partial sum| <= K * 127 * 127 must stay below 2^53 for float64 to be exact
_EXACT_MAX_K = (1 << 53) // (127 * 127)


class _Scopes:
    """``torch.profiler.record_function`` ranges around quantize, product
    and rescale, off unless ``profile_scopes()`` turns them on (the trace
    reads the device time under each)."""

    on = False


@contextlib.contextmanager
def profile_scopes():
    """Name the quantize, int8 product and rescale ops for the profiler
    while the block runs."""
    saved, _Scopes.on = _Scopes.on, True
    try:
        yield
    finally:
        _Scopes.on = saved


def scope(name: str):
    """A profiler range ``int8 <name>`` when scopes are on, else nothing."""
    return torch.profiler.record_function(f"int8 {name}") if _Scopes.on else contextlib.nullcontext()


def int8_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exactly, on any device:
    float64 products of at most ``_EXACT_ROWS`` rows at a time."""
    _check_operands(a, b)
    if a.shape[1] > _EXACT_MAX_K:
        raise ValueError(f"K={a.shape[1]} is too deep for an exact float64 sum (at most {_EXACT_MAX_K})")
    bd = b.double()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    for lo in range(0, a.shape[0], _EXACT_ROWS):
        out[lo:lo + _EXACT_ROWS] = (a[lo:lo + _EXACT_ROWS].double() @ bd).to(torch.int32)
    return out


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not multiply")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` within its shape rules: more than 16 rows, K and N
    multiples of 8 (zero rows and columns added, and the result cut back),
    ``a`` row-major and ``b`` column-major (the layout cuBLASLt's int8
    product takes without a copy)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_to(a, mp, kp).contiguous()
    b = _pad_to(b, kp, np_)
    if b.stride() != (1, kp):
        b = b.t().contiguous().t()
    out = torch._int_mm(a, b)
    _COUNTER.card_launches += 1
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 with int32 accumulation:
    ``torch._int_mm`` on a CUDA tensor (``int8_matmul.card_launches``
    counts its calls), the exact route on the CPU."""
    _check_operands(a, b)
    if a.device.type == "cuda":
        return _int_mm(a, b)
    if a.device.type != "cpu":
        raise NotImplementedError(f"int8_matmul runs on CUDA or the CPU, not {a.device}")
    return int8_matmul_exact(a, b)


int8_matmul.card_launches = 0
_COUNTER = int8_matmul  # the count stays on this function if a caller wraps the name


def _pair(v: IntPair) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv_out_hw(h: int, w: int, kernel: Tuple[int, int], stride: IntPair, padding: IntPair,
                dilation: IntPair) -> Tuple[int, int]:
    """Output height and width of a convolution."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, _pair(stride), _pair(padding), _pair(dilation)
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: IntPair = 1, padding: IntPair = 0,
                dilation: IntPair = 1, groups: int = 1, matmul=int8_matmul) -> torch.Tensor:
    """NHWC int8 ``x_q`` (N, H, W, C) and HWIO int8 ``w_q`` (kh, kw, C/g, F)
    -> NHWC int32 (N, Ho, Wo, F), zero padding (the quantized zero), as
    ``lax.conv_general_dilated(..., preferred_element_type=int32)``.
    ``matmul`` is the product each group runs (``int8_matmul_exact`` to
    take the exact route on the card)."""
    n, h, w, c = x_q.shape
    kh, kw, cg, f = w_q.shape
    if c != cg * groups or f % groups:
        raise ValueError(f"map of {c} channels, kernel {tuple(w_q.shape)}, groups {groups}")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding, dilation)
    m, fg = n * ho * wo, f // groups
    if (kh, kw, sh, sw, ph, pw, groups) == (1, 1, 1, 1, 0, 0, 1):
        return matmul(x_q.reshape(m, c), w_q.reshape(c, f)).view(n, ho, wo, f)
    if ph or pw:
        xp = x_q.new_zeros((n, h + 2 * ph, w + 2 * pw, c))
        xp[:, ph:ph + h, pw:pw + w] = x_q
    else:
        xp = x_q.contiguous()
    s_n, s_h, s_w, _ = xp.stride()
    win = xp.as_strided((n, ho, wo, kh, kw, c), (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw, 1))
    outs = []
    for g in range(groups):
        cols = win[..., g * cg:(g + 1) * cg].reshape(m, kh * kw * cg)
        outs.append(matmul(cols, w_q[..., g * fg:(g + 1) * fg].reshape(kh * kw * cg, fg)))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.view(n, ho, wo, f)


def quantize_weight_per_channel(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel weights: ``s_w = max(max|w|, 1e-8) /
    127`` over every axis but ``axis``, ``w_q = round(w / s_w)`` as int8.
    Returns (w_q in ``w``'s layout, s_w (channels,) float32)."""
    wf = w.float()
    others = [d for d in range(w.dim()) if d != axis % w.dim()]
    s_w = torch.clamp_min(wf.abs().amax(dim=others), 1e-8) / 127.0
    shape = [1] * w.dim()
    shape[axis] = -1
    return torch.round(wf / s_w.view(shape)).to(torch.int8), s_w


def activation_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor (pad rows included) as a float32
    0-d tensor; NaN when ``x`` holds a NaN."""
    return x.abs().amax().float()


def quantize_per_tensor(x: torch.Tensor, act_max: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s_x = max(act_max, 1e-8) / 127``, ``x_q = clip(round(x.float() /
    s_x), -127, 127)`` as int8 with NaN -> 0, in ``x``'s layout. Returns
    (x_q, s_x as a float32 0-d tensor)."""
    s_x = torch.clamp_min(act_max.float(), 1e-8) / 127.0
    q = x / s_x.view(1)  # a 1-d scale promotes a bf16 x: x.float() / s_x in one pass
    q = q.round_().clamp_(-127.0, 127.0).nan_to_num_(nan=0.0)
    return q.to(torch.int8), s_x


def rescale(y: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor, bias: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """int32 ``y`` (..., F) -> ``y.float() * (s_x * s_w) [+ bias]``, float32
    until the final cast to ``dtype``: ``torch.mul`` of the int32 tensor and
    the float32 scale promotes as ``astype`` then multiply does."""
    out = torch.mul(y, s_x * s_w)
    if bias is not None:
        out.add_(bias.float())
    return out.to(dtype)
