"""Shared building blocks of the FRCNN trunk, and the int8 layers.

Port of ``vltk_tpu/models/layers.py``. Modules here take NCHW-shaped
tensors; the backbone hands them NHWC data as channels-last views, so no
copy is made on the way in or out. Parameter and buffer names are the
reference torch names (``weight``, ``norm.running_var``, ...).

int8 (the serving presets): ``ConvNorm(int8=True)`` is the JAX package's
``ConvNorm`` over ``Int8Conv`` and ``Int8Linear`` its ``Int8Dense``, with
the float layer's parameters (names, shapes, dtypes), so checkpoints load
as they are. Weights are quantized per output channel (cached until the
weight changes), activations per tensor, the product accumulates in int32
(``ops/int8.py``) and is rescaled in float32. Each layer has three modes:
dynamic (no recorded scale: the input's own max), static (``act_max``, a
non-persistent buffer, so ``state_dict()`` is unchanged) and calibrating
(``act_max`` raised to the input's max first, then used).
``calibrate_int8_scales`` runs a model in calibrating mode and returns
``{module name: act_max}``; ``load_int8_scales`` puts such a dict back.
Round has a zero gradient: these layers are for serving.

The stem's space-to-depth rewrite (``StemConvNorm(use_s2d=True)``) is
exact: the 7x7/2 kernel padded to 8x8 and both kernel and input turned 2x2
space-to-depth, a 4x4 stride-1 conv over 4C channels; it falls back to the
plain conv on odd sizes and defaults off, as in JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.ops import int8 as q8


def compute_dtype(x: torch.Tensor, weight: torch.Tensor, dtype: Optional[torch.dtype]):
    """The dtype a layer computes in: its configured dtype, or else the
    promotion of input and parameter dtypes (flax's rule for dtype=None)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, weight.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d frozen in eval mode. The affine is computed in float32
    from float32 buffers and cast to the activation dtype before it is
    applied, as the reference does."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        mul = self.weight * torch.pow(self.running_var + self.eps, -0.5)
        add = self.bias - self.running_mean * mul
        shape = (1, -1, 1, 1)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


def _hwio_int8(w: torch.Tensor):
    """OIHW float weight -> (w_q as an HWIO view of (F, kh, kw, C/g) int8
    memory, a column-major (kh*kw*C/g, F) matrix once reshaped; s_w)."""
    w_q, s_w = q8.quantize_weight_per_channel(w, axis=0)
    return w_q.permute(0, 2, 3, 1).contiguous().permute(1, 2, 3, 0), s_w


def _in_out_int8(w: torch.Tensor):
    """(out, in) float weight -> (w_q as a column-major (in, out) int8
    view; s_w)."""
    w_q, s_w = q8.quantize_weight_per_channel(w, axis=0)
    return w_q.t(), s_w


class Int8Mixin:
    """What ``ConvNorm(int8=True)`` and ``Int8Linear`` share: the recorded
    activation max ``act_max`` (a non-persistent buffer, None = dynamic),
    the ``calibrating`` flag, and the quantized weight, cached until the
    weight is edited in place, replaced or moved (an edit through
    ``weight.data`` bypasses the version counter the cache reads)."""

    def _init_int8(self) -> None:
        self.register_buffer("act_max", None, persistent=False)
        self.calibrating = False
        self._wq_cache = None

    def _apply(self, fn, *args, **kwargs):
        self._wq_cache = None  # .to(), .cuda(), .half() ... make new weights
        return super()._apply(fn, *args, **kwargs)

    def _quantized_weight(self, make):
        """``make(weight)`` -> (w_q, s_w), cached on the weight's storage,
        version counter, device and dtype."""
        w = self.weight
        try:
            key = (w.data_ptr(), w._version, w.device, w.dtype)
        except RuntimeError:  # an inference tensor keeps no version: no cache
            return make(w)
        if self._wq_cache is None or self._wq_cache[0] != key:
            with q8.scope("quantize"):
                self._wq_cache = (key, *make(w.detach()))
        return self._wq_cache[1:]

    def _quantize_input(self, x: torch.Tensor):
        """(x_q, s_x) in the layer's mode: calibrating raises ``act_max`` to
        max|x| first and uses it, static uses ``act_max``, dynamic max|x|."""
        with q8.scope("quantize"):
            if self.calibrating:
                m = q8.activation_max(x)
                self.act_max = m if self.act_max is None else torch.maximum(self.act_max, m)
            m = self.act_max if self.act_max is not None else q8.activation_max(x)
            return q8.quantize_per_tensor(x, m)


class ConvNorm(Int8Mixin, nn.Module):
    """Conv2d + optional frozen norm + optional activation (the reference
    torch ``Conv2d`` with ``norm``/``activation``). With ``int8=True`` the
    conv is JAX's ``Int8Conv`` on the same ``weight``: its output is in the
    configured dtype, else the input's."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = False,
        norm: bool = True,
        activation: Optional[Callable] = None,
        dtype: Optional[torch.dtype] = None,
        int8: bool = False,
    ):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = (
            stride, padding, dilation, groups,
        )
        self.dtype = dtype
        self.activation = activation
        self.int8 = int8
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.norm = FrozenBatchNorm(out_channels) if norm else None
        if int8:
            self._init_int8()

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.weight, self.dtype)
        return F.conv2d(
            x.to(dt),
            self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            self.stride,
            self.padding,
            self.dilation,
            self.groups,
        )

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``Int8Conv``, NHWC inside: quantize, int8 conv with int32
        sums, rescale (+ bias) in float32, cast."""
        out_dt = self.dtype or x.dtype
        x_q, s_x = self._quantize_input(x.permute(0, 2, 3, 1))
        w_q, s_w = self._quantized_weight(_hwio_int8)
        with q8.scope("product"):
            y = q8.int8_conv2d(x_q, w_q, self.stride, self.padding, self.dilation, self.groups)
        with q8.scope("rescale"):
            y = q8.rescale(y, s_x, s_w, self.bias, out_dt)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        x = self._int8_conv(x) if self.int8 else self._conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class StemConvNorm(ConvNorm):
    """The 7x7/2 stem conv + frozen norm + relu (the reference's
    ``StemConvNorm``). ``use_s2d`` takes the exact space-to-depth form of
    the same conv (JAX's ``StemConv``) where height and width are even."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64,
                 dtype: Optional[torch.dtype] = None, use_s2d: bool = False):
        super().__init__(
            in_channels, out_channels, 7, stride=2, padding=3,
            activation=F.relu, dtype=dtype,
        )
        self.use_s2d = use_s2d

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        if not self.use_s2d or h % 2 or w % 2:
            return super()._conv(x)
        dt = compute_dtype(x, self.weight, self.dtype)
        f = self.weight.shape[0]
        # kernel: one zero row/column in front -> 8x8 -> (4,2,4,2,C,F) ->
        # (4,4,4C,F), channel order (p, q, c); here as OIHW (F, 4C, 4, 4)
        w8 = F.pad(self.weight.to(dt).permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
        k4 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, f)
        # input: (N,H,W,C) -> (N,H/2,W/2,4C), channel order (p, q, c)
        xs = (x.to(dt).permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c))
        xs = F.pad(xs, (0, 0, 2, 1, 2, 1)).permute(0, 3, 1, 2)
        return F.conv2d(xs, k4.permute(3, 2, 0, 1))


class Int8Linear(Int8Mixin, nn.Linear):
    """``nn.Linear`` on the int8 path (JAX's ``Int8Dense``), with the same
    ``weight`` / ``bias``. ``forward(x, dtype)``: the output is in ``dtype``,
    else the input's; the bias is added in float32 first."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.int8 = True
        self._init_int8()

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dt = dtype or x.dtype
        x_q, s_x = self._quantize_input(x)
        w_q, s_w = self._quantized_weight(_in_out_int8)
        with q8.scope("product"):
            y = q8.int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
        with q8.scope("rescale"):
            y = q8.rescale(y, s_x, s_w, self.bias, out_dt)
        return y.view(*x.shape[:-1], -1)


def int8_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """Every int8 layer of ``model`` by module name."""
    return {name: m for name, m in model.named_modules() if isinstance(m, Int8Mixin) and m.int8}


def int8_scales(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The recorded ``act_max`` of every int8 layer that has one."""
    return {name: m.act_max for name, m in int8_layers(model).items() if m.act_max is not None}


def load_int8_scales(model: nn.Module, scales: Mapping[str, torch.Tensor]) -> None:
    """Put ``{module name: act_max}`` back (every int8 layer must be named,
    no other name may be): the layers take their static path. An empty
    mapping clears them all (the dynamic path)."""
    layers = int8_layers(model)
    if scales:
        missing, unexpected = sorted(set(layers) - set(scales)), sorted(set(scales) - set(layers))
        if missing or unexpected:
            raise KeyError(f"int8 scales: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for name, m in layers.items():
        value = scales.get(name)
        m.act_max = None if value is None else torch.as_tensor(value, dtype=torch.float32).to(m.weight.device)


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Every int8 layer of ``model`` in calibrating mode inside the block."""
    layers = int8_layers(model).values()
    for m in layers:
        m.calibrating = True
    try:
        yield
    finally:
        for m in layers:
            m.calibrating = False


def calibrate_int8_scales(model: nn.Module, batches: Iterable, **kwargs) -> Dict[str, torch.Tensor]:
    """Static int8 calibration (JAX's ``calibrate_int8_variables``): from
    fresh scales, run ``model(*batch, **kwargs)`` for each batch (a tuple of
    positional arguments) in calibrating mode, so every int8 layer keeps
    the running max of its inputs. The scales stay loaded in ``model`` and
    are returned as ``{module name: act_max}``."""
    if not int8_layers(model):
        raise ValueError("the model has no int8 layers to calibrate")
    load_int8_scales(model, {})
    with torch.inference_mode(), calibrating(model):
        for batch in batches:
            model(*batch, **kwargs)
    return int8_scales(model)


def caffe_maxpool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Caffe-style ceil-mode max pool with padding 0 (NCHW)."""
    return F.max_pool2d(x, window, stride, padding=0, ceil_mode=True)


def torch_maxpool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 1) -> torch.Tensor:
    """Floor-mode max pool with symmetric padding (NCHW)."""
    return F.max_pool2d(x, window, stride, padding=pad)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal at +-2 std, std
    sqrt(1/fan_in) corrected for the truncation."""
    std = math.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
