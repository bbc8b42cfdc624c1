"""Shared building blocks of the FRCNN trunk.

Port of ``vltk_tpu/models/layers.py`` (plain float path). Modules here take
NCHW-shaped tensors; the backbone hands them NHWC data as channels-last
views, so no copy is made on the way in or out. Parameter and buffer names
are the reference torch names (``weight``, ``norm.running_var``, ...).

Left for a later slice: the int8 layers (``Int8Conv``/``Int8Dense``) and
the space-to-depth stem, an exact TPU rewrite that defaults off.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


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


class ConvNorm(nn.Module):
    """Conv2d + optional frozen norm + optional activation (the reference
    torch ``Conv2d`` with ``norm``/``activation``)."""

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
    ):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = (
            stride, padding, dilation, groups,
        )
        self.dtype = dtype
        self.activation = activation
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.norm = FrozenBatchNorm(out_channels) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        dt = compute_dtype(x, self.weight, self.dtype)
        x = F.conv2d(
            x.to(dt),
            self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            self.stride,
            self.padding,
            self.dilation,
            self.groups,
        )
        if self.norm is not None:
            x = self.norm(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class StemConvNorm(ConvNorm):
    """The 7x7/2 stem conv + frozen norm + relu (the plain path of the
    reference's ``StemConvNorm``)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            in_channels, out_channels, 7, stride=2, padding=3,
            activation=F.relu, dtype=dtype,
        )


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
