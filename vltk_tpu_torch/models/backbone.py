"""ResNet-C4 backbone: the FRCNN trunk.

Port of ``vltk_tpu/models/backbone.py``. Modules take and return NHWC
tensors like the reference; inside, the convolutions see the same memory
as NCHW channels-last views. Module names are the reference torch names
(``stem.conv1``, ``res4.3.conv2``, ``res5.0.shortcut`` ...), so a reference
state dict loads as it is.

Carried over: the stem's ceil-mode max pool, ``stride_in_1x1``, and the VG
res5 variant (stride 1 in the first block, dilation/padding 2 in every
conv2, ``halve=False``). ``int8`` puts the three convs of every
bottleneck block on the int8 path (the projection shortcut and the stem
stay float), ``stem_s2d`` the stem on its exact space-to-depth form; both
default off, as in JAX. ``remat`` is a training-memory option of the
reference and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vltk_tpu_torch.models.layers import (
    ConvNorm,
    StemConvNorm,
    caffe_maxpool,
    torch_maxpool,
)

NUM_BLOCKS_PER_STAGE = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BasicStem(nn.Module):
    """conv1 7x7/2 (+ frozen BN, relu) + 3x3/2 max pool: total stride 4."""

    def __init__(self, in_channels: int = 3, out_channels: int = 64,
                 caffe_maxpool: bool = True, dtype: Optional[torch.dtype] = None, s2d: bool = False):
        super().__init__()
        self.caffe_maxpool = caffe_maxpool
        self.conv1 = StemConvNorm(in_channels, out_channels, dtype=dtype, use_s2d=s2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        y = self.conv1(_nchw(x))
        y = caffe_maxpool(y) if self.caffe_maxpool else torch_maxpool(y)
        return _nhwc(y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut when the
    channel count changes."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        stride_in_1x1: bool = True,
        dilation: int = 1,
        dtype: Optional[torch.dtype] = None,
        int8: bool = False,
    ):
        super().__init__()
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(
            in_channels, bottleneck_channels, 1, stride=stride_1x1,
            activation=F.relu, dtype=dtype, int8=int8,
        )
        self.conv2 = ConvNorm(
            bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3,
            padding=dilation, dilation=dilation, groups=num_groups,
            activation=F.relu, dtype=dtype, int8=int8,
        )
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1, dtype=dtype, int8=int8)
        self.shortcut = (
            ConvNorm(in_channels, out_channels, 1, stride=stride, dtype=dtype)
            if in_channels != out_channels
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        xc = _nchw(x)
        out = self.conv3(self.conv2(self.conv1(xc)))
        shortcut = xc if self.shortcut is None else self.shortcut(xc)
        return _nhwc(F.relu(out + shortcut))


def res_stage(
    num_blocks: int,
    in_channels: int,
    out_channels: int,
    bottleneck_channels: int,
    first_stride: int = 2,
    num_groups: int = 1,
    stride_in_1x1: bool = True,
    dilation: int = 1,
    dtype: Optional[torch.dtype] = None,
    int8: bool = False,
) -> nn.Sequential:
    """A sequence of bottleneck blocks named "0", "1", ...; the first block
    may stride."""
    blocks = []
    for i in range(num_blocks):
        blocks.append(
            BottleneckBlock(
                in_channels if i == 0 else out_channels,
                out_channels,
                bottleneck_channels,
                stride=first_stride if i == 0 else 1,
                num_groups=num_groups,
                stride_in_1x1=stride_in_1x1,
                dilation=dilation,
                dtype=dtype,
                int8=int8,
            )
        )
    return nn.Sequential(*blocks)


class ResNetC4(nn.Module):
    """stem + res2..res4, emitting the stride-16 res4 map (NHWC) that the
    RPN and the RoI heads consume."""

    def __init__(
        self,
        depth: int = 101,
        stem_out_channels: int = 64,
        res2_out_channels: int = 256,
        num_groups: int = 1,
        width_per_group: int = 64,
        stride_in_1x1: bool = True,
        caffe_maxpool: bool = True,
        dtype: Optional[torch.dtype] = None,
        int8: bool = False,
        stem_s2d: bool = False,
    ):
        super().__init__()
        self.stem = BasicStem(3, stem_out_channels, caffe_maxpool, dtype=dtype, s2d=stem_s2d)
        blocks = NUM_BLOCKS_PER_STAGE[depth]
        bottleneck = num_groups * width_per_group
        in_ch, out_ch = stem_out_channels, res2_out_channels
        for idx, stage_idx in enumerate(range(2, 5)):  # res2, res3, res4
            stage = res_stage(
                blocks[idx], in_ch, out_ch, bottleneck,
                first_stride=1 if idx == 0 else 2,
                num_groups=num_groups, stride_in_1x1=stride_in_1x1, dtype=dtype, int8=int8,
            )
            self.add_module(f"res{stage_idx}", stage)
            in_ch = out_ch
            out_ch *= 2
            bottleneck *= 2
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC -> NHWC
        x = self.stem(x)
        for name in ("res2", "res3", "res4"):
            x = getattr(self, name)(x)
        return x


class Res5Head(nn.Sequential):
    """The res5 stage run on pooled RoI features: blocks "0".."2". With
    ``halve=False`` (the VG attribute model) it keeps the 14x14 size:
    stride 1 in block 0, dilation/padding 2 in every conv2."""

    def __init__(
        self,
        res2_out_channels: int = 256,
        num_groups: int = 1,
        width_per_group: int = 64,
        stride_in_1x1: bool = True,
        halve: bool = False,
        dtype: Optional[torch.dtype] = None,
        int8: bool = False,
    ):
        factor = 2 ** 3
        out_channels = res2_out_channels * factor
        bottleneck = num_groups * width_per_group * factor
        stage = res_stage(
            3, out_channels // 2, out_channels, bottleneck,
            first_stride=2 if halve else 1, num_groups=num_groups,
            stride_in_1x1=stride_in_1x1, dilation=1 if halve else 2, dtype=dtype, int8=int8,
        )
        super().__init__(*stage)
