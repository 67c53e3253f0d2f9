"""Shared building blocks (NHWC in, NHWC out).

Counterpart of ``codd_tpu/models/layers.py``.  Each wrapper owns a torch
layer named like the flax submodule (``conv``), so a flax parameter path
maps onto a torch ``state_dict`` key one to one (``utils/params.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["lrelu", "mish", "to_nchw", "to_nhwc", "Conv", "ConvTranspose",
           "SharedStrideConv"]


def lrelu(x, slope: float = 0.2):
    return F.leaky_relu(x, negative_slope=slope)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def to_nchw(x):
    """NHWC -> NCHW view (channels-last strides when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(fn, x, weight, bias, **kw):
    """``fn`` (``F.conv2d`` / ``F.conv_transpose2d``) in float32."""
    return fn(x, weight, bias, **kw)


class Conv(nn.Module):
    """2D conv with torch-style integer padding and dilation (flax
    ``Conv`` with explicit symmetric padding)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=padding, dilation=dilation,
                              bias=use_bias)

    def forward(self, x):
        c = self.conv
        return to_nhwc(_conv(F.conv2d, to_nchw(x), c.weight, c.bias,
                             stride=c.stride, padding=c.padding,
                             dilation=c.dilation))


class ConvTranspose(nn.Module):
    """flax ``ConvTranspose(kernel, stride, padding="VALID")``; the weight
    bridge flips the flax kernel spatially (``utils/params.py``)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 2,
                 stride: int = 2):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, features, kernel, stride=stride)

    def forward(self, x):
        c = self.conv
        return to_nhwc(_conv(F.conv_transpose2d, to_nchw(x), c.weight, c.bias,
                             stride=c.stride))


class SharedStrideConv(nn.Module):
    """A VALID conv whose weights are shared across calls with different
    strides (the tile-feature extractor)."""

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)  # nn.Conv2d's

    def forward(self, x, strides: Tuple[int, int]):
        return to_nhwc(_conv(F.conv2d, to_nchw(x), self.weight, self.bias,
                             stride=strides))
