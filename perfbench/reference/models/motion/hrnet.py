"""HRNet-w18-small context network of RAFT-3D (counterpart of
``codd_tpu/models/motion/hrnet.py``).  All norms are FrozenBatchNorm.
Returns the four branch features at [1/4, 1/8, 1/16, 1/32];
``ResizeConcatConv`` resamples them to 1/8 and projects them."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.upsample import interpolate_bilinear
from ..layers import Conv
from .encoders import FrozenBatchNorm

__all__ = ["HRNetSmall", "ResizeConcatConv"]


class _ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, relu=True):
        super().__init__()
        self.relu = relu
        self.conv = Conv(cin, features, kernel, stride=stride,
                         padding=(kernel - 1) // 2, use_bias=False)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class _Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, expansion=4):
        super().__init__()
        out_c = planes * expansion
        self.c1 = _ConvBN(cin, planes, 1)
        self.c2 = _ConvBN(planes, planes, 3, stride=stride)
        self.c3 = _ConvBN(planes, out_c, 1, relu=False)
        self.down = (_ConvBN(cin, out_c, 1, stride=stride, relu=False)
                     if cin != out_c or stride != 1 else None)

    def forward(self, x):
        y = self.c3(self.c2(self.c1(x)))
        if self.down is not None:
            x = self.down(x)
        return F.relu(x + y)


class _BasicBlock(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.c1 = _ConvBN(planes, planes, 3)
        self.c2 = _ConvBN(planes, planes, 3, relu=False)

    def forward(self, x):
        return F.relu(x + self.c2(self.c1(x)))


class _HRModule(nn.Module):
    """Parallel branches + full cross-resolution fusion."""

    def __init__(self, channels: Tuple[int, ...], num_blocks: Tuple[int, ...]):
        super().__init__()
        self.channels = channels
        self.num_blocks = num_blocks
        n = len(channels)
        for i in range(n):
            for b in range(num_blocks[i]):
                setattr(self, f"branch{i}_blk{b}", _BasicBlock(channels[i]))
        for i in range(n):
            for j in range(n):
                if j > i:
                    setattr(self, f"fuse{i}_{j}",
                            _ConvBN(channels[j], channels[i], 1, relu=False))
                elif j < i:
                    for s in range(i - j):
                        last = s == i - j - 1
                        c = channels[i] if last else channels[j]
                        setattr(self, f"fuse{i}_{j}_{s}",
                                _ConvBN(channels[j], c, 3, stride=2,
                                        relu=not last))

    def forward(self, xs):
        n = len(self.channels)
        ys = []
        for i in range(n):
            y = xs[i]
            for b in range(self.num_blocks[i]):
                y = getattr(self, f"branch{i}_blk{b}")(y)
            ys.append(y)
        fused = []
        for i in range(n):
            acc = None
            for j in range(n):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = getattr(self, f"fuse{i}_{j}")(ys[j])
                    t = interpolate_bilinear(t, tuple(ys[i].shape[1:3]),
                                             align_corners=False)
                else:
                    t = ys[j]
                    for s in range(i - j):
                        t = getattr(self, f"fuse{i}_{j}_{s}")(t)
                acc = t if acc is None else acc + t
            fused.append(F.relu(acc))
        return fused


class HRNetSmall(nn.Module):
    """HRNet-w18-small: (64,) / (18,36) / (18,36,72)x3 / (18,36,72,144)x2."""

    stage_channels = ((64,), (18, 36), (18, 36, 72), (18, 36, 72, 144))
    stage_modules = (1, 1, 3, 2)
    stage_blocks = ((2,), (2, 2), (2, 2, 2), (2, 2, 2, 2))

    def __init__(self):
        super().__init__()
        self.stem1 = _ConvBN(3, 64, 3, stride=2)
        self.stem2 = _ConvBN(64, 64, 3, stride=2)
        c0 = self.stage_channels[0][0]
        cin = 64
        for b in range(self.stage_blocks[0][0]):
            setattr(self, f"layer1_{b}", _Bottleneck(cin, c0))
            cin = c0 * 4
        prev = [cin]
        for stage in (1, 2, 3):
            chans = self.stage_channels[stage]
            for i, c in enumerate(chans):
                if i < len(prev):
                    if prev[i] != c:
                        setattr(self, f"trans{stage}_{i}", _ConvBN(prev[i], c))
                else:
                    setattr(self, f"trans{stage}_{i}",
                            _ConvBN(prev[-1], c, 3, stride=2))
            for m in range(self.stage_modules[stage]):
                setattr(self, f"stage{stage + 1}_m{m}",
                        _HRModule(chans, self.stage_blocks[stage]))
            prev = list(chans)

    def forward(self, x):
        x = self.stem2(self.stem1(x))
        for b in range(self.stage_blocks[0][0]):
            x = getattr(self, f"layer1_{b}")(x)
        xs = [x]
        for stage in (1, 2, 3):
            chans = self.stage_channels[stage]
            new_xs = []
            for i in range(len(chans)):
                name = f"trans{stage}_{i}"
                if i < len(xs):
                    new_xs.append(getattr(self, name)(xs[i])
                                  if hasattr(self, name) else xs[i])
                else:
                    new_xs.append(getattr(self, name)(xs[-1]))
            xs = new_xs
            for m in range(self.stage_modules[stage]):
                xs = getattr(self, f"stage{stage + 1}_m{m}")(xs)
        return xs


class ResizeConcatConv(nn.Module):
    """Resize all branches to branch-1 (1/8) resolution, concat, 1x1 conv."""

    def __init__(self, in_channels: int = 18 + 36 + 72 + 144,
                 out_channels: int = 512):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 1, use_bias=False)

    def forward(self, xs: Sequence[torch.Tensor]):
        target = tuple(xs[1].shape[1:3])
        ups = [interpolate_bilinear(x, target, align_corners=True) for x in xs]
        return F.relu(self.conv(torch.cat(ups, -1)))
