"""RAFT feature encoder and norm helpers (counterpart of
``codd_tpu/models/motion/encoders.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv

__all__ = ["instance_norm", "FrozenBatchNorm", "BasicEncoder"]


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalisation over H, W (NHWC), no affine."""
    mean = x.mean((1, 2), keepdim=True)
    var = x.var((1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics: ``weight``/``bias`` parameters,
    ``running_mean``/``running_var`` buffers (flax scale/bias params and
    mean/var batch_stats)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv + (self.bias - self.running_mean * inv)


class _ResidualBlock(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = Conv(planes, planes, 3, padding=1)
        if stride != 1 or cin != planes:
            self.downsample = Conv(cin, planes, 1, stride=stride)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT feature encoder at 1/8 resolution, instance-norm variant."""

    def __init__(self, output_dim: int = 128):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3)
        self.layer1_0 = _ResidualBlock(64, 64, 1)
        self.layer1_1 = _ResidualBlock(64, 64, 1)
        self.layer2_0 = _ResidualBlock(64, 96, 2)
        self.layer2_1 = _ResidualBlock(96, 96, 1)
        self.layer3_0 = _ResidualBlock(96, 128, 2)
        self.layer3_1 = _ResidualBlock(128, 128, 1)
        self.conv2 = Conv(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(instance_norm(self.conv1(x)))
        for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1",
                     "layer3_0", "layer3_1"):
            x = getattr(self, name)(x)
        return self.conv2(x)
