"""Counterpart of `ealdm_tpu/models/resnet.py`, so far only `FrozenBatchNorm`
(UnetCond's norm="frozen_bn"). The ResNet-50 trunk is not ported yet."""
from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm2d on NHWC x: y = (x - mean) * rsqrt(var + eps) * w
    + b. The running statistics are plain parameters, as in the JAX
    package; the result follows type promotion with the float32 parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.var.float() + self.eps) * self.weight
        return x * inv + (self.bias - self.mean * inv)
