"""ResNet-50 feature trunk (counterpart of `ealdm_tpu/models/resnet.py`):
NHWC images in, torchvision's layer layout, the JAX package's parameter
names (`conv1`, `bn1`, `layer<s>_<b>` with `downsample_conv` /
`downsample_bn`, `fc`), so `utils.flax_import.load_flax_params` carries a
flax tree over unchanged.

Two norms, as in the JAX package:
  * "group" (default): flax's `nn.GroupNorm`, min(32, C) groups, eps 1e-6.
    It runs `ops.norms.group_norm`, so on the card the GroupNorm kernel
    (without SiLU).
  * "frozen_bn": eval-mode BatchNorm2d with the running statistics as
    parameters (eps 1e-5), the norm a torchvision `state_dict()` loads into
    (`load_torch_resnet50_state`).
Convolutions run on NCHW-indexed tensors kept channels_last in memory.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import group_norm


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


class _GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=min(32, C))` (eps 1e-6) on an
    NCHW-indexed tensor."""

    def __init__(self, features: int):
        super().__init__()
        self.num_groups = min(32, features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=1e-6,
                          data_format="NCHW")


class _FrozenBN(FrozenBatchNorm):
    """FrozenBatchNorm on an NCHW-indexed tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "frozen_bn":
        return _FrozenBN(features)
    if norm == "group":
        return _GroupNorm(features)
    raise ValueError(f"unknown norm mode: {norm!r}")


def _conv(cin, cout, k, stride=1, dtype=torch.float32):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1, norm: str = "group",
                 dtype=torch.float32):
        super().__init__()
        out_ch = features * self.expansion
        self.conv1 = _conv(cin, features, 1, dtype=dtype)
        self.bn1 = _norm(norm, features)
        self.conv2 = _conv(features, features, 3, strides, dtype=dtype)
        self.bn2 = _norm(norm, features)
        self.conv3 = _conv(features, out_ch, 1, dtype=dtype)
        self.bn3 = _norm(norm, out_ch)
        if cin != out_ch or strides != 1:
            self.downsample_conv = _conv(cin, out_ch, 1, strides, dtype=dtype)
            self.downsample_bn = _norm(norm, out_ch)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """[N, H, W, 3] -> [N, H/32, W/32, 2048], or with `pool` (or a
    `num_classes` head) the spatial mean [N, 2048] (then the fc logits).
    Built on the ambient device."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 0,
                 norm: str = "group", dtype=torch.float32):
        super().__init__()
        self.stage_sizes, self.num_classes = tuple(stage_sizes), num_classes
        self.conv1 = _conv(3, 64, 7, 2, dtype=dtype)
        self.bn1 = _norm(norm, 64)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                block = Bottleneck(cin, 64 * 2**stage, strides, norm, dtype)
                self.add_module(f"layer{stage + 1}_{b}", block)
                cin = 64 * 2**stage * Bottleneck.expansion
        self.fc = nn.Linear(cin, num_classes, dtype=dtype) if num_classes else None

    def forward(self, x, *, pool: bool = False):
        y = x.permute(0, 3, 1, 2)  # NHWC memory: an NCHW index on channels_last
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
        if pool or self.num_classes:
            y = y.mean(dim=(2, 3))
            return self.fc(y) if self.fc is not None else y
        return y.permute(0, 2, 3, 1)


def load_torch_resnet50_state(model: ResNet50, state_dict: Mapping[str, Any]) -> None:
    """Copy a torchvision resnet50 `state_dict()` into a
    `ResNet50(norm="frozen_bn")`, in place: `layer<s>.<b>.*` ->
    `layer<s>_<b>.*`, `downsample.0` / `.1` -> `downsample_conv` /
    `downsample_bn`, `bn.running_mean` / `running_var` -> `bn.mean` / `var`;
    `num_batches_tracked` is dropped. Raises on a missing or unused tensor."""
    own = {}
    for key, v in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        name = key.replace("running_mean", "mean").replace("running_var", "var")
        name = name.replace("downsample.0", "downsample_conv").replace(
            "downsample.1", "downsample_bn")
        parts = name.split(".")
        if parts[0].startswith("layer"):
            parts = [f"{parts[0]}_{parts[1]}"] + parts[2:]
        own[".".join(parts)] = torch.as_tensor(np.asarray(v))
    params = dict(model.named_parameters())
    missing, unused = sorted(set(params) - set(own)), sorted(set(own) - set(params))
    if missing or unused:
        raise ValueError(f"state dict does not match ResNet50(norm='frozen_bn'): missing "
                         f"{missing[:8]} ({len(missing)}), unused {unused[:8]} ({len(unused)})")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(own[k].reshape(p.shape))
