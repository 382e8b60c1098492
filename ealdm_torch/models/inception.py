"""InceptionV3, the FID feature trunk (counterpart of
`ealdm_tpu/models/inception.py`): torchvision's `inception_v3` graph with
pytorch-fid's patches (the "pt_inception-2015-12-05" network that
torchmetrics' FrechetInceptionDistance(feature=2048) runs):

  * `BasicConv2d`: a bias-free convolution, a frozen BatchNorm (eps 1e-3;
    the running statistics are parameters: `bn_scale`, `bn_bias`,
    `bn_mean`, `bn_var`, the JAX names) and ReLU;
  * the 3x3 average pools of Mixed_5*, 6* and 7b's pool branches with
    count_include_pad=False, and Mixed_7c's pool branch a 3x3 max pool;
  * [N, H, W, 3] in [0, 1], resized to 299^2 bilinearly with no
    antialiasing (as `jax.image.resize(..., "bilinear", antialias=False)`),
    mapped to [-1, 1], and the last map's spatial mean out: [N, 2048].

Float32 throughout; the convolutions are cuDNN's on NCHW-indexed tensors
kept channels_last in memory. Neither package has a kernel of its own here.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .encoders import resize_nhwc


class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen BatchNorm (eps 1e-3) + ReLU, NCHW-indexed."""

    def __init__(self, cin: int, features: int, kernel=1, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride=stride, padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_mean = nn.Parameter(torch.zeros(features))
        self.bn_var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.bn_var + 1e-3) * self.bn_scale
        y = self.conv(x) * inv[:, None, None] + (self.bn_bias - self.bn_mean * inv)[:, None, None]
        return F.relu(y)


def _avg_pool_3x3_exclusive(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64)
        self.branch5x5_1 = BasicConv2d(cin, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_exclusive(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192)
        self.branch7x7_1 = BasicConv2d(cin, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_exclusive(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """pool "avg" (FIDInceptionE_1, Mixed_7b) or "max" (FIDInceptionE_2,
    Mixed_7c)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320)
        self.branch3x3_1 = BasicConv2d(cin, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool == "avg":
            bp = _avg_pool_3x3_exclusive(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """[N, H, W, 3] in [0, 1] -> [N, 2048] FID pool3 features. With
    `resize_input` a side other than 299 is resized to 299^2 (bilinear, no
    antialiasing); with `normalize_input` [0, 1] -> [-1, 1] (pytorch-fid's
    defaults). Built on the ambient device."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    @torch.no_grad()
    def seeded_(self, seed: int) -> "InceptionV3Features":
        """Seeded random weights: each convolution ~ N(0, 2 / fan_in) from a
        CPU generator seeded with `seed` (the same weights on any device),
        the BatchNorms the identity (scale 1, bias 0, mean 0, var 1)."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("conv.weight"):
                p.copy_(torch.randn(p.shape, generator=gen, device="cpu")
                        * np.sqrt(2.0 / p[0].numel()))
            else:
                p.fill_(1.0 if name.endswith(("bn_scale", "bn_var")) else 0.0)
        return self

    def forward(self, x):
        x = x.float()
        if self.resize_input and tuple(x.shape[1:3]) != (299, 299):
            x = resize_nhwc(x, (299, 299), "bilinear", antialias=False)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.permute(0, 3, 1, 2)  # NHWC memory: an NCHW index on channels_last
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


_BN_LEAVES = {"bn.weight": "bn_scale", "bn.bias": "bn_bias", "bn.running_mean": "bn_mean",
              "bn.running_var": "bn_var", "conv.weight": "conv.weight"}


@torch.no_grad()
def load_torch_inception_state(model: InceptionV3Features,
                               state_dict: Mapping[str, Any]) -> InceptionV3Features:
    """Copy a torchvision-named InceptionV3 state dict (the
    pt_inception-2015-12-05 FID weights, say) into `model`, in place:
    `<scope>.conv.weight` as it is (OIHW in both), `<scope>.bn.weight` /
    `bias` / `running_mean` / `running_var` -> `<scope>.bn_scale` /
    `bn_bias` / `bn_mean` / `bn_var`. `fc.*`, `AuxLogits.*` and
    `num_batches_tracked` are ignored; any other key it cannot map, and any
    parameter left unfilled, raises ValueError. Returns `model`."""
    own = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0] in ("fc", "AuxLogits") or "num_batches_tracked" in key:
            continue
        leaf = ".".join(parts[-2:])
        if leaf not in _BN_LEAVES:
            raise ValueError(f"unmapped torch key: {key}")
        v = val.detach().cpu() if isinstance(val, torch.Tensor) else np.asarray(val)
        own[".".join(parts[:-2] + [_BN_LEAVES[leaf]])] = torch.as_tensor(v, dtype=torch.float32)
    params = dict(model.named_parameters())
    missing, unused = sorted(set(params) - set(own)), sorted(set(own) - set(params))
    if missing or unused:
        raise ValueError(f"state dict does not match InceptionV3Features: missing "
                         f"{missing[:8]} ({len(missing)}), unused {unused[:8]} ({len(unused)})")
    for k, p in params.items():
        p.copy_(own[k].reshape(p.shape))
    return model
