"""LPIPS perceptual distance (counterpart of `ealdm_tpu/losses/lpips.py`):
the scaling layer, VGG16's relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 activations,
unit-normalised over channels, the 1x1 "lin" heads, the spatial mean and
the sum over the five taps.

LPIPS is frozen: its parameters do not require a gradient, and no optimizer
takes them. Gradients flow through it to its inputs. Without a checkpoint
(`load_torch_lpips_weights`) the VGG trunk holds whatever weights the
caller gave it and the heads the constant 1/C of JAX's initialiser, a
multi-scale feature-matching distance still.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2D
from ..utils.device import resolve_device

# ImageNet channel statistics of the reference ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_VGG16_CFG = (
    (64, 64),            # -> relu1_2
    (128, 128),          # -> relu2_2
    (256, 256, 256),     # -> relu3_3
    (512, 512, 512),     # -> relu4_3
    (512, 512, 512),     # -> relu5_3
)


class VGG16Features(nn.Module):
    """VGG16's 13 3x3 convolutions with ReLU, 2x2 max-pools between the
    blocks; returns the five tap activations (NCHW)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        cin = 3
        for b, widths in enumerate(_VGG16_CFG):
            for i, w in enumerate(widths):
                self.add_module(f"conv{b}_{i}", Conv2D(cin, w, 3, padding=1, dtype=dtype))
                cin = w

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for b, widths in enumerate(_VGG16_CFG):
            for i in range(len(widths)):
                x = F.relu(getattr(self, f"conv{b}_{i}")(x))
            taps.append(x)
            if b < len(_VGG16_CFG) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


def _normalize_tensor(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance d(x, y) [B] of NHWC images in [-1, 1]. x and y
    go through the VGG trunk as one batch."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.vgg = VGG16Features(dtype)
            for i, widths in enumerate(_VGG16_CFG):
                # 1x1 no-bias head, initialised to the constant 1/C as JAX's
                self.add_module(f"lin{i}", Conv2D(widths[-1], 1, 1, dtype=dtype,
                                                  use_bias=False))
                nn.init.constant_(getattr(self, f"lin{i}").weight, 1.0 / widths[-1])
            self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                                 persistent=False)
            self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                                 persistent=False)
        self.requires_grad_(False)

    def forward(self, x, y):
        b = x.shape[0]
        xy = torch.cat([x, y]).permute(0, 3, 1, 2)
        taps = self.vgg((xy - self.shift) / self.scale)
        total = 0.0
        for i, t in enumerate(taps):
            t = _normalize_tensor(t)
            diff = torch.square(t[:b] - t[b:])
            total = total + torch.mean(getattr(self, f"lin{i}")(diff), dim=(1, 2, 3))
        return total


# torchvision VGG16 `features` indices of the 13 convolutions, and the
# taming slice each lives in (slice boundaries 4, 9, 16, 23)
_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _slice_of(i: int) -> int:
    return 1 + sum(i >= b for b in (4, 9, 16, 23))


@torch.no_grad()
def load_torch_lpips_weights(lpips: LPIPS, state_dict: Dict) -> LPIPS:
    """Copy a torch LPIPS checkpoint into `lpips`, in place, in either layout
    JAX accepts: taming's `vgg_lpips` (`net.slice{1..5}.{idx}` convolutions,
    `lin{i}.model.1.weight` heads) or a raw torchvision VGG16
    (`features.{idx}`, `lins.{i}.model.1.weight`). Both are OIHW already.
    Keys it does not name are left alone."""
    names = [f"conv{b}_{i}" for b, ws in enumerate(_VGG16_CFG) for i in range(len(ws))]

    def put(param, value):
        param.copy_(torch.as_tensor(np.asarray(value, np.float32)).reshape(param.shape))

    for idx, name in zip(_CONV_IDX, names):
        conv = getattr(lpips.vgg, name)
        for fmt in (f"net.slice{_slice_of(idx)}.{idx}", f"features.{idx}"):
            if f"{fmt}.weight" in state_dict:
                put(conv.weight, state_dict[f"{fmt}.weight"])
            if f"{fmt}.bias" in state_dict:
                put(conv.bias, state_dict[f"{fmt}.bias"])
    for i in range(len(_VGG16_CFG)):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in state_dict:
                put(getattr(lpips, f"lin{i}").weight, state_dict[key])
    return lpips
