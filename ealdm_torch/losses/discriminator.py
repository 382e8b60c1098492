"""PatchGAN discriminator (counterpart of `ealdm_tpu/losses/discriminator.py`):
pix2pix's NLayerDiscriminator as the reference's VAE losses build it, a
pyramid of 4x4 convolutions (padding 1) with leaky ReLU 0.2 ending in a
one-channel logit map.

As in the JAX package, GroupNorm stands in for the reference's BatchNorm
(stateless, no cross-replica statistics): `resolve_num_groups(ch, 32)`
groups, flax's eps 1e-6, through the port's one GroupNorm (`GroupNorm32`,
the hand-written kernel on a CUDA tensor).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2D, GroupNorm32
from ..utils.device import resolve_device


class NLayerDiscriminator(nn.Module):
    """NHWC images [B, H, W, input_nc] -> NHWC logits [B, h, w, 1]."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers = n_layers
        with torch.device(resolve_device(device)):
            self.conv_in = Conv2D(input_nc, ndf, 4, stride=2, padding=1, dtype=dtype)
            ch = ndf
            for n in range(1, n_layers + 1):
                out = ndf * min(2 ** n, 8)
                self.add_module(f"conv_{n}", Conv2D(ch, out, 4, stride=2 if n < n_layers else 1,
                                                    padding=1, dtype=dtype, use_bias=False))
                self.add_module(f"norm_{n}", GroupNorm32(out, 32, eps=1e-6))
                ch = out
            self.conv_out = Conv2D(ch, 1, 4, padding=1, dtype=dtype)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """JAX's initialisers: convolutions ~ N(0, 0.02^2) drawn from
        `generator` (a CPU one: the same weights on any device), biases 0,
        norm scales 1."""
        for name, p in self.named_parameters():
            if name.startswith("conv") and name.endswith("weight"):
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))
            else:
                p.fill_(1.0 if name.startswith("norm") and name.endswith("weight") else 0.0)

    def forward(self, x):
        h = F.leaky_relu(self.conv_in(x.permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm_{n}")(h), 0.2)
        return self.conv_out(h).permute(0, 2, 3, 1)
