"""Latent distributions (counterpart of `ealdm_tpu/models/distributions.py`).

`DiagonalGaussian` is the KL autoencoder's posterior, with the channel-last
moment layout of the JAX package ([..., 2C]: mean || logvar). `normal_kl` is
the prior term of the VLB (`LatentDiffusion.prior_bpd`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..parallel import draws


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Factored Gaussian parameterised by [..., 2C] moments (mean || logvar)."""

    mean: torch.Tensor
    logvar: torch.Tensor
    deterministic: bool = False

    @classmethod
    def from_moments(cls, parameters: torch.Tensor, deterministic: bool = False):
        mean, logvar = parameters.chunk(2, dim=-1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0), deterministic=deterministic)

    @property
    def std(self):
        return torch.zeros_like(self.mean) if self.deterministic else torch.exp(0.5 * self.logvar)

    @property
    def var(self):
        return torch.zeros_like(self.mean) if self.deterministic else torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise=None):
        """mean + std * noise, the noise drawn from `generator` unless given
        (a test replays another framework's draw through `noise`)."""
        if noise is None:
            noise = draws.randn(self.mean.shape, generator, dtype=self.mean.dtype,
                                device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self):
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None):
        """KL to the standard normal (or to `other`), summed over the
        non-batch dims."""
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype,
                               device=self.mean.device)
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * (self.mean.square() + self.var - 1.0 - self.logvar).sum(dims)
        return 0.5 * ((self.mean - other.mean).square() / other.var + self.var / other.var
                      - 1.0 - self.logvar + other.logvar).sum(dims)

    def nll(self, sample, dims=None):
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype,
                               device=self.mean.device)
        if dims is None:
            dims = tuple(range(1, self.mean.dim()))
        return 0.5 * (math.log(2.0 * math.pi) + self.logvar
                      + (sample - self.mean).square() / self.var).sum(dims)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """Elementwise KL between two diagonal Gaussians; any argument may be a
    tensor or a Python number (broadcasting)."""
    mean1, logvar1, mean2, logvar2 = (
        x if isinstance(x, torch.Tensor) else torch.tensor(float(x))
        for x in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2).square() * torch.exp(-logvar2))
