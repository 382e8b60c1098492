"""Latent distributions (counterpart of `ealdm_tpu/models/distributions.py`).

`normal_kl` is the prior term of the VLB (`LatentDiffusion.prior_bpd`). The
JAX module's `DiagonalGaussian` is the KL autoencoder's posterior; it comes
with `AutoencoderKL`, which the port does not have yet.
"""
from __future__ import annotations

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """Elementwise KL between two diagonal Gaussians; any argument may be a
    tensor or a Python number (broadcasting)."""
    mean1, logvar1, mean2, logvar2 = (
        x if isinstance(x, torch.Tensor) else torch.tensor(float(x))
        for x in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2).square() * torch.exp(-logvar2))
