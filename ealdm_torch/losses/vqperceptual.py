"""VQ-GAN loss (counterpart of `ealdm_tpu/losses/vqperceptual.py`): pixel
(L1 or L2) + LPIPS, the codebook loss, the adaptive GAN term and, with
`n_classes`, the codes' perplexity in the log.

The reference's `VQLPIPSWithDiscriminator` (`vqperceptual.py:43-167`): the
generator branch is the mean NLL + d_weight * disc_factor * g_loss +
codebook_weight * codebook loss; the discriminator branch as the KL
variant's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .contperceptual import _logits, discriminator_loss, resolve_d_weight
from .discriminator import NLayerDiscriminator
from .gan import adopt_weight, hinge_d_loss, measure_perplexity, vanilla_d_loss
from .lpips import LPIPS


class VQLPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start: int, codebook_weight: float = 1.0,
                 pixelloss_weight: float = 1.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_conditional: bool = False,
                 disc_ndf: int = 64, disc_loss: str = "hinge", n_classes: Optional[int] = None,
                 pixel_loss: str = "l1", dtype=torch.float32, device=None):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r} is not 'hinge' or 'vanilla'")
        if pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {pixel_loss!r} is not 'l1' or 'l2'")
        self.disc_start, self.codebook_weight = disc_start, codebook_weight
        self.pixelloss_weight, self.perceptual_weight = pixelloss_weight, perceptual_weight
        self.disc_factor, self.disc_weight = disc_factor, disc_weight
        self.disc_conditional, self.n_classes, self.pixel_loss = (disc_conditional, n_classes,
                                                                  pixel_loss)
        dev = resolve_device(device)
        self.perceptual = LPIPS(dtype, dev)
        self.discriminator = NLayerDiscriminator(disc_in_channels, disc_ndf, disc_num_layers,
                                                 dtype=dtype, device=dev)
        self._d_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss

    def _pixel(self, a, b):
        return torch.abs(a - b) if self.pixel_loss == "l1" else torch.square(a - b)

    def nll_loss(self, inputs, reconstructions):
        """(NLL, mean reconstruction loss): the same number twice, as JAX's."""
        rec = self._pixel(inputs, reconstructions) * self.pixelloss_weight
        if self.perceptual_weight > 0:
            p = self.perceptual(inputs, reconstructions)
            rec = rec + self.perceptual_weight * p[:, None, None, None]
        return torch.mean(rec), torch.mean(rec)

    def g_loss(self, reconstructions, cond=None):
        return -torch.mean(_logits(self.discriminator, reconstructions, cond))

    def generator_loss(self, codebook_loss, inputs, reconstructions, global_step, d_weight,
                       cond=None, predicted_indices=None, split: str = "train"):
        """(loss, log) of the autoencoder's update; d_weight as in
        `LPIPSWithDiscriminator.generator_loss`."""
        nll, rec_mean = self.nll_loss(inputs, reconstructions)
        g = self.g_loss(reconstructions, cond)
        d_weight = resolve_d_weight(d_weight, nll, g)
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        quant = torch.mean(codebook_loss)
        loss = nll + d_weight * disc_factor * g + self.codebook_weight * quant
        log = {
            f"{split}/total_loss": loss,
            f"{split}/quant_loss": quant,
            f"{split}/nll_loss": nll,
            f"{split}/rec_loss": rec_mean,
            f"{split}/d_weight": torch.as_tensor(d_weight),
            f"{split}/disc_factor": disc_factor,
            f"{split}/g_loss": g,
        }
        if predicted_indices is not None and self.n_classes is not None:
            perplexity, usage = measure_perplexity(predicted_indices, self.n_classes)
            log[f"{split}/perplexity"] = perplexity
            log[f"{split}/cluster_usage"] = usage
        return loss, log

    def discriminator_loss(self, inputs, reconstructions, global_step, cond=None,
                           split: str = "train"):
        return discriminator_loss(self, inputs, reconstructions, global_step, cond, split)
