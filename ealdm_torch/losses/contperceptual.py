"""KL-VAE loss (counterpart of `ealdm_tpu/losses/contperceptual.py`): L1 +
LPIPS under a learned-logvar NLL, the KL term, and the adaptive GAN term.

The reference's `LPIPSWithDiscriminator` (`contperceptual.py:7-110`): the
generator branch is the weighted NLL + kl_weight * KL + d_weight *
disc_factor * g_loss, d_weight = ||grad nll|| / (||grad g|| + 1e-4) clamped
to [0, 1e4] (`:32-43`); the discriminator branch is the hinge or vanilla
loss of the real and fake logits after the warm-up. As in the JAX package
the two gradients of d_weight are taken with respect to the reconstruction
(`adaptive_d_weight`), not the decoder's last layer.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.device import resolve_device
from .discriminator import NLayerDiscriminator
from .gan import adopt_weight, hinge_d_loss, vanilla_d_loss
from .lpips import LPIPS


def _logits(disc, x, cond):
    return disc(x if cond is None else torch.cat([x, cond], -1))


def resolve_d_weight(d_weight, nll, g):
    """d_weight as given, or, when it is a function, its value at the weighted
    NLL and the GAN loss (the train step's adaptive weight, from their
    gradients with respect to the reconstruction)."""
    return d_weight(nll, g) if callable(d_weight) else d_weight


class LPIPSWithDiscriminator(nn.Module):
    def __init__(self, disc_start: int, logvar_init: float = 0.0, kl_weight: float = 1.0,
                 pixelloss_weight: float = 1.0, disc_num_layers: int = 3,
                 disc_in_channels: int = 3, disc_factor: float = 1.0, disc_weight: float = 1.0,
                 perceptual_weight: float = 1.0, disc_conditional: bool = False,
                 disc_loss: str = "hinge", dtype=torch.float32, device=None):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r} is not 'hinge' or 'vanilla'")
        self.disc_start = disc_start
        self.kl_weight, self.pixelloss_weight = kl_weight, pixelloss_weight
        self.disc_factor, self.disc_weight = disc_factor, disc_weight
        self.perceptual_weight, self.disc_conditional = perceptual_weight, disc_conditional
        dev = resolve_device(device)
        # a parameter of the module; the trainer does not update it (the
        # reference's opt_ae leaves it out)
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init), device=dev))
        self.perceptual = LPIPS(dtype, dev)
        self.discriminator = NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers,
                                                 dtype=dtype, device=dev)
        self._d_loss = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss

    def nll_loss(self, inputs, reconstructions, weights=None):
        """(weighted NLL, NLL, mean reconstruction loss), the NLLs summed
        over pixels and averaged over the batch."""
        rec = torch.abs(inputs - reconstructions) * self.pixelloss_weight
        if self.perceptual_weight > 0:
            p = self.perceptual(inputs, reconstructions)
            rec = rec + self.perceptual_weight * p[:, None, None, None]
        nll = rec / torch.exp(self.logvar) + self.logvar
        weighted = nll if weights is None else weights * nll
        b = nll.shape[0]
        return torch.sum(weighted) / b, torch.sum(nll) / b, torch.mean(rec)

    def g_loss(self, reconstructions, cond=None):
        if (cond is not None) != self.disc_conditional:
            raise ValueError("cond must be given exactly when disc_conditional")
        return -torch.mean(_logits(self.discriminator, reconstructions, cond))

    def generator_loss(self, inputs, reconstructions, posterior, global_step, d_weight,
                       cond=None, weights=None, split: str = "train"):
        """(loss, log) of the autoencoder's update. d_weight: a number, or a
        function of (weighted NLL, GAN loss) that gives it
        (`resolve_d_weight`)."""
        weighted_nll, nll, rec_mean = self.nll_loss(inputs, reconstructions, weights)
        kl = torch.sum(posterior.kl()) / posterior.mean.shape[0]
        g = self.g_loss(reconstructions, cond)
        d_weight = resolve_d_weight(d_weight, weighted_nll, g)
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        loss = weighted_nll + self.kl_weight * kl + d_weight * disc_factor * g
        log = {
            f"{split}/total_loss": loss,
            f"{split}/logvar": self.logvar,
            f"{split}/kl_loss": kl,
            f"{split}/nll_loss": nll,
            f"{split}/rec_loss": rec_mean,
            f"{split}/d_weight": torch.as_tensor(d_weight),
            f"{split}/disc_factor": disc_factor,
            f"{split}/g_loss": g,
        }
        return loss, log

    def discriminator_loss(self, inputs, reconstructions, global_step, cond=None,
                           split: str = "train"):
        return discriminator_loss(self, inputs, reconstructions, global_step, cond, split)


def discriminator_loss(loss, inputs, reconstructions, global_step, cond=None,
                       split: str = "train"):
    """(loss, log) of the discriminator's update under either GAN loss
    module: its logits on the detached inputs and reconstructions."""
    inputs, reconstructions = inputs.detach(), reconstructions.detach()
    logits_real = _logits(loss.discriminator, inputs, cond)
    logits_fake = _logits(loss.discriminator, reconstructions, cond)
    disc_factor = adopt_weight(loss.disc_factor, global_step, loss.disc_start)
    d_loss = disc_factor * loss._d_loss(logits_real, logits_fake)
    log = {
        f"{split}/disc_loss": d_loss,
        f"{split}/logits_real": torch.mean(logits_real),
        f"{split}/logits_fake": torch.mean(logits_fake),
    }
    return d_loss, log


def adaptive_d_weight(nll_grad_rec, g_grad_rec, disc_weight: float):
    """d_weight from the gradient norms with respect to the reconstruction,
    clamped to [0, 1e4] and scaled by disc_weight."""
    num = torch.linalg.vector_norm(nll_grad_rec)
    den = torch.linalg.vector_norm(g_grad_rec) + 1e-4
    return torch.clamp(num / den, 0.0, 1e4) * disc_weight
