"""GAN loss primitives of the first-stage losses (counterpart of
`ealdm_tpu/losses/gan.py`: taming's hinge_d_loss / vanilla_d_loss /
adopt_weight as the reference's contperceptual.py and vqperceptual.py use
them)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight, global_step, threshold=0, value=0.0) -> torch.Tensor:
    """`weight` from `threshold` on, `value` before (the discriminator's
    warm-up), as a 0-d float32 tensor on the step's device; global_step is
    an int or a 0-d tensor."""
    step = torch.as_tensor(global_step)
    return torch.where(step < threshold, torch.tensor(float(value), device=step.device),
                       torch.tensor(float(weight), device=step.device))


def measure_perplexity(indices, n_classes: int):
    """(perplexity, clusters used) of the code indices' histogram."""
    counts = torch.bincount(indices.reshape(-1), minlength=n_classes).float()
    probs = counts / indices.numel()
    perplexity = torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))
    return perplexity, torch.sum(probs > 0)


def hinge_d_loss_with_exemplar_weights(logits_real, logits_fake, weights):
    """Hinge loss with per-sample spatial means, averaged over the batch by
    `weights` (the reference's `vqperceptual.py:11-18`)."""
    if not weights.shape[0] == logits_real.shape[0] == logits_fake.shape[0]:
        raise ValueError("one weight a sample")
    axes = tuple(range(1, logits_real.dim()))
    loss_real = torch.mean(F.relu(1.0 - logits_real), dim=axes)
    loss_fake = torch.mean(F.relu(1.0 + logits_fake), dim=axes)
    wsum = torch.sum(weights)
    return 0.5 * (torch.sum(weights * loss_real) / wsum + torch.sum(weights * loss_fake) / wsum)
