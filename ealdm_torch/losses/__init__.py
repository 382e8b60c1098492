"""First-stage training losses (counterpart of `ealdm_tpu/losses`): LPIPS,
the PatchGAN discriminator, the KL- and VQ-VAE GAN objectives, and
`build_loss`, the loss rows of the JAX package's target registry
(`ealdm_tpu/config.py:95-98`)."""

from ..utils.device import resolve_device
from .contperceptual import LPIPSWithDiscriminator, adaptive_d_weight
from .discriminator import NLayerDiscriminator
from .gan import (adopt_weight, hinge_d_loss, hinge_d_loss_with_exemplar_weights,
                  measure_perplexity, vanilla_d_loss)
from .lpips import LPIPS, VGG16Features, load_torch_lpips_weights
from .vqperceptual import VQLPIPSWithDiscriminator

# a lossconfig's target -> the loss module it builds
LOSS_TARGETS = {
    "ldm.modules.losses.LPIPSWithDiscriminator": LPIPSWithDiscriminator,
    "ldm.modules.losses.contperceptual.LPIPSWithDiscriminator": LPIPSWithDiscriminator,
    "taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator": VQLPIPSWithDiscriminator,
    "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator": VQLPIPSWithDiscriminator,
}


def build_loss(lossconfig: dict, dtype=None, device=None):
    """The loss module of a first stage's `lossconfig` {target, params}, built
    on `device` ("cuda" unless given)."""
    target = lossconfig["target"]
    if target not in LOSS_TARGETS:
        raise NotImplementedError(f"loss {target!r} is not ported")
    kwargs = dict(lossconfig.get("params", {}))
    if dtype is not None:
        kwargs["dtype"] = dtype
    return LOSS_TARGETS[target](**kwargs, device=resolve_device(device))


__all__ = [
    "LOSS_TARGETS",
    "LPIPS",
    "VGG16Features",
    "load_torch_lpips_weights",
    "NLayerDiscriminator",
    "LPIPSWithDiscriminator",
    "VQLPIPSWithDiscriminator",
    "adaptive_d_weight",
    "adopt_weight",
    "build_loss",
    "hinge_d_loss",
    "hinge_d_loss_with_exemplar_weights",
    "vanilla_d_loss",
    "measure_perplexity",
]
