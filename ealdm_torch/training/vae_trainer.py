"""Two-optimizer VAE-GAN training of the first stages (counterpart of
`ealdm_tpu/training/vae_trainer.py`): the reference's alternating Lightning
protocol (`autoencoder.py:142-162,330-372`) with Adam (0.5, 0.9)
(`:410-417`), one call a step:

  1. the autoencoder's forward (a KL posterior sample from the step's
     generator, or `noise`);
  2. the adaptive d_weight from the gradients of the NLL and of the GAN
     loss with respect to the reconstruction: two `torch.autograd.grad`
     calls on the one forward's graph (JAX runs a second forward with the
     same parameters and key, whose reconstruction is the same);
  3. the autoencoder's update: the generator loss's gradient with respect
     to the autoencoder's parameters only;
  4. the discriminator's update from its loss on the detached
     pre-update reconstruction, at the pre-update discriminator.

Both losses read the state's step before its increment, so the GAN terms
are off while step < disc_start. Gradients are taken with
`torch.autograd.grad` over each update's own parameters: the generator
loss reaches the discriminator's and LPIPS's parameters, and nothing of
that lands in an update or a `.grad`. LPIPS is frozen, and the loss
module's `logvar` stays at its initial value (as the reference's opt_ae,
which leaves it out).

The state is updated in place: its parameter dicts hold the modules' own
parameters. Adam is `trainer.AdamW` with weight decay 0 (optax.adam's
arithmetic: eps 1e-8 outside the root, bias-corrected).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..losses import adaptive_d_weight, build_loss
from ..models.ddpm import build_first_stage
from ..models.vae import AutoencoderKL
from ..utils.device import check_module_device
from ..utils.init import random_init_
from ..weights import load_lpips_params
from .trainer import AdamW, AdamWState, _copy_into, _seed

_DISC = "discriminator."


def build_autoencoder(model_config: Dict, dtype=torch.float32, device=None):
    """(autoencoder, loss module) of a first stage's trainable config
    {target, params: {..., lossconfig}} (`zoo._fs_train_config`,
    `config.VQ_F8_AE_TRAIN`), both on `device` ("cuda" unless given)."""
    vae = build_first_stage(model_config, dtype, device)
    return vae, build_loss(model_config["params"]["lossconfig"], dtype, device)


def random_init_autoencoder_(vae, loss_module, seed: int) -> None:
    """Seeded random weights for a first stage and its loss module:
    `utils.init.random_init_` for the autoencoder (seed) and LPIPS's VGG
    trunk (seed + 1), the discriminator's N(0, 0.02^2) (seed + 2); LPIPS's
    heads and logvar keep their initial values."""
    random_init_(vae, seed)
    perceptual = getattr(loss_module, "perceptual", None)
    if perceptual is not None:
        random_init_(perceptual.vgg, seed + 1)
    loss_module.discriminator.init_weights_(torch.Generator().manual_seed(seed + 2))


@dataclasses.dataclass
class VAETrainState:
    step: int
    ae_params: Dict[str, torch.Tensor]    # the autoencoder's own parameters
    loss_params: Dict[str, torch.Tensor]  # LPIPS, logvar, the discriminator (trained)
    opt_ae_state: AdamWState
    opt_disc_state: AdamWState

    def state_dict(self) -> Dict[str, Any]:
        """Tensors, numbers and dicts only (loads with weights_only=True)."""
        return {"step": self.step,
                "ae_params": {k: p.detach() for k, p in self.ae_params.items()},
                "loss_params": {k: p.detach() for k, p in self.loss_params.items()},
                "opt_ae_state": dict(vars(self.opt_ae_state)),
                "opt_disc_state": dict(vars(self.opt_disc_state))}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a `state_dict` into this state's tensors, in place."""
        _copy_into(self.ae_params, sd["ae_params"])
        _copy_into(self.loss_params, sd["loss_params"])
        for opt, saved in ((self.opt_ae_state, sd["opt_ae_state"]),
                           (self.opt_disc_state, sd["opt_disc_state"])):
            _copy_into(opt.mu, saved["mu"])
            _copy_into(opt.nu, saved["nu"])
            opt.count, opt.mini_step = saved["count"], saved["mini_step"]
        self.step = sd["step"]


def init_vae_train_state(vae, loss_module, learning_rate: float, lr_g_factor: float = 1.0,
                         device=None) -> Tuple[VAETrainState, AdamW, AdamW]:
    """(state, opt_ae, opt_disc) of `vae` and `loss_module` as they stand
    (their parameters are the state's): Adam (0.5, 0.9) at learning_rate *
    lr_g_factor over the autoencoder's parameters and at learning_rate over
    the discriminator's. device: where both must live, "cuda" unless given.
    A canonical LPIPS checkpoint in $EALDM_WEIGHTS_DIR is copied into the
    loss module's LPIPS first (`weights.load_lpips_params`)."""
    check_module_device(vae, device)
    check_module_device(loss_module, device)
    if hasattr(loss_module, "perceptual"):
        load_lpips_params(loss_module.perceptual)
    opt_ae = AdamW(learning_rate * lr_g_factor, weight_decay=0.0, b1=0.5, b2=0.9)
    opt_disc = AdamW(learning_rate, weight_decay=0.0, b1=0.5, b2=0.9)
    ae_params = dict(vae.named_parameters())
    loss_params = dict(loss_module.named_parameters())
    state = VAETrainState(
        step=0, ae_params=ae_params, loss_params=loss_params,
        opt_ae_state=opt_ae.init(ae_params),
        opt_disc_state=opt_disc.init({k: p for k, p in loss_params.items()
                                      if k.startswith(_DISC)}))
    return state, opt_ae, opt_disc


def _forward(vae, is_kl, x, generator, noise, dev):
    """(reconstruction, KL posterior or (codebook loss, indices))."""
    if not is_kl:
        rec, qloss, ind = vae(x)
        return rec, (qloss, ind)
    if noise is None:
        generator = torch.Generator(device=dev).manual_seed(_seed(generator))
    return vae(x, generator, noise=noise)


def _generator_loss(loss_module, is_kl, x, rec, aux, step, d_weight, split="train"):
    if is_kl:
        return loss_module.generator_loss(x, rec, aux, step, d_weight, split=split)
    qloss, ind = aux
    return loss_module.generator_loss(qloss, x, rec, step, d_weight, None, ind, split=split)


def _grads(loss, params: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    return dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))


def make_vae_train_step(vae, loss_module, opt_ae: AdamW, opt_disc: AdamW, device=None):
    """(state, batch, generator=None, noise=None) -> (state, metrics): one
    step of both updates on batch["image"] [N, H, W, 3]. A KL posterior's
    noise is `noise` when given (a checked step replays host noise: the
    card's and the CPU's generators differ), else drawn from a generator on
    the model's device seeded from `generator`. metrics: the loss modules'
    train/* logs, "aeloss" and "discloss", as detached 0-d tensors."""
    dev = check_module_device(vae, device)
    is_kl = isinstance(vae, AutoencoderKL)

    def step(state: VAETrainState, batch, generator: Optional[torch.Generator] = None,
             noise=None):
        x = batch["image"]
        gstep = state.step
        rec, aux = _forward(vae, is_kl, x, generator, noise, dev)

        def d_weight(nll, g):
            nll_grad, = torch.autograd.grad(nll, rec, retain_graph=True)
            g_grad, = torch.autograd.grad(g, rec, retain_graph=True)
            return adaptive_d_weight(nll_grad, g_grad, loss_module.disc_weight).detach()

        g_total, g_log = _generator_loss(loss_module, is_kl, x, rec, aux, gstep, d_weight)
        grads = _grads(g_total, state.ae_params, state.opt_ae_state.mu)
        opt_ae.apply(state.ae_params, grads, state.opt_ae_state)
        del grads
        d_total, d_log = loss_module.discriminator_loss(x, rec.detach(), gstep)
        d_grads = _grads(d_total, state.loss_params, state.opt_disc_state.mu)
        opt_disc.apply(state.loss_params, d_grads, state.opt_disc_state)
        state.step += 1
        metrics = {**g_log, **d_log, "aeloss": g_total, "discloss": d_total}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_vae_eval_step(vae, loss_module, device=None):
    """(state, batch, generator=None, noise=None) -> the val/* logs of both
    branches at the state's step, d_weight 1 (the reference's
    `_validation_step`)."""
    dev = check_module_device(vae, device)
    is_kl = isinstance(vae, AutoencoderKL)

    @torch.no_grad()
    def eval_step(state: VAETrainState, batch, generator: Optional[torch.Generator] = None,
                  noise=None):
        x = batch["image"]
        rec, aux = _forward(vae, is_kl, x, generator, noise, dev)
        _, log_ae = _generator_loss(loss_module, is_kl, x, rec, aux, state.step, 1.0, "val")
        _, log_d = loss_module.discriminator_loss(x, rec, state.step, split="val")
        return {**log_ae, **log_d}

    return eval_step
