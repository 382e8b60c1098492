"""LatentDiffusion (counterpart of `ealdm_tpu/models/ddpm.py`).

Builders for the flagship's three targets (the UNet, the VQ first stage and
the STDiff UnetCond tower), DiffusionWrapper with crossattn conditioning, the
CFG conditioning pair, apply_model with the hoisted step invariants, the
first-stage encode and decode, and the training objective: q_sample and the
posterior algebra, the eps loss with training-time CFG (one 2N-batched UNet
call, [c_neg, c_pos] order), the logvar table, the VLB weighting and the
shortened conditioning schedule.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.schedules import DiffusionSchedule, extract
from ..utils.device import resolve_device
from .distributions import normal_kl
from .stdiff import UnetCond
from .unet import UNetModel
from .vae import VQModel


def build_unet(unet_config: Dict[str, Any], dtype=torch.float32) -> UNetModel:
    cfg = dict(unet_config)
    for k in ("use_checkpoint", "use_fp16", "data_format"):
        cfg.pop(k, None)
    return UNetModel(**cfg, dtype=dtype)


def build_first_stage(config: Dict[str, Any], dtype=torch.float32) -> VQModel:
    target = config.get("target", "identity")
    params = dict(config.get("params", {}))
    if target.endswith("VQModelInterface") or target.endswith("VQModel"):
        return VQModel(ddconfig=dict(params["ddconfig"]), n_embed=params["n_embed"],
                       embed_dim=params["embed_dim"], dtype=dtype)
    raise NotImplementedError(f"first stage {target!r} is not ported yet")


def build_cond_stage(config: Dict[str, Any], feat_hw: int,
                     dtype=torch.float32) -> UnetCond:
    """The STDiff UnetCond tower; feat_hw is the side of the first-stage
    feature map it reads."""
    target = config.get("target", "")
    if not target.endswith("UnetCond"):
        raise NotImplementedError(f"cond stage {target!r} is not ported yet")
    params = dict(config.get("params", {}))
    cond_args = dict(params.pop("cond_args", {}))
    if cond_args.get("noise_f_int"):
        cond_args["noise_f_int"] = [t for t in cond_args["noise_f_int"] if t]
    kwargs = {k: params[k] for k in (
        "mid_dim", "emb_dim", "out_dim", "w_dim", "f_dim", "hidden_dim",
        "num_layers", "num_ws", "norm") if k in params}
    if "dims" in cond_args:
        kwargs["t_dim"] = int(cond_args["dims"])
    return UnetCond(cond_args=cond_args, feat_hw=feat_hw, dtype=dtype, **kwargs)


class DiffusionWrapper(nn.Module):
    """conditioning_key dispatch around the UNet (None and crossattn)."""

    def __init__(self, unet_config, conditioning_key=None, dtype=torch.float32):
        super().__init__()
        if conditioning_key not in (None, "crossattn"):
            raise NotImplementedError(
                f"conditioning_key {conditioning_key!r} is not ported yet")
        self.conditioning_key = conditioning_key
        self.diffusion_model = build_unet(unet_config, dtype)

    def forward(self, x, t, c_crossattn=None, context_kv=None, emb_tables=None):
        hoist = dict(context_kv=context_kv, emb_tables=emb_tables)
        if self.conditioning_key is None:
            return self.diffusion_model(x, t, **hoist)
        if c_crossattn is None and context_kv is None:
            # attn2 would silently run as self-attention (context = x)
            raise ValueError("crossattn conditioning requires c_crossattn or context_kv")
        cc = None if c_crossattn is None else torch.cat(list(c_crossattn), dim=1)
        return self.diffusion_model(x, t, context=cc, **hoist)


class LatentDiffusion(nn.Module):
    """Latent diffusion with a frozen VQ first stage and the STDiff cond stage.

    The keyword arguments are `model.params` of the JAX package's configs
    (see `ealdm_torch.config`). The module is built on `device` ("cuda"
    unless the caller asks for another; "meta" builds shapes only). The
    first stage never trains: its parameters are built with
    requires_grad=False, as the reference freezes it, and the cond stage
    too when `cond_stage_trainable` is false."""

    def __init__(self, unet_config, first_stage_config, cond_stage_config,
                 timesteps: int = 1000, beta_schedule: str = "linear",
                 linear_start: float = 1e-4, linear_end: float = 2e-2,
                 cosine_s: float = 8e-3, parameterization: str = "eps",
                 loss_type: str = "l2", conditioning_key: Optional[str] = None,
                 first_stage_key: str = "img", cond_stage_key: str = "image",
                 cond_stage_trainable: bool = False, num_timesteps_cond: int = 1,
                 scale_factor: float = 1.0, unconditional_guidance_scale: float = 2.0,
                 learn_logvar: bool = False, logvar_init: float = 0.0,
                 l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if parameterization != "eps":
            raise NotImplementedError(
                f"parameterization {parameterization!r} is not ported yet")
        if loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type {loss_type!r}")
        if not 1 <= num_timesteps_cond <= timesteps:
            raise ValueError(f"num_timesteps_cond {num_timesteps_cond} not in 1..{timesteps}")
        dev = resolve_device(device)
        self.timesteps, self.beta_schedule = timesteps, beta_schedule
        self.linear_start, self.linear_end, self.cosine_s = linear_start, linear_end, cosine_s
        self.loss_type = loss_type
        self.conditioning_key = conditioning_key
        self.first_stage_key, self.cond_stage_key = first_stage_key, cond_stage_key
        self.cond_stage_trainable = cond_stage_trainable
        self.scale_factor = scale_factor
        self.unconditional_guidance_scale = unconditional_guidance_scale
        self.l_simple_weight = l_simple_weight
        self.original_elbo_weight = original_elbo_weight
        self.unet_config = dict(unet_config)
        self.dtype = dtype
        dd = first_stage_config["params"]["ddconfig"]
        feat_hw = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
        with torch.device(dev):
            self.model = DiffusionWrapper(unet_config, conditioning_key, dtype)
            self.first_stage_model = build_first_stage(first_stage_config, dtype)
            self.cond_stage_model = build_cond_stage(cond_stage_config, feat_hw, dtype)
            logvar = torch.full((timesteps,), float(logvar_init))
            if learn_logvar:
                self.logvar = nn.Parameter(logvar)
            else:
                self.register_buffer("logvar", logvar, persistent=False)
        self.first_stage_model.requires_grad_(False)
        if not cond_stage_trainable:
            self.cond_stage_model.requires_grad_(False)
        self.schedule = DiffusionSchedule.create(
            timesteps=timesteps, beta_schedule=beta_schedule,
            linear_start=linear_start, linear_end=linear_end, cosine_s=cosine_s,
            device=dev,
        )
        # the shortened conditioning-noise schedule (reference
        # make_cond_schedule); active only when num_timesteps_cond > 1
        cond_ids = torch.full((timesteps,), timesteps - 1, dtype=torch.int64)
        if num_timesteps_cond > 1:
            ids = np.round(np.linspace(0, timesteps - 1, num_timesteps_cond)).astype(np.int64)
            cond_ids[:num_timesteps_cond] = torch.from_numpy(ids)
        self.cond_ids = cond_ids.to(dev)
        self.shorten_cond_schedule = num_timesteps_cond > 1

    # ------------------------------------------------------------- first stage
    def encode_first_stage(self, x):
        """Image [N, H, W, 3] -> the un-quantized latent, without gradient."""
        with torch.no_grad():
            return self.first_stage_model.encode_prequant(x)

    def get_first_stage_encoding(self, z):
        return self.scale_factor * z

    def decode_first_stage(self, z):
        """Latent [N, h, w, 4] -> image [N, H, W, 3] (quantized first)."""
        return self.first_stage_model.decode_interface((1.0 / self.scale_factor) * z)

    def quantize_latent(self, z):
        return self.first_stage_model.quantize(z)[0]

    # ------------------------------------------------------------- conditioning
    def _mixed_image_features(self, img):
        """The frozen first-stage encoder's features, without gradient."""
        with torch.no_grad():
            return self.first_stage_model.encoder(img)

    def _check_mixed(self):
        if self.cond_stage_key != "mixed":
            raise NotImplementedError("only the 'mixed' STDiff conditioning is ported")

    def get_learned_conditioning(self, cond, fuse_env: bool = True, generator=None,
                                 features=None):
        """`mixed` conditioning dict (img, flow, weather, time) -> context.
        features: the first-stage features of cond["img"], if already
        computed; generator: the dropout source (train() mode)."""
        self._check_mixed()
        feat = self._mixed_image_features(cond["img"]) if features is None else features
        return self.cond_stage_model(feat, cond["flow"], cond["weather"], cond["time"],
                                     fuse_env=fuse_env, generator=generator)

    def get_learned_conditioning_pair(self, mixed, generator=None, features=None):
        """(c_neg, c_pos): the negative is the other-site image `img_random`
        with env fusion off. Both images go through the encoder as one
        2N-batched call (or come as `features`, that call's output)."""
        self._check_mixed()
        n = mixed["img"].shape[0]
        feat2 = features
        if feat2 is None:
            feat2 = self._mixed_image_features(
                torch.cat([mixed["img"], mixed["img_random"]], dim=0))
        args = (mixed["flow"], mixed["weather"], mixed["time"])
        c_pos = self.cond_stage_model(feat2[:n], *args, fuse_env=True, generator=generator)
        c_neg = self.cond_stage_model(feat2[n:], *args, fuse_env=False, generator=generator)
        return c_neg, c_pos

    # ------------------------------------------------------------- denoiser
    def apply_model(self, x_noisy, t, cond_context, context_kv=None, emb_tables=None):
        """The denoiser on already-encoded conditioning; context_kv /
        emb_tables are the hoisted step invariants (inference.hoist_invariants)."""
        hoist = dict(context_kv=context_kv, emb_tables=emb_tables)
        if self.conditioning_key is None or cond_context is None:
            return self.model(x_noisy, t, **hoist)
        ca = list(cond_context) if isinstance(cond_context, (list, tuple)) else [cond_context]
        return self.model(x_noisy, t, c_crossattn=ca, **hoist)

    # ------------------------------------------------------------- diffusion math
    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.dim()) * noise)

    def q_mean_variance(self, x_start, t):
        """Moments of q(x_t | x_0): (mean, variance, log variance)."""
        s = self.schedule
        mean = extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
        log_var = extract(s.log_one_minus_alphas_cumprod, t, x_start.dim())
        return mean, torch.exp(log_var), log_var

    def prior_bpd(self, x_start):
        """KL(q(x_T | x_0) || N(0, I)) in bits per dim, one value per batch
        element (a diagnostic, not trained)."""
        b = x_start.shape[0]
        t = torch.full((b,), self.schedule.num_timesteps - 1, dtype=torch.int64,
                       device=x_start.device)
        qt_mean, _, qt_log_var = self.q_mean_variance(x_start, t)
        kl = normal_kl(qt_mean, qt_log_var, 0.0, 0.0)
        return kl.reshape(b, -1).mean(dim=1) / math.log(2.0)

    def predict_start_from_noise(self, x_t, t, noise):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * noise)

    def predict_eps_from_xstart(self, x_t, t, pred_xstart):
        """The inverse of predict_start_from_noise: eps from a predicted x0."""
        s = self.schedule
        return ((extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t - pred_xstart)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()))

    def q_posterior(self, x_start, x_t, t):
        """(mean, variance, clipped log variance) of q(x_{t-1} | x_t, x_0)."""
        s = self.schedule
        mean = (extract(s.posterior_mean_coef1, t, x_t.dim()) * x_start
                + extract(s.posterior_mean_coef2, t, x_t.dim()) * x_t)
        return (mean, extract(s.posterior_variance, t, x_t.dim()),
                extract(s.posterior_log_variance_clipped, t, x_t.dim()))

    # ------------------------------------------------------------- losses
    def _pixel_loss(self, pred, target):
        if self.loss_type == "l1":
            return (target - pred).abs()
        return (target - pred).square()

    def p_losses(self, x_start, cond_context, t, noise):
        """(loss, metrics) of the eps objective. cond_context is None, [N,
        ...] or the [2N, ...] CFG pair (first half negative, second half
        positive): then the UNet runs once on the 2N batch and its output is
        guided with `unconditional_guidance_scale`."""
        x_noisy = self.q_sample(x_start, t, noise)
        cfg = (cond_context is not None and self.unconditional_guidance_scale != 1.0
               and cond_context.shape[0] == 2 * x_start.shape[0])
        if cfg:
            out = self.apply_model(torch.cat([x_noisy] * 2), torch.cat([t] * 2), cond_context)
            e_uncond, e_cond = out.chunk(2, dim=0)
            model_output = e_uncond + self.unconditional_guidance_scale * (e_cond - e_uncond)
        else:
            model_output = self.apply_model(x_noisy, t, cond_context)
        loss_simple = self._pixel_loss(model_output, noise).mean(
            dim=tuple(range(1, x_start.dim())))
        logvar_t = self.logvar[t]
        loss = self.l_simple_weight * (loss_simple / torch.exp(logvar_t) + logvar_t).mean()
        loss_vlb = (self.schedule.lvlb_weights[t] * loss_simple).mean()
        total = loss + self.original_elbo_weight * loss_vlb
        return total, {"loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb,
                       "loss": total}

    # ------------------------------------------------------------- train entry
    def _cfg_pair(self) -> bool:
        return (self.conditioning_key is not None and self.cond_stage_key == "mixed"
                and self.unconditional_guidance_scale != 1.0)

    def encode_inputs(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The frozen first-stage work of a training batch, without
        gradient: "z", the scaled latent of the target frames, and
        "features", the encoder features of the conditioning images (the 2N
        [img, img_random] pair under training-time CFG) or None."""
        x = batch.get("img", batch.get(self.first_stage_key))
        z = self.get_first_stage_encoding(self.encode_first_stage(x))
        features = None
        if self.conditioning_key is not None and self.cond_stage_key == "mixed":
            mixed = batch["mixed"]
            imgs = (torch.cat([mixed["img"], mixed["img_random"]], dim=0)
                    if self._cfg_pair() else mixed["img"])
            features = self._mixed_image_features(imgs)
        return {"z": z, "features": features}

    def training_loss(self, batch: Dict[str, Any], generator: Optional[torch.Generator],
                      *, t=None, noise=None, train: bool = True, encoded=None):
        """The EALDM training objective of one batch: (loss, metrics).

        batch: {"img": [N, H, W, 3] target frames, "mixed": {...}} for the
        conditional model. t and noise are drawn from `generator` unless
        given; with `train` (and the module in train() mode) the cond tower's
        dropout draws from it too. encoded: `encode_inputs(batch)`, if the
        caller already ran it."""
        enc = self.encode_inputs(batch) if encoded is None else encoded
        z = enc["z"]
        if t is None:
            t = torch.randint(0, self.timesteps, (z.shape[0],), generator=generator,
                              device=z.device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
        drop = generator if train else None
        cond_context = None
        if self.conditioning_key is not None:
            self._check_mixed()
            mixed = batch["mixed"]
            if self._cfg_pair():
                c_neg, c_pos = self.get_learned_conditioning_pair(
                    mixed, generator=drop, features=enc["features"])
                cond_context = torch.cat([c_neg, c_pos], dim=0)
            else:
                cond_context = self.get_learned_conditioning(
                    mixed, fuse_env=True, generator=drop, features=enc["features"])
        if (self.shorten_cond_schedule and cond_context is not None
                and cond_context.is_floating_point()):
            # noise the conditioning at the shortened schedule's timestep
            tc = self.cond_ids[t]
            c_noise = torch.randn(cond_context.shape, generator=generator,
                                  device=cond_context.device)
            if cond_context.shape[0] == 2 * t.shape[0]:
                tc = torch.cat([tc, tc])
            cond_context = self.q_sample(cond_context, tc, c_noise)
        return self.p_losses(z, cond_context, t, noise)
