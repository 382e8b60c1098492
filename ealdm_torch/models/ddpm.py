"""LatentDiffusion and DDPM (counterpart of `ealdm_tpu/models/ddpm.py`).

Builders for the UNet, the first stages (VQ, KL, the pixel-space identity)
and the cond stages (the STDiff UnetCond tower, the class and text encoders
of `encoders.py`, or the `__is_unconditional__` / `__is_first_stage__`
sentinels), DiffusionWrapper with every conditioning key (None, concat,
crossattn, hybrid, adm), the learned conditioning of any cond_stage_key and
the STDiff CFG pair, apply_model with the hoisted step invariants, the
first-stage encode and decode, split-input patching of all three
(`split_input_params`, `ops/patching.py`), and the training objective under
any cond_stage_key: q_sample and the posterior algebra, the eps or x0 loss
with training-time CFG for `mixed` (one 2N-batched UNet call, [c_neg,
c_pos] order), the logvar table, the VLB weighting and the shortened
conditioning schedule. `DDPM` is the pixel-space model: identity first
stage, no conditioning.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.patching import clamp_patch_params, patched_apply, unfold2d
from ..ops.schedules import DiffusionSchedule, extract
from ..utils.device import resolve_device
from .distributions import normal_kl
from .encoders import build_encoder
from .stdiff import UnetCond
from .unet import UNetModel
from .vae import AutoencoderKL, IdentityFirstStage, VQModel


def build_unet(unet_config: Dict[str, Any], dtype=torch.float32) -> UNetModel:
    cfg = dict(unet_config)
    for k in ("use_checkpoint", "use_fp16", "data_format"):
        cfg.pop(k, None)
    return UNetModel(**cfg, dtype=dtype)


def build_first_stage(config: Optional[Dict[str, Any]], dtype=torch.float32,
                      device=None) -> nn.Module:
    """VQModel, AutoencoderKL or IdentityFirstStage (no config, or an
    identity target) from a first_stage_config {target, params}; the VQ
    and KL models are built on `device` ("cuda" unless given)."""
    config = config or {}
    target = config.get("target", "identity")
    params = dict(config.get("params", {}))
    if target.endswith("VQModelInterface") or target.endswith("VQModel"):
        return VQModel(ddconfig=dict(params["ddconfig"]), n_embed=params["n_embed"],
                       embed_dim=params["embed_dim"], dtype=dtype, device=device)
    if target.endswith("AutoencoderKL"):
        return AutoencoderKL(ddconfig=dict(params["ddconfig"]), embed_dim=params["embed_dim"],
                             dtype=dtype, device=device)
    if "Identity" in target or target == "identity":
        return IdentityFirstStage()
    raise NotImplementedError(f"first stage {target!r} is not ported yet")


SENTINELS = ("__is_unconditional__", "__is_first_stage__")


def build_cond_stage(config, feat_hw: Optional[int], dtype=torch.float32, device=None):
    """The cond-stage module of a cond_stage_config: the STDiff UnetCond tower
    (feat_hw is the side of the first-stage feature map it reads), or an
    encoder of `build_encoder` (None for `torch.nn.Identity`). A sentinel
    string (or None) comes back as it is."""
    if config is None or config in SENTINELS:
        return config
    if isinstance(config, str):
        raise ValueError(f"unknown cond stage {config!r}")
    target = config.get("target", "")
    params = dict(config.get("params", {}))
    if not target.endswith("UnetCond"):
        return build_encoder(target, params, dtype, device)
    cond_args = dict(params.pop("cond_args", {}))
    if cond_args.get("noise_f_int"):
        cond_args["noise_f_int"] = [t for t in cond_args["noise_f_int"] if t]
    kwargs = {k: params[k] for k in (
        "mid_dim", "emb_dim", "out_dim", "w_dim", "f_dim", "hidden_dim",
        "num_layers", "num_ws", "norm") if k in params}
    if "dims" in cond_args:
        kwargs["t_dim"] = int(cond_args["dims"])
    return UnetCond(cond_args=cond_args, feat_hw=feat_hw, dtype=dtype, **kwargs)


CONDITIONING_KEYS = (None, "concat", "crossattn", "hybrid", "adm")


class DiffusionWrapper(nn.Module):
    """conditioning_key dispatch around the UNet: None; "concat" (the maps of
    c_concat joined to x's channels); "crossattn" (c_crossattn joined along
    the tokens as the context); "hybrid" (both); "adm" (c_crossattn[0] as
    the class ids y)."""

    def __init__(self, unet_config, conditioning_key=None, dtype=torch.float32):
        super().__init__()
        if conditioning_key not in CONDITIONING_KEYS:
            raise ValueError(f"unknown conditioning_key {conditioning_key!r}")
        self.conditioning_key = conditioning_key
        self.diffusion_model = build_unet(unet_config, dtype)

    def forward(self, x, t, c_concat=None, c_crossattn=None, context_kv=None,
                emb_tables=None):
        key = self.conditioning_key
        hoist = dict(context_kv=context_kv, emb_tables=emb_tables)
        if key is None:
            return self.diffusion_model(x, t, **hoist)
        if key in ("concat", "hybrid"):
            x = torch.cat([x, *[c.to(x.dtype) for c in c_concat]], dim=-1)
        if key == "concat":
            return self.diffusion_model(x, t, **hoist)
        if key == "adm":
            if emb_tables is not None:
                raise ValueError("a class embedding precludes the emb_tables hoisting")
            return self.diffusion_model(x, t, y=c_crossattn[0])
        if c_crossattn is None and context_kv is None:
            # attn2 would silently run as self-attention (context = x)
            raise ValueError("crossattn conditioning requires c_crossattn or context_kv")
        cc = None if c_crossattn is None else torch.cat(list(c_crossattn), dim=1)
        return self.diffusion_model(x, t, context=cc, **hoist)


class LatentDiffusion(nn.Module):
    """Latent diffusion with a frozen first stage and a cond stage.

    The keyword arguments are `model.params` of the JAX package's configs
    (see `ealdm_torch.config`). The module is built on `device` ("cuda"
    unless the caller asks for another; "meta" builds shapes only). The
    first stage never trains: its parameters are built with
    requires_grad=False, as the reference freezes it, and the cond stage
    too when `cond_stage_trainable` is false. `split_input_params` (keys as
    `ops.patching.DEFAULT_SPLIT_PARAMS`) runs the denoiser, and with
    `patch_distributed_vq` the first stage, over an overlapping crop grid."""

    def __init__(self, unet_config, first_stage_config=None,
                 cond_stage_config="__is_unconditional__", timesteps: int = 1000,
                 beta_schedule: str = "linear", linear_start: float = 1e-4,
                 linear_end: float = 2e-2, cosine_s: float = 8e-3,
                 parameterization: str = "eps",
                 loss_type: str = "l2", conditioning_key: Optional[str] = None,
                 first_stage_key: str = "img", cond_stage_key: str = "image",
                 cond_stage_trainable: bool = False, num_timesteps_cond: int = 1,
                 scale_factor: float = 1.0, unconditional_guidance_scale: float = 2.0,
                 learn_logvar: bool = False, logvar_init: float = 0.0,
                 l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0,
                 split_input_params: Optional[Dict[str, Any]] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if parameterization not in ("eps", "x0"):
            raise NotImplementedError(f"parameterization {parameterization!r}")
        if loss_type not in ("l1", "l2"):
            raise NotImplementedError(f"loss_type {loss_type!r}")
        if not 1 <= num_timesteps_cond <= timesteps:
            raise ValueError(f"num_timesteps_cond {num_timesteps_cond} not in 1..{timesteps}")
        dev = resolve_device(device)
        self.timesteps, self.beta_schedule = timesteps, beta_schedule
        self.linear_start, self.linear_end, self.cosine_s = linear_start, linear_end, cosine_s
        self.loss_type = loss_type
        self.parameterization = parameterization
        self.conditioning_key = conditioning_key
        self.first_stage_key, self.cond_stage_key = first_stage_key, cond_stage_key
        self.cond_stage_trainable = cond_stage_trainable
        self.scale_factor = scale_factor
        self.unconditional_guidance_scale = unconditional_guidance_scale
        self.l_simple_weight = l_simple_weight
        self.original_elbo_weight = original_elbo_weight
        self.split_input_params = split_input_params
        self.unet_config = dict(unet_config)
        self.dtype = dtype
        feat_hw = None
        if (isinstance(cond_stage_config, dict)
                and cond_stage_config.get("target", "").endswith("UnetCond")):
            # the tower reads the first-stage encoder's features
            dd = first_stage_config["params"]["ddconfig"]
            feat_hw = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
        with torch.device(dev):
            self.model = DiffusionWrapper(unet_config, conditioning_key, dtype)
            self.first_stage_model = build_first_stage(first_stage_config, dtype, dev)
            cond = build_cond_stage(cond_stage_config, feat_hw, dtype, dev)
            logvar = torch.full((timesteps,), float(logvar_init))
            if learn_logvar:
                self.logvar = nn.Parameter(logvar)
            else:
                self.register_buffer("logvar", logvar, persistent=False)
        # a sentinel string stands in for a cond-stage module
        self.cond_stage_sentinel = cond if isinstance(cond, str) else None
        self.cond_stage_model = None if isinstance(cond, str) else cond
        self.first_stage_model.requires_grad_(False)
        if not cond_stage_trainable and self.cond_stage_model is not None:
            self.cond_stage_model.requires_grad_(False)
        self.schedule = DiffusionSchedule.create(
            timesteps=timesteps, beta_schedule=beta_schedule,
            linear_start=linear_start, linear_end=linear_end, cosine_s=cosine_s,
            parameterization=parameterization, device=dev,
        )
        # the shortened conditioning-noise schedule (reference
        # make_cond_schedule); active only when num_timesteps_cond > 1
        cond_ids = torch.full((timesteps,), timesteps - 1, dtype=torch.int64)
        if num_timesteps_cond > 1:
            ids = np.round(np.linspace(0, timesteps - 1, num_timesteps_cond)).astype(np.int64)
            cond_ids[:num_timesteps_cond] = torch.from_numpy(ids)
        self.cond_ids = cond_ids.to(dev)
        self.shorten_cond_schedule = num_timesteps_cond > 1

    def clone(self, *, split_input_params):
        """This model with other `split_input_params` (flax's `clone`): a
        shallow copy that shares every parameter, buffer and submodule."""
        m = copy.copy(self)
        m.split_input_params = split_input_params
        return m

    # ------------------------------------------------------------- first stage
    def _patching(self) -> Optional[Dict[str, Any]]:
        """The split_input_params that patch the first stage, or None."""
        p = self.split_input_params
        if p is not None and p.get("patch_distributed_vq"):
            return p
        return None

    def encode_first_stage(self, x, generator=None, sample_posterior: bool = True,
                           noise=None):
        """Image [N, H, W, 3] -> latent, without gradient: VQ's un-quantized
        latent, a KL posterior's sample (from `generator`, or `noise` of the
        raw encode's shape when given) or mode, or the image itself
        (identity). With patching, the crops of the image are encoded as one
        batch (`noise`: [N*L, ...]) and stitched."""
        p = self._patching()
        with torch.no_grad():
            if p is not None and x.dim() == 4:
                return patched_apply(
                    lambda crops: self._encode_raw(crops, generator, sample_posterior, noise),
                    x, p, df=int(p.get("vqf", 1)))
            return self._encode_raw(x, generator, sample_posterior, noise)

    def _encode_raw(self, x, generator=None, sample_posterior: bool = True, noise=None):
        fs = self.first_stage_model
        if isinstance(fs, VQModel):
            return fs.encode_prequant(x)
        if isinstance(fs, AutoencoderKL):
            posterior = fs.encode(x)
            return posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return fs.encode(x)

    def get_first_stage_encoding(self, z):
        return self.scale_factor * z

    def decode_first_stage(self, z, force_not_quantize: bool = False):
        """Latent [N, h, w, c] -> image [N, H, W, 3]; a VQ latent is
        quantized first unless `force_not_quantize`. With patching, the
        latent's crops are decoded as one batch and stitched."""
        z = (1.0 / self.scale_factor) * z
        p = self._patching()
        if p is not None and z.dim() == 4:
            return patched_apply(lambda crops: self._decode_raw(crops, force_not_quantize),
                                 z, p, uf=int(p.get("vqf", 1)))
        return self._decode_raw(z, force_not_quantize)

    def _decode_raw(self, z, force_not_quantize: bool = False):
        fs = self.first_stage_model
        if isinstance(fs, VQModel):
            return fs.decode_interface(z, force_not_quantize)
        return fs.decode(z)

    def quantize_latent(self, z):
        """VQ-quantize a latent (the identity for other first stages)."""
        if isinstance(self.first_stage_model, VQModel):
            return self.first_stage_model.quantize(z)[0]
        return z

    # ------------------------------------------------------------- conditioning
    def _mixed_image_features(self, img):
        """The frozen first-stage encoder's features, without gradient."""
        with torch.no_grad():
            return self.first_stage_model.encoder(img)

    def _check_mixed(self):
        if self.cond_stage_key != "mixed":
            raise NotImplementedError("the CFG pair takes only the 'mixed' STDiff "
                                      "conditioning")

    def get_learned_conditioning(self, cond, fuse_env: bool = True, generator=None,
                                 features=None):
        """The context of a conditioning input. With no cond-stage module:
        under `__is_first_stage__` the first stage's encoding of the image
        cond (a KL posterior's mode), else cond unchanged. `mixed`: the dict
        (img, flow, weather, time) through the STDiff tower, where features
        are the first-stage features of cond["img"] if already computed and
        generator the dropout source (train() mode). Any other key: cond
        (class ids, token ids) through the cond-stage module."""
        if self.cond_stage_model is None:
            if self.cond_stage_sentinel == "__is_first_stage__":
                return self.encode_first_stage(cond, sample_posterior=False)
            return cond
        if self.cond_stage_key != "mixed":
            return self.cond_stage_model(cond)
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
        emb_tables are the hoisted step invariants (inference.hoist_invariants),
        which the split-input path refuses."""
        if self.split_input_params is not None and x_noisy.dim() == 4:
            if context_kv is not None or emb_tables is not None:
                raise ValueError("hoisted invariants are not supported on the split-input "
                                 "patched path")
            return self._apply_model_patched(x_noisy, t, cond_context)
        return self._apply_model_dense(x_noisy, t, cond_context, context_kv, emb_tables)

    def _apply_model_dense(self, x_noisy, t, cond_context, context_kv=None, emb_tables=None):
        hoist = dict(context_kv=context_kv, emb_tables=emb_tables)
        if self.conditioning_key is None or cond_context is None:
            return self.model(x_noisy, t, **hoist)
        cc, ca = self._split_context(cond_context)
        return self.model(x_noisy, t, c_concat=cc, c_crossattn=ca, **hoist)

    def _apply_model_patched(self, x_noisy, t, cond_context):
        """The denoiser over an overlapping crop grid of x_noisy, all L
        crops of the B samples as one [B*L, ...] UNet call, stitched. Concat
        maps are cut on the same grid; cross-attention and class context
        is repeated for each crop of its sample."""
        p = dict(self.split_input_params)
        p["ks"], p["stride"] = clamp_patch_params(tuple(x_noisy.shape[1:3]), tuple(p["ks"]),
                                                  tuple(p["stride"]))
        b = x_noisy.shape[0]
        cc = ca = cc_flat = None
        if cond_context is not None:
            cc, ca = self._split_context(cond_context)
        if cc is not None:
            for m in cc:
                if (m.dim() != 4 or tuple(m.shape[:3]) != tuple(x_noisy.shape[:3])
                        or m.device != x_noisy.device):
                    raise ValueError("concat conditioning must be a [B, H, W, C] map on the "
                                     f"input's grid and device, got {tuple(m.shape)} on "
                                     f"{m.device} for {tuple(x_noisy.shape)} on "
                                     f"{x_noisy.device}")
            cc_flat = [unfold2d(m, p["ks"], p["stride"]).reshape(-1, *p["ks"], m.shape[-1])
                       for m in cc]

        def fn(crops):
            length = crops.shape[0] // b
            ctx = None
            if cond_context is not None:
                ctx = {"c_concat": cc_flat,
                       "c_crossattn": None if ca is None
                       else [a.repeat_interleave(length, dim=0) for a in ca]}
            return self._apply_model_dense(crops, t.repeat_interleave(length), ctx)

        return patched_apply(fn, x_noisy, p)

    def _split_context(self, cond_context):
        """(c_concat, c_crossattn) lists of a context: "hybrid" takes a dict
        {"c_concat": ..., "c_crossattn": ...} (each a tensor or a list); a
        single tensor or list routes by conditioning_key."""
        def aslist(v):
            if v is None:
                return None
            return list(v) if isinstance(v, (list, tuple)) else [v]

        if isinstance(cond_context, dict):
            return aslist(cond_context.get("c_concat")), aslist(cond_context.get("c_crossattn"))
        if self.conditioning_key == "hybrid":
            raise ValueError('hybrid conditioning needs a dict context '
                             '{"c_concat": ..., "c_crossattn": ...}')
        if self.conditioning_key in ("crossattn", "adm"):
            return None, aslist(cond_context)
        return aslist(cond_context), None

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
        """(loss, metrics) of the eps (or x0) objective. cond_context is None, [N,
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
        target = noise if self.parameterization == "eps" else x_start
        loss_simple = self._pixel_loss(model_output, target).mean(
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

    def _cond_trains(self) -> bool:
        return self.cond_stage_model is not None and any(
            p.requires_grad for p in self.cond_stage_model.parameters())

    def encode_inputs(self, batch: Dict[str, Any], generator=None,
                      noise=None) -> Dict[str, Any]:
        """The frozen work of a training batch, without gradient: "z", the
        scaled latent of the target frames (`batch["img"]`, else
        `batch[first_stage_key]`; a KL posterior sampled from `generator`,
        or `noise` when given);
        "features", the encoder features of the `mixed` conditioning images
        (the 2N [img, img_random] pair under training-time CFG) or None;
        "cond", the context of `batch[cond_stage_key]` when the cond stage
        does not train (a sentinel, Identity or a frozen module), else
        None."""
        x = batch.get("img", batch.get(self.first_stage_key))
        z = self.get_first_stage_encoding(self.encode_first_stage(x, generator, noise=noise))
        features = cond = None
        if self.conditioning_key is not None and self.cond_stage_key == "mixed":
            mixed = batch["mixed"]
            imgs = (torch.cat([mixed["img"], mixed["img_random"]], dim=0)
                    if self._cfg_pair() else mixed["img"])
            features = self._mixed_image_features(imgs)
        elif self.conditioning_key is not None and not self._cond_trains():
            with torch.no_grad():
                cond = self.get_learned_conditioning(batch[self.cond_stage_key])
        return {"z": z, "features": features, "cond": cond}

    def training_loss(self, batch: Dict[str, Any], generator: Optional[torch.Generator],
                      *, t=None, noise=None, cond_noise=None, train: bool = True,
                      encoded=None):
        """The training objective of one batch: (loss, metrics).

        batch: the target frames under "img" (or `first_stage_key`) and the
        conditioning under `cond_stage_key`: {"img", "img_random", "flow",
        "weather", "time"} for `mixed`, class ids, token ids, an LR image, a
        masked image, ... on the model's device. t, noise and, under the
        shortened conditioning schedule, cond_noise are drawn from
        `generator` unless given; with `train` (and the module in train()
        mode) the STDiff tower's dropout draws from it too. encoded:
        `encode_inputs(batch)`, if the caller already ran it."""
        enc = self.encode_inputs(batch, generator) if encoded is None else encoded
        z = enc["z"]
        if t is None:
            t = torch.randint(0, self.timesteps, (z.shape[0],), generator=generator,
                              device=z.device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
        drop = generator if train else None
        cond_context = None
        if self.conditioning_key is not None and self.cond_stage_key == "mixed":
            mixed = batch["mixed"]
            if self._cfg_pair():
                c_neg, c_pos = self.get_learned_conditioning_pair(
                    mixed, generator=drop, features=enc["features"])
                cond_context = torch.cat([c_neg, c_pos], dim=0)
            else:
                cond_context = self.get_learned_conditioning(
                    mixed, fuse_env=True, generator=drop, features=enc["features"])
        elif self.conditioning_key is not None:
            cond_context = enc.get("cond")
            if cond_context is None:
                cond_context = self.get_learned_conditioning(batch[self.cond_stage_key])
        if (self.shorten_cond_schedule and cond_context is not None
                and cond_context.is_floating_point()):
            # noise the conditioning at the shortened schedule's timestep
            tc = self.cond_ids[t]
            if cond_noise is None:
                cond_noise = torch.randn(cond_context.shape, generator=generator,
                                         device=cond_context.device)
            if cond_context.shape[0] == 2 * t.shape[0]:
                tc = torch.cat([tc, tc])
            cond_context = self.q_sample(cond_context, tc, cond_noise)
        return self.p_losses(z, cond_context, t, noise)


class DDPM(LatentDiffusion):
    """Pixel-space DDPM: identity first stage, no conditioning, no
    training-time guidance (the JAX package's API-parity subclass)."""

    def __init__(self, unet_config, first_stage_config=None,
                 cond_stage_config="__is_unconditional__",
                 unconditional_guidance_scale: float = 1.0, **kwargs):
        super().__init__(unet_config, first_stage_config, cond_stage_config,
                         unconditional_guidance_scale=unconditional_guidance_scale, **kwargs)
