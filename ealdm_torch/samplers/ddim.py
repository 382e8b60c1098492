"""DDIM and ancestral samplers as Python loops (counterpart of
`ealdm_tpu/samplers/ddim.py`).

Per DDIM step: x_prev = sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise *
temperature, with classifier-free guidance as ONE 2N-batched model call over
[uncond; cond], an optional score corrector, the eps or x0
parameterization, clipping or quantizing pred_x0, noise dropout, and the
inpainting composite (mask == 1 keeps the known region, re-noised from x0
at the step's t before the model call).

Noise comes from a `torch.Generator`, or from `noise_fn(i, shape)` for step
i (0 = the first, highest-t step), which lets a test replay another
framework's noise stream. A step's other draws come from
`noise_fn(i, shape, kind)`: kind "mask" is the re-noise of x0 (JAX draws it
from its own split of the step key, before the step's noise) and "keep" the
0/1 keep mask of noise dropout.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.schedules import DDIMSchedule, DiffusionSchedule, extract
from ..parallel import draws


class DDIMConfig(NamedTuple):
    num_steps: int = 50
    eta: float = 0.0
    temperature: float = 1.0
    noise_dropout: float = 0.0
    unconditional_guidance_scale: float = 1.0
    parameterization: str = "eps"  # "eps" or "x0"
    clip_denoised: bool = False
    quantize_x0: bool = False


_NO_EXTRA = object()  # sentinel: "no per-step extra tables" (None is valid)


def _tree_map(fn, *trees):
    """fn over the tensor leaves of matching dict / tuple / list trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (tuple, list)):
        return type(head)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _guided_eps(eps_fn, x, t, cond, uncond, scale: float, extra=_NO_EXTRA):
    """CFG as a single batched forward over [uncond; cond] (reference order).
    cond/uncond may be trees of batch-leading tensors (the hoisted per-site
    cross-attn K/V); `extra` is this step's row of the extra tables."""
    args = () if extra is _NO_EXTRA else (extra,)
    if uncond is None or scale == 1.0:
        return eps_fn(x, t, cond, *args)
    x_in = torch.cat([x, x], dim=0)
    t_in = torch.cat([t, t], dim=0)
    c_in = _tree_map(lambda u, c: torch.cat([u, c], dim=0), uncond, cond)
    e_uncond, e_cond = eps_fn(x_in, t_in, c_in, *args).chunk(2, dim=0)
    return e_uncond + scale * (e_cond - e_uncond)


def ddim_step(x, e_t, a_t, a_prev, sigma_t, noise, cfg: DDIMConfig, quantize_fn=None):
    """One DDIM update from the model's output and this step's scalars:
    (x_prev, pred_x0)."""
    sqrt_one_minus_at = torch.sqrt(1.0 - a_t)
    if cfg.parameterization == "x0":
        # the model predicts x0; eps is recovered for the direction term
        pred_x0 = e_t
        e_t = (x - torch.sqrt(a_t) * pred_x0) / sqrt_one_minus_at
    else:
        pred_x0 = (x - sqrt_one_minus_at * e_t) / torch.sqrt(a_t)
    if cfg.clip_denoised:
        pred_x0 = pred_x0.clamp(-1.0, 1.0)
    if cfg.quantize_x0 and quantize_fn is not None:
        pred_x0 = quantize_fn(pred_x0)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=0.0)) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * cfg.temperature
    return x_prev, pred_x0


def _draw(noise_fn, generator, i, shape, device, kind="step", drop=0.0):
    """Step i's draw of `kind` (see the module docstring): standard normal,
    or for "keep" a 0/1 mask that keeps each element with probability
    1 - `drop`."""
    if noise_fn is not None:
        return draws.cut(lambda s: noise_fn(*((i, s) if kind == "step" else (i, s, kind)))
                         .to(device=device, dtype=torch.float32), shape)
    if kind == "keep":
        return (draws.rand(shape, generator, device=device) < 1.0 - drop).float()
    return draws.randn(shape, generator, device=device)


def renoise_known(x, x0, mask, schedule: DiffusionSchedule, t_vec, noise):
    """The inpainting composite: x0 noised to t where mask == 1, x elsewhere."""
    img_orig = (extract(schedule.sqrt_alphas_cumprod, t_vec, x.dim()) * x0
                + extract(schedule.sqrt_one_minus_alphas_cumprod, t_vec, x.dim()) * noise)
    return img_orig * mask + (1.0 - mask) * x


def ddim_sample(eps_fn: Callable, shape, ddim: DDIMSchedule,
                cfg: DDIMConfig = DDIMConfig(), cond=None, uncond=None,
                x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[Callable] = None, extra_tables=None,
                mask=None, x0=None, schedule: Optional[DiffusionSchedule] = None,
                quantize_fn=None, return_pred_x0: bool = False,
                return_intermediates: bool = False, score_corrector=None):
    """Run the DDIM chain from x_T (drawn from `generator` when None).
    Returns x, or (x, the last pred_x0) with return_pred_x0, or (x, (the
    [S, B, ...] stack of every step's x_prev, that of its pred_x0)) with
    return_intermediates.

    mask / x0 / schedule: inpainting, where `schedule` is the full-T
    DiffusionSchedule. score_corrector: `fn(e_t, x, t, cond) -> e_t`,
    applied to the guided score. extra_tables: optional tree of [S, ...]
    per-step tables in the same low->high order as ddim.timesteps (the
    hoisted timestep-embedding tables); reversed alongside the alpha/sigma
    tables, and step i's row is passed to eps_fn as a fourth argument."""
    device = ddim.alphas.device
    if mask is not None and (x0 is None or schedule is None):
        raise ValueError("a mask needs x0 and the full schedule")
    if x_T is None:
        x_T = draws.randn(shape, generator, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    b = shape[0]
    timesteps = ddim.timesteps.flip(0)
    alphas, alphas_prev, sigmas = (t.flip(0) for t in
                                   (ddim.alphas, ddim.alphas_prev, ddim.sigmas))
    extra_rev = (None if extra_tables is None
                 else _tree_map(lambda a: a.flip(0), extra_tables))
    xs, preds = [], []
    pred_x0 = x
    for i in range(ddim.num_steps):
        t_vec = timesteps[i].expand(b)
        if mask is not None:
            x = renoise_known(x, x0, mask, schedule, t_vec,
                              _draw(noise_fn, generator, i, x.shape, device, "mask"))
        e_t = _guided_eps(
            eps_fn, x, t_vec, cond, uncond, cfg.unconditional_guidance_scale,
            extra=_NO_EXTRA if extra_rev is None
            else _tree_map(lambda a: a[i], extra_rev),
        )
        if score_corrector is not None:
            e_t = score_corrector(e_t, x, t_vec, cond)
        if cfg.noise_dropout > 0.0:
            keep = _draw(noise_fn, generator, i, x.shape, device, "keep", cfg.noise_dropout)
        noise = _draw(noise_fn, generator, i, x.shape, device)
        if cfg.noise_dropout > 0.0:
            noise = noise * keep / (1.0 - cfg.noise_dropout)
        x, pred_x0 = ddim_step(x, e_t, alphas[i], alphas_prev[i], sigmas[i], noise, cfg,
                               quantize_fn)
        if return_intermediates:
            xs.append(x)
            preds.append(pred_x0)
    if return_intermediates:
        return x, (torch.stack(xs), torch.stack(preds))
    if return_pred_x0:
        return x, pred_x0
    return x


def ancestral_sample(eps_fn: Callable, shape, schedule: DiffusionSchedule, cond=None,
                     uncond=None, guidance_scale: float = 1.0, clip_denoised: bool = True,
                     x_T: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     noise_fn: Optional[Callable] = None):
    """The full-T ancestral (DDPM) chain, t = T-1 .. 0 (the reference
    `p_sample_loop`). noise_fn(j, shape) gives step j's noise, j = 0 at
    t = T-1; step T-1 (t = 0) adds none."""
    device = schedule.betas.device
    b = shape[0]
    if x_T is None:
        x_T = draws.randn(shape, generator, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    T = schedule.num_timesteps
    for j, i in enumerate(range(T - 1, -1, -1)):
        t_vec = torch.full((b,), i, dtype=torch.int64, device=device)
        e_t = _guided_eps(eps_fn, x, t_vec, cond, uncond, guidance_scale)
        x_recon = (extract(schedule.sqrt_recip_alphas_cumprod, t_vec, x.dim()) * x
                   - extract(schedule.sqrt_recipm1_alphas_cumprod, t_vec, x.dim()) * e_t)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean = (extract(schedule.posterior_mean_coef1, t_vec, x.dim()) * x_recon
                + extract(schedule.posterior_mean_coef2, t_vec, x.dim()) * x)
        if i > 0:
            log_var = extract(schedule.posterior_log_variance_clipped, t_vec, x.dim())
            x = mean + torch.exp(0.5 * log_var) * _draw(noise_fn, generator, j, x.shape,
                                                        device)
        else:
            x = mean
    return x
