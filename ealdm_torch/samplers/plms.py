"""PLMS (pseudo linear multistep) sampler as a Python loop (counterpart of
`ealdm_tpu/samplers/plms.py`).

Adams-Bashforth orders 1-4 over the history of eps; the first step is a
pseudo improved Euler (a second model call at the next timestep). eta must
be 0. The inpainting composite is DDIM's (`renoise_known`), with the
re-noise drawn as `noise_fn(i, shape, "mask")` (JAX draws it from the step
key itself); PLMS draws nothing else.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.schedules import DDIMSchedule, DiffusionSchedule
from ..parallel import draws
from .ddim import DDIMConfig, _draw, _guided_eps, ddim_step, renoise_known


def plms_sample(eps_fn: Callable, shape, ddim: DDIMSchedule,
                cfg: DDIMConfig = DDIMConfig(), cond=None, uncond=None,
                x_T: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[Callable] = None, mask=None, x0=None,
                schedule: Optional[DiffusionSchedule] = None, score_corrector=None):
    """Run the PLMS chain from x_T (drawn from `generator` when None).
    mask / x0 / schedule: inpainting, as in `ddim_sample`."""
    if cfg.eta != 0.0:
        raise ValueError("PLMS requires eta == 0")
    if mask is not None and (x0 is None or schedule is None):
        raise ValueError("a mask needs x0 and the full schedule")
    device = ddim.alphas.device
    if x_T is None:
        x_T = draws.randn(shape, generator, device=device)
    x = x_T.to(device=device, dtype=torch.float32)
    b = shape[0]
    ts = ddim.timesteps.flip(0)
    # t_next of step i is the following (lower) timestep; the last repeats
    ts_next = torch.cat([ts[1:], ts[-1:]])
    alphas, alphas_prev, sigmas = (t.flip(0) for t in
                                   (ddim.alphas, ddim.alphas_prev, ddim.sigmas))
    scale = cfg.unconditional_guidance_scale

    def model_eps(x, t_vec):
        e_t = _guided_eps(eps_fn, x, t_vec, cond, uncond, scale)
        if score_corrector is not None:
            e_t = score_corrector(e_t, x, t_vec, cond)
        return e_t

    old_eps = []  # newest last, at most 3
    zeros = torch.zeros_like(x)
    for i in range(ddim.num_steps):
        t_vec, tn_vec = ts[i].expand(b), ts_next[i].expand(b)
        a_t, a_prev, sigma_t = alphas[i], alphas_prev[i], sigmas[i]
        if mask is not None:
            x = renoise_known(x, x0, mask, schedule, t_vec,
                              _draw(noise_fn, generator, i, x.shape, device, "mask"))
        e_t = model_eps(x, t_vec)
        if not old_eps:
            x_prev, _ = ddim_step(x, e_t, a_t, a_prev, sigma_t, zeros, cfg)
            e_prime = (e_t + model_eps(x_prev, tn_vec)) / 2
        elif len(old_eps) == 1:
            e_prime = (3 * e_t - old_eps[-1]) / 2
        elif len(old_eps) == 2:
            e_prime = (23 * e_t - 16 * old_eps[-1] + 5 * old_eps[-2]) / 12
        else:
            e_prime = (55 * e_t - 59 * old_eps[-1] + 37 * old_eps[-2] - 9 * old_eps[-3]) / 24
        x, _ = ddim_step(x, e_prime, a_t, a_prev, sigma_t, zeros, cfg)
        old_eps = (old_eps + [e_t])[-3:]
    return x
