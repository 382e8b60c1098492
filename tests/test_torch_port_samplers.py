"""The port's samplers against the JAX package's, value for value, with a
closed-form denoiser written once in numpy terms for both frameworks: every
DDIM option (eps and x0 parameterization, clip_denoised, temperature,
noise_dropout, a score corrector, quantize_x0, the inpainting mask with x0,
return_pred_x0 and return_intermediates), the full-T ancestral chain, and
PLMS with and without a mask. Both sides start from the same x_T; the port
replays JAX's draws through its noise hook (the mask re-noise, the dropout
keep mask and the step noise, split from the step keys as JAX splits them).
float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.ops.schedules import DDIMSchedule as TDDIM
from ealdm_torch.ops.schedules import DiffusionSchedule as TSched
from ealdm_torch.samplers import DDIMConfig as TConfig
from ealdm_torch.samplers import ancestral_sample as t_ancestral
from ealdm_torch.samplers import ddim_sample as t_ddim
from ealdm_torch.samplers import plms_sample as t_plms
from ealdm_tpu.ops.schedules import DDIMSchedule as JDDIM
from ealdm_tpu.ops.schedules import DiffusionSchedule as JSched
from ealdm_tpu.samplers import DDIMConfig as JConfig
from ealdm_tpu.samplers import ancestral_sample as j_ancestral
from ealdm_tpu.samplers import ddim_sample as j_ddim
from ealdm_tpu.samplers import plms_sample as j_plms

SHAPE = (2, 6, 6, 3)
T = 100
STEPS = 5


def eps_jax(x, t, c):
    """A denoiser with x-, t- and context-dependence, in jnp."""
    tt = (t.astype(jnp.float32) / T)[:, None, None, None]
    out = 0.3 * jnp.tanh(x) + 0.2 * tt * jnp.sin(3.0 * x)
    return out if c is None else out + 0.1 * c[:, None, None, :]


def eps_torch(x, t, c):
    tt = (t.float() / T)[:, None, None, None]
    out = 0.3 * torch.tanh(x) + 0.2 * tt * torch.sin(3.0 * x)
    return out if c is None else out + 0.1 * c[:, None, None, :]


def scheds(steps=STEPS, eta=0.0):
    kw = dict(timesteps=T, linear_start=0.0015, linear_end=0.0195)
    js, ts = JSched.create(**kw), TSched.create(**kw)
    return js, ts, JDDIM.create(js, steps, eta=eta), TDDIM.create(ts, steps, eta=eta)


def ddim_draws(rng, steps, mask=False, dropout=0.0):
    """JAX ddim_sample's draws at each step i (0 = the highest t), by kind."""
    draws = []
    for k in jax.random.split(jax.random.split(rng)[0], steps):
        d = {}
        if mask:
            k_noise, k = jax.random.split(k)
            d["mask"] = np.asarray(jax.random.normal(k_noise, SHAPE))
        k_drop, k = jax.random.split(k)
        d["step"] = np.asarray(jax.random.normal(k, SHAPE))
        if dropout:
            d["keep"] = np.asarray(
                jax.random.bernoulli(k_drop, 1.0 - dropout, SHAPE), np.float32)
        draws.append(d)
    return draws


def replay(draws):
    def noise_fn(i, shape, kind="step"):
        assert tuple(shape) == SHAPE
        return torch.from_numpy(draws[i][kind].copy())

    return noise_fn


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    x_T = rng.randn(*SHAPE).astype(np.float32)
    x0 = (0.5 * rng.randn(*SHAPE)).astype(np.float32)
    mask = np.zeros(SHAPE[:3] + (1,), np.float32)
    mask[:, :3] = 1.0  # the top half is known
    return x_T, x0, mask


def close(got, want, tol=1e-5):
    """float32 through a few steps of elementwise math: 1e-5 of the
    result's scale."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale)


def quantize_j(x):
    return jnp.round(x * 4) / 4


def quantize_t(x):
    return torch.round(x * 4) / 4


DDIM_CASES = {
    "eps_eta1": (dict(eta=1.0), {}),
    "x0_param": (dict(eta=1.0, parameterization="x0"), {}),
    "clip_denoised": (dict(eta=0.5, clip_denoised=True), {}),
    "temperature": (dict(eta=1.0, temperature=0.7), {}),
    "noise_dropout": (dict(eta=1.0, noise_dropout=0.3), {}),
    "quantize_x0": (dict(eta=0.0, quantize_x0=True), {"quantize": True}),
    "score_corrector": (dict(eta=1.0), {"corrector": True}),
    "mask_x0": (dict(eta=1.0), {"mask": True}),
    "mask_eta0_cfg": (dict(eta=0.0, unconditional_guidance_scale=2.0),
                      {"mask": True, "cfg": True}),
}


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_option_matches_jax(case):
    opts, extra = DDIM_CASES[case]
    eta = opts.get("eta", 0.0)
    js, ts, jd, td = scheds(eta=eta)
    x_T, x0, mask = inputs()
    rng = jax.random.PRNGKey(3)
    draws = ddim_draws(rng, STEPS, mask=extra.get("mask", False),
                       dropout=opts.get("noise_dropout", 0.0))
    jkw, tkw = {}, {}
    if extra.get("mask"):
        jkw = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0), schedule=js)
        tkw = dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0), schedule=ts)
    if extra.get("quantize"):
        jkw["quantize_fn"], tkw["quantize_fn"] = quantize_j, quantize_t
    if extra.get("corrector"):
        jkw["score_corrector"] = lambda e, x, t, c: e - 0.1 * x
        tkw["score_corrector"] = lambda e, x, t, c: e - 0.1 * x
    cond = uncond = None
    if extra.get("cfg"):
        c = np.random.RandomState(5).randn(SHAPE[0], SHAPE[-1]).astype(np.float32)
        cond, uncond = c, np.zeros_like(c)
    want = j_ddim(eps_jax, rng, SHAPE, jd, JConfig(num_steps=STEPS, **opts),
                  cond=None if cond is None else jnp.asarray(cond),
                  uncond=None if uncond is None else jnp.asarray(uncond),
                  x_T=jnp.asarray(x_T), **jkw)
    got = t_ddim(eps_torch, SHAPE, td, TConfig(num_steps=STEPS, **opts),
                 cond=None if cond is None else torch.from_numpy(cond),
                 uncond=None if uncond is None else torch.from_numpy(uncond),
                 x_T=torch.from_numpy(x_T), noise_fn=replay(draws), **tkw)
    close(got, want)
    if extra.get("mask"):  # the known rows were composited in at every step
        assert not np.allclose(np.asarray(got)[:, 3:], np.asarray(got)[:, :3])


def test_ddim_returns_pred_x0_and_intermediates():
    js, ts, jd, td = scheds(eta=1.0)
    x_T, _, _ = inputs(1)
    rng = jax.random.PRNGKey(4)
    draws = ddim_draws(rng, STEPS)
    cfg_j, cfg_t = JConfig(num_steps=STEPS, eta=1.0), TConfig(num_steps=STEPS, eta=1.0)
    kw_t = dict(x_T=torch.from_numpy(x_T), noise_fn=replay(draws))
    x_j, pred_j = j_ddim(eps_jax, rng, SHAPE, jd, cfg_j, x_T=jnp.asarray(x_T),
                         return_pred_x0=True)
    x_t, pred_t = t_ddim(eps_torch, SHAPE, td, cfg_t, return_pred_x0=True, **kw_t)
    close(x_t, x_j)
    close(pred_t, pred_j)
    x_j, (xs_j, preds_j) = j_ddim(eps_jax, rng, SHAPE, jd, cfg_j, x_T=jnp.asarray(x_T),
                                  return_intermediates=True)
    x_t, (xs_t, preds_t) = t_ddim(eps_torch, SHAPE, td, cfg_t, return_intermediates=True,
                                  **kw_t)
    assert tuple(xs_t.shape) == (STEPS,) + SHAPE == tuple(preds_t.shape)
    close(xs_t, xs_j)
    close(preds_t, preds_j)
    torch.testing.assert_close(x_t, xs_t[-1])


@pytest.mark.parametrize("clip", [True, False])
def test_ancestral_matches_jax(clip):
    """T = 20 steps of the ancestral chain. JAX draws x_T from the second
    half of the key's split and step j's noise from the j-th of the first
    half's T keys; the port takes both."""
    kw = dict(timesteps=20, linear_start=0.0015, linear_end=0.0195)
    js, ts = JSched.create(**kw), TSched.create(**kw)
    rng = jax.random.PRNGKey(6)
    rest, init = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(init, SHAPE))
    noises = [np.asarray(jax.random.normal(k, SHAPE)) for k in jax.random.split(rest, 20)]
    want = j_ancestral(eps_jax, rng, SHAPE, js, clip_denoised=clip)
    got = t_ancestral(eps_torch, SHAPE, ts, clip_denoised=clip, x_T=torch.from_numpy(x_T.copy()),
                      noise_fn=lambda j, shape: torch.from_numpy(noises[j].copy()))
    close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("steps", [2, 6])
def test_plms_matches_jax(masked, steps):
    """6 asked for (7 run: 100 // 6 = 16 strides) reach the fourth order;
    JAX draws the mask's re-noise from each step key itself."""
    js, ts, jd, td = scheds(steps)
    x_T, x0, mask = inputs(2)
    rng = jax.random.PRNGKey(8)
    keys = jax.random.split(jax.random.split(rng)[0], jd.num_steps)
    draws = [{"mask": np.asarray(jax.random.normal(k, SHAPE))} for k in keys]
    jkw = tkw = {}
    if masked:
        jkw = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0), schedule=js)
        tkw = dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0), schedule=ts)
    want = j_plms(eps_jax, rng, SHAPE, jd, JConfig(num_steps=steps), x_T=jnp.asarray(x_T),
                  **jkw)
    got = t_plms(eps_torch, SHAPE, td, TConfig(num_steps=steps), x_T=torch.from_numpy(x_T),
                 noise_fn=replay(draws), **tkw)
    close(got, want)


def test_plms_refuses_eta():
    _, _, _, td = scheds()
    with pytest.raises(ValueError, match="eta"):
        t_plms(eps_torch, SHAPE, td, TConfig(eta=0.5))


# Closed-form twins of tests/test_sampler_golden.py, on the port alone.

def test_ddim_zero_eps_telescopes():
    """eps == 0 and eta == 0: each step is x' = sqrt(a_prev / a_t) x, so the
    chain telescopes to x_T * prod sqrt(a_prev / a_t)."""
    _, ts, _, td = scheds(10)
    x_T = torch.full((1, 4, 4, 1), 0.7)
    out = t_ddim(lambda x, t, c: torch.zeros_like(x), (1, 4, 4, 1), td,
                 TConfig(num_steps=10), x_T=x_T)
    a, ap = td.alphas.double().numpy(), td.alphas_prev.double().numpy()
    np.testing.assert_allclose(out.numpy(), 0.7 * np.prod(np.sqrt(ap / a)), rtol=1e-4)


def test_plms_equals_ddim_for_constant_eps():
    """A constant eps makes every Adams-Bashforth combination that constant,
    so PLMS is DDIM exactly (to float32 rounding)."""
    _, _, _, td = scheds(6)
    x_T = torch.ones(1, 4, 4, 2)

    def eps(x, t, c):
        return torch.full_like(x, 0.3)

    a = t_ddim(eps, (1, 4, 4, 2), td, TConfig(num_steps=6), x_T=x_T)
    b = t_plms(eps, (1, 4, 4, 2), td, TConfig(num_steps=6), x_T=x_T)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cfg_scale_algebra():
    """The guided eps is e_u + s (e_c - e_u), from one 2N-batched call."""
    from ealdm_torch.samplers.ddim import _guided_eps

    calls = []

    def eps_fn(x, t, ctx):
        calls.append(x.shape[0])
        half = x.shape[0] // 2
        return torch.cat([torch.full((half,) + x.shape[1:], 0.2),
                          torch.full((half,) + x.shape[1:], 0.9)])

    out = _guided_eps(eps_fn, torch.zeros(2, 2, 2, 1), torch.zeros(2, dtype=torch.long),
                      torch.ones(2, 1), torch.zeros(2, 1), 3.0)
    assert calls == [4]
    torch.testing.assert_close(out, torch.full_like(out, 0.2 + 3.0 * 0.7))


def test_generator_streams_repeat():
    """Without a noise hook, a seeded generator gives the same chain twice
    (mask re-noise, dropout keep mask and step noise all drawn from it)."""
    _, ts, _, td = scheds(eta=1.0)
    _, x0, mask = inputs(3)
    kw = dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0), schedule=ts)
    runs = [t_ddim(eps_torch, SHAPE, td, TConfig(num_steps=STEPS, eta=1.0, noise_dropout=0.2),
                   generator=torch.Generator().manual_seed(9), **kw) for _ in range(2)]
    assert torch.equal(*runs) and bool(torch.isfinite(runs[0]).all())
