"""The unconditional paths of the port against the JAX package, at tiny
widths of the repo's unconditional configurations, float32 on the CPU: the
unconditional VQ latent model (`UNCOND`'s layout: AttentionBlock UNet,
32-channel heads), the pixel-space `DDPM` (`PIXEL`'s: identity first stage)
and the VQ-f4 inpainting model (`INPAINT`'s: 8 heads), each `apply_model`
and a 3-step `sample_images` with JAX's noise replayed; the inpainting path
(mask and x0, DDIM and PLMS) end to end; and the x0 parameterization's loss.
Weights are seeded random values of the JAX tree's shapes, loaded through
the bridge.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.config import INPAINT, PIXEL, UNCOND, model_kwargs
from ealdm_torch.inference import sample_images
from ealdm_torch.models.ddpm import DDPM as TorchDDPM
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.models.vae import IdentityFirstStage
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu.inference import sample_images as jax_sample_images
from ealdm_tpu.models.ddpm import DDPM as JaxDDPM
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

B = 2
STEPS = 3
RUN_STEPS = 4  # "uniform": 1000 // 3 = 333 strides 0, 333, 666, 999


def tiny(cfg, res, unet, ddconfig=None, **model):
    """A configuration's model kwargs cut to tiny widths (same layout)."""
    kw = model_kwargs(cfg)
    kw["unet_config"].update(unet)
    if ddconfig is not None:
        kw["first_stage_config"]["params"]["ddconfig"].update(ddconfig)
        kw["first_stage_config"]["params"]["n_embed"] = 32
    kw.update(model)
    return kw, res


CONFIGS = {
    # AttentionBlock with 16-channel heads at ds 1 and 2, VQ-f4 at 32^2
    "uncond": tiny(UNCOND, 32, dict(image_size=8, model_channels=32, channel_mult=[1, 2],
                                    attention_resolutions=[2, 1], num_res_blocks=1,
                                    num_head_channels=16),
                   dict(resolution=32, ch=16, ch_mult=[1, 2, 2], attn_resolutions=[8])),
    # 8 heads at ds 2
    "inpaint": tiny(INPAINT, 32, dict(image_size=8, model_channels=32, channel_mult=[1, 2],
                                      attention_resolutions=[2], num_res_blocks=1,
                                      num_heads=8),
                    dict(resolution=32, ch=16, ch_mult=[1, 2, 2])),
    # pixel space, 16^2
    "pixel": tiny(PIXEL, 16, dict(image_size=16, model_channels=32, channel_mult=[1, 2],
                                  attention_resolutions=[2], num_res_blocks=1,
                                  num_head_channels=16)),
}


def latent_shape(name, tm):
    kw, res = CONFIGS[name]
    if isinstance(tm.first_stage_model, IdentityFirstStage):
        return (res, res, 3)
    dd = kw["first_stage_config"]["params"]["ddconfig"]
    side = res // 2 ** (len(dd["ch_mult"]) - 1)
    return (side, side, kw["unet_config"]["in_channels"])


def build(name, seed=0, **extra):
    kw, res = CONFIGS[name]
    kw = {**copy.deepcopy(kw), **extra}
    j_cls, t_cls = (JaxDDPM, TorchDDPM) if name == "pixel" else (JaxLDM, TorchLDM)
    jm = j_cls(**kw, dtype=jnp.float32)
    batch = {"img": np.zeros((B, res, res, 3), np.float32)}
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r, "dropout": r}, batch, r, method=jm.full_init),
        jax.random.PRNGKey(0))
    variables = random_tree(shapes, seed)
    tm = t_cls(**kw, dtype=torch.float32, device="cpu").eval()
    load_flax_params(tm, variables, device="cpu")
    return jm, variables, tm


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return (request.param, *build(request.param))


def ddim_noise(rng, n_steps, shape, mask=False):
    """JAX ddim_sample's draws per step: the mask re-noise (from its own
    split of the step key, first) and the step noise."""
    draws = []
    for k in jax.random.split(jax.random.split(rng)[0], n_steps):
        d = {}
        if mask:
            k_noise, k = jax.random.split(k)
            d["mask"] = np.asarray(jax.random.normal(k_noise, shape))
        d["step"] = np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
        draws.append(d)
    return draws


def replay(draws):
    return lambda i, shape, kind="step": torch.from_numpy(draws[i][kind].copy())


def close_to_scale(got, want, tol=1e-5):
    """float32 through a UNet: 1e-5 of the result's scale (with random
    weights the first DDIM step takes the latent to ~1e2)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_apply_model_matches(pair):
    name, jm, variables, tm = pair
    shape = latent_shape(name, tm)
    rng = np.random.RandomState(1)
    x = rng.randn(B, *shape).astype(np.float32)
    t = np.array([999, 17], np.int32)
    want = jax.jit(lambda v, x, t: jm.apply(v, x, t, None, method=jm.apply_model))(
        variables, x, t)
    with torch.no_grad():
        got = tm.apply_model(torch.from_numpy(x), torch.from_numpy(t).long(), None)
    assert tm.cond_stage_model is None and tm.conditioning_key is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sample_matches(pair):
    """3 DDIM steps at eta 1 (4 run), hoisted, then the first-stage decode;
    the pixel model's decode is the identity."""
    name, jm, variables, tm = pair
    shape = latent_shape(name, tm)
    rng = jax.random.PRNGKey(7)
    x_T = np.random.RandomState(11).randn(B, *shape).astype(np.float32)
    draws = ddim_noise(rng, RUN_STEPS, (B, *shape))
    z_j = jax_sample_images(jm, variables, rng, B, shape, steps=STEPS, eta=1.0,
                            x_T=jnp.asarray(x_T), hoist=True, decode=False)
    img_t, z_t = sample_images(tm, B, shape, steps=STEPS, eta=1.0,
                               x_T=torch.from_numpy(x_T), noise_fn=replay(draws),
                               device="cpu")
    close_to_scale(z_t, z_j)
    if name == "pixel":
        assert torch.equal(img_t, z_t)
    elif name == "inpaint":  # decode VQ codes of the JAX latent on both sides
        with torch.no_grad():
            img = tm.decode_first_stage(torch.from_numpy(np.array(z_j)))
        want = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode_first_stage))(
            variables, z_j)
        np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_inpaint_sample_images_matches(sampler):
    """scripts/inpaint.py's run at a tiny width: the VQ-f4 encode of an
    image, a keep-mask with a hole, `sample_images(mask=, x0=)` at eta 0,
    decode. JAX's mask re-noise is replayed (PLMS draws it from the step key
    itself, DDIM from a split)."""
    jm, variables, tm = build("inpaint", seed=2)
    img = np.random.RandomState(3).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    z_j = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, jax.random.PRNGKey(0), method=jm.encode_first_stage))(variables, img))
    with torch.no_grad():
        z_t = tm.get_first_stage_encoding(tm.encode_first_stage(torch.from_numpy(img)))
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-4, atol=1e-4)
    shape = z_j.shape
    mask = np.ones(shape[:3] + (1,), np.float32)
    mask[:, 2:6, 2:6] = 0.0
    rng = jax.random.PRNGKey(5)
    x_T = np.random.RandomState(4).randn(*shape).astype(np.float32)
    if sampler == "plms":
        keys = jax.random.split(jax.random.split(rng)[0], RUN_STEPS)
        draws = [{"mask": np.asarray(jax.random.normal(k, shape))} for k in keys]
    else:
        draws = ddim_noise(rng, RUN_STEPS, shape, mask=True)
    out_j = jax_sample_images(jm, variables, rng, B, shape[1:], steps=STEPS, eta=0.0,
                              x_T=jnp.asarray(x_T), mask=jnp.asarray(mask),
                              x0=jnp.asarray(z_j), sampler=sampler, decode=False)
    img_t, out_t = sample_images(tm, B, shape[1:], steps=STEPS, eta=0.0, sampler=sampler,
                                 x_T=torch.from_numpy(x_T), mask=torch.from_numpy(mask),
                                 x0=torch.from_numpy(z_j), noise_fn=replay(draws),
                                 device="cpu")
    close_to_scale(out_t, out_j)
    assert img_t.shape == (B, 32, 32, 3) and bool(torch.isfinite(img_t).all())


def test_x0_parameterization_loss_matches():
    """parameterization="x0": the loss target is x_start and the VLB
    weights are the x0 schedule's."""
    jm, variables, tm = build("uncond", seed=4, parameterization="x0")
    rng = np.random.RandomState(6)
    z = rng.randn(B, 8, 8, 4).astype(np.float32)
    noise = rng.randn(B, 8, 8, 4).astype(np.float32)
    t = np.array([5, 700], np.int32)
    want, wm = jax.jit(lambda v: jm.apply(v, z, None, t, noise, deterministic=True,
                                          method=jm.p_losses))(variables)
    with torch.no_grad():
        got, gm = tm.p_losses(torch.from_numpy(z), None, torch.from_numpy(t).long(),
                              torch.from_numpy(noise))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(gm["loss_vlb"].item(), float(wm["loss_vlb"]), rtol=1e-5)


def test_unported_cond_sentinel_raises():
    """`__is_first_stage__` is ported (the conditioning is the first stage's
    encoding; tests/test_torch_port_cond.py holds it against JAX); an
    unknown sentinel string raises, and a cond stage that a later slice
    ports raises NotImplementedError naming its ROADMAP item."""
    kw, _ = CONFIGS["inpaint"]
    kw = copy.deepcopy(kw)
    kw["cond_stage_config"] = "__is_first_stage__"
    tm = TorchLDM(**kw, device="meta")
    assert tm.cond_stage_model is None and tm.cond_stage_sentinel == "__is_first_stage__"
    kw["cond_stage_config"] = "__is_last_stage__"
    with pytest.raises(ValueError, match="__is_last_stage__"):
        TorchLDM(**kw, device="meta")
    kw["cond_stage_config"] = {"target": "ldm.modules.diffusionmodules.util.HybridConditioner",
                               "params": {}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchLDM(**kw, device="meta")
