"""The port's KL first stage against the JAX package, float32 on the CPU, at
`configs/smoke/autoencoder_tiny.yaml`'s ddconfig: `AutoencoderKL`'s encoder
moments and decode, `DiagonalGaussian`'s mode, sample (JAX's noise
replayed), kl (to the standard normal and to another posterior) and nll,
and `LatentDiffusion.encode_first_stage` / `decode_first_stage` with a KL
first stage and a scale factor. Weights are seeded random values of the JAX
tree's shapes, loaded through the bridge.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.models.distributions import DiagonalGaussian
from ealdm_torch.models.vae import AutoencoderKL as TorchKL
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
from ealdm_tpu.models.distributions import DiagonalGaussian as JaxGaussian
from ealdm_tpu.models.vae import AutoencoderKL as JaxKL
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS = yaml.safe_load(
    (REPO / "configs" / "smoke" / "autoencoder_tiny.yaml").read_text())["model"]["params"]
DD, EMBED = PARAMS["ddconfig"], PARAMS["embed_dim"]
RES, B = DD["resolution"], 2
# float32 through an encoder or decoder: XLA:CPU and ATen sum in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def vae():
    jm = JaxKL(ddconfig=dict(DD), embed_dim=EMBED, dtype=jnp.float32)
    x = np.zeros((B, RES, RES, 3), np.float32)
    shapes = jax.eval_shape(lambda r: jm.init({"params": r}, x, r), jax.random.PRNGKey(0))
    variables = random_tree(shapes, 0)
    tm = TorchKL(ddconfig=dict(DD), embed_dim=EMBED, device="cpu").eval()
    load_flax_params(tm, variables, device="cpu")
    img = np.random.RandomState(1).uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    moments = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.quant_conv(
        m.encoder(x))))(variables, img)
    with torch.no_grad():
        post = tm.encode(torch.from_numpy(img))
    return jm, variables, tm, img, np.array(moments), post


def test_encoder_moments_and_mode(vae):
    _, _, tm, _, moments, post = vae
    jpost = JaxGaussian.from_moments(jnp.asarray(moments))
    assert tuple(post.mean.shape) == (B, RES // 2, RES // 2, EMBED)
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(jpost.mean), **TOL)
    np.testing.assert_allclose(post.logvar.numpy(), np.asarray(jpost.logvar), **TOL)
    np.testing.assert_allclose(post.mode().numpy(), np.asarray(jpost.mode()), **TOL)


def test_gaussian_sample_kl_nll(vae):
    """On the same moments (JAX's), the distribution's algebra agrees to
    float32 rounding: 1e-5 relative."""
    moments = vae[4]
    j = JaxGaussian.from_moments(jnp.asarray(moments))
    t = DiagonalGaussian.from_moments(torch.from_numpy(moments))
    key = jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, j.mean.shape))
    s_j = np.asarray(j.sample(key))
    s_t = t.sample(noise=torch.from_numpy(noise))
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5, atol=1e-6)
    other_m = np.random.RandomState(3).randn(*moments.shape).astype(np.float32)
    j2 = JaxGaussian.from_moments(jnp.asarray(other_m))
    t2 = DiagonalGaussian.from_moments(torch.from_numpy(other_m))
    for got, want in ((t.kl(), j.kl()), (t.kl(t2), j.kl(j2)),
                      (t.nll(torch.from_numpy(s_j)), j.nll(jnp.asarray(s_j)))):
        assert tuple(got.shape) == (B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    det = DiagonalGaussian.from_moments(torch.from_numpy(moments), deterministic=True)
    assert not det.kl().any() and torch.equal(det.sample(noise=torch.ones(1)), det.mean)


def test_sample_draws_from_a_generator(vae):
    post = vae[5]
    a = post.sample(torch.Generator().manual_seed(0))
    b = post.sample(torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, post.mean)


def test_decode_matches(vae):
    jm, variables, tm, _, moments, _ = vae
    z = moments[..., :EMBED]
    want = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode))(variables, z)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z))
    assert tuple(got.shape) == (B, RES, RES, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kl_first_stage_in_latent_diffusion():
    """encode_first_stage (a posterior sample with JAX's noise replayed, and
    the mode) times scale_factor, and decode_first_stage dividing it back
    out, on an unconditional LDM whose first stage is the tiny KL model."""
    kw = dict(
        unet_config=dict(image_size=16, in_channels=EMBED, out_channels=EMBED,
                         model_channels=16, attention_resolutions=[], num_res_blocks=1,
                         channel_mult=[1], num_heads=1),
        first_stage_config={"target": "ldm.models.autoencoder.AutoencoderKL",
                            "params": {"embed_dim": EMBED, "ddconfig": dict(DD)}},
        cond_stage_config="__is_unconditional__", scale_factor=0.18215)
    jm = JaxLDM(**kw, dtype=jnp.float32)
    batch = {"img": np.zeros((B, RES, RES, 3), np.float32)}
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r, "dropout": r}, batch, r, method=jm.full_init),
        jax.random.PRNGKey(0))
    variables = random_tree(shapes, 5)
    tm = TorchLDM(**kw, device="cpu").eval()
    load_flax_params(tm, variables, device="cpu")
    img = np.random.RandomState(6).uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def encode(v, x, sample):
        z = jm.apply(v, x, key, sample_posterior=sample, method=jm.encode_first_stage)
        return jm.apply(v, z, method=jm.get_first_stage_encoding)

    z_sample = jax.jit(lambda v, x: encode(v, x, True))(variables, img)
    z_mode = jax.jit(lambda v, x: encode(v, x, False))(variables, img)
    noise = np.asarray(jax.random.normal(key, z_mode.shape))
    with torch.no_grad():
        x = torch.from_numpy(img)
        t_sample = tm.get_first_stage_encoding(
            tm.encode_first_stage(x, noise=torch.from_numpy(noise)))
        t_mode = tm.get_first_stage_encoding(tm.encode_first_stage(x, sample_posterior=False))
        dec = tm.decode_first_stage(torch.from_numpy(np.asarray(z_mode)))
    np.testing.assert_allclose(t_sample.numpy(), np.asarray(z_sample), **TOL)
    np.testing.assert_allclose(t_mode.numpy(), np.asarray(z_mode), **TOL)
    want = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode_first_stage))(
        variables, z_mode)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), **TOL)


def test_vq_still_refuses_double_z():
    from ealdm_torch.models.vae import VQModel

    with pytest.raises(NotImplementedError, match="double_z"):
        VQModel(ddconfig={**DD, "double_z": True}, n_embed=8, embed_dim=EMBED)
    with pytest.raises(NotImplementedError, match="double_z"):
        TorchKL(ddconfig={**DD, "double_z": False}, embed_dim=EMBED)
