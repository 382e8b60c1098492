"""Split-input patching in the port (`ealdm_torch/ops/patching.py` and the
patched branches of `LatentDiffusion`) against the JAX package, float32 on
the CPU:

- `unfold2d`, `fold2d`, `compute_weighting` (with and without the tie
  breaker) and `patched_apply` with an up- and a down-factor, within 1e-6;
  on a crop grid that does not cover the input, NaN at exactly JAX's
  places (the stitch divides 0 by 0 there, as the reference does);
- the patched `apply_model` of a tiny hybrid UNet (concat map and
  cross-attention context): one crop equals the dense call, and a 3x3 crop
  grid equals JAX's, within 1e-5;
- the patched VQ encode (3x3 image crops) and decode (3x3 latent crops)
  against JAX's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.ops import patching as tp
from ealdm_tpu.ops import patching as jp
from tests.test_torch_port_cond import build, gc_paused, jax_method

torch.set_num_threads(1)

P = dict(jp.DEFAULT_SPLIT_PARAMS, ks=(8, 8), stride=(4, 4), vqf=2, tie_braker=True)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _exact(got, want, tol=1e-6):
    """Within tol of the result's scale (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_unfold_and_fold_match():
    x = _rand((2, 16, 12, 3))
    crops = tp.unfold2d(torch.from_numpy(x), (8, 6), (4, 3))
    want = jp.unfold2d(jnp.asarray(x), (8, 6), (4, 3))
    assert tuple(crops.shape) == (2, 9, 8, 6, 3)
    _exact(crops, want, tol=0)
    # dense NHWC crops, also where one crop is the whole input
    assert crops.is_contiguous() and tp.unfold2d(torch.from_numpy(x), (16, 12),
                                                 (16, 12)).is_contiguous()
    patches = _rand((2, 9, 8, 6, 3), seed=1)
    _exact(tp.fold2d(torch.from_numpy(patches), (16, 12), (8, 6), (4, 3)),
           jp.fold2d(jnp.asarray(patches), (16, 12), (8, 6), (4, 3)))


@pytest.mark.parametrize("tie_braker", [False, True])
def test_weighting_matches(tie_braker):
    p = dict(P, tie_braker=tie_braker)
    got = tp.compute_weighting(8, 6, 3, 4, p)
    _exact(got, jp.compute_weighting(8, 6, 3, 4, p), tol=0)
    assert tuple(got.shape) == (12, 8, 6, 1)


@pytest.mark.parametrize("uf,df", [(1, 1), (2, 1), (1, 2)])
def test_patched_apply_matches(uf, df):
    """fn resamples by uf / df and is not linear, so each crop's output and
    the stitch are both exercised."""
    x = _rand((2, 16, 16, 2), seed=2)

    def fn_t(c):
        c = torch.tanh(c) + c.square()
        if uf > 1:
            c = c.repeat_interleave(uf, 1).repeat_interleave(uf, 2)
        return c[:, ::df, ::df]

    def fn_j(c):
        c = jnp.tanh(c) + jnp.square(c)
        if uf > 1:
            c = jnp.repeat(jnp.repeat(c, uf, axis=1), uf, axis=2)
        return c[:, ::df, ::df]

    got = tp.patched_apply(fn_t, torch.from_numpy(x), P, uf=uf, df=df)
    want = jax.jit(lambda a: jp.patched_apply(fn_j, a, P, uf=uf, df=df))(x)
    assert tuple(got.shape) == (2, 16 * uf // df, 16 * uf // df, 2) and got.is_contiguous()
    _exact(got, want)


def test_uncovered_border_is_nan_where_jax_is():
    """ks 16 and stride 8 over 28x28 leave the last 4 rows and columns
    uncovered: 208 NaN pixels a sample in both packages."""
    x = _rand((2, 28, 28, 3), seed=3)
    p = dict(P, ks=(16, 16), stride=(8, 8))
    got = tp.patched_apply(lambda c: 2 * c, torch.from_numpy(x), p).numpy()
    want = np.asarray(jax.jit(lambda a: jp.patched_apply(lambda c: 2 * c, a, p))(x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[..., 0]).sum() == 416
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=0, atol=1e-5)


# ------------------------------------------------------------ patched UNet
HYBRID = dict(
    unet_config=dict(image_size=16, in_channels=5, out_channels=3, model_channels=16,
                     num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
                     num_heads=2, use_spatial_transformer=True, context_dim=8, legacy=False),
    cond_stage_config="__is_unconditional__", conditioning_key="hybrid", timesteps=8,
    unconditional_guidance_scale=1.0,
)


@pytest.fixture(scope="module")
@gc_paused()
def hybrid():
    """A 24x24 latent with a 2-channel concat map and a 3-token context:
    ks 16, stride 4 gives 3x3 crops; on a 16x16 input, ks 16 one crop."""
    from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM

    b = 2
    jm, variables, tm = build(HYBRID, seed=4)
    rng = np.random.RandomState(5)
    d = dict(x=rng.randn(b, 24, 24, 3).astype(np.float32),
             cmap=rng.randn(b, 24, 24, 2).astype(np.float32),
             ctx=rng.randn(b, 3, 8).astype(np.float32), t=np.array([7, 2], np.int32))
    grid = dict(P, ks=(16, 16), stride=(4, 4))
    jm_p = JaxLDM(**copy.deepcopy(HYBRID), split_input_params=grid)
    ctx = {"c_concat": [d["cmap"]], "c_crossattn": [d["ctx"]]}
    d["patched"] = np.asarray(jax_method(jm_p, "apply_model")(variables, d["x"], d["t"], ctx))
    return dict(d, tm=tm, grid=grid)


def _port_ctx(d, side=24):
    return {"c_concat": [torch.from_numpy(d["cmap"][:, :side, :side])],
            "c_crossattn": [torch.from_numpy(d["ctx"])]}


def test_patched_apply_model_matches(hybrid):
    d, tm = hybrid, hybrid["tm"].clone(split_input_params=hybrid["grid"])
    with torch.no_grad():
        got = tm.apply_model(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]).long(),
                             _port_ctx(d))
        with pytest.raises(ValueError, match="hoisted"):
            tm.apply_model(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]).long(), None,
                           emb_tables={})
        with pytest.raises(ValueError, match="concat conditioning"):
            tm.apply_model(torch.from_numpy(d["x"]), torch.from_numpy(d["t"]).long(),
                           {"c_concat": [torch.zeros(2, 16, 16, 2)], "c_crossattn": None})
    np.testing.assert_allclose(got.numpy(), d["patched"], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(d["patched"]).max()))


def test_one_crop_equals_dense(hybrid):
    d = hybrid
    one = d["tm"].clone(split_input_params=dict(P, ks=(16, 16), stride=(16, 16)))
    x, t = torch.from_numpy(d["x"][:, :16, :16]), torch.from_numpy(d["t"]).long()
    with torch.no_grad():
        got = one.apply_model(x, t, _port_ctx(d, 16))
        want = d["tm"].apply_model(x, t, _port_ctx(d, 16))
    assert d["tm"].split_input_params is None  # the clone left the model as it was
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------- patched first stage
VQ_LDM = dict(
    unet_config=dict(image_size=8, in_channels=3, out_channels=3, model_channels=8,
                     num_res_blocks=1, attention_resolutions=[], channel_mult=[1],
                     num_heads=1),
    first_stage_config={"target": "ldm.models.autoencoder.VQModelInterface", "params": {
        "embed_dim": 3, "n_embed": 16, "ddconfig": dict(
            double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=8,
            ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)}},
    cond_stage_config="__is_unconditional__", timesteps=8, unconditional_guidance_scale=1.0,
)


@gc_paused()
def test_patched_vq_encode_and_decode_match():
    """The encode over 3x3 image crops of 16^2 (stride 8, vqf 4: 4^2 latent
    crops stitched to 8^2) and the decode, with and without quantizing,
    over 3x3 latent crops of 4^2 (stride 2, each decoded to 16^2)."""
    from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM

    enc_p = dict(P, ks=(16, 16), stride=(8, 8), vqf=4)
    dec_p = dict(P, ks=(4, 4), stride=(2, 2), vqf=4)
    jm, variables, tm = build(VQ_LDM, seed=6)
    img = np.random.RandomState(7).randn(1, 32, 32, 3).astype(np.float32)
    jm_e = JaxLDM(**copy.deepcopy(VQ_LDM), split_input_params=enc_p)
    jm_d = JaxLDM(**copy.deepcopy(VQ_LDM), split_input_params=dec_p)

    @jax.jit
    def jax_side(v, img):
        z = jm_e.apply(v, img, None, False, method=jm_e.encode_first_stage)
        return z, [jm_d.apply(v, z, nq, method=jm_d.decode_first_stage) for nq in (False, True)]

    z_j, dec_j = jax_side(variables, img)
    with torch.no_grad():
        z = tm.clone(split_input_params=enc_p).encode_first_stage(torch.from_numpy(img))
        dec = [tm.clone(split_input_params=dec_p).decode_first_stage(z, force_not_quantize=nq)
               for nq in (False, True)]
    assert tuple(z.shape) == (1, 8, 8, 3)
    _exact(z, z_j, tol=1e-5)
    for got, want in zip(dec, dec_j):
        assert tuple(got.shape) == (1, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())))
