"""The port's models against the JAX package at the tiny flagship config
(`bench.build_model(tiny=True)`): UNetModel (plain and with the hoisted
K/V and embedding tables), VQModel encode/decode and UnetCond with env
fusion on and off, all in float32 on the CPU with the same weights. Then
the STDiff branches no config of the sampling path reaches, each built on
its own at a tiny width: EqualizedDense, CondScale with `w`,
FrozenBatchNorm and UnetCond(norm="frozen_bn").

Weights are seeded random values of the JAX parameter tree's shapes, loaded
into the port through the bridge. A fresh flax init would zero the output
convs and make the UNet's output trivially zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.config import TINY, model_kwargs
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.models.unet import (
    precompute_context_kv as t_precompute_kv,
    precompute_emb_tables as t_precompute_emb,
)
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_torch.models import resnet as t_resnet
from ealdm_torch.models import stdiff as t_stdiff
from ealdm_tpu.models import resnet as j_resnet
from ealdm_tpu.models import stdiff as j_stdiff
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
from ealdm_tpu.models.unet import (
    precompute_context_kv as j_precompute_kv,
    precompute_emb_tables as j_precompute_emb,
)

torch.set_num_threads(1)

# float32 on both sides; the sums run in another order (XLA:CPU vs ATen),
# which leaves a few 1e-6 relative per op: a whole UNet stays within 1e-4.
TOL = dict(rtol=1e-4, atol=1e-4)


def random_tree(shapes, seed):
    """Seeded values for a flax parameter tree of ShapeDtypeStructs: kernels
    ~ N(0, 1/fan_in), norm scales near 1, biases and codebooks small."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "embedding":
            v = rng.randn(*shape)
        elif name == "c_to_scales_weight":
            v = rng.randn(*shape) / np.sqrt(shape[-1])
        elif name == "var":
            v = 0.5 + rng.rand(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)  # a 0-d leaf (a loss's logvar) draws a float

    return jax.tree_util.tree_map_with_path(fill, shapes)


def mixed_batch(b, res, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "img": rng.randn(b, res, res, 3).astype(np.float32),
        "img_random": rng.randn(b, res, res, 3).astype(np.float32),
        "flow": rng.randn(b, 1, 1).astype(np.float32),
        "weather": rng.randn(b, 1, 16).astype(np.float32),
        "time": rng.rand(b, 1).astype(np.float32),
    }


def build_pair(cfg=TINY, b=2, seed=0):
    """(jax model, jax variables, port model, numpy mixed batch) at fp32,
    sharing one set of weights."""
    kw = model_kwargs(cfg)
    jm = JaxLDM(**kw, dtype=jnp.float32)
    batch = {"img": np.zeros((b, cfg["res"], cfg["res"], 3), np.float32),
             "mixed": mixed_batch(b, cfg["res"], seed)}
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r, "dropout": r}, batch, r,
                          method=jm.full_init),
        jax.random.PRNGKey(0))
    variables = random_tree(shapes, seed)
    tm = TorchLDM(**kw, dtype=torch.float32, device="cpu").eval()
    load_flax_params(tm, variables, device="cpu")
    return jm, variables, tm, batch["mixed"]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_bridge_loads_every_parameter(pair):
    jm, variables, tm, _ = pair
    w = variables["params"]["model"]["diffusion_model"]["conv_in"]["kernel"]
    got = tm.model.diffusion_model.conv_in.weight.detach().numpy()
    np.testing.assert_array_equal(got, np.transpose(w, (3, 2, 0, 1)))


def _unet_inputs(b=2, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 8, 8, 4).astype(np.float32)
    t = np.array([999, 17][:b], np.int32)
    ctx = rng.randn(b, 4, 512).astype(np.float32)
    return x, t, ctx


def test_unet_matches(pair):
    jm, variables, tm, _ = pair
    x, t, ctx = _unet_inputs()
    want = jm.apply(variables, x, t, ctx, method=jm.apply_model)
    with torch.no_grad():
        got = tm.apply_model(_t(x), _t(t).long(), _t(ctx))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 4)
    _close(got, want)


def test_unet_hoisted_matches(pair):
    """precompute_context_kv + precompute_emb_tables (one table row per
    step, shared by the batch) against the JAX hoisted path."""
    jm, variables, tm, _ = pair
    x, _, ctx = _unet_inputs()
    ts = np.array([1, 500, 999], np.int32)
    unet_j = jm.bind(variables).model.diffusion_model
    params = variables["params"]["model"]["diffusion_model"]
    kv_j = j_precompute_kv(unet_j, params, ctx)
    emb_j = j_precompute_emb(unet_j, params, ts)
    row = {k: v[1] for k, v in emb_j.items()}
    want = jm.apply(variables, x, np.full(2, 500, np.int32), None,
                    context_kv=kv_j, emb_tables=row, method=jm.apply_model)
    unet_t = tm.model.diffusion_model
    with torch.no_grad():
        kv_t = t_precompute_kv(unet_t, _t(ctx))
        emb_t = t_precompute_emb(unet_t, _t(ts).long())
        for site, pairs in kv_t.items():
            _close(pairs[0][0], kv_j[site][0][0], dict(rtol=1e-5, atol=1e-5))
        for site, table in emb_t.items():
            _close(table, emb_j[site], dict(rtol=1e-5, atol=1e-5))
        got = tm.apply_model(_t(x), torch.full((2,), 500), None, context_kv=kv_t,
                             emb_tables={k: v[1] for k, v in emb_t.items()})
    _close(got, want)


def test_vq_encode_decode_match(pair):
    jm, variables, tm, mixed = pair
    img = mixed["img"]
    fs = jm.bind(variables).first_stage_model
    z_j = fs.encode_prequant(img)
    with torch.no_grad():
        z_t = tm.first_stage_model.encode_prequant(_t(img))
    assert z_t.shape == (2, 8, 8, 4)
    _close(z_t, z_j)
    # decode_interface quantizes first: decode the JAX latent on both sides
    dec_j = fs.decode_interface(z_j)
    with torch.no_grad():
        dec_t = tm.first_stage_model.decode_interface(_t(z_j))
    assert dec_t.shape == (2, 64, 64, 3)
    _close(dec_t, dec_j)


@pytest.mark.parametrize("fuse_env", [True, False])
def test_unet_cond_matches(pair, fuse_env):
    jm, variables, tm, mixed = pair
    want = jm.apply(variables, mixed, fuse_env, method=jm.get_learned_conditioning)
    with torch.no_grad():
        got = tm.get_learned_conditioning({k: _t(v) for k, v in mixed.items()},
                                          fuse_env=fuse_env)
    assert got.shape == (2, 4, 512)
    _close(got, want)


def test_conditioning_pair_matches(pair):
    jm, variables, tm, mixed = pair
    neg_j, pos_j = jm.apply(variables, mixed, method=jm.get_learned_conditioning_pair)
    with torch.no_grad():
        neg_t, pos_t = tm.get_learned_conditioning_pair(
            {k: _t(v) for k, v in mixed.items()})
    _close(neg_t, neg_j)
    _close(pos_t, pos_j)


# ------------------------------------------------------------------ STDiff
def _init_pair(jmod, tmod, *args, seed=3):
    """Seeded random weights of jmod's tree, loaded into tmod; returns the
    JAX variables."""
    shapes = jax.eval_shape(lambda r: jmod.init(r, *args), jax.random.PRNGKey(0))
    variables = random_tree(shapes, seed)
    load_flax_params(tmod, variables, device="cpu")
    return variables


@pytest.mark.parametrize("activation,lr", [("linear", 1.0), ("lrelu", 1.0),
                                           ("lrelu", 0.01), ("swish", 0.5)])
def test_equalized_dense_matches(activation, lr):
    x = np.random.RandomState(0).randn(3, 12).astype(np.float32)
    jm = j_stdiff.EqualizedDense(8, activation=activation, lr_multiplier=lr)
    tm = t_stdiff.EqualizedDense(12, 8, activation=activation, lr_multiplier=lr)
    variables = _init_pair(jm, tm, x)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(variables, x))


COND_ARGS = {"type": "fourier", "dims": 6, "f_manual": [1.0, 365.25],
             "include_lin": True, "lin_lr": 0.01, "lr": 1}


@pytest.mark.parametrize("branches", ["w_and_c", "w_only"])
def test_cond_scale_matches(branches):
    """`w_affine(w)` (bias 1) times the Fourier scales of c, or alone."""
    rng = np.random.RandomState(1)
    cond_args = COND_ARGS if branches == "w_and_c" else {"type": "none"}
    xform = j_stdiff.ConditioningTransform(COND_ARGS)
    c = np.asarray(xform(jnp.asarray(rng.rand(2, 1).astype(np.float32)), broadcast=False))
    w = rng.randn(2, 6).astype(np.float32)
    jm = j_stdiff.CondScale(16, cond_args, w_dim=6)
    tm = t_stdiff.CondScale(16, cond_args, c.shape[-1], w_dim=6)
    variables = _init_pair(jm, tm, w, c)
    with torch.no_grad():
        got = tm(_t(w), _t(c))
    assert got.shape == (2, 16)
    _close(got, jm.apply(variables, w, c))


def test_frozen_batch_norm_matches():
    x = (2 * np.random.RandomState(2).randn(2, 3, 4, 6) + 1).astype(np.float32)
    jm, tm = j_resnet.FrozenBatchNorm(6), t_resnet.FrozenBatchNorm(6)
    variables = _init_pair(jm, tm, x)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(variables, x))


@pytest.mark.parametrize("fuse_env", [True, False])
def test_unet_cond_frozen_bn_matches(fuse_env):
    rng = np.random.RandomState(4)
    kw = dict(mid_dim=4, emb_dim=16, out_dim=32, w_dim=16, f_dim=1, hidden_dim=16,
              norm="frozen_bn")
    args = (rng.randn(2, 4, 4, 4).astype(np.float32), rng.randn(2, 1, 1).astype(np.float32),
            rng.randn(2, 1, 16).astype(np.float32), rng.rand(2, 1).astype(np.float32))
    jm = j_stdiff.UnetCond(**kw)
    tm = t_stdiff.UnetCond(**kw, feat_hw=4).eval()
    variables = _init_pair(jm, tm, *args)
    with torch.no_grad():
        got = tm(*(_t(a) for a in args), fuse_env=fuse_env)
    assert got.shape == (2, 4, 32)
    _close(got, jm.apply(variables, *args, fuse_env))
