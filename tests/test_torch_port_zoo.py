"""The model-zoo slice of the port against the JAX package, float32 on the
CPU, weights from seeded random flax trees through the bridge:

- `ResBlock` with scale-shift norm, `up` and `down` (and a hoisted row),
  the UNet options no zoo entry sets (refused), and a tiny UNet's ResBlock
  resample sites and hoisted scale-shift emb tables;
- `SpatialRescaler` (182 -> 3 channels over 2 stages; bilinear, which
  antialiases when it downsamples, and nearest), and the VQ model with
  `attn_type="none"`;
- a tiny LDM laid out as `ldm/lsun_churches256` (unconditional, KL-f8,
  scale-shift, ResBlock resampling) sampled for 3 DDIM steps (4 run) at
  eta 1, hoisted, with JAX's noise replayed; and one laid out as
  `ldm/inpainting_big` (concat of the attention-free VQ-f4 encoding of the
  masked image and the mask, 7 input channels) for 3 steps at eta 0;

`log_images` has a file of its own (`test_torch_port_log_images.py`): its
JAX side alone takes about 20 s on the CPU.

Tolerances: 1e-5 of each result's scale through a UNet or a decoder
(float32, sums in another order; with random weights the first DDIM step
takes the latent far above 1), 1e-5 relative for single layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import zoo
from ealdm_torch.inference import hoist_invariants, sample_images
from ealdm_torch.models import encoders as t_enc
from ealdm_torch.models import layers as t_layers
from ealdm_torch.models import unet as t_unet
from ealdm_torch.models import vae as t_vae
from ealdm_torch.ops.schedules import DDIMSchedule, DiffusionSchedule
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu.inference import sample_images as jax_sample_images
from ealdm_tpu.models import encoders as j_enc
from ealdm_tpu.models import layers as j_layers
from ealdm_tpu.models import unet as j_unet
from ealdm_tpu.models import vae as j_vae
from tests.test_torch_port_cond import build, close_to_scale, flax_shapes_of, gc_paused
from tests.test_torch_port_models import random_tree
from tests.test_torch_port_uncond import ddim_noise, replay

torch.set_num_threads(1)

B = 2
STEPS, RUN_STEPS = 3, 4  # "uniform": 1000 // 3 = 333 strides 0, 333, 666, 999
# single layers: float32, sums in another order
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(tm, seed=0):
    """A seeded flax tree of the port module's parameter shapes, loaded into
    it; the JAX module applies the same tree (and raises on a missing or
    extra leaf)."""
    variables = random_tree(flax_shapes_of(tm), seed)
    load_flax_params(tm, variables, device="cpu")
    return variables


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# --------------------------------------------------------------- layers
RESBLOCKS = {
    "scale_shift": dict(use_scale_shift_norm=True, cout=64),
    "scale_shift_hoisted": dict(use_scale_shift_norm=True, cout=64, hoisted=True),
    "up": dict(up=True),
    "down": dict(down=True),
    "scale_shift_up": dict(use_scale_shift_norm=True, up=True),
    "scale_shift_down": dict(use_scale_shift_norm=True, down=True),
}


@pytest.mark.parametrize("case", list(RESBLOCKS))
def test_resblock_options(case):
    """ResBlock against the JAX block: scale-shift splits the 2C embedding
    projection (scale, shift); up / down resample h and the skip input after
    the in-norm's SiLU; a hoisted row is one [(2*)C] row for the batch."""
    opts = dict(RESBLOCKS[case])
    cout, hoisted = opts.pop("cout", 32), opts.pop("hoisted", False)
    x, emb = _rand(B, 8, 8, 32), _rand(B, 128, seed=2)
    jm = j_layers.ResBlock(out_channels=cout, **opts)
    tm = t_layers.ResBlock(32, cout, 128, **opts).eval()
    variables = _pair(tm)
    if hoisted:
        row = _rand(2 * cout, seed=3)
        want = jax.jit(lambda v, x, r: jm.apply(v, x, None, emb_out=r))(variables, x, row)
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), None, emb_out=torch.from_numpy(row))
    else:
        want = jax.jit(jm.apply)(variables, x, emb)
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(emb))
    side = 16 if opts.get("up") else 4 if opts.get("down") else 8
    assert want.shape == (B, side, side, cout)
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("key,value", [("dropout", 0.1), ("conv_resample", False),
                                       ("num_heads_upsample", 4)])
def test_unet_refuses_unported_options(key, value):
    """Of the JAX UNet's options, only the values the zoo sets are ported:
    no zoo entry sets dropout, plain resamples without convs or a separate
    head count for the up path, so the UNet refuses them rather than half
    running them."""
    with pytest.raises(NotImplementedError, match=key):
        t_unet.UNetModel(8, 4, 32, 4, 1, [2], channel_mult=[1, 2], num_heads=8,
                         use_scale_shift_norm=True, resblock_updown=True, **{key: value})
    for entry in zoo.names():
        unet = zoo.spec(entry).get("unet", {})
        assert unet.get(key, t_unet._FIXED_OPTIONS[key]) == t_unet._FIXED_OPTIONS[key], entry


@gc_paused()
def test_unet_emb_tables_and_sites():
    """churches' UNet options (scale-shift norm, ResBlock resampling, 8
    heads) at a tiny width: the plan's ResBlock sites carry JAX's names in
    JAX's order, the hoisted [S, 2C] emb tables are JAX's, and the output
    from one step's rows is the unhoisted output. (The UNet itself is held
    to JAX's through the hoisted DDIM steps of
    `test_churches_sample_matches`.)"""
    cfg = dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
               attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
               use_scale_shift_norm=True, resblock_updown=True, num_heads=8)
    jm = j_unet.UNetModel(**cfg, data_format="NHWC")
    tm = t_unet.UNetModel(**cfg).eval()
    variables = _pair(tm)
    j_res, _ = j_unet.unet_site_plan(jm)
    t_res, _ = t_unet.unet_site_plan(tm)
    assert t_res == j_res and {"down_0_downres", "up_1_upres"} <= set(t_res)
    steps = np.array([1, 334, 667, 999], np.int32)
    j_tab = jax.jit(lambda p, s: j_unet.precompute_emb_tables(jm, p, s))(
        variables["params"], steps)
    with torch.no_grad():
        t_tab = t_unet.precompute_emb_tables(tm, torch.from_numpy(steps).long())
    assert list(t_tab) == t_res and sorted(j_tab) == sorted(t_res)
    for site, tab in t_tab.items():
        assert tab.shape == (4, 2 * getattr(tm, site).out_conv.weight.shape[0])
        close_to_scale(tab, j_tab[site])
    x = torch.from_numpy(_rand(B, 8, 8, 4))
    with torch.no_grad():
        got = tm(x, None, emb_tables={k: v[2] for k, v in t_tab.items()})
        want = tm(x, torch.full((B,), 667))
    close_to_scale(got, want)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_spatial_rescaler(method):
    """semantic_synthesis256's cond stage: 182 segmentation channels, 2
    stages of x0.5 (64^2 -> 16^2; bilinear antialiases, its weights
    renormalised at the borders) and the bias-free 1x1 map to 3 channels."""
    params = dict(n_stages=2, in_channels=182, out_channels=3, method=method)
    x = np.random.RandomState(5).rand(B, 64, 64, 182).astype(np.float32)
    jm = j_enc.SpatialRescaler(**params)
    tm = t_enc.build_encoder("ldm.modules.encoders.modules.SpatialRescaler", params)
    variables = _pair(tm)
    want = jm.apply(variables, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (B, 16, 16, 3)
    _close(got, want)


@gc_paused()
def test_vq_attn_type_none():
    """vq-f4-noattn: no attention module anywhere, the encoder's
    pre-quantization latent and the decode of its codes as JAX's."""
    dd = dict(zoo.spec("first_stage_models/vq-f4-noattn")["ddconfig"], resolution=16, ch=16,
              ch_mult=[1, 2], num_res_blocks=1)
    jm = j_vae.VQModel(ddconfig=dd, n_embed=32, embed_dim=3)
    tm = t_vae.VQModel(ddconfig=dd, n_embed=32, embed_dim=3, device="cpu").eval()
    assert not any(isinstance(m, t_vae.VaeAttnBlock) for m in tm.modules())
    variables = _pair(tm)
    img = np.random.RandomState(6).uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    want_z, want_img = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: (
        m.encode_prequant(x), m.decode_interface(m.encode_prequant(x)))))(variables, img)
    with torch.no_grad():
        z = tm.encode_prequant(torch.from_numpy(img))
        rec = tm.decode_interface(z)
    close_to_scale(z, want_z)
    close_to_scale(rec, want_img)


# --------------------------------------------------------------- LDMs
def tiny_zoo(name, unet, ddconfig, n_embed=None):
    """A zoo entry's LatentDiffusion kwargs cut to tiny widths (same options
    and layout)."""
    kw = zoo.model_kwargs(name)
    kw["unet_config"].update(unet)
    fs = kw["first_stage_config"]["params"]
    fs["ddconfig"].update(ddconfig)
    if n_embed is not None:
        fs["n_embed"] = n_embed
    return kw


CHURCHES = tiny_zoo("ldm/lsun_churches256",
                    dict(image_size=8, model_channels=16, attention_resolutions=[1],
                         channel_mult=[1, 2], num_res_blocks=1),
                    dict(resolution=16, ch=16, ch_mult=[1, 2], num_res_blocks=1))
INPAINT_BIG = tiny_zoo("ldm/inpainting_big",
                       dict(image_size=8, model_channels=16, attention_resolutions=[2],
                            channel_mult=[1, 2], num_res_blocks=1),
                       dict(resolution=16, ch=16, ch_mult=[1, 2], num_res_blocks=1),
                       n_embed=32)


@gc_paused()
def test_churches_sample_matches():
    """lsun_churches256's path at a tiny width: DDIM at eta 1, hoisted (the
    emb tables carry 2C scale-shift rows), then the KL decode (held to JAX's
    in `test_torch_port_kl.py`)."""
    jm, variables, tm = build(CHURCHES, seed=7)
    assert tm.model.diffusion_model.plan.count(("res", "down_0_downres")) == 1
    shape = (B, 8, 8, 4)
    rng = jax.random.PRNGKey(8)
    x_T = _rand(*shape, seed=9)
    z_j = jax_sample_images(jm, variables, rng, B, shape[1:], steps=STEPS, eta=1.0,
                            x_T=jnp.asarray(x_T), hoist=True, decode=False)
    img_t, z_t = sample_images(tm, B, shape[1:], steps=STEPS, eta=1.0,
                               x_T=torch.from_numpy(x_T),
                               noise_fn=replay(ddim_noise(rng, RUN_STEPS, shape)), device="cpu")
    close_to_scale(z_t, z_j)
    assert img_t.shape == (B, 16, 16, 3) and bool(torch.isfinite(img_t).all())


@gc_paused()
def test_inpainting_big_sample_matches():
    """inpainting_big's path at a tiny width: the conditioning is the VQ
    encoder's pre-quantization latent of the masked image (the
    `__is_first_stage__` cond stage) joined to the nearest-resized hole
    mask; concat takes the plain step (no hoisting); DDIM at eta 0, where
    no draw matters. Both samplers take the JAX side's conditioning."""
    jm, variables, tm = build(INPAINT_BIG, seed=10)
    rng = np.random.RandomState(11)
    img = rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((B, 16, 16, 1), np.float32)
    mask[:, 4:12, 2:10] = 1.0
    masked = img * (1.0 - mask)
    x_T = _rand(B, 8, 8, 3, seed=13)

    @jax.jit
    def jax_side(v, masked, x_T):
        c = jm.apply(v, masked, method=jm.get_learned_conditioning)
        cond = jnp.concatenate([c, mask[:, ::2, ::2]], axis=-1)  # nearest 16 -> 8
        return c, cond

    c_j, cond = (np.array(a) for a in jax_side(variables, masked, x_T))
    with torch.no_grad():
        c_t = tm.get_learned_conditioning(torch.from_numpy(masked))
    close_to_scale(c_t, c_j)
    assert cond.shape == (B, 8, 8, 4)
    ddim = DDIMSchedule.create(DiffusionSchedule.create(), STEPS)
    eps_fn, *_, extra = hoist_invariants(tm, ddim, torch.from_numpy(cond))
    assert extra is None and eps_fn.__name__ == "eps_fn"
    z_j = jax_sample_images(jm, variables, jax.random.PRNGKey(12), B, (8, 8, 3), steps=STEPS,
                            eta=0.0, cond=jnp.asarray(cond), x_T=jnp.asarray(x_T),
                            decode=False)
    img_t, z_t = sample_images(tm, B, (8, 8, 3), steps=STEPS, eta=0.0,
                               cond=torch.from_numpy(cond), x_T=torch.from_numpy(x_T),
                               noise_fn=lambda i, shape: torch.zeros(shape), device="cpu")
    close_to_scale(z_t, z_j)
    composite = img * (1 - mask) + img_t.numpy() * mask
    assert composite.shape == img.shape and np.isfinite(composite).all()
