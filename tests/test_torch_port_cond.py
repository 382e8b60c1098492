"""The text- and class-conditional slice of the port against the JAX
package, float32 on the CPU, weights from seeded random flax trees through
the bridge:

- `configs/smoke/txt2img_tiny.yaml` (BERT cond stage on the hash-bucket
  tokenizer, VQ first stage): conditioning, 3 DDIM steps (4 run) at eta 0
  with CFG 5 through `sample_images(cond=, uncond=)`, decode; the port's
  unhoisted run against its hoisted one;
- a tiny class-conditional LDM laid out as `CIN256` (ClassEmbedder with a
  null class, a 1-head SpatialTransformer UNet, VQ-f4) with CFG 3;
- a tiny KL LDM with scale factor 0.18215 and an `__is_first_stage__`
  cond stage, under the concat and hybrid keys (UNet with legacy=False),
  and a pixel-space UNet with `num_classes` under the adm key;
- the full-width TXT2IMG and CIN256 trees through the bridge, one to one.

The JAX side runs jitted, as its own tests run it; it samples once a model.
"""
import contextlib
import copy
import gc
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch.inference import hoist_invariants, make_eps_fn, sample_images
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.ops.schedules import DDIMSchedule, DiffusionSchedule
from ealdm_torch.utils import flax_import
from ealdm_tpu.config import _LD_KEYS, model_from_config
from ealdm_tpu.inference import make_eps_fn as jax_make_eps_fn
from ealdm_tpu.inference import sample_images as jax_sample_images
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
from ealdm_tpu.models.text_transformer import SimpleTokenizer as JaxTokenizer
from ealdm_tpu.ops import schedules as jax_schedules
from ealdm_tpu.samplers import DDIMConfig as JaxDDIMConfig
from ealdm_tpu.samplers import ddim_sample as jax_ddim_sample
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3  # "uniform": 1000 // 3 = 333 runs 4 steps


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic collector off while JAX traces and compiles: with the
    test process's heap its passes take about a quarter of a trace's time.
    It runs again on leaving."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def close_to_scale(got, want, tol=1e-5):
    """float32 through a UNet chain: tol of the result's scale (with random
    weights the first DDIM step takes the latent far above 1)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def touch_all(m, img, x, t, cond):
    """Every parameter of the LDM `m`, each module traced once (cheaper than
    `full_init`, which traces the encoder twice and the loss): the cond
    stage, the first stage's encode and decode, the denoiser."""
    m.encode_first_stage(img, sample_posterior=False)
    m.decode_first_stage(x)
    return m.apply_model(x, t, m.get_learned_conditioning(cond))


def tree_shapes(jm, img, x, cond):
    """The flax parameter tree's shapes (the key's generator is the cheapest
    to trace: no value is drawn)."""
    t = jnp.zeros((x.shape[0],), jnp.int32)
    return jax.eval_shape(lambda r: jm.init(r, img, x, t, cond, method=touch_all),
                          jax.random.key(0, impl="unsafe_rbg"))


def flax_shapes_of(module):
    """The flax parameter tree's shapes read off a port module's parameters,
    the bridge's rules run backwards (tracing the flax init would cost more
    than the rest of a tiny model's test): OIHW conv and [out, in] Dense
    weights become HWIO and [in, out] kernels, 1-d weights norm scales."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "weight":
            leaf, shape = {4: ("kernel", shape[2:] + shape[1::-1]),
                           2: ("kernel", shape[::-1]), 1: ("scale", shape)}[len(shape)]
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return {"params": tree}


def build(kw, seed=0):
    """(jax model, variables, port model) sharing one seeded random tree,
    loaded into the port through the bridge."""
    jm = JaxLDM(**copy.deepcopy(kw), dtype=jnp.float32)
    tm = TorchLDM(**copy.deepcopy(kw), dtype=torch.float32, device="cpu").eval()
    variables = random_tree(flax_shapes_of(tm), seed)
    flax_import.load_flax_params(tm, variables, device="cpu")
    return jm, variables, tm


def jax_method(jm, name):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=getattr(jm, name)))


def jax_sample(jm, variables, shape, x_T, c, uc, scale):
    """JAX's sample_images at eta 0 (x_T given, so no draw matters), then
    its decode, jitted."""
    z = jax_sample_images(jm, variables, jax.random.PRNGKey(1), shape[0], shape[1:],
                          steps=STEPS, eta=0.0, guidance_scale=scale, cond=c, uncond=uc,
                          x_T=jnp.asarray(x_T), decode=False)
    return np.asarray(jax_method(jm, "decode_first_stage")(variables, z)), np.asarray(z)


def port_sample(tm, shape, x_T, c, uc, scale, hoist=True, **kw):
    return sample_images(tm, shape[0], shape[1:], steps=STEPS, eta=0.0, guidance_scale=scale,
                         cond=c, uncond=uc, x_T=torch.from_numpy(x_T), hoist=hoist,
                         device="cpu", **kw)


# ---------------------------------------------------------------- txt2img
PROMPT = "a watercolor of a lighthouse on a cliff at dusk"


@pytest.fixture(scope="module")
@gc_paused()
def txt2img():
    cfg = yaml.safe_load((REPO / "configs/smoke/txt2img_tiny.yaml").read_text())["model"]
    p = cfg["params"]
    kw = {k: p[k] for k in _LD_KEYS if k in p}
    kw.update(unet_config=dict(p["unet_config"]["params"]),
              first_stage_config=p["first_stage_config"],
              cond_stage_config=p["cond_stage_config"])
    assert model_from_config(cfg)[0].unet_config == kw["unet_config"]
    csp = p["cond_stage_config"]["params"]
    jtok = JaxTokenizer(csp["vocab_size"], csp["max_seq_len"])
    b = 2
    tokens = np.asarray(jtok([PROMPT] * b + [""] * b))
    side = p["unet_config"]["params"]["image_size"]
    shape = (b, side, side, p["unet_config"]["params"]["in_channels"])
    jm, variables, tm = build(kw)
    enc = jax_method(jm, "get_learned_conditioning")
    c, uc = enc(variables, tokens[:b]), enc(variables, tokens[b:])
    x_T = np.random.RandomState(3).randn(*shape).astype(np.float32)
    img, z = jax_sample(jm, variables, shape, x_T, c, uc, 5.0)
    return dict(tm=tm, tokens=tokens, c=np.array(c), uc=np.array(uc), shape=shape,
                x_T=x_T, img=img, z=z, b=b)


def test_txt2img_tokens_and_conditioning(txt2img):
    """The port's own tokenizer (the hash buckets at vocab_size 1024) gives
    JAX's ids; the BERT context within 1e-5 (after its final LayerNorm)."""
    tm, b = txt2img["tm"], txt2img["b"]
    ids = tm.cond_stage_model.tokenize([PROMPT] * b + [""] * b)
    np.testing.assert_array_equal(ids.numpy(), txt2img["tokens"])
    with torch.no_grad():
        ctx = tm.get_learned_conditioning(ids)
    assert ctx.dtype == torch.float32
    np.testing.assert_allclose(ctx.numpy(), np.concatenate([txt2img["c"], txt2img["uc"]]),
                               rtol=0, atol=1e-5)


def test_txt2img_sample_matches(txt2img):
    """sample_images(cond=, uncond=) with CFG 5, hoisted, and the decode:
    latents within 1e-5 of their scale, images within 1e-5."""
    t = txt2img
    c, uc = torch.from_numpy(t["c"]), torch.from_numpy(t["uc"])
    img, z = port_sample(t["tm"], t["shape"], t["x_T"], c, uc, 5.0)
    close_to_scale(z, t["z"])
    close_to_scale(img, t["img"])
    # port against port: unhoisted, and `mixed` is not encoded when cond is given
    img2, z2 = port_sample(t["tm"], t["shape"], t["x_T"], c, uc, 5.0, hoist=False,
                           mixed={"img": torch.zeros(1)})
    close_to_scale(z2, z.numpy(), tol=1e-6)
    with pytest.raises(NotImplementedError, match="mixed"):
        port_sample(t["tm"], t["shape"], t["x_T"], None, None, 5.0,
                    mixed={"img": torch.zeros(1)})


# ------------------------------------------------------- class-conditional
N_CLASSES = 11  # class 10 is the null class of guidance, as 1000 of 1001


@pytest.fixture(scope="module")
@gc_paused()
def classcond():
    kw = t_config.model_kwargs(t_config.CIN256)
    kw["unet_config"].update(image_size=8, model_channels=16, channel_mult=[1, 2],
                             attention_resolutions=[2], num_res_blocks=1, context_dim=16)
    kw["first_stage_config"]["params"]["n_embed"] = 32
    kw["first_stage_config"]["params"]["ddconfig"].update(resolution=32, ch=16,
                                                          ch_mult=[1, 2, 2])
    kw["cond_stage_config"]["params"].update(n_classes=N_CLASSES, embed_dim=16)
    b = 2
    shape = (b, 8, 8, 3)
    jm, variables, tm = build(kw)
    ids = np.array([3, 7], np.int32)
    null = np.full((b,), N_CLASSES - 1, np.int32)
    x_T = np.random.RandomState(4).randn(*shape).astype(np.float32)
    # the notebook's sampling program (scripts/latent_imagenet_diffusion.ipynb):
    # one jitted conditioning, DDIM with the plain eps_fn, decode
    sched = jax_schedules.DiffusionSchedule.create(
        timesteps=jm.timesteps, linear_start=jm.linear_start, linear_end=jm.linear_end)
    ddim = jax_schedules.DDIMSchedule.create(sched, STEPS, eta=0.0)
    cfg = JaxDDIMConfig(num_steps=STEPS, eta=0.0, unconditional_guidance_scale=3.0,
                        parameterization=jm.parameterization)

    @jax.jit
    def sample_class(v, class_ids, null_ids, x_T):
        c = jm.apply(v, class_ids, method=jm.get_learned_conditioning)
        uc = jm.apply(v, null_ids, method=jm.get_learned_conditioning)
        z = jax_ddim_sample(jax_make_eps_fn(jm, v), jax.random.PRNGKey(1), shape, ddim, cfg,
                            cond=c, uncond=uc, x_T=x_T)
        return c, uc, z, jm.apply(v, z, method=jm.decode_first_stage)

    c, uc, z, img = (np.asarray(a) for a in sample_class(variables, ids, null, x_T))
    return dict(tm=tm, ids=ids, null=null, c=c, uc=uc, shape=shape, x_T=x_T, img=img, z=z)


def test_class_embedder_matches(classcond):
    """ClassEmbedder: [B] ids and [B, k] (first column) -> [B, 1, D], exact."""
    t = classcond
    with torch.no_grad():
        got = t["tm"].get_learned_conditioning(torch.from_numpy(t["ids"]))
        got2 = t["tm"].get_learned_conditioning(
            torch.from_numpy(np.stack([t["null"], t["ids"]], axis=1)))
    assert tuple(got.shape) == (2, 1, 16)
    np.testing.assert_array_equal(got.numpy(), t["c"])
    np.testing.assert_array_equal(got2.numpy(), t["uc"])


def test_class_conditional_sample_matches(classcond):
    """CFG 3 against the null class, hoisted, VQ-f4 decode: within 1e-5 of
    the scale."""
    t = classcond
    with torch.no_grad():
        c = t["tm"].get_learned_conditioning(torch.from_numpy(t["ids"]))
        uc = t["tm"].get_learned_conditioning(torch.from_numpy(t["null"]))
    img, z = port_sample(t["tm"], t["shape"], t["x_T"], c, uc, 3.0)
    close_to_scale(z, t["z"])
    close_to_scale(img, t["img"])


# ------------------------------------------- concat, hybrid, first stage, adm
KL_LDM = dict(
    unet_config=dict(image_size=8, in_channels=8, out_channels=4, model_channels=16,
                     attention_resolutions=[1], num_res_blocks=1, channel_mult=[1],
                     num_head_channels=8, use_spatial_transformer=True, context_dim=16,
                     legacy=False),
    first_stage_config={"target": "ldm.models.autoencoder.AutoencoderKL", "params": {
        "embed_dim": 4, "ddconfig": dict(double_z=True, z_channels=4, resolution=16,
                                         in_channels=3, out_ch=3, ch=16, ch_mult=[1, 2],
                                         num_res_blocks=1, attn_resolutions=[],
                                         dropout=0.0)}},
    cond_stage_config="__is_first_stage__", cond_stage_key="image",
    timesteps=1000, linear_start=0.00085, linear_end=0.012, scale_factor=0.18215,
)


@pytest.fixture(scope="module")
@gc_paused()
def kl():
    """The KL LDM under the concat and the hybrid keys, with one parameter
    tree: the wrapper has none of its own, and with context_dim equal to the
    transformers' width (16: one level) the cross-attention that concat runs
    on the features themselves has the hybrid context's shapes."""
    b = 2
    jm, variables, tm = build(dict(KL_LDM, conditioning_key="concat"))
    kw_h = dict(KL_LDM, conditioning_key="hybrid")
    jm_h = JaxLDM(**copy.deepcopy(kw_h))
    tm_h = TorchLDM(**copy.deepcopy(kw_h), device="cpu").eval()
    flax_import.load_flax_params(tm_h, variables, device="cpu")
    rng = np.random.RandomState(5)
    d = dict(tm=tm, tm_h=tm_h, img=(rng.rand(b, 16, 16, 3) * 2 - 1).astype(np.float32),
             x=rng.randn(b, 8, 8, 4).astype(np.float32),
             ctx=rng.randn(b, 3, 16).astype(np.float32), t=np.array([999, 31], np.int32))

    @jax.jit
    def jax_side(v, img, x, t, ctx):
        """The first-stage map, the decode of x, and the denoiser under
        concat and hybrid, in one program."""
        c_map = jm.apply(v, img, method=jm.get_learned_conditioning)
        return dict(c_map=c_map, decoded=jm.apply(v, x, method=jm.decode_first_stage),
                    concat=jm.apply(v, x, t, c_map, method=jm.apply_model),
                    hybrid=jm_h.apply(v, x, t, {"c_concat": [c_map], "c_crossattn": [ctx]},
                                      method=jm_h.apply_model))

    out = jax_side(variables, d["img"], d["x"], d["t"], d["ctx"])
    return {**d, **{k: np.asarray(v) for k, v in out.items()}}


def test_first_stage_conditioning_and_kl_decode(kl):
    """`__is_first_stage__`: the KL posterior's mode of the image cond
    (1e-5); decode_first_stage of the same latents under scale factor
    0.18215 (1e-5 of the image's scale)."""
    with torch.no_grad():
        got = kl["tm"].get_learned_conditioning(torch.from_numpy(kl["img"]))
        img = kl["tm"].decode_first_stage(torch.from_numpy(kl["x"]))
    assert kl["tm"].cond_stage_model is None
    np.testing.assert_allclose(got.numpy(), kl["c_map"], rtol=0, atol=1e-5)
    close_to_scale(img, kl["decoded"])


@pytest.mark.parametrize("key", ["concat", "hybrid"])
def test_concat_and_hybrid_match(kl, key):
    """apply_model with the first-stage map joined to the latent's channels,
    and for hybrid a 3-token cross-attention context too: 1e-4, as the
    UNet tests of the other slices."""
    tm = kl["tm"] if key == "concat" else kl["tm_h"]
    with torch.no_grad():
        t_map = tm.get_learned_conditioning(torch.from_numpy(kl["img"]))
        t_cond = t_map if key == "concat" else {"c_concat": [t_map],
                                                "c_crossattn": [torch.from_numpy(kl["ctx"])]}
        got = tm.apply_model(torch.from_numpy(kl["x"]), torch.from_numpy(kl["t"]).long(),
                             t_cond)
    np.testing.assert_allclose(got.numpy(), kl[key], rtol=1e-4, atol=1e-4)
    if key == "hybrid":
        with pytest.raises(ValueError, match="dict"):
            tm.apply_model(torch.from_numpy(kl["x"]), torch.from_numpy(kl["t"]).long(), t_map)


def test_hoisting_falls_back_for_concat(kl):
    """A conditioning_key other than None/crossattn runs unhoisted: the plain
    eps_fn, the contexts unchanged, no tables; sampling equals hoist=False."""
    tm = kl["tm"]
    ddim = DDIMSchedule.create(DiffusionSchedule.create(linear_start=0.00085,
                                                        linear_end=0.012), STEPS, eta=0.0)
    with torch.no_grad():
        c = tm.get_learned_conditioning(torch.from_numpy(kl["img"]))
    eps_fn, c2, uc2, tables = hoist_invariants(tm, ddim, c, None)
    assert c2 is c and uc2 is None and tables is None
    assert eps_fn.__code__ is make_eps_fn(tm).__code__
    x_T = np.random.RandomState(6).randn(2, 8, 8, 4).astype(np.float32)
    outs = [port_sample(tm, (2, 8, 8, 4), x_T, c, None, 1.0, hoist=h, decode=False)
            for h in (True, False)]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


ADM = dict(
    unet_config=dict(image_size=8, in_channels=3, out_channels=3, model_channels=16,
                     attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                     num_heads=2, num_classes=5, legacy=False),
    cond_stage_config="__is_unconditional__", conditioning_key="adm",
    cond_stage_key="class_label", timesteps=1000,
)


@gc_paused()
def test_adm_class_unet_matches():
    """A UNet with num_classes under the adm key: label_emb added to the
    timestep embedding (1e-4); emb_tables are refused; hoisting falls back."""
    b = 3
    jm, variables, tm = build(ADM)
    rng = np.random.RandomState(7)
    x = rng.randn(b, 8, 8, 3).astype(np.float32)
    t = np.array([999, 500, 3], np.int32)
    y = np.array([0, 4, 2], np.int32)
    want = jax_method(jm, "apply_model")(variables, x, t, y)
    xt, tt, yt = torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y)
    with torch.no_grad():
        assert torch.equal(tm.get_learned_conditioning(yt), yt)
        got = tm.apply_model(xt, tt, yt)
        unet = tm.model.diffusion_model
        with pytest.raises(ValueError, match="t-only"):
            unet(xt, tt, y=yt, emb_tables={})
        with pytest.raises(ValueError, match="num_classes"):
            unet(xt, tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    outs = [port_sample(tm, (b, 8, 8, 3), x, yt, torch.full((b,), 1), 2.0, hoist=h,
                        decode=False) for h in (True, False)]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


# ------------------------------------------------------- full-width bridge
@pytest.mark.parametrize("name,cond_shape", [("TXT2IMG", (1, 77)), ("CIN256", (1,))])
@gc_paused()
def test_full_width_trees_map_one_to_one(name, cond_shape):
    """The full-width flax trees (shapes only) map onto the port built on the
    meta device: every port parameter set once, with its shape, and every
    flax leaf used (nn.Embed tables, the text transformer's LayerNorms and
    Dense layers with bias)."""
    cfg = getattr(t_config, name)
    kw = t_config.model_kwargs(cfg)
    jm = JaxLDM(**kw, dtype=jnp.bfloat16)
    shapes = tree_shapes(jm, jnp.zeros((1, cfg["res"], cfg["res"], 3)),
                         jnp.zeros((1, cfg["zres"], cfg["zres"], cfg["zch"])),
                         jnp.zeros(cond_shape, jnp.int32))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    tm = TorchLDM(**kw, dtype=torch.bfloat16, device="meta")
    sd = flax_import.flax_to_state_dict(tree)
    flax_import.check_state_dict(tm, sd)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(dict(tm.named_parameters()))


def test_full_width_configs_mirror_the_yaml():
    """TXT2IMG and CIN256 are their YAML's model.params (the keys JAX's
    model_from_config passes on), uncut."""
    for name, path in (("TXT2IMG", "txt2img-1p4B-eval.yaml"), ("CIN256", "cin256-v2.yaml")):
        params = yaml.safe_load((REPO / "configs/latent-diffusion" / path).read_text())
        params = params["model"]["params"]
        kw = t_config.model_kwargs(getattr(t_config, name))
        assert kw["unet_config"] == params["unet_config"]["params"]
        assert kw["cond_stage_config"] == params["cond_stage_config"]
        fs = params["first_stage_config"]
        assert kw["first_stage_config"]["target"] == fs["target"]
        assert kw["first_stage_config"]["params"] == {
            k: v for k, v in fs["params"].items() if k not in ("lossconfig", "monitor")}
        rest = {k: v for k, v in kw.items()
                if k not in ("unet_config", "cond_stage_config", "first_stage_config")}
        assert rest == {k: params[k] for k in _LD_KEYS if k in params}
