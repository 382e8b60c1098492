"""The port's command-line tools (`ealdm_torch/scripts/`) against the JAX
package's scripts, on the CPU in float32: each tool's computation on the
same weights and x_T with JAX's draws replayed through the samplers' noise
hook (sample_diffusion's neutral-conditioning DDIM and ancestral chains,
txt2img's guided DDIM and PLMS, inpaint's masked DDIM, knn2img's [query;
neighbours] conditioning from a text and an image query), inpaint's
`make_batch` and keep-mask against Pillow and `jax.image.resize`, and each
tool end to end in-process with the JAX tests' arguments, sample_diffusion
on a run dir the port's CheckpointManager wrote.
"""
import importlib
import importlib.util
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch.scripts import inpaint as t_inpaint
from ealdm_torch.scripts import knn2img as t_knn2img
from ealdm_torch.scripts import sample_diffusion as t_sample
from ealdm_torch.scripts import txt2img as t_txt2img
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu import config as j_config
from ealdm_tpu.ops.schedules import DDIMSchedule, DiffusionSchedule
from ealdm_tpu.samplers import DDIMConfig, ancestral_sample, ddim_sample, plms_sample
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
XLA = {"xla_backend_optimization_level": 0}
CPU = ["--device", "cpu"]
EXAMPLES = REPO / "data" / "inpainting_examples"


def jax_script(name):
    """A module of the JAX package's `scripts/` (its jax imports are inside
    its functions)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pair_from_yaml(path, batch, seed):
    """(JAX model, its seeded variables, the port's model with them) of a
    config file, float32 on the CPU."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    jm, _ = j_config.model_from_config(cfg["model"])
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, batch, r,
                                              method=jm.full_init), jax.random.PRNGKey(0))
    variables = random_tree(shapes, seed)
    tm, _ = t_config.model_from_config(t_config.load_config([str(path)])["model"], device="cpu")
    load_flax_params(tm.eval(), variables, device="cpu")
    return cfg, jm, variables, tm


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA)


@pytest.fixture(autouse=True)
def _gc_paused():
    """Python's cyclic collector off in each test: its passes over the test
    process's heap take about a quarter of a JAX trace's time."""
    from tests.test_torch_port_cond import gc_paused

    with gc_paused():
        yield


def step_draws(rng, steps, shape, mask=False):
    """JAX ddim_sample's draws at each step (0 = the highest t), by kind."""
    draws = []
    for k in jax.random.split(jax.random.split(rng)[0], steps):
        d = {}
        if mask:
            k_noise, k = jax.random.split(k)
            d["mask"] = np.asarray(jax.random.normal(k_noise, shape))
        d["step"] = np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
        draws.append(d)
    return draws


def replay(draws):
    return lambda i, shape, kind="step": torch.from_numpy(draws[i][kind].copy())


def close_to_scale(got, want, tol=1e-4):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ----------------------------------------------------------- inpaint inputs
def test_make_batch_equals_pillow():
    j_inpaint = jax_script("inpaint")
    for stem in ("example0", "example1"):
        args = (str(EXAMPLES / f"{stem}.png"), str(EXAMPLES / f"{stem}_mask.png"))
        for size in (256, 32):
            want, got = j_inpaint.make_batch(*args, size=size), t_inpaint.make_batch(*args, size)
            np.testing.assert_array_equal(got["mask"], want["mask"])
            np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=1 / 127.5)
            np.testing.assert_allclose(got["masked_image"], want["masked_image"], rtol=0,
                                       atol=1 / 127.5)


def test_luma_equals_pillow_convert_l():
    from PIL import Image

    rgb = np.random.RandomState(0).randint(0, 256, (17, 19, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(t_inpaint.to_luma(rgb), want)
    rgba = np.concatenate([rgb, rgb[..., :1]], axis=2)
    np.testing.assert_array_equal(t_inpaint.to_luma(rgba),
                                  np.asarray(Image.fromarray(rgba).convert("L")))


def test_keep_mask_equals_jax_nearest():
    """The stripe mask (1 where the column is 2 mod 4) at 256 -> 64: JAX's
    resize keeps every stripe (mean 1), torch's "nearest" none (mean 0)."""
    stripe = np.zeros((1, 256, 256, 1), np.float32)
    stripe[:, :, 2::4] = 1.0
    masks = [stripe] + [t_inpaint.make_batch(str(EXAMPLES / f"{s}.png"),
                                             str(EXAMPLES / f"{s}_mask.png"), 256)["mask"]
                        for s in ("example0", "example1")]
    for m in masks:
        for side in (64, 32, 8):
            want = 1.0 - np.asarray(jax.image.resize(jnp.asarray(m), (1, side, side, 1),
                                                     "nearest"))
            np.testing.assert_array_equal(t_inpaint.keep_mask(torch.from_numpy(m), side), want)
    assert float(t_inpaint.keep_mask(torch.from_numpy(stripe), 64).mean()) == 0.0
    hole = torch.nn.functional.interpolate(torch.from_numpy(stripe).permute(0, 3, 1, 2),
                                           size=(64, 64), mode="nearest")
    assert float(hole.mean()) == 0.0  # what torch's "nearest" would have kept


# ----------------------------------------------------------- sample_diffusion
MICRO = REPO / "configs" / "smoke" / "stdiff_micro.yaml"


@pytest.fixture(scope="module")
def micro():
    from tests.test_torch_port_models import mixed_batch

    batch = {"img": np.zeros((2, 16, 16, 3), np.float32), "mixed": mixed_batch(2, 16)}
    return pair_from_yaml(MICRO, batch, seed=6)


def test_sample_diffusion_neutral_ddim_and_ancestral_equal_jax(micro):
    cfg, jm, variables, tm = micro
    b, shape = 2, (2, 8, 8, 4)
    neutral = {k: v.numpy() for k, v in t_sample.neutral_mixed(b, 16, "cpu").items()}
    sched = DiffusionSchedule.create(timesteps=jm.timesteps, beta_schedule=jm.beta_schedule,
                                     linear_start=jm.linear_start, linear_end=jm.linear_end)
    ddim = DDIMSchedule.create(sched, 3, eta=1.0)
    cfg_j = DDIMConfig(num_steps=3, eta=1.0, parameterization=jm.parameterization)

    def program(rng, x_T):
        """The JAX script's: the neutral context, DDIM from x_T and the
        ancestral chain (its x_T drawn from rng), each decoded."""
        c = jm.apply(variables, neutral, False, method=jm.get_learned_conditioning)

        def eps_fn(x, t, ctx):
            return jm.apply(variables, x, t, c, method=jm.apply_model)

        z = ddim_sample(eps_fn, rng, shape, ddim, cfg_j, x_T=x_T)
        za = ancestral_sample(eps_fn, rng, shape, sched)
        dec = lambda z_: jm.apply(variables, z_, method=jm.decode_first_stage)  # noqa: E731
        return c, z, dec(z), za

    rng = jax.random.PRNGKey(42)
    x_T = np.random.RandomState(1).randn(*shape).astype(np.float32)
    c_j, z_j, img_j, za_j = compiled(program, rng, x_T)(rng, x_T)
    c_t = t_sample.neutral_conditioning(tm, b, 16, "cpu")
    close_to_scale(c_t, c_j, 1e-5)
    steps = int(ddim.timesteps.shape[0])
    img_t, z_t = t_sample.sample_batch(tm, shape, c_t, 3, 1.0, False,
                                       x_T=torch.from_numpy(x_T),
                                       noise_fn=replay(step_draws(rng, steps, shape)))
    close_to_scale(z_t, z_j)
    close_to_scale(img_t, img_j)

    # the full-T ancestral chain: x_T from the key's second half, step j's
    # noise from the j-th split of its first
    rest, init = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(init, shape))
    noises = [np.asarray(jax.random.normal(k, shape))
              for k in jax.random.split(rest, jm.timesteps)]
    _, z_t = t_sample.sample_batch(tm, shape, c_t, 0, 1.0, True, x_T=torch.from_numpy(x_T),
                                   noise_fn=lambda j, s: torch.from_numpy(noises[j].copy()))
    close_to_scale(z_t, za_j)


def _port_run_dir(root, tm):
    """A logdir as `ealdm_torch.main` leaves it: configs/ and a `last`
    checkpoint of a TrainState whose EMA shadow differs from its
    parameters."""
    from ealdm_torch.training import CheckpointManager, init_train_state

    logdir = root / "2026-01-01T00-00-00_micro"
    (logdir / "configs").mkdir(parents=True)
    (logdir / "configs" / "2026-01-01T00-00-00-project.yaml").write_text(MICRO.read_text())
    state, _ = init_train_state(tm, device="cpu")
    with torch.no_grad():
        for k, s in state.ema.shadow.items():
            s.add_(0.01 * torch.randn(s.shape, generator=torch.Generator().manual_seed(1)))
    CheckpointManager(str(logdir / "checkpoints"), monitor=None).save_last(state, 7)
    return logdir, state


def test_sample_diffusion_cli_samples_with_the_ema_shadow(micro, tmp_path):
    from ealdm_torch.scripts._common import load_sampling_weights, to_uint8
    from ealdm_torch.utils.png import load_png

    cfg, _, _, tm = micro
    logdir, state = _port_run_dir(tmp_path, tm)
    out = tmp_path / "out"
    t_sample.main(["-r", str(logdir), "-n", "3", "--batch_size", "2", "-c", "2", "-l",
                   str(out), *CPU])
    pngs = sorted(os.listdir(out / "img"))
    assert pngs == ["000000.png", "000001.png", "000002.png"]
    arr = np.load(out / "3_samples.npz")["arr_0"]
    assert arr.shape == (3, 16, 16, 3) and arr.dtype == np.uint8
    np.testing.assert_array_equal(load_png(str(out / "img" / "000002.png")), arr[2])
    saved = json.loads((out / "sampling_config.json").read_text())
    assert saved["n_samples"] == 3 and saved["custom_steps"] == 2

    def first_batch(weights):
        m, _ = t_config.model_from_config(t_config.load_config([str(MICRO)])["model"],
                                          device="cpu")
        load_sampling_weights(m.eval(), {"params": weights, "ema": None})
        g = torch.Generator().manual_seed(42)
        img, _ = t_sample.sample_batch(m, (2, 8, 8, 4),
                                       t_sample.neutral_conditioning(m, 2, 16, "cpu"), 2, 1.0,
                                       False, generator=g)
        return to_uint8(img)

    np.testing.assert_array_equal(arr[:2], first_batch(state.ema.shadow))
    assert not np.array_equal(arr[:2], first_batch(state.params))


# ------------------------------------------------------------------ txt2img
TXT2IMG = REPO / "configs" / "smoke" / "txt2img_tiny.yaml"


@pytest.fixture(scope="module")
def txt2img_pair():
    n = 2
    cfg = yaml.safe_load(TXT2IMG.read_text())
    tokens_c, tokens_uc = t_txt2img.tokens(cfg, "a small stream", n)
    batch = {"img": np.zeros((n, 32, 32, 3), np.float32), "caption": tokens_c.numpy()}
    return (cfg, tokens_c, tokens_uc) + pair_from_yaml(TXT2IMG, batch, seed=8)[1:]


@pytest.mark.parametrize("plms", [False, True])
def test_txt2img_guided_sampling_equals_jax(plms, txt2img_pair):
    from ealdm_tpu.models.text_transformer import SimpleTokenizer

    cfg, tokens_c, tokens_uc, jm, variables, tm = txt2img_pair
    n, shape = 2, (2, 16, 16, 4)
    csc = cfg["model"]["params"]["cond_stage_config"]["params"]
    jtok = SimpleTokenizer(vocab_size=csc["vocab_size"], max_len=csc["max_seq_len"])
    np.testing.assert_array_equal(tokens_c.numpy(), np.asarray(jtok(["a small stream"] * n)))
    np.testing.assert_array_equal(tokens_uc.numpy(), np.asarray(jtok([""] * n)))
    sched = DiffusionSchedule.create(timesteps=jm.timesteps, linear_start=jm.linear_start,
                                     linear_end=jm.linear_end)
    ddim = DDIMSchedule.create(sched, 4, eta=0.0)
    cfg_j = DDIMConfig(num_steps=4, eta=0.0, unconditional_guidance_scale=5.0,
                       parameterization=jm.parameterization)
    sampler = plms_sample if plms else ddim_sample

    def program(rng, x_T, tc, tuc):
        """The JAX script's: both prompts' contexts, guided sampling, decode."""
        c = jm.apply(variables, tc, method=jm.get_learned_conditioning)
        uc = jm.apply(variables, tuc, method=jm.get_learned_conditioning)

        def eps_fn(x, t, ctx):
            return jm.apply(variables, x, t, ctx, method=jm.apply_model)

        z = sampler(eps_fn, rng, shape, ddim, cfg_j, cond=c, uncond=uc, x_T=x_T)
        return c, z, jm.apply(variables, z, method=jm.decode_first_stage)

    rng = jax.random.PRNGKey(0)
    x_T = np.random.RandomState(2).randn(*shape).astype(np.float32)
    args = (rng, x_T, tokens_c.numpy(), tokens_uc.numpy())
    c_j, z_j, img_j = compiled(program, *args)(*args)
    with torch.no_grad():
        c_t = tm.get_learned_conditioning(tokens_c)
        uc_t = tm.get_learned_conditioning(tokens_uc)
    close_to_scale(c_t, c_j, 1e-5)
    img_t, z_t = t_txt2img.sample(tm, c_t, uc_t, shape, 4, 0.0, 5.0, plms,
                                  x_T=torch.from_numpy(x_T),
                                  noise_fn=lambda i, s, kind="step": torch.zeros(s))
    close_to_scale(z_t, z_j)
    close_to_scale(img_t, img_j)


@pytest.mark.parametrize("args,n", [
    (["--prompt", "a small stream", "--n_samples", "2", "--ddim_steps", "4", "--H", "32",
      "--W", "32"], 2),
    (["--prompt", "night river", "--n_samples", "1", "--ddim_steps", "5", "--plms"], 1),
])
def test_txt2img_cli(tmp_path, args, n):
    out = tmp_path / "txt2img"
    grid = t_txt2img.main(["--config", str(TXT2IMG), *args, "--outdir", str(out), *CPU])
    assert len(os.listdir(out / "samples")) == n
    assert os.path.basename(grid) == args[1].replace(" ", "-") + ".png"


# ------------------------------------------------------------------ inpaint
def test_inpaint_tiny_equals_jax():
    from ealdm_tpu.inference import sample_images as j_sample_images
    from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
    from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM

    size, kw = t_inpaint.model_kwargs(tiny=True)
    batch = t_inpaint.make_batch(str(EXAMPLES / "example0.png"),
                                 str(EXAMPLES / "example0_mask.png"), size)
    jm = JaxLDM(**kw)
    shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r},
                                              {"img": batch["image"]}, r, method=jm.full_init),
                            jax.random.PRNGKey(0))
    variables = random_tree(shapes, 9)
    tm = TorchLDM(**kw, device="cpu").eval()
    load_flax_params(tm, variables, device="cpu")

    x, mask_px = jnp.asarray(batch["image"]), jnp.asarray(batch["mask"])
    zshape = (1, 16, 16, 3)  # the VQ-f2 latent of 32^2

    # the JAX script's: encode, the latent keep-mask, masked DDIM at eta 0
    # from x_T (`sample_images` compiles its own chain), the composite
    z = jm.scale_factor * compiled(
        lambda v, x_: jm.apply(v, x_, jax.random.PRNGKey(1), method=jm.encode_first_stage),
        variables, x)(variables, x)
    keep = 1.0 - jax.image.resize(mask_px, (1, z.shape[1], z.shape[2], 1), "nearest")
    rng = jax.random.PRNGKey(2)
    x_T = np.random.RandomState(3).randn(*zshape).astype(np.float32)
    img_j, _ = j_sample_images(jm, variables, rng, 1, z.shape[1:], steps=4, eta=0.0,
                               mask=keep, x0=z, x_T=jnp.asarray(x_T))
    want = np.asarray(x * (1 - mask_px) + img_j * mask_px)
    steps = len(DDIMSchedule.create(DiffusionSchedule.create(timesteps=1000), 4).timesteps)
    result, _, keep_t = t_inpaint.inpaint(
        tm, batch, 4, False, x_T=torch.from_numpy(x_T),
        noise_fn=replay(step_draws(rng, steps, zshape, mask=True)))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep))
    close_to_scale(result, want)


def test_inpaint_cli_keeps_the_known_region(tmp_path):
    from PIL import Image

    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    rng = np.random.RandomState(0)
    img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(indir / "example.png")
    mask = np.zeros((32, 32), np.uint8)
    mask[8:24, 8:24] = 255
    Image.fromarray(mask).save(indir / "example_mask.png")
    t_inpaint.main(["--indir", str(indir), "--outdir", str(outdir), "--steps", "4", "--tiny",
                    *CPU])
    out = np.asarray(Image.open(outdir / "example.png"))
    np.testing.assert_allclose(out[:4, :4], img[:4, :4], atol=2)


@pytest.mark.parametrize("plms", [False, True])
def test_inpaint_cli_on_the_committed_examples(tmp_path, plms):
    outs = t_inpaint.main(["--outdir", str(tmp_path), "--steps", "2", "--tiny", *CPU]
                          + (["--plms"] if plms else []))
    assert sorted(os.path.basename(p) for p in outs) == ["example0.png", "example1.png"]
    assert set(os.listdir(tmp_path)) == {"example0.png", "example1.png"}


# ------------------------------------------------------------------ knn2img
SMALL_CLIP = {"text": (64, 2, 4, 512), "vision": (64, 2, 4, 16, 512)}
RDM = REPO / "configs" / "smoke" / "rdm_tiny.yaml"


@pytest.fixture
def small_clip(monkeypatch):
    import ealdm_torch.models.encoders as t_enc
    import ealdm_tpu.models.encoders as j_enc

    for mod in (t_enc, j_enc):
        monkeypatch.setitem(mod.CLIP_VERSIONS, "test-knn", SMALL_CLIP)
    return "test-knn"


@pytest.mark.parametrize("query", ["text", "image"])
def test_knn2img_conditioning_equals_jax(tmp_path, small_clip, query):
    """The JAX script's `embed_queries` computation (the tower's first
    context token of each prompt, or the image tower's embedding of the PNG
    in [-1, 1] repeated) and the port's on the same tower weights, then
    [query; k neighbours] from one index."""
    from PIL import Image

    from ealdm_torch.retrieval import Searcher as TSearcher
    from ealdm_torch.retrieval import retrieval_conditioning
    from ealdm_tpu.models.encoders import FrozenClipImageEmbedder, FrozenCLIPTextEmbedder
    from ealdm_tpu.retrieval import Searcher as JSearcher

    opt = t_knn2img.get_parser().parse_args(["--database", "x", "--prompt",
                                            "a stone bridge at dusk"])
    opt.clip_type = small_clip
    if query == "image":
        pixels = (np.random.RandomState(1).rand(48, 40, 3) * 255).astype(np.uint8)
        opt.query_image = str(tmp_path / "query.png")
        Image.fromarray(pixels).save(opt.query_image)
        emb = FrozenClipImageEmbedder.from_version(small_clip)
        x = jnp.asarray(pixels, jnp.float32)[None] / 127.5 - 1.0
    else:
        emb = FrozenCLIPTextEmbedder.from_version(small_clip)
        x = jnp.zeros((1, 77), jnp.int32)
    params = random_tree(jax.eval_shape(lambda r: emb.init(r, x), jax.random.PRNGKey(0)), 4)
    if query == "image":
        q_j = np.repeat(np.asarray(compiled(emb.apply, params, x)(params, x)), 2, axis=0)
    else:
        toks = jnp.asarray(emb.bind(params).tokenize([opt.prompt] * 2))
        q_j = np.asarray(compiled(emb.apply, params, toks)(params, toks))[:, 0, :]
    q_t, texts = t_knn2img.embed_queries(opt, 2, "cpu", params=params)
    assert texts == (["<image:query.png>"] * 2 if query == "image" else [opt.prompt] * 2)
    np.testing.assert_allclose(q_t.numpy(), q_j, rtol=0, atol=1e-5)

    db = np.random.RandomState(2).randn(32, 512).astype(np.float32)
    nns = JSearcher(db).search(q_j, k=3)
    c_j = np.concatenate([q_j[:, None, :], np.asarray(nns["nn_embeddings"])], axis=1)
    c_t, uc_t, _ = retrieval_conditioning(q_t, TSearcher(db, device="cpu"), k=3,
                                          guidance_scale=2.0)
    assert tuple(c_t.shape) == (2, 4, 512)
    np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=1e-5)
    assert not uc_t.any()


def test_knn2img_cli_text_query(tmp_path):
    db_path = str(tmp_path / "db.npz")
    np.savez(db_path, embedding=np.random.RandomState(0).randn(32, 512).astype(np.float32))
    out = tmp_path / "rdm"
    t_knn2img.main(["--config", str(RDM), "--database", db_path, "--prompt",
                    "a stone bridge at dusk", "--use_neighbors", "--knn", "3", "--clip_type",
                    "ViT-B/32", "--n_samples", "2", "--ddim_steps", "4", "--scale", "2.0",
                    "--H", "32", "--W", "32", "--outdir", str(out), *CPU])
    assert len(os.listdir(out / "samples")) == 2
    assert any(f.startswith("grid") for f in os.listdir(out))


def test_knn2img_cli_image_query_from_an_index(tmp_path):
    from PIL import Image

    from ealdm_tpu.retrieval import Searcher as JSearcher

    rng = np.random.RandomState(1)
    idx_path = str(tmp_path / "index.npz")
    JSearcher(rng.randn(24, 512).astype(np.float32)).save(idx_path)
    img_path = str(tmp_path / "query.png")
    Image.fromarray((rng.rand(48, 48, 3) * 255).astype(np.uint8)).save(img_path)
    out = tmp_path / "rdm_img"
    t_knn2img.main(["--config", str(RDM), "--database", idx_path, "--query_image", img_path,
                    "--use_neighbors", "--knn", "2", "--clip_type", "ViT-B/32", "--n_samples",
                    "1", "--ddim_steps", "4", "--plms", "--scale", "2.0", "--H", "32", "--W",
                    "32", "--outdir", str(out), "--skip_grid", *CPU])
    assert len(os.listdir(out / "samples")) == 1
    jpg = tmp_path / "query.jpg"
    jpg.write_bytes(b"\xff\xd8")
    with pytest.raises(NotImplementedError, match="item 9"):
        t_knn2img.main(["--config", str(RDM), "--database", idx_path, "--query_image",
                        str(jpg), "--clip_type", "ViT-B/32", "--outdir", str(out), *CPU])


def test_knn2img_reads_an_orbax_checkpoint(tmp_path):
    """`--ckpt .../last/state`, a StandardCheckpointer save of the JAX
    package's TrainState (as JAX's knn2img.py restores it): the model
    samples with the checkpoint's EMA shadow."""
    from ealdm_torch.utils.flax_import import flax_to_state_dict
    from ealdm_tpu.training import TrainState, make_optimizer
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager
    from ealdm_tpu.training.ema import ema_init
    from tests.test_torch_port_cond import flax_shapes_of

    tm, _ = t_config.model_from_config(t_config.load_config([str(RDM)])["model"], device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_tree(flax_shapes_of(tm), seed=8)["params"])
    shadow = jax.tree_util.tree_map(lambda p: p + 0.5, params)
    state = TrainState(step=jnp.asarray(5, jnp.int32), params=params,
                       opt_state=make_optimizer(1e-4, params).init(params),
                       ema=ema_init(params)._replace(shadow=shadow))
    mgr = JaxManager(str(tmp_path / "ckpt"), monitor=None)
    mgr.save_last(jax.device_get(state), 5)
    mgr.close()
    ckpt = tmp_path / "ckpt" / "last" / "state"
    db_path = str(tmp_path / "db.npz")
    np.savez(db_path, embedding=np.random.RandomState(0).randn(16, 512).astype(np.float32))
    opt = t_knn2img.get_parser().parse_args(["--config", str(RDM), "--ckpt", str(ckpt),
                                             "--database", db_path, *CPU])
    model, _ = t_knn2img.load_model(opt, "cpu")
    want = flax_to_state_dict(jax.device_get(shadow))
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
    out = tmp_path / "rdm"
    t_knn2img.main(["--config", str(RDM), "--ckpt", str(ckpt), "--database", db_path,
                    "--use_neighbors", "--knn", "2", "--clip_type", "ViT-B/32", "--n_samples",
                    "1", "--ddim_steps", "2", "--H", "32", "--W", "32", "--outdir", str(out),
                    "--skip_grid", *CPU])
    assert len(os.listdir(out / "samples")) == 1


# ---------------------------------------------------------------- the card
@pytest.mark.parametrize("name,argv", [
    ("sample_diffusion", ["-r", "logs/none"]),
    ("txt2img", []),
    ("inpaint", ["--outdir", "out"]),
    ("train_searcher", ["-d", "db.npz", "-t", "index.npz"]),
    ("knn2img", ["--database", "db.npz"]),
    ("export_sampler", ["-r", "logs/none", "-o", "a.bin"]),
])
def test_cli_needs_the_card_unless_asked(name, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without CUDA")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"ealdm_torch.scripts.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not os.listdir(tmp_path)
