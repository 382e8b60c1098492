"""The port's retrieval-augmented sampling (`ealdm_torch/retrieval.py`,
`config.RDM768`) against the JAX package on the CPU, float32:

- `Searcher`: the exact and the partitioned search give JAX's indices and
  its scores within 1e-6; `build_partitions` gives JAX's leaves for a seed;
  the -1 / -inf / 0 slots where the probed leaves hold fewer than k;
  `auto_build_searcher`'s size threshold and probe count, which `save`
  keeps; an index saved by either package loads in the other;
- the slice on `configs/smoke/rdm_tiny.yaml`: a small CLIP text tower with
  embed_dim 512 embeds the prompt, a seeded database gives the k
  neighbours, the [query; neighbours] context (1e-5) drives DDIM (3 steps
  asked, 4 run) at eta 0 with CFG 5 against the zero context, hoisted;
  latents and decode within 1e-4 of their scale against JAX's
  `hoist_invariants` + `ddim_sample`;
- `config.RDM768` is the 768x768.yaml's `model.params`, and its model built
  on "meta" has the names and shapes of `jax.eval_shape` of the JAX init.
"""
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch import retrieval as t_ret
from ealdm_torch.inference import sample_images
from ealdm_torch.models import encoders as t_enc
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.utils import flax_import
from ealdm_tpu import retrieval as j_ret
from ealdm_tpu.config import _LD_KEYS
from ealdm_tpu.inference import hoist_invariants as jax_hoist_invariants
from ealdm_tpu.models import encoders as j_enc
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM
from ealdm_tpu.ops import schedules as jax_schedules
from ealdm_tpu.samplers import DDIMConfig as JaxDDIMConfig
from ealdm_tpu.samplers import ddim_sample as jax_ddim_sample
from tests.test_torch_port_clip import pair
from tests.test_torch_port_cond import build, close_to_scale, gc_paused, tree_shapes

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-6


def database(n, d, seed):
    return {"embedding": np.random.RandomState(seed).randn(n, d).astype(np.float32),
            "img_id": np.arange(n)}


def assert_same_search(got, want):
    np.testing.assert_array_equal(got["nn_indices"].numpy(), want["nn_indices"])
    np.testing.assert_allclose(got["nn_scores"].numpy(), want["nn_scores"], rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(got["nn_embeddings"].numpy(), want["nn_embeddings"], rtol=0,
                               atol=SCORE_TOL)


def test_exact_search_matches():
    db = database(300, 16, seed=0)
    q = np.random.RandomState(1).randn(5, 16).astype(np.float32)
    js, ts = j_ret.Searcher.from_database(db), t_ret.Searcher.from_database(db, device="cpu")
    np.testing.assert_allclose(ts.embeddings.numpy(), js.embeddings, rtol=0, atol=SCORE_TOL)
    assert (ts.num_entries, ts.dim, ts.partitioned) == (300, 16, False)
    assert_same_search(ts.search(q, k=7), js.search(q, k=7))
    # k past the database's size is capped, as in JAX
    small = database(4, 16, seed=2)
    got = t_ret.Searcher.from_database(small, device="cpu").search(q, k=10)
    assert_same_search(got, j_ret.Searcher.from_database(small).search(q, k=10))


def test_partitions_and_partitioned_search_match():
    """The same seed gives JAX's leaves (padded index and mask equal,
    centroids within 1e-6), and probing 3 of 12 leaves JAX's result."""
    db = database(600, 16, seed=3)
    q = np.random.RandomState(4).randn(6, 16).astype(np.float32)
    js, ts = j_ret.Searcher.from_database(db), t_ret.Searcher.from_database(db, device="cpu")
    js.build_partitions(12, seed=5)
    ts.build_partitions(12, seed=5)
    assert ts.partitioned
    np.testing.assert_array_equal(ts._leaf_idx.numpy(), js._leaf_idx)
    np.testing.assert_array_equal(ts._leaf_mask.numpy(), js._leaf_mask)
    np.testing.assert_allclose(ts._centroids.numpy(), js._centroids, rtol=0, atol=SCORE_TOL)
    assert_same_search(ts.search(q, k=8, leaves_to_search=3),
                       js.search(q, k=8, leaves_to_search=3))
    # no probe count given or baked in: the exact path
    assert_same_search(ts.search(q, k=8), js.search(q, k=8))


def test_short_leaves_pad_with_sentinels():
    """One probed leaf of a few members cannot fill k = 10: the tail slots
    are -1, -inf and zeros, as in JAX."""
    db = database(40, 8, seed=6)
    q = np.random.RandomState(7).randn(3, 8).astype(np.float32)
    js, ts = j_ret.Searcher.from_database(db), t_ret.Searcher.from_database(db, device="cpu")
    js.build_partitions(10, seed=0)
    ts.build_partitions(10, seed=0)
    got = ts.search(q, k=10, leaves_to_search=1)
    assert_same_search(got, js.search(q, k=10, leaves_to_search=1))
    short = got["nn_indices"] == -1
    assert short.any() and got["nn_indices"].shape == (3, 10)
    assert torch.isneginf(got["nn_scores"][short]).all()
    assert not got["nn_embeddings"][short].any()
    assert torch.isfinite(got["nn_scores"][~short]).all()


def test_auto_build_thresholds_and_persisted_probe_count(tmp_path):
    """Exact below 1e5 entries; at 1e5 the partitions with num_leaves // 20
    probes, which save / load keep in both packages."""
    small = database(99_999, 4, seed=8)
    assert not t_ret.auto_build_searcher(small, device="cpu").partitioned
    db = database(100_000, 4, seed=9)
    s = t_ret.auto_build_searcher(db, num_leaves=40, device="cpu")
    assert s.partitioned and s.default_leaves_to_search == 2
    assert s._centroids.shape == (40, 4) and int(s._leaf_mask.sum()) == 100_000
    s.save(tmp_path / "index.npz")
    assert t_ret.Searcher.load(tmp_path / "index.npz", device="cpu").default_leaves_to_search == 2
    assert j_ret.Searcher.load(str(tmp_path / "index.npz")).default_leaves_to_search == 2


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_index_loads_across_packages(tmp_path, saved_by):
    """A partitioned index with a baked-in probe count, saved by one
    package, searches the same in the other (metadata kept)."""
    db = database(500, 16, seed=10)
    q = np.random.RandomState(11).randn(4, 16).astype(np.float32)
    path = tmp_path / "index.npz"
    if saved_by == "jax":
        src = j_ret.Searcher.from_database(db)
        src.build_partitions(10, seed=1)
        src.default_leaves_to_search = 2
        src.save(str(path))
        want = src.search(q, k=6)
        got_s = t_ret.Searcher.load(path, device="cpu")
        got = got_s.search(q, k=6)
        np.testing.assert_array_equal(got_s.metadata["img_id"], db["img_id"])
    else:
        src = t_ret.Searcher.from_database(db, device="cpu")
        src.build_partitions(10, seed=1)
        src.default_leaves_to_search = 2
        src.save(path)
        got = src.search(q, k=6)
        dst = j_ret.Searcher.load(str(path))
        want = dst.search(q, k=6)
        np.testing.assert_array_equal(dst.metadata["img_id"], db["img_id"])
    assert (got["nn_indices"] >= 0).all()
    assert_same_search(got, want)


# ------------------------------------------------------- the slice
PROMPT = "a happy bear reading a newspaper, oil on canvas"
STEPS, SCALE, K = 3, 5.0, 10


@gc_paused()
def test_rdm_tiny_retrieval_sampling_matches(monkeypatch):
    """knn2img's path on the tiny RDM: the text query of n = 2 prompts, k =
    10 neighbours from a seeded 256 x 512 database (exact search), the
    [2, 11, 512] context, DDIM at eta 0 with CFG 5, the KL decode."""
    for mod in (j_enc, t_enc):  # a small ViT-B/32-wide (512) text tower
        monkeypatch.setitem(mod.CLIP_VERSIONS, "test-rdm", {"text": (64, 2, 4, 512)})
    cfg = yaml.safe_load((REPO / "configs/smoke/rdm_tiny.yaml").read_text())["model"]
    p = cfg["params"]
    kw = {k: p[k] for k in _LD_KEYS if k in p}
    kw.update(unet_config=dict(p["unet_config"]["params"]),
              first_stage_config=p["first_stage_config"],
              cond_stage_config=p["cond_stage_config"])
    n = 2

    # the query: the same prompt through both text towers
    jemb = j_enc.FrozenCLIPTextEmbedder.from_version("test-rdm")
    temb = t_enc.FrozenCLIPTextEmbedder.from_version("test-rdm", device="cpu").eval()
    tokens = np.asarray(j_enc.SimpleTokenizer(49408, 77)([PROMPT] * n))
    variables = pair(jemb, temb, jnp.asarray(tokens), seed=12)
    jq = np.asarray(jax.jit(jemb.apply)(variables, jnp.asarray(tokens))[:, 0, :])
    tq = t_ret.embed_queries(n, texts=[PROMPT], text_embedder=temb)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=0, atol=1e-5)

    # the context: [query ; k neighbours] and its zero twin
    db = database(256, 512, seed=13)
    js, ts = j_ret.Searcher.from_database(db), t_ret.Searcher.from_database(db, device="cpu")
    nns = js.search(jq, k=K)
    jc = np.concatenate([jq[:, None, :], nns["nn_embeddings"]], axis=1)
    c, uc, tnns = t_ret.retrieval_conditioning(tq, ts, k=K, guidance_scale=SCALE)
    np.testing.assert_array_equal(tnns["nn_indices"].numpy(), nns["nn_indices"])
    assert c.shape == (n, 1 + K, 512) and c.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=1e-5)
    assert not uc.any() and uc.shape == c.shape
    assert t_ret.retrieval_conditioning(tq, None, guidance_scale=1.0)[1] is None

    # the sampling: JAX's hoist_invariants + ddim_sample, the port's sample_images
    jm, mvars, tm = build(kw, seed=14)
    side, zch = p["unet_config"]["params"]["image_size"], p["unet_config"]["params"]["in_channels"]
    shape = (n, side, side, zch)
    x_T = np.random.RandomState(15).randn(*shape).astype(np.float32)
    sched = jax_schedules.DiffusionSchedule.create(
        timesteps=jm.timesteps, beta_schedule=jm.beta_schedule,
        linear_start=jm.linear_start, linear_end=jm.linear_end)
    ddim = jax_schedules.DDIMSchedule.create(sched, STEPS, eta=0.0)
    dcfg = JaxDDIMConfig(num_steps=STEPS, eta=0.0, unconditional_guidance_scale=SCALE,
                         parameterization=jm.parameterization)

    @jax.jit
    def jax_run(cond, uncond, x):
        eps_fn, cond, uncond, extra = jax_hoist_invariants(jm, mvars, ddim, cond, uncond)
        z = jax_ddim_sample(eps_fn, jax.random.PRNGKey(1), shape, ddim, dcfg, cond=cond,
                            uncond=uncond, x_T=x, extra_tables=extra)
        return jm.apply(mvars, z, method=jm.decode_first_stage), z

    jimg, jz = jax_run(jnp.asarray(jc), jnp.zeros_like(jnp.asarray(jc)), jnp.asarray(x_T))
    img, z = sample_images(tm, n, shape[1:], steps=STEPS, eta=0.0, guidance_scale=SCALE,
                           cond=c, uncond=uc, x_T=torch.from_numpy(x_T), device="cpu")
    close_to_scale(z, jz, tol=1e-4)
    close_to_scale(img, jimg, tol=1e-4)


def test_conditioning_refuses_a_searcher_elsewhere():
    """The neighbours are not copied across devices: a searcher on another
    device than the queries raises."""
    far = t_ret.Searcher.from_database(database(8, 16, seed=16), device="meta")
    q = torch.from_numpy(np.random.RandomState(17).randn(2, 16).astype(np.float32))
    with pytest.raises(ValueError, match="the searcher is on meta"):
        t_ret.retrieval_conditioning(q, far, k=3)


def test_image_query_is_repeated():
    """An image query embeds once and stands for all n samples."""
    emb = t_enc.FrozenClipImageEmbedder(out_dim=16, image_size=32, patch_size=16, width=32,
                                        n_layer=1, n_heads=2, device="cpu").eval()
    with torch.no_grad():
        for i, p in enumerate(emb.parameters()):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.2)
    img = torch.rand(1, 128, 128, 3) * 2 - 1
    q = t_ret.embed_queries(3, image=img, image_embedder=emb)
    assert q.shape == (3, 16)
    torch.testing.assert_close(q, emb(img).expand(3, -1), rtol=0, atol=0)


# ------------------------------------------------------- full width
def test_rdm768_mirrors_the_yaml():
    """RDM768 is 768x768.yaml's model.params: the keys JAX's
    model_from_config passes on, uncut."""
    params = yaml.safe_load(
        (REPO / "configs/retrieval-augmented-diffusion/768x768.yaml").read_text())
    params = params["model"]["params"]
    kw = t_config.model_kwargs(t_config.RDM768)
    assert kw["unet_config"] == params["unet_config"]["params"]
    assert kw["cond_stage_config"] == params["cond_stage_config"]
    fs = params["first_stage_config"]
    assert kw["first_stage_config"] == fs
    rest = {k: v for k, v in kw.items()
            if k not in ("unet_config", "cond_stage_config", "first_stage_config")}
    assert rest == {k: params[k] for k in _LD_KEYS if k in params}
    side = t_config.RDM768["res"] // 2 ** (len(fs["params"]["ddconfig"]["ch_mult"]) - 1)
    assert (side, t_config.RDM768["zch"]) == (params["image_size"], params["channels"])


@gc_paused()
def test_rdm768_tree_maps_one_to_one():
    """The full-width flax tree (shapes only, a [1, 11, 768] context through
    the Identity cond stage) onto the port built on "meta": 1,405.1 M
    parameters, every one set once with its shape."""
    kw = t_config.model_kwargs(t_config.RDM768)
    jm = JaxLDM(**copy.deepcopy(kw), dtype=jnp.bfloat16)
    shapes = tree_shapes(jm, jnp.zeros((1, 256, 256, 3)), jnp.zeros((1, 48, 48, 16)),
                         jnp.zeros((1, 11, 768)))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    tm = TorchLDM(**kw, dtype=torch.bfloat16, device="meta")
    sd = flax_import.flax_to_state_dict(tree)
    flax_import.check_state_dict(tm, sd)
    assert len(sd) == len(dict(tm.named_parameters()))
    assert sum(p.numel() for p in tm.parameters()) == 1_405_091_363
