"""The port's CLIP towers and CLIP cond stages (`ealdm_torch/models/clip.py`,
`models/encoders.py`) against the JAX package on the CPU, float32, weights
from one seeded random flax tree carried by the bridge (`load_flax_params`,
which fails on a missing, unused or misshapen leaf):

- the text tower (width 64, 2 layers, 4 heads) with an explicit `eot_id`,
  with the argmax rule, and on a sequence that lacks the id: 1e-5;
- the image tower (patch 8) through `clip_preprocess` from an image smaller
  and one larger than the tower's size (the larger takes the antialiased
  downsampling): 1e-5;
- both cond stages as `build_encoder` makes them (token ids equal, outputs
  1e-5), on a small geometry registered under one version name in both
  packages' `CLIP_VERSIONS`;
- at full width with no compute: the ViT-L/14 towers built on torch's
  "meta" device have the parameter names and shapes of `jax.eval_shape` of
  the JAX init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.models import clip as t_clip
from ealdm_torch.models import encoders as t_enc
from ealdm_torch.utils.flax_import import flax_to_state_dict, load_flax_params
from ealdm_tpu.models import clip as j_clip
from ealdm_tpu.models import encoders as j_enc
from tests.test_torch_port_cond import gc_paused
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

TOL = 1e-5
SMALL = dict(width=64, layers=2, heads=4, embed_dim=48)
# a small geometry for the cond stages: text (width, layers, heads, embed),
# vision (width, layers, heads, patch, embed)
SMALL_VERSION = {"text": (64, 2, 4, 48), "vision": (64, 2, 4, 32, 48)}


def shapes_of(jm, *args):
    return jax.eval_shape(jm.init, jax.random.key(0, impl="unsafe_rbg"), *args)


def pair(jm, tm, *args, seed=0):
    """A seeded tree over the JAX module's parameters, loaded into the port."""
    variables = random_tree(shapes_of(jm, *args), seed)
    load_flax_params(tm, variables, device="cpu")
    return variables


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("eot_id", [None, 7])
def test_text_tower_matches(eot_id):
    """Rows: the id 7 at two places (the first pools), the id missing (the
    argmax fallback), the largest id before the id."""
    vocab, n = 100, 12
    rng = np.random.RandomState(1)
    tokens = rng.randint(8, vocab - 1, size=(3, n)).astype(np.int32)
    tokens[0, 5] = tokens[0, 9] = 7
    tokens[2, 3], tokens[2, 8] = vocab - 1, 7
    jm = j_clip.CLIPTextTower(vocab_size=vocab, context_length=16, eot_id=eot_id, **SMALL)
    tm = t_clip.CLIPTextTower(vocab_size=vocab, context_length=16, eot_id=eot_id, **SMALL).eval()
    variables = pair(jm, tm, jnp.asarray(tokens))
    want = jax.jit(jm.apply)(variables, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (3, SMALL["embed_dim"])
    close(got, want)
    argmax = [int(np.argmax(r)) for r in tokens]
    pos = t_clip.eot_positions(torch.from_numpy(tokens), eot_id).tolist()
    assert pos == (argmax if eot_id is None else [5, argmax[1], 8])


@pytest.mark.parametrize("side", [20, 48])
@gc_paused()
def test_image_tower_and_preprocess_match(side):
    """[-1, 1] images of 20^2 (upsampled) and 48^2 (downsampled with the
    antialias filter) to the tower's 32^2, then the ViT."""
    size = 32
    x = np.random.RandomState(side).uniform(-1, 1, (2, side, side, 3)).astype(np.float32)
    pre = t_clip.clip_preprocess(torch.from_numpy(x), size)
    close(pre, j_clip.clip_preprocess(jnp.asarray(x), size))
    jm = j_clip.CLIPVisionTower(image_size=size, patch_size=8, **SMALL)
    tm = t_clip.CLIPVisionTower(image_size=size, patch_size=8, **SMALL).eval()
    variables = pair(jm, tm, jnp.zeros((1, size, size, 3)))
    want = jax.jit(jm.apply)(variables, j_clip.clip_preprocess(jnp.asarray(x), size))
    with torch.no_grad():
        got = tm(pre)
    assert got.shape == (2, SMALL["embed_dim"])
    close(got, want)


@pytest.fixture
def small_version(monkeypatch):
    for mod in (j_enc, t_enc):
        monkeypatch.setitem(mod.CLIP_VERSIONS, "test-small", SMALL_VERSION)
    return "test-small"


PROMPTS = ["a happy bear reading a newspaper, oil on canvas", "",
           "a watercolor of a lighthouse on a cliff at dusk " * 12]


@gc_paused()
def test_text_cond_stage_matches(small_version):
    """FrozenCLIPTextEmbedder through `build_encoder` (n_repeat 3, the
    committed WordPiece vocab at vocab_size 49408): the same ids, the
    normalized and repeated context within 1e-5. The third prompt is
    truncated: its end token is the last id."""
    target = "ldm.modules.encoders.modules.FrozenCLIPTextEmbedder"
    params = {"version": small_version, "n_repeat": 3}
    jm = j_enc.build_encoder(target, params)
    tm = t_enc.build_encoder(target, params, device="cpu").eval()
    ids = tm.tokenize(PROMPTS)
    jids = np.asarray(j_enc.SimpleTokenizer(49408, 77)(PROMPTS))
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert tm.model.eot_id == tm.tokenizer._wordpiece.sep_id != int(ids.max())
    variables = pair(jm, tm, jnp.asarray(jids))
    want = jax.jit(jm.apply)(variables, jnp.asarray(jids))
    with torch.no_grad():
        got = tm(ids)
    assert got.shape == (3, 3, 48)
    close(got, want)
    np.testing.assert_allclose(np.linalg.norm(got[:, 0].numpy(), axis=-1), 1.0, atol=1e-6)


@gc_paused()
def test_image_cond_stage_matches(small_version):
    """FrozenClipImageEmbedder through `build_encoder` (the version under
    "model"): preprocess at 224^2, ViT, normalize; within 1e-5."""
    target = "ldm.modules.encoders.modules.FrozenClipImageEmbedder"
    params = {"model": small_version}
    jm = j_enc.build_encoder(target, params)
    tm = t_enc.build_encoder(target, params, device="cpu").eval()
    x = np.random.RandomState(5).uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    variables = pair(jm, tm, jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 48)
    close(got, want)


@pytest.mark.parametrize("target", ["FrozenCLIPTextEmbedder", "FrozenClipImageEmbedder"])
def test_cond_stage_defaults_to_the_card(small_version, target):
    """A CLIP embedder, which also serves alone as a query encoder, is built
    on the card unless the caller names the device: without one, it
    raises."""
    params = {"version": small_version, "model": small_version}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_enc.build_encoder(f"ldm.modules.encoders.modules.{target}", params)
    with torch.device("meta"):  # nor does an ambient device stand in for it
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_enc.build_encoder(f"ldm.modules.encoders.modules.{target}", params)


def test_image_embedder_refuses_an_image_elsewhere(small_version):
    """The image embedder computes where it lives: an image on another
    device raises, and is not copied there."""
    emb = t_enc.FrozenClipImageEmbedder.from_version(small_version, device="meta")
    with pytest.raises(RuntimeError, match="image is on cpu"):
        emb(torch.zeros(1, 32, 32, 3))


def test_hybrid_conditioner_still_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        t_enc.build_encoder("ldm.modules.diffusionmodules.util.HybridConditioner", {})


@pytest.mark.parametrize("which", ["text", "vision"])
@gc_paused()
def test_vit_l14_towers_match_the_jax_tree(which):
    """ViT-L/14 at full width on "meta": the JAX init's parameter paths
    (`jax.eval_shape`; the text embedder's tower sits under "model", the
    image embedder's under "visual") and shapes, one to one."""
    if which == "text":
        jm = j_enc.FrozenCLIPTextEmbedder.from_version("ViT-L/14")
        args = (jnp.zeros((1, 77), jnp.int32),)
        tm = t_enc.FrozenCLIPTextEmbedder.from_version  # built below on meta
    else:
        jm = j_enc.FrozenClipImageEmbedder.from_version("ViT-L/14")
        args = (jnp.zeros((1, 224, 224, 3)),)
        tm = t_enc.FrozenClipImageEmbedder.from_version
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  shapes_of(jm, *args))
    want = {k: tuple(np.shape(v)) for k, v in flax_to_state_dict(tree).items()}
    tm = tm("ViT-L/14", device="meta")
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    n = sum(p.numel() for p in tm.parameters())
    assert n == {"text": 123_650_304, "vision": 303_966_208}[which]
