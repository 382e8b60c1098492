"""The third stage's evaluation pieces in the port against the JAX
package's, float32 on the CPU: `metrics.py` (to 1e-12, float64 on the host
in both), InceptionV3 (the trunk at [1, 75, 75, 3] without the resize, 1e-4
of the output's largest element; the 299^2 bilinear resize alone against
`jax.image.resize(..., antialias=False)`; the torchvision-named loader),
CLIP's loaders (OpenAI and Hugging Face names at a reduced width, both
towers, 1e-5 of the embedding's scale) and `weights.py` (each file kind,
the search order, the warning, the refusal of a full-object pickle).

Every checkpoint is written here from seeded numpy; nothing is downloaded.
JAX's InceptionV3 compiles once (XLA's backend optimisations off), in a
module fixture.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import metrics as t_metrics
from ealdm_torch import weights as t_weights
from ealdm_torch.models import clip as t_clip
from ealdm_torch.models import inception as t_inception
from ealdm_torch.models.encoders import linear_resize_weights, resize_nhwc
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu import metrics as j_metrics
from ealdm_tpu import weights as j_weights
from ealdm_tpu.models import clip as j_clip
from ealdm_tpu.models import inception as j_inception
from tests.test_torch_port_cond import gc_paused

torch.set_num_threads(1)
XLA = {"xla_backend_optimization_level": 0}


# ------------------------------------------------------------------ metrics
def _feats(seed, n=40, d=12):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d) @ rng.randn(d, d) + rng.randn(d)


def test_metrics_equal_jax():
    rng = np.random.RandomState(0)
    a, b = rng.uniform(-1, 1, (2, 8, 8, 3)), rng.uniform(-1, 1, (2, 8, 8, 3))
    assert t_metrics.psnr(a, b) == pytest.approx(j_metrics.psnr(a, b), rel=1e-12, abs=0)
    assert t_metrics.psnr(a, a) == j_metrics.psnr(a, a) == float("inf")
    real, fake = _feats(1), _feats(2)
    mu_r, mu_f = real.mean(0), fake.mean(0)
    cov_r, cov_f = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    want = j_metrics.frechet_distance(mu_r, cov_r, mu_f, cov_f)
    assert t_metrics.frechet_distance(mu_r, cov_r, mu_f, cov_f) == pytest.approx(
        want, rel=1e-12, abs=1e-12)
    # rank-deficient covariances (fewer samples than dimensions)
    few_r, few_f = _feats(3, n=5, d=12), _feats(4, n=5, d=12)
    fids = []
    for mod in (t_metrics, j_metrics):
        fid = mod.FID()
        for half in (slice(0, 3), slice(3, 5)):
            fid.update(few_r[half], real=True)
            fid.update(few_f[half], real=False)
        fids.append(fid.compute())
        fid.reset()
        assert fid._real == fid._fake == []
    assert np.isfinite(fids[0]) and fids[0] == pytest.approx(fids[1], rel=1e-12, abs=1e-12)
    feature_fn = lambda x: np.asarray(x)[:, :6] * 2.0  # noqa: E731
    fids = []
    for mod in (t_metrics, j_metrics):
        fid = mod.FID(feature_fn)
        fid.update(real, real=True)
        fid.update(fake, real=False)
        fids.append(fid.compute())
    assert fids[0] == pytest.approx(fids[1], rel=1e-12, abs=1e-12)
    y_true = (rng.rand(30, 10) > 0.6).astype(np.float32)
    y_pred = rng.rand(30, 10)
    for average in ("macro", "micro"):
        got = t_metrics.multilabel_f1(y_true, y_pred, average)
        assert got == pytest.approx(j_metrics.multilabel_f1(y_true, y_pred, average),
                                    rel=1e-12, abs=1e-12)
    logits = rng.randn(30, 10)
    assert t_metrics.label_agreement(logits, y_true) == j_metrics.label_agreement(logits,
                                                                                  y_true)
    assert t_metrics.label_agreement(logits[:0], y_true[:0]) == 0.0


# --------------------------------------------------------------- InceptionV3
def torchvision_inception_state(seed):
    """A torchvision-named InceptionV3 state dict with seeded values (He
    convolutions, BatchNorms near the identity), the keys JAX's loader
    skips among them."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, p in t_inception.InceptionV3Features().named_parameters():
        scope, leaf = name.rsplit(".", 1)
        if name.endswith("conv.weight"):
            v = rng.randn(*p.shape) * np.sqrt(2.0 / p[0].numel())
            sd[name] = torch.from_numpy(v.astype(np.float32))
            continue
        key = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
               "bn_var": "bn.running_var"}[leaf]
        v = {"bn_scale": 1 + 0.1 * rng.randn(*p.shape), "bn_bias": 0.1 * rng.randn(*p.shape),
             "bn_mean": 0.1 * rng.randn(*p.shape),
             "bn_var": 0.5 + rng.rand(*p.shape)}[leaf]
        sd[f"{scope}.{key}"] = torch.from_numpy(v.astype(np.float32))
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(5)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    return sd


@pytest.fixture(scope="module")
def inception():
    """(state dict, JAX's loaded variables, input [1, 75, 75, 3], JAX's
    features without the resize)."""
    sd = torchvision_inception_state(0)
    variables = j_inception.load_torch_inception_state(sd)
    x = np.random.RandomState(1).rand(1, 75, 75, 3).astype(np.float32)
    net = j_inception.InceptionV3Features(resize_input=False)
    with gc_paused():
        fn = jax.jit(net.apply).lower(variables, x).compile(XLA)
        want = np.asarray(fn(variables, x))
    return sd, jax.device_get(variables), x, want


def _inception_close(got, want):
    assert got.shape == want.shape == (1, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_inception_trunk_matches_jax(inception):
    """The trunk at [1, 75, 75, 3] (no resize) with JAX's parameters carried
    by the bridge."""
    _, variables, x, want = inception
    net = t_inception.InceptionV3Features(resize_input=False).eval()
    load_flax_params(net, variables, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _inception_close(got, want)


def test_inception_loader_matches_jax(inception):
    """The same torchvision state dict through each package's loader gives
    the same features; an unmapped key and a missing one raise."""
    sd, _, x, want = inception
    net = t_inception.load_torch_inception_state(
        t_inception.InceptionV3Features(resize_input=False), sd).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _inception_close(got, want)
    with pytest.raises(ValueError, match="unmapped torch key"):
        t_inception.load_torch_inception_state(net, {**sd, "Mixed_5b.extra.weight": sd[
            "fc.weight"]})
    short = {k: v for k, v in sd.items() if k != "Mixed_7c.branch_pool.bn.weight"}
    with pytest.raises(ValueError, match="missing"):
        t_inception.load_torch_inception_state(net, short)
    seeded = t_inception.InceptionV3Features().seeded_(0)
    again = t_inception.InceptionV3Features().seeded_(0)
    assert all(torch.equal(a, b) for a, b in zip(seeded.parameters(), again.parameters()))
    assert torch.equal(seeded.Mixed_6b.branch1x1.bn_var, torch.ones(192))


def _resize_close(x, want=None):
    """The port's resize of x within 2e-7 of the float64 contraction of its
    weights and 4e-6 of JAX's (XLA's float32 einsum on this CPU is up to
    1.7e-6 from that contraction on these [0, 1] inputs)."""
    got = resize_nhwc(torch.from_numpy(x), (299, 299), "bilinear", antialias=False).numpy()
    wh, ww = (linear_resize_weights(n, 299, antialias=False).astype(np.float64)
              for n in x.shape[1:3])
    exact = np.einsum("nhwc,hH->nHwc", x.astype(np.float64), wh)
    exact = np.einsum("nHwc,wW->nHWc", exact, ww)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-7)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    return got


@pytest.mark.parametrize("side", [32, 64, 256])
def test_inception_resize_matches_jax(side):
    """The 299^2 bilinear resize without antialiasing, alone, against
    jax.image.resize."""
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    _resize_close(x, np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear",
                                                 antialias=False)))
    if side == 256:  # antialiasing differs from it only when shrinking
        wide = np.random.RandomState(2).rand(1, 320, 320, 3).astype(np.float32)
        down = _resize_close(wide)
        assert not np.allclose(down, resize_nhwc(torch.from_numpy(wide), (299, 299)).numpy())


# ----------------------------------------------------------------------- CLIP
TXT = dict(vocab_size=97, context_length=12, width=32, layers=2, heads=4, embed_dim=24)
VIS = dict(image_size=32, patch_size=8, width=40, layers=2, heads=4, embed_dim=24)


def _openai_block(rng, prefix, w):
    r = lambda *s: torch.from_numpy((rng.randn(*s) / np.sqrt(s[-1])).astype(np.float32))  # noqa
    b = lambda *s: torch.from_numpy((0.1 * rng.randn(*s)).astype(np.float32))  # noqa
    n = lambda: torch.from_numpy((1 + 0.1 * rng.randn(w)).astype(np.float32))  # noqa
    return {f"{prefix}.attn.in_proj_weight": r(3 * w, w), f"{prefix}.attn.in_proj_bias": b(3 * w),
            f"{prefix}.attn.out_proj.weight": r(w, w), f"{prefix}.attn.out_proj.bias": b(w),
            f"{prefix}.ln_1.weight": n(), f"{prefix}.ln_1.bias": b(w),
            f"{prefix}.ln_2.weight": n(), f"{prefix}.ln_2.bias": b(w),
            f"{prefix}.mlp.c_fc.weight": r(4 * w, w), f"{prefix}.mlp.c_fc.bias": b(4 * w),
            f"{prefix}.mlp.c_proj.weight": r(w, 4 * w), f"{prefix}.mlp.c_proj.bias": b(w)}


def openai_clip_state(seed):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)  # noqa: E731
    w, vw = TXT["width"], VIS["width"]
    grid = VIS["image_size"] // VIS["patch_size"]
    sd = {"token_embedding.weight": t(TXT["vocab_size"], w),
          "positional_embedding": t(TXT["context_length"], w),
          "ln_final.weight": 1 + t(w), "ln_final.bias": t(w),
          "text_projection": t(w, TXT["embed_dim"]) * 3,
          "visual.conv1.weight": t(vw, 3, VIS["patch_size"], VIS["patch_size"]),
          "visual.class_embedding": t(vw), "visual.positional_embedding": t(grid**2 + 1, vw),
          "visual.ln_pre.weight": 1 + t(vw), "visual.ln_pre.bias": t(vw),
          "visual.ln_post.weight": 1 + t(vw), "visual.ln_post.bias": t(vw),
          "visual.proj": t(vw, VIS["embed_dim"]) * 3, "logit_scale": torch.tensor(4.6)}
    for i in range(TXT["layers"]):
        sd.update(_openai_block(rng, f"transformer.resblocks.{i}", w))
    for i in range(VIS["layers"]):
        sd.update(_openai_block(rng, f"visual.transformer.resblocks.{i}", vw))
    return sd


def hf_clip_state(openai, pre="pre_layrnorm"):
    """The same weights under Hugging Face CLIPModel's names."""
    sd = {"text_model.embeddings.token_embedding.weight": openai["token_embedding.weight"],
          "text_model.embeddings.position_embedding.weight": openai["positional_embedding"],
          "text_model.final_layer_norm.weight": openai["ln_final.weight"],
          "text_model.final_layer_norm.bias": openai["ln_final.bias"],
          "text_projection.weight": openai["text_projection"].T.contiguous(),
          "vision_model.embeddings.patch_embedding.weight": openai["visual.conv1.weight"],
          "vision_model.embeddings.class_embedding": openai["visual.class_embedding"],
          "vision_model.embeddings.position_embedding.weight":
              openai["visual.positional_embedding"],
          f"vision_model.{pre}.weight": openai["visual.ln_pre.weight"],
          f"vision_model.{pre}.bias": openai["visual.ln_pre.bias"],
          "vision_model.post_layernorm.weight": openai["visual.ln_post.weight"],
          "vision_model.post_layernorm.bias": openai["visual.ln_post.bias"],
          "visual_projection.weight": openai["visual.proj"].T.contiguous()}
    for src, dst, layers in (("transformer", "text_model", TXT["layers"]),
                             ("visual.transformer", "vision_model", VIS["layers"])):
        for i in range(layers):
            a, b = f"{src}.resblocks.{i}", f"{dst}.encoder.layers.{i}"
            for leaf in ("weight", "bias"):
                q, k, v = openai[f"{a}.attn.in_proj_{leaf}"].chunk(3)
                sd.update({f"{b}.self_attn.q_proj.{leaf}": q, f"{b}.self_attn.k_proj.{leaf}": k,
                           f"{b}.self_attn.v_proj.{leaf}": v,
                           f"{b}.self_attn.out_proj.{leaf}": openai[f"{a}.attn.out_proj.{leaf}"],
                           f"{b}.layer_norm1.{leaf}": openai[f"{a}.ln_1.{leaf}"],
                           f"{b}.layer_norm2.{leaf}": openai[f"{a}.ln_2.{leaf}"],
                           f"{b}.mlp.fc1.{leaf}": openai[f"{a}.mlp.c_fc.{leaf}"],
                           f"{b}.mlp.fc2.{leaf}": openai[f"{a}.mlp.c_proj.{leaf}"]})
    return sd


@pytest.fixture(scope="module")
def clip_jax():
    """JAX's towers at the reduced geometry, compiled once, and the inputs."""
    tokens = np.random.RandomState(3).randint(1, TXT["vocab_size"] - 1, (3, 9))
    tokens[:, -1] = TXT["vocab_size"] - 1  # the end token, the largest id
    image = np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)
    text_net, vis_net = j_clip.CLIPTextTower(**TXT), j_clip.CLIPVisionTower(**VIS)
    tp, vp = j_clip.load_torch_clip_state(openai_clip_state(5))
    with gc_paused():
        text_fn = jax.jit(text_net.apply).lower({"params": tp}, tokens).compile(XLA)
        vis_fn = jax.jit(vis_net.apply).lower({"params": vp}, image).compile(XLA)
    return tokens, image, text_fn, vis_fn


@pytest.mark.parametrize("naming", ["openai", "hf", "hf_pre_layernorm"])
def test_clip_loaders_match_jax(clip_jax, naming):
    """An OpenAI-named and a Hugging Face-named checkpoint (either spelling
    of the pre-LN) through both packages' loaders: the towers' text and
    image embeddings within 1e-5 of their scale."""
    tokens, image, text_fn, vis_fn = clip_jax
    sd = openai_clip_state(5)
    if naming != "openai":
        sd = hf_clip_state(sd, "pre_layrnorm" if naming == "hf" else "pre_layernorm")
    tp, vp = j_clip.load_torch_clip_state(sd)
    text, visual = t_clip.load_torch_clip_state(sd)
    towers = t_clip.CLIPTextTower(**TXT), t_clip.CLIPVisionTower(**VIS)
    towers[0].load_state_dict(text)
    towers[1].load_state_dict(visual)
    with torch.no_grad():
        got = (towers[0](torch.from_numpy(tokens)).numpy(),
               towers[1](torch.from_numpy(image)).numpy())
    for g, w in zip(got, (text_fn({"params": tp}, tokens), vis_fn({"params": vp}, image))):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


def test_clip_loader_takes_either_half():
    sd = openai_clip_state(6)
    text_only = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    text, visual = t_clip.load_torch_clip_state(text_only)
    assert visual is None and j_clip.load_torch_clip_state(text_only)[1] is None
    assert set(text) == set(dict(t_clip.CLIPTextTower(**TXT).named_parameters()))
    vis_only = {k: v for k, v in sd.items() if k.startswith("visual.")}
    text, visual = t_clip.load_torch_clip_state(vis_only)
    assert text is None and set(visual) == set(
        dict(t_clip.CLIPVisionTower(**VIS).named_parameters()))
    assert t_clip.load_torch_clip_state({}) == (None, None)


# -------------------------------------------------------------------- weights
class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)

    def forward(self, x):
        return self.lin(x)


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["npz", "pth", "lightning", "torchscript"])
def test_load_state_dict_file_equals_jax(tmp_path, kind):
    torch.manual_seed(0)
    tiny = _Tiny()
    sd = {k: v.detach().clone() for k, v in tiny.state_dict().items()}
    path = str(tmp_path / {"npz": "w.npz", "pth": "w.pth", "lightning": "w.ckpt",
                           "torchscript": "w.pt"}[kind])
    if kind == "npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif kind == "pth":
        torch.save(sd, path)
    elif kind == "lightning":
        torch.save({"state_dict": sd, "epoch": 3, "global_step": 7}, path)
    else:
        torch.jit.save(torch.jit.script(tiny), path)
    got = t_weights.load_state_dict_file(path)
    _same_state(got, sd)
    _same_state(got, j_weights.load_state_dict_file(path))


def test_full_object_pickle_is_refused(tmp_path):
    """A checkpoint that needs weights_only=False raises ValueError in both
    packages; nothing is unpickled."""
    path = str(tmp_path / "model.pth")
    torch.save(_Tiny(), path)
    for mod in (t_weights, j_weights):
        with pytest.raises(ValueError, match="weights_only=False"):
            mod.load_state_dict_file(path)
    with open(tmp_path / "list.pth", "wb"):
        pass
    torch.save([torch.zeros(2)], str(tmp_path / "list.pth"))
    with pytest.raises(ValueError, match="not a state_dict"):
        t_weights.load_state_dict_file(str(tmp_path / "list.pth"))


def test_search_order_and_warning(tmp_path, monkeypatch):
    assert t_weights.ENV_VAR == j_weights.ENV_VAR == "EALDM_WEIGHTS_DIR"
    assert t_weights.CANONICAL_FILES == j_weights.CANONICAL_FILES
    monkeypatch.delenv("EALDM_WEIGHTS_DIR", raising=False)
    assert t_weights.weights_dir() is None and t_weights.find_weights("clip") is None
    monkeypatch.setenv("EALDM_WEIGHTS_DIR", str(tmp_path / "missing"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert t_weights.weights_dir() is None
        assert t_weights.find_weights("inception") is None
    assert any("is not a directory" in str(w.message) for w in caught)
    monkeypatch.setenv("EALDM_WEIGHTS_DIR", str(tmp_path))
    for kind, names in t_weights.CANONICAL_FILES.items():
        assert t_weights.find_weights(kind) is None
        for name in reversed(names):  # the later names first: the first name still wins
            (tmp_path / name).write_bytes(b"")
            assert t_weights.find_weights(kind) == str(tmp_path / name)
            assert j_weights.find_weights(kind) == str(tmp_path / name)
    other = tmp_path / "other"
    other.mkdir()
    (other / "clip.npz").write_bytes(b"")
    assert t_weights.find_weights("clip", str(other)) == str(other / "clip.npz")
    assert os.environ["EALDM_WEIGHTS_DIR"] == str(tmp_path)
