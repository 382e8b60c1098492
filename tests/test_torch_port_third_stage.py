"""The port's third stage (`ealdm_torch/third_stage.py`) against the JAX
package's `ealdm_tpu/third_stage.py`, float32 on the CPU, on the micro
STDiff model (`configs/smoke/stdiff_micro.yaml`: 16^2 images, 8^2 x 4
latents) with one seeded parameter tree in both packages:

- `ThirdStageDataset` on dumps that JAX's `dump_third_stage_data` wrote,
  and the port's dumps against JAX's given the same `log_images` outputs
  (both packages' `log_images` patched to return them): equal arrays;
- `CLIPZeroShot` at a reduced geometry with JAX's towers' parameters
  carried, and after both load one OpenAI-named checkpoint: class embeddings and
  logits within 1e-5 of their scale;
- the heads: two Adam steps from carried parameters, losses 1e-5
  relative, fc_w and fc_f within 1e-5 of JAX's, the trunk bit-unchanged;
- `test` with the FID features and CLIP logits injected into both (JAX's
  InceptionV3 and CLIP are not compiled again): FID, F1 and agreements
  equal, the flow MSE 1e-5 relative, both CSVs (flow inverse-scaled)
  equal to 1e-5 of each column's scale;
- `Refinement`: the identity at init, and the forward with JAX's
  parameters carried within 1e-5 of the output's scale;
- `refine_decoder`, 2 steps at batch 2 with the loss module's parameters
  carried: gl and dl 1e-5 relative; every decoder tensor that the decode
  depends on within 2e-6 of JAX's after the steps (lr 1e-4), and the
  refined decode within 1e-5 of JAX's. A conv bias ahead of a one-channel
  GroupNorm group has a gradient of float32 noise in both packages, which
  Adam turns into a step of up to lr of either sign: those tensors, whose
  value the decode does not depend on, are not compared.

JAX's flax inits of ResNet-50, the CLIP towers and the loss module are
replaced by seeded values in the trees `jax.eval_shape` gives (the eager
init of ResNet-50 takes 25 s on the CPU, of the reduced CLIP towers 14 s).
"""
import contextlib
import csv
import os
import pathlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ealdm_torch.inference as t_inference
import ealdm_tpu.inference as j_inference
from ealdm_torch import config as t_config
from ealdm_torch import third_stage as t_ts
from ealdm_torch.data.scalers import StandardScaler
from ealdm_torch.losses import VQLPIPSWithDiscriminator
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_tpu import config as j_config
from ealdm_tpu import third_stage as j_ts
from tests.test_torch_port_cond import gc_paused
from tests.test_torch_port_eval_trunks import openai_clip_state
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
MICRO = str(REPO / "configs/smoke/stdiff_micro.yaml")
B = 2


@contextlib.contextmanager
def seeded_flax_init(seed, record=None):
    """flax's `Module.init` gives seeded values in the tree of its
    `jax.eval_shape` (appended to `record`) instead of running the init."""
    original = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        tree = random_tree(jax.eval_shape(lambda r: original(self, r, *args, **kwargs), rngs),
                           seed)
        if record is not None:
            record.append(tree)
        return jax.tree_util.tree_map(jnp.asarray, tree)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = original


@pytest.fixture(scope="module")
def micro():
    """(JAX model, its variables, the port's model with them)."""
    cfg = j_config.load_config([MICRO])
    jm, _ = j_config.model_from_config(cfg["model"])
    tm, _ = t_config.model_from_config(t_config.load_config([MICRO])["model"], device="cpu")
    z = lambda *s: jnp.zeros((B, *s))  # noqa: E731
    example = {"img": z(16, 16, 3), "mixed": {"img": z(16, 16, 3), "img_random": z(16, 16, 3),
                                              "flow": z(1, 1), "weather": z(1, 16), "time": z(1)}}
    with gc_paused():
        shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, example, r,
                                                  method=jm.full_init), jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes, 60)["params"]}
    load_flax_params(tm, variables, device="cpu")
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm.eval()


def dump_batch(rng, n=B, side=16):
    return {"img": rng.uniform(-1, 1, (n, side, side, 3)).astype(np.float32),
            "latent": rng.randn(n, side // 2, side // 2, 4).astype(np.float32),
            "w": rng.randn(n, 1, 16).astype(np.float32),
            "wlabel_nxt": (rng.rand(n, 10) > 0.6).astype(np.float32),
            "flabel": rng.randn(n, 1, 1).astype(np.float32),
            "flabel_nxt": rng.randn(n, 1).astype(np.float32),
            "t": rng.rand(n, 1).astype(np.float32)}


# --------------------------------------------------------------- the dumps
class _Data:
    """A DataModule's loaders over fixed STDiff batches (no test loader)."""

    def __init__(self, batches):
        self.batches = batches

    def train_dataloader(self):
        return list(self.batches)

    def test_dataloader(self):
        return None


def _stdiff_batches(seed, n_batches=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        d = dump_batch(rng)
        out.append({"img": d["img"], "mixed": {
            "img": d["img"][::-1].copy(), "img_random": d["img"], "weather": d["w"],
            "wlabel_nxt": d["wlabel_nxt"], "flow": d["flabel"], "label_nxt": d["flabel_nxt"],
            "time": d["t"], "ids_nxt": np.zeros((B, 1, 1), np.float32)}})
    return out


def test_dumps_equal_jax(tmp_path, monkeypatch):
    """Given the same log_images outputs, the port writes JAX's npz files
    (the train loader standing in for the missing test one, max_batches
    honoured), and `ThirdStageDataset` reads JAX's dumps as JAX's does."""
    batches = _stdiff_batches(61)
    latents = [np.random.RandomState(62 + i).randn(B, 8, 8, 4).astype(np.float32)
               for i in range(len(batches))]
    calls = {"jax": [], "torch": []}

    def fake(side, to_out):
        def log_images(model, *args, **kwargs):
            calls[side].append({k: kwargs[k] for k in ("n", "steps", "quantize_denoised")})
            return {"diff_samples_latent": to_out(latents[len(calls[side]) - 1])}
        return log_images

    monkeypatch.setattr(j_inference, "log_images", fake("jax", jnp.asarray))
    monkeypatch.setattr(t_inference, "log_images", fake("torch", torch.from_numpy))
    model = torch.nn.Linear(1, 1)
    j_dir = j_ts.dump_third_stage_data(None, None, _Data(batches), str(tmp_path / "j"),
                                       jax.random.PRNGKey(0), split="test", steps=7,
                                       max_batches=2)
    t_dir = t_ts.dump_third_stage_data(model, _Data(batches), str(tmp_path / "t"),
                                       torch.Generator(), split="test", steps=7,
                                       max_batches=2, device="cpu")
    assert calls["jax"] == calls["torch"] == [dict(n=B, steps=7, quantize_denoised=True)] * 2
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == ["batch_00000.npz", "batch_00001.npz"]
    assert t_dir.endswith(os.path.join("third_stage_data", "test"))
    for name in names:
        with np.load(os.path.join(j_dir, name)) as j, np.load(os.path.join(t_dir, name)) as t:
            assert j.files == t.files == ["img", "latent", "w", "wlabel_nxt", "flabel",
                                          "flabel_nxt", "t"]
            for k in j.files:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    want, got = j_ts.ThirdStageDataset(j_dir), t_ts.ThirdStageDataset(j_dir)
    assert len(got) == len(want) == 2 * B
    for i in range(len(want)):
        for k, v in want[i].items():
            np.testing.assert_array_equal(got[i][k], v)
    with pytest.raises(AssertionError, match="no third-stage dumps"):
        t_ts.ThirdStageDataset(str(tmp_path))


def test_dataset_keeps_eight_files(tmp_path):
    rng = np.random.RandomState(63)
    for i in range(10):
        np.savez(tmp_path / f"batch_{i:05d}.npz", **dump_batch(rng, n=1))
    ds = t_ts.ThirdStageDataset(str(tmp_path))
    assert len(ds) == 10
    for i in (9, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9):
        item = ds[i]
        assert item["latent"].shape == (8, 8, 4) and item["wlabel_nxt"].shape == (10,)
    assert len(ds._cache) == 8 and 9 in ds._cache


# ------------------------------------------------------------------- CLIP
CLIP_TEXT = dict(width=32, n_layer=2, n_heads=4, vocab_size=97, max_seq_len=12)
CLIP_IMAGE = dict(width=40, n_layer=2, n_heads=4, patch_size=8)


def test_clip_zero_shot_matches_jax():
    """The scorer at a reduced geometry (the towers of
    `test_torch_port_eval_trunks.openai_clip_state`): JAX's towers' seeded
    parameters carried, then one OpenAI checkpoint loaded into both; and
    the port's seed-0 scorer is the same scorer each time it is built."""
    with seeded_flax_init(74), gc_paused():
        want = j_ts.CLIPZeroShot(embed_dim=24, image_size=32, text_kwargs=CLIP_TEXT,
                                 image_kwargs=CLIP_IMAGE)
    got = t_ts.CLIPZeroShot(embed_dim=24, image_size=32, text_kwargs=CLIP_TEXT,
                            image_kwargs=CLIP_IMAGE, text_params=want._text_params,
                            image_params=want._image_params, device="cpu")
    np.testing.assert_array_equal(got._tokens.numpy(), np.asarray(want._tokens))
    images = np.tanh(np.random.RandomState(64).randn(3, 32, 32, 3)).astype(np.float32)

    def close(g, w):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))

    close(got.class_embeddings, want.class_embeddings)
    close(got.logits(torch.from_numpy(images)), want.logits(images))
    sd = openai_clip_state(65)
    want.load_clip_weights(sd)
    got.load_clip_weights(sd)
    close(got.class_embeddings, want.class_embeddings)
    logits = got.logits(torch.from_numpy(images))
    close(logits, want.logits(images))
    labels = (np.random.RandomState(66).rand(3, 10) > 0.5).astype(np.float32)
    assert got.agreement(torch.from_numpy(images), labels) == want.agreement(images, labels)
    seeded = t_ts.CLIPZeroShot(embed_dim=24, image_size=32, text_kwargs=CLIP_TEXT,
                               image_kwargs=CLIP_IMAGE, device="cpu")
    again = t_ts.CLIPZeroShot(embed_dim=24, image_size=32, text_kwargs=CLIP_TEXT,
                              image_kwargs=CLIP_IMAGE, device="cpu")
    np.testing.assert_array_equal(seeded.logits(torch.from_numpy(images)),
                                  again.logits(torch.from_numpy(images)))


# ------------------------------------------------------------------ heads
@pytest.fixture(scope="module")
def heads(micro):
    """JAX's ThirdStageModel and the port's with the same head parameters,
    and the dumps both read."""
    jm, variables, tm = micro
    with seeded_flax_init(67), gc_paused():
        j_model = j_ts.ThirdStageModel(jm, variables)
    t_model = t_ts.ThirdStageModel(tm, head_params=jax.device_get(j_model.head_params),
                                   device="cpu")
    rng = np.random.RandomState(68)
    return j_model, t_model, [dump_batch(rng) for _ in range(2)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_heads_two_steps_equal_jax(heads):
    j_model, t_model, batches = heads
    trunk = {k: p.detach().clone() for k, p in t_model.heads.trunk.named_parameters()}
    for batch in batches:
        with gc_paused():
            images, wlabel, flabel = j_model._batch_tensors(batch)
            j_model.head_params, j_model.opt_state, want = j_model._train_step(
                j_model.head_params, j_model.opt_state, images, wlabel, flabel)
        got = t_model.train_step(*t_model._batch_tensors(batch))
        for k in ("loss", "loss_w", "loss_f"):
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    params = _host(j_model.head_params)
    for head in ("fc_w", "fc_f"):
        layer = getattr(t_model.heads, head)
        np.testing.assert_allclose(layer.weight.detach().numpy(), params[head]["kernel"].T,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(layer.bias.detach().numpy(), params[head]["bias"], rtol=0,
                                   atol=1e-5)
    assert t_model.opt_state.count == 2
    for k, p in t_model.heads.trunk.named_parameters():
        assert torch.equal(p, trunk[k]) and not p.requires_grad, k


class _Injected:
    """Stands in for the FID trunk's features and the CLIP scorer's logits:
    the i-th call gets the i-th seeded array, in both packages."""

    def __init__(self, seed, width, to_out):
        self.rng, self.width, self.to_out = np.random.RandomState(seed), width, to_out
        self.calls = 0

    def __call__(self, images):
        self.calls += 1
        return self.to_out(self.rng.randn(len(images), self.width).astype(np.float32))

    def logits(self, images):
        return np.asarray(self(images))


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_test_equals_jax_on_the_same_features(heads, tmp_path):
    j_model, t_model, batches = heads
    scalers = tmp_path / "scalers"
    scalers.mkdir()
    sc = StandardScaler().fit(np.random.RandomState(69).randn(20, 1) * 3 + 5)
    with open(scalers / "flow_scaler_trainval.json", "w") as f:
        import json

        json.dump(sc.to_dict(), f)
    results = {}
    for side, model, to_out in (("jax", j_model, jnp.asarray),
                                ("torch", t_model, torch.from_numpy)):
        model._fid_feats = _Injected(70, 48, to_out)
        model._clip_scorer = _Injected(71, 10, to_out)
        with gc_paused():
            results[side] = model.test(list(batches) * 2, str(tmp_path / side), str(scalers))
        assert model._fid_feats.calls == 2 * len(batches) * 2
    want, got = results["jax"], results["torch"]
    assert list(got) == list(want)
    for k in ("fid", "weather_f1", "clip_agreement", "head_agreement"):
        assert got[k] == want[k], k
    assert got["flow_mse"] == pytest.approx(want["flow_mse"], rel=1e-5)
    for name in ("third_stage_flow.csv", "third_stage_results.csv"):
        g, w = (_read_csv(tmp_path / side / name) for side in ("torch", "jax"))
        assert g[0] == w[0] and len(g) == len(w)
        g, w = np.array(g[1:], np.float64), np.array(w[1:], np.float64)
        assert (np.abs(g - w) <= 1e-5 * np.abs(w).max(axis=0)).all(), (name, g, w)
    flow = np.array(_read_csv(tmp_path / "torch" / "third_stage_flow.csv")[1:], np.float64)
    np.testing.assert_allclose(flow[:, 1], sc.inverse_transform(np.concatenate(
        [b["flabel_nxt"] for b in batches] * 2))[:, 0], rtol=1e-6)
    assert (tmp_path / "torch" / "third_stage_flow.png").exists() == (
        tmp_path / "jax" / "third_stage_flow.png").exists()


# ------------------------------------------------------------- refinement
def test_refinement_equals_jax():
    """`Refinement`: the identity at init in both packages (its last
    convolution starts at zero), and with JAX's parameters carried, the last
    convolution seeded too, the forward within 1e-5 of the output's scale."""
    z = np.random.RandomState(74).randn(2, 8, 8, 4).astype(np.float32)
    j_ref = j_ts.Refinement(channels=4)
    t_ref = t_ts.Refinement(channels=4, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(t_ref(torch.from_numpy(z)).numpy(), z)
    np.testing.assert_array_equal(np.asarray(j_ref(jnp.asarray(z))), z)
    tree = random_tree(jax.eval_shape(lambda: j_ref.params), 75)
    j_ref.params = jax.tree_util.tree_map(jnp.asarray, tree)
    load_flax_params(t_ref, tree, device="cpu")
    want = np.asarray(j_ref(jnp.asarray(z)))
    with torch.no_grad():
        got = t_ref(torch.from_numpy(z)).numpy()
    assert not np.allclose(want, z, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_refine_decoder_equals_jax(micro):
    jm, variables, tm = micro
    loaders = [dump_batch(np.random.RandomState(72 + i)) for i in range(2)]
    record = []
    with seeded_flax_init(73, record), gc_paused():
        j_model = j_ts.ThirdStageModel(jm, variables)
        want = j_model.refine_decoder(loaders, steps=2, lr=1e-4)
    loss_tree = record[-1]
    loss = VQLPIPSWithDiscriminator(disc_start=0, disc_num_layers=1, device="cpu")
    load_flax_params(loss, loss_tree, device="cpu")
    before = {k: p.detach().clone() for k, p in tm.first_stage_model.decoder.named_parameters()}
    try:
        t_model = t_ts.ThirdStageModel(tm, device="cpu")
        got = t_model.refine_decoder(loaders, steps=2, lr=1e-4, loss_module=loss)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        assert got[1] == pytest.approx(want[1], rel=1e-5)
        dec_want = _host(j_model.variables["params"]["first_stage_model"]["decoder"])
        from ealdm_torch.utils.flax_import import flax_to_state_dict

        dec_want = flax_to_state_dict(dec_want)
        decoder = tm.first_stage_model.decoder
        latent = torch.from_numpy(loaders[0]["latent"])
        with torch.no_grad():
            ref = tm.decode_first_stage(latent)
        compared = []
        for k, p in decoder.named_parameters():
            assert not p.requires_grad, k
            if _decode_depends_on(tm, p, latent, ref):
                np.testing.assert_allclose(p.detach().numpy(), dec_want[k], rtol=0, atol=2e-6,
                                           err_msg=k)
                assert not torch.equal(p, before[k]), k
                compared.append(k)
        assert len(compared) > len(before) // 2, compared
        jax_decode = jax.jit(lambda v, z: jm.apply(v, z, method=jm.decode_first_stage))
        np.testing.assert_allclose(ref.numpy(), np.asarray(jax_decode(j_model.variables,
                                                                      loaders[0]["latent"])),
                                   rtol=0, atol=1e-5 * float(ref.abs().max()))
    finally:
        with torch.no_grad():
            for k, p in tm.first_stage_model.decoder.named_parameters():
                p.copy_(before[k])


@torch.no_grad()
def _decode_depends_on(tm, p, latent, ref):
    """Whether the decode changes by more than 1e-4 of its scale when `p`
    moves by 0.1 (one that a GroupNorm cancels moves it by float32 noise)."""
    p.add_(0.1)
    try:
        return not torch.allclose(tm.decode_first_stage(latent), ref, rtol=0,
                                  atol=1e-4 * float(ref.abs().max()))
    finally:
        p.sub_(0.1)
