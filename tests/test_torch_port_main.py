"""The port's training entry point (`ealdm_torch/main.py`) against the JAX
package's steps, float32 on the CPU (`--device cpu`), on synthetic data on
disk:

- `main` on `configs/smoke/stdiff_micro.yaml` (the STDiff dataset through
  the DataModule and the prefetcher) trains 2 steps; the weights are
  seeded values in the tree of JAX's init (`jax.eval_shape`: compiling the
  init would take 17 s here), carried into the port by `load_flax_params`,
  and each step replays JAX's draws
  from the step's key: t, the noise and the cond tower's dropout masks
  (read off flax's Dropout with an interceptor). Each logged train/loss
  equals JAX's `make_train_step` on the same two batches within 1e-5
  relative;
- the logdir holds what JAX's `main.py` writes: configs/*.yaml (read back by
  the port's reader), metrics.jsonl, tb/, checkpoints/last, the
  ImageLogger's grids and condition CSV;
- `-r <logdir>` restores step 2 bit for bit and continues to step 3;
- `scale_by_std` gives JAX's factor (1/std of the first batch's latents)
  on the same weights;
- `-t` with the third stage dumps both splits, trains the heads and
  writes both CSVs (`--devices` and `--tp` are tests/test_torch_port_parallel.py's);
- `main` gives SIGUSR1 back to the caller's handler on return, so the run's
  model and state are freed once the caller drops them;
- `train_autoencoder` on `configs/smoke/autoencoder_tiny.yaml` (a folder of
  PNGs written by the port's writer) takes one step whose metrics equal
  JAX's `make_vae_train_step` (the KL posterior's noise replayed) within
  the VAE training tests' limits (1e-5 relative, 1e-6 absolute), then writes the
  validation logs, a checkpoint and the reconstruction grid, which the
  port's PNG reader reads back.

JAX's steps compile once (XLA's backend optimisations off) in
module-scoped fixtures.
"""
import functools
import gc
import json
import os
import pathlib
import shutil
import signal
import weakref

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ealdm_torch.main as t_main
import ealdm_torch.training as t_training
from ealdm_torch import config as t_config
from ealdm_torch.data.synthetic import generate_synthetic_dataset
from ealdm_torch.models import stdiff as t_stdiff_model
from ealdm_torch.utils.flax_import import load_flax_params
from ealdm_torch.utils.png import encode_png, load_png
from ealdm_tpu import config as j_config
from ealdm_tpu.models.ddpm import build_first_stage as j_build_first_stage
from ealdm_tpu.training import TrainState as j_TrainState
from ealdm_tpu.training import make_optimizer as j_make_optimizer
from ealdm_tpu.training import make_train_step as j_make_train_step
from ealdm_tpu.training.ema import ema_init as j_ema_init
from ealdm_tpu.training import vae_trainer as j_vae_trainer
from tests.test_torch_port_cond import flax_shapes_of, gc_paused
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
MICRO = str(REPO / "configs/smoke/stdiff_micro.yaml")
AE_TINY = str(REPO / "configs/smoke/autoencoder_tiny.yaml")
XLA = {"xla_backend_optimization_level": 0}


def _numpy(batch):
    if isinstance(batch, dict):
        return {k: _numpy(v) for k, v in batch.items()}
    return batch.numpy() if isinstance(batch, torch.Tensor) else batch


def _jnp(batch):
    return jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in batch.items()
                                                if k != "file_path_"})


def _dropout_masks_fn(jm):
    """(params, batch, key) -> the keep masks of JAX's training-time dropouts
    for the step's key, in call order: the cond tower's pair (fused, then
    the negative) as `training_loss` calls it, its dropout rng fold_in(key,
    1). Jitted: the masks come out of the traced call."""

    def masks(params, batch, key):
        out = []

        def record(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and not context.module.deterministic:
                out.append(y != 0)  # a zero input gives 0 either way
            return y

        with nn.intercept_methods(record):
            jm.apply({"params": params}, batch["mixed"], deterministic=False,
                     rngs={"dropout": jax.random.fold_in(key, 1)},
                     method=jm.get_learned_conditioning_pair)
        return out

    return jax.jit(masks)


def _replayed_dropout(masks):
    def dropout(x, rate, generator):
        keep = torch.from_numpy(masks.pop(0))
        assert keep.shape == x.shape
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))
    return dropout


def _micro_data(corpus):
    return [f"data.params.train.params.path={corpus}/",
            f"data.params.train.params.path_weather={corpus}/",
            f"data.params.train.params.path_scaler={corpus}/scalers/"]


def _micro_argv(corpus, logroot, *extra):
    return ["-b", MICRO, "--device", "cpu", "--log_every", "1", "-l", str(logroot),
            "--third_stage", "false", *_micro_data(corpus), *extra]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("main")
    corpus = root / "corpus"
    generate_synthetic_dataset(str(corpus), sites=("Site_A_01", "Site_B_02"), n_days=12,
                               image_size=16, seed=0)
    return root, corpus


@pytest.fixture(scope="module")
def ldm_run(corpus):
    """The port's 2-step run with JAX's weights and draws, beside JAX's
    losses on the same batches."""
    root, corpus_dir = corpus
    mp = pytest.MonkeyPatch()
    cfg = j_config.load_config([MICRO])
    jm, base_lr = j_config.model_from_config(cfg["model"])
    lr = 2 * base_lr  # accumulate 1 x 1 device x batch 2
    example = _numpy(next(iter(t_main._data(t_config.load_config([MICRO], [
        f"data.params.train.params.path={corpus_dir}/",
        f"data.params.train.params.path_weather={corpus_dir}/",
        f"data.params.train.params.path_scaler={root}/example_scalers/"]), 0)[0]
        .train_dataloader())))
    ex = _jnp(example)
    with gc_paused():
        # seeded values in the JAX init's tree (compiling the init would take
        # 17 s here; its shapes take a trace)
        shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, ex, r,
                                                  method=jm.full_init), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(jnp.asarray, random_tree(shapes, seed=4)["params"])
        # JAX's init_train_state on those parameters
        j_opt = j_make_optimizer(lr, params)
        j_state = j_TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=j_opt.init(params), ema=j_ema_init(params))
        j_step = j_make_train_step(jm, j_opt, donate=False, remat="none").lower(
            j_state, ex, jax.random.PRNGKey(0)).compile(XLA)
        masks_fn = _dropout_masks_fn(jm).lower(params, ex, jax.random.PRNGKey(0)).compile(XLA)
    jax_side = {"state": j_state, "losses": [], "batches": []}
    init_params = jax.device_get(params)
    real_make_train_step = t_training.make_train_step

    def make_train_step(model, optimizer, **kw):
        step = real_make_train_step(model, optimizer, **kw)

        def replayed(state, batch, generator):
            key = jax.random.PRNGKey(100 + state.step)
            nb = _numpy(batch)
            jax_side["batches"].append(nb)
            masks = [np.asarray(m) for m in masks_fn(jax_side["state"].params, _jnp(nb), key)]
            rngs = jax.random.split(key, 4)  # training_loss: t from [1], the noise from [2]
            t = jax.random.randint(rngs[1], (2,), 0, jm.timesteps)
            noise = jax.random.normal(rngs[2], (2, 8, 8, 4))
            jax_side["state"], m = j_step(jax_side["state"], _jnp(nb), key)
            jax_side["losses"].append(float(m["loss"]))
            model.training_loss = functools.partial(
                type(model).training_loss, model, t=torch.from_numpy(np.array(t)).long(),
                noise=torch.from_numpy(np.array(noise)))
            mp.setattr(t_stdiff_model, "dropout", _replayed_dropout(masks))
            try:
                return step(state, batch, generator)
            finally:
                del model.training_loss
                assert not masks, "a JAX dropout site was not replayed"

        return replayed

    mp.setattr(t_training, "make_train_step", make_train_step)
    mp.setattr(t_main, "init_model_weights",
               lambda model, seed: load_flax_params(model, {"params": init_params},
                                                    device="cpu"))
    try:
        logdir, model, state = t_main.main(_micro_argv(
            corpus_dir, root / "logs", "-t", "-d", "--max_steps", "2",
            "lightning.callbacks.image_logger.params.batch_frequency=2",
            "lightning.callbacks.image_logger.params.max_images=2"))
    finally:
        mp.undo()
    return dict(logdir=logdir, model=model, state=state, jax=jax_side, root=root,
                corpus=corpus_dir)


def _metrics(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_logged_losses_equal_jax_train_step(ldm_run):
    rows = [r for r in _metrics(ldm_run["logdir"]) if "train/loss" in r]
    assert [r["step"] for r in rows] == [1, 2]
    want = ldm_run["jax"]["losses"]
    assert len(want) == 2
    for row, w in zip(rows, want):
        assert row["train/loss"] == pytest.approx(w, rel=1e-5)
    assert ldm_run["state"].step == 2
    b1, b2 = ldm_run["jax"]["batches"]
    assert b1["img"].shape == (2, 16, 16, 3) and not np.array_equal(b1["img"], b2["img"])


def test_logdir_holds_what_jax_main_writes(ldm_run):
    logdir = pathlib.Path(ldm_run["logdir"])
    assert logdir.name.endswith("_stdiff_micro")
    yamls = list((logdir / "configs").glob("*-project.yaml"))
    assert len(yamls) == 1
    written = t_config.load_config([str(yamls[0])])
    assert written["model"] == t_config.load_config([MICRO])["model"]
    assert written["data"]["params"]["train"]["params"]["path"] == f"{ldm_run['corpus']}/"
    assert (logdir / "checkpoints" / "last" / "state.pt").is_file()
    assert len(list((logdir / "tb").glob("events.out.tfevents.*"))) == 1
    images = sorted(p.name for p in (logdir / "images" / "train").iterdir())
    for key in ("inputs", "reconstruction", "conditioning", "diffusion_row", "samples",
                "diff_samples"):
        assert f"{key}_gs-000002.png" in images, images
        img = load_png(str(logdir / "images" / "train" / f"{key}_gs-000002.png"))
        assert img.dtype == np.uint8 and img.ndim == 3
    assert "conditions_gs-000002.csv" in images
    rows = _metrics(logdir)
    assert any("sys/epoch_time_s" in r for r in rows)


def test_resume_continues_from_step_two(ldm_run, tmp_path):
    logdir = shutil.copytree(ldm_run["logdir"], tmp_path / "run")
    saved = {k: p.detach().clone() for k, p in ldm_run["state"].params.items()}
    _, _, restored = t_main.main(["-r", str(logdir), "--device", "cpu"])
    assert restored.step == 2
    for k, p in restored.params.items():
        assert torch.equal(p.detach(), saved[k]), k
    _, _, state = t_main.main(["-r", str(logdir), "-t", "--device", "cpu", "--max_steps", "3",
                               "--log_every", "1", "--third_stage", "false"])
    assert state.step == 3
    assert [r["step"] for r in _metrics(logdir) if "train/loss" in r] == [1, 2, 3]
    assert len(list((logdir / "configs").glob("*.yaml"))) >= 2


def test_scale_by_std_gives_jax_factor(ldm_run):
    root, corpus_dir = ldm_run["root"], ldm_run["corpus"]
    cfg = j_config.load_config([MICRO])
    jm, _ = j_config.model_from_config(cfg["model"])
    params = jax.device_get(ldm_run["jax"]["state"].params)
    mp = pytest.MonkeyPatch()
    mp.setattr(t_main, "init_model_weights",
               lambda model, seed: load_flax_params(model, {"params": params}, device="cpu"))
    try:
        _, model, _ = t_main.main(_micro_argv(corpus_dir, root / "scale_logs",
                                              "model.params.scale_by_std=true"))
    finally:
        mp.undo()
    # the first batch of the run's loader, as main reads it
    data = t_main._data(t_config.load_config([MICRO], _micro_data(corpus_dir)), 23)[0]
    img = next(iter(data.train_dataloader()))["img"]
    z = jax.jit(lambda p, x: jm.apply({"params": p}, x, jax.random.PRNGKey(1),
                                      method=jm.encode_first_stage))(params, jnp.asarray(img))
    assert model.scale_factor == pytest.approx(float(1.0 / jnp.std(z)), rel=1e-5)
    assert model.scale_factor != 1.0


def test_third_stage_runs_after_training(corpus):
    """`-t --max_steps 1 --third_stage true --third_stage_max_batches 1`,
    as tests/test_full_pipeline.py runs the JAX `main.py`: one dump batch a
    split with JAX's seven keys, the heads trained on it, and both CSVs with
    finite results."""
    root, corpus_dir = corpus
    argv = _micro_argv(corpus_dir, root / "third", "-t", "--max_steps", "1",
                       "--third_stage_max_batches", "1")
    argv[argv.index("--third_stage") + 1] = "true"
    logdir, _, state = t_main.main(argv)
    assert state.step == 1
    for split in ("train", "test"):
        d = pathlib.Path(logdir) / "third_stage_data" / split
        assert sorted(p.name for p in d.iterdir()) == ["batch_00000.npz"]
        with np.load(d / "batch_00000.npz") as z:
            assert z.files == ["img", "latent", "w", "wlabel_nxt", "flabel", "flabel_nxt", "t"]
            assert z["img"].shape == (2, 16, 16, 3) and z["latent"].shape == (2, 8, 8, 4)
            assert z["wlabel_nxt"].shape == (2, 10) and z["latent"].dtype == np.float32
            assert np.isfinite(z["latent"]).all()
    with open(os.path.join(logdir, "third_stage_results.csv")) as f:
        header, values = [line.strip().split(",") for line in f]
    assert header == ["fid", "weather_f1", "clip_agreement", "head_agreement", "flow_mse"]
    assert all(np.isfinite(float(v)) for v in values)
    with open(os.path.join(logdir, "third_stage_flow.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "time,flow_true,flow_pred" and len(rows) == 3


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_main.main(["-b", MICRO, "-l", "/nonexistent"])


def test_main_gives_back_the_signal_handler(corpus, tmp_path):
    """The crash checkpoint's SIGUSR1 handler holds the run's state; on
    return the caller's handler is back and nothing of the port keeps the
    model or the state alive."""
    root, corpus_dir = corpus
    before = signal.getsignal(signal.SIGUSR1)
    _, model, state = t_main.main(_micro_argv(corpus_dir, tmp_path / "logs"))
    assert signal.getsignal(signal.SIGUSR1) == before
    refs = weakref.ref(model), weakref.ref(state)
    del model, state
    gc.collect()
    assert [r() for r in refs] == [None, None]


# ------------------------------------------------------------ first stage
@pytest.fixture(scope="module")
def ae_run(corpus):
    root, _ = corpus
    rng = np.random.RandomState(6)
    for split, n in (("train", 4), ("val", 2)):
        d = root / "pngs" / split
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"{i:03d}.png").write_bytes(
                encode_png(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)))
    dots = [f"data.params.train.params.data_root={root / 'pngs' / 'train'}",
            f"data.params.validation.params.data_root={root / 'pngs' / 'val'}"]
    argv = ["-b", AE_TINY, "-t", "--device", "cpu", "--max_steps", "1", "--log_every", "1",
            "-l", str(root / "ae_logs"), *dots]
    cfg = t_config.load_config([AE_TINY], dots)
    mp_ = cfg["model"]["params"]
    vae = t_config.resolve_target(cfg["model"]["target"])  # the registry's class
    t_vae, t_loss = t_training.build_autoencoder(cfg["model"], device="cpu")
    assert isinstance(t_vae, vae)
    ae_tree = random_tree(flax_shapes_of(t_vae), seed=1)["params"]
    loss_tree = random_tree(flax_shapes_of(t_loss), seed=2)["params"]
    jvae = j_build_first_stage(cfg["model"])
    jloss = j_config.instantiate_from_config(mp_["lossconfig"])
    lr = 2 * cfg["model"]["base_learning_rate"]
    opt_ae, opt_disc = optax.adam(lr, b1=0.5, b2=0.9), optax.adam(lr, b1=0.5, b2=0.9)
    ae_p = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    loss_p = jax.tree_util.tree_map(jnp.asarray, loss_tree)
    j_state = j_vae_trainer.VAETrainState(
        step=jnp.zeros((), jnp.int32), ae_params=ae_p, loss_params=loss_p,
        opt_ae_state=opt_ae.init(ae_p), opt_disc_state=opt_disc.init(loss_p["discriminator"]))
    key = jax.random.PRNGKey(7)
    seen = {}
    real = t_training.make_vae_train_step

    def make_vae_train_step(vae, loss_module, opt_a, opt_d, **kw):
        step = real(vae, loss_module, opt_a, opt_d, **kw)

        def replayed(state, batch, generator=None, noise=None):
            x = batch["image"].numpy()
            with gc_paused():
                fn = j_vae_trainer.make_vae_train_step(jvae, jloss, opt_ae, opt_disc)
                b = {"image": jnp.asarray(x)}
                _, seen["jax"] = fn.lower(j_state, b, key).compile(XLA)(j_state, b, key)
            z = np.asarray(jax.random.normal(key, (x.shape[0], 16, 16, 2)))
            state, metrics = step(state, batch, generator, noise=torch.from_numpy(z))
            seen["port"] = metrics
            return state, metrics

        return replayed

    def init(vae, loss_module, seed):
        load_flax_params(vae, {"params": ae_tree}, device="cpu")
        load_flax_params(loss_module, {"params": loss_tree}, device="cpu")

    mp = pytest.MonkeyPatch()
    mp.setattr(t_training, "make_vae_train_step", make_vae_train_step)
    mp.setattr(t_main, "init_autoencoder_weights", init)
    try:
        logdir, vae_module, state = t_main.main(argv)
    finally:
        mp.undo()
    return dict(logdir=logdir, seen=seen, state=state)


def test_train_autoencoder_step_equals_jax(ae_run):
    got, want = ae_run["seen"]["port"], jax.device_get(ae_run["seen"]["jax"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    rows = _metrics(ae_run["logdir"])
    assert rows[0]["step"] == 1
    assert rows[0]["train/total_loss"] == pytest.approx(float(want["train/total_loss"]),
                                                        rel=1e-5, abs=1e-6)
    assert ae_run["state"].step == 1


def test_train_autoencoder_writes_the_validation_and_the_grid(ae_run):
    logdir = pathlib.Path(ae_run["logdir"])
    rows = _metrics(logdir)
    assert any("val/rec_loss" in r for r in rows)
    assert (logdir / "checkpoints" / "1" / "meta.json").is_file()
    assert (logdir / "checkpoints" / "last" / "state.pt").is_file()
    grid = load_png(str(logdir / "images" / "val" / "recon_gs-000001.png"))
    assert grid.shape == (32, 64, 3) and grid.dtype == np.uint8
