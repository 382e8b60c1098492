"""The port's distribution layer (`ealdm_torch/parallel/`, the distributed
`ealdm_torch.main`) against the JAX package's, on the CPU over gloo. Ranks
are spawned processes with a free port and a collective timeout of their
own (`tests/torch_parallel_worker.py`); the models are tiny and float32.

1. `MeshConfig.resolve`, `local_batch_size` and `scale_learning_rate`
   give JAX's values and refuse what JAX refuses;
2. for tests/test_tp_sampling.py's UNet and the micro STDiff LDM at T = 2
   and 4, the port cuts exactly the leaves JAX's `state_sharding_rules`
   cuts, to the same shard shapes (under the `flax_import` name map);
3. a cut `Dense`, `Conv2D` or `Embed` equals the whole layer, trainable
   (its slice of the output, gathered; the gradients) and frozen (its
   weight gathered); tests/test_tp_sampling.py's program at T = 2 with
   seeded parameters and JAX's draws equals JAX's one-device DDIM;
4. tests/multiproc_worker.py's DDPM at --devices 2 takes JAX's one-process
   losses and gradient norms; at dp2 x tp2 (4 ranks) the port's own
   draws, state, samples and state bytes equal one process's; the VAE-GAN
   step at --devices 2 equals one process's;
5. `python -m ealdm_torch.main --devices 3` on the micro YAML prints JAX's
   "Reduced device count" and learning-rate lines, spawns 2 ranks that
   equal one process, writes each file once, and its checkpoint resumes in
   one process as the one-process run continues.

JAX's programs compile once each (XLA's backend optimisations off).
"""
import functools
import json
import os
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ealdm_torch.main as t_main
from ealdm_torch import config as t_config
from ealdm_torch import parallel as t_par
from ealdm_torch.data.pipeline import to_device
from ealdm_torch.data.synthetic import generate_synthetic_dataset
from ealdm_torch.models import UNetModel as TorchUNet
from ealdm_torch.parallel import sharding as t_sharding
from ealdm_torch.training import make_optimizer, make_train_step
from ealdm_torch.utils.flax_import import flax_to_state_dict
from ealdm_tpu import config as j_config
from ealdm_tpu.models import UNetModel as JaxUNet
from ealdm_tpu.models.ddpm import DDPM as JaxDDPM
from ealdm_tpu.ops.schedules import DDIMSchedule, DiffusionSchedule
from ealdm_tpu.parallel import MeshConfig as JMeshConfig
from ealdm_tpu.parallel import create_mesh as j_create_mesh
from ealdm_tpu.parallel import local_batch_size as j_local_batch_size
from ealdm_tpu.parallel import scale_learning_rate as j_scale_learning_rate
from ealdm_tpu.parallel.sharding import state_sharding_rules as j_state_sharding_rules
from ealdm_tpu.samplers import DDIMConfig, ddim_sample
from ealdm_tpu.training import TrainState as j_TrainState
from ealdm_tpu.training import make_optimizer as j_make_optimizer
from ealdm_tpu.training import make_train_step as j_make_train_step
from ealdm_tpu.training.ema import ema_init as j_ema_init
from tests import torch_parallel_worker as W
from tests.test_torch_port_cond import gc_paused
from tests.test_torch_port_models import mixed_batch, random_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
MICRO = str(REPO / "configs/smoke/stdiff_micro.yaml")
XLA = {"xla_backend_optimization_level": 0}
TOL = 1e-5
VAE_STEPS, VAE_LR = 1, 1e-4


def _load(out, rank):
    """A rank's saved numbers: rank r's (an int) or the file named `rank`."""
    name = f"rank{rank}" if isinstance(rank, int) else rank
    return torch.load(os.path.join(out, f"{name}.pt"), weights_only=False)


def _within_adam(got, want, lr, steps, what=""):
    """Parameters after `steps` Adam steps of `lr`: within TOL of their
    largest magnitude plus the two runs' moves apart (at most lr a step
    each), for leaves whose gradients are float noise (see
    test_dp2_tp2_equals_one_process)."""
    got, want = got.detach().numpy(), want.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * float(np.abs(want).max()) + 2 * steps * lr,
                               err_msg=what)


def _close_to_max(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1e-30, float(np.abs(want).max())), err_msg=what)


# ------------------------------------------------------------------ (1)
@pytest.mark.parametrize("n,data,model", [
    (8, -1, 1), (8, -1, 2), (8, 2, 4), (8, 4, 2), (4, -1, 4), (2, 2, 1), (1, -1, 1),
    (8, 3, 2), (6, -1, 4), (4, 2, 1), (3, -1, 2), (4, -1, 0)])
def test_mesh_config_resolves_as_jax(n, data, model):
    def run(cfg):
        try:
            return cfg.resolve(n)
        except (AssertionError, ValueError):
            return "refused"

    assert run(t_par.MeshConfig(data, model)) == run(JMeshConfig(data, model))


@pytest.mark.parametrize("batch,data,model", [(16, 8, 1), (8, 2, 4), (6, 4, 2), (32, 4, 2),
                                              (2, 2, 1), (3, 2, 1), (12, 1, 8)])
def test_local_batch_size_as_jax(batch, data, model):
    jmesh = j_create_mesh(JMeshConfig(data, model), devices=jax.devices()[:data * model])

    def run(fn, mesh):
        try:
            return fn(batch, mesh)
        except (AssertionError, ValueError):
            return "refused"

    assert run(t_par.local_batch_size, t_par.Mesh(data=data, model=model)) == run(
        j_local_batch_size, jmesh)


@pytest.mark.parametrize("args", [(1e-5, 8, 2, 1, True), (4.5e-6, 12, 4, 2, True),
                                  (2e-6, 32, 1, 1, False), (1e-4, 3, 8, 4, True)])
def test_scale_learning_rate_as_jax(args):
    assert t_par.scale_learning_rate(*args) == j_scale_learning_rate(*args)


@pytest.mark.parametrize("n,batch,tp", [(8, 16, 1), (8, 6, 2), (3, 2, 1), (4, 2, 2), (8, 1, 1),
                                        (6, 8, 2)])
def test_shrink_rule_is_jax_main(n, batch, tp):
    """JAX main.py's loop, as written there."""
    want = n
    while want > 1 and (batch % (want // tp) != 0):
        want -= tp
    assert t_main.shrink_devices(n, batch, tp) == want


# ------------------------------------------------------------------ (2)
def _jax_unet_shapes():
    m = JaxUNet(**W.TP_UNET)
    return jax.eval_shape(lambda r: m.init(r, jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,), jnp.int32)),
                          jax.random.PRNGKey(0))["params"]


def _jax_micro_shapes():
    cfg = j_config.load_config([MICRO])
    jm, _ = j_config.model_from_config(cfg["model"])
    batch = {"img": np.zeros((2, 16, 16, 3), np.float32), "mixed": mixed_batch(2, 16)}
    with gc_paused():
        return jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, batch, r,
                                                method=jm.full_init),
                              jax.random.PRNGKey(0))["params"]


def _port_micro():
    cfg = t_config.load_config([MICRO], [])
    return t_config.model_from_config(cfg["model"], dtype=torch.float32, device="meta")[0]


MODELS = {"tp_unet": (_jax_unet_shapes, lambda: TorchUNet(**W.TP_UNET).to("meta")),
          "stdiff_micro": (_jax_micro_shapes, _port_micro)}


@pytest.fixture(scope="module")
def shape_trees():
    return {k: (jax_fn(), port_fn()) for k, (jax_fn, port_fn) in MODELS.items()}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_cuts_the_leaves_jax_cuts(shape_trees, name, tp):
    jshapes, port = shape_trees[name]
    mesh = j_create_mesh(JMeshConfig(data=8 // tp, model=tp))
    shardings = j_state_sharding_rules(jshapes, mesh)
    # JAX's per-device shard of every leaf, carried through the name map
    shard_tree = jax.tree_util.tree_map(
        lambda s, sh: np.zeros(sh.shard_shape(s.shape), np.float32), jshapes, shardings)
    whole_tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jshapes)
    want_shard, want_whole = flax_to_state_dict(shard_tree), flax_to_state_dict(whole_tree)
    # bias_ih_l0 has no flax leaf: the bridge sizes it from the gate kernels
    want = {k: v.shape for k, v in want_shard.items()
            if v.shape != want_whole[k].shape and not k.endswith("bias_ih_l0")}
    rules = t_par.param_sharding_rules(port, tp)
    params = dict(port.named_parameters())
    assert set(rules) == set(want_whole)
    got = {k: t_sharding.shard_shape(params[k].shape, r, tp) for k, r in rules.items()
           if r is not None}
    assert got == want
    assert got, "the rule cuts nothing"


# ------------------------------------------------------------------ (3), (4)
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks runs (3) tests/test_tp_sampling.py's program
    at T = 2 on seeded parameters and JAX's draws, (4)
    tests/multiproc_worker.py's DDPM at --devices 2 on seeded parameters
    and JAX's t and noise, and the VAE step at --devices 2; meanwhile JAX's
    one-device DDIM and one-process DDPM steps compile and run here."""
    out = tmp_path_factory.mktemp("two_ranks")
    for d in ("tp", "dp"):
        (out / d).mkdir()
    # (3)
    unet = JaxUNet(**W.TP_UNET)
    shapes = jax.eval_shape(lambda r: unet.init(r, jnp.zeros((2, 8, 8, 3)),
                                                jnp.zeros((2,), jnp.int32)),
                            jax.random.PRNGKey(0))
    tp_params = random_tree(shapes, seed=2)
    rng = jax.random.PRNGKey(7)
    k_steps, k_init = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(k_init, (8, 8, 8, 3)))
    noises = [np.asarray(jax.random.normal(jax.random.split(k)[1], (8, 8, 8, 3)))
              for k in jax.random.split(k_steps, 4)]
    # (4)
    ddpm = JaxDDPM(unet_config=W.DDPM_UNET, timesteps=10)
    gbatch, lr = W.global_batch(), 1e-3
    batch = {"img": jnp.asarray(gbatch)}
    shapes = jax.eval_shape(lambda r: ddpm.init({"params": r, "dropout": r}, batch, r,
                                                method=ddpm.full_init), jax.random.PRNGKey(0))
    params = random_tree(shapes, seed=3)["params"]
    draws = []
    for i in (1, 2):
        rngs = jax.random.split(jax.random.PRNGKey(i), 4)  # t from [1], the noise from [2]
        draws.append((np.asarray(jax.random.randint(rngs[1], (16,), 0, 10)),
                      np.asarray(jax.random.normal(rngs[2], (16, 8, 8, 3)))))
    ranks = W.start_ranks(W.two_rank_jobs, 2, str(out), (tp_params, x_T, noises),
                          (params, gbatch, draws, lr), (VAE_STEPS, VAE_LR))
    ddim = DDIMSchedule.create(DiffusionSchedule.create(timesteps=20), 4)

    def program(params, rng):
        return ddim_sample(lambda x, t, c: unet.apply(params, x, t), rng, (8, 8, 8, 3), ddim,
                           DDIMConfig(num_steps=4))

    jp = jax.tree_util.tree_map(jnp.asarray, tp_params)
    jd = jax.tree_util.tree_map(jnp.asarray, params)
    opt = j_make_optimizer(lr, jd)
    state = j_TrainState(step=jnp.zeros((), jnp.int32), params=jd, opt_state=opt.init(jd),
                         ema=j_ema_init(jd))
    losses, norms = [], []
    with gc_paused():
        ref = jax.jit(program).lower(jp, rng).compile(XLA)(jp, rng)
        step = j_make_train_step(ddpm, opt, donate=False, remat="none").lower(
            state, batch, jax.random.PRNGKey(1)).compile(XLA)
        for i in (1, 2):
            state, m = step(state, batch, jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    W.join(ranks)
    return dict(tp=str(out / "tp"), ref=np.asarray(ref), dp=str(out / "dp"), losses=losses,
                norms=norms)


@pytest.mark.parametrize("name", ["dense", "conv", "embed"])
@pytest.mark.parametrize("frozen", [False, True])
def test_cut_layers_equal_whole_layers(two_ranks, name, frozen):
    """A cut `Dense`, `Conv2D` or `Embed` (T = 2) gives the whole layer's
    output on both ranks; trainable, the whole input gradient and the
    rank's slice of the weight gradient (1e-6 of each's largest)."""
    for r in (0, 1):
        saved = _load(two_ranks["tp"], f"layers_rank{r}")
        (want, want_g), (got, got_g) = (saved["res"][(name, frozen, k)]
                                        for k in ("whole", "cut"))
        _close_to_max(got, want, tol=1e-6, what=f"{name} rank {r}")
        assert set(got_g) == set(want_g) == (set() if frozen else {"x", "weight"})
        if not frozen:
            if name != "embed":
                _close_to_max(got_g["x"], want_g["x"], tol=1e-6, what=f"{name} dx")
            axis = 1 if name == "embed" else 0
            n = want_g["weight"].shape[axis] // 2
            own = want_g["weight"].narrow(axis, saved["index"] * n, n)
            _close_to_max(got_g["weight"], own, tol=1e-6, what=f"{name} dW")


def test_tp2_sampling_equals_jax_one_device(two_ranks):
    r0, r1 = _load(two_ranks["tp"], 0), _load(two_ranks["tp"], 1)
    assert r0["cut"] and r0["cut"] == r1["cut"]
    assert torch.equal(r0["z"], r1["z"])
    _close_to_max(r0["z"], two_ranks["ref"])


def test_dp2_train_equals_jax_one_process(two_ranks):
    j = two_ranks
    r0, r1 = _load(j["dp"], 0), _load(j["dp"], 1)
    assert r0["losses"] == r1["losses"] and r0["grad_norms"] == r1["grad_norms"]
    np.testing.assert_allclose(r0["losses"], j["losses"], rtol=TOL)
    np.testing.assert_allclose(r0["grad_norms"], j["norms"], rtol=TOL)
    for k, p in r0["params"].items():  # both ranks hold one state
        assert torch.equal(p, r1["params"][k]), k


def test_dp2_tp2_equals_one_process(tmp_path):
    """The cut and the gather are exact; the first step's gradients (summed
    over the model group, averaged over the data group), the metrics, the
    moments and the samples equal one process's. Parameters are held to
    one process's within the steps' Adam moves (`_within_adam`): this UNet's
    GroupNorms hold one channel a group and remove a per-channel constant,
    so the gradients of the time embedding and of conv_in's bias are float
    noise near 1e-9 (below Adam's eps), and their updates are not
    reproducible in sign."""
    batch, steps, n, lr = W.global_batch(), 2, 4, 1e-3
    ranks = W.start_ranks(W.dp_tp_train, 4, str(tmp_path), batch, lr, steps, n)
    one = W.ddpm_state_numbers(lr, batch, steps, n)
    W.join(ranks)
    ranks = [_load(tmp_path, r) for r in range(4)]
    gmax = max(float(g.abs().max()) for g in one["grads"].values())
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=TOL), k
        assert r["grads"].keys() == one["grads"].keys()
        for k, g in one["grads"].items():
            np.testing.assert_allclose(r["grads"][k].numpy(), g.numpy(), rtol=0,
                                       atol=TOL * gmax, err_msg=k)
        _close_to_max(r["samples"], one["samples"])
    sd, want = ranks[0]["state"], one["state"].state_dict()
    for k, v in one["state0"].items():
        assert torch.equal(ranks[0]["state0"][k], v), k
    for k, v in want["params"].items():
        _within_adam(sd["params"][k], v, lr, steps, k)
    for key in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in want["opt_state"][key].values())
        for k, v in want["opt_state"][key].items():
            np.testing.assert_allclose(sd["opt_state"][key][k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4 * top, err_msg=f"{key} {k}")
    assert sd["opt_state"]["count"] == want["opt_state"]["count"] == steps
    assert set(sd["ema"]["shadow"]) == set(want["ema"]["shadow"])
    # each rank holds the cut leaves' half and the whole leaves, to the byte
    state = one["state"]
    rules = t_par.param_sharding_rules(one["model"], 2)
    parts = [state.params, state.opt_state.mu, state.opt_state.nu, state.ema.shadow]
    expect = sum(t.numel() * t.element_size() // (2 if rules[k] else 1)
                 for part in parts for k, t in part.items())
    assert any(rules.values())
    assert [r["bytes"] for r in ranks] == [expect] * 4


def test_vae_step_dp2_equals_one_process(two_ranks):
    """`make_vae_train_step(..., mesh=)` at --devices 2 (JAX's takes a mesh
    too; its two ranks are two_ranks'): the tiny KL autoencoder with the
    GAN terms on, so d_weight comes from the global batch's gradient norms;
    the metrics within the VAE training tests' limits (1e-5 relative, 1e-6
    absolute) of one process's, the parameters within Adam's moves."""
    steps, lr = VAE_STEPS, VAE_LR
    metrics, params = W.vae_numbers(None, steps, lr)
    r0, r1 = (_load(two_ranks["dp"], f"vae_rank{r}") for r in (0, 1))
    assert r0["metrics"] == r1["metrics"]
    for got, want in zip(r0["metrics"], metrics):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k, p in params.items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        _within_adam(r0["params"][k], p, lr, steps, k)


# ------------------------------------------------------------------ (5)
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    generate_synthetic_dataset(str(root / "corpus"), sites=("Site_A_01", "Site_B_02"),
                               n_days=12, image_size=16, seed=0)
    return root


def _data_overrides(root):
    c = root / "corpus"
    return [f"data.params.train.params.path={c}/", f"data.params.train.params.path_weather={c}/",
            f"data.params.train.params.path_scaler={c}/scalers/"]


def _argv(root, logs, *extra):
    return ["-b", MICRO, "-t", "--device", "cpu", "--log_every", "1", "-l", str(root / logs),
            "--third_stage", "false", *_data_overrides(root), *extra]


def _rows(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def test_main_spawns_ranks_equal_to_one_process_and_resumes_in_one(corpus, capfd):
    # (b) --devices 3 gives 2 ranks by JAX's rule (batch 2); its parent
    # waits in a thread while (a), one process at the learning rate the
    # ranks' scaling gives, trains here
    spawned = {}
    b_run = threading.Thread(target=lambda: spawned.update(out=t_main.main(
        _argv(corpus, "b", "--max_steps", "1", "--devices", "3"))))
    b_run.start()
    try:
        logdir_a, model_a, state_a = t_main.main(_argv(corpus, "a", "--max_steps", "1",
                                                       "model.base_learning_rate=2.0e-05"))
    finally:
        b_run.join()
    logdir_b, model_b, state_b = spawned["out"]
    assert model_b is None and state_b is None
    out = capfd.readouterr().out
    jax_main = (REPO / "main.py").read_text()
    assert 'print(f"Reduced device count to {n_dev} so batch {batch_size} shards evenly")' \
        in jax_main
    assert "Reduced device count to 2 so batch 2 shards evenly" in out
    # JAX's line, its two f-string parts as main.py writes them
    assert 'f"Setting learning rate to {lr:.2e} = {opt.accumulate_grad_batches}"' in jax_main
    assert ('f" (accumulate) * {n_dev} (devices) * {batch_size} (bs) * {base_lr:.2e} (base)"'
            in jax_main)
    lr_line = ("Setting learning rate to {lr:.2e} = {a} (accumulate) * {n} (devices) * {bs} (bs) "
               "* {base:.2e} (base)")
    assert lr_line.format(lr=4e-5, a=1, n=2, bs=2, base=1e-5) in out
    assert out.count("Setting learning rate") == 2  # rank 0 of (b) and (a)
    # rank 0 alone wrote, once each
    files = sorted(p.relative_to(logdir_b).as_posix() for p in pathlib.Path(logdir_b).rglob("*")
                   if p.is_file())
    assert len([f for f in files if f.startswith("configs/")]) == 1
    assert len([f for f in files if f.startswith("tb/")]) == 1
    assert "checkpoints/last/state.pt" in files
    rows_a, rows_b = _rows(logdir_a), _rows(logdir_b)
    assert [r["step"] for r in rows_b] == [1]
    for ra, rb in zip(rows_a, rows_b):
        for k in ("train/loss", "train/grad_norm"):
            assert rb[k] == pytest.approx(ra[k], rel=TOL), k
    # the micro UNet's GroupNorms hold one channel a group too
    lr = 4e-5
    ckpt_b = torch.load(os.path.join(logdir_b, "checkpoints/last/state.pt"), weights_only=True)
    for k, p in state_a.params.items():
        _within_adam(ckpt_b["params"][k], p, lr, 1, k)
    # (d) (b)'s checkpoint resumed in one process, step 2, beside (a) continued
    # with the batch and seed the resumed loop takes first
    _, _, state_d = t_main.main(["-r", logdir_b, "-t", "--device", "cpu", "--max_steps", "2",
                                 "--log_every", "1", "--third_stage", "false", "--scale_lr",
                                 "false", "model.base_learning_rate=4.0e-05"])
    cfg = t_config.load_config([MICRO], _data_overrides(corpus))
    data = t_main._data(cfg, 23)[0]
    loader = data.train_dataloader()
    next(iter(loader))  # the run's `example`
    batch = to_device(next(iter(loader)), torch.device("cpu"))
    step = make_train_step(model_a, make_optimizer(lr), device="cpu")
    _, m3 = step(state_a, batch, torch.Generator().manual_seed(23))
    assert state_d.step == state_a.step == 2
    assert _rows(logdir_b)[-1]["train/loss"] == pytest.approx(float(m3["loss"]), rel=TOL)
    for k, p in state_a.params.items():
        _within_adam(state_d.params[k], p, lr, 2, k)


def test_bridge_scan_covers_parallel():
    from tests.test_torch_port_bridge import _sources

    names = {p.relative_to(REPO).as_posix() for p in _sources()}
    assert {"ealdm_torch/parallel/mesh.py", "ealdm_torch/parallel/sharding.py",
            "ealdm_torch/parallel/comm.py", "ealdm_torch/parallel/draws.py"} <= names


def test_draws_are_the_global_batch_rows():
    g = functools.partial(torch.Generator().manual_seed, 4)
    whole = torch.randn((2, 6, 3), generator=g())
    pair = torch.randn((4, 6, 3), generator=g())  # [negative; positive] blocks of 2 rows
    from ealdm_torch.parallel import draws

    for i in range(2):
        with draws.batch_rows(i, 2, 1):
            assert torch.equal(draws.randn((1, 6, 3), g()), whole[i:i + 1])
            assert torch.equal(draws.randn((2, 6, 3), g(), groups=2),
                               pair.reshape(2, 2, 6, 3)[:, i])
            # a row of 3 entries (the LSTM head's [B * T, .])
            assert torch.equal(draws.randn((3, 3), g()),
                               torch.randn((6, 3), generator=g())[i * 3:i * 3 + 3])
