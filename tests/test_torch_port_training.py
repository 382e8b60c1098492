"""The port's training slice against the JAX package, float32 on the CPU, at
the tiny flagship config (`bench.build_model(tiny=True)`) with the same
weights (`tests/test_torch_port_models.build_pair`):

  (iii) the loss and every trainable gradient of the whole objective
        (frozen VQ encode, the 2N conditioning pair, q_sample, one 2N CFG
        UNet call, the eps loss) at explicit t and noise, dropout off;
  (iv)  AdamW with LambdaLinearScheduler, three updates, plain and with
        accumulate_grad_batches=2;
  (v)   the EMA and the three LR schedules;
  (vi)  the three remat policies give the same gradients;
  (vii) two train steps, a CheckpointManager round trip and a bit-identical
        third step;
  (viii) dropout: seeded, and off in eval mode;
plus the posterior algebra, `prior_bpd`, `normal_kl` and the train state of
a JAX run carried across by the bridge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.models import distributions as t_dist
from ealdm_torch.training import (
    CheckpointManager,
    build_scheduler,
    ema_init,
    ema_update,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from ealdm_torch.utils.flax_import import flax_to_state_dict, load_flax_ema
from ealdm_tpu.models import distributions as j_dist
from ealdm_tpu.training import ema as j_ema
from ealdm_tpu.training import lr_scheduler as j_lr
from ealdm_tpu.training import trainer as j_trainer
from tests.test_torch_port_models import build_pair

torch.set_num_threads(1)

B, SEED = 2, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_max(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    limit = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= limit, (err, limit)


def _torch_batch(batch):
    return {"img": _t(batch["img"]), "mixed": {k: _t(v) for k, v in batch["mixed"].items()}}


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm, mixed = build_pair(b=B, seed=SEED)
    rng = np.random.RandomState(SEED)
    batch = {"img": rng.randn(B, 64, 64, 3).astype(np.float32), "mixed": mixed}
    t = np.array([999, 123], np.int32)
    noise = rng.randn(B, 8, 8, 4).astype(np.float32)
    return dict(jm=jm, variables=variables, tm=tm, batch=batch, t=t, noise=noise)


def _jax_loss(module, batch, t, noise):
    """JAX's training objective at explicit t and noise, dropout off:
    (loss, (metrics, c_pos))."""
    z = module.get_first_stage_encoding(module.encode_first_stage(batch["img"]))
    c_neg, c_pos = module.get_learned_conditioning_pair(batch["mixed"], deterministic=True)
    loss, metrics = module.p_losses(z, jnp.concatenate([c_neg, c_pos]), t, noise,
                                    deterministic=True)
    return loss, (metrics, c_pos)


def _torch_grads(tm, batch, t, noise, remat="none"):
    for p in tm.parameters():
        p.grad = None
    tm.train()
    with tm.model.diffusion_model.remat_blocks(remat):
        loss, metrics = tm.training_loss(_torch_batch(batch), None, t=_t(t).long(),
                                         noise=_t(noise), train=False)
    loss.backward()
    return loss, metrics, {k: p.grad for k, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def objective(pair):
    jm, variables = pair["jm"], pair["variables"]

    def f(params):
        return jm.apply({"params": params}, pair["batch"], pair["t"], pair["noise"],
                        method=_jax_loss)

    (loss_j, (metrics_j, c_pos_j)), grads_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"])
    loss_t, metrics_t, grads_t = _torch_grads(pair["tm"], pair["batch"], pair["t"],
                                              pair["noise"])
    return dict(loss_j=float(loss_j), metrics_j=jax.device_get(metrics_j), loss_t=loss_t,
                metrics_t=metrics_t, grads_j=jax.device_get(grads_j), grads_t=grads_t,
                c_pos_j=np.asarray(c_pos_j))


# ------------------------------------------------------------------ (iii)
def test_loss_matches(objective):
    assert objective["loss_t"].item() == pytest.approx(objective["loss_j"], rel=1e-5)
    for k in ("loss_simple", "loss_vlb", "loss"):
        assert objective["metrics_t"][k].item() == pytest.approx(
            float(objective["metrics_j"][k]), rel=1e-5), k


def test_every_trainable_gradient_matches(pair, objective):
    """JAX's gradient tree in the port's names and layouts: each trainable
    gradient to 1e-4 of its largest element. The first stage has none on
    either side (JAX: zeros behind stop_gradient; the port: no .grad), nor
    has the LSTMs' bias_ih, which flax does not have. A gradient that is
    zero in exact arithmetic (conv_cat_0's bias, before a GroupNorm of one
    channel a group; the LSTMs' weight_hh over one time step) is rounding
    noise on both sides: both must stay below 1e-7 of the model's largest
    gradient."""
    want = flax_to_state_dict(objective["grads_j"])
    got = objective["grads_t"]
    trainable = [k for k, p in pair["tm"].named_parameters() if p.requires_grad]
    assert len(trainable) > 100
    noise_floor = 1e-7 * max(np.abs(want[k]).max() for k in trainable)
    for k in trainable:
        assert got[k] is not None, k
        if np.abs(want[k]).max() <= noise_floor:
            assert got[k].abs().max().item() <= noise_floor, k
            continue
        _close_to_max(got[k], want[k], 1e-4)
    for k, p in pair["tm"].named_parameters():
        if not p.requires_grad:
            assert got[k] is None, k
            assert k.startswith("first_stage_model") or k.endswith("bias_ih_l0"), k
            assert not np.any(want[k]), k


def test_posterior_algebra_matches(pair):
    jm, variables, tm = pair["jm"], pair["variables"], pair["tm"]
    rng = np.random.RandomState(1)
    x0, xt, eps = (rng.randn(B, 8, 8, 4).astype(np.float32) for _ in range(3))
    t = np.array([0, 640], np.int32)
    bound = jm.bind(variables)
    want = [bound.q_sample(x0, t, eps), *bound.q_mean_variance(x0, t),
            bound.predict_start_from_noise(xt, t, eps), bound.predict_eps_from_xstart(xt, t, x0),
            *bound.q_posterior(x0, xt, t), bound.prior_bpd(x0)]
    tt = _t(t).long()
    got = [tm.q_sample(_t(x0), tt, _t(eps)), *tm.q_mean_variance(_t(x0), tt),
           tm.predict_start_from_noise(_t(xt), tt, _t(eps)),
           tm.predict_eps_from_xstart(_t(xt), tt, _t(x0)), *tm.q_posterior(_t(x0), _t(xt), tt),
           tm.prior_bpd(_t(x0))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.broadcast_to(g.numpy(), np.shape(w)), w,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("second", ["tensors", "numbers"])
def test_normal_kl_matches(second):
    """The VLB prior term, against JAX's `normal_kl`: against a second
    Gaussian given as tensors, or as the numbers `prior_bpd` passes."""
    rng = np.random.RandomState(2)
    m1, lv1, m2, lv2 = (rng.randn(2, 3, 3, 4).astype(np.float32) for _ in range(4))
    if second == "numbers":
        m2, lv2 = 0.5, -0.25
    got = t_dist.normal_kl(_t(m1), _t(lv1), *(x if np.isscalar(x) else _t(x) for x in (m2, lv2)))
    want = j_dist.normal_kl(m1, lv1, m2, lv2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ (iv)
SCHED = {"target": "ldm.lr_scheduler.LambdaLinearScheduler",
         "params": {"warm_up_steps": [2], "cycle_lengths": [10], "f_start": [0.1],
                    "f_max": [1.0], "f_min": [0.5]}}


@pytest.mark.parametrize("accumulate", [1, 2])
def test_optimizer_matches_optax(accumulate):
    """Three updates of make_optimizer against the JAX one on a two-part
    tree whose "first_stage_model" part is frozen, on the same gradients."""
    rng = np.random.RandomState(3)
    tree = {"model": {"a": rng.randn(4, 5).astype(np.float32),
                      "b": rng.randn(7).astype(np.float32)},
            "first_stage_model": {"c": rng.randn(3).astype(np.float32)}}
    lr = 1e-2
    j_opt = j_trainer.make_optimizer(lr, tree, schedule_fn=j_lr.build_scheduler(SCHED),
                                     accumulate_grad_batches=accumulate)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)
    j_update = jax.jit(j_opt.update)
    names = {"model.a": ("model", "a"), "model.b": ("model", "b"),
             "first_stage_model.c": ("first_stage_model", "c")}
    params = {k: _t(tree[a][b]).requires_grad_(not k.startswith("first"))
              for k, (a, b) in names.items()}
    t_opt = make_optimizer(lr, schedule_fn=build_scheduler(SCHED),
                           accumulate_grad_batches=accumulate)
    t_state = t_opt.init(params)
    for _ in range(3 * accumulate):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        updates, j_state = j_update(jax.tree_util.tree_map(jnp.asarray, g), j_state,
                                    j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, updates)
        t_opt.apply(params, {k: _t(g[a][b]) for k, (a, b) in names.items()}, t_state)
        for k, (a, b) in names.items():
            np.testing.assert_allclose(params[k].detach().numpy(), j_params[a][b],
                                       rtol=1e-6, atol=0)
    assert t_state.count == 3
    np.testing.assert_array_equal(params["first_stage_model.c"].detach().numpy(),
                                  tree["first_stage_model"]["c"])


# ------------------------------------------------------------------ (v)
def test_ema_matches():
    rng = np.random.RandomState(4)
    p0 = rng.randn(6, 3).astype(np.float32)
    for use_num_updates in (True, False):
        j_state = j_ema.ema_init({"w": jnp.asarray(p0)}, decay=0.99,
                                 use_num_updates=use_num_updates)
        t_state = ema_init({"w": _t(p0)}, decay=0.99, use_num_updates=use_num_updates)
        for _ in range(12):
            p = rng.randn(6, 3).astype(np.float32)
            j_state = j_ema.ema_update(j_state, {"w": jnp.asarray(p)})
            ema_update(t_state, {"w": _t(p)})
            np.testing.assert_allclose(t_state.shadow["w"].numpy(), j_state.shadow["w"],
                                       rtol=1e-6, atol=1e-7)
        assert t_state.num_updates == int(j_state.num_updates)


@pytest.mark.parametrize("config", [
    {"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
     "params": {"warm_up_steps": 5, "lr_min": 0.1, "lr_max": 1.0, "lr_start": 0.01,
                "max_decay_steps": 20, "verbosity_interval": 0}},
    {"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2",
     "params": {"warm_up_steps": [3, 2], "f_min": [0.1, 0.2], "f_max": [1.0, 0.8],
                "f_start": [0.0, 0.3], "cycle_lengths": [10, 15]}},
    {"target": "ldm.lr_scheduler.LambdaLinearScheduler",
     "params": {"warm_up_steps": [4, 0], "f_min": [0.5, 0.1], "f_max": [1.0, 0.9],
                "f_start": [1e-6, 0.9], "cycle_lengths": [12, 20]}},
], ids=["cosine", "cosine_cyclic", "linear_cyclic"])
def test_lr_schedules_match(config):
    """Every step of two cycles and beyond; JAX evaluates in float32."""
    j_fn, t_fn = j_lr.build_scheduler(config), build_scheduler(config)
    for n in range(40):
        assert t_fn(n) == pytest.approx(float(j_fn(n)), rel=1e-6, abs=1e-7), n


# ------------------------------------------------------------------ (vi)
def test_remat_policies_give_the_same_gradients(pair, objective):
    for policy in ("dots", "full"):
        loss, _, grads = _torch_grads(pair["tm"], pair["batch"], pair["t"], pair["noise"],
                                      remat=policy)
        assert loss.item() == objective["loss_t"].item(), policy
        for k, g in objective["grads_t"].items():
            if g is None:
                assert grads[k] is None
            else:
                torch.testing.assert_close(grads[k], g, rtol=0,
                                           atol=1e-6 * g.abs().max().item())


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_remat_reruns_one_block_at_a_time(pair, policy):
    """Under "dots" and "full" the backward reruns each UNet block and the
    out head once, when it reaches it: in the reverse of the forward's
    order, so one block's intermediates are live at a time. (One region
    around the whole loss reruns them all first, in the forward's order,
    and holds them all at once.) Under "none" nothing reruns."""
    unet = pair["tm"].model.diffusion_model
    names = [name for kind, name in unet.plan if kind in ("res", "attn", "resample")]
    names.append("out_norm")
    log = []
    hooks = [getattr(unet, n).register_forward_pre_hook(lambda m, a, n=n: log.append(n))
             for n in names]
    try:
        _torch_grads(pair["tm"], pair["batch"], pair["t"], pair["noise"], remat=policy)
    finally:
        for h in hooks:
            h.remove()
    assert len(names) > 10
    assert log == (names if policy == "none" else names + names[::-1])
    assert unet.remat == "none"  # the policy holds inside the context only


# ------------------------------------------------------------------ (vii)
def _fresh_model(pair, fill=None):
    from ealdm_torch.config import TINY, model_kwargs
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.utils.flax_import import load_flax_params

    tm = LatentDiffusion(**model_kwargs(TINY), dtype=torch.float32, device="cpu")
    if fill is None:
        load_flax_params(tm, pair["variables"], device="cpu")
    else:
        with torch.no_grad():
            for p in tm.parameters():
                p.fill_(fill)
    return tm


def test_checkpoint_resume_is_bit_identical(pair, tmp_path):
    batch = _torch_batch(pair["batch"])

    def run(tm, state, steps):
        step = make_train_step(tm, state_opt[id(tm)], remat="dots", device="cpu")
        out = None
        for s in steps:
            state, out = step(state, batch, torch.Generator().manual_seed(100 + s))
        return state, out

    state_opt = {}
    tm = _fresh_model(pair)
    state, opt = init_train_state(tm, learning_rate=1e-3, ema_decay=0.9, device="cpu")
    state_opt[id(tm)] = opt
    state, metrics = run(tm, state, [1, 2])
    assert state.step == 2 and torch.isfinite(metrics["loss"])
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_top_k=1, monitor="loss")
    mgr.save(2, state, metrics={"loss": metrics["loss"]})
    state, m3 = run(tm, state, [3])
    want = {k: p.detach().clone() for k, p in state.params.items()}
    want_ema = {k: s.clone() for k, s in state.ema.shadow.items()}

    tm2 = _fresh_model(pair, fill=0.5)
    state2, opt2 = init_train_state(tm2, learning_rate=1e-3, ema_decay=0.9, device="cpu")
    state_opt[id(tm2)] = opt2
    assert mgr.latest_step() == 2 and mgr.best_step() == 2
    state2 = mgr.restore(state2)
    assert state2.step == 2 and state2.opt_state.count == 2 and state2.ema.num_updates == 2
    state2, m3b = run(tm2, state2, [3])
    for k in want:
        assert torch.equal(state2.params[k], want[k]), k
        assert torch.equal(state2.ema.shadow[k], want_ema[k]), k
    assert all(torch.equal(m3[k], m3b[k]) for k in m3)
    # the frozen first stage never moved
    fs = {k: v for k, v in flax_to_state_dict(pair["variables"]).items()
          if k.startswith("first_stage_model")}
    for k, v in fs.items():
        np.testing.assert_array_equal(state.params[k].detach().numpy(), v)
    # eval with params and EMA; last restores too
    ev = make_eval_step(tm, device="cpu")(state, batch, torch.Generator().manual_seed(0))
    assert {"loss", "loss_ema", "loss_simple_ema"} <= set(ev)
    assert mgr.restore_last(state2).step == 2


def test_checkpoint_retention():
    """top-k on the monitored metric; checkpoints without it are kept."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        params = {"w": torch.zeros(3, requires_grad=True)}
        from ealdm_torch.training.trainer import TrainState

        opt = make_optimizer(1e-3)
        state = TrainState(step=0, params=params, opt_state=opt.init(params),
                           ema=ema_init(params))
        mgr = CheckpointManager(d, save_top_k=2, monitor="val/loss")
        for step, loss in ((1, 0.9), (2, 0.5), (3, 0.7), (4, None), (5, 0.8)):
            state.step = step
            mgr.save(step, state, None if loss is None else {"val/loss": loss})
        assert sorted(mgr._metrics()) == [2, 3, 4]
        assert mgr.best_step() == 2 and mgr.latest_step() == 4
        assert mgr.should_save_every_n(0) is False
        with torch.no_grad():
            params["w"].fill_(7.0)
        mgr.restore(state, step=3)
        assert state.step == 3 and not params["w"].any()


@pytest.mark.parametrize("cut", ["last", "numbered"])
def test_checkpoint_survives_a_crash_mid_rewrite(tmp_path, cut):
    """A crash between setting the old checkpoint aside and renaming the new
    one into place leaves only `<name>.old`: the readers take it, and the
    next save writes over it cleanly."""
    import os

    from ealdm_torch.training.trainer import TrainState

    params = {"w": torch.zeros(3, requires_grad=True)}
    opt = make_optimizer(1e-3)
    state = TrainState(step=4, params=params, opt_state=opt.init(params), ema=None)
    mgr = CheckpointManager(str(tmp_path), save_top_k=2, monitor=None)
    mgr.save(4, state)
    name = "last" if cut == "last" else "4"
    os.replace(tmp_path / name, tmp_path / (name + ".old"))  # the crash's state
    with torch.no_grad():
        params["w"].fill_(7.0)
    state.step = 0
    restored = mgr.restore_last(state) if cut == "last" else mgr.restore(state)
    assert restored.step == 4 and not params["w"].any()
    assert mgr.latest_step() == 4
    state.step = 5
    mgr.save(5, state)
    mgr.save(4, state)  # rewrites step 4 over its set-aside copy
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "last"]
    assert mgr.restore_last(state).step == 5


# ------------------------------------------------------------------ (viii)
def test_dropout_is_seeded_and_off_in_eval(pair, objective):
    """The tower (env fusion on) in train() mode: the same generator seed
    gives the same output, another seed another; without a generator, or in
    eval mode, no dropout, and eval mode equals JAX's deterministic c_pos."""
    tm = pair["tm"]
    mixed = {k: _t(v) for k, v in pair["batch"]["mixed"].items()}
    want = objective["c_pos_j"]
    tower = tm.cond_stage_model
    with torch.no_grad():
        feat = tm._mixed_image_features(mixed["img"])
        args = (feat, mixed["flow"], mixed["weather"], mixed["time"])
        tower.train()
        a = tower(*args, generator=torch.Generator().manual_seed(1))
        b = tower(*args, generator=torch.Generator().manual_seed(1))
        c = tower(*args, generator=torch.Generator().manual_seed(2))
        plain = tower(*args)  # no generator: no dropout
        tower.eval()
        ev = tower(*args, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose(ev.numpy(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(plain, ev, rtol=0, atol=0)
    assert (a - ev).abs().max() > 1e-3


# ------------------------------------------------------------------ bridge
def test_jax_train_state_resumes_in_the_port(pair):
    """A learned logvar and a JAX EmaState's shadow tree come across."""
    from ealdm_torch.config import TINY, model_kwargs
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.utils.flax_import import load_flax_params

    params = dict(pair["variables"]["params"])
    params["logvar"] = np.linspace(-1, 1, 1000).astype(np.float32)
    tm = LatentDiffusion(**model_kwargs(TINY), learn_logvar=True, dtype=torch.float32,
                         device="cpu")
    load_flax_params(tm, {"params": params}, device="cpu")
    np.testing.assert_array_equal(tm.logvar.detach().numpy(), params["logvar"])
    assert tm.logvar.requires_grad
    shadow = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, params)
    state, _ = init_train_state(tm, device="cpu")
    load_flax_ema(state.ema, tm, shadow)
    np.testing.assert_array_equal(state.ema.shadow["logvar"].numpy(), 0.5 * params["logvar"])
    w = params["model"]["diffusion_model"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(
        state.ema.shadow["model.diffusion_model.conv_in.weight"].numpy(),
        0.5 * np.transpose(w, (3, 2, 0, 1)))
