"""First-stage VAE-GAN training in the port (`training/vae_trainer.py`)
against the JAX package's, float32 on the CPU: one `make_vae_train_step`
of a tiny KL model and of a tiny VQ model (disc_start 0, `n_classes` set),
both from one seeded random parameter tree carried by `flax_to_state_dict`,
the KL posterior drawn from JAX's key and replayed through `noise`.

JAX's step and eval step compile once per model (XLA's backend
optimisations off: a third less compile time, float32 kept) in a
module-scoped fixture that the cases share. Compared:

- every metric (the train/* logs, aeloss, discloss): 1e-5 relative, 1e-6
  absolute;
- both optimizers' Adam moments after the step (0.5 g and 0.1 g^2):
  within 1e-4 of each tensor's largest element plus 1e-6 of the
  optimizer's largest moment (the float32 rounding of a gradient that is
  zero but for it: a convolution's bias ahead of a GroupNorm, the
  attention's key bias; their moments are 1e-8 of the largest). Adam's
  first update moves each parameter by about lr whatever its gradient, so
  parameters are not compared: a gradient at float32 noise may flip sign
  between packages;
- the parameters LPIPS and logvar do not move, the discriminator and the
  autoencoder do; `make_vae_eval_step`'s val/* logs; a checkpoint round
  trip of the `VAETrainState`; LPIPS weights loaded from
  $EALDM_WEIGHTS_DIR as JAX's `weights.load_lpips_params` loads them.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ealdm_torch.losses import LPIPSWithDiscriminator, VQLPIPSWithDiscriminator
from ealdm_torch.models.vae import AutoencoderKL, VQModel
from ealdm_torch.training import (CheckpointManager, init_vae_train_state, make_vae_eval_step,
                                  make_vae_train_step)
from ealdm_torch.utils.flax_import import flax_to_state_dict, load_flax_params
from ealdm_tpu import losses as j_losses
from ealdm_tpu.models import vae as j_vae
from ealdm_tpu.training import vae_trainer as j_trainer
from tests.test_torch_port_cond import flax_shapes_of, gc_paused
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

B, RES, LR = 2, 16, 1e-3
DD = dict(double_z=True, z_channels=2, resolution=RES, in_channels=3, out_ch=3, ch=16,
          ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
KL_LOSS = dict(disc_start=0, kl_weight=1e-6, disc_weight=0.5, disc_num_layers=1,
               logvar_init=0.2)
VQ_LOSS = dict(disc_start=0, disc_weight=0.75, disc_num_layers=1, codebook_weight=1.0,
               n_classes=16)
VAL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL, MOMENT_FLOOR = 1e-4, 1e-6


def _models(kind, device="cpu"):
    if kind == "kl":
        return (AutoencoderKL(DD, embed_dim=2, device=device),
                LPIPSWithDiscriminator(**KL_LOSS, device=device))
    return (VQModel(dict(DD, double_z=False), n_embed=16, embed_dim=2, device=device),
            VQLPIPSWithDiscriminator(**VQ_LOSS, device=device))


def _jax_models(kind):
    if kind == "kl":
        return (j_vae.AutoencoderKL(ddconfig=DD, embed_dim=2),
                j_losses.LPIPSWithDiscriminator(**KL_LOSS))
    return (j_vae.VQModel(ddconfig=dict(DD, double_z=False), n_embed=16, embed_dim=2),
            j_losses.VQLPIPSWithDiscriminator(**VQ_LOSS))


def _moments(opt_state):
    """(mu, nu) of an optax.adam state."""
    adam = opt_state[0]
    return adam.mu, adam.nu


@pytest.fixture(scope="module", params=["kl", "vq"])
def jax_run(request):
    """JAX's train and eval step on the seeded trees, compiled once: (kind,
    ae tree, loss tree, batch, step key, noise, new state, metrics, val logs)."""
    kind = request.param
    vae, loss = _models(kind)
    ae_tree = random_tree(flax_shapes_of(vae), seed=1)["params"]
    loss_tree = random_tree(flax_shapes_of(loss), seed=2)["params"]
    x = np.random.RandomState(3).uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    jvae, jloss = _jax_models(kind)
    opt_ae = optax.adam(LR, b1=0.5, b2=0.9)
    opt_disc = optax.adam(LR, b1=0.5, b2=0.9)
    ae_p = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    loss_p = jax.tree_util.tree_map(jnp.asarray, loss_tree)
    state = j_trainer.VAETrainState(
        step=jnp.zeros((), jnp.int32), ae_params=ae_p, loss_params=loss_p,
        opt_ae_state=opt_ae.init(ae_p), opt_disc_state=opt_disc.init(loss_p["discriminator"]))
    key, eval_key = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    batch = {"image": jnp.asarray(x)}
    opts = {"xla_backend_optimization_level": 0}
    with gc_paused():
        step = j_trainer.make_vae_train_step(jvae, jloss, opt_ae, opt_disc)
        new_state, metrics = step.lower(state, batch, key).compile(opts)(state, batch, key)
        ev = j_trainer.make_vae_eval_step(jvae, jloss)
        val = ev.lower(new_state, batch, eval_key).compile(opts)(new_state, batch, eval_key)
    zshape = (B, RES // 2, RES // 2, 2)
    noise = (np.asarray(jax.random.normal(key, zshape)),
             np.asarray(jax.random.normal(eval_key, zshape))) if kind == "kl" else (None, None)
    return dict(kind=kind, ae_tree=ae_tree, loss_tree=loss_tree, x=x, noise=noise,
                state=jax.device_get(new_state), metrics=jax.device_get(metrics),
                val=jax.device_get(val))


def _port(run):
    vae, loss = _models(run["kind"])
    load_flax_params(vae, {"params": run["ae_tree"]}, device="cpu")
    load_flax_params(loss, {"params": run["loss_tree"]}, device="cpu")
    state, opt_ae, opt_disc = init_vae_train_state(vae, loss, LR, device="cpu")
    return vae, loss, state, opt_ae, opt_disc


def _noise(run, i):
    n = run["noise"][i]
    return None if n is None else torch.tensor(n)


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]), **VAL, err_msg=k)


def _moments_close(got, want_tree, prefix=""):
    want = {prefix + k: np.asarray(v, np.float64) for k, v in flax_to_state_dict(want_tree).items()}
    assert set(got) == set(want)
    floor = MOMENT_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        err = np.abs(got[k].detach().numpy() - w).max()
        assert err <= MOMENT_TOL * np.abs(w).max() + floor, (k, err, np.abs(w).max())


def test_train_step_matches_jax(jax_run):
    run = jax_run
    vae, loss, state, opt_ae, opt_disc = _port(run)
    before = {k: p.detach().clone() for k, p in {**state.ae_params, **state.loss_params}.items()}
    step = make_vae_train_step(vae, loss, opt_ae, opt_disc, device="cpu")
    state, metrics = step(state, {"image": torch.from_numpy(run["x"])}, None, _noise(run, 0))
    assert state.step == 1
    _close_metrics(metrics, run["metrics"])
    js = run["state"]
    mu, nu = _moments(js.opt_ae_state)
    _moments_close(state.opt_ae_state.mu, mu)
    _moments_close(state.opt_ae_state.nu, nu)
    mu, nu = _moments(js.opt_disc_state)
    _moments_close(state.opt_disc_state.mu, mu, "discriminator.")
    _moments_close(state.opt_disc_state.nu, nu, "discriminator.")
    for k, p in {**state.ae_params, **state.loss_params}.items():
        moved = not torch.equal(p, before[k])
        assert moved == (k in state.opt_ae_state.mu or k in state.opt_disc_state.mu), k
        assert p.grad is None, k
    if run["kind"] == "vq":
        assert float(metrics["train/perplexity"]) > 0


def test_eval_step_matches_jax(jax_run, tmp_path):
    """val/* logs after the step, at JAX's updated parameters (Adam's first
    step scales float32 noise up to lr, so the two packages' updated
    parameters need not agree); then the state's checkpoint round trip
    (parameters, both Adam states and the step, bit for bit)."""
    run = jax_run
    vae, loss, state, opt_ae, opt_disc = _port(run)
    x = {"image": torch.from_numpy(run["x"])}
    state, _ = make_vae_train_step(vae, loss, opt_ae, opt_disc, device="cpu")(
        state, x, None, _noise(run, 0))
    load_flax_params(vae, {"params": run["state"].ae_params}, device="cpu")
    load_flax_params(loss, {"params": run["state"].loss_params}, device="cpu")
    val = make_vae_eval_step(vae, loss, device="cpu")(state, x, None, _noise(run, 1))
    _close_metrics(val, run["val"])
    saved = copy.deepcopy(state.state_dict())
    mgr = CheckpointManager(str(tmp_path), monitor="val/rec_loss")
    mgr.save(state.step, state, {"val/rec_loss": val["val/rec_loss"]})
    fresh = _port(run)[2]
    assert fresh.step == 0
    mgr.restore(fresh)
    got = fresh.state_dict()
    assert got["step"] == 1
    for part in ("ae_params", "loss_params"):
        for k, v in saved[part].items():
            assert torch.equal(got[part][k], v), k
    for part in ("opt_ae_state", "opt_disc_state"):
        assert got[part]["count"] == saved[part]["count"] == 1
        for moment in ("mu", "nu"):
            for k, v in saved[part][moment].items():
                assert torch.equal(got[part][moment][k], v), k


def _vgg_lpips_state(seed):
    """A taming `vgg_lpips.pth` state dict (every VGG16 convolution and the
    five heads) with seeded values."""
    rng = np.random.RandomState(seed)
    sd, cin = {}, 3
    idx = iter((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))
    for b, width in enumerate((64, 128, 256, 512, 512)):
        for _ in range((2, 2, 3, 3, 3)[b]):
            i = next(idx)
            key = f"net.slice{1 + sum(i >= s for s in (4, 9, 16, 23))}.{i}"
            sd[f"{key}.weight"] = torch.from_numpy(
                (rng.randn(width, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32))
            sd[f"{key}.bias"] = torch.from_numpy((0.1 * rng.randn(width)).astype(np.float32))
            cin = width
        sd[f"lin{b}.model.1.weight"] = torch.from_numpy(rng.rand(1, width, 1, 1).astype(
            np.float32))
    return sd


def test_init_loads_lpips_weights(tmp_path, monkeypatch):
    """With a `vgg_lpips.pth` written here in $EALDM_WEIGHTS_DIR,
    `init_vae_train_state` loads it into the loss module's LPIPS: its value
    on two images equals JAX's LPIPS given the same file through
    `weights.load_lpips_params` (1e-5 relative). An empty directory leaves
    LPIPS as it was."""
    from ealdm_tpu import weights as j_weights

    vae, loss = _models("kl")
    monkeypatch.setenv("EALDM_WEIGHTS_DIR", str(tmp_path))
    before = {k: v.clone() for k, v in loss.perceptual.state_dict().items()}
    init_vae_train_state(vae, loss, LR, device="cpu")
    for k, v in loss.perceptual.state_dict().items():
        assert torch.equal(v, before[k]), k
    torch.save(_vgg_lpips_state(42), str(tmp_path / "vgg_lpips.pth"))
    init_vae_train_state(vae, loss, LR, device="cpu")
    rng = np.random.RandomState(43)
    x, y = (rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = loss.perceptual(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    variables = j_weights.load_lpips_params(random_tree(flax_shapes_of(loss.perceptual), 44))
    net = j_losses.LPIPS()
    with gc_paused():
        want = np.asarray(jax.jit(net.apply).lower(variables, x, y).compile(
            {"xla_backend_optimization_level": 0})(variables, x, y))
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not np.allclose(got, 0)


def test_entry_points_default_to_cuda():
    """The VQ model, the losses and the VAE trainer run on the card unless
    asked for the CPU: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without CUDA")
    from ealdm_torch.losses import LPIPS, NLayerDiscriminator, build_loss

    for make in (lambda: VQModel(dict(DD, double_z=False), n_embed=16, embed_dim=2),
                 lambda: AutoencoderKL(DD, embed_dim=2), LPIPS, NLayerDiscriminator,
                 lambda: LPIPSWithDiscriminator(**KL_LOSS),
                 lambda: VQLPIPSWithDiscriminator(**VQ_LOSS),
                 lambda: build_loss({"target": "ldm.modules.losses.LPIPSWithDiscriminator",
                                     "params": KL_LOSS})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    vae, loss = _models("kl")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_vae_train_state(vae, loss, LR)
    state, opt_ae, opt_disc = init_vae_train_state(vae, loss, LR, device="cpu")
    for make in (lambda: make_vae_train_step(vae, loss, opt_ae, opt_disc),
                 lambda: make_vae_eval_step(vae, loss)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
