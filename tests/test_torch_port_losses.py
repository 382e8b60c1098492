"""The first-stage losses of the port (`ealdm_torch/losses`) against the JAX
package's (`ealdm_tpu/losses`), float32 on the CPU, on seeded numpy inputs
and one seeded random parameter tree carried into the port by
`flax_to_state_dict`:

- the VectorQuantizer's gradients (encoder input and codebook) against
  `jax.grad` of JAX's: the commitment and codebook terms and the
  straight-through estimator;
- the GAN primitives, LPIPS (VGG16 at its fixed widths on 32^2 images), the
  PatchGAN discriminator at 1-3 layers and odd sides, both loss modules'
  generator and discriminator branches (values and logs) and the adaptive
  d_weight against `jax.grad` with respect to the reconstruction;
- `load_torch_lpips_weights` in both checkpoint layouts, `build_loss`;
- the full-width `vq-f8` and `kl-f8` trainable trees, autoencoder and loss,
  built on torch's "meta" device against `jax.eval_shape` of the JAX init.

Tolerances: values 1e-5 relative (1e-6 absolute), gradients 1e-5 of each
gradient's largest element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import config as t_config
from ealdm_torch import losses as t_losses
from ealdm_torch import zoo
from ealdm_torch.models.distributions import DiagonalGaussian as TorchGaussian
from ealdm_torch.models.quantize import VectorQuantizer as TorchVQ
from ealdm_torch.training import build_autoencoder
from ealdm_torch.utils.flax_import import flax_to_state_dict, load_flax_params
from ealdm_tpu import losses as j_losses
from ealdm_tpu.models.distributions import DiagonalGaussian as JaxGaussian
from ealdm_tpu.models.quantize import VectorQuantizer as JaxVQ
from tests.test_torch_port_cond import flax_shapes_of, gc_paused
from tests.test_torch_port_models import random_tree

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-6)
B, RES = 2, 32


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or VAL))


def _grad_close(got, want, tol=1e-5):
    got, want = np.asarray(got.detach().numpy(), np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _images(seed, n=B, res=RES):
    return np.random.RandomState(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _pair(module, seed):
    """A seeded flax tree of the port module's parameter shapes, loaded into
    it."""
    variables = random_tree(flax_shapes_of(module), seed)
    load_flax_params(module, variables, device="cpu")
    return jax.tree_util.tree_map(jnp.asarray, variables)


# --------------------------------------------------------------- quantizer
def test_vector_quantizer_gradients_match_jax():
    """loss(z, e) = sum(z_q * w) + 3 * codebook_loss: its value, z_q and the
    indices, and its gradients with respect to the encoder output z and the
    codebook, against jax.grad of JAX's VectorQuantizer. Without the
    stop-gradients the encoder's gradient through z_q vanishes (1 - 1) and
    the decoder's lands on the codebook rows."""
    n_embed, dim, beta = 12, 4, 0.25
    rng = np.random.RandomState(3)
    z = rng.randn(2, 5, 5, dim).astype(np.float32)
    emb = rng.randn(n_embed, dim).astype(np.float32)
    w = rng.randn(2, 5, 5, dim).astype(np.float32)
    jm = JaxVQ(n_embed, dim, beta)

    def f(z, e):
        zq, loss, (_, _, ind) = jm.apply({"params": {"embedding": e}}, z)
        return jnp.sum(zq * w) + 3.0 * loss, (zq, loss, ind)

    (val, (zq_j, loss_j, ind_j)), (gz_j, ge_j) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(z, emb)
    tm = TorchVQ(n_embed, dim, beta)
    with torch.no_grad():
        tm.embedding.copy_(_t(emb))
    zt = _t(z).requires_grad_()
    zq, loss, (_, _, ind) = tm(zt)
    total = torch.sum(zq * _t(w)) + 3.0 * loss
    gz, ge = torch.autograd.grad(total, [zt, tm.embedding])
    np.testing.assert_array_equal(ind.numpy(), np.asarray(ind_j))
    _close(zq, zq_j)
    _close(loss, loss_j)
    _close(total, val)
    _grad_close(gz, gz_j)
    _grad_close(ge, ge_j)


# --------------------------------------------------------------- primitives
def test_gan_primitives_match_jax():
    rng = np.random.RandomState(4)
    real, fake = rng.randn(3, 6, 6, 1).astype(np.float32), rng.randn(3, 6, 6, 1).astype(np.float32)
    weights = rng.rand(3).astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        _close(getattr(t_losses, name)(_t(real), _t(fake)),
               getattr(j_losses, name)(real, fake))
    _close(t_losses.hinge_d_loss_with_exemplar_weights(_t(real), _t(fake), _t(weights)),
           j_losses.hinge_d_loss_with_exemplar_weights(real, fake, weights))
    for step in (0, 4, 5, 9, torch.tensor(4), torch.tensor(5)):
        got = t_losses.adopt_weight(0.75, step, threshold=5)
        assert got.dim() == 0
        assert float(got) == float(j_losses.adopt_weight(0.75, int(step), threshold=5))
    ind = rng.randint(0, 7, (2, 4, 4))
    perp, usage = t_losses.measure_perplexity(torch.from_numpy(ind), 16)
    perp_j, usage_j = j_losses.measure_perplexity(jnp.asarray(ind), 16)
    _close(perp, perp_j)
    assert int(usage) == int(usage_j) == len(np.unique(ind))


# --------------------------------------------------------------- networks
@gc_paused()
def test_lpips_matches_jax_and_is_frozen():
    """LPIPS values, and the gradient with respect to y, on a seeded tree;
    the port's parameters require no gradient."""
    tm = t_losses.LPIPS(device="cpu")
    assert not any(p.requires_grad for p in tm.parameters())
    for i, c in enumerate((64, 128, 256, 512, 512)):  # JAX's constant head init
        assert torch.all(getattr(tm, f"lin{i}").weight == 1.0 / c)
    variables = _pair(tm, seed=5)
    x, y = _images(6), _images(7)
    jm = j_losses.LPIPS()
    d_j, g_j = jax.jit(jax.value_and_grad(
        lambda y: jnp.sum(jm.apply(variables, x, y) * jnp.arange(1.0, B + 1))))(y)
    yt = _t(y).requires_grad_()
    d = tm(_t(x), yt)
    assert d.shape == (B,)
    total = torch.sum(d * torch.arange(1.0, B + 1))
    g, = torch.autograd.grad(total, yt)
    _close(total, d_j)
    _grad_close(g, g_j)


@pytest.mark.parametrize("n_layers,res", [(1, 32), (2, 40), (3, 62)])
def test_discriminator_matches_jax(n_layers, res):
    """Logits of the PatchGAN at 1-3 layers (GroupNorm at odd sides for 40
    and 62: 9^2 and 15^2 / 7^2) and the gradient with respect to its input."""
    tm = t_losses.NLayerDiscriminator(n_layers=n_layers, ndf=16, device="cpu")
    variables = _pair(tm, seed=10 + n_layers)
    x = _images(8, res=res)
    jm = j_losses.NLayerDiscriminator(n_layers=n_layers, ndf=16)
    out_j = jax.jit(jm.apply)(variables, x)
    g_j = jax.jit(jax.grad(lambda x: jnp.sum(jm.apply(variables, x) ** 2)))(x)
    xt = _t(x).requires_grad_()
    out = tm(xt)
    assert out.shape == out_j.shape
    _close(out, out_j, rtol=1e-5, atol=1e-5)
    g, = torch.autograd.grad(torch.sum(out ** 2), xt)
    _grad_close(g, g_j)


def test_discriminator_init_weights():
    """JAX's initialisers: N(0, 0.02^2) convolutions, zero biases, unit
    norm scales; the same draws on every call with one seed."""
    tm = t_losses.NLayerDiscriminator(n_layers=2, device="cpu")
    tm.init_weights_(torch.Generator().manual_seed(0))
    w = torch.cat([p.detach().flatten() for n, p in tm.named_parameters()
                   if n.startswith("conv") and n.endswith("weight")])
    assert abs(float(w.std()) - 0.02) < 5e-4 and abs(float(w.mean())) < 5e-4
    assert all(torch.all(p == 1) for n, p in tm.named_parameters() if n.startswith("norm")
               and n.endswith("weight"))
    assert all(torch.all(p == 0) for n, p in tm.named_parameters() if n.endswith("bias"))
    again = t_losses.NLayerDiscriminator(n_layers=2, device="cpu")
    again.init_weights_(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), again.parameters()))


# --------------------------------------------------------------- the losses
def _logs_close(got, want):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-5, atol=1e-6)


@gc_paused()
def test_kl_loss_branches_match_jax():
    """LPIPSWithDiscriminator: the adaptive d_weight (its gradients with
    respect to the reconstruction against jax.grad), the generator branch
    at that d_weight and with a weight map, the discriminator branch (hinge
    and vanilla), before and after disc_start: values and logs."""
    kw = dict(disc_start=3, kl_weight=1e-3, disc_weight=0.5, disc_num_layers=2,
              logvar_init=0.3)
    x, rec = _images(20), _images(21)
    rng = np.random.RandomState(22)
    moments = rng.randn(B, 4, 4, 4).astype(np.float32)
    weights = rng.rand(B, RES, RES, 1).astype(np.float32)
    for disc_loss in ("hinge", "vanilla"):
        tm = t_losses.LPIPSWithDiscriminator(**kw, disc_loss=disc_loss, device="cpu")
        variables = _pair(tm, seed=23)
        jm = j_losses.LPIPSWithDiscriminator(**kw, disc_loss=disc_loss)

        def jax_branches(v, x, rec, moments, weights, step):
            post = JaxGaussian.from_moments(moments)
            nll_g = jax.grad(lambda r: jm.apply(v, x, r, method=jm.nll_loss)[0])(rec)
            g_g = jax.grad(lambda r: jm.apply(v, r, method=jm.g_loss))(rec)
            dw = j_losses.adaptive_d_weight(nll_g, g_g, jm.disc_weight)
            gen = jm.apply(v, x, rec, post, step, dw, method=jm.generator_loss)
            genw = jm.apply(v, x, rec, post, step, dw, None, weights,
                            method=jm.generator_loss)
            disc = jm.apply(v, x, rec, step, method=jm.discriminator_loss)
            return gen, genw, disc

        jb = jax.jit(jax_branches)
        for step in (2, 3):
            gen_j, genw_j, disc_j = jb(variables, x, rec, moments, weights, step)
            post = TorchGaussian.from_moments(_t(moments))
            rt = _t(rec).requires_grad_()

            def d_weight(nll, g):
                a, = torch.autograd.grad(nll, rt, retain_graph=True)
                b, = torch.autograd.grad(g, rt, retain_graph=True)
                return t_losses.adaptive_d_weight(a, b, tm.disc_weight)

            loss, log = tm.generator_loss(_t(x), rt, post, step, d_weight)
            _close(loss, gen_j[0])
            _logs_close(log, gen_j[1])
            assert float(log["train/disc_factor"]) == (0.0 if step < 3 else 1.0)
            dw = log["train/d_weight"]
            loss_w, log_w = tm.generator_loss(_t(x), rt, post, step, dw, weights=_t(weights))
            _close(loss_w, genw_j[0])
            _logs_close(log_w, genw_j[1])
            d_loss, d_log = tm.discriminator_loss(_t(x), rt, step)
            _close(d_loss, disc_j[0])
            _logs_close(d_log, disc_j[1])


@gc_paused()
@pytest.mark.parametrize("pixel_loss", ["l1", "l2"])
def test_vq_loss_branches_match_jax(pixel_loss):
    """VQLPIPSWithDiscriminator with the perplexity log (n_classes), both
    pixel losses, the adaptive d_weight and the discriminator branch."""
    kw = dict(disc_start=0, disc_weight=0.6, disc_num_layers=2, codebook_weight=1.5,
              n_classes=16, pixel_loss=pixel_loss, disc_ndf=32)
    x, rec = _images(30), _images(31)
    rng = np.random.RandomState(32)
    ind = rng.randint(0, 16, (B, 4, 4))
    qloss = np.float32(0.37)
    tm = t_losses.VQLPIPSWithDiscriminator(**kw, device="cpu")
    variables = _pair(tm, seed=33)
    jm = j_losses.VQLPIPSWithDiscriminator(**kw)

    @jax.jit
    def jax_branches(v, x, rec, ind):
        nll_g = jax.grad(lambda r: jm.apply(v, x, r, method=jm.nll_loss)[0])(rec)
        g_g = jax.grad(lambda r: jm.apply(v, r, method=jm.g_loss))(rec)
        dw = j_losses.adaptive_d_weight(nll_g, g_g, jm.disc_weight)
        gen = jm.apply(v, qloss, x, rec, 7, dw, None, ind, method=jm.generator_loss)
        return gen, jm.apply(v, x, rec, 7, method=jm.discriminator_loss)

    gen_j, disc_j = jax_branches(variables, x, rec, ind)
    rt = _t(rec).requires_grad_()

    def d_weight(nll, g):
        a, = torch.autograd.grad(nll, rt, retain_graph=True)
        b, = torch.autograd.grad(g, rt, retain_graph=True)
        return t_losses.adaptive_d_weight(a, b, tm.disc_weight)

    loss, log = tm.generator_loss(torch.tensor(qloss), _t(x), rt, 7, d_weight, None,
                                  torch.from_numpy(ind))
    _close(loss, gen_j[0])
    _logs_close(log, gen_j[1])
    assert "train/perplexity" in log and "train/cluster_usage" in log
    d_loss, d_log = tm.discriminator_loss(_t(x), rt, 7)
    _close(d_loss, disc_j[0])
    _logs_close(d_log, disc_j[1])


# --------------------------------------------------------------- weights, targets
@pytest.mark.parametrize("layout", ["taming", "torchvision"])
def test_load_torch_lpips_weights_matches_jax(layout):
    """A torch checkpoint in either layout loads into the port's LPIPS as
    JAX's loader maps it into the flax tree."""
    tm = t_losses.LPIPS(device="cpu")
    variables = random_tree(flax_shapes_of(tm), seed=40)
    rng = np.random.RandomState(41)
    sd, cin = {}, 3
    idx = iter((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28))
    for b, widths in enumerate((64, 128, 256, 512, 512)):
        for _ in range((2, 2, 3, 3, 3)[b]):
            i = next(idx)
            key = (f"net.slice{1 + sum(i >= s for s in (4, 9, 16, 23))}.{i}"
                   if layout == "taming" else f"features.{i}")
            sd[f"{key}.weight"] = torch.from_numpy(rng.randn(widths, cin, 3, 3).astype(np.float32))
            sd[f"{key}.bias"] = torch.from_numpy(rng.randn(widths).astype(np.float32))
            cin = widths
        head = f"lin{b}.model.1.weight" if layout == "taming" else f"lins.{b}.model.1.weight"
        sd[head] = torch.from_numpy(rng.rand(1, widths, 1, 1).astype(np.float32))
    want = flax_to_state_dict(j_losses.load_torch_lpips_weights(variables["params"], sd))
    t_losses.load_torch_lpips_weights(tm, sd)
    got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_loss_targets():
    for target, cls in t_losses.LOSS_TARGETS.items():
        params = {"disc_start": 5}
        m = t_losses.build_loss({"target": target, "params": params}, device="meta")
        assert type(m) is cls and m.disc_start == 5
    with pytest.raises(NotImplementedError, match="DummyLoss"):
        t_losses.build_loss({"target": "ldm.modules.losses.contperceptual.DummyLoss"},
                            device="meta")


# --------------------------------------------------------------- full width
@gc_paused()
@pytest.mark.parametrize("name", ["vq-f8", "kl-f8"])
def test_full_width_trainable_trees_on_meta(name):
    """The zoo entry's trainable form (`_fs_train_config`, as the config's)
    built on the meta device by `build_autoencoder`: the autoencoder's and
    the loss's parameters have the names and shapes of `jax.eval_shape` of
    the JAX init at 256^2."""
    from ealdm_tpu.config import instantiate_from_config
    from ealdm_tpu.models.ddpm import build_first_stage as jax_first_stage
    from ealdm_tpu.zoo import _fs_train_config as jax_train_config

    cfg = zoo._fs_train_config(name)
    assert cfg == jax_train_config(name)
    want_cfg = {"vq-f8": t_config.VQ_F8_AE_TRAIN, "kl-f8": t_config.KL_F8_AE_TRAIN}[name]
    assert want_cfg["model"] == cfg and want_cfg["dtype"] == "float32"
    vae, loss = build_autoencoder(cfg, device="meta")
    jvae = jax_first_stage(cfg)
    jloss = instantiate_from_config(cfg["params"]["lossconfig"])
    x = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    if name.startswith("kl"):
        ae_shapes = jax.eval_shape(lambda r, x: jvae.init({"params": r}, x, r), key, x)

        def loss_init(r, x):
            post = JaxGaussian.from_moments(jnp.zeros((1, 32, 32, 8)))
            return jloss.init({"params": r}, x, x, post, 0)
    else:
        ae_shapes = jax.eval_shape(lambda r, x: jvae.init({"params": r}, x), key, x)

        def loss_init(r, x):
            return jloss.init({"params": r}, jnp.zeros(()), x, x, 0)
    loss_shapes = jax.eval_shape(loss_init, key, x)
    for module, shapes in ((vae, ae_shapes), (loss, loss_shapes)):
        # zero-stride stand-ins: the bridge's transposes run without the memory
        tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
        want = {k: tuple(np.shape(v)) for k, v in flax_to_state_dict(tree).items()}
        got = {k: tuple(p.shape) for k, p in module.named_parameters()}
        assert got == want
    assert sum(p.numel() for p in loss.discriminator.parameters()) == sum(
        np.prod(v.shape) for v in jax.tree_util.tree_leaves(loss_shapes["params"]["discriminator"]))
