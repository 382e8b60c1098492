"""The port's `bias_act` against the JAX package's, on the CPU in float32.

On the CPU the JAX op takes its `bias_act_ref` path (its Pallas kernel is
for the TPU only), and the port's wrapper runs `bias_act_plain`: both the
values and the gradients, first and second order, through the port's
autograd Function, are held against JAX's custom VJP.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import kernels

# the modules (each package's `ops.bias_act` attribute is the function)
t_ba = importlib.import_module("ealdm_torch.ops.bias_act")
j_ba = importlib.import_module("ealdm_tpu.ops.bias_act")

torch.set_num_threads(1)

ACTS = ["linear", "relu", "lrelu", "tanh", "sigmoid", "elu", "selu", "softplus", "swish"]
# float32 on both sides; exp/tanh/log1p may round an ulp apart: 1e-5.
TOL = dict(rtol=1e-5, atol=1e-5)
# The second-order gradient sums products of those: 1e-4.
TOL2 = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(case, seed=0):
    """(x, b, kwargs) for a bias on the last dim, on dim 1, or on the last
    dim with gain and clamp."""
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(3, 6, 5, 8)).astype(np.float32)
    if case == "dim1":
        return x, rng.randn(6).astype(np.float32), dict(dim=1)
    b = rng.randn(8).astype(np.float32)
    if case == "gain_clamp":
        return x, b, dict(dim=-1, gain=1.7, clamp=1.1)
    return x, b, dict(dim=-1)


@pytest.mark.parametrize("case", ["last", "dim1", "gain_clamp"])
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_jax(act, case):
    x, b, kw = _inputs(case)
    want = j_ba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, **kw)
    got = t_ba.bias_act(_t(x), _t(b), act=act, **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(t_ba.bias_act_plain(_t(x), _t(b), act=act, **kw).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_grads_match_jax(act):
    """The construction of tests/test_ops.py's second-order test: f =
    sum(bias_act(x, b)^2), its gradient in x, and the gradient of
    sum(grad^2) in x and b."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    b = (0.5 * rng.randn(16)).astype(np.float32)
    kw = dict(act=act, clamp=1.5 if act == "linear" else None)

    def jf(x, b):
        return jnp.sum(j_ba.bias_act(x, b, **kw) ** 2)

    jg = jax.grad(jf)(x, b)
    jgg_x, jgg_b = jax.grad(lambda x, b: jnp.sum(jax.grad(jf)(x, b) ** 2),
                            argnums=(0, 1))(x, b)

    xt, bt = _t(x).requires_grad_(), _t(b).requires_grad_()
    f = (t_ba.bias_act(xt, bt, **kw) ** 2).sum()
    (g,) = torch.autograd.grad(f, xt, create_graph=True)
    gg_x, gg_b = torch.autograd.grad((g ** 2).sum(), (xt, bt))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(gg_x.numpy(), np.asarray(jgg_x), **TOL2)
    np.testing.assert_allclose(gg_b.numpy(), np.asarray(jgg_b), **TOL2)


def test_bias_act_grad_of_bias_alone():
    """Only b needs a gradient: the backward differentiates b alone."""
    rng = np.random.RandomState(2)
    x, b = rng.randn(5, 4).astype(np.float32), rng.randn(4).astype(np.float32)
    bt = _t(b).requires_grad_()
    (db,) = torch.autograd.grad(t_ba.bias_act(_t(x), bt, act="tanh").sum(), bt)
    want = jax.grad(lambda b: jnp.sum(j_ba.bias_act(x, b, act="tanh")))(b)
    np.testing.assert_allclose(db.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bias_act_plain_rounds_once(dtype):
    """A 16-bit input is computed in float32 and rounded once to its dtype."""
    x, b, kw = _inputs("gain_clamp")
    xt = _t(x).to(dtype)
    got = t_ba.bias_act(xt, _t(b), act="swish", **kw)
    want = t_ba.bias_act_plain(xt.float(), _t(b), act="swish", **kw).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_bias_act_defaults_match_jax():
    for name, spec in t_ba.activation_funcs.items():
        jspec = j_ba.activation_funcs[name]
        assert (spec.def_alpha, spec.def_gain) == (jspec.def_alpha, jspec.def_gain), name


def test_bias_act_kernel_wrapper_refuses_cpu_and_bad_bias():
    """The kernel entry point raises on a CPU tensor; the public op on a
    CPU tensor runs the plain version and launches nothing."""
    x = torch.zeros(2, 8)
    before = kernels.launches["bias_act"]
    with pytest.raises(ValueError):
        t_ba.bias_act_kernel(x, torch.zeros(8))
    t_ba.bias_act(x, torch.zeros(8), act="lrelu")
    assert kernels.launches["bias_act"] == before
    with pytest.raises(ValueError, match="does not match"):
        t_ba.bias_act(x, torch.zeros(3))
    with pytest.raises(ValueError, match="NaN"):
        t_ba.bias_act(x, None, clamp=float("nan"))


def test_dense_strides():
    """The kernel takes any dense layout (e.g. an NHWC view of NCHW memory)
    and refuses gaps."""
    assert t_ba._dense(torch.zeros(2, 3, 4, 5).permute(0, 2, 3, 1))
    assert t_ba._dense(torch.zeros(2, 1, 4)[:, :, :])
    assert not t_ba._dense(torch.zeros(4, 6)[:, :3])
    assert not t_ba._dense(torch.zeros(4, 6)[::2])
