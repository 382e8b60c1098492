"""The port's FIR resampling ops against the JAX package, on the CPU in
float32: setup_filter, upfirdn2d (the seven cases of tests/test_ops.py),
filter2d / upsample2d / downsample2d, filtered_lrelu, conv2d_resample and
grid_sample, with second-order gradients of the last three.

In the JAX package these are XLA convolutions and gathers; in the port,
depthwise `F.conv2d` and `torch.gather`. Sums run in another order: values
to rtol 1e-4 / atol 1e-5, second-order gradients (sums of products of those)
to 1e-4 of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import ops as T
from ealdm_tpu import ops as J

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _close_scaled(got, want, rel=1e-4):
    """Agreement within `rel` of the largest reference value."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("args", [
    dict(f=[1, 3, 3, 1]),
    dict(f=[1, 3, 3, 1], gain=4, flip_filter=True),
    dict(f=[1, 2, 3, 4, 4, 3, 2, 1]),
    dict(f=[[1, 2], [3, 4]], normalize=False, flip_filter=True),
    dict(f=[1, 3, 3, 1], separable=True, gain=2),
    dict(f=None),
])
def test_setup_filter_matches(args):
    _close(T.setup_filter(**args), J.setup_filter(**args), dict(rtol=0, atol=0))


@pytest.mark.parametrize("up,down,pad,sep", [
    (1, 1, 0, False),
    (2, 1, 1, False),
    (1, 2, 1, False),
    (2, 2, (1, 2, 0, 1), False),
    (2, 1, 2, True),
    (1, 2, 2, True),
    (1, 1, (-1, -1, -1, -1), False),
])
def test_upfirdn2d_matches(up, down, pad, sep):
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    f = (np.array([1.0, 3.0, 3.0, 1.0], np.float32) if sep
         else np.array([[1.0, 2.0], [2.0, 4.0]], np.float32))
    want = J.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down, padding=pad, gain=1.5)
    got = T.upfirdn2d(_t(x), _t(f), up=up, down=down, padding=pad, gain=1.5)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("op", ["filter2d", "upsample2d", "downsample2d"])
def test_fir_wrappers_match(op):
    x = np.random.RandomState(1).randn(1, 9, 10, 4).astype(np.float32)
    taps = [1, 3, 3, 1]
    want = getattr(J, op)(jnp.asarray(x), J.setup_filter(taps))
    got = getattr(T, op)(_t(x), T.setup_filter(taps))
    assert got.shape == want.shape
    _close(got, want)


def _flrelu_inputs(seed=2):
    rng = np.random.RandomState(seed)
    return rng.randn(2, 6, 6, 4).astype(np.float32), rng.randn(4).astype(np.float32)


FLRELU_KW = dict(up=2, down=2, padding=3, clamp=0.9)


def test_filtered_lrelu_matches():
    x, b = _flrelu_inputs()
    want = J.filtered_lrelu(jnp.asarray(x), J.setup_filter([1, 3, 3, 1]),
                            J.setup_filter([1, 3, 3, 1]), jnp.asarray(b), **FLRELU_KW)
    ft = T.setup_filter([1, 3, 3, 1])
    got = T.filtered_lrelu(_t(x), ft, ft, _t(b), **FLRELU_KW)
    assert got.shape == want.shape == (2, 6, 6, 4)
    _close(got, want)


def _second_order(jfn, tfn, *arrays):
    """grad of sum(grad(sum(fn(*a)^2))[0]^2) in every input, both packages."""
    def jf(*a):
        return jnp.sum(jfn(*a) ** 2)

    jgg = jax.grad(lambda *a: jnp.sum(jax.grad(jf)(*a) ** 2),
                   argnums=tuple(range(len(arrays))))(*arrays)
    ts = [_t(a).requires_grad_() for a in arrays]
    (g,) = torch.autograd.grad((tfn(*ts) ** 2).sum(), ts[0], create_graph=True)
    tgg = torch.autograd.grad((g ** 2).sum(), ts)
    for got, want in zip(tgg, jgg):
        _close_scaled(got, want)


def test_filtered_lrelu_second_order_grad():
    x, b = _flrelu_inputs(3)
    jf_, tf_ = J.setup_filter([1, 3, 3, 1]), T.setup_filter([1, 3, 3, 1])
    _second_order(lambda x, b: J.filtered_lrelu(x, jf_, jf_, b, **FLRELU_KW),
                  lambda x, b: T.filtered_lrelu(x, tf_, tf_, b, **FLRELU_KW), x, b)


C2R_CASES = [dict(up=1, down=1, padding=1), dict(up=2, down=1, padding=1),
             dict(up=1, down=2, padding=1), dict(up=2, down=2, padding=1, flip_weight=False),
             dict(up=1, down=1, padding=(1, 0), groups=2, flip_filter=True)]


@pytest.mark.parametrize("kw", C2R_CASES, ids=["plain", "up2", "down2", "up2_down2", "groups2"])
def test_conv2d_resample_matches(kw):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = (rng.randn(3, 3, 4 // kw.get("groups", 1), 6) / 6).astype(np.float32)
    want = J.conv2d_resample(jnp.asarray(x), jnp.asarray(w), J.setup_filter([1, 3, 3, 1]), **kw)
    got = T.conv2d_resample(_t(x), _t(w), T.setup_filter([1, 3, 3, 1]), **kw)
    assert got.shape == want.shape
    _close(got, want)


def test_conv2d_resample_second_order_grad():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 6, 6, 2).astype(np.float32)
    w = (rng.randn(3, 3, 2, 3) / 4).astype(np.float32)
    jf_, tf_ = J.setup_filter([1, 3, 3, 1]), T.setup_filter([1, 3, 3, 1])
    _second_order(lambda x, w: J.conv2d_resample(x, w, jf_, up=2, down=2, padding=1),
                  lambda x, w: T.conv2d_resample(x, w, tf_, up=2, down=2, padding=1), x, w)


def _grid_inputs(seed=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    # a margin beyond [-1, 1] so that some taps fall outside the image
    grid = rng.uniform(-1.2, 1.2, (2, 4, 6, 2)).astype(np.float32)
    return x, grid


def test_grid_sample_matches():
    x, grid = _grid_inputs()
    want = J.grid_sample(jnp.asarray(x), jnp.asarray(grid))
    got = T.grid_sample(_t(x), _t(grid))
    assert got.shape == (2, 4, 6, 3)
    _close(got, want)


def test_grid_sample_second_order_grad():
    """In x and in the grid: the gather/lerp form is twice differentiable
    (torch's own grid_sample backward is not)."""
    x, grid = _grid_inputs(7)
    _second_order(lambda g, x: J.grid_sample(x, g), lambda g, x: T.grid_sample(x, g), grid, x)
