"""The backward of the port's GroupNorm and flash-attention kernels.

On the card `group_norm`, `flash_attention` and `flash_attention_packed` run
their kernels inside autograd Functions whose backward recomputes the plain
formulation and takes its vjp, as the JAX package's `custom_vjp`s do. Here on
the CPU: (i) the backward helpers against the JAX backward functions
themselves (`_group_norm_pallas_bwd`, `_flash_vjp_bwd`, `_packed_vjp_bwd`)
in float32, to 1e-5 of each gradient's largest element; (ii) each Function,
with its kernel replaced by the plain version, against autograd through that
plain version; and, under "dots" and "full" rematerialisation, its forward
running again in the backward (the kernel is recomputed, not saved).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.ops import attention as t_attn
from ealdm_torch.ops import norms as t_norms
from ealdm_torch.utils.remat import apply_remat
from ealdm_tpu.ops import attention as j_attn
from ealdm_tpu.ops import norms as j_norms

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_max(got, want, rel):
    """|got - want| <= rel * max|want|, element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    limit = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= limit, (err, limit)


def _gn_case(n, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(n, h, w, c) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    pre = rng.randn(n, c).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    return x, scale, bias, pre, g


def _nchw(a):  # NHWC numpy -> the port's NCHW-indexed tensor
    return _t(a).permute(0, 3, 1, 2)


# ------------------------------------------------------------------ (i)
@pytest.mark.parametrize("use_pre", [False, True])
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_group_norm_vjp_matches_jax_backward(use_pre, fuse_silu):
    """group_norm_vjp against `_group_norm_pallas_bwd` (HWNC) in float32."""
    x, scale, bias, pre, g = _gn_case(3, 4, 5, 64, seed=int(use_pre) + 2 * int(fuse_silu))
    hwnc = lambda a: jnp.transpose(jnp.asarray(a), (1, 2, 0, 3))  # noqa: E731
    want = j_norms._group_norm_pallas_bwd(
        32, 1e-5, fuse_silu,
        (hwnc(x), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(pre) if use_pre else None),
        hwnc(g))
    got = t_norms.group_norm_vjp(_nchw(x), _t(scale), _t(bias), _t(pre) if use_pre else None,
                                 _nchw(g), 32, 1e-5, fuse_silu)
    _close_to_max(got[0].permute(2, 3, 0, 1), want[0], 1e-5)
    for gt, gj in zip(got[1:3], want[1:3]):
        _close_to_max(gt, gj, 1e-5)
    if use_pre:
        _close_to_max(got[3], want[3], 1e-5)
    else:
        assert got[3] is None and want[3] is None


@pytest.mark.parametrize("shape_q,shape_kv", [((2, 3, 64, 32), (2, 3, 64, 32)),
                                              ((1, 1, 48, 512), (1, 1, 40, 512))])
def test_flash_attention_vjp_matches_jax_backward(shape_q, shape_kv):
    rng = np.random.RandomState(4)
    q, g = (rng.randn(*shape_q).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(*shape_kv).astype(np.float32) for _ in range(2))
    want = j_attn._flash_vjp_bwd(None, None, None, None, (q, k, v), g)
    got = t_attn.flash_attention_vjp(_t(q), _t(k), _t(v), _t(g))
    for gt, gj in zip(got, want):
        _close_to_max(gt, gj, 1e-5)


def test_flash_attention_packed_vjp_matches_jax_backward():
    rng = np.random.RandomState(5)
    heads = 4
    q, k, v, g = (rng.randn(2, 64, heads * 32).astype(np.float32) for _ in range(4))
    want = j_attn._packed_vjp_bwd(heads, None, None, None, (q, k, v), g)
    got = t_attn.flash_attention_vjp(_t(q), _t(k), _t(v), _t(g), heads=heads)
    for gt, gj in zip(got, want):
        _close_to_max(gt, gj, 1e-5)


# ------------------------------------------------------------------ (ii)
def _plain_group_norm_kernel(x, scale, bias, num_groups, eps, fuse_silu, pre_bias=None):
    """The kernel's function in torch (pre_bias in x's dtype, as the kernel
    takes it), standing in for the CUDA launch."""
    return t_norms.group_norm_plain(
        x, scale, bias, num_groups, eps, t_norms.silu if fuse_silu else None, "NCHW",
        None if pre_bias is None else pre_bias.to(x.dtype))


@pytest.fixture
def plain_kernels(monkeypatch):
    """Replace the three kernel launches by their plain versions and count
    the calls, so the Functions run on the CPU."""
    calls = {"group_norm": 0, "flash": 0, "packed": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(t_norms, "group_norm_kernel",
                        counted("group_norm", _plain_group_norm_kernel))
    monkeypatch.setattr(t_attn, "flash_attention_kernel",
                        counted("flash", t_attn.flash_attention_plain))

    def packed_plain(q, k, v, heads, scale=None):
        o = t_attn.flash_attention_plain(*(t_attn._split_heads(t, heads) for t in (q, k, v)),
                                         scale)
        return o.transpose(1, 2).reshape(q.shape)

    monkeypatch.setattr(t_attn, "flash_attention_packed_kernel", counted("packed", packed_plain))
    return calls


def _grads(fn, inputs, g):
    inputs = [t.clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("use_pre", [False, True])
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_group_norm_function_equals_plain_autograd(plain_kernels, use_pre, fuse_silu):
    x, scale, bias, pre, g = _gn_case(2, 4, 4, 64, seed=7)
    x = _nchw(x).contiguous(memory_format=torch.channels_last)
    inputs = [x, _t(scale), _t(bias)] + ([_t(pre)] if use_pre else [])

    def function(x, s, b, p=None):
        return t_norms.GroupNormKernel.apply(x, s, b, p, 32, 1e-5, fuse_silu)

    def plain(x, s, b, p=None):
        return _plain_group_norm_kernel(x, s, b, 32, 1e-5, fuse_silu, p)

    got = _grads(function, inputs, _nchw(g))
    want = _grads(plain, inputs, _nchw(g))
    assert plain_kernels["group_norm"] == 1
    for gt, gw in zip(got, want):
        _close_to_max(gt, gw, 1e-6)


def test_flash_functions_equal_plain_autograd(plain_kernels):
    rng = np.random.RandomState(8)
    q, k, v, g = (_t(rng.randn(2, 2, 64, 32).astype(np.float32)) for _ in range(4))
    got = _grads(lambda *a: t_attn.FlashAttention.apply(*a, None), [q, k, v], g)
    want = _grads(t_attn.flash_attention_plain, [q, k, v], g)
    for gt, gw in zip(got, want):
        _close_to_max(gt, gw, 1e-5)
    heads = 4
    qp, kp, vp, gp = (_t(rng.randn(2, 64, heads * 32).astype(np.float32)) for _ in range(4))
    got = _grads(lambda *a: t_attn.FlashAttentionPacked.apply(*a, heads, None),
                 [qp, kp, vp], gp)
    want = _grads(lambda *a: t_attn.flash_attention_plain(
        *(t_attn._split_heads(t, heads) for t in a)).transpose(1, 2).reshape(qp.shape),
        [qp, kp, vp], gp)
    for gt, gw in zip(got, want):
        _close_to_max(gt, gw, 1e-5)
    assert plain_kernels["flash"] == 1 and plain_kernels["packed"] == 1


@pytest.mark.parametrize("policy,runs", [("none", 1), ("dots", 2), ("full", 2)])
def test_kernel_forwards_rerun_under_remat(plain_kernels, policy, runs):
    """A conv -> GroupNorm Function -> linear -> flash Function chain under
    each policy: the same gradients, and under "dots" / "full" each kernel's
    forward runs once more in the backward (neither output is saved)."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(8, 32, 3, padding=1)
    lin = torch.nn.Linear(32, 96)

    def fn(x):
        h = t_norms.GroupNormKernel.apply(conv(x), torch.ones(32), torch.zeros(32), None,
                                          8, 1e-5, True)
        tokens = lin(h.flatten(2).transpose(1, 2))  # [B, 64, 96]
        q, k, v = (t.reshape(2, 64, 1, 32).transpose(1, 2) for t in tokens.chunk(3, -1))
        return t_attn.FlashAttention.apply(q, k, v, None).square().sum()

    x = torch.randn(2, 8, 8, 8)
    loss = apply_remat(fn, policy)(x)
    grads = torch.autograd.grad(loss, [conv.weight, lin.weight])
    assert plain_kernels["group_norm"] == runs and plain_kernels["flash"] == runs
    ref = torch.autograd.grad(fn(x), [conv.weight, lin.weight])
    for gt, gw in zip(grads, ref):
        torch.testing.assert_close(gt, gw, rtol=0, atol=1e-5 * gw.abs().max().item())
