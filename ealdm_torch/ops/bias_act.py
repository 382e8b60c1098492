"""Fused bias + activation + gain + clamp (counterpart of
`ealdm_tpu/ops/bias_act.py`).

`bias_act` is a `torch.autograd.Function`. Its forward launches the CUDA
kernel (`kernels/csrc/bias_act.cu`) on a CUDA tensor and runs
`bias_act_plain`, the same formula in torch, on a CPU tensor. Its backward
is the JAX package's `_bwd`: it recomputes through `bias_act_plain` in
differentiable torch, so second-order gradients work. The kernel takes any
dense tensor with the bias on any dim, in float32, bfloat16 or float16.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels import build

__all__ = ["activation_funcs", "bias_act", "bias_act_kernel", "bias_act_plain"]

_SQRT2 = math.sqrt(2.0)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class _ActSpec(NamedTuple):
    fn: object  # (x, alpha) -> y
    def_alpha: float
    def_gain: float
    code: int  # the kernel's activation code


def _selu(x, alpha):
    lam, a = 1.0507009873554805, 1.6732632423543772
    return lam * torch.where(x > 0, x, a * torch.expm1(x))


# The nine activations of the JAX package, with their default alpha and gain.
activation_funcs = {
    "linear": _ActSpec(lambda x, a: x, 0.0, 1.0, 0),
    "relu": _ActSpec(lambda x, a: torch.clamp_min(x, 0.0), 0.0, _SQRT2, 1),
    "lrelu": _ActSpec(lambda x, a: torch.where(x >= 0, x, x * a), 0.2, _SQRT2, 2),
    "tanh": _ActSpec(lambda x, a: torch.tanh(x), 0.0, 1.0, 3),
    "sigmoid": _ActSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0, 4),
    "elu": _ActSpec(lambda x, a: torch.where(x > 0, x, torch.expm1(x)), 0.0, 1.0, 5),
    "selu": _ActSpec(_selu, 0.0, 1.0, 6),
    "softplus": _ActSpec(lambda x, a: F.softplus(x), 0.0, 1.0, 7),
    "swish": _ActSpec(lambda x, a: x * torch.sigmoid(x), 0.0, _SQRT2, 8),
}


def _resolve(act: str, alpha, gain, clamp):
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    if math.isnan(clamp):
        raise ValueError("clamp is NaN")
    return spec, alpha, gain, clamp


def _bias_dim(x, b, dim) -> int:
    d = dim % x.dim()
    if b.dim() != 1 or b.shape[0] != x.shape[d]:
        raise ValueError(f"bias {tuple(b.shape)} does not match dim {dim} of "
                         f"{tuple(x.shape)}")
    return d


def bias_act_plain(x, b=None, dim=-1, act="linear", alpha=None, gain=None, clamp=None):
    """y = clamp(act(x + b[dim]) * gain, +-clamp), in float32, cast back to
    x's dtype (the JAX `bias_act_ref` formula)."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    y = x.float()
    if b is not None:
        shape = [1] * x.dim()
        shape[_bias_dim(x, b, dim)] = -1
        y = y + b.float().reshape(shape)
    y = spec.fn(y, alpha)
    if gain != 1:
        y = y * gain
    if clamp >= 0:
        y = torch.clamp(y, -clamp, clamp)
    return y.to(x.dtype)


def _dense(t) -> bool:
    """Whether `t`'s elements fill its storage span without gaps or overlap,
    in some order of its dims."""
    expect = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def bias_act_kernel(x, b=None, dim=-1, act="linear", alpha=None, gain=None, clamp=None):
    """Launch the bias_act kernel on a dense CUDA tensor x (float32, bfloat16
    or float16) with b a float32 [x.shape[dim]] on the same card, or None.
    Returns y with x's shape, strides and dtype. Raises on anything the
    kernel does not take."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    if not x.is_cuda:
        raise ValueError("bias_act_kernel needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the bias_act kernel takes float32/bfloat16/float16, not {x.dtype}")
    if not _dense(x):
        raise ValueError(f"x with strides {x.stride()} is not dense")
    y = torch.empty_like(x)
    if y.stride() != x.stride():
        raise ValueError(f"output strides {y.stride()} differ from x's {x.stride()}")
    c, inner, b_ptr = 1, 1, None
    if b is not None:
        d = _bias_dim(x, b, dim)
        if b.dtype != torch.float32 or b.device != x.device or not b.is_contiguous():
            raise ValueError(f"bias must be a contiguous float32 [C] on {x.device}")
        c = x.shape[d]
        inner = x.stride(d) if c > 1 else 1
        b_ptr = b.data_ptr()
    if x.numel() == 0:
        return y
    lib = build.library("bias_act")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib.ealdm_bias_act(x.data_ptr(), b_ptr, y.data_ptr(), _DTYPE_CODE[x.dtype],
                                   x.numel(), c, inner, spec.code, alpha, gain, clamp,
                                   stream), "bias_act")
    kernels.launches["bias_act"] += 1
    return y


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        ctx.args = (dim, act, alpha, gain, clamp)
        ctx.save_for_backward(x, b)
        if not x.is_cuda:
            return bias_act_plain(x, b, dim, act, alpha, gain, clamp)
        return bias_act_kernel(x, None if b is None else b.float().contiguous(),
                               dim, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, gy):
        # The vjp of the plain formula at the saved inputs, as JAX's `_bwd`.
        # Under create_graph the saved inputs carry their history, so the
        # result is differentiable again.
        x, b = ctx.saved_tensors
        need_x, need_b = ctx.needs_input_grad[:2]
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            xs = x if need_x else x.detach()
            bs = None if b is None else b if need_b else b.detach()
            y = bias_act_plain(xs, bs, *ctx.args)
            wrt = [t for t, need in ((xs, need_x), (bs, need_b)) if need]
            grads = iter(torch.autograd.grad(y, wrt, gy, create_graph=create_graph))
        dx = next(grads) if need_x else None
        db = next(grads) if need_b else None
        return dx, db, None, None, None, None, None


def bias_act(x, b=None, dim=-1, act="linear", alpha=None, gain=None, clamp=None):
    """Fused y = clamp(act(x + b[dim]) * gain, +-clamp), in x's dtype.
    Differentiable to any order."""
    return _BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
