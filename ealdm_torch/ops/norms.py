"""Normalization primitives (counterpart of `ealdm_tpu/ops/norms.py`).

`group_norm` on a CUDA tensor launches the fused GroupNorm kernels
(`kernels/csrc/group_norm.cu`, fp32 statistics) for the two layouts they
take: dense channels_last, which is what the model's convolutions hand every
norm, and NCHW-contiguous; on a CPU tensor it runs `group_norm_plain`, the
jnp formulation written in torch. On the card the kernel runs inside
`GroupNormKernel`, whose backward is the plain formulation's vjp
(`group_norm_vjp`), as the JAX package's `custom_vjp` does. Under a trace
its forward calls the dispatcher operator `ealdm::group_norm` (the launch,
with a fake that gives the output's shape, dtype and strides), so
`torch.export` records the launch by name; importing this module registers
it. An eager call launches directly (see `ops/attention.py`'s `_LIB`). The JAX package's
`set_norm_impl("xla"|"pallas")` switch has no counterpart: it trades XLA
scheduling, which eager PyTorch does not have.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import kernels
from ..kernels import build

__all__ = [
    "GroupNormKernel", "group_norm", "group_norm_kernel_layout", "group_norm_path",
    "group_norm_plain", "group_norm_vjp", "instance_norm_2d", "layer_norm",
    "resolve_num_groups", "set_norm_stats_precision", "silu",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# NCHW-contiguous: groups up to this many elements run the one-block kernel
# (kept in shared memory as fp32); larger ones the two-kernel path in chunks
# of _CHUNK.
_SINGLE_MAX_ELEMS = 32768
_CHUNK = 8192
# channels_last (the constants of `kernels/csrc/group_norm.cu`): a cluster of
# _CLUSTER CTAs takes a sample whose ceil(H*W / _CLUSTER) rows fit
# _SLICE_BYTES; larger samples take the two-read path in tiles of at most
# _TILE_BYTES.
_CLUSTER = 8
_SLICE_BYTES = 192 * 1024
_TILE_BYTES = 64 * 1024
# a channels_last block owns whole rows of 16-byte vectors, at most 512 threads
_CL_MAX_ROW_VECTORS = 512


def silu(x):
    return x * torch.sigmoid(x)


# Statistics precision of the plain formulations: "fp32" (default) or
# "native" (the compute dtype), as in the JAX package.
_NORM_STATS_DTYPE = "fp32"


def set_norm_stats_precision(mode: str):
    """mode: 'fp32' (default, training-grade) or 'native' (fast inference)."""
    global _NORM_STATS_DTYPE
    if mode not in ("fp32", "native"):
        raise ValueError(f"unknown norm stats precision {mode!r}")
    _NORM_STATS_DTYPE = mode


def _stats_dtype(x):
    return x.dtype if _NORM_STATS_DTYPE == "native" else torch.float32


def resolve_num_groups(c: int, num_groups: int) -> int:
    """Largest group count <= num_groups that divides c (tiny-channel safe)."""
    g = min(num_groups, c)
    while c % g != 0:
        g -= 1
    return g


def group_norm(x, scale, bias, num_groups=32, eps=1e-5, act=None,
               data_format: str = "NHWC", pre_bias=None):
    """GroupNorm of an NHWC (public, as ealdm_tpu) or NCHW-indexed (the
    port's internal indexing, channels_last in memory) tensor; optional fused
    act and a per-(sample, channel) `pre_bias` [N or 1, C] added to x before
    the statistics."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"unknown data_format {data_format!r}")
    c = x.shape[-1] if data_format == "NHWC" else x.shape[1]
    num_groups = resolve_num_groups(c, num_groups)
    if not x.is_cuda:
        return group_norm_plain(x, scale, bias, num_groups, eps, act,
                                data_format, pre_bias, _stats_dtype(x))
    if act not in (None, silu):
        raise ValueError("the GroupNorm kernel fuses SiLU only")
    xc = x if data_format == "NCHW" else x.permute(0, 3, 1, 2)
    y = GroupNormKernel.apply(
        xc,
        torch.ones(c, device=x.device) if scale is None else scale.float(),
        torch.zeros(c, device=x.device) if bias is None else bias.float(),
        pre_bias, num_groups, eps, act is silu,
    )
    return y if data_format == "NCHW" else y.permute(0, 2, 3, 1)


class GroupNormKernel(torch.autograd.Function):
    """`group_norm_kernel` with the JAX package's rematerialised backward
    (`_group_norm_pallas_bwd`): only the inputs are saved, and the backward
    is `group_norm_vjp`, the vjp of the plain formulation in float32."""

    @staticmethod
    def forward(ctx, x, scale, bias, pre_bias, num_groups, eps, fuse_silu):
        ctx.save_for_backward(x, scale, bias, pre_bias)
        ctx.config = (num_groups, eps, fuse_silu)
        if isinstance(x, FakeTensor):  # a trace records the operator
            return torch.ops.ealdm.group_norm.default(x, scale, bias, pre_bias, num_groups,
                                                      eps, fuse_silu)
        return group_norm_kernel(x, scale, bias, num_groups, eps, fuse_silu, pre_bias)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, pre_bias = ctx.saved_tensors
        grads = group_norm_vjp(x, scale, bias, pre_bias, g, *ctx.config)
        return (*grads, None, None, None)


# The launch as a dispatcher operator (see `ops/attention.py`'s `_LIB`): the
# CPU and CUDA kernels call `group_norm_kernel` by its module name, which
# raises on a CPU tensor.
_LIB = torch.library.Library("ealdm", "FRAGMENT")
_LIB.define("group_norm(Tensor x, Tensor scale, Tensor bias, Tensor? pre_bias, int num_groups, "
            "float eps, bool fuse_silu) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("group_norm",
              lambda x, scale, bias, pre_bias, num_groups, eps, fuse_silu: group_norm_kernel(
                  x, scale, bias, num_groups, eps, fuse_silu, pre_bias), _key)


@torch.library.register_fake("ealdm::group_norm", lib=_LIB)
def _group_norm_fake(x, scale, bias, pre_bias, num_groups, eps, fuse_silu):
    return torch.empty_like(x)  # y keeps x's layout


def group_norm_vjp(x, scale, bias, pre_bias, g, num_groups, eps, fuse_silu):
    """Gradients of the NCHW-indexed GroupNorm (+pre-bias)(+SiLU) for the
    output cotangent `g`: (dx, dscale, dbias, dpre_bias), each in its input's
    dtype (dpre_bias None without a pre-bias). The forward is recomputed
    through `group_norm_plain` with float32 statistics, as
    `ealdm_tpu.ops.norms._group_norm_pallas_bwd` does."""
    with torch.profiler.record_function("ealdm::group_norm_vjp"), torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, scale, bias)]
        if pre_bias is not None:
            inputs.append(pre_bias.detach().requires_grad_())
        y = group_norm_plain(*inputs[:3], num_groups, eps, silu if fuse_silu else None,
                             "NCHW", inputs[3] if pre_bias is not None else None)
        grads = torch.autograd.grad(y, inputs, g)
    return (*grads, None) if pre_bias is None else grads


def group_norm_plain(x, scale, bias, num_groups, eps, act=None,
                     data_format="NHWC", pre_bias=None, stats_dtype=torch.float32):
    """The plain formulation (ealdm_tpu `_group_norm_jnp`): variance as
    E[(x - mean)^2] in `stats_dtype`, affine, act, cast back."""
    in_dtype = x.dtype
    xf = x.to(stats_dtype)
    if data_format == "NHWC":
        n, h, w, c = x.shape
        if pre_bias is not None:
            xf = xf + pre_bias.to(stats_dtype)[:, None, None, :]
        xg = xf.reshape(n, h, w, num_groups, c // num_groups)
        axes = (1, 2, 4)
        cshape = (c,)
    else:
        n, c, h, w = x.shape
        if pre_bias is not None:
            xf = xf + pre_bias.to(stats_dtype)[:, :, None, None]
        xg = xf.reshape(n, num_groups, c // num_groups, h, w)
        axes = (2, 3, 4)
        cshape = (c, 1, 1)
    mean = xg.mean(axes, keepdim=True)
    var = torch.square(xg - mean).mean(axes, keepdim=True)
    xf = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if scale is not None:
        xf = xf * scale.to(stats_dtype).reshape(cshape)
    if bias is not None:
        xf = xf + bias.to(stats_dtype).reshape(cshape)
    if act is not None:
        xf = act(xf)
    return xf.to(in_dtype)


def group_norm_layout(x) -> str:
    """"channels_last" or "nchw": the layouts of a [N, C, H, W] tensor the
    GroupNorm kernels take (dense channels_last, as every tensor of the
    model's convolutions; NCHW-contiguous). Raises ValueError for any other
    strides."""
    if x.dim() == 4 and x.is_contiguous():
        return "nchw"
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    raise ValueError(f"the GroupNorm kernels take dense NCHW or channels_last "
                     f"[N, C, H, W], not strides {x.stride()} of {tuple(x.shape)}")


def group_norm_kernel_layout(shape, dtype, layout="channels_last") -> str:
    """The layout the kernels run a [N, C, H, W] tensor of `layout` in: its
    own, except channels_last rows wider than a block's 512 16-byte vectors
    (float32 C > 2048, bfloat16 C > 4096), which the NCHW kernels take
    through a layout copy each way."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if layout == "channels_last" and shape[1] * itemsize // 16 > _CL_MAX_ROW_VECTORS:
        return "nchw"
    return layout


def group_norm_path(shape, dtype, num_groups, layout="channels_last") -> str:
    """The kernel path, and launch counter, a [N, C, H, W] GroupNorm takes:
    "group_norm" (one read of x) or "group_norm_two_pass" (two reads).
    channels_last splits by the sample's bytes, NCHW by the group's
    elements."""
    _, c, h, w = shape
    if group_norm_kernel_layout(shape, dtype, layout) == "channels_last":
        itemsize = torch.empty((), dtype=dtype).element_size()
        fits = math.ceil(h * w / _CLUSTER) * c * itemsize <= _SLICE_BYTES
    else:
        fits = c // num_groups * h * w <= _SINGLE_MAX_ELEMS
    return "group_norm" if fits else "group_norm_two_pass"


def group_norm_kernel(x, scale, bias, num_groups, eps, fuse_silu, pre_bias=None):
    """Launch the GroupNorm kernels on a CUDA tensor indexed [N, C, H, W],
    dense channels_last or NCHW-contiguous (`group_norm_layout`); y keeps
    x's layout. scale/bias: fp32 [C]; pre_bias: [N or 1, C], cast to x's
    dtype. Raises on anything the kernels do not take."""
    if not x.is_cuda:
        raise ValueError("group_norm_kernel needs a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"GroupNorm kernel takes float32/bfloat16, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 [C] on {x.device}")
    layout = group_norm_layout(x)
    if group_norm_kernel_layout(x.shape, x.dtype, layout) != layout:
        y = group_norm_kernel(x.contiguous(), scale, bias, num_groups, eps, fuse_silu,
                              pre_bias)
        return y.contiguous(memory_format=torch.channels_last)
    if layout == "channels_last" and (x.data_ptr() % 16 or c * x.element_size() % 16):
        raise ValueError("the channels_last GroupNorm kernels take 16-byte aligned "
                         "tensors whose rows of C channels are multiples of 16 bytes")
    y = torch.empty_like(x)
    pre_ptr, psn, psc = None, 0, 0
    if pre_bias is not None:
        pre_bias = pre_bias.to(x.dtype)
        if (pre_bias.dim() != 2 or pre_bias.shape[1] != c
                or pre_bias.shape[0] not in (1, n) or pre_bias.device != x.device):
            raise ValueError(f"pre_bias must be [N or 1, C], got {tuple(pre_bias.shape)}")
        pre_ptr = pre_bias.data_ptr()
        psn = 0 if pre_bias.shape[0] == 1 else pre_bias.stride(0)
        psc = pre_bias.stride(1)
    lib = build.library("group_norm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = group_norm_path(x.shape, x.dtype, num_groups, layout)
    common = (_DTYPE_CODE[x.dtype], n, c, h * w, num_groups, psn, psc, float(eps),
              int(fuse_silu))
    ptrs = (x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), pre_ptr)
    if path == "group_norm":
        launch = lib.ealdm_group_norm_cl if layout == "channels_last" else lib.ealdm_group_norm
        err = launch(*ptrs, *common, stream)
    elif layout == "channels_last":
        tile_rows = _TILE_BYTES // (c * x.element_size())
        scratch = torch.empty(n * math.ceil(h * w / tile_rows) * 2 * num_groups,
                              dtype=torch.float32, device=x.device)
        err = lib.ealdm_group_norm_cl_two_read(*ptrs, scratch.data_ptr(), *common,
                                               tile_rows, stream)
    else:
        chunks = math.ceil(c // num_groups * h * w / _CHUNK)
        scratch = torch.empty(2 * n * num_groups * chunks, dtype=torch.float32,
                              device=x.device)
        err = lib.ealdm_group_norm_two_pass(*ptrs, scratch.data_ptr(), *common,
                                            _CHUNK, chunks, stream)
    build.check(err, f"{path} ({layout})")
    kernels.count_launch(path, (layout, tuple(x.shape), str(x.dtype).removeprefix("torch.")))
    return y


def instance_norm_2d(x, eps=1e-5):
    """Per-(sample, channel) spatial normalization of NHWC input (no affine)."""
    in_dtype = x.dtype
    xf = x.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = torch.square(xf - mean).mean((1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(in_dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis; stats follow set_norm_stats_precision."""
    in_dtype = x.dtype
    sd = _stats_dtype(x)
    xf = x.to(sd)
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        xf = xf * scale.to(sd)
    if bias is not None:
        xf = xf + bias.to(sd)
    return xf.to(in_dtype)
