"""Scaled-dot-product attention (counterpart of `ealdm_tpu/ops/attention.py`).

`flash_attention` ([B, H, N, D]) and `flash_attention_packed` ([B, N, H*D])
launch a hand-written kernel on CUDA tensors and run `flash_attention_plain`,
the same math in torch, on CPU tensors. The kernels run head dims that are
multiples of 8; the wrappers run any other d zero-padded to the next
multiple of 8, so every d runs, as the JAX kernel takes any d. bfloat16 up
to 1,920 runs on the tensor cores and rounds P to bfloat16 before P*V (as
the TPU's MXU does): `WGMMA_HEAD_DIMS` on the narrow wgmma/TMA kernel
(`kernels/csrc/flash_attention_sm90.cu`), `WIDE_WGMMA_HEAD_DIMS` on the
wide one (`kernels/csrc/flash_attention_sm90_wide.cu`),
`DEEP_WGMMA_HEAD_DIMS` on the deep one, a cluster of blocks that split the
head dim (`kernels/csrc/flash_attention_sm90_deep.cu`; no configuration's
bfloat16 path reaches d = 584 or above), the others on `mma.sync`
(`kernels/csrc/flash_attention.cu`). float32 at every d, and bfloat16 above
1,920, run `flash_tf32x3_kernel` (`kernels/csrc/flash_attention_sm90_f32.cu`):
both products on the tensor cores in split TF32 (hi*lo + lo*hi + hi*hi, about
1e-6 from float32 math), with a key split over blocks where the row blocks
leave SMs idle, its parts added by `flash_tf32x3_combine_kernel`. Every
kernel copies 16-byte pieces: the tensors must be 16-byte aligned with
strides in multiples of 16 bytes, else `ValueError`. Each launch
counts under `flash_counter(d, dtype=)` (per head dim, entry point and
float32 or not), and a combine under `COMBINE_COUNTER`.
On the card both run inside autograd Functions whose backward is the vjp of
the dense `sdpa` (`flash_attention_vjp`), as the JAX package's `custom_vjp`s
do. Under a trace each Function's forward calls a dispatcher operator,
`ealdm::flash_attention` or `ealdm::flash_attention_packed`, whose kernel
is the launch and whose fake gives the output's shape, dtype and strides,
so `torch.export` records the launch by name (`serving.py`); importing this
module registers them. An eager call launches directly.
`bf16_attention_shares` states the limits a bfloat16 kernel is held to
against the plain version. `sdpa` (the dense default) and
`tiny_ctx_attention_packed` are plain torch, as they are plain jnp in the
JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from .. import kernels
from ..kernels import build

__all__ = ["sdpa", "flash_attention", "flash_attention_packed",
           "flash_attention_plain", "flash_counter",
           "flash_attention_vjp", "bf16_attention_shares", "WGMMA_HEAD_DIMS",
           "WIDE_WGMMA_HEAD_DIMS", "DEEP_WGMMA_HEAD_DIMS", "deep_slices", "tf32x3_tiling",
           "COMBINE_COUNTER",
           "tiny_ctx_attention_packed", "set_attention_impl", "attention_impl"]

# "dense" (default), "flash" (the kernel at eligible self-attention sites) or
# "flash_packed" (the kernel on the projection-native [B, N, H*D] layout, plus
# the block-diagonal tiny-context cross-attention), as in the JAX package.
_ATTN_IMPL = "dense"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# bfloat16 head dims that run `flash_wgmma_narrow_kernel`
# (`kernels/csrc/flash_attention_sm90.cu`), `flash_wgmma_wide_kernel`
# (`kernels/csrc/flash_attention_sm90_wide.cu`) and `flash_wgmma_deep_kernel`
# (`kernels/csrc/flash_attention_sm90_deep.cu`), all wgmma and TMA;
# `flash_attention.cu` runs the others up to 32 (`flash_mma_narrow_kernel`).
# float32 at every d, and bfloat16 above 1,920, run `flash_tf32x3_kernel`
# (`kernels/csrc/flash_attention_sm90_f32.cu`, split TF32). These ranges,
# `deep_slices` and `tf32x3_tiling` are the routing: each C entry point
# refuses a head dim it is not routed.
WGMMA_HEAD_DIMS = range(40, 129, 8)
WIDE_WGMMA_HEAD_DIMS = range(136, 577, 8)
DEEP_WGMMA_HEAD_DIMS = range(584, 1921, 8)
# the launch counter of `flash_tf32x3_combine_kernel`, which adds the parts
# of a key split (the C entry point launches it after the flash kernel)
COMBINE_COUNTER = "flash_attention_combine"


def deep_slices(d: int):
    """(W, CS) of `flash_wgmma_deep_kernel` at head dim d (a multiple of
    8): each block of a cluster of CS keeps a depth slice of W columns.
    W = 512 (two blocks) where d is 776 .. 1,024, else 384 (two to five
    blocks, so d <= 1,920): the width that pads d less. The kernel takes W
    from here."""
    w = 512 if 768 < d <= 1024 else 384
    return w, -(-d // w)


def tf32x3_tiling(d: int, dtype=torch.float32):
    """(BK, WC, DW) of `flash_tf32x3_kernel` at head dim d (a multiple of
    8): tiles of BK keys, and row groups of 16 rows whose WC warps multiply
    DW columns each, so that a depth pass of S and a strip of O are WC * DW
    columns. float32: d <= 32, 64 and 128 on one warp of d rounded up; d <=
    160 on two of 80 and d <= 256 on two of 128; d = 513 .. 640 on four of
    160 with 24-key tiles; every other d on four of 128, in passes and
    strips of 512 above 640. bfloat16 (above 1,920) on eight of 128. The
    kernel takes the tiling from here (its entry point refuses a tiling it
    has no instance of), and `emulate_tf32x3` in the tests follows it."""
    if dtype == torch.bfloat16:
        return 32, 8, 128
    if d <= 64:
        return 64, 1, 32 if d <= 32 else 64
    if d <= 128:
        return 32, 1, 128
    if d <= 256:
        return (32, 2, 80) if d <= 160 else (32, 2, 128)
    return (24, 4, 160) if 512 < d <= 640 else (32, 4, 128)


def flash_counter(d: int, packed: bool = False, dtype: torch.dtype = torch.bfloat16) -> str:
    """The launch counter of the flash kernel at head dim `d`, for the
    [B, H, N, D] entry point or the packed one; float32 counts apart
    (`flash_attention_f32_d{d}`: it runs `flash_tf32x3_kernel`)."""
    f32 = "_f32" if dtype == torch.float32 else ""
    return f"flash_attention{'_packed' if packed else ''}{f32}_d{d}"


def set_attention_impl(mode: str):
    global _ATTN_IMPL
    if mode not in ("dense", "flash", "flash_packed"):
        raise ValueError(f"unknown attention impl {mode!r}")
    _ATTN_IMPL = mode


def attention_impl() -> str:
    return _ATTN_IMPL


def sdpa(q, k, v, scale=None):
    """Attention over [B, H, Nq, D] x [B, H, Nk, D] -> [B, H, Nq, D]; q and k
    are each pre-scaled by scale**0.5, softmax in fp32, weights cast to v's
    dtype before the second product (accumulated in fp32)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ss = math.sqrt(scale)
    logits = torch.matmul((q * ss).float(), (k * ss).float().transpose(-1, -2))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)


def flash_attention_plain(q, k, v, scale=None):
    """The kernel's math in torch: q * scale in fp32, fp32 softmax and fp32
    accumulation, output in q's dtype. [B, H, Nq, D] -> [B, H, Nq, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _split_heads(t, heads):
    """The [B, H, N, D] view of a packed [B, N, H*D] tensor."""
    b, n, hd = t.shape
    return t.reshape(b, n, heads, hd // heads).transpose(1, 2)


# bfloat16's unit roundoff: rounding to nearest with an 8-bit significand errs
# by at most 2^-8 of the value.
BF16_ROUNDOFF = 2**-8


def bf16_attention_shares(got, q, k, v, want, heads=None, scale=None,
                          p_rounding=BF16_ROUNDOFF):
    """How much of its two limits a bfloat16 kernel's output `got` uses
    against `want` = flash_attention_plain(q, k, v), on [B, H, N, D] tensors
    or, given `heads`, packed [B, N, H*D] ones: (the largest share of the
    per-element limit, the share of the RMS limit). Both must be <= 1.

    The kernel and the plain version compute in float32 and round once to
    bfloat16, which leaves them at most one ulp apart, and an ulp is at most
    2^-7 of the value: two ulps of each reference element plus 1e-4. The
    kernel also rounds P to bfloat16 before P*V, as the TPU's MXU does; the
    plain version keeps P in float32. Each p*v term errs by at most 2^-8 of
    itself, so |do_i| <= 2^-8 * sum_j p_ij |v_j| / l_i <= 2^-8 * max_j |v_j|
    (l_i sums the unrounded p): the per-element limit adds
    `p_rounding` * max|v| over the keys of each (batch, head).

    That worst case needs every error of a row to point one way, so a kernel
    with a much coarser P could pass it. The RMS limit holds the typical
    error: with each relative rounding error uniform on [-u, u] (variance
    u^2 / 3), P's rounding gives o_id a variance of
    u^2 / 3 * sum_j p_ij^2 v_jd^2 / l_i^2, and the two roundings of the output
    add at most 2 * u^2 / 3 * o_id^2. The RMS of got - want may be at most
    twice the root of their mean."""
    if heads is not None:
        got, q, k, v, want = (_split_heads(t, heads) for t in (got, q, k, v, want))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    want = want.float()
    diff = (got.float() - want).abs()
    vmax = v.float().abs().amax(dim=(2, 3), keepdim=True)
    elem = 2 * 2**-7 * want.abs() + 1e-4 + p_rounding * vmax
    p = torch.softmax(torch.matmul(q.float() * scale, k.float().transpose(-1, -2)), dim=-1)
    var = (p_rounding**2 * torch.matmul(p.square(), v.float().square())
           + 2 * BF16_ROUNDOFF**2 * want.square()) / 3
    rms_share = (diff.square().mean() / (4 * var.mean())).sqrt()
    return (diff / elem).max().item(), rms_share.item()


def flash_attention(q, k, v, scale=None):
    """Fused attention on [B, H, N, D] q and [B, H, M, D] k/v; on the card
    differentiable through `FlashAttention`."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    return FlashAttention.apply(q, k, v, scale)


def flash_attention_packed(q, k, v, heads, scale=None):
    """Fused attention on packed [B, Nq, H*D] q and [B, Nk, H*D] k/v (heads
    are column strips); returns [B, Nq, H*D]. On the card differentiable
    through `FlashAttentionPacked`."""
    if not q.is_cuda:
        o = flash_attention_plain(_split_heads(q, heads), _split_heads(k, heads),
                                  _split_heads(v, heads), scale)
        return o.transpose(1, 2).reshape(q.shape)
    return FlashAttentionPacked.apply(q, k, v, heads, scale)


class FlashAttention(torch.autograd.Function):
    """The kernel forward with the JAX package's rematerialised backward
    (`_flash_vjp_bwd`): q, k, v are saved, no scores, and the backward is
    `flash_attention_vjp`, the vjp of the dense `sdpa`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if isinstance(q, FakeTensor):  # a trace records the operator
            return torch.ops.ealdm.flash_attention.default(q, k, v, scale)
        return flash_attention_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_vjp(*ctx.saved_tensors, g, ctx.scale), None)


class FlashAttentionPacked(torch.autograd.Function):
    """`flash_attention_packed_kernel` with the backward of JAX's
    `_packed_vjp_bwd`: the vjp of `sdpa` on the split heads."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.config = (scale, heads)
        if isinstance(q, FakeTensor):
            return torch.ops.ealdm.flash_attention_packed.default(q, k, v, heads, scale)
        return flash_attention_packed_kernel(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_vjp(*ctx.saved_tensors, g, *ctx.config), None, None)


def flash_attention_vjp(q, k, v, g, scale=None, heads=None):
    """(dq, dk, dv) of attention for the output cotangent `g`, each in its
    input's dtype: the vjp of the dense `sdpa` recomputed from q, k, v, as
    `ealdm_tpu.ops.attention._flash_vjp_bwd` does. With `heads`, q/k/v/g are
    packed [B, N, H*D] (JAX's `_packed_vjp_bwd`)."""
    with torch.profiler.record_function("ealdm::flash_attention_vjp"), torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        if heads is None:
            o = sdpa(*inputs, scale)
        else:
            o = sdpa(*(_split_heads(t, heads) for t in inputs), scale)
            o = o.transpose(1, 2).reshape(q.shape)
        return torch.autograd.grad(o, inputs, g)


def flash_attention_kernel(q, k, v, scale=None):
    """Launch the flash kernel on CUDA [B, H, N, D] q and [B, H, M, D] k/v."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes [B, H, N, D] q/k/v")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    d = q.shape[3]
    _check_head_dim(d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d % 8:
        q, k, v = _pad_last(q, k, v)
    o = torch.empty_like(q)
    _launch(q, k, v, o, q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            [t.stride()[:3] for t in (q, k, v, o)], scale)
    kernels.count_launch(flash_counter(d, dtype=q.dtype), q.shape[2])
    return o[..., :d] if d % 8 else o


def flash_attention_packed_kernel(q, k, v, heads, scale=None):
    """Launch the flash kernel on CUDA packed [B, Nq, H*D] q and [B, Nk, H*D]
    k/v."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("flash_attention_packed takes [B, N, H*D] q/k/v")
    b, nq, hd = q.shape
    if hd % heads or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, heads {heads}")
    d = hd // heads
    _check_head_dim(d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d % 8:  # pad each head's columns: [B, N, H, d] -> [B, N, H * dp]
        q, k, v = (t.reshape(-1, heads, d) for t in (q, k, v))
        q, k, v = (t.reshape(b, -1, t.shape[1] * t.shape[2]) for t in _pad_last(q, k, v))
    dp = q.shape[2] // heads
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # (batch, head, row) strides of the packed view: heads are dp-column strips
    strides = [(t.stride(0), dp * t.stride(2), t.stride(1)) for t in (q, k, v, o)]
    _launch(q, k, v, o, b, heads, nq, k.shape[1], dp, strides, scale)
    kernels.count_launch(flash_counter(d, packed=True, dtype=q.dtype), nq)
    if d % 8:
        return o.reshape(b, nq, heads, dp)[..., :d].reshape(b, nq, hd)
    return o


# The launches as dispatcher operators (the low-level `torch.library` API: a
# `custom_op` costs more host time a call). A trace (`torch.export`, which
# hands the Functions fake tensors) records the operator; an eager call
# launches directly, since the operator's round trip into Python adds 7-10
# us of host time to every launch on the H100's host, slower in 10 of 10
# interleaved pairs (`chip_smoke.py --host`, `operator_cost`; PERF.md §6).
# The CPU and CUDA kernels both call the launch function by its module
# name, so a test or `chip_smoke.hold_sites` that swaps it sees every call;
# on a CPU tensor the launch raises.
_LIB = torch.library.Library("ealdm", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, float? scale) -> Tensor")
_LIB.define("flash_attention_packed(Tensor q, Tensor k, Tensor v, int heads, float? scale) "
            "-> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("flash_attention",
              lambda q, k, v, scale: flash_attention_kernel(q, k, v, scale), _key)
    _LIB.impl("flash_attention_packed",
              lambda q, k, v, heads, scale: flash_attention_packed_kernel(q, k, v, heads, scale),
              _key)


@torch.library.register_fake("ealdm::flash_attention", lib=_LIB)
def _flash_attention_fake(q, k, v, scale):
    d = q.shape[-1]
    if d % 8 == 0:
        return torch.empty_like(q)
    # the launch runs on zero-padded copies and returns a view of the first d columns
    return q.new_empty((*q.shape[:-1], d + (-d % 8)))[..., :d]


@torch.library.register_fake("ealdm::flash_attention_packed", lib=_LIB)
def _flash_attention_packed_fake(q, k, v, heads, scale):
    return q.new_empty(q.shape)


def _check_head_dim(d):
    if d < 1:
        raise ValueError(f"the flash kernels take head dims from 1, not {d}")


def _pad_last(*tensors):
    """Zero columns up to the next multiple of 8 of the last dim: they leave
    q k^T, and so the softmax, unchanged (the scale is the real d's), and
    the output's extra columns are zeros the caller drops."""
    d = tensors[0].shape[-1]
    return [F.pad(t, (0, -d % 8)) for t in tensors]


def _launch(q, k, v, o, b, h, nq, nk, d, strides, scale):
    if not q.is_cuda:
        raise ValueError("the flash kernel needs CUDA tensors")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32/bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d < 8 or d % 8:
        raise ValueError(f"the flash kernels run head dims that are multiples of 8, not {d}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k, v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v, o)):
        raise ValueError("the head dimension must be contiguous")
    _check_alignment((q, k, v, o), strides, (b, h, nq), (b, h, nk))
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    flat = [s for triple in strides for s in triple]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype == torch.float32 or d > DEEP_WGMMA_HEAD_DIMS[-1]:
        _launch_tf32x3(ptrs, q, b, h, nq, nk, d, flat, scale, stream)
        return
    # bfloat16 up to 1,920
    name = ("flash_attention_sm90" if d in WGMMA_HEAD_DIMS
            else "flash_attention_sm90_wide" if d in WIDE_WGMMA_HEAD_DIMS
            else "flash_attention_sm90_deep" if d in DEEP_WGMMA_HEAD_DIMS else None)
    if name is not None:
        width = (deep_slices(d)[0],) if name == "flash_attention_sm90_deep" else ()
        err = getattr(build.library(name), f"ealdm_{name}")(
            *ptrs, *width, b, h, nq, nk, d, *flat, float(scale), stream)
        build.check(err, name)
        return
    err = build.library("flash_attention").ealdm_flash_attention(
        *ptrs, _DTYPE_CODE[q.dtype], b, h, nq, nk, d, *flat, float(scale), stream)
    build.check(err, "flash_attention")


def _launch_tf32x3(ptrs, q, b, h, nq, nk, d, flat, scale, stream):
    """`flash_tf32x3_kernel`, with the key split its entry point asks for:
    KS > 1 takes an fp32 scratch for the parts (unnormalised O, and each
    row's max and sum), allocated here, and a second launch that adds them."""
    lib = build.library("flash_attention_sm90_f32")
    code = _DTYPE_CODE[q.dtype]
    tiling = tf32x3_tiling(d, q.dtype)
    splits = lib.ealdm_flash_attention_sm90_f32_splits(code, *tiling, b, h, nq, nk, d)
    if splits < 1:
        build.check(-splits, "flash_attention_sm90_f32 key split")
    part = ml = None
    if splits > 1:
        part = torch.empty(splits * b * h * nq * d, dtype=torch.float32, device=q.device)
        ml = torch.empty(splits * b * h * nq * 2, dtype=torch.float32, device=q.device)
    err = lib.ealdm_flash_attention_sm90_f32(
        *ptrs, None if part is None else part.data_ptr(), None if ml is None else ml.data_ptr(),
        splits, code, *tiling, b, h, nq, nk, d, *flat, float(scale), stream)
    build.check(err, "flash_attention_sm90_f32")
    if splits > 1:
        kernels.count_launch(COMBINE_COUNTER, nq)


def _check_alignment(tensors, strides, q_sizes, kv_sizes):
    """The kernels copy rows in 16-byte pieces: every base must be 16-byte
    aligned and every (batch, head, row) stride of a dimension longer than 1
    a multiple of 16 bytes (8 bfloat16 or 4 float32 elements)."""
    dtype = str(tensors[0].dtype).removeprefix("torch.")
    elems = 16 // tensors[0].element_size()
    for name, t, triple, sizes in zip("qkvo", tensors, strides,
                                      (q_sizes, kv_sizes, kv_sizes, q_sizes)):
        if t.data_ptr() % 16:
            raise ValueError(f"{dtype} flash attention needs 16-byte aligned "
                             f"tensors; {name} starts at {t.data_ptr() % 16} past")
        if any(s % elems for s, n in zip(triple, sizes) if n > 1):
            raise ValueError(f"{dtype} flash attention needs strides that are "
                             f"multiples of {elems} elements; {name} has {tuple(triple)}")


def tiny_ctx_attention_packed(q, k, v, heads, scale=None):
    """Cross-attention against a tiny context without re-laying-out q: per-head
    dots as two matmuls against block-diagonal K/V ([H*D, H*M] / [H*M, H*D]).
    q: [B, N, H*D]; k/v: [B, M, H*D]."""
    b, n, hd = q.shape
    m = k.shape[1]
    d = hd // heads
    if hd != heads * d:
        raise ValueError(f"{hd} columns do not split into {heads} heads")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    eye = torch.eye(heads, dtype=q.dtype, device=q.device)
    kr = k.reshape(b, m, heads, d)
    vr = v.reshape(b, m, heads, d)
    kbd = torch.einsum("bmhd,gh->bgdhm", kr, eye).reshape(b, hd, heads * m)
    vbd = torch.einsum("bmhd,gh->bgmhd", vr, eye).reshape(b, heads * m, hd)
    logits = torch.matmul((q * scale).float(), kbd.float())
    w = torch.softmax(logits.reshape(b, n, heads, m), dim=-1)
    w = w.reshape(b, n, heads * m).to(v.dtype)
    return torch.matmul(w.float(), vbd.float()).to(v.dtype)
