"""UNet building blocks (counterpart of `ealdm_tpu/models/layers.py`).

Conv features are NCHW; token tensors are [B, N, C]. Submodules carry the
flax module names, and parameters the flax conventions translated once by
the bridge (`utils/flax_import.py`): Dense weights [out, in], conv weights
OIHW, norm scales as `weight`. As with flax `dtype=`, parameters stay fp32
and each layer computes in its `dtype`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    attention_impl,
    flash_attention,
    flash_attention_packed,
    sdpa,
    tiny_ctx_attention_packed,
)
from ..ops.norms import group_norm, layer_norm, silu

# Token count at/above which the flash kernel is used.
FLASH_MIN_TOKENS = 256


def flash_eligible(n: int, m: int) -> bool:
    """Self-attention sites the flash kernels take (the JAX routing
    predicate of `_attend` / `_flash_packed_eligible`, minus the device)."""
    return n >= FLASH_MIN_TOKENS and n == m and n % 256 == 0


class Dense(nn.Module):
    """flax nn.Dense: y = x @ W^T + b computed in `dtype`."""

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv2D(nn.Module):
    """2-D convolution on NCHW input with symmetric integer padding."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), self.stride, self.padding)


def conv3x3(cin, cout, dtype=torch.float32):
    return Conv2D(cin, cout, 3, dtype=dtype)


def conv1x1(cin, cout, dtype=torch.float32):
    return Conv2D(cin, cout, 1, dtype=dtype)


class LayerNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics on NCHW input; on CUDA tensors the
    fused GroupNorm kernel (optional pre-bias and SiLU)."""

    def __init__(self, c, num_groups=32, eps=1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, act=None, pre_bias=None):
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups,
                          eps=self.eps, act=act, data_format="NCHW",
                          pre_bias=pre_bias)


def upsample_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """2x nearest-neighbour upsample + 3x3 conv (`conv`)."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.conv = conv3x3(c, c, dtype)

    def forward(self, x):
        return self.conv(upsample_nearest(x))


class Downsample(nn.Module):
    """stride-2 3x3 conv with symmetric pad 1 (`op`)."""

    def __init__(self, c, dtype=torch.float32):
        super().__init__()
        self.op = Conv2D(c, c, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GroupNorm-SiLU-conv residual block with timestep-embedding injection
    (the JAX block with its defaults: no scale-shift norm, no resampling,
    a 1x1 conv on a channel-changing skip)."""

    def __init__(self, in_channels, out_channels, emb_channels, dtype=torch.float32):
        super().__init__()
        self.in_norm = GroupNorm32(in_channels)
        self.in_conv = conv3x3(in_channels, out_channels, dtype)
        self.emb_proj = Dense(emb_channels, out_channels, dtype=dtype)
        self.out_norm = GroupNorm32(out_channels)
        self.out_conv = conv3x3(out_channels, out_channels, dtype)
        self.skip = (conv1x1(in_channels, out_channels, dtype)
                     if out_channels != in_channels else None)

    def forward(self, x, emb, emb_out=None):
        """emb_out: optional precomputed `emb_proj(silu(emb))` [N, C] or a
        per-step row [C] broadcast over the batch (unet.precompute_emb_tables)."""
        h = self.in_conv(self.in_norm(x, act=silu))
        if emb_out is None:
            emb_out = self.emb_proj(silu(emb))
        elif emb_out.dim() == 1:
            emb_out = emb_out[None, :]
        # the embedding add is fused into the norm's statistics pass
        h = self.out_norm(h, act=silu, pre_bias=emb_out.to(h.dtype))
        h = self.out_conv(h)
        return (x if self.skip is None else self.skip(x)) + h


def _attend(q, k, v):
    """[B, H, N, D] attention: the flash kernel under the "flash"/"flash_packed"
    impls, on CUDA, at eligible self-attention sites; dense sdpa otherwise."""
    if (attention_impl() in ("flash", "flash_packed")
            and flash_eligible(q.shape[2], k.shape[2]) and q.is_cuda):
        return flash_attention(q, k, v)
    return sdpa(q, k, v)


def _flash_packed_eligible(q, n, m):
    return attention_impl() == "flash_packed" and flash_eligible(n, m) and q.is_cuda


class CrossAttention(nn.Module):
    """Multi-head attention on [B, N, C] tokens; self-attention when context
    is None."""

    def __init__(self, query_dim, context_dim, heads, dim_head, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Dense(query_dim, inner, use_bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, use_bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None, kv=None):
        """kv: optional precomputed (k, v) [B, M, inner] of a step-constant
        context (unet.precompute_context_kv); skips to_k/to_v."""
        b, n, _ = x.shape
        inner = self.heads * self.dim_head
        q = self.to_q(x)
        if kv is not None:
            k, v = kv
        else:
            context = x if context is None else context
            k, v = self.to_k(context), self.to_v(context)
        m = k.shape[1]
        if _flash_packed_eligible(q, n, m):
            out = flash_attention_packed(q, k, v, self.heads)
        elif (attention_impl() == "flash_packed"
              and m * self.heads <= 128 and n >= FLASH_MIN_TOKENS):
            out = tiny_ctx_attention_packed(q, k, v, self.heads)
        else:
            def split(t, length):
                return t.reshape(b, length, self.heads, self.dim_head).transpose(1, 2)

            out = _attend(split(q, n), split(k, m), split(v, m))
            out = out.transpose(1, 2).reshape(b, n, inner)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, 2 * dim_out, dtype=dtype)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")  # flax nn.gelu default


class FeedForward(nn.Module):
    """The gated (GEGLU) feed-forward, the only form the transformer uses."""

    def __init__(self, dim, mult=4, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.geglu = GEGLU(dim, inner, dtype)
        self.out_proj = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        return self.out_proj(self.geglu(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim, dtype=torch.float32):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype)
        self.ff = FeedForward(dim, dtype=dtype)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None, kv=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context, kv=kv) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Project NCHW features to h-major tokens, run transformer blocks,
    project back. `tokens` is the H*W this site runs at."""

    def __init__(self, in_channels, heads, dim_head, depth=1, context_dim=None,
                 tokens=None, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.tokens = tokens
        self.depth = depth
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = conv1x1(in_channels, inner, dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, heads, dim_head, context_dim, dtype=dtype))
        self.proj_out = conv1x1(inner, in_channels, dtype)

    def block(self, i) -> BasicTransformerBlock:
        return getattr(self, f"block_{i}")

    def forward(self, x, context=None, kv=None):
        """kv: optional per-depth precomputed cross-attn (k, v) pairs."""
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        for i in range(self.depth):
            x = self.block(i)(x, context=context, kv=None if kv is None else kv[i])
        x = x.reshape(b, h, w, inner).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in


class AttentionBlock(nn.Module):
    """QKV self-attention over flattened spatial positions (legacy head
    split: heads before the q/k/v split)."""

    def __init__(self, channels, num_heads=1, dtype=torch.float32):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        self.proj_out = Dense(channels, channels, dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        n, hd = h * w, c // self.num_heads
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, n, c)
        qkv = self.qkv(y).reshape(b, n, self.num_heads, 3 * hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        out = _attend(q, k, v).transpose(1, 2).reshape(b, n, c)
        out = self.proj_out(out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)
