"""The text transformer behind the BERT-style conditioning encoder
(counterpart of `ealdm_tpu/models/text_transformer.py`).

lucidrains' x_transformer TransformerWrapper + Encoder AttentionLayers at the
BERTEmbedder defaults (learned absolute positions, pre-norm ('a', 'f')
blocks of 64-wide heads with plain residuals, exact-GELU feed-forward, a
final LayerNorm, no logit head), with the Encoder's option surface:
ScaleNorm, RMSNorm, ReZero, GRU-gated residuals, GEGLU, macaron, sandwich,
position-infused attention, post-norm and residual attention.

The dtypes follow the flax modules: the embeddings and every norm keep
float32 (flax's LayerNorm has no `dtype`, so it returns float32 for a
bfloat16 input), each Dense computes in `dtype`. So the context this module
hands the UNet is float32 whatever `dtype` is. The attention is the plain
einsum form with a float32 softmax: the 77-token sequence is no flash site.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.tokenizer import VOCAB_ENV_VAR, WordPieceTokenizer, default_vocab_path
from .layers import Dense, Embed


class SimpleTokenizer:
    """WordPiece over the committed vocab when it fits `vocab_size`, else
    the md5 hash-bucket fallback; `__call__` returns int64 ids on the CPU."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3
    _RESERVED = 4

    def __init__(self, vocab_size: int = 30522, max_len: int = 77,
                 vocab_path: Optional[str] = None):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._encode_fn: Optional[Callable] = None
        self._wordpiece = None
        path = vocab_path or default_vocab_path()
        if not os.path.exists(path) and os.environ.get(VOCAB_ENV_VAR):
            # an explicitly configured vocab must not silently degrade to the
            # hash buckets (the ids would differ with no error)
            raise FileNotFoundError(
                f"{VOCAB_ENV_VAR} points at nonexistent vocab file {path!r}")
        if os.path.exists(path):
            wp = WordPieceTokenizer(path, max_len=max_len)
            if len(wp) <= vocab_size:
                self._wordpiece = wp
                self.PAD = wp.pad_id
            elif vocab_path is not None or os.environ.get(VOCAB_ENV_VAR):
                raise ValueError(
                    f"vocab file {path!r} has {len(wp)} entries, exceeding the "
                    f"model's vocab_size={vocab_size}; refusing to silently "
                    "fall back to hash-bucket token ids")

    def set_encode_fn(self, fn: Callable[[str], Sequence[int]]):
        self._encode_fn = fn

    def _bucket(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return self._RESERVED + h % (self.vocab_size - self._RESERVED)

    def encode(self, text: str) -> list:
        if self._encode_fn is not None:
            return list(self._encode_fn(text))[: self.max_len]
        if self._wordpiece is not None:
            return self._wordpiece.encode(text)
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        return [self.BOS] + [self._bucket(w) for w in words][: self.max_len - 2] + [self.EOS]

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        out = np.full((len(texts), self.max_len), self.PAD, np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return torch.from_numpy(out)


class LayerNormF32(nn.Module):
    """flax nn.LayerNorm without `dtype`: float32 statistics, float32 out."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)


class ScaleNormX(nn.Module):
    """x_transformer ScaleNorm: the L2 norm scaled by dim^-0.5, one gain."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.dim**-0.5
        return x / n.clamp(min=self.eps) * self.g


class RMSNormX(nn.Module):
    """x_transformer RMSNorm: ScaleNorm's normaliser, a gain per channel."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        n = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.dim**-0.5
        return x / n.clamp(min=self.eps) * self.g


class RezeroGate(nn.Module):
    """The ReZero gate on the attention branch: a zero-initialised scalar."""

    def __init__(self):
        super().__init__()
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x * self.g


class GRUGate(nn.Module):
    """x_transformer GRUGating: a GRU cell with the branch output as input and
    the residual stream as hidden state; gate chunks in torch's r, z, n order."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.gru_ih = Dense(dim, 3 * dim, dtype=dtype)
        self.gru_hh = Dense(dim, 3 * dim, dtype=dtype)

    def forward(self, out, residual):
        ri, zi, ni = self.gru_ih(out).chunk(3, dim=-1)
        rh, zh, nh = self.gru_hh(residual).chunk(3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        n = torch.tanh(ni + r * nh)
        return (1.0 - z) * n + z * residual


def fixed_positional_embedding(n: int, dim: int, dtype=torch.float32, device=None):
    """The x_transformer sinusoid: [n, dim], the sin block then the cos block."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                             device=device) / dim))
    s = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv_freq[None]
    return torch.cat([torch.sin(s), torch.cos(s)], dim=-1).to(dtype)


class XAttention(nn.Module):
    """x_transformer Attention: bias-free q/k/v to heads * dim_head, the
    scaled dot product with a float32 softmax, `to_out` back to dim (with
    bias). `sinusoid` is added to the q and k inputs (position-infused);
    `prev_attn` (pre-softmax logits of the previous attention layer) to the
    logits (residual attention)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_k = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_v = Dense(dim, inner, use_bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x, context=None, sinusoid=None, prev_attn=None):
        """(output, pre-softmax logits)."""
        kv = x if context is None else context
        q_in, k_in = x, kv
        if sinusoid is not None:
            q_in = q_in + sinusoid[None, : q_in.shape[1]]
            k_in = k_in + sinusoid[None, : k_in.shape[1]]
        q, k, v = self.to_q(q_in), self.to_k(k_in), self.to_v(kv)
        b, n, inner = q.shape
        m = k.shape[1]

        def split(t, length):
            return t.reshape(b, length, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = split(q, n), split(k, m), split(v, m)
        dots = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head**-0.5
        if prev_attn is not None:
            dots = dots + prev_attn
        attn = torch.softmax(dots.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, inner)
        return self.to_out(out), dots


class XFeedForward(nn.Module):
    """x_transformer FeedForward: Linear -> exact GELU -> Linear, or GEGLU."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, dtype=torch.float32):
        super().__init__()
        inner = dim * mult
        self.glu = glu
        self.ff_in = Dense(dim, inner * 2 if glu else inner, dtype=dtype)
        self.ff_out = Dense(inner, dim, dtype=dtype)

    def forward(self, x):
        h = self.ff_in(x)
        if self.glu:
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate)
        else:
            h = F.gelu(h)
        return self.ff_out(h)


def layer_types_for(depth: int, macaron: bool = False, sandwich_coef: Optional[int] = None):
    """The layer-type sequence: ('a', 'f') blocks, macaron's ('f', 'a', 'f'),
    sandwich front-loading attention."""
    block = ("f", "a", "f") if macaron else ("a", "f")
    if sandwich_coef is not None:
        if not 0 < sandwich_coef <= depth:
            raise ValueError(f"sandwich coefficient {sandwich_coef} not in 1..{depth}")
        return ("a",) * sandwich_coef + block * (depth - sandwich_coef) + ("f",) * sandwich_coef
    return block * depth


class TextTransformer(nn.Module):
    """Token ids [B, L] -> embeddings [B, L, dim] (float32). Layer j is named
    `layer_<i>_attn` or `layer_<i>_ff` (i counting each type), with its norm
    `<name>_norm`, ReZero gate `<name>_rezero` and GRU gate `<name>_gate`,
    as the flax module names them."""

    def __init__(self, vocab_size: int, max_len: int, dim: int, depth: int,
                 heads: int = 8, dim_head: int = 64, use_scalenorm: bool = False,
                 use_rmsnorm: bool = False, use_rezero: bool = False,
                 gate_residual: bool = False, ff_glu: bool = False, macaron: bool = False,
                 sandwich_coef: Optional[int] = None, position_infused_attn: bool = False,
                 pre_norm: bool = True, residual_attn: bool = False, dtype=torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.use_rezero, self.gate_residual = use_rezero, gate_residual
        self.macaron, self.pre_norm = macaron, pre_norm
        self.position_infused_attn, self.residual_attn = position_infused_attn, residual_attn
        self.token_emb = Embed(vocab_size, dim)
        if not position_infused_attn:
            self.pos_emb = Embed(max_len, dim)
        self.layers = []  # (type, name) in execution order
        counts = {"a": 0, "f": 0}
        types = layer_types_for(depth, macaron, sandwich_coef)
        for j, lt in enumerate(types):
            name = f"layer_{counts[lt]}_{'attn' if lt == 'a' else 'ff'}"
            counts[lt] += 1
            self.layers.append((lt, name))
            # a post-norm stack skips the last layer's norm (flax creates
            # no parameters for it)
            if not use_rezero and (pre_norm or j < len(types) - 1):
                if use_rmsnorm:
                    norm = RMSNormX(dim)
                elif use_scalenorm:
                    norm = ScaleNormX(dim)
                else:
                    norm = LayerNormF32(dim)
                self.add_module(f"{name}_norm", norm)
            if lt == "a":
                self.add_module(name, XAttention(dim, heads, dim_head, dtype))
                if use_rezero:
                    self.add_module(f"{name}_rezero", RezeroGate())
            else:
                self.add_module(name, XFeedForward(dim, glu=ff_glu, dtype=dtype))
            if gate_residual:
                self.add_module(f"{name}_gate", GRUGate(dim, dtype))
        self.norm = LayerNormF32(dim)

    def _norm(self, name, x):
        return x if self.use_rezero else getattr(self, f"{name}_norm")(x)

    def forward(self, tokens):
        b, n = tokens.shape
        x = self.token_emb(tokens)
        sinusoid = None
        if self.position_infused_attn:
            sinusoid = fixed_positional_embedding(n, self.dim, self.dtype, x.device)
            x = x.to(self.dtype)
        else:
            pos = self.pos_emb(torch.arange(n, device=x.device))
            x = (x + pos[None]).to(self.dtype)
        prev_attn = None
        for j, (lt, name) in enumerate(self.layers):
            residual = x
            h = self._norm(name, x) if self.pre_norm else x
            if lt == "a":
                out, pre = getattr(self, name)(h, sinusoid=sinusoid, prev_attn=prev_attn)
                if self.use_rezero:
                    out = getattr(self, f"{name}_rezero")(out)
                if self.residual_attn:
                    prev_attn = pre
            else:
                out = getattr(self, name)(h)
                if self.macaron:
                    out = 0.5 * out
            if self.gate_residual:
                x = getattr(self, f"{name}_gate")(out, residual)
            else:
                x = residual + out
            if not self.pre_norm and j < len(self.layers) - 1:
                x = self._norm(name, x)
        return self.norm(x)

