"""Conditioning encoders (counterpart of `ealdm_tpu/models/encoders.py`):
ClassEmbedder, TransformerEmbedder and BERTEmbedder, and `build_encoder`,
the registry of cond-stage targets.

The spatial, hybrid and CLIP encoders are refused with the ROADMAP item
that ports them: the JAX `SpatialRescaler` resizes with `jax.image.resize`,
which antialiases when it downsamples (so `F.interpolate` is no
counterpart), and the CLIP embedders need `models/clip.py`.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from .text_transformer import Embed, SimpleTokenizer, TextTransformer


class ClassEmbedder(nn.Module):
    """Class ids [B] (or [B, ...], first column) -> [B, 1, embed_dim] float32."""

    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = Embed(n_classes, embed_dim)

    def forward(self, c):
        if c.dim() > 1:
            c = c[:, 0]
        return self.embedding(c)[:, None, :]


class TransformerEmbedder(nn.Module):
    """Token ids [B, L] -> [B, L, n_embed] through the text transformer."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, dtype=torch.float32):
        super().__init__()
        self.transformer = TextTransformer(vocab_size=vocab_size, max_len=max_seq_len,
                                           dim=n_embed, depth=n_layer, dtype=dtype)

    def forward(self, tokens):
        return self.transformer(tokens)


class BERTEmbedder(TransformerEmbedder):
    """Text -> cross-attention context. `tokenize` runs on the host (ids on
    the CPU; the caller moves them); the module takes ids."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, dtype=torch.float32):
        super().__init__(n_embed, n_layer, vocab_size, max_seq_len, dtype)
        self.tokenizer = SimpleTokenizer(vocab_size, max_seq_len)

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        return self.tokenizer(texts)


# cond-stage targets of the JAX registry that a later slice ports
_NOT_PORTED = {
    "SpatialRescaler": "ROADMAP queue 1 item 6 (its jax.image.resize antialiases "
                       "when it downsamples)",
    "HybridConditioner": "ROADMAP queue 1 item 6",
    "FrozenCLIPTextEmbedder": "ROADMAP queue 1 item 6 (needs models/clip.py)",
    "FrozenClipImageEmbedder": "ROADMAP queue 1 item 6 (needs models/clip.py)",
}


def build_encoder(target: str, params: Dict[str, Any], dtype=torch.float32):
    """The module of a cond-stage target, or None for `torch.nn.Identity`
    (a precomputed conditioning passed through unchanged)."""
    name = target.rsplit(".", 1)[-1]
    if name == "ClassEmbedder":
        return ClassEmbedder(embed_dim=params["embed_dim"],
                             n_classes=params.get("n_classes", 1000))
    if name in ("BERTEmbedder", "TransformerEmbedder"):
        cls = BERTEmbedder if name == "BERTEmbedder" else TransformerEmbedder
        return cls(n_embed=params["n_embed"], n_layer=params["n_layer"],
                   vocab_size=params.get("vocab_size", 30522),
                   max_seq_len=params.get("max_seq_len", 77), dtype=dtype)
    if name == "Identity":
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(f"cond stage {name} is not ported yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown cond stage target: {target}")
