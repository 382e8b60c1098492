"""Conditioning encoders (counterpart of `ealdm_tpu/models/encoders.py`):
ClassEmbedder, TransformerEmbedder, BERTEmbedder, SpatialRescaler, the
frozen CLIP text and image embedders (`models/clip.py`), and
`build_encoder`, the registry of cond-stage targets.

The hybrid encoder is refused with the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import Conv2D
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


def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of `jax.image.resize(method="bilinear")`
    along one axis (antialias=True, no translation): the triangle kernel
    max(0, 1 - |x|) at the output samples' centres, widened by n_in / n_out
    when downsampling (a low-pass filter), each column renormalised to sum
    to 1 (the borders' cut-off taps), zero where a sample falls outside the
    input (`jax._src.image.scale.compute_weight_mat`)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_nhwc(x, size, method: str = "bilinear"):
    """`jax.image.resize` of an NHWC tensor to `size` = (H', W'): "nearest"
    takes input index floor((i + 0.5) * n_in / n_out); "bilinear" contracts
    each resized axis with `linear_resize_weights` in float32 (in x's dtype
    if that is wider)."""
    _, h, w, _ = x.shape
    if method == "nearest":
        for axis, (n_in, n_out) in ((1, (h, size[0])), (2, (w, size[1]))):
            if n_in != n_out:
                idx = np.floor(((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.float32))
                x = x.index_select(axis, torch.from_numpy(idx.astype(np.int64)).to(x.device))
        return x
    if not x.is_floating_point():
        x = x.float()
    for axis, (n_in, n_out) in ((1, (h, size[0])), (2, (w, size[1]))):
        if n_in != n_out:
            wm = torch.from_numpy(linear_resize_weights(n_in, n_out)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, wm, dims=([axis], [0])), -1, axis)
    return x


class SpatialRescaler(nn.Module):
    """n_stages rescales of NHWC maps by `multiplier` (`resize_nhwc`:
    bilinear with JAX's antialiasing, or nearest; the JAX module maps every
    other method name to bilinear), then an optional bias-free 1x1
    `channel_mapper` to out_channels."""

    _METHODS = ("nearest", "linear", "bilinear", "trilinear", "bicubic", "area")

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        if method not in self._METHODS:
            raise ValueError(f"unknown SpatialRescaler method {method!r}")
        self.n_stages, self.multiplier = n_stages, multiplier
        self.method = "nearest" if method == "nearest" else "bilinear"
        self.channel_mapper = (None if out_channels is None else
                               Conv2D(in_channels, out_channels, 1, dtype=dtype,
                                      use_bias=False))

    def forward(self, x):
        for _ in range(self.n_stages):
            _, h, w, _ = x.shape
            size = (max(int(h * self.multiplier), 1), max(int(w * self.multiplier), 1))
            x = resize_nhwc(x, size, self.method)
        if self.channel_mapper is not None:
            x = self.channel_mapper(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return x


# OpenAI CLIP release geometries (clip/model.py): version -> tower dims.
CLIP_VERSIONS = {
    # text: (width, layers, heads, embed); vision: (width, layers, heads,
    # patch, embed)
    "ViT-B/32": {"text": (512, 12, 8, 512), "vision": (768, 12, 12, 32, 512)},
    "ViT-B/16": {"text": (512, 12, 8, 512), "vision": (768, 12, 12, 16, 512)},
    "ViT-L/14": {"text": (768, 12, 12, 768),
                 "vision": (1024, 24, 16, 14, 768)},
}


def _l2_normalize(z):
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)


class FrozenCLIPTextEmbedder(nn.Module):
    """Token ids [B, L] -> the EOT-pooled CLIP text feature, L2-normalized,
    repeated to [B, n_repeat, n_embed]. `tokenize` runs the hermetic
    `SimpleTokenizer` on the host (ids on the CPU; the tower moves them to
    its device); the tower pools at its WordPiece end token (`sep_id`), or
    the hash buckets' EOS. Built on `device` (default "cuda", which raises
    without a card)."""

    def __init__(self, n_embed: int = 512, n_layer: int = 12, width: int = 512,
                 n_heads: int = 8, vocab_size: int = 49408, max_seq_len: int = 77,
                 n_repeat: int = 1, normalize: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        from .clip import CLIPTextTower

        self.n_repeat, self.normalize = n_repeat, normalize
        self.tokenizer = SimpleTokenizer(vocab_size, max_seq_len)
        eos = self.tokenizer.EOS
        if self.tokenizer._wordpiece is not None:
            eos = self.tokenizer._wordpiece.sep_id
        with torch.device(resolve_device(device)):
            self.model = CLIPTextTower(vocab_size=vocab_size, context_length=max_seq_len,
                                       width=width, layers=n_layer, heads=n_heads,
                                       embed_dim=n_embed, eot_id=eos, dtype=dtype)

    @classmethod
    def from_version(cls, version: str = "ViT-L/14", **kw):
        """The geometry of `clip.load(version)`."""
        w, l, h, e = CLIP_VERSIONS[version]["text"]
        return cls(n_embed=e, n_layer=l, width=w, n_heads=h, **kw)

    def tokenize(self, texts: Sequence[str]) -> torch.Tensor:
        return self.tokenizer(texts)

    def forward(self, tokens):
        z = self.model(tokens)
        if self.normalize:
            z = _l2_normalize(z)
        return z[:, None, :].repeat(1, self.n_repeat, 1)


class FrozenClipImageEmbedder(nn.Module):
    """[-1, 1] NHWC image -> `clip_preprocess` (resize, channel statistics)
    -> the ViT tower -> its L2-normalized [B, out_dim] embedding. The
    default geometry is ViT-B/32. Built on `device` (default "cuda", which
    raises without a card); the image must lie there."""

    def __init__(self, out_dim: int = 512, image_size: int = 224, patch_size: int = 32,
                 width: int = 768, n_layer: int = 12, n_heads: int = 12,
                 dtype=torch.float32, device=None):
        super().__init__()
        from .clip import CLIPVisionTower

        self.image_size = image_size
        with torch.device(resolve_device(device)):
            self.visual = CLIPVisionTower(image_size=image_size, patch_size=patch_size,
                                          width=width, layers=n_layer, heads=n_heads,
                                          embed_dim=out_dim, dtype=dtype)

    @classmethod
    def from_version(cls, version: str = "ViT-L/14", **kw):
        w, l, h, p, e = CLIP_VERSIONS[version]["vision"]
        return cls(out_dim=e, width=w, n_layer=l, n_heads=h, patch_size=p, **kw)

    def forward(self, x):
        from .clip import clip_preprocess

        if x.device != self.visual.proj.device:
            raise RuntimeError(f"image is on {x.device}, the embedder on "
                               f"{self.visual.proj.device}")
        return _l2_normalize(self.visual(clip_preprocess(x, self.image_size)))


# cond-stage targets of the JAX registry that a later slice ports
_NOT_PORTED = {"HybridConditioner": "ROADMAP queue 1 item 7"}


def build_encoder(target: str, params: Dict[str, Any], dtype=torch.float32, device=None):
    """The module of a cond-stage target, or None for `torch.nn.Identity`
    (a precomputed conditioning passed through unchanged). The CLIP
    embedders, which also serve alone as query encoders, are built on
    `device` (default "cuda"); the others on the ambient device."""
    name = target.rsplit(".", 1)[-1]
    if name == "ClassEmbedder":
        return ClassEmbedder(embed_dim=params["embed_dim"],
                             n_classes=params.get("n_classes", 1000))
    if name in ("BERTEmbedder", "TransformerEmbedder"):
        cls = BERTEmbedder if name == "BERTEmbedder" else TransformerEmbedder
        return cls(n_embed=params["n_embed"], n_layer=params["n_layer"],
                   vocab_size=params.get("vocab_size", 30522),
                   max_seq_len=params.get("max_seq_len", 77), dtype=dtype)
    if name == "SpatialRescaler":
        return SpatialRescaler(**params, dtype=dtype)
    if name == "FrozenCLIPTextEmbedder":
        kw = {k: params[k] for k in ("n_repeat", "normalize") if k in params}
        return FrozenCLIPTextEmbedder.from_version(params.get("version", "ViT-L/14"),
                                                   dtype=dtype, device=device, **kw)
    if name == "FrozenClipImageEmbedder":
        return FrozenClipImageEmbedder.from_version(params.get("model", "ViT-L/14"),
                                                    dtype=dtype, device=device)
    if name == "Identity":
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(f"cond stage {name} is not ported yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown cond stage target: {target}")
