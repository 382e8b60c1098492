"""CLIP's text transformer and ViT image trunk (counterpart of
`ealdm_tpu/models/clip.py`), with OpenAI CLIP's architecture:

  * pre-LN residual blocks (eps 1e-5) around a packed-qkv multi-head
    attention (`attn.in_proj_weight` [3d, d], used as x @ W^T, and
    `attn.out_proj_*`) and a QuickGELU MLP (`mlp_c_fc`, `mlp_c_proj`);
  * text: token embedding + learned positional embedding, a causal mask
    (-inf above the diagonal, float32), `ln_final`, pooling at each
    sequence's end-of-text token, then `text_projection` ([width, embed],
    used as x @ P);
  * image (ViT): a bias-free patchify `conv1`, the class embedding
    prepended, the positional embedding, `ln_pre`, the transformer,
    `ln_post` on the class token, then `proj`.

The attention is the JAX module's dense form, explicit matmuls with a
float32 softmax: 77 and 257 tokens are no flash site in either package. The
dtypes follow the flax modules: every LayerNorm returns float32, the packed
projections compute in the wider of the input's dtype and `dtype` (jnp's
promotion), the MLP's Dense layers in `dtype`.

`load_torch_clip_state` reads an OpenAI CLIP or a Hugging Face CLIPModel
state dict into the towers' own parameter names (the JAX module's import
maps, in torch's layouts: no transposes but HF's projections).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .encoders import resize_nhwc
from .layers import Conv2D, Dense, Embed
from .text_transformer import LayerNormF32


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _promoted(x, dtype):
    """x in the dtype jnp gives `x @ w.astype(dtype)`."""
    return x.to(torch.promote_types(x.dtype, dtype))


class CLIPAttention(nn.Module):
    """torch.nn.MultiheadAttention with packed in_proj, as CLIP uses it:
    [B, N, width] -> [B, N, width], `mask` added to the logits."""

    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj_weight = nn.Parameter(torch.zeros(width, width))
        self.out_proj_bias = nn.Parameter(torch.zeros(width))

    def _linear(self, x, w, b):
        x = _promoted(x, self.dtype)
        return torch.nn.functional.linear(x, w.to(self.dtype).to(x.dtype),
                                          b.to(self.dtype).to(x.dtype))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = self._linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(hd)
        if mask is not None:
            logits = logits + mask
        attn = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        ct = torch.promote_types(attn.dtype, v.dtype)
        out = torch.matmul(attn.to(ct), v.to(ct)).transpose(1, 2).reshape(b, n, d)
        return self._linear(out, self.out_proj_weight, self.out_proj_bias)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = CLIPAttention(width, heads, dtype)
        self.ln_2 = LayerNormF32(width)
        self.mlp_c_fc = Dense(width, 4 * width, dtype=dtype)
        self.mlp_c_proj = Dense(4 * width, width, dtype=dtype)

    def forward(self, x, mask=None):
        h = self.attn(self.ln_1(x), mask)
        x = _promoted(x, h.dtype) + h
        h = self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))
        return x + h.to(x.dtype)


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"resblocks_{i}", ResidualAttentionBlock(width, heads, dtype))

    def forward(self, x, mask=None):
        for i in range(self.layers):
            x = getattr(self, f"resblocks_{i}")(x, mask)
        return x


def eot_positions(tokens, eot_id: Optional[int] = None):
    """[B] pooling positions: with `eot_id` None, each sequence's largest
    id (OpenAI's EOT 49407 is the vocab's last); else the first occurrence
    of `eot_id`, and the largest id where a sequence lacks it."""
    fallback = torch.argmax(tokens, dim=-1)
    if eot_id is None:
        return fallback
    is_eot = tokens == eot_id
    return torch.where(is_eot.any(dim=-1), torch.argmax(is_eot.int(), dim=-1), fallback)


class CLIPTextTower(nn.Module):
    """Token ids [B, L] -> [B, embed_dim] (unnormalized) CLIP text features."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512,
                 eot_id: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.eot_id, self.dtype = eot_id, dtype
        self.token_embedding = Embed(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = CLIPTransformer(width, layers, heads, dtype)
        self.ln_final = LayerNormF32(width)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens):
        tokens = tokens.to(self.positional_embedding.device)
        n = tokens.shape[1]
        x = self.token_embedding(tokens).to(self.dtype)
        x = x + self.positional_embedding[:n].to(self.dtype)
        mask = torch.triu(torch.full((n, n), float("-inf"), device=x.device), diagonal=1)
        x = self.ln_final(self.transformer(x, mask))
        x = x[torch.arange(x.shape[0], device=x.device), eot_positions(tokens, self.eot_id)]
        x = _promoted(x, self.dtype)
        return x @ self.text_projection.to(self.dtype).to(x.dtype)


class CLIPVisionTower(nn.Module):
    """NHWC image (CLIP-preprocessed) -> [B, embed_dim] visual features."""

    def __init__(self, image_size: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, embed_dim: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        grid = image_size // patch_size
        self.conv1 = Conv2D(3, width, patch_size, stride=patch_size, padding=0, dtype=dtype,
                            use_bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = LayerNormF32(width)
        self.transformer = CLIPTransformer(width, layers, heads, dtype)
        self.ln_post = LayerNormF32(width)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, x):
        x = self.conv1(x.permute(0, 3, 1, 2))
        b, c = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, c)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        x = self.transformer(self.ln_pre(x))
        x = _promoted(self.ln_post(x[:, 0]), self.dtype)
        return x @ self.proj.to(self.dtype).to(x.dtype)


# CLIP preprocessing channel statistics (clip/clip.py _transform)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(x, image_size: int = 224):
    """[-1, 1] NHWC -> CLIP-normalized NHWC at image_size^2: `resize_nhwc`'s
    bilinear, which antialiases when it shrinks, as `jax.image.resize`."""
    _, h, w, _ = x.shape
    x = (x + 1.0) / 2.0
    if (h, w) != (image_size, image_size):
        x = resize_nhwc(x, (image_size, image_size), "bilinear")
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


# ------------------------------------------------------------------ import
def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def _block_params(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """An OpenAI `ResidualAttentionBlock`'s tensors under the port's names."""
    names = {"attn.in_proj_weight": "attn.in_proj_weight",
             "attn.in_proj_bias": "attn.in_proj_bias",
             "attn.out_proj.weight": "attn.out_proj_weight",
             "attn.out_proj.bias": "attn.out_proj_bias",
             "ln_1.weight": "ln_1.weight", "ln_1.bias": "ln_1.bias",
             "ln_2.weight": "ln_2.weight", "ln_2.bias": "ln_2.bias",
             "mlp.c_fc.weight": "mlp_c_fc.weight", "mlp.c_fc.bias": "mlp_c_fc.bias",
             "mlp.c_proj.weight": "mlp_c_proj.weight", "mlp.c_proj.bias": "mlp_c_proj.bias"}
    return {f"{dst}.{to}": _tensor(sd[f"{src}.{frm}"]) for frm, to in names.items()}


def _hf_block_params(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """A Hugging Face `CLIPEncoderLayer` as a `ResidualAttentionBlock` (q, k
    and v packed into in_proj)."""
    attn = f"{src}.self_attn"
    out = {
        f"{dst}.attn.in_proj_weight": torch.cat(
            [_tensor(sd[f"{attn}.{x}_proj.weight"]) for x in "qkv"]),
        f"{dst}.attn.in_proj_bias": torch.cat(
            [_tensor(sd[f"{attn}.{x}_proj.bias"]) for x in "qkv"]),
        f"{dst}.attn.out_proj_weight": _tensor(sd[f"{attn}.out_proj.weight"]),
        f"{dst}.attn.out_proj_bias": _tensor(sd[f"{attn}.out_proj.bias"]),
    }
    for frm, to in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"), ("mlp.fc1", "mlp_c_fc"),
                    ("mlp.fc2", "mlp_c_proj")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{to}.{leaf}"] = _tensor(sd[f"{src}.{frm}.{leaf}"])
    return out


def _layers(sd, prefix: str, index: int) -> int:
    return len({k.split(".")[index] for k in sd if k.startswith(prefix)})


def _norm(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": _tensor(sd[f"{src}.weight"]),
            f"{dst}.bias": _tensor(sd[f"{src}.bias"])}


def _hf_text_params(sd) -> Dict[str, torch.Tensor]:
    base = "text_model"
    out = {"token_embedding.embedding": _tensor(sd[f"{base}.embeddings.token_embedding.weight"]),
           "positional_embedding": _tensor(sd[f"{base}.embeddings.position_embedding.weight"]),
           "text_projection": _tensor(sd["text_projection.weight"]).T.contiguous(),
           **_norm(sd, f"{base}.final_layer_norm", "ln_final")}
    for i in range(_layers(sd, f"{base}.encoder.layers.", 3)):
        out.update(_hf_block_params(sd, f"{base}.encoder.layers.{i}",
                                    f"transformer.resblocks_{i}"))
    return out


def _hf_vision_params(sd) -> Dict[str, torch.Tensor]:
    base = "vision_model"
    # HF's pre-LN attribute is (sic) `pre_layrnorm` in shipped checkpoints
    pre = (f"{base}.pre_layrnorm" if f"{base}.pre_layrnorm.weight" in sd
           else f"{base}.pre_layernorm")
    out = {"conv1.weight": _tensor(sd[f"{base}.embeddings.patch_embedding.weight"]),
           "class_embedding": _tensor(sd[f"{base}.embeddings.class_embedding"]),
           "positional_embedding": _tensor(sd[f"{base}.embeddings.position_embedding.weight"]),
           "proj": _tensor(sd["visual_projection.weight"]).T.contiguous(),
           **_norm(sd, pre, "ln_pre"), **_norm(sd, f"{base}.post_layernorm", "ln_post")}
    for i in range(_layers(sd, f"{base}.encoder.layers.", 3)):
        out.update(_hf_block_params(sd, f"{base}.encoder.layers.{i}",
                                    f"transformer.resblocks_{i}"))
    return out


def load_torch_clip_state(state_dict: Mapping[str, Any]
                          ) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                     Optional[Dict[str, torch.Tensor]]]:
    """An OpenAI CLIP or Hugging Face CLIPModel `state_dict()` -> (text,
    visual): state dicts of a `CLIPTextTower` and a `CLIPVisionTower` (ViT
    trunk) under the port's names, float32 on the host, to give to
    `load_state_dict`. Either half is None where the checkpoint lacks it
    (a text-only checkpoint, say)."""
    sd = state_dict
    text = visual = None
    if "token_embedding.weight" in sd:
        text = {"token_embedding.embedding": _tensor(sd["token_embedding.weight"]),
                "positional_embedding": _tensor(sd["positional_embedding"]),
                "text_projection": _tensor(sd["text_projection"]),
                **_norm(sd, "ln_final", "ln_final")}
        for i in range(_layers(sd, "transformer.resblocks.", 2)):
            text.update(_block_params(sd, f"transformer.resblocks.{i}",
                                      f"transformer.resblocks_{i}"))
    if "text_model.embeddings.token_embedding.weight" in sd:
        text = _hf_text_params(sd)
    if "vision_model.embeddings.patch_embedding.weight" in sd:
        visual = _hf_vision_params(sd)
    if "visual.conv1.weight" in sd:
        visual = {"conv1.weight": _tensor(sd["visual.conv1.weight"]),
                  "class_embedding": _tensor(sd["visual.class_embedding"]),
                  "positional_embedding": _tensor(sd["visual.positional_embedding"]),
                  "proj": _tensor(sd["visual.proj"]),
                  **_norm(sd, "visual.ln_pre", "ln_pre"),
                  **_norm(sd, "visual.ln_post", "ln_post")}
        for i in range(_layers(sd, "visual.transformer.resblocks.", 3)):
            visual.update(_block_params(sd, f"visual.transformer.resblocks.{i}",
                                        f"transformer.resblocks_{i}"))
    return text, visual
