"""ADM-style UNet denoiser (counterpart of `ealdm_tpu/models/unet.py`).

Public I/O is NHWC as in the JAX package (x [N, H, W, C] in, float32
[N, H, W, C] out); the internals run NCHW. Under `remat_blocks` each block
is a rematerialisation region of its own.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.embeddings import timestep_embedding
from ..ops.norms import silu
from ..utils.remat import apply_remat, check_policy
from .layers import (
    AttentionBlock,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    Upsample,
    conv3x3,
)

# Options of the JAX UNetModel that no ported configuration changes. They are
# accepted at these values only; each other branch comes with the
# configuration that needs it.
_FIXED_OPTIONS = dict(dropout=0.0, conv_resample=True, num_classes=None,
                      num_heads_upsample=-1, use_scale_shift_norm=False,
                      resblock_updown=False, legacy=True)


def _head_config(ch, num_heads, num_head_channels,
                 use_spatial_transformer) -> Tuple[int, int]:
    """(heads, dim_head) following the reference's rules with legacy=True."""
    heads = num_heads if num_head_channels == -1 else ch // num_head_channels
    dim_head = ch // heads if use_spatial_transformer else num_head_channels
    return heads, dim_head


class UNetModel(nn.Module):
    """`plan` lists the blocks in execution order as (kind, module name):
    "res", "attn" and "resample" run that module; "push" saves the current
    features as a skip, "pop" concatenates the last saved skip (name None)."""

    def __init__(
        self,
        image_size: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        num_heads: int = -1,
        num_head_channels: int = -1,
        use_spatial_transformer: bool = False,
        transformer_depth: int = 1,
        context_dim: Optional[int] = None,
        dtype=torch.float32,
        **options,
    ):
        super().__init__()
        for key, value in options.items():
            if key not in _FIXED_OPTIONS:
                raise TypeError(f"UNetModel has no option {key!r}")
            if value != _FIXED_OPTIONS[key]:
                raise NotImplementedError(f"UNetModel {key}={value!r} is not ported yet")
        if use_spatial_transformer and context_dim is None:
            raise ValueError("a SpatialTransformer UNet needs context_dim")
        if num_heads == -1 and num_head_channels == -1:
            raise ValueError("set num_heads or num_head_channels")
        self.model_channels = model_channels
        self.use_spatial_transformer = use_spatial_transformer
        self.transformer_depth = transformer_depth
        self.dtype = dtype
        self.remat = "none"
        self.plan = []

        emb_dim = model_channels * 4
        self.time_embed_0 = Dense(model_channels, emb_dim, dtype=dtype)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dtype)

        def add(kind, name, module):
            self.add_module(name, module)
            self.plan.append((kind, name))

        def res(name, cin, cout):
            add("res", name, ResBlock(cin, cout, emb_dim, dtype=dtype))

        def attn(name, ch, ds):
            heads, dim_head = _head_config(ch, num_heads, num_head_channels,
                                           use_spatial_transformer)
            if use_spatial_transformer:
                add("attn", name, SpatialTransformer(
                    ch, heads, dim_head, transformer_depth, context_dim,
                    tokens=(image_size // ds) ** 2, dtype=dtype))
            else:
                add("attn", name, AttentionBlock(ch, heads, dtype=dtype))

        skips = []

        def push(ch):
            self.plan.append(("push", None))
            skips.append(ch)

        self.conv_in = conv3x3(in_channels, model_channels, dtype)
        ch, ds = model_channels, 1
        push(ch)
        n_levels = len(channel_mult)
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                res(f"down_{level}_{i}_res", ch, mult * model_channels)
                ch = mult * model_channels
                if ds in attention_resolutions:
                    attn(f"down_{level}_{i}_attn", ch, ds)
                push(ch)
            if level != n_levels - 1:
                add("resample", f"down_{level}_down", Downsample(ch, dtype))
                push(ch)
                ds *= 2
        res("mid_res1", ch, ch)
        attn("mid_attn", ch, ds)
        res("mid_res2", ch, ch)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                self.plan.append(("pop", None))
                res(f"up_{level}_{i}_res", ch + skips.pop(), model_channels * mult)
                ch = model_channels * mult
                if ds in attention_resolutions:
                    attn(f"up_{level}_{i}_attn", ch, ds)
                if level and i == num_res_blocks:
                    add("resample", f"up_{level}_up", Upsample(ch, dtype))
                    ds //= 2
        self.out_norm = GroupNorm32(ch)
        self.out_conv = conv3x3(ch, out_channels, dtype)

    def forward(self, x, timesteps, context=None, context_kv=None, emb_tables=None):
        """x: [N, H, W, C_in]; timesteps: [N]; context: [N, L, context_dim].

        context_kv: {attn_site: ((k, v), ...)} precomputed cross-attn K/V
        (`precompute_context_kv`); emb_tables: {res_site: [out_ch]} this
        step's rows of `precompute_emb_tables`."""
        if emb_tables is not None:
            emb = None
        else:
            t_emb = timestep_embedding(timesteps, self.model_channels)
            emb = self.time_embed_2(silu(self.time_embed_0(t_emb)))

        def block(fn, *args, **kwargs):
            return apply_remat(fn, self.remat)(*args, **kwargs)

        h = self.conv_in(x.to(self.dtype).permute(0, 3, 1, 2))
        hs = []
        for kind, name in self.plan:
            if kind == "push":
                hs.append(h)
            elif kind == "pop":
                h = torch.cat([h, hs.pop()], dim=1)
            elif kind == "res":
                row = None if emb_tables is None else emb_tables[name]
                h = block(getattr(self, name), h, emb, emb_out=row)
            elif kind == "attn" and self.use_spatial_transformer:
                kv = None if context_kv is None else context_kv[name]
                h = block(getattr(self, name), h, context, kv=kv)
            else:
                h = block(getattr(self, name), h)
        h = block(self._out_head, h)
        return h.permute(0, 2, 3, 1).float().contiguous()

    def _out_head(self, h):
        return self.out_conv(self.out_norm(h, act=silu))

    @contextlib.contextmanager
    def remat_blocks(self, policy: str):
        """Within the context, each block of `plan` and the out head run as
        a region of their own under `policy` (`utils.remat`): the backward
        reruns one block when it reaches it, so one block's intermediates
        are live at a time."""
        saved, self.remat = self.remat, check_policy(policy)
        try:
            yield self
        finally:
            self.remat = saved


def unet_site_plan(unet: UNetModel):
    """(res_sites, attn_sites) module names in execution order; attn_sites
    lists SpatialTransformer sites only (the cross-attn hoisting targets)."""
    res_sites = [name for kind, name in unet.plan if kind == "res"]
    attn_sites = ([name for kind, name in unet.plan if kind == "attn"]
                  if unet.use_spatial_transformer else [])
    return res_sites, attn_sites


def precompute_context_kv(unet: UNetModel, context):
    """The cross-attn K/V projections of a step-constant context, once:
    {attn_site: ((k, v), ...) per transformer depth}, k/v [B, M, inner]."""
    _, attn_sites = unet_site_plan(unet)
    out = {}
    for site in attn_sites:
        st = getattr(unet, site)
        out[site] = tuple(
            (st.block(d).attn2.to_k(context), st.block(d).attn2.to_v(context))
            for d in range(unet.transformer_depth)
        )
    return out


def precompute_emb_tables(unet: UNetModel, timesteps):
    """The timestep MLP and every ResBlock's `emb_proj(silu(emb))` for all
    sampler timesteps at once: {res_site: [S, out_ch]}."""
    t_emb = timestep_embedding(timesteps, unet.model_channels)
    semb = silu(unet.time_embed_2(silu(unet.time_embed_0(t_emb))))
    res_sites, _ = unet_site_plan(unet)
    return {site: getattr(unet, site).emb_proj(semb) for site in res_sites}
