"""First stages (counterpart of `ealdm_tpu/models/vae.py`): the VQ models,
the KL autoencoder and the pixel-space identity.

Encoder, Decoder, VQModel and AutoencoderKL take and return NHWC tensors as
in the JAX package; their internals run NCHW. `attn_type` "vanilla" builds
the single-head attention blocks, "none" builds none (the identity, as the
reference's nn.Identity); the linear-attention block is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import silu
from ..utils.device import resolve_device
from .distributions import DiagonalGaussian
from .layers import Conv2D, GroupNorm32, _attend, conv1x1, conv3x3, upsample_nearest
from .quantize import VectorQuantizer


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VaeResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels=None, dtype=torch.float32):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = conv3x3(in_channels, out_channels, dtype)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = conv3x3(out_channels, out_channels, dtype)
        self.nin_shortcut = (conv1x1(in_channels, out_channels, dtype)
                             if out_channels != in_channels else None)

    def forward(self, x):
        h = self.conv1(self.norm1(x, act=silu))
        h = self.conv2(self.norm2(h, act=silu))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VaeAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1 q/k/v/out projections."""

    def __init__(self, channels, tokens=None, dtype=torch.float32):
        super().__init__()
        self.tokens = tokens
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = conv1x1(channels, channels, dtype)
        self.k = conv1x1(channels, channels, dtype)
        self.v = conv1x1(channels, channels, dtype)
        self.proj_out = conv1x1(channels, channels, dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, 1, H*W, C], h-major
            return _nhwc(t).reshape(b, 1, h * w, c)

        out = _attend(tokens(self.q(y)), tokens(self.k(y)), tokens(self.v(y)))
        return x + self.proj_out(_nchw(out.reshape(b, h, w, c)))


class VaeDownsample(nn.Module):
    """stride-2 conv after the VAE's asymmetric (0, 1) zero pad."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=0, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VaeUpsample(nn.Module):
    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = conv3x3(channels, channels, dtype)

    def forward(self, x):
        return self.conv(upsample_nearest(x))


def _attn_factory(attn_type: str):
    """The attention block of `attn_type` (`make_attn`): VaeAttnBlock for
    "vanilla", the identity for "none"."""
    if attn_type == "vanilla":
        return VaeAttnBlock
    if attn_type == "none":
        return lambda *args: nn.Identity()
    if attn_type == "linear":
        raise NotImplementedError("VaeLinAttnBlock (attn_type 'linear') is not ported yet: "
                                  "ROADMAP queue 1 item 7")
    raise ValueError(f"attn_type {attn_type!r} unknown")


class Encoder(nn.Module):
    def __init__(self, ch: int, z_channels: int, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, in_channels: int = 3, double_z: bool = False,
                 attn_type: str = "vanilla", dtype=torch.float32):
        super().__init__()
        attn = _attn_factory(attn_type)
        self.dtype = dtype
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = conv3x3(in_channels, ch, dtype)
        curr_res, block_in = resolution, ch
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            for i_block in range(num_res_blocks):
                self.add_module(f"down_{i_level}_block_{i_block}",
                                VaeResnetBlock(block_in, block_out, dtype))
                block_in = block_out
                if curr_res in attn_resolutions:
                    self.add_module(f"down_{i_level}_attn_{i_block}",
                                    attn(block_in, curr_res ** 2, dtype))
            if i_level != self.num_levels - 1:
                self.add_module(f"down_{i_level}_downsample",
                                VaeDownsample(block_in, dtype))
                curr_res //= 2
        self.mid_block_1 = VaeResnetBlock(block_in, dtype=dtype)
        self.mid_attn_1 = attn(block_in, curr_res ** 2, dtype)
        self.mid_block_2 = VaeResnetBlock(block_in, dtype=dtype)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = conv3x3(block_in, 2 * z_channels if double_z else z_channels, dtype)

    def forward(self, x):
        """x: [N, H, W, C] -> features [N, H/f, W/f, z] (2z with double_z)."""
        h = self.conv_in(_nchw(x.to(self.dtype)))
        for i_level in range(self.num_levels):
            for i_block in range(self.num_res_blocks):
                h = getattr(self, f"down_{i_level}_block_{i_block}")(h)
                attn = getattr(self, f"down_{i_level}_attn_{i_block}", None)
                if attn is not None:
                    h = attn(h)
            if i_level != self.num_levels - 1:
                h = getattr(self, f"down_{i_level}_downsample")(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        h = self.conv_out(self.norm_out(h, act=silu))
        return _nhwc(h)


class Decoder(nn.Module):
    def __init__(self, ch: int, out_ch: int, z_channels: int,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 attn_type: str = "vanilla", dtype=torch.float32):
        super().__init__()
        attn = _attn_factory(attn_type)
        self.dtype = dtype
        self.num_levels = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (self.num_levels - 1)
        self.conv_in = conv3x3(z_channels, block_in, dtype)
        self.mid_block_1 = VaeResnetBlock(block_in, dtype=dtype)
        self.mid_attn_1 = attn(block_in, curr_res ** 2, dtype)
        self.mid_block_2 = VaeResnetBlock(block_in, dtype=dtype)
        for i_level in reversed(range(self.num_levels)):
            block_out = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"up_{i_level}_block_{i_block}",
                                VaeResnetBlock(block_in, block_out, dtype))
                block_in = block_out
                if curr_res in attn_resolutions:
                    self.add_module(f"up_{i_level}_attn_{i_block}",
                                    attn(block_in, curr_res ** 2, dtype))
            if i_level != 0:
                self.add_module(f"up_{i_level}_upsample",
                                VaeUpsample(block_in, dtype))
                curr_res *= 2
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = conv3x3(block_in, out_ch, dtype)

    def forward(self, z):
        """z: [N, h, w, z_channels] -> [N, H, W, out_ch]."""
        h = self.conv_in(_nchw(z.to(self.dtype)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for i_level in reversed(range(self.num_levels)):
            for i_block in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i_level}_block_{i_block}")(h)
                attn = getattr(self, f"up_{i_level}_attn_{i_block}", None)
                if attn is not None:
                    h = attn(h)
            if i_level != 0:
                h = getattr(self, f"up_{i_level}_upsample")(h)
        return _nhwc(self.conv_out(self.norm_out(h, act=silu)))


# ddconfig options that no ported configuration changes, as (the JAX
# package's default, the one value the port accepts). `double_z` is the
# model's own: False for VQ, True for KL (the JAX AutoencoderKL asserts it).
# `attn_type` ("vanilla" or "none"; "linear" raises) is passed on.
_DD_FIXED = {"dropout": (0.0, 0.0),
             "resamp_with_conv": (True, True), "give_pre_end": (False, False),
             "tanh_out": (False, False), "use_linear_attn": (False, False)}


def _ddkwargs(ddconfig: dict, decoder: bool = False, double_z: bool = False,
              model: str = "VQModel") -> dict:
    fixed = {**_DD_FIXED, "double_z": (True, double_z)}
    for key, (default, ported) in fixed.items():
        value = ddconfig.get(key, default)
        if value != ported:
            raise NotImplementedError(f"{model} ddconfig {key}={value!r} is not ported yet")
    keys = ["ch", "ch_mult", "num_res_blocks", "attn_resolutions", "resolution",
            "z_channels", "attn_type"]
    out = {k: ddconfig[k] for k in keys if k in ddconfig}
    if decoder:
        out["out_ch"] = ddconfig["out_ch"]
    else:
        out["in_channels"] = ddconfig.get("in_channels", 3)
        out["double_z"] = double_z
    return out


class VQModel(nn.Module):
    """VQ-GAN autoencoder: Encoder -> quant_conv -> VQ -> post_quant_conv ->
    Decoder. Built on `device` (default "cuda", which raises without a
    card)."""

    def __init__(self, ddconfig: dict, n_embed: int, embed_dim: int,
                 beta: float = 0.25, dtype=torch.float32, device=None):
        super().__init__()
        enc_kw, dec_kw = _ddkwargs(ddconfig), _ddkwargs(ddconfig, decoder=True)
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(**enc_kw, dtype=dtype)
            self.decoder = Decoder(**dec_kw, dtype=dtype)
            self.quantize = VectorQuantizer(n_embed, embed_dim, beta)
            self.quant_conv = conv1x1(ddconfig["z_channels"], embed_dim, dtype)
            self.post_quant_conv = conv1x1(embed_dim, ddconfig["z_channels"], dtype)

    def encode(self, x):
        """(quant, codebook loss, (perplexity, None, indices)) of x [N, H, W, 3]."""
        return self.quantize(self.encode_prequant(x))

    def encode_prequant(self, x):
        """Un-quantized latent (the `VQModelInterface.encode` used by LDM)."""
        return _nhwc(self.quant_conv(_nchw(self.encoder(x))))

    def decode(self, quant):
        return self.decoder(_nhwc(self.post_quant_conv(_nchw(quant))))

    def decode_code(self, code):
        """Integer codes [N, h, w] -> images."""
        return self.decode(self.quantize.embed_code(code))

    def forward(self, x):
        """(reconstruction, codebook loss, indices [N, h, w]): the training
        forward."""
        quant, diff, (_, _, indices) = self.encode(x)
        return self.decode(quant), diff, indices

    def decode_interface(self, h, force_not_quantize: bool = False):
        """`VQModelInterface.decode`: quantize the latent (unless
        `force_not_quantize`), then decode."""
        return self.decode(h if force_not_quantize else self.quantize(h)[0])


class AutoencoderKL(nn.Module):
    """KL-regularised VAE: Encoder (double_z) -> quant_conv (2 * embed_dim
    moments) -> DiagonalGaussian; post_quant_conv -> Decoder. Built on
    `device` (default "cuda", which raises without a card)."""

    def __init__(self, ddconfig: dict, embed_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        enc_kw = _ddkwargs(ddconfig, double_z=True, model="AutoencoderKL")
        dec_kw = _ddkwargs(ddconfig, decoder=True, double_z=True, model="AutoencoderKL")
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(**enc_kw, dtype=dtype)
            self.decoder = Decoder(**dec_kw, dtype=dtype)
            self.quant_conv = conv1x1(2 * ddconfig["z_channels"], 2 * embed_dim, dtype)
            self.post_quant_conv = conv1x1(embed_dim, ddconfig["z_channels"], dtype)

    def encode(self, x) -> DiagonalGaussian:
        """x [N, H, W, 3] -> the posterior over [N, h, w, embed_dim]."""
        return DiagonalGaussian.from_moments(_nhwc(self.quant_conv(_nchw(self.encoder(x)))))

    def decode(self, z):
        return self.decoder(_nhwc(self.post_quant_conv(_nchw(z))))

    def forward(self, x, generator=None, sample_posterior: bool = True, noise=None):
        """(reconstruction, posterior); z is a posterior sample (from
        `generator`, or `noise` when given) or its mode."""
        posterior = self.encode(x)
        z = posterior.sample(generator, noise) if sample_posterior else posterior.mode()
        return self.decode(z), posterior


class IdentityFirstStage(nn.Module):
    """Pixel-space passthrough (also STDiff's IdentityAutoEncoder)."""

    def encode(self, x):
        return x

    def decode(self, x):
        return x
