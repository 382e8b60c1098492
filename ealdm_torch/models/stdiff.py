"""STDiff environment-conditioning tower (counterpart of
`ealdm_tpu/models/stdiff.py`).

Public tensors are NHWC as in the JAX package. Ported: ConditioningTransform
(without its conditioning noise: JAX's UnetCond builds it with
add_noise=False, so no shipped path draws it), EqualizedDense, CondScale (its
`w` and `c` branches), EnvLSTM, AdaIN and UnetCond with norm="group" or
"frozen_bn". The two dropout sites (p 0.1: EnvLSTM's head and the out-head
tokens) run in train() mode when the caller passes a `torch.Generator`, as
flax's nn.Dropout runs when given a "dropout" rng and deterministic=False.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import bias_act
from ..ops.norms import instance_norm_2d
from ..parallel import draws
from ..parallel.sharding import whole
from .layers import Conv2D, Dense
from .resnet import FrozenBatchNorm


class ConditioningTransform:
    """Cyclic Fourier features of (scaled) capture time."""

    def __init__(self, cond_args: Dict[str, Any], num_ws: int = 1):
        self.cond_args = dict(cond_args)
        self.num_ws = num_ws
        self.explicit_lin = bool(self.cond_args.get("include_lin", False))
        self.freqs = self._frequencies()
        self.num_f = len(self.freqs)

    def _frequencies(self) -> np.ndarray:
        if self.cond_args.get("type") not in ("fourier", "f_concat"):
            return np.zeros((0,), np.float32)
        freqs = list(self.cond_args.get("f_manual", []))
        if self.explicit_lin:
            freqs = [-1.0] + freqs  # sorts first: the explicit linear slot
        return np.sort(np.asarray(freqs, dtype=np.float32))

    def __call__(self, c: torch.Tensor, broadcast: bool = True) -> torch.Tensor:
        """c: [B, 1] (global) or [B, #freq] float32 -> [B, num_ws, dims].
        The angles reach 2*pi*672*c, so they stay in float32."""
        ca = self.cond_args
        if ca.get("type") in ("fourier", "f_concat"):
            freqs = torch.as_tensor(self.freqs, device=c.device)
            angles = 2 * np.pi * freqs * c
            cos, sin = torch.cos(angles), torch.sin(angles)
            if self.explicit_lin:
                cos[..., 0] = 1.0
                sin[..., 0] = float(ca.get("lin_lr", 1e-2)) * c[..., 0]
            c = torch.stack([cos, sin], dim=-1).reshape(*c.shape[:-1], -1)
        if broadcast and c.dim() == 2:
            c = c[:, None, :].expand(c.shape[0], self.num_ws, c.shape[1])
        return c


class EqualizedDense(nn.Module):
    """StyleGAN-style FC: weight [out, in] scaled at run time by
    lr_multiplier / sqrt(in); the bias scaled by lr_multiplier. "linear"
    computes y + b, as the JAX module does; any other activation goes
    through `bias_act`. The JAX module's `use_bias=False` is not ported: no
    caller sets it."""

    def __init__(self, in_features: int, features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init_value: float = 0.0):
        super().__init__()
        self.activation, self.lr_multiplier = activation, lr_multiplier
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.full((features,), float(bias_init_value)))

    def forward(self, x):
        w = whole(self.weight)
        weight_gain = self.lr_multiplier / math.sqrt(w.shape[1])
        y = x @ (w.to(x.dtype).T * weight_gain)
        b = self.bias if self.lr_multiplier == 1 else self.bias * self.lr_multiplier
        if self.activation == "linear":
            return y + b.to(y.dtype)
        return bias_act(y, b, act=self.activation)


class CondScale(nn.Module):
    """Per-channel style scales: `w_affine(w)` (an EqualizedDense with bias
    1) times the Fourier-feature scales of `c`, or either alone."""

    def __init__(self, channels: int, cond_args: Dict[str, Any], c_dim: int,
                 w_dim: Optional[int] = None):
        super().__init__()
        self.cond_args = dict(cond_args)
        self.w_dim = w_dim
        if w_dim is not None:
            self.w_affine = EqualizedDense(w_dim, channels, bias_init_value=1.0)
        if self.cond_args.get("type") == "fourier":
            self.c_to_scales_weight = nn.Parameter(torch.zeros(channels, c_dim))

    def forward(self, w=None, c=None):
        styles = None
        if self.w_dim is not None and w is not None:
            styles = self.w_affine(w)
        if self.cond_args.get("type") == "fourier":
            gain = float(self.cond_args.get("lr", 1)) / math.sqrt(c.shape[-1])
            scales = c @ (whole(self.c_to_scales_weight).to(c.dtype).T * gain)
            styles = styles * scales if styles is not None else scales
        return styles


def dropout(x, rate: float, generator: torch.Generator):
    """flax nn.Dropout: keep each element with probability 1 - rate (a
    uniform draw from `generator` below it, the data rank's rows of the global
    batch's draw: `parallel.draws`) and scale it by 1 / (1 - rate)."""
    keep_prob = 1.0 - rate
    keep = draws.rand(x.shape, generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class EnvLSTM(nn.Module):
    """LSTM over an env time series + 2-layer FC head on every step:
    [B, T, D] -> [B*T, emb]. The recurrence runs in float32 (the flax cell
    has no compute dtype); the head in `dtype`. Only the head is dropped out
    (after fc_0), as in JAX: torch.nn.LSTM's own dropout acts between
    stacked layers and stays off."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 num_layers: int = 1, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.hidden_size, self.num_layers, self.dtype = hidden_size, num_layers, dtype
        self.dropout_rate = dropout
        for layer in range(num_layers):
            lstm = nn.LSTM(input_size if layer == 0 else hidden_size, hidden_size,
                           batch_first=True)
            # flax's cell has one bias a gate; torch adds bias_ih to bias_hh,
            # so bias_ih stays 0 and out of training
            nn.init.zeros_(lstm.bias_ih_l0)
            lstm.bias_ih_l0.requires_grad_(False)
            self.add_module(f"lstm_{layer}", lstm)
        self.fc_0 = Dense(hidden_size, output_size, dtype=dtype)
        self.fc_2 = Dense(output_size, output_size, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """Dropout runs in train() mode when `generator` is given."""
        b, t, _ = x.shape
        h = x.to(self.dtype).float()
        for layer in range(self.num_layers):
            lstm = getattr(self, f"lstm_{layer}")
            if any(getattr(p, "tp_shard", None) is not None for p in lstm.parameters()):
                # weights cut over a model group run whole
                h, _ = torch.func.functional_call(
                    lstm, {k: whole(p) for k, p in lstm.named_parameters()}, (h,))
            else:
                h, _ = lstm(h)
        h = h.reshape(b * t, self.hidden_size)
        h = F.relu(self.fc_0(h))
        if self.training and generator is not None:
            h = dropout(h, self.dropout_rate, generator)
        return self.fc_2(h)


class AdaIN(nn.Module):
    """InstanceNorm + style-conditioned (1 + gamma) * x + beta on NHWC x."""

    def __init__(self, channels: int, style_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear = Dense(style_dim, 2 * channels, dtype=dtype)

    def forward(self, x, w):
        x = instance_norm_2d(x)
        gamma, beta = self.linear(w).chunk(2, dim=-1)
        return x * (1.0 + gamma[:, None, None, :]) + beta[:, None, None, :]


def _norm_groups(c: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if c % g == 0:
            return g
    return 1


class FlaxGroupNorm(nn.Module):
    """flax `nn.GroupNorm` as UnetCond's conv_cat_norm uses it: eps 1e-6,
    float32 statistics with the variance as max(E[x^2] - E[x]^2, 0), and a
    float32 result. Not a kernel site in the JAX package: plain torch here."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """x: [N, H, W, C]."""
        n, h, w, c = x.shape
        xg = x.float().reshape(n, h, w, self.num_groups, c // self.num_groups)
        mean = xg.mean((1, 2, 4), keepdim=True)
        var = (xg.square().mean((1, 2, 4), keepdim=True) - mean.square()).clamp_min(0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(n, h, w, c)
        return y * self.weight + self.bias


class UnetCond(nn.Module):
    """Environment-aware conditioning tower -> cross-attention context
    [B, mid_dim, out_dim]. `fuse_env=False` is the negative/unconditional
    branch: AdaIN fusion is skipped."""

    def __init__(self, mid_dim: int = 4, emb_dim: int = 128, out_dim: int = 512,
                 w_dim: int = 16, f_dim: int = 1, t_dim: int = 6,
                 hidden_dim: int = 1024, num_layers: int = 1, num_ws: int = 1,
                 cond_args: Optional[Dict[str, Any]] = None, norm: str = "group",
                 feat_hw: int = 32, dtype=torch.float32):
        """feat_hw: the side of the (square) image-feature map, which sets
        the out head's width (flax infers it from the first input)."""
        super().__init__()
        if norm not in ("group", "frozen_bn"):
            raise ValueError(f"unknown UnetCond norm {norm!r}")
        self.mid_dim, self.num_ws, self.dtype = mid_dim, num_ws, dtype
        self.cond_args = cond_args or {
            "type": "fourier", "dims": t_dim, "f_manual": [],
            "include_lin": True, "lin_lr": 0.01, "lr": 1,
        }
        self.xform = ConditioningTransform(self.cond_args, num_ws=num_ws)
        c_dim = 2 * self.xform.num_f
        self.scaled_styles = CondScale(emb_dim, self.cond_args, c_dim)
        self.f_mlp = EnvLSTM(f_dim, hidden_dim, emb_dim, num_layers, dtype=dtype)
        self.w_mlp = EnvLSTM(w_dim, hidden_dim, emb_dim, num_layers, dtype=dtype)
        self.wadain = AdaIN(mid_dim, emb_dim, dtype)
        self.fadain = AdaIN(mid_dim, emb_dim, dtype)
        self.tadain = AdaIN(mid_dim, emb_dim, dtype)
        self.conv_cat_0 = Conv2D(4 * mid_dim, mid_dim, 3, dtype=dtype)
        self.conv_cat_norm = (FrozenBatchNorm(mid_dim) if norm == "frozen_bn"
                              else FlaxGroupNorm(mid_dim, _norm_groups(mid_dim)))
        self.conv_cat_3 = Conv2D(mid_dim, mid_dim, 3, dtype=dtype)
        hw = feat_hw * feat_hw
        self.out_0 = Dense(hw, mid_dim * hw, dtype=dtype)
        self.out_3 = Dense(mid_dim * hw, out_dim, dtype=dtype)

    def forward(self, img_feat, flow, weather, time, fuse_env: bool = True,
                generator: Optional[torch.Generator] = None):
        """img_feat [B, h, w, mid_dim] (the frozen first-stage encoding of
        the previous frame), flow [B, T, f_dim], weather [B, T, w_dim],
        time [B, 1] -> context [B, mid_dim, out_dim]. In train() mode with a
        `generator`, the two dropout sites draw from it (the LSTM heads'
        first, f then w, then the out head)."""
        cs = self.xform(time.float(), broadcast=True)
        c0 = cs[:, 0, :]
        h = img_feat
        if fuse_env:
            t_style = self.scaled_styles(c=c0)
            f_emb = self.f_mlp(flow, generator)
            w_emb = self.w_mlp(weather, generator)
            combined = torch.cat([
                h, self.wadain(h, w_emb), self.fadain(h, f_emb),
                self.tadain(h, t_style),
            ], dim=-1)
            combined = self.conv_cat_0(combined.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            combined = F.relu(self.conv_cat_norm(combined))
            combined = self.conv_cat_3(combined.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            h = combined + h
        b, fh, fw, c = h.shape
        tokens = h.permute(0, 3, 1, 2).reshape(b, c, fh * fw)
        tokens = F.relu(self.out_0(tokens))
        if self.training and generator is not None:
            tokens = dropout(tokens, 0.1, generator)
        return self.out_3(tokens)
