"""Overlapping-crop (split-input) inference for oversized inputs
(counterpart of `ealdm_tpu/ops/patching.py`).

An input is cut into an overlapping grid of crops (row-major crop order,
as `torch.nn.Unfold` orders them), the network runs once on all crops as
one [B*L, ...] batch, and the outputs are stitched back by a border-distance
weighting: each output pixel is the weighted mean of the crops that cover
it. `fold2d` is `torch.nn.functional.fold`, the exact adjoint of the
gather, as JAX's is `jax.linear_transpose` of it. Where the grid does not
cover the input (its side is not ks + k * stride), the folded weight is 0
and the stitch divides 0 by 0: NaN there, in both packages and in the
reference they follow.

Layout is NHWC throughout.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

DEFAULT_SPLIT_PARAMS: Dict[str, object] = {
    # the reference's log_images defaults
    "ks": (128, 128),
    "stride": (64, 64),
    "vqf": 4,
    "patch_distributed_vq": True,
    "tie_braker": False,
    "clip_max_weight": 0.5,
    "clip_min_weight": 0.01,
    "clip_max_tie_weight": 0.5,
    "clip_min_tie_weight": 0.01,
}


def grid_shape(hw: Tuple[int, int], ks: Tuple[int, int], stride: Tuple[int, int]):
    """Number of crops (Ly, Lx) of a VALID crop grid."""
    ly = (hw[0] - ks[0]) // stride[0] + 1
    lx = (hw[1] - ks[1]) // stride[1] + 1
    return ly, lx


def clamp_patch_params(hw, ks, stride):
    """Kernel and stride shrunk to the input, as the reference does."""
    ks = (min(ks[0], hw[0]), min(ks[1], hw[1]))
    stride = (min(stride[0], hw[0]), min(stride[1], hw[1]))
    return ks, stride


def delta_border(h: int, w: int, device=None) -> torch.Tensor:
    """[h, w] float32 normalised distance to the nearest border: 0 at the
    edge, 0.5 in the centre."""
    y = torch.arange(h, dtype=torch.float32, device=device) / max(h - 1, 1)
    x = torch.arange(w, dtype=torch.float32, device=device) / max(w - 1, 1)
    dy = torch.minimum(y, 1.0 - y)
    dx = torch.minimum(x, 1.0 - x)
    return torch.minimum(dy[:, None], dx[None, :])


def compute_weighting(h: int, w: int, ly: int, lx: int, params: Dict,
                      device=None) -> torch.Tensor:
    """[L, h, w, 1] float32 blending weights of each crop; `tie_braker` also
    down-weights the crops near the grid's border."""
    wgt = delta_border(h, w, device).clamp(params["clip_min_weight"],
                                           params["clip_max_weight"])
    wgt = wgt[None].expand(ly * lx, h, w)
    if params.get("tie_braker"):
        tie = delta_border(ly, lx, device).clamp(
            params["clip_min_tie_weight"], params["clip_max_tie_weight"]).reshape(-1)
        wgt = wgt * tie[:, None, None]
    return wgt[..., None]


def unfold2d(x: torch.Tensor, ks: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, L, kh, kw, C] overlapping crops, row-major crop
    order, contiguous (the kernels take a crop as the dense NHWC tensor the
    unpatched path gives them, also where one crop is the whole input)."""
    b, _, _, c = x.shape
    crops = x.unfold(1, ks[0], stride[0]).unfold(2, ks[1], stride[1])  # [B,Ly,Lx,C,kh,kw]
    return crops.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, ks[0], ks[1], c).contiguous()


def fold2d(patches: torch.Tensor, out_hw: Tuple[int, int], ks: Tuple[int, int],
           stride: Tuple[int, int]) -> torch.Tensor:
    """[B, L, kh, kw, C] -> [B, H, W, C] overlap-add: the adjoint of
    `unfold2d` (`torch.nn.functional.fold`), contiguous NHWC."""
    b, length, kh, kw, c = patches.shape
    cols = patches.permute(0, 4, 2, 3, 1).reshape(b, c * kh * kw, length)
    return F.fold(cols, out_hw, ks, stride=stride).permute(0, 2, 3, 1).contiguous()


def patched_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, params: Dict,
                  *, uf: int = 1, df: int = 1) -> torch.Tensor:
    """Run `fn` ([N, h, w, C] -> [N, h*uf/df, w*uf/df, C']) over an
    overlapping crop grid of `x` as one [B*L, ...] call and stitch the
    results; the weights, the fold and the division in the output's dtype."""
    if uf != 1 and df != 1:
        raise ValueError("patched_apply takes an up- or a down-factor, not both")
    b, h, w, _ = x.shape
    ks, stride = clamp_patch_params((h, w), tuple(params["ks"]), tuple(params["stride"]))
    ly, lx = grid_shape((h, w), ks, stride)
    length = ly * lx
    crops = unfold2d(x, ks, stride)
    out = fn(crops.reshape((b * length,) + crops.shape[2:]))
    okh, okw = ks[0] * uf // df, ks[1] * uf // df
    if tuple(out.shape[1:3]) != (okh, okw):
        raise ValueError(f"fn gave crops of {tuple(out.shape[1:3])}, not {(okh, okw)}")
    wgt = compute_weighting(okh, okw, ly, lx, params, x.device).to(out.dtype)
    out = out.reshape((b, length) + out.shape[1:]) * wgt[None]
    out_hw = (h * uf // df, w * uf // df)
    ostride = (stride[0] * uf // df, stride[1] * uf // df)
    folded = fold2d(out, out_hw, (okh, okw), ostride)
    norm = fold2d(wgt[None], out_hw, (okh, okw), ostride)
    return folded / norm
