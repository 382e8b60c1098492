"""conv2d_resample and grid_sample on NHWC tensors (counterpart of
`ealdm_tpu/ops/resample.py`).

`conv2d_resample`: a grouped convolution with integer up/downsampling and
FIR filtering, composed from `upfirdn2d` and a VALID `F.conv2d`, with the
JAX package's padding arithmetic and `flip_weight`/`flip_filter`
conventions. Weights keep the JAX layout [kh, kw, Cin/groups, Cout].

`grid_sample`: bilinear sampling, align_corners=False, zeros outside the
image, written as a gather and a lerp so that it is differentiable to any
order (`F.grid_sample`'s backward is not twice differentiable).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .upfirdn2d import get_filter_size, upfirdn2d

__all__ = ["conv2d_resample", "grid_sample"]


def _conv(x, w, groups=1, stride=1):
    """VALID conv of NHWC x with HWIO w; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """2D conv with optional up/downsampling. x: [N, H, W, Cin];
    w: [kh, kw, Cin/groups, Cout]. `padding` is applied once, w.r.t. the
    upsampled image, then a VALID (optionally strided) conv, then the FIR
    downsample. flip_weight=True means correlation (the torch conv2d
    convention)."""
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    elif len(padding) == 2:
        padding = (padding[0], padding[0], padding[1], padding[1])
    px0, px1, py0, py1 = padding
    fw, fh = get_filter_size(f)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if not flip_weight:  # correlation by default; flip for true convolution
        w = w.flip([0, 1])
    w = w.to(x.dtype)

    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return _conv(x, w, groups=groups, stride=down)

    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=(px0, px1, py0, py1),
                  gain=up**2 if up > 1 else 1, flip_filter=flip_filter)
    x = _conv(x, w, groups=groups)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x


def grid_sample(x, grid):
    """Bilinear grid sample, torch align_corners=False convention, zeros
    outside. x: [N, H, W, C]; grid: [N, Hg, Wg, 2] with (x, y) in [-1, 1].
    Returns [N, Hg, Wg, C]."""
    n, h, w, c = x.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    ix0, iy0 = x0.long(), y0.long()
    flat = x.reshape(n, h * w, c)
    out = 0
    # the corners in the order of jax.scipy.ndimage.map_coordinates
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, -1, 1)
            v = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(*gx.shape, c)
            out = out + (wy * wx)[..., None] * torch.where(valid[..., None], v, 0)
    return out.to(x.dtype)
