"""upfirdn2d and its wrappers (counterpart of `ealdm_tpu/ops/upfirdn2d.py`).

zero-insertion upsample -> pad/crop -> FIR filter -> decimate, on NHWC
tensors, in float32 and cast back. In the JAX package this is one XLA
convolution, not a Pallas kernel; here it is a depthwise `F.conv2d` on the
zero-inserted, padded NCHW view. The zero insertion appends up-1 zeros after
the last sample too, as the JAX package's padding does. Negative padding
crops. A 1-D filter is separable: one pass per axis (W, then H), with the
gain applied once at the end.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["downsample2d", "filter2d", "get_filter_size", "setup_filter",
           "upfirdn2d", "upsample2d"]


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = (scaling, scaling)
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling {scaling} must be >= 1")
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = (padding, padding)
    if len(padding) == 2:
        px, py = padding
        padding = (px, px, py, py)
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def get_filter_size(f):
    """(fw, fh) of a 1-D or 2-D filter; (1, 1) for None."""
    if f is None:
        return 1, 1
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {tuple(f.shape)}")
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None):
    """Normalize/flip/gain-scale an FIR filter; float32, 1-D (separable) or
    2-D. A 1-D filter of fewer than 8 taps becomes its 2-D outer product
    unless `separable` says otherwise."""
    if f is None:
        f = 1
    f = torch.as_tensor(np.asarray(f, dtype=np.float32))
    if f.dim() not in (0, 1, 2) or f.numel() == 0:
        raise ValueError(f"bad filter shape {tuple(f.shape)}")
    if f.dim() == 0:
        f = f[None]
    if separable is None:
        separable = f.dim() == 1 and f.numel() >= 8
    if f.dim() == 1 and not separable:
        f = torch.outer(f, f)
    if f.dim() != (1 if separable else 2):
        raise ValueError(f"a {f.dim()}-d filter cannot be separable={separable}")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.dim())))
    return f * (gain ** (f.dim() / 2))


def _zero_insert(x, up, axis):
    """NCHW x with up-1 zeros after every sample along `axis` (2: H, 3: W)."""
    if up == 1:
        return x
    n, c, h, w = x.shape
    if axis == 2:
        return F.pad(x.reshape(n, c, h, 1, w), (0, 0, 0, up - 1)).reshape(n, c, h * up, w)
    return F.pad(x.reshape(n, c, h, w, 1), (0, up - 1)).reshape(n, c, h, w * up)


def _pad_crop(x, px0, px1, py0, py1):
    """Zero-pad (positive) or crop (negative) the H and W edges of NCHW x."""
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    h, w = x.shape[2], x.shape[3]
    return x[:, :, max(-py0, 0):h - max(-py1, 0), max(-px0, 0):w - max(-px1, 0)]


def _depthwise(x, f2d, stride):
    """Correlate each channel of NCHW x with the [fh, fw] filter, VALID."""
    c = x.shape[1]
    weight = f2d[None, None].expand(c, 1, *f2d.shape)
    return F.conv2d(x, weight, stride=stride, groups=c)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """y = decimate(FIR(pad(zero_upsample(x)))). x: [N, H, W, C]."""
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d takes [N, H, W, C], got {tuple(x.shape)}")
    if f is None:
        f = torch.ones(1, 1)
    f = torch.as_tensor(f, dtype=torch.float32).to(x.device)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    _, in_h, in_w, _ = x.shape
    fw, fh = get_filter_size(f)
    if in_w * upx + padx0 + padx1 < fw or in_h * upy + pady0 + pady1 < fh:
        raise ValueError("the padded input is smaller than the filter")
    # conv2d correlates; flip_filter=False means true convolution
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    in_dtype = x.dtype
    y = x.float().permute(0, 3, 1, 2)
    if f.dim() == 1:
        y = _pad_crop(_zero_insert(y, upx, 3), padx0, padx1, 0, 0)
        y = _depthwise(y, f[None, :], (1, downx))
        y = _pad_crop(_zero_insert(y, upy, 2), 0, 0, pady0, pady1)
        y = _depthwise(y, f[:, None], (downy, 1))
    else:
        y = _zero_insert(_zero_insert(y, upy, 2), upx, 3)
        y = _depthwise(_pad_crop(y, padx0, padx1, pady0, pady1), f, (downy, downx))
    gain = float(gain)
    if gain != 1.0:
        y = y * gain
    return y.permute(0, 2, 3, 1).to(in_dtype)


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Same-size FIR filtering (shape-preserving by default)."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """FIR upsample by `up` with DC-preserving gain (gain * up^2)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (
        padx0 + (fw + upx - 1) // 2,
        padx1 + (fw - upx) // 2,
        pady0 + (fh + upy - 1) // 2,
        pady1 + (fh - upy) // 2,
    )
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """FIR anti-aliased downsample by `down`."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (
        padx0 + (fw - downx + 1) // 2,
        padx1 + (fw - downx) // 2,
        pady0 + (fh - downy + 1) // 2,
        pady1 + (fh - downy) // 2,
    )
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
