"""filtered_lrelu: upsample -> biased leaky ReLU -> downsample on NHWC
tensors (counterpart of `ealdm_tpu/ops/filtered_lrelu.py`).

bias -> upfirdn2d(up, gain=up^2) -> lrelu(slope) * gain with clamp ->
upfirdn2d(down). Both bias_act stages go through `bias_act`, so on a CUDA
tensor each call launches the bias_act kernel twice.
"""
from __future__ import annotations

import math

from .bias_act import bias_act
from .upfirdn2d import _parse_padding, get_filter_size, upfirdn2d

__all__ = ["filtered_lrelu"]


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=math.sqrt(2.0), slope=0.2, clamp=None):
    """x: [N, H, W, C]; fu/fd: 1-D separable or 2-D FIR filters; b: [C].
    Returns [N, out_h, out_w, C] in x's dtype."""
    if x.dim() != 4:
        raise ValueError(f"filtered_lrelu takes [N, H, W, C], got {tuple(x.shape)}")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1):
        raise ValueError(f"up {up!r} and down {down!r} must be integers >= 1")
    px0, px1, py0, py1 = _parse_padding(padding)
    fu_w, fu_h = get_filter_size(fu)
    fd_w, fd_h = get_filter_size(fd)
    in_dtype = x.dtype
    n, in_h, in_w, c = x.shape
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    x = bias_act(x, b, dim=-1)  # bias only (linear act)
    x = upfirdn2d(x, fu, up=up, padding=(px0, px1, py0, py1), gain=up**2)
    x = bias_act(x, None, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down)

    if tuple(x.shape) != (n, out_h, out_w, c):
        raise RuntimeError(f"filtered_lrelu gave {tuple(x.shape)}, expected "
                           f"{(n, out_h, out_w, c)}")
    return x.to(in_dtype)
