"""PNG files from uint8 arrays on the standard library's `zlib` and
`struct` alone (the card's machine has no imaging package; the JAX
package's `save_png` and TensorBoard images go through PIL).

8-bit greyscale [H, W] (or [H, W, 1]) and RGB [H, W, 3], no filter, one
IDAT chunk.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (greyscale, truecolour)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG bytes of a uint8 [H, W], [H, W, 1] or [H, W, 3] array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes [H, W], [H, W, 1] or [H, W, 3], not {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 ("none") a row
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def save_png(path: str, img: np.ndarray) -> None:
    """Write `encode_png(img)` to `path`, making its directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(img))
