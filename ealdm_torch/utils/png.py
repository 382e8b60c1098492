"""PNG files to and from uint8 arrays on the standard library's `zlib` and
`struct` alone (the card's machine has no imaging package; the JAX
package's `save_png`, TensorBoard images and image datasets go through
PIL).

The writer: 8-bit greyscale [H, W] (or [H, W, 1]) and RGB [H, W, 3], no
filter, one IDAT chunk. The reader: 8-bit greyscale, greyscale with alpha,
RGB and RGBA, not interlaced, any of the five row filters (what PIL and
other encoders write), as the arrays `np.asarray(PIL.Image.open(path))`
gives; `to_rgb` is PIL's `convert("RGB")` of them.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (greyscale, truecolour)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> channels the reader takes


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


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the row filters (None, Sub, Up, Average, Paeth) of `raw`, h rows
    of a filter byte and w * bpp bytes."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: serial along the row
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG's pixels as uint8: [H, W] greyscale, [H, W, 2] greyscale with
    alpha, [H, W, 3] RGB or [H, W, 4] RGBA."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("a PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG of bit depth {depth}, colour type {color}, interlace {interlace}: the "
            "reader takes 8-bit greyscale, greyscale + alpha, RGB and RGBA, not interlaced")
    c = _CHANNELS[color]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def load_png(path: str) -> np.ndarray:
    """`decode_png` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of a decoded PNG: greyscale repeated, alpha
    dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
