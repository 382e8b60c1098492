"""Dependency-free TensorBoard event files (counterpart of
`ealdm_tpu/training/tensorboard.py`, byte for byte the same records; images
are PNG-encoded by `utils/png.py` instead of PIL).

The reference trains under Lightning's TensorBoard logger; the JSONL stream
stays the primary log, and these files let TensorBoard read the logdir.
The format, written directly:

  * TFRecord framing: <u64 length><u32 masked-crc32c(length)><payload>
    <u32 masked-crc32c(payload)>.
  * Payloads are hand-encoded `Event` protobuf messages (varints and
    length-delimited fields):
      Event{ wall_time=1:double, step=2:int64, file_version=3:string,
             summary=5:Summary }
      Summary{ value=1: repeated Value }
      Summary.Value{ tag=1:string, simple_value=2:float, image=4:Image }
      Summary.Image{ height=1, width=2, colorspace=3,
                     encoded_image_string=4:bytes (PNG) }

crc32c (Castagnoli) is table-driven Python: a step's scalars are a few
dozen bytes.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np

from ..utils.png import encode_png

# --------------------------------------------------------------- crc32c
_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _string(field: int, v: str) -> bytes:
    return _bytes(field, v.encode("utf-8"))


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes(1, _string(1, tag) + _float(2, float(value)))


def _image_value(tag: str, png: bytes, h: int, w: int, c: int) -> bytes:
    img = _int64(1, h) + _int64(2, w) + _int64(3, c) + _bytes(4, png)
    return _bytes(1, _string(1, tag) + _bytes(4, img))


def _event(step: Optional[int] = None, summary: bytes = b"",
           file_version: Optional[str] = None) -> bytes:
    msg = _double(1, time.time())
    if step is not None:
        msg += _int64(2, int(step))
    if file_version is not None:
        msg += _string(3, file_version)
    if summary:
        msg += _bytes(5, summary)
    return msg




# --------------------------------------------------------------- writer
class TBEventWriter:
    """Append-only TensorBoard event file in `logdir`."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}{suffix}"
        self.path = os.path.join(logdir, name)
        self._fh = open(self.path, "ab")
        self._record(_event(file_version="brain.Event:2"))
        self.flush()

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._record(_event(step=step, summary=_scalar_value(tag, value)))

    def add_scalars(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        summary = b""
        for k, v in metrics.items():
            try:
                summary += _scalar_value(f"{prefix}{k}", float(v))
            except (TypeError, ValueError):
                continue
        if summary:
            self._record(_event(step=step, summary=summary))

    def add_image(self, tag: str, img: np.ndarray, step: int):
        """img: [H,W,C] float in [-1,1]/[0,1] or uint8."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            lo, hi = float(img.min()), float(img.max())
            if lo < -0.01:  # [-1,1] convention
                img = (img + 1.0) / 2.0
            elif hi > 1.5:  # already 0..255
                img = img / 255.0
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        png = encode_png(img if c != 1 else img[..., 0])
        self._record(_event(step=step, summary=_image_value(tag, png, h, w, c)))

    def flush(self):
        self._fh.flush()

    def close(self):
        if not self._fh.closed:
            self.flush()
            self._fh.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass
