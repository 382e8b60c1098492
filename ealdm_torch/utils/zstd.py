"""Zstandard decoding and CRC-32C through the port's own C++ library
(`ealdm_torch/native/zstd.cpp`, RFC 8878), bound with ctypes: the card's
machine has neither the `zstandard` package nor orbax's tensorstore, and
the system's libzstd is not relied on.

The library is built from the checkout's source with g++ at first use,
into the gitignored `build/native/` (keyed by the source's hash), as
`data/native_loader.py` builds its loader; a failed build raises. A frame
is decoded into a buffer the caller gives (`decompress_into`: a numpy
array or a CPU tensor, so a checkpoint's leaf is decoded where it lands)
or into a new `bytes` (`decompress`). A frame that does not decode raises
`ZstdError` with the reason; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..data import native_loader

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "native", "zstd.cpp")
_ERR = 512
_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """A zstd frame the decoder cannot decode."""


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = native_loader.library_path(SOURCE, "libealdm_zstd.so")
        if not os.path.exists(path):
            native_loader.build_library(SOURCE, path)
        lib = ctypes.CDLL(path)
        sz, p, err = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
        lib.ealdm_zstd_content_size.restype = ctypes.c_int64
        lib.ealdm_zstd_content_size.argtypes = [p, sz, err, sz]
        lib.ealdm_zstd_decompress.restype = ctypes.c_int64
        lib.ealdm_zstd_decompress.argtypes = [p, sz, p, sz, err, sz]
        lib.ealdm_crc32c.restype = ctypes.c_uint32
        lib.ealdm_crc32c.argtypes = [ctypes.c_uint32, p, sz]
        _lib = lib
        return _lib


def _source(data):
    """(address, size, keep-alive) of a bytes-like object, with no copy."""
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    if not a.flags.c_contiguous:
        raise ValueError("zstd input must be contiguous")
    return a.ctypes.data, a.nbytes, a


def _target(out):
    """(address, size) of a writable numpy array or CPU tensor."""
    if isinstance(out, np.ndarray):
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("the output array must be contiguous and writable")
        return out.ctypes.data, out.nbytes
    import torch

    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("the output tensor must be a contiguous CPU tensor")
        return out.data_ptr(), out.numel() * out.element_size()
    raise TypeError(f"cannot decode into a {type(out).__name__}")


def _content_size(data):
    """The decoded size the frames' headers state, or None where one does
    not state it."""
    addr, n, _keep = _source(data)
    err = ctypes.create_string_buffer(_ERR)
    got = get_lib().ealdm_zstd_content_size(addr, n, err, _ERR)
    if got == -2:
        raise ZstdError(err.value.decode())
    return None if got < 0 else got


def _decode(addr: int, n: int, dst: int, cap: int) -> int:
    err = ctypes.create_string_buffer(_ERR)
    got = get_lib().ealdm_zstd_decompress(addr, n, dst, cap, err, _ERR)
    if got < 0:
        raise ZstdError(err.value.decode())
    return got


def decompress_into(data, out) -> int:
    """Decode `data` into `out`, whose size must be the decoded size
    exactly; returns it."""
    addr, n, _keep = _source(data)
    dst, cap = _target(out)
    got = _decode(addr, n, dst, cap)
    if got != cap:
        raise ZstdError(f"decoded {got} bytes into a buffer of {cap}")
    return got


def decompress(data, limit: int = 1 << 31) -> bytes:
    """The decoded bytes of `data`. Where a frame does not state its size,
    the buffer grows to at most `limit` bytes."""
    size = _content_size(data)
    addr, n, _keep = _source(data)
    cap = size if size is not None else min(limit, max(1 << 16, 8 * n))
    while True:
        out = np.empty(cap, np.uint8)
        try:
            got = _decode(addr, n, out.ctypes.data, cap)
            return out[:got].tobytes()
        except ZstdError as e:
            if size is not None or "past the buffer" not in str(e) or cap >= limit:
                raise
            cap = min(limit, 4 * cap)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`, continuing from `crc`."""
    addr, n, _keep = _source(data)
    return get_lib().ealdm_crc32c(crc, addr, n)
