"""ctypes binding of the C++ batch image loader `native/loader.cpp` (the
counterpart of `ealdm_tpu/data/native_loader.py`, with its three symbols).

The library is built from the checkout's `native/loader.cpp` with g++ at
first use, into the gitignored `build/native/` (keyed by the source's
hash); the `.so` committed under `native/` is never loaded. Where the JAX
package falls back to numpy and PIL when the build fails, the port raises:
the two paths resize differently, and a silent switch would change the
data.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Sequence

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SOURCE = os.path.join(_REPO, "native", "loader.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared"]  # native/Makefile's

_lock = threading.Lock()
_lib = None


def library_path(source: str = SOURCE, name: str = "libealdm_loader.so") -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, digest, name)


def build_library(source: str, path: str) -> None:
    """Compile `source` with g++ (or $CXX) into the shared library `path`;
    raises if the build fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    out = subprocess.run([cxx, *_FLAGS, "-o", tmp, source], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"building {source} with {cxx} failed:\n{out.stderr}")
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            build_library(SOURCE, path)
        lib = ctypes.CDLL(path)
        lib.ealdm_probe_npy.restype = ctypes.c_int
        lib.ealdm_probe_npy.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.ealdm_load_image_f32.restype = ctypes.c_int
        lib.ealdm_load_image_f32.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_float)]
        lib.ealdm_load_batch_f32.restype = ctypes.c_int
        lib.ealdm_load_batch_f32.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def probe(path: str):
    """(h, w, c) of an .npy image (uint8 or float32, C order)."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = get_lib().ealdm_probe_npy(path.encode(), ctypes.byref(h), ctypes.byref(w),
                                   ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"{path}: not an .npy image the native loader reads (code {rc})")
    return h.value, w.value, c.value


def load_image(path: str, size: int) -> np.ndarray:
    """One .npy image -> [size, size, 3] float32 in [-1, 1] (bilinear, the
    corners aligned)."""
    if not path.endswith(".npy"):
        raise ValueError(f"{path}: the native loader reads .npy files only")
    out = np.empty((size, size, 3), np.float32)
    rc = get_lib().ealdm_load_image_f32(path.encode(), size,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"{path}: the native loader failed (code {rc})")
    return out


def load_batch(paths: Sequence[str], size: int, threads: int = 0) -> np.ndarray:
    """.npy images -> [N, size, size, 3] float32, loaded by `threads`
    workers (min(cores, 8) if 0)."""
    bad = [p for p in paths if not p.endswith(".npy")]
    if bad:
        raise ValueError(f"{bad[0]}: the native loader reads .npy files only")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    threads = threads or min(os.cpu_count() or 1, 8)
    rc = get_lib().ealdm_load_batch_f32(arr, n, size, threads,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"the native loader failed on {rc} of {n} images")
    return out
