"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/<hash>/lib<name>.so` at the root
of the checkout (listed in .gitignore), where <hash> covers every source and
the compiler flags, so an edited source is rebuilt and an unchanged one is
reused. nvcc's output (ptxas's registers, shared memory and spills) is kept
beside it as `lib<name>.log`. All sources compile at once, one nvcc process
each. Nothing is built or imported when this module is imported: the first
kernel launch (or `build_all`) does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet, in parallel, and load
    all of them. Raises with nvcc's output when a build fails."""
    if _LIBS:
        return _LIBS
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, lib,
        )
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
        else:
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for src in _sources():
        _LIBS[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
    _declare(_LIBS)
    return _LIBS


def library_path(name: str) -> Path:
    """The shared library built from `csrc/<name>.cu`."""
    return _build_dir() / f"lib{name}.so"


def build_report(name: str) -> str:
    """nvcc's output for the library built from `csrc/<name>.cu`, from this
    build or the one that made the cached library. Raises if there is none."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        raise RuntimeError(f"no nvcc report for {name}: build it again "
                           f"(delete {log.parent})")
    return log.read_text()


def cuda_tool(name: str) -> str:
    """A program of the CUDA toolkit beside nvcc (`cuobjdump`, ...)."""
    return os.path.join(os.path.dirname(_nvcc()), name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (building on first use)."""
    return build_all()[name]


def _declare(libs: Dict[str, ctypes.CDLL]) -> None:
    """argtypes/restype of every C entry point (see the .cu sources)."""
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fa = libs["flash_attention"].ealdm_flash_attention
    fa.argtypes = [P, P, P, P, I, I, I, I, I, I] + [L] * 12 + [F, P]
    fa.restype = I
    fd = libs["flash_attention_sm90_deep"].ealdm_flash_attention_sm90_deep
    fd.argtypes = fa.argtypes  # its slice width where fa takes the dtype
    fd.restype = I
    f32 = libs["flash_attention_sm90_f32"]
    f32.ealdm_flash_attention_sm90_f32.argtypes = [P] * 6 + [I] * 10 + [L] * 12 + [F, P]
    f32.ealdm_flash_attention_sm90_f32.restype = I
    f32.ealdm_flash_attention_sm90_f32_splits.argtypes = [I] * 9
    f32.ealdm_flash_attention_sm90_f32_splits.restype = I
    for name in ("flash_attention_sm90", "flash_attention_sm90_wide"):
        fw = getattr(libs[name], f"ealdm_{name}")
        fw.argtypes = [P, P, P, P, I, I, I, I, I] + [L] * 12 + [F, P]
        fw.restype = I
    gn = libs["group_norm"]
    ptrs = [P] * 5  # x, y, scale, bias, pre
    args = [I] * 5 + [L, L, F, I]  # dtype, N, C, HW, G, psn, psc, eps, silu
    gn.ealdm_group_norm.argtypes = ptrs + args + [P]
    gn.ealdm_group_norm_cl.argtypes = ptrs + args + [P]
    gn.ealdm_group_norm_two_pass.argtypes = ptrs + [P] + args + [I, I, P]
    gn.ealdm_group_norm_cl_two_read.argtypes = ptrs + [P] + args + [I, P]
    for fn in (gn.ealdm_group_norm, gn.ealdm_group_norm_cl, gn.ealdm_group_norm_two_pass,
               gn.ealdm_group_norm_cl_two_read):
        fn.restype = I
    ba = libs["bias_act"].ealdm_bias_act
    ba.argtypes = [P, P, P, I, L, L, L, I, F, F, F, P]
    ba.restype = I


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
