"""What paces the wgmma flash-attention kernels, timed on copies of them.

    python -m ealdm_torch.kernels.probe_flash          # both kernels
    python -m ealdm_torch.kernels.probe_flash narrow   # flash_attention_sm90.cu only
    python -m ealdm_torch.kernels.probe_flash wide     # flash_attention_sm90_wide.cu only
    python -m ealdm_torch.kernels.probe_flash deep     # flash_attention_sm90_deep.cu only
    python -m ealdm_torch.kernels.probe_flash f32      # flash_attention.cu's float32 kernels

Builds each source into `build/kernels/probe/` once for each of its
variants below (the file's FLASH_PROBE_* macros; all nvcc processes at once)
and times each in device time (torch.profiler) at the shapes the paths give
it, bfloat16, contiguous [B, H, N, D]. The narrow kernel (d = 40 .. 128): as
built; without the softmax; without the softmax and the products (the
copies, barriers and waits alone); the same with K copied and V not, and the
whole kernel without V's copies (half the bytes); with 1 consumer
warpgroup (64-row blocks, two an SM), 2 and 3; with tiles stored as strips
of 16 or 32 columns (TMA rows of 32 or 64 bytes, against 128 bytes as built
at D = 40 .. 64); and with rings of 6 and 8 K/V stages (4 as built). The
wide kernel (d = 136 .. 576) at cin256-v2's and the VAEs' shapes: as built;
without the softmax; the copies alone; without V's copies; 3 PV
warpgroups at d = 384 (2 as built); the key split over a cluster of two
blocks nowhere and everywhere (as built where twice the blocks fill the
SMs' waves better). The deep kernel (d = 584 .. 1,920, a cluster of
blocks that split the head dim) at [4, 2, 1024, d], d = 640, 648, 960 and
1,104: as built; without the softmax; the copies and the exchange of
partial scores alone; the copies alone; without V's copies; without the
exchange (each block's S its own partial); with every d on depth slices
of 384 columns (as routed: 512 at d = 776 .. 1,024, `deep_slices`). The
float32 kernels (flash_attention.cu, float32 inputs): as built
(`flash_wide_kernel` up to d = 512, `flash_deep_kernel` above), with
`flash_deep_kernel` at every d, and with `flash_wide_kernel` up to 640 (its
16-row blocks above 512). A variant that leaves work out computes garbage:
only its time is read. Prints one line per shape, and the card's name and
power limit; `chip_smoke.py` phase 2c times the same shapes beside the
library call.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess

import torch

from . import build
from ..ops.attention import deep_slices

NARROW_VARIANTS = {
    "as built": [],
    "no softmax": ["-DFLASH_PROBE_SKIP=1"],
    "copies only": ["-DFLASH_PROBE_SKIP=3"],
    "K copies only": ["-DFLASH_PROBE_SKIP=7"],
    "no V copies": ["-DFLASH_PROBE_SKIP=4"],
    "1 consumer, 2 blocks an SM": ["-DFLASH_PROBE_CONSUMERS=1"],
    "2 consumers": ["-DFLASH_PROBE_CONSUMERS=2"],
    "3 consumers": ["-DFLASH_PROBE_CONSUMERS=3"],
    "16-col strips": ["-DFLASH_PROBE_STRIP=16"],
    "16-col strips, copies only": ["-DFLASH_PROBE_STRIP=16", "-DFLASH_PROBE_SKIP=3"],
    "32-col strips": ["-DFLASH_PROBE_STRIP=32"],
    "6 stages": ["-DFLASH_PROBE_STAGES=6"],
    "8 stages": ["-DFLASH_PROBE_STAGES=8"],
    "8 stages, copies only": ["-DFLASH_PROBE_STAGES=8", "-DFLASH_PROBE_SKIP=3"],
}
# txt2img's d=40 at 1,024 rows and d=80 at 256, inpainting's d=48 at 256;
# d=80 and d=128 at 1,024 rows
NARROW_SHAPES = ((16, 8, 1024, 40), (16, 8, 256, 80), (16, 8, 256, 48), (16, 8, 1024, 80),
                 (16, 8, 1024, 128))
WIDE_VARIANTS = {
    "as built": [],
    "no softmax": ["-DFLASH_PROBE_SKIP=1"],
    "copies only": ["-DFLASH_PROBE_SKIP=3"],
    "no V copies": ["-DFLASH_PROBE_SKIP=4"],
    "3 PV warpgroups at d=384": ["-DFLASH_PROBE_PV_GROUPS=3"],
    "no key split": ["-DFLASH_PROBE_SPLIT=0"],
    "key split everywhere": ["-DFLASH_PROBE_SPLIT=1"],
}
# cin256-v2's CFG batch at ds 4 and 2, txt2img's KL-f8 and the flagship's
# VQ-f8 mid attention, cin256-v2's VQ-f4 decode
WIDE_SHAPES = ((12, 1, 1024, 384), (12, 1, 256, 576), (8, 1, 1024, 512), (24, 1, 1024, 512),
               (6, 1, 4096, 512))
DEEP_VARIANTS = {
    "as built": [],
    "no softmax": ["-DFLASH_PROBE_SKIP=1"],
    "copies and exchange only": ["-DFLASH_PROBE_SKIP=3"],
    "copies only": ["-DFLASH_PROBE_SKIP=11"],
    "no V copies": ["-DFLASH_PROBE_SKIP=4"],
    "no exchange": ["-DFLASH_PROBE_SKIP=8"],
    "W = 384 at every d": [],
}
# the head dims chip_smoke.py times it at: 640, 648 and 960; and 1,104
# (d = 1,100 padded: three blocks a cluster)
DEEP_SHAPES = ((4, 2, 1024, 640), (4, 2, 1024, 648), (4, 2, 1024, 960), (4, 2, 1024, 1104))
F32_VARIANTS = {
    "as built": [],
    "flash_deep_kernel at every d": ["-DFLASH_PROBE_DEEP_ABOVE=0"],
    "flash_wide_kernel to 640": ["-DFLASH_PROBE_DEEP_ABOVE=640"],
}
# the float32 card-vs-CPU passes' heads: the UNets' d = 24 .. 96 and d = 160,
# the VAEs' 512, cin256-v2's 384 and 576, and 640, the last d below the deep
# kernel's
F32_SHAPES = ((2, 8, 1024, 24), (2, 8, 1024, 64), (2, 8, 256, 96), (2, 8, 1024, 160),
              (1, 1, 1024, 384), (1, 1, 1024, 512), (1, 1, 256, 576), (2, 2, 1024, 640))
# source: (its variants, its shapes, the variants not run at a head dim, dtype)
PROBES = {
    "flash_attention_sm90": (NARROW_VARIANTS, NARROW_SHAPES,
                             # their 128 registers do not hold the fragments: spills
                             lambda name, d: d > 64 and name in (
                                 "3 consumers", "1 consumer, 2 blocks an SM"),
                             torch.bfloat16),
    "flash_attention_sm90_wide": (WIDE_VARIANTS, WIDE_SHAPES,
                                  lambda name, d: name == "3 PV warpgroups at d=384" and d != 384,
                                  torch.bfloat16),
    "flash_attention_sm90_deep": (DEEP_VARIANTS, DEEP_SHAPES, lambda name, d: False,
                                  torch.bfloat16),
    "flash_attention": (F32_VARIANTS, F32_SHAPES, lambda name, d: False, torch.float32),
}

# the argument some entries take after the output: flash_attention.cu's
# dtype code (0: float32), the deep kernel's depth slice
PRE_ARG = {"flash_attention": lambda name, d: 0,
           "flash_attention_sm90_deep": lambda name, d: (
               384 if name == "W = 384 at every d" else deep_slices(d)[0])}


def _libraries(source: str, variants: dict) -> dict:
    out_dir = build.BUILD_ROOT / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(build.CSRC / f"{source}.cu")
    procs = {}
    for i, (name, flags) in enumerate(variants.items()):
        lib = out_dir / f"lib{source}_probe{i}.so"
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
                                         str(lib), src], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe build {source} {name!r} failed:\n{out}")
        spills = sorted({int(x) for x in re.findall(r"(\d+) bytes spill stores", out)})
        print(f"[probe] build {source} {name}: spill stores {spills} bytes"
              + "".join(f"; {line.strip()[:160]}" for line in out.splitlines()
                        if "Performance Loss" in line), flush=True)
        fn = getattr(ctypes.CDLL(str(lib)), f"ealdm_{source}")
        fn.argtypes = [P, P, P, P] + [I] * (6 if source in PRE_ARG else 5) + [L] * 12 + [F, P]
        fn.restype = I
        libs[name] = fn
    return libs


def _device_ms(fn, iters=20):
    """Device time a call (torch.profiler), taken again, up to three times,
    when a profile records no kernel (as chip_smoke.py's `device_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / iters / 1e3
        if ms > 0:
            return ms
    raise RuntimeError("the profiler recorded no kernel in three profiles")


def main(argv=()):
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash needs a CUDA card")
    which = {"narrow": ["flash_attention_sm90"], "wide": ["flash_attention_sm90_wide"],
             "deep": ["flash_attention_sm90_deep"],
             "f32": ["flash_attention"]}.get(argv[0] if argv else "", list(PROBES))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for source in which:
        variants, shapes, skip, dtype = PROBES[source]
        libs = _libraries(source, variants)
        for shape in shapes:
            b, h, n, d = shape
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            o = torch.empty_like(q)
            strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
            times, outs = {}, []
            for name, fn in libs.items():
                if skip(name, d):
                    continue
                pre = [PRE_ARG[source](name, d)] if source in PRE_ARG else []

                def run(fn=fn, pre=pre):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *pre,
                             b, h, n, n, d, *strides, 1 / math.sqrt(d),
                             torch.cuda.current_stream().cuda_stream)
                    build.check(err, f"probe {source} {name}")

                times[name] = _device_ms(run)
                outs.append(o.clone())
            # the float32 variants compute the same function: how far apart
            diff = "; max |diff| " + ", ".join(
                f"{(out - outs[0]).abs().max().item():.3e}" for out in outs[1:]) \
                if dtype == torch.float32 else ""
            print(f"[probe] {list(shape)} " + "; ".join(f"{name} {ms:.4f}"
                                                         for name, ms in times.items()) + diff,
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
