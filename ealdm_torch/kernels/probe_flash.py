"""What paces the wgmma flash-attention kernels, timed on copies of them.

    python -m ealdm_torch.kernels.probe_flash          # both kernels
    python -m ealdm_torch.kernels.probe_flash narrow   # flash_attention_sm90.cu only
    python -m ealdm_torch.kernels.probe_flash wide     # flash_attention_sm90_wide.cu only
    python -m ealdm_torch.kernels.probe_flash deep     # flash_attention_sm90_deep.cu only
    python -m ealdm_torch.kernels.probe_flash f32      # flash_attention_sm90_f32.cu only
    python -m ealdm_torch.kernels.probe_flash f32 --earlier OLD/ealdm_torch/kernels/csrc

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
float32 kernel (flash_attention_sm90_f32.cu, split TF32 on mma.sync) at
F32_SHAPES, float32 inputs, on the tiling `ops.attention.tf32x3_tiling`
gives: as built (the key split its entry point chooses); with no key
split, and 2 and 8 blocks a row block's keys; with one TF32 term (hi*hi:
time only, it misses 1e-4); without the softmax; the copies alone (no
products, no softmax); everything but the copies (the products read
whatever shared memory holds); and, at d <= 256 (the instances whose row
groups make whole warpgroups of 64 rows; also at F32_WGMMA_SHAPES, the
widest d of two of them at 1,024 rows), every such instance on mma.sync,
with S on wgmma m64nNk8 TF32 (K's tile staged in wgmma's layout, its lo
staged beside it), with P V on wgmma (V transposed into hi and lo tiles
while staging, TF32 having no transpose bit), and with both ("as built":
each instance's own choice). Each build prints every kernel's registers
and spilled bytes. With `--earlier`, the float32 entry of an earlier tree's
flash_attention.cu (its FMA kernels) is built from that directory and
timed beside it, and both trees' bfloat16 route at [2, 2, 1024, 1928]. A
variant that leaves work out computes garbage: only its time is read; the
wgmma variants compute the same function, and their distance from "as
built" is printed. Prints one line per shape, and the card's name and
power limit; `chip_smoke.py` phase 2c times the routed kernel at the same
shapes beside the library call.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess

import torch

from . import build
from ..ops.attention import deep_slices, tf32x3_tiling

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
    "1 TF32 term": ["-DFLASH_PROBE_TERMS=1"],
    "no softmax": ["-DFLASH_PROBE_SKIP=1"],
    "copies only": ["-DFLASH_PROBE_SKIP=3"],
    "no copies": ["-DFLASH_PROBE_SKIP=4"],
    "mma.sync": ["-DFLASH_PROBE_WGMMA=0"],
    "wgmma S": ["-DFLASH_PROBE_WGMMA=1"],
    "wgmma P V": ["-DFLASH_PROBE_WGMMA=2"],
    "wgmma S and P V": ["-DFLASH_PROBE_WGMMA=3"],
}
# the float32 head dims whose instances have wgmma variants (WR = 4), and
# two shapes more for them: d = 128 and 256 at 1,024 rows
F32_WGMMA_DIMS = range(8, 257, 8)
F32_WGMMA_VARIANTS = ("mma.sync", "wgmma S", "wgmma P V", "wgmma S and P V")
F32_WGMMA_SHAPES = ((2, 8, 1024, 128), (2, 8, 1024, 256))
# key splits timed on the "as built" library beside the one the entry
# chooses (None)
F32_SPLITS = (None, 1, 2, 8)
# the float32 card-vs-CPU passes' heads: the UNets' d = 24 .. 96 and d = 160,
# the VAEs' 512, cin256-v2's 384 and 576, and 640
F32_SHAPES = ((2, 8, 1024, 24), (2, 8, 1024, 64), (2, 8, 256, 96), (2, 8, 1024, 160),
              (1, 1, 1024, 384), (1, 1, 1024, 512), (1, 1, 256, 576), (2, 2, 1024, 640))
# the bfloat16 head past the deep wgmma kernel's 1,920
BF16_DEEP_SHAPE = (2, 2, 1024, 1928)
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
}

# the argument some entries take after the output: the deep kernel's depth
# slice
PRE_ARG = {"flash_attention_sm90_deep": lambda name, d: (
               384 if name == "W = 384 at every d" else deep_slices(d)[0])}


def _config(entry: str) -> str:
    """A mangled kernel name's template integers (`Config<...>`), or the
    name itself: "flash_tf32x3_kernel<128,2,4,32,1>"."""
    name = re.search(r"\d+(flash_\w+?_kernel)", entry)
    args = re.findall(r"Li(\d+)E", entry)
    return f"{name.group(1) if name else entry[-40:]}<{','.join(args)}>"


def _compile(source: str, variants: dict, csrc=build.CSRC) -> dict:
    """{variant: the loaded library} of `csrc/<source>.cu` built once per
    variant's flags, all nvcc processes at once."""
    out_dir = build.BUILD_ROOT / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(csrc / f"{source}.cu")
    tag = "" if csrc == build.CSRC else "_earlier"
    procs = {}
    for i, (name, flags) in enumerate(variants.items()):
        lib = out_dir / f"lib{source}{tag}_probe{i}.so"
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o",
                                         str(lib), src], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe build {source} {name!r} failed:\n{out}")
        # each entry's mangled name, its spill line and its registers
        entries = [f"{_config(entry)} {regs} registers, {st} bytes spilled"
                   for entry, st, regs in re.findall(
                       r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                       r"Used (\d+) registers", out, re.S)]
        print(f"[probe] build {source} {name}: {'; '.join(entries)}"
              + "".join(f"; {line.strip()[:160]}" for line in out.splitlines()
                        if "Performance Loss" in line), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _libraries(source: str, variants: dict) -> dict:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    libs = {}
    for name, lib in _compile(source, variants).items():
        fn = getattr(lib, f"ealdm_{source}")
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


def probe_f32(gen, earlier=None):
    """The float32 kernel's variants and key splits at F32_SHAPES, beside
    the float32 entry of the earlier tree's flash_attention.cu in
    directory `earlier` (its FMA kernels), and both routes at bfloat16
    BF16_DEEP_SHAPE. Prints a line a shape: device ms each, and how far the
    variants that compute the same function are from "as built"."""
    from pathlib import Path

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    source = "flash_attention_sm90_f32"
    libs = _compile(source, F32_VARIANTS)
    fns, splits_of = {}, {}  # each variant's entry, and the key split it chooses
    for name, lib in libs.items():
        fns[name] = lib.ealdm_flash_attention_sm90_f32
        fns[name].argtypes = [P] * 6 + [I] * 10 + [L] * 12 + [F, P]
        fns[name].restype = I
        splits_of[name] = lib.ealdm_flash_attention_sm90_f32_splits
        splits_of[name].argtypes, splits_of[name].restype = [I] * 9, I
    old = None
    if earlier:
        old = _compile("flash_attention", {"earlier": []}, Path(earlier))["earlier"] \
            .ealdm_flash_attention
        old.argtypes = [P, P, P, P] + [I] * 6 + [L] * 12 + [F, P]
        old.restype = I
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, shapes in ((torch.float32, F32_SHAPES + F32_WGMMA_SHAPES),
                          (torch.bfloat16, (BF16_DEEP_SHAPE,))):
        code = 0 if dtype == torch.float32 else 1
        for shape in shapes:
            b, h, n, d = shape
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            o = torch.empty_like(q)
            strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
            tiling = tf32x3_tiling(d, dtype)
            routed = splits_of["as built"](code, *tiling, b, h, n, n, d)
            ntiles = -(-n // tiling[0])
            runs = {}
            for name, fn in fns.items():
                if name == "as built" or dtype == torch.float32 and (
                        name not in F32_WGMMA_VARIANTS or d in F32_WGMMA_DIMS):
                    ks = splits_of[name](code, *tiling, b, h, n, n, d)
                    runs[f"{name}, KS={ks}"] = (fn, ks)
            runs.update({f"as built, KS={ks}": (fns["as built"], ks) for ks in F32_SPLITS[1:]
                         if ks != routed and ks <= ntiles and dtype == torch.float32})
            times, outs = {}, {}
            for name, (fn, ks) in runs.items():
                part = torch.empty(ks * b * h * n * d, device="cuda")
                ml = torch.empty(ks * b * h * n * 2, device="cuda")

                def run(fn=fn, ks=ks, part=part, ml=ml):
                    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   part.data_ptr(), ml.data_ptr(), ks, code, *tiling, b, h, n,
                                   n, d, *strides, 1 / math.sqrt(d), stream), f"probe {name}")

                times[name] = _device_ms(run)
                outs[name] = o.float().clone()
            if old is not None:
                def run_old():
                    build.check(old(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), code,
                                    b, h, n, n, d, *strides, 1 / math.sqrt(d), stream),
                                "probe earlier")

                times["earlier flash_attention.cu"] = _device_ms(run_old)
                outs["earlier flash_attention.cu"] = o.float().clone()
            ref = outs[f"as built, KS={routed}"]
            same = list(outs)
            print(f"[probe] {str(dtype)[6:]} {list(shape)} " + "; ".join(
                f"{name} {ms:.4f}" for name, ms in times.items()) + "; max |diff| from as built: "
                + ", ".join(f"{name} {(outs[name] - ref).abs().max().item():.3e}"
                            for name in same if outs[name] is not ref), flush=True)
            del q, k, v, o, outs


def main(argv=()):
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if argv and argv[0] == "f32":
        earlier = argv[argv.index("--earlier") + 1] if "--earlier" in argv else None
        probe_f32(gen, earlier)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
              .stdout.strip())
        return
    which = {"narrow": ["flash_attention_sm90"], "wide": ["flash_attention_sm90_wide"],
             "deep": ["flash_attention_sm90_deep"]}.get(argv[0] if argv else "", list(PROBES))
    for source in which:
        variants, shapes, skip, dtype = PROBES[source]
        libs = _libraries(source, variants)
        for shape in shapes:
            b, h, n, d = shape
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            o = torch.empty_like(q)
            strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
            times = {}
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
            print(f"[probe] {list(shape)} " + "; ".join(f"{name} {ms:.4f}"
                                                         for name, ms in times.items()),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
