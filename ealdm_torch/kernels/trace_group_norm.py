"""Phase times of the one-read GroupNorm kernel on the card.

    python -m ealdm_torch.kernels.trace_group_norm

Builds `csrc/group_norm.cu` with -DGN_TRACE into `build/kernels/trace/` and
runs `gn_cluster_kernel` at the UNet's channels_last bfloat16 shapes, each
time on an input just pushed out of the L2. Prints per shape: the CTAs an
SM holds and the clusters the card holds at once; the median and largest
time, over the CTAs, of each phase of a CTA's first sample, from
%globaltimer stamps (each taken after a __syncthreads, which the traced
build adds); the traced kernel's device time; and the device time of
`torch.Tensor.copy_` of x, which reads and writes the same bytes.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from . import build

# stamp slots in the order a CTA takes them, and the phase each one ends
PHASES = ((6, "read + mean pass"), (7, "group sums"), (8, "M2 pass"), (9, "group sums"),
          (1, "stats tail"), (2, "cluster barrier"), (3, "merge"),
          (4, "normalise + write"), (5, "last barrier"))
SHAPES = (((48, 256, 32, 32), True), ((45, 256, 32, 32), True),
          ((48, 768, 32, 32), False), ((48, 1024, 8, 8), True))


def _library() -> ctypes.CDLL:
    out_dir = build.BUILD_ROOT / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libgroup_norm_trace.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DGN_TRACE", "-o", str(lib),
                    str(build.CSRC / "group_norm.cu")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    so.ealdm_group_norm_cl.argtypes = [P] * 5 + [I] * 5 + [L, L, F, I, P]
    so.ealdm_group_norm_cl.restype = I
    so.ealdm_group_norm_trace.argtypes = [P, I]
    so.ealdm_group_norm_cl_residency.argtypes = [I] * 4
    return so


def _device_ms(fn, iters=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("trace_group_norm needs a CUDA card")
    so = _library()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")  # > the L2
    for (n, c, h, w), has_pre in SHAPES:
        x = torch.randn(n, c, h, w, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        y = torch.empty_like(x)
        pre = torch.randn(n, c, device="cuda").to(torch.bfloat16) if has_pre else None
        scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")

        def run():
            err = so.ealdm_group_norm_cl(
                x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                None if pre is None else pre.data_ptr(), 1, n, c, h * w, 32,
                0 if pre is None else c, 1, 1e-5, 1,
                torch.cuda.current_stream().cuda_stream)
            build.check(err, "traced gn_cluster_kernel")

        stamps = (ctypes.c_ulonglong * (16 * 8 * n))()
        addr = ctypes.cast(stamps, ctypes.c_void_p)
        run()
        torch.cuda.synchronize()
        build.check(so.ealdm_group_norm_trace(addr, 8 * n), "trace reset")
        flush.zero_()
        run()
        torch.cuda.synchronize()
        build.check(so.ealdm_group_norm_trace(addr, 8 * n), "trace copy")
        ctas = [stamps[16 * b:16 * b + 16] for b in range(8 * n)]
        ctas = [s for s in ctas if s[0] and s[5]]  # the CTAs of the first round
        res = so.ealdm_group_norm_cl_residency(n, c, h * w, 32)
        t0 = min(s[0] for s in ctas)
        print(f"[{n},{c},{h},{w}] bf16{' + pre-bias' if has_pre else ''}: "
              f"{res // 1000} CTAs an SM, {res % 1000} clusters at once, "
              f"{len(ctas)} CTAs in the first round, which spans "
              f"{(max(s[5] for s in ctas) - t0) / 1e3:.1f} us")
        prev = 0
        for slot, name in PHASES:
            us = [(s[slot] - s[prev]) / 1e3 for s in ctas]
            print(f"  {name:18s} median {statistics.median(us):5.1f} us, "
                  f"largest {max(us):5.1f} us")
            prev = slot
        print(f"  traced kernel {_device_ms(run) * 1e3:.1f} us of device time; "
              f"copy_ of x {_device_ms(lambda: y.copy_(x)) * 1e3:.1f} us", flush=True)


if __name__ == "__main__":
    main()
