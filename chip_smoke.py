#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ealdm_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # phases 1-2b only: a new kernel's first call
    python3 chip_smoke.py --groupnorm  # the build and phase 2's GroupNorm part only
    python3 chip_smoke.py --train      # the build and phase 6 (training) only

Phases, each of which raises (non-zero exit) on failure:
  1. build every kernel from `ealdm_torch/kernels/csrc/*.cu` with nvcc, and
     take a census of the bfloat16 flash kernels' and the GroupNorm kernels'
     machine code (tensor-core, async-copy, ldmatrix and exp instructions;
     ptxas spills);
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes and layouts, in bfloat16 and float32, show that two planted
     faults break the bfloat16 attention limits, and time kernel / plain /
     one PyTorch library call (a yardstick only; the port never calls it);
     GroupNorm in both layouts it takes, timed at the main path's
     (channels_last) on inputs that do not fit the L2;
  2b. the op library entry point `ealdm_torch.ops` at full width: the
     bias_act kernel against `bias_act_plain` (nine activations, any dim,
     three dtypes), first- and second-order gradients, then filtered_lrelu
     and EqualizedDense(lrelu) with their bias_act launches counted, a
     float32 check against the CPU, and the bias_act timings;
  3. the main path at the flagship width: LatentDiffusion in bfloat16 with
     seeded random weights, `sample_images` at batch 24, DDIM-50, eta 1,
     CFG 2, hoisted invariants, with the launch counts checked against what
     the module tree implies (GroupNorm by path, layout and shape), three
     timed runs (img/s from the median),
     then one more run under torch.profiler for
     the device time by kernel and the device's idle share;
  4. the same program under the packed attention layout for a few steps,
     held against the "flash" layout at the same seed;
  5. a reference check: flagship width at batch 1, 2 steps, float32, the
     card (kernels) against the CPU (plain versions) on the same inputs;
  6. training, `bench.py --train`'s step (`config.FLAGSHIP_TRAIN`): (a) the
     GroupNorm and flash Functions' gradients against autograd through
     their plain versions at the train step's shapes; (b) the flagship train
     step at batch 24 in bfloat16 with remat "dots" (a warm-up and five
     timed steps, launches per step checked against the module tree, one
     profiled step: device time by group and the idle share; three steps
     each under "none" and "full" for their time and peak); (c) gradient
     completeness after the first step; (e) that step's numbers: the
     gradient of one bf16 batch-24 step with the kernels against the same
     step with each kernel launch replaced by its plain version, and a
     planted GroupNorm fault that must fail the same limit; (d) one float32
     train step at batch 1, the card against the CPU.

The last lines of output are a `[train]` JSON line with phase 6's numbers,
the card's name and power limit, a JSON line with every kernel's numbers
(not with --train), and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build")  # gitignored, beside the kernel builds

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside them, device memory bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exp2 on the SFU: 16 results a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput table, compute capability 9.0); see
# `peak_exp` for the clock.
SFU_EXP_PER_CLOCK = 16

# the redesigned bfloat16 flash kernels, as named in flash_attention.cu
MMA_KERNELS = ("flash_mma_d32_kernel", "flash_mma_d512_kernel")
# the channels_last GroupNorm kernels (group_norm.cu): the two that stage
# rows in shared memory by asynchronous copies, and the streaming one; and
# the NCHW kernels kept from PR 1
GN_STAGING_KERNELS = ("gn_cluster_kernel", "gn_tile_stats_kernel")
GN_KERNELS = (*GN_STAGING_KERNELS, "gn_tile_apply_kernel", "gn_single_kernel",
              "gn_partial_kernel", "gn_apply_kernel")
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "UBLKCP", "LDSM", "MUFU.EX2")
ASYNC_COPY_OPS = ("LDGSTS", "UTMALDG", "UBLKCP")
L2_BYTES = 50e6  # H100 L2; timed inputs rotate over more than twice this


def tolerance(dtype, want):
    """Per-element limit of kernel vs plain version. Both compute in float32
    (sums in another order, which differ by a few 1e-6 at most) and round
    once to the output dtype. float32: 1e-4. bfloat16: the two roundings
    leave the results at most one bf16 ulp apart, and an ulp is at most
    2^-7 of the value; the limit is two ulps of each reference element plus
    the float32 limit. bfloat16 attention has limits of its own, which also
    cover the kernel's rounding of P (`bf16_attention_shares`)."""
    if str(dtype) == "torch.float32":
        return 1e-4
    return 2 * 2**-7 * want.float().abs() + 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query="name,power.limit", fmt="csv,noheader") -> str:
    """The first card's line of `nvidia-smi --query-gpu=<query>`."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def peak_exp():
    """exp2 results a second on the SFUs: 16 a clock per SM x the card's SMs
    x its maximum SM clock, as nvidia-smi reads it."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXP_PER_CLOCK * sms * mhz * 1e6


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops, exps=0):
    """Least time in ms, and what sets it: the operations at `peak_flops`,
    the bytes at the memory rate, or the exponentials at the SFU's rate."""
    times = {"operations": flops / peak_flops, "bytes": nbytes / PEAK_BYTES,
             "exp": exps / peak_exp() if exps else 0.0}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def device_ms_by_kernel(fn, iters=20, warmup=2):
    """{kernel: device time per call in ms} of the CUDA kernels `fn` runs,
    under torch.profiler over `iters` calls; a kernel is named by its
    function (the profiler's key up to the template arguments). A kernel's
    time per call is its mean time a launch times its launches a call, so a
    launch the profiler misses does not pull the mean down."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
            name = m.group(1) if m else e.key
            per_call = max(1, round(e.count / iters))
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / e.count * per_call / 1e3)
    return out


def device_ms(fn, iters=20, warmup=2):
    """Device time per call: the sum of every CUDA kernel's time under
    torch.profiler over `iters` calls. Unlike `cuda_ms` it leaves out the
    gaps where the device waits for the host, which dominate a call of a
    few microseconds."""
    ms = sum(device_ms_by_kernel(fn, iters, warmup).values())
    if ms <= 0:
        raise RuntimeError("the profiler saw no device time")
    return ms


def compare(errs, kernel, dtype, got, want, what, attn=None):
    """Raise unless `got` is within its limits of `want`: `tolerance`
    element by element or, for bfloat16 attention (`attn` = (q, k, v,
    heads)), both limits of `bf16_attention_shares`. Keeps the largest
    bfloat16 error per kernel in `errs`."""
    import torch

    from ealdm_torch.ops.attention import bf16_attention_shares

    err = (got.float() - want.float()).abs().max().item()
    if attn is not None and dtype == torch.bfloat16:
        q, k, v, heads = attn
        shares = bf16_attention_shares(got, q, k, v, want, heads)
    else:
        shares = ((got.float() - want.float()).abs() / tolerance(dtype, want)).max().item(),
    text = " and ".join(f"{x:.3g} of the {kind} limit"
                        for x, kind in zip(shares, ("per-element", "RMS")))
    if not all(math.isfinite(x) and x <= 1 for x in shares):
        raise RuntimeError(f"{kernel} {what} {dtype}: max abs err {err:.3g}, {text}")
    if dtype == torch.bfloat16:
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    log(f"  {kernel:24s} {what:34s} {str(dtype):15s} max_abs_err {err:.3g} ({text})")


def coarse_p_attention(q, k, v, bits):
    """A planted fault: flash_attention_plain with P rounded to nearest with
    a `bits`-bit significand before P*V (bfloat16 has 8), the row sums
    unrounded."""
    import torch

    s = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    m, e = torch.frexp(p)
    p_coarse = torch.ldexp(torch.round(m * 2**bits) / 2**bits, e)
    return (torch.matmul(p_coarse, v.float()) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


# ------------------------------------------------------------------ phase 1
def phase_build():
    from ealdm_torch.kernels import build

    t0 = time.perf_counter()
    names = list(build.build_all())
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name in names:
            f.write(f"--- {name}\n{build.build_report(name)}\n")
    for name in names:
        for line in build.build_report(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"[build] {len(names)} sources built or found built in {secs:.1f} s")
    return secs


def sass_census(source, names):
    """{kernel: counts of SASS_OPS} from `cuobjdump -sass` of the library
    built from `csrc/<source>.cu`, and {kernel: registers and spill bytes}
    from its nvcc report, each summed (counts) or maximised (registers,
    spills) over a kernel's template instances."""
    import re

    from ealdm_torch.kernels import build

    lib = build.library_path(source)
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=True, timeout=300).stdout
    op_re = re.compile(r"\b(" + "|".join(re.escape(op) for op in SASS_OPS) + r")\b")
    census, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line), None)
            if current:
                census.setdefault(current, dict.fromkeys(SASS_OPS, 0))
        elif current:
            for op in op_re.findall(line):
                census[current][op] += 1
    # ptxas -v: "Compiling entry function '<name>'", then "... N bytes spill
    # stores, M bytes spill loads" and "Used R registers"
    ptxas, current = {}, None
    for line in build.build_report(source).splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in names if k in line), None)
        elif current and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            d = ptxas.setdefault(current, {})
            d["spill_bytes"] = max(d.get("spill_bytes", 0), int(st) + int(ld))
        elif current and "Used" in line:
            d = ptxas.setdefault(current, {})
            d["registers"] = max(d.get("registers", 0),
                                 int(re.search(r"Used (\d+) registers", line).group(1)))
    for name in names:
        log(f"[sass] {name}: {census.get(name)}; ptxas {ptxas.get(name)}")
        if name not in census:
            raise RuntimeError(f"{name} is not in {lib}")
        if "spill_bytes" not in ptxas.get(name, {}):
            raise RuntimeError(f"{name} has no spill line in the nvcc report")
        if ptxas[name]["spill_bytes"]:
            raise RuntimeError(f"{name} spills: {ptxas[name]}")
    return census


def phase_sass():
    """Machine-code census: the bfloat16 flash kernels need tensor-core
    (HMMA/HGMMA) and asynchronous-copy instructions, the GroupNorm kernels
    that stage rows in shared memory asynchronous copies (LDGSTS, UTMALDG or
    the bulk copy UBLKCP); no kernel of either may spill. Raises otherwise,
    or if a kernel is missing from the machine code or the nvcc report."""
    flash = sass_census("flash_attention", MMA_KERNELS)
    for name, c in flash.items():
        if c["HMMA"] + c["HGMMA"] == 0:
            raise RuntimeError(f"{name} has no tensor-core instruction")
        if not any(c[op] for op in ASYNC_COPY_OPS):
            raise RuntimeError(f"{name} has no asynchronous copy")
    gn = sass_census("group_norm", GN_KERNELS)
    for name in GN_STAGING_KERNELS:
        if not any(gn[name][op] for op in ASYNC_COPY_OPS):
            raise RuntimeError(f"{name} has no asynchronous copy")
    return flash, gn


# ------------------------------------------------------------------ phase 2
def phase_kernels():
    """Returns {kernel name: numbers} for the JSON line; `launches` stays
    None until a main-path run fills it in."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import (
        _split_heads, bf16_attention_shares, flash_attention, flash_attention_packed,
        flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    errs = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check_attn(name, q, k, v, what, heads=None):
        if heads is None:
            got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        else:
            got = flash_attention_packed(q, k, v, heads)
            want = flash_attention_plain(*(_split_heads(t, heads) for t in (q, k, v)))
            want = want.transpose(1, 2).reshape(q.shape)
        compare(errs, name, q.dtype, got, want, what, attn=(q, k, v, heads))

    # -- flash attention [B, H, N, D], contiguous
    attn_cases = [("flash_attention_d32", (48, 8, 1024, 32)),
                  ("flash_attention_d32", (48, 16, 256, 32)),
                  ("flash_attention_d512", (24, 1, 1024, 512)),
                  ("flash_attention_d512", (48, 1, 1024, 512))]
    for name, shape in attn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
            check_attn(name, q, k, v, f"[B,H,N,D]={list(shape)}")
    # -- the head-strided view of a [B, N, H*D] projection (the main path)
    for heads, shape in ((8, (48, 1024, 256)), (16, (48, 256, 512))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (_split_heads(randn(*shape, dtype=dtype), heads) for _ in range(3))
            check_attn("flash_attention_d32", q, k, v,
                       f"split view of {list(shape)} H={heads}")
    # a ragged key/query count is masked inside the kernel
    for d in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(2, 2, 200, d, dtype=dtype)
            k, v = randn(2, 2, 77, d, dtype=dtype), randn(2, 2, 77, d, dtype=dtype)
            check_attn(f"flash_attention_d{d}", q, k, v, "ragged Nq=200 Nk=77")
    # -- packed [B, N, H*D]
    for heads, shape in ((8, (48, 1024, 256)), (16, (48, 256, 512))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
            check_attn("flash_attention_packed", q, k, v,
                       f"[B,N,HD]={list(shape)} H={heads}", heads)
    # -- the limits' teeth at the main path's largest d=32 shape: two planted
    #    faults, each of which one of the two limits must catch
    q, k, v = (randn(48, 8, 1024, 32, dtype=torch.bfloat16) for _ in range(3))
    want = flash_attention_plain(q, k, v)
    readings = {
        "sound kernel": flash_attention(q, k, v),
        # the kernel run without the last 64-key tile: a kernel that skipped it
        "kernel, last key tile dropped": flash_attention(q, k[:, :, :-64], v[:, :, :-64]),
        "P rounded to 4 bits (fp8 significand)": coarse_p_attention(q, k, v, bits=4),
    }
    for what, got in readings.items():
        elem, rms = bf16_attention_shares(got, q, k, v, want)
        log(f"[limit] [48,8,1024,32] {what}: {elem:.3g} of the per-element limit, "
            f"{rms:.3g} of the RMS limit")
        if (max(elem, rms) <= 1) != (what == "sound kernel"):
            raise RuntimeError(f"the bfloat16 attention limits misjudge: {what}")
    torch.cuda.synchronize()

    # -- timing at the main path's largest shape of each kernel, bfloat16
    bf = torch.bfloat16
    res = {}

    def attn_row(row, kernel, shape, layout, kernel_fn, plain_fn, lib_fn, replaces, qkv,
                 counter=None):
        """`row` names the JSON row, `kernel` the error record it reports and
        the launch counter it reads, or `counter` = (kernel, query rows) its
        launches at one shape."""
        b, h, n, d = shape
        flops = 4 * b * h * n * n * d
        nbytes = 4 * b * h * n * d * 2
        bms, by = bound(flops, nbytes, PEAK_BF16, exps=b * h * n * n)
        # The exponentials are operations too (on the SFU, at their own
        # rate); `bound_kind` says which limit it is. Times are device time
        # (torch.profiler), which leaves out the wrapper's host time; the
        # CUDA-event time per call (`event_ms`) is kept beside the kernel's.
        res[row] = dict(
            name=row, route="cuda", source="ealdm_torch/kernels/csrc/flash_attention.cu",
            replaces=replaces, launches=None, max_abs_err=errs[kernel],
            ms=device_ms(lambda: kernel_fn(*qkv)), plain_ms=device_ms(lambda: plain_fn(*qkv)),
            bound_ms=bms, bound_by="bytes" if by == "bytes" else "operations",
            bound_kind=by, library_ms=device_ms(lambda: lib_fn(*qkv)),
            event_ms=cuda_ms(lambda: kernel_fn(*qkv)),
            shape=list(shape), layout=layout, dtype="bfloat16", counter=counter or kernel)

    def packed(fn, heads):  # [B,H,N,D] attention on packed [B,N,H*D] q/k/v
        return lambda q, k, v: fn(*(_split_heads(t, heads) for t in (q, k, v))) \
            .transpose(1, 2).reshape(q.shape)

    sdpa_lib = F.scaled_dot_product_attention
    flash_replaces = "ealdm_tpu/ops/attention.py:77"
    for row, shape in (("flash_attention_d32", (48, 8, 1024, 32)),
                       ("flash_attention_d512", (24, 1, 1024, 512))):
        qkv = [randn(*shape, dtype=bf) for _ in range(3)]
        attn_row(row, row, shape, "contiguous [B,H,N,D]", flash_attention,
                 flash_attention_plain, sdpa_lib, flash_replaces, qkv)
    # the d=32 kernel on the main path's layout: the head-strided view of the
    # [B, N, H*D] projection, at both UNet levels that take it
    for row, (b, n, heads) in (("flash_attention_d32_split_n1024", (48, 1024, 8)),
                               ("flash_attention_d32_split_n256", (48, 256, 16))):
        qkv = [_split_heads(randn(b, n, heads * 32, dtype=bf), heads) for _ in range(3)]
        attn_row(row, "flash_attention_d32", (b, heads, n, 32),
                 f"head-strided view of [{b},{n},{heads * 32}]", flash_attention,
                 flash_attention_plain, sdpa_lib, flash_replaces, qkv,
                 counter=("flash_attention_d32", n))
    b, n, heads = 48, 1024, 8
    qkv = [randn(b, n, heads * 32, dtype=bf) for _ in range(3)]
    attn_row("flash_attention_packed", "flash_attention_packed", (b, heads, n, 32),
             f"packed [{b},{n},{heads * 32}]",
             lambda q, k, v: flash_attention_packed(q, k, v, heads),
             packed(flash_attention_plain, heads), packed(sdpa_lib, heads),
             "ealdm_tpu/ops/attention.py:272", qkv)
    log_rows(res)
    return res


def log_rows(rows):
    for r in rows.values():
        event = f" (event_ms {r['event_ms']:.4f})" if "event_ms" in r else ""
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        split = "".join(f" {k} {v:.4f}" for k, v in r.get("kernel_ms", {}).items())
        log(f"[time] {r['name']:32s} {r['shape']} kernel_ms {r['ms']:.4f}{event} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {r['bound_ms']:.4f} ({r.get('bound_kind', r['bound_by'])})"
            + (f"; by kernel:{split}" if len(r.get("kernel_ms", {})) > 1 else ""))


def phase_group_norm():
    """The GroupNorm kernels against `group_norm_plain` at the main path's
    shapes, in both layouts the kernels take (channels_last, what the main
    path hands them, and NCHW-contiguous), both dtypes, plain and pre-bias +
    SiLU; then bfloat16 timings. Each row names the counter its launches
    moved: "group_norm" (one read of x) or "group_norm_two_pass" (two),
    suffixed "_nchw" for the NCHW kernels. Returns the JSON line's rows."""
    import itertools

    import torch
    import torch.nn.functional as F

    from ealdm_torch import kernels
    from ealdm_torch.ops.norms import group_norm_kernel, group_norm_plain, silu

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf = torch.float32, torch.bfloat16
    errs = {}

    def randn(*shape, dtype=f32, layout="channels_last"):
        x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        if len(shape) == 4 and layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def run(x, *args):
        """The kernel's output and the row its launch counted under."""
        before = dict(kernels.launches)
        y = group_norm_kernel(x, *args)
        name = next(k for k in ("group_norm", "group_norm_two_pass")
                    if kernels.launches[k] != before[k])
        return y, name if x.is_contiguous(memory_format=torch.channels_last) else name + "_nchw"

    cases = [((48, 256, 32, 32), 1e-5), ((48, 512, 16, 16), 1e-5), ((48, 1024, 8, 8), 1e-5),
             ((48, 768, 32, 32), 1e-5), ((24, 128, 256, 256), 1e-6),
             ((48, 256, 128, 128), 1e-6)]
    for shape, eps in cases:
        c = shape[1]
        scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
        for layout, dtype in itertools.product(("channels_last", "nchw"), (f32, bf)):
            x = (3 * randn(*shape, layout=layout) + 1).to(dtype)
            pre = randn(shape[0], c, dtype=dtype)
            for fuse, p in ((False, None), (True, pre)):
                got, row = run(x, scale, bias, 32, eps, fuse, p)
                want = group_norm_plain(x, scale, bias, 32, eps, silu if fuse else None,
                                        "NCHW", p)
                compare(errs, row, dtype, got, want,
                        f"{list(shape)} {layout} {'pre_bias+SiLU' if fuse else 'plain'}")
    torch.cuda.synchronize()

    # -- bfloat16 timings. Inputs rotate over enough tensors to pass twice the
    #    L2, so each call reads them from device memory, as the main path's
    #    fresh activations are. Device time (torch.profiler) leaves out the
    #    wrapper's host time; the CUDA-event time per call is kept beside it.
    res = {}
    single = "ealdm_tpu/ops/group_norm_pallas.py:103"
    chunked = "ealdm_tpu/ops/group_norm_pallas.py:123"
    timed = [  # row, shape, eps, pre-bias, layout, the TPU kernel
        ("group_norm", (48, 256, 32, 32), 1e-5, True, "channels_last", single),
        ("group_norm_c768", (48, 768, 32, 32), 1e-5, False, "channels_last", single),
        ("group_norm_8x8", (48, 1024, 8, 8), 1e-5, True, "channels_last", single),
        ("group_norm_two_pass", (24, 128, 256, 256), 1e-6, False, "channels_last", chunked),
        ("group_norm_two_pass_b48", (48, 128, 256, 256), 1e-6, False, "channels_last",
         chunked),
        ("group_norm_nchw", (48, 256, 32, 32), 1e-5, True, "nchw", single),
        ("group_norm_two_pass_nchw", (24, 128, 256, 256), 1e-6, False, "nchw", chunked),
    ]
    for row, shape, eps, has_pre, layout, replaces in timed:
        n_, c = shape[:2]
        scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        numel = math.prod(shape)
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * numel)))
        inputs = [(randn(*shape, dtype=bf, layout=layout),
                   randn(n_, c, dtype=bf) if has_pre else None) for _ in range(copies)]
        _, path_row = run(inputs[0][0], scale, bias, 32, eps, True, inputs[0][1])
        nbytes = 2 * numel * 2 + (n_ * c * 2 if has_pre else 0) + 2 * c * 4
        bms, by = bound(10 * numel, nbytes, PEAK_FP32)

        def rotate(fn):
            it = itertools.cycle(inputs)
            return lambda: fn(*next(it))

        def kernel(x, p):
            return group_norm_kernel(x, scale, bias, 32, eps, True, p)

        def plain(x, p):
            return group_norm_plain(x, scale, bias, 32, eps, silu, "NCHW", p)

        def lib(x, p):
            xin = x if p is None else x + p[:, :, None, None]
            return F.silu(F.group_norm(xin, 32, scale.to(x.dtype), bias.to(x.dtype), eps))

        iters = 20 if numel < 2e8 else 10
        split = device_ms_by_kernel(rotate(kernel), iters)
        res[row] = dict(
            name=row, route="cuda", source="ealdm_torch/kernels/csrc/group_norm.cu",
            replaces=replaces, launches=None, max_abs_err=errs[path_row],
            ms=sum(split.values()), kernel_ms=split, plain_ms=device_ms(rotate(plain), iters),
            bound_ms=bms, bound_by=by, library_ms=device_ms(rotate(lib), iters),
            event_ms=cuda_ms(rotate(kernel), iters), shape=list(shape), layout=layout,
            dtype="bfloat16", pre_bias=has_pre, silu=True, rotated_inputs=copies,
            counter=(path_row.removesuffix("_nchw"), (layout, shape, "bfloat16")))
        del inputs
    # the main rows count every launch of their kernel path
    for row in ("group_norm", "group_norm_two_pass"):
        res[row]["counter"] = row
    log_rows(res)
    return res


# ------------------------------------------------------------------ phase 2b
def phase_ops():
    """The op library entry point at full width. Returns the bias_act row
    of the JSON line, with `launches` from the op-path run: one
    filtered_lrelu call (two bias_act launches) and one
    EqualizedDense(lrelu) call (one)."""
    import torch

    from ealdm_torch import kernels, ops
    from ealdm_torch.models.stdiff import EqualizedDense
    from ealdm_torch.ops.bias_act import bias_act_kernel, bias_act_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    f32, bf, fp16 = torch.float32, torch.bfloat16, torch.float16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def check(dtype, got, want, what):
        compare(errs, "bias_act", dtype, got, want, what)

    # -- the kernel against bias_act_plain
    nhwc, nchw = (48, 32, 32, 256), (48, 256, 32, 32)
    b256 = randn(256)
    for dtype in (f32, bf):
        x = (2 * randn(*nhwc)).to(dtype)
        for act in ops.activation_funcs:
            check(dtype, bias_act_kernel(x, b256, act=act), bias_act_plain(x, b256, act=act),
                  f"{act} {list(nhwc)} bias")
        x = (2 * randn(*nchw)).to(dtype)
        check(dtype, bias_act_kernel(x, b256, dim=1, act="lrelu"),
              bias_act_plain(x, b256, dim=1, act="lrelu"), f"lrelu {list(nchw)} dim=1")
        kw = dict(act="swish", gain=0.7, clamp=1.5)
        check(dtype, bias_act_kernel(x, b256, dim=1, **kw), bias_act_plain(x, b256, dim=1, **kw),
              "swish gain 0.7 clamp 1.5 dim=1")
        x, b13 = randn(7, 13, 129, dtype=dtype), randn(13)
        for act in ("lrelu", "softplus", "selu"):
            check(dtype, bias_act_kernel(x, b13, dim=1, act=act, clamp=2.0),
                  bias_act_plain(x, b13, dim=1, act=act, clamp=2.0),
                  f"{act} ragged [7,13,129] dim=1 clamp 2")
    x = randn(*nhwc, dtype=fp16)
    check(fp16, bias_act_kernel(x, b256, act="lrelu"), bias_act_plain(x, b256, act="lrelu"),
          f"lrelu {list(nhwc)} bias")

    # -- first- and second-order gradients: the autograd path (kernel
    #    forward, plain backward) against the plain version
    grads = {}
    x0, b0 = randn(4, 8, 8, 32), randn(32)
    for name, fn in (("kernel", ops.bias_act), ("plain", bias_act_plain)):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(x, b, act="swish", clamp=3.0)
        (g,) = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
        grads[name] = (g, *torch.autograd.grad((g ** 2).sum(), (x, b)))
    for what, got, want in zip(("dx", "d2x", "d2b"), grads["kernel"], grads["plain"]):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"  bias_act autograd {what}: max diff / max|plain| {rel:.3g} (tolerance 1e-5)")
        if not rel <= 1e-5:
            raise RuntimeError(f"bias_act {what} disagrees with the plain version: {rel:.3g}")

    # -- the op path: filtered_lrelu and EqualizedDense, launches counted
    fir = ops.setup_filter([1, 3, 3, 1])
    fl_kw = dict(up=2, down=2, padding=3)
    x_fl = randn(*nhwc, dtype=bf)
    dense = EqualizedDense(512, 512, activation="lrelu", lr_multiplier=0.01).cuda()
    with torch.no_grad():
        dense.weight.copy_(randn(512, 512) * 100)
        dense.bias.copy_(randn(512))
    w = randn(48, 512)

    def flrelu_plain(x, b):
        y = ops.upfirdn2d(bias_act_plain(x, b), fir, up=2, padding=3, gain=4)
        return ops.upfirdn2d(bias_act_plain(y, None, act="lrelu", gain=math.sqrt(2)),
                             fir, down=2).to(x.dtype)

    kernels.reset_launch_counts()
    y_fl = ops.filtered_lrelu(x_fl, fir, fir, b256, **fl_kw)
    torch.cuda.synchronize()
    fl_launches = kernels.launches["bias_act"]
    with torch.no_grad():
        y_d = dense(w)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"[ops] launches {counts}: filtered_lrelu {fl_launches}, EqualizedDense(lrelu) "
        f"{counts['bias_act'] - fl_launches}")
    if fl_launches != 2 or counts["bias_act"] != 3:
        raise RuntimeError("expected 2 bias_act launches per filtered_lrelu call and 1 per "
                           f"EqualizedDense(lrelu) call, got {counts}")
    if any(n for k, n in counts.items() if k != "bias_act"):
        raise RuntimeError(f"the op path launched other kernels: {counts}")
    if tuple(y_fl.shape) != nhwc or y_fl.dtype != bf:
        raise RuntimeError(f"filtered_lrelu gave {tuple(y_fl.shape)} {y_fl.dtype}")
    check(bf, y_fl, flrelu_plain(x_fl, b256), f"filtered_lrelu {list(nhwc)}")
    with torch.no_grad():
        h = w @ (dense.weight.T * (0.01 / math.sqrt(512)))
        check(f32, y_d, bias_act_plain(h, dense.bias * 0.01, act="lrelu"),
              "EqualizedDense(lrelu) [48,512]")

    # -- float32 on the card (kernels) against the CPU (plain versions)
    xs, bs = randn(2, 16, 16, 32), randn(32)
    got = ops.filtered_lrelu(xs, fir, fir, bs, clamp=1.0, **fl_kw).cpu()
    want = ops.filtered_lrelu(xs.cpu(), fir, fir, bs.cpu(), clamp=1.0, **fl_kw)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[ops] filtered_lrelu float32 card vs CPU: max diff / max|y| {rel:.3g} "
        f"(tolerance 1e-5)")
    if not rel <= 1e-5:
        raise RuntimeError("filtered_lrelu on the card disagrees with the CPU")

    # -- timings, bfloat16: (a) linear + bias, (b) lrelu + bias + gain +
    #    clamp, (c) filtered_lrelu's middle stage
    x_a = randn(*nhwc, dtype=bf)
    b_bf = b256.to(bf)
    x_c = randn(48, 67, 67, 256, dtype=bf)
    cases = {
        "a": (x_a, b256, dict(act="linear"), 1, lambda: torch.add(x_a, b_bf)),
        "b": (x_a, b256, dict(act="lrelu", gain=math.sqrt(2), clamp=256.0), 6, None),
        "c": (x_c, None, dict(act="lrelu", gain=math.sqrt(2)), 3, None),
    }
    timed = {}
    for key, (x, b, kw, ops_per_elem, lib) in cases.items():
        nbytes = 2 * x.numel() * x.element_size() + (0 if b is None else b.numel() * 4)
        bms, by = bound(ops_per_elem * x.numel(), nbytes, PEAK_FP32)
        timed[key] = dict(
            shape=list(x.shape), dtype="bfloat16", **kw, bias=b is not None,
            ms=device_ms(lambda: bias_act_kernel(x, b, **kw)),
            plain_ms=device_ms(lambda: bias_act_plain(x, b, **kw)),
            library_ms=None if lib is None else device_ms(lib),
            event_ms=cuda_ms(lambda: bias_act_kernel(x, b, **kw), iters=50),
            bound_ms=bms, bound_by=by)
        t = timed[key]
        lib_txt = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"[time] bias_act ({key}) {t['shape']} {kw} bias={t['bias']}: kernel_ms "
            f"{t['ms']:.4f} (event_ms {t['event_ms']:.4f}) plain_ms {t['plain_ms']:.4f} "
            f"library_ms {lib_txt} bound_ms {t['bound_ms']:.4f} ({t['bound_by']})")
    a = timed["a"]
    return dict(
        name="bias_act", route="cuda", source="ealdm_torch/kernels/csrc/bias_act.cu",
        replaces="ealdm_tpu/ops/bias_act.py:100", launches=counts["bias_act"],
        max_abs_err=errs["bias_act"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
        shape=a["shape"], dtype="bfloat16", cases=timed)


# ------------------------------------------------------------------ phase 3+
def random_init_(model, seed):
    """Seeded random weights: matrices and conv kernels ~ N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), codebook N(0, 1)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            v = torch.randn(p.shape, generator=gen)
            if leaf == "embedding":
                pass
            elif p.dim() >= 2:
                v /= math.sqrt(p[0].numel())
            elif leaf == "weight":  # norm scales
                v = 1 + 0.1 * v
            else:
                v *= 0.1
            p.copy_(v)


def mixed_batch(b, res, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    return {
        "img": torch.randn(b, res, res, 3, generator=g).to(device),
        "img_random": torch.randn(b, res, res, 3, generator=g).to(device),
        "flow": torch.randn(b, 1, 1, generator=g).to(device),
        "weather": torch.randn(b, 1, 16, generator=g).to(device),
        "time": torch.rand(b, 1, generator=g).to(device),
    }


def group_norm_sites(module, side):
    """(C, side, groups) of every GroupNorm32 one forward of `module` runs on
    a [N, C, side, side] input, from the module tree: children run in the
    order they were registered, each GroupNorm32 inside a child once, and a
    resampling child halves or doubles the side for the children after it."""
    from ealdm_torch.models.layers import Downsample, GroupNorm32, Upsample
    from ealdm_torch.models.vae import VaeDownsample, VaeUpsample

    sites = []
    for child in module.children():
        if isinstance(child, (Downsample, VaeDownsample)):
            side //= 2
        elif isinstance(child, (Upsample, VaeUpsample)):
            side *= 2
        else:
            sites += [(m.weight.numel(), side, m.num_groups) for m in child.modules()
                      if isinstance(m, GroupNorm32)]
    return sites


def expected_launches(model, steps, batch, cfg):
    """Launch counts of one sample_images run, from the module tree: every
    GroupNorm32 and every eligible self-attention site runs once per
    forward; the UNet runs once per step on the 2N CFG batch, the encoder
    once (the 2N conditioning pair), the decoder once. Each GroupNorm site
    takes the kernel path `group_norm_path` gives its shape, channels_last."""
    import collections

    import torch

    from ealdm_torch.models.layers import SpatialTransformer, flash_eligible
    from ealdm_torch.models.vae import VaeAttnBlock
    from ealdm_torch.ops.norms import group_norm_path, resolve_num_groups

    unet = model.model.diffusion_model
    fs = model.first_stage_model
    unet_flash = {}  # token count -> flash sites per UNet call
    for st in unet.modules():
        if isinstance(st, SpatialTransformer) and flash_eligible(st.tokens, st.tokens):
            unet_flash[st.tokens] = unet_flash.get(st.tokens, 0) + st.depth
    vae_flash = sum(1 for part in (fs.encoder, fs.decoder) for m in part.modules()
                    if isinstance(m, VaeAttnBlock) and flash_eligible(m.tokens, m.tokens))
    census = collections.Counter()
    for module, n, side, runs in ((unet, 2 * batch, cfg["zres"], steps),
                                  (fs.encoder, 2 * batch, cfg["res"], 1),
                                  (fs.decoder, batch, cfg["zres"], 1)):
        for c, s, groups in group_norm_sites(module, side):
            shape = (n, c, s, s)
            path = group_norm_path(shape, torch.bfloat16, resolve_num_groups(c, groups))
            census[(path, ("channels_last", shape, "bfloat16"))] += runs
    return {
        "unet_flash_sites": sum(unet_flash.values()) * steps,
        "unet_flash_sites_by_tokens": {n: c * steps for n, c in sorted(unet_flash.items())},
        "vae_flash_sites": vae_flash,
        "group_norm": sum(v for (name, _), v in census.items() if name == "group_norm"),
        "group_norm_two_pass": sum(v for (name, _), v in census.items()
                                   if name == "group_norm_two_pass"),
        "group_norm_census": dict(census),
    }


def phase_main_path(cfg_module, steps, batch):
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.FLAGSHIP
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] LatentDiffusion flagship, {n_params / 1e6:.1f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    mixed = mixed_batch(batch, cfg["res"], seed=1, device="cuda")
    latent = (cfg["zres"], cfg["zres"], 4)

    def run(steps_, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return sample_images(model, batch, latent, steps=steps_, eta=1.0,
                             guidance_scale=2.0, mixed=mixed, hoist=True, generator=g)

    t0 = time.perf_counter()
    run(steps, 2)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    img, z = run(steps, 2)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts, details = dict(kernels.launches), dict(kernels.launch_details)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # two more timed runs: the host's time per run varies from run to run,
    # and img/s is the median run's
    for _ in range(2):
        t0 = time.perf_counter()
        run(steps, 2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dt = sorted(walls)[1]
    if tuple(img.shape) != (batch, cfg["res"], cfg["res"], 3):
        raise RuntimeError(f"output shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not bool(torch.isfinite(z).all()):
        raise RuntimeError("non-finite output")
    if float(img.float().std()) == 0.0:
        raise RuntimeError("constant output")
    want = expected_launches(model, steps, batch, cfg)
    got = {"unet_flash_sites": counts["flash_attention_d32"],
           "unet_flash_sites_by_tokens": {n: c for (name, n), c in sorted(details.items())
                                          if name == "flash_attention_d32"},
           "vae_flash_sites": counts["flash_attention_d512"],
           "group_norm": counts["group_norm"],
           "group_norm_two_pass": counts["group_norm_two_pass"],
           "group_norm_census": {k: c for k, c in details.items()
                                 if k[0].startswith("group_norm")}}
    log(f"[main] batch {batch}, DDIM-{steps}, eta 1, CFG 2: {dt:.3f} s "
        f"= {batch / dt:.4f} img/s, the median of {[round(w, 4) for w in walls]} s "
        f"(warm-up {warm_s:.1f} s), peak memory "
        f"{peak_gb:.2f} GiB, output {list(img.shape)} std {float(img.float().std()):.4f}")
    log(f"[main] launches {counts}, the d=32 ones by query rows "
        f"{got['unet_flash_sites_by_tokens']}")
    log("[main] GroupNorm launches by path, layout, [N, C, H, W] and dtype, counted at "
        "the launch (expected from the module tree):")
    for key in sorted(set(got["group_norm_census"]) | set(want["group_norm_census"])):
        log(f"  {key[0]:20s} {key[1][0]:14s} {str(list(key[1][1])):22s} {key[1][2]}: "
            f"{got['group_norm_census'].get(key, 0)} "
            f"({want['group_norm_census'].get(key, 0)})")
    if got != want:
        raise RuntimeError(f"launch counts {got} differ from the module tree's {want}")
    if counts["bias_act"] != 0:
        raise RuntimeError(f"the sampling path launched bias_act {counts['bias_act']} times")
    for name in ("flash_attention_d32", "flash_attention_d512", "group_norm",
                 "group_norm_two_pass"):
        if counts[name] == 0:
            raise RuntimeError(f"{name} was not launched on the main path")
    return model, mixed, details, dict(
        img_per_s=batch / dt, seconds=dt, walls_s=walls, peak_gib=peak_gb, warmup_s=warm_s,
        launches=counts, d32_launches_by_rows=got["unet_flash_sites_by_tokens"])


def phase_profile(model, mixed, batch, steps, unprofiled_s):
    """One main-path run under torch.profiler: device time by kernel, and the
    device's idle share against the profiled run's wall time and against
    the unprofiled timed run (the profiler slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ealdm_torch.inference import sample_images

    g = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample_images(model, batch, (32, 32, 4), steps=steps, eta=1.0,
                      guidance_scale=2.0, mixed=mixed, hoist=True, generator=g)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"[profile] DDIM-{steps} batch {batch}: device busy {busy:.3f} s; idle share "
        f"{1 - busy / wall_s:.3f} of the profiled wall {wall_s:.3f} s, "
        f"{1 - busy / unprofiled_s:.3f} of the unprofiled {unprofiled_s:.3f} s")
    # each kernel counts in the first group whose name it contains
    groups = {"flash attention": (*MMA_KERNELS, "flash_row_kernel", "flash_wide_kernel"),
              "group_norm": GN_KERNELS,
              "convolution": ("fprop", "conv", "nchw", "nhwc"),
              "matmul": ("gemm", "nvjet", "cutlass"),
              "copies": ("copy_kernel",)}
    totals = dict.fromkeys([*groups, "other"], 0.0)
    for key, t, _ in rows:
        tag = next((g for g, names in groups.items() if any(n in key for n in names)),
                   "other")
        totals[tag] += t
    for tag, t in totals.items():
        log(f"[profile] {tag:16s} {t:.3f} s = {t / busy:.3f} of device time")
    for key, t, n in rows[:20]:
        log(f"[profile] {t * 1e3:9.2f} ms {t / busy:6.3f} x{n:<6d} {key[:110]}")
    return dict(device_busy_s=busy, idle_share=1 - busy / unprofiled_s,
                profiled_wall_s=wall_s, flash_s=totals["flash attention"],
                flash_share=totals["flash attention"] / busy,
                group_norm_s=totals["group_norm"], group_norm_share=totals["group_norm"] / busy)


def phase_packed(model, mixed, batch, steps):
    import torch

    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.ops.attention import set_attention_impl

    latent = (32, 32, 4)
    out = {}
    counts = None
    for impl in ("flash", "flash_packed"):
        set_attention_impl(impl)
        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(5)
        img, z = sample_images(model, batch, latent, steps=steps, eta=1.0,
                               guidance_scale=2.0, mixed=mixed, hoist=True, generator=g)
        torch.cuda.synchronize()
        out[impl] = (img.float(), z.float())
        if impl == "flash_packed":
            counts = dict(kernels.launches)
    set_attention_impl("flash")
    if counts["flash_attention_packed"] == 0:
        raise RuntimeError("flash_attention_packed was not launched")
    if counts["flash_attention_d32"] != 0:
        raise RuntimeError("the packed run still launched the split-layout kernel in the UNet")
    z_f, z_p = out["flash"][1], out["flash_packed"][1]
    rel = ((z_p - z_f).abs().max() / z_f.abs().max()).item()
    img_diff = (out["flash"][0] - out["flash_packed"][0]).abs().mean().item()
    log(f"[packed] {steps} steps at batch {batch}: launches {counts}; latent max "
        f"diff / max|z| = {rel:.3g} (tolerance 5e-2), image mean abs diff {img_diff:.3g}")
    # Same kernel at the self-attention sites; the cross-attention differs
    # (block-diagonal tiny-context form vs dense sdpa), rounding at other
    # places in bf16, and the random-weight chain amplifies it.
    if not math.isfinite(rel) or rel > 5e-2:
        raise RuntimeError(f"packed and flash runs disagree: {rel:.3g}")
    return counts


def phase_reference(cfg_module, bf16_model):
    """Flagship width, batch 1, 2 DDIM steps, float32: the card with its
    kernels against the CPU with the plain versions, same weights, x_T and
    noise; then one decode of the same VQ codes on both."""
    import torch

    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_module.FLAGSHIP
    kw = cfg_module.model_kwargs(cfg)
    sd = {k: v.float() for k, v in bf16_model.state_dict().items()}
    models = {}
    for dev in ("cpu", "cuda"):
        m = LatentDiffusion(**kw, dtype=torch.float32, device=dev).eval()
        m.load_state_dict(sd)
        models[dev] = m
    g = torch.Generator(device="cpu").manual_seed(9)
    x_T = torch.randn(1, 32, 32, 4, generator=g)
    noise = [torch.randn(1, 32, 32, 4, generator=g) for _ in range(2)]
    mixed = mixed_batch(1, cfg["res"], seed=4, device="cpu")
    z = {}
    for dev, m in models.items():
        z[dev] = sample_images(
            m, 1, (32, 32, 4), steps=2, eta=1.0, guidance_scale=2.0,
            mixed={k: v.to(dev) for k, v in mixed.items()}, x_T=x_T.to(dev),
            noise_fn=lambda i, shape: noise[i], decode=False, device=dev).float().cpu()
    rel = ((z["cuda"] - z["cpu"]).abs().max() / z["cpu"].abs().max()).item()
    with torch.no_grad():
        codes = models["cpu"].first_stage_model.quantize(z["cpu"])[2][2]
        imgs = {dev: m.first_stage_model.decode(
            m.first_stage_model.quantize.embed_code(codes.to(dev))).float().cpu()
            for dev, m in models.items()}
    img_err = (imgs["cuda"] - imgs["cpu"]).abs().max().item()
    img_scale = imgs["cpu"].abs().max().item()
    log(f"[reference] float32 card vs CPU: latent max diff / max|z| {rel:.3g} "
        f"(tolerance 1e-3); decoded image max abs diff {img_err:.3g} of max "
        f"{img_scale:.3g} (tolerance 1e-3 of max)")
    # float32 on both sides; convolution algorithms and sum orders differ
    # (cuDNN vs oneDNN), and the first DDIM step scales the latent by
    # 1/sqrt(alpha) ~ 14.
    if not (rel <= 1e-3 and img_err <= 1e-3 * img_scale):
        raise RuntimeError("the card's float32 result disagrees with the CPU reference")


# ------------------------------------------------------------------ phase 6
def rel_err_to_max(got, want):
    """max |got - want| / max |want|, in float32 (0 when both are 0)."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else (got - want).abs().max().item()


def phase_train_grads():
    """(a) The autograd Functions' gradients on the card against autograd
    through the plain versions on the same inputs and cotangent. Both sides
    recompute the same float32 formula (`group_norm_plain`, the dense
    `sdpa`) on the same tensors, so they differ by the order of a sum at
    most: 1e-5 of each gradient's largest element. A detached kernel output
    has no grad_fn and fails before that."""
    import torch

    from ealdm_torch.ops.attention import _split_heads, flash_attention, sdpa
    from ealdm_torch.ops.norms import group_norm, group_norm_plain, silu

    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf = torch.float32, torch.bfloat16
    tol = 1e-5
    worst = {}

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def grads(fn, inputs, g):
        inputs = [t.detach().requires_grad_() for t in inputs]
        y = fn(*inputs)
        return y, torch.autograd.grad(y, inputs, g)

    def check(name, what, got, want, node):
        y, gs = got
        if y.grad_fn is None or type(y.grad_fn).__name__ != node:
            raise RuntimeError(f"{name} {what}: output grad_fn {y.grad_fn}, not {node}")
        errs = [rel_err_to_max(a, b) for a, b in zip(gs, want[1])]
        worst[name] = max(worst.get(name, 0.0), *errs)
        log(f"  {name:20s} {what:46s} grad errors / max {[f'{e:.2g}' for e in errs]} "
            f"(tolerance {tol:g})")
        if not all(math.isfinite(e) and e <= tol for e in errs):
            raise RuntimeError(f"{name} {what}: gradients disagree with the plain version")

    gn_cases = [((48, 256, 32, 32), True, "channels_last"),
                ((48, 1024, 8, 8), False, "channels_last"),
                ((24, 128, 256, 256), False, "channels_last"),
                ((8, 256, 32, 32), True, "nchw")]
    for shape, with_pre, layout in gn_cases:
        n, c = shape[:2]
        for dtype in (f32, bf):
            x = (3 * randn(*shape) + 1).to(dtype)
            if layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            g = randn(*shape, dtype=dtype)
            scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
            inputs = [x, scale, bias] + ([randn(n, c, dtype=dtype)] if with_pre else [])
            for act in (None, silu):
                def kernel(x, s, b, p=None):
                    return group_norm(x, s, b, 32, 1e-5, act, "NCHW", p)

                def plain(x, s, b, p=None):
                    return group_norm_plain(x, s, b, 32, 1e-5, act, "NCHW", p)

                what = (f"{list(shape)} {layout} {str(dtype)[6:]}"
                        f"{' pre_bias' if with_pre else ''}{' SiLU' if act else ''}")
                check("group_norm", what, grads(kernel, inputs, g), grads(plain, inputs, g),
                      "GroupNormKernelBackward")
            del x, g, inputs
    # flash d=32 on the UNet's head-strided view, d=512 as the VQ encoder
    # calls it; against the vjp of the dense sdpa
    for dtype in (f32, bf):
        for name, qkv in (
                ("flash_attention_d32", [_split_heads(randn(48, 1024, 256, dtype=dtype), 8)
                                         for _ in range(3)]),
                ("flash_attention_d512", [randn(48, 1, 1024, 512, dtype=dtype)
                                          for _ in range(3)])):
            g = randn(*qkv[0].shape, dtype=dtype)
            check(name, f"{list(qkv[0].shape)} {str(dtype)[6:]}",
                  grads(flash_attention, qkv, g), grads(sdpa, qkv, g), "FlashAttentionBackward")
            del qkv, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def train_batch(b, res, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    img = torch.randn(b, res, res, 3, generator=g).to(device)
    return {"img": img, "mixed": mixed_batch(b, res, seed + 1, device)}


def expected_train_launches(model, batch, cfg, remat):
    """Kernel launches of one train step, from the module tree: the VQ
    encoder once on the N target frames and once on the 2N conditioning
    pair; the UNet once on the 2N CFG batch, and under "dots" or "full" once
    more when the backward recomputes each of its blocks and its out head
    (the kernels' outputs are not saved). The cond tower has no kernel
    site. {(counter, detail): n} in
    the wrappers' terms, plus the totals by counter."""
    import collections

    import torch

    from ealdm_torch.models.layers import SpatialTransformer, flash_eligible
    from ealdm_torch.models.vae import VaeAttnBlock
    from ealdm_torch.ops.norms import group_norm_path, resolve_num_groups

    unet = model.model.diffusion_model
    enc = model.first_stage_model.encoder
    unet_runs = 1 if remat == "none" else 2
    census = collections.Counter()
    for module, n, side, runs in ((unet, 2 * batch, cfg["zres"], unet_runs),
                                  (enc, batch, cfg["res"], 1), (enc, 2 * batch, cfg["res"], 1)):
        for c, s, groups in group_norm_sites(module, side):
            shape = (n, c, s, s)
            path = group_norm_path(shape, torch.bfloat16, resolve_num_groups(c, groups))
            census[(path, ("channels_last", shape, "bfloat16"))] += runs
    for st in unet.modules():
        if isinstance(st, SpatialTransformer) and flash_eligible(st.tokens, st.tokens):
            census[("flash_attention_d32", st.tokens)] += st.depth * unet_runs
    enc_attn = [m for m in enc.modules()
                if isinstance(m, VaeAttnBlock) and flash_eligible(m.tokens, m.tokens)]
    for m in enc_attn:
        census[("flash_attention_d512", m.tokens)] += 2
    totals = collections.Counter()
    for (name, _), n in census.items():
        totals[name] += n
    return dict(census), dict(totals)


def train_profile_groups(prof):
    """Device seconds of one profiled train step by group. Kernels launched
    inside the `ealdm::group_norm_vjp`, `ealdm::flash_attention_vjp`,
    `ealdm::adamw` and `ealdm::ema` ranges (the plain backwards, the
    optimizer, the EMA) count there, whatever they are; the others by
    kernel name."""
    from torch.autograd import DeviceType

    ranges = {"ealdm::group_norm_vjp": "GroupNorm backward (plain)",
              "ealdm::flash_attention_vjp": "attention backward (plain)",
              "ealdm::adamw": "AdamW and EMA", "ealdm::ema": "AdamW and EMA"}
    by_name = {"GroupNorm forward kernel": GN_KERNELS,
               "flash forward kernel": (*MMA_KERNELS, "flash_row_kernel", "flash_wide_kernel"),
               "convolutions": ("fprop", "dgrad", "wgrad", "conv", "nchw", "nhwc"),
               "matmuls": ("gemm", "nvjet", "cutlass"),
               "copies and casts": ("copy_kernel",),
               "elementwise and reductions": ("elementwise", "reduce_kernel",
                                              "multi_tensor_apply")}
    totals = dict.fromkeys([*by_name, *dict.fromkeys(ranges.values()), "other"], 0.0)
    in_range = {}

    def subtree(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from subtree(ch)

    events = prof.events()
    for e in events:
        if e.name in ranges and e.device_type == DeviceType.CPU:
            for k in subtree(e):
                totals[ranges[e.name]] += k.duration / 1e6
                in_range[k.name] = in_range.get(k.name, 0.0) + k.duration / 1e6
    busy, launches, rows = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key in ranges or getattr(e, "is_user_annotation", False):
            continue  # a range's span on the device track, not a kernel
        t = e.self_device_time_total / 1e6
        busy += t
        launches += e.count
        rest = t - in_range.get(e.key, 0.0)
        tag = next((g for g, names in by_name.items() if any(n in e.key for n in names)),
                   "other")
        totals[tag] += rest
        rows.append((t, e.count, tag, e.key))
    return busy, totals, launches, sorted(rows, reverse=True)


def phase_train(cfg_module):
    """(b) `bench.py --train`'s step on the flagship: one warm-up step and
    five timed ones, launches per step against the module tree, one
    profiled step; (c) gradient completeness after the first step."""
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.models.layers import GroupNorm32
    from ealdm_torch.training import init_train_state, make_train_step

    cfg, tc = cfg_module.FLAGSHIP, cfg_module.FLAGSHIP_TRAIN
    ealdm_torch.enable_inference_optimizations()
    batch_size = tc["batch_size"]
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=getattr(torch, tc["dtype"]),
                            device="cuda")
    random_init_(model, seed=0)
    state, opt = init_train_state(model, learning_rate=tc["learning_rate"],
                                  ema_decay=tc["ema_decay"])
    step = make_train_step(model, opt, remat=tc["remat"])
    n_train = sum(p.numel() for k, p in state.params.items() if k in state.opt_state.mu)
    log(f"[train] flagship {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, {n_train / 1e6:.1f} M trainable; batch {batch_size}, "
        f"{tc['dtype']} compute, remat {tc['remat']!r}, lr {tc['learning_rate']}; "
        f"built in {time.perf_counter() - t0:.1f} s")
    batch = train_batch(batch_size, cfg["res"], seed=21, device="cuda")
    frozen = {k: p.detach().clone() for k, p in state.params.items()
              if k.startswith("first_stage_model")}
    want, want_totals = expected_train_launches(model, batch_size, cfg, tc["remat"])

    def run_step(step_fn, seed):
        """(wall s, loss, grad norm, launches by detail) of one step."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step_fn(state, batch, torch.Generator().manual_seed(seed))
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()  # waits for the step
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss, gnorm, dict(kernels.launch_details)

    warm_s, loss0, gnorm0, details0 = run_step(step, 100)
    # (c) gradient completeness after the first step
    missing, bad, zero = [], [], []
    for k, p in state.params.items():
        if k in state.opt_state.mu:
            if p.grad is None:
                missing.append(k)
            elif not bool(torch.isfinite(p.grad).all()):
                bad.append(k)
        elif p.grad is not None:
            bad.append(k)
    unet = model.model.diffusion_model
    must_move = {"model.diffusion_model.conv_in.weight": unet.conv_in.weight}
    for name, m in unet.named_modules():
        if isinstance(m, GroupNorm32):
            must_move[f"{name}.weight"], must_move[f"{name}.bias"] = m.weight, m.bias
    zero = [k for k, p in must_move.items() if p.grad is None or not p.grad.abs().max() > 0]
    moved = [k for k, p in frozen.items() if not torch.equal(state.params[k], p)]
    log(f"[train] after the first step: {len(state.opt_state.mu)} trainable tensors, "
        f"missing grads {missing[:4]}, non-finite or unexpected {bad[:4]}, zero among "
        f"conv_in and {len(must_move) - 1} UNet GroupNorm scales/biases {zero[:4]}, "
        f"first-stage tensors moved {moved[:4]} of {len(frozen)}")
    if missing or bad or zero or moved:
        raise RuntimeError("gradient completeness failed after the first step")
    del frozen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = [run_step(step, 200 + i) for i in range(5)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = [s[0] for s in steps]
    dt = sorted(walls)[2]
    got_totals = {}
    for (name, _), n in steps[0][3].items():
        got_totals[name] = got_totals.get(name, 0) + n
    log(f"[train] warm-up step {warm_s:.2f} s (loss {loss0:.6f}, grad norm {gnorm0:.6f}); "
        f"timed steps {[round(w, 4) for w in walls]} s: median {dt * 1e3:.1f} ms = "
        f"{batch_size / dt:.3f} img/s; peak {peak_gib:.2f} GiB")
    log(f"[train] losses {[round(s[1], 6) for s in steps]}, grad norms "
        f"{[round(s[2], 6) for s in steps]}")
    log(f"[train] launches per step {got_totals} (module tree: {want_totals})")
    for key in sorted(set(want) | set(steps[0][3]), key=str):
        log(f"  {str(key):70s} {steps[0][3].get(key, 0)} ({want.get(key, 0)})")
    for i, s in enumerate(steps):
        if s[3] != want:
            raise RuntimeError(f"timed step {i}: launches differ from the module tree's")
        if not (math.isfinite(s[1]) and math.isfinite(s[2])):
            raise RuntimeError(f"timed step {i}: non-finite loss or grad norm")
    if details0 != want:
        raise RuntimeError("warm-up step: launches differ from the module tree's")
    for name in ("flash_attention_d32", "flash_attention_d512", "group_norm",
                 "group_norm_two_pass"):
        if not got_totals.get(name):
            raise RuntimeError(f"{name} was not launched by the train step")
    # one profiled step: device busy, idle share, device time by group
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, torch.Generator().manual_seed(300))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, groups, n_kernels, rows = train_profile_groups(prof)
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time in the train step")
    log(f"[train-profile] device busy {busy * 1e3:.1f} ms in {n_kernels} kernel launches; "
        f"idle share {1 - busy / dt:.3f} of the median unprofiled step ({dt * 1e3:.1f} ms), "
        f"{1 - busy / prof_wall:.3f} of the profiled one ({prof_wall * 1e3:.1f} ms)")
    for tag, t in groups.items():
        log(f"[train-profile] {tag:28s} {t * 1e3:9.2f} ms = {t / busy:.3f} of device time")
    for t, n, tag, key in rows[:20]:
        log(f"[train-profile] {t * 1e3:8.2f} ms x{n:<5d} ({tag}, ranges included) {key[:90]}")
    for tag in ("GroupNorm backward (plain)", "attention backward (plain)", "AdamW and EMA"):
        if groups[tag] <= 0:
            raise RuntimeError(f"the profile attributes no device time to {tag}")
    # the other remat policies, three steps each: median time, peak, launches
    policies = {}
    for policy in ("none", "full"):
        other = make_train_step(model, opt, remat=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = [run_step(other, 400 + i) for i in range(3)]
        expect, _ = expected_train_launches(model, batch_size, cfg, policy)
        ok = all(r[3] == expect and math.isfinite(r[1]) for r in runs)
        policies[policy] = dict(step_ms=sorted(r[0] for r in runs)[1] * 1e3,
                                walls_s=[r[0] for r in runs],
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"[train] remat {policy!r}: steps {[round(r[0], 4) for r in runs]} s, median "
            f"{policies[policy]['step_ms']:.1f} ms, peak {policies[policy]['peak_gib']:.2f} "
            f"GiB, launches as the module tree gives and finite losses: {ok}")
        if not ok:
            raise RuntimeError(f"remat {policy!r}: launches {runs[0][3]} or losses "
                               f"{[r[1] for r in runs]}")
    out = dict(batch=batch_size, dtype=tc["dtype"], remat=tc["remat"],
               step_ms=dt * 1e3, walls_s=walls, img_per_s=batch_size / dt,
               warmup_s=warm_s, peak_gib=peak_gib, losses=[loss0] + [s[1] for s in steps],
               grad_norms=[gnorm0] + [s[2] for s in steps], launches_per_step=got_totals,
               device_busy_ms=busy * 1e3, idle_share=1 - busy / dt,
               kernel_launches=n_kernels,
               profiled_wall_ms=prof_wall * 1e3,
               device_ms_by_group={k: v * 1e3 for k, v in groups.items()},
               other_remat=policies)
    return model, out


def phase_train_reference(cfg_module, trained):
    """(d) One training step's loss and gradients at full width, batch 1,
    float32, dropout off, TF32 off: the card (kernels) against the CPU
    (plain versions), same weights, batch, t and noise. The sums differ in
    order (cuDNN and cuBLAS against oneDNN) and the attention differs in
    form (the flash kernel against dense sdpa): loss to 1e-4 relative, the
    grad norm to 1e-3 relative, and each listed gradient to 1e-3 of its
    largest element."""
    import torch

    from ealdm_torch.models.ddpm import LatentDiffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tc = cfg_module.FLAGSHIP, cfg_module.FLAGSHIP_TRAIN
    kw = cfg_module.model_kwargs(cfg)
    sd = {k: v.float() for k, v in trained.state_dict().items()}
    batch = train_batch(1, cfg["res"], seed=31, device="cpu")
    g = torch.Generator().manual_seed(32)
    t = torch.randint(0, 1000, (1,), generator=g)
    noise = torch.randn(1, cfg["zres"], cfg["zres"], 4, generator=g)
    listed = ("model.diffusion_model.conv_in.weight",
              "model.diffusion_model.mid_res1.out_norm.weight",
              "model.diffusion_model.down_0_0_attn.block_0.attn1.to_q.weight",
              "cond_stage_model.out_3.weight")
    res = {}
    for dev in ("cpu", "cuda"):
        m = LatentDiffusion(**kw, dtype=torch.float32, device=dev)
        m.load_state_dict(sd)
        m.train()
        b = {"img": batch["img"].to(dev), "mixed": {k: v.to(dev) for k, v in
                                                    batch["mixed"].items()}}

        t0 = time.perf_counter()
        with m.model.diffusion_model.remat_blocks(tc["remat"]):
            loss, _ = m.training_loss(b, None, t=t.to(dev), noise=noise.to(dev), train=False)
        loss.backward()
        grads = [p.grad for p in m.parameters() if p.requires_grad]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).item()
        named = dict(m.named_parameters())
        res[dev] = (loss.item(), gnorm, {k: named[k].grad.float().cpu() for k in listed})
        log(f"[train-reference] {dev}: loss {res[dev][0]:.8f}, grad norm {gnorm:.8f} "
            f"({time.perf_counter() - t0:.1f} s)")
        del m, grads, named
    torch.cuda.empty_cache()
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = res["cpu"], res["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = abs(n_gpu - n_cpu) / abs(n_cpu)
    grad_rel = {k: rel_err_to_max(g_gpu[k], g_cpu[k]) for k in listed}
    log(f"[train-reference] float32 card vs CPU: loss {loss_rel:.3g} relative (tolerance "
        f"1e-4), grad norm {norm_rel:.3g} (1e-3), gradients / max "
        f"{ {k.split('.', 1)[1]: f'{v:.3g}' for k, v in grad_rel.items()} } (1e-3)")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and all(v <= 1e-3 for v in grad_rel.values())):
        raise RuntimeError("the card's float32 train step disagrees with the CPU")
    return dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, grad_rel_to_max=grad_rel)


# a GroupNorm kernel whose output is this much too large (a systematic
# error of about 4 bf16 ulps) must fail phase 6 (e)'s limit
PLANTED_GN_SCALE = 2**-5


def phase_train_bf16_check(cfg_module, model):
    """(e) The numbers of the step that (b) times: one bf16 step at batch 24
    (same weights, batch, t and noise, dropout off, remat as timed) with the
    kernels, and again with each kernel launch replaced by its plain version
    on the card (`group_norm_plain`, `flash_attention_plain`; the backwards
    are the same code on both sides). The two can differ only by the
    kernels' rounding, which is of the kind bf16 compute adds everywhere, so
    the limit comes from the bf16 step's own error: the plain bf16
    gradient's distance from a float32 step's (plain versions, TF32 off).
    Over the 410 M trainable elements,
        |g_kernels - g_plain| <= 2 |g_plain - g_float32|
    (two bf16 runs whose roundings were independent would land sqrt(2)
    apart), and the grad norms then differ by no more (triangle
    inequality). The loss, a mean over 98,304 outputs, must agree to 2^-8
    relative, one bf16 rounding of the loss itself. A GroupNorm kernel with
    its output `PLANTED_GN_SCALE` too large must fail the gradient limit."""
    import contextlib

    import torch

    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.ops import attention, norms

    cfg, tc = cfg_module.FLAGSHIP, cfg_module.FLAGSHIP_TRAIN
    n = tc["batch_size"]
    batch = train_batch(n, cfg["res"], seed=41, device="cuda")
    g = torch.Generator().manual_seed(42)
    t = torch.randint(0, 1000, (n,), generator=g).cuda()
    noise = torch.randn(n, cfg["zres"], cfg["zres"], 4, generator=g).cuda()
    kernel_gn, kernel_flash = norms.group_norm_kernel, attention.flash_attention_kernel

    def plain_gn(x, scale, bias, num_groups, eps, fuse_silu, pre_bias=None):
        return norms.group_norm_plain(x, scale, bias, num_groups, eps,
                                      norms.silu if fuse_silu else None, "NCHW",
                                      None if pre_bias is None else pre_bias.to(x.dtype))

    def faulty_gn(*args, **kwargs):
        return kernel_gn(*args, **kwargs) * (1 + PLANTED_GN_SCALE)

    @contextlib.contextmanager
    def launches(gn, flash):
        norms.group_norm_kernel, attention.flash_attention_kernel = gn, flash
        try:
            yield
        finally:
            norms.group_norm_kernel, attention.flash_attention_kernel = kernel_gn, kernel_flash

    def step(m, remat):
        """(loss, every trainable gradient as one float32 vector)."""
        m.train()
        params = [p for p in m.parameters() if p.requires_grad]
        with m.model.diffusion_model.remat_blocks(remat):
            loss, _ = m.training_loss(batch, None, t=t, noise=noise, train=False)
        return loss.item(), torch.cat([x.float().flatten()
                                       for x in torch.autograd.grad(loss, params)])

    t0 = time.perf_counter()
    with launches(plain_gn, attention.flash_attention_plain):
        l_plain, g_plain = step(model, tc["remat"])
        ref = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.float32,
                              device="cuda")
        ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        l_ref, g_ref = step(ref, "none")
        del ref
    ref_norm = g_ref.norm().item()
    bf16_err = (g_plain - g_ref).norm().item() / ref_norm
    del g_ref
    res = {"loss_float32": l_ref, "loss_plain": l_plain, "grad_norm_plain": g_plain.norm().item(),
           "plain_vs_float32": bf16_err, "limit": 2 * bf16_err}
    for name, gn in (("kernels", kernel_gn), ("planted_fault", faulty_gn)):
        with launches(gn, kernel_flash):
            loss, grad = step(model, tc["remat"])
        res[name] = {"loss": loss, "loss_rel": abs(loss - l_plain) / abs(l_plain),
                     "grad_norm": grad.norm().item(),
                     "grad_vs_plain": (grad - g_plain).norm().item() / ref_norm}
        del grad
    del g_plain
    torch.cuda.empty_cache()
    k, f = res["kernels"], res["planted_fault"]
    log(f"[train-bf16] batch {n}, {tc['dtype']}, remat {tc['remat']!r} "
        f"({time.perf_counter() - t0:.1f} s): "
        f"loss kernels {k['loss']:.8f}, plain {l_plain:.8f}, float32 {l_ref:.8f}; "
        f"|g_kernels - g_plain| = {k['grad_vs_plain']:.4g} of |g_float32|, limit "
        f"{res['limit']:.4g} (twice |g_plain - g_float32| = {bf16_err:.4g}); loss "
        f"{k['loss_rel']:.3g} relative (limit {2**-8:.3g}); grad norms {k['grad_norm']:.6f} "
        f"/ {res['grad_norm_plain']:.6f}")
    log(f"[train-bf16] planted fault (GroupNorm output x (1 + {PLANTED_GN_SCALE:g})): "
        f"{f['grad_vs_plain']:.4g} of |g_float32| against the limit {res['limit']:.4g}; "
        f"loss {f['loss_rel']:.3g} relative")
    if not (k["grad_vs_plain"] <= res["limit"] and k["loss_rel"] <= 2**-8):
        raise RuntimeError("the bf16 train step with the kernels disagrees with the plain one")
    if f["grad_vs_plain"] <= res["limit"]:
        raise RuntimeError("the planted GroupNorm fault passed the bf16 step's limit")
    return res


def phases_train(cfg_module):
    """Phase 6, training: (a) gradient checks, (b) + (c) the flagship train
    step, (e) its bf16 numbers against the plain versions', (d) float32
    card vs CPU. Returns the [train] line's dict."""
    import torch

    grads = phase_train_grads()
    model, out = phase_train(cfg_module)
    out["grad_check_worst"] = grads
    out["bf16_check"] = phase_train_bf16_check(cfg_module, model)
    out["reference"] = phase_train_reference(cfg_module, model)
    del model
    torch.cuda.empty_cache()
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ealdm_torch import config as cfg_module  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build()
    train_only = "--train" in argv
    rows = {}
    if "--groupnorm" in argv:
        rows = phase_group_norm()
    elif not train_only:
        phase_sass()
        rows = phase_kernels()
        rows.update(phase_group_norm())
        rows["bias_act"] = phase_ops()
    if not {"--kernels", "--groupnorm", "--train"} & set(argv):
        steps, batch = 50, 24
        model, mixed, details, e2e = phase_main_path(cfg_module, steps, batch)
        counts = e2e["launches"]
        for row in rows.values():
            # a kernel's row takes its count, a shape's row its count at that shape
            name = row.get("counter", row["name"])
            if isinstance(name, tuple):
                row["launches"] = details.get(name, 0)
            elif name in ("flash_attention_d32", "flash_attention_d512", "group_norm",
                          "group_norm_two_pass"):
                row["launches"] = counts[name]
        e2e.update(phase_profile(model, mixed, batch, steps, e2e["seconds"]))
        packed = phase_packed(model, mixed, batch, steps=2)
        rows["flash_attention_packed"]["launches"] = packed["flash_attention_packed"]
        phase_reference(cfg_module, model)
        log(f"[e2e] {json.dumps(e2e)}")
        del model
        torch.cuda.empty_cache()
    train = None
    if not {"--kernels", "--groupnorm"} & set(argv):
        train = phases_train(cfg_module)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if train is not None:
        log(f"[train] {json.dumps(train)}")
    log(smi)
    if not train_only:
        log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
