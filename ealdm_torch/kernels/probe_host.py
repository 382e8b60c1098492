"""Why a host-bound path's wall changes within one process: the RDM768
UNet's CFG call, timed on the host's clock before and after what a
`chip_smoke.py` run does between its timed runs.

    python -m ealdm_torch.kernels.probe_host

Builds `config.RDM768` in bfloat16 on the card (its default init: the
values do not change the host's work) and times, in this order in one
process, the median host wall of 20 UNet calls at the CFG batch
[4, 48, 48, 16] with a [4, 11, 768] context (each call synchronized) and
the host time a launch of 1,000 one-element adds: fresh; with the garbage
collector off; after a CPU burst (float32 matmuls on every core, as the
float32 references run); after one torch.profiler session of CUDA
activity; after five more; and then with the collector off. A child
process runs the sequence for each setting of kineto's TEARDOWN_CUPTI
(unset, "0", "1": whether CUPTI is finalized when a trace ends). Prints the
card's name and power limit, then one JSON line a child.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch


def _walls(fn, n):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def child() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from .. import config, enable_inference_optimizations
    from ..models.ddpm import LatentDiffusion

    enable_inference_optimizations()
    cfg = config.RDM768
    model = LatentDiffusion(**config.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(4, cfg["zres"], cfg["zres"], cfg["zch"], device="cuda", generator=gen)
    t = torch.full((4,), 500, dtype=torch.int64, device="cuda")
    ctx = torch.randn(4, 11, 768, device="cuda", generator=gen)
    x = torch.zeros(1, device="cuda")

    def unet():
        model.apply_model(z, t, ctx)

    def adds():
        for _ in range(1000):
            x.add_(1)

    def measure():
        u, a = _walls(unet, 20), _walls(adds, 5)
        return {"unet_ms": 1e3 * statistics.median(u),
                "unet_ms_min_max": [1e3 * min(u), 1e3 * max(u)],
                "launch_us": 1e3 * statistics.median(a)}  # seconds per 1,000

    def profiled():
        with profile(activities=[ProfilerActivity.CUDA]):
            unet()
            torch.cuda.synchronize()

    out = {}
    with torch.no_grad():
        for _ in range(3):
            unet()
        out["fresh"] = measure()
        gc.disable()
        out["gc_off"] = measure()
        gc.enable()
        a = torch.randn(2048, 2048)
        for _ in range(20):
            a @ a
        out["after_cpu_burst"] = measure()
        profiled()
        out["after_1_profile"] = measure()
        for _ in range(5):
            profiled()
        out["after_6_profiles"] = measure()
        gc.disable()
        out["after_6_profiles_gc_off"] = measure()
        gc.enable()
    return out


def main(argv=()):
    if "--child" in argv:
        print(json.dumps({"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"), **child()}))
        return 0
    if not torch.cuda.is_available():
        print("probe_host: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for teardown in (None, "0", "1"):
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        if teardown is not None:
            env["TEARDOWN_CUPTI"] = teardown
        run = subprocess.run([sys.executable, "-m", "ealdm_torch.kernels.probe_host",
                              "--child"], env=env, capture_output=True, text=True)
        print(run.stdout.strip().splitlines()[-1] if run.returncode == 0 else run.stderr,
              flush=True)
        rc |= run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
