"""Multiplier-valued LR schedules, base_lr = 1 (counterpart of
`ealdm_tpu/training/lr_scheduler.py`).

The reference's LambdaWarmUpCosineScheduler (one cycle),
LambdaWarmUpCosineScheduler2 and LambdaLinearScheduler (cyclic, configured
by lists): each a function of the update count returning a float.
"""
from __future__ import annotations

import bisect
import math
from typing import Sequence


def warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                  max_decay_steps: int):
    def schedule(n):
        if n < warm_up_steps:
            return (lr_max - lr_start) / warm_up_steps * n + lr_start
        t = min((n - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def _cyclic(warm_up_steps: Sequence[int], f_min: Sequence[float], f_max: Sequence[float],
            f_start: Sequence[float], cycle_lengths: Sequence[int], linear: bool):
    starts = [0]
    for length in cycle_lengths:
        starts.append(starts[-1] + length)

    def schedule(n):
        # completed cycles before step n (the last cycle runs on forever)
        c = bisect.bisect_right(starts[1:-1], n)
        nn = n - starts[c]
        wu, cl = warm_up_steps[c], cycle_lengths[c]
        if nn < wu:
            return (f_max[c] - f_start[c]) / wu * nn + f_start[c]
        if linear:
            return f_min[c] + (f_max[c] - f_min[c]) * (cl - nn) / cl
        t = min((nn - wu) / max(cl - wu, 1.0), 1.0)
        return f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1 + math.cos(t * math.pi))

    return schedule


def warmup_cosine_cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaWarmUpCosineScheduler2: linear warm-up, then cosine decay, per cycle."""
    return _cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear=False)


def warmup_linear_cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaLinearScheduler: linear ramp, then linear decay, per cycle."""
    return _cyclic(warm_up_steps, f_min, f_max, f_start, cycle_lengths, linear=True)


def build_scheduler(config: dict):
    """The schedule of a reference scheduler_config {target, params}."""
    target = config.get("target", "")
    p = dict(config.get("params", {}))
    name = target.rsplit(".", 1)[-1]
    if name == "LambdaWarmUpCosineScheduler":
        return warmup_cosine(p["warm_up_steps"], p["lr_min"], p["lr_max"], p["lr_start"],
                             p["max_decay_steps"])
    if name in ("LambdaWarmUpCosineScheduler2", "LambdaLinearScheduler"):
        build = (warmup_cosine_cyclic if name == "LambdaWarmUpCosineScheduler2"
                 else warmup_linear_cyclic)
        return build(p["warm_up_steps"], p["f_min"], p["f_max"], p["f_start"],
                     p["cycle_lengths"])
    raise ValueError(f"unknown scheduler target: {target}")
