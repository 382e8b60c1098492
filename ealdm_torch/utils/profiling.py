"""Tracing and step timing (counterpart of `ealdm_tpu/utils/profiling.py`).

  * `trace(logdir)`: a torch.profiler trace (CPU and CUDA activities) of
    the enclosed block, exported as a Chrome trace JSON under `logdir`.
    kineto's TEARDOWN_CUPTI is set to 1 before the first trace: with CUPTI
    left on after a trace, its callbacks slow every later launch on the host
    (`ealdm_torch/kernels/probe_host.py`).
  * `fence()`: waits for the card's queued work (a synchronize), so a timed
    bucket measures device time; a no-op without a card.
  * `StepTimer`: named wall-clock buckets with a Lightning-profiler-style
    summary.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """A torch.profiler trace of the enclosed block, written to
    `<logdir>/<name>.json`; yields the profiler."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def fence(x=None) -> None:
    """Wait until the card has run all the work queued so far (`x`, a tensor
    or None, names the card; the current one if None)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    elif x is None and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Named wall-clock buckets + a Lightning-profiler-style summary."""

    def __init__(self):
        self.buckets: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.buckets.setdefault(name, []).append(seconds)

    def summary(self) -> str:
        rows = [("action", "mean (ms)", "total (s)", "calls")]
        total = sum(sum(v) for v in self.buckets.values()) or 1.0
        for name, vals in sorted(self.buckets.items(), key=lambda kv: -sum(kv[1])):
            rows.append((name, f"{1e3 * sum(vals) / len(vals):.2f}",
                         f"{sum(vals):.2f} ({100 * sum(vals) / total:.0f}%)", str(len(vals))))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
        sep = "-" * len(lines[0])
        return "\n".join([sep, lines[0], sep, *lines[1:], sep])

    def report(self):
        if self.buckets:
            print(self.summary(), flush=True)
