"""Cross-process training statistics (counterpart of
`ealdm_tpu/training/stats.py`; the reference's `torch_utils/training_stats.py`).

Named scalar streams accumulate as (count, sum, sum of squares) moments in
float64 on the host; a `Collector` snapshots them, summed over processes by
`torch.distributed.all_reduce` when a process group is initialised (locally
otherwise), and answers num / mean / std.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

_counters: "OrderedDict[str, np.ndarray]" = OrderedDict()


def report(name: str, value) -> None:
    """Accumulate the scalars of `value` (a number, array or tensor) into
    the stream `name`."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().double().numpy()
    arr = np.asarray(value, np.float64).reshape(-1)
    if arr.size == 0:
        return
    moments = np.array([arr.size, arr.sum(), np.square(arr).sum()], np.float64)
    if name in _counters:
        _counters[name] += moments
    else:
        _counters[name] = moments


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def report0(name: str, value, process_index: Optional[int] = None) -> None:
    """`report` on process 0 only (rank_zero_only); the other processes
    hold the stream with no moments, so every process syncs the same
    names."""
    if (_rank() if process_index is None else process_index) == 0:
        report(name, value)
    else:
        _counters.setdefault(name, np.zeros(3, np.float64))


def _sync(names) -> Dict[str, np.ndarray]:
    """The streams' moments summed over processes. Every process must hold
    the same names (report and report0 them alike); they are reduced in
    sorted order, whatever order each process reported them in."""
    order = sorted(names)
    table = np.stack([_counters[n] for n in order])
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.from_numpy(table).to(dev)
        dist.all_reduce(t)
        table = t.cpu().numpy()
    return {n: table[i] for i, n in enumerate(order)}


class Collector:
    """Snapshot of the streams whose names fullmatch `regex`: `update`
    takes the moments accumulated since the last update (the snapshot is
    cleared first unless `keep_previous`) and zeroes the streams."""

    def __init__(self, regex: str = ".*", keep_previous: bool = True):
        self._regex = re.compile(regex)
        self._keep_previous = keep_previous
        self._moments: Dict[str, np.ndarray] = {}
        self.update()

    def names(self):
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self):
        if not self._keep_previous:
            self._moments.clear()
        names = self.names()
        if not names:
            return
        synced = _sync(names)
        for n in names:
            self._moments[n] = synced[n].copy()
            _counters[n][:] = 0

    def num(self, name):
        return int(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name):
        m = self._moments.get(name, np.zeros(3))
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name):
        m = self._moments.get(name, np.zeros(3))
        if m[0] == 0:
            return float("nan")
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean**2, 0.0)))

    def as_dict(self):
        return {n: {"num": self.num(n), "mean": self.mean(n), "std": self.std(n)}
                for n in self._moments}
