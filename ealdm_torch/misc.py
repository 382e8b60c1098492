"""Runtime assertion, sampling and consistency helpers (counterpart of
`ealdm_tpu/misc.py`): `assert_shape`, `InfiniteSampler` (the JAX package's
index order for every size, rank, replica count, seed and window),
`check_param_consistency` (the largest drift of a parameter from its mean
over the `torch.distributed` group) and `profiled_function` (a
`torch.profiler.record_function` range).
"""
from __future__ import annotations

import functools
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch


def assert_shape(tensor, ref_shape: Sequence[Optional[int]]):
    """Assert a tensor's shape; None entries are wildcards."""
    if tensor.ndim != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {tensor.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref) in enumerate(zip(tensor.shape, ref_shape)):
        if ref is not None and size != ref:
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref}")


class InfiniteSampler:
    """Shuffled infinite index stream with rank sharding and window-local
    reshuffling, drawn from numpy's RandomState(seed) as the JAX package
    draws it."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert dataset_size > 0
        assert 0 <= rank < num_replicas
        assert 0 <= window_size <= 1
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


@torch.no_grad()
def check_param_consistency(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The largest |p - mean over the processes of p| of any parameter in
    `params` (a name -> tensor dict, or an nn.Module), as a float32 0-d
    tensor: the weight-drift check of data-parallel replicas. The mean is an
    all-reduce over the default `torch.distributed` process group (gloo on
    the CPU); without one initialized there is one replica and the drift is
    0."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    drift = torch.zeros((), dtype=torch.float32)
    for p in params.values():
        mean = p.detach().float().clone()
        if world > 1:
            dist.all_reduce(mean, op=dist.ReduceOp.SUM)
            mean /= world
        drift = torch.maximum(drift, (p.detach().float() - mean).abs().max().cpu())
    return drift


def profiled_function(fn):
    """Decorator that names `fn`'s work in profiler traces: a
    `torch.profiler.record_function` range around each call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper
