"""General helpers (counterpart of `ealdm_tpu/util.py`): ismap / isimage,
exists / default, mean_flat, count_params and parallel_data_prefetch.

`log_txt_as_img` is not ported: the card's machine has no imaging package,
and rendering the committed `data/DejaVuSans.ttf` needs a TrueType
rasterizer of the port's own (ROADMAP queue 1 item 10). It raises.
"""
from __future__ import annotations

import concurrent.futures
from typing import Callable, Sequence

import numpy as np
import torch

_TEXT_ITEM = "ROADMAP queue 1 item 10 (a TrueType rasterizer for data/DejaVuSans.ttf)"


def log_txt_as_img(wh, xc: Sequence[str], size: int = 10) -> np.ndarray:
    raise NotImplementedError(f"log_txt_as_img is not ported: {_TEXT_ITEM}")


def ismap(x) -> bool:
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] > 3


def isimage(x) -> bool:
    return hasattr(x, "ndim") and x.ndim == 4 and x.shape[-1] in (1, 3)


def exists(x) -> bool:
    return x is not None


def default(val, d):
    if val is not None:
        return val
    return d() if callable(d) else d


def mean_flat(tensor: torch.Tensor) -> torch.Tensor:
    """The mean over every dimension but the first."""
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


def count_params(params, verbose: bool = False) -> int:
    """Total element count of an nn.Module's parameters, or of a (nested)
    dict / list of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        total = sum(p.numel() for p in params.parameters())
    else:
        def leaves(tree):
            if isinstance(tree, dict):
                for v in tree.values():
                    yield from leaves(v)
            elif isinstance(tree, (list, tuple)):
                for v in tree:
                    yield from leaves(v)
            else:
                yield tree

        total = sum(int(np.prod(x.shape)) for x in leaves(params))
    if verbose:
        print(f"Model has {total * 1e-6:.2f} M params.")
    return total


def parallel_data_prefetch(func: Callable, data, n_proc: int,
                           target_data_type: str = "ndarray", use_threads: bool = True):
    """`func` over every item of `data` in `n_proc` contiguous chunks, one
    worker a chunk (threads by default, processes with use_threads=False),
    results in the input's order: an ndarray, or a list with
    target_data_type="list"."""
    if target_data_type not in ("ndarray", "list"):
        raise ValueError("target_data_type must be 'ndarray' or 'list'")
    if isinstance(data, np.ndarray) and target_data_type == "list":
        raise ValueError("list expected but function got ndarray")
    if not hasattr(data, "__iter__"):
        raise TypeError("data must be iterable")
    data = list(data) if not isinstance(data, np.ndarray) else data

    n_proc = max(1, min(n_proc, len(data)))
    chunk = (len(data) + n_proc - 1) // n_proc
    chunks = [data[i * chunk:(i + 1) * chunk] for i in range(n_proc)]
    pool_cls = (concurrent.futures.ThreadPoolExecutor if use_threads
                else concurrent.futures.ProcessPoolExecutor)
    with pool_cls(max_workers=n_proc) as ex:
        results = list(ex.map(_apply, [func] * len(chunks), chunks))
    flat = [x for sub in results for x in sub]
    return np.asarray(flat) if target_data_type == "ndarray" else flat


def _apply(func, sub):
    return [func(x) for x in sub]
