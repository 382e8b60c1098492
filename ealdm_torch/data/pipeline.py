"""Host-side data pipeline (counterpart of `ealdm_tpu/data/pipeline.py`):
map-style datasets batched into numpy dicts of static shapes (drop_last),
seeded epoch shuffling, the config-driven DataModule, and a prefetcher that
stages each batch on the device from a background thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


class Dataset:
    """Map-style dataset: __len__ + __getitem__ returning a tree of arrays."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Any:
        raise NotImplementedError


class WrappedDataset(Dataset):
    """Wrap an arbitrary indexable into the Dataset protocol (the reference's
    `WrappedDataset`, main.py:140-148)."""

    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def skip_item(self, idx):
        skip = getattr(self.data, "skip_item", None)
        if skip is not None:
            skip(idx)


def _stack(items: Sequence[Any]) -> Any:
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:
    """Batches of `batch_size` items, shuffled each epoch by
    RandomState(seed + epoch) when `shuffle`, the last partial batch dropped
    when `drop_last`. rows=(index, count): a data-parallel rank's loader,
    which reads the same global batches in the same order and loads only
    its rows [index * b, (index + 1) * b) of each, b = batch_size / count
    (`jax.make_array_from_process_local_data`'s per-process rows). A dataset
    whose items draw from a stream of its own (`skip_item(idx)`) is told of
    the other rows, in order, so its draws stay those of one process."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, collate_fn: Optional[Callable] = None,
                 rows: Optional[Tuple[int, int]] = None):
        if rows is not None and (batch_size % rows[1] or not drop_last):
            raise ValueError(f"batch {batch_size} does not split over {rows[1]} data ranks")
        self.rows = rows
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.collate_fn = collate_fn or _stack

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.rows is None:
                yield self.collate_fn([self.dataset[int(i)] for i in idx])
                continue
            b = self.batch_size // self.rows[1]
            mine = range(self.rows[0] * b, (self.rows[0] + 1) * b)
            skip = getattr(self.dataset, "skip_item", lambda i: None)
            items = []
            for j, i in enumerate(idx):
                if j in mine:
                    items.append(self.dataset[int(i)])
                else:
                    skip(int(i))
            yield self.collate_fn(items)


def _numeric(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype.kind in "biuf"


def to_device(batch, device, stream=None):
    """The batch with each numeric numpy leaf as a tensor on `device`;
    string and object leaves stay on the host. On a CUDA device each leaf
    goes through pinned memory and copies with non_blocking on `stream` (the
    current stream if None)."""
    if isinstance(batch, dict):
        return {k: to_device(v, device, stream) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(v, device, stream) for v in batch)
    if not _numeric(batch):
        return batch
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return t.to(device)
    with torch.cuda.stream(stream):  # a no-op for None
        return t.pin_memory().to(device, non_blocking=True)


def _tensors(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _tensors(v)
    elif isinstance(batch, (tuple, list)):
        for v in batch:
            yield from _tensors(v)
    elif isinstance(batch, torch.Tensor):
        yield batch


class DevicePrefetcher:
    """A background thread reads the loader and stages each batch on
    `device`, keeping `buffer_size` batches ahead of the caller. A worker's
    error is raised in the caller, after the batches staged before it.

    On a CUDA device the worker copies on a side stream of its own, through
    pinned memory with non_blocking=True, and records an event after each
    batch. Before a batch is handed out, the caller's current stream waits
    on that event (so no kernel reads a tensor before its copy lands), and
    each tensor is `record_stream`-ed on the caller's stream (so the caching
    allocator does not give its memory to a later copy on the side stream
    while the caller's kernels may still read it)."""

    def __init__(self, loader, device="cuda", buffer_size: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.buffer_size = buffer_size

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        sentinel = object()
        error: list = []
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    staged = to_device(batch, self.device, stream)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(stream)
                    q.put((staged, event))
            except BaseException as e:  # raised in the caller, never swallowed
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                staged, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for x in _tensors(staged):
                        x.record_stream(current)
                yield staged
        finally:
            # a caller that stops early (max_steps) releases the worker
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if error:
            raise error[0]


class DataModule:
    """Config-driven train/val/test loaders (the reference's
    DataModuleFromConfig).

    dataset_configs: {"train": {target, params}, "validation": ..., "test": ...}
    """

    def __init__(self, batch_size: int, dataset_configs: Dict[str, Dict], num_workers: int = 0,
                 wrap: bool = False, seed: int = 0, rows: Optional[Tuple[int, int]] = None):
        from ..config import instantiate_from_config

        self.batch_size = batch_size
        self.seed = seed
        self.rows = rows  # (data index, data ranks): each loader's rows
        self.datasets: Dict[str, Dataset] = {}
        for split, cfg in dataset_configs.items():
            if cfg is None:
                continue
            ds = instantiate_from_config(cfg)
            self.datasets[split] = WrappedDataset(ds) if wrap else ds

    def _loader(self, split: str, shuffle: bool, rows) -> Optional[DataLoader]:
        ds = self.datasets.get(split)
        if ds is None:
            return None
        return DataLoader(ds, self.batch_size, shuffle=shuffle, drop_last=True, seed=self.seed,
                          rows=rows)

    def train_dataloader(self, whole: bool = False):
        """The train loader; with `whole`, of the global batches on any rank."""
        return self._loader("train", True, None if whole else self.rows)

    def val_dataloader(self):
        return self._loader("validation", False, self.rows)

    def test_dataloader(self):
        return self._loader("test", False, self.rows)

    def predict_dataloader(self):
        return self._loader("predict", False, self.rows)
