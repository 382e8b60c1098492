"""Rank layout for data and tensor parallelism (counterpart of
`ealdm_tpu/parallel/mesh.py`), one process a device on `torch.distributed`.

The JAX package lays its devices out as a `data` x `model` mesh,
`np.asarray(devices).reshape(data, model)`. Here each device is one rank,
so rank r sits at data index r // model and model index r % model: a model
group holds `model` consecutive ranks, a data group the ranks that share a
model index. `create_mesh` makes every group on every rank (as
`torch.distributed.new_group` requires) and keeps the rank's two. Groups of
one rank are None: a layer or a step with no group runs no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining devices
    model: int = 1   # tensor-parallel degree

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        return data, model


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a `data` x `model` layout and its two groups."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: Any = None    # the ranks of this model index (None: one rank)
    model_group: Any = None   # the ranks of this data index (None: one rank)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def world() -> tuple[int, int]:
    """(world size, rank) of the initialised process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def create_mesh(config: MeshConfig = MeshConfig(), n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the initialised process group (one rank without one).
    n_devices, if given, must be the world size."""
    size, rank = world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"{n_devices} devices asked for, {size} ranks running")
    data, model = config.resolve(size)
    groups = {}
    if size > 1:
        # every rank makes every group, in one order
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            g = dist.new_group(ranks) if model > 1 else None
            if rank in ranks:
                groups["model"] = g
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            g = dist.new_group(ranks) if data > 1 else None
            if rank in ranks:
                groups["data"] = g
    return Mesh(data=data, model=model, rank=rank, data_group=groups.get("data"),
                model_group=groups.get("model"))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    data = mesh.shape["data"]
    if global_batch % data:
        raise ValueError(f"batch {global_batch} does not split over {data} data ranks")
    return global_batch // data


def scale_learning_rate(
    base_lr: float,
    batch_size: int,
    n_devices: int,
    accumulate_grad_batches: int = 1,
    scale_lr: bool = True,
) -> float:
    """Reference LR convention: lr = accumulate x ndev x bs x base_lr; pass
    scale_lr=False to use base_lr."""
    if not scale_lr:
        return base_lr
    return accumulate_grad_batches * n_devices * batch_size * base_lr

