"""The collectives of the mesh's groups, and the two autograd Functions of
tensor parallelism.

Under the JAX package's GSPMD the compiler emits these from sharding
annotations; here they are called where a layer needs them:

  * `copy_to_model(x, group)`: identity forward; the backward sums the
    gradient of x over the model group (each rank holds the part of dL/dx
    that flows through its own weight shard);
  * `gather_from_model(y, group, dim)`: all-gather of the ranks' slices
    along `dim` forward; the backward returns the rank's own slice of the
    gradient, which every rank of the group holds whole and alike.
    (`torch.distributed.nn.functional.all_gather`'s backward sums the
    group's copies, which scales each sharded layer's gradient by the
    group's size.)

Under gloo (ranks that share a card, or the CPU) the sums and gathers of
the layers and the step go through host memory, and this module is the one
place that stages them. Where a gloo group's ranks all run on this host,
`_HostExchange` gives each rank a slot of shared memory (a memfd that the
others map through /proc, pinned for the card's copies): a rank copies its
tensor into its slot, and after a barrier every rank reads every slot, in
rank order, so all ranks get the same bits; gloo then carries only the
barriers. A group across hosts runs gloo's own collective, the card's
tensors copied through pinned host memory (`_on_host`). NCCL takes the
card's tensors as they are.
"""
from __future__ import annotations

import os
import socket
from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _HostExchange:
    """Shared host memory of one gloo group whose ranks run on this host: a
    slot of `cap` bytes a rank, grown (collectively: every rank asks for the
    same size) when a tensor does not fit."""

    def __init__(self, group):
        self.group, self.n, self.rank = group, group_size(group), group_rank(group)
        self.cap, self.slots, self.pinned = 0, [], False

    def _release(self):
        if self.pinned:
            cudart = torch.cuda.cudart()
            for slot in self.slots:
                cudart.cudaHostUnregister(slot.data_ptr())
        self.slots, self.pinned = [], False

    def _grow(self, nbytes: int, pin: bool) -> None:
        cap = max(nbytes, 2 * self.cap, 1 << 20)
        fd = os.memfd_create("ealdm_exchange")
        try:
            os.ftruncate(fd, cap)
            where: List = [None] * self.n
            dist.all_gather_object(where, (os.getpid(), fd), group=self.group)
            slots = [torch.from_file(f"/proc/{pid}/fd/{f}", shared=True, size=cap,
                                     dtype=torch.uint8) for pid, f in where]
            dist.barrier(group=self.group)  # every rank has mapped every slot
        finally:
            os.close(fd)
        self._release()
        self.slots, self.cap = slots, cap
        if pin:
            cudart = torch.cuda.cudart()
            self.pinned = all(int(cudart.cudaHostRegister(s.data_ptr(), cap, 0)) == 0
                              for s in slots)

    def _slot(self, r: int, t: torch.Tensor) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        return self.slots[r][:nbytes].view(t.dtype).view(t.shape)

    def _put(self, t: torch.Tensor) -> None:
        """t into this rank's slot, then a barrier: every slot is written."""
        nbytes = t.numel() * t.element_size()
        if nbytes > self.cap:
            self._grow(nbytes, t.is_cuda)
        self._slot(self.rank, t).copy_(t)
        dist.barrier(group=self.group)

    def _read(self, r: int, t: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(self._slot(r, t))

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        self._put(t)
        parts = [t if r == self.rank else self._read(r, t) for r in range(self.n)]
        dist.barrier(group=self.group)  # every slot read before any is written again
        return parts

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        self._put(t)
        acc = self._read(0, t)
        for r in range(1, self.n):
            acc += self._read(r, t)
        dist.barrier(group=self.group)
        return t.copy_(acc)


_EXCHANGES = {}


def _exchange(group):
    """The group's `_HostExchange` where it runs gloo on one host (decided
    once, collectively, at its first collective), else None."""
    key = id(group)
    if key not in _EXCHANGES:
        ok = None
        if dist.get_backend(group) == "gloo":
            mine = (socket.gethostname(), hasattr(os, "memfd_create"))
            seen: List = [None] * group_size(group)
            dist.all_gather_object(seen, mine, group=group)
            if all(s == (mine[0], True) for s in seen):
                ok = _HostExchange(group)
        _EXCHANGES[key] = (group, ok)
    return _EXCHANGES[key][1]


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` in pinned host memory (a card's tensor under
    gloo)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over `group` in place (a no-op without a group)."""
    if group is None:
        return t
    ex = _exchange(group) if op == dist.ReduceOp.SUM else None
    if ex is not None:
        c = t.contiguous()
        ex.sum_(c)
        return t if c is t else t.copy_(c)
    if not _staged(t, group):
        dist.all_reduce(t, op=op, group=group)
        return t
    h = _on_host(t)
    dist.all_reduce(h, op=op, group=group)
    return t.copy_(h)


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank `src`'s `t` on every rank of `group` (the world if None),
    in place."""
    if not _staged(t, group):
        dist.broadcast(t, src, group=group)
        return t
    h = _on_host(t)
    dist.broadcast(h, src, group=group)
    return t.copy_(h)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (one shape) joined along `dim` in rank order, on
    t's device, in t's memory format where it is channels_last."""
    n = group_size(group)
    if n == 1:
        return t
    ex = _exchange(group)
    if ex is not None:
        parts = ex.all_gather(t.contiguous())
    else:
        x = _on_host(t) if _staged(t, group) else t.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    cl = (t.dim() == 4 and not t.is_contiguous()
          and t.is_contiguous(memory_format=torch.channels_last))
    fmt = torch.channels_last if cl else torch.contiguous_format
    return out.to(t.device).contiguous(memory_format=fmt)


def join_blocks(parts: torch.Tensor, n: int, dim: int, blocks: int) -> torch.Tensor:
    """The group's slices (joined along `dim` as `all_gather` does) put in
    their places when the axis is `blocks` blocks each cut in n (the LSTM's
    four gates): [n, blocks, s] -> [blocks, n, s] along `dim`."""
    if blocks == 1:
        return parts
    shape = list(parts.shape)
    s = shape[dim] // (n * blocks)
    x = parts.reshape(shape[:dim] + [n, blocks, s] + shape[dim + 1:])
    return x.transpose(dim, dim + 1).reshape(shape)


def own_slice(x: torch.Tensor, rank: int, n: int, dim: int, blocks: int = 1) -> torch.Tensor:
    """The slice of a whole tensor that rank `rank` of n holds along `dim`
    (each of `blocks` blocks cut in n)."""
    shape = list(x.shape)
    s = shape[dim] // (n * blocks)
    v = x.reshape(shape[:dim] + [blocks, n, s] + shape[dim + 1:]).select(dim + 1, rank)
    return v.reshape(shape[:dim] + [blocks * s] + shape[dim + 1:])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, blocks):
        ctx.group, ctx.dim, ctx.blocks = group, dim % x.dim(), blocks
        n = group_size(group)
        return join_blocks(all_gather(x, group, ctx.dim), n, ctx.dim, blocks)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        return (own_slice(g, group_rank(ctx.group), n, ctx.dim, ctx.blocks).contiguous(),
                None, None, None)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int, blocks: int = 1) -> torch.Tensor:
    return x if group is None else _GatherFromModel.apply(x, group, dim, blocks)


def barrier(group=None) -> None:
    """Wait for every rank of `group` (the world if None) when more than
    one runs."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def broadcast_object(obj, src: int = 0):
    """rank `src`'s `obj` on every rank (itself without a process group)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
