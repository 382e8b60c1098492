"""Random draws of a data-parallel step at the global batch's shape.

A step's draws (t, the noise, the STDiff tower's dropout masks, the
conditioning's noise, a KL posterior's sample) come from one seeded
generator that every rank holds alike. In one process they have the global
batch's shape; a rank that drew at its own shape would get the first rows'
values on every rank. So inside `batch_rows(index, count, rows)` each draw
is made at the global shape and cut to rank `index`'s rows: the leading
axis holds `groups` stacked blocks (2 for the [negative; positive] pair),
each block batch-major with the same number of entries a row; rank `index`
keeps rows [index * rows, (index + 1) * rows) of every block. Outside the
context (one data rank) the draws are the plain ones.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


@contextlib.contextmanager
def batch_rows(index: int, count: int, rows: int):
    """Within the context this thread's draws are rank `index`'s cut (of
    `count` data ranks, `rows` rows each) of the global batch's draws."""
    saved = getattr(_state, "rows", None)
    _state.rows = (index, count, rows) if count > 1 else None
    try:
        yield
    finally:
        _state.rows = saved


def cut(draw, shape, groups: int = 1):
    """`draw(shape)` (a callable of a shape), or within `batch_rows` the
    rank's cut of `draw` at the global shape."""
    rows = getattr(_state, "rows", None)
    shape = tuple(shape)
    if rows is None:
        return draw(shape)
    index, count, b = rows
    per_row, rem = divmod(shape[0], groups * b)
    if rem or per_row == 0:
        raise ValueError(f"a draw of leading size {shape[0]} is not {groups} block(s) of "
                         f"{b} rows")
    whole = draw((groups * count * b * per_row,) + shape[1:])
    whole = whole.reshape(groups, count * b * per_row, *shape[1:])
    return whole[:, index * b * per_row:(index + 1) * b * per_row].reshape(shape)


def randn(shape, generator=None, *, groups: int = 1, **kw) -> torch.Tensor:
    return cut(lambda s: torch.randn(s, generator=generator, **kw), shape, groups)


def rand(shape, generator=None, *, groups: int = 1, **kw) -> torch.Tensor:
    return cut(lambda s: torch.rand(s, generator=generator, **kw), shape, groups)


def randint(high: int, shape, generator=None, *, groups: int = 1, **kw) -> torch.Tensor:
    return cut(lambda s: torch.randint(0, high, s, generator=generator, **kw), shape, groups)
