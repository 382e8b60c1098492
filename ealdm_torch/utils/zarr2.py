"""zarr v2 arrays over a key-value store (`utils.ocdbt`), as tensorstore's
zarr driver lays them out in the JAX package's orbax checkpoints.

An array `name` is the key `name/.zarray` (JSON: shape, chunks, dtype,
compressor, fill_value, order, filters, dimension_separator, zarr_format)
and one key a chunk, `name/<i>.<j>...` (`name/0` for a 0-d array), each
chunk a C-order block of `chunks` elements, zstd-compressed or raw. Read:
dtypes `<f4`, `<f2`, `<i4`, `<i8`, `<u4`, `|b1` and `bfloat16`, order C,
the `.` or `/` separator, any chunk grid (edge chunks are stored whole),
an absent chunk (the fill value), and the zstd compressor or none; any
other codec, dtype, order or filter raises naming the array. Each chunk
decodes straight into its place in the output when the grid has one
chunk (a checkpoint's leaves), else through one chunk buffer. Written:
one chunk, `"compressor": null`.
"""
from __future__ import annotations

import itertools
import json
from typing import Optional

import numpy as np
import torch

from . import zstd

_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
           "<u4": np.uint32, "|b1": np.bool_, "bool": np.bool_, "<f8": np.float64}
_TORCH = {"<f4": torch.float32, "<f2": torch.float16, "<i4": torch.int32, "<i8": torch.int64,
          "<u4": torch.uint32, "|b1": torch.bool, "bool": torch.bool, "<f8": torch.float64,
          "bfloat16": torch.bfloat16}


class ZarrError(ValueError):
    """An array the reader cannot read."""


class ArraySpec:
    """The parsed `.zarray` of array `name`."""

    def __init__(self, name: str, meta: dict):
        self.name = name
        fail = lambda what: ZarrError(f"zarr array {name!r}: {what}")  # noqa: E731
        if meta.get("zarr_format") != 2:
            raise fail(f"zarr_format {meta.get('zarr_format')!r}, only 2 is read")
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(s) for s in meta["chunks"])
        if len(self.chunks) != len(self.shape):
            raise fail(f"chunks {self.chunks} for shape {self.shape}")
        self.dtype_name = meta["dtype"]
        if self.dtype_name not in _TORCH:
            raise fail(f"dtype {self.dtype_name!r} is not read")
        if meta.get("order", "C") != "C":
            raise fail(f"order {meta.get('order')!r}, only C is read")
        if meta.get("filters"):
            raise fail(f"filters {meta['filters']!r} are not read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise fail(f"compressor {comp.get('id')!r}, only zstd or none is read")
        self.compressed = comp is not None
        self.sep = meta.get("dimension_separator", ".")
        if self.sep not in (".", "/"):
            raise fail(f"dimension_separator {self.sep!r}")
        self.fill_value = meta.get("fill_value")

    def chunk_key(self, index) -> str:
        return f"{self.name}/" + (self.sep.join(str(i) for i in index) if index else "0")

    def grid(self):
        return [range(-(-s // c)) if c else range(1) for s, c in zip(self.shape, self.chunks)]

    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self.dtype_name]


def read_spec(store, name: str) -> ArraySpec:
    try:
        raw = bytes(store.read(f"{name}/.zarray"))
    except KeyError as e:
        raise ZarrError(f"zarr array {name!r}: no .zarray ({e})") from e
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise ZarrError(f"zarr array {name!r}: .zarray is not JSON ({e})") from e
    return ArraySpec(name, meta)


def _decode_chunk(spec: ArraySpec, store, key: str, out_bytes: np.ndarray) -> None:
    """Decode chunk `key` into the uint8 buffer `out_bytes` (its whole size)."""
    data = store.read(key)
    if spec.compressed:
        try:
            zstd.decompress_into(data, out_bytes)
        except zstd.ZstdError as e:
            raise ZarrError(f"zarr chunk {key!r}: zstd: {e}") from e
    else:
        if memoryview(data).nbytes != out_bytes.nbytes:
            raise ZarrError(f"zarr chunk {key!r}: {memoryview(data).nbytes} bytes, "
                            f"not {out_bytes.nbytes}")
        out_bytes[...] = np.frombuffer(data, np.uint8)


def _fill(spec: ArraySpec, out: torch.Tensor) -> None:
    if spec.fill_value is None:
        raise ZarrError(f"zarr array {spec.name!r}: a chunk is absent and there is no "
                        "fill value")
    out.fill_(spec.fill_value)


def read_into(store, name: str, out: Optional[torch.Tensor] = None,
              spec: Optional[ArraySpec] = None) -> torch.Tensor:
    """Array `name` as a CPU tensor: decoded into `out` (contiguous, of its
    shape and dtype) when given, else into a new one."""
    spec = spec or read_spec(store, name)
    dtype = spec.torch_dtype()
    if out is None:
        out = torch.empty(spec.shape, dtype=dtype)
    elif tuple(out.shape) != spec.shape or out.dtype != dtype or not out.is_contiguous() \
            or out.device.type != "cpu":
        raise ZarrError(f"zarr array {name!r}: {spec.shape} {spec.dtype_name} into a "
                        f"{tuple(out.shape)} {out.dtype} tensor on {out.device}")
    whole = spec.chunks == spec.shape
    flat = out.view(-1).view(torch.uint8) if out.numel() else None
    if whole:
        key = spec.chunk_key((0,) * len(spec.shape))
        if key not in store:
            _fill(spec, out)
        elif out.numel():
            _decode_chunk(spec, store, key, flat.numpy())
        return out
    n = int(np.prod(spec.chunks))
    buf = torch.empty(spec.chunks, dtype=dtype)
    for index in itertools.product(*spec.grid()):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, spec.chunks, spec.shape))
        key = spec.chunk_key(index)
        if key not in store:
            _fill(spec, out[sl])
            continue
        if n:
            _decode_chunk(spec, store, key, buf.view(-1).view(torch.uint8).numpy())
        out[sl] = buf[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


_NAME_OF_TORCH = {torch.float32: "<f4", torch.float16: "<f2", torch.int32: "<i4",
                  torch.int64: "<i8", torch.bool: "|b1", torch.float64: "<f8",
                  torch.bfloat16: "bfloat16"}
_NAME_OF_NUMPY = {np.dtype(v): k for k, v in _DTYPES.items() if k != "bool"}


def zarray(shape, dtype) -> bytes:
    """The `.zarray` JSON of a one-chunk, uncompressed array of `dtype`
    (torch's or numpy's), as tensorstore writes it."""
    names = _NAME_OF_TORCH if isinstance(dtype, torch.dtype) else _NAME_OF_NUMPY
    key = dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)
    if key not in names:
        raise ZarrError(f"no zarr dtype for {dtype}")
    meta = {"chunks": list(shape), "compressor": None, "dimension_separator": ".",
            "dtype": names[key], "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":")).encode()


def chunk_key(name: str, ndim: int) -> str:
    """The key of a one-chunk array's chunk."""
    return f"{name}/" + (".".join("0" * ndim) or "0")
