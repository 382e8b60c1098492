"""The JAX package's orbax checkpoints on disk, read and written with no
orbax or tensorstore (the counterpart of the files that
`ealdm_tpu/training/checkpoint.py` writes).

An item (a `StandardSave` under `<step>/default`, a `StandardCheckpointer`
save at `last/state`) is a folder:

  _METADATA             JSON: "tree_metadata" maps each leaf's path (the
                        tuple's repr) to its keys ({"key", "key_type": 1 a
                        sequence index, 2 a dict key or field}) and its
                        "value_type": "jax.Array" or "np.ndarray" (a zarr
                        array), "scalar" (a Python number, a 0-d array in
                        the store), or "None" / "Tuple" / "Dict" / "List"
                        (an empty node, no array)
  _CHECKPOINT_METADATA  JSON: the handler, timestamps
  manifest.ocdbt, d/    the OCDBT store (`utils.ocdbt`) of the zarr v2
                        arrays (`utils.zarr2`), one a leaf, named by its
                        keys joined with "." ("1.model.conv_in.kernel")
  array_metadatas/, _sharding, ocdbt.process_<n>/
                        what a jax.Array save adds (read through the root
                        manifest; not needed)

The manager's layout (`ealdm_tpu/training/checkpoint.py`): `<dir>/<step>/
default` with `<step>/metrics/metrics` (JSON) and `<step>/
_CHECKPOINT_METADATA`, and `<dir>/last/state` with `last/meta.json`
({"step": n}).

`OrbaxItem` reads an item leaf by leaf (`read` decodes a leaf into a
tensor); `read_orbax_tree` gives its nested tree (numpy arrays, a bfloat16
leaf as a CPU tensor, Python scalars; a sequence as a list). `write_item`
writes what `StandardCheckpointer.save` writes for a tree of numpy arrays,
which orbax restores with a template: np.ndarray leaves and scalars,
uncompressed, in one OCDBT database. `write_orbax_tree` writes a nested
tree (lists and tuples as sequences, dicts as dicts).
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import ocdbt, zarr2
from ..utils.flax_import import path_name

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLERS = "orbax.checkpoint._src.handlers."
STANDARD = _HANDLERS + "standard_checkpoint_handler.StandardCheckpointHandler"
JSON = _HANDLERS + "json_checkpoint_handler.JsonCheckpointHandler"
_EMPTY = {"None": None, "Tuple": (), "Dict": {}, "List": []}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")

Path = Tuple[Any, ...]


class OrbaxError(ValueError):
    """An orbax checkpoint the reader cannot read."""


def is_item(path: str) -> bool:
    """Whether `path` is an orbax item folder (`_METADATA` and an OCDBT
    manifest)."""
    return (os.path.isfile(os.path.join(path, METADATA))
            and os.path.isfile(os.path.join(path, ocdbt.MANIFEST)))


class OrbaxItem:
    """One item folder: `leaves` maps each leaf's path (int keys for
    sequence indices) to its value type."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        try:
            with open(os.path.join(self.path, METADATA)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise OrbaxError(f"{self.path}: no readable {METADATA} ({e})") from e
        if not meta.get("use_ocdbt", False):
            raise OrbaxError(f"{self.path}: not an OCDBT checkpoint (use_ocdbt false)")
        if meta.get("use_zarr3", False):
            raise OrbaxError(f"{self.path}: zarr v3 arrays are not read")
        self.leaves: Dict[Path, str] = {}
        for text, entry in meta["tree_metadata"].items():
            keys = []
            for k in entry["key_metadata"]:
                if k["key_type"] == 1:
                    keys.append(int(k["key"]))
                elif k["key_type"] == 2:
                    keys.append(k["key"])
                else:
                    raise OrbaxError(f"{self.path}: leaf {text}: key type {k['key_type']} "
                                     "is unknown")
            if tuple(str(k) for k in keys) != tuple(ast.literal_eval(text)):
                raise OrbaxError(f"{self.path}: leaf {text}: its keys say {keys}")
            vt = entry["value_metadata"]["value_type"]
            if vt not in _ARRAYS and vt not in _EMPTY:
                raise OrbaxError(f"{self.path}: leaf {text}: value type {vt!r} is unknown")
            self.leaves[tuple(keys)] = vt
        self.store = ocdbt.OcdbtReader(self.path)

    def _array(self, path: Path) -> str:
        vt = self.leaves.get(tuple(path))
        if vt is None:
            raise KeyError(f"{self.path}: no leaf {path_name(path)}")
        if vt not in _ARRAYS:
            raise OrbaxError(f"{self.path}: leaf {path_name(path)} is {vt}, not an array")
        return path_name(path)

    def read(self, path: Path, dtype: Optional[torch.dtype] = None, shape=None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Leaf `path` as a CPU tensor (decoded into `out` when given); raises
        unless it has `dtype` and `shape` where those are given."""
        name = self._array(path)
        spec = zarr2.read_spec(self.store, name)
        if dtype is not None and spec.torch_dtype() != dtype:
            raise OrbaxError(f"{self.path}: leaf {name} is {spec.dtype_name}, the port keeps "
                             f"{dtype}")
        if shape is not None and tuple(spec.shape) != tuple(shape):
            raise OrbaxError(f"{self.path}: leaf {name} has shape {spec.shape}, the port's "
                             f"is {tuple(shape)}")
        return zarr2.read_into(self.store, name, out, spec=spec)

    def scalar(self, path: Path):
        """A 0-d leaf as a Python number."""
        t = self.read(path)
        if t.dim() != 0:
            raise OrbaxError(f"{self.path}: leaf {path_name(path)} has shape "
                             f"{tuple(t.shape)}, not a number's")
        return t.item()

    def value(self, path: Path):
        """Leaf `path` as `read_orbax_tree` gives it."""
        vt = self.leaves[tuple(path)]
        if vt in _EMPTY:
            return _EMPTY[vt]
        if vt == "scalar":
            return self.scalar(path)
        t = self.read(path)
        return t if t.dtype == torch.bfloat16 else t.numpy()

    def tree(self):
        """The nested tree: dicts, lists (sequences) and leaves."""
        root: dict = {}
        for path in self.leaves:
            node = root
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.value(path)
        return _lists(root)

    def close(self) -> None:
        self.store.close()


def _lists(node):
    if isinstance(node, dict) and node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise OrbaxError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
        return [_lists(node[i]) for i in range(len(node))]
    if isinstance(node, dict):
        return {k: _lists(v) for k, v in node.items()}
    return node


def read_orbax_tree(path: str):
    """The nested tree of item folder `path`: numpy arrays (a bfloat16 leaf
    as a CPU tensor), Python scalars, None and empty containers; a
    sequence (a tuple or a pytree node's children) as a list."""
    item = OrbaxItem(path)
    try:
        return item.tree()
    finally:
        item.close()


# ----------------------------------------------------------------- writing

def flatten_tree(tree, prefix: Path = ()) -> Dict[Path, Any]:
    """{path: leaf} of a nested tree: a list or tuple is a sequence (int
    keys), a dict a dict; an empty one is a leaf."""
    if isinstance(tree, (list, tuple)) and tree:
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, prefix + (i,)))
        return out
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _value_type(v) -> str:
    if v is None:
        return "None"
    for name, empty in (("Tuple", ()), ("List", []), ("Dict", {})):
        if type(v) is type(empty) and not v:
            return name
    if isinstance(v, (bool, int, float)) and not isinstance(v, np.generic):
        return "scalar"
    return "np.ndarray"


def _array_items(name: str, v) -> dict:
    """The OCDBT items of one array leaf: a numpy array, a Python scalar,
    or a callable leaf (`flax_import.LazyLeaf`: shape, dtype, and the
    tensor when called, copied to the host as it is written)."""
    if callable(v) and hasattr(v, "shape"):
        shape, dtype = tuple(v.shape), v.dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()

        def produce(leaf=v):
            return leaf().detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()

        chunk = ocdbt.Deferred(nbytes, produce) if nbytes > ocdbt.MAX_INLINE_VALUE_BYTES \
            else produce()
    else:
        if isinstance(v, (bool, int, float)) and not isinstance(v, np.generic):
            v = np.asarray(v, {bool: np.bool_, int: np.int64, float: np.float64}[type(v)])
        a = np.asarray(v, order="C")  # (ascontiguousarray makes a 0-d array 1-d)
        shape, dtype, chunk = a.shape, a.dtype, a.reshape(-1).view(np.uint8)
    return {f"{name}/.zarray": zarr2.zarray(shape, dtype),
            zarr2.chunk_key(name, len(shape)): chunk}


def _key_meta(path: Path):
    return [{"key": str(k), "key_type": 1 if isinstance(k, int) else 2} for k in path]


def checkpoint_metadata(handlers, metrics=None) -> dict:
    now = time.time_ns()
    return {"item_handlers": handlers, "metrics": metrics or {}, "performance_metrics": {},
            "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
            "custom_metadata": {}}


def write_item(path: str, leaves: Dict[Path, Any], standalone: bool = True) -> int:
    """Write {path: leaf} as an orbax item folder `path` (replaced if it
    exists), as `StandardCheckpointer.save` writes numpy leaves; a leaf is
    an array or tensor ("np.ndarray"), a Python number ("scalar"), None or
    an empty tuple, list or dict, or a callable leaf made when written.
    standalone: the folder carries its own _CHECKPOINT_METADATA (last/state;
    a step's items share the step's). Returns the bytes of the store."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree_meta, items = {}, {}
    for p, v in leaves.items():
        vt = _value_type(v)
        meta = {"value_type": vt, "skip_deserialize": vt in _EMPTY}
        tree_meta[repr(tuple(str(k) for k in p))] = {"key_metadata": _key_meta(p),
                                                      "value_metadata": meta}
        if vt not in _EMPTY:
            items.update(_array_items(path_name(p), v))
    nbytes = ocdbt.write_ocdbt(tmp, items)
    with open(os.path.join(tmp, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    if standalone:
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump(checkpoint_metadata(STANDARD), f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return nbytes


def write_orbax_tree(path: str, tree) -> int:
    """Write a nested tree as an item folder (`write_item`)."""
    return write_item(path, flatten_tree(tree))


# ------------------------------------------------------- the manager layout

def is_step_dir(path: str) -> bool:
    """A step of a JAX `CheckpointManager` (`<step>/default`)."""
    return is_item(os.path.join(path, "default"))


def step_metrics(step_dir: str) -> dict:
    """`<step>/metrics/metrics` ({} where the step saved none)."""
    p = os.path.join(step_dir, "metrics", "metrics")
    if not os.path.isfile(p):
        return {}
    with open(p) as f:
        return json.load(f)


def write_step(directory: str, step: int, leaves: Dict[Path, Any],
               metrics: Optional[dict] = None) -> int:
    """`<directory>/<step>/default` (and `metrics/metrics`), as the JAX
    manager's save writes a step; replaced if it exists."""
    final = os.path.join(directory, str(int(step)))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    nbytes = write_item(os.path.join(tmp, "default"), leaves, standalone=False)
    handlers = {"default": STANDARD}
    if metrics:
        handlers["metrics"] = JSON
        os.makedirs(os.path.join(tmp, "metrics"))
        with open(os.path.join(tmp, "metrics", "metrics"), "w") as f:
            json.dump(metrics, f)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump(checkpoint_metadata(handlers), f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return nbytes


def write_last(directory: str, step: int, item: str) -> None:
    """`<directory>/last/state` and `last/meta.json`, as the JAX manager's
    save_last writes them, from `item`, the `<step>/default` a step's save
    wrote of the same state: its files hard-linked (the store is written
    once) beside the _CHECKPOINT_METADATA of an item saved on its own."""
    last = os.path.join(directory, "last")
    os.makedirs(last, exist_ok=True)
    final = os.path.join(last, "state")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(item, tmp, copy_function=os.link)
    with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
        json.dump(checkpoint_metadata(STANDARD), f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    with open(os.path.join(last, "meta.json"), "w") as f:
        json.dump({"step": int(step)}, f)
