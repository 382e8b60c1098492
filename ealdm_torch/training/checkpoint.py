"""Checkpoints of a train state with the reference's retention rules
(counterpart of `ealdm_tpu/training/checkpoint.py`, which keeps them with
orbax).

A state is any object with `state_dict()` and `load_state_dict(sd)` (the
LDM `TrainState`, the first stage's `VAETrainState`). `save` writes the
whole state (parameters, EMA shadow, optimizer state, step) as
`<directory>/<step>/state.pt` with `torch.save`, beside its scalar
metrics, and rewrites `<directory>/last`. With a monitored metric it keeps
the `save_top_k` best checkpoints that report it and every checkpoint that
does not (orbax's keep_checkpoints_without_metrics); without one, the
`save_top_k` latest. `restore` copies a checkpoint into a state of the same
structure, in place.

A checkpoint is written to `<name>.tmp` and renamed into place; the one it
replaces is first renamed to `<name>.old` and removed last, so a crash at
any point leaves a whole checkpoint under one of the two names, and the
readers take `<name>.old` where `<name>` is missing.

The readers (`restore`, `restore_last`, `read`, `latest_step`,
`best_step`) take the JAX package's checkpoints too, known by their files
(`training/orbax_format.py`): a step `<step>/default` (an orbax item) with
its metrics in `<step>/metrics/metrics`, and `last/state` with
`last/meta.json`; a directory may hold both kinds (a JAX run the port
resumed). A JAX state is imported leaf by leaf into the state's own
tensors (`utils.flax_import.import_state`); `read` gives its parameters
and EMA shadow under the port's names, each decoded when it is taken.
`write_jax_checkpoint` writes a state in the JAX layout, for the JAX
package to restore.

Under `torch.distributed` every rank calls `save` and `save_last`: with a
`mesh` whose model group cuts the state, the state is first gathered whole
(`parallel.gather_state`, collective over the model group); rank 0 alone
writes, in the format one process writes, so a checkpoint resumes under any
layout; and every rank then waits at a barrier, so none reads or leaves
before the files are whole. Every rank reads a checkpoint whole; the caller
cuts it (`parallel.shard_state`).
"""
from __future__ import annotations

import json
import os
import shutil
from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.comm import barrier
from ..parallel.mesh import world
from ..utils import flax_import
from . import orbax_format

_STATE, _META = "state.pt", "meta.json"
_ASIDE = ".old"


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 3,
                 monitor: Optional[str] = "val/loss_simple_ema", mode: str = "min",
                 every_n_train_steps: Optional[int] = None, mesh=None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.writer = world()[1] == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)
        self.save_top_k, self.monitor, self.mode = save_top_k, monitor, mode
        self.every_n_train_steps = every_n_train_steps
        self._last_dir = os.path.join(self.directory, "last")

    def _state_dict(self, state: Any) -> dict:
        """The state's whole state_dict (gathered over a cutting model group)."""
        if self.mesh is None or self.mesh.model == 1:
            return state.state_dict()
        from ..parallel.sharding import gather_state

        return gather_state(state, self.mesh)

    def _write(self, path: str, sd: dict, meta: dict) -> None:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(sd, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(path):
            shutil.rmtree(path + _ASIDE, ignore_errors=True)
            os.replace(path, path + _ASIDE)
        os.replace(tmp, path)
        shutil.rmtree(path + _ASIDE, ignore_errors=True)

    @staticmethod
    def _live(path: str) -> Optional[str]:
        """`path`, or the copy `_write` set aside if a crash cut it off
        there (or a JAX step there); None if neither holds a whole
        checkpoint."""
        for p in (path, path + _ASIDE):
            if os.path.exists(os.path.join(p, _META)) or orbax_format.is_step_dir(p):
                return p
        return None

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        metrics = {k: float(v) for k, v in (metrics or {}).items()
                   if getattr(v, "ndim", 0) == 0}
        sd = self._state_dict(state)
        if self.writer:
            self._write(os.path.join(self.directory, str(int(step))), sd,
                        {"step": int(step), "metrics": metrics})
            self._prune()
            self._write(self._last_dir, sd, {"step": int(step)})
        barrier()

    def save_last(self, state: Any, step: int) -> None:
        """The unconditional `last.ckpt` (also the crash-path save)."""
        sd = self._state_dict(state)
        if self.writer:
            self._write(self._last_dir, sd, {"step": int(step)})
        barrier()

    def _metrics(self) -> Dict[int, dict]:
        out = {}
        for name in os.listdir(self.directory):
            step = name[:-len(_ASIDE)] if name.endswith(_ASIDE) else name
            path = os.path.join(self.directory, step)
            live = os.path.join(self.directory, name)
            if not (step.isdigit() and self._live(path) == live):
                continue
            if os.path.exists(os.path.join(live, _META)):
                with open(os.path.join(live, _META)) as f:
                    out[int(step)] = json.load(f)["metrics"]
            else:
                out[int(step)] = orbax_format.step_metrics(live)
        return out

    def _ranked(self, metrics: Dict[int, dict]):
        """Steps that report the monitored metric, best first (the later
        step first among equals)."""
        sign = 1.0 if self.mode == "min" else -1.0
        scored = [s for s, m in metrics.items() if self.monitor in m]
        return sorted(scored, key=lambda s: (sign * metrics[s][self.monitor], -s))

    def _prune(self) -> None:
        metrics = self._metrics()
        if self.monitor:
            drop = self._ranked(metrics)[self.save_top_k:]
        else:
            drop = sorted(metrics)[:-self.save_top_k] if self.save_top_k else sorted(metrics)
        for step in drop:
            shutil.rmtree(self._live(os.path.join(self.directory, str(step))))

    def _load(self, path: str, state_template: Any, model) -> Any:
        live = self._live(path)
        if live is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        item = _jax_item(live)
        if item is not None:
            if model is None:
                raise ValueError(f"{item}: a JAX checkpoint names its leaves by the model; "
                                 f"give the model the state trains")
            return import_jax_state(item, state_template, model)
        device = _first_tensor(state_template.state_dict()).device
        sd = torch.load(os.path.join(live, _STATE), map_location=device, weights_only=True)
        state_template.load_state_dict(sd)
        return state_template

    def restore(self, state_template: Any, step: Optional[int] = None, model=None) -> Any:
        """Load checkpoint `step` (the latest if None, else `last`) into
        `state_template`, in place, and return it. `model`: what the state
        trains (an LDM, or a first stage's (autoencoder, loss module)
        pair), which a JAX checkpoint needs (`import_jax_state`)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return self.restore_last(state_template, model)
        return self._load(os.path.join(self.directory, str(int(step))), state_template, model)

    def restore_last(self, state_template: Any, model=None) -> Any:
        return self._load(self._last_dir, state_template, model)

    def read(self, step: Optional[int] = None, last: bool = False, map_location=None,
             mmap: bool = False) -> dict:
        """The saved `state_dict()` itself, with no state to copy it into
        (the sampling CLIs take the parameters or the EMA shadow from it):
        checkpoint `step`, or `last` with last=True, else the latest step
        (`last` when there is none); with `mmap`, memory-mapped (`torch.load`'s).
        A JAX checkpoint gives `read_jax_state`'s (decoded on the host as
        each tensor is taken; map_location and mmap do not apply)."""
        if not last and step is None:
            step = self.latest_step()
        path = self._last_dir if last or step is None else os.path.join(
            self.directory, str(int(step)))
        live = self._live(path)
        if live is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        item = _jax_item(live)
        if item is not None:
            return read_jax_state(item)
        return torch.load(os.path.join(live, _STATE), map_location=map_location,
                          weights_only=True, mmap=mmap)

    def latest_step(self) -> Optional[int]:
        steps = list(self._metrics())
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        if not self.monitor:
            return None
        ranked = self._ranked(self._metrics())
        return ranked[0] if ranked else None

    def should_save_every_n(self, step: int) -> bool:
        n = self.every_n_train_steps
        return bool(n) and step > 0 and step % n == 0


def _jax_item(live: str) -> Optional[str]:
    """The orbax item of checkpoint folder `live` (a JAX step's `default`,
    JAX's `last/state`), or None for one of the port's."""
    if os.path.exists(os.path.join(live, _STATE)):
        return None
    for name in ("default", "state"):
        if orbax_format.is_item(os.path.join(live, name)):
            return os.path.join(live, name)
    return None


def _zero_biases(sd: dict, model) -> Dict[str, torch.Tensor]:
    """The LSTMs' bias_ih in an LDM state_dict's parameters and EMA shadow:
    no JAX leaf holds them, so they are 0 (none in a first stage's)."""
    if "params" not in sd:
        return {}
    parts = {"params": sd["params"], "shadow": (sd.get("ema") or {}).get("shadow", {})}
    return {f"{p}.{k}": t[k] for p, t in parts.items()
            for k in flax_import.lstm_zero_biases(model) if k in t}


@torch.no_grad()
def import_jax_state(item_path: str, state: Any, model) -> Any:
    """Copy the JAX train state of orbax item `item_path` into `state` (a
    `TrainState` or `VAETrainState` from `init_train_state` /
    `init_vae_train_state`, whole), in place, one leaf at a time; `model`
    is what it trains (an LDM, or the pair (autoencoder, loss module)),
    whose flax names the leaves carry. An LR schedule's count in the JAX
    tree is taken as the optimizer's count."""
    sd = state.state_dict()
    item = orbax_format.OrbaxItem(item_path)
    try:
        scheduled = any(p[-3:] == ("inner_state", 2, "count") for p in item.leaves)
        layout = flax_import.state_layout(sd, model, scheduled)
        flax_import.import_state(layout, item, _zero_biases(sd, model).values())
    finally:
        item.close()
    state.load_state_dict(sd)  # the numbers; each tensor is copied onto itself
    return state


class _JaxLeaves(Mapping):
    """The port tensors of one flax subtree of a JAX item (the parameters,
    the EMA shadow), under the port's names (`flax_import`'s rules), each
    decoded from the item when it is taken."""

    def __init__(self, item: "orbax_format.OrbaxItem", prefix: tuple):
        self.item, self.prefix = item, prefix
        self.groups: Dict[str, list] = {}  # port name -> the flax leaves making it
        for path, vt in item.leaves.items():
            if path[:len(prefix)] != prefix or vt in ("None", "Tuple", "Dict", "List"):
                continue
            flax = ".".join(str(k) for k in path[len(prefix):])
            for port in flax_import.port_names(flax):
                self.groups.setdefault(port, []).append(path)

    def __getitem__(self, port: str) -> torch.Tensor:
        tree: dict = {}
        for path in self.groups[port]:
            node = tree
            for k in path[len(self.prefix):-1]:
                node = node.setdefault(str(k), {})
            node[str(path[-1])] = self.item.read(path).numpy()
        return torch.from_numpy(np.ascontiguousarray(flax_import.flax_to_state_dict(tree)[port]))

    def __iter__(self):
        return iter(self.groups)

    def __len__(self) -> int:
        return len(self.groups)


def read_jax_state(item_path: str) -> dict:
    """The saved LDM train state of orbax item `item_path` as the port's
    `state_dict()` names it, for the sampling tools: "step", "params" and
    "ema" ({"shadow", "decay", "num_updates"} or None), the tensors decoded
    as they are taken."""
    item = orbax_format.OrbaxItem(item_path)
    if (0,) not in item.leaves or not any(p[:1] == (1,) for p in item.leaves):
        raise ValueError(f"{item_path}: not the JAX package's LDM TrainState "
                         f"(leaves '0' and '1')")
    ema = None
    if item.leaves.get((3,)) != "None":
        ema = {"shadow": _JaxLeaves(item, (3, "shadow")), "decay": item.scalar((3, "decay")),
               "num_updates": item.scalar((3, "num_updates"))}
    return {"step": int(item.scalar((0,))), "params": _JaxLeaves(item, (1,)), "ema": ema}


def write_jax_checkpoint(directory: str, state: Any, step: int, model, optimizer=None,
                         metrics: Optional[dict] = None, mesh=None) -> int:
    """Write `state` in the JAX package's manager layout, as its
    `CheckpointManager.save` and `save_last` do: `<directory>/<step>/default`
    (with `metrics/metrics` when given) and `<directory>/last/state` with
    `last/meta.json`, the two items on one store (`orbax_format.write_last`).
    `model` is what the state trains (an LDM, or the pair (autoencoder,
    loss module)); `optimizer` the LDM's `AdamW`, whose LR schedule JAX's
    tree records (None: no schedule). Under `torch.distributed` every rank
    calls it: with a `mesh` whose model group cuts the state the state is
    gathered whole first; rank 0 writes; all wait at a barrier. Returns the
    bytes of the store written (0 on the other ranks)."""
    metrics = {k: float(v) for k, v in (metrics or {}).items()
               if getattr(v, "ndim", 0) == 0}
    if mesh is None or mesh.model == 1:
        sd = state.state_dict()
    else:
        from ..parallel.sharding import gather_state

        sd = gather_state(state, mesh)
    nbytes = 0
    if world()[1] == 0:
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        scheduled = optimizer is not None and optimizer.schedule_fn is not None
        leaves = flax_import.export_state(flax_import.state_layout(sd, model, scheduled),
                                          _zero_biases(sd, model))
        nbytes = orbax_format.write_step(directory, step, leaves, metrics)
        orbax_format.write_last(directory, step, os.path.join(directory, str(int(step)),
                                                              "default"))
    barrier()
    return nbytes


def _first_tensor(tree: dict) -> Optional[torch.Tensor]:
    """The first tensor in a state_dict's nested dicts (where the state lives)."""
    for v in tree.values():
        found = v if isinstance(v, torch.Tensor) else (
            _first_tensor(v) if isinstance(v, dict) else None)
        if found is not None:
            return found
    return None
