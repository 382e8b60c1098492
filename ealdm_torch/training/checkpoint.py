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
from typing import Any, Dict, Optional

import torch

from ..parallel.comm import barrier
from ..parallel.mesh import world

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
        there; None if neither holds a whole checkpoint."""
        for p in (path, path + _ASIDE):
            if os.path.exists(os.path.join(p, _META)):
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
            if step.isdigit() and self._live(path) == os.path.join(self.directory, name):
                with open(os.path.join(self.directory, name, _META)) as f:
                    out[int(step)] = json.load(f)["metrics"]
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

    def _load(self, path: str, state_template: Any) -> Any:
        live = self._live(path)
        if live is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        device = _first_tensor(state_template.state_dict()).device
        sd = torch.load(os.path.join(live, _STATE), map_location=device, weights_only=True)
        state_template.load_state_dict(sd)
        return state_template

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint `step` (the latest if None, else `last`) into
        `state_template`, in place, and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return self.restore_last(state_template)
        return self._load(os.path.join(self.directory, str(int(step))), state_template)

    def restore_last(self, state_template: Any) -> Any:
        return self._load(self._last_dir, state_template)

    def read(self, step: Optional[int] = None, last: bool = False, map_location=None,
             mmap: bool = False) -> dict:
        """The saved `state_dict()` itself, with no state to copy it into
        (the sampling CLIs take the parameters or the EMA shadow from it):
        checkpoint `step`, or `last` with last=True, else the latest step
        (`last` when there is none); with `mmap`, memory-mapped (`torch.load`'s)."""
        if not last and step is None:
            step = self.latest_step()
        path = self._last_dir if last or step is None else os.path.join(
            self.directory, str(int(step)))
        live = self._live(path)
        if live is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
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


def _first_tensor(tree: dict) -> Optional[torch.Tensor]:
    """The first tensor in a state_dict's nested dicts (where the state lives)."""
    for v in tree.values():
        found = v if isinstance(v, torch.Tensor) else (
            _first_tensor(v) if isinstance(v, dict) else None)
        if found is not None:
            return found
    return None
