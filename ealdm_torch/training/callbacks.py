"""Training callbacks (counterpart of `ealdm_tpu/training/callbacks.py`; the
reference's main.py:244-469): the run directories and the merged config,
the JSONL + TensorBoard scalar log, image grids with the condition CSV, and
the epoch time with the device's memory.

Nothing here needs PyYAML or PIL (the card's machine has neither): the
config is written by a small YAML emitter (`to_yaml`) and images by
`utils/png.py`.
"""
from __future__ import annotations

import csv
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.png import save_png

__all__ = ["DeviceStatsCallback", "ImageLogger", "MetricLogger", "SetupCallback", "save_png",
           "to_uint8_grid", "to_yaml"]


def to_uint8_grid(images, nrow: int = 4) -> np.ndarray:
    """[N, H, W, C] in [-1, 1] (array or tensor) -> one [gh, gw, 3] uint8
    grid, `nrow` images a row."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    images = np.clip((np.asarray(images, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    n, h, w, c = images.shape
    if c == 1:
        images = np.repeat(images, 3, axis=-1)
    elif c > 3:
        images = images[..., :3]
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * h, ncol * w, 3), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return (grid * 255).astype(np.uint8)


def _yaml_scalar(v) -> str:
    """A YAML scalar that PyYAML's safe_load reads back as `v`: floats with
    a dot in the mantissa and a signed exponent (`1.0e-06`; PyYAML reads
    `1e-06` as a string), strings double-quoted (JSON escapes are YAML's)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        mant, _, exp = repr(v).partition("e")
        if "." not in mant:
            mant += ".0"
        return f"{mant}e{exp}" if exp else mant
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"to_yaml takes dicts, lists, str, int, float, bool and None, not "
                    f"{type(v).__name__}")


def _yaml_lines(obj, indent: int):
    pad = " " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = _yaml_scalar(k)
            if isinstance(v, (dict, list, tuple)) and len(v):
                yield f"{pad}{key}:"
                yield from _yaml_lines(v, indent + 2)
            else:
                yield f"{pad}{key}: {_yaml_flat(v)}"
    else:
        for v in obj:
            if isinstance(v, (dict, list, tuple)) and len(v):
                yield f"{pad}-"
                yield from _yaml_lines(v, indent + 2)
            else:
                yield f"{pad}- {_yaml_flat(v)}"


def _yaml_flat(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _yaml_scalar(v)


def to_yaml(config: Dict) -> str:
    """Block-style YAML of a config made of dicts, lists (tuples), str, int,
    float, bool and None, in insertion order."""
    if not isinstance(config, dict):
        raise TypeError("to_yaml takes a dict")
    return "\n".join(_yaml_lines(config, 0)) + "\n" if config else "{}\n"


class SetupCallback:
    """Make logdir, its checkpoints/ and configs/, and write the merged
    config to configs/<now>-<name>.yaml."""

    def __init__(self, logdir: str, config: Dict, name: str = "project"):
        self.logdir = logdir
        self.ckptdir = os.path.join(logdir, "checkpoints")
        self.cfgdir = os.path.join(logdir, "configs")
        self.config = config
        self.name = name

    def on_start(self, now: str = "") -> str:
        for d in (self.logdir, self.ckptdir, self.cfgdir):
            os.makedirs(d, exist_ok=True)
        path = os.path.join(self.cfgdir, f"{now}-{self.name}.yaml")
        with open(path, "w") as f:
            f.write(to_yaml(self.config))
        return path


class MetricLogger:
    """Scalars a step to logdir/metrics.jsonl (the primary log), to a
    TensorBoard event file under logdir/tb, and optionally to stdout."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl", tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self.tb = None
        if tensorboard:
            from .tensorboard import TBEventWriter

            self.tb = TBEventWriter(os.path.join(logdir, "tb"))

    def log(self, step: int, metrics: Dict, prefix: str = "", echo: bool = False):
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError, RuntimeError):
                continue  # not a scalar
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.tb is not None:
            self.tb.add_scalars({k: v for k, v in row.items() if k != "step"}, step)
            self.tb.flush()
        if echo:
            shown = {k: round(v, 5) for k, v in row.items() if k != "step"}
            print(f"step {step}: {shown}", flush=True)


class ImageLogger:
    """Every `batch_frequency` steps, the grids of the port's
    `inference.log_images` as PNGs under logdir/images/<split> (and into a
    TensorBoard writer when given), and the batch's conditions, mapped back
    through the persisted scalers, as a CSV beside them."""

    def __init__(self, logdir: str, batch_frequency: int = 1000, max_images: int = 8,
                 scaler_dir: Optional[str] = None, log_steps: int = 20, eta: float = 1.0,
                 tb_writer=None):
        self.logdir = logdir
        self.batch_frequency = max(1, batch_frequency)
        self.max_images = max_images
        self.scaler_dir = scaler_dir
        self.log_steps = log_steps
        self.eta = eta
        self.tb = tb_writer
        self._scalers = {}

    def check_frequency(self, step: int) -> bool:
        return step % self.batch_frequency == 0

    def _scaler(self, name: str, phase: str):
        key = (name, phase)
        if key not in self._scalers and self.scaler_dir:
            from ..data.scalers import load_scaler

            path = os.path.join(self.scaler_dir, f"{name}_scaler_{phase}.json")
            self._scalers[key] = load_scaler(path) if os.path.exists(path) else None
        return self._scalers.get(key)

    def log_img(self, model, batch, step: int, generator=None, split: str = "train",
                sample: bool = True, device=None):
        """The grids of `log_images(model, batch, generator)` (the model on
        `device`, "cuda" unless given), written as PNGs; returns the logs."""
        from ..inference import log_images

        logs = log_images(model, batch, generator, n=self.max_images, steps=self.log_steps,
                          eta=self.eta, sample=sample, device=device)
        root = os.path.join(self.logdir, "images", split)
        for key, imgs in logs.items():
            if key.endswith("_latent") or key == "mask" or imgs.dim() != 4:
                continue
            grid = to_uint8_grid(imgs)
            save_png(os.path.join(root, f"{key}_gs-{step:06d}.png"), grid)
            if self.tb is not None:
                self.tb.add_image(f"{split}/{key}", grid, step)
        self._write_condition_csv(batch, step, split, root)
        return logs

    def _write_condition_csv(self, batch, step: int, split: str, root: str):
        mixed = batch.get("mixed")
        if not isinstance(mixed, dict):
            return
        os.makedirs(root, exist_ok=True)

        def rows(v, n):
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            return v[:n].reshape(n, -1)

        n = min(self.max_images, batch["img"].shape[0])
        phase = "trainval" if split == "train" else "test"
        cols = {}
        for name in ("flow", "weather", "time"):
            cols[name] = rows(mixed[name], n)
            sc = self._scaler(name, phase)
            if sc is not None:
                cols[name] = sc.inverse_transform(cols[name])
        flow, weather, t = cols["flow"], cols["weather"], cols["time"]
        with open(os.path.join(root, f"conditions_gs-{step:06d}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["idx", "time"] + [f"flow_{i}" for i in range(flow.shape[1])]
                       + [f"weather_{i}" for i in range(weather.shape[1])])
            for i in range(n):
                w.writerow([i, *t[i].tolist(), *flow[i].tolist(), *weather[i].tolist()])


class DeviceStatsCallback:
    """An epoch's wall time and the peak and current memory allocated on
    `device` (the model's; none on the CPU), as the reference's
    CUDACallback."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._t0 = None

    def on_epoch_start(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0 = time.perf_counter()

    def on_epoch_end(self) -> Dict[str, float]:
        stats = {}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            stats["peak_bytes_in_use"] = float(torch.cuda.max_memory_allocated(self.device))
            stats["bytes_in_use"] = float(torch.cuda.memory_allocated(self.device))
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        stats["epoch_time_s"] = dt
        print(f"Epoch time {dt:.2f}s, peak device memory "
              f"{stats.get('peak_bytes_in_use', 0) / 2**20:.0f} MiB", flush=True)
        return stats
