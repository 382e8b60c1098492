"""What the command-line tools share: the device flag, the compute dtype,
the inference settings, reading a run back (`load_run`) and its checkpoints
(the port's `CheckpointManager` layout and the JAX package's orbax one),
reading a PNG, and the uint8 conversion."""
from __future__ import annotations

import contextlib
import glob
import os
from typing import Optional

import numpy as np
import torch

# The models' dtype: the JAX scripts build theirs at LatentDiffusion's
# float32 default and take no dtype flag.
DTYPE = torch.float32


def add_device_args(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: cuda (the default; raises without a card) or cpu")
    return p


def resolve(opt) -> torch.device:
    from ..utils.device import resolve_device

    return resolve_device(opt.device)


@contextlib.contextmanager
def inference_settings():
    """`ealdm_torch.enable_inference_optimizations` (flash attention at the
    eligible self-attention sites, compute-dtype LayerNorm statistics) for
    the block, the process's own settings restored after it."""
    import ealdm_torch
    from ..ops import attention, norms

    saved = attention.attention_impl(), norms._NORM_STATS_DTYPE
    ealdm_torch.enable_inference_optimizations()
    try:
        yield
    finally:
        attention.set_attention_impl(saved[0])
        norms.set_norm_stats_precision(saved[1])


def load_run(resume: str):
    """(config, checkpoint dir, logdir) of a run: `resume` is its logdir,
    its checkpoints dir or a file inside that; the config is the last of
    the logdir's configs/*.yaml, read with the port's YAML reader."""
    from ..config import load_config

    if os.path.isfile(resume):
        resume = os.path.dirname(resume)
    logdir = resume.rstrip("/")
    if logdir.endswith("checkpoints"):
        logdir = os.path.dirname(logdir)
    cfgs = sorted(glob.glob(os.path.join(logdir, "configs", "*.yaml")))
    assert cfgs, f"no configs under {logdir}/configs"
    return load_config([cfgs[-1]]), os.path.join(logdir, "checkpoints"), logdir


def read_checkpoint(path: str, last: bool = False) -> dict:
    """The saved train state of `path`: a `state.pt`, a checkpoint dir
    (`.../checkpoints/<step>` or `.../last`) or a checkpoints dir (its
    latest step, else `last`; `last` itself with last=True), of the port or
    of the JAX package (also an orbax item, `.../last/state` or
    `.../<step>/default`, as JAX's knn2img.py takes), read lazily on the
    host: a tool reads only the tensors it copies to the device (the EMA
    shadow, not the optimizer's moments)."""
    from ..training import orbax_format
    from ..training.checkpoint import CheckpointManager, read_jax_state

    norm = os.path.normpath(path)
    if os.path.isfile(norm):
        return torch.load(norm, map_location="cpu", weights_only=True, mmap=True)
    if os.path.exists(os.path.join(norm, "state.pt")):
        return torch.load(os.path.join(norm, "state.pt"), map_location="cpu",
                          weights_only=True, mmap=True)
    if orbax_format.is_item(norm):
        return read_jax_state(norm)
    for item in ("state", "default"):  # JAX's last/ or <step>/
        if orbax_format.is_item(os.path.join(norm, item)):
            return read_jax_state(os.path.join(norm, item))
    mgr = CheckpointManager(norm, monitor=None)
    return mgr.read(last=last, map_location="cpu", mmap=True)


@torch.no_grad()
def load_sampling_weights(model: torch.nn.Module, state: dict) -> str:
    """Copy the checkpoint's EMA shadow (where it has one), else its
    parameters, into `model`, in place. Returns which."""
    which = "ema" if state.get("ema") is not None else "params"
    src = state["ema"]["shadow"] if which == "ema" else state["params"]
    params = dict(model.named_parameters())
    if set(src) != set(params):
        raise ValueError(f"the checkpoint's tensors do not match the model: "
                         f"{sorted(set(src) ^ set(params))[:8]}")
    for k, p in params.items():
        p.copy_(src[k])
    return which


def read_png(path: str) -> np.ndarray:
    """A PNG's decoded pixels (`utils.png`); any other format raises naming
    the JPEG item (`data.images.read_image`)."""
    from ..data.images import read_image
    from ..utils.png import load_png

    if not path.lower().endswith(".png"):
        read_image(path)  # raises
    return load_png(path)


def to_uint8(imgs) -> np.ndarray:
    """[-1, 1] images (tensor or array) -> uint8, as the JAX scripts round."""
    if isinstance(imgs, torch.Tensor):
        imgs = imgs.detach().float().cpu().numpy()
    return ((np.clip(imgs, -1, 1) + 1) * 127.5).astype(np.uint8)


def sampling_model(config_model: dict, device, checkpoint: Optional[dict] = None):
    """The config's model in `DTYPE` on `device` in eval mode, with the
    checkpoint's sampling weights (EMA first) when one is given."""
    from ..config import model_from_config

    model, _ = model_from_config(config_model, dtype=DTYPE, device=device)
    model.eval()
    if checkpoint is not None:
        load_sampling_weights(model, checkpoint)
    return model
