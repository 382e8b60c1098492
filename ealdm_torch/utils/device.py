"""The port's device rule: entry points run on the card unless asked not to."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises when it names CUDA
    and no card is present, so nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def check_module_device(module: torch.nn.Module, device=None) -> torch.device:
    """Resolve `device` and require that `module`'s parameters live there."""
    dev = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != dev.type:
        raise RuntimeError(f"model is on {have}, but device={dev} was asked for")
    return have


def rank_device(device=None) -> torch.device:
    """The device of this rank: for "cuda" without an index,
    `cuda:{LOCAL_RANK % cards}` (LOCAL_RANK from the launcher's environment, 0
    without one), made the current card; otherwise `resolve_device(device)`."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
