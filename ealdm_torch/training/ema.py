"""EMA of the model parameters (counterpart of `ealdm_tpu/training/ema.py`).

The reference's LitEma: a shadow of every parameter with the warm-up decay
min(decay, (1 + n) / (10 + n)), or the fixed decay when the update count is
-1. The shadow covers the same set as JAX's (the whole parameter tree, the
frozen first stage included) and is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    decay: float
    num_updates: int  # -1 disables the warm-up
    shadow: Dict[str, torch.Tensor]  # parameter name -> shadow tensor


def ema_init(params: Dict[str, torch.Tensor], decay: float = 0.9999,
             use_num_updates: bool = True) -> EmaState:
    """params: {name: parameter}; the shadow starts as a copy of each."""
    return EmaState(decay=decay, num_updates=0 if use_num_updates else -1,
                    shadow={k: p.detach().clone() for k, p in params.items()})


@torch.no_grad()
def ema_update(state: EmaState, params: Dict[str, torch.Tensor]) -> EmaState:
    """shadow <- shadow - (1 - decay) * (shadow - param), in place. The decay
    is rounded to float32 as JAX computes it."""
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    decay = np.float32(state.decay)
    if n >= 0:
        decay = min(decay, np.float32(1.0 + n) / np.float32(10.0 + n))
    one_minus = float(np.float32(1.0) - decay)
    with torch.profiler.record_function("ealdm::ema"):
        names = list(state.shadow)
        shadow = [state.shadow[k] for k in names]
        diff = torch._foreach_sub(shadow, [params[k].detach() for k in names])
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(shadow, diff)
    state.num_updates = n
    return state
