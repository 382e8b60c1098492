"""Training layer: the LDM train step, AdamW, EMA, LR schedules and
checkpointing (counterpart of `ealdm_tpu/training`; its VAE trainer, losses,
callbacks, stats and TensorBoard writer are not ported yet)."""

from .checkpoint import CheckpointManager
from .ema import EmaState, ema_init, ema_update
from .lr_scheduler import (
    build_scheduler,
    warmup_cosine,
    warmup_cosine_cyclic,
    warmup_linear_cyclic,
)
from .trainer import (
    AdamW,
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "AdamW",
    "CheckpointManager",
    "EmaState",
    "ema_init",
    "ema_update",
    "build_scheduler",
    "warmup_cosine",
    "warmup_cosine_cyclic",
    "warmup_linear_cyclic",
    "TrainState",
    "init_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
