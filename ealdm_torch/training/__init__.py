"""Training layer (counterpart of `ealdm_tpu/training`): the LDM train
step, AdamW, EMA, LR schedules, checkpointing, the first stages' two-
optimizer VAE-GAN step (`vae_trainer`, with the losses of
`ealdm_torch.losses`), the callbacks, the cross-process statistics and the
TensorBoard writer. `ealdm_torch.main` runs the loops around them."""

from .checkpoint import CheckpointManager
from .ema import EmaState, ema_init, ema_update
from .lr_scheduler import (
    build_scheduler,
    warmup_cosine,
    warmup_cosine_cyclic,
    warmup_linear_cyclic,
)
from .callbacks import (
    DeviceStatsCallback,
    ImageLogger,
    MetricLogger,
    SetupCallback,
    save_png,
    to_uint8_grid,
)
from .stats import Collector, report, report0
from .tensorboard import TBEventWriter
from .trainer import (
    AdamW,
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from .vae_trainer import (
    VAETrainState,
    build_autoencoder,
    init_vae_train_state,
    make_vae_eval_step,
    make_vae_train_step,
    random_init_autoencoder_,
)

__all__ = [
    "AdamW",
    "CheckpointManager",
    "Collector",
    "DeviceStatsCallback",
    "ImageLogger",
    "MetricLogger",
    "SetupCallback",
    "TBEventWriter",
    "VAETrainState",
    "build_autoencoder",
    "init_vae_train_state",
    "make_vae_eval_step",
    "make_vae_train_step",
    "random_init_autoencoder_",
    "report",
    "report0",
    "save_png",
    "to_uint8_grid",
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
