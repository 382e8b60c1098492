"""The port's op layer (counterpart of `ealdm_tpu.ops`): schedules,
embeddings, norms, attention, bias_act and the FIR resampling ops. The
wrappers of the CUDA kernels run their plain versions on CPU tensors."""

from .schedules import (
    DDIMSchedule,
    DiffusionSchedule,
    extract,
    make_beta_schedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)
from .embeddings import timestep_embedding
from .bias_act import activation_funcs, bias_act, bias_act_plain
from .upfirdn2d import (
    downsample2d,
    filter2d,
    setup_filter,
    upfirdn2d,
    upsample2d,
)
from .filtered_lrelu import filtered_lrelu
from .resample import conv2d_resample, grid_sample
from .norms import group_norm, instance_norm_2d, layer_norm, silu
from .attention import flash_attention, sdpa

__all__ = [
    "DDIMSchedule",
    "DiffusionSchedule",
    "extract",
    "make_beta_schedule",
    "make_ddim_sampling_parameters",
    "make_ddim_timesteps",
    "timestep_embedding",
    "bias_act",
    "bias_act_plain",
    "activation_funcs",
    "upfirdn2d",
    "filter2d",
    "upsample2d",
    "downsample2d",
    "setup_filter",
    "filtered_lrelu",
    "conv2d_resample",
    "grid_sample",
    "group_norm",
    "instance_norm_2d",
    "layer_norm",
    "silu",
    "sdpa",
    "flash_attention",
]
