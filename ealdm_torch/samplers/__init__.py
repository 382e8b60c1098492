"""Samplers (DDIM, ancestral, PLMS)."""

from .ddim import DDIMConfig, ancestral_sample, ddim_sample, ddim_step
from .plms import plms_sample

__all__ = ["DDIMConfig", "ancestral_sample", "ddim_sample", "ddim_step", "plms_sample"]
