"""Rematerialisation policies of the backward (counterpart of the policies
`ealdm_tpu/training/trainer.py` hands `jax.checkpoint`).

  "dots"  saves the outputs of the matrix products and convolutions
          (`jax.checkpoint_policies.dots_saveable` saves dot_general and
          conv_general_dilated) and recomputes the rest, the GroupNorm and
          flash kernels' forwards included: a custom autograd Function is no
          ATen op the policy could save;
  "full"  saves nothing (`nothing_saveable`);
  "none"  saves everything.

PyTorch's non-reentrant checkpoint reruns a whole region when the backward
first needs one of its tensors, so a region's intermediates are all live
again at once. The UNet therefore takes one region per block
(`UNetModel.remat_blocks`), not one around the loss.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

REMAT_POLICIES = ("none", "dots", "full")
# the ATen products `jax.checkpoint_policies.dots_saveable` keeps
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
            torch.ops.aten.convolution.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    return policy


def apply_remat(fn: Callable, policy: str) -> Callable:
    """`fn` as one region under the named policy. Under "dots" and "full"
    the backward reruns `fn`, so what it draws at random must come from a
    source the rerun re-creates (the RNG state is restored; an explicit
    generator is not)."""
    if check_policy(policy) == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)
    return lambda *args, **kwargs: checkpoint(fn, *args, use_reentrant=False, **kw,
                                              **kwargs)
