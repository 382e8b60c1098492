"""Sharding rules and placement (counterpart of `ealdm_tpu/parallel/sharding.py`):
parameters over the `model` group, batches over `data`.

JAX's rule (`_shape_based_spec`): a leaf of rank >= 2 is cut on its last
axis, the output features of a flax kernel, when that axis divides by the
model group's size T and holds at least 2T entries; biases, norm scales and
1-D leaves stay whole. The port's layouts (`utils/flax_import.py`) put that
axis elsewhere:

  Dense weight [out, in], Conv2D weight [out, in, kh, kw]   -> dim 0
  torch.nn.LSTM weight_ih / weight_hh [4H, .]               -> dim 0, as four
      gate blocks of H each cut alike (flax's four gate kernels [., H])
  any other leaf (nn.Embed's [num, dim], VectorQuantizer's codebook,
  EqualizedDense's [out, in], c_to_scales_weight, CLIP's raw weights)
                                                            -> its last dim

so the port cuts exactly the leaves JAX cuts. The rule covers the
parameters, the Adam moments and the EMA shadows alike. A cut parameter
carries its placement as `tp_shard`; `Dense`, `Conv2D` and `Embed` compute
their slice of the output features from a trainable one and gather the
whole output (`models/layers.py`), and every other use (a frozen layer's
weight, any other module's parameter) takes `whole(p)`, the parameter
gathered at use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .comm import all_gather, broadcast_, gather_from_model, join_blocks, own_slice
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardRule:
    axis: int
    blocks: int = 1  # the axis holds `blocks` blocks, each cut alike


@dataclasses.dataclass(frozen=True)
class Shard:
    """The placement of a cut parameter (its `tp_shard`)."""

    axis: int
    blocks: int
    size: int     # T, the model group's size
    index: int    # this rank's slice
    group: Any


def _tp(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh.shape["model"]


def leaf_rule(module: torch.nn.Module, name: str, shape, tp: int) -> Optional[ShardRule]:
    """JAX's shape rule for parameter `name` of `module` (of `shape`) under a
    model group of `tp`, in the port's layout; None: it stays whole."""
    from ..models.layers import Conv2D, Dense

    if len(shape) < 2 or tp == 1:
        return None
    if isinstance(module, torch.nn.LSTM) and name.startswith("weight_"):
        rule = ShardRule(0, 4)
    elif isinstance(module, (Dense, Conv2D, torch.nn.Linear, torch.nn.Conv2d)) \
            and name == "weight":
        rule = ShardRule(0)
    else:
        rule = ShardRule(len(shape) - 1)
    n = shape[rule.axis] // rule.blocks
    return rule if n % tp == 0 and n >= 2 * tp else None


def param_sharding_rules(model: torch.nn.Module, mesh) -> Dict[str, Optional[ShardRule]]:
    """{parameter name: its rule or None} under `mesh` (or a model-group size)."""
    tp = _tp(mesh)
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        out[name] = leaf_rule(model.get_submodule(owner), leaf, tuple(p.shape), tp)
    return out


def state_sharding_rules(state, mesh, model: torch.nn.Module) -> Dict[str, Any]:
    """The rules of a TrainState's tensors by part: "params", "mu", "nu"
    ("acc_grads" under accumulation) and "ema" (the shadow), each {name:
    rule or None}. The moments and the shadow follow their parameter."""
    rules = param_sharding_rules(model, mesh)
    opt = state.opt_state
    out = {"params": rules, "mu": {k: rules[k] for k in opt.mu},
           "nu": {k: rules[k] for k in opt.nu}}
    if opt.acc_grads is not None:
        out["acc_grads"] = {k: rules[k] for k in opt.acc_grads}
    if state.ema is not None:
        out["ema"] = {k: rules[k] for k in state.ema.shadow}
    return out


def shard_shape(shape, rule: Optional[ShardRule], tp: int) -> tuple:
    shape = tuple(shape)
    if rule is None:
        return shape
    return shape[:rule.axis] + (shape[rule.axis] // tp,) + shape[rule.axis + 1:]


def _cut(t: torch.Tensor, rule: ShardRule, mesh: Mesh) -> torch.Tensor:
    return own_slice(t, mesh.model_index, mesh.model, rule.axis, rule.blocks).clone()


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Cut `model`'s parameters to this rank's slices in place (the same
    Parameter objects, their data replaced) and tag each with `tp_shard`."""
    if mesh.model == 1:
        return model
    for name, rule in param_sharding_rules(model, mesh).items():
        p = model.get_parameter(name)
        if rule is None or getattr(p, "tp_shard", None) is not None:
            continue
        p.data = _cut(p.data, rule, mesh)
        p.tp_shard = Shard(rule.axis, rule.blocks, mesh.model, mesh.model_index,
                           mesh.model_group)
    return model


@torch.no_grad()
def shard_state(state, mesh: Mesh, model: torch.nn.Module):
    """Cut a whole TrainState of `model` to this rank's slices in place: the
    parameters (the model's own), the Adam moments, the accumulated
    gradients and the EMA shadow alike. Returns the state."""
    if mesh.model == 1:
        return state
    rules = param_sharding_rules(model, mesh)
    shard_params(model, mesh)
    parts = [state.opt_state.mu, state.opt_state.nu]
    if state.opt_state.acc_grads is not None:
        parts.append(state.opt_state.acc_grads)
    if state.ema is not None:
        parts.append(state.ema.shadow)
    for part in parts:
        for k, t in part.items():
            if rules[k] is not None:
                part[k] = _cut(t, rules[k], mesh)
    return state


@torch.no_grad()
def unshard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Undo `shard_params`: every cut parameter gathered whole in place and
    untagged. Collective over the model group."""
    if mesh.model == 1:
        return model
    for p in model.parameters():
        s = getattr(p, "tp_shard", None)
        if s is not None:
            p.data = _whole_tensor(p.data, s)
            del p.tp_shard
    return model


def whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a module uses it: gathered over its model group (the
    gradient's own slice back) when it is cut, else itself."""
    s = getattr(p, "tp_shard", None)
    return p if s is None else gather_from_model(p, s.group, s.axis, s.blocks)


def _whole_tensor(t: torch.Tensor, s: Optional[Shard]) -> torch.Tensor:
    if s is None:
        return t
    return join_blocks(all_gather(t, s.group, s.axis), s.size, s.axis, s.blocks)


@torch.no_grad()
def gather_state(state, mesh: Mesh) -> Dict[str, Any]:
    """`state.state_dict()` with every cut tensor gathered whole: the state
    as one process holds it, for a checkpoint. Collective over the model
    group: every rank of it calls it."""
    sd = state.state_dict()
    if mesh.model == 1:
        return sd
    shards = {k: getattr(p, "tp_shard", None) for k, p in state.params.items()}

    def gathered(part):
        return {k: _whole_tensor(t, shards[k]) for k, t in part.items()}

    sd["params"] = gathered(sd["params"])
    opt = dict(sd["opt_state"])
    for key in ("mu", "nu", "acc_grads"):
        if opt.get(key) is not None:
            opt[key] = gathered(opt[key])
    sd["opt_state"] = opt
    if sd["ema"] is not None:
        sd["ema"] = dict(sd["ema"], shadow=gathered(sd["ema"]["shadow"]))
    return sd


def state_bytes(state) -> int:
    """Bytes of a TrainState's tensors on this rank (parameters, moments,
    accumulated gradients, EMA shadow)."""
    opt = state.opt_state
    parts = [state.params, opt.mu, opt.nu, opt.acc_grads or {},
             state.ema.shadow if state.ema is not None else {}]
    return sum(t.numel() * t.element_size() for part in parts for t in part.values())


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows [d * B / D, (d + 1) * B / D) of every leaf of a
    global batch (d its data index of D); leaves that are not arrays stay."""
    if mesh.data == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if not isinstance(batch, (torch.Tensor, np.ndarray)) or batch.ndim == 0:
        return batch
    b, rem = divmod(batch.shape[0], mesh.data)
    if rem:
        raise ValueError(f"batch {batch.shape[0]} does not split over {mesh.data} data ranks")
    return batch[mesh.data_index * b:(mesh.data_index + 1) * b]


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's tensors of `tree` on every rank, in place."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return broadcast_(tree, 0)
    return tree
