"""Parameter bridge: the JAX package's flax parameter tree -> this port's
`state_dict`, and a JAX train state's EMA shadow -> the port's.

The tree arrives as nested dicts of numpy arrays (`jax.device_get(variables)`,
with or without the top-level "params"). The port's submodules carry the
flax module names, so a flax path `a/b/c/<leaf>` becomes the port name
`a.b.c.<name>`:

  Conv kernel [kh, kw, in, out] (HWIO)   -> weight [out, in, kh, kw] (OIHW)
  Dense kernel [in, out]                 -> weight [out, in]
  norm scale                             -> weight
  bias, embedding, c_to_scales_weight,
  a learned top-level logvar, the text
  transformer's ScaleNorm / RMSNorm /
  ReZero gain g                          -> the same name, unchanged
  EqualizedDense weight (already [out, in]),
  FrozenBatchNorm mean and var           -> the same name, unchanged
  CLIP's attention in_proj_weight,
  in_proj_bias, out_proj_weight,
  out_proj_bias (already torch's layout),
  positional_embedding, class_embedding,
  text_projection and proj ([width,
  embed], used as x @ P)                 -> the same name, unchanged
  OptimizedLSTMCell lstm_<l>/{i,h}{i,f,g,o}
      -> torch.nn.LSTM lstm_<l>.{weight_ih,weight_hh,bias_hh}_l0, gates
         stacked in torch's i, f, g, o order. flax has one bias per gate, on
         the h projection; torch adds bias_ih and bias_hh, so bias_ih_l0 is 0.

The rules are by leaf, not by model, so one bridge carries every model the
port builds: the STDiff LDM, the AttentionBlock UNets (`qkv` and `proj_out`
are Dense), VQ-f4/f8, `AutoencoderKL`, whose `quant_conv` maps
2 * z_channels to 2 * embed_dim and `post_quant_conv` embed_dim back, and
the text- and class-conditional models (nn.Embed tables, the text
transformer's LayerNorms and Dense layers, a class UNet's `label_emb`), and
the zoo's (`zoo.py`): a scale-shift ResBlock's `emb_proj` of 2 * out_ch,
the ResBlock resample sites `down_<l>_downres` / `up_<l>_upres` (their
nearest and average-pool resamples have no parameters, in either package),
the bias-free `channel_mapper` kernel of `SpatialRescaler`, and a VQ model
whose `attn_type` "none" has no attention leaves; and the CLIP towers of
the CLIP cond stages (`models/clip.py`: the bias-free patchify `conv1`
kernel, the MLP's Dense layers, the LayerNorms and the token embedding take
the rules above).

`load_flax_params` raises on any port parameter left unfilled, any flax
leaf left unused, and any shape that disagrees; so does `load_flax_ema`,
which fills an `EmaState` from the shadow tree of a JAX `EmaState` (the
same structure as the parameters), so that a JAX train state resumes here.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .device import check_module_device

_GATES = "ifgo"  # torch.nn.LSTM's stacking order
# CLIP's raw parameters (`models/clip.py`), each in the layout the port uses
_CLIP_LEAVES = ("in_proj_weight", "in_proj_bias", "out_proj_weight", "out_proj_bias",
                "positional_embedding", "class_embedding", "text_projection", "proj")
_LSTM = re.compile(r"^(.*lstm_\d+)\.([ih])([ifgo])\.(kernel|bias)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _leaf(name: str, v: np.ndarray):
    """(port name, array) of one non-LSTM flax leaf."""
    head, _, last = name.rpartition(".")
    weight = f"{head}.weight" if head else "weight"
    if last == "kernel":
        if v.ndim == 4:
            return weight, np.transpose(v, (3, 2, 0, 1))
        if v.ndim == 2:
            return weight, np.transpose(v, (1, 0))
        raise ValueError(f"{name}: no rule for a {v.ndim}-d kernel")
    if last == "scale":
        return weight, v
    if last in ("bias", "embedding", "c_to_scales_weight", "weight", "mean", "var",
                "logvar", "g", *_CLIP_LEAVES):
        return name, v
    raise ValueError(f"{name}: no rule for flax leaf {last!r}")


def flax_to_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """Port parameter name -> numpy array, for every parameter the tree sets."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}
    lstm: Dict[str, Dict[tuple, np.ndarray]] = {}
    for name, v in _flatten(tree).items():
        m = _LSTM.match(name)
        if m:
            prefix, side, gate, kind = m.groups()
            lstm.setdefault(prefix, {})[(side, gate, kind)] = v
            continue
        key, arr = _leaf(name, v)
        if key in out:
            raise ValueError(f"two flax leaves map onto {key}")
        out[key] = arr
    for prefix, g in lstm.items():
        need = {(s, gate, "kernel") for s in "ih" for gate in _GATES} | {
            ("h", gate, "bias") for gate in _GATES}
        if set(g) != need:
            raise ValueError(f"{prefix}: LSTM leaves {sorted(g)} are not one flax "
                             "OptimizedLSTMCell")
        w_ih = np.concatenate([np.transpose(g[("i", k, "kernel")]) for k in _GATES])
        out[f"{prefix}.weight_ih_l0"] = w_ih
        out[f"{prefix}.weight_hh_l0"] = np.concatenate(
            [np.transpose(g[("h", k, "kernel")]) for k in _GATES])
        out[f"{prefix}.bias_hh_l0"] = np.concatenate([g[("h", k, "bias")] for k in _GATES])
        out[f"{prefix}.bias_ih_l0"] = np.zeros(w_ih.shape[0], np.asarray(w_ih).dtype)
    return out


def check_state_dict(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """Raise unless `sd` names exactly the module's parameters, shape for shape."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(sd))
    unused = sorted(set(sd) - set(params))
    bad = sorted(k for k in set(params) & set(sd)
                 if tuple(params[k].shape) != tuple(np.shape(sd[k])))
    if missing or unused or bad:
        raise ValueError(
            f"flax tree does not match the port: missing {missing[:8]} "
            f"({len(missing)}), unused {unused[:8]} ({len(unused)}), shape "
            + ", ".join(f"{k} {tuple(params[k].shape)} vs {np.shape(sd[k])}"
                        for k in bad[:8]))


@torch.no_grad()
def load_flax_params(module: torch.nn.Module, tree: Mapping, device=None) -> None:
    """Copy the flax parameter tree into `module`'s parameters, in place.
    device: where the module must live, "cuda" unless given."""
    check_module_device(module, device)
    sd = flax_to_state_dict(tree)
    check_state_dict(module, sd)
    for name, p in module.named_parameters():
        p.copy_(torch.from_numpy(np.ascontiguousarray(sd[name], dtype=np.float32)))


@torch.no_grad()
def load_flax_ema(ema_state, module: torch.nn.Module, shadow_tree: Mapping) -> None:
    """Copy a JAX EmaState's shadow tree into `ema_state.shadow` (an
    `ealdm_torch.training.EmaState` of `module`'s parameters), in place."""
    sd = flax_to_state_dict(shadow_tree)
    check_state_dict(module, sd)
    if set(ema_state.shadow) != set(sd):
        raise ValueError("the EMA shadow does not cover the module's parameters")
    for name, s in ema_state.shadow.items():
        s.copy_(torch.from_numpy(np.ascontiguousarray(sd[name], dtype=np.float32)))
