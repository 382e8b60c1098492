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
  FrozenBatchNorm mean and var,
  InceptionV3's frozen BatchNorm bn_scale,
  bn_bias, bn_mean, bn_var               -> the same name, unchanged
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

The rules run backwards too: `module_plan(module)` gives every flax leaf
of a module's parameters with the rule that makes it (`LeafRule`: the
port parameter, the layout transform, the LSTM gate's rows), and
`state_dict_to_flax` builds the flax tree of a module's state_dict with
it. Which rule a `weight` takes comes from the module that owns it: a
norm's is its scale, an EqualizedDense's stays `weight`, a 4-d one is a
conv kernel and a 2-d one a Dense kernel; an LSTM's bias_ih must be 0.

Train states (`ldm_layout`, `vae_layout`): every leaf of the JAX
package's `TrainState` (`ealdm_tpu/training/trainer.py`) or
`VAETrainState` (`vae_trainer.py`) pytree, by its orbax path (an int key
is a sequence index, a str key a dict key or a field), beside where the
port keeps it (`Slot`):

  LDM ('0', params '1', optax state '2', EmaState '3' or None):
    (0,)                                         step
    (1, *flax)                                   params
    (2, 'inner_states', 'train', 'inner_state', 0, 'count' | 'mu' | 'nu')
                                                 AdamWState count, mu, nu
                                                 (the first stage's leaves
                                                 are masked: None)
    (2, 'inner_states', 'train', 'inner_state', 1)     None (weight decay)
    (2, 'inner_states', 'train', 'inner_state', 2)     None, or {'count'}
                                                 under an LR schedule
    (2, 'inner_states', 'frozen', 'inner_state') None (set_to_zero)
    under optax.MultiSteps the above sit under (2, 'inner_opt_state') beside
    (2, 'mini_step'), (2, 'gradient_step') (= count), (2, 'acc_grads', *flax)
    (every parameter: the frozen ones' are 0) and (2, 'skip_state') ()
    (3, 'decay' | 'num_updates' | 'shadow', ...) EmaState
  VAE: (0,) step, (1, ...) ae_params, (2, ...) loss_params, (3, 0, 'count' |
    'mu' | 'nu') and (3, 1) None: opt_ae_state; (4, ...) opt_disc_state over
    the loss's discriminator.

`import_state` copies a JAX tree (an `orbax_format.OrbaxItem`) into a port
state in place, one leaf at a time; `export_state` gives the JAX tree of a
port state_dict, leaf by leaf. A JAX leaf with no counterpart in the port
state, a port tensor the JAX tree lacks, a frozen or masked set that
differs, or counts that disagree raise naming the leaf.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

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


_SAME = ("bias", "embedding", "c_to_scales_weight", "mean", "var", "logvar", "g",
         "bn_scale", "bn_bias", "bn_mean", "bn_var", *_CLIP_LEAVES)


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
    if last in _SAME or last == "weight":
        return name, v
    raise ValueError(f"{name}: no rule for flax leaf {last!r}")


def port_names(flax_name: str) -> List[str]:
    """The port parameters a dotted flax leaf name goes into: its own, or an
    LSTM cell's four (each needs every leaf of the cell)."""
    m = _LSTM.match(flax_name)
    if m:
        return [f"{m.group(1)}.{k}" for k in ("weight_ih_l0", "weight_hh_l0", "bias_hh_l0",
                                               "bias_ih_l0")]
    head, _, last = flax_name.rpartition(".")
    if last in ("kernel", "scale"):
        return [f"{head}.weight" if head else "weight"]
    if last in _SAME or last == "weight":
        return [flax_name]
    raise ValueError(f"{flax_name}: no rule for flax leaf {last!r}")


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
        # reshape: ascontiguousarray makes a 0-d leaf (a loss's logvar) 1-d
        p.copy_(torch.from_numpy(np.ascontiguousarray(sd[name], dtype=np.float32))
                .reshape(p.shape))


@torch.no_grad()
def load_flax_ema(ema_state, module: torch.nn.Module, shadow_tree: Mapping) -> None:
    """Copy a JAX EmaState's shadow tree into `ema_state.shadow` (an
    `ealdm_torch.training.EmaState` of `module`'s parameters), in place."""
    sd = flax_to_state_dict(shadow_tree)
    check_state_dict(module, sd)
    if set(ema_state.shadow) != set(sd):
        raise ValueError("the EMA shadow does not cover the module's parameters")
    for name, s in ema_state.shadow.items():
        s.copy_(torch.from_numpy(np.ascontiguousarray(sd[name], dtype=np.float32))
                .reshape(s.shape))


# ------------------------------------------------------- the rules backwards

class LeafRule(NamedTuple):
    """How one flax leaf comes from a port parameter: `port` (its name),
    `kind` ("copy"; "conv": OIHW -> HWIO; "dense": transposed) and `rows`
    (an LSTM gate's rows of the port tensor, or None)."""
    port: str
    kind: str
    rows: Optional[Tuple[int, int]] = None


def _flax_leaf(pname: str, ndim: int, owner: torch.nn.Module) -> Tuple[str, str]:
    if pname == "weight":
        cls = type(owner).__name__
        if "Norm" in cls:
            return "scale", "copy"
        if cls == "EqualizedDense":
            return "weight", "copy"
        if ndim == 4:
            return "kernel", "conv"
        if ndim == 2:
            return "kernel", "dense"
        raise ValueError(f"{cls}.weight: no flax rule for a {ndim}-d weight")
    if pname in _SAME:
        return pname, "copy"
    raise ValueError(f"{type(owner).__name__}.{pname}: no flax rule")


def module_plan(module: torch.nn.Module) -> Dict[str, LeafRule]:
    """Dotted flax leaf name -> the rule that makes it, for every parameter
    of `module` (an LSTM's bias_ih has none: it is 0)."""
    plan: Dict[str, LeafRule] = {}
    for mname, owner in module.named_modules():
        for pname, p in owner.named_parameters(recurse=False):
            port = f"{mname}.{pname}" if mname else pname
            if isinstance(owner, torch.nn.LSTM):
                if pname == "bias_ih_l0":
                    continue
                side, kind = {"weight_ih_l0": ("i", "kernel"), "weight_hh_l0": ("h", "kernel"),
                              "bias_hh_l0": ("h", "bias")}[pname]
                h = owner.hidden_size
                for g, gate in enumerate(_GATES):
                    plan[f"{mname}.{side}{gate}.{kind}"] = LeafRule(
                        port, "dense" if kind == "kernel" else "copy", (g * h, (g + 1) * h))
                continue
            leaf, kind = _flax_leaf(pname, p.ndim, owner)
            plan[f"{mname}.{leaf}" if mname else leaf] = LeafRule(port, kind)
    return plan


def lstm_zero_biases(module: torch.nn.Module) -> List[str]:
    """The port names of the LSTMs' bias_ih (0, with no flax leaf)."""
    return [f"{m}.bias_ih_l0" for m, owner in module.named_modules()
            if isinstance(owner, torch.nn.LSTM)]


def to_flax(rule: LeafRule, t: torch.Tensor) -> torch.Tensor:
    """The flax leaf (a view) of port tensor `t` under `rule`."""
    if rule.rows is not None:
        t = t[rule.rows[0]:rule.rows[1]]
    if rule.kind == "conv":
        return t.permute(2, 3, 1, 0)
    if rule.kind == "dense":
        return t.t()
    return t


def flax_shape(rule: LeafRule, port_shape) -> Tuple[int, ...]:
    return tuple(to_flax(rule, torch.empty(port_shape, device="meta")).shape)


@torch.no_grad()
def from_flax_(rule: LeafRule, dst: torch.Tensor, leaf: torch.Tensor) -> None:
    """Copy flax leaf `leaf` into its place in port tensor `dst`, in place."""
    view = to_flax(rule, dst)
    if tuple(view.shape) != tuple(leaf.shape):
        raise ValueError(f"{rule.port}: flax leaf {tuple(leaf.shape)} for "
                         f"{tuple(view.shape)}")
    view.copy_(leaf)


def _nest(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _check_lstm_bias(module: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    for name in lstm_zero_biases(module):
        if name in sd and bool(torch.as_tensor(sd[name]).ne(0).any()):
            raise ValueError(f"{name} is not 0: flax's LSTM cell has one bias a gate")


def state_dict_to_flax(module: torch.nn.Module, sd: Optional[Mapping[str, Any]] = None
                       ) -> dict:
    """The nested flax tree (numpy arrays) of `sd` (the module's own
    parameters if None; a subset, such as an optimizer's moments, gives the
    leaves it covers): the inverse of `flax_to_state_dict`."""
    if sd is None:
        sd = {k: p.detach() for k, p in module.named_parameters()}
    _check_lstm_bias(module, sd)
    flat = {}
    for name, rule in module_plan(module).items():
        if rule.port in sd:
            t = torch.as_tensor(sd[rule.port])
            flat[name] = np.ascontiguousarray(to_flax(rule, t.detach().cpu()).numpy())
    return _nest(flat)


# ------------------------------------------------------------ train states

Path = Tuple[Any, ...]


class Slot(NamedTuple):
    """Where the port keeps one leaf of a JAX train state.

    kind "tensor": `store[rule.port]` under `rule` (float32); "zeros": a
    JAX leaf of `shape` that is 0 and the port does not keep (a frozen
    parameter's MultiSteps accumulator); "int" / "float": `store[key]` of
    the state_dict section `store` (JAX: a 0-d int32 array / a scalar);
    "none" / "tuple": an empty JAX node (None, () )."""
    kind: str
    store: Any = None
    key: Any = None
    rule: Optional[LeafRule] = None
    shape: Tuple[int, ...] = ()


def _tensors(out: Dict[Path, Slot], prefix: Path, plan: Mapping[str, LeafRule],
             store: Mapping[str, torch.Tensor], absent: Optional[str] = None,
             shapes: Optional[Mapping[str, torch.Size]] = None) -> None:
    """One slot a flax leaf of `plan` under `prefix`: its tensor in `store`,
    or where `store` lacks it `absent`: "none" (a masked moment), "zeros"
    (a frozen parameter's accumulator, of its shape in `shapes`) or None
    (raise)."""
    for name, rule in plan.items():
        path = prefix + tuple(name.split("."))
        if rule.port in store:
            out[path] = Slot("tensor", store, rule.port, rule,
                             flax_shape(rule, store[rule.port].shape))
        elif absent == "zeros":
            out[path] = Slot("zeros", rule=rule, shape=flax_shape(rule, shapes[rule.port]))
        elif absent == "none":
            out[path] = Slot("none")
        else:
            raise ValueError(f"the port's state has no tensor {rule.port} for JAX leaf "
                             f"{path_name(path)}")


def _untracked(plan: Mapping[str, LeafRule], store: Mapping[str, Any], what: str,
               zero: List[str]) -> None:
    """Raise if `store` holds a tensor no flax leaf of `plan` maps."""
    known = {r.port for r in plan.values()} | set(zero)
    extra = sorted(set(store) - known)
    if extra:
        raise ValueError(f"{what}: port tensors with no JAX leaf: {extra[:8]} ({len(extra)})")


def _adam(out: Dict[Path, Slot], prefix: Path, plan, opt: Mapping[str, Any], zero,
          masked: bool) -> None:
    """optax.adam(w) state under `prefix`: the chain's ScaleByAdamState."""
    _untracked(plan, opt["mu"], "the optimizer's moments", zero)
    out[prefix + (0, "count")] = Slot("int", opt, "count")
    for m in ("mu", "nu"):
        _tensors(out, prefix + (0, m), plan, opt[m], "none" if masked else None)


def ldm_layout(sd: Mapping[str, Any], model: torch.nn.Module, scheduled: bool = False,
               frozen_prefixes=("first_stage_model",)) -> Dict[Path, Slot]:
    """Every leaf of the JAX `TrainState` of an LDM state_dict `sd`
    (`TrainState.state_dict()`) of `model`; `scheduled`: the optimizer has
    an LR schedule (optax keeps its count); the JAX trainer masks the
    parameters under `frozen_prefixes`."""
    plan, zero = module_plan(model), lstm_zero_biases(model)
    out: Dict[Path, Slot] = {(0,): Slot("int", sd, "step")}
    _untracked(plan, sd["params"], "params", zero)
    _tensors(out, (1,), plan, sd["params"])
    opt = sd["opt_state"]
    multi = opt.get("acc_grads") is not None
    p = (2, "inner_opt_state") if multi else (2,)
    for name, rule in plan.items():
        frozen = name.split(".")[0] in frozen_prefixes
        if frozen == (rule.port in opt["mu"]):
            raise ValueError(
                f"{rule.port}: the JAX trainer {'masks' if frozen else 'trains'} the "
                f"parameter behind flax leaf {name}, the port's optimizer "
                f"{'trains' if frozen else 'does not'}")
    train = p + ("inner_states", "train", "inner_state")
    _adam(out, train, plan, opt, zero, masked=True)
    out[train + (1,)] = Slot("none")
    if scheduled:
        out[train + (2, "count")] = Slot("int", opt, "count")
    else:
        out[train + (2,)] = Slot("none")
    out[p + ("inner_states", "frozen", "inner_state")] = Slot("none")
    if multi:
        out[(2, "mini_step")] = Slot("int", opt, "mini_step")
        out[(2, "gradient_step")] = Slot("int", opt, "count")
        _tensors(out, (2, "acc_grads"), plan, opt["acc_grads"], "zeros",
                 {k: v.shape for k, v in sd["params"].items()})
        out[(2, "skip_state")] = Slot("tuple")
    ema = sd.get("ema")
    if ema is None:
        out[(3,)] = Slot("none")
    else:
        out[(3, "decay")] = Slot("float", ema, "decay")
        out[(3, "num_updates")] = Slot("int", ema, "num_updates")
        _untracked(plan, ema["shadow"], "the EMA shadow", zero)
        _tensors(out, (3, "shadow"), plan, ema["shadow"])
    return out


def vae_layout(sd: Mapping[str, Any], model: Tuple[torch.nn.Module, torch.nn.Module]
               ) -> Dict[Path, Slot]:
    """Every leaf of the JAX `VAETrainState` of a first stage's state_dict
    (`VAETrainState.state_dict()`) of `model`, the pair (autoencoder, loss
    module)."""
    ae_plan, loss_plan = module_plan(model[0]), module_plan(model[1])
    out: Dict[Path, Slot] = {(0,): Slot("int", sd, "step")}
    _untracked(ae_plan, sd["ae_params"], "ae_params", [])
    _untracked(loss_plan, sd["loss_params"], "loss_params", [])
    _tensors(out, (1,), ae_plan, sd["ae_params"])
    _tensors(out, (2,), loss_plan, sd["loss_params"])
    _adam(out, (3,), ae_plan, sd["opt_ae_state"], [], masked=False)
    out[(3, 1)] = Slot("none")
    disc = {n[len("discriminator."):]: r for n, r in loss_plan.items()
            if n.startswith("discriminator.")}
    _adam(out, (4,), disc, sd["opt_disc_state"], [], masked=False)
    out[(4, 1)] = Slot("none")
    return out


def state_layout(sd: Mapping[str, Any], model, scheduled: bool = False) -> Dict[Path, Slot]:
    """`vae_layout` or `ldm_layout` of a state_dict, by its sections: the
    model an LDM's state trains, or a first stage's (autoencoder, loss
    module) pair."""
    if "ae_params" in sd:
        return vae_layout(sd, model)
    return ldm_layout(sd, model, scheduled)


def path_name(path: Path) -> str:
    """orbax's name of a leaf (its zarr array): the keys joined with '.'."""
    return ".".join(str(k) for k in path)


@torch.no_grad()
def import_state(layout: Dict[Path, Slot], item, zero_tensors=()) -> None:
    """Copy the JAX tree of `item` (an `orbax_format.OrbaxItem`) into the
    port tensors and numbers of `layout`, in place: each leaf is decoded
    into a host buffer and copied into its tensor, so the host holds one
    leaf at a time. zero_tensors: port tensors with no JAX leaf set to 0
    (the LSTMs' bias_ih)."""
    jax_leaves = item.leaves
    have = set(jax_leaves)
    want = set(layout)
    extra, lacking = sorted(have - want, key=str), sorted(want - have, key=str)
    if extra:
        raise ValueError(f"{item.path}: JAX leaves with no counterpart in the port's state: "
                         + ", ".join(path_name(p) for p in extra[:8]) + f" ({len(extra)})")
    if lacking:
        raise ValueError(f"{item.path}: the port's state has leaves the JAX tree lacks: "
                         + ", ".join(path_name(p) for p in lacking[:8]) + f" ({len(lacking)})")
    ints: Dict[Tuple[int, Any], Tuple[Path, int]] = {}
    for path, slot in layout.items():
        vt = jax_leaves[path]
        name = path_name(path)
        if slot.kind in ("none", "tuple"):
            want_vt = "None" if slot.kind == "none" else "Tuple"
            if vt != want_vt:
                raise ValueError(f"{item.path}: leaf {name} is {vt}, the port's state has "
                                 f"{want_vt} there")
            continue
        if vt in ("None", "Tuple", "Dict", "List"):
            raise ValueError(f"{item.path}: leaf {name} is empty ({vt}); the port's state "
                             f"has a {slot.kind} there")
        if slot.kind == "tensor":
            dst = slot.store[slot.key]
            from_flax_(slot.rule, dst, item.read(path, dtype=torch.float32, shape=slot.shape))
        elif slot.kind == "zeros":
            leaf = item.read(path, dtype=torch.float32, shape=slot.shape)
            if bool(leaf.ne(0).any()):
                raise ValueError(f"{item.path}: leaf {name} (the accumulated gradient of "
                                 f"frozen {slot.rule.port}) is not 0; the port keeps none")
        else:
            v = item.scalar(path)
            if slot.kind == "int":
                v = int(v)
                k = (id(slot.store), slot.key)
                if k in ints and ints[k][1] != v:
                    raise ValueError(f"{item.path}: leaf {name} = {v} but "
                                     f"{path_name(ints[k][0])} = {ints[k][1]}: both are the "
                                     f"port's {slot.key}")
                ints[k] = (path, v)
            else:
                v = float(v)
            slot.store[slot.key] = v
    for t in zero_tensors:
        t.zero_()


def export_state(layout: Dict[Path, Slot], zero: Mapping[str, torch.Tensor] = {}
                 ) -> Dict[Path, Any]:
    """The JAX tree of `layout`'s port state as {path: value}: a tensor
    leaf is a callable giving its JAX layout (contiguous, on the state's
    device) when called, with `.shape`; an int a 0-d int32 array, a float
    the Python float (orbax's scalar), None and () themselves. zero: port
    tensors with no JAX leaf (the LSTMs' bias_ih), which must be 0."""
    for name, t in zero.items():
        if bool(t.ne(0).any()):
            raise ValueError(f"{name} is not 0: flax's LSTM cell has one bias a gate")
    out: Dict[Path, Any] = {}
    for path, slot in layout.items():
        if slot.kind == "tensor":
            out[path] = LazyLeaf(slot.shape, torch.float32,
                                 lambda s=slot: to_flax(s.rule, s.store[s.key].detach()))
        elif slot.kind == "zeros":
            out[path] = LazyLeaf(slot.shape, torch.float32,
                                 lambda s=slot: torch.zeros(s.shape))
        elif slot.kind == "int":
            out[path] = np.asarray(slot.store[slot.key], np.int32)
        elif slot.kind == "float":
            out[path] = float(slot.store[slot.key])
        else:
            out[path] = None if slot.kind == "none" else ()
    return out


class LazyLeaf:
    """A tensor leaf made when it is written: `fn()` of `shape` and `dtype`."""

    def __init__(self, shape, dtype, fn: Callable[[], torch.Tensor]):
        self.shape, self.dtype, self.fn = tuple(shape), dtype, fn

    def __call__(self) -> torch.Tensor:
        t = self.fn()
        if tuple(t.shape) != self.shape or t.dtype != self.dtype:
            raise ValueError(f"a leaf of {self.shape} {self.dtype} came out "
                             f"{tuple(t.shape)} {t.dtype}")
        return t
