"""Training step for LatentDiffusion (counterpart of
`ealdm_tpu/training/trainer.py`).

  * AdamW over the parameters that require a gradient: the UNet, the cond
    tower when it trains and a learned logvar. LatentDiffusion builds the
    first stage frozen, which leaves it out as optax's `set_to_zero` mask
    does. optax's arithmetic: eps outside the square root, eps_root 0, the
    weight decay added before the learning rate. `accumulate_grad_batches` has
    optax.MultiSteps' semantics (a running mean of the gradients, one update
    every k calls).
  * The EMA update after every step.
  * The LR schedule as a multiplier of the base rate, read at the count of
    updates made.
  * Rematerialisation of the UNet's backward, one region a block
    (`UNetModel.remat_blocks`, the policies of `utils.remat`): "dots" saves
    the outputs of the matrix products and convolutions and recomputes the
    rest, the GroupNorm and flash kernels' forwards included; "full" saves
    only each block's input; "none" saves everything. The frozen encodes run
    without gradient, and the small conditioning tower outside the regions.

The state is updated in place: TrainState.params are the model's own
parameters, and the optimizer and EMA tensors are updated where they lie.
A step returns the same state object with its step count advanced.

With a `mesh` (`parallel.create_mesh`) the step is data- and tensor-
parallel, as the JAX step jitted over a mesh: each rank takes its rows of
the global batch and its slices of a state cut by `parallel.shard_state`;
the step's draws are its rows of the global batch's (`parallel.draws`);
after the backward every gradient is averaged over the data group in flat
buckets; grad_norm is the norm of the whole gradient (the squares of cut
leaves summed over the model group, whole leaves counted once); the
optimizer and the EMA then update the rank's slices; the metrics are
averaged over the data group, so every rank returns the global batch's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.ddpm import LatentDiffusion
from ..parallel import draws
from ..parallel.comm import all_reduce_
from ..utils.device import check_module_device
from ..utils.remat import check_policy
from .ema import EmaState, ema_init, ema_update


@dataclasses.dataclass
class AdamWState:
    count: int  # updates made (adam's bias-correction count and the schedule's)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0  # micro-batches accumulated towards the next update
    acc_grads: Optional[Dict[str, torch.Tensor]] = None


class AdamW:
    """optax.adamw over the parameters that require a gradient (the others
    get no update, as under optax's set_to_zero), wrapped in optax.MultiSteps
    when accumulate_grad_batches > 1; applied in place."""

    def __init__(self, learning_rate: float,
                 schedule_fn: Optional[Callable[[int], float]] = None,
                 weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, accumulate_grad_batches: int = 1):
        if accumulate_grad_batches < 1:
            raise ValueError(f"accumulate_grad_batches {accumulate_grad_batches} < 1")
        self.learning_rate, self.schedule_fn = learning_rate, schedule_fn
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.every_k = accumulate_grad_batches

    def lr(self, count: int) -> float:
        if self.schedule_fn is None:
            return self.learning_rate
        return self.learning_rate * self.schedule_fn(count)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        names = [k for k, p in params.items() if p.requires_grad]
        zeros = lambda: {k: torch.zeros_like(params[k]) for k in names}  # noqa: E731
        return AdamWState(count=0, mu=zeros(), nu=zeros(),
                          acc_grads=zeros() if self.every_k > 1 else None)

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: AdamWState) -> bool:
        """One call: accumulate `grads` and, every k-th call, update the
        trainable `params` in place. Returns whether they were updated."""
        names = list(state.mu)
        g = [grads[k] for k in names]
        if self.every_k > 1:
            acc = [state.acc_grads[k] for k in names]
            # optax.MultiSteps: acc + (g - acc) / (mini_step + 1)
            step = torch._foreach_sub(g, acc)
            torch._foreach_div_(step, float(state.mini_step + 1))
            torch._foreach_add_(acc, step)
            state.mini_step += 1
            if state.mini_step < self.every_k:
                return False
            state.mini_step = 0
            g = acc
        with torch.profiler.record_function("ealdm::adamw"):
            self._adamw(names, [params[k] for k in names], g, state)
        if self.every_k > 1:
            torch._foreach_zero_(g)
        return True

    def _adamw(self, names, p, g, state):
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        lr = self.lr(state.count)
        state.count += 1
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, 1 - self.b2)
        # bias corrections in float32, as optax computes decay ** count
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(state.count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(state.count))
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd * p; p += -lr * u
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)


def make_optimizer(learning_rate: float,
                   schedule_fn: Optional[Callable[[int], float]] = None,
                   weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                   accumulate_grad_batches: int = 1) -> AdamW:
    """AdamW with optax.adamw's defaults and the schedule as a multiplier."""
    return AdamW(learning_rate, schedule_fn, weight_decay, b1, b2,
                 accumulate_grad_batches=accumulate_grad_batches)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # the model's own parameters, by name
    opt_state: AdamWState
    ema: Optional[EmaState]

    def state_dict(self) -> Dict[str, Any]:
        """Tensors, numbers and dicts only (loads with weights_only=True)."""
        opt = dict(vars(self.opt_state))  # shallow: the tensors themselves
        ema = None if self.ema is None else dict(vars(self.ema))
        return {"step": self.step, "params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": opt, "ema": ema}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a `state_dict` into this state's tensors, in place."""
        _copy_into(self.params, sd["params"])
        opt = sd["opt_state"]
        _copy_into(self.opt_state.mu, opt["mu"])
        _copy_into(self.opt_state.nu, opt["nu"])
        if self.opt_state.acc_grads is not None:
            _copy_into(self.opt_state.acc_grads, opt["acc_grads"])
        self.opt_state.count, self.opt_state.mini_step = opt["count"], opt["mini_step"]
        if (self.ema is None) != (sd["ema"] is None):
            raise ValueError("the checkpoint and the state disagree on the EMA")
        if self.ema is not None:
            _copy_into(self.ema.shadow, sd["ema"]["shadow"])
            self.ema.decay, self.ema.num_updates = sd["ema"]["decay"], sd["ema"]["num_updates"]
        self.step = sd["step"]


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    if set(dst) != set(src):
        raise ValueError(f"tensor names differ: {sorted(set(dst) ^ set(src))[:8]}")
    for k, t in dst.items():
        t.copy_(src[k])


def init_train_state(model: LatentDiffusion, optimizer: Optional[AdamW] = None,
                     learning_rate: float = 1e-6, use_ema: bool = True,
                     ema_decay: float = 0.9999, device=None) -> Tuple[TrainState, AdamW]:
    """The train state of `model` as it stands (its parameters are the
    state's): optimizer state for the trainable ones and an EMA shadow of
    all. device: where the model must live, "cuda" unless given."""
    check_module_device(model, device)
    params = dict(model.named_parameters())
    if optimizer is None:
        optimizer = make_optimizer(learning_rate)
    ema = ema_init(params, decay=ema_decay) if use_ema else None
    return TrainState(step=0, params=params, opt_state=optimizer.init(params), ema=ema), \
        optimizer


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (), generator=generator))


# bytes of one flat bucket of the gradients' all-reduce over the data group
GRAD_BUCKET_BYTES = 64 << 20


def _rows(batch) -> int:
    """The leading size of a batch's first tensor (the rank's rows)."""
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            return v.shape[0]
        if isinstance(v, dict):
            return _rows(v)
    raise ValueError("the batch holds no tensor")


def _draw_rows(mesh, batch):
    """The step's draws as the rank's rows of the global batch's."""
    if mesh is None:
        return contextlib.nullcontext()
    return draws.batch_rows(mesh.data_index, mesh.data, _rows(batch))


@torch.no_grad()
def average_gradients(grads: List[torch.Tensor], group, n: int,
                      bucket_bytes: int = GRAD_BUCKET_BYTES) -> None:
    """Each gradient replaced by its mean over `group` (n ranks), in place,
    one all-reduce a flat bucket of at most `bucket_bytes` (or one leaf)."""
    if group is None:
        return
    bucket, size = [], 0

    def flush():
        if bucket:
            flat = torch._utils._flatten_dense_tensors(bucket)
            all_reduce_(flat, group).div_(n)
            for g, r in zip(bucket, torch._utils._unflatten_dense_tensors(flat, bucket)):
                g.copy_(r)
            bucket.clear()

    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > bucket_bytes or g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += nbytes
    flush()


def global_grad_norm(grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                     mesh=None) -> torch.Tensor:
    """optax.global_norm of the whole gradient: under a model group the
    squares of the cut leaves are summed over it once, and whole leaves
    (alike on every rank of it) are counted once."""
    norms = torch._foreach_norm(list(grads.values()))
    if mesh is None or mesh.model_group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).float().square()
    cut = torch.tensor([getattr(params[k], "tp_shard", None) is not None for k in grads],
                       device=sq.device)
    cut_sq = all_reduce_(sq[cut].sum().reshape(1), mesh.model_group)
    return torch.sqrt(cut_sq[0] + sq[~cut].sum())


def average_metrics(metrics: Dict[str, torch.Tensor], mesh=None) -> Dict[str, torch.Tensor]:
    """The 0-d metrics averaged over the data group (one all-reduce)."""
    if mesh is None or mesh.data_group is None:
        return metrics
    names = list(metrics)
    v = all_reduce_(torch.stack([metrics[k].detach().float() for k in names]),
                    mesh.data_group) / mesh.data
    return {k: v[i] for i, k in enumerate(names)}


def make_train_step(model: LatentDiffusion, optimizer: AdamW, remat: str = "dots",
                    device=None, mesh=None):
    """(state, batch, generator) -> (state, metrics): the frozen first-stage
    encodes, the loss with the UNet's blocks under `remat`, its backward
    into each parameter's .grad, the optimizer and the EMA. `generator` (on
    any device) gives the step's seed; t, the noise and the dropout masks
    come from a generator on the model's device seeded with it. metrics:
    loss, loss_simple, loss_vlb and grad_norm (the global norm of this
    call's gradients), as 0-d tensors. mesh: the rank's place when the step
    runs data- or tensor-parallel (the module docstring); batch is then the
    rank's rows and every rank calls the step with the same generator."""
    dev = check_module_device(model, device)
    unet = model.model.diffusion_model
    check_policy(remat)

    def step(state: TrainState, batch, generator: torch.Generator):
        model.train()
        g = torch.Generator(device=dev).manual_seed(_seed(generator))
        for p in state.params.values():
            p.grad = None
        with unet.remat_blocks(remat), _draw_rows(mesh, batch):
            loss, metrics = model.training_loss(batch, g, train=True)
        loss.backward()
        grads = {k: state.params[k].grad for k in state.opt_state.mu}
        missing = [k for k, gr in grads.items() if gr is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:8]} ({len(missing)})")
        if mesh is not None:
            average_gradients(list(grads.values()), mesh.data_group, mesh.data)
        grad_norm = global_grad_norm(grads, state.params, mesh)
        optimizer.apply(state.params, grads, state.opt_state)
        if state.ema is not None:
            ema_update(state.ema, state.params)
        state.step += 1
        out = average_metrics({k: v.detach() for k, v in metrics.items()}, mesh)
        out["grad_norm"] = grad_norm
        return state, out

    return step


def make_eval_step(model: LatentDiffusion, device=None, mesh=None):
    """(state, batch, generator) -> metrics of the loss with the current
    parameters and, suffixed "_ema", with the EMA shadow swapped in; both on
    the same t and noise, dropout off (the reference's validation_step).
    With a `mesh` batch is the rank's rows and the metrics are averaged over
    the data group."""
    dev = check_module_device(model, device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: torch.Generator):
        model.eval()
        seed = _seed(generator)
        encoded = model.encode_inputs(batch)

        def metrics():
            g = torch.Generator(device=dev).manual_seed(seed)
            with _draw_rows(mesh, batch):
                return model.training_loss(batch, g, train=False, encoded=encoded)[1]

        out = dict(metrics())
        if state.ema is not None:
            saved = {k: p.data for k, p in state.params.items()}
            for k, p in state.params.items():
                p.data = state.ema.shadow[k]
            try:
                out.update({f"{k}_ema": v for k, v in metrics().items()})
            finally:
                for k, p in state.params.items():
                    p.data = saved[k]
        return average_metrics(out, mesh)

    return eval_step
