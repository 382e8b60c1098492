"""Serving: ahead-of-time export of the sampling program, an artifact
format, and a minimal batching server (counterpart of
`ealdm_tpu/serving.py`).

The JAX package exports the whole program (the CFG pair encode, the
stream-split DDIM scan and the decode) as one StableHLO module. Here the
program is `torch.export`ed as three `ExportedProgram`s, traced once at
fixed shapes on the device they will serve on:
  * "conditioning": the `mixed` inputs -> the (uncond, cond) pair;
  * "step": one DDIM step (the 2N-batched guided UNet call, optionally
    stream-split, and the update) with the step's timestep, schedule values
    and noise as tensor inputs;
  * "decode": the first-stage decode.
Each holds only its part of the model's parameters. Unrolling the 50 steps
into one graph would trace tens of thousands of nodes; the loop over steps
is instead `ServedSampler`, generic code here. The step invariants are not
hoisted (as in JAX's exported program). The hand-written kernels launch
through dispatcher operators (`ealdm::flash_attention`,
`ealdm::group_norm`, registered by `ealdm_torch.ops`), so the graphs name
them, and a serving process needs only torch and that registry, never
`ealdm_torch.models`. Parameters ride in each program's state:
`ServedSampler.load_state_dict` swaps a new checkpoint in without
re-export.

A `torch.Generator` cannot be a graph input, so the programs take x_T and
every step's noise as tensors; `SamplerService` draws them from its seeded
generator in `sample_images`' order (x_T, then each step's noise), so a
served batch equals `sample_images(..., hoist=False, generator=)` at the
same seed.

Artifact: `_MAGIC`, a little-endian u64 header length, a JSON header
(format, package and torch versions, the device type the programs were
traced on, fn_name, each program's byte length, the caller's meta under
"config") and the programs' `torch.export.save` bytes back to back. A
headerless file is one `torch.export.save` payload and loads as that
program's module. Loading on another device type than the traced one
raises (the counterpart of JAX's `platforms=`).
"""
from __future__ import annotations

import copy
import io
import json
import os
import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import __version__ as _PKG_VERSION
from . import ops  # noqa: F401  (registers the ealdm:: kernel operators)
from .utils.device import resolve_device

_MAGIC = b"EALDMEXP1\n"
FORMAT = "ealdm-torch-exported-v1"
PROGRAMS = ("conditioning", "step", "decode")


# ----------------------------------------------------------------- artifacts
def export_fn(module: torch.nn.Module, *example_args) -> torch.export.ExportedProgram:
    """`torch.export` of `module` at the example args' shapes and dtypes,
    without autograd."""
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def _program_bytes(ep: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_exported(programs: Dict[str, torch.export.ExportedProgram], path: str,
                  device, meta: Optional[dict] = None) -> str:
    """Write `programs` (name -> ExportedProgram, traced on `device`) to
    `path` behind the JSON header."""
    blobs = {name: _program_bytes(ep) for name, ep in programs.items()}
    header = {
        "format": FORMAT,
        "framework_version": _PKG_VERSION,
        "torch_version": torch.__version__,
        "device": torch.device(device).type,
        "fn_name": "sample",  # ServedSampler: (mixed, x_T, noise) -> images
        "programs": [[name, len(b)] for name, b in blobs.items()],
    }
    if meta:
        header["config"] = meta
    blob = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for b in blobs.values():
            f.write(b)
    return path


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """(header, payload) of an artifact; a headerless file gives {}."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(_MAGIC):
        off = len(_MAGIC)
        (n,) = struct.unpack_from("<Q", raw, off)
        off += 8
        return json.loads(raw[off:off + n].decode()), raw[off + n:]
    return {}, raw


def load_exported(path: str, *, with_meta: bool = False, device=None):
    """The artifact's callable: a `ServedSampler` over its programs, or for
    a headerless file its one program's module. `device` ("cuda" unless
    given) must be the device type the programs were traced on."""
    dev = resolve_device(device)
    header, payload = read_artifact(path)
    if not header:
        fn = torch.export.load(io.BytesIO(payload)).module()
        return (fn, header) if with_meta else fn
    if header.get("format") != FORMAT:
        raise ValueError(f"{path}: not an {FORMAT} artifact ({header.get('format')!r})")
    if header["device"] != dev.type:
        raise ValueError(f"{path} was traced on {header['device']}; it cannot be served on "
                         f"{dev.type}: export it again there")
    programs, off = {}, 0
    for name, n in header["programs"]:
        programs[name] = torch.export.load(io.BytesIO(payload[off:off + n]))
        off += n
    fn = ServedSampler(programs, header)
    return (fn, header) if with_meta else fn


class ServedSampler:
    """The loop over the exported programs:
    `(mixed, x_T [B, h, w, c], noise [S, B, h, w, c]) -> images [B, H, W, 3]`.
    The DDIM tables come from the header's config."""

    def __init__(self, programs: Dict[str, torch.export.ExportedProgram], header: dict):
        missing = set(PROGRAMS) - set(programs)
        if missing:
            raise ValueError(f"the artifact lacks the programs {sorted(missing)}")
        self.header = header
        self.meta = header.get("config", {})
        self.modules = {name: ep.module() for name, ep in programs.items()}
        dev = torch.device(header["device"])
        sched = self.meta["schedule"]
        self.timesteps = torch.tensor(sched["timesteps"], dtype=torch.int64, device=dev)
        self.alphas, self.alphas_prev, self.sigmas = (
            torch.tensor(sched[k], dtype=torch.float32, device=dev)
            for k in ("alphas", "alphas_prev", "sigmas"))

    @torch.no_grad()
    def __call__(self, mixed: Dict[str, torch.Tensor], x_T: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return self.modules["decode"](self.latents(mixed, x_T, noise))

    @torch.no_grad()
    def latents(self, mixed: Dict[str, torch.Tensor], x_T: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """The DDIM chain's last latent, before the decode."""
        mixed = {k: mixed[k] for k in self.meta["mixed_keys"]}
        c_neg, c_pos = self.modules["conditioning"](mixed)
        x = x_T
        b, s = x.shape[0], self.timesteps.shape[0]
        for i in range(s):  # high t first, as ddim_sample
            j = s - 1 - i
            x = self.modules["step"](x, self.timesteps[j].expand(b), self.alphas[j],
                                     self.alphas_prev[j], self.sigmas[j], noise[i], c_neg,
                                     c_pos)
        return x

    @torch.no_grad()
    def load_state_dict(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a LatentDiffusion's parameters (by their names in the model:
        a checkpoint's "params" or EMA "shadow") into every program that
        holds them, in place."""
        used = set()
        for gm in self.modules.values():
            for name, t in list(gm.named_parameters()) + list(gm.named_buffers()):
                key = name.removeprefix("ldm.")
                if key in params:
                    t.copy_(params[key])
                    used.add(key)
        if not used:
            raise ValueError("no parameter of the programs is in the state dict")


# ------------------------------------------------------------ the programs
def _view(module: torch.nn.Module, keep) -> torch.nn.Module:
    """A shallow copy of `module` sharing its parameters but holding only
    the children named in `keep`: `torch.export` keeps every parameter of
    the module it traces, used or not, so each program traces a view that
    holds its own part of the model and no other."""
    v = copy.copy(module)
    v._modules = {k: m for k, m in module._modules.items() if k in keep}
    return v


class _Conditioning(torch.nn.Module):
    """`mixed` -> (c_neg, c_pos), the CFG pair (`get_learned_conditioning_pair`)."""

    def __init__(self, model):
        super().__init__()
        self.ldm = _view(model, {"first_stage_model", "cond_stage_model"})
        self.ldm._modules["first_stage_model"] = _view(model.first_stage_model, {"encoder"})

    def forward(self, mixed):
        return self.ldm.get_learned_conditioning_pair(mixed)


class _Step(torch.nn.Module):
    """One DDIM step: the guided 2N-batched UNet call (split into `streams`
    sub-batches) and the update (`samplers.ddim.ddim_step`)."""

    def __init__(self, model, cfg, streams: int):
        super().__init__()
        self.ldm = _view(model, {"model"})
        self.cfg, self.streams = cfg, streams

    def forward(self, x, t, a_t, a_prev, sigma_t, noise, c_neg, c_pos):
        from .inference import make_eps_fn, split_streams
        from .samplers.ddim import _guided_eps, ddim_step

        e_t = _guided_eps(split_streams(make_eps_fn(self.ldm), self.streams), x, t, c_pos,
                          c_neg, self.cfg.unconditional_guidance_scale)
        return ddim_step(x, e_t, a_t, a_prev, sigma_t, noise, self.cfg)[0]


class _Decode(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.ldm = _view(model, {"first_stage_model"})
        self.ldm._modules["first_stage_model"] = _view(
            model.first_stage_model,
            set(model.first_stage_model._modules) - {"encoder", "quant_conv"})

    def forward(self, z):
        return self.ldm.decode_first_stage(z)


def export_sampler(model, batch_size: int, latent_shape, steps: int = 50, eta: float = 1.0,
                   guidance_scale: float = 2.0, streams: int = 1,
                   image_size: Optional[int] = None):
    """Export the flagship conditional-sampling program of a `mixed`
    LatentDiffusion (CFG over the (uncond, cond) pair, DDIM, the decode) at
    `batch_size`, on the device the model lives on; the same computation as
    `sample_images(..., mixed=, hoist=False)` and as JAX's
    `export_sampler`. Returns (programs, meta): the three ExportedPrograms
    and the header's config (shapes and the DDIM tables)."""
    from .ops.schedules import DDIMSchedule, DiffusionSchedule
    from .samplers import DDIMConfig

    if model.cond_stage_key != "mixed" or model.conditioning_key != "crossattn":
        raise ValueError("export_sampler takes a crossattn LatentDiffusion conditioned on "
                         "`mixed` (the STDiff model)")
    dev = next(model.parameters()).device
    sched = DiffusionSchedule.create(
        timesteps=model.timesteps, beta_schedule=model.beta_schedule,
        linear_start=model.linear_start, linear_end=model.linear_end,
        cosine_s=model.cosine_s, device=dev)
    ddim = DDIMSchedule.create(sched, steps, eta=eta)
    cfg = DDIMConfig(num_steps=steps, eta=eta, unconditional_guidance_scale=guidance_scale,
                     parameterization=model.parameterization)
    b = batch_size
    h = w = image_size if image_size is not None else latent_shape[0] * 8
    mixed = {k: torch.zeros(shape, device=dev) for k, shape in (
        ("img", (b, h, w, 3)), ("img_random", (b, h, w, 3)), ("flow", (b, 1, 1)),
        ("weather", (b, 1, 16)), ("time", (b, 1)))}
    model.eval()
    cond = _Conditioning(model)
    with torch.no_grad():
        c_neg, c_pos = cond(mixed)
    # distinct example tensors: inputs that alias one tensor are traced as one
    x, noise = (torch.zeros((b, *latent_shape), device=dev) for _ in range(2))
    a_t, a_prev, sigma_t = (torch.ones((), device=dev) for _ in range(3))
    t = ddim.timesteps[:1].repeat(b)
    programs = {
        "conditioning": export_fn(cond, mixed),
        "step": export_fn(_Step(model, cfg, streams), x, t, a_t, a_prev, sigma_t, noise, c_neg,
                          c_pos),
        "decode": export_fn(_Decode(model), x),
    }
    meta = {"steps": int(ddim.num_steps), "eta": eta, "guidance_scale": guidance_scale,
            "streams": streams, "batch_size": b, "resolution": h,
            "latent_shape": list(latent_shape), "mixed_keys": list(mixed),
            "schedule": {"timesteps": ddim.timesteps.tolist(),
                         **{k: getattr(ddim, k).tolist()
                            for k in ("alphas", "alphas_prev", "sigmas")}}}
    return programs, meta


# ------------------------------------------------------------------- serving
class SamplerService:
    """A steady-state server over an exported sampler (or any callable of
    the same signature). The program has a STATIC batch size: `submit`
    queues requests, `serve_pending` pads the last batch by repeating its
    last request, runs the program a batch at a time and returns the
    outputs in submission order. x_T and each step's noise come from a
    generator on the program's device seeded with `seed`."""

    def __init__(self, program: Callable, batch_size: int, seed: int = 0,
                 latent_shape=None, steps: Optional[int] = None, device=None):
        meta = getattr(program, "meta", {})
        self._program = program
        self._batch = batch_size
        self._latent = tuple(latent_shape if latent_shape is not None else meta["latent_shape"])
        self._steps = steps if steps is not None else meta["steps"]
        self._device = resolve_device(device)
        self._gen = torch.Generator(device=self._device).manual_seed(seed)
        self._queue = []

    def submit(self, mixed: dict) -> int:
        """Queue one request (per-sample arrays, no batch dim); returns its id."""
        self._queue.append(mixed)
        return len(self._queue) - 1

    def pending(self) -> int:
        return len(self._queue)

    def draws(self):
        """One batch's (x_T, noise [S, ...]) in `sample_images`' order."""
        shape = (self._batch, *self._latent)
        x_T = torch.randn(shape, generator=self._gen, device=self._device)
        noise = torch.stack([torch.randn(shape, generator=self._gen, device=self._device)
                             for _ in range(self._steps)])
        return x_T, noise

    def serve_pending(self):
        out = []
        q, self._queue = self._queue, []
        for start in range(0, len(q), self._batch):
            chunk = q[start:start + self._batch]
            n_real = len(chunk)
            chunk = chunk + [chunk[-1]] * (self._batch - n_real)
            batch = {k: torch.stack([torch.as_tensor(np.asarray(r[k])) for r in chunk])
                     .to(self._device, torch.float32) for k in chunk[0]}
            imgs = self._program(batch, *self.draws())
            out.extend(np.asarray(imgs[:n_real].float().cpu()))
        return out


def distributed_backend(device, local_world: int) -> str:
    """The backend rule: "nccl" when each of a host's `local_world` ranks has
    a card of its own; "gloo" when they share cards (NCCL refuses two ranks
    on one card), the collectives on the cards' tensors staged through host
    memory (`parallel/comm.py`); "gloo" on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(device=None) -> bool:
    """The one place that starts a process group, from the launcher's
    environment: MASTER_ADDR and MASTER_PORT (the rendezvous), WORLD_SIZE,
    RANK, LOCAL_RANK (the card: `cuda:{LOCAL_RANK % cards}`,
    `utils.device.rank_device`) and LOCAL_WORLD_SIZE (ranks on this host;
    WORLD_SIZE without it). Runs when WORLD_SIZE is above 1 and no group is
    up, else returns False. device: "cuda" (default) or "cpu"; the backend
    follows `distributed_backend`, and one line names it with the rank's
    device. EALDM_DIST_TIMEOUT (seconds), if set, bounds every collective
    wait, so a rank that stops failing the others instead of hanging them."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or torch.distributed.is_initialized():
        return False
    from .utils.device import rank_device

    dev = rank_device(device)
    rank = int(os.environ["RANK"])
    backend = distributed_backend(dev, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    kw = {}
    if os.environ.get("EALDM_DIST_TIMEOUT"):
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=float(os.environ["EALDM_DIST_TIMEOUT"]))
    torch.distributed.init_process_group(backend=backend, init_method="env://",
                                         world_size=world, rank=rank, **kw)
    print(f"[dist] rank {rank}/{world} backend {backend} device {dev}", flush=True)
    return True
