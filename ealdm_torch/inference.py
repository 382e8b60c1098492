"""Sampling pipeline: conditioning -> DDIM or PLMS loop -> first-stage
decode (counterpart of `ealdm_tpu/inference.py`).

`sample_images` is the port's main path: conditional (the STDiff pair with
CFG, or an encoded `cond` / `uncond` pair such as text or class contexts)
or unconditional, with the inpainting composite when given a mask and x0.
`log_images` is the image logger's bundle. Both run on the card unless the
caller passes device="cpu" (and built the model there).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models.ddpm import LatentDiffusion
from .models.unet import precompute_context_kv, precompute_emb_tables
from .ops.schedules import DDIMSchedule, DiffusionSchedule
from .parallel import draws, local_batch_size, shard_batch
from .parallel.comm import all_gather
from .samplers.ddim import DDIMConfig, _tree_map, ddim_sample
from .samplers.plms import plms_sample
from .utils.device import check_module_device


def split_streams(eps_fn, num_streams: int):
    """Wrap a denoiser so each call runs `num_streams` sub-batches one after
    another and concatenates them. In the JAX package this hides the TPU's
    per-op issue latency; the numerics are those of the unsplit call. Eager
    PyTorch gains nothing from it, so `sample_images` does not use it."""
    if num_streams <= 1:
        return eps_fn

    def split_fn(x, t, ctx, *extra):
        if x.shape[0] % num_streams:
            raise ValueError(f"batch {x.shape[0]} not divisible by {num_streams} streams")
        n = x.shape[0] // num_streams
        outs = [
            eps_fn(x[i * n:(i + 1) * n], t[i * n:(i + 1) * n],
                   _tree_map(lambda a: a[i * n:(i + 1) * n], ctx), *extra)
            for i in range(num_streams)
        ]
        return torch.cat(outs, dim=0)

    return split_fn


def make_eps_fn(model: LatentDiffusion):
    def eps_fn(x, t, ctx):
        return model.apply_model(x, t, ctx)

    return eps_fn


def hoist_invariants(model: LatentDiffusion, ddim: DDIMSchedule, cond=None,
                     uncond=None, want_emb_tables: bool = True):
    """Precompute the step-invariant work of a DDIM chain once: every
    SpatialTransformer's cross-attn K/V of the constant contexts, and the
    timestep MLP + every ResBlock's emb projection for all S timesteps.
    Returns (eps_fn, cond', uncond', extra_tables) for `ddim_sample`.
    want_emb_tables=False (PLMS, which evaluates off the per-step grid)
    skips the tables; extra_tables is then None. Where hoisting does not
    apply (a conditioning_key other than None and crossattn, split-input
    patching, or a class-conditional UNet) it returns the plain eps_fn with
    cond and uncond unchanged and no tables."""
    unet = model.model.diffusion_model
    if (model.conditioning_key not in (None, "crossattn")
            or model.split_input_params is not None or unet.num_classes is not None):
        return make_eps_fn(model), cond, uncond, None
    emb_tables = precompute_emb_tables(unet, ddim.timesteps) if want_emb_tables else None
    kv = model.conditioning_key == "crossattn" and unet.use_spatial_transformer
    if kv:
        if cond is not None:
            cond = precompute_context_kv(unet, cond)
        if uncond is not None:
            uncond = precompute_context_kv(unet, uncond)

    def eps_fn(x, t, ctx, emb_rows=None):
        return model.apply_model(x, t, None if kv else ctx,
                                 context_kv=ctx if kv else None, emb_tables=emb_rows)

    return eps_fn, cond, uncond, emb_tables


def encode_cfg_conditioning(model: LatentDiffusion, mixed: Dict):
    """(c_neg, c_pos) of the EALDM negative-pairing convention."""
    return model.get_learned_conditioning_pair(mixed)


@torch.no_grad()
def sample_images(model: LatentDiffusion, batch_size: int, latent_shape,
                  steps: int = 50, eta: float = 1.0,
                  guidance_scale: Optional[float] = None,
                  mixed: Optional[Dict] = None, cond=None, uncond=None,
                  sampler: str = "ddim",
                  quantize_denoised: bool = False, decode: bool = True,
                  x_T=None, mask=None, x0=None, hoist: bool = True,
                  generator: Optional[torch.Generator] = None, noise_fn=None,
                  device=None, mesh=None):
    """The full pipeline. Returns (images [N, H, W, 3], latents [N, h, w, c])
    or, with decode=False, the latents.

    mesh (`parallel.create_mesh`): data- and tensor-parallel sampling, as
    the JAX program jitted over a mesh. Every rank passes the global batch's
    inputs (batch_size N, the conditioning, x_T, mask, x0) and samples its
    data rank's rows of them, its draws (or noise_fn's) the rows of the
    global batch's; a model cut over the model group
    (`parallel.shard_params`) runs its layers on their shards. The outputs
    are gathered over the data group, whole on every rank.

    mixed: the STDiff conditioning dict, encoded into (uncond, cond) by
    `encode_cfg_conditioning` unless `cond` is given. cond / uncond: encoded
    contexts (`model.get_learned_conditioning` of tokens, class ids, ...);
    guidance runs when uncond is given and guidance_scale is not 1.
    sampler: "ddim" or "plms" (eta 0). mask / x0: inpainting, [N, h, w, 1]
    (1 keeps x0) and the known latent [N, h, w, c], both float32.
    device: where to run, "cuda" unless given; the model must live there.
    generator / noise_fn: the sampler's noise source (see ddim_sample)."""
    if sampler not in ("ddim", "plms"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if mesh is not None and mesh.data > 1:
        b = local_batch_size(batch_size, mesh)
        mixed, cond, uncond, x_T, mask, x0 = shard_batch(
            [mixed, cond, uncond, x_T, mask, x0], mesh)
        with draws.batch_rows(mesh.data_index, mesh.data, b):
            out = sample_images(
                model, b, latent_shape, steps=steps, eta=eta, guidance_scale=guidance_scale,
                mixed=mixed, cond=cond, uncond=uncond, sampler=sampler,
                quantize_denoised=quantize_denoised, decode=decode, x_T=x_T, mask=mask, x0=x0,
                hoist=hoist, generator=generator, noise_fn=noise_fn, device=device)
        if not decode:
            return all_gather(out, mesh.data_group, 0)
        return tuple(all_gather(t, mesh.data_group, 0) for t in out)
    dev = check_module_device(model, device)
    sched = DiffusionSchedule.create(
        timesteps=model.timesteps, beta_schedule=model.beta_schedule,
        linear_start=model.linear_start, linear_end=model.linear_end,
        cosine_s=model.cosine_s, device=dev,
    )
    ddim = DDIMSchedule.create(sched, steps, eta=eta)
    if guidance_scale is None:
        guidance_scale = model.unconditional_guidance_scale
    cfg = DDIMConfig(num_steps=steps, eta=eta, unconditional_guidance_scale=guidance_scale,
                     parameterization=model.parameterization)
    if mixed is not None and cond is None:
        mixed = {k: v.to(dev) for k, v in mixed.items()}
        uncond, cond = encode_cfg_conditioning(model, mixed)
    if hoist:
        eps_fn, cond, uncond, extra = hoist_invariants(
            model, ddim, cond, uncond, want_emb_tables=sampler != "plms")
    else:
        eps_fn, extra = make_eps_fn(model), None
    shape = (batch_size,) + tuple(latent_shape)
    inpaint = dict(mask=None if mask is None else mask.to(dev, torch.float32),
                   x0=None if x0 is None else x0.to(dev, torch.float32), schedule=sched)
    if sampler == "plms":
        z = plms_sample(eps_fn, shape, ddim, cfg, cond=cond, uncond=uncond, x_T=x_T,
                        generator=generator, noise_fn=noise_fn, **inpaint)
    else:
        z = ddim_sample(eps_fn, shape, ddim, cfg, cond=cond, uncond=uncond, x_T=x_T,
                        generator=generator, noise_fn=noise_fn, extra_tables=extra,
                        **inpaint)
    if quantize_denoised:
        z = model.quantize_latent(z)
    if not decode:
        return z
    return model.decode_first_stage(z), z


@torch.no_grad()
def log_images(model: LatentDiffusion, batch: Dict, generator: Optional[torch.Generator] = None,
               n: int = 8, steps: int = 50, eta: float = 1.0, sample: bool = True,
               quantize_denoised: bool = True, inpaint: bool = False,
               plot_progressive_rows: bool = False, device=None) -> Dict[str, torch.Tensor]:
    """The reference `log_images` bundle as a dict of NHWC tensors, with the
    JAX package's keys in its order: "inputs" (batch["img"][:n]),
    "reconstruction", "conditioning" (the STDiff image) or "bbox_image" (the
    rendered layout), "diffusion_row" (the first min(n, 4) latents noised at
    6 timesteps from 0 to T - 1, decoded, side by side), then with `sample`:
    "samples" (DDIM, guidance only for the STDiff pair), with
    `quantize_denoised` "diff_samples" and "diff_samples_latent" (the
    samples' VQ-quantized latents and their decode), with `inpaint`
    "samples_inpainting", "mask" (1 keeps the latent's border, 0 its middle
    half) and "samples_outpainting", and with `plot_progressive_rows`
    "progressive_row" (the decoded pred_x0 of 6 evenly spaced steps of a
    min(n, 4) chain). Every draw (a KL posterior sample, the diffusion
    row's noise, the samplers' x_T and noise) comes from `generator`, in
    that order."""
    from .data.layout import BBoxTokenizer, render_layout

    dev = check_module_device(model, device)
    out: Dict[str, torch.Tensor] = {}
    x = batch["img"][:n].to(dev)
    n = x.shape[0]
    out["inputs"] = x
    z = model.scale_factor * model.encode_first_stage(x, generator)
    out["reconstruction"] = model.decode_first_stage(z)
    latent_shape = tuple(z.shape[1:])

    mixed = None
    if model.cond_stage_key == "mixed" and "mixed" in batch:
        mixed = {k: v[:n].to(dev) for k, v in batch["mixed"].items()}
        out["conditioning"] = mixed["img"]
    cond_ctx = None
    if mixed is None and model.conditioning_key is not None and model.cond_stage_key in batch:
        # generic conditioning (class ids, caption or bbox tokens)
        cond_ctx = model.get_learned_conditioning(batch[model.cond_stage_key][:n].to(dev))
    if model.cond_stage_key == "coordinates_bbox" and "coordinates_bbox" in batch:
        tok = BBoxTokenizer()
        out["bbox_image"] = torch.stack([
            torch.from_numpy(render_layout(tok.decode(ids.tolist()), x.shape[1]))
            for ids in batch["coordinates_bbox"][:n].cpu()]).to(dev)

    n_row = min(n, 4)
    ts = np.linspace(0, model.timesteps - 1, 6).astype(np.float32).astype(np.int64)
    noise = torch.randn(z[:n_row].shape, generator=generator, device=dev)
    rows = [model.decode_first_stage(model.q_sample(
        z[:n_row], torch.full((n_row,), int(t), dtype=torch.int64, device=dev), noise))
        for t in ts]
    out["diffusion_row"] = torch.cat(rows, dim=2)
    if not sample:
        return out

    common = dict(steps=steps, eta=eta, mixed=mixed, cond=cond_ctx,
                  guidance_scale=None if mixed is not None else 1.0, generator=generator,
                  device=dev)
    imgs, zs = sample_images(model, n, latent_shape, **common)
    out["samples"] = imgs
    if quantize_denoised:
        zq = model.quantize_latent(zs)
        out["diff_samples"] = model.decode_first_stage(zq)
        out["diff_samples_latent"] = zq
    if inpaint:
        h, w = latent_shape[0], latent_shape[1]
        mask = torch.ones(n, h, w, 1, device=dev)
        mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 0.0
        out["samples_inpainting"], _ = sample_images(model, n, latent_shape, mask=mask, x0=z,
                                                     **common)
        out["mask"] = mask
        out["samples_outpainting"], _ = sample_images(model, n, latent_shape, mask=1.0 - mask,
                                                      x0=z, **common)
    if plot_progressive_rows:
        sched = DiffusionSchedule.create(
            timesteps=model.timesteps, beta_schedule=model.beta_schedule,
            linear_start=model.linear_start, linear_end=model.linear_end, device=dev)
        ddim = DDIMSchedule.create(sched, steps, eta=eta)
        cond = uncond = None
        ucg = model.unconditional_guidance_scale
        if mixed is not None:
            uncond, cond = encode_cfg_conditioning(model, mixed)
        elif cond_ctx is not None:
            # condition the chain too, without guidance (no paired negative)
            cond, ucg = cond_ctx, 1.0
        _, (_, pred_x0s) = ddim_sample(
            make_eps_fn(model), (n_row,) + latent_shape, ddim,
            DDIMConfig(num_steps=steps, eta=eta, unconditional_guidance_scale=ucg,
                       parameterization=model.parameterization),
            cond=None if cond is None else cond[:n_row],
            uncond=None if uncond is None else uncond[:n_row],
            generator=generator, return_intermediates=True)
        picks = np.linspace(0, steps - 1, 6).astype(np.float32).astype(np.int64)
        out["progressive_row"] = torch.cat(
            [model.decode_first_stage(pred_x0s[int(i)]) for i in picks], dim=2)
    return out
