"""Batched (un)conditional sampling from a trained run (counterpart of
`scripts/sample_diffusion.py`):

    python -m ealdm_torch.scripts.sample_diffusion -r <logdir> [-n 50] [-c 50]
        [-e 1.0] [-v] [--batch_size 10] [-l <outdir>] [--device cuda]

Reads the run's config with the port's YAML reader, restores the last
checkpoint that `ealdm_torch.main` wrote and samples with its EMA shadow:
DDIM at `-c` steps and eta `-e`, or the full-T ancestral chain with `-v`,
then the first-stage decode. A model conditioned on `mixed` gets the
neutral conditioning of the JAX script (a seeded image, zero flow, weather
and time, env fusion off, no guidance). Writes img/<n>.png,
<n>_samples.npz and sampling_config.json, and prints each batch's
throughput. Draws come from a generator seeded with 42 on the device.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from ._common import (add_device_args, inference_settings, load_run, read_checkpoint, resolve,
                      sampling_model, to_uint8)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-r", "--resume", type=str, required=True, help="logdir or checkpoint dir")
    p.add_argument("-n", "--n_samples", type=int, default=50)
    p.add_argument("-e", "--eta", type=float, default=1.0)
    p.add_argument("-v", "--vanilla_sample", action="store_true",
                   help="full-T ancestral sampling instead of DDIM")
    p.add_argument("-l", "--logdir", type=str, default="none")
    p.add_argument("-c", "--custom_steps", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=10)
    return add_device_args(p)


def neutral_mixed(b: int, res: int, device) -> dict:
    """The JAX script's neutral `mixed` input: a RandomState(0) image (as
    img and img_random), zero flow, weather and time."""
    img = torch.from_numpy(np.random.RandomState(0).randn(b, res, res, 3).astype(np.float32))
    img = img.to(device)
    return {"img": img, "img_random": img,
            "flow": torch.zeros(b, 1, 1, device=device),
            "weather": torch.zeros(b, 1, 16, device=device),
            "time": torch.zeros(b, 1, device=device)}


@torch.no_grad()
def neutral_conditioning(model, b: int, res: int, device):
    """The context a `mixed` model samples under (env fusion off), else None."""
    if model.conditioning_key is None or model.cond_stage_key != "mixed":
        return None
    return model.get_learned_conditioning(neutral_mixed(b, res, device), False)


@torch.no_grad()
def sample_batch(model, shape, cond, steps: int, eta: float, vanilla: bool,
                 generator=None, x_T=None, noise_fn=None):
    """One batch: (images [B, H, W, 3], latents). DDIM (hoisted, no
    guidance) or, with `vanilla`, the ancestral chain."""
    from ..inference import make_eps_fn, sample_images
    from ..ops.schedules import DiffusionSchedule
    from ..samplers import ancestral_sample

    if not vanilla:
        return sample_images(model, shape[0], shape[1:], steps=steps, eta=eta,
                             guidance_scale=1.0, cond=cond, generator=generator, x_T=x_T,
                             noise_fn=noise_fn, device=next(model.parameters()).device.type)
    dev = next(model.parameters()).device
    sched = DiffusionSchedule.create(
        timesteps=model.timesteps, beta_schedule=model.beta_schedule,
        linear_start=model.linear_start, linear_end=model.linear_end,
        cosine_s=model.cosine_s, device=dev)
    z = ancestral_sample(make_eps_fn(model), shape, sched, cond=cond, x_T=x_T,
                         generator=generator, noise_fn=noise_fn)
    return model.decode_first_stage(z), z


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the output dir."""
    from ..utils.png import save_png

    opt = get_parser().parse_args(argv)
    dev = resolve(opt)
    config, ckpt_dir, logdir = load_run(opt.resume)
    with inference_settings():
        model = sampling_model(config["model"], dev, read_checkpoint(ckpt_dir, last=True))
        mp = config["model"]["params"]
        res = mp["first_stage_config"]["params"]["ddconfig"]["resolution"]
        zres = mp["unet_config"]["params"]["image_size"]
        zch = mp["unet_config"]["params"]["in_channels"]
        b = opt.batch_size
        cond = neutral_conditioning(model, b, res, dev)

        outdir = opt.logdir if opt.logdir != "none" else os.path.join(
            logdir, "samples", datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
        imgdir = os.path.join(outdir, "img")
        os.makedirs(imgdir, exist_ok=True)
        print(f"Writing samples to {outdir}")

        gen = torch.Generator(device=dev).manual_seed(42)
        all_images, n_saved = [], 0
        while n_saved < opt.n_samples:
            t0 = time.time()
            imgs, _ = sample_batch(model, (b, zres, zres, zch), cond, opt.custom_steps, opt.eta,
                                   opt.vanilla_sample, generator=gen)
            imgs_u8 = to_uint8(imgs)
            dt = time.time() - t0
            print(f"Throughput for this batch: {imgs_u8.shape[0] / dt:.2f} img/s")
            for im in imgs_u8:
                if n_saved >= opt.n_samples:
                    break
                save_png(os.path.join(imgdir, f"{n_saved:06d}.png"), im)
                n_saved += 1
            all_images.append(imgs_u8)

    arr = np.concatenate(all_images)[:opt.n_samples]
    np.savez(os.path.join(outdir, f"{arr.shape[0]}_samples.npz"), arr)
    with open(os.path.join(outdir, "sampling_config.json"), "w") as f:
        json.dump(vars(opt), f)
    print(f"Saved {n_saved} samples.")
    return outdir


if __name__ == "__main__":
    main(sys.argv[1:])
