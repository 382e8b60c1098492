"""Text-to-image sampling with classifier-free guidance (counterpart of
`scripts/txt2img.py`):

    python -m ealdm_torch.scripts.txt2img [--prompt TEXT] [--config <yaml>]
        [-r <logdir>] [--ddim_steps 50] [--plms] [--ddim_eta 0] [--scale 5]
        [--n_samples 4] [--n_iter 1] [--outdir DIR] [--device cuda]

The prompt and the empty prompt go through the port's `SimpleTokenizer`
at the cond stage's vocab size and length, then the cond stage; DDIM (or
PLMS) samples with guidance at `--scale`, the first stage decodes, and
the images land in <outdir>/samples with a grid named after the prompt.
Without `-r` the weights are seeded random (`utils.init.random_init_`,
seed 0); with it, the run's EMA shadow. Draws come from a generator
seeded with 0 on the device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ._common import (add_device_args, inference_settings, read_checkpoint, resolve,
                      sampling_model, to_uint8)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a painting of a river in a storm")
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", type=int, default=256)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("-r", "--resume", type=str, default="",
                   help="trained run dir (optional; seeded random weights otherwise)")
    p.add_argument("--config", type=str, default="")
    return add_device_args(p)


DEFAULT_TXT2IMG = {
    "model": {
        "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
        "params": {
            "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000,
            "first_stage_key": "image", "cond_stage_key": "caption",
            "conditioning_key": "crossattn", "cond_stage_trainable": True,
            "image_size": 32, "channels": 4,
            "unet_config": {
                "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                "params": {
                    "image_size": 32, "in_channels": 4, "out_channels": 4,
                    "model_channels": 128, "attention_resolutions": [4, 2, 1],
                    "num_res_blocks": 2, "channel_mult": [1, 2, 4],
                    "num_heads": 8, "use_spatial_transformer": True,
                    "transformer_depth": 1, "context_dim": 512,
                },
            },
            "first_stage_config": {
                "target": "ldm.models.autoencoder.VQModelInterface",
                "params": {
                    "embed_dim": 4, "n_embed": 16384,
                    "ddconfig": {
                        "double_z": False, "z_channels": 4, "resolution": 256,
                        "in_channels": 3, "out_ch": 3, "ch": 128,
                        "ch_mult": [1, 2, 2, 4], "num_res_blocks": 2,
                        "attn_resolutions": [32], "dropout": 0.0,
                    },
                },
            },
            "cond_stage_config": {
                "target": "ldm.modules.encoders.modules.BERTEmbedder",
                "params": {"n_embed": 512, "n_layer": 8},
            },
        },
    }
}


def tokens(config: dict, prompt: str, n: int):
    """(prompt ids, empty-prompt ids) [n, L] of the cond stage's tokenizer."""
    from ..models.text_transformer import SimpleTokenizer

    csc = config["model"]["params"].get("cond_stage_config", {}).get("params", {})
    tok = SimpleTokenizer(vocab_size=csc.get("vocab_size", 30522),
                          max_len=csc.get("max_seq_len", 77))
    return tok([prompt] * n), tok([""] * n)


def build_model(config: dict, device, resume: str = ""):
    """The config's model with the run's EMA weights, or seeded random ones."""
    from ..utils.init import random_init_

    ckpt = None
    if resume:
        ckpt = read_checkpoint(os.path.join(resume, "checkpoints"), last=True)
    model = sampling_model(config["model"], device, ckpt)
    if ckpt is None:
        random_init_(model, seed=0)
    return model


@torch.no_grad()
def sample(model, c, uc, shape, steps: int, eta: float, scale: float, plms: bool,
           generator=None, x_T=None, noise_fn=None):
    """One batch of guided samples: (images, latents)."""
    from ..inference import sample_images

    return sample_images(model, shape[0], shape[1:], steps=steps, eta=0.0 if plms else eta,
                         guidance_scale=scale, cond=c, uncond=uc,
                         sampler="plms" if plms else "ddim", generator=generator, x_T=x_T,
                         noise_fn=noise_fn, device=next(model.parameters()).device.type)


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the grid's path."""
    from ..config import load_config
    from ..utils.png import save_png

    opt = get_parser().parse_args(argv)
    dev = resolve(opt)
    config = load_config([opt.config]) if opt.config else DEFAULT_TXT2IMG
    mp = config["model"]["params"]
    zres = mp["unet_config"]["params"].get("image_size", opt.H // 8)
    zch = mp["unet_config"]["params"]["in_channels"]
    n = opt.n_samples
    with inference_settings():
        model = build_model(config, dev, opt.resume)
        tokens_c, tokens_uc = tokens(config, opt.prompt, n)
        c = model.get_learned_conditioning(tokens_c.to(dev))
        uc = model.get_learned_conditioning(tokens_uc.to(dev))

        os.makedirs(opt.outdir, exist_ok=True)
        sample_dir = os.path.join(opt.outdir, "samples")
        os.makedirs(sample_dir, exist_ok=True)
        base_count = len(os.listdir(sample_dir))
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = []
        for _ in range(opt.n_iter):
            imgs, _ = sample(model, c, uc, (n, zres, zres, zch), opt.ddim_steps, opt.ddim_eta,
                             opt.scale, opt.plms, generator=gen)
            imgs_u8 = to_uint8(imgs)
            for im in imgs_u8:
                save_png(os.path.join(sample_dir, f"{base_count:04d}.png"), im)
                base_count += 1
            rows.append(np.concatenate(list(imgs_u8), axis=1))
    grid = os.path.join(opt.outdir, f'{opt.prompt.replace(" ", "-")[:60]}.png')
    save_png(grid, np.concatenate(rows, axis=0))
    print(f"Your samples are ready in {opt.outdir}")
    return grid


if __name__ == "__main__":
    main(sys.argv[1:])
