"""Masked inpainting (counterpart of `scripts/inpaint.py`):

    python -m ealdm_torch.scripts.inpaint --outdir DIR [--indir DIR]
        [--steps 50] [--plms] [-r <logdir>] [--tiny] [--device cuda]

Each `<name>_mask.png` in `--indir` (default: the committed
data/inpainting_examples) pairs with `<name>.png`. `make_batch` reads them
as the JAX script's Pillow calls do, in numpy: the image converted to RGB
and the mask to "L" (Pillow's integer luma), both BICUBIC-resized
(`data.images.resample`), the mask thresholded at 0.5 (1 = hole). The
image's first-stage latent is sampled with DDIM (or PLMS) at eta 0 under
the latent keep-mask (the hole mask resized "nearest-exact", which picks
the pixels JAX's `jax.image.resize(..., "nearest")` picks: half-pixel
centres), then decoded, and the known region is composited back. Without
`-r` the weights are seeded random (seed 0). PNG inputs only.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ._common import (DTYPE, add_device_args, inference_settings, read_checkpoint, read_png,
                      resolve, to_uint8)

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "inpainting_examples")


def to_luma(img: np.ndarray) -> np.ndarray:
    """Pillow's convert("L") of a decoded 8-bit PNG: (R * 19595 + G * 38470
    + B * 7471 + 0x8000) >> 16 of RGB(A); greyscale as it is."""
    if img.ndim == 2:
        return img
    if img.shape[2] in (1, 2):
        return img[..., 0]
    rgb = img[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def make_batch(image_path: str, mask_path: str, size: int = 256):
    """{"image" [1, size, size, 3] in [-1, 1], "mask" [1, size, size, 1]
    (1 = hole), "masked_image"} as float32 numpy, as the JAX script's
    `make_batch` gives them."""
    from ..data.images import resample
    from ..utils.png import to_rgb

    img = resample(to_rgb(read_png(image_path)), (size, size), "bicubic")
    img = img.astype(np.float32) / 127.5 - 1.0
    mask = resample(to_luma(read_png(mask_path)), (size, size), "bicubic")
    mask = (mask.astype(np.float32) / 255.0 > 0.5).astype(np.float32)[..., None]
    masked = img * (1.0 - mask)
    # contiguous: the resize's passes leave strided arrays, and the model
    # takes dense NHWC tensors (the flash kernel needs a contiguous head dim)
    return {k: np.ascontiguousarray(v[None])
            for k, v in (("image", img), ("mask", mask), ("masked_image", masked))}


def keep_mask(mask_px: torch.Tensor, side: int) -> torch.Tensor:
    """The latent keep-mask [N, side, side, 1] (1 = keep) of a pixel hole
    mask [N, H, W, 1]: the JAX script's `jax.image.resize(..., "nearest")`,
    which samples at half-pixel centres (torch's "nearest-exact"; its
    "nearest" picks other pixels)."""
    hole = F.interpolate(mask_px.permute(0, 3, 1, 2).float(), size=(side, side),
                         mode="nearest-exact")
    return 1.0 - hole.permute(0, 2, 3, 1)


def model_kwargs(tiny: bool):
    """(image side, LatentDiffusion keyword arguments) of the JAX script's
    latent-inpainting model: a VQ-f4 first stage and an unconditional UNet,
    full size or `--tiny`."""
    if tiny:
        size = 32
        unet = dict(image_size=16, in_channels=3, out_channels=3, model_channels=16,
                    attention_resolutions=[4], num_res_blocks=1, channel_mult=[1, 2],
                    num_heads=2)
        ddconfig = dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3,
                        ch=16, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[],
                        dropout=0.0)
        n_embed = 64
    else:
        size = 256
        unet = dict(image_size=64, in_channels=3, out_channels=3, model_channels=128,
                    attention_resolutions=[8, 4, 2], num_res_blocks=2,
                    channel_mult=[1, 2, 3, 4], num_heads=8)
        ddconfig = dict(double_z=False, z_channels=3, resolution=256, in_channels=3, out_ch=3,
                        ch=128, ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[],
                        dropout=0.0)
        n_embed = 8192
    return size, dict(
        unet_config=unet,
        first_stage_config={"target": "ldm.models.autoencoder.VQModelInterface",
                            "params": {"embed_dim": 3, "n_embed": n_embed,
                                       "ddconfig": ddconfig}},
        cond_stage_config="__is_unconditional__", timesteps=1000, linear_start=0.0015,
        linear_end=0.0205)


@torch.no_grad()
def inpaint(model, batch: dict, steps: int, plms: bool, generator=None, x_T=None,
            noise_fn=None):
    """One image: (the composite [1, H, W, 3] float32, the sample before
    compositing, the keep-mask)."""
    from ..inference import sample_images

    dev = next(model.parameters()).device
    x = torch.from_numpy(batch["image"]).to(dev)
    mask_px = torch.from_numpy(batch["mask"]).to(dev)
    z = model.encode_first_stage(x, generator)
    z = model.scale_factor * z
    keep = keep_mask(mask_px, z.shape[1])
    img, _ = sample_images(model, 1, tuple(z.shape[1:]), steps=steps, eta=0.0, mask=keep,
                           x0=z.float(), sampler="plms" if plms else "ddim",
                           generator=generator, x_T=x_T, noise_fn=noise_fn, device=dev.type)
    result = x * (1 - mask_px) + img.float() * mask_px
    return result, img, keep


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the output paths."""
    from ..models.ddpm import LatentDiffusion
    from ..utils.init import random_init_
    from ..utils.png import save_png
    from ._common import load_sampling_weights

    p = argparse.ArgumentParser()
    p.add_argument("--indir", type=str, default=_EXAMPLES,
                   help="dir with *.png images and *_mask.png masks "
                        "(default: the committed data/inpainting_examples)")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--plms", action="store_true", help="the PLMS sampler instead of DDIM")
    p.add_argument("-r", "--resume", type=str, default="", help="trained run dir (optional)")
    p.add_argument("--tiny", action="store_true", help="tiny model and resolution")
    opt = add_device_args(p).parse_args(argv)
    dev = resolve(opt)

    masks = sorted(glob.glob(os.path.join(opt.indir, "*_mask.png")))
    images = [m.replace("_mask.png", ".png") for m in masks]
    print(f"Found {len(masks)} inputs.")
    os.makedirs(opt.outdir, exist_ok=True)
    size, kwargs = model_kwargs(opt.tiny)
    outs = []
    with inference_settings():
        model = LatentDiffusion(**kwargs, dtype=DTYPE, device=dev).eval()
        if opt.resume:
            load_sampling_weights(model, read_checkpoint(
                os.path.join(opt.resume, "checkpoints"), last=True))
        else:
            random_init_(model, seed=0)
        gen = torch.Generator(device=dev).manual_seed(0)
        for image_path, mask_path in zip(images, masks):
            result, _, _ = inpaint(model, make_batch(image_path, mask_path, size=size),
                                   opt.steps, opt.plms, generator=gen)
            outs.append(os.path.join(opt.outdir, os.path.basename(image_path)))
            save_png(outs[-1], to_uint8(result)[0])
    print(f"Inpainted {len(images)} images -> {opt.outdir}")
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
