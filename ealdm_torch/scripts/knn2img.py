"""Retrieval-augmented sampling with the RDM (counterpart of
`scripts/knn2img.py`):

    python -m ealdm_torch.scripts.knn2img --database <npz> [--prompt TEXT |
        --from_file FILE | --query_image PNG] [--config <yaml> [--ckpt PATH] |
        -r <logdir>] [--use_neighbors --knn 10] [--plms] [--scale 5]
        [--n_samples 2] [--H 768 --W 768] [--outdir DIR] [--device cuda]

The model comes from a run (`-r`) or a config with an optional checkpoint
of the port's layout (an orbax directory of the JAX package raises). The
query is the CLIP text tower's embedding of the prompts (cycled to
n_samples), or the image tower's of one PNG (no resize here; the tower's
preprocessing resizes). A prebuilt index (`train_searcher`) or a raw
database (indexed on the fly) gives the k nearest neighbours; the
conditioning is [query; neighbours] (with --use_neighbors), the
unconditional context its zeros where the scale is not 1. The step
invariants are hoisted, DDIM (or PLMS) samples with guidance, the first
stage decodes, and the images land in <outdir>/samples with a padded grid.
The CLIP towers and, without a checkpoint, the RDM take seeded random
weights (seed 0). Draws come from a generator seeded with 1 + the
iteration on the device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ._common import (add_device_args, inference_settings, load_run, read_checkpoint, resolve,
                      sampling_model, to_uint8)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a happy bear reading a newspaper, oil on canvas")
    p.add_argument("--from_file", type=str, default=None, help="prompts file, one per line")
    p.add_argument("--query_image", type=str, default=None,
                   help="image-image retrieval: embed this PNG with the CLIP image tower")
    p.add_argument("--config", type=str,
                   default="configs/retrieval-augmented-diffusion/768x768.yaml")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint (state.pt, a step or last dir, or a checkpoints dir) "
                        "for --config; seeded random weights if absent")
    p.add_argument("-r", "--resume", type=str, default=None,
                   help="trained run logdir (overrides --config/--ckpt)")
    p.add_argument("--clip_type", type=str, default="ViT-L/14",
                   choices=["ViT-B/32", "ViT-B/16", "ViT-L/14"])
    p.add_argument("--database", type=str, required=True,
                   help="searcher index .npz (train_searcher) or a raw embedding database .npz")
    p.add_argument("--use_neighbors", action="store_true",
                   help="append retrieved neighbours to the conditioning")
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--outdir", type=str, default="outputs/knn2img-samples")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_samples", type=int, default=2)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--n_rows", type=int, default=0)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--skip_grid", action="store_true")
    p.add_argument("--H", type=int, default=768)
    p.add_argument("--W", type=int, default=768)
    return add_device_args(p)


def load_model(opt, device):
    """(model, config) from `-r` or `--config` [`--ckpt`]."""
    from ..config import load_config
    from ..utils.init import random_init_

    if opt.resume:
        config, ckpt, _ = load_run(opt.resume)
    else:
        config, ckpt = load_config([opt.config]), opt.ckpt
    state = read_checkpoint(ckpt) if ckpt else None
    model = sampling_model(config["model"], device, state)
    if state is None:
        print("WARNING: sampling from seeded RANDOM weights (no --ckpt/-r)")
        random_init_(model, seed=0)
    return model, config


@torch.no_grad()
def embed_queries(opt, n: int, device, params=None):
    """([n, D] L2-normalized CLIP query embeddings on `device`, the query
    labels). The tower takes seeded weights (seed 0), or `params`, a flax
    tree of the JAX tower."""
    from ..models.encoders import FrozenClipImageEmbedder, FrozenCLIPTextEmbedder
    from ..retrieval import _seeded_or_carried, embed_queries as embed
    from ..utils.png import to_rgb
    from ._common import read_png

    if opt.query_image:
        x = torch.from_numpy(to_rgb(read_png(opt.query_image)).astype(np.float32))
        x = x[None].to(device) / 127.5 - 1.0
        emb = _seeded_or_carried(FrozenClipImageEmbedder.from_version(opt.clip_type,
                                                                      device=device),
                                 0, params, device)
        return (embed(n, image=x, image_embedder=emb),
                [f"<image:{os.path.basename(opt.query_image)}>"] * n)
    if opt.from_file:
        with open(opt.from_file) as f:
            texts = [ln for ln in f.read().splitlines() if ln.strip()]
        if not texts:
            raise SystemExit(f"--from_file {opt.from_file}: no prompts found")
    else:
        texts = [opt.prompt]
    texts = (texts * ((n + len(texts) - 1) // len(texts)))[:n]
    emb = _seeded_or_carried(FrozenCLIPTextEmbedder.from_version(opt.clip_type, device=device),
                             0, params, device)
    return embed(n, texts=texts, text_embedder=emb), texts


def load_searcher(path: str, device):
    """A saved index, or a raw database indexed on the fly."""
    from ..retrieval import Searcher

    try:
        return Searcher.load(path, device=device)
    except (KeyError, ValueError):
        return Searcher.from_database(dict(np.load(path)), device=device)


@torch.no_grad()
def sample(model, c, uc, shape, steps: int, eta: float, scale: float, plms: bool,
           generator=None, x_T=None, noise_fn=None):
    """One batch: (images, latents), hoisted (DDIM with the timestep tables)."""
    from ..inference import sample_images

    return sample_images(model, shape[0], shape[1:], steps=steps, eta=eta,
                         guidance_scale=scale, cond=c, uncond=uc,
                         sampler="plms" if plms else "ddim", generator=generator, x_T=x_T,
                         noise_fn=noise_fn, device=next(model.parameters()).device.type)


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the output dir."""
    from ..retrieval import retrieval_conditioning
    from ..utils.png import save_png

    opt = get_parser().parse_args(argv)
    dev = resolve(opt)
    with inference_settings():
        model, config = load_model(opt, dev)
        mp = config["model"]["params"]
        ctx_dim = mp["unet_config"]["params"]["context_dim"]
        zch = mp["unet_config"]["params"]["in_channels"]
        f = 2 ** (len(mp["first_stage_config"]["params"]["ddconfig"]["ch_mult"]) - 1)
        searcher = load_searcher(opt.database, dev)
        assert searcher.dim == ctx_dim, (
            f"database dim {searcher.dim} != model context_dim {ctx_dim}; "
            f"pick a matching --clip_type/database")

        q, texts = embed_queries(opt, opt.n_samples, dev)
        print("sampling prompts:", texts[:2], "..." if len(texts) > 2 else "")
        c, uc, _ = retrieval_conditioning(q, searcher if opt.use_neighbors else None,
                                          k=opt.knn, guidance_scale=opt.scale)
        shape = (opt.n_samples, opt.H // f, opt.W // f, zch)

        sample_path = os.path.join(opt.outdir, "samples")
        os.makedirs(sample_path, exist_ok=True)
        base_count = len(os.listdir(sample_path))
        grid_count = len([f_ for f_ in os.listdir(opt.outdir) if f_.startswith("grid")])
        print(f"sampling scale for cfg is {opt.scale:.2f}")
        all_samples = []
        for it in range(opt.n_iter):
            gen = torch.Generator(device=dev).manual_seed(1 + it)
            imgs, _ = sample(model, c, uc, shape, opt.ddim_steps, opt.ddim_eta, opt.scale,
                             opt.plms, generator=gen)
            imgs8 = to_uint8(imgs)
            for im in imgs8:
                save_png(os.path.join(sample_path, f"{base_count:05}.png"), im)
                base_count += 1
            all_samples.append(imgs8)

    if not opt.skip_grid:
        stack = np.concatenate(all_samples, axis=0)
        n_rows = opt.n_rows if opt.n_rows > 0 else opt.n_samples
        rows = [np.concatenate(list(stack[i:i + n_rows]), axis=1)
                for i in range(0, len(stack), n_rows)]
        w = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows]
        save_png(os.path.join(opt.outdir, f"grid-{grid_count:04}.png"),
                 np.concatenate(rows, axis=0))
    print(f"Your samples are ready and waiting for you here: \n{opt.outdir}")
    return opt.outdir


if __name__ == "__main__":
    main(sys.argv[1:])
