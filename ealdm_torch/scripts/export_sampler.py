"""Export a trained run's conditional sampling program as a serving
artifact (counterpart of `scripts/export_sampler.py`):

    python -m ealdm_torch.scripts.export_sampler -r <logdir> -o sampler.pt2x
        [--batch_size 8] [--steps 50] [--eta 1.0] [--scale 2.0] [--streams 1]
        [--device cuda]

Restores the run's last checkpoint (EMA shadow) as `sample_diffusion`
does, `torch.export`s the conditioning, DDIM-step and decode programs on
`--device` (`serving.export_sampler`) and writes them behind the JSON
header. A process that imports only torch and the kernel operator registry
serves the file (`serving.load_exported`, `SamplerService`) on the same
device type. `--device` replaces the JAX script's `--platform`: a program
is traced on the card it will run on.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ._common import (add_device_args, inference_settings, load_run, read_checkpoint, resolve,
                      sampling_model)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-r", "--resume", required=True,
                   help="logdir or checkpoint dir of a trained run")
    p.add_argument("-o", "--out", required=True, help="artifact output path")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--scale", type=float, default=2.0, help="classifier-free guidance scale")
    p.add_argument("--streams", type=int, default=1,
                   help="independent denoiser chains per step")
    return add_device_args(p)


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns (path, export seconds)."""
    from ..serving import export_sampler, save_exported

    opt = get_parser().parse_args(argv)
    dev = resolve(opt)
    config, ckpt_dir, _ = load_run(opt.resume)
    mp = config["model"]["params"]
    res = mp["first_stage_config"]["params"]["ddconfig"]["resolution"]
    zres = mp["unet_config"]["params"]["image_size"]
    zch = mp["unet_config"]["params"]["in_channels"]
    with inference_settings():
        model = sampling_model(config["model"], dev, read_checkpoint(ckpt_dir, last=True))
        t0 = time.perf_counter()
        programs, meta = export_sampler(model, batch_size=opt.batch_size,
                                        latent_shape=(zres, zres, zch), steps=opt.steps,
                                        eta=opt.eta, guidance_scale=opt.scale,
                                        streams=opt.streams, image_size=res)
        seconds = time.perf_counter() - t0
    save_exported(programs, opt.out, dev, meta=meta)
    size = os.path.getsize(opt.out)
    print(f"Exported {opt.steps}-step sampler (batch {opt.batch_size}, {res}^2) -> {opt.out} "
          f"({size / 1e6:.1f} MB) in {seconds:.1f} s")
    return opt.out, seconds


if __name__ == "__main__":
    main(sys.argv[1:])
