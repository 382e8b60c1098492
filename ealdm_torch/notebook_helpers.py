"""Notebook helpers (counterpart of the root `notebook_helpers.py`): model
selection (the zoo, the flagship's YAML, a run directory), the
conditioning examples, the convolutional sampling workflow of the
super-resolution and class-conditional modes, and the PNG helpers.

    model = notebook_helpers.get_model("superresolution", dtype=torch.bfloat16)
    logs = notebook_helpers.run(model, "data/example_conditioning/superresolution/sample_0.png")
    notebook_helpers.visualize(logs["sample"], "sample.png")

Models come from `ealdm_torch.zoo` or `config.model_from_config` with
seeded random weights, or from a run's checkpoint (its EMA weights). A
conditioning image is a PNG (read by `utils/png.py`: the card has no
imaging package), an [H, W, 3] uint8 array, or a `.npz` of one.
`visualize_cond_img` returns the image as an array (the JAX package
returns a PIL image). `run` switches split-input patching on for inputs of
128 px and more, with the reference's 128 / 64 crop grid.
"""
from __future__ import annotations

import glob
import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .inference import make_eps_fn
from .models.encoders import resize_nhwc
from .models.vae import VQModel
from .ops.patching import DEFAULT_SPLIT_PARAMS
from .ops.schedules import DDIMSchedule, DiffusionSchedule
from .samplers.ddim import DDIMConfig, ddim_sample
from .utils.device import resolve_device
from .utils.init import random_init_
from .utils.png import load_png, to_rgb

# mode -> zoo entry
MODEL_ZOO = {
    "superresolution": "ldm/bsr_sr",
    "class_conditional": "ldm/cin256",
    "stdiff": None,  # the flagship's YAML config
}
_STDIFF_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "latent-diffusion", "stdiff_cin-ldm-vq-f8.yaml")


def get_model(mode: str = "stdiff", run_dir: Optional[str] = None,
              zoo_name: Optional[str] = None, *, seed: int = 0, dtype=torch.float32,
              device=None):
    """The model of `mode`, in eval mode on `device` ("cuda" unless given;
    "meta" allocates no weights): the zoo entry (or `zoo_name`), or for
    "stdiff" the flagship's YAML (`configs/latent-diffusion/
    stdiff_cin-ldm-vq-f8.yaml`) through `config.model_from_config`, with
    seeded random weights (`utils.init.random_init_`). With `run_dir` (a
    run of `ealdm_torch.main`), the model of the run's own configs/*.yaml
    with the EMA weights of its last checkpoint (its parameters where it
    kept no EMA); the JAX package builds the mode's model for the run."""
    from . import zoo
    from .config import load_config, model_from_config

    if run_dir:
        cfgs = sorted(glob.glob(os.path.join(run_dir, "configs", "*.yaml")))
        model, _ = model_from_config(load_config(cfgs)["model"], dtype=dtype, device=device)
    elif mode == "stdiff" and zoo_name is None:
        model, _ = model_from_config(load_config([_STDIFF_CFG])["model"], dtype=dtype,
                                     device=device)
    else:
        model = zoo.build(zoo_name or MODEL_ZOO[mode], dtype=dtype, device=device)
    model.eval()
    if next(model.parameters()).is_meta:
        return model
    random_init_(model, seed)
    if run_dir:
        from .training import CheckpointManager, init_train_state

        state, _ = init_train_state(model, device=next(model.parameters()).device)
        CheckpointManager(os.path.join(run_dir, "checkpoints"), monitor=None).restore_last(
            state, model)
        if state.ema is not None:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(state.ema.shadow[k])
    return model


def _load_image(value) -> np.ndarray:
    """An [H, W, 3] uint8 array, the one array of a `.npz` file, or a PNG
    file (converted as PIL's convert("RGB"))."""
    if isinstance(value, (str, os.PathLike)):
        if str(value).lower().endswith(".png"):
            return to_rgb(load_png(str(value)))
        if not str(value).endswith(".npz"):
            raise ValueError(f"{value}: give a PNG, an [H, W, 3] uint8 array or a .npz of one "
                             "(no other image decoder on the card)")
        with np.load(value) as arrays:
            if len(arrays.files) != 1:
                raise ValueError(f"{value} holds {arrays.files}, not one image")
            value = arrays[arrays.files[0]]
    arr = np.asarray(value)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"an [H, W, 3] uint8 image, not {arr.dtype} {arr.shape}")
    return arr


def get_cond(mode: str, selected_path_or_value, device=None) -> Dict[str, Any]:
    """The conditioning example on `device` ("cuda" unless given).

    superresolution: an image (a PNG path, see `_load_image`) -> {"LR_image": [1, H, W,
    3] in [-1, 1], "image": its 4x bilinear upsample (`resize_nhwc`, JAX's
    `jax.image.resize`) in [-1, 1]}. class_conditional: a class id ->
    {"class_label": [1] int64}."""
    dev = resolve_device(device)
    if mode == "superresolution":
        up_f = 4
        c = torch.from_numpy(_load_image(selected_path_or_value)).to(dev).float() / 255.0
        h, w, _ = c.shape
        c_up = resize_nhwc(c[None], (up_f * h, up_f * w), "bilinear")
        return {"LR_image": 2.0 * c[None] - 1.0, "image": 2.0 * c_up - 1.0}
    if mode == "class_conditional":
        return {"class_label": torch.tensor([int(selected_path_or_value)], device=dev)}
    raise NotImplementedError(f"cond not implemented for mode {mode}")


@torch.no_grad()
def make_convolutional_sample(example: Dict[str, Any], model, custom_steps: int = 50,
                              eta: float = 1.0, quantize_x0: bool = False,
                              custom_shape=None, temperature: float = 1.0, x_T=None,
                              seed: int = 0, make_progrow: bool = True,
                              noise_fn=None) -> Dict[str, Any]:
    """Encode the example's image, condition on `example[cond_stage_key]`,
    DDIM-sample at the latent's shape (or `custom_shape`) and decode: a log
    of tensors {input, reconstruction, original_conditioning, sample,
    progressive_row (every (S // 4)-th step's latent), time (seconds of the
    sampler, ending in a synchronize on the card), and for a VQ first stage
    sample_noquant and sample_diff}. Draws (a KL posterior, x_T unless
    given, the step noise unless `noise_fn` gives it; see `ddim_sample`)
    come from a generator on the model's device seeded with `seed`."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    log: Dict[str, Any] = {}
    x = example.get("image", example.get("img"))
    if x is not None:
        z = model.get_first_stage_encoding(model.encode_first_stage(x, g))
        log["input"] = x
        log["reconstruction"] = model.decode_first_stage(z)
    elif custom_shape is None:
        raise ValueError("an example without an image needs custom_shape")
    c = None
    if model.conditioning_key is not None:
        xc = example[model.cond_stage_key]
        c = model.get_learned_conditioning(xc)
        log["original_conditioning"] = xc
    shape = tuple(custom_shape) if custom_shape is not None else tuple(z.shape)
    sched = DiffusionSchedule.create(
        timesteps=model.timesteps, beta_schedule=model.beta_schedule,
        linear_start=model.linear_start, linear_end=model.linear_end,
        cosine_s=model.cosine_s, device=dev)
    ddim = DDIMSchedule.create(sched, custom_steps, eta=eta)
    cfg = DDIMConfig(num_steps=custom_steps, eta=eta, temperature=temperature,
                     quantize_x0=quantize_x0, parameterization=model.parameterization)
    t0 = time.perf_counter()
    sample = ddim_sample(make_eps_fn(model), shape, ddim, cfg, cond=c, x_T=x_T, generator=g,
                         noise_fn=noise_fn, return_intermediates=make_progrow)
    if make_progrow:
        sample, (x_inter, _) = sample
        log["progressive_row"] = x_inter[::max(1, len(x_inter) // 4)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log["time"] = time.perf_counter() - t0
    log["sample"] = model.decode_first_stage(sample)
    if isinstance(model.first_stage_model, VQModel):
        log["sample_noquant"] = model.decode_first_stage(sample, force_not_quantize=True)
        log["sample_diff"] = (log["sample_noquant"] - log["sample"]).abs()
    return log


def run(model, selected_path_or_value, task: str = "superresolution",
        custom_steps: int = 50, resize_enabled: bool = False, **sample_kw):
    """Build the example of `task` on the model's device and draw a
    convolutional sample; an image input of 128 px and more runs with
    split-input patching (`DEFAULT_SPLIT_PARAMS`: 128^2 crops, stride 64,
    on the image for the encode and on the latent for the denoiser and the
    decode) on a `clone` of the model. `sample_kw` go to
    `make_convolutional_sample` (eta, seed, x_T, noise_fn, ...).
    `resize_enabled` is accepted and unused, as in the reference."""
    dev = next(model.parameters()).device
    example = get_cond(task, selected_path_or_value, device=dev)
    m, custom_shape = model, None
    x = example.get("image")
    if x is not None and x.shape[1] >= 128 and x.shape[2] >= 128:
        m = model.clone(split_input_params=dict(DEFAULT_SPLIT_PARAMS))
    if x is None:
        u = model.unet_config
        custom_shape = (1, u["image_size"], u["image_size"], u["in_channels"])
    return make_convolutional_sample(example, m, custom_steps=custom_steps,
                                     custom_shape=custom_shape, **sample_kw)


def visualize(images, path: str = "notebook_sample.png"):
    """[N, H, W, C] images in [-1, 1] as one PNG grid at `path`; returns the
    path."""
    from .training.callbacks import save_png, to_uint8_grid

    save_png(path, to_uint8_grid(images))
    return path


def visualize_cond_img(path: str) -> np.ndarray:
    """A conditioning image for display: the PNG's pixels as uint8 (the JAX
    package returns a PIL image; the card has no imaging package)."""
    return load_png(path)


def get_cond_options(mode: str, root: str = "data/example_conditioning"):
    """The bundled conditioning examples of a task: (its folder, sorted
    file names)."""
    path = os.path.join(root, mode)
    return path, sorted(os.listdir(path))


def select_cond_path(mode: str, index: int = 0, name: Optional[str] = None,
                     root: str = "data/example_conditioning"):
    """A conditioning example's path, by name or index."""
    path, files = get_cond_options(mode, root)
    chosen = name if name is not None else files[index]
    if chosen not in files:
        raise ValueError(f"{chosen!r} is not among {files}")
    return os.path.join(path, chosen)


def get_custom_cond(mode: str, source_path_or_text, root: str = "data/example_conditioning"):
    """Install a custom conditioning example under root/mode and return its
    path: a prompt for "text_conditional" (written to a file named after
    it), else a copy of the file."""
    dest = os.path.join(root, mode)
    os.makedirs(dest, exist_ok=True)
    if mode == "text_conditional":
        text = str(source_path_or_text)
        slug = re.sub(r"[^A-Za-z0-9_-]", "_", text[:20])  # path-safe
        out = os.path.join(dest, f"custom_{slug}.txt")
        with open(out, "w") as f:
            f.write(text)
        return out
    out = os.path.join(dest, f"custom_{os.path.basename(str(source_path_or_text))}")
    shutil.copyfile(source_path_or_text, out)
    return out
