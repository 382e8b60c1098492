"""The config system (counterpart of `ealdm_tpu/config.py`) and the
port's model configurations as Python dicts.

The config system reads the repo's YAML configs with the port's own reader
(`utils/yaml_subset.py`: the card's machine has no YAML package), merges
them left to right, applies `a.b.c=value` overrides, and builds each
`{target, params}` component through a registry with the JAX package's
keys (the reference's dotted class paths), mapped to the port's classes.
A key whose class is not ported raises NotImplementedError naming its
ROADMAP item.

FLAGSHIP and TINY mirror `bench.py build_model` (tiny=False / tiny=True):
the benchmarked STDiff -> DDIM-50 CFG -> VQ-f8 program. FLAGSHIP has the
shapes of `model.params` in `configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml`.
The unconditional paths, each at its source's full width:
  INPAINT  the latent inpainting model of `scripts/inpaint.py` as
           `scripts/perf/bench_configs.py` `bench_inpaint` builds it (VQ-f4,
           8192 codes; an AttentionBlock UNet with 8 heads);
  UNCOND   `configs/latent-diffusion/uncond_cin-ldm-vq-f8.yaml`;
  PIXEL    `configs/latent-diffusion/uncond_stdiff_cin-ldm-vq-f8.yaml`, the
           128^2 pixel-space DDPM (identity first stage);
  KL_F4    `configs/autoencoder/autoencoder_kl_64x64x3.yaml`, the
           AutoencoderKL alone (`vae_kwargs`).
The text- and class-conditional models, at full width:
  TXT2IMG  `configs/latent-diffusion/txt2img-1p4B-eval.yaml`: the 32-layer
           BERT cond stage, a legacy=False UNet of 320 channels with
           8-head SpatialTransformers, KL-f8 (scale factor 0.18215);
  CIN256   `configs/latent-diffusion/cin256-v2.yaml`: the ClassEmbedder of
           1001 classes (1000 is the null class of guidance), a 1-head
           UNet of 192 channels, VQ-f4.
Two entries of the model zoo (`zoo.py`, the published `models/ldm/*`):
  CHURCHES    `ldm/lsun_churches256`: unconditional, KL-f8, a UNet of 192
              channels with scale-shift norm and ResBlock resampling down
              to 2^2 (32^2 x 4 latents);
  INPAINT_BIG `ldm/inpainting_big`: concat conditioning on the VQ-f4
              (attention-free) encoding of the masked image and the mask
              (7 input channels), ResBlock resampling (64^2 x 3 latents).
Super-resolution (the zoo entry the notebook's superresolution mode runs):
  BSR_SR   `ldm/bsr_sr`: the LR image through an Identity cond stage, joined
           to the latent's channels (6 input channels), a UNet of 160
           channels with 32-wide heads at ds 8, VQ-f4 with its d = 512 mid
           attention; the image side is the input's (64^2 LR -> 256^2).
Training steps of the conditional configs, as FLAGSHIP_TRAIN:
  CIN256_TRAIN, TXT2IMG_TRAIN  their YAML's base_learning_rate and use_ema.
First-stage VAE-GAN training (`main.py`'s `train_autoencoder`), float32 as
`main.py` builds a first stage, 256^2 images, the YAMLs' batch 12:
  VQ_F8_AE_TRAIN  the zoo's `first_stage_models/vq-f8` trainable form
                  (`zoo._fs_train_config`): attention at 32^2, 16,384
                  codes, VQLPIPSWithDiscriminator with disc_start 1;
  KL_F8_AE_TRAIN  read from `configs/autoencoder/autoencoder_kl_32x32x4.yaml`
                  (its model, batch and base rate): mid-block attention
                  only, LPIPSWithDiscriminator with disc_start 50,001.
Retrieval-augmented diffusion:
  RDM768   read from `configs/retrieval-augmented-diffusion/768x768.yaml`
           (`ld_kwargs` of its model.params): a UNet of
           448 channels with 32-wide heads cross-attending to a [query;
           neighbours] context of CLIP ViT-L/14 embeddings (width 768, the
           Identity cond stage: the context comes precomputed, see
           `retrieval.py`), KL-f16 (768^2 images, 48^2 x 16 latents).
"""
from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Dict, Sequence

from . import zoo
from .utils.yaml_subset import YAMLSubsetError, load as _load_yaml, loads as _loads_yaml

_COND = {
    "target": "STDiff.models.UnetCond",
    "params": {
        "mid_dim": 4, "emb_dim": 128, "out_dim": 512, "w_dim": 16,
        "f_dim": 1, "hidden_dim": 1024,
        "cond_args": {
            "type": "fourier", "dims": 6, "lr": 1, "lin_lr": 0.01,
            "f_manual": [1.8398, 672], "include_lin": True,
            "noise": 0, "noise_f": [263.2, 7.79, 0], "noise_f_int": [],
        },
    },
}


def _first_stage(res, zres, ch, nembed):
    return {
        "target": "ldm.models.autoencoder.VQModelInterface",
        "params": {
            "embed_dim": 4, "n_embed": nembed,
            "ddconfig": dict(
                double_z=False, z_channels=4, resolution=res, in_channels=3,
                out_ch=3, ch=ch, ch_mult=[1, 2, 2, 4], num_res_blocks=2,
                attn_resolutions=[zres], dropout=0.0,
            ),
        },
    }


def _model(unet, first_stage):
    return dict(
        unet_config=unet,
        first_stage_config=first_stage,
        cond_stage_config=copy.deepcopy(_COND),
        timesteps=1000,
        linear_start=0.0015,
        linear_end=0.0195,
        conditioning_key="crossattn",
        cond_stage_key="mixed",
        cond_stage_trainable=True,
        unconditional_guidance_scale=2.0,
    )


# 256^2 images, 32^2 x 4 latents (bench.py:155-162)
FLAGSHIP = dict(
    res=256, zres=32,
    model=_model(
        dict(
            image_size=32, in_channels=4, out_channels=4, model_channels=256,
            attention_resolutions=[4, 2, 1], num_res_blocks=2,
            channel_mult=[1, 2, 4], num_head_channels=32,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=512,
        ),
        _first_stage(256, 32, 128, 16384),
    ),
)

# 64^2 images, 8^2 x 4 latents (bench.py:146-153)
TINY = dict(
    res=64, zres=8,
    model=_model(
        dict(
            image_size=8, in_channels=4, out_channels=4, model_channels=64,
            attention_resolutions=[4, 2, 1], num_res_blocks=1,
            channel_mult=[1, 2], num_head_channels=32,
            use_spatial_transformer=True, transformer_depth=1,
            context_dim=512,
        ),
        _first_stage(64, 8, 32, 64),
    ),
)


# `bench.py --train`'s training step on FLAGSHIP (bench.py:59-80, :336-347):
# flash attention and native LayerNorm statistics
# (enable_inference_optimizations), bfloat16 compute on float32 parameters,
# AdamW at 1e-5 with the first stage masked out, EMA decay 0.9999, remat
# "dots"
FLAGSHIP_TRAIN = dict(batch_size=24, dtype="bfloat16", learning_rate=1e-5,
                      ema_decay=0.9999, remat="dots")


# the VQ-f4 first stage of INPAINT (bench_configs.py:300-304)
_VQ_F4 = {
    "target": "ldm.models.autoencoder.VQModelInterface",
    "params": {
        "embed_dim": 3, "n_embed": 8192,
        "ddconfig": dict(
            double_z=False, z_channels=3, resolution=256, in_channels=3, out_ch=3,
            ch=128, ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[],
            dropout=0.0,
        ),
    },
}

# 256^2 images, 64^2 x 3 latents (bench_configs.py:288-312)
INPAINT = dict(
    res=256, zres=64, zch=3,
    model=dict(
        unet_config=dict(
            image_size=64, in_channels=3, out_channels=3, model_channels=128,
            attention_resolutions=[8, 4, 2], num_res_blocks=2,
            channel_mult=[1, 2, 3, 4], num_heads=8,
        ),
        first_stage_config=_VQ_F4,
        cond_stage_config="__is_unconditional__",
        timesteps=1000, linear_start=0.0015, linear_end=0.0205,
    ),
)

# 256^2 images, 32^2 x 4 latents (uncond_cin-ldm-vq-f8.yaml model.params)
UNCOND = dict(
    res=256, zres=32, zch=4,
    model=dict(
        unet_config=dict(
            image_size=32, in_channels=4, out_channels=4, model_channels=256,
            attention_resolutions=[4, 2, 1], num_res_blocks=2,
            channel_mult=[1, 2, 4], num_head_channels=32,
        ),
        first_stage_config=_first_stage(256, 32, 128, 16384),
        cond_stage_config="__is_unconditional__",
        timesteps=1000, linear_start=0.0015, linear_end=0.0195,
        num_timesteps_cond=1, first_stage_key="img",
    ),
)

# 128^2 x 3 pixels (uncond_stdiff_cin-ldm-vq-f8.yaml model.params)
PIXEL = dict(
    res=128, zres=128, zch=3,
    model=dict(
        unet_config=dict(
            image_size=128, in_channels=3, out_channels=3, model_channels=224,
            attention_resolutions=[8, 4, 2], num_res_blocks=2,
            channel_mult=[1, 2, 3, 4], num_head_channels=32,
        ),
        first_stage_config={"target": "STDiff.models.IdentityAutoEncoder"},
        cond_stage_config="__is_unconditional__",
        timesteps=1000, linear_start=0.0015, linear_end=0.0195,
        num_timesteps_cond=1, first_stage_key="img",
    ),
)

# 256^2 images, 64^2 x 3 latents (autoencoder_kl_64x64x3.yaml model.params,
# without the loss)
KL_F4 = dict(
    res=256, zres=64, zch=3,
    vae=dict(
        embed_dim=3,
        ddconfig=dict(
            double_z=True, z_channels=3, resolution=256, in_channels=3, out_ch=3,
            ch=128, ch_mult=[1, 2, 4], num_res_blocks=2, attn_resolutions=[],
            dropout=0.0,
        ),
    ),
)


# 256^2 images, 32^2 x 4 latents (txt2img-1p4B-eval.yaml model.params, the
# keys the JAX package's model_from_config passes on, without the loss)
TXT2IMG = dict(
    res=256, zres=32, zch=4,
    model=dict(
        unet_config=dict(
            image_size=32, in_channels=4, out_channels=4, model_channels=320,
            attention_resolutions=[4, 2, 1], num_res_blocks=2, channel_mult=[1, 2, 4, 4],
            num_heads=8, use_spatial_transformer=True, transformer_depth=1,
            context_dim=1280, use_checkpoint=True, legacy=False,
        ),
        first_stage_config={
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {
                "embed_dim": 4,
                "ddconfig": dict(
                    double_z=True, z_channels=4, resolution=256, in_channels=3, out_ch=3,
                    ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[],
                    dropout=0.0,
                ),
            },
        },
        cond_stage_config={
            "target": "ldm.modules.encoders.modules.BERTEmbedder",
            "params": {"n_embed": 1280, "n_layer": 32},
        },
        timesteps=1000, linear_start=0.00085, linear_end=0.012,
        first_stage_key="image", cond_stage_key="caption", cond_stage_trainable=True,
        conditioning_key="crossattn", scale_factor=0.18215,
    ),
)

# 256^2 images, 64^2 x 3 latents (cin256-v2.yaml model.params, as TXT2IMG)
CIN256 = dict(
    res=256, zres=64, zch=3,
    model=dict(
        unet_config=dict(
            image_size=64, in_channels=3, out_channels=3, model_channels=192,
            attention_resolutions=[8, 4, 2], num_res_blocks=2, channel_mult=[1, 2, 3, 5],
            num_heads=1, use_spatial_transformer=True, transformer_depth=1,
            context_dim=512,
        ),
        first_stage_config=_VQ_F4,
        cond_stage_config={
            "target": "ldm.modules.encoders.modules.ClassEmbedder",
            "params": {"n_classes": 1001, "embed_dim": 512, "key": "class_label"},
        },
        timesteps=1000, linear_start=0.0015, linear_end=0.0195,
        first_stage_key="image", cond_stage_key="class_label", cond_stage_trainable=True,
        conditioning_key="crossattn",
    ),
)


# the conditional configs' train steps (cin256-v2.yaml, txt2img-1p4B-eval.yaml:
# base_learning_rate, use_ema false), with FLAGSHIP_TRAIN's bfloat16 compute
# and remat; the batch a card holds with room to spare
CIN256_TRAIN = dict(batch_size=8, dtype="bfloat16", learning_rate=1e-4, use_ema=False,
                    remat="dots")
TXT2IMG_TRAIN = dict(batch_size=8, dtype="bfloat16", learning_rate=5e-5, use_ema=False,
                     remat="dots")


# 256^2 images through the zoo's own keyword arguments
CHURCHES = dict(res=256, zres=32, zch=4, zoo="ldm/lsun_churches256",
                model=zoo.model_kwargs("ldm/lsun_churches256"))
INPAINT_BIG = dict(res=256, zres=64, zch=3, zoo="ldm/inpainting_big",
                   model=zoo.model_kwargs("ldm/inpainting_big"))
# 64^2 LR -> 256^2 images, 64^2 x 3 latents (the notebook's example); the
# model takes any side a multiple of 8 latents
BSR_SR = dict(res=256, zres=64, zch=3, zoo="ldm/bsr_sr", model=zoo.model_kwargs("ldm/bsr_sr"))


# the learning rate main.py gives one device (scale_lr): accumulate 1 x 1
# device x batch 12 x base_learning_rate 4.5e-6 (train_autoencoder's default
# where a config has none, as the zoo's)
_AE_BATCH = 12
_AE_LR = 1 * 1 * _AE_BATCH * 4.5e-6
VQ_F8_AE_TRAIN = dict(res=256, batch_size=_AE_BATCH, dtype="float32", learning_rate=_AE_LR,
                      lr_g_factor=1.0, model=zoo._fs_train_config("vq-f8"))
def model_kwargs(cfg: dict) -> dict:
    """LatentDiffusion keyword arguments of a configuration above (a deep
    copy)."""
    return copy.deepcopy(cfg["model"])


def vae_kwargs(cfg: dict) -> dict:
    """AutoencoderKL keyword arguments of KL_F4 (a deep copy)."""
    return copy.deepcopy(cfg["vae"])


# ------------------------------------------------------------ config system
def deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str) -> Any:
    """A dotlist value as YAML, then a string that reads as a float as that
    float (YAML 1.1 reads `5e-4` as a string); text that is not YAML stays
    as it is."""
    try:
        v = _loads_yaml(s)
    except YAMLSubsetError:
        return s
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def apply_dotlist(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Apply `a.b.c=value` overrides (the reference CLI's trailing args)."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


def load_config(paths: Sequence[str], overrides: Sequence[str] = ()) -> Dict:
    """The YAML files at `paths` merged left to right, then `overrides`."""
    cfg: Dict = {}
    for p in paths:
        cfg = deep_merge(cfg, _load_yaml(p) or {})
    return apply_dotlist(cfg, overrides)


class NotPorted:
    """A registry entry whose class the port does not have yet
    (`resolve_target` raises naming its ROADMAP item)."""

    def __init__(self, what: str, item: str):
        self.what, self.item = what, item


_SR_ITEM = "ROADMAP queue 1 item 9 (the JPEG data paths)"
_IMAGE_SR = NotPorted("ImageSRDataset (JPEG re-encoding; no JPEG codec on the card)", _SR_ITEM)
_LAYOUT = NotPorted("SyntheticLayoutDataset", _SR_ITEM)
_THIRD_STAGE = NotPorted("ThirdStageDataset", "ROADMAP queue 1 item 6 (the third stage)")

# the reference's dotted path -> "module:attr" in this package (the keys of
# `ealdm_tpu/config.py` _REGISTRY)
_REGISTRY = {
    # diffusion models
    "ldm.models.diffusion.ddpm.LatentDiffusion": "ealdm_torch.models.ddpm:LatentDiffusion",
    "ldm.models.diffusion.ddpm.DDPM": "ealdm_torch.models.ddpm:DDPM",
    "ldm.models.diffusion.ddpm.Layout2ImgDiffusion": "ealdm_torch.models.ddpm:Layout2ImgDiffusion",
    # first stages
    "ldm.models.autoencoder.VQModelInterface": "ealdm_torch.models.vae:VQModel",
    "ldm.models.autoencoder.VQModel": "ealdm_torch.models.vae:VQModel",
    "ldm.models.autoencoder.AutoencoderKL": "ealdm_torch.models.vae:AutoencoderKL",
    "ldm.models.autoencoder.IdentityFirstStage": "ealdm_torch.models.vae:IdentityFirstStage",
    "STDiff.models.IdentityAutoEncoder": "ealdm_torch.models.vae:IdentityFirstStage",
    # denoiser
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": "ealdm_torch.models.unet:UNetModel",
    # conditioning
    "STDiff.models.UnetCond": "ealdm_torch.models.stdiff:UnetCond",
    "ldm.modules.encoders.modules.ClassEmbedder": "ealdm_torch.models.encoders:ClassEmbedder",
    "ldm.modules.encoders.modules.BERTEmbedder": "ealdm_torch.models.encoders:BERTEmbedder",
    "ldm.modules.encoders.modules.TransformerEmbedder":
        "ealdm_torch.models.encoders:TransformerEmbedder",
    "ldm.modules.encoders.modules.SpatialRescaler": "ealdm_torch.models.encoders:SpatialRescaler",
    "ldm.modules.encoders.modules.FrozenCLIPTextEmbedder":
        "ealdm_torch.models.encoders:FrozenCLIPTextEmbedder",
    "ldm.modules.encoders.modules.FrozenClipImageEmbedder":
        "ealdm_torch.models.encoders:FrozenClipImageEmbedder",
    # schedulers
    "ldm.lr_scheduler.LambdaLinearScheduler": "ealdm_torch.training.lr_scheduler:build_scheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler":
        "ealdm_torch.training.lr_scheduler:build_scheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2":
        "ealdm_torch.training.lr_scheduler:build_scheduler",
    # losses
    "ldm.modules.losses.LPIPSWithDiscriminator":
        "ealdm_torch.losses.contperceptual:LPIPSWithDiscriminator",
    "ldm.modules.losses.contperceptual.LPIPSWithDiscriminator":
        "ealdm_torch.losses.contperceptual:LPIPSWithDiscriminator",
    "taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        "ealdm_torch.losses.vqperceptual:VQLPIPSWithDiscriminator",
    "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator":
        "ealdm_torch.losses.vqperceptual:VQLPIPSWithDiscriminator",
    "torch.nn.Identity": "ealdm_torch.config:_identity",
    # data layer
    "main.DataModuleFromConfig": "ealdm_torch.data.pipeline:DataModule",
    "STDiff.dataset_wlbl.ImageNetVidDataset": "ealdm_torch.data.stdiff:StreamCameraDataset",
    "STDiff.dataset.ImageNetVidDataset": "ealdm_torch.data.stdiff:StreamCameraDataset",
    "STDiff.third_stage_dataset.ThirdStageDataset": _THIRD_STAGE,
    "ldm.data.lsun.LSUNChurchesTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.lsun.LSUNChurchesValidation": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.lsun.LSUNBedroomsTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.lsun.LSUNBedroomsValidation": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.lsun.LSUNCatsTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.lsun.LSUNCatsValidation": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.imagenet.ImageNetSRTrain": _IMAGE_SR,
    "ldm.data.imagenet.ImageNetSRValidation": _IMAGE_SR,
    "ldm.data.imagenet.ImageNetTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "ldm.data.imagenet.ImageNetValidation": "ealdm_torch.data.images:ImageFolderDataset",
    "taming.data.faceshq.CelebAHQTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "taming.data.faceshq.CelebAHQValidation": "ealdm_torch.data.images:ImageFolderDataset",
    "taming.data.faceshq.FFHQTrain": "ealdm_torch.data.images:ImageFolderDataset",
    "taming.data.faceshq.FFHQValidation": "ealdm_torch.data.images:ImageFolderDataset",
    # layout-to-image
    "ldm.data.openimages.OpenImagesBBoxTrain": _LAYOUT,
    "ldm.data.openimages.OpenImagesBBoxValidation": _LAYOUT,
}


def _identity(*args, **kwargs):
    return None


def resolve_target(target: str):
    """A reference or native dotted path (`pkg.mod.Attr` or `pkg.mod:Attr`;
    the JAX package's own paths read as the port's) as a class or callable;
    NotImplementedError for a registered class that is not ported."""
    entry = _REGISTRY.get(target)
    if isinstance(entry, NotPorted):
        raise NotImplementedError(f"{target}: {entry.what} is not ported yet ({entry.item})")
    if entry is not None:
        target = entry
    if target.startswith("ealdm_tpu."):
        target = "ealdm_torch." + target[len("ealdm_tpu."):]
    if ":" in target:
        module, attr = target.split(":")
    else:
        module, _, attr = target.rpartition(".")
    try:
        return getattr(importlib.import_module(module), attr)
    except (ImportError, AttributeError, ValueError) as e:
        raise ValueError(f"cannot resolve target '{target}'") from e


def get_obj_from_str(string: str):
    """Reference-API alias for resolve_target."""
    return resolve_target(string)


def instantiate_from_config(config: Dict, **extra):
    """The object described by {target, params} (reference semantics); the
    sentinel strings come back as they are."""
    if config in ("__is_first_stage__", "__is_unconditional__"):
        return config
    if "target" not in config:
        raise KeyError("expected a 'target' key in config")
    cls = resolve_target(config["target"])
    params = dict(config.get("params", {}))
    params.update(extra)
    return cls(**params)


_LD_KEYS = {
    "timesteps", "beta_schedule", "linear_start", "linear_end", "cosine_s",
    "v_posterior", "parameterization", "loss_type", "conditioning_key",
    "first_stage_key", "cond_stage_key", "cond_stage_trainable", "scale_factor",
    "learn_logvar", "logvar_init", "l_simple_weight", "original_elbo_weight",
    "split_input_params",
}


def ld_kwargs(params: Dict) -> Dict:
    """The model keyword arguments of a config's `model.params`: the
    `_LD_KEYS` it sets, the UNet's params, the two stages' configs."""
    kwargs: Dict[str, Any] = {k: params[k] for k in _LD_KEYS if k in params}
    if kwargs.pop("v_posterior", 0.0):
        raise NotImplementedError("v_posterior != 0 is not ported (no configuration sets it)")
    kwargs["unet_config"] = dict(params["unet_config"].get("params", {}))
    for key in ("first_stage_config", "cond_stage_config"):
        if key in params:
            c = params[key]
            kwargs[key] = c if isinstance(c, str) else dict(c)
    return kwargs


def model_from_config(model_cfg: Dict, dtype=None, device=None):
    """(model, base_learning_rate) of `config.model`: the LatentDiffusion,
    DDPM or Layout2ImgDiffusion of its target, built on `device` ("cuda"
    unless given; "meta" allocates nothing) with the port's zero
    initialisers (`utils.init.random_init_` draws seeded weights). Keys
    outside `_LD_KEYS` (monitor, image_size, num_timesteps_cond, ...) are
    accepted and ignored, as the JAX package's `model_from_config` does."""
    import torch

    from .models.ddpm import DDPM, LatentDiffusion, Layout2ImgDiffusion

    params = dict(model_cfg.get("params", {}))
    base_lr = model_cfg.get("base_learning_rate", 1e-6)
    target = model_cfg.get("target", "ldm.models.diffusion.ddpm.LatentDiffusion")

    kwargs = ld_kwargs(params)
    kwargs["dtype"] = torch.float32 if dtype is None else dtype

    if target.endswith("Layout2ImgDiffusion"):
        cls = Layout2ImgDiffusion
    elif target.endswith("LatentDiffusion"):
        cls = LatentDiffusion
    else:
        cls = DDPM
    return cls(**kwargs, device=device), base_lr


# ---------------------------------------------- configurations from the YAMLs
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KL_F8_YAML = load_config([os.path.join(_REPO, "configs/autoencoder/autoencoder_kl_32x32x4.yaml")])
_KL_F8_BATCH = _KL_F8_YAML["data"]["params"]["batch_size"]
# the model as the YAML gives it; the learning rate main.py gives one device
KL_F8_AE_TRAIN = dict(
    res=256, batch_size=_KL_F8_BATCH, dtype="float32",
    learning_rate=1 * 1 * _KL_F8_BATCH * _KL_F8_YAML["model"]["base_learning_rate"],
    lr_g_factor=1.0,
    model={k: v for k, v in _KL_F8_YAML["model"].items() if k != "base_learning_rate"})

# 768^2 images, 48^2 x 16 latents: the model keyword arguments of the YAML's
# model.params
RDM768 = dict(
    res=768, zres=48, zch=16, clip="ViT-L/14",
    model=ld_kwargs(load_config([os.path.join(
        _REPO, "configs/retrieval-augmented-diffusion/768x768.yaml")])["model"]["params"]))
