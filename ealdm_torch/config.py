"""Model configurations as Python dicts (the card has no YAML parser).

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
  KL_F8_AE_TRAIN  `configs/autoencoder/autoencoder_kl_32x32x4.yaml`:
                  mid-block attention only, LPIPSWithDiscriminator with
                  disc_start 50,001.
Retrieval-augmented diffusion:
  RDM768   `configs/retrieval-augmented-diffusion/768x768.yaml`: a UNet of
           448 channels with 32-wide heads cross-attending to a [query;
           neighbours] context of CLIP ViT-L/14 embeddings (width 768, the
           Identity cond stage: the context comes precomputed, see
           `retrieval.py`), KL-f16 (768^2 images, 48^2 x 16 latents).
"""
from __future__ import annotations

import copy

from . import zoo

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
# device x batch 12 x base_learning_rate 4.5e-6 (the KL YAML's, and
# train_autoencoder's default where a config has none, as the zoo's)
_AE_BATCH = 12
_AE_LR = 1 * 1 * _AE_BATCH * 4.5e-6
VQ_F8_AE_TRAIN = dict(res=256, batch_size=_AE_BATCH, dtype="float32", learning_rate=_AE_LR,
                      lr_g_factor=1.0, model=zoo._fs_train_config("vq-f8"))
KL_F8_AE_TRAIN = dict(
    res=256, batch_size=_AE_BATCH, dtype="float32", learning_rate=_AE_LR, lr_g_factor=1.0,
    model={
        "target": "ldm.models.autoencoder.AutoencoderKL",
        "params": {
            "monitor": "val/rec_loss",
            "embed_dim": 4,
            "lossconfig": {
                "target": "ldm.modules.losses.LPIPSWithDiscriminator",
                "params": {"disc_start": 50001, "kl_weight": 0.000001, "disc_weight": 0.5},
            },
            "ddconfig": dict(
                double_z=True, z_channels=4, resolution=256, in_channels=3, out_ch=3, ch=128,
                ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[], dropout=0.0,
            ),
        },
    },
)


# 768^2 images, 48^2 x 16 latents (768x768.yaml model.params, as TXT2IMG)
RDM768 = dict(
    res=768, zres=48, zch=16, clip="ViT-L/14",
    model=dict(
        unet_config=dict(
            image_size=48, in_channels=16, out_channels=16, model_channels=448,
            attention_resolutions=[4, 2, 1], num_res_blocks=2, channel_mult=[1, 2, 3, 4],
            use_scale_shift_norm=False, resblock_updown=False, num_head_channels=32,
            use_spatial_transformer=True, transformer_depth=1, context_dim=768,
            use_checkpoint=True,
        ),
        first_stage_config={
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {
                "embed_dim": 16,
                "ddconfig": dict(
                    double_z=True, z_channels=16, resolution=256, in_channels=3, out_ch=3,
                    ch=128, ch_mult=[1, 1, 2, 2, 4], num_res_blocks=2, attn_resolutions=[16],
                    dropout=0.0,
                ),
            },
        },
        cond_stage_config={"target": "torch.nn.Identity"},
        timesteps=1000, linear_start=0.0015, linear_end=0.015,
        first_stage_key="jpg", cond_stage_key="nix", cond_stage_trainable=False,
        conditioning_key="crossattn", scale_factor=0.22765929,
    ),
)


def model_kwargs(cfg: dict) -> dict:
    """LatentDiffusion keyword arguments of a configuration above (a deep
    copy)."""
    return copy.deepcopy(cfg["model"])


def vae_kwargs(cfg: dict) -> dict:
    """AutoencoderKL keyword arguments of KL_F4 (a deep copy)."""
    return copy.deepcopy(cfg["vae"])
