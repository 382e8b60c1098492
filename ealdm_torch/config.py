"""Model configurations as Python dicts (the card has no YAML parser).

FLAGSHIP and TINY mirror `bench.py build_model` (tiny=False / tiny=True):
the benchmarked STDiff -> DDIM-50 CFG -> VQ-f8 program. FLAGSHIP has the
shapes of `model.params` in `configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml`.
"""
from __future__ import annotations

import copy

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


def model_kwargs(cfg: dict) -> dict:
    """LatentDiffusion keyword arguments of FLAGSHIP / TINY (a deep copy)."""
    return copy.deepcopy(cfg["model"])
