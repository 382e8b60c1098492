"""The LDM model zoo (counterpart of `ealdm_tpu/zoo.py`): the architectures
of the published first-stage models and LDMs (`models/first_stage_models/*`
and `models/ldm/*/config.yaml` of CompVis latent-diffusion), buildable with
random weights or weights carried through `utils/flax_import.py`.

    model = zoo.build("ldm/lsun_churches256", dtype=torch.bfloat16)  # on "cuda"
    vae = zoo.build("first_stage_models/vq-f4-noattn", device="cpu")
    cfg = zoo.spec("ldm/inpainting_big")                              # a copy of the dict

The tables are this package's own copy of the JAX package's (plain data,
held equal by the tests).
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from .utils.device import resolve_device

# ---------------------------------------------------------------- first stages
_DD = dict(resolution=256, in_channels=3, out_ch=3, ch=128, dropout=0.0)


def _dd(z, mult, attn, double_z, nrb=2):
    return dict(_DD, z_channels=z, ch_mult=list(mult), attn_resolutions=list(attn),
                num_res_blocks=nrb, double_z=double_z)


# Per-entry GAN loss hyperparameters of the reference's standalone training
# stubs (`models/first_stage_models/*/config.yaml`): kl-* use
# LPIPSWithDiscriminator, vq-* use VQLPIPSWithDiscriminator with varying
# disc_start/disc_weight/disc_num_layers.
_KL_LOSS = dict(disc_start=50001, kl_weight=1.0e-6, disc_weight=0.5)


def _vq_loss(disc_start, disc_weight=0.75, **kw):
    return dict(disc_conditional=False, disc_in_channels=3,
                disc_start=disc_start, disc_weight=disc_weight,
                codebook_weight=1.0, **kw)


FIRST_STAGES: Dict[str, Dict[str, Any]] = {
    "kl-f4": dict(kind="kl", embed_dim=3, ddconfig=_dd(3, (1, 2, 4), (), True),
                  loss=dict(_KL_LOSS)),
    "kl-f8": dict(kind="kl", embed_dim=4, ddconfig=_dd(4, (1, 2, 4, 4), (), True),
                  loss=dict(_KL_LOSS)),
    "kl-f16": dict(kind="kl", embed_dim=16, ddconfig=_dd(16, (1, 1, 2, 2, 4), (16,), True),
                   loss=dict(_KL_LOSS)),
    "kl-f32": dict(kind="kl", embed_dim=64, ddconfig=_dd(64, (1, 1, 2, 2, 4, 4), (16, 8), True),
                   loss=dict(_KL_LOSS)),
    "vq-f4": dict(kind="vq", embed_dim=3, n_embed=8192, ddconfig=_dd(3, (1, 2, 4), (), False),
                  loss=_vq_loss(0)),
    "vq-f4-noattn": dict(kind="vq", embed_dim=3, n_embed=8192,
                         ddconfig=dict(_dd(3, (1, 2, 4), (), False), attn_type="none"),
                         loss=_vq_loss(11)),
    "vq-f8": dict(kind="vq", embed_dim=4, n_embed=16384, ddconfig=_dd(4, (1, 2, 2, 4), (32,), False),
                  loss=_vq_loss(1, disc_weight=0.6, disc_num_layers=2)),
    "vq-f8-n256": dict(kind="vq", embed_dim=4, n_embed=256, ddconfig=_dd(4, (1, 2, 2, 4), (32,), False),
                       loss=_vq_loss(250001)),
    "vq-f16": dict(kind="vq", embed_dim=8, n_embed=16384, ddconfig=_dd(8, (1, 1, 2, 2, 4), (16,), False),
                   loss=_vq_loss(250001, disc_num_layers=2), monitor=None),
}


def _fs_config(name: str) -> Dict[str, Any]:
    spec = FIRST_STAGES[name]
    if spec["kind"] == "kl":
        return {"target": "ldm.models.autoencoder.AutoencoderKL",
                "params": {"embed_dim": spec["embed_dim"], "ddconfig": spec["ddconfig"]}}
    return {"target": "ldm.models.autoencoder.VQModelInterface",
            "params": {"embed_dim": spec["embed_dim"], "n_embed": spec["n_embed"],
                       "ddconfig": spec["ddconfig"]}}


# ------------------------------------------------------------------- LDM zoo
def _unet(**kw):
    base = dict(num_res_blocks=2)
    base.update(kw)
    return base


LDM_ZOO: Dict[str, Dict[str, Any]] = {
    # unconditional face/scene models on vq-f4 latents
    "celeba256": dict(
        first_stage="vq-f4", cond="__is_unconditional__", ls=0.0015, le=0.0195,
        base_lr=2.0e-6, let=200, ntc=1, stub_key="class_label",
        trainable=False, monitor="val/loss",
        unet=_unet(image_size=64, in_channels=3, out_channels=3, model_channels=224,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 4],
                   num_head_channels=32),
    ),
    "ffhq256": dict(
        first_stage="vq-f4", cond="__is_unconditional__", ls=0.0015, le=0.0195,
        base_lr=2.0e-6, let=200, ntc=1, stub_key="class_label",
        trainable=False, monitor="val/loss",
        unet=_unet(image_size=64, in_channels=3, out_channels=3, model_channels=224,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 4],
                   num_head_channels=32),
    ),
    "lsun_beds256": dict(
        first_stage="vq-f4", cond="__is_unconditional__", ls=0.0015, le=0.0195,
        base_lr=2.0e-6, let=200, ntc=1, stub_key="class_label",
        trainable=False, monitor="val/loss",
        unet=_unet(image_size=64, in_channels=3, out_channels=3, model_channels=224,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 4],
                   num_head_channels=32),
    ),
    "lsun_churches256": dict(
        first_stage="kl-f8", cond="__is_unconditional__", ls=0.0015, le=0.0155,
        base_lr=5.0e-5, let=200, ntc=1, stub_key="image",
        trainable=False, loss_type="l1", scale_by_std=True,
        monitor="val/loss_simple_ema",
        sched={"target": "ldm.lr_scheduler.LambdaLinearScheduler",
               "params": {"warm_up_steps": [10000],
                          "cycle_lengths": [10000000000000],
                          "f_start": [1.0e-6], "f_max": [1.0], "f_min": [1.0]}},
        unet=_unet(image_size=32, in_channels=4, out_channels=4, model_channels=192,
                   attention_resolutions=[1, 2, 4, 8], channel_mult=[1, 2, 2, 4, 4],
                   num_heads=8, use_scale_shift_norm=True, resblock_updown=True),
    ),
    # class-conditional ImageNet
    "cin256": dict(
        first_stage="vq-f8", ls=0.0015, le=0.0195, conditioning_key="crossattn",
        base_lr=1.0e-6, let=200, ntc=1, trainable=True,
        monitor="val/loss_simple_ema",
        cond_stage_key="class_label",
        cond={"target": "ldm.modules.encoders.modules.ClassEmbedder",
              "params": {"embed_dim": 512, "key": "class_label"}},
        unet=_unet(image_size=32, in_channels=4, out_channels=4, model_channels=256,
                   attention_resolutions=[4, 2, 1], channel_mult=[1, 2, 4],
                   num_head_channels=32, use_spatial_transformer=True,
                   transformer_depth=1, context_dim=512),
    ),
    # text-to-image
    "text2img256": dict(
        first_stage="vq-f4", ls=0.0015, le=0.0195, conditioning_key="crossattn",
        base_lr=2.0e-6, let=200, ntc=1, trainable=True,
        monitor="val/loss_simple_ema",
        cond_stage_key="caption",
        cond={"target": "ldm.modules.encoders.modules.BERTEmbedder",
              "params": {"n_embed": 640, "n_layer": 32}},
        unet=_unet(image_size=64, in_channels=3, out_channels=3, model_channels=192,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 5],
                   num_head_channels=32, use_spatial_transformer=True,
                   transformer_depth=1, context_dim=640),
    ),
    # layout-to-image
    "layout2img-openimages256": dict(
        first_stage="vq-f4", ls=0.0015, le=0.0205, conditioning_key="crossattn",
        base_lr=2.0e-6, let=100, trainable=True, loss_type="l1",
        monitor="val/loss_simple_ema",
        cond_stage_key="coordinates_bbox",
        cond={"target": "ldm.modules.encoders.modules.BERTEmbedder",
              "params": {"n_embed": 512, "n_layer": 16, "vocab_size": 8192,
                         "max_seq_len": 92, "use_tokenizer": False}},
        unet=_unet(image_size=64, in_channels=3, out_channels=3, model_channels=128,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 4],
                   num_head_channels=32, use_spatial_transformer=True,
                   transformer_depth=3, context_dim=512),
    ),
    # inpainting (concat masked image + mask in input channels)
    "inpainting_big": dict(
        # NB: the attn_type="none" vq-f4 variant (models/ldm/inpainting_big/
        # config.yaml ddconfig) — not the standard vq-f4
        first_stage="vq-f4-noattn", cond="__is_first_stage__", ls=0.0015, le=0.0205,
        base_lr=1.0e-6, let=100, loss_type="l1", monitor="val/loss",
        fs_loss="ldm.modules.losses.contperceptual.DummyLoss",
        sched={"target": "ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
               "params": {"verbosity_interval": 0, "warm_up_steps": 1000,
                          "max_decay_steps": 50000, "lr_start": 0.001,
                          "lr_max": 0.1, "lr_min": 0.0001}},
        conditioning_key="concat", cond_stage_key="masked_image",
        unet=_unet(image_size=64, in_channels=7, out_channels=3, model_channels=256,
                   attention_resolutions=[8, 4, 2], channel_mult=[1, 2, 3, 4],
                   num_heads=8, resblock_updown=True),
    ),
    # super-resolution (concat LR latent)
    "bsr_sr": dict(
        # LR image passes through an Identity cond stage and is concatenated
        # raw (models/ldm/bsr_sr/config.yaml: torch.nn.Identity, in_ch 3+3)
        first_stage="vq-f4", cond={"target": "torch.nn.Identity"},
        ls=0.0015, le=0.0155, base_lr=1.0e-6, let=100,
        trainable=False, loss_type="l2",
        conditioning_key="concat", cond_stage_key="LR_image",
        unet=_unet(image_size=64, in_channels=6, out_channels=3, model_channels=160,
                   attention_resolutions=[16, 8], channel_mult=[1, 2, 2, 4],
                   num_head_channels=32),
    ),
    # semantic synthesis (concat rescaled segmentation)
    "semantic_synthesis256": dict(
        first_stage="vq-f4", ls=0.0015, le=0.0205, conditioning_key="concat",
        base_lr=1.0e-6, let=100, trainable=True, loss_type="l1",
        cond_stage_key="segmentation",
        cond={"target": "ldm.modules.encoders.modules.SpatialRescaler",
              "params": {"n_stages": 2, "in_channels": 182, "out_channels": 3}},
        unet=_unet(image_size=64, in_channels=6, out_channels=3, model_channels=128,
                   attention_resolutions=[32, 16, 8], channel_mult=[1, 4, 8],
                   num_heads=8),
    ),
    "semantic_synthesis512": dict(
        first_stage="vq-f4", ls=0.0015, le=0.0205, conditioning_key="concat",
        base_lr=1.0e-6, let=100, trainable=True, loss_type="l1",
        cond_stage_key="segmentation",
        cond={"target": "ldm.modules.encoders.modules.SpatialRescaler",
              "params": {"n_stages": 2, "in_channels": 182, "out_channels": 3}},
        unet=_unet(image_size=128, in_channels=6, out_channels=3, model_channels=128,
                   attention_resolutions=[32, 16, 8], channel_mult=[1, 4, 8],
                   num_heads=8),
    ),
}


def names():
    return [f"first_stage_models/{k}" for k in FIRST_STAGES] + [
        f"ldm/{k}" for k in LDM_ZOO
    ]


def spec(name: str) -> Dict[str, Any]:
    kind, _, short = name.partition("/")
    if kind == "first_stage_models":
        return copy.deepcopy(FIRST_STAGES[short])
    return copy.deepcopy(LDM_ZOO[short])


def model_kwargs(name: str) -> Dict[str, Any]:
    """The LatentDiffusion keyword arguments of an "ldm/..." entry, as the
    JAX package's `zoo.build` gives them (a fresh copy). `scale_by_std` is
    not among them, as in the JAX package, so the scale factor is 1."""
    z = LDM_ZOO[name.partition("/")[2]]
    kwargs = dict(
        unet_config=z["unet"],
        first_stage_config=_fs_config(z["first_stage"]),
        cond_stage_config=z.get("cond", "__is_unconditional__"),
        timesteps=1000,
        linear_start=z["ls"],
        linear_end=z["le"],
        unconditional_guidance_scale=1.0,
    )
    for key in ("conditioning_key", "loss_type"):
        if key in z:
            kwargs[key] = z[key]
    if "cond_stage_key" in z:
        kwargs["cond_stage_key"] = z["cond_stage_key"]
        kwargs["cond_stage_trainable"] = z.get(
            "trainable", not isinstance(z.get("cond"), str))
    return copy.deepcopy(kwargs)


def build(name: str, dtype=torch.float32, device=None):
    """The module of a zoo entry, built on `device` ("cuda" unless given;
    "meta" allocates no weights): the first stage of a
    "first_stage_models/..." entry, else the LatentDiffusion of
    `model_kwargs`."""
    from .models.ddpm import LatentDiffusion, build_first_stage

    dev = resolve_device(device)
    kind, _, short = name.partition("/")
    if kind == "first_stage_models":
        with torch.device(dev):
            return build_first_stage(_fs_config(short), dtype, dev)
    if kind != "ldm":
        raise KeyError(f"unknown zoo entry {name!r}")
    return LatentDiffusion(**model_kwargs(name), dtype=dtype, device=dev)
