#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ealdm_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # phases 1-2b only: a new kernel's first call
    python3 chip_smoke.py --groupnorm  # the build and phase 2's GroupNorm part only
    python3 chip_smoke.py --train      # the build and phase 6 (training) only
    python3 chip_smoke.py --paths      # the build, phase 2c and phases 7-16 only
    python3 chip_smoke.py --ae         # the build and phase 17 (first-stage training) only
    python3 chip_smoke.py --main       # the build and phase 18 (`python -m ealdm_torch.main`) only
    python3 chip_smoke.py --host       # the build and the kernel wrappers' host cost
    python3 chip_smoke.py --cli        # the build and phase 19 (the CLIs and serving) only
    python3 chip_smoke.py --third      # the build and phase 20 (the third stage) only

Phases, each of which raises (non-zero exit) on failure:
  1. build every kernel from `ealdm_torch/kernels/csrc/*.cu` with nvcc (the
     seconds logged), and take a census of the bfloat16 flash kernels' and
     the GroupNorm kernels' machine code (tensor-core, async-copy, ldmatrix
     and exp instructions; ptxas registers and spills): the three wgmma
     flash kernels need HGMMA and UTMALDG and unserialized products, the
     float32 one (split TF32) HMMA of the TF32 kind only and cp.async, no
     kernel may spill;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes and layouts, in bfloat16 and float32, show that two planted
     faults break the bfloat16 attention limits, and time kernel / plain /
     one PyTorch library call (a yardstick only; the port never calls it);
     the d <= 32 routing: the wgmma kernel held and timed beside
     flash_mma_narrow_kernel at the flagship's d=32 shapes and at d=24;
     GroupNorm in both layouts it takes, timed at the main path's
     (channels_last) on inputs that do not fit the L2, and at the RDM's
     widest one-read site [4,3584,6,6] and largest two-read [2,128,768,768],
     and the super-resolution decode's two-read [9,128,512,512];
  2c. flash attention at the head dims of the repo's other configurations
     (24, 40, 48, 80 at 1024 and 256 tokens; 384 and 576 at 1024; and the
     conditional paths' wide sites [12,1,256,576], [12,1,1024,384],
     [8,1,1024,512]), split and packed, both dtypes, timed like phase 2
     (each row names the kernel the profile saw); the wide sites
     (`route_wide_heads`: flash_wgmma_wide_kernel held and timed beside the
     library at those sites, [24,1,1024,512], cin256-v2's VQ-f4 decode
     [6,1,4096,512] and the RDM's KL-f16 decode [2,1,2304,512], `[route]`
     lines); d = 24
     .. 80, 384, 512 and 576 at a ragged Nq = 1000, Nk = 77; the wrapper's
     host time a call at [16,8,256,80] and [16,8,256,32] (`host_cost`);
     the gradients through FlashAttention at d = 48 and d = 384; the zoo
     paths' five flash shapes, the RDM path's two and the super-resolution
     path's four (ZOO_PATH_SHAPES, RDM_PATH_SHAPES, SR_PATH_SHAPES, a
     `[route]` line each: kernel, library, bound) and
     d = 648 and 960 (held, timed; the profile
     must see flash_wgmma_deep_kernel in bfloat16 and flash_tf32x3_kernel
     in float32); `route_deep_heads`: the deep wgmma kernel at
     [4, 2, 1024, 640] too, and a `[route]` line at d = 640, 648 and 960
     (kernel, library, bound); the float32 kernel (split TF32) at every
     head of `probe_flash.F32_SHAPES`, timed beside the library and the
     plain version, and bfloat16 d = 1,928 on it (`float32_heads`);
  2b. the op library entry point `ealdm_torch.ops` at full width: the
     bias_act kernel against `bias_act_plain` (nine activations, any dim,
     three dtypes), first- and second-order gradients, then filtered_lrelu
     and EqualizedDense(lrelu) with their bias_act launches counted, a
     float32 check against the CPU, and the bias_act timings;
  3. the main path at the flagship width: LatentDiffusion in bfloat16 with
     seeded random weights, `sample_images` at batch 24, DDIM-50, eta 1,
     CFG 2, hoisted invariants, with the launch counts checked against what
     the module tree implies (GroupNorm by path, layout and shape), three
     timed runs (img/s from the median),
     then one more run under torch.profiler for
     the device time by kernel and the device's idle share;
  4. the same program under the packed attention layout for a few steps,
     held against the "flash" layout at the same seed;
  5. a reference check: flagship width at batch 1, 2 steps, float32, the
     card (kernels) against the CPU (plain versions) on the same inputs;
  6. training, `bench.py --train`'s step (`config.FLAGSHIP_TRAIN`): (a) the
     GroupNorm and flash Functions' gradients against autograd through
     their plain versions at the train step's shapes; (b) the flagship train
     step at batch 24 in bfloat16 with remat "dots" (a warm-up and five
     timed steps, launches per step checked against the module tree, one
     profiled step: device time by group and the idle share; one step each
     under "none" and "full", its launches against the module tree and its
     loss finite); (c) gradient
     completeness after the first step; (e) that step's numbers: the
     gradient of one bf16 batch-24 step with the kernels against the same
     step with each kernel launch replaced by its plain version, and a
     planted GroupNorm fault that must fail the same limit; (d) one float32
     train step at batch 1, the card against the CPU; (f) the cin256-v2
     (`config.CIN256_TRAIN`: class ids through the trainable ClassEmbedder)
     and txt2img (`config.TXT2IMG_TRAIN`: token ids from the host tokenizer
     through the trainable 32-layer BERT) steps at batch 8, each with a
     warm-up and three timed steps, launches per step against the module
     tree, gradient completeness (the cond stage trains and moves, the
     first stage gets no gradient and stays), one profiled step, and its
     own (e) and (d).
  7. inpainting (`config.INPAINT`, scripts/inpaint.py's run): the VQ-f4
     encode of a seeded 256^2 batch of 16, a keep-mask, `sample_images(mask,
     x0)` with DDIM-50 at eta 0, decode and composite; launches against the
     module tree (flash per head dim, GroupNorm per path), one timed run,
     a profile, float32 card vs CPU over 2 steps, and PLMS over 4 steps;
  8. the unconditional VQ-f8 LDM (`config.UNCOND`) at batch 24, one DDIM-50
     eta 1 run, timed, launches checked;
  9. the pixel-space DDPM (`config.PIXEL`) at batch 4: 4 DDIM and 4 PLMS
     steps, launches checked (GroupNorm C/G = 7 to 56);
  10. the KL-f4 autoencoder (`config.KL_F4`) round trip at batch 16, 256^2:
     bfloat16 timed, launches checked, the PSNR of bfloat16 against float32.
  11. txt2img (`config.TXT2IMG`, `txt2img-1p4B-eval`, scripts/txt2img.py's
     run) at full width: batch 8 of one prompt against the empty prompt
     through the port's tokenizer and the 32-layer BERT, DDIM-50 at eta 0
     with CFG 5, hoisted, the KL-f8 decode; launches against the module
     tree (flash d=40 / d=80 / d=512, GroupNorm by path), one timed run,
     the two BERT passes timed, a profile, the C = 2,560 GroupNorm sites
     among the held ones, float32 card vs CPU over 2 steps at batch 1;
  12. class-conditional ImageNet (`config.CIN256`, cin256-v2, the sampling
     notebook's settings): classes 25, 187, 448, 992, 6 samples each,
     DDIM-20 at eta 0, scale 3 against the null class 1000, VQ-f4 decode;
     the same checks and numbers.
  13. `ldm/lsun_churches256` (`config.CHURCHES`, built by
     `ealdm_torch.zoo.build`), scripts/sample_diffusion.py's defaults:
     batch 10, DDIM-50 at eta 1, unconditional, hoisted (scale-shift emb
     tables), the KL-f8 decode; the GroupNorm sites of 4 and 16 pixels
     among the held ones; float32 card vs CPU at batch 1, 2 steps.
  14. `ldm/inpainting_big` (`config.INPAINT_BIG`), upstream
     scripts/inpaint.py on the two committed data/inpainting_examples as a
     batch of 2: the attention-free VQ-f4 encoding of the masked image
     joined to the mask at 64^2, DDIM-50 at eta 0 (concat: the plain step),
     decode, composite; float32 card vs CPU (conditioning and 2 steps).
  15. retrieval-augmented sampling (`config.RDM768`, the 768x768 RDM with
     KL-f16 and 48^2 latents), scripts/knn2img.py with --use_neighbors
     --knn 10: a seeded 200,000 x 768 database indexed on the card by
     `auto_build_searcher` (447 leaves, 22 probed), the ViT-L/14 CLIP text
     tower on the default prompt (n = 2) and image tower on example0,
     k = 10 on the exact search (against a float64 brute force) and the
     partitioned one (recall@10 logged), the [2, 11, 768] context through
     DDIM-50 at eta 0 with CFG 5, the decode to 768^2; the C = 3,584
     GroupNorm sites among the held ones; float32 card vs CPU at batch 1,
     2 steps (conditioning, latent, image embedding).
  16. super-resolution (`config.BSR_SR`, `ldm/bsr_sr`) through
     `ealdm_torch.notebook_helpers` (`get_model`, `run`: split-input
     patching at 128^2 crops, stride 64, DDIM-50 at eta 1) on (a) the
     committed 64^2 example (256^2 out: 3x3 encode crops, one crop for the
     UNet and the decode) and (b) that example upsampled to 256^2 (1024^2
     out: 15x15 encode crops, 3x3 crops of 128^2 for the UNet, its d=32
     flash at 256 rows, and for the decode to 512^2 each); launches against
     the module tree at the crops' sides (`superres_passes`), one timed
     run, a profile, `hold_sites`; float32 card vs CPU at batch 1, 2 steps
     on (a) with the grid cut to 32^2 crops, stride 16 (multi-crop encode,
     UNet and decode).
  17. first-stage VAE-GAN training (`training/vae_trainer.py`), float32 at
     full width, for `config.VQ_F8_AE_TRAIN` (the zoo's vq-f8, disc_start 1)
     and `config.KL_F8_AE_TRAIN` (autoencoder_kl_32x32x4.yaml, disc_start
     50,001): the kernels at the step's shapes (flash [12,1,1024,512], the
     autoencoder's and the discriminator's GroupNorms, 63^2 and 31^2 among
     them) held and timed; then for each (a) one step at batch 1 on the card
     against the CPU (loss 1e-4, every trained gradient 1e-3, d_weight and
     the logs), (b) the discriminator's warm-up (bit-frozen before
     disc_start, moving from it; LPIPS and logvar never move), (c) a
     warm-up and five timed steps at batch 12, 256^2 (step ms, img/s, peak
     GiB), launches per step against the module tree, a profile with the
     plain backwards' ranges, (d) one step with every kernel launch held
     against its plain version, (e) main.py's loop (MetricLogger's JSONL and
     TensorBoard events, an eval step, a checkpoint save and a bit-equal
     restore, the reconstruction grid through the zlib PNG writer, the
     YAML config; no PyYAML or PIL imported); and the two convergence
     oracles of tests/test_convergence.py on the port at micro size;
  18. the training entry point `ealdm_torch.main.main` from the repo's
     YAMLs at full width, in a temporary directory it removes: (a) the
     synthetic stream-camera corpus at 256^2 (four sites of 120 days, its
     windows held to the reckoning); (b) the flagship YAML, bf16, batch 32,
     4 steps at the default --log_every, one ImageLogger grid after the
     last, one validation: launches per step against
     `expected_train_launches`, every batch on the card, the loop's first
     loss against `make_train_step` on the same batch, state and generator
     (2^-8 relative), the img/s of the loop's steps 1-3 and of as many bare
     steps on a resident batch, alone and with the train loader's
     prefetcher fetching beside them (each run between two synchronizes,
     none within), the prefetcher's waits and the steps' host seconds in those
     steps, peak GiB, each checkpoint's bytes and write seconds, the
     logdir's files; one bare step with every kernel launch held against
     its plain version (`hold_sites`); (c) on the micro STDiff YAML over
     the same corpus: 4 steps, `-r <logdir>` (the configs read back by the
     port's YAML reader, step 4 restored bit for bit), then step 6; (d)
     `train_autoencoder` on autoencoder_kl_32x32x4.yaml, float32, batch
     12, 2 steps on PNGs written by the port's writer: launches against
     `ae_train_census`, finite losses, the reconstruction grid read
     back by the port's PNG reader, the memory the earlier runs left.
  19. the command-line tools and serving, in-process through each tool's
     `main(argv)` on phase 18's flagship run dir before it is removed
     (`--cli`: a seeded flagship state written by `CheckpointManager` in a
     directory of its own): (a) sample_diffusion at batch 24, DDIM-50, eta
     1 (the throughput line, 24 PNGs and the .npz read back, the EMA shadow
     used, launches against the module tree, every launch of a `-c 1`
     batch held); (b) txt2img-1p4B-eval.yaml, 2 samples at 256², 50 steps,
     scale 5, DDIM; (c) inpaint's full model on
     data/inpainting_examples, 50 steps; (d) train_searcher on 64 seeded
     256² PNGs (ResNet-50), then on the 200,000 x 768 database with
     --num_leaves 8; (e) knn2img on the 768x768 RDM, 2 samples, the
     database, --use_neighbors --knn 10, a text and a PNG query; (f)
     export_sampler at batch 8, 50 steps, then a fresh process (torch and
     the kernel operator registry only) loads the artifact and a
     SamplerService serves 10 requests: its latent and images against the
     direct `sample_images(hoist=False)` on the same draws (5e-2 of max
     |z|), a profiled batch's hand-written kernels by name and launches
     against the direct program's. Each tool's wall, img/s over the wall
     and peak GiB, and (f)'s export seconds, artifact bytes, load seconds
     and served img/s, are the `[cli]` line.
  20. the third stage (`ealdm_torch/third_stage.py`), run by phase 18 (b)'s
     `ealdm_torch.main` call with --third_stage true
     --third_stage_max_batches 1 on the flagship YAML (`--third`: a
     one-step run of its own): (a) one dump batch of 32 a split at DDIM-50
     (npz keys, shapes, dtypes; each dump's launches against the module
     tree, and every launch of one UNet call at its guided batch of 64
     held), the heads' training and `test` at CLIP
     64^2, both CSVs and `run`'s five results, each part's seconds; (b)
     `test` on (a)'s dumps at CLIP 224^2 (InceptionV3 at 299^2, ResNet-50 at
     256^2); (c) one decode + heads batch of 4: launches against the module
     tree (the VQ-f8 decoder's flash and GroupNorms, ResNet-50's 53
     GroupNorms), every launch held, and ResNet-50's largest GroupNorm site
     timed beside its plain version and F.group_norm; (d) float32 card
     against CPU at batch 2, TF32 off: the decoded images, ResNet-50's
     pooled features, the heads, InceptionV3's pool3 features and the CLIP
     logits, each within 1e-3 of its largest |value|; (e) `refine_decoder`,
     2 steps at batch 4 in float32 (finite losses, the decoder and the
     discriminator moved, step seconds, peak GiB, every launch of a step
     held); (f) seeded `inception.npz`, `clip.pth` and `vgg_lpips.pth` in a
     temporary $EALDM_WEIGHTS_DIR: the trunks' outputs after auto-loading
     equal to those of the same parameters copied directly.
  Each of phases 7-16 also holds every kernel launch of one bfloat16 pass
  (7, 14, 16: encode, one UNet call, decode; 8, 11, 12, 13, 15: one UNet
  call and a decode; 9: one UNet call; 10: one round trip) against its
  plain version on the same inputs, at the shapes and strides the path
  gives it (`hold_sites`); 11-16 also report img/s (one timed run), peak
  GiB and the device's busy time and idle share from one profile.
  Phases 7-16 run after phase 5 and before phase 6; phases 17, 18 (with
  20 inside it) and 19 run last. The models these phases seed draw their
  weights on the card (`random_init_`).

The last lines of output are a `[phase-seconds]` line (the wall seconds
of each phase or group of phases), `[done]`, a `[paths]` JSON line with
phases 7-16's numbers, a `[train]` JSON line with phase 6's numbers, an
`[ae_train_vq_f8]`, `[ae_train_kl_f8]`, `[convergence]` and
`[ae_train_seconds]` line with phase 17's, a `[main]` line with phase
18's, a `[cli]` line with phase 19's, a `[third_stage]` line with phase
20's, the card's name and power
limit, a JSON line with every kernel's numbers (not with --train), and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build")  # gitignored, beside the kernel builds

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside them, device memory bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exp2 on the SFU: 16 results a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput table, compute capability 9.0); see
# `peak_exp` for the clock.
SFU_EXP_PER_CLOCK = 16

# the bfloat16 flash kernels, as named in flash_attention.cu (templates over
# the padded head dim; mma.sync, cp.async), flash_attention_sm90.cu (wgmma,
# TMA: d = 40 .. 128), flash_attention_sm90_wide.cu (wgmma, TMA: d = 136 ..
# 576) and flash_attention_sm90_deep.cu (wgmma, TMA, a cluster splitting the
# head dim: d = 648 .. 1,920), and every flash forward kernel
MMA_KERNELS = ("flash_mma_narrow_kernel",)
WGMMA_KERNEL = "flash_wgmma_narrow_kernel"
WIDE_WGMMA_KERNEL = "flash_wgmma_wide_kernel"
DEEP_WGMMA_KERNEL = "flash_wgmma_deep_kernel"
# flash_attention_sm90_f32.cu (split TF32 on mma.sync, and on wgmma at d = 33
# .. 128 and 161 .. 256): float32 at every d, bfloat16 above 1,920; its key
# split's second launch
F32_KERNEL = "flash_tf32x3_kernel"
F32_COMBINE_KERNEL = "flash_tf32x3_combine_kernel"
FLASH_KERNELS = (*MMA_KERNELS, WGMMA_KERNEL, WIDE_WGMMA_KERNEL, DEEP_WGMMA_KERNEL,
                 F32_KERNEL, F32_COMBINE_KERNEL)
KERNEL_SOURCES = {WGMMA_KERNEL: "flash_attention_sm90.cu",
                  WIDE_WGMMA_KERNEL: "flash_attention_sm90_wide.cu",
                  DEEP_WGMMA_KERNEL: "flash_attention_sm90_deep.cu"}
# head dims of the repo's configurations other than the flagship's 32 and
# 512: the UNets' (txt2img 40/80, inpainting 48, lsun_churches 24/48) and
# cin256-v2's wide heads
NARROW_HEAD_DIMS = (24, 40, 48, 80)
WIDE_HEAD_DIMS = (384, 576)
# [B, H, N, D] of the conditional paths' wide flash sites: cin256-v2's CFG
# batch of 12 at ds 4 and ds 2, and txt2img's KL-f8 mid attention at batch 8
PATH_WIDE_SHAPES = ((12, 1, 256, 576), (12, 1, 1024, 384), (8, 1, 1024, 512))
# the wide routing's shapes: those, the flagship's VQ-f8 mid attention at
# batch 24, cin256-v2's VQ-f4 decode (6 images a call, 64^2 tokens) and the
# RDM's KL-f16 decode (2 images, 48^2 tokens)
WIDE_ROUTE_SHAPES = (*PATH_WIDE_SHAPES, (24, 1, 1024, 512), (6, 1, 4096, 512),
                     (2, 1, 2304, 512))
# [B, H, N, D] of the zoo paths' flash sites (phases 13 and 14):
# lsun_churches256 at batch 10 (d=24 at 32^2, d=48 at 16^2, the KL-f8 mid
# attention) and inpainting_big at batch 2 (d=64 at 32^2, d=96 at 16^2)
ZOO_PATH_SHAPES = ((10, 8, 1024, 24), (10, 8, 256, 48), (10, 1, 1024, 512),
                   (2, 8, 1024, 64), (2, 8, 256, 96))
# [B, H, N, D] of the retrieval-augmented path's flash sites (phase 15):
# the RDM UNet's CFG batch of 4 at 48^2 (14 heads of 32) and the KL-f16
# decoder's attention at 48^2 on 2 images
RDM_PATH_SHAPES = ((4, 14, 2304, 32), (2, 1, 2304, 512))
# [B, H, N, D] of the super-resolution path's new flash sites (phase 16):
# input (b)'s UNet on 3x3 crops of 128^2 (d=32, 20 heads at 16^2), the VQ-f4
# decoder's attention at input (a)'s 64^2 latent and on (b)'s 3x3 crops of
# 128^2, and (b)'s encoder on 15x15 crops (32^2 latent each)
SR_PATH_SHAPES = ((9, 20, 256, 32), (1, 1, 4096, 512), (9, 1, 16384, 512),
                  (225, 1, 1024, 512))
# head dims above 640, held and timed on flash_wgmma_deep_kernel (bfloat16)
# and flash_tf32x3_kernel (float32)
DEEP_HEAD_DIMS = (648, 960)
# TF32 on the tensor cores (NVIDIA data sheet, dense): the float32 flash
# kernel's three terms a product run at this rate
PEAK_TF32 = 495e12
# the channels_last GroupNorm kernels (group_norm.cu): the two that stage
# rows in shared memory by asynchronous copies, and the streaming one; and
# the NCHW kernels kept from PR 1
GN_STAGING_KERNELS = ("gn_cluster_kernel", "gn_tile_stats_kernel")
GN_KERNELS = (*GN_STAGING_KERNELS, "gn_tile_apply_kernel", "gn_single_kernel",
              "gn_partial_kernel", "gn_apply_kernel")
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "UBLKCP", "LDSM", "MUFU.EX2")
ASYNC_COPY_OPS = ("LDGSTS", "UTMALDG", "UBLKCP")
L2_BYTES = 50e6  # H100 L2; timed inputs rotate over more than twice this


def tolerance(dtype, want):
    """Per-element limit of kernel vs plain version. Both compute in float32
    (sums in another order, which differ by a few 1e-6 at most) and round
    once to the output dtype. float32: 1e-4. bfloat16: the two roundings
    leave the results at most one bf16 ulp apart, and an ulp is at most
    2^-7 of the value; the limit is two ulps of each reference element plus
    the float32 limit. bfloat16 attention has limits of its own, which also
    cover the kernel's rounding of P (`bf16_attention_shares`)."""
    if str(dtype) == "torch.float32":
        return 1e-4
    return 2 * 2**-7 * want.float().abs() + 1e-4


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query="name,power.limit", fmt="csv,noheader") -> str:
    """The first card's line of `nvidia-smi --query-gpu=<query>`."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def peak_exp():
    """exp2 results a second on the SFUs: 16 a clock per SM x the card's SMs
    x its maximum SM clock, as nvidia-smi reads it."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXP_PER_CLOCK * sms * mhz * 1e6


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, peak_flops, exps=0):
    """Least time in ms, and what sets it: the operations at `peak_flops`,
    the bytes at the memory rate, or the exponentials at the SFU's rate."""
    times = {"operations": flops / peak_flops, "bytes": nbytes / PEAK_BYTES,
             "exp": exps / peak_exp() if exps else 0.0}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def kernel_label(key):
    """A profiler key's kernel as `name<template arguments>`, without
    namespaces or spaces: "flash_wgmma_narrow_kernel<Config<64,3>>"."""
    key = key.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(key):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            head = key[:i].rstrip()
            break
    else:
        return key
    if not head:
        return key
    depth = 0
    for j in range(len(head) - 1, -1, -1):  # the name starts after the last top-level space
        depth += (head[j] == ">") - (head[j] == "<")
        if head[j] == " " and depth == 0:
            return head[j + 1:].replace(" ", "")
    return head.replace(" ", "")


def device_activities(prof):
    """{name: (device seconds, count)} of what ran on the device in a
    torch.profiler run (kernels, copies, sets; a range's span on the device
    track is not one), summed by name over the profiler's raw events: the
    rows of `key_averages()` with device time, without the event tree it
    builds first (for 150,000 launches, about 40 s of the H100 machine's
    host time, where the raw events take about 1 s)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_async() or e.is_user_annotation()
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        t, n = out.get(e.name(), (0.0, 0))
        out[e.name()] = (t + (e.end_ns() - e.start_ns()) / 1e9, n + 1)
    return {k: v for k, v in out.items() if v[0] > 0}


def device_ms_by_kernel(fn, iters=20, warmup=2):
    """{kernel: device time per call in ms} of the CUDA kernels `fn` runs,
    under torch.profiler over `iters` calls; a kernel is named by its
    function (`kernel_label` up to the template arguments). A kernel's
    time per call is its mean time a launch times its launches a call, so a
    launch the profiler misses does not pull the mean down."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for key, (t, count) in device_activities(prof).items():
        name = kernel_label(key).split("<")[0].split("::")[-1]
        per_call = max(1, round(count / iters))
        out[name] = out.get(name, 0.0) + t / count * per_call * 1e3
    return out


def device_ms(fn, iters=20, warmup=2, names=False):
    """Device time per call: the sum of every CUDA kernel's time under
    torch.profiler over `iters` calls. Unlike `cuda_ms` it leaves out the
    gaps where the device waits for the host, which dominate a call of a
    few microseconds. A profile that records no kernel at all (it happens
    now and then, after many profiles in one process) is taken again, up to
    three times; then it raises, so a row's time is always device time.
    With `names`, returns (ms, the kernels' names joined by "+")."""
    for _ in range(3):
        by_kernel = device_ms_by_kernel(fn, iters, warmup)
        ms = sum(by_kernel.values())
        if ms > 0:
            return (ms, "+".join(sorted(by_kernel))) if names else ms
    raise RuntimeError("the profiler recorded no kernel in three profiles")


def compare(errs, kernel, dtype, got, want, what, attn=None):
    """Raise unless `got` is within its limits of `want`: `tolerance`
    element by element or, for bfloat16 attention (`attn` = (q, k, v,
    heads)), both limits of `bf16_attention_shares`. Keeps the largest
    bfloat16 error per kernel in `errs`."""
    import torch

    from ealdm_torch.ops.attention import bf16_attention_shares

    err = (got.float() - want.float()).abs().max().item()
    if attn is not None and dtype == torch.bfloat16:
        q, k, v, heads = attn
        shares = bf16_attention_shares(got, q, k, v, want, heads)
    else:
        shares = ((got.float() - want.float()).abs() / tolerance(dtype, want)).max().item(),
    text = " and ".join(f"{x:.3g} of the {kind} limit"
                        for x, kind in zip(shares, ("per-element", "RMS")))
    if not all(math.isfinite(x) and x <= 1 for x in shares):
        raise RuntimeError(f"{kernel} {what} {dtype}: max abs err {err:.3g}, {text}")
    if dtype == torch.bfloat16:
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    log(f"  {kernel:24s} {what:34s} {str(dtype):15s} max_abs_err {err:.3g} ({text})")


def coarse_p_attention(q, k, v, bits):
    """A planted fault: flash_attention_plain with P rounded to nearest with
    a `bits`-bit significand before P*V (bfloat16 has 8), the row sums
    unrounded."""
    import torch

    s = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    m, e = torch.frexp(p)
    p_coarse = torch.ldexp(torch.round(m * 2**bits) / 2**bits, e)
    return (torch.matmul(p_coarse, v.float()) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


# ------------------------------------------------------------------ phase 1
def phase_build():
    from ealdm_torch.kernels import build

    t0 = time.perf_counter()
    names = list(build.build_all())
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name in names:
            f.write(f"--- {name}\n{build.build_report(name)}\n")
    for name in names:
        for line in build.build_report(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"[build] {len(names)} sources built or found built in {secs:.1f} s")
    return secs


def sass_census(source, names):
    """{kernel: counts of SASS_OPS} from `cuobjdump -sass` of the library
    built from `csrc/<source>.cu`, and {kernel: registers and spill bytes}
    from its nvcc report, each summed (counts) or maximised (registers,
    spills) over a kernel's template instances."""
    import re

    from ealdm_torch.kernels import build

    lib = build.library_path(source)
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=True, timeout=300).stdout
    op_re = re.compile(r"\b(" + "|".join(re.escape(op) for op in SASS_OPS) + r")\b")
    census, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line), None)
            if current:
                census.setdefault(current, dict.fromkeys(SASS_OPS, 0))
        elif current:
            for op in op_re.findall(line):
                census[current][op] += 1
    # ptxas -v: "Compiling entry function '<name>'", then "... N bytes spill
    # stores, M bytes spill loads" and "Used R registers"
    ptxas, current = {}, None
    for line in build.build_report(source).splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in names if k in line), None)
        elif current and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            d = ptxas.setdefault(current, {})
            d["spill_bytes"] = max(d.get("spill_bytes", 0), int(st) + int(ld))
        elif current and "Used" in line:
            d = ptxas.setdefault(current, {})
            d["registers"] = max(d.get("registers", 0),
                                 int(re.search(r"Used (\d+) registers", line).group(1)))
    for name in names:
        log(f"[sass] {name}: {census.get(name)}; ptxas {ptxas.get(name)}")
        if name not in census:
            raise RuntimeError(f"{name} is not in {lib}")
        if "spill_bytes" not in ptxas.get(name, {}):
            raise RuntimeError(f"{name} has no spill line in the nvcc report")
        if ptxas[name]["spill_bytes"]:
            raise RuntimeError(f"{name} spills: {ptxas[name]}")
    return census


def phase_sass():
    """Machine-code census: the bfloat16 flash kernels need tensor-core
    (HMMA/HGMMA) and asynchronous-copy instructions, the three wgmma ones
    HGMMA and TMA loads (UTMALDG), the float32 one (`flash_tf32x3_kernel`)
    TF32 products only, both HMMA.1688.F32.TF32 (mma.sync) and TF32 HGMMA
    (the instances on wgmma), and LDGSTS, the GroupNorm kernels that stage
    rows in shared memory asynchronous copies (LDGSTS, UTMALDG or the bulk
    copy UBLKCP); no kernel of any may spill, and ptxas may not serialize a
    wgmma kernel's products (its "Potential Performance Loss" notes).
    Raises otherwise, or if a kernel is missing from the machine code or the
    nvcc report."""
    import re

    from ealdm_torch.kernels import build

    flash = sass_census("flash_attention", MMA_KERNELS)
    f32 = sass_census("flash_attention_sm90_f32", (F32_KERNEL, F32_COMBINE_KERNEL))
    if not f32[F32_KERNEL]["HMMA"] or not f32[F32_KERNEL]["LDGSTS"]:
        raise RuntimeError(f"{F32_KERNEL} needs HMMA and LDGSTS: {f32[F32_KERNEL]}")
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                           str(build.library_path("flash_attention_sm90_f32"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    tf32, tf32_wg = sass.count("HMMA.1688.F32.TF32"), len(re.findall(r"HGMMA\.\S*\.TF32", sass))
    log(f"[sass] {F32_KERNEL}: {tf32} HMMA.1688.F32.TF32 (of {f32[F32_KERNEL]['HMMA']} HMMA), "
        f"{tf32_wg} TF32 HGMMA (of {f32[F32_KERNEL]['HGMMA']} HGMMA)")
    if tf32 != f32[F32_KERNEL]["HMMA"] or tf32_wg != f32[F32_KERNEL]["HGMMA"]:
        raise RuntimeError(f"{F32_KERNEL}: tensor-core products that are not TF32")
    if not tf32 or not tf32_wg:
        raise RuntimeError(f"{F32_KERNEL} needs both mma.sync and wgmma TF32 products")
    for kernel, source in {**KERNEL_SOURCES, F32_KERNEL: "flash_attention_sm90_f32.cu"}.items():
        if kernel != F32_KERNEL:
            flash.update(sass_census(source.removesuffix(".cu"), (kernel,)))
        serialized = [line for line in build.build_report(source.removesuffix(".cu")).splitlines()
                      if "Potential Performance Loss" in line and "wgmma" in line]
        if serialized:
            raise RuntimeError(f"ptxas serializes the wgmma products: {serialized[0]}")
    for name, c in flash.items():
        if c["HMMA"] + c["HGMMA"] == 0:
            raise RuntimeError(f"{name} has no tensor-core instruction")
        if not any(c[op] for op in ASYNC_COPY_OPS):
            raise RuntimeError(f"{name} has no asynchronous copy")
    for kernel in KERNEL_SOURCES:
        if not (flash[kernel]["HGMMA"] and flash[kernel]["UTMALDG"]):
            raise RuntimeError(f"{kernel} needs HGMMA and UTMALDG: {flash[kernel]}")
    gn = sass_census("group_norm", GN_KERNELS)
    for name in GN_STAGING_KERNELS:
        if not any(gn[name][op] for op in ASYNC_COPY_OPS):
            raise RuntimeError(f"{name} has no asynchronous copy")
    return flash, gn


# ------------------------------------------------------------------ phase 2
def phase_kernels():
    """Returns {kernel name: numbers} for the JSON line; `launches` stays
    None until a main-path run fills it in."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import (
        _split_heads, bf16_attention_shares, flash_attention, flash_attention_packed,
        flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    errs = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check_attn(name, q, k, v, what, heads=None):
        if heads is None:
            got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
        else:
            got = flash_attention_packed(q, k, v, heads)
            want = flash_attention_plain(*(_split_heads(t, heads) for t in (q, k, v)))
            want = want.transpose(1, 2).reshape(q.shape)
        compare(errs, name, q.dtype, got, want, what, attn=(q, k, v, heads))

    # -- flash attention [B, H, N, D], contiguous
    attn_cases = [("flash_attention_d32", (48, 8, 1024, 32)),
                  ("flash_attention_d32", (48, 16, 256, 32)),
                  ("flash_attention_d512", (24, 1, 1024, 512)),
                  ("flash_attention_d512", (48, 1, 1024, 512))]
    for name, shape in attn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
            check_attn(name, q, k, v, f"[B,H,N,D]={list(shape)}")
    # -- the head-strided view of a [B, N, H*D] projection (the main path)
    for heads, shape in ((8, (48, 1024, 256)), (16, (48, 256, 512))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (_split_heads(randn(*shape, dtype=dtype), heads) for _ in range(3))
            check_attn("flash_attention_d32", q, k, v,
                       f"split view of {list(shape)} H={heads}")
    # a ragged key/query count is masked inside the kernel
    for d in (32, 512):
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(2, 2, 200, d, dtype=dtype)
            k, v = randn(2, 2, 77, d, dtype=dtype), randn(2, 2, 77, d, dtype=dtype)
            check_attn(f"flash_attention_d{d}", q, k, v, "ragged Nq=200 Nk=77")
    # -- packed [B, N, H*D]
    for heads, shape in ((8, (48, 1024, 256)), (16, (48, 256, 512))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
            check_attn("flash_attention_packed_d32", q, k, v,
                       f"[B,N,HD]={list(shape)} H={heads}", heads)
    # -- the limits' teeth at the main path's largest d=32 shape: two planted
    #    faults, each of which one of the two limits must catch
    q, k, v = (randn(48, 8, 1024, 32, dtype=torch.bfloat16) for _ in range(3))
    want = flash_attention_plain(q, k, v)
    readings = {
        "sound kernel": flash_attention(q, k, v),
        # the kernel run without the last 64-key tile: a kernel that skipped it
        "kernel, last key tile dropped": flash_attention(q, k[:, :, :-64], v[:, :, :-64]),
        "P rounded to 4 bits (fp8 significand)": coarse_p_attention(q, k, v, bits=4),
    }
    for what, got in readings.items():
        elem, rms = bf16_attention_shares(got, q, k, v, want)
        log(f"[limit] [48,8,1024,32] {what}: {elem:.3g} of the per-element limit, "
            f"{rms:.3g} of the RMS limit")
        if (max(elem, rms) <= 1) != (what == "sound kernel"):
            raise RuntimeError(f"the bfloat16 attention limits misjudge: {what}")
    torch.cuda.synchronize()

    # -- timing at the main path's largest shape of each kernel, bfloat16
    bf = torch.bfloat16
    res = {}

    def packed(fn, heads):  # [B,H,N,D] attention on packed [B,N,H*D] q/k/v
        return lambda q, k, v: fn(*(_split_heads(t, heads) for t in (q, k, v))) \
            .transpose(1, 2).reshape(q.shape)

    sdpa_lib = F.scaled_dot_product_attention
    flash_replaces = "ealdm_tpu/ops/attention.py:77"
    for row, shape in (("flash_attention_d32", (48, 8, 1024, 32)),
                       ("flash_attention_d512", (24, 1, 1024, 512))):
        qkv = [randn(*shape, dtype=bf) for _ in range(3)]
        attention_row(res, errs, row, row, shape, "contiguous [B,H,N,D]", flash_attention,
                      flash_attention_plain, sdpa_lib, flash_replaces, qkv)
    # the d=32 kernel on the main path's layout: the head-strided view of the
    # [B, N, H*D] projection, at both UNet levels that take it
    for row, (b, n, heads) in (("flash_attention_d32_split_n1024", (48, 1024, 8)),
                               ("flash_attention_d32_split_n256", (48, 256, 16))):
        qkv = [_split_heads(randn(b, n, heads * 32, dtype=bf), heads) for _ in range(3)]
        attention_row(res, errs, row, "flash_attention_d32", (b, heads, n, 32),
                      f"head-strided view of [{b},{n},{heads * 32}]", flash_attention,
                      flash_attention_plain, sdpa_lib, flash_replaces, qkv,
                      counter=("flash_attention_d32", n))
    b, n, heads = 48, 1024, 8
    qkv = [randn(b, n, heads * 32, dtype=bf) for _ in range(3)]
    attention_row(res, errs, "flash_attention_packed_d32", "flash_attention_packed_d32",
                  (b, heads, n, 32), f"packed [{b},{n},{heads * 32}]",
                  lambda q, k, v: flash_attention_packed(q, k, v, heads),
                  packed(flash_attention_plain, heads), packed(sdpa_lib, heads),
                  "ealdm_tpu/ops/attention.py:272", qkv)
    route_small_heads(res, errs, randn, flash_replaces)
    log_rows(res)
    return res


def route_small_heads(res, errs, randn, replaces):
    """d <= 32 runs flash_mma_narrow_kernel unless the wgmma kernel is faster
    at each of the flagship's three d=32 sites and lsun_churches' d=24: here
    each shape runs through both in this process (the wgmma kernel routed
    there for these calls only), held to its limits first. Adds a row for
    the wgmma kernel at each shape (0 launches on every path; `mma_ms` is
    flash_mma_narrow_kernel's time) and logs the verdict."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops import attention
    from ealdm_torch.ops.attention import (
        _split_heads, flash_attention, flash_attention_plain)

    bf = torch.bfloat16
    cases = (("flash_wgmma_d32_n1024", (48, 8, 1024, 32), None),
             ("flash_wgmma_d32_split_n1024", (48, 8, 1024, 32), 8),
             ("flash_wgmma_d32_split_n256", (48, 16, 256, 32), 16),
             ("flash_wgmma_d24_n1024", (16, 8, 1024, 24), None))
    routed = attention.WGMMA_HEAD_DIMS
    wins = []
    for row, shape, heads in cases:
        b, h, n, d = shape
        if heads is None:
            layout = "contiguous [B,H,N,D]"
            qkv = [randn(*shape, dtype=bf) for _ in range(3)]
        else:
            layout = f"head-strided view of [{b},{n},{heads * d}]"
            qkv = [_split_heads(randn(b, n, heads * d, dtype=bf), heads) for _ in range(3)]
        mma_ms = device_ms(lambda: flash_attention(*qkv))
        attention.WGMMA_HEAD_DIMS = range(8, 129, 8)
        try:
            compare(errs, row, bf, flash_attention(*qkv), flash_attention_plain(*qkv), layout,
                    attn=(*qkv, None))
            attention_row(res, errs, row, row, shape, layout, flash_attention,
                          flash_attention_plain, F.scaled_dot_product_attention, replaces, qkv,
                          counter=(f"{row} (not routed)", n))
        finally:
            attention.WGMMA_HEAD_DIMS = routed
        res[row]["mma_ms"] = mma_ms
        wins.append(res[row]["ms"] < mma_ms)
        log(f"[route] d={d} {layout} {list(shape)}: flash_mma_narrow_kernel {mma_ms:.4f} ms, "
            f"{res[row]['kernel']} {res[row]['ms']:.4f} ms")
    verdict = "route d <= 32 to it" if all(wins) else "d <= 32 stays on flash_mma_narrow_kernel"
    log(f"[route] the wgmma kernel is faster at {sum(wins)} of {len(wins)} d <= 32 shapes: "
        f"{verdict}")


def attention_row(res, errs, row, kernel, shape, layout, kernel_fn, plain_fn, lib_fn,
                  replaces, qkv, counter=None):
    """Time one bfloat16 attention shape into res[row]: `row` names the JSON
    row, `kernel` the error record it reports and the launch counter it
    reads, or `counter` = (kernel, query rows) its launches at one shape."""
    b, h, n, d = shape
    flops = 4 * b * h * n * n * d
    nbytes = 4 * b * h * n * d * 2
    bms, by = bound(flops, nbytes, PEAK_BF16, exps=b * h * n * n)
    # The exponentials are operations too (on the SFU, at their own rate);
    # `bound_kind` says which limit it is. Times are device time
    # (torch.profiler), which leaves out the wrapper's host time; the
    # CUDA-event time per call (`event_ms`) is kept beside the kernel's.
    # `kernel` names the kernel the profile saw, and `source` its file.
    ms, port_kernel = device_ms(lambda: kernel_fn(*qkv), names=True)
    source = KERNEL_SOURCES.get(port_kernel, "flash_attention.cu")
    res[row] = dict(
        name=row, route="cuda", source=f"ealdm_torch/kernels/csrc/{source}",
        replaces=replaces, launches=None, max_abs_err=errs[kernel],
        ms=ms, plain_ms=device_ms(lambda: plain_fn(*qkv)),
        bound_ms=bms, bound_by="bytes" if by == "bytes" else "operations",
        bound_kind=by, library_ms=device_ms(lambda: lib_fn(*qkv)),
        event_ms=cuda_ms(lambda: kernel_fn(*qkv)), kernel=port_kernel,
        shape=list(shape), layout=layout, dtype="bfloat16", counter=counter or kernel)


def log_rows(rows):
    for r in rows.values():
        event = f" (event_ms {r['event_ms']:.4f})" if "event_ms" in r else ""
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        split = "".join(f" {k} {v:.4f}" for k, v in r.get("kernel_ms", {}).items())
        log(f"[time] {r['name']:32s} {r['shape']} {r.get('kernel', '')} kernel_ms {r['ms']:.4f}{event} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
            f"bound_ms {r['bound_ms']:.4f} ({r.get('bound_kind', r['bound_by'])})"
            + (f"; by kernel:{split}" if len(r.get("kernel_ms", {})) > 1 else ""))


def phase_group_norm():
    """The GroupNorm kernels against `group_norm_plain` at the main path's
    shapes, in both layouts the kernels take (channels_last, what the main
    path hands them, and NCHW-contiguous), both dtypes, plain and pre-bias +
    SiLU; then bfloat16 timings. Each row names the counter its launches
    moved: "group_norm" (one read of x) or "group_norm_two_pass" (two),
    suffixed "_nchw" for the NCHW kernels. Returns the JSON line's rows."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch import kernels
    from ealdm_torch.ops.norms import group_norm_kernel, group_norm_plain, silu

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf = torch.float32, torch.bfloat16
    errs = {}

    def randn(*shape, dtype=f32, layout="channels_last"):
        x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        if len(shape) == 4 and layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def run(x, *args):
        """The kernel's output and the row its launch counted under."""
        before = dict(kernels.launches)
        y = group_norm_kernel(x, *args)
        name = next(k for k in ("group_norm", "group_norm_two_pass")
                    if kernels.launches[k] != before[k])
        return y, name if x.is_contiguous(memory_format=torch.channels_last) else name + "_nchw"

    cases = [((48, 256, 32, 32), 1e-5), ((48, 512, 16, 16), 1e-5), ((48, 1024, 8, 8), 1e-5),
             ((48, 768, 32, 32), 1e-5), ((24, 128, 256, 256), 1e-6),
             ((48, 256, 128, 128), 1e-6), ((4, 3584, 6, 6), 1e-5), ((2, 128, 768, 768), 1e-6),
             ((9, 128, 512, 512), 1e-6)]
    for shape, eps in cases:
        c = shape[1]
        scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
        for layout, dtype in itertools.product(("channels_last", "nchw"), (f32, bf)):
            x = (3 * randn(*shape, layout=layout) + 1).to(dtype)
            pre = randn(shape[0], c, dtype=dtype)
            for fuse, p in ((False, None), (True, pre)):
                got, row = run(x, scale, bias, 32, eps, fuse, p)
                want = group_norm_plain(x, scale, bias, 32, eps, silu if fuse else None,
                                        "NCHW", p)
                compare(errs, row, dtype, got, want,
                        f"{list(shape)} {layout} {'pre_bias+SiLU' if fuse else 'plain'}")
    torch.cuda.synchronize()

    # -- bfloat16 timings. Inputs rotate over enough tensors to pass twice the
    #    L2, so each call reads them from device memory, as the main path's
    #    fresh activations are. Device time (torch.profiler) leaves out the
    #    wrapper's host time; the CUDA-event time per call is kept beside it.
    res = {}
    single = "ealdm_tpu/ops/group_norm_pallas.py:103"
    chunked = "ealdm_tpu/ops/group_norm_pallas.py:123"
    timed = [  # row, shape, eps, pre-bias, layout, the TPU kernel
        ("group_norm", (48, 256, 32, 32), 1e-5, True, "channels_last", single),
        ("group_norm_c768", (48, 768, 32, 32), 1e-5, False, "channels_last", single),
        ("group_norm_8x8", (48, 1024, 8, 8), 1e-5, True, "channels_last", single),
        ("group_norm_two_pass", (24, 128, 256, 256), 1e-6, False, "channels_last", chunked),
        ("group_norm_two_pass_b48", (48, 128, 256, 256), 1e-6, False, "channels_last",
         chunked),
        ("group_norm_nchw", (48, 256, 32, 32), 1e-5, True, "nchw", single),
        ("group_norm_two_pass_nchw", (24, 128, 256, 256), 1e-6, False, "nchw", chunked),
        # the RDM's widest UNet site (a skip joined at 6^2) and its largest
        # decoder sample (phase 15)
        ("group_norm_c3584", (4, 3584, 6, 6), 1e-5, False, "channels_last", single),
        ("group_norm_two_pass_768", (2, 128, 768, 768), 1e-6, False, "channels_last", chunked),
        # the super-resolution path's decode of 3x3 latent crops to 512^2 each
        # (phase 16, input b)
        ("group_norm_two_pass_512", (9, 128, 512, 512), 1e-6, False, "channels_last", chunked),
    ]
    for row, shape, eps, has_pre, layout, replaces in timed:
        n_, c = shape[:2]
        scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        numel = math.prod(shape)
        copies = max(1, math.ceil(2 * L2_BYTES / (2 * numel)))
        inputs = [(randn(*shape, dtype=bf, layout=layout),
                   randn(n_, c, dtype=bf) if has_pre else None) for _ in range(copies)]
        _, path_row = run(inputs[0][0], scale, bias, 32, eps, True, inputs[0][1])
        nbytes = 2 * numel * 2 + (n_ * c * 2 if has_pre else 0) + 2 * c * 4
        bms, by = bound(10 * numel, nbytes, PEAK_FP32)

        def rotate(fn):
            it = itertools.cycle(inputs)
            return lambda: fn(*next(it))

        def kernel(x, p):
            return group_norm_kernel(x, scale, bias, 32, eps, True, p)

        def plain(x, p):
            return group_norm_plain(x, scale, bias, 32, eps, silu, "NCHW", p)

        def lib(x, p):
            xin = x if p is None else x + p[:, :, None, None]
            return F.silu(F.group_norm(xin, 32, scale.to(x.dtype), bias.to(x.dtype), eps))

        iters = 20 if numel < 2e8 else 10
        split = device_ms_by_kernel(rotate(kernel), iters)
        res[row] = dict(
            name=row, route="cuda", source="ealdm_torch/kernels/csrc/group_norm.cu",
            replaces=replaces, launches=None, max_abs_err=errs[path_row],
            ms=sum(split.values()), kernel_ms=split, plain_ms=device_ms(rotate(plain), iters),
            bound_ms=bms, bound_by=by, library_ms=device_ms(rotate(lib), iters),
            event_ms=cuda_ms(rotate(kernel), iters), shape=list(shape), layout=layout,
            dtype="bfloat16", pre_bias=has_pre, silu=True, rotated_inputs=copies,
            counter=(path_row.removesuffix("_nchw"), (layout, shape, "bfloat16")))
        del inputs
    # the main rows count every launch of their kernel path
    for row in ("group_norm", "group_norm_two_pass"):
        res[row]["counter"] = row
    log_rows(res)
    return res


# ------------------------------------------------------------------ phase 2c
def phase_head_dims():
    """Flash attention at the head dims of the repo's other configurations:
    NARROW_HEAD_DIMS at [16, 8, N, d] with N = 1024 and 256, WIDE_HEAD_DIMS at
    [16, 1, 1024, d], the paths' shapes PATH_WIDE_SHAPES and ZOO_PATH_SHAPES
    (a `[route]` line each for the zoo's: kernel, library, bound), and
    DEEP_HEAD_DIMS at [4, 2, 1024, d] (flash_wgmma_deep_kernel in bfloat16,
    flash_tf32x3_kernel in float32, as the profile must see). Each against
    `flash_attention_plain` in bfloat16 (both limits of
    `bf16_attention_shares`) and float32 (1e-4), through the split and the
    packed entry point; then bfloat16 timings of the split one (a row each,
    bound and library call as phase 2's); then the gradients of q, k
    and v through FlashAttention at d = 48 against autograd through the
    dense sdpa (1e-5 of each gradient's largest element, as phase 6 (a)).
    Returns (the JSON line's rows, the largest gradient error)."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import (
        flash_attention, flash_attention_packed, flash_attention_plain, flash_counter, sdpa)

    gen = torch.Generator(device="cuda").manual_seed(12)
    f32, bf = torch.float32, torch.bfloat16
    errs = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def packed(t):  # [B, H, N, D] -> the projection-native [B, N, H*D]
        b, h, n, d = t.shape
        return t.transpose(1, 2).reshape(b, n, h * d).contiguous()

    cases = [(16, 8, n, d) for d in NARROW_HEAD_DIMS for n in (1024, 256)]
    cases += [(16, 1, 1024, d) for d in WIDE_HEAD_DIMS]
    cases += [*PATH_WIDE_SHAPES, *ZOO_PATH_SHAPES, *RDM_PATH_SHAPES, *SR_PATH_SHAPES]
    cases += [(4, 2, 1024, d) for d in DEEP_HEAD_DIMS]
    for shape in cases:
        name = flash_counter(shape[3])
        for dtype in (f32, bf):
            q, k, v = (randn(*shape, dtype=dtype) for _ in range(3))
            want = flash_attention_plain(q, k, v)
            compare(errs, name, dtype, flash_attention(q, k, v), want,
                    f"[B,H,N,D]={list(shape)}", attn=(q, k, v, None))
            pq, pk, pv = (packed(t) for t in (q, k, v))
            compare(errs, name, dtype, flash_attention_packed(pq, pk, pv, shape[1]), packed(want),
                    f"packed [B,N,HD], H={shape[1]}", attn=(pq, pk, pv, shape[1]))
            del q, k, v, want, pq, pk, pv
    torch.cuda.synchronize()

    res = {}
    for shape in cases:
        b, h, n, d = shape
        if shape in (*PATH_WIDE_SHAPES, *ZOO_PATH_SHAPES, *RDM_PATH_SHAPES, *SR_PATH_SHAPES):
            row = f"flash_attention_d{d}_b{b}_n{n}"
        else:
            row = f"flash_attention_d{d}_n{n}" if d in NARROW_HEAD_DIMS else flash_counter(d)
        qkv = [randn(*shape, dtype=bf) for _ in range(3)]
        attention_row(res, errs, row, flash_counter(d), shape, "contiguous [B,H,N,D]",
                      flash_attention, flash_attention_plain, F.scaled_dot_product_attention,
                      "ealdm_tpu/ops/attention.py:77", qkv, counter=(flash_counter(d), n))
        if d in DEEP_HEAD_DIMS:
            if res[row]["kernel"] != DEEP_WGMMA_KERNEL:
                raise RuntimeError(f"d={d} bf16: the profile saw {res[row]['kernel']}, "
                                   f"not {DEEP_WGMMA_KERNEL}")
            qkv32 = [t.float() for t in qkv]
            _, seen = device_ms(lambda: flash_attention(*qkv32), iters=2, names=True)
            if F32_KERNEL not in seen.split("+"):
                raise RuntimeError(f"d={d} float32: the profile saw {seen}, not {F32_KERNEL}")
            del qkv32
        if shape in (*ZOO_PATH_SHAPES, *RDM_PATH_SHAPES, *SR_PATH_SHAPES):
            r = res[row]
            where = ("zoo" if shape in ZOO_PATH_SHAPES else
                     "rdm" if shape in RDM_PATH_SHAPES else "superres")
            log(f"[route] {where} path {list(shape)}: {r['kernel']} {r['ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_kind']})")
        del qkv

    route_deep_heads(res, errs, randn)
    float32_heads(res, errs, randn)
    route_wide_heads(errs, randn)
    # the wgmma kernels' ragged edges at the paths' head dims: a partial
    # query block and a partial key tile
    for d in (*NARROW_HEAD_DIMS, 64, 96, 384, 512, 576, *DEEP_HEAD_DIMS):
        q = randn(2, 3, 1000, d, dtype=bf)
        k, v = randn(2, 3, 77, d, dtype=bf), randn(2, 3, 77, d, dtype=bf)
        want = flash_attention_plain(q, k, v)
        compare(errs, flash_counter(d), bf, flash_attention(q, k, v), want,
                "ragged Nq=1000 Nk=77", attn=(q, k, v, None))
        if d in DEEP_HEAD_DIMS:  # and packed: the cluster's column slices of each head
            pq, pk, pv = (packed(t) for t in (q, k, v))
            compare(errs, flash_counter(d), bf, flash_attention_packed(pq, pk, pv, 3),
                    packed(want), "packed, ragged Nq=1000 Nk=77", attn=(pq, pk, pv, 3))
    host = host_cost()

    worst = 0.0
    for shape, dtype in itertools.product(((16, 8, 256, 48), (4, 1, 1024, 384)), (f32, bf)):
        d = shape[3]
        qkv = [randn(*shape, dtype=dtype) for _ in range(3)]
        g = randn(*shape, dtype=dtype)
        outs = {}
        for how, fn in (("kernel", flash_attention), ("plain", sdpa)):
            inputs = [t.detach().requires_grad_() for t in qkv]
            y = fn(*inputs)
            outs[how] = (y, torch.autograd.grad(y, inputs, g))
        y, grads = outs["kernel"]
        if y.grad_fn is None or type(y.grad_fn).__name__ != "FlashAttentionBackward":
            raise RuntimeError(f"flash d={d} output grad_fn {y.grad_fn}")
        rel = [rel_err_to_max(a, b) for a, b in zip(grads, outs["plain"][1])]
        worst = max(worst, *rel)
        log(f"  flash_attention_d{d} gradients {list(shape)} {str(dtype)[6:]}: dq, dk, dv "
            f"errors / max {[f'{e:.2g}' for e in rel]} (tolerance 1e-5)")
        if not all(math.isfinite(e) and e <= 1e-5 for e in rel):
            raise RuntimeError(f"flash d={d} gradients disagree with the plain version")
    for (d, n), us in host.items():
        row = res.get(f"flash_attention_d{d}_n{n}")
        if row is not None:
            row["host_us"] = us
    log_rows(res)
    return res, worst


def route_wide_heads(errs, randn):
    """flash_wgmma_wide_kernel (`ops.attention.WIDE_WGMMA_HEAD_DIMS`) at the
    paths' wide sites, WIDE_ROUTE_SHAPES: each held to both bf16 limits,
    checked to be the kernel the profile sees and timed in device time
    beside the library call. Logs a [route] line a shape."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import flash_attention, flash_attention_plain, flash_counter

    bf = torch.bfloat16
    for shape in WIDE_ROUTE_SHAPES:
        b, h, n, d = shape
        qkv = [randn(*shape, dtype=bf) for _ in range(3)]
        compare(errs, flash_counter(d), bf, flash_attention(*qkv), flash_attention_plain(*qkv),
                f"{list(shape)}", attn=(*qkv, None))
        ms, seen = device_ms(lambda: flash_attention(*qkv), names=True)
        if seen != WIDE_WGMMA_KERNEL:
            raise RuntimeError(f"{list(shape)}: the profile saw {seen}, not {WIDE_WGMMA_KERNEL}")
        lib = device_ms(lambda: F.scaled_dot_product_attention(*qkv))
        bms, by = bound(4 * b * h * n * n * d, 4 * b * h * n * d * 2, PEAK_BF16, exps=b * h * n * n)
        log(f"[route] d={d} {list(shape)}: {WIDE_WGMMA_KERNEL} {ms:.4f} ms, library "
            f"{lib:.4f} ms, bound {bms:.4f} ms ({by})")
        del qkv


def route_deep_heads(res, errs, randn):
    """The deep wgmma kernel (routed: d = 584 .. 1,920) at [4, 2, 1024, d]
    for d = 640 (held to both bf16 limits and checked to be the kernel the
    profile sees, as the DEEP_HEAD_DIMS rows were) and the DEEP_HEAD_DIMS:
    adds a row for d = 640 and logs a `[route]` line a head dim (kernel,
    library, bound)."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import flash_attention, flash_attention_plain, flash_counter

    bf = torch.bfloat16
    shape = (4, 2, 1024, 640)
    qkv = [randn(*shape, dtype=bf) for _ in range(3)]
    compare(errs, flash_counter(640), bf, flash_attention(*qkv), flash_attention_plain(*qkv),
            f"{list(shape)}", attn=(*qkv, None))
    attention_row(res, errs, flash_counter(640), flash_counter(640), shape,
                  "contiguous [B,H,N,D]", flash_attention, flash_attention_plain,
                  F.scaled_dot_product_attention, "ealdm_tpu/ops/attention.py:77", qkv,
                  counter=(flash_counter(640), shape[2]))
    del qkv
    for d in (640, *DEEP_HEAD_DIMS):
        row = res[flash_counter(d)]
        if row["kernel"] != DEEP_WGMMA_KERNEL:
            raise RuntimeError(f"d={d} bf16: the profile saw {row['kernel']}, "
                               f"not {DEEP_WGMMA_KERNEL}")
        log(f"[route] deep head {row['shape']}: {DEEP_WGMMA_KERNEL} {row['ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_kind']})")


def float32_heads(res, errs, randn):
    """The float32 kernel (split TF32, `flash_tf32x3_kernel`, and its
    combine where the entry splits the keys) at every head of
    `probe_flash.F32_SHAPES`, held to 1e-4 against the plain version and
    timed in device time beside the plain version and the library call,
    with the bound of three TF32 terms a product at 495 TFLOP/s. A row
    each, under the float32 counter at its rows (of the paths, only
    first-stage training runs float32 flash: d = 512 at 1,024 rows; the
    float32 card-vs-CPU passes are checks, not paths). Then bfloat16 at
    [2, 2, 1024, 1928], past the deep wgmma kernel's 1,920, on the same
    kernel (S in one term,
    bfloat16 being exact in TF32, P V in two), held to both bf16 limits and
    bound by the bfloat16 function's operations at 989 TFLOP/s, as every
    other bfloat16 row is."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.kernels.probe_flash import BF16_DEEP_SHAPE, F32_SHAPES
    from ealdm_torch.ops.attention import flash_attention, flash_attention_plain, flash_counter

    for shape, dtype in [*((s, torch.float32) for s in F32_SHAPES),
                         (BF16_DEEP_SHAPE, torch.bfloat16)]:
        b, h, n, d = shape
        qkv = [randn(*shape, dtype=dtype) for _ in range(3)]
        row = f"flash_attention_{'f32' if dtype == torch.float32 else 'bf16'}_d{d}_b{b}_n{n}"
        got, want = flash_attention(*qkv), flash_attention_plain(*qkv)
        compare(errs, row, dtype, got, want, f"{list(shape)}", attn=(*qkv, None))
        errs[row] = (got.float() - want.float()).abs().max().item()
        ms, seen = device_ms(lambda: flash_attention(*qkv), names=True)
        if F32_KERNEL not in seen.split("+"):
            raise RuntimeError(f"{dtype} {list(shape)}: the profile saw {seen}, not {F32_KERNEL}")
        # float32 needs three TF32 terms a product to hold 1e-4; bfloat16
        # attention is the function's own operations at the bfloat16 peak
        flops, peak = ((3 * 4 * b * h * n * n * d, PEAK_TF32) if dtype == torch.float32
                       else (4 * b * h * n * n * d, PEAK_BF16))
        bms, by = bound(flops, 4 * b * h * n * d * qkv[0].element_size(), peak,
                        exps=b * h * n * n)
        res[row] = dict(
            name=row, route="cuda", source="ealdm_torch/kernels/csrc/flash_attention_sm90_f32.cu",
            replaces="ealdm_tpu/ops/attention.py:77", launches=None,
            max_abs_err=errs[row], ms=ms, plain_ms=device_ms(lambda: flash_attention_plain(*qkv)),
            bound_ms=bms, bound_by="bytes" if by == "bytes" else "operations", bound_kind=by,
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(*qkv)),
            event_ms=cuda_ms(lambda: flash_attention(*qkv)), kernel=seen, shape=list(shape),
            layout="contiguous [B,H,N,D]", dtype=str(dtype).removeprefix("torch."),
            counter=(flash_counter(d, dtype=dtype), n))
        log(f"[route] {str(dtype)[6:]} {list(shape)}: {seen} {ms:.4f} ms, plain "
            f"{res[row]['plain_ms']:.4f} ms, library {res[row]['library_ms']:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), max_abs_err {errs[row]:.3g}")
        del qkv, got, want


def host_cost(calls=1000):
    """The bfloat16 flash wrapper's host time per call, in microseconds: wall
    time of `calls` back-to-back `flash_attention` calls without a
    synchronize, divided by the calls, at [16,8,256,80] (d=80: the wgmma
    kernel, three tensor maps encoded a call, where the kernel has them) and
    [16,8,256,32] (d=32: the mma.sync kernel, none). The device finishes a
    call faster than the host issues one (checked), so the launch queue
    never fills and the wall is host time. Then the GroupNorm wrapper the same
    way at [16,256,16,16] (channels_last bfloat16, fused SiLU), and, where
    the tree has the dispatcher operators, `operator_cost`. Runs in older
    trees too (`--host`). Returns {(d, rows) or ("group_norm", C): us},
    with `operator_cost`'s entries."""
    import torch

    from ealdm_torch.ops.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for shape in ((16, 8, 256, 80), (16, 8, 256, 32)):
        qkv = [torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
        for _ in range(20):
            flash_attention(*qkv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            flash_attention(*qkv)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        dev_us = device_ms(lambda: flash_attention(*qkv)) * 1e3
        if dev_us >= us:
            raise RuntimeError(f"host cost at {shape}: the device ({dev_us:.1f} us a call) "
                               f"is slower than the host ({us:.1f} us): the queue fills")
        log(f"[host] flash_attention {list(shape)} bf16: {us:.2f} us of host time a call "
            f"over {calls} calls (device {dev_us:.2f} us a call)")
        out[(shape[3], shape[2])] = us
    # the GroupNorm wrapper as the UNet calls it: channels_last bf16 [16,256,16,16]
    # (the flagship's ds-2 sites at the CFG batch), fused SiLU
    from ealdm_torch.ops.norms import group_norm, silu

    x = torch.randn(16, 256, 16, 16, generator=gen, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w, b = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")

    def gn():
        return group_norm(x, w, b, 32, 1e-5, act=silu, data_format="NCHW")

    for _ in range(20):
        gn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        gn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    dev_us = device_ms(gn) * 1e3
    log(f"[host] group_norm [16,256,16,16] bf16 channels_last SiLU: {us:.2f} us of host time "
        f"a call over {calls} calls (device {dev_us:.2f} us a call)")
    out[("group_norm", 256)] = us
    if hasattr(torch.ops.ealdm, "group_norm"):  # trees with the dispatcher operators
        out.update(operator_cost(qkv, x, w, b))
    return out


def operator_cost(qkv, x, w, b, pairs=10, calls=500):
    """The dispatcher operators' round trip: host us a call of the launch
    through `torch.ops.ealdm.*` and of the same launch called directly, in
    `pairs` interleaved pairs of `calls` calls each (the order alternating
    within a pair), on the d=32 flash inputs and the GroupNorm input of
    `host_cost`. Returns {(name, "operator" or "direct"): [us per pair]}."""
    import statistics

    import torch

    from ealdm_torch.ops.attention import flash_attention_kernel
    from ealdm_torch.ops.norms import group_norm_kernel

    cases = {
        "flash_attention [16,8,256,32]": (
            lambda: torch.ops.ealdm.flash_attention.default(*qkv, None),
            lambda: flash_attention_kernel(*qkv, None)),
        "group_norm [16,256,16,16] SiLU": (
            lambda: torch.ops.ealdm.group_norm.default(x, w, b, None, 32, 1e-5, True),
            lambda: group_norm_kernel(x, w, b, 32, 1e-5, True, None)),
    }

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for name, (op, direct) in cases.items():
        for _ in range(20):
            op(), direct()
        got = {"operator": [], "direct": []}
        for i in range(pairs):
            order = ("operator", "direct") if i % 2 == 0 else ("direct", "operator")
            for which in order:
                got[which].append(host_us(op if which == "operator" else direct))
        diff = [a - b for a, b in zip(got["operator"], got["direct"])]
        log(f"[host-op] {name}: operator {[round(u, 2) for u in got['operator']]} us, direct "
            f"{[round(u, 2) for u in got['direct']]} us a call; operator minus direct median "
            f"{statistics.median(diff):.2f} us (min {min(diff):.2f}, max {max(diff):.2f}), "
            f"{sum(d > 0 for d in diff)} of {pairs} pairs slower through the operator")
        out.update({(name, k): v for k, v in got.items()})
    return out


# ------------------------------------------------------------------ phase 2b
def phase_ops():
    """The op library entry point at full width. Returns the bias_act row
    of the JSON line, with `launches` from the op-path run: one
    filtered_lrelu call (two bias_act launches) and one
    EqualizedDense(lrelu) call (one)."""
    import torch

    from ealdm_torch import kernels, ops
    from ealdm_torch.models.stdiff import EqualizedDense
    from ealdm_torch.ops.bias_act import bias_act_kernel, bias_act_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    f32, bf, fp16 = torch.float32, torch.bfloat16, torch.float16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def check(dtype, got, want, what):
        compare(errs, "bias_act", dtype, got, want, what)

    # -- the kernel against bias_act_plain
    nhwc, nchw = (48, 32, 32, 256), (48, 256, 32, 32)
    b256 = randn(256)
    for dtype in (f32, bf):
        x = (2 * randn(*nhwc)).to(dtype)
        for act in ops.activation_funcs:
            check(dtype, bias_act_kernel(x, b256, act=act), bias_act_plain(x, b256, act=act),
                  f"{act} {list(nhwc)} bias")
        x = (2 * randn(*nchw)).to(dtype)
        check(dtype, bias_act_kernel(x, b256, dim=1, act="lrelu"),
              bias_act_plain(x, b256, dim=1, act="lrelu"), f"lrelu {list(nchw)} dim=1")
        kw = dict(act="swish", gain=0.7, clamp=1.5)
        check(dtype, bias_act_kernel(x, b256, dim=1, **kw), bias_act_plain(x, b256, dim=1, **kw),
              "swish gain 0.7 clamp 1.5 dim=1")
        x, b13 = randn(7, 13, 129, dtype=dtype), randn(13)
        for act in ("lrelu", "softplus", "selu"):
            check(dtype, bias_act_kernel(x, b13, dim=1, act=act, clamp=2.0),
                  bias_act_plain(x, b13, dim=1, act=act, clamp=2.0),
                  f"{act} ragged [7,13,129] dim=1 clamp 2")
    x = randn(*nhwc, dtype=fp16)
    check(fp16, bias_act_kernel(x, b256, act="lrelu"), bias_act_plain(x, b256, act="lrelu"),
          f"lrelu {list(nhwc)} bias")

    # -- first- and second-order gradients: the autograd path (kernel
    #    forward, plain backward) against the plain version
    grads = {}
    x0, b0 = randn(4, 8, 8, 32), randn(32)
    for name, fn in (("kernel", ops.bias_act), ("plain", bias_act_plain)):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y = fn(x, b, act="swish", clamp=3.0)
        (g,) = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
        grads[name] = (g, *torch.autograd.grad((g ** 2).sum(), (x, b)))
    for what, got, want in zip(("dx", "d2x", "d2b"), grads["kernel"], grads["plain"]):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        log(f"  bias_act autograd {what}: max diff / max|plain| {rel:.3g} (tolerance 1e-5)")
        if not rel <= 1e-5:
            raise RuntimeError(f"bias_act {what} disagrees with the plain version: {rel:.3g}")

    # -- the op path: filtered_lrelu and EqualizedDense, launches counted
    fir = ops.setup_filter([1, 3, 3, 1])
    fl_kw = dict(up=2, down=2, padding=3)
    x_fl = randn(*nhwc, dtype=bf)
    dense = EqualizedDense(512, 512, activation="lrelu", lr_multiplier=0.01).cuda()
    with torch.no_grad():
        dense.weight.copy_(randn(512, 512) * 100)
        dense.bias.copy_(randn(512))
    w = randn(48, 512)

    def flrelu_plain(x, b):
        y = ops.upfirdn2d(bias_act_plain(x, b), fir, up=2, padding=3, gain=4)
        return ops.upfirdn2d(bias_act_plain(y, None, act="lrelu", gain=math.sqrt(2)),
                             fir, down=2).to(x.dtype)

    kernels.reset_launch_counts()
    y_fl = ops.filtered_lrelu(x_fl, fir, fir, b256, **fl_kw)
    torch.cuda.synchronize()
    fl_launches = kernels.launches["bias_act"]
    with torch.no_grad():
        y_d = dense(w)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"[ops] launches {counts}: filtered_lrelu {fl_launches}, EqualizedDense(lrelu) "
        f"{counts['bias_act'] - fl_launches}")
    if fl_launches != 2 or counts["bias_act"] != 3:
        raise RuntimeError("expected 2 bias_act launches per filtered_lrelu call and 1 per "
                           f"EqualizedDense(lrelu) call, got {counts}")
    if any(n for k, n in counts.items() if k != "bias_act"):
        raise RuntimeError(f"the op path launched other kernels: {counts}")
    if tuple(y_fl.shape) != nhwc or y_fl.dtype != bf:
        raise RuntimeError(f"filtered_lrelu gave {tuple(y_fl.shape)} {y_fl.dtype}")
    check(bf, y_fl, flrelu_plain(x_fl, b256), f"filtered_lrelu {list(nhwc)}")
    with torch.no_grad():
        h = w @ (dense.weight.T * (0.01 / math.sqrt(512)))
        check(f32, y_d, bias_act_plain(h, dense.bias * 0.01, act="lrelu"),
              "EqualizedDense(lrelu) [48,512]")

    # -- float32 on the card (kernels) against the CPU (plain versions)
    xs, bs = randn(2, 16, 16, 32), randn(32)
    got = ops.filtered_lrelu(xs, fir, fir, bs, clamp=1.0, **fl_kw).cpu()
    want = ops.filtered_lrelu(xs.cpu(), fir, fir, bs.cpu(), clamp=1.0, **fl_kw)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[ops] filtered_lrelu float32 card vs CPU: max diff / max|y| {rel:.3g} "
        f"(tolerance 1e-5)")
    if not rel <= 1e-5:
        raise RuntimeError("filtered_lrelu on the card disagrees with the CPU")

    # -- timings, bfloat16: (a) linear + bias, (b) lrelu + bias + gain +
    #    clamp, (c) filtered_lrelu's middle stage
    x_a = randn(*nhwc, dtype=bf)
    b_bf = b256.to(bf)
    x_c = randn(48, 67, 67, 256, dtype=bf)
    cases = {
        "a": (x_a, b256, dict(act="linear"), 1, lambda: torch.add(x_a, b_bf)),
        "b": (x_a, b256, dict(act="lrelu", gain=math.sqrt(2), clamp=256.0), 6, None),
        "c": (x_c, None, dict(act="lrelu", gain=math.sqrt(2)), 3, None),
    }
    timed = {}
    for key, (x, b, kw, ops_per_elem, lib) in cases.items():
        nbytes = 2 * x.numel() * x.element_size() + (0 if b is None else b.numel() * 4)
        bms, by = bound(ops_per_elem * x.numel(), nbytes, PEAK_FP32)
        timed[key] = dict(
            shape=list(x.shape), dtype="bfloat16", **kw, bias=b is not None,
            ms=device_ms(lambda: bias_act_kernel(x, b, **kw)),
            plain_ms=device_ms(lambda: bias_act_plain(x, b, **kw)),
            library_ms=None if lib is None else device_ms(lib),
            event_ms=cuda_ms(lambda: bias_act_kernel(x, b, **kw), iters=50),
            bound_ms=bms, bound_by=by)
        t = timed[key]
        lib_txt = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"[time] bias_act ({key}) {t['shape']} {kw} bias={t['bias']}: kernel_ms "
            f"{t['ms']:.4f} (event_ms {t['event_ms']:.4f}) plain_ms {t['plain_ms']:.4f} "
            f"library_ms {lib_txt} bound_ms {t['bound_ms']:.4f} ({t['bound_by']})")
    a = timed["a"]
    return dict(
        name="bias_act", route="cuda", source="ealdm_torch/kernels/csrc/bias_act.cu",
        replaces="ealdm_tpu/ops/bias_act.py:100", launches=counts["bias_act"],
        max_abs_err=errs["bias_act"], ms=a["ms"], plain_ms=a["plain_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
        shape=a["shape"], dtype="bfloat16", cases=timed)


# ------------------------------------------------------------------ phase 3+
def random_init_(model, seed):
    """`ealdm_torch.utils.init.random_init_`'s seeded random weights, drawn
    on the model's device (`on_device`): the host's draws took 6-7 ns a
    parameter, 9.7 s for txt2img's 1.5 B. Every card-against-CPU check copies
    the card model's weights, so nothing depends on the host's draws."""
    from ealdm_torch.utils.init import random_init_ as init

    init(model, seed, on_device=True)


def mixed_batch(b, res, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    return {
        "img": torch.randn(b, res, res, 3, generator=g).to(device),
        "img_random": torch.randn(b, res, res, 3, generator=g).to(device),
        "flow": torch.randn(b, 1, 1, generator=g).to(device),
        "weather": torch.randn(b, 1, 16, generator=g).to(device),
        "time": torch.rand(b, 1, generator=g).to(device),
    }


def child_sides(module, side):
    """(child, the side of its input, the side it hands on) of each child
    of `module` run on a [N, C, side, side] input, from the module tree:
    children run in the order they were registered, and a resampling child
    (Downsample / Upsample, or a ResBlock with up / down) halves or doubles
    the side for the children after it."""
    from ealdm_torch.models.layers import Downsample, ResBlock, Upsample
    from ealdm_torch.models.vae import VaeDownsample, VaeUpsample

    for child in module.children():
        new = side
        if isinstance(child, (Downsample, VaeDownsample)):
            new = side // 2
        elif isinstance(child, (Upsample, VaeUpsample)):
            new = side * 2
        elif isinstance(child, ResBlock) and child.resample is not None:
            new = side * 2 if child.resample == "up" else side // 2
        yield child, side, new
        side = new


def group_norm_sites(module, side):
    """(C, side, groups) of every GroupNorm32 one forward of `module` runs on
    a [N, C, side, side] input (`child_sides`), each GroupNorm32 inside a
    child once; a resampling ResBlock's in_norm at the side before its
    resample, its out_norm after."""
    from ealdm_torch.models.layers import GroupNorm32, ResBlock

    sites = []
    for child, s, new in child_sides(module, side):
        if isinstance(child, ResBlock) and child.resample is not None:
            sites += [(n.weight.numel(), t, n.num_groups)
                      for n, t in ((child.in_norm, s), (child.out_norm, new))]
        else:
            sites += [(m.weight.numel(), s, m.num_groups) for m in child.modules()
                      if isinstance(m, GroupNorm32)]
    return sites


def phase_main_path(cfg_module, steps, batch):
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.FLAGSHIP
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] LatentDiffusion flagship, {n_params / 1e6:.1f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    mixed = mixed_batch(batch, cfg["res"], seed=1, device="cuda")
    latent = (cfg["zres"], cfg["zres"], 4)

    def run(steps_, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return sample_images(model, batch, latent, steps=steps_, eta=1.0,
                             guidance_scale=2.0, mixed=mixed, hoist=True, generator=g)

    t0 = time.perf_counter()
    run(steps, 2)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    img, z = run(steps, 2)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts, details = dict(kernels.launches), dict(kernels.launch_details)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # two more timed runs: the host's time per run varies from run to run,
    # and img/s is the median run's
    for _ in range(2):
        t0 = time.perf_counter()
        run(steps, 2)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    dt = sorted(walls)[1]
    if tuple(img.shape) != (batch, cfg["res"], cfg["res"], 3):
        raise RuntimeError(f"output shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or not bool(torch.isfinite(z).all()):
        raise RuntimeError("non-finite output")
    if float(img.float().std()) == 0.0:
        raise RuntimeError("constant output")
    log(f"[main] batch {batch}, DDIM-{steps}, eta 1, CFG 2: {dt:.3f} s "
        f"= {batch / dt:.4f} img/s, the median of {[round(w, 4) for w in walls]} s "
        f"(warm-up {warm_s:.1f} s), peak memory "
        f"{peak_gb:.2f} GiB, output {list(img.shape)} std {float(img.float().std()):.4f}")
    # the UNet once a step on the 2N CFG batch, the encoder once (the 2N
    # conditioning pair), the decoder once
    fs = model.first_stage_model
    want = path_census([(model.model.diffusion_model, 2 * batch, cfg["zres"], steps),
                        (fs.encoder, 2 * batch, cfg["res"], 1),
                        (fs.decoder, batch, cfg["zres"], 1)])
    log("[main] GroupNorm launches by path, layout, [N, C, H, W] and dtype, counted at "
        "the launch (expected from the module tree):")
    for key in sorted(k for k in set(details) | set(want) if k[0].startswith("group_norm")):
        log(f"  {key[0]:20s} {key[1][0]:14s} {str(list(key[1][1])):22s} {key[1][2]}: "
            f"{details.get(key, 0)} ({want.get(key, 0)})")
    check_launches("main", want, details)
    d32_by_rows = {n: c for (name, n), c in sorted(details.items())
                   if name == "flash_attention_d32"}
    log(f"[main] the d=32 flash launches by query rows {d32_by_rows}")
    return model, mixed, details, dict(
        img_per_s=batch / dt, seconds=dt, walls_s=walls, peak_gib=peak_gb, warmup_s=warm_s,
        launches=counts, d32_launches_by_rows=d32_by_rows)


def phase_profile(model, mixed, batch, steps, unprofiled_s):
    """One main-path run under torch.profiler: device time by kernel, and the
    device's idle share against the unprofiled timed run (the profiler slows
    the host)."""
    import torch

    from ealdm_torch.inference import sample_images

    g = torch.Generator(device="cuda").manual_seed(2)
    prof = profile_groups(
        lambda: sample_images(model, batch, (32, 32, 4), steps=steps, eta=1.0,
                              guidance_scale=2.0, mixed=mixed, hoist=True, generator=g),
        "profile", unprofiled_s)
    busy, totals = prof["device_busy_s"], prof["device_s_by_group"]
    return dict(device_busy_s=busy, idle_share=prof["idle_share"],
                profiled_wall_s=prof["profiled_wall_s"], flash_s=totals["flash attention"],
                flash_share=totals["flash attention"] / busy,
                group_norm_s=totals["group_norm"], group_norm_share=totals["group_norm"] / busy)


def phase_packed(model, mixed, batch, steps):
    import collections

    import torch

    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.ops.attention import set_attention_impl

    latent = (32, 32, 4)
    out = {}
    counts = None
    for impl in ("flash", "flash_packed"):
        set_attention_impl(impl)
        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(5)
        img, z = sample_images(model, batch, latent, steps=steps, eta=1.0,
                               guidance_scale=2.0, mixed=mixed, hoist=True, generator=g)
        torch.cuda.synchronize()
        out[impl] = (img.float(), z.float())
        if impl == "flash_packed":
            counts = collections.Counter(kernels.launches)
    set_attention_impl("flash")
    if counts["flash_attention_packed_d32"] == 0:
        raise RuntimeError("flash_attention_packed_d32 was not launched")
    if counts["flash_attention_d32"] != 0:
        raise RuntimeError("the packed run still launched the split-layout kernel in the UNet")
    z_f, z_p = out["flash"][1], out["flash_packed"][1]
    rel = ((z_p - z_f).abs().max() / z_f.abs().max()).item()
    img_diff = (out["flash"][0] - out["flash_packed"][0]).abs().mean().item()
    log(f"[packed] {steps} steps at batch {batch}: launches {counts}; latent max "
        f"diff / max|z| = {rel:.3g} (tolerance 5e-2), image mean abs diff {img_diff:.3g}")
    # Same kernel at the self-attention sites; the cross-attention differs
    # (block-diagonal tiny-context form vs dense sdpa), rounding at other
    # places in bf16, and the random-weight chain amplifies it.
    if not math.isfinite(rel) or rel > 5e-2:
        raise RuntimeError(f"packed and flash runs disagree: {rel:.3g}")
    return counts


def phase_reference(cfg_module, bf16_model):
    """Flagship width, batch 1, 2 DDIM steps, float32: the card with its
    kernels against the CPU with the plain versions, same weights, x_T and
    noise; then one decode of the same VQ codes on both. TF32 is off for
    the library's matmuls and convolutions; the flash kernel computes in
    split TF32 (three TF32 terms a product, about 1e-6 from float32)."""
    import torch

    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_module.FLAGSHIP
    kw = cfg_module.model_kwargs(cfg)
    sd = {k: v.float() for k, v in bf16_model.state_dict().items()}
    models = {}
    for dev in ("cpu", "cuda"):
        m = LatentDiffusion(**kw, dtype=torch.float32, device=dev).eval()
        m.load_state_dict(sd)
        models[dev] = m
    g = torch.Generator(device="cpu").manual_seed(9)
    x_T = torch.randn(1, 32, 32, 4, generator=g)
    noise = [torch.randn(1, 32, 32, 4, generator=g) for _ in range(2)]
    mixed = mixed_batch(1, cfg["res"], seed=4, device="cpu")
    z = {}
    for dev, m in models.items():
        z[dev] = sample_images(
            m, 1, (32, 32, 4), steps=2, eta=1.0, guidance_scale=2.0,
            mixed={k: v.to(dev) for k, v in mixed.items()}, x_T=x_T.to(dev),
            noise_fn=lambda i, shape: noise[i], decode=False, device=dev).float().cpu()
    rel = ((z["cuda"] - z["cpu"]).abs().max() / z["cpu"].abs().max()).item()
    with torch.no_grad():
        codes = models["cpu"].first_stage_model.quantize(z["cpu"])[2][2]
        imgs = {dev: m.first_stage_model.decode(
            m.first_stage_model.quantize.embed_code(codes.to(dev))).float().cpu()
            for dev, m in models.items()}
    img_err = (imgs["cuda"] - imgs["cpu"]).abs().max().item()
    img_scale = imgs["cpu"].abs().max().item()
    log(f"[reference] float32 card vs CPU: latent max diff / max|z| {rel:.3g} "
        f"(tolerance 1e-3); decoded image max abs diff {img_err:.3g} of max "
        f"{img_scale:.3g} (tolerance 1e-3 of max)")
    # float32 on both sides; convolution algorithms and sum orders differ
    # (cuDNN vs oneDNN), and the first DDIM step scales the latent by
    # 1/sqrt(alpha) ~ 14.
    if not (rel <= 1e-3 and img_err <= 1e-3 * img_scale):
        raise RuntimeError("the card's float32 result disagrees with the CPU reference")


# ------------------------------------------------------------------ phases 7-10
def flash_sites(module, side, runs, census, dtype="bfloat16"):
    """Add to `census` the flash launches of `runs` forwards of `module` in
    `dtype` on a [N, C, side, side] input: every eligible self-attention site
    (AttentionBlock, SpatialTransformer per depth, VaeAttnBlock) under its
    head dim's counter and the tokens of the side it runs at
    (`child_sides`; not the module's build-time `tokens`: a VAE decodes
    latents larger than its config's resolution)."""
    import torch

    from ealdm_torch.models.layers import AttentionBlock, SpatialTransformer, flash_eligible
    from ealdm_torch.models.vae import VaeAttnBlock
    from ealdm_torch.ops.attention import flash_counter

    for child, s, _ in child_sides(module, side):
        for m in child.modules():
            if isinstance(m, AttentionBlock):
                d, k = m.head_dim, 1
            elif isinstance(m, SpatialTransformer):
                d, k = m.block(0).attn1.dim_head, m.depth
            elif isinstance(m, VaeAttnBlock):
                d, k = m.q.weight.shape[0], 1
            else:
                continue
            if flash_eligible(s * s, s * s):
                census[(flash_counter(d, dtype=getattr(torch, dtype)), s * s)] += k * runs


def path_census(passes, dtype="bfloat16"):
    """{(counter, detail): launches} of a run in `dtype` whose forwards are
    `passes` = [(module, batch, input side, runs)], from the module tree:
    each GroupNorm32 once a forward on the path `group_norm_path` gives its
    channels_last shape, each eligible attention site once."""
    import collections

    import torch

    from ealdm_torch.ops.norms import group_norm_path, resolve_num_groups

    census = collections.Counter()
    for module, n, side, runs in passes:
        for c, s, groups in group_norm_sites(module, side):
            shape = (n, c, s, s)
            path = group_norm_path(shape, getattr(torch, dtype), resolve_num_groups(c, groups))
            census[(path, ("channels_last", shape, dtype))] += runs
        flash_sites(module, side, runs, census, dtype)
    return dict(census)


def check_launches(label, want, got=None):
    """Raise unless `got`, the launches since the last reset unless given,
    are `want` exactly; log them by counter (GroupNorm by path, flash by
    head dim)."""
    import collections

    from ealdm_torch import kernels

    got = dict(kernels.launch_details) if got is None else got
    totals = collections.Counter()
    for (name, _), n in got.items():
        totals[name] += n
    log(f"[{label}] launches {dict(sorted(totals.items()))}")
    for key in sorted(set(got) | set(want), key=str):
        if got.get(key, 0) != want.get(key, 0):
            log(f"  {str(key):72s} {got.get(key, 0)} (module tree {want.get(key, 0)})")
    if got != want:
        raise RuntimeError(f"{label}: launch counts differ from the module tree's")
    return got


def hold_sites(label, fn, grad=False):
    """Run fn (under no_grad unless `grad`: a train step) with every
    GroupNorm and flash kernel launch held against its plain version on the
    same inputs (the shapes, strides and layouts the path gives it):
    bfloat16 flash by both limits of `bf16_attention_shares`, the rest by
    `tolerance`. Logs each site's worst share and raises if any exceeds 1,
    or if a launch went unheld (a float32 flash launch's key-split combine
    is part of it). Returns {site: worst share}."""
    import contextlib

    import torch

    from ealdm_torch import kernels
    from ealdm_torch.ops import attention, norms

    kernel_gn, kernel_flash = norms.group_norm_kernel, attention.flash_attention_kernel
    sites, held = {}, [0]

    def note(key, share):
        sites[key] = max(sites.get(key, 0.0), share)
        held[0] += 1

    def gn(x, scale, bias, num_groups, eps, fuse_silu, pre_bias=None):
        y = kernel_gn(x, scale, bias, num_groups, eps, fuse_silu, pre_bias)
        want = norms.group_norm_plain(x, scale, bias, num_groups, eps,
                                      norms.silu if fuse_silu else None, "NCHW",
                                      None if pre_bias is None else pre_bias.to(x.dtype))
        note((norms.group_norm_path(x.shape, x.dtype, num_groups), tuple(x.shape),
              f"C/G {x.shape[1] // num_groups}"),
             ((y.float() - want.float()).abs() / tolerance(x.dtype, want)).max().item())
        return y

    def flash(q, k, v, scale=None):
        o = kernel_flash(q, k, v, scale)
        want = attention.flash_attention_plain(q, k, v, scale)
        if q.dtype == torch.bfloat16:
            share = max(attention.bf16_attention_shares(o, q, k, v, want, scale=scale))
        else:
            share = ((o.float() - want.float()).abs() / tolerance(q.dtype, want)).max().item()
        note((attention.flash_counter(q.shape[3], dtype=q.dtype), tuple(q.shape),
              f"strides {q.stride()}"),
             share)
        del want
        return o

    kernels.reset_launch_counts()
    norms.group_norm_kernel, attention.flash_attention_kernel = gn, flash
    try:
        with contextlib.nullcontext() if grad else torch.no_grad():
            fn()
    finally:
        norms.group_norm_kernel, attention.flash_attention_kernel = kernel_gn, kernel_flash
    torch.cuda.synchronize()
    launched = sum(n for k, n in kernels.launches.items() if k != attention.COMBINE_COUNTER)
    for key, share in sorted(sites.items(), key=str):
        log(f"  {key[0]:24s} {str(list(key[1])):22s} {key[2]:30s} {share:.3g} of the limit")
    worst = max(sites.values())
    log(f"[{label}] {held[0]} kernel launches at {len(sites)} sites held against their "
        f"plain versions ({launched} launched): worst {worst:.3g} of the limit")
    if held[0] != launched:
        raise RuntimeError(f"{label}: {launched - held[0]} kernel launches were not held")
    if not (math.isfinite(worst) and worst <= 1):
        raise RuntimeError(f"{label}: a kernel site disagrees with its plain version")
    return sites


def timed_runs(fn, n=3):
    """Wall seconds of n runs of fn, each ending in a synchronize."""
    import torch

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def check_image(label, img, shape):
    import torch

    if tuple(img.shape) != tuple(shape):
        raise RuntimeError(f"{label}: output shape {tuple(img.shape)}, not {shape}")
    if not bool(torch.isfinite(img).all()) or float(img.float().std()) == 0.0:
        raise RuntimeError(f"{label}: non-finite or constant output")


def profile_groups(fn, label, unprofiled_s, top=20):
    """One run of fn under torch.profiler: device busy, the idle share
    against `unprofiled_s` (a run without the profiler, which slows the
    host), device time by group, by flash kernel instance and of the `top`
    kernels. Each kernel counts in the first group whose name it contains."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [(key, t, n) for key, (t, n) in device_activities(prof).items()]
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time")
    groups = {"flash attention": FLASH_KERNELS,
              "group_norm": GN_KERNELS,
              "convolution": ("fprop", "conv", "nchw", "nhwc"),
              "matmul": ("gemm", "nvjet", "cutlass"),
              "copies": ("copy_kernel",)}
    totals = dict.fromkeys([*groups, "other"], 0.0)
    for key, t, _ in rows:
        tag = next((g for g, names in groups.items() if any(n in key for n in names)), "other")
        totals[tag] += t
    log(f"[{label}] device busy {busy:.4f} s; idle share {1 - busy / unprofiled_s:.3f} "
        f"of the unprofiled {unprofiled_s:.4f} s ({1 - busy / wall_s:.3f} of the profiled "
        f"{wall_s:.4f} s); {sum(r[2] for r in rows)} kernel launches")
    for tag, t in totals.items():
        log(f"[{label}] {tag:16s} {t:.4f} s = {t / busy:.3f} of device time")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[{label}] {t * 1e3:9.2f} ms {t / busy:6.3f} x{n:<6d} {key[:110]}")
    # each flash kernel instance (the template's padded head dim) on its own
    flash = {}
    for key, t, n in rows:
        instance = kernel_label(key)
        if instance.startswith("flash_"):
            flash[instance] = flash.get(instance, 0.0) + t
    log(f"[{label}] flash by instance: " + ", ".join(
        f"{k} {t * 1e3:.2f} ms = {t / busy:.4f}" for k, t in sorted(flash.items())))
    return dict(device_busy_s=busy, idle_share=1 - busy / unprofiled_s, profiled_wall_s=wall_s,
                device_s_by_group=totals, device_s_by_flash_instance=flash)


def inpaint_inputs(batch, res, seed):
    """A seeded image batch in [-1, 1] and its hole masks (1 = hole, one
    box an image, 1/8 to 1/2 of the side), as scripts/inpaint.py reads them."""
    import torch

    g = torch.Generator().manual_seed(seed)
    img = torch.rand(batch, res, res, 3, generator=g) * 2 - 1
    mask = torch.zeros(batch, res, res, 1)
    for i in range(batch):
        h, w = (int(v) for v in torch.randint(res // 8, res // 2, (2,), generator=g))
        y, x = (int(v) for v in torch.randint(0, res - res // 2, (2,), generator=g))
        mask[i, y:y + h, x:x + w] = 1.0
    return img, mask


def keep_mask(mask_px, side):
    """The latent-resolution keep-mask (1 = keep the known region) as
    scripts/inpaint.py makes it: `ealdm_torch.scripts.inpaint.keep_mask`,
    the hole mask resized "nearest-exact" (JAX's nearest resize samples at
    half-pixel centres; torch's "nearest" picks other pixels)."""
    from ealdm_torch.scripts.inpaint import keep_mask as cli_keep_mask

    return cli_keep_mask(mask_px, side)


def phase_inpaint(cfg_module):
    """Phase 7: scripts/inpaint.py's run at INPAINT's full width, batch 16,
    DDIM-50 at eta 0, bfloat16; every kernel launch of one pass (encode, one
    UNet call, decode) held against its plain version (`hold_sites`)."""
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.INPAINT
    batch, steps, res, zres = 16, 50, cfg["res"], cfg["zres"]
    ealdm_torch.enable_inference_optimizations()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=50)
    log(f"[inpaint] INPAINT, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, batch {batch}, DDIM-{steps}, eta 0")
    img_cpu, mask_cpu = inpaint_inputs(batch, res, seed=51)
    img, mask_px = img_cpu.cuda(), mask_cpu.cuda()
    latent = (zres, zres, cfg["zch"])

    def run(steps_, sampler="ddim"):
        """encode, sample with the mask, decode, composite."""
        g = torch.Generator(device="cuda").manual_seed(52)
        z = model.get_first_stage_encoding(model.encode_first_stage(img))
        out, _ = sample_images(model, batch, latent, steps=steps_, eta=0.0, sampler=sampler,
                               mask=keep_mask(mask_px, zres), x0=z, generator=g)
        return img * (1 - mask_px) + out.float() * mask_px

    fs, unet = model.first_stage_model, model.model.diffusion_model

    def census(unet_runs):
        return path_census([(fs.encoder, batch, res, 1), (unet, batch, zres, unet_runs),
                            (fs.decoder, batch, zres, 1)])

    t0 = time.perf_counter()
    run(steps)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = None

    def counted():
        nonlocal out
        out = run(steps)

    walls = timed_runs(counted, 1)  # one timed run: host-bound, as phases 11-16
    details = check_launches("inpaint", census(steps))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = walls[0]
    check_image("inpaint", out, (batch, res, res, 3))
    known = mask_px.expand_as(out) == 0
    if not torch.equal(out[known], img.expand_as(out)[known]):
        raise RuntimeError("inpaint: the composite changed the known pixels")
    log(f"[inpaint] {dt:.4f} s = {batch / dt:.4f} img/s, one timed run (warm-up "
        f"{warm_s:.1f} s), peak {peak:.2f} GiB")
    prof = profile_groups(lambda: run(steps), "inpaint-profile", dt, top=12)
    t_mid = torch.full((batch,), 500, dtype=torch.int64, device="cuda")

    def one_pass():  # encode, one UNet call, decode
        z = model.get_first_stage_encoding(model.encode_first_stage(img))
        model.apply_model(z, t_mid, None)
        model.decode_first_stage(z)

    held = hold_sites("inpaint-held", one_pass)
    # PLMS, 4 steps: 5 UNet calls (the first step evaluates twice)
    kernels.reset_launch_counts()
    plms_walls = timed_runs(lambda: check_image("inpaint-plms", run(4, "plms"),
                                                (batch, res, res, 3)), 1)
    check_launches("inpaint-plms", census(5))
    log(f"[inpaint-plms] 4 steps in {plms_walls[0]:.4f} s")
    ref = inpaint_reference(cfg_module, model, img_cpu[:1], mask_cpu[:1])
    del model
    torch.cuda.empty_cache()
    return details, dict(batch=batch, steps=steps, img_per_s=batch / dt, seconds=dt,
                         walls_s=walls, warmup_s=warm_s, peak_gib=peak, **prof,
                         held_sites=len(held), held_worst_share=max(held.values()),
                         plms4_s=plms_walls[0], reference=ref)


def inpaint_reference(cfg_module, bf16_model, img, mask_px):
    """Phase 7's float32 check: batch 1, 2 DDIM steps with the mask, the
    card (kernels) against the CPU (plain versions), same weights, x_T and
    noise; the encode too. TF32 is off for the library's matmuls and
    convolutions (main); the flash kernel computes in split TF32, about
    1e-6 from float32. 1e-3 of the latent's scale, as phase 5."""
    import torch

    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.INPAINT
    kw = cfg_module.model_kwargs(cfg)
    sd = {k: v.float() for k, v in bf16_model.state_dict().items()}
    models = {}
    for dev in ("cpu", "cuda"):
        m = LatentDiffusion(**kw, dtype=torch.float32, device=dev).eval()
        m.load_state_dict(sd)
        models[dev] = m
    latent = (cfg["zres"], cfg["zres"], cfg["zch"])
    g = torch.Generator().manual_seed(53)
    x_T = torch.randn(1, *latent, generator=g)
    draws = {(i, kind): torch.randn(1, *latent, generator=g)
             for i in range(2) for kind in ("mask", "step")}
    with torch.no_grad():
        z = {dev: m.encode_first_stage(img.to(dev)).float().cpu() for dev, m in models.items()}
    keep = keep_mask(mask_px, cfg["zres"])
    out = {}
    for dev, m in models.items():
        out[dev] = sample_images(
            m, 1, latent, steps=2, eta=0.0, mask=keep.to(dev), x0=z["cpu"].to(dev),
            x_T=x_T.to(dev), noise_fn=lambda i, shape, kind="step": draws[(i, kind)],
            decode=False, device=dev).float().cpu()
    enc = rel_err_to_max(z["cuda"], z["cpu"])
    rel = rel_err_to_max(out["cuda"], out["cpu"])
    log(f"[inpaint-reference] float32 card vs CPU: encode max diff / max|z| {enc:.3g}, "
        f"masked 2-step latent {rel:.3g} (tolerance 1e-3 each)")
    del models
    if not (enc <= 1e-3 and rel <= 1e-3):
        raise RuntimeError("inpaint: the card's float32 result disagrees with the CPU")
    return dict(encode_rel=enc, latent_rel=rel)


def phase_uncond(cfg_module):
    """Phase 8: the unconditional VQ-f8 LDM (UNCOND) at batch 24, one DDIM-50
    eta 1 run after a 2-step warm-up, bfloat16; every kernel launch of one
    UNet call and a decode held against its plain version."""
    import torch

    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.UNCOND
    batch, steps = 24, 50
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=60)
    latent = (cfg["zres"], cfg["zres"], cfg["zch"])
    out = {}

    def run(steps_):
        g = torch.Generator(device="cuda").manual_seed(61)
        out["img"], _ = sample_images(model, batch, latent, steps=steps_, eta=1.0, generator=g)

    timed_runs(lambda: run(2), 1)
    kernels.reset_launch_counts()
    (wall,) = timed_runs(lambda: run(steps), 1)
    details = check_launches("uncond", path_census(
        [(model.model.diffusion_model, batch, cfg["zres"], steps),
         (model.first_stage_model.decoder, batch, cfg["zres"], 1)]))
    check_image("uncond", out["img"], (batch, cfg["res"], cfg["res"], 3))
    t_mid = torch.full((batch,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(batch, *latent, generator=torch.Generator().manual_seed(62)).cuda()
    held = hold_sites("uncond-held", lambda: model.decode_first_stage(
        model.apply_model(z, t_mid, None)))
    log(f"[uncond] UNCOND {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, batch {batch}, DDIM-{steps} eta 1: {wall:.4f} s = "
        f"{batch / wall:.4f} img/s")
    del model
    torch.cuda.empty_cache()
    return details, dict(batch=batch, steps=steps, seconds=wall, img_per_s=batch / wall,
                         held_sites=len(held), held_worst_share=max(held.values()))


def phase_pixel(cfg_module):
    """Phase 9: the pixel-space DDPM (PIXEL) at batch 4, 4 DDIM and 4 PLMS
    steps, bfloat16, launches checked; then every GroupNorm and flash launch
    of one UNet call held against its plain version (`hold_sites`)."""
    import torch

    from ealdm_torch import kernels
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import DDPM

    cfg = cfg_module.PIXEL
    batch, res = 4, cfg["res"]
    model = DDPM(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16, device="cuda").eval()
    random_init_(model, seed=62)
    unet = model.model.diffusion_model
    log(f"[pixel] PIXEL {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
        f"batch {batch}, {res}^2")
    out, numbers, details = {}, {}, {}
    for sampler, calls in (("ddim", 4), ("plms", 5)):
        def run():
            g = torch.Generator(device="cuda").manual_seed(63)
            out["img"], _ = sample_images(model, batch, (res, res, 3), steps=4,
                                          eta=1.0 if sampler == "ddim" else 0.0,
                                          sampler=sampler, generator=g)

        timed_runs(run, 1)  # warm-up
        kernels.reset_launch_counts()
        (wall,) = timed_runs(run, 1)
        details[sampler] = check_launches(f"pixel-{sampler}",
                                          path_census([(unet, batch, res, calls)]))
        check_image(f"pixel-{sampler}", out["img"], (batch, res, res, 3))
        log(f"[pixel-{sampler}] 4 steps ({calls} UNet calls) in {wall:.4f} s")
        numbers[f"{sampler}4_s"] = wall

    # every kernel launch of one UNet call against its plain version
    g = torch.Generator(device="cuda").manual_seed(64)
    x = torch.randn(batch, res, res, 3, generator=g, device="cuda")
    t = torch.tensor([999, 500, 250, 1], device="cuda")
    sites = hold_sites("pixel-held", lambda: model.apply_model(x, t, None))
    gn = {k: v for k, v in sites.items() if k[2].startswith("C/G")}
    worst = max(gn.values())
    cgs = sorted({int(k[2].split()[1]) for k in gn})
    log(f"[pixel] {len(gn)} GroupNorm shapes of one UNet call, C/G {cgs}: worst "
        f"{worst:.3g} of the limit")
    del model
    torch.cuda.empty_cache()
    return details["ddim"], dict(batch=batch, **numbers, group_norm_shapes=len(gn),
                                 group_norm_cg=cgs, group_norm_worst_share=worst,
                                 held_sites=len(sites),
                                 held_worst_share=max(sites.values()))


def phase_kl(cfg_module):
    """Phase 10: the KL-f4 round trip (encode, posterior sample, decode) at
    batch 16, 256^2: bfloat16 timed over three runs after a warm-up with its
    launches checked, every kernel launch of one run held against its plain
    version, then float32 on the same input and noise; the PSNR of
    the bfloat16 reconstruction against the float32 one (peak-to-peak 2)."""
    import torch

    from ealdm_torch import kernels
    from ealdm_torch.models.vae import AutoencoderKL

    cfg = cfg_module.KL_F4
    batch, res = 16, cfg["res"]
    kw = cfg_module.vae_kwargs(cfg)
    vae = AutoencoderKL(**kw, dtype=torch.bfloat16).eval()
    vae32 = AutoencoderKL(**kw, dtype=torch.float32).eval()
    random_init_(vae, seed=70)
    vae32.load_state_dict(vae.state_dict())
    g = torch.Generator().manual_seed(71)
    x = (torch.rand(batch, res, res, 3, generator=g) * 2 - 1).cuda()
    noise = torch.randn(batch, cfg["zres"], cfg["zres"], kw["embed_dim"], generator=g).cuda()
    rec = {}

    def run(m, key):
        with torch.no_grad():
            rec[key], _ = m(x, noise=noise)

    timed_runs(lambda: run(vae, "bf16"), 1)
    kernels.reset_launch_counts()
    walls = timed_runs(lambda: run(vae, "bf16"), 1)
    details = check_launches("kl", path_census([(vae.encoder, batch, res, 1),
                                                (vae.decoder, batch, cfg["zres"], 1)]))
    walls += timed_runs(lambda: run(vae, "bf16"), 2)
    dt = sorted(walls)[1]
    held = hold_sites("kl-held", lambda: vae(x, noise=noise))
    run(vae32, "f32")
    torch.cuda.synchronize()
    for key in rec:
        check_image(f"kl-{key}", rec[key], (batch, res, res, 3))
    mse = (rec["bf16"].float() - rec["f32"]).square().mean().item()
    psnr = 10 * math.log10(4.0 / mse) if mse > 0 else float("inf")
    log(f"[kl] KL_F4 {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M parameters, "
        f"batch {batch}, {res}^2 round trip in bfloat16: {dt:.4f} s = {batch / dt:.4f} img/s, "
        f"the median of {[round(w, 4) for w in walls]} s; PSNR bfloat16 vs float32 "
        f"{psnr:.2f} dB")
    del vae, vae32, rec
    torch.cuda.empty_cache()
    return details, dict(batch=batch, seconds=dt, walls_s=walls, img_per_s=batch / dt,
                         psnr_bf16_vs_f32_db=psnr, held_sites=len(held),
                         held_worst_share=max(held.values()))


# ------------------------------------------------------------------ phases 11-12
TXT2IMG_PROMPT = "a painting of a lighthouse on a cliff at dusk, oil on canvas"
CIN256_CLASSES = (25, 187, 448, 992)  # scripts/latent_imagenet_diffusion.ipynb
CIN256_NULL = 1000


def float32_reference(label, build, bf16_model, latent, seed, cond_fn=None, scale=None,
                      eta=0.0):
    """Batch 1, 2 DDIM steps, float32: `build(device)`'s model on the card
    (its kernels) against the CPU (the plain versions), with `bf16_model`'s
    weights, the same x_T and, at eta > 0, the same step noise. With
    `cond_fn(model, device)` -> (cond, uncond or None, {name: tensor}), the
    conditioning is built on each device and held too, with each named
    tensor, and guided at `scale`. 1e-3 of each result's scale, TF32 off for
    the library and the flash kernel in split TF32, as phase 5."""
    import torch

    from ealdm_torch.inference import sample_images

    sd = {key: v.float() for key, v in bf16_model.state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    x_T = torch.randn(1, *latent, generator=g)
    draws = [torch.randn(1, *latent, generator=g) for _ in range(2)] if eta else None
    got = {}
    for dev in ("cpu", "cuda"):
        m = build(dev).eval()
        m.load_state_dict(sd)
        c, uc, extra = None, None, {}
        if cond_fn is not None:
            with torch.no_grad():
                c, uc, extra = cond_fn(m, dev)
            extra = dict(conditioning=c, **extra)
        z = sample_images(m, 1, latent, steps=2, eta=eta, guidance_scale=scale, cond=c,
                          uncond=uc, x_T=x_T.to(dev), decode=False, device=dev,
                          noise_fn=(lambda i, shape: draws[i]) if eta else None)
        for name, t in dict(latent=z, **extra).items():
            got.setdefault(name, {})[dev] = t.float().cpu()
        del m, c, uc, extra
    out = {f"{name}_rel": rel_err_to_max(v["cuda"], v["cpu"]) for name, v in got.items()}
    log(f"[{label}] float32 card vs CPU, batch 1, 2 steps: "
        + ", ".join(f"{key} {v:.3g}" for key, v in out.items())
        + f" (max|z| {got['latent']['cpu'].abs().max().item():.3g}; tolerance 1e-3 each)")
    if not all(v <= 1e-3 for v in out.values()):
        raise RuntimeError(f"{label}: the card's float32 result disagrees with the CPU")
    return out


def conditional_model(cfg_module, cfg):
    """`build` for `float32_reference`: the config's LatentDiffusion."""
    import torch

    from ealdm_torch.models.ddpm import LatentDiffusion

    kw = cfg_module.model_kwargs(cfg)
    return lambda dev: LatentDiffusion(**kw, dtype=torch.float32, device=dev)


def learned_conditioning(cond_input, uncond_input):
    """`cond_fn` for `float32_reference`: the model's own cond stage."""
    return lambda m, dev: (m.get_learned_conditioning(cond_input.to(dev)),
                           m.get_learned_conditioning(uncond_input.to(dev)), {})


def conditional_path(label, run, census, batch_images, hold_fn, widest_c=None,
                     small_pixels=None):
    """The shared half of phases 11-16: a warm-up, one timed run with its
    launches checked against `census` and its peak (these paths are
    host-bound and PERF.md keeps their ranges over three runs, so the card
    budget keeps one), one profiled run, every kernel launch of `hold_fn` held against
    its plain version; with `widest_c`, the GroupNorm sites of that many
    channels must be among the held ones, and with `small_pixels` those of
    at most that many pixels a sample. Returns (launch details, numbers)."""
    import torch

    from ealdm_torch import kernels

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls = timed_runs(run, 1)
    details = check_launches(label, census)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = walls[0]
    by_rows = {f"{name}@{n}": c for (name, n), c in sorted(details.items())
               if name.startswith("flash")}
    gn = {}
    for (name, _), c in details.items():
        if name.startswith("group_norm"):
            gn[name] = gn.get(name, 0) + c
    log(f"[{label}] {dt:.4f} s = {batch_images / dt:.4f} img/s, one timed run "
        f"(warm-up {warm_s:.1f} s), peak {peak:.2f} GiB; "
        f"flash launches by counter and rows {by_rows}; GroupNorm launches by path {gn}")
    prof = profile_groups(run, f"{label}-profile", dt, top=12)
    held = hold_sites(f"{label}-held", hold_fn)
    out = dict(img_per_s=batch_images / dt, seconds=dt, walls_s=walls, warmup_s=warm_s,
               peak_gib=peak, flash_launches_by_rows=by_rows, group_norm_launches=gn, **prof,
               held_sites=len(held), held_worst_share=max(held.values()))
    if widest_c is not None:
        wide = {k: v for k, v in held.items() if k[2].startswith("C/G") and k[1][1] == widest_c}
        if not wide:
            raise RuntimeError(f"{label}: no GroupNorm site at C = {widest_c} was held")
        log(f"[{label}] GroupNorm at C = {widest_c}: {len(wide)} sites "
            f"{sorted(k[1] for k in wide)}, worst {max(wide.values()):.3g} of the limit")
        out[f"group_norm_c{widest_c}_worst_share"] = max(wide.values())
    if small_pixels is not None:
        small = {k: v for k, v in held.items()
                 if k[2].startswith("C/G") and k[1][2] * k[1][3] <= small_pixels}
        if not small:
            raise RuntimeError(f"{label}: no GroupNorm site of <= {small_pixels} pixels was held")
        log(f"[{label}] GroupNorm at <= {small_pixels} pixels a sample: {len(small)} sites "
            f"{sorted(k[1] for k in small)}, worst {max(small.values()):.3g} of the limit")
        out["group_norm_small_worst_share"] = max(small.values())
    return details, out


def phase_txt2img(cfg_module):
    """Phase 11: `txt2img-1p4B-eval` (TXT2IMG) as scripts/txt2img.py runs
    it, at full width in bfloat16: batch 8 of one prompt against the empty
    prompt through the port's tokenizer, both through the 32-layer BERT,
    `sample_images(cond=, uncond=)` with DDIM-50 at eta 0 and CFG 5,
    hoisted, and the KL-f8 decode to [8, 256, 256, 3]."""
    import torch

    import ealdm_torch
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.TXT2IMG
    batch, steps, scale = 8, 50, 5.0
    latent = (cfg["zres"], cfg["zres"], cfg["zch"])
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=80)
    parts = {k: sum(p.numel() for p in getattr(model, k).parameters())
             for k in ("cond_stage_model", "model", "first_stage_model")}
    log(f"[txt2img] TXT2IMG {sum(parts.values()) / 1e6:.1f} M parameters (BERT "
        f"{parts['cond_stage_model'] / 1e6:.1f} M, UNet {parts['model'] / 1e6:.1f} M, KL-f8 "
        f"{parts['first_stage_model'] / 1e6:.1f} M), built in {time.perf_counter() - t0:.1f} s; "
        f"batch {batch}, DDIM-{steps}, eta 0, CFG {scale}")
    bert = model.cond_stage_model
    tokens_c = bert.tokenize([TXT2IMG_PROMPT] * batch)
    tokens_uc = bert.tokenize([""] * batch)
    tokens = (tokens_c.cuda(), tokens_uc.cuda())
    out = {}

    def encode():
        with torch.no_grad():
            return tuple(model.get_learned_conditioning(t) for t in tokens)

    def run():
        c, uc = encode()
        g = torch.Generator(device="cuda").manual_seed(81)
        out["img"], out["z"] = sample_images(model, batch, latent, steps=steps, eta=0.0,
                                             guidance_scale=scale, cond=c, uncond=uc,
                                             generator=g)

    fs, unet = model.first_stage_model, model.model.diffusion_model
    census = path_census([(unet, 2 * batch, cfg["zres"], steps),
                          (fs.decoder, batch, cfg["zres"], 1)])
    c, uc = encode()
    if c.dtype != torch.float32 or tuple(c.shape) != (batch, 77, 1280):
        raise RuntimeError(f"txt2img: BERT context {c.dtype} {tuple(c.shape)}")
    bert_ms = cuda_ms(encode, iters=5)
    t_mid = torch.full((2 * batch,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(2 * batch, *latent, generator=torch.Generator().manual_seed(82)).cuda()

    def one_pass():  # one UNet call on the CFG batch, then the decode
        model.apply_model(z, t_mid, torch.cat([uc, c]))
        model.decode_first_stage(z[:batch])

    details, numbers = conditional_path("txt2img", run, census, batch, one_pass, widest_c=2560)
    check_image("txt2img", out["img"], (batch, cfg["res"], cfg["res"], 3))
    log(f"[txt2img] the two BERT passes (prompt and empty prompt, batch {batch} each) "
        f"{bert_ms:.3f} ms; output std {float(out['img'].float().std()):.4f}")
    ref = float32_reference("txt2img-reference", conditional_model(cfg_module, cfg), model,
                            (cfg["zres"], cfg["zres"], cfg["zch"]), seed=83,
                            cond_fn=learned_conditioning(tokens_c[:1], tokens_uc[:1]),
                            scale=scale)
    del model
    torch.cuda.empty_cache()
    return details, dict(batch=batch, steps=steps, guidance_scale=scale,
                         params_m={k: v / 1e6 for k, v in parts.items()},
                         bert_two_passes_ms=bert_ms, **numbers, reference=ref)


def phase_cin256(cfg_module):
    """Phase 12: the class-conditional ImageNet LDM (CIN256) as
    scripts/latent_imagenet_diffusion.ipynb samples it, in bfloat16: classes
    25, 187, 448 and 992, 6 samples each, DDIM-20 at eta 0 with scale 3
    against the null class 1000, hoisted, and the VQ-f4 decode."""
    import torch

    import ealdm_torch
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.CIN256
    n, steps, scale = 6, 20, 3.0
    latent = (cfg["zres"], cfg["zres"], cfg["zch"])
    ealdm_torch.enable_inference_optimizations()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=90)
    parts = {k: sum(p.numel() for p in getattr(model, k).parameters())
             for k in ("cond_stage_model", "model", "first_stage_model")}
    log(f"[cin256] CIN256 {sum(parts.values()) / 1e6:.1f} M parameters (ClassEmbedder "
        f"{parts['cond_stage_model'] / 1e6:.1f} M, UNet {parts['model'] / 1e6:.1f} M, VQ-f4 "
        f"{parts['first_stage_model'] / 1e6:.1f} M); classes {list(CIN256_CLASSES)}, {n} "
        f"samples each, DDIM-{steps}, eta 0, scale {scale}, null class {CIN256_NULL}")
    null = torch.full((n,), CIN256_NULL, dtype=torch.int64, device="cuda")
    out = {}

    def run():
        imgs = []
        with torch.no_grad():
            uc = model.get_learned_conditioning(null)
            for k, cls in enumerate(CIN256_CLASSES):
                c = model.get_learned_conditioning(torch.full_like(null, cls))
                g = torch.Generator(device="cuda").manual_seed(91 + k)
                img, _ = sample_images(model, n, latent, steps=steps, eta=0.0,
                                       guidance_scale=scale, cond=c, uncond=uc, generator=g)
                imgs.append(img)
        out["img"] = torch.cat(imgs)

    fs, unet = model.first_stage_model, model.model.diffusion_model
    k = len(CIN256_CLASSES)
    census = path_census([(unet, 2 * n, cfg["zres"], steps * k),
                          (fs.decoder, n, cfg["zres"], k)])
    with torch.no_grad():
        uc = model.get_learned_conditioning(null)
        c = model.get_learned_conditioning(torch.full_like(null, CIN256_CLASSES[0]))
    if c.dtype != torch.float32 or tuple(c.shape) != (n, 1, 512):
        raise RuntimeError(f"cin256: class context {c.dtype} {tuple(c.shape)}")
    t_mid = torch.full((2 * n,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(2 * n, *latent, generator=torch.Generator().manual_seed(92)).cuda()

    def one_pass():  # one UNet call on the CFG batch, then the decode
        model.apply_model(z, t_mid, torch.cat([uc, c]))
        model.decode_first_stage(z[:n])

    details, numbers = conditional_path("cin256", run, census, n * k, one_pass)
    check_image("cin256", out["img"], (n * k, cfg["res"], cfg["res"], 3))
    ref = float32_reference("cin256-reference", conditional_model(cfg_module, cfg), model,
                            (cfg["zres"], cfg["zres"], cfg["zch"]), seed=93,
                            cond_fn=learned_conditioning(torch.tensor([CIN256_CLASSES[1]]),
                                                         torch.tensor([CIN256_NULL])),
                            scale=scale)
    del model
    torch.cuda.empty_cache()
    return details, dict(classes=list(CIN256_CLASSES), samples_per_class=n, steps=steps,
                         guidance_scale=scale, params_m={k: v / 1e6 for k, v in parts.items()},
                         **numbers, reference=ref)


# ------------------------------------------------------------------ phases 13-14
def zoo_builder(name):
    """`build` for `float32_reference`: the zoo entry `name`."""
    import torch

    from ealdm_torch import zoo

    return lambda dev: zoo.build(name, dtype=torch.float32, device=dev)


def zoo_model(label, cfg, seed):
    """A zoo entry built through `ealdm_torch.zoo.build` in bfloat16 on the
    card with seeded random weights; logs its parts' sizes."""
    import torch

    import ealdm_torch
    from ealdm_torch import zoo

    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = zoo.build(cfg["zoo"], dtype=torch.bfloat16, device="cuda").eval()
    random_init_(model, seed=seed)
    parts = {k: sum(p.numel() for p in getattr(model, k).parameters())
             for k in ("model", "first_stage_model")}
    log(f"[{label}] {cfg['zoo']}: UNet {parts['model'] / 1e6:.1f} M, first stage "
        f"{parts['first_stage_model'] / 1e6:.1f} M parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, {k: v / 1e6 for k, v in parts.items()}


def phase_churches(cfg_module):
    """Phase 13: `ldm/lsun_churches256` (CHURCHES) as scripts/sample_diffusion.py
    samples it by default, in bfloat16: batch 10, DDIM-50 at eta 1,
    unconditional, hoisted emb tables (2C scale-shift rows), then the KL-f8
    decode to [10, 256, 256, 3]. The UNet's ResBlocks resample down to 2^2,
    so the GroupNorm sites of 4 and 16 pixels (C up to 1,536) must be among
    the held ones."""
    import torch

    from ealdm_torch.inference import sample_images

    cfg = cfg_module.CHURCHES
    batch, steps, zres = 10, 50, cfg["zres"]
    latent = (zres, zres, cfg["zch"])
    model, params_m = zoo_model("churches", cfg, seed=100)
    out = {}

    def run():
        g = torch.Generator(device="cuda").manual_seed(101)
        out["img"], out["z"] = sample_images(model, batch, latent, steps=steps, eta=1.0,
                                             generator=g)

    fs, unet = model.first_stage_model, model.model.diffusion_model
    census = path_census([(unet, batch, zres, steps), (fs.decoder, batch, zres, 1)])
    t_mid = torch.full((batch,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(batch, *latent, generator=torch.Generator().manual_seed(102)).cuda()

    def one_pass():  # one UNet call, then the decode
        model.apply_model(z, t_mid, None)
        model.decode_first_stage(z)

    details, numbers = conditional_path("churches", run, census, batch, one_pass,
                                        widest_c=1536, small_pixels=16)
    check_image("churches", out["img"], (batch, cfg["res"], cfg["res"], 3))
    ref = float32_reference("churches-reference", zoo_builder(cfg["zoo"]), model, latent,
                            seed=103, eta=1.0)
    del model
    torch.cuda.empty_cache()
    return details, dict(batch=batch, steps=steps, eta=1.0, params_m=params_m, **numbers,
                         reference=ref)


def inpainting_examples(res):
    """The two committed `data/inpainting_examples` pairs as one batch, read
    as scripts/inpaint.py's make_batch reads them
    (`ealdm_torch.scripts.inpaint.make_batch`: the PNGs through the port's
    reader, Pillow's BICUBIC resize to res^2 in numpy, the mask's "L" luma
    above 0.5 = hole): the image in [-1, 1], the mask and the masked
    image."""
    import numpy as np
    import torch

    from ealdm_torch.scripts.inpaint import make_batch

    root = os.path.join(HERE, "data", "inpainting_examples")
    batches = [make_batch(os.path.join(root, f"{stem}.png"),
                          os.path.join(root, f"{stem}_mask.png"), res)
               for stem in ("example0", "example1")]
    return tuple(torch.from_numpy(np.concatenate([b[k] for b in batches]))
                 for k in ("image", "mask", "masked_image"))


def inpaint_conditioning(model, masked, mask_px):
    """inpainting_big's concat conditioning (upstream scripts/inpaint.py):
    the first stage's encoding of the masked image (`__is_first_stage__`:
    the VQ encoder's pre-quantization latent) joined to the hole mask
    resized (nearest) to the latent's side."""
    import torch
    import torch.nn.functional as F

    c = model.get_learned_conditioning(masked)
    cc = F.interpolate(mask_px.permute(0, 3, 1, 2), size=tuple(c.shape[1:3]), mode="nearest")
    return torch.cat([c, cc.permute(0, 2, 3, 1).to(c.dtype)], dim=-1)


def phase_inpainting_big(cfg_module):
    """Phase 14: `ldm/inpainting_big` (INPAINT_BIG) as upstream
    scripts/inpaint.py runs it on the two committed examples, as one batch of
    2 in bfloat16: the conditioning (`inpaint_conditioning`), DDIM-50 at eta
    0 (concat takes the plain step, no hoisting), the decode of the
    attention-free VQ-f4, and the composite over the known pixels."""
    import torch

    from ealdm_torch.inference import sample_images

    cfg = cfg_module.INPAINT_BIG
    steps, res, zres = 50, cfg["res"], cfg["zres"]
    latent = (zres, zres, cfg["zch"])
    model, params_m = zoo_model("inpainting_big", cfg, seed=110)
    img_cpu, mask_cpu, masked_cpu = inpainting_examples(res)
    img, mask_px, masked = img_cpu.cuda(), mask_cpu.cuda(), masked_cpu.cuda()
    batch = img.shape[0]
    log(f"[inpainting_big] batch {batch} (data/inpainting_examples at {res}^2, holes "
        f"{[round(float(m.mean()), 4) for m in mask_cpu]} of the pixels), DDIM-{steps}, eta 0")
    out = {}

    def run():
        with torch.no_grad():
            cond = inpaint_conditioning(model, masked, mask_px)
        g = torch.Generator(device="cuda").manual_seed(111)
        x, _ = sample_images(model, batch, latent, steps=steps, eta=0.0, cond=cond, generator=g)
        out["img"] = img * (1 - mask_px) + x.float() * mask_px

    fs, unet = model.first_stage_model, model.model.diffusion_model
    census = path_census([(fs.encoder, batch, res, 1), (unet, batch, zres, steps),
                          (fs.decoder, batch, zres, 1)])
    t_mid = torch.full((batch,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(batch, *latent, generator=torch.Generator().manual_seed(112)).cuda()

    def one_pass():  # the conditioning, one UNet call, the decode
        model.apply_model(z, t_mid, inpaint_conditioning(model, masked, mask_px))
        model.decode_first_stage(z)

    details, numbers = conditional_path("inpainting_big", run, census, batch, one_pass)
    check_image("inpainting_big", out["img"], (batch, res, res, 3))
    known = mask_px.expand_as(out["img"]) == 0
    if not torch.equal(out["img"][known], img.expand_as(out["img"])[known]):
        raise RuntimeError("inpainting_big: the composite changed the known pixels")
    ref = float32_reference(
        "inpainting_big-reference", zoo_builder(cfg["zoo"]), model, latent, seed=113,
        cond_fn=lambda m, dev: (inpaint_conditioning(m, masked_cpu[:1].to(dev),
                                                     mask_cpu[:1].to(dev)), None, {}))
    del model
    torch.cuda.empty_cache()
    return details, dict(batch=batch, steps=steps, eta=0.0, params_m=params_m, **numbers,
                         reference=ref)


# ------------------------------------------------------------------ phase 15
RDM_PROMPT = "a happy bear reading a newspaper, oil on canvas"  # knn2img's --prompt
RDM_DATABASE = (200_000, 768)  # entries x CLIP ViT-L/14 embedding width


def rdm_towers(clip, seed):
    """The ViT-L/14 CLIP cond stages (text and image embedders) in float32
    on the card, as knn2img runs them, with seeded random weights."""
    from ealdm_torch.models.encoders import FrozenCLIPTextEmbedder, FrozenClipImageEmbedder

    towers = []
    for i, cls in enumerate((FrozenCLIPTextEmbedder, FrozenClipImageEmbedder)):
        m = cls.from_version(clip, device="cuda").eval()
        random_init_(m, seed=seed + i)
        towers.append(m)
    return towers


def check_exact_search(label, found, queries, db, k):
    """The exact search's indices against a float64 brute force on the host:
    equal at every rank whose score is more than 1e-6 from its neighbours'
    (a closer pair may swap under float32 rounding). Returns the ranks
    checked and the largest score error."""
    import numpy as np

    q = queries.double().cpu().numpy()
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-8)
    scores = np.empty((q.shape[0], db.shape[0]))
    for lo in range(0, db.shape[0], 50_000):  # float64 a slice at a time
        part = db[lo:lo + 50_000].astype(np.float64)
        part /= np.maximum(np.linalg.norm(part, axis=1, keepdims=True), 1e-8)
        scores[:, lo:lo + 50_000] = q @ part.T
    order = np.argsort(-scores, axis=1)[:, :k + 1]
    top = np.take_along_axis(scores, order, axis=1)
    got = found["nn_indices"].cpu().numpy()
    gaps = -np.diff(top, axis=1)  # [B, k]: score j minus score j + 1
    clear = (gaps[:, :k] > 1e-6) & np.concatenate(
        [np.ones((q.shape[0], 1), bool), gaps[:, :k - 1] > 1e-6], axis=1)
    bad = clear & (got != order[:, :k])
    score_err = float(np.abs(found["nn_scores"].double().cpu().numpy() - top[:, :k]).max())
    log(f"[{label}] exact search vs float64 brute force: {int(clear.sum())} of {got.size} "
        f"ranks clear of a 1e-6 tie, {int(bad.sum())} differ; score error {score_err:.3g}")
    if bad.any() or score_err > 1e-5:
        raise RuntimeError(f"{label}: the exact search disagrees with the brute force")
    return int(clear.sum()), score_err


def phase_rdm(cfg_module):
    """Phase 15: retrieval-augmented sampling (RDM768, the 768x768 RDM) as
    scripts/knn2img.py runs it with --use_neighbors --knn 10, in bfloat16
    at full width: a seeded 200,000 x 768 float32 database on the card,
    indexed by `auto_build_searcher` (447 leaves, 22 probed); the ViT-L/14
    text tower embeds the default prompt for n = 2 samples and the image
    tower `example0` of data/inpainting_examples (128^2, upsampled to
    224^2); k = 10 on the exact and the partitioned search (the exact one
    against a float64 brute force, the partitioned one's recall@10 logged);
    the [2, 11, 768] context through DDIM-50 at eta 0 with CFG 5 against
    its zeros, hoisted; the KL-f16 decode to [2, 768, 768, 3]. The UNet's
    d=32 flash and the decoder's d=512 run at 48^2 = 2,304 rows; the
    GroupNorm sites of 3,584 channels must be among the held ones."""
    import numpy as np
    import torch

    import ealdm_torch
    from ealdm_torch import retrieval
    from ealdm_torch.inference import sample_images
    from ealdm_torch.models.ddpm import LatentDiffusion

    cfg = cfg_module.RDM768
    n, steps, scale, k = 2, 50, 5.0, 10
    latent = (cfg["zres"], cfg["zres"], cfg["zch"])
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=torch.bfloat16,
                            device="cuda").eval()
    random_init_(model, seed=120)
    towers = rdm_towers(cfg["clip"], seed=121)
    parts = {key: sum(p.numel() for p in getattr(model, key).parameters())
             for key in ("model", "first_stage_model")}
    parts.update(clip_text=sum(p.numel() for p in towers[0].parameters()),
                 clip_image=sum(p.numel() for p in towers[1].parameters()))
    log(f"[rdm] RDM768 {(parts['model'] + parts['first_stage_model']) / 1e6:.1f} M parameters "
        f"(UNet {parts['model'] / 1e6:.1f} M, KL-f16 {parts['first_stage_model'] / 1e6:.1f} M), "
        f"CLIP {cfg['clip']} text {parts['clip_text'] / 1e6:.1f} M and image "
        f"{parts['clip_image'] / 1e6:.1f} M (float32), built in {time.perf_counter() - t0:.1f} s; "
        f"n {n}, DDIM-{steps}, eta 0, CFG {scale}, k {k}")

    t0 = time.perf_counter()
    db = np.random.default_rng(122).standard_normal(RDM_DATABASE, dtype=np.float32)
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    searcher = retrieval.auto_build_searcher({"embedding": db}, device="cuda")
    exact = retrieval.Searcher.from_database({"embedding": db}, device="cuda")
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    leaves = searcher._centroids.shape[0]
    log(f"[rdm] database {list(db.shape)} float32 made in {made_s:.2f} s; the partitioned "
        f"index ({leaves} leaves of up to {searcher._leaf_idx.shape[1]}, "
        f"{searcher.default_leaves_to_search} probed) and the exact one in {index_s:.2f} s")
    if (not searcher.partitioned or leaves != int(math.sqrt(RDM_DATABASE[0]))
            or searcher.default_leaves_to_search != leaves // 20):
        raise RuntimeError("rdm: auto_build_searcher did not build sqrt(N) leaves, N/20 probed")

    text, vision = towers
    pixels = np.load(os.path.join(HERE, "ealdm_torch", "data", "inpainting_examples.npz"))
    image = torch.from_numpy(pixels["example0"])[None].float().cuda() / 127.5 - 1.0
    q_text = retrieval.embed_queries(n, texts=[RDM_PROMPT], text_embedder=text)
    q_img = retrieval.embed_queries(n, image=image, image_embedder=vision)
    for what, q in (("text", q_text), ("image", q_img)):
        norms = torch.linalg.vector_norm(q, dim=-1)
        if (tuple(q.shape) != (n, RDM_DATABASE[1]) or not bool(torch.isfinite(q).all())
                or float((norms - 1).abs().max()) > 1e-5):
            raise RuntimeError(f"rdm: {what} query {tuple(q.shape)}, norms {norms.tolist()}")
    search_ms = {}
    found = {}
    for what, s in (("exact", exact), ("partitioned", searcher)):
        found[what] = s.search(q_text, k=k)
        search_ms[what] = cuda_ms(lambda: s.search(q_text, k=k), iters=5)
    clear, score_err = check_exact_search("rdm", found["exact"], q_text, db, k)
    got_e, got_p = (found[w]["nn_indices"].cpu().numpy() for w in ("exact", "partitioned"))
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got_e, got_p)]))
    img_found = searcher.search(q_img, k=k)["nn_indices"]
    log(f"[rdm] search k={k}: exact {search_ms['exact']:.3f} ms, partitioned "
        f"{search_ms['partitioned']:.3f} ms; partitioned recall@{k} against exact {recall:.3f} "
        f"(information: the database is Gaussian noise); image query's neighbours "
        f"{img_found[0].tolist()}")

    out = {}

    def conditioning():
        q = retrieval.embed_queries(n, texts=[RDM_PROMPT], text_embedder=text)
        return retrieval.retrieval_conditioning(q, searcher, k=k, guidance_scale=scale)[:2]

    def run():
        c, uc = conditioning()
        g = torch.Generator(device="cuda").manual_seed(123)
        out["img"], out["z"] = sample_images(model, n, latent, steps=steps, eta=0.0,
                                             guidance_scale=scale, cond=c, uncond=uc,
                                             generator=g)

    c, uc = conditioning()
    if tuple(c.shape) != (n, 1 + k, RDM_DATABASE[1]) or c.dtype != torch.float32:
        raise RuntimeError(f"rdm: context {c.dtype} {tuple(c.shape)}")
    cond_ms = cuda_ms(conditioning, iters=5)
    fs, unet = model.first_stage_model, model.model.diffusion_model
    census = path_census([(unet, 2 * n, cfg["zres"], steps), (fs.decoder, n, cfg["zres"], 1)])
    t_mid = torch.full((2 * n,), 500, dtype=torch.int64, device="cuda")
    z = torch.randn(2 * n, *latent, generator=torch.Generator().manual_seed(124)).cuda()

    def one_pass():  # one UNet call on the CFG batch, then the decode
        model.apply_model(z, t_mid, torch.cat([uc, c]))
        model.decode_first_stage(z[:n])

    details, numbers = conditional_path("rdm", run, census, n, one_pass, widest_c=3584)
    check_image("rdm", out["img"], (n, cfg["res"], cfg["res"], 3))
    log(f"[rdm] conditioning (text tower, partitioned search, stacking) {cond_ms:.3f} ms; "
        f"output std {float(out['img'].float().std()):.4f}")
    def reference_conditioning(m, dev):  # CLIP, the search and the stacking on dev
        text, vision = towers
        if dev == "cpu":
            text, vision = (type(t).from_version(cfg["clip"], device="cpu").eval()
                            for t in towers)
            text.load_state_dict(towers[0].state_dict())
            vision.load_state_dict(towers[1].state_dict())
        q = retrieval.embed_queries(1, texts=[RDM_PROMPT], text_embedder=text)
        c, uc, _ = retrieval.retrieval_conditioning(q, searcher.to(dev), k=k,
                                                    guidance_scale=scale)
        return c, uc, {"image_embedding": vision(image.to(dev))}

    ref = float32_reference("rdm-reference", conditional_model(cfg_module, cfg), model,
                            latent, seed=125, cond_fn=reference_conditioning, scale=scale)
    del model, towers, searcher, exact
    torch.cuda.empty_cache()
    return details, dict(n_samples=n, steps=steps, eta=0.0, guidance_scale=scale, knn=k,
                         params_m={key: v / 1e6 for key, v in parts.items()},
                         database=list(RDM_DATABASE), leaves=leaves,
                         leaves_probed=leaves // 20, index_build_s=index_s,
                         search_ms=search_ms, partitioned_recall_at_k=recall,
                         exact_ranks_checked=clear, exact_score_err=score_err,
                         conditioning_ms=cond_ms, **numbers, reference=ref)


# ------------------------------------------------------------------ phase 16
SR_STEPS = 50  # notebook_helpers.run's custom_steps; eta 1
# the float32 reference's crop grid (ks, stride), cut from the notebook's
# 128 / 64 so that input (a)'s encode, UNet call and decode each take
# several crops in seconds on the host
SR_REFERENCE_GRID = ((32, 32), (16, 16))


def superres_inputs():
    """{"a": the committed 64^2 example (data/example_conditioning/
    superresolution/sample_0.png, decoded), "b": the same upsampled 4x to
    256^2 (`get_cond`'s bilinear image, rounded to uint8), which stands in
    for a larger photograph}, as uint8 [H, W, 3] arrays."""
    import numpy as np

    from ealdm_torch import notebook_helpers as nh

    path = os.path.join(HERE, "ealdm_torch", "data", "superresolution_examples.npz")
    small = np.load(path)["sample_0"]
    up = nh.get_cond("superresolution", small, device="cpu")["image"][0]
    big = ((up + 1.0) * 127.5).round().clamp(0, 255).byte().numpy()
    return {"a": small, "b": big}


def superres_passes(model, lr_side, steps, params):
    """`path_census` passes of one notebook run on an LR image of lr_side^2
    under the split-input `params`: the encode of the 4x image's crops as
    one batch, each DDIM step's UNet call on the latent's crops, and three
    decodes of those crops (reconstruction, sample, sample_noquant); a crop
    grid is ((side - ks) // stride + 1)^2 after the kernel and stride are
    clamped to the side. Returns (passes, {stage: (crops, crop side)})."""
    from ealdm_torch.ops.patching import clamp_patch_params, grid_shape

    def grid(side):
        ks, stride = clamp_patch_params((side, side), tuple(params["ks"]),
                                        tuple(params["stride"]))
        ly, lx = grid_shape((side, side), ks, stride)
        return ly * lx, ks[0]

    fs, unet = model.first_stage_model, model.model.diffusion_model
    enc, lat = grid(4 * lr_side), grid(lr_side)  # bsr_sr: the latent's side is the LR's
    return ([(fs.encoder, *enc, 1), (unet, *lat, steps), (fs.decoder, *lat, 3)],
            {"encode": enc, "unet": lat, "decode": lat})


def phase_superres(cfg_module):
    """Phase 16: `ldm/bsr_sr` (BSR_SR) through the notebook's workflow,
    `ealdm_torch.notebook_helpers`: `get_model("superresolution")` in
    bfloat16 and `run` with DDIM-50 at eta 1 on (a) the committed 64^2
    example (a 256^2 output: the encode over 3x3 crops of 128^2, one crop
    for the UNet and the decode) and (b) that example upsampled to 256^2
    (a 1024^2 output: 15x15 encode crops, 3x3 crops of 128^2 latent for the
    UNet, whose d=32 attention then runs at 256 rows, and for the decode,
    at 512^2 each). Each: launches against the module tree at the crops'
    sides, one timed run, a profile, every kernel launch of one pass
    (patched encode, one patched UNet call, patched decode) held. Then
    float32 card vs CPU at batch 1, 2 steps on input (a) with the crop grid
    cut to SR_REFERENCE_GRID."""
    import torch

    import ealdm_torch
    from ealdm_torch import notebook_helpers as nh
    from ealdm_torch.ops.patching import DEFAULT_SPLIT_PARAMS

    cfg = cfg_module.BSR_SR
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = nh.get_model("superresolution", seed=130, dtype=torch.bfloat16)
    parts = {k: sum(p.numel() for p in getattr(model, k).parameters())
             for k in ("model", "first_stage_model")}
    log(f"[superres] {cfg['zoo']}: UNet {parts['model'] / 1e6:.1f} M, VQ-f4 "
        f"{parts['first_stage_model'] / 1e6:.1f} M parameters, built in "
        f"{time.perf_counter() - t0:.1f} s; DDIM-{SR_STEPS}, eta 1, split-input "
        f"ks {DEFAULT_SPLIT_PARAMS['ks']} stride {DEFAULT_SPLIT_PARAMS['stride']}")
    params = dict(DEFAULT_SPLIT_PARAMS)
    patched = model.clone(split_input_params=params)
    inputs = superres_inputs()
    details, out = {}, {}
    for tag, arr in inputs.items():
        label = f"superres_{tag}"
        side = arr.shape[0]
        passes, grids = superres_passes(model, side, SR_STEPS, params)
        log(f"[{label}] LR {side}^2 -> {4 * side}^2: crops (count, side) {grids}")
        got = {}

        def run():
            got["log"] = nh.run(model, arr, custom_steps=SR_STEPS, eta=1.0, seed=131)

        example = nh.get_cond("superresolution", arr, device="cuda")
        t_mid = torch.full((1,), 500, dtype=torch.int64, device="cuda")

        def one_pass():  # the patched encode, one patched UNet call, the patched decode
            z = patched.encode_first_stage(example["image"])
            patched.apply_model(z, t_mid, example["LR_image"])
            patched.decode_first_stage(z)

        details[label], numbers = conditional_path(label, run, path_census(passes), 1,
                                                   one_pass)
        sample = got["log"]["sample"]
        check_image(label, sample, (1, 4 * side, 4 * side, 3))
        log(f"[{label}] sample std {float(sample.float().std()):.4f}; the profiled run's "
            f"sampler took {got['log']['time']:.4f} s of it")
        out[label] = dict(lr_side=side, out_side=4 * side, crops=grids, **numbers)
        del got, example
        torch.cuda.empty_cache()
    out["reference"] = superres_reference("superres-reference", model, inputs["a"])
    del model, patched
    torch.cuda.empty_cache()
    return details, dict(steps=SR_STEPS, eta=1.0, params_m={k: v / 1e6 for k, v in parts.items()},
                         **out)


def superres_reference(label, bf16_model, arr, seed=132):
    """Batch 1, 2 DDIM steps at eta 1, float32: `make_convolutional_sample`
    on the card (its kernels) and on the CPU (the plain versions), with
    `bf16_model`'s weights, split-input patching at SR_REFERENCE_GRID, the
    same x_T and step noise; the final latent, the sample and the
    reconstruction within 1e-3 of their scale, TF32 off, as phase 5."""
    import torch

    from ealdm_torch import notebook_helpers as nh
    from ealdm_torch import zoo
    from ealdm_torch.ops.patching import DEFAULT_SPLIT_PARAMS

    ks, stride = SR_REFERENCE_GRID
    params = dict(DEFAULT_SPLIT_PARAMS, ks=ks, stride=stride)
    side = arr.shape[0]
    _, grids = superres_passes(bf16_model, side, 2, params)
    sd = {k: v.float() for k, v in bf16_model.state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    latent = (1, side, side, 3)
    x_T = torch.randn(latent, generator=g)
    draws = [torch.randn(latent, generator=g) for _ in range(2)]
    got = {}
    t0 = time.perf_counter()
    for dev in ("cpu", "cuda"):
        m = zoo.build("ldm/bsr_sr", dtype=torch.float32, device=dev).eval()
        m.load_state_dict(sd)
        logs = nh.make_convolutional_sample(
            nh.get_cond("superresolution", arr, device=dev), m.clone(split_input_params=params),
            custom_steps=2, eta=1.0, x_T=x_T.to(dev), noise_fn=lambda i, shape: draws[i])
        for key, v in (("latent", logs["progressive_row"][-1]), ("sample", logs["sample"]),
                       ("reconstruction", logs["reconstruction"])):
            got.setdefault(key, {})[dev] = v.float().cpu()
        del m, logs
    rel = {f"{k}_rel": rel_err_to_max(v["cuda"], v["cpu"]) for k, v in got.items()}
    log(f"[{label}] float32 card vs CPU, batch 1, 2 steps, LR {side}^2, ks {ks} stride "
        f"{stride}: crops (count, side) {grids}; "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (tolerance 1e-3 each; {time.perf_counter() - t0:.1f} s)")
    if not all(v <= 1e-3 for v in rel.values()):
        raise RuntimeError(f"{label}: the card's float32 result disagrees with the CPU")
    return dict(ks=list(ks), stride=list(stride), crops=grids, **rel)


def phases_paths(cfg_module):
    """Phases 7-16. Returns ({path: launch details}, the [paths] line, with
    each phase's wall seconds under "seconds")."""
    details, out, seconds = {}, {}, {}
    for name, phase in (("inpaint", phase_inpaint), ("uncond", phase_uncond),
                        ("pixel", phase_pixel), ("kl", phase_kl), ("txt2img", phase_txt2img),
                        ("cin256", phase_cin256), ("churches", phase_churches),
                        ("inpainting_big", phase_inpainting_big), ("rdm", phase_rdm)):
        t0 = time.perf_counter()
        details[name], out[name] = phase(cfg_module)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sr_details, out["superres"] = phase_superres(cfg_module)
    seconds["superres"] = time.perf_counter() - t0
    details.update(sr_details)
    out["seconds"] = seconds
    return details, out


# ------------------------------------------------------------------ phase 6
def rel_err_to_max(got, want):
    """max |got - want| / max |want|, in float32 (0 when both are 0)."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else (got - want).abs().max().item()


def phase_train_grads():
    """(a) The autograd Functions' gradients on the card against autograd
    through the plain versions on the same inputs and cotangent. Both sides
    recompute the same float32 formula (`group_norm_plain`, the dense
    `sdpa`) on the same tensors, so they differ by the order of a sum at
    most: 1e-5 of each gradient's largest element. A detached kernel output
    has no grad_fn and fails before that."""
    import torch

    from ealdm_torch.ops.attention import _split_heads, flash_attention, sdpa
    from ealdm_torch.ops.norms import group_norm, group_norm_plain, silu

    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf = torch.float32, torch.bfloat16
    tol = 1e-5
    worst = {}

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def grads(fn, inputs, g):
        inputs = [t.detach().requires_grad_() for t in inputs]
        y = fn(*inputs)
        return y, torch.autograd.grad(y, inputs, g)

    def check(name, what, got, want, node):
        y, gs = got
        if y.grad_fn is None or type(y.grad_fn).__name__ != node:
            raise RuntimeError(f"{name} {what}: output grad_fn {y.grad_fn}, not {node}")
        errs = [rel_err_to_max(a, b) for a, b in zip(gs, want[1])]
        worst[name] = max(worst.get(name, 0.0), *errs)
        log(f"  {name:20s} {what:46s} grad errors / max {[f'{e:.2g}' for e in errs]} "
            f"(tolerance {tol:g})")
        if not all(math.isfinite(e) and e <= tol for e in errs):
            raise RuntimeError(f"{name} {what}: gradients disagree with the plain version")

    gn_cases = [((48, 256, 32, 32), True, "channels_last"),
                ((48, 1024, 8, 8), False, "channels_last"),
                ((24, 128, 256, 256), False, "channels_last"),
                ((8, 256, 32, 32), True, "nchw")]
    for shape, with_pre, layout in gn_cases:
        n, c = shape[:2]
        for dtype in (f32, bf):
            x = (3 * randn(*shape) + 1).to(dtype)
            if layout == "channels_last":
                x = x.contiguous(memory_format=torch.channels_last)
            g = randn(*shape, dtype=dtype)
            scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
            inputs = [x, scale, bias] + ([randn(n, c, dtype=dtype)] if with_pre else [])
            for act in (None, silu):
                def kernel(x, s, b, p=None):
                    return group_norm(x, s, b, 32, 1e-5, act, "NCHW", p)

                def plain(x, s, b, p=None):
                    return group_norm_plain(x, s, b, 32, 1e-5, act, "NCHW", p)

                what = (f"{list(shape)} {layout} {str(dtype)[6:]}"
                        f"{' pre_bias' if with_pre else ''}{' SiLU' if act else ''}")
                check("group_norm", what, grads(kernel, inputs, g), grads(plain, inputs, g),
                      "GroupNormKernelBackward")
            del x, g, inputs
    # flash d=32 on the UNet's head-strided view, d=512 as the VQ encoder
    # calls it; against the vjp of the dense sdpa
    for dtype in (f32, bf):
        for name, qkv in (
                ("flash_attention_d32", [_split_heads(randn(48, 1024, 256, dtype=dtype), 8)
                                         for _ in range(3)]),
                ("flash_attention_d512", [randn(48, 1, 1024, 512, dtype=dtype)
                                          for _ in range(3)])):
            g = randn(*qkv[0].shape, dtype=dtype)
            check(name, f"{list(qkv[0].shape)} {str(dtype)[6:]}",
                  grads(flash_attention, qkv, g), grads(sdpa, qkv, g), "FlashAttentionBackward")
            del qkv, g
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def train_batch(b, res, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    img = torch.randn(b, res, res, 3, generator=g).to(device)
    return {"img": img, "mixed": mixed_batch(b, res, seed + 1, device)}


def expected_train_launches(model, batch, cfg, remat):
    """Kernel launches of one train step, from the module tree: the first
    stage's encoder once on the N target frames, and under the STDiff CFG
    pair once more on the 2N conditioning pair; the UNet once on the N
    samples (2N for the CFG pair), and under "dots" or "full" once more
    when the backward recomputes each of its blocks and its out head (the
    kernels' outputs are not saved). The cond stages (the STDiff tower, the
    BERT, the ClassEmbedder) have no kernel site. {(counter, detail): n} in
    the wrappers' terms, plus the totals by counter."""
    import collections

    unet = model.model.diffusion_model
    enc = model.first_stage_model.encoder
    pair = model.cond_stage_key == "mixed" and model.unconditional_guidance_scale != 1.0
    runs = 1 if remat == "none" else 2
    passes = [(unet, (2 if pair else 1) * batch, cfg["zres"], runs), (enc, batch, cfg["res"], 1)]
    if pair:
        passes.append((enc, 2 * batch, cfg["res"], 1))
    census = path_census(passes)
    totals = collections.Counter()
    for (name, _), n in census.items():
        totals[name] += n
    return census, dict(totals)


def device_union_s(prof, skip=()):
    """Seconds in which the device ran anything in the profile: the union
    of its activities' intervals (kernels, copies, sets), so that two that
    overlap count once; a range's span on the device track (a user
    annotation, or a name in `skip`) is not an activity."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in skip
                   and not getattr(e, "is_user_annotation", False))
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def train_profile_groups(prof):
    """Device seconds of one profiled train step: busy (`device_union_s`),
    the kernels' summed, and that sum by group. Kernels launched
    inside the `ealdm::group_norm_vjp`, `ealdm::flash_attention_vjp`,
    `ealdm::adamw` and `ealdm::ema` ranges (the plain backwards, the
    optimizer, the EMA) count there, whatever they are; the others by
    kernel name."""
    from torch.autograd import DeviceType

    ranges = {"ealdm::group_norm_vjp": "GroupNorm backward (plain)",
              "ealdm::flash_attention_vjp": "attention backward (plain)",
              "ealdm::adamw": "AdamW and EMA", "ealdm::ema": "AdamW and EMA"}
    by_name = {"GroupNorm forward kernel": GN_KERNELS,
               "flash forward kernel": FLASH_KERNELS,
               "convolutions": ("fprop", "dgrad", "wgrad", "conv", "nchw", "nhwc"),
               "matmuls": ("gemm", "nvjet", "cutlass"),
               "copies and casts": ("copy_kernel",),
               "elementwise and reductions": ("elementwise", "reduce_kernel",
                                              "multi_tensor_apply")}
    totals = dict.fromkeys([*by_name, *dict.fromkeys(ranges.values()), "other"], 0.0)
    in_range = {}

    def subtree(e):
        yield from e.kernels
        for ch in e.cpu_children:
            yield from subtree(ch)

    events = prof.events()
    for e in events:
        if e.name in ranges and e.device_type == DeviceType.CPU:
            for k in subtree(e):
                totals[ranges[e.name]] += k.duration / 1e6
                in_range[k.name] = in_range.get(k.name, 0.0) + k.duration / 1e6
    summed, launches, rows = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key in ranges or getattr(e, "is_user_annotation", False):
            continue  # a range's span on the device track, not a kernel
        t = e.self_device_time_total / 1e6
        summed += t
        launches += e.count
        rest = t - in_range.get(e.key, 0.0)
        tag = next((g for g, names in by_name.items() if any(n in e.key for n in names)),
                   "other")
        totals[tag] += rest
        rows.append((t, e.count, tag, e.key))
    return device_union_s(prof, ranges), summed, totals, launches, sorted(rows, reverse=True)


def profile_train_step(label, step, state, batch, seed, dt, top=20):
    """One train step under torch.profiler: (device busy s, device s by
    group, kernel launches, profiled wall s), logged with the idle share of
    the profiled step (busy, the union of the device's activities, against
    that step's own wall), `dt` (the median unprofiled step) beside it, and
    the `top` kernels. Raises
    where the profile shows no device time in the plain backwards or the
    optimizer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, summed, groups, n_kernels, rows = train_profile_groups(prof)
    if busy <= 0:
        raise RuntimeError(f"{label}: the profiler saw no device time in the train step")
    log(f"[{label}] device busy {busy * 1e3:.1f} ms (kernels summed {summed * 1e3:.1f} ms) in "
        f"{n_kernels} kernel launches; idle share {1 - busy / prof_wall:.4f} of the profiled "
        f"step ({prof_wall * 1e3:.1f} ms; the median unprofiled one {dt * 1e3:.1f} ms)")
    for tag, t in groups.items():
        log(f"[{label}] {tag:28s} {t * 1e3:9.2f} ms = {t / summed:.3f} of kernel time")
    for t, n, tag, key in rows[:top]:
        log(f"[{label}] {t * 1e3:8.2f} ms x{n:<5d} ({tag}, ranges included) {key[:90]}")
    for tag in ("GroupNorm backward (plain)", "attention backward (plain)", "AdamW and EMA"):
        if groups[tag] <= 0:
            raise RuntimeError(f"{label}: the profile attributes no device time to {tag}")
    return busy, groups, n_kernels, prof_wall


def phase_train(cfg_module):
    """(b) `bench.py --train`'s step on the flagship: one warm-up step and
    five timed ones, launches per step against the module tree, one
    profiled step; (c) gradient completeness after the first step."""
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.models.layers import GroupNorm32
    from ealdm_torch.training import init_train_state, make_train_step

    cfg, tc = cfg_module.FLAGSHIP, cfg_module.FLAGSHIP_TRAIN
    ealdm_torch.enable_inference_optimizations()
    batch_size = tc["batch_size"]
    t0 = time.perf_counter()
    model = LatentDiffusion(**cfg_module.model_kwargs(cfg), dtype=getattr(torch, tc["dtype"]),
                            device="cuda")
    random_init_(model, seed=0)
    state, opt = init_train_state(model, learning_rate=tc["learning_rate"],
                                  ema_decay=tc["ema_decay"])
    step = make_train_step(model, opt, remat=tc["remat"])
    n_train = sum(p.numel() for k, p in state.params.items() if k in state.opt_state.mu)
    log(f"[train] flagship {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, {n_train / 1e6:.1f} M trainable; batch {batch_size}, "
        f"{tc['dtype']} compute, remat {tc['remat']!r}, lr {tc['learning_rate']}; "
        f"built in {time.perf_counter() - t0:.1f} s")
    batch = train_batch(batch_size, cfg["res"], seed=21, device="cuda")
    frozen = {k: p.detach().clone() for k, p in state.params.items()
              if k.startswith("first_stage_model")}
    want, want_totals = expected_train_launches(model, batch_size, cfg, tc["remat"])

    def run_step(step_fn, seed):
        """(wall s, loss, grad norm, launches by detail) of one step."""
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step_fn(state, batch, torch.Generator().manual_seed(seed))
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()  # waits for the step
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss, gnorm, dict(kernels.launch_details)

    warm_s, loss0, gnorm0, details0 = run_step(step, 100)
    # (c) gradient completeness after the first step
    missing, bad, zero = [], [], []
    for k, p in state.params.items():
        if k in state.opt_state.mu:
            if p.grad is None:
                missing.append(k)
            elif not bool(torch.isfinite(p.grad).all()):
                bad.append(k)
        elif p.grad is not None:
            bad.append(k)
    unet = model.model.diffusion_model
    must_move = {"model.diffusion_model.conv_in.weight": unet.conv_in.weight}
    for name, m in unet.named_modules():
        if isinstance(m, GroupNorm32):
            must_move[f"{name}.weight"], must_move[f"{name}.bias"] = m.weight, m.bias
    zero = [k for k, p in must_move.items() if p.grad is None or not p.grad.abs().max() > 0]
    moved = [k for k, p in frozen.items() if not torch.equal(state.params[k], p)]
    log(f"[train] after the first step: {len(state.opt_state.mu)} trainable tensors, "
        f"missing grads {missing[:4]}, non-finite or unexpected {bad[:4]}, zero among "
        f"conv_in and {len(must_move) - 1} UNet GroupNorm scales/biases {zero[:4]}, "
        f"first-stage tensors moved {moved[:4]} of {len(frozen)}")
    if missing or bad or zero or moved:
        raise RuntimeError("gradient completeness failed after the first step")
    del frozen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = [run_step(step, 200 + i) for i in range(5)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    walls = [s[0] for s in steps]
    dt = sorted(walls)[2]
    got_totals = {}
    for (name, _), n in steps[0][3].items():
        got_totals[name] = got_totals.get(name, 0) + n
    log(f"[train] warm-up step {warm_s:.2f} s (loss {loss0:.6f}, grad norm {gnorm0:.6f}); "
        f"timed steps {[round(w, 4) for w in walls]} s: median {dt * 1e3:.1f} ms = "
        f"{batch_size / dt:.3f} img/s; peak {peak_gib:.2f} GiB")
    log(f"[train] losses {[round(s[1], 6) for s in steps]}, grad norms "
        f"{[round(s[2], 6) for s in steps]}")
    log(f"[train] launches per step {got_totals} (module tree: {want_totals})")
    for key in sorted(set(want) | set(steps[0][3]), key=str):
        log(f"  {str(key):70s} {steps[0][3].get(key, 0)} ({want.get(key, 0)})")
    for i, s in enumerate(steps):
        if s[3] != want:
            raise RuntimeError(f"timed step {i}: launches differ from the module tree's")
        if not (math.isfinite(s[1]) and math.isfinite(s[2])):
            raise RuntimeError(f"timed step {i}: non-finite loss or grad norm")
    if details0 != want:
        raise RuntimeError("warm-up step: launches differ from the module tree's")
    for name in ("flash_attention_d32", "flash_attention_d512", "group_norm",
                 "group_norm_two_pass"):
        if not got_totals.get(name):
            raise RuntimeError(f"{name} was not launched by the train step")
    busy, groups, n_kernels, prof_wall = profile_train_step("train-profile", step, state,
                                                            batch, 300, dt)
    # the other remat policies, one step each: launches against the module
    # tree and finite losses (PERF.md keeps their three-step timings)
    policies = {}
    for policy in ("none", "full"):
        other = make_train_step(model, opt, remat=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall, loss, gnorm, got = run_step(other, 400)
        expect, _ = expected_train_launches(model, batch_size, cfg, policy)
        ok = got == expect and math.isfinite(loss) and math.isfinite(gnorm)
        policies[policy] = dict(step_s=wall,
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"[train] remat {policy!r}: one step {wall:.4f} s (its first), peak "
            f"{policies[policy]['peak_gib']:.2f} GiB, launches as the module tree gives "
            f"and finite loss and grad norm: {ok}")
        if not ok:
            raise RuntimeError(f"remat {policy!r}: launches {got} against {expect}, "
                               f"loss {loss}, grad norm {gnorm}")
    out = dict(batch=batch_size, dtype=tc["dtype"], remat=tc["remat"],
               step_ms=dt * 1e3, walls_s=walls, img_per_s=batch_size / dt,
               warmup_s=warm_s, peak_gib=peak_gib, losses=[loss0] + [s[1] for s in steps],
               grad_norms=[gnorm0] + [s[2] for s in steps], launches_per_step=got_totals,
               device_busy_ms=busy * 1e3, idle_share=1 - busy / prof_wall,
               kernel_launches=n_kernels,
               profiled_wall_ms=prof_wall * 1e3,
               device_ms_by_group={k: v * 1e3 for k, v in groups.items()},
               other_remat=policies)
    return model, out


def train_step_inputs(b, zshape, seed):
    """The t, noise and KL posterior noise of a checked train step, drawn on
    the host (the same on every device): t ~ U{0..999}, the noise and the
    posterior's [b, *zshape]."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, 1000, (b,), generator=g)
    noise = torch.randn(b, *zshape, generator=g)
    return t, noise, torch.randn(b, *zshape, generator=g)


def checked_loss(m, batch, t, noise, fs_noise, remat):
    """The training loss of `m` on `batch` at the given t and noise, dropout
    off, the first stage's encode (its KL posterior drawn as fs_noise)
    without gradient and the UNet under `remat`."""
    enc = m.encode_inputs(batch, noise=fs_noise)
    with m.model.diffusion_model.remat_blocks(remat):
        return m.training_loss(batch, None, t=t, noise=noise, train=False, encoded=enc)[0]


def phase_train_reference(label, kw, remat, trained, batch, zshape, listed, seed):
    """(d) One training step's loss and gradients at full width, batch 1,
    float32, dropout off, TF32 off for the library's matmuls and
    convolutions (the flash kernel computes in split TF32, about 1e-6 from
    float32): the card (kernels) against the CPU (plain versions), same
    weights, batch, t, noise and posterior noise. The sums differ in order
    (cuDNN and cuBLAS against oneDNN) and the attention differs in form
    (the flash kernel against dense sdpa): loss to 1e-4 relative, the grad
    norm to 1e-3 relative, and each listed gradient to 1e-3 of its largest
    element. `batch` is on the CPU; zshape is the latent's [h, w, c]."""
    import torch

    from ealdm_torch.models.ddpm import LatentDiffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = {k: v.float() for k, v in trained.state_dict().items()}
    t, noise, fs_noise = train_step_inputs(1, zshape, seed)
    res = {}
    for dev in ("cpu", "cuda"):
        m = LatentDiffusion(**kw, dtype=torch.float32, device=dev)
        m.load_state_dict(sd)
        m.train()
        b = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dev)) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss = checked_loss(m, b, t.to(dev), noise.to(dev), fs_noise.to(dev), remat)
        loss.backward()
        grads = [p.grad for p in m.parameters() if p.requires_grad]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).item()
        named = dict(m.named_parameters())
        res[dev] = (loss.item(), gnorm, {k: named[k].grad.float().cpu() for k in listed})
        log(f"[{label}] {dev}: loss {res[dev][0]:.8f}, grad norm {gnorm:.8f} "
            f"({time.perf_counter() - t0:.1f} s)")
        del m, grads, named
    torch.cuda.empty_cache()
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = res["cpu"], res["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = abs(n_gpu - n_cpu) / abs(n_cpu)
    grad_rel = {k: rel_err_to_max(g_gpu[k], g_cpu[k]) for k in listed}
    log(f"[{label}] float32 card vs CPU: loss {loss_rel:.3g} relative (tolerance "
        f"1e-4), grad norm {norm_rel:.3g} (1e-3), gradients / max "
        f"{ {k.split('.', 1)[1]: f'{v:.3g}' for k, v in grad_rel.items()} } (1e-3)")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and all(v <= 1e-3 for v in grad_rel.values())):
        raise RuntimeError(f"{label}: the card's float32 train step disagrees with the CPU")
    return dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, grad_rel_to_max=grad_rel)


# the gradients phase 6 (d) holds one by one on the flagship
FLAGSHIP_LISTED = ("model.diffusion_model.conv_in.weight",
                   "model.diffusion_model.mid_res1.out_norm.weight",
                   "model.diffusion_model.down_0_0_attn.block_0.attn1.to_q.weight",
                   "cond_stage_model.out_3.weight")


# a GroupNorm kernel whose output is this much too large (a systematic
# error of about 4 bf16 ulps) must fail phase 6 (e)'s limit
PLANTED_GN_SCALE = 2**-5


def phase_train_bf16_check(label, kw, remat, model, batch, zshape, seed):
    """(e) The numbers of the step that is timed: one bf16 step on `batch`
    (same weights, t, noise and posterior noise, dropout off, `remat`) with
    the kernels, and again with each kernel launch replaced by its plain
    version on the card (`group_norm_plain`, `flash_attention_plain`; the
    backwards are the same code on both sides). The two can differ only by
    the kernels' rounding, which is of the kind bf16 compute adds
    everywhere, so the limit comes from the bf16 step's own error: the plain
    bf16 gradient's distance from a float32 step's (plain versions, TF32
    off). Over every trainable element (410 M on the flagship),
        |g_kernels - g_plain| <= 2 |g_plain - g_float32|
    (two bf16 runs whose roundings were independent would land sqrt(2)
    apart), and the grad norms then differ by no more (triangle
    inequality). The loss, a mean over the batch's latents, must agree to
    2^-8 relative, one bf16 rounding of the loss itself. A GroupNorm kernel
    with its output `PLANTED_GN_SCALE` too large must fail the gradient
    limit."""
    import contextlib

    import torch

    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.ops import attention, norms

    n = next(iter(batch.values())).shape[0]
    t, noise, fs_noise = (v.cuda() for v in train_step_inputs(n, zshape, seed))
    kernel_gn, kernel_flash = norms.group_norm_kernel, attention.flash_attention_kernel

    def plain_gn(x, scale, bias, num_groups, eps, fuse_silu, pre_bias=None):
        return norms.group_norm_plain(x, scale, bias, num_groups, eps,
                                      norms.silu if fuse_silu else None, "NCHW",
                                      None if pre_bias is None else pre_bias.to(x.dtype))

    def faulty_gn(*args, **kwargs):
        return kernel_gn(*args, **kwargs) * (1 + PLANTED_GN_SCALE)

    @contextlib.contextmanager
    def launches(gn, flash):
        norms.group_norm_kernel, attention.flash_attention_kernel = gn, flash
        try:
            yield
        finally:
            norms.group_norm_kernel, attention.flash_attention_kernel = kernel_gn, kernel_flash

    def step(m, remat_):
        """(loss, every trainable gradient as one float32 vector)."""
        m.train()
        params = [p for p in m.parameters() if p.requires_grad]
        loss = checked_loss(m, batch, t, noise, fs_noise, remat_)
        return loss.item(), torch.cat([x.float().flatten()
                                       for x in torch.autograd.grad(loss, params)])

    t0 = time.perf_counter()
    with launches(plain_gn, attention.flash_attention_plain):
        l_plain, g_plain = step(model, remat)
        ref = LatentDiffusion(**kw, dtype=torch.float32, device="cuda")
        ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        l_ref, g_ref = step(ref, "none")
        del ref
    ref_norm = g_ref.norm().item()
    bf16_err = (g_plain - g_ref).norm().item() / ref_norm
    del g_ref
    res = {"loss_float32": l_ref, "loss_plain": l_plain, "grad_norm_plain": g_plain.norm().item(),
           "plain_vs_float32": bf16_err, "limit": 2 * bf16_err,
           "trainable_elements": g_plain.numel()}
    for name, gn in (("kernels", kernel_gn), ("planted_fault", faulty_gn)):
        with launches(gn, kernel_flash):
            loss, grad = step(model, remat)
        res[name] = {"loss": loss, "loss_rel": abs(loss - l_plain) / abs(l_plain),
                     "grad_norm": grad.norm().item(),
                     "grad_vs_plain": (grad - g_plain).norm().item() / ref_norm}
        del grad
    del g_plain
    torch.cuda.empty_cache()
    k, f = res["kernels"], res["planted_fault"]
    log(f"[{label}] batch {n}, bfloat16, remat {remat!r}, {res['trainable_elements']} "
        f"trainable elements ({time.perf_counter() - t0:.1f} s): "
        f"loss kernels {k['loss']:.8f}, plain {l_plain:.8f}, float32 {l_ref:.8f}; "
        f"|g_kernels - g_plain| = {k['grad_vs_plain']:.4g} of |g_float32|, limit "
        f"{res['limit']:.4g} (twice |g_plain - g_float32| = {bf16_err:.4g}); loss "
        f"{k['loss_rel']:.3g} relative (limit {2**-8:.3g}); grad norms {k['grad_norm']:.6f} "
        f"/ {res['grad_norm_plain']:.6f}")
    log(f"[{label}] planted fault (GroupNorm output x (1 + {PLANTED_GN_SCALE:g})): "
        f"{f['grad_vs_plain']:.4g} of |g_float32| against the limit {res['limit']:.4g}; "
        f"loss {f['loss_rel']:.3g} relative")
    if not (k["grad_vs_plain"] <= res["limit"] and k["loss_rel"] <= 2**-8):
        raise RuntimeError(f"{label}: the bf16 train step with the kernels disagrees with the "
                           "plain one")
    if f["grad_vs_plain"] <= res["limit"]:
        raise RuntimeError(f"{label}: the planted GroupNorm fault passed the bf16 step's limit")
    return res


# phase 6 (f): the conditional configs' train steps, by name: (config,
# training settings, seed, the gradients (d) holds one by one)
TRAIN_COND = {
    "cin256": ("CIN256", "CIN256_TRAIN", 140,
               ("model.diffusion_model.conv_in.weight",
                "model.diffusion_model.mid_res1.out_norm.weight",
                "model.diffusion_model.down_1_0_attn.block_0.attn1.to_q.weight",
                "cond_stage_model.embedding.embedding")),
    "txt2img": ("TXT2IMG", "TXT2IMG_TRAIN", 150,
                ("model.diffusion_model.conv_in.weight",
                 "model.diffusion_model.mid_res1.out_norm.weight",
                 "model.diffusion_model.down_0_0_attn.block_0.attn1.to_q.weight",
                 "cond_stage_model.transformer.layer_31_attn.to_q.weight")),
}


def cond_train_batch(model, cfg, b, seed, device):
    """A seeded batch for the conditional configs' step: b images in [-1, 1]
    under the first-stage key and, under the cond-stage key, class ids
    below 1000 or the token ids of b prompts from the host tokenizer."""
    import torch

    g = torch.Generator().manual_seed(seed)
    batch = {model.first_stage_key: torch.rand(b, cfg["res"], cfg["res"], 3, generator=g) * 2 - 1}
    if model.cond_stage_key == "class_label":
        batch["class_label"] = torch.randint(0, 1000, (b,), generator=g)
    else:
        words = TXT2IMG_PROMPT.split()
        prompts = [" ".join(words[i % len(words):] + words[:i % len(words)]) for i in range(b)]
        batch[model.cond_stage_key] = model.cond_stage_model.tokenize(prompts)
    return {k: v.to(device) for k, v in batch.items()}


def phase_train_cond(cfg_module, name):
    """(f) A conditional config's train step (TRAIN_COND[name]) at full
    width in bfloat16: the cond stage (ClassEmbedder or the 32-layer BERT)
    trains with the UNet, the first stage is frozen. One warm-up step and
    three timed ones (img/s of the median, peak GiB), launches per step
    against the module tree, gradient completeness after the first step,
    one profiled step (device busy, idle share); then (e) and (d) on this
    config. Returns (the first timed step's launch details, numbers)."""
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.training import init_train_state, make_train_step

    cfg_key, tc_key, seed, listed = TRAIN_COND[name]
    cfg, tc = getattr(cfg_module, cfg_key), getattr(cfg_module, tc_key)
    kw = cfg_module.model_kwargs(cfg)
    label, n = f"train-{name}", tc["batch_size"]
    zshape = (cfg["zres"], cfg["zres"], cfg["zch"])
    ealdm_torch.enable_inference_optimizations()
    t0 = time.perf_counter()
    model = LatentDiffusion(**kw, dtype=getattr(torch, tc["dtype"]), device="cuda")
    random_init_(model, seed=seed)
    state, opt = init_train_state(model, learning_rate=tc["learning_rate"],
                                  use_ema=tc["use_ema"])
    step = make_train_step(model, opt, remat=tc["remat"])
    trainable = {k for k in state.opt_state.mu}
    n_cond = sum(p.numel() for k, p in state.params.items()
                 if k in trainable and k.startswith("cond_stage_model"))
    log(f"[{label}] {cfg_key} {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters, {sum(state.params[k].numel() for k in trainable) / 1e6:.1f} M trainable "
        f"(cond stage {n_cond / 1e6:.1f} M); batch {n}, {tc['dtype']} compute, remat "
        f"{tc['remat']!r}, lr {tc['learning_rate']}, EMA {tc['use_ema']}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = cond_train_batch(model, cfg, n, seed + 1, "cuda")
    want, want_totals = expected_train_launches(model, n, cfg, tc["remat"])
    before = {k: p.detach().clone() for k, p in state.params.items()
              if k.startswith(("first_stage_model", "cond_stage_model"))}

    def run_step(i):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step(state, batch, torch.Generator().manual_seed(seed + 10 + i))
        loss = m["loss"].item()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss, dict(kernels.launch_details)

    warm_s, loss0, details0 = run_step(0)
    # every trainable tensor has a finite gradient, no frozen one has any
    bad = [k for k, p in state.params.items() if (k in trainable) != (p.grad is not None)
           or (p.grad is not None and not bool(torch.isfinite(p.grad).all()))]
    moved = {k: not torch.equal(state.params[k], p) for k, p in before.items()}
    frozen_moved = [k for k, v in moved.items() if v and k.startswith("first_stage_model")]
    cond_still = [k for k, v in moved.items() if not v and k.startswith("cond_stage_model")]
    log(f"[{label}] after the first step: {len(trainable)} trainable tensors; missing, "
        f"non-finite or unexpected grads {bad[:4]}; cond-stage tensors that did not "
        f"move {cond_still[:4]} of {sum(k.startswith('cond') for k in moved)}; first-stage "
        f"tensors moved {frozen_moved[:4]}")
    if bad or frozen_moved or cond_still or not n_cond:
        raise RuntimeError(f"{label}: gradient completeness failed after the first step")
    del before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = [run_step(1 + i) for i in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = [r[0] for r in steps]
    dt = sorted(walls)[1]
    totals = {}
    for (counter, _), c in steps[0][2].items():
        totals[counter] = totals.get(counter, 0) + c
    log(f"[{label}] warm-up step {warm_s:.2f} s (loss {loss0:.6f}); timed steps "
        f"{[round(w, 4) for w in walls]} s: median {dt * 1e3:.1f} ms = {n / dt:.3f} img/s; "
        f"peak {peak:.2f} GiB; losses {[round(r[1], 6) for r in steps]}")
    log(f"[{label}] launches per step {totals} (module tree: {want_totals})")
    for i, r in enumerate([(warm_s, loss0, details0), *steps]):
        if r[2] != want:
            check_launches(f"{label} step {i}", want, r[2])
        if not math.isfinite(r[1]):
            raise RuntimeError(f"{label} step {i}: non-finite loss")
    busy, groups, n_kernels, prof_wall = profile_train_step(f"{label}-profile", step, state,
                                                            batch, seed + 20, dt, top=8)
    out = dict(batch=n, dtype=tc["dtype"], remat=tc["remat"], step_ms=dt * 1e3, walls_s=walls,
               img_per_s=n / dt, warmup_s=warm_s, peak_gib=peak,
               losses=[loss0] + [r[1] for r in steps], launches_per_step=totals,
               trainable_m=sum(state.params[k].numel() for k in trainable) / 1e6,
               cond_stage_trainable_m=n_cond / 1e6, device_busy_ms=busy * 1e3,
               idle_share=1 - busy / prof_wall, kernel_launches=n_kernels,
               profiled_wall_ms=prof_wall * 1e3,
               device_ms_by_group={k: v * 1e3 for k, v in groups.items()})
    del state, opt, step
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    out["bf16_check"] = phase_train_bf16_check(
        f"{label}-bf16", kw, tc["remat"], model, cond_train_batch(model, cfg, n, seed + 2, "cuda"),
        zshape, seed=seed + 3)
    out["reference"] = phase_train_reference(
        f"{label}-reference", kw, tc["remat"], model,
        cond_train_batch(model, cfg, 1, seed + 4, "cpu"), zshape, listed, seed=seed + 5)
    del model
    torch.cuda.empty_cache()
    return steps[0][2], out


def phases_train(cfg_module):
    """Phase 6, training: (a) gradient checks, (b) + (c) the flagship train
    step, (e) its bf16 numbers against the plain versions', (d) float32
    card vs CPU; (f) the cin256-v2 and txt2img steps with their (e) and
    (d). Returns ({path: launches of one step}, the [train] line's dict)."""
    import torch

    cfg, tc = cfg_module.FLAGSHIP, cfg_module.FLAGSHIP_TRAIN
    kw = cfg_module.model_kwargs(cfg)
    zshape = (cfg["zres"], cfg["zres"], 4)
    grads = phase_train_grads()
    model, out = phase_train(cfg_module)
    out["grad_check_worst"] = grads
    out["bf16_check"] = phase_train_bf16_check(
        "train-bf16", kw, tc["remat"], model,
        train_batch(tc["batch_size"], cfg["res"], seed=41, device="cuda"), zshape, seed=42)
    out["reference"] = phase_train_reference(
        "train-reference", kw, tc["remat"], model, train_batch(1, cfg["res"], seed=31,
                                                                device="cpu"),
        zshape, FLAGSHIP_LISTED, seed=32)
    del model
    torch.cuda.empty_cache()
    details = {}
    for name in ("cin256", "txt2img"):
        details[f"train_{name}"], out[name] = phase_train_cond(cfg_module, name)
    return details, out


# ------------------------------------------------------------------ phase 17
# the trainable first stages, by name: (config, seed, the AE tensors (a)
# names in its log)
AE_TRAIN = {"vq_f8": ("VQ_F8_AE_TRAIN", 170), "kl_f8": ("KL_F8_AE_TRAIN", 180)}
AE_CHECK_BATCH = 1  # (a)'s float32 step, card against CPU, at full width
# (a)'s bound on the L1 elements whose sign(rec - x) the card's and the CPU's
# forwards disagree on, a batch image: float32 rounding moves a few across x
# (0-1 seen at 256^2); a wrong forward moves many
AE_MAX_SIGN_FLIPS = 4
AE_LOOP_BATCH = 2   # (e)'s loop


def ae_modules(cfg, seed, device):
    """(autoencoder, loss module) of a trainable first-stage config in
    float32 with seeded random weights: `random_init_` for the autoencoder
    and the VGG trunk, the discriminator's N(0, 0.02^2), LPIPS's heads at
    JAX's 1/C and logvar at its initial value, as built."""
    import torch

    from ealdm_torch.training import build_autoencoder, random_init_autoencoder_

    vae, loss = build_autoencoder(cfg["model"], torch.float32, device)
    random_init_autoencoder_(vae, loss, seed)
    return vae, loss


def ae_images(b, res, seed):
    """b host images in [-1, 1], [b, res, res, 3]."""
    import torch

    return torch.rand(b, res, res, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def ae_noise(vae, b, res, seed):
    """Host posterior noise of a KL autoencoder's [b, h, w, embed_dim]
    latent, None for a VQ one."""
    import torch

    from ealdm_torch.models.vae import AutoencoderKL

    if not isinstance(vae, AutoencoderKL):
        return None
    f = 2 ** (vae.encoder.num_levels - 1)
    c = vae.post_quant_conv.weight.shape[1]
    return torch.randn(b, res // f, res // f, c, generator=torch.Generator().manual_seed(seed))


def disc_sites(disc, side):
    """(C, side, groups) of each GroupNorm of the discriminator on a side^2
    input: 4x4 convolutions with padding 1, stride 2 up to the last."""
    sites = []
    side = (side - 2) // 2 + 1  # conv_in
    for n in range(1, disc.n_layers + 1):
        side = (side - 2) // (2 if n < disc.n_layers else 1) + 1
        norm = getattr(disc, f"norm_{n}")
        sites.append((norm.weight.numel(), side, norm.num_groups))
    return sites


def f32_flash_splits(b, h, n, d):
    """The key split the float32 flash entry point takes at [b, h, n, d]."""
    import torch

    from ealdm_torch.kernels import build
    from ealdm_torch.ops.attention import tf32x3_tiling

    lib = build.library("flash_attention_sm90_f32")
    return lib.ealdm_flash_attention_sm90_f32_splits(
        0, *tf32x3_tiling(d, torch.float32), b, h, n, n, d)


def ae_train_census(vae, loss, b, res):
    """Kernel launches of one float32 VAE-GAN step at batch b, from the
    module tree: the encoder and the decoder once (the d_weight gradients
    and the backward rerun no kernel: the backwards are the plain vjps), the
    discriminator three times (the GAN loss on the reconstruction, then the
    real and fake logits of its own update), the key-split combine beside
    each float32 flash launch that splits. LPIPS has no kernel site.
    {(counter, detail): n}, and the totals by counter."""
    import collections

    import torch

    from ealdm_torch.ops.attention import COMBINE_COUNTER, flash_counter
    from ealdm_torch.ops.norms import group_norm_path, resolve_num_groups

    f = 2 ** (vae.encoder.num_levels - 1)
    census = collections.Counter(path_census(
        [(vae.encoder, b, res, 1), (vae.decoder, b, res // f, 1)], "float32"))
    for c, s, groups in disc_sites(loss.discriminator, res):
        shape = (b, c, s, s)
        path = group_norm_path(shape, torch.float32, resolve_num_groups(c, groups))
        census[(path, ("channels_last", shape, "float32"))] += 3
    for (name, rows), n in list(census.items()):
        if name.startswith("flash_attention"):
            d = int(name.rsplit("_d", 1)[1])
            if name == flash_counter(d, dtype=torch.float32) and f32_flash_splits(
                    b, 1, rows, d) > 1:
                census[(COMBINE_COUNTER, rows)] += n
    totals = collections.Counter()
    for (name, _), n in census.items():
        totals[name] += n
    return dict(census), dict(totals)


def ae_forward(vae, x, noise):
    """The reconstruction of a train step's forward (a KL posterior sample
    drawn as `noise`)."""
    from ealdm_torch.models.vae import AutoencoderKL

    return vae(x, None, noise=noise)[0] if isinstance(vae, AutoencoderKL) else vae(x)[0]


def l1_flip_correction(loss, x, rec_cpu, rec_gpu, params):
    """The L1 pixel loss's gradient is discontinuous where a reconstructed
    element equals its input: an element whose sign(rec - x) differs between
    the card's forward and the CPU's (about one at batch 1, 256^2, where the
    two reconstructions differ by float32 rounding) moves the loss's
    gradient with respect to rec by 2 * its coefficient, and every parameter
    gradient by that vector's vjp. Returns (the elements whose sign
    differs, {name: the vjp through the CPU's graph}), so that the CPU's
    gradients plus the vjp are what the card's signs give."""
    import torch

    s_gpu, s_cpu = torch.sign(rec_gpu - x), torch.sign(rec_cpu.detach() - x)
    flips = int((s_gpu != s_cpu).sum())
    if not flips or getattr(loss, "pixel_loss", "l1") != "l1":
        return flips, {}
    if hasattr(loss, "logvar"):  # the KL loss: NLL summed over pixels, / B, / exp(logvar)
        coef = loss.pixelloss_weight / float(torch.exp(loss.logvar.detach())) / x.shape[0]
    else:  # the VQ loss: the mean over every element
        coef = loss.pixelloss_weight / x.numel()
    names = list(params)
    grads = torch.autograd.grad(rec_cpu, [params[k] for k in names], (s_gpu - s_cpu) * coef,
                                allow_unused=True)
    return flips, {k: g for k, g in zip(names, grads) if g is not None}


def disc_grads_f64(cfg, loss_sd, x, rec, step):
    """{name: gradient} of the discriminator's update loss at global step
    `step` on the CPU, computed in float64 (GroupNorm statistics too; the
    float32 parameters are cast to it, so each gradient is rounded to
    float32 once), with the weights of `loss_sd`, on images x and the
    reconstruction rec."""
    import torch

    from ealdm_torch.losses import build_loss
    from ealdm_torch.ops.norms import set_norm_stats_precision

    lm = build_loss(cfg["model"]["params"]["lossconfig"], torch.float64, "cpu")
    lm.load_state_dict(loss_sd)
    params = dict(lm.discriminator.named_parameters())
    set_norm_stats_precision("native")
    try:
        d_total, _ = lm.discriminator_loss(x.double(), rec.double(), step)
        grads = torch.autograd.grad(d_total, list(params.values()))
    finally:
        set_norm_stats_precision("fp32")
    return {f"discriminator.{k}": g for k, g in zip(params, grads)}


def ae_checked_step(label, cfg, vae, loss, seed):
    """(a) One float32 step at full width and batch AE_CHECK_BATCH, the card
    (kernels, TF32 off for the library) against the CPU (plain versions):
    the same weights, images and posterior noise, at global step disc_start
    so that the GAN term, d_weight's share of the decoder's gradient and
    the discriminator's update are live on both sides. After one step from
    zero moments Adam's mu is (1 - b1) g, so the gradients are held through it:
    each trained tensor within 1e-3 of its largest element plus 1e-6 of the
    optimizer's largest (the float32 rounding of a gradient that is zero but
    for it: a bias ahead of a GroupNorm, the attention's key bias), after
    the CPU's gradients take the vjp of the L1 elements whose sign the two
    forwards disagree on (`l1_flip_correction`), of which there may be at
    most AE_MAX_SIGN_FLIPS an image. The discriminator's gradients are held
    the same way against its update in float64 on the CPU from the same
    weights, x and the card's reconstruction (`disc_grads_f64`): they move
    by up to 2e-3 of their largest between the card's reconstruction and
    the CPU's, which differ by float32 rounding, and a float32 sum (the
    card's or the CPU's) lies up to about 1e-3 from float64 where a
    difference of the real and the fake terms cancels behind a GroupNorm.
    Each is held within 1e-3 of its largest plus the floor, or within twice
    the CPU's own float32 error against float64 (on its reconstruction),
    whichever is larger. The total loss within 1e-4
    relative; d_weight and every other logged metric within 1e-4 relative
    plus 1e-6."""
    import torch

    from ealdm_torch.training import (build_autoencoder, init_vae_train_state,
                                      make_vae_train_step)

    b, res = AE_CHECK_BATCH, cfg["res"]
    cfg_step = loss.disc_start
    x = ae_images(b, res, seed)
    noise = ae_noise(vae, b, res, seed + 1)
    sds = (vae.state_dict(), loss.state_dict())
    out, recs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if dev == "cuda":
            v, lm = vae, loss
        else:
            v, lm = build_autoencoder(cfg["model"], torch.float32, "cpu")
            v.load_state_dict(sds[0])
            lm.load_state_dict(sds[1])
        state, oa, od = init_vae_train_state(v, lm, cfg["learning_rate"],
                                             cfg["lr_g_factor"], device=dev)
        state.step = cfg_step  # the first step with the GAN terms on
        xd, nd = x.to(dev), None if noise is None else noise.to(dev)
        step = make_vae_train_step(v, lm, oa, od, device=dev)
        with torch.no_grad():
            saved = {k: p.clone() for k, p in {**state.ae_params, **state.loss_params}.items()}
        _, m = step(state, {"image": xd}, None, nd)
        out[dev] = ({k: float(t) for k, t in m.items()},
                    {k: t.float().cpu() for k, t in {**state.opt_ae_state.mu,
                                                     **state.opt_disc_state.mu}.items()})
        log(f"[{label}] (a) {dev}: aeloss {out[dev][0]['aeloss']:.8f}, d_weight "
            f"{out[dev][0]['train/d_weight']:.8f} ({time.perf_counter() - t0:.1f} s)")
        with torch.no_grad():  # the modules as they were (the card's go on to (b)-(e))
            for k, p in {**state.ae_params, **state.loss_params}.items():
                p.copy_(saved[k])
        with torch.set_grad_enabled(dev == "cpu"):  # the step's reconstruction; the
            recs[dev] = ae_forward(v, xd, nd)       # CPU's graph serves the vjp
        params = dict(v.named_parameters())
        del state, step, saved
    flips, corr = l1_flip_correction(lm, x, recs["cpu"], recs["cuda"].cpu(), params)
    g64 = {dev: disc_grads_f64(cfg, sds[1], x, recs[dev].detach().cpu(), cfg_step)
           for dev in ("cuda", "cpu")}
    del recs, v, lm, params
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    if flips > AE_MAX_SIGN_FLIPS * b:
        raise RuntimeError(f"{label}: the card's reconstruction and the CPU's lie on "
                           f"opposite sides of x at {flips} elements (at most "
                           f"{AE_MAX_SIGN_FLIPS * b})")
    if m_cpu["train/disc_factor"] != 1.0 or not any(
            t.abs().max() > 0 for k, t in g_cpu.items() if k.startswith("discriminator.")):
        raise RuntimeError(f"{label}: the checked step ran with the GAN terms off")
    for k, c in corr.items():
        g_cpu[k] = g_cpu[k] + (1 - oa.b1) * c
    loss_rel = abs(m_gpu["aeloss"] - m_cpu["aeloss"]) / abs(m_cpu["aeloss"])
    bad_metrics = {k: (m_gpu[k], v) for k, v in m_cpu.items()
                   if not abs(m_gpu[k] - v) <= 1e-4 * abs(v) + 1e-6}
    floor = {part: 1e-6 * max(t.abs().max().item() for k, t in g_cpu.items()
                              if k.startswith("discriminator.") == (part == "disc"))
             for part in ("ae", "disc")}
    grad_rel, bad_grads, disc_rel = {}, [], {}
    for k, want in g_cpu.items():
        disc = k.startswith("discriminator.")
        if disc:  # against float64; the CPU's float32 beside it
            want64 = ((1 - od.b1) * g64["cuda"][k]).float()
            cpu64 = ((1 - od.b1) * g64["cpu"][k]).float()
            scale = want64.abs().max().item()
            disc_rel[k] = tuple((a - c).abs().max().item() / scale for a, c in (
                (g_gpu[k], want64), (want, cpu64), (g_gpu[k], want)))
            want = want64
        err = (g_gpu[k] - want).abs().max().item()
        scale = want.abs().max().item()
        grad_rel[k] = err / scale if scale else err
        limit = max(1e-3, 2 * disc_rel[k][1]) if disc else 1e-3
        if not err <= limit * scale + floor["disc" if disc else "ae"]:
            bad_grads.append((k, err, scale))
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"[{label}] (a) discriminator gradients, of their largest: card vs float64, CPU "
        f"float32 vs float64, card vs CPU float32: "
        f"{[(k.removeprefix('discriminator.'), [f'{e:.3g}' for e in v])
           for k, v in disc_rel.items()]}")
    log(f"[{label}] (a) float32 card vs CPU, batch {b}: aeloss {loss_rel:.3g} relative "
        f"(1e-4) at global step {cfg_step}; metrics outside 1e-4 {bad_metrics}; L1 signs that "
        f"differ {flips} (at most {AE_MAX_SIGN_FLIPS * b}; their vjp added to the CPU's "
        f"gradients); {len(g_cpu)} trained gradients, outside their limits (1e-3 of their "
        f"largest + 1e-6 of the optimizer's; the discriminator's against float64): "
        f"{bad_grads[:4]}; largest relative {[(k, f'{v:.3g}') for k, v in worst]}")
    if not (loss_rel <= 1e-4 and not bad_metrics and not bad_grads):
        raise RuntimeError(f"{label}: the card's float32 train step disagrees with the CPU")
    return dict(aeloss_rel=loss_rel, global_step=cfg_step, d_weight=m_gpu["train/d_weight"],
                d_weight_cpu=m_cpu["train/d_weight"], l1_sign_flips=flips,
                l1_sign_flips_max=AE_MAX_SIGN_FLIPS * b,
                metrics_rel_max=max(abs(m_gpu[k] - v) / max(abs(v), 1e-30)
                                    for k, v in m_cpu.items()),
                grad_rel_max=max(grad_rel.values()), gradients=len(g_cpu),
                disc_rel_max={what: max(v[i] for v in disc_rel.values()) for i, what in enumerate(
                    ("card_vs_f64", "cpu_f32_vs_f64", "card_vs_cpu_f32"))})


def ae_loop(label, cfg, vae, loss, state, step, eval_step, seed):
    """(e) main.py's `train_autoencoder` sequence on the card at batch
    AE_LOOP_BATCH: SetupCallback's YAML, three steps logged through
    MetricLogger (JSONL and TensorBoard events), DeviceStatsCallback around
    them, one eval step logged, a CheckpointManager save, a step that moves
    the state, a restore that must give back the saved parameters and Adam
    moments bit for bit, and the reconstruction grid through the zlib PNG
    writer (read back here by inflating it). PyYAML and PIL must not have
    been imported."""
    import shutil
    import struct
    import zlib

    import numpy as np
    import torch

    from ealdm_torch.models.vae import AutoencoderKL
    from ealdm_torch.training import (CheckpointManager, DeviceStatsCallback, MetricLogger,
                                      SetupCallback, save_png, to_uint8_grid)

    logdir = os.path.join(OUT_DIR, f"ae_train_{label}")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    cfg_path = SetupCallback(logdir, {"model": cfg["model"]}).on_start("now")
    with open(cfg_path) as f:
        text = f.read()
    lossp = cfg["model"]["params"]["lossconfig"]["params"]
    if "kl_weight" in lossp and '"kl_weight": 1.0e-06' not in text:
        raise RuntimeError(f"{label}: the YAML does not spell kl_weight as a float")
    logger, stats = MetricLogger(logdir), DeviceStatsCallback("cuda")
    ckpt = CheckpointManager(os.path.join(logdir, "checkpoints"), monitor="val/rec_loss")
    x = ae_images(AE_LOOP_BATCH, cfg["res"], seed).cuda()
    stats.on_epoch_start()
    for i in range(3):
        _, m = step(state, {"image": x}, torch.Generator().manual_seed(seed + i))
        logger.log(state.step, m)
    sys_stats = stats.on_epoch_end()
    logger.log(state.step, sys_stats, prefix="sys/")
    val = eval_step(state, {"image": x}, torch.Generator().manual_seed(seed + 9))
    logger.log(state.step, val)
    ckpt.save(state.step, state, val)
    saved = {k: v.clone() for k, v in {**state.ae_params, **state.loss_params,
                                       **{f"mu/{k}": t for k, t in state.opt_ae_state.mu.items()},
                                       **{f"nu/{k}": t for k, t in state.opt_ae_state.nu.items()},
                                       **{f"dmu/{k}": t for k, t in state.opt_disc_state.mu.items()}
                                       }.items()}
    saved_step = state.step
    step(state, {"image": x}, torch.Generator().manual_seed(seed + 20))  # moves the state
    ckpt.restore(state)
    now = {**state.ae_params, **state.loss_params,
           **{f"mu/{k}": t for k, t in state.opt_ae_state.mu.items()},
           **{f"nu/{k}": t for k, t in state.opt_ae_state.nu.items()},
           **{f"dmu/{k}": t for k, t in state.opt_disc_state.mu.items()}}
    differ = [k for k, v in saved.items() if not torch.equal(now[k], v)]
    if differ or state.step != saved_step or ckpt.best_step() != saved_step:
        raise RuntimeError(f"{label}: the checkpoint restore differs at {differ[:4]} "
                           f"(step {state.step}, saved {saved_step})")
    with torch.no_grad():  # the reference's log_images reconstruction
        rec = (vae(x, torch.Generator(device="cuda").manual_seed(seed))[0]
               if isinstance(vae, AutoencoderKL) else vae(x)[0])
    grid = to_uint8_grid(rec)
    png = os.path.join(logdir, "images", "val", f"recon_gs-{state.step:06d}.png")
    save_png(png, grid)
    with open(png, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if (w, h) != grid.shape[1::-1] or not np.array_equal(rows[:, 1:].reshape(grid.shape), grid):
        raise RuntimeError(f"{label}: the PNG does not read back to its grid")
    with open(logger.path) as f:
        lines = [json.loads(line) for line in f]
    tb = [p for p in os.listdir(os.path.join(logdir, "tb")) if p.startswith("events.out")]
    if len(lines) != 5 or "val/rec_loss" not in lines[-1] or len(tb) != 1:
        raise RuntimeError(f"{label}: {len(lines)} JSONL rows, TB files {tb}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "PIL"))
    if loaded:
        raise RuntimeError(f"{label}: the loop imported {loaded}")
    out = dict(jsonl_rows=len(lines), tb_bytes=os.path.getsize(os.path.join(logdir, "tb", tb[0])),
               png_bytes=len(data), checkpoint_step=saved_step, restored_tensors=len(saved),
               val_rec_loss=float(val["val/rec_loss"]), epoch_peak_gib=sys_stats.get(
                   "peak_bytes_in_use", 0) / 2**30, seconds=time.perf_counter() - t0)
    log(f"[{label}] (e) loop: {out}")
    shutil.rmtree(logdir, ignore_errors=True)
    return out


def ae_disc_snapshot(loss):
    return {k: p.detach().clone() for k, p in loss.discriminator.named_parameters()}


def ae_moved(a, b):
    """Whether any tensor of snapshot a differs from b's, bit for bit."""
    import torch

    return any(not torch.equal(a[k], b[k]) for k in a)


def phase_ae_train(cfg_module, name):
    """Phase 17 on one trainable first stage (AE_TRAIN[name]) at full width
    in float32: (a) `ae_checked_step`; (b) the discriminator's warm-up: its
    parameters bit-equal after each step before disc_start and moved after
    the first one from it, disc_factor 0 before it, LPIPS and logvar never
    moving; (c) a warm-up and five timed steps at the config's batch (step
    ms, training img/s, peak GiB), launches per step against
    `ae_train_census`, one profiled step (device busy, idle share, groups,
    the plain backwards among them); (d) one step with every kernel launch
    held against its plain version (float32 limits); (e) `ae_loop`.
    Returns (one step's launch details, numbers)."""
    import torch

    import ealdm_torch
    from ealdm_torch import kernels
    from ealdm_torch.ops.attention import flash_counter
    from ealdm_torch.training import init_vae_train_state, make_vae_eval_step, make_vae_train_step

    cfg_key, seed = AE_TRAIN[name]
    cfg = getattr(cfg_module, cfg_key)
    label, n, res = f"ae_train_{name}", cfg["batch_size"], cfg["res"]
    ealdm_torch.enable_inference_optimizations()  # flash at the eligible VAE attention sites
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    vae, loss = ae_modules(cfg, seed, "cuda")
    n_ae = sum(p.numel() for p in vae.parameters())
    n_disc = sum(p.numel() for p in loss.discriminator.parameters())
    n_lpips = sum(p.numel() for p in loss.perceptual.parameters())
    log(f"[{label}] {cfg_key}: autoencoder {n_ae / 1e6:.2f} M, discriminator "
        f"{n_disc / 1e6:.2f} M, LPIPS {n_lpips / 1e6:.2f} M (frozen); batch {n}, {res}^2, "
        f"float32, lr {cfg['learning_rate']:.3g}, disc_start {loss.disc_start}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"reference": ae_checked_step(label, cfg, vae, loss, seed + 3)}
    state, opt_ae, opt_disc = init_vae_train_state(vae, loss, cfg["learning_rate"],
                                                   cfg["lr_g_factor"])
    step = make_vae_train_step(vae, loss, opt_ae, opt_disc)
    x = ae_images(n, res, seed + 4).cuda()
    want, want_totals = ae_train_census(vae, loss, n, res)
    frozen = {k: p.detach().clone() for k, p in state.loss_params.items()
              if not k.startswith("discriminator.")}

    def run_step(i):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, m = step(state, {"image": x}, torch.Generator().manual_seed(seed + 10 + i))
        ae = m["aeloss"].item()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, ae, dict(kernels.launch_details),
                {k: float(v) for k, v in m.items()})

    discs = [ae_disc_snapshot(loss)]
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(6):  # the warm-up, then five timed steps
        runs.append(run_step(i))
        if i < 2:
            discs.append(ae_disc_snapshot(loss))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # (b) the warm-up: step i runs at global step i
    start = loss.disc_start
    moved = [ae_moved(discs[i], discs[i + 1]) for i in range(2)]
    factors = [r[3]["train/disc_factor"] for r in runs]
    lpips_moved = [k for k, p in frozen.items() if not torch.equal(state.loss_params[k], p)]
    warm_ok = (moved == [i >= start for i in range(2)]
               and factors == [float(i >= start) for i in range(6)]
               and ae_moved(discs[0], ae_disc_snapshot(loss)) == (5 >= start)
               and not lpips_moved)
    log(f"[{label}] (b) disc_start {start}: discriminator moved in steps 0, 1: {moved}; "
        f"after six steps: {ae_moved(discs[0], ae_disc_snapshot(loss))}; disc_factor {factors}; "
        f"LPIPS / logvar tensors moved {lpips_moved[:4]} of {len(frozen)}")
    if not warm_ok:
        raise RuntimeError(f"{label}: the discriminator's warm-up does not hold")
    del discs
    # (c) time, memory, launches
    walls = [r[0] for r in runs[1:]]
    dt = sorted(walls)[2]
    totals = {}
    for (counter, _), c in runs[1][2].items():
        totals[counter] = totals.get(counter, 0) + c
    log(f"[{label}] warm-up step {runs[0][0]:.2f} s; timed steps {[round(w, 4) for w in walls]} "
        f"s: median {dt * 1e3:.1f} ms = {n / dt:.3f} img/s; peak {peak:.2f} GiB; aeloss "
        f"{[round(r[1], 5) for r in runs]}")
    log(f"[{label}] launches per step {totals} (module tree: {want_totals})")
    for i, r in enumerate(runs):
        if r[2] != want:
            check_launches(f"{label} step {i}", want, r[2])
        if not all(math.isfinite(v) for v in r[3].values()):
            raise RuntimeError(f"{label} step {i}: a non-finite metric {r[3]}")
    for counter in (flash_counter(512, dtype=torch.float32),):
        if not totals.get(counter):
            raise RuntimeError(f"{label}: {counter} was not launched by the step")
    busy, groups, n_kernels, prof_wall = profile_train_step(
        f"{label}-profile", step, state, {"image": x}, seed + 30, dt, top=10)
    # (d) every kernel launch of one step against its plain version
    sites = hold_sites(f"{label}-hold", lambda: step(
        state, {"image": x}, torch.Generator().manual_seed(seed + 40)), grad=True)
    # (e) main.py's loop
    loop = ae_loop(name, cfg, vae, loss, state, step, make_vae_eval_step(vae, loss), seed + 50)
    out.update(
        batch=n, res=res, dtype="float32", step_ms=dt * 1e3, walls_s=walls, img_per_s=n / dt,
        warmup_s=runs[0][0], peak_gib=peak, aeloss=[r[1] for r in runs],
        metrics_last=runs[-1][3], launches_per_step=totals, disc_moved_steps_0_1=moved,
        disc_factor=factors, device_busy_ms=busy * 1e3, idle_share=1 - busy / prof_wall,
        kernel_launches=n_kernels, profiled_wall_ms=prof_wall * 1e3,
        device_ms_by_group={k: v * 1e3 for k, v in groups.items()},
        held_sites=len(sites), held_worst=max(sites.values()), loop=loop,
        parameters_m={"autoencoder": n_ae / 1e6, "discriminator": n_disc / 1e6})
    details = runs[1][2]
    del state, step, opt_ae, opt_disc, vae, loss, x
    torch.cuda.empty_cache()
    return details, out


def f32_group_norm_rows(timed, gen):
    """float32 channels_last GroupNorm sites (32 groups, eps 1e-6, SiLU or
    not), each held against its plain version (one launch on the path
    `group_norm_path` gives) and timed beside it and F.group_norm (device
    time, inputs rotated past the L2). `timed`: [(row, shape, SiLU)].
    Returns the JSON line's rows."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch import kernels
    from ealdm_torch.ops.norms import group_norm_kernel, group_norm_path, group_norm_plain, silu

    f32 = torch.float32
    errs, res = {}, {}

    def randn(*shape, layout="contiguous"):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x

    single = "ealdm_tpu/ops/group_norm_pallas.py:103"
    chunked = "ealdm_tpu/ops/group_norm_pallas.py:123"
    for row, shape, fuse in timed:
        n_, c = shape[:2]
        scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
        numel = math.prod(shape)
        copies = max(1, math.ceil(2 * L2_BYTES / (4 * numel)))
        inputs = [3 * randn(*shape, layout="channels_last") + 1 for _ in range(copies)]
        path = group_norm_path(shape, f32, 32)
        kernels.reset_launch_counts()
        got = group_norm_kernel(inputs[0], scale, bias, 32, 1e-6, fuse)
        if kernels.launches[path] != 1:
            raise RuntimeError(f"{row}: {dict(kernels.launches)}, not one {path} launch")
        want = group_norm_plain(inputs[0], scale, bias, 32, 1e-6, silu if fuse else None, "NCHW")
        compare(errs, row, f32, got, want, f"{list(shape)} channels_last")
        errs[row] = (got - want).abs().max().item()
        del got, want
        bms, by = bound(10 * numel, 2 * numel * 4 + 2 * c * 4, PEAK_FP32)
        it = itertools.cycle(inputs)
        kernel = lambda: group_norm_kernel(next(it), scale, bias, 32, 1e-6, fuse)  # noqa: E731
        plain = lambda: group_norm_plain(next(it), scale, bias, 32, 1e-6,  # noqa: E731
                                         silu if fuse else None, "NCHW")

        def lib():
            y = F.group_norm(next(it), 32, scale, bias, 1e-6)
            return F.silu(y) if fuse else y

        iters = 20 if numel < 2e8 else 10
        split = device_ms_by_kernel(kernel, iters)
        res[row] = dict(
            name=row, route="cuda", source="ealdm_torch/kernels/csrc/group_norm.cu",
            replaces=single if path == "group_norm" else chunked, launches=None,
            max_abs_err=errs[row], ms=sum(split.values()), kernel_ms=split,
            plain_ms=device_ms(plain, iters), bound_ms=bms, bound_by=by,
            library_ms=device_ms(lib, iters), event_ms=cuda_ms(kernel, iters), shape=list(shape),
            layout="channels_last", dtype="float32", pre_bias=False, silu=fuse,
            rotated_inputs=copies, counter=(path, ("channels_last", shape, "float32")))
        del inputs
    return res


def phase_ae_kernels():
    """The kernels at the first-stage step's float32 shapes, held against
    their plain versions (1e-4) and timed (device time, inputs rotated past
    the L2 for GroupNorm): flash [12,1,1024,512] (every VAE attention site
    at batch 12) and the GroupNorm sites of the autoencoder (with SiLU) and
    the discriminator (without: leaky ReLU follows), the odd sides 63^2 and
    31^2 among them. Returns the JSON line's rows."""
    import torch
    import torch.nn.functional as F

    from ealdm_torch.ops.attention import flash_attention, flash_attention_plain, flash_counter

    gen = torch.Generator(device="cuda").manual_seed(17)
    f32 = torch.float32
    errs, res = {}, {}

    def randn(*shape, layout="contiguous"):
        x = torch.randn(*shape, generator=gen, device="cuda")
        return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x

    b, h, nq, d = shape = (12, 1, 1024, 512)
    qkv = [randn(*shape) for _ in range(3)]
    row = "flash_attention_f32_d512_b12_n1024"
    compare(errs, row, f32, flash_attention(*qkv), flash_attention_plain(*qkv), str(list(shape)))
    errs[row] = (flash_attention(*qkv) - flash_attention_plain(*qkv)).abs().max().item()
    ms, seen = device_ms(lambda: flash_attention(*qkv), names=True)
    bms, by = bound(3 * 4 * b * h * nq * nq * d, 4 * b * h * nq * d * 4, PEAK_TF32,
                    exps=b * h * nq * nq)
    res[row] = dict(
        name=row, route="cuda", source="ealdm_torch/kernels/csrc/flash_attention_sm90_f32.cu",
        replaces="ealdm_tpu/ops/attention.py:77", launches=None, max_abs_err=errs[row], ms=ms,
        plain_ms=device_ms(lambda: flash_attention_plain(*qkv)), bound_ms=bms,
        bound_by="bytes" if by == "bytes" else "operations", bound_kind=by,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(*qkv)),
        event_ms=cuda_ms(lambda: flash_attention(*qkv)), kernel=seen, shape=list(shape),
        layout="split heads of the VAE's [B,1,N,C] tokens", dtype="float32",
        key_splits=f32_flash_splits(b, h, nq, d), counter=(flash_counter(d, dtype=f32), nq))
    del qkv
    res.update(f32_group_norm_rows([  # row, shape, SiLU (the autoencoder's norms) or not
        ("ae_gn_f32_c128_256", (12, 128, 256, 256), True),
        ("ae_gn_f32_c256_256", (12, 256, 256, 256), True),
        ("ae_gn_f32_c512_32", (12, 512, 32, 32), True),
        ("disc_gn_f32_c128_64", (12, 128, 64, 64), False),  # (the discriminator's:
        ("disc_gn_f32_c256_63", (12, 256, 63, 63), False),  # leaky ReLU follows)
        ("disc_gn_f32_c256_32", (12, 256, 32, 32), False),
        ("disc_gn_f32_c512_31", (12, 512, 31, 31), False),
    ], gen))
    torch.cuda.empty_cache()
    log_rows(res)
    return res


def phase_convergence():
    """The port's convergence oracles on the card (on the CPU they take 77 s
    and 42 s), `tests/test_convergence.py`'s two at its micro sizes with the
    port's seeded weights: the LDM step (frozen VQ first stage, trainable
    STDiff tower, the CFG pair) over 300 steps, the last 50 steps' mean
    loss below 0.7 of the first 50's and the EMA's eval loss below the
    start; the float32 VAE-GAN step over 160, the last 20 steps'
    reconstruction loss below 0.7 of the first 20's, the discriminator
    bit-frozen for the 60 steps before disc_start and moving after it."""
    import numpy as np
    import torch

    from ealdm_torch.losses import LPIPSWithDiscriminator
    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.models.vae import AutoencoderKL
    from ealdm_torch.training import (init_train_state, init_vae_train_state, make_eval_step,
                                      make_train_step, make_vae_train_step)

    t0 = time.perf_counter()
    model = LatentDiffusion(
        unet_config=dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
                         attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                         num_head_channels=16, use_spatial_transformer=True,
                         transformer_depth=1, context_dim=64),
        first_stage_config={"target": "ldm.models.autoencoder.VQModelInterface", "params": {
            "embed_dim": 4, "n_embed": 64, "ddconfig": dict(
                double_z=False, z_channels=4, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)}},
        cond_stage_config={"target": "STDiff.models.UnetCond", "params": {
            "mid_dim": 4, "emb_dim": 32, "out_dim": 64, "w_dim": 16, "f_dim": 1,
            "hidden_dim": 32, "cond_args": {
                "type": "fourier", "dims": 6, "lr": 1, "lin_lr": 0.01,
                "f_manual": [1.84, 672], "include_lin": True, "noise": 0, "noise_f": [],
                "noise_f_int": []}}},
        timesteps=20, linear_start=0.0015, linear_end=0.0195, conditioning_key="crossattn",
        cond_stage_key="mixed", cond_stage_trainable=True, unconditional_guidance_scale=2.0,
        device="cuda")
    random_init_(model, seed=0)
    rng = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()

    batch = {"img": randn(4, 32, 32, 3), "mixed": {
        "img": randn(4, 32, 32, 3), "img_random": randn(4, 32, 32, 3),
        "flow": randn(4, 1, 1), "weather": randn(4, 1, 16),
        "time": torch.from_numpy(rng.rand(4, 1).astype(np.float32)).cuda()}}
    state, opt = init_train_state(model, learning_rate=2e-3)
    step = make_train_step(model, opt, remat="none")
    gen = torch.Generator().manual_seed(100)
    losses = [float(step(state, batch, gen)[1]["loss"]) for _ in range(300)]
    first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
    ema = float(make_eval_step(model)(state, batch, torch.Generator().manual_seed(999))[
        "loss_simple_ema"])
    ldm = dict(first50=first, last50=last, ratio=last / first, ema_eval=ema,
               seconds=time.perf_counter() - t0)
    log(f"[convergence] LDM: {ldm}")
    if not (all(map(math.isfinite, losses)) and last < 0.7 * first and ema < first):
        raise RuntimeError("the LDM step did not converge")
    del model, state, opt, step, batch

    t0 = time.perf_counter()
    dd = dict(double_z=True, z_channels=2, resolution=16, in_channels=3, out_ch=3, ch=16,
              ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
    disc_start, n_steps = 60, 160
    vae = AutoencoderKL(dd, embed_dim=2)
    loss = LPIPSWithDiscriminator(disc_start=disc_start, kl_weight=1e-6, disc_weight=0.5,
                                  disc_num_layers=1, perceptual_weight=1.0)
    random_init_(vae, seed=0)
    random_init_(loss.perceptual.vgg, seed=1)
    loss.discriminator.init_weights_(torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 16, 16, 3).astype(np.float32)).cuda()
    x = x * 2 - 1
    state, opt_ae, opt_disc = init_vae_train_state(vae, loss, learning_rate=2e-3)
    step = make_vae_train_step(vae, loss, opt_ae, opt_disc)
    disc0 = ae_disc_snapshot(loss)
    gen = torch.Generator().manual_seed(100)
    rec, discs, frozen_ok = [], [], None
    for i in range(n_steps):
        if i == disc_start:
            frozen_ok = not ae_moved(disc0, ae_disc_snapshot(loss))
        m = step(state, {"image": x}, gen)[1]
        rec.append(float(m["train/rec_loss"]))
        discs.append(float(m["train/disc_loss"]))
    first, last = float(np.mean(rec[:20])), float(np.mean(rec[-20:]))
    vgan = dict(first20=first, last20=last, ratio=last / first, disc_frozen_before_start=frozen_ok,
                disc_moved_after=ae_moved(disc0, ae_disc_snapshot(loss)),
                disc_loss_start=discs[disc_start], disc_loss_end=discs[-1],
                seconds=time.perf_counter() - t0)
    log(f"[convergence] VAE-GAN: {vgan}")
    if not (all(map(math.isfinite, rec + discs)) and last < 0.7 * first and frozen_ok
            and vgan["disc_moved_after"]
            and (abs(discs[-1] - discs[disc_start]) > 1e-5
                 or np.mean(discs[-20:]) != np.mean(discs[disc_start:disc_start + 20]))):
        raise RuntimeError("the VAE-GAN step did not converge or trained the discriminator "
                           "before disc_start")
    return dict(ldm=ldm, vae_gan=vgan)


def phases_ae_train(cfg_module):
    """Phase 17, first-stage training: the kernels at the step's float32
    shapes, `phase_ae_train` on vq-f8 and kl-f8, the convergence oracles.
    Returns ({path: launches of one step}, {path: numbers}, the rows)."""
    t0 = time.perf_counter()
    rows = phase_ae_kernels()
    details, out, seconds = {}, {}, {"kernels": time.perf_counter() - t0}
    for name in AE_TRAIN:
        t0 = time.perf_counter()
        details[f"ae_train_{name}"], out[f"ae_train_{name}"] = phase_ae_train(cfg_module, name)
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["convergence"] = phase_convergence()
    seconds["convergence"] = time.perf_counter() - t0
    out["ae_train_seconds"] = seconds
    return details, out, rows


# ------------------------------------------------------------------ phase 18
MAIN_YAML = "configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml"
MAIN_RESUME_YAML = "configs/smoke/stdiff_micro.yaml"  # (c)'s resume
MAIN_AE_YAML = "configs/autoencoder/autoencoder_kl_32x32x4.yaml"
# four sites, the default test site among them, 120 days each: with l_seq 1
# a site gives 119 windows; phase "trainval" keeps round(0.375 * 119) = 45
# and 119 - round(0.675 * 119) = 39 of them, phase "test" (the default test
# site only) 80 - 45 = 35
MAIN_SITES = ("Avery Brook_Bridge_01171000", "Site_A_01", "Site_B_02", "Site_C_03")
MAIN_DAYS = 120
MAIN_WINDOWS = {"train": 4 * (45 + 39), "validation": 35}
MAIN_STEPS, MAIN_RESUME_STEPS, MAIN_AE_STEPS = 4, 6, 2
MAIN_AE_IMAGES = {"train": 24, "validation": 12}


def timed_checkpoint_writes(records):
    """CheckpointManager._write wrapped to log each checkpoint's bytes and
    write seconds into `records`; returns the original to restore."""
    from ealdm_torch.training import checkpoint

    original = checkpoint.CheckpointManager._write

    def write(self, path, state, meta):
        t0 = time.perf_counter()
        original(self, path, state, meta)
        records.append(dict(checkpoint=os.path.relpath(path, os.path.dirname(self.directory)),
                            bytes=os.path.getsize(os.path.join(path, "state.pt")),
                            seconds=time.perf_counter() - t0))

    checkpoint.CheckpointManager._write = write
    return original


def logdir_files(logdir):
    out = []
    for root, _, files in os.walk(logdir):
        for f in sorted(files):
            p = os.path.join(root, f)
            out.append((os.path.relpath(p, logdir), os.path.getsize(p)))
    return sorted(out)


def tensors_on(batch, device_type):
    """Whether every tensor leaf of a batch lies on `device_type`, and that
    its numeric leaves are tensors."""
    import numpy as np
    import torch

    if isinstance(batch, dict):
        return all(tensors_on(v, device_type) for v in batch.values())
    if isinstance(batch, torch.Tensor):
        return batch.device.type == device_type
    return isinstance(batch, np.ndarray) and batch.dtype.kind in "USO"


class LoopProbe:
    """`ealdm_torch.main.main`'s on_batch and on_step hooks: each step's
    kernel launches (counted on the host between the two hooks) and
    metrics (device tensors, read after the run), whether each batch
    reached the step on the card, the first batch with the generator's
    state before its step, and the wall of steps `window` (first, last): a
    synchronize at the first one's batch and after the last one, none
    between, so the loop runs there as it does unprobed."""

    def __init__(self, window):
        self.window = window
        self.launches, self.metrics, self.on_card = [], [], []
        self.first = None
        self.walls = []

    def on_batch(self, step, batch, generator):
        import torch

        from ealdm_torch import kernels

        if step == self.window[0]:
            torch.cuda.synchronize()
            self.walls.append(time.perf_counter())
        kernels.reset_launch_counts()
        self.on_card.append(tensors_on(batch, "cuda"))
        if self.first is None:
            clone = lambda b: ({k: clone(v) for k, v in b.items()} if isinstance(b, dict)  # noqa
                               else b.clone() if isinstance(b, torch.Tensor) else b)
            self.first = (clone(batch), generator.get_state())

    def on_step(self, step, metrics):
        import torch

        from ealdm_torch import kernels

        self.launches.append(dict(kernels.launch_details))
        self.metrics.append(metrics)
        if step == self.window[1]:
            torch.cuda.synchronize()
            self.walls.append(time.perf_counter())

    @property
    def hooks(self):
        return dict(on_batch=self.on_batch, on_step=self.on_step)

    @property
    def window_s(self):
        return self.walls[1] - self.walls[0]


def release():
    """Free what the dropped references held on the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main_corpus(root):
    """(a) the synthetic stream-camera corpus at 256^2 and the dataset
    lengths it gives, held to MAIN_WINDOWS."""
    from ealdm_torch.data.stdiff import StreamCameraDataset
    from ealdm_torch.data.synthetic import generate_synthetic_dataset

    t0 = time.perf_counter()
    generate_synthetic_dataset(root, sites=MAIN_SITES, n_days=MAIN_DAYS, image_size=256, seed=0)
    lengths = {split: len(StreamCameraDataset(root, root, phase=phase,
                                              path_scaler=os.path.join(root, "count")))
               for split, phase in (("train", "trainval"), ("validation", "test"))}
    size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(root) for f in fs)
    log(f"[main] (a) corpus: {len(MAIN_SITES)} sites x {MAIN_DAYS} days at 256^2, {size} bytes, "
        f"written in {time.perf_counter() - t0:.1f} s; windows {lengths} (reckoned "
        f"{MAIN_WINDOWS})")
    if lengths != MAIN_WINDOWS:
        raise RuntimeError("the corpus's windows differ from the reckoning")
    return lengths


def phase_main_ldm(root, corpus):
    """(b) `ealdm_torch.main.main` on the flagship YAML at full width, bf16,
    MAIN_STEPS steps at the default --log_every, one ImageLogger grid after
    the last step, one validation; then the same first step through
    `make_train_step` on the loop's first batch and generator, as many bare
    steps on that resident batch, alone and with the train loader's
    prefetcher fetching a batch before each (img/s: the batch times the
    steps after the first over their wall, one synchronize before and one
    after), and one bare step with every launch held against its plain
    version; (c) the resume to MAIN_RESUME_STEPS on the micro STDiff YAML
    (`MAIN_RESUME_YAML`) over the same corpus."""
    import json as _json

    import torch

    from ealdm_torch import kernels
    from ealdm_torch import main as tmain
    from ealdm_torch.config import load_config
    from ealdm_torch.data.pipeline import DevicePrefetcher
    from ealdm_torch.training import make_optimizer, make_train_step
    from ealdm_torch.utils.profiling import StepTimer

    dots = [f"data.params.{split}.params.{key}={corpus}/" for split in ("train", "validation")
            for key in ("path", "path_weather")]
    dots += [f"lightning.callbacks.image_logger.params.batch_frequency={MAIN_STEPS}",
             "lightning.callbacks.image_logger.params.max_images=4"]
    common = ["-b", os.path.join(HERE, MAIN_YAML), "--dtype", "bfloat16", "--device", "cuda"]
    steady = MAIN_STEPS - 1
    writes, probe, timer = [], LoopProbe((1, MAIN_STEPS - 1)), StepTimer()
    original_write = timed_checkpoint_writes(writes)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the loop, then the third stage as the JAX main.py runs it (phase 20)
        with ThirdStageProbe() as third_probe:
            logdir, model, state = tmain.main(
                common + ["-t", "--max_steps", str(MAIN_STEPS), "-l", os.path.join(root, "logs"),
                          "--third_stage", "true", "--third_stage_max_batches", "1", *dots],
                timer=timer, **probe.hooks)
        loop_s = third_probe.loop_end - t0
        peak_gib = third_probe.loop_peak_gib
        batch_size = probe.first[0]["img"].shape[0]
        losses = [m["loss"].item() for m in probe.metrics]
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            vals = [r for r in map(_json.loads, f) if "val/loss_simple_ema" in r]
        n_params = sum(p.numel() for p in model.parameters())
        want, want_totals = expected_train_launches(model, batch_size, {"res": 256, "zres": 32},
                                                    "dots")
        for i, got in enumerate(probe.launches):
            check_launches(f"main-loop step {i}", want, got)
        if not all(probe.on_card) or len(probe.on_card) != MAIN_STEPS:
            raise RuntimeError(f"a batch did not reach the step on the card: {probe.on_card}")
        if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses) or not vals:
            raise RuntimeError(f"the loop's losses {losses} and validations {vals}")
        files = logdir_files(logdir)
        del state
        third_details, third = phase_third(logdir, model, third_probe, root,
                                           os.path.join(HERE, MAIN_YAML))
        del model
        release()

        # the bare step: the same first step, then the resident batch
        with tmain.kernel_settings():
            _, model, state = tmain.main(common + ["--third_stage", "false", "-l",
                                                   os.path.join(root, "bare"), *dots])
            step = make_train_step(model, make_optimizer(batch_size * 1e-6))
            batch, gen_state = probe.first
            gen = torch.Generator()
            gen.set_state(gen_state)
            bare_metrics, bare_launches = [], []
            for i in range(MAIN_STEPS):
                if i == 1:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                kernels.reset_launch_counts()
                _, m = step(state, batch, gen)
                bare_launches.append(dict(kernels.launch_details))
                bare_metrics.append(m)
            torch.cuda.synchronize()
            bare_s = time.perf_counter() - t1
            bare_losses = [m["loss"].item() for m in bare_metrics]
            # the same bare steps with the loop's ETL beside them: a batch
            # taken from the train loader's prefetcher before each step, unused
            loader = tmain._data(load_config([os.path.join(HERE, MAIN_YAML)], dots),
                                 23)[0].train_dataloader()
            fetched = iter(DevicePrefetcher(loader, "cuda"))
            next(fetched)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(steady):
                next(fetched)
                step(state, batch, gen)
            torch.cuda.synchronize()
            etl_s = time.perf_counter() - t1
            fetched.close()
            sites = hold_sites("main-held", lambda: step(state, batch, gen), grad=True)
        for i, got in enumerate(bare_launches):
            check_launches(f"main-bare step {i}", want, got)
        first_rel = abs(losses[0] - bare_losses[0]) / abs(bare_losses[0])
        del model, state, step, batch, bare_metrics
        release()

        # (c) the resume, on the micro STDiff YAML over the same corpus (the
        # flagship's 7.1 GB checkpoints cost 45 s more; phase 19 reads them):
        # MAIN_STEPS steps, the configs read back, step MAIN_STEPS restored
        # bit for bit, then MAIN_RESUME_STEPS
        t1 = time.perf_counter()
        micro_dots = [f"data.params.train.params.{key}={corpus}/"
                      for key in ("path", "path_weather")]
        micro_logdir, model, state = tmain.main(
            ["-b", os.path.join(HERE, MAIN_RESUME_YAML), "-t", "--max_steps", str(MAIN_STEPS),
             "--third_stage", "false", "--device", "cuda", "-l", os.path.join(root, "micro"),
             *micro_dots])
        saved = {k: p.detach().cpu() for k, p in state.params.items()}
        del model, state
        _, model, state = tmain.main(["-r", micro_logdir, "--device", "cuda"])
        differ = [k for k, p in state.params.items() if not torch.equal(p.detach().cpu(),
                                                                        saved[k])]
        n_tensors = len(saved)
        restored_step = state.step
        del model, state, saved
        _, model, state = tmain.main(["-r", micro_logdir, "-t", "--max_steps",
                                      str(MAIN_RESUME_STEPS), "--third_stage", "false",
                                      "--log_every", "1", "--device", "cuda"])
        resumed_step = state.step
        resume_s = time.perf_counter() - t1
        del model, state
        release()
    finally:
        from ealdm_torch.training import checkpoint

        checkpoint.CheckpointManager._write = original_write
    # the host's share of the loop's steps 1..MAIN_STEPS-1: each step's call
    # (enqueue, and waits on the device where the queue is full) and the
    # prefetcher's waits for batches 2..MAIN_STEPS-1, fetched between them
    waits = timer.buckets.get("data_wait", [])
    calls = timer.buckets.get("train_step", [])
    out = dict(
        parameters_m=n_params / 1e6, batch=batch_size, dtype="bfloat16", steps=MAIN_STEPS,
        log_every="default", loop_s=loop_s, losses=losses, val=vals[-1],
        steady_steps=steady, loop_steady_s=probe.window_s,
        loop_img_per_s=batch_size * steady / probe.window_s,
        bare_steady_s=bare_s, bare_img_per_s=batch_size * steady / bare_s,
        bare_etl_steady_s=etl_s, bare_etl_img_per_s=batch_size * steady / etl_s,
        bare_losses=bare_losses, first_loss_rel=first_rel,
        prefetch_wait_s=waits, prefetch_wait_steady_s=sum(waits[2:MAIN_STEPS]),
        train_step_call_s=calls, train_step_call_steady_s=sum(calls[1:MAIN_STEPS]),
        peak_gib=peak_gib, checkpoints=writes, logdir_files=files,
        launches_per_step=want_totals, held_sites=len(sites), held_worst=max(sites.values()),
        restored_step=restored_step, restored_differ=len(differ), resumed_step=resumed_step,
        resume_s=resume_s)
    log(f"[main] (b) {n_params / 1e6:.1f} M parameters, batch {batch_size}, bf16: loop "
        f"{loop_s:.1f} s for {MAIN_STEPS} steps; steps 1-{steady}: loop {probe.window_s:.4f} s "
        f"= {out['loop_img_per_s']:.3f} img/s (train_step calls "
        f"{out['train_step_call_steady_s']:.4f} s, prefetch waits "
        f"{out['prefetch_wait_steady_s']:.4f} s), bare make_train_step on the resident batch "
        f"{bare_s:.4f} s = {out['bare_img_per_s']:.3f} img/s, with the loop's ETL beside it "
        f"{etl_s:.4f} s = {out['bare_etl_img_per_s']:.3f} img/s; prefetch waits "
        f"{[round(w, 4) for w in waits]} s; peak {peak_gib:.2f} GiB")
    log(f"[main] (b) losses {losses}, bare {bare_losses}: first step {first_rel:.3g} relative "
        f"(limit {2**-8:.3g}); launches per step as the module tree gives: {want_totals}")
    for w in writes:
        log(f"[main] checkpoint {w['checkpoint']}: {w['bytes']} bytes in {w['seconds']:.2f} s")
    log(f"[main] logdir {[f'{p} {n}' for p, n in files]}")
    log(f"[main] (c) resume: step {restored_step} restored, {len(differ)} of {n_tensors} "
        f"parameter tensors differ from the saved ones; then step {resumed_step}, "
        f"{resume_s:.1f} s")
    if first_rel > 2**-8:
        raise RuntimeError("the loop's first loss differs from make_train_step's")
    if differ or restored_step != MAIN_STEPS or resumed_step != MAIN_RESUME_STEPS:
        raise RuntimeError(f"the resume restored step {restored_step} with {differ[:4]} "
                           f"differing, and reached step {resumed_step}")
    return probe.launches[0], out, third_details, third


def phase_main_ae(root):
    """(d) `ealdm_torch.main.main` on autoencoder_kl_32x32x4.yaml at full
    width, float32, batch 12, MAIN_AE_STEPS steps, on folders of 256^2 PNGs
    written by the port's writer; the first step's launches against phase
    17's census, the reconstruction grid read back by the port's reader."""
    import json as _json

    import numpy as np
    import torch

    from ealdm_torch import main as tmain
    from ealdm_torch.config import load_config
    from ealdm_torch.losses import build_loss
    from ealdm_torch.utils.png import encode_png, load_png

    rng = np.random.RandomState(7)
    dots = []
    for split, n in MAIN_AE_IMAGES.items():
        d = os.path.join(root, "pngs", split)
        os.makedirs(d)
        for i in range(n):
            with open(os.path.join(d, f"{i:03d}.png"), "wb") as f:
                f.write(encode_png(rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)))
        dots.append(f"data.params.{split}={{target: ldm.data.lsun.LSUNChurchesTrain, "
                    f"params: {{data_root: '{d}', size: 256}}}}")
    probe = LoopProbe((1, MAIN_AE_STEPS - 1))
    resident_gib = torch.cuda.memory_allocated() / 2**30  # what the runs before left
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logdir, vae, state = tmain.main(
        ["-b", os.path.join(HERE, MAIN_AE_YAML), "-t", "--max_steps", str(MAIN_AE_STEPS),
         "--log_every", "1", "--device", "cuda", "-l", os.path.join(root, "ae_logs"), *dots],
        **probe.hooks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cfg = load_config([os.path.join(HERE, MAIN_AE_YAML)], dots)
    loss = build_loss(cfg["model"]["params"]["lossconfig"], device="cpu")
    want, totals = ae_train_census(vae, loss, 12, 256)
    for i, got in enumerate(probe.launches):
        check_launches(f"main-ae step {i}", want, got)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [_json.loads(line) for line in f]
    train = [r for r in rows if "train/total_loss" in r]
    finite = all(math.isfinite(v) for r in train for v in r.values())
    grid_path = os.path.join(logdir, "images", "val", f"recon_gs-{MAIN_AE_STEPS:06d}.png")
    grid = load_png(grid_path)
    out = dict(steps=MAIN_AE_STEPS, batch=12, dtype="float32", seconds=seconds,
               steady_step_s=probe.window_s, resident_before_gib=resident_gib,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               aeloss=[r.get("aeloss") for r in train], val=[r for r in rows if "val/rec_loss" in r],
               grid_shape=list(grid.shape), launches_per_step=totals,
               on_card=all(probe.on_card), logdir_files=logdir_files(logdir))
    log(f"[main] (d) train_autoencoder: {seconds:.1f} s, step 1 {probe.window_s:.4f} s, aeloss "
        f"{out['aeloss']}, grid {grid.shape}, peak {out['peak_gib']:.2f} GiB ({resident_gib:.2f} "
        f"GiB resident before the run), launches per step as phase 17's census gives: {totals}")
    if (len(train) != MAIN_AE_STEPS or not finite or not out["val"] or not all(probe.on_card)
            or len(probe.launches) != MAIN_AE_STEPS or grid.shape != (768, 1024, 3)
            or grid.dtype != np.uint8 or grid.std() == 0):
        raise RuntimeError(f"train_autoencoder: {out}")
    details = probe.launches[0]
    del vae, state, probe
    release()
    return details, out


def phase_main(cli=False):
    """Phase 18, the training entry point `python -m ealdm_torch.main` from
    the repo's YAMLs at full width: (a) the corpus, (b) the LDM loop beside
    the bare step, (c) the resume, (d) the first-stage loop; phase 20 runs
    on (b)'s run, whose third stage it times; with `cli`, then phase 19 on
    (b)'s flagship run dir. Everything it writes lives in a temporary
    directory it removes. Returns ({path: one step's launch details},
    numbers with phase 20's under "third_stage", phase 19's numbers or
    None)."""
    import glob
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="ealdm_main_")
    cli_out = None
    try:
        t0 = time.perf_counter()
        corpus = os.path.join(root, "corpus")
        windows = main_corpus(corpus)
        ldm_details, ldm, third_details, third = phase_main_ldm(root, corpus)
        ae_details, ae = phase_main_ae(root)
        out = dict(windows=windows, ldm=ldm, ae=ae, seconds=time.perf_counter() - t0,
                   third_stage=third)
        details = {"main_ldm_step": ldm_details, "main_ae_step": ae_details, **third_details}
        if cli:
            flagship, = glob.glob(os.path.join(root, "logs", "*"))
            cli_details, cli_out = phase_cli(flagship, root)
            details.update(cli_details)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return details, out, cli_out


# ------------------------------------------------------------------ phase 20
THIRD_KEYS = ["img", "latent", "w", "wlabel_nxt", "flabel", "flabel_nxt", "t"]
THIRD_HEADS_BATCH = 4   # ThirdStageModel.run's batch, (c)'s decode + heads batch
THIRD_CHECK_BATCH = 2   # (d)'s float32 card-against-CPU batch
THIRD_REFINE_STEPS = 2  # (e)'s refine_decoder steps, at THIRD_HEADS_BATCH
THIRD_DUMP_STEPS = 50   # dump_third_stage_data's DDIM steps, as ealdm_torch.main runs it


class ThirdStageProbe:
    """Wraps `ealdm_torch.third_stage`'s dump, `ThirdStageModel.train` and
    `.test` while `ealdm_torch.main` runs the third stage: the seconds of
    each (a synchronize at each end), each one's kernel launches (the
    counts set to 0 as it starts and read as it ends: `launches`, by part,
    and their sum over the stage, `stage_launches`), the results of `run`,
    and the loop's end (its wall and peak before the third stage's first
    dump)."""

    def __init__(self):
        self.seconds, self.results, self.loop_end, self.loop_peak_gib = {}, None, None, None
        self.launches, self.stage_launches = {}, {}

    def __enter__(self):
        import torch

        from ealdm_torch import kernels, third_stage

        self._saved = (third_stage.dump_third_stage_data, third_stage.ThirdStageModel.train,
                       third_stage.ThirdStageModel.test)
        dump, train, test = self._saved
        probe = self

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                if probe.loop_end is None:
                    probe.loop_end = time.perf_counter()
                    probe.loop_peak_gib = torch.cuda.max_memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                key = name(args, kwargs)
                probe.seconds[key] = probe.seconds.get(key, 0.0) + time.perf_counter() - t0
                probe.launches[key] = dict(kernels.launch_details)
                for site, n in probe.launches[key].items():
                    probe.stage_launches[site] = probe.stage_launches.get(site, 0) + n
                return out
            return wrapper

        third_stage.dump_third_stage_data = timed(
            lambda a, k: f"dump_{k.get('split', 'test')}", dump)
        third_stage.ThirdStageModel.train = timed(lambda a, k: "heads_train", train)

        def test_and_keep(*args, **kwargs):
            probe.results = test(*args, **kwargs)
            return probe.results

        third_stage.ThirdStageModel.test = timed(lambda a, k: "test", test_and_keep)
        return self

    def __exit__(self, *exc):
        from ealdm_torch import third_stage

        (third_stage.dump_third_stage_data, third_stage.ThirdStageModel.train,
         third_stage.ThirdStageModel.test) = self._saved


def resnet50_census(trunk, n, side, dtype="float32"):
    """{(counter, detail): launches} of one pooled forward of a "group"
    ResNet-50 (`models/resnet.py`) on [n, side, side, 3] in `dtype`: its 53
    GroupNorms, each on the path `group_norm_path` gives its channels_last
    shape (the stem's at side / 2, each block's first norm at the block's
    input side, the rest at its output side)."""
    import collections

    import torch

    from ealdm_torch.ops.norms import group_norm_path

    sites = [(trunk.bn1, side // 2)]
    s = side // 4  # the stem's stride-2 convolution and max pool
    for stage, n_blocks in enumerate(trunk.stage_sizes):
        for b in range(n_blocks):
            block = getattr(trunk, f"layer{stage + 1}_{b}")
            out = s // 2 if stage > 0 and b == 0 else s
            sites += [(block.bn1, s), (block.bn2, out), (block.bn3, out)]
            if block.downsample_bn is not None:
                sites.append((block.downsample_bn, out))
            s = out
    census = collections.Counter()
    for norm, s in sites:
        shape = (n, norm.weight.numel(), s, s)
        path = group_norm_path(shape, getattr(torch, dtype), norm.num_groups)
        census[(path, ("channels_last", shape, dtype))] += 1
    return dict(census), len(sites)


def third_dumps(logdir, batch):
    """(a)'s dump files: one batch a split with JAX's seven keys, float32,
    finite, at the flagship's shapes. Returns {split: path}."""
    import numpy as np

    out = {}
    for split in ("train", "test"):
        d = os.path.join(logdir, "third_stage_data", split)
        files = sorted(os.listdir(d))
        if files != ["batch_00000.npz"]:
            raise RuntimeError(f"third stage: {split} dump files {files}")
        with np.load(os.path.join(d, files[0])) as z:
            shapes = {k: tuple(z[k].shape) for k in z.files}
            ok = (z.files == THIRD_KEYS and all(z[k].dtype == np.float32 for k in z.files)
                  and all(np.isfinite(z[k]).all() for k in z.files)
                  and shapes["img"] == (batch, 256, 256, 3)
                  and shapes["latent"] == (batch, 32, 32, 4)
                  and shapes["wlabel_nxt"] == (batch, 10)
                  and all(v[0] == batch for v in shapes.values()))
        log(f"[third_stage] (a) {split} dump {files[0]}: {shapes}")
        if not ok:
            raise RuntimeError(f"third stage: the {split} dump's keys, dtypes or shapes")
        out[split] = d
    return out


def third_weights(wdir, scorer, fid_net, lpips):
    """(f)'s checkpoints, written into `wdir` from seeded values drawn on
    the card: a torchvision-named `inception.npz`, an OpenAI-named
    `clip.pth` and a taming `vgg_lpips.pth`, each the state of one of the
    given modules (an InceptionV3Features, a CLIPZeroShot's towers, an
    LPIPS), whose parameters are set to those values directly."""
    import numpy as np
    import torch

    from ealdm_torch.losses import lpips as lpips_mod

    gen = torch.Generator(device="cuda").manual_seed(200)

    def fill(module, bn_like=()):
        with torch.no_grad():
            for name, p in module.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                v = torch.randn(p.shape, generator=gen, device="cuda")
                if leaf in ("bn_var",):
                    v = 0.5 + v.abs()
                elif leaf == "bn_scale" or (p.dim() == 1 and leaf == "weight"):
                    v = 1 + 0.1 * v
                elif p.dim() >= 2:
                    v = v * math.sqrt(2.0 / p[0].numel())
                else:
                    v = 0.1 * v
                p.copy_(v)
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}

    sd = fill(fid_net)
    tv = {}
    for k, v in sd.items():
        scope, leaf = k.rsplit(".", 1)
        leaf = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
                "bn_var": "bn.running_var"}.get(leaf, leaf)
        tv[f"{scope}.{leaf}"] = v.numpy()
    np.savez(os.path.join(wdir, "inception.npz"), **tv)

    def openai(name):
        name = name.replace("token_embedding.embedding", "token_embedding.weight")
        name = name.replace("attn.out_proj_", "attn.out_proj.").replace("mlp_c_", "mlp.c_")
        return re.sub(r"resblocks_(\d+)", r"resblocks.\1", name)

    clip = {openai(k): v for k, v in fill(scorer.text_model.model).items()}
    clip.update({"visual." + openai(k): v for k, v in fill(scorer.image_model.visual).items()})
    scorer.class_embeddings = scorer._embed_texts(scorer._tokens)
    torch.save(clip, os.path.join(wdir, "clip.pth"))

    lp = fill(lpips)
    names = [f"conv{b}_{i}" for b, ws in enumerate(lpips_mod._VGG16_CFG) for i in range(len(ws))]
    taming = {}
    for idx, name in zip(lpips_mod._CONV_IDX, names):
        for leaf in ("weight", "bias"):
            taming[f"net.slice{lpips_mod._slice_of(idx)}.{idx}.{leaf}"] = lp[f"vgg.{name}.{leaf}"]
    for i in range(len(lpips_mod._VGG16_CFG)):
        taming[f"lin{i}.model.1.weight"] = lp[f"lin{i}.weight"]
    torch.save(taming, os.path.join(wdir, "vgg_lpips.pth"))
    return {n: os.path.getsize(os.path.join(wdir, n))
            for n in ("inception.npz", "clip.pth", "vgg_lpips.pth")}


def phase_third(logdir, model, probe, root, config_path):
    """Phase 20 under `ealdm_torch.main`'s kernel settings (flash attention
    at eligible sites), as the entry point runs the third stage."""
    from ealdm_torch import main as tmain

    with tmain.kernel_settings():
        return _phase_third(logdir, model, probe, root, config_path)


def _phase_third(logdir, model, probe, root, config_path):
    """Phase 20, the third stage at full width, after `ealdm_torch.main`
    ran it on `logdir` (flagship YAML, one dump batch a split, DDIM-50,
    `probe` its seconds and launches): (a) the dumps (each one's launches
    against the module tree, one UNet call at its guided batch held), the
    CSVs and `run`'s results; (b)
    `ThirdStageModel.test` on (a)'s test dump with CLIP at 224^2; (c) one
    decode + heads batch's launches against the module tree, every one held
    against its plain version; (d) float32 card against CPU at batch 2; (e)
    `refine_decoder`; (f) the weights from $EALDM_WEIGHTS_DIR. Returns
    ({"third_stage": the whole stage's launches under ealdm_torch.main},
    numbers)."""
    import numpy as np
    import torch

    from ealdm_torch import kernels, training
    from ealdm_torch.config import load_config, model_from_config
    from ealdm_torch.data.pipeline import DataLoader
    from ealdm_torch.inference import sample_images
    from ealdm_torch.losses import LPIPS
    from ealdm_torch.models.inception import InceptionV3Features
    from ealdm_torch.third_stage import CLIPZeroShot, ThirdStageDataset, ThirdStageModel

    t_phase = time.perf_counter()
    out = {"main_seconds": dict(probe.seconds), "results": probe.results}
    # (a) what ealdm_torch.main wrote
    batch = int(load_config([config_path])["data"]["params"]["batch_size"])
    dirs = third_dumps(logdir, batch)
    with open(os.path.join(logdir, "third_stage_results.csv")) as f:
        header, values = [line.strip().split(",") for line in f]
    with open(os.path.join(logdir, "third_stage_flow.csv")) as f:
        flow_rows = f.read().splitlines()
    log(f"[third_stage] (a) seconds {probe.seconds}; results {probe.results}")
    if (probe.results is None or list(probe.results) != header
            or not all(math.isfinite(float(v)) for v in values)
            or flow_rows[0] != "time,flow_true,flow_pred" or len(flow_rows) != batch + 1
            or set(probe.seconds) != {"dump_train", "dump_test", "heads_train", "test"}):
        raise RuntimeError(f"third stage (a): results {probe.results}, CSV {header} {values}, "
                           f"{len(flow_rows)} flow rows")
    # (a) each dump's launches against the module tree: log_images' encode,
    # reconstruction and 6 diffusion-row decodes (of min(n, 4)), the 2N
    # conditioning encode, DDIM's UNet on the 2N guided batch each step, the
    # samples' and the quantized samples' decodes
    fs, unet = model.first_stage_model, model.model.diffusion_model
    dec_dtype = str(fs.decoder.dtype).removeprefix("torch.")
    dump_want = path_census([(fs.encoder, batch, 256, 1), (fs.encoder, 2 * batch, 256, 1),
                             (unet, 2 * batch, 32, THIRD_DUMP_STEPS),
                             (fs.decoder, batch, 32, 3), (fs.decoder, min(batch, 4), 32, 6)],
                            dtype=dec_dtype)
    for split in ("train", "test"):
        check_launches(f"third-stage dump {split}", dump_want, probe.launches[f"dump_{split}"])
    # one UNet call at the dump's guided batch (and the 2N conditioning
    # encode before it), every launch held
    dump_gen = torch.Generator(device="cuda").manual_seed(21)
    dump_held = hold_sites("third-stage dump held", lambda: sample_images(
        model, batch, (32, 32, 4), steps=1, mixed=mixed_batch(batch, 256, 22, "cuda"),
        decode=False, generator=dump_gen))
    out["dump"] = dict(batch=batch, steps=THIRD_DUMP_STEPS, guided_batch=2 * batch,
                       held_sites=len(dump_held), held_worst=max(dump_held.values()))
    release()

    # (b) test at CLIP's full width (InceptionV3 at 299^2, ResNet-50 at 256^2)
    loader = DataLoader(ThirdStageDataset(dirs["test"]), THIRD_HEADS_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = ThirdStageModel(model, clip_image_size=224, device="cuda")
    res_b = full.test(loader, os.path.join(root, "third_b"))
    torch.cuda.synchronize()
    out["full_width"] = dict(results=res_b, seconds=time.perf_counter() - t0)
    log(f"[third_stage] (b) test at CLIP 224^2: {out['full_width']}")
    if not all(math.isfinite(v) for v in res_b.values()):
        raise RuntimeError(f"third stage (b): {res_b}")

    # (c) one decode + heads batch: launches against the module tree, held
    first = next(iter(loader))
    latent = torch.from_numpy(first["latent"]).cuda()
    want = path_census([(model.first_stage_model.decoder, THIRD_HEADS_BATCH, 32, 1)],
                       dtype=dec_dtype)
    heads_census, n_sites = resnet50_census(full.heads.trunk, THIRD_HEADS_BATCH, 256)
    for key, n in heads_census.items():
        want[key] = want.get(key, 0) + n
    kernels.reset_launch_counts()
    with torch.no_grad():
        full._heads(full.decode(latent))
    torch.cuda.synchronize()
    check_launches("third-stage decode + heads", want)
    held = hold_sites("third-stage held", lambda: full._heads(full.decode(latent)))
    out["launches"] = dict(decoder_dtype=dec_dtype, resnet_group_norm_sites=n_sites,
                           held_sites=len(held),
                           held_worst=max(held.values()))
    del full
    release()
    # ResNet-50's largest GroupNorm site (the stem's, at the heads' batch)
    out["kernel_rows"] = f32_group_norm_rows(
        [("resnet50_gn_f32_c64_128", (THIRD_HEADS_BATCH, 64, 128, 128), False)],
        torch.Generator(device="cuda").manual_seed(20))
    log_rows(out["kernel_rows"])

    # (d) float32, card against CPU, batch 2, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = load_config([config_path])
    sd = {k: v.float() for k, v in model.state_dict().items()}
    lat2 = latent[:THIRD_CHECK_BATCH].cpu()
    got, scorers = {}, {}
    for dev in ("cpu", "cuda"):
        m, _ = model_from_config(cfg["model"], dtype=torch.float32, device=dev)
        m.load_state_dict(sd)
        m.scale_factor = model.scale_factor
        tsm = ThirdStageModel(m.eval(), clip_image_size=224, device=dev)
        images = tsm.decode(lat2.to(dev))
        x = got["images"]["cpu"].to(dev) if dev == "cuda" else images  # the CPU's decode
        with torch.no_grad():
            logits_w, pred_f = tsm._heads(x)
            row = dict(images=images, resnet_pooled=tsm.heads.trunk(x, pool=True),
                       fc_w=logits_w, fc_f=pred_f, inception_pool3=tsm._fid_feats(x),
                       clip_logits=torch.from_numpy(tsm.clip_scorer.logits(x)))
        for k, v in row.items():
            got.setdefault(k, {})[dev] = v.float().cpu()
        scorers[dev] = tsm
    rel = {k: rel_err_to_max(v["cuda"], v["cpu"]) for k, v in got.items()}
    out["float32_card_vs_cpu"] = dict(rel, seconds=time.perf_counter() - t0)
    log(f"[third_stage] (d) float32 card vs CPU, batch {THIRD_CHECK_BATCH}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + " (tolerance 1e-3 of max each)")
    if not all(v <= 1e-3 for v in rel.values()):
        raise RuntimeError("third stage (d): the card's float32 result disagrees with the CPU")
    tsm = scorers.pop("cuda")
    del scorers
    release()

    # (e) refine_decoder on the card's float32 model, batch 4
    loss = tsm.refine_loss(0)
    decoder = tsm.model.first_stage_model.decoder
    dec0 = {k: p.detach().clone() for k, p in decoder.named_parameters()}
    disc0 = {k: p.detach().clone() for k, p in loss.discriminator.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gl, dl = tsm.refine_decoder([first], steps=THIRD_REFINE_STEPS, lr=1e-5, loss_module=loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / THIRD_REFINE_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec_moved = max(float((p - dec0[k]).abs().max()) for k, p in decoder.named_parameters())
    disc_moved = max(float((p - disc0[k]).abs().max())
                     for k, p in loss.discriminator.named_parameters())
    refine_held = hold_sites("third-stage refine held", lambda: tsm.refine_decoder(
        [first], steps=1, lr=1e-5, loss_module=loss), grad=True)
    out["refine"] = dict(steps=THIRD_REFINE_STEPS, batch=THIRD_HEADS_BATCH, gl=gl, dl=dl,
                         step_s=step_s, peak_gib=peak, decoder_moved=dec_moved,
                         discriminator_moved=disc_moved, held_sites=len(refine_held),
                         held_worst=max(refine_held.values()))
    log(f"[third_stage] (e) refine_decoder: gl {gl:.6g}, dl {dl:.6g}, {step_s:.3f} s a step, "
        f"peak {peak:.2f} GiB, decoder moved {dec_moved:.3g}, discriminator {disc_moved:.3g}")
    if not (math.isfinite(gl) and math.isfinite(dl) and dec_moved > 0 and disc_moved > 0):
        raise RuntimeError(f"third stage (e): {out['refine']}")
    del dec0, disc0

    # (f) the trunks' weights from $EALDM_WEIGHTS_DIR against a direct copy
    t0 = time.perf_counter()
    wdir = os.path.join(root, "weights")
    os.makedirs(wdir)
    with torch.device("cuda"):
        fid_direct = InceptionV3Features().eval()
    lpips_direct = LPIPS(device="cuda").eval()
    scorer_direct = CLIPZeroShot(image_size=224, device="cuda")
    sizes = third_weights(wdir, scorer_direct, fid_direct, lpips_direct)
    x = got["images"]["cpu"].cuda()
    y = torch.flip(x, dims=(2,))
    saved_env = os.environ.get("EALDM_WEIGHTS_DIR")
    os.environ["EALDM_WEIGHTS_DIR"] = wdir
    try:
        auto = ThirdStageModel(tsm.model, clip_image_size=224, device="cuda")
        with torch.no_grad():
            same_fid = torch.equal(auto._fid_feats(x), fid_direct((x + 1.0) * 0.5))
        same_clip = np.array_equal(auto.clip_scorer.logits(x), scorer_direct.logits(x))
        training.init_vae_train_state(tsm.model.first_stage_model, loss, 1e-5, device="cuda")
        with torch.no_grad():
            same_lpips = torch.equal(loss.perceptual(x, y), lpips_direct(x, y))
    finally:
        if saved_env is None:
            os.environ.pop("EALDM_WEIGHTS_DIR")
        else:
            os.environ["EALDM_WEIGHTS_DIR"] = saved_env
    out["weights"] = dict(bytes=sizes, inception_equal=same_fid, clip_equal=same_clip,
                          lpips_equal=same_lpips, seconds=time.perf_counter() - t0)
    log(f"[third_stage] (f) weights {sizes}: auto-loaded against directly copied, "
        f"InceptionV3 features equal {same_fid}, CLIP logits {same_clip}, LPIPS {same_lpips}")
    if not (same_fid and same_clip and same_lpips):
        raise RuntimeError("third stage (f): the auto-loaded trunks differ from the direct copy")
    del auto, tsm, loss, fid_direct, lpips_direct, scorer_direct
    release()
    out["seconds"] = sum(probe.seconds.values()) + time.perf_counter() - t_phase
    out["card"] = nvidia_smi()
    # the [kernels] line's third_stage column: the whole stage under
    # ealdm_torch.main (both dumps, the heads' training and test)
    return {"third_stage": dict(probe.stage_launches)}, out


def phase_third_alone():
    """`--third`: the corpus, `ealdm_torch.main` on the flagship YAML for one
    step with the third stage, then phase 20, in a temporary directory it
    removes."""
    import shutil
    import tempfile

    from ealdm_torch import main as tmain

    root = tempfile.mkdtemp(prefix="ealdm_third_")
    try:
        corpus = os.path.join(root, "corpus")
        main_corpus(corpus)
        dots = [f"data.params.{split}.params.{key}={corpus}/"
                for split in ("train", "validation") for key in ("path", "path_weather")]
        with ThirdStageProbe() as probe:
            logdir, model, _ = tmain.main(
                ["-b", os.path.join(HERE, MAIN_YAML), "--dtype", "bfloat16", "--device", "cuda",
                 "-t", "--max_steps", "1", "--third_stage", "true",
                 "--third_stage_max_batches", "1", "-l", os.path.join(root, "logs"), *dots])
        return phase_third(logdir, model, probe, root, os.path.join(HERE, MAIN_YAML))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 19
CLI_TXT2IMG_YAML = "configs/latent-diffusion/txt2img-1p4B-eval.yaml"
CLI_RDM_YAML = "configs/retrieval-augmented-diffusion/768x768.yaml"
CLI_BATCH, CLI_STEPS = 24, 50
CLI_SERVE_BATCH, CLI_REQUESTS = 8, 10
CLI_SERVE_SEED = 11

# the serving process: torch and the port's kernel operator registry only
CLI_SERVE = r"""
import json, os, sys, time
import numpy as np, torch
from torch.autograd import DeviceType
from ealdm_torch import kernels, serving
assert "ealdm_torch.models" not in sys.modules
torch.backends.cuda.matmul.allow_tf32 = False  # as the parent process runs
torch.backends.cudnn.allow_tf32 = False
art, requests, out = sys.argv[1:4]
t0 = time.perf_counter()
fn = serving.load_exported(art)
load_s = time.perf_counter() - t0
req = dict(np.load(requests))
n = len(req["img"])
latents = []


def program(mixed, x_T, noise):  # fn, keeping each batch's last latent
    latents.append(fn.latents(mixed, x_T, noise))
    return fn.modules["decode"](latents[-1])


program.meta = fn.meta
svc = serving.SamplerService(program, batch_size=fn.meta["batch_size"], seed=int(sys.argv[4]))
for i in range(n):
    svc.submit({k: v[i] for k, v in req.items()})
kernels.reset_launch_counts()
t0 = time.perf_counter()
imgs = svc.serve_pending()
torch.cuda.synchronize()
serve_s = time.perf_counter() - t0
for i in range(fn.meta["batch_size"]):
    svc.submit({k: v[i] for k, v in req.items()})
kernels.reset_launch_counts()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    svc.serve_pending()
    torch.cuda.synchronize()
# the profiler's raw events: key_averages() builds an event tree first
names = sorted({e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns()})
batch_launches = {f"{k[0]}|{k[1]}": v for k, v in kernels.launch_details.items()}
latent = latents[0].float().cpu().numpy()  # the first batch's
assert "ealdm_torch.models" not in sys.modules
np.save(out + ".npy", np.stack(imgs))
np.save(out + ".latent.npy", latent)
with open(out, "w") as f:
    json.dump(dict(load_s=load_s, serve_s=serve_s, n=n, kernel_names=names,
                   batch_launches=batch_launches,
                   modules=sorted(m for m in sys.modules if m.startswith("ealdm_torch"))), f)
sys.stdout.flush()
os._exit(0)  # no finalization after a profile (see the end of chip_smoke.py)
"""


class _Capture:
    """stdout copied into a list of lines while it still prints."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.text.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def cli_run(label, fn, argv, n_images):
    """`fn(argv)` (a CLI's main) in-process: (its return, {wall_s, img_per_s
    over the wall, peak_gib, launches}, its launch details, its stdout)."""
    import contextlib

    import torch

    from ealdm_torch import kernels

    release()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    cap = _Capture(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cap):
        out = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nums = dict(wall_s=wall, img_per_s=n_images / wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches={k: v for k, v in kernels.launches.items() if v})
    log(f"[cli] {label}: {wall:.2f} s wall, {nums['img_per_s']:.4f} img/s over it, peak "
        f"{nums['peak_gib']:.2f} GiB, launches {nums['launches']}")
    return out, nums, dict(kernels.launch_details), "".join(cap.text)


def cli_flagship_logdir(root):
    """A run dir as `ealdm_torch.main` leaves one for the flagship YAML:
    configs/ and a `last` checkpoint of a seeded TrainState whose EMA shadow
    differs from its parameters (`--cli` alone; the full script reads phase
    18's)."""
    import torch

    from ealdm_torch.config import load_config, model_from_config
    from ealdm_torch.training import CheckpointManager, init_train_state

    logdir = os.path.join(root, "flagship")
    os.makedirs(os.path.join(logdir, "configs"))
    with open(os.path.join(HERE, MAIN_YAML)) as f, open(
            os.path.join(logdir, "configs", "cli-project.yaml"), "w") as g:
        g.write(f.read())
    model, _ = model_from_config(load_config([os.path.join(HERE, MAIN_YAML)])["model"],
                                 dtype=torch.bfloat16, device="cuda")
    random_init_(model, seed=190)
    state, _ = init_train_state(model, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(191)
    with torch.no_grad():
        for v in state.ema.shadow.values():
            v.add_(0.01 * torch.randn(v.shape, generator=gen, device="cuda"))
    CheckpointManager(os.path.join(logdir, "checkpoints"), monitor=None).save_last(state, 0)
    del model, state
    release()
    return logdir


def cli_images(label, paths, shape):
    """Each PNG read back by the port's reader at `shape`, uint8, not constant."""
    from ealdm_torch.utils.png import load_png

    for p in paths:
        img = load_png(p)
        if img.shape != tuple(shape) or img.std() == 0:
            raise RuntimeError(f"{label}: {p} reads back as {img.shape}, std {img.std()}")


def phase_cli(logdir, root):
    """Phase 19, the command-line tools and serving at full width on the
    card, in-process through each tool's `main(argv)`: (a) sample_diffusion
    on the flagship run dir (batch 24, DDIM-50, eta 1) with launches against
    the module tree and one held pass, (b) txt2img (DDIM), (c)
    inpaint, (d) train_searcher, (e) knn2img (a text query), (f)
    export_sampler and a fresh serving process. Returns ({path: launch
    details}, numbers)."""
    import numpy as np
    import torch

    from ealdm_torch.config import load_config, model_from_config
    from ealdm_torch.scripts import (_common, export_sampler, inpaint, knn2img,
                                     sample_diffusion, train_searcher, txt2img)
    from ealdm_torch.utils.png import save_png

    t_phase = time.perf_counter()
    out, details = {}, {}
    cli_root = os.path.join(root, "cli")
    os.makedirs(cli_root, exist_ok=True)

    # (a) sample_diffusion with the EMA shadow
    used = []
    real_load = _common.load_sampling_weights

    def recording(model, state):
        drift = max(float((state["ema"]["shadow"][k].float() - p.float()).abs().max())
                    for k, p in state["params"].items())
        used.append((real_load(model, state), drift))
        return used[-1][0]

    _common.load_sampling_weights = recording
    try:
        sample_dir = os.path.join(cli_root, "sample")
        _, nums, det, text = cli_run("sample_diffusion", sample_diffusion.main, [
            "-r", logdir, "-n", str(CLI_BATCH), "--batch_size", str(CLI_BATCH), "-c",
            str(CLI_STEPS), "-e", "1", "-l", sample_dir], CLI_BATCH)
    finally:
        _common.load_sampling_weights = real_load
    line = [ln for ln in text.splitlines() if ln.startswith("Throughput for this batch")]
    nums["throughput_line"] = line
    nums["weights"], nums["ema_minus_params_max"] = used[0]
    if used[0][0] != "ema" or not used[0][1] > 0:
        raise RuntimeError(f"sample_diffusion: sampled with {used[0]}, not a distinct EMA")
    pngs = sorted(os.listdir(os.path.join(sample_dir, "img")))
    cli_images("sample_diffusion", [os.path.join(sample_dir, "img", p) for p in pngs],
               (256, 256, 3))
    arr = np.load(os.path.join(sample_dir, f"{CLI_BATCH}_samples.npz"))["arr_0"]
    if len(pngs) != CLI_BATCH or arr.shape != (CLI_BATCH, 256, 256, 3) or len(line) != 1:
        raise RuntimeError(f"sample_diffusion: {len(pngs)} PNGs, npz {arr.shape}, {line}")
    config = load_config(sorted(
        os.path.join(logdir, "configs", f) for f in os.listdir(os.path.join(logdir, "configs"))
        )[-1:])
    meta_model, _ = model_from_config(config["model"], device="meta")
    fs = meta_model.first_stage_model
    want = path_census([(meta_model.model.diffusion_model, CLI_BATCH, 32, CLI_STEPS),
                        (fs.encoder, CLI_BATCH, 256, 1), (fs.decoder, CLI_BATCH, 32, 1)],
                       dtype="float32")  # the tools' models are float32, as JAX's scripts
    check_launches("cli-sample_diffusion", want, det)
    details["cli_sample_diffusion"] = det
    out["sample_diffusion"] = nums
    held = hold_sites("cli-sample_diffusion held", lambda: sample_diffusion.main([
        "-r", logdir, "-n", str(CLI_BATCH), "--batch_size", str(CLI_BATCH), "-c", "1", "-e",
        "1", "-l", os.path.join(cli_root, "held")]))
    out["sample_diffusion"]["held_worst"] = max(held.values())

    # (b) txt2img at 256^2, 2 samples (the card budget's cut from 4: the
    # wall is the 1.5 B-parameter seeded init), 50 steps, scale 5, DDIM (the
    # card budget's cut of the PLMS run, which re-ran that init; the CPU
    # tests hold --plms)
    for name, extra in (("txt2img_ddim", []),):
        d = os.path.join(cli_root, name)
        grid, nums, _, _ = cli_run(name, txt2img.main, [
            "--config", os.path.join(HERE, CLI_TXT2IMG_YAML), "--n_samples", "2",
            "--ddim_steps", str(CLI_STEPS), "--scale", "5", "--outdir", d, *extra], 2)
        cli_images(name, [os.path.join(d, "samples", p)
                          for p in sorted(os.listdir(os.path.join(d, "samples")))],
                   (256, 256, 3))
        cli_images(name, [grid], (256, 512, 3))
        out[name] = nums

    # (c) inpaint, the full model on the committed examples, 50 steps
    d = os.path.join(cli_root, "inpaint")
    paths, nums, _, _ = cli_run("inpaint", inpaint.main, ["--outdir", d, "--steps",
                                                          str(CLI_STEPS)], 2)
    cli_images("inpaint", paths, (256, 256, 3))
    out["inpaint"] = nums

    # (d) train_searcher: 64 seeded 256^2 PNGs through ResNet-50; then the
    # (e) database with --num_leaves 8
    folder = os.path.join(cli_root, "images")
    os.makedirs(folder)
    rng = np.random.RandomState(192)
    for i in range(64):
        save_png(os.path.join(folder, f"{i:03d}.png"),
                 rng.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    s, nums, _, _ = cli_run("train_searcher images", train_searcher.main, [
        "-d", folder, "-t", os.path.join(cli_root, "images_index.npz")], 64)
    if s.num_entries != 64 or s.dim != 2048:
        raise RuntimeError(f"train_searcher: {s.num_entries} x {s.dim}")
    out["train_searcher_images"] = nums
    db_path = os.path.join(cli_root, "database.npz")
    gen = torch.Generator(device="cuda").manual_seed(193)
    np.savez(db_path, embedding=torch.randn(*RDM_DATABASE, generator=gen, device="cuda")
             .cpu().numpy())
    s, nums, _, _ = cli_run("train_searcher npz", train_searcher.main, [
        "-d", db_path, "-t", os.path.join(cli_root, "db_index.npz"), "--num_leaves", "8"], 0)
    if not s.partitioned or s.default_leaves_to_search != 1:
        raise RuntimeError("train_searcher --num_leaves 8: not partitioned, probed 1")
    out["train_searcher_npz"] = nums
    del s

    # (e) knn2img: the 768x768 RDM, 2 samples, the database, 10 neighbours,
    # the text query (the card budget's cut of the image query, which re-ran
    # the RDM's 1.4 B-parameter seeded init; the CPU tests hold
    # --query_image)
    for name, query in (("knn2img_text", []),):
        d = os.path.join(cli_root, name)
        _, nums, _, _ = cli_run(name, knn2img.main, [
            "--config", os.path.join(HERE, CLI_RDM_YAML), "--database", db_path,
            "--use_neighbors", "--knn", "10", "--n_samples", "2", "--outdir", d, *query], 2)
        cli_images(name, [os.path.join(d, "samples", p)
                          for p in sorted(os.listdir(os.path.join(d, "samples")))],
                   (768, 768, 3))
        out[name] = nums

    # (f) export_sampler at batch 8, 50 steps; a fresh process serves 10
    art = os.path.join(cli_root, "sampler.pt2x")
    built, real_model = [], export_sampler.sampling_model

    def keep_model(*args, **kwargs):
        """The model the CLI exports (its EMA weights): the direct program."""
        built.append(real_model(*args, **kwargs))
        return built[-1]

    export_sampler.sampling_model = keep_model
    try:
        (_, export_s), nums, _, _ = cli_run("export_sampler", export_sampler.main, [
            "-r", logdir, "-o", art, "--batch_size", str(CLI_SERVE_BATCH), "--steps",
            str(CLI_STEPS)], 0)
    finally:
        export_sampler.sampling_model = real_model
    nums.update(export_s=export_s, artifact_bytes=os.path.getsize(art))
    requests = os.path.join(cli_root, "requests.npz")
    mixed = mixed_batch(CLI_REQUESTS, 256, seed=194, device="cpu")
    np.savez(requests, **{k: v.numpy() for k, v in mixed.items()})
    served_json = os.path.join(cli_root, "served.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_SERVE, art, requests, served_json,
                           str(CLI_SERVE_SEED)], cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the serving process failed:\n{proc.stderr[-4000:]}")
    with open(served_json) as f:
        served = json.load(f)
    served_imgs = np.load(served_json + ".npy")
    # the direct program on the same requests and draws (seed, batch 8)
    model, = built
    with _common.inference_settings():
        from ealdm_torch import kernels
        from ealdm_torch.inference import sample_images

        kernels.reset_launch_counts()
        g = torch.Generator(device="cuda").manual_seed(CLI_SERVE_SEED)
        first = {k: v[:CLI_SERVE_BATCH].cuda() for k, v in mixed.items()}
        direct, direct_z = sample_images(model, CLI_SERVE_BATCH, (32, 32, 4),
                                         steps=CLI_STEPS, eta=1.0, guidance_scale=2.0,
                                         mixed=first, hoist=False, generator=g)
        torch.cuda.synchronize()
        direct_launches = {f"{k[0]}|{k[1]}": v for k, v in kernels.launch_details.items()}
        details["cli_served"] = dict(kernels.launch_details)
    direct, direct_z = direct.float().cpu().numpy(), direct_z.float().cpu().numpy()
    served_z = np.load(served_json + ".latent.npy")
    # max difference over max |z| (latent) and max |image|, each held to phase
    # 3's bf16 tolerance (the float32 programs should agree exactly)
    rel = float(np.abs(served_z - direct_z).max() / np.abs(direct_z).max())
    img_rel = float(np.abs(served_imgs[:CLI_SERVE_BATCH] - direct).max() / np.abs(direct).max())
    img_mean = float(np.abs(served_imgs[:CLI_SERVE_BATCH] - direct).mean())
    names = served["kernel_names"]
    hand = sorted({kernel_label(k) for k in names
                   if any(n in k for n in (*FLASH_KERNELS, *GN_KERNELS))})
    nums.update(load_s=served["load_s"], serve_s=served["serve_s"],
                served_img_per_s=served["n"] / served["serve_s"], process_s=process_s,
                served_vs_direct_latent_rel=rel, served_vs_direct_image_rel=img_rel,
                served_vs_direct_image_mean_abs=img_mean, profiled_hand_written_kernels=hand,
                launches_equal=served["batch_launches"] == direct_launches,
                served_modules=served["modules"])
    log(f"[cli] served: artifact {nums['artifact_bytes']} bytes, export {export_s:.1f} s, load "
        f"{served['load_s']:.1f} s, {served['n']} requests in {served['serve_s']:.2f} s = "
        f"{nums['served_img_per_s']:.4f} img/s; against the direct program: latent {rel:.3g} of "
        f"max |z|, images {img_rel:.3g} of max (tolerance 5e-2 each), mean abs "
        f"{img_mean:.3g}; "
        f"kernels profiled {hand}; launches a batch "
        f"{sum(served['batch_launches'].values())} (direct "
        f"{sum(direct_launches.values())})")
    if any(m.startswith("ealdm_torch.models") for m in served["modules"]):
        raise RuntimeError("the serving process imported the model code")
    if not (math.isfinite(rel) and rel <= 5e-2) or served_imgs.shape != (CLI_REQUESTS, 256,
                                                                           256, 3):
        raise RuntimeError(f"the served latent differs from the direct program's: {rel}")
    if not (math.isfinite(img_rel) and img_rel <= 5e-2):
        raise RuntimeError(f"the served images differ from the direct program's: {img_rel}")
    if not any(h.startswith("flash_") for h in hand) or not any(h.startswith("gn_")
                                                               for h in hand):
        raise RuntimeError(f"the served profile lacks the hand-written kernels: {names}")
    if not nums["launches_equal"]:
        raise RuntimeError(f"served launches {served['batch_launches']} differ from the "
                           f"direct program's {direct_launches}")
    out["export_sampler"] = nums
    del model
    release()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[cli] {json.dumps(out)}")
    return details, out


def phase_cli_alone():
    """`--cli`: phase 19 on a seeded flagship run dir of its own, in a
    temporary directory it removes."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="ealdm_cli_")
    try:
        return phase_cli(cli_flagship_logdir(root), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv):
    # Finalize CUPTI when each torch.profiler trace ends: left on, its
    # callbacks slow every later launch on the host and so every timed run
    # after the first profile (`ealdm_torch/kernels/probe_host.py`)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ealdm_torch import config as cfg_module  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    seconds = {}  # wall seconds a phase (group), for the [phase-seconds] line

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    timed("1 build", phase_build)
    if "--host" in argv:  # the build and the wrapper's host cost only
        host_cost()
        log(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    train_only = "--train" in argv
    paths_only = "--paths" in argv
    ae_only = "--ae" in argv
    main_only = "--main" in argv
    cli_only = "--cli" in argv
    third_only = "--third" in argv
    rows, head_dim_grads = {}, None
    if "--groupnorm" in argv:
        rows = phase_group_norm()
    elif not (train_only or ae_only or main_only or cli_only or third_only):
        timed("1 sass", phase_sass)
        if not paths_only:
            rows = timed("2 kernels", phase_kernels)
            rows.update(timed("2 group_norm", phase_group_norm))
            rows["bias_act"] = timed("2b ops", phase_ops)
        head_dim_rows, head_dim_grads = timed("2c head dims", phase_head_dims)
        rows.update(head_dim_rows)
    launches_by_path = {}
    if not {"--kernels", "--groupnorm", "--train", "--paths", "--ae", "--main",
            "--cli", "--third"} & set(argv):
        steps, batch = 50, 24
        t_main = time.perf_counter()
        model, mixed, details, e2e = phase_main_path(cfg_module, steps, batch)
        counts = e2e["launches"]
        for row in rows.values():
            # a kernel's row takes its count, a shape's row its count at that
            # shape (left for the paths below where the flagship has none)
            name = row.get("counter", row["name"])
            if isinstance(name, tuple):
                row["launches"] = details.get(name) or None
            elif name in ("flash_attention_d32", "flash_attention_d512", "group_norm",
                          "group_norm_two_pass"):
                row["launches"] = counts[name]
        e2e.update(phase_profile(model, mixed, batch, steps, e2e["seconds"]))
        packed = phase_packed(model, mixed, batch, steps=2)
        rows["flash_attention_packed_d32"]["launches"] = packed["flash_attention_packed_d32"]
        phase_reference(cfg_module, model)
        log(f"[e2e] {json.dumps(e2e)}")
        del model
        torch.cuda.empty_cache()
        launches_by_path["flagship"] = details
        seconds["3-5 flagship"] = time.perf_counter() - t_main
    paths = None
    if not {"--kernels", "--groupnorm", "--train", "--ae", "--main", "--cli",
            "--third"} & set(argv):
        path_details, paths = timed("7-16 paths", phases_paths, cfg_module)
        launches_by_path.update(path_details)
        paths["flash_grad_worst"] = head_dim_grads
    train = None
    if not {"--kernels", "--groupnorm", "--paths", "--ae", "--main", "--cli",
            "--third"} & set(argv):
        train_details, train = timed("6 train", phases_train, cfg_module)
        launches_by_path.update(train_details)
    ae_train = None
    if not {"--kernels", "--groupnorm", "--paths", "--train", "--main", "--cli",
            "--third"} & set(argv):
        ae_details, ae_train, ae_rows = timed("17 first-stage training", phases_ae_train,
                                              cfg_module)
        launches_by_path.update(ae_details)
        rows.update(ae_rows)
    main_run = cli_run_out = third = None
    if not {"--kernels", "--groupnorm", "--paths", "--train", "--ae", "--cli",
            "--third"} & set(argv):
        main_details, main_run, cli_run_out = timed("18-20 main, cli and third stage",
                                                    phase_main, "--main" not in argv)
        launches_by_path.update(main_details)
        third = main_run.pop("third_stage")
        rows.update(third.pop("kernel_rows"))
        seconds["20 third stage"] = third["seconds"]  # within phase 18's run
        seconds["18-20 main, cli and third stage"] -= third["seconds"]
        if cli_run_out is not None:  # phase 19 ran inside phase 18's directory
            seconds["19 cli"] = cli_run_out["seconds"]
            seconds["18-20 main, cli and third stage"] -= cli_run_out["seconds"]
        seconds["18 main"] = seconds.pop("18-20 main, cli and third stage")
    elif "--cli" in argv:
        cli_details, cli_run_out = timed("19 cli", phase_cli_alone)
        launches_by_path.update(cli_details)
    elif third_only:
        third_details, third = timed("20 third stage (with its one-step run)",
                                     phase_third_alone)
        rows.update(third.pop("kernel_rows"))
        launches_by_path.update(third_details)
    for row in rows.values():
        # each path's launches of the row's counter (at its shape, for a
        # shape's row; a train path's: one step); a row the flagship does
        # not reach reads the first path that launches it (phases 7-16,
        # then 6 (f), in order), else 0
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {
            path: (d.get(counter, 0) if isinstance(counter, tuple)
                   else sum(n for (name, _), n in d.items() if name == counter))
            for path, d in launches_by_path.items()}
        if row["launches"] is None and launches_by_path:
            row["launches"] = next((c for c in row["launches_by_path"].values() if c), 0)
    log(f"[phase-seconds] {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if paths is not None:
        log(f"[paths] {json.dumps(paths)}")
    if train is not None:
        log(f"[train] {json.dumps(train)}")
    if ae_train is not None:
        for key, numbers in ae_train.items():
            log(f"[{key}] {json.dumps(numbers)}")
    if main_run is not None:
        log(f"[main] {json.dumps(main_run)}")
    if third is not None:
        log(f"[third_stage] {json.dumps(third)}")
    log(smi)
    if not train_only:
        log(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main(sys.argv[1:])
    # Leave without the interpreter's finalization: after a torch.profiler
    # trace near the end (`--host`), CUPTI's teardown at exit held the
    # process past its last line until it was killed. Everything is printed
    # and flushed, and every process the script started has ended.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
