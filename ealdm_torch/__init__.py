"""ealdm-torch: the PyTorch/CUDA port of the Environment-Aware Latent
Diffusion framework, for one NVIDIA H100.

The JAX package `ealdm_tpu` is the reference; this package keeps its module
layout and names so each counterpart is found under the same path:

  ops/       schedules, embeddings, norms, attention, bias_act, upfirdn2d,
             filtered_lrelu, conv2d_resample, grid_sample (plain torch +
             the wrappers of the hand-written CUDA kernels)
  kernels/   CUDA C++ sources for sm_90a and the nvcc/ctypes loader
  data/      the WordPiece tokenizer and its vocab, the layout tokens
  models/    UNet, VQ and KL autoencoders, STDiff conditioning tower, the
             class, text and spatial cond stages, LatentDiffusion (sampling
             and training surface), distributions, FrozenBatchNorm
  samplers/  DDIM, ancestral, PLMS
  training/  the LDM train step (AdamW, EMA, remat), LR schedules, checkpoints
  utils/     the flax-parameter bridge and the device rule
  zoo.py     the LDM model zoo's architectures (`zoo.build(name)`)

Public tensors are NHWC as in `ealdm_tpu`; convolutional internals are NCHW.
Entry points run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"


def enable_inference_optimizations():
    """Inference fast paths, as `ealdm_tpu.enable_inference_optimizations`:
    the flash attention kernel at eligible self-attention sites and
    compute-dtype LayerNorm statistics. GroupNorm on a CUDA tensor always
    runs its kernel, with fp32 statistics."""
    from .ops.attention import set_attention_impl
    from .ops.norms import set_norm_stats_precision

    set_attention_impl("flash")
    set_norm_stats_precision("native")
