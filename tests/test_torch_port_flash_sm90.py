"""The wgmma/TMA flash-attention kernel (`flash_attention_sm90.cu`) against
its plain PyTorch version, on the card.

Every bfloat16 head dim that routes to it (`WGMMA_HEAD_DIMS`, d = 40 .. 128),
at Nq = Nk = 256 and 1,024 and at a ragged pair (Nq = 1,000, Nk = 77: a
partial query block and a partial key tile), in the contiguous, head-strided
and packed layouts, each held to both limits of `bf16_attention_shares`.
These tests need an NVIDIA GPU (sm_90a) with nvcc; elsewhere they skip. Run
them on the card with
    python -m pytest tests/test_torch_port_flash_sm90.py -m cuda -q
"""
import pytest
import torch

from ealdm_torch import kernels
from ealdm_torch.ops.attention import (
    WGMMA_HEAD_DIMS,
    _split_heads,
    bf16_attention_shares,
    flash_attention,
    flash_attention_packed,
    flash_attention_plain,
    flash_counter,
    sdpa,
)

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(*shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(BF)


def _within_limits(got, q, k, v, want, heads=None):
    elem, rms = bf16_attention_shares(got, q, k, v, want, heads)
    assert elem <= 1 and rms <= 1, (elem, rms)


@pytest.mark.parametrize("nq,nk", [(256, 256), (1024, 1024), (1000, 77)])
@pytest.mark.parametrize("d", list(WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("layout", ["contiguous", "head_strided", "packed"])
def test_wgmma_flash_attention(dev, layout, d, nq, nk):
    b, h = 2, 2
    name = flash_counter(d, packed=layout == "packed")
    before = kernels.launches[name]
    if layout == "packed":
        q = _randn(b, nq, h * d, dev=dev, seed=1)
        k, v = (_randn(b, nk, h * d, dev=dev, seed=s) for s in (2, 3))
        got = flash_attention_packed(q, k, v, h)
        want = flash_attention_plain(*(_split_heads(t, h) for t in (q, k, v)))
        want = want.transpose(1, 2).reshape(got.shape)
        torch.cuda.synchronize()
        _within_limits(got, q, k, v, want, h)
    else:
        if layout == "contiguous":
            q = _randn(b, h, nq, d, dev=dev, seed=1)
            k, v = (_randn(b, h, nk, d, dev=dev, seed=s) for s in (2, 3))
        else:  # the [B, H, N, D] view of [B, N, H*D] projections, as `_attend` passes them
            q = _split_heads(_randn(b, nq, h * d, dev=dev, seed=1), h)
            k, v = (_split_heads(_randn(b, nk, h * d, dev=dev, seed=s), h) for s in (2, 3))
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert got.stride() == q.stride()
        _within_limits(got, q, k, v, flash_attention_plain(q, k, v))
    assert kernels.launches[name] == before + 1


def test_wgmma_kernel_is_the_one_launched(dev):
    """d = 40 runs `flash_wgmma_narrow_kernel` (and d = 32 does not)."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for d in (40, 32):
        q, k, v = (_randn(2, 2, 256, d, dev=dev, seed=s) for s in (1, 2, 3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention(q, k, v)
            torch.cuda.synchronize()
        names[d] = " ".join(e.key for e in prof.key_averages())
    assert "flash_wgmma_narrow_kernel" in names[40]
    assert "flash_wgmma_narrow_kernel" not in names[32]


def test_wgmma_flash_attention_grad_d48(dev):
    """Gradients through FlashAttention at d = 48 (the inpainting UNet's
    head): the kernel forward, the dense sdpa's vjp as the backward."""
    qkv = [_randn(2, 4, 256, 48, dev=dev, seed=s).requires_grad_() for s in (1, 2, 3)]
    g = _randn(2, 4, 256, 48, dev=dev, seed=4)
    y = flash_attention(*qkv)
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(y, qkv, g)
    ref = [t.detach().requires_grad_() for t in qkv]
    want = torch.autograd.grad(sdpa(*ref), ref, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=1e-5 * w.float().abs().max().item())
