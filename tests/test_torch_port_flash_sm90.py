"""The wgmma/TMA flash-attention kernels (`flash_attention_sm90.cu`,
`flash_attention_sm90_wide.cu`) against their plain PyTorch version, on the
card.

Every bfloat16 head dim that routes to the narrow kernel (`WGMMA_HEAD_DIMS`,
d = 40 .. 128), and the wide kernel's (`WIDE_WGMMA_HEAD_DIMS`) at every
padded width it runs (DP = 192 .. 576, d = 320 and 448 padded to 384 and
512) beside d = 640 on the mma.sync kernel, at Nq = Nk = 256 and 1,024 and
at a ragged pair (Nq = 1,000, Nk = 77: a partial query block and a partial
key tile), in the contiguous, head-strided and packed layouts, each held to
both limits of `bf16_attention_shares`; the wide kernel also at the paths'
shapes, where the key split over a cluster of two blocks runs or does not.
These tests need an NVIDIA GPU (sm_90a) with nvcc; elsewhere they skip. Run
them on the card with
    python -m pytest tests/test_torch_port_flash_sm90.py -m cuda -q
"""
import pytest
import torch

from ealdm_torch import kernels
from ealdm_torch.ops.attention import (
    WGMMA_HEAD_DIMS,
    WIDE_WGMMA_HEAD_DIMS,
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


def _check_layout(dev, layout, b, h, d, nq, nk):
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


@pytest.mark.parametrize("nq,nk", [(256, 256), (1024, 1024), (1000, 77)])
@pytest.mark.parametrize("d", list(WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("layout", ["contiguous", "head_strided", "packed"])
def test_wgmma_flash_attention(dev, layout, d, nq, nk):
    _check_layout(dev, layout, 2, 2, d, nq, nk)


@pytest.mark.parametrize("nq,nk", [(256, 256), (1024, 1024), (1000, 77)])
@pytest.mark.parametrize("d", [136, 192, 256, 320, 384, 448, 512, 576, 640])
@pytest.mark.parametrize("layout", ["contiguous", "head_strided", "packed"])
def test_wide_flash_attention(dev, layout, d, nq, nk):
    """d = 136 .. 576 on the wide wgmma kernel (at 2 x 2 heads the key split
    runs where a key half holds 4 tiles), 640 on flash_mma_wide_kernel."""
    _check_layout(dev, layout, 2, 2, d, nq, nk)


@pytest.mark.parametrize("shape", [(12, 1, 1024, 384), (12, 1, 256, 576), (8, 1, 1024, 512),
                                   (24, 1, 1024, 512), (48, 1, 256, 576)])
def test_wide_flash_attention_path_shapes(dev, shape):
    """The paths' wide sites (cin256-v2's CFG batch at ds 4 and 2, the VAEs'
    d=512) and [48,1,256,576], where 192 blocks take no key split."""
    b, h, n, d = shape
    q, k, v = (_randn(*shape, dev=dev, seed=s) for s in (1, 2, 3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    _within_limits(got, q, k, v, flash_attention_plain(q, k, v))


def test_wgmma_kernel_is_the_one_launched(dev):
    """d = 40 runs `flash_wgmma_narrow_kernel` (and d = 32 does not); d =
    136, 384 and 576 run `flash_wgmma_wide_kernel`, 640 does not."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for d in (40, 32, 136, 384, 576, 640):
        q, k, v = (_randn(2, 2, 256, d, dev=dev, seed=s) for s in (1, 2, 3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention(q, k, v)
            torch.cuda.synchronize()
        names[d] = " ".join(e.key for e in prof.key_averages())
    assert "flash_wgmma_narrow_kernel" in names[40]
    assert "flash_wgmma_narrow_kernel" not in names[32]
    for d in (136, 384, 576):
        assert d in WIDE_WGMMA_HEAD_DIMS and "flash_wgmma_wide_kernel" in names[d]
    assert "flash_wgmma_wide_kernel" not in names[640]
    assert "flash_mma_wide_kernel" in names[640]


def test_wgmma_flash_attention_grad_d48(dev):
    """Gradients through FlashAttention at d = 48 (the inpainting UNet's
    head): the kernel forward, the dense sdpa's vjp as the backward."""
    _check_grads(dev, (2, 4, 256, 48))


def test_wide_flash_attention_grad_d384(dev):
    """The same at d = 384 (cin256-v2's head at ds 4), on the wide kernel."""
    _check_grads(dev, (2, 1, 1024, 384))


def _check_grads(dev, shape):
    qkv = [_randn(*shape, dev=dev, seed=s).requires_grad_() for s in (1, 2, 3)]
    g = _randn(*shape, dev=dev, seed=4)
    y = flash_attention(*qkv)
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(y, qkv, g)
    ref = [t.detach().requires_grad_() for t in qkv]
    want = torch.autograd.grad(sdpa(*ref), ref, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=1e-5 * w.float().abs().max().item())
