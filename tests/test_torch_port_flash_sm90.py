"""The wgmma/TMA flash-attention kernels (`flash_attention_sm90.cu`,
`flash_attention_sm90_wide.cu`, `flash_attention_sm90_deep.cu`) against
their plain PyTorch version, on the card.

Every bfloat16 head dim that routes to the narrow kernel (`WGMMA_HEAD_DIMS`,
d = 40 .. 128), and the wide kernel's (`WIDE_WGMMA_HEAD_DIMS`) at every
padded width it runs (DP = 192 .. 576, d = 320 and 448 padded to 384 and
512) beside d = 640 on the deep kernel, at Nq = Nk = 256 and 1,024 and
at a ragged pair (Nq = 1,000, Nk = 77: a partial query block and a partial
key tile), in the contiguous, head-strided and packed layouts, each held to
both limits of `bf16_attention_shares`; the wide kernel also at the paths'
shapes, where the key split over a cluster of two blocks runs or does not.
The deep kernel (`DEEP_WGMMA_HEAD_DIMS`, d = 584 .. 1,920: a cluster of
blocks that split the head dim) at d = 648, 704, 960 and 1,100 (padded to
1,104), ragged, in the same three layouts, the kernel each dtype runs
above d = 640 (float32 and bfloat16 above 1,920: `flash_tf32x3_kernel`),
and the C entry points' refusal of head dims that `ops.attention` does
not route to them.
These tests need an NVIDIA GPU (sm_90a) with nvcc; elsewhere they skip. Run
them on the card with
    python -m pytest tests/test_torch_port_flash_sm90.py -m cuda -q
"""
import pytest
import torch

from ealdm_torch import kernels
from ealdm_torch.ops.attention import (
    DEEP_WGMMA_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    WIDE_WGMMA_HEAD_DIMS,
    _split_heads,
    bf16_attention_shares,
    deep_slices,
    flash_attention,
    flash_attention_packed,
    flash_attention_plain,
    flash_counter,
    sdpa,
    tf32x3_tiling,
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
        if d % 8 == 0:  # else the kernel wrote a padded copy
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
    runs where a key half holds 4 tiles), 640 on the deep wgmma kernel."""
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
    136, 384 and 576 run `flash_wgmma_wide_kernel`; 640 runs not it but
    `flash_wgmma_deep_kernel`."""
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for d in (40, 32, 136, 384, 576, 640):
        q, k, v = (_randn(2, 2, 256, d, dev=dev, seed=s) for s in (1, 2, 3))
        flash_attention(q, k, v)  # a first launch loads the kernel outside the profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention(q, k, v)
            torch.cuda.synchronize()
        names[d] = " ".join(e.key for e in prof.key_averages())
    assert "flash_wgmma_narrow_kernel" in names[40]
    assert "flash_wgmma_narrow_kernel" not in names[32]
    for d in (136, 384, 576):
        assert d in WIDE_WGMMA_HEAD_DIMS and "flash_wgmma_wide_kernel" in names[d]
    assert "flash_wgmma_wide_kernel" not in names[640]
    assert 640 in DEEP_WGMMA_HEAD_DIMS and "flash_wgmma_deep_kernel" in names[640]


@pytest.mark.parametrize("nq,nk", [(256, 256), (1000, 77), (70, 130)])
@pytest.mark.parametrize("d", [648, 704, 960, 1100])
@pytest.mark.parametrize("layout", ["contiguous", "head_strided", "packed"])
def test_deep_flash_attention(dev, layout, d, nq, nk):
    """d = 648 .. 1,100 on the deep wgmma kernel: clusters of 2 and 3
    blocks, depth strips wholly past d (648, 704), a partial query block
    and a partial key tile."""
    _check_layout(dev, layout, 2, 2, d, nq, nk)


def _kernels_seen(q, k, v):
    from torch.profiler import ProfilerActivity, profile

    flash_attention(q, k, v)  # a first launch loads the kernel outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


def test_deep_wgmma_kernel_is_the_one_launched(dev):
    """bfloat16 d = 648 and 960 run `flash_wgmma_deep_kernel`; float32 at
    those d, and bfloat16 above 1,920, run `flash_tf32x3_kernel`."""
    for d in (648, 960):
        q, k, v = (_randn(2, 2, 256, d, dev=dev, seed=s) for s in (1, 2, 3))
        seen = _kernels_seen(q, k, v)
        assert d in DEEP_WGMMA_HEAD_DIMS and "flash_wgmma_deep_kernel" in seen
        assert "flash_tf32x3_kernel" not in seen
        seen = _kernels_seen(*(t.float() for t in (q, k, v)))
        assert "flash_tf32x3_kernel" in seen and "flash_wgmma_deep_kernel" not in seen
    q, k, v = (_randn(1, 1, 64, 1928, dev=dev, seed=s) for s in (1, 2, 3))
    seen = _kernels_seen(q, k, v)
    assert 1928 not in DEEP_WGMMA_HEAD_DIMS and "flash_tf32x3_kernel" in seen
    assert "flash_wgmma_deep_kernel" not in seen


def test_flash_attention_above_deep_wgmma_head_dims(dev):
    """bfloat16 d = 1,928, past the deep wgmma kernel's 1,920, runs
    `flash_tf32x3_kernel` (split TF32: S in one term, bfloat16 being exact
    in TF32, P V in two), ragged, split and packed; and d = 1,920, the deep
    wgmma kernel's widest (five blocks a cluster)."""
    for d in (1928, 1920):
        for layout in ("contiguous", "packed"):
            _check_layout(dev, layout, 1, 2, d, 70, 45)


def test_flash_entries_refuse_what_is_not_routed_to_them(dev):
    """`ops.attention` owns the routing: the deep wgmma kernel's entry
    takes its slice width from `deep_slices` and refuses a width it has no
    instance for, or one whose cluster would not be 2 .. 5 blocks (2 at 512);
    flash_attention.cu refuses float32 and bfloat16 above 32, which the
    wgmma kernels and flash_attention_sm90_f32.cu run; the latter refuses
    bfloat16 d = 8 .. 1,920. Each refusal is cudaErrorInvalidValue (1),
    before a launch."""
    from ealdm_torch.kernels import build

    q = _randn(1, 1, 64, 1928, dev=dev, seed=1)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call(entry, pre, d):
        strides = [x for _ in range(4) for x in (64 * d, 64 * d, d)]
        return entry(q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), pre,
                     1, 1, 64, 64, d, *strides, 0.1, stream)

    deep = build.library("flash_attention_sm90_deep").ealdm_flash_attention_sm90_deep
    assert [deep_slices(d) for d in (648, 960, 1104)] == [(384, 2), (512, 2), (384, 3)]
    for w, d in ((256, 648), (512, 1104), (384, 1928), (384, 384)):
        assert call(deep, w, d) == 1, (w, d)
    assert call(deep, 384, 648) == 0
    mma = build.library("flash_attention").ealdm_flash_attention
    for d in (40, 136, 640, 1920, 1928):
        assert call(mma, 1, d) == 1, d
    assert call(mma, 0, 32) == 1
    f32 = build.library("flash_attention_sm90_f32")
    tiling = tf32x3_tiling(1928, torch.bfloat16)
    entry = f32.ealdm_flash_attention_sm90_f32
    for d in (32, 648, 1920):
        assert f32.ealdm_flash_attention_sm90_f32_splits(1, *tiling, 1, 1, 64, 64, d) == -1, d
        assert call(lambda *a: entry(*a[:4], None, None, 1, a[4], *tiling, *a[5:]),
                    1, d) == 1, d
    assert call(lambda *a: entry(*a[:4], None, None, 1, a[4], *tiling, *a[5:]), 1, 1928) == 0
    torch.cuda.synchronize()


def test_wgmma_flash_attention_grad_d48(dev):
    """Gradients through FlashAttention at d = 48 (the inpainting UNet's
    head): the kernel forward, the dense sdpa's vjp as the backward."""
    _check_grads(dev, (2, 4, 256, 48))


def test_wide_flash_attention_grad_d384(dev):
    """The same at d = 384 (cin256-v2's head at ds 4), on the wide kernel."""
    _check_grads(dev, (2, 1, 1024, 384))


def test_deep_flash_attention_grad_d648(dev):
    """The same at d = 648, on the deep wgmma kernel."""
    _check_grads(dev, (2, 2, 256, 648))


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
