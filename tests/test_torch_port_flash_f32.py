"""The float32 flash-attention kernel (`flash_attention_sm90_f32.cu`:
`flash_tf32x3_kernel`, both products on the tensor cores in split TF32, and
`flash_tf32x3_combine_kernel`, which adds the parts of a key split) against
the plain PyTorch version, on the card.

Every float32 head dim from 8 to 640 in steps of 8 and 1,928, at a ragged
pair (Nq = 1,000, Nk = 77: a partial query block and a partial key tile),
split and packed, to 1e-4; the key split at 1, 2, 8 and 16 blocks through
the C entry point, each to 1e-4; the kernels each dtype runs and the
combine's launch count; the 16-byte rule for float32 tensors; and the
entry point's refusals. These tests need an NVIDIA GPU (sm_90a) with nvcc;
elsewhere they skip. Run them on the card with
    python -m pytest tests/test_torch_port_flash_f32.py -m cuda -q
"""
import pytest
import torch

from ealdm_torch import kernels
from ealdm_torch.ops.attention import (
    COMBINE_COUNTER,
    flash_attention,
    flash_attention_packed,
    flash_attention_plain,
    flash_counter,
    tf32x3_tiling,
)

pytestmark = pytest.mark.cuda

F32 = torch.float32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(*shape, dev, seed, dtype=F32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _packed(t):  # [B, H, N, D] -> the projection-native [B, N, H*D]
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d).contiguous()


@pytest.mark.parametrize("d", [*range(8, 641, 8), 1928])
def test_f32_flash_attention_every_head_dim(dev, d):
    """d = 8 .. 640 and 1,928 (two strips and two depth passes of 512),
    Nq = 1,000 against Nk = 77, split and packed: 1e-4."""
    q = _randn(1, 2, 1000, d, dev=dev, seed=1)
    k, v = _randn(1, 2, 77, d, dev=dev, seed=2), _randn(1, 2, 77, d, dev=dev, seed=3)
    want = flash_attention_plain(q, k, v)
    before = kernels.launches[flash_counter(d)]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[flash_counter(d)] == before + 1
    assert (got - want).abs().max().item() <= 1e-4
    got = flash_attention_packed(*(_packed(t) for t in (q, k, v)), 2)
    assert (got - _packed(want)).abs().max().item() <= 1e-4


def _entry_call(q, k, v, o, splits, d, dtype=0):
    """The C entry on [B, H, N, d] tensors with `splits` key splits (its
    scratch allocated here); returns the error code."""
    from ealdm_torch.kernels import build

    b, h, nq = q.shape[:3]
    part = ml = None
    if splits > 1:
        part = torch.empty(splits * b * h * nq * d, dtype=F32, device=q.device)
        ml = torch.empty(splits * b * h * nq * 2, dtype=F32, device=q.device)
    strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
    fn = build.library("flash_attention_sm90_f32").ealdm_flash_attention_sm90_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if part is None else part.data_ptr(), None if ml is None else ml.data_ptr(),
             splits, dtype, *tf32x3_tiling(d, q.dtype), b, h, nq, k.shape[2], d, *strides,
             d ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err


@pytest.mark.parametrize("d", [24, 96, 512, 640, 648])
def test_f32_key_splits_agree(dev, d):
    """The key split at 1, 2, 8 and 16 blocks (1,024 keys are 16 tiles of
    64 at d <= 64, 32 or 43 of 32 and 24 above), whatever the entry would
    choose: every split to 1e-4 of the plain version at [2, 2, 200, d]."""
    q = _randn(2, 2, 200, d, dev=dev, seed=4)
    k, v = _randn(2, 2, 1024, d, dev=dev, seed=5), _randn(2, 2, 1024, d, dev=dev, seed=6)
    want = flash_attention_plain(q, k, v)
    for splits in (1, 2, 8, 16):
        o = torch.full_like(q, float("nan"))
        assert _entry_call(q, k, v, o, splits, d) == 0, splits
        assert (o - want).abs().max().item() <= 1e-4, splits


def _kernels_seen(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()  # a first launch loads the kernel outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


def test_f32_kernel_is_the_one_launched(dev):
    """float32 runs `flash_tf32x3_kernel` at every d, with
    `flash_tf32x3_combine_kernel` where the entry splits the keys (one
    [1, 1, 1024, 512] head: 32 row blocks) and counted under
    COMBINE_COUNTER, and without it where the row blocks fill the card
    ([16, 8, 1024, 64])."""
    q, k, v = (_randn(1, 1, 1024, 512, dev=dev, seed=s) for s in (1, 2, 3))
    before = kernels.launches[COMBINE_COUNTER]
    seen = _kernels_seen(lambda: flash_attention(q, k, v))
    assert "flash_tf32x3_kernel" in seen and "flash_tf32x3_combine_kernel" in seen, seen
    assert kernels.launches[COMBINE_COUNTER] == before + 2
    q, k, v = (_randn(16, 8, 1024, 64, dev=dev, seed=s) for s in (1, 2, 3))
    seen = _kernels_seen(lambda: flash_attention(q, k, v))
    assert "flash_tf32x3_kernel" in seen and "flash_tf32x3_combine_kernel" not in seen, seen


def test_f32_flash_attention_rejects_misalignment(dev):
    """The float32 kernel copies 16-byte pieces: a base one element past a
    16-byte boundary, or a row stride that is not a multiple of 4 elements,
    raises instead of launching; a row stride of d + 4 runs."""
    flat = _randn(1 + 2 * 64 * 32, dev=dev, seed=1)
    q = flat[1:].view(1, 2, 64, 32)
    k = _randn(1, 2, 64, 32, dev=dev, seed=2)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, k)
    wide = _randn(1, 2, 64, 34, dev=dev, seed=3)[..., :32]
    with pytest.raises(ValueError, match="multiples of 4"):
        flash_attention(wide, k, k)
    wide = _randn(1, 2, 64, 36, dev=dev, seed=3)[..., :32]
    assert (flash_attention(wide, k, k) - flash_attention_plain(wide, k, k)).abs().max() <= 1e-4


def test_f32_entry_refuses_what_is_not_routed_to_it(dev):
    """The entry takes float32 at any d that is a multiple of 8 and
    bfloat16 above 1,920 only, each on a tiling it has an instance of
    (`tf32x3_tiling`), and a d wider than the one depth pass of the d = 513
    .. 640 instance (Q's tile in shared memory) or of the d = 65 .. 128 one
    (P V on wgmma) is refused; it refuses a key split of 0, one above the
    key tiles or 16, and a split without its scratch, before a launch
    (cudaErrorInvalidValue, 1)."""
    from ealdm_torch.kernels import build

    lib = build.library("flash_attention_sm90_f32")
    splits = lib.ealdm_flash_attention_sm90_f32_splits
    bf = torch.bfloat16
    assert splits(0, *tf32x3_tiling(16), 1, 1, 64, 64, 12) == -1
    assert splits(1, *tf32x3_tiling(1920, bf), 1, 1, 64, 64, 1920) == -1
    assert splits(1, *tf32x3_tiling(1928, bf), 1, 1, 64, 64, 1928) >= 1
    assert splits(1, *tf32x3_tiling(512), 1, 1, 64, 64, 1928) == -1
    for tiling in ((32, 3, 128), (16, 4, 128), (32, 4, 120)):
        assert splits(0, *tiling, 1, 1, 64, 64, 512) == -1, tiling
    q, k, v = (_randn(1, 1, 64, 512, dev=dev, seed=s) for s in (1, 2, 3))
    o = torch.empty_like(q)
    assert _entry_call(q, k, v, o, 0, 512) == 1
    assert _entry_call(q, k, v, o, 3, 512) == 1  # 64 keys: two 32-key tiles
    assert _entry_call(q, k, v, o, 17, 512) == 1
    bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
    assert _entry_call(bq, bk, bv, torch.empty_like(bq), 1, 512, dtype=1) == 1
    strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ealdm_flash_attention_sm90_f32(  # a split of 2 without its scratch
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, None, 2, 0,
        *tf32x3_tiling(512), 1, 1, 64, 64, 512, *strides, 0.1, stream)
    assert err == 1
    for d, wider in ((640, 648), (128, 136)):  # one-pass instances at a wider d
        qw, kw, vw = (_randn(1, 1, 64, wider, dev=dev, seed=s) for s in (1, 2, 3))
        ow = torch.empty_like(qw)
        strides = [x for t in (qw, kw, vw, ow) for x in t.stride()[:3]]
        err = lib.ealdm_flash_attention_sm90_f32(
            qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), ow.data_ptr(), None, None, 1, 0,
            *tf32x3_tiling(d), 1, 1, 64, 64, wider, *strides, 0.1, stream)
        assert err == 1, d
    assert _entry_call(qw, kw, vw, ow, 1, 136) == 0
