"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (sm_90a) with nvcc; elsewhere they skip.
Run them on the card with
    python -m pytest tests/test_torch_port_kernels.py -m cuda -q
Small shapes with ragged edges; `chip_smoke.py` checks the main path's
full shapes.
"""
import pytest
import torch

from ealdm_torch import kernels
from ealdm_torch.ops.attention import (
    _split_heads,
    bf16_attention_shares,
    flash_attention,
    flash_counter,
    flash_attention_packed,
    flash_attention_plain,
    sdpa,
)
from ealdm_torch.ops.bias_act import activation_funcs, bias_act, bias_act_plain
from ealdm_torch.ops.norms import (
    group_norm,
    group_norm_kernel,
    group_norm_kernel_layout,
    group_norm_layout,
    group_norm_path,
    group_norm_plain,
    silu,
)

pytestmark = pytest.mark.cuda


def _within_limit(dtype, got, want):
    """Kernel and plain version both compute in float32 and round once:
    float32 to 1e-4; bfloat16 to two ulps of each reference element (an ulp
    is at most 2^-7 of the value) plus the float32 limit."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return diff.max().item() <= 1e-4
    # float16's ulp (2^-10 of the value) is finer than bfloat16's
    return bool((diff <= 2 * 2**-7 * want.float().abs() + 1e-4).all())


def _attention_ok(got, q, k, v, want, heads=None):
    """float32 attention to 1e-4; bfloat16 within both limits of
    `bf16_attention_shares` (the kernel rounds P to bfloat16, the plain
    version does not)."""
    if q.dtype == torch.float32:
        return (got - want).abs().max().item() <= 1e-4
    return max(bf16_attention_shares(got, q, k, v, want, heads)) <= 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(*shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape_q,shape_kv", [((2, 3, 256, 32), (2, 3, 256, 32)),
                                              ((2, 2, 130, 32), (2, 2, 70, 32)),
                                              ((1, 1, 100, 512), (1, 1, 45, 512)),
                                              ((48, 1, 256, 512), (48, 1, 256, 512))])
def test_flash_attention(dev, dtype, shape_q, shape_kv):
    q = _randn(*shape_q, dtype=dtype, dev=dev, seed=1)
    k = _randn(*shape_kv, dtype=dtype, dev=dev, seed=2)
    v = _randn(*shape_kv, dtype=dtype, dev=dev, seed=3)
    name = flash_counter(shape_q[-1], dtype=dtype)
    before = kernels.launches[name]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads", [(192, 4), (256, 16)])
def test_flash_attention_packed(dev, dtype, n, heads):
    b, d = 2, 32
    q, k, v = (_randn(b, n, heads * d, dtype=dtype, dev=dev, seed=s) for s in (1, 2, 3))
    want = flash_attention_plain(*(_split_heads(t, heads) for t in (q, k, v)))
    want = want.transpose(1, 2).reshape(q.shape)
    before = kernels.launches[flash_counter(d, packed=True, dtype=dtype)]
    got = flash_attention_packed(q, k, v, heads)
    assert kernels.launches[flash_counter(d, packed=True, dtype=dtype)] == before + 1
    assert _attention_ok(got, q, k, v, want, heads)


@pytest.mark.parametrize("d", [32, 512])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("nk", [1, 63, 64, 65, 200])
def test_flash_attention_bf16_tile_edges(dev, d, nq, nk):
    """Query and key counts on either side of the bfloat16 kernels' tiles
    (64 query rows; 64 keys at d=32, 32 at d=512)."""
    bf = torch.bfloat16
    q = _randn(2, 2, nq, d, dtype=bf, dev=dev, seed=1)
    k = _randn(2, 2, nk, d, dtype=bf, dev=dev, seed=2)
    v = _randn(2, 2, nk, d, dtype=bf, dev=dev, seed=3)
    name = flash_counter(d)
    before = kernels.launches[name]
    before_rows = kernels.launch_details.get((name, nq), 0)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert kernels.launch_details[(name, nq)] == before_rows + 1
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,heads", [(1024, 8), (256, 16)])
def test_flash_attention_head_strided_view(dev, dtype, n, heads):
    """The layout `_attend` passes: the [B, H, N, D] view of a [B, N, H*D]
    projection (row stride H*D, head stride D); the output keeps it."""
    b, d = 2, 32
    q, k, v = (_randn(b, n, heads * d, dtype=dtype, dev=dev, seed=s)
               .reshape(b, n, heads, d).transpose(1, 2) for s in (1, 2, 3))
    got = flash_attention(q, k, v)
    assert got.stride() == q.stride()
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("d", [32, 512])
def test_flash_attention_bf16_rejects_misalignment(dev, d):
    """The bfloat16 kernels copy 16-byte pieces: a base one element past a
    16-byte boundary, or a row stride that is not a multiple of 8 elements,
    raises instead of launching."""
    bf = torch.bfloat16
    flat = _randn(1 + 2 * 64 * d, dtype=bf, dev=dev)
    q = flat[1:].view(1, 2, 64, d)
    k = _randn(1, 2, 64, d, dtype=bf, dev=dev, seed=2)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, k)
    wide = _randn(1, 2, 64, d + 4, dtype=bf, dev=dev, seed=3)[..., :d]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(wide, k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 40, 48, 80, 128, 136, 384, 576, 640])
def test_flash_attention_head_dims(dev, dtype, d):
    """The head dims the repo's other configurations reach: 24 and 40 are
    not multiples of the mma k-step (zero-padded to 32 and 48), 384 and 576
    take the wide kernel (576 at 32 rows a block); and the ends of each
    kernel's range (8, 128; 136 padded to 192; 640). Ragged query and key
    counts, the split entry point with its per-head-dim counter, and the
    packed one."""
    heads = 2
    q = _randn(2, heads, 130, d, dtype=dtype, dev=dev, seed=1)
    k = _randn(2, heads, 97, d, dtype=dtype, dev=dev, seed=2)
    v = _randn(2, heads, 97, d, dtype=dtype, dev=dev, seed=3)
    before = kernels.launches[flash_counter(d, dtype=dtype)]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches[flash_counter(d, dtype=dtype)] == before + 1
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))
    pq, pk, pv = (t.transpose(1, 2).reshape(2, t.shape[2], heads * d).contiguous()
                  for t in (q, k, v))
    got = flash_attention_packed(pq, pk, pv, heads)
    want = flash_attention_plain(q, k, v).transpose(1, 2).reshape(got.shape)
    assert _attention_ok(got, pq, pk, pv, want, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [648, 960, 1100])
def test_flash_attention_deep_head_dims(dev, dtype, d):
    """A head dim above 640 (1100 is padded to 1104) runs, in bfloat16,
    flash_wgmma_deep_kernel (`flash_attention_sm90_deep.cu`: a cluster of
    blocks that split the head dim) and, in float32, flash_tf32x3_kernel
    (`flash_attention_sm90_f32.cu`: split TF32, strips and depth passes of
    512 columns), counted under its head dim, split and packed, against the
    plain version with ragged query and key counts: bfloat16 within the
    limits of the tensor-core kernels, float32 to 1e-4."""
    heads = 2
    q = _randn(2, heads, 70, d, dtype=dtype, dev=dev, seed=1)
    k = _randn(2, heads, 45, d, dtype=dtype, dev=dev, seed=2)
    v = _randn(2, heads, 45, d, dtype=dtype, dev=dev, seed=3)
    from torch.profiler import ProfilerActivity, profile

    flash_attention(q, k, v)  # a first launch loads the kernel outside the profile
    torch.cuda.synchronize()
    before = kernels.launches[flash_counter(d, dtype=dtype)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
    seen = " ".join(e.key for e in prof.key_averages())
    kernel = "flash_wgmma_deep_kernel" if dtype == torch.bfloat16 else "flash_tf32x3_kernel<"
    assert kernel in seen, seen
    assert got.shape == q.shape
    assert kernels.launches[flash_counter(d, dtype=dtype)] == before + 1
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))
    pq, pk, pv = (t.transpose(1, 2).reshape(2, t.shape[2], heads * d).contiguous()
                  for t in (q, k, v))
    got = flash_attention_packed(pq, pk, pv, heads)
    want = flash_attention_plain(q, k, v).transpose(1, 2).reshape(got.shape)
    assert _attention_ok(got, pq, pk, pv, want, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 20])
def test_flash_attention_pads_head_dims(dev, dtype, d):
    """A head dim that is not a multiple of 8 runs the kernel on q/k/v
    zero-padded to the next one (at the real d's scale), split and packed,
    and keeps the first d columns: it matches the plain version."""
    heads = 2
    q = _randn(2, heads, 130, d, dtype=dtype, dev=dev, seed=1)
    k = _randn(2, heads, 97, d, dtype=dtype, dev=dev, seed=2)
    v = _randn(2, heads, 97, d, dtype=dtype, dev=dev, seed=3)
    before = kernels.launches[flash_counter(d, dtype=dtype)]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == q.shape
    assert kernels.launches[flash_counter(d, dtype=dtype)] == before + 1
    assert _attention_ok(got, q, k, v, flash_attention_plain(q, k, v))
    pq, pk, pv = (t.transpose(1, 2).reshape(2, t.shape[2], heads * d).contiguous()
                  for t in (q, k, v))
    got = flash_attention_packed(pq, pk, pv, heads)
    assert got.shape == pq.shape
    want = flash_attention_plain(q, k, v).transpose(1, 2).reshape(got.shape)
    assert _attention_ok(got, pq, pk, pv, want, heads)


# id: ([N, C, H, W], rows of the pre-bias, offset of x). 32 groups. The
# channels_last cases cover C/G = 4 (a bfloat16 vector spans two groups), 8,
# 48 and 64, the pixel UNet's 7 and 14 (groups that do not align with a
# vector), 21 and 49 (C/V without a multiple of 32 within 512 threads: the
# block has idle threads, one read and two), the largest UNet sample (1.5
# MiB in bfloat16, the one-read limit) and one row past it, a single sample, a broadcast pre-bias, and
# data far from 0 (1000 + N(0, 1): an unshifted E[v^2] - mean^2 loses the
# variance).
_GN_CASES = {
    "one_block": ((3, 64, 9, 7), "n", 0.0),
    "two_pass": ((2, 64, 130, 130), "n", 0.0),
    "cg4": ((2, 128, 12, 20), "n", 0.0),
    "cg8": ((2, 256, 8, 8), "n", 0.0),
    "cg48": ((2, 1536, 8, 8), "n", 0.0),
    "cg64": ((2, 2048, 4, 4), "n", 0.0),
    "cg80_txt2img": ((2, 2560, 4, 4), "n", 0.0),
    "cg7": ((2, 224, 16, 16), "n", 0.0),
    "cg14": ((2, 448, 8, 8), "n", 0.0),
    "cg21_work_threads": ((2, 672, 8, 8), "n", 0.0),
    "cg49_work_threads": ((2, 1568, 4, 4), "n", 0.0),
    "cg21_two_read": ((1, 672, 40, 40), "n", 0.0),
    "unet_largest": ((2, 768, 32, 32), "n", 0.0),
    "past_one_read": ((2, 768, 25, 41), "n", 0.0),
    "n1": ((1, 128, 16, 16), "1", 0.0),
    "pre_row_broadcast": ((3, 96, 10, 10), "1", 0.0),
    "offset": ((2, 64, 32, 32), "n", 1000.0),
    "offset_two_read": ((2, 64, 130, 130), "n", 1000.0),
    # lsun_churches256's two lowest levels: 4 and 16 pixels a sample, so
    # 4 and 6 of the one-read cluster's 8 CTAs hold no row
    "churches_2x2": ((2, 1536, 2, 2), "n", 0.0),
    "churches_4x4": ((2, 768, 4, 4), "n", 0.0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_GN_CASES))
@pytest.mark.parametrize("channels_last", [False, True])
def test_group_norm(dev, dtype, case, channels_last):
    """Against the plain version in float64, rounded once to the dtype; the
    path's launch counter and its (layout, shape, dtype) count move by one."""
    shape, pre_rows, offset = _GN_CASES[case]
    x = _randn(*shape, dtype=torch.float32, dev=dev)
    x = ((x + offset) if offset else (3 * x + 1)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    layout = group_norm_layout(x)
    assert layout == ("channels_last" if channels_last else "nchw")
    n, c = shape[:2]
    scale = 1 + 0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=4)
    bias = 0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=5)
    pre = _randn(n if pre_rows == "n" else 1, c, dtype=dtype, dev=dev, seed=6)
    name = group_norm_path(shape, dtype, 32, layout)
    detail = (name, (group_norm_kernel_layout(shape, dtype, layout), shape,
                     str(dtype).removeprefix("torch.")))
    before, before_detail = dict(kernels.launches), kernels.launch_details.get(detail, 0)
    got = group_norm(x, scale, bias, 32, 1e-6, act=silu, data_format="NCHW", pre_bias=pre)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in kernels.launches.items() if v != before[k]} == {name: 1}
    assert kernels.launch_details[detail] == before_detail + 1
    assert got.dtype == dtype and group_norm_layout(got) == layout
    want = group_norm_plain(x, scale, bias, 32, 1e-6, silu, "NCHW", pre,
                            stats_dtype=torch.float64)
    assert _within_limit(dtype, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 1536, 2, 2), (3, 768, 4, 4), (2, 192, 32, 32)])
def test_group_norm_without_act_or_pre_bias(dev, dtype, shape):
    """The form every scale-shift ResBlock's out_norm runs (no SiLU, no
    pre-bias), at lsun_churches256's channels_last shapes, against the plain
    version in float64."""
    x = (3 * _randn(*shape, dtype=torch.float32, dev=dev) + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    scale = 1 + 0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=4)
    bias = 0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=5)
    got = group_norm(x, scale, bias, 32, 1e-5, data_format="NCHW")
    torch.cuda.synchronize()
    want = group_norm_plain(x, scale, bias, 32, 1e-5, None, "NCHW", stats_dtype=torch.float64)
    assert group_norm_layout(got) == "channels_last"
    assert _within_limit(dtype, got, want)


def test_group_norm_one_read_limit(dev):
    """The largest UNet sample takes the one-read path in bfloat16, one row
    more takes two reads; float32 halves the limit."""
    bf = torch.bfloat16
    assert group_norm_path((48, 768, 32, 32), bf, 32) == "group_norm"
    assert group_norm_path((48, 768, 25, 41), bf, 32) == "group_norm_two_pass"
    assert group_norm_path((48, 768, 32, 32), torch.float32, 32) == "group_norm_two_pass"


@pytest.mark.parametrize("view", ["narrowed_width", "sliced_channels", "misaligned_base"])
def test_group_norm_rejects_layouts(dev, view):
    """Strides other than dense NCHW or channels_last, and a channels_last
    tensor off a 16-byte boundary, raise instead of launching or copying."""
    bf = torch.bfloat16
    if view == "narrowed_width":
        x = _randn(2, 64, 8, 9, dtype=bf, dev=dev).contiguous(
            memory_format=torch.channels_last)[..., :8]
    elif view == "sliced_channels":
        x = _randn(2, 128, 8, 8, dtype=bf, dev=dev)[:, ::2]
    else:
        x = _randn(1 + 2 * 8 * 8 * 64, dtype=bf, dev=dev)[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2)
    ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        group_norm_kernel(x, ones, zeros, 32, 1e-6, True)
    assert kernels.launches == before


def _grad_close(got, want):
    """The Functions' backwards recompute the same float32 formula as
    autograd through the plain version, on the same inputs: each gradient
    to 1e-5 of its largest element (the sums may run in another order)."""
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-5 * max(scale, 1e-30)


def _grads(fn, inputs, g):
    inputs = [t.detach().requires_grad_() for t in inputs]
    y = fn(*inputs)
    return y, torch.autograd.grad(y, inputs, g)


_GN_GRAD_CASES = {  # id: ([N, C, H, W], rows of the pre-bias or None)
    "one_read": ((3, 64, 9, 7), "n"),
    "cg4_no_pre": ((2, 128, 12, 20), None),
    "two_read": ((2, 64, 130, 130), "n"),
    "n1_broadcast_pre": ((1, 96, 10, 10), "1"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_GN_GRAD_CASES))
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("act", [None, silu], ids=["plain", "silu"])
def test_group_norm_grad(dev, dtype, case, channels_last, act):
    """GroupNormKernel's gradients (x, scale, bias, pre-bias) against
    autograd through group_norm_plain, and its output's grad_fn."""
    shape, pre_rows = _GN_GRAD_CASES[case]
    n, c = shape[:2]
    x = (3 * _randn(*shape, dtype=torch.float32, dev=dev) + 1).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    inputs = [x, 1 + 0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=4),
              0.1 * _randn(c, dtype=torch.float32, dev=dev, seed=5)]
    if pre_rows:
        inputs.append(_randn(n if pre_rows == "n" else 1, c, dtype=dtype, dev=dev, seed=6))
    g = _randn(*shape, dtype=dtype, dev=dev, seed=7)
    y, got = _grads(lambda x, s, b, p=None: group_norm(x, s, b, 32, 1e-6, act, "NCHW", p),
                    inputs, g)
    assert type(y.grad_fn).__name__ == "GroupNormKernelBackward"
    _, want = _grads(lambda x, s, b, p=None: group_norm_plain(x, s, b, 32, 1e-6, act, "NCHW", p),
                     inputs, g)
    _grad_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_grad_through_residual(dev, dtype):
    """x + GroupNorm(x), as the UNet routes a skip around every norm: with a
    detached kernel output the backward still runs, and x's gradient is the
    cotangent alone; scale and bias would get none."""
    x = (3 * _randn(2, 64, 16, 16, dtype=torch.float32, dev=dev) + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    inputs = [x, 1 + 0.1 * _randn(64, dtype=torch.float32, dev=dev, seed=4),
              0.1 * _randn(64, dtype=torch.float32, dev=dev, seed=5)]
    g = _randn(2, 64, 16, 16, dtype=dtype, dev=dev, seed=7)
    _, got = _grads(lambda x, s, b: x + group_norm(x, s, b, 32, 1e-5, silu, "NCHW"), inputs, g)
    _, want = _grads(lambda x, s, b: x + group_norm_plain(x, s, b, 32, 1e-5, silu, "NCHW"),
                     inputs, g)
    assert (got[0].float() - g.float()).abs().max() > 1e-2
    _grad_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape_q,shape_kv", [((2, 3, 130, 32), (2, 3, 70, 32)),
                                              ((2, 2, 256, 32), (2, 2, 256, 32)),
                                              ((1, 1, 100, 512), (1, 1, 45, 512))])
def test_flash_attention_grad(dev, dtype, shape_q, shape_kv):
    """FlashAttention's gradients against the vjp of the dense sdpa (its
    backward, as in JAX) and close to autograd through the kernel's plain
    version (another formula: q and k each pre-scaled by scale**0.5)."""
    qkv = [_randn(*s, dtype=dtype, dev=dev, seed=i)
           for i, s in enumerate((shape_q, shape_kv, shape_kv))]
    g = _randn(*shape_q, dtype=dtype, dev=dev, seed=4)
    y, got = _grads(flash_attention, qkv, g)
    assert type(y.grad_fn).__name__ == "FlashAttentionBackward"
    _grad_close(got, _grads(sdpa, qkv, g)[1])
    if dtype == torch.float32:
        for a, b in zip(got, _grads(flash_attention_plain, qkv, g)[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_packed_grad(dev, dtype):
    heads, d = 4, 32
    qkv = [_randn(2, 192, heads * d, dtype=dtype, dev=dev, seed=s) for s in (1, 2, 3)]
    g = _randn(2, 192, heads * d, dtype=dtype, dev=dev, seed=4)

    def dense(q, k, v):
        o = sdpa(*(_split_heads(t, heads) for t in (q, k, v)))
        return o.transpose(1, 2).reshape(q.shape)

    y, got = _grads(lambda q, k, v: flash_attention_packed(q, k, v, heads), qkv, g)
    assert type(y.grad_fn).__name__ == "FlashAttentionPackedBackward"
    _grad_close(got, _grads(dense, qkv, g)[1])


def _bias_act_x(layout, dtype, dev):
    """(x, dim) for a bias_act layout: a ragged [7, 13, 129] with the bias
    on dim 1; NHWC with it on the last dim; an NHWC view of NCHW memory;
    and a tensor that starts 2 bytes past a 16-byte boundary."""
    if layout == "ragged_dim1":
        return 2 * _randn(7, 13, 129, dtype=dtype, dev=dev), 1
    if layout == "nhwc":
        return 2 * _randn(2, 5, 7, 64, dtype=dtype, dev=dev), -1
    if layout == "nchw_memory":
        return 2 * _randn(2, 64, 5, 7, dtype=dtype, dev=dev).permute(0, 2, 3, 1), -1
    flat = 2 * _randn(1 + 3 * 9 * 40, dtype=dtype, dev=dev)
    return flat[1:].view(3, 9, 40), 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act", list(activation_funcs))
def test_bias_act_activations(dev, dtype, act):
    x, dim = _bias_act_x("ragged_dim1", dtype, dev)
    b = _randn(13, dtype=torch.float32, dev=dev, seed=7)
    before = kernels.launches["bias_act"]
    got = bias_act(x, b, dim=dim, act=act, gain=0.9, clamp=2.5)
    torch.cuda.synchronize()
    assert kernels.launches["bias_act"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _within_limit(dtype, got, bias_act_plain(x, b, dim=dim, act=act, gain=0.9, clamp=2.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw_memory", "unaligned"])
def test_bias_act_layouts(dev, dtype, layout):
    x, dim = _bias_act_x(layout, dtype, dev)
    b = _randn(x.shape[dim], dtype=torch.float32, dev=dev, seed=8)
    before = kernels.launches["bias_act"]
    got = bias_act(x, b, dim=dim, act="lrelu")
    assert kernels.launches["bias_act"] == before + 1
    assert got.stride() == x.stride()
    assert _within_limit(dtype, got, bias_act_plain(x, b, dim=dim, act="lrelu"))
    no_bias = bias_act(x, None, act="swish")
    assert _within_limit(dtype, no_bias, bias_act_plain(x, None, act="swish"))


def test_bias_act_second_order_grad(dev):
    """Kernel forward with the plain backward against the plain version
    throughout: gradients of first and second order."""
    x0 = _randn(3, 16, 5, dtype=torch.float32, dev=dev, seed=9)
    b0 = _randn(16, dtype=torch.float32, dev=dev, seed=10)
    out = {}
    for name, fn in (("kernel", bias_act), ("plain", bias_act_plain)):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        (g,) = torch.autograd.grad((fn(x, b, dim=1, act="elu") ** 2).sum(), x,
                                   create_graph=True)
        out[name] = (g, *torch.autograd.grad((g ** 2).sum(), (x, b)))
    for got, want in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bias_act_rejects_unsupported(dev):
    x = _randn(4, 8, dtype=torch.float32, dev=dev)
    with pytest.raises(TypeError):
        bias_act(x.double(), None)
    with pytest.raises(ValueError, match="not dense"):
        bias_act(_randn(4, 16, dtype=torch.float32, dev=dev)[:, :8], None)


def test_bias_act_64bit_indices(dev):
    """2^31 + 4 elements take the kernel's 64-bit index path; the bias lies
    on dim 0, 2^29 + 1 elements apart."""
    x = torch.ones(4, 2**29 + 1, dtype=torch.bfloat16, device=dev)
    x[:, -3:] = -2.0
    b = torch.arange(4, dtype=torch.float32, device=dev)
    got = bias_act(x, b, dim=0, act="lrelu")
    for cols in (slice(0, 5), slice(-5, None)):
        want = bias_act_plain(x[:, cols], b, dim=0, act="lrelu")
        assert torch.equal(got[:, cols], want)
