"""The bfloat16 flash-attention limits, checked where there is no card.

The bfloat16 kernels (`ealdm_torch/kernels/csrc/flash_attention.cu`) run the
online softmax over key tiles (64 keys up to d=128, 32 above) in float32, in
base 2 (p = 2^(s*c - m*c), c = scale * log2(e)), round P to bfloat16 before
P*V and accumulate in float32; the row sums use the unrounded P. `emulate`
repeats that arithmetic in torch. The card checks hold the kernels to the
two limits of `bf16_attention_shares` against `flash_attention_plain`, which
keeps P in float32: per element, two bf16 ulps of each reference element +
1e-4 + 2^-8 * max|v| (the worst case of P's rounding), and the RMS of the
error against that of P's rounding (see its docstring for the derivation).

Here the emulation is held to both limits, shown to agree with the JAX
Pallas kernel (interpret mode) when the rounding is off, and shown to break
them when the online softmax is wrong or P is rounded more coarsely, so that
the limits would catch a kernel with those faults. `emulate_wide` does the
same for the wide wgmma kernel (`flash_attention_sm90_wide.cu`, d = 136 ..
576), whose order differs: O's rescale reaches the warpgroups that hold O
through a double buffer, and with the key split two blocks combine (O,
max, sum) at the end. `emulate_deep` does it for the deep wgmma kernel
(`flash_attention_sm90_deep.cu`, d = 584 .. 1,920), whose scores are the
sum of a cluster's partial products over depth slices, added in rank
order. At the head dims the
repo's other configurations reach (24, 40, 48, 80: not multiples of the
mma k-step, or off the two that the first kernels took), the plain versions
the card holds the kernels to are checked against the JAX kernels in
interpret mode, split and packed.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_tpu.ops import attention as j_attention
from ealdm_tpu.ops.attention import _flash_packed_forward
from ealdm_torch.ops.attention import (
    _split_heads, bf16_attention_shares, deep_slices, flash_attention_packed,
    flash_attention_plain, tf32x3_tiling)

LOG2E = 1.4426950408889634


class _BlockK(dict):
    """Keys a tile in the bfloat16 kernels: 64 up to d=128, 32 above."""

    def __missing__(self, d):
        return 64 if d <= 128 else 32


BLOCK_K = _BlockK()


def round_significand(x, bits):
    """x rounded to nearest (ties to even) with a `bits`-bit significand:
    8 is bfloat16, 4 an fp8 (e4m3) significand."""
    m, e = torch.frexp(x)  # m in [0.5, 1)
    return torch.ldexp(torch.round(m * 2**bits) / 2**bits, e)


def emulate(q, k, v, block_k, scale=None, p_bits=8, rescale=True, last_tile=True):
    """The kernels' arithmetic on [B, H, Nq, D] q and [B, H, Nk, D] k/v;
    returns the float32 output before its rounding to q's dtype. P is
    rounded to `p_bits` significant bits (None: not rounded). The switches
    break it: `rescale=False` drops the alpha rescale of the running sum and
    output, `last_tile=False` skips the last key tile, and `p_bits` below 8
    rounds P more coarsely than bfloat16."""
    nk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3] + (1,), -math.inf)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(qf.shape)
    ntiles = -(-nk // block_k)
    for t in range(ntiles if last_tile else ntiles - 1):
        kt, vt = kf[:, :, t * block_k:(t + 1) * block_k], vf[:, :, t * block_k:(t + 1) * block_k]
        s = qf @ kt.transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = (p if p_bits is None else round_significand(p, p_bits)) @ vt
        acc = (acc * alpha if rescale else acc) + pv
        m = m_new
    return acc / l


def shares(got, q, k, v, **kw):
    """(per-element, RMS) shares of the limits that `got` uses against
    flash_attention_plain."""
    return bf16_attention_shares(got.to(torch.bfloat16), q, k, v,
                                 flash_attention_plain(q, k, v, kw.get("scale")), **kw)


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


# (B, H, Nq, Nk): equal counts on whole tiles, and ragged counts whose last
# key tile is partly filled
SHAPES = {32: [(2, 2, 128, 128), (2, 3, 100, 104), (1, 2, 65, 1)],
          512: [(1, 1, 64, 64), (2, 1, 70, 45), (1, 1, 1, 33)],
          24: [(2, 2, 128, 128), (1, 2, 65, 70)],
          40: [(2, 2, 128, 128), (1, 2, 65, 70)],
          48: [(2, 2, 128, 128), (1, 2, 65, 70)],
          80: [(2, 2, 128, 128), (1, 2, 65, 70)],
          576: [(1, 1, 64, 64), (1, 1, 33, 45)]}


@pytest.mark.parametrize("d,shape", [(d, s) for d in SHAPES for s in SHAPES[d]])
def test_emulation_within_limit(d, shape):
    b, h, nq, nk = shape
    rng = np.random.default_rng(nq * 1000 + nk + d)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    assert max(shares(emulate(q, k, v, BLOCK_K[d]), q, k, v)) <= 1


@pytest.mark.parametrize("heads,d", [(2, 32), (1, 512)])
def test_emulation_matches_pallas_without_rounding(heads, d):
    """float32, P unrounded: the emulation is the Pallas kernel's online
    softmax (base 2 instead of e, the scale on the scores instead of q), on
    the packed [B, N, H*D] layout with the same key tile."""
    b, n = 2, 128
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32) for _ in range(3))
    want = _flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                 block_k=BLOCK_K[d], interpret=True)

    def split(x):
        return torch.from_numpy(x).reshape(b, n, heads, d).transpose(1, 2)

    got = emulate(split(q), split(k), split(v), BLOCK_K[d], p_bits=None)
    got = got.transpose(1, 2).reshape(b, n, heads * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [32, 512])
@pytest.mark.parametrize("fault", ["no_alpha_rescale", "skip_last_ragged_tile"])
def test_broken_emulation_breaks_limit(d, fault):
    """Two faults an online-softmax kernel can have, each far outside the
    limit: the limit would catch them on the card."""
    bk = BLOCK_K[d]
    b, h, nq, nk = 1, 2, 64, 2 * bk + bk // 2 + 3  # two full tiles and a ragged one
    rng = np.random.default_rng(11)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    q = q * 2  # spread the scores so the running max moves between tiles
    kw = {"rescale": False} if fault == "no_alpha_rescale" else {"last_tile": False}
    assert max(shares(emulate(q, k, v, bk), q, k, v)) <= 1
    assert shares(emulate(q, k, v, bk, **kw), q, k, v)[0] > 2


@pytest.mark.parametrize("d,shape", [(32, (2, 4, 1024, 1024)), (512, (1, 1, 1024, 1024))])
def test_coarse_p_breaks_rms_limit(d, shape):
    """P rounded to 4 significant bits (an fp8 significand) instead of 8, at
    the main path's token count: the per-element limit, a worst case,
    still passes it, and the RMS limit catches it."""
    b, h, nq, nk = shape
    rng = np.random.default_rng(d)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    sound = shares(emulate(q, k, v, BLOCK_K[d]), q, k, v)
    coarse = shares(emulate(q, k, v, BLOCK_K[d], p_bits=4), q, k, v)
    assert max(sound) <= 1
    assert coarse[0] <= 1 < 2 < coarse[1]


def test_p_rounding_needs_the_2_to_minus_8_term():
    """Scores set so that every p but the row max's lies just off a bf16
    rounding midpoint, 0.5 + 2^-9: 63 keys just below it (rounded down,
    v = +1) and 63 just above (rounded up, v = -1). The rounding errors add
    while the output cancels to about 0, so the rounded-P error reaches
    0.97 of 2^-8 * max|v|: above the limit with a 2^-9 term, within it with
    2^-8."""
    n, d = 63, 32
    x = [1.0] + [0.5 + 2**-9 - 2**-16] * n + [0.5 + 2**-9 + 2**-16] * n
    q = torch.zeros(1, 1, 1, d)
    q[..., 0] = 1.0
    k = torch.zeros(1, 1, 1 + 2 * n, d)
    k[0, 0, :, 0] = torch.log(torch.tensor(x, dtype=torch.float64)).float()
    v = torch.zeros(1, 1, 1 + 2 * n, d)
    v[0, 0, 1:n + 1] = 1.0
    v[0, 0, n + 1:] = -1.0
    want = flash_attention_plain(q, k, v, scale=1.0)
    got = emulate(q, k, v, BLOCK_K[d], scale=1.0).to(torch.bfloat16)
    assert 0.9 < bf16_attention_shares(got, q, k, v, want, scale=1.0)[0] <= 1
    assert bf16_attention_shares(got, q, k, v, want, scale=1.0, p_rounding=2**-9)[0] > 1.5


NEW_DIMS = (24, 40, 48, 80)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = j_attention.pl.pallas_call
    monkeypatch.setattr(j_attention.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("d", NEW_DIMS)
def test_plain_matches_pallas_at_new_head_dims(interpret_pallas, d):
    """flash_attention_plain, the card's reference at these head dims,
    against JAX's `flash_attention` (the Pallas kernel in interpret mode) on
    [B, H, N, D] float32, N = 256 (the smallest flash-eligible count):
    1e-5, float32 sums in another order."""
    b, h, n = 2, 3, 256
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    want = j_attention.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", NEW_DIMS)
def test_packed_plain_matches_pallas_at_new_head_dims(d):
    """The packed entry point's CPU form against JAX's packed kernel in
    interpret mode, [B, N, H*D] float32: 1e-5."""
    b, n, heads = 2, 256, 2
    rng = np.random.default_rng(100 + d)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32) for _ in range(3))
    want = _flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                 interpret=True)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = flash_attention_packed(tq, tk, tv, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    split = flash_attention_plain(*(_split_heads(t, heads) for t in (tq, tk, tv)))
    torch.testing.assert_close(got, split.transpose(1, 2).reshape(b, n, heads * d))


# keys a tile of the wide wgmma kernel (`flash_attention_sm90_wide.cu`
# `route`) at the paths' head dims; its key split over two blocks runs at
# [12,1,256,576] and wherever one block per 64 rows leaves half the card idle
WIDE_BLOCK_K = {384: 32, 512: 32, 576: 32}


def emulate_wide(q, k, v, d, key_split=1, scale=None, p_bits=8, stale_alpha=False,
                 combine=True):
    """The wide kernel's arithmetic on [B, H, Nq, D] q and [B, H, Nk, D] k/v,
    in its order: each of `key_split` blocks takes key tiles [t0, t1) of BK
    keys; its S warpgroup runs the online softmax over each tile and keeps
    the row sums; its PV warpgroups rescale O by the tile's alpha (read from
    the tile's buffer) and add P V, each on its own columns, which leaves
    every element's arithmetic as it is; at the end the blocks' (O, max,
    sum) combine. Returns the float32 output before its rounding. The
    faults: `stale_alpha` rescales O by the other buffer's alpha (the
    previous tile's), `combine=False` adds the second block's O without its
    rescale."""
    block_k = WIDE_BLOCK_K[d]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    ntiles = -(-k.shape[2] // block_k)
    blocks = []
    for r in range(key_split):
        m = torch.full(q.shape[:3] + (1,), -math.inf)
        l = torch.zeros(q.shape[:3] + (1,))
        acc = torch.zeros(qf.shape)
        alphas = [torch.zeros_like(l)] * 2  # the two buffers
        for t in range(ntiles * r // key_split, ntiles * (r + 1) // key_split):
            kt, vt = (x[:, :, t * block_k:(t + 1) * block_k] for x in (kf, vf))
            s = qf @ kt.transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alphas[t % 2] = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * alphas[t % 2] + p.sum(dim=-1, keepdim=True)
            pv = (p if p_bits is None else round_significand(p, p_bits)) @ vt
            acc = acc * alphas[(t + stale_alpha) % 2] + pv
            m = m_new
        blocks.append((acc, m, l))
    acc, m, l = blocks[0]
    for acc_b, m_b, l_b in blocks[1:]:
        mx = torch.maximum(m, m_b)
        fa, fb = torch.exp2((m - mx) * c), torch.exp2((m_b - mx) * c)
        acc = acc * fa + (acc_b * fb if combine else acc_b)
        l = l * fa + l_b * fb
        m = mx
    return acc / l


# (B, H, Nq, Nk): whole tiles, a ragged last tile, and a key split whose
# halves hold 4 and 5 tiles (the second ragged)
WIDE_SHAPES = [(1, 1, 64, 256), (2, 1, 70, 45), (1, 2, 33, 281)]


@pytest.mark.parametrize("key_split", [1, 2])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("d", sorted(WIDE_BLOCK_K))
def test_wide_emulation_within_limit(d, shape, key_split):
    b, h, nq, nk = shape
    rng = np.random.default_rng(nq * 1000 + nk + d + key_split)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    assert max(shares(emulate_wide(q, k, v, d, key_split), q, k, v)) <= 1


@pytest.mark.parametrize("d", [384, 576])
def test_wide_emulation_matches_pallas_without_rounding(d):
    """float32, P unrounded: the wide order (32-key tiles, alpha through
    the double buffer, the key split's combine) is the Pallas kernel's
    online softmax, on the packed [B, N, D] layout of one head: 1e-5."""
    b, n = 2, 128
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(3))
    want = _flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
                                 block_k=32, interpret=True)

    def split(x):
        return torch.from_numpy(x)[:, None]

    for key_split in (1, 2):
        got = emulate_wide(split(q), split(k), split(v), d, key_split, p_bits=None)
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,fault", [(384, "stale_alpha"), (576, "stale_alpha"),
                                     (384, "combine"), (576, "combine")])
def test_broken_wide_emulation_breaks_limit(d, fault):
    """The faults the wide order can have: PV warpgroups that rescale O by
    the other P buffer's alpha (the previous tile's), and a key-split
    combine that adds the second block's O without its rescale. Each is far
    outside the limit."""
    b, h, nq, nk = 1, 2, 64, 8 * 32 + 19
    rng = np.random.default_rng(13)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    q = q * 2  # spread the scores so the running max and the halves' maxima move
    assert max(shares(emulate_wide(q, k, v, d, key_split=2), q, k, v)) <= 1
    broken = emulate_wide(q, k, v, d, key_split=2,
                          **{fault: fault == "stale_alpha"})
    assert shares(broken, q, k, v)[0] > 2


# the deep wgmma kernel (`flash_attention_sm90_deep.cu`, d = 584 .. 1,920):
# 32-key tiles, and the depth slices `deep_slices` gives it, one block of a
# cluster each
DEEP_BLOCK_K = 32


def emulate_deep(q, k, v, scale=None, p_bits=8, own_partial_only=False, stale_peer=0):
    """The deep kernel's arithmetic on [B, H, Nq, D] q and [B, H, Nk, D] k/v,
    in its order: the head dim, zero-padded to a multiple of 8 and then to
    CS slices of W, splits over the CS blocks of a cluster; for each
    32-key tile each block takes its partial S_c = Q_c K_c^T and the cluster
    adds the CS partials in rank order 0 .. CS-1, so every block runs the
    same base-2 online softmax on the same S and the same P (rounded to
    bfloat16); block c adds P V_c to its columns of O. Returns the float32
    output before its rounding. The faults, each in block c's view of S:
    `own_partial_only` takes its own partial without its peers';
    `stale_peer` = s > 0 takes each peer's partial of tile j - s (zeros
    before the first tile): s = 1 reads the other exchange buffer, s = 2
    the right buffer before the peer's new partial lands (a missing wait)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    w, cs = deep_slices(-(-d // 8) * 8)
    pad = (0, cs * w - d)
    qf, kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (q, k, v))
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    bk = DEEP_BLOCK_K
    ntiles = -(-k.shape[2] // bk)
    # partials[j][r]: block r's partial S of tile j
    partials = [[qf[..., r * w:(r + 1) * w] @ kf[:, :, j * bk:(j + 1) * bk, r * w:(r + 1) * w]
                 .transpose(-1, -2) for r in range(cs)] for j in range(ntiles)]
    out = torch.zeros(qf.shape)
    for blk in range(cs):  # each block's view; sound, they all see one S
        m = torch.full(q.shape[:3] + (1,), -math.inf)
        l = torch.zeros(q.shape[:3] + (1,))
        acc = torch.zeros(q.shape[:3] + (w,))
        for j in range(ntiles):
            s = None
            for r in range(cs):
                part = partials[j][r]
                if own_partial_only and r != blk:
                    continue
                if stale_peer and r != blk:
                    part = partials[j - stale_peer][r] if j >= stale_peer else \
                        torch.zeros_like(part)
                    if part.shape != partials[j][r].shape:  # the ragged last tile
                        part = part[..., :partials[j][r].shape[-1]]
                s = part if s is None else s + part
            vt = vf[:, :, j * bk:(j + 1) * bk, blk * w:(blk + 1) * w]
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + (p if p_bits is None else round_significand(p, p_bits)) @ vt
            m = m_new
        out[..., blk * w:(blk + 1) * w] = acc / l
    return out[..., :d]


DEEP_DIMS = (648, 960, 1100)
# (B, H, Nq, Nk): a partial query block (rows past 64) and a partial last
# key tile, and a single ragged tile
DEEP_SHAPES = [(1, 2, 70, 77), (2, 1, 33, 19)]


@pytest.mark.parametrize("shape", DEEP_SHAPES)
@pytest.mark.parametrize("d", DEEP_DIMS)
def test_deep_emulation_within_limit(d, shape):
    b, h, nq, nk = shape
    rng = np.random.default_rng(nq * 1000 + nk + d)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    assert max(shares(emulate_deep(q, k, v), q, k, v)) <= 1


def test_deep_slices_match_the_kernel_route():
    """The clusters the deep kernel runs (the wrapper passes it the width
    of `deep_slices`, which `emulate_deep` also takes): 2 blocks of 384 at
    d = 648 and 704, 2 of 512 at 960, 3 of 384 at 1,104, 5 of 384 at 1,920
    (its widest), and the smallest padding of the two widths everywhere."""
    assert [deep_slices(d) for d in (648, 704, 960, 1104, 1920)] == [
        (384, 2), (384, 2), (512, 2), (384, 3), (384, 5)]
    for d in range(584, 1921, 8):
        w, cs = deep_slices(d)
        assert w * cs == min(-(-d // 384) * 384, -(-d // 512) * 512 if d <= 1024 else 10**9)


@pytest.mark.parametrize("fault", ["own_partial_only", "stale_peer_1", "stale_peer_2"])
@pytest.mark.parametrize("d", [648, 1100])
def test_broken_deep_emulation_breaks_limit(d, fault):
    """The faults the cluster's exchange can have: a block that normalises
    its columns with its own partial S and not its peers' (its slice of
    the row is then weighted differently from the others'), and a peer's
    partial read from the previous tile's buffer or before the peer's store
    lands (a missing cluster wait). Each is far outside the limit."""
    b, h, nq, nk = 1, 2, 64, 4 * DEEP_BLOCK_K + 19
    rng = np.random.default_rng(17)
    q, k, v = _bf16(rng, b, h, nq, d), _bf16(rng, b, h, nk, d), _bf16(rng, b, h, nk, d)
    q = q * 2  # spread the scores so that a wrong S moves the softmax
    assert max(shares(emulate_deep(q, k, v), q, k, v)) <= 1
    kw = ({"own_partial_only": True} if fault == "own_partial_only"
          else {"stale_peer": int(fault[-1])})
    assert shares(emulate_deep(q, k, v, **kw), q, k, v)[0] > 2


@functools.lru_cache(maxsize=None)
def _deep_pallas(d, layout):
    """(q, k, v, JAX's output) at [2, 2, 256, d] float32 ([2, 256, 2*d]
    packed): the Pallas kernel in interpret mode with 32-key tiles."""
    b, h, n = 2, 2, 256
    rng = np.random.default_rng(d + (layout == "packed"))
    if layout == "packed":
        q, k, v = (rng.standard_normal((b, n, h * d)).astype(np.float32) for _ in range(3))
        want = _flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                     block_k=DEEP_BLOCK_K, interpret=True)
    else:
        q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
        orig = j_attention.pl.pallas_call
        j_attention.pl.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
        try:
            want = j_attention.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               block_k=DEEP_BLOCK_K)
        finally:
            j_attention.pl.pallas_call = orig
    return q, k, v, np.asarray(want)


def _deep_split(layout, *arrays):
    """torch [B, H, N, D] views of the test's float32 arrays."""
    ts = [torch.from_numpy(a) for a in arrays]
    return ts if layout == "split" else [_split_heads(t, 2) for t in ts]


@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("d", [648, 960])
def test_deep_emulation_matches_pallas_without_rounding(d, layout):
    """float32, P unrounded: the deep order (the cluster's partial scores
    added in rank order, 32-key tiles) is the Pallas kernel's online
    softmax, on [B, H, N, D] and on the packed [B, N, H*D]: 1e-5."""
    q, k, v, want = _deep_pallas(d, layout)
    got = emulate_deep(*_deep_split(layout, q, k, v), p_bits=None)
    if layout == "packed":
        got = got.transpose(1, 2).reshape(want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("d", [648, 960])
def test_plain_matches_pallas_at_deep_head_dims(d, layout):
    """flash_attention_plain (and the packed entry point's CPU form), the
    card's reference for the deep kernel, against the same Pallas runs:
    1e-5."""
    q, k, v, want = _deep_pallas(d, layout)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = (flash_attention_plain(tq, tk, tv) if layout == "split"
           else flash_attention_packed(tq, tk, tv, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- float32
# `flash_tf32x3_kernel` (`flash_attention_sm90_f32.cu`): every float32 head
# dim (and bfloat16 above 1,920) on the TF32 tensor cores (mma.sync, and
# wgmma at some head dims) in split TF32, on `tf32x3_tiling`.


def tf32_round(x):
    """x rounded to TF32 as `cvt.rna.tf32.f32` does: 10 fraction bits, to
    nearest, ties away from zero (the low 13 bits of the float32 cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x cut to TF32: its 13 low bits cleared (toward zero), as the kernel
    takes hi, and as the tensor core reads a float32 lo."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a, b, split, rounding=tf32_trunc):
    """a @ b on the TF32 tensor cores: in split TF32 (hi*lo + lo*hi + hi*hi,
    the order the kernel issues them), or one term (hi*hi). The kernel's
    split (`rounding=tf32_trunc`): hi = x cut to TF32, lo = x - hi, of which
    the tensor core reads the TF32 top; `tf32_round` is cvt.rna's."""
    ah, bh = rounding(a), rounding(b)
    if not split:
        return ah @ bh
    al, bl = rounding(a - ah), rounding(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def emulate_tf32x3(q, k, v, splits=1, scale=None, split_scores=True, split_values=True,
                   rescale_parts=True, rounding=tf32_trunc):
    """The kernel's arithmetic on float32 [B, H, Nq, D] q and [B, H, Nk, D]
    k/v, in its order: the head dim zero-padded to whole depth passes of CW
    columns; for each tile of BK keys, each warp's partial S over its DW
    columns of every pass (split TF32), the partials added in rank order;
    the base-2 online softmax; O += P V in split TF32. With `splits` > 1 the
    key tiles split into that many ranges, each with its own (max, sum, O),
    combined as the combine kernel does. The faults: one TF32 term in S
    (`split_scores=False`) or in P V (`split_values=False`), and a combine
    that adds the parts without rescaling each by 2^((m_i - m) c).
    `rounding=tf32_round` splits with cvt.rna instead."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bk, wc, dw = tf32x3_tiling(d)
    cw = wc * dw
    dp = -(-d // cw) * cw
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, dp - d)) for t in (q, k, v))
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    ntiles = -(-k.shape[2] // bk)
    parts = []
    for sp in range(splits):
        m = torch.full(q.shape[:3] + (1,), -math.inf)
        l = torch.zeros(q.shape[:3] + (1,))
        acc = torch.zeros(qf.shape)
        for j in range(sp * ntiles // splits, (sp + 1) * ntiles // splits):
            kt, vt = kf[:, :, j * bk:(j + 1) * bk], vf[:, :, j * bk:(j + 1) * bk]
            s = None
            for w in range(cw // dw):  # warp w's partial over every pass, in rank order
                cols = [p + w * dw + i for p in range(0, dp, cw) for i in range(dw)]
                part = _tf32_product(qf[..., cols], kt[..., cols].transpose(-1, -2),
                                     split_scores, rounding)
                s = part if s is None else s + part
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - m_new * c)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + _tf32_product(p, vt, split_values, rounding)
            m = m_new
        parts.append((m, l, acc))
    if splits == 1:
        return (acc / l)[..., :d]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [torch.exp2((m - top) * c) if rescale_parts else torch.ones_like(m)
         for m, _, _ in parts]
    total = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return (sum(wi * a for wi, (_, _, a) in zip(w, parts)) / total)[..., :d]


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# (B, H, Nq, Nk, key splits) at each d: whole tiles, a ragged query block
# and key tile, and a key split whose ranges hold 1 to 3 tiles
TF32X3_SHAPES = [(1, 2, 128, 256, 1), (2, 1, 70, 77, 1), (1, 2, 100, 200, 3)]


@pytest.mark.parametrize("rounding", [tf32_trunc, tf32_round])
@pytest.mark.parametrize("shape", TF32X3_SHAPES)
@pytest.mark.parametrize("d", [32, 512, 640, 680])
def test_tf32x3_emulation_within_limit(d, shape, rounding):
    """Split TF32 on both products, in the kernel's order, holds the float32
    limit of 1e-4 against flash_attention_plain: at d = 32, 512 and 640 (one
    depth pass) and 680 (two passes of 512, and two strips), with and
    without the key split; with the kernel's split (hi cut to TF32) and
    with cvt.rna's."""
    b, h, nq, nk, splits = shape
    rng = np.random.default_rng(nq * 1000 + nk + d)
    q, k, v = _f32(rng, b, h, nq, d), _f32(rng, b, h, nk, d), _f32(rng, b, h, nk, d)
    got = emulate_tf32x3(q, k, v, splits=splits, rounding=rounding)
    assert (got - flash_attention_plain(q, k, v)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("layout", ["split", "packed"])
@pytest.mark.parametrize("d", [32, 512])
def test_tf32x3_emulation_matches_pallas(interpret_pallas, d, layout):
    """The emulation against JAX's Pallas kernel in interpret mode, from the
    same numpy inputs at [2, 2, 256, d] ([2, 256, 2*d] packed), with a key
    split of 2: 1e-4."""
    b, h, n = 2, 2, 256
    rng = np.random.default_rng(200 + d)
    if layout == "packed":
        q, k, v = (rng.standard_normal((b, n, h * d)).astype(np.float32) for _ in range(3))
        want = _flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                                     interpret=True)
        got = emulate_tf32x3(*(_split_heads(torch.from_numpy(t), h) for t in (q, k, v)),
                             splits=2).transpose(1, 2).reshape(b, n, h * d)
    else:
        q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
        want = j_attention.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        got = emulate_tf32x3(*(torch.from_numpy(t) for t in (q, k, v)), splits=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("fault", ["one_term", "scores_only", "values_only", "stale_combine"])
def test_broken_tf32x3_emulation_breaks_limit(fault):
    """The faults the float32 kernel could have, each outside 1e-4 at
    [1, 2, 256, 512]: one TF32 term in both products, the split on only one
    of them, and a key split whose combine does not rescale each part by
    2^((m_i - m) c)."""
    b, h, n, d = 1, 2, 256, 512
    rng = np.random.default_rng(41)
    q, k, v = (_f32(rng, b, h, n, d) for _ in range(3))
    want = flash_attention_plain(q, k, v)
    assert (emulate_tf32x3(q, k, v, splits=4) - want).abs().max().item() <= 1e-4
    kw = {"one_term": dict(split_scores=False, split_values=False),
          "scores_only": dict(split_values=False),
          "values_only": dict(split_scores=False),
          "stale_combine": dict(splits=4, rescale_parts=False)}[fault]
    assert (emulate_tf32x3(q, k, v, **kw) - want).abs().max().item() > 1e-4


def test_tf32_round_is_cvt_rna():
    """tf32_round keeps 10 fraction bits, rounding half away from zero, as
    cvt.rna does: 1 + 2^-11 (a tie) rounds up, 1 + 2^-11 - 2^-23 down, and
    negative values mirror; tf32_trunc cuts toward zero."""
    x = torch.tensor([1 + 2**-11, 1 + 2**-11 - 2**-23, -(1 + 2**-11), 1 + 3 * 2**-11])
    torch.testing.assert_close(tf32_round(x), torch.tensor([1 + 2**-10, 1.0, -(1 + 2**-10),
                                                            1 + 2 * 2**-10]), rtol=0, atol=0)
    torch.testing.assert_close(tf32_trunc(x), torch.tensor([1.0, 1.0, -1.0, 1 + 2**-10]),
                               rtol=0, atol=0)
