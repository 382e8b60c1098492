"""The channels_last GroupNorm kernels' statistics, emulated on the CPU.

`gn_cluster_kernel` (one read) and `gn_tile_stats_kernel` +
`gn_tile_apply_kernel` (two reads) in `ealdm_torch/kernels/csrc/group_norm.cu`
run only on the card. `emulate` repeats their arithmetic in float32 on the
[N, H*W, C] rows of a channels_last tensor: values shifted by each group's
value v = x + pre-bias at row 0 (d = x + (pre-bias - K)), per-slice (8
slices of ceil(H*W / 8) rows) or per-tile (mean, M2) with the mean taken
first, merged by Chan's formula in the kernels' order (slices by rank;
tiles by lane ranges, then a shuffle tree), and
y = (d - mean) * rstd * scale + bias. It follows the wrapper's
plan (`ealdm_torch.ops.norms`: path and tile rows) for the dtype given.

The emulation is held to the Pallas kernel in interpret mode (as
`test_torch_port_ops.py` runs it) and to `ealdm_tpu.ops.norms.group_norm`
at 1e-4. On data 1000 from 0 the JAX formulation runs in float64
(`_group_norm_jnp` under `jax.enable_x64`): in float32 its own mean loses
the digits the limit needs there, and the Pallas kernel's E[x^2] - mean^2
loses the variance. Two broken emulations, one that drops a partial and one that takes
E[v^2] - mean^2 unshifted, fall outside that limit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.ops import norms as t_norms
from ealdm_tpu.ops import group_norm_pallas
from ealdm_tpu.ops import norms as j_norms

torch.set_num_threads(1)

LIMIT = 1e-4  # float32, another summation order than XLA's


def _merge(a, b):
    """Chan's merge of (count, mean, M2) b into a; counts are Python numbers,
    means and M2 [N, G] tensors."""
    na, ma, qa = a
    nb, mb, qb = b
    if nb == 0:
        return a
    tot = na + nb
    f, delta = nb / tot, mb - ma
    return tot, ma + delta * f, qa + qb + delta * delta * na * f


def emulate(x, scale, bias, groups, eps, silu, pre=None, plan_dtype=torch.float32,
            drop=None, unshifted=False):
    """The kernels' output for float32 x [N, C, H, W]; `drop` leaves one
    partial out of the merge, `unshifted` takes the variance as
    E[v^2] - mean^2 of unshifted sums."""
    n, c, h, w = x.shape
    hw, cg = h * w, c // groups
    rows_x = x.permute(0, 2, 3, 1).reshape(n, hw, c)
    pre = torch.zeros(n, c) if pre is None else pre
    # d = x + (pre - shift), the shift being v = x + pre at row 0 and the
    # group's first channel
    shift = (rows_x[:, 0] + pre).reshape(n, groups, cg)[:, :, :1].expand(n, groups, cg)
    off = pre - (0 if unshifted else shift.reshape(n, c))
    d = (rows_x + off[:, None, :]).reshape(n, hw, groups, cg)
    if t_norms.group_norm_path(x.shape, plan_dtype, groups) == "group_norm":
        rows = math.ceil(hw / t_norms._CLUSTER)
        order = None  # slices merged by rank
    else:
        rows = t_norms._TILE_BYTES // (c * torch.empty((), dtype=plan_dtype).element_size())
        order = "lanes"
    parts = []
    for k, r0 in enumerate(range(0, hw, rows)):
        dk = d[:, r0:r0 + rows]
        cnt = dk.shape[1] * cg
        mean = dk.sum((1, 3)) / cnt
        q = ((dk * dk).sum((1, 3)) if unshifted
             else torch.square(dk - mean[:, None, :, None]).sum((1, 3)))
        parts.append(None if k == drop else (cnt, mean, q))
    parts = [p for p in parts if p is not None]
    zero = (0, torch.zeros(n, groups), torch.zeros(n, groups))
    if order is None:
        tot = zero
        for p in parts:
            tot = _merge(tot, p)
    else:  # each lane a range of tiles, then shuffle-down merges
        per = math.ceil(len(parts) / 32)
        lanes = []
        for lane in range(32):
            acc = zero
            for p in parts[lane * per:(lane + 1) * per]:
                acc = _merge(acc, p)
            lanes.append(acc)
        for off in (16, 8, 4, 2, 1):
            for lane in range(off):
                lanes[lane] = _merge(lanes[lane], lanes[lane + off])
        tot = lanes[0]
    cnt, mean, m2 = tot
    if unshifted:  # sums of v and v^2 over the sample, no shift, no M2
        s1 = torch.stack([p[1] * p[0] for p in parts]).sum(0)
        s2 = torch.stack([p[2] for p in parts]).sum(0)
        mean = s1 / cnt
        var = s2 / cnt - mean * mean
    else:
        var = m2 / cnt
    rstd = torch.rsqrt(var + eps)
    a = (rstd[:, :, None] * scale.reshape(groups, cg)).reshape(n, 1, c)
    y = (d - mean[:, None, :, None]).reshape(n, hw, c) * a + bias
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _inputs(shape, offset, seed=0):
    n, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    x = x + offset if offset else 3 * x + 1
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    pre = rng.randn(n, c).astype(np.float32)
    return x.astype(np.float32), scale, bias, pre


def _torch_args(x, scale, bias, pre):
    """emulate's arguments: x as a channels_last [N, C, H, W] view, 32
    groups, eps 1e-6, SiLU, the pre-bias."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    return (xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-6, True,
            torch.from_numpy(pre))


def _err(got, want_nhwc):
    return np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want_nhwc)).max()


def _jax_group_norm(x, scale, bias, pre, offset):
    """The JAX GroupNorm with fused SiLU: float32 statistics, or float64 for
    data far from 0."""
    if not offset:
        return j_norms.group_norm(jnp.asarray(x), scale, bias, 32, 1e-6, act=j_norms.silu,
                                  pre_bias=jnp.asarray(pre))
    with jax.enable_x64(True):
        xj, sj, bj, pj = (jnp.asarray(a, jnp.float64) for a in (x, scale, bias, pre))
        return np.asarray(j_norms._group_norm_jnp(xj, sj, bj, 32, 1e-6, j_norms.silu, "NHWC",
                                                  pj, jnp.float64))


# id: ([N, C, H, W], the dtype whose plan is followed). One read: 8 slices,
# two of them empty at H*W = 6; two reads: 67 tiles of 256 rows, 3 a lane.
_CASES = {
    "one_read": ((2, 64, 16, 16), torch.float32),
    "one_read_empty_slices": ((2, 64, 3, 2), torch.float32),
    "two_read": ((1, 64, 130, 130), torch.float32),
    "two_read_bf16_plan": ((1, 64, 130, 130), torch.bfloat16),
}


@pytest.mark.parametrize("case", list(_CASES))
@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_emulation_matches_jax(case, offset):
    shape, plan = _CASES[case]
    x, scale, bias, pre = _inputs(shape, offset)
    path = t_norms.group_norm_path(shape, plan, 32)
    assert path == ("group_norm" if case.startswith("one") else "group_norm_two_pass")
    want = _jax_group_norm(x, scale, bias, pre, offset)
    got = emulate(*_torch_args(x, scale, bias, pre), plan_dtype=plan)
    assert _err(got, want) <= LIMIT


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = group_norm_pallas.pl.pallas_call
    monkeypatch.setattr(group_norm_pallas.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("case", ["one_read", "two_read"])
def test_emulation_matches_pallas_kernel(interpret_pallas, case):
    shape, plan = _CASES[case]
    x, scale, bias, pre = _inputs(shape, 0.0)
    want = group_norm_pallas.group_norm_hwnc(
        jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)), jnp.asarray(scale),
        jnp.asarray(bias), 32, 1e-6, fuse_silu=True, pre_bias=jnp.asarray(pre))
    got = emulate(*_torch_args(x, scale, bias, pre), plan_dtype=plan)
    assert _err(got, jnp.transpose(want, (2, 0, 1, 3))) <= LIMIT


@pytest.mark.parametrize("case", ["one_read", "two_read"])
@pytest.mark.parametrize("fault", ["dropped_partial", "unshifted_variance"])
def test_broken_emulation_falls_outside(case, fault):
    """A partial left out of the merge, or E[v^2] - mean^2 on unshifted data
    1000 from 0, each miss the JAX result by more than the limit."""
    shape, plan = _CASES[case]
    offset = 1000.0 if fault == "unshifted_variance" else 0.0
    x, scale, bias, pre = _inputs(shape, offset)
    want = _jax_group_norm(x, scale, bias, pre, offset)
    kw = dict(drop=3) if fault == "dropped_partial" else dict(unshifted=True)
    got = emulate(*_torch_args(x, scale, bias, pre), plan_dtype=plan, **kw)
    assert _err(got, want) > 10 * LIMIT
