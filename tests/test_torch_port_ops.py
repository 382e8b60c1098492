"""The port's ops against the JAX package, on the CPU in float32: schedules,
timestep embedding, group/layer/instance norm and the attention family.

On CPU tensors the kernel wrappers (`group_norm`, `flash_attention`,
`flash_attention_packed`) run their plain versions; these tests hold those
against the JAX functions, including the Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch.ops import attention as t_attn
from ealdm_torch.ops import norms as t_norms
from ealdm_torch.ops import schedules as t_sched
from ealdm_torch.ops.embeddings import timestep_embedding as t_temb
from ealdm_tpu.ops import attention as j_attn
from ealdm_tpu.ops import group_norm_pallas
from ealdm_tpu.ops import norms as j_norms
from ealdm_tpu.ops import schedules as j_sched
from ealdm_tpu.ops.embeddings import timestep_embedding as j_temb

torch.set_num_threads(1)

# float32 reductions in another order (XLA:CPU vs ATen): a few ulps.
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedule_exact(kind):
    np.testing.assert_array_equal(
        t_sched.make_beta_schedule(kind, 1000, 0.0015, 0.0195),
        j_sched.make_beta_schedule(kind, 1000, 0.0015, 0.0195))


@pytest.mark.parametrize("steps", [3, 50, 200])
def test_ddim_timesteps_exact(steps):
    np.testing.assert_array_equal(t_sched.make_ddim_timesteps("uniform", steps, 1000),
                                  j_sched.make_ddim_timesteps("uniform", steps, 1000))


def test_schedule_x0_weights_match():
    """The x0 parameterization's lvlb weights, on a cosine schedule."""
    kw = dict(timesteps=1000, beta_schedule="cosine", parameterization="x0")
    ts, js = t_sched.DiffusionSchedule.create(**kw), j_sched.DiffusionSchedule.create(**kw)
    for field in ("betas", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=field)


def test_schedule_tables_match():
    """Both build the tables in float64 numpy and store float32: equal."""
    kw = dict(timesteps=1000, linear_start=0.0015, linear_end=0.0195)
    ts, js = t_sched.DiffusionSchedule.create(**kw), j_sched.DiffusionSchedule.create(**kw)
    for field in ("betas", "alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                  "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                  "posterior_variance", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=field)
    td = t_sched.DDIMSchedule.create(ts, 50, eta=1.0)
    jd = j_sched.DDIMSchedule.create(js, 50, eta=1.0)
    for field in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(td, field).numpy(),
                                      np.asarray(getattr(jd, field)), err_msg=field)
    t = np.array([0, 17, 999])
    np.testing.assert_array_equal(
        t_sched.extract(ts.sqrt_alphas_cumprod, _t(t), 4).numpy(),
        np.asarray(j_sched.extract(js.sqrt_alphas_cumprod, jnp.asarray(t), 4)))


@pytest.mark.parametrize("dim", [64, 256, 65])
def test_timestep_embedding(dim):
    """cos || sin order, float32 math. Each library's float32 exp may round
    a frequency one ulp apart (1.2e-7 relative); times t up to 999 that
    moves an argument by up to 1.2e-4, and its sin/cos with it: 1e-4."""
    t = np.array([0, 1, 17, 500, 999], np.int32)
    _close(t_temb(_t(t), dim), j_temb(jnp.asarray(t), dim), dict(rtol=0, atol=1e-4))


# ------------------------------------------------------------------ norms
def _gn_inputs(n, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    x = (3 * rng.randn(n, h, w, c) + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    pre = rng.randn(n, c).astype(np.float32)
    return x, scale, bias, pre


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW", "NCHW_channels_last"])
@pytest.mark.parametrize("eps,silu,use_pre", [(1e-5, True, True), (1e-6, True, False),
                                              (1e-6, False, False), (1e-5, False, True)])
def test_group_norm_matches_jnp(fmt, eps, silu, use_pre):
    """NHWC, NCHW-contiguous, and the channels_last NCHW view the model's
    convolutions produce."""
    x, scale, bias, pre = _gn_inputs(2, 6, 5, 64)
    want = j_norms.group_norm(jnp.asarray(x), scale, bias, 32, eps,
                              act=j_norms.silu if silu else None,
                              pre_bias=jnp.asarray(pre) if use_pre else None)
    xt = _t(x)
    if fmt != "NHWC":
        xt = xt.permute(0, 3, 1, 2)
        assert xt.is_contiguous(memory_format=torch.channels_last)
        if fmt == "NCHW":
            xt = xt.contiguous()
    got = t_norms.group_norm(xt, _t(scale), _t(bias), 32, eps,
                             act=t_norms.silu if silu else None,
                             data_format="NHWC" if fmt == "NHWC" else "NCHW",
                             pre_bias=_t(pre) if use_pre else None)
    if fmt != "NHWC":
        got = got.permute(0, 2, 3, 1)
    _close(got, want)


def test_group_norm_resolves_groups():
    """12 channels do not split into 32 groups: both fall back to 12."""
    assert t_norms.resolve_num_groups(12, 32) == j_norms.resolve_num_groups(12, 32) == 12
    x, scale, bias, _ = _gn_inputs(2, 4, 4, 12)
    _close(t_norms.group_norm(_t(x), _t(scale), _t(bias), 32),
           j_norms.group_norm(jnp.asarray(x), scale, bias, 32))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the Pallas GroupNorm kernel in interpret mode on the CPU."""
    orig = group_norm_pallas.pl.pallas_call
    monkeypatch.setattr(group_norm_pallas.pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("shape", [(8, 4, 4, 128), (8, 32, 32, 128)],
                         ids=["single", "chunked"])
def test_group_norm_plain_matches_pallas_kernel(interpret_pallas, shape):
    """The port's plain version (what the CUDA kernel is held to) against
    the Pallas kernel on its HWNC view, single-pass and chunked, with the
    pre-bias and fused SiLU. The kernel's variance is E[x^2] - mean^2 (the
    port's plain version subtracts the mean first): 1e-4."""
    n, h, w, c = shape
    x, scale, bias, pre = _gn_inputs(n, h, w, c)
    want = group_norm_pallas.group_norm_hwnc(
        jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)), jnp.asarray(scale),
        jnp.asarray(bias), 32, 1e-5, fuse_silu=True, pre_bias=jnp.asarray(pre))
    got = t_norms.group_norm_plain(_t(x).permute(0, 3, 1, 2), _t(scale), _t(bias), 32,
                                   1e-5, t_norms.silu, "NCHW", _t(pre))
    _close(got.permute(2, 3, 0, 1), want, dict(rtol=1e-4, atol=1e-4))


def test_layer_and_instance_norm():
    rng = np.random.RandomState(1)
    x = (2 * rng.randn(2, 7, 48) + 0.5).astype(np.float32)
    s, b = (1 + 0.1 * rng.randn(48)).astype(np.float32), rng.randn(48).astype(np.float32)
    _close(t_norms.layer_norm(_t(x), _t(s), _t(b)), j_norms.layer_norm(x, s, b))
    x4 = (2 * rng.randn(2, 5, 6, 8) + 0.5).astype(np.float32)
    _close(t_norms.instance_norm_2d(_t(x4)), j_norms.instance_norm_2d(jnp.asarray(x4)))


def test_norm_stats_precision_switch():
    t_norms.set_norm_stats_precision("native")
    try:
        assert t_norms._stats_dtype(torch.zeros(1, dtype=torch.bfloat16)) == torch.bfloat16
    finally:
        t_norms.set_norm_stats_precision("fp32")
    assert t_norms._stats_dtype(torch.zeros(1, dtype=torch.bfloat16)) == torch.float32
    with pytest.raises(ValueError):
        t_norms.set_norm_stats_precision("fp16")


# ------------------------------------------------------------------ attention
def _qkv(shape_q, shape_kv, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32))


def test_sdpa_matches():
    q, k, v = _qkv((2, 4, 64, 32), (2, 4, 4, 32))
    _close(t_attn.sdpa(_t(q), _t(k), _t(v)), j_attn.sdpa(q, k, v))


@pytest.mark.parametrize("d", [32, 512])
def test_flash_attention_cpu_matches_jax_sdpa(d):
    """On CPU `_attend` runs dense sdpa in JAX; the port's flash wrapper runs
    its plain version: the same attention, another rounding order."""
    q, k, v = _qkv((2, 2, 256, d), (2, 2, 256, d))
    _close(t_attn.flash_attention(_t(q), _t(k), _t(v)), j_attn.sdpa(q, k, v))


@pytest.mark.parametrize("b,n,heads,d", [(2, 256, 8, 32), (1, 256, 16, 32)])
def test_flash_attention_packed_matches_pallas(b, n, heads, d):
    q, k, v = _qkv((b, n, heads * d), (b, n, heads * d))
    want = j_attn._flash_packed_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        heads, interpret=True)
    _close(t_attn.flash_attention_packed(_t(q), _t(k), _t(v), heads), want)


def test_tiny_ctx_attention_packed():
    q, k, v = _qkv((2, 256, 8 * 32), (2, 4, 8 * 32))
    _close(t_attn.tiny_ctx_attention_packed(_t(q), _t(k), _t(v), 8),
           j_attn.tiny_ctx_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), 8))


def test_attention_impl_switch():
    assert t_attn.attention_impl() == "dense"
    for mode in ("flash", "flash_packed", "dense"):
        t_attn.set_attention_impl(mode)
        assert t_attn.attention_impl() == mode
    with pytest.raises(ValueError):
        t_attn.set_attention_impl("xformers")


def test_kernel_wrappers_take_cpu_tensors_only_as_plain():
    """The kernel entry points refuse CPU tensors rather than run them."""
    x = torch.zeros(2, 32, 4, 4)
    with pytest.raises(ValueError):
        t_norms.group_norm_kernel(x, torch.ones(32), torch.zeros(32), 32, 1e-5, True)
