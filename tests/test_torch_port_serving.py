"""The port's serving path (`ealdm_torch/serving.py`,
`ealdm_torch.scripts.export_sampler`) on the CPU, float32: the exported
conditioning / DDIM-step / decode programs against JAX's `export_sampler`
program on TINY's twin at 16^2 (`configs/smoke/stdiff_micro.yaml`) with
JAX's draws replayed;
the artifact served by a process that never imports `ealdm_torch.models`;
`SamplerService`'s padding and order; the headerless and wrong-device
artifacts; a checkpoint swapped in without re-export; the kernel launches
as dispatcher operators (opcheck, and their names in an exported graph);
`maybe_initialize_distributed`. The artifact is the export_sampler CLI's,
of a run dir the port's CheckpointManager wrote.
"""
import json
import pathlib
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import serving
from ealdm_torch.config import model_from_config as t_model_from_config
from ealdm_torch.inference import sample_images
from ealdm_torch.ops import attention as t_attn
from ealdm_torch.ops import norms as t_norms
from ealdm_tpu.serving import export_sampler as j_export_sampler
from tests.test_torch_port_models import mixed_batch

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
XLA = {"xla_backend_optimization_level": 0}
B, STEPS, LATENT = 2, 3, (8, 8, 4)


@pytest.fixture(autouse=True)
def _gc_paused():
    from tests.test_torch_port_cond import gc_paused

    with gc_paused():
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A micro run dir the port's CheckpointManager wrote (TINY's twin at
    16^2, `configs/smoke/stdiff_micro.yaml`): its EMA shadow holds JAX's
    seeded weights, its parameters others; the export_sampler CLI's
    artifact of it (batch 2, 3 DDIM steps: 4 on the uniform grid)."""
    from ealdm_torch.scripts import export_sampler
    from tests.test_torch_port_cli import MICRO, _port_run_dir, pair_from_yaml

    root = tmp_path_factory.mktemp("serving")
    mixed = mixed_batch(B, 16, seed=4)
    _, jm, variables, tm = pair_from_yaml(MICRO, {"img": mixed["img"], "mixed": mixed}, 11)
    logdir, state = _port_run_dir(root, tm)
    with torch.no_grad():  # the shadow is JAX's weights, the parameters are not
        for k, p in state.params.items():
            state.ema.shadow[k].copy_(p)
            p.add_(0.02)
    from ealdm_torch.training import CheckpointManager

    CheckpointManager(str(logdir / "checkpoints"), monitor=None).save_last(state, 8)
    path = str(root / "sampler.bin")
    _, seconds = export_sampler.main(["-r", str(logdir), "-o", path, "--batch_size", str(B),
                                      "--steps", str(STEPS), "--device", "cpu"])
    return dict(jm=jm, variables=variables, state=state, mixed=mixed, path=path,
                seconds=seconds, meta=serving.read_artifact(path)[0]["config"])


def _draws(rng, steps, shape):
    """JAX ddim_sample's x_T and step noise [S, ...] for key `rng`."""
    rest, init = jax.random.split(rng)
    x_T = np.asarray(jax.random.normal(init, shape))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[1], shape))
                      for k in jax.random.split(rest, steps)])
    return x_T, noise


def _mixed_t(mixed):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in mixed.items()}


def _direct(weights, mixed, seed):
    """`sample_images(..., hoist=False)` of the micro model with `weights`."""
    from ealdm_torch.config import load_config
    from ealdm_torch.scripts._common import load_sampling_weights
    from tests.test_torch_port_cli import MICRO

    m, _ = t_model_from_config(load_config([str(MICRO)])["model"], device="cpu")
    load_sampling_weights(m.eval(), {"params": weights, "ema": None})
    g = torch.Generator().manual_seed(seed)
    return sample_images(m, B, LATENT, steps=STEPS, eta=1.0, guidance_scale=2.0,
                         mixed=_mixed_t(mixed), hoist=False, generator=g, device="cpu")[0]


_SERVE = """
import sys, numpy as np, torch
from ealdm_torch import serving
assert "ealdm_torch.models" not in sys.modules
fn = serving.load_exported(sys.argv[1], device="cpu")
inputs = dict(np.load(sys.argv[2]))
mixed = {k: torch.from_numpy(inputs[k]) for k in fn.meta["mixed_keys"]}
out = {"replayed": fn(mixed, torch.from_numpy(inputs["x_T"]),
                      torch.from_numpy(inputs["noise"])).numpy()}


def serve(seed, n):
    svc = serving.SamplerService(fn, batch_size=2, seed=seed, device="cpu")
    for i in range(n):
        svc.submit({k: v[i % 2].numpy() for k, v in mixed.items()})
    return np.stack(svc.serve_pending())


out["served"] = serve(5, 3)
fn.load_state_dict(torch.load(sys.argv[3], weights_only=True))  # no re-export
out["swapped"] = serve(9, 2)
np.savez(sys.argv[4], **out)
assert "ealdm_torch.models" not in sys.modules
print(sorted(m for m in sys.modules if m.startswith("ealdm_torch")))
"""


def test_artifact_serves_in_a_fresh_process_as_jax_and_the_direct_program(run, tmp_path):
    """A process with torch and the op registry only: the artifact on JAX's
    draws equals JAX's `export_sampler` program on the same weights;
    `SamplerService` (3 requests at batch 2) gives `sample_images(...,
    hoist=False)`'s images at its seed; and after the checkpoint's other
    parameters are swapped in, that program's with them."""
    rng = jax.random.PRNGKey(7)
    x_T, noise = _draws(rng, run["meta"]["steps"], (B, *LATENT))
    inputs, params, out = (str(tmp_path / n) for n in ("in.npz", "params.pt", "out.npz"))
    np.savez(inputs, x_T=x_T, noise=noise, **run["mixed"])
    torch.save(run["state"].params, params)
    proc = subprocess.Popen([sys.executable, "-c", _SERVE, run["path"], inputs, params, out],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:  # JAX's program and the direct ones meanwhile
        exported, _ = j_export_sampler(run["jm"], run["variables"], batch_size=B,
                                       latent_shape=LATENT, steps=STEPS, image_size=16)
        mixed_j = {k: jnp.asarray(v) for k, v in run["mixed"].items()}
        call = jax.jit(exported.call).lower(run["variables"], mixed_j, rng).compile(XLA)
        want = np.asarray(call(run["variables"], mixed_j, rng))
        direct = _direct(run["state"].ema.shadow, run["mixed"], 5).numpy()
        swapped = _direct(run["state"].params, run["mixed"], 9).numpy()
    finally:
        stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert "ealdm_torch.models" not in stdout
    got = np.load(out)
    assert got["replayed"].shape == (B, 16, 16, 3) and got["served"].shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got["replayed"], want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got["served"][:2], direct, rtol=0,
                               atol=1e-5 * np.abs(direct).max())
    assert np.isfinite(got["served"][2]).all()  # the padded second batch
    np.testing.assert_allclose(got["swapped"], swapped, rtol=0,
                               atol=1e-5 * np.abs(swapped).max())
    assert np.abs(swapped - direct).max() > 1e-2


def test_sampler_service_batches_and_pads():
    """3 requests at batch 2: two batches, the second padded with its last
    request; outputs in submission order."""
    seen = []

    def program(batch, x_T, noise):
        seen.append((batch["time"][:, 0].clone(), x_T.shape, noise.shape))
        return batch["img"] + 0 * x_T.sum()

    svc = serving.SamplerService(program, batch_size=2, seed=0, latent_shape=LATENT, steps=4,
                                 device="cpu")
    reqs = [{k: v[0] for k, v in mixed_batch(1, 16, seed=s).items()} for s in range(3)]
    for i, r in enumerate(reqs):
        assert svc.submit(r) == i
    assert svc.pending() == 3
    outs = svc.serve_pending()
    assert svc.pending() == 0 and len(outs) == 3
    for o, r in zip(outs, reqs):
        np.testing.assert_array_equal(o, r["img"])
    assert [list(t.numpy()) for t, _, _ in seen] == [
        [reqs[0]["time"][0], reqs[1]["time"][0]], [reqs[2]["time"][0]] * 2]
    assert all(x == (2, *LATENT) and n == (4, 2, *LATENT) for _, x, n in seen)


def _direct_decode(run, z):
    from ealdm_torch.config import load_config
    from ealdm_torch.scripts._common import load_sampling_weights
    from tests.test_torch_port_cli import MICRO

    m, _ = t_model_from_config(load_config([str(MICRO)])["model"], device="cpu")
    load_sampling_weights(m.eval(), run["state"].state_dict())
    return m.decode_first_stage(z).numpy()


def test_header_headerless_and_device(run, tmp_path):
    header, payload = serving.read_artifact(run["path"])
    assert header["format"] == serving.FORMAT and header["device"] == "cpu"
    assert header["torch_version"] == torch.__version__ and header["fn_name"] == "sample"
    assert [n for n, _ in header["programs"]] == ["conditioning", "step", "decode"]
    assert sum(n for _, n in header["programs"]) == len(payload)
    assert header["config"]["latent_shape"] == list(LATENT) and run["seconds"] > 0

    # a headerless file: one program's torch.export.save bytes
    n_cond, n_step, n_dec = (n for _, n in header["programs"])
    raw = tmp_path / "decode.pt2"
    raw.write_bytes(payload[n_cond + n_step:])
    assert serving.read_artifact(str(raw))[0] == {}
    decode = serving.load_exported(str(raw), device="cpu")
    z = torch.randn(B, *LATENT)
    with torch.no_grad():
        np.testing.assert_allclose(decode(z).numpy(), _direct_decode(run, z), rtol=0,
                                   atol=1e-6)

    header["device"] = "cuda"  # as if traced on the card
    blob = json.dumps(header).encode()
    moved = tmp_path / "cuda.bin"
    moved.write_bytes(serving._MAGIC + struct.pack("<Q", len(blob)) + blob + payload)
    with pytest.raises(ValueError, match="traced on cuda"):
        serving.load_exported(str(moved), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.load_exported(run["path"])


def test_maybe_initialize_distributed(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("EALDM_DIST_TIMEOUT", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert serving.maybe_initialize_distributed() is False
    calls = {}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.update(kw))
    assert serving.maybe_initialize_distributed(device="cpu") is True
    assert calls == {"backend": "gloo", "init_method": "env://", "world_size": 2, "rank": 1}
    # the backend rule: nccl only where each rank of a host has a card
    n = torch.cuda.device_count()
    assert serving.distributed_backend("cpu", 1) == "gloo"
    if n:
        assert serving.distributed_backend("cuda", n) == "nccl"
        assert serving.distributed_backend("cuda", n + 1) == "gloo"
    elif not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serving.maybe_initialize_distributed()


@pytest.fixture
def plain_kernels(monkeypatch):
    """The launches replaced by their plain versions, so the operators run
    on the CPU."""
    from tests.test_torch_port_grads import _plain_group_norm_kernel

    monkeypatch.setattr(t_norms, "group_norm_kernel", _plain_group_norm_kernel)
    monkeypatch.setattr(t_attn, "flash_attention_kernel", t_attn.flash_attention_plain)

    def packed(q, k, v, heads, scale=None):
        o = t_attn.flash_attention_plain(*(t_attn._split_heads(t, heads) for t in (q, k, v)),
                                         scale)
        return o.transpose(1, 2).reshape(q.shape)

    monkeypatch.setattr(t_attn, "flash_attention_packed_kernel", packed)


def test_kernel_operators_export_by_name(plain_kernels):
    """opcheck of the three operators (the fakes' shapes, dtypes and
    strides against the launch's), and an exported graph that names them."""
    rng = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 8, 16, generator=rng) for _ in range(3))
    qp = torch.randn(2, 8, 2 * 12, generator=rng)
    x = torch.randn(2, 32, 4, 4, generator=rng).contiguous(memory_format=torch.channels_last)
    cases = [(torch.ops.ealdm.flash_attention.default, (q, k, v, None)),
             (torch.ops.ealdm.flash_attention.default, (q, k, v, 0.3)),
             (torch.ops.ealdm.flash_attention_packed.default, (qp, qp, qp, 2, None)),
             (torch.ops.ealdm.group_norm.default, (x, torch.ones(32), torch.zeros(32),
                                                   torch.randn(2, 32), 8, 1e-5, True))]
    for op, args in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))

    class M(torch.nn.Module):
        def forward(self, q, k, v, x):
            o = t_attn.FlashAttention.apply(q, k, v, None)
            y = t_norms.GroupNormKernel.apply(x, torch.ones(32), torch.zeros(32), None, 8, 1e-5,
                                              False)
            return o, y

    ep = serving.export_fn(M(), q, k, v, x)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {"ealdm.flash_attention.default", "ealdm.group_norm.default"} <= targets
    o, y = ep.module()(q, k, v, x)
    np.testing.assert_allclose(o.numpy(), t_attn.flash_attention_plain(q, k, v).numpy(),
                               rtol=0, atol=1e-6)
    assert y.stride() == x.stride()
