"""The JAX package's orbax checkpoints in the port (`utils/zstd.py` over
`native/zstd.cpp`, `utils/ocdbt.py`, `utils/zarr2.py`,
`training/orbax_format.py`, the train-state layouts of
`utils/flax_import.py`, `training/checkpoint.py`), on the CPU against
orbax, tensorstore and the `zstandard` package as oracles:

1. zstd frames of zeros, random, smooth and bfloat16 floats, text, a leaf
   over 128 KiB and one of several MB (tensorstore's zarr writer over a
   memory:// store, and `zstandard` at other levels, with checksums and
   streamed) decode to their bytes; CRC-32C's known vectors; a corrupted
   frame (its XXH64 content checksum), an unknown block type and a
   corrupted node raise;
2. OCDBT: `list()` and every `read()` equal tensorstore's for a store of
   nodes of 256 bytes (height >= 2, inline and indirect values, several
   data files) and for checkpoints the JAX package wrote (the root manifest
   and `ocdbt.process_0`);
3. zarr v2 arrays of each dtype, 0-d, a chunk grid and an absent chunk;
4. the micro LDM's TrainState that JAX trained and saved (with and
   without optax.MultiSteps) imports into the port's state to the bit, and
   the next step on the same batch and draws matches JAX's (loss and
   grad_norm 1e-5 relative, the moments within 1e-4 of each tensor's
   largest plus 1e-6 of the optimizer's largest);
5. the same for `configs/smoke/autoencoder_tiny.yaml`'s VAETrainState;
6. the port's writing restores in JAX's `CheckpointManager` to the bit,
   with its latest and best step;
7. at full width on the meta device, the flagship's TrainState and the
   kl-f8 first stage's VAETrainState map onto `jax.eval_shape` of JAX's,
   leaf for leaf with shapes and dtypes, and `state_dict_to_flax` inverts
   `flax_to_state_dict`; seeded weights keep the LSTMs' bias_ih at 0, and
   the writer refuses one that is not;
8. `ealdm_torch.main -r` on the LDM's and the first stage's logdirs the
   JAX package wrote, and `sample_diffusion -r` on the LDM's;
9. the committed fixture `ealdm_torch/data/jax_ckpt_micro.tar.xz`: its
   leaves decode to the digests it records, and a fresh JAX run gives its
   loss and leaves (float noise across XLA's thread counts aside: the
   parameters and EMA within 4 learning rates, the moments within 1e-5 of
   the optimizer's largest).
"""
import functools
import hashlib
import json
import os
import pathlib
import shutil
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard

import ealdm_torch.main as t_main
from ealdm_torch import config as t_config
from ealdm_torch import training as t_training
from ealdm_torch.models import stdiff as t_stdiff_model
from ealdm_torch.training import orbax_format
from ealdm_torch.training.checkpoint import CheckpointManager, write_jax_checkpoint
from ealdm_torch.utils import flax_import, ocdbt, zarr2, zstd
from tests import jax_ckpt_fixture as fx
from tests.test_torch_port_cond import gc_paused
from tests.test_torch_port_main import _replayed_dropout

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
XLA = {"xla_backend_optimization_level": 0}
AE_TINY = REPO / "configs" / "smoke" / "autoencoder_tiny.yaml"


def _kv(root):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()


def _same_as_tensorstore(root):
    kv = _kv(root)
    keys = sorted(kv.list().result())
    reader = ocdbt.OcdbtReader(str(root))
    assert reader.list() == keys
    for k in keys:
        assert bytes(reader.read(k)) == kv.read(k).result().value, k
    return reader


# ------------------------------------------------------------------ 1 zstd
def _payload(kind):
    rng = np.random.RandomState(0)
    smooth = np.cumsum(rng.randn(300_000).astype(np.float32) * 1e-3).astype(np.float32)
    return {
        "zeros": bytes(200_000),
        "random_f32": rng.randn(60_000).astype(np.float32).tobytes(),
        "smooth_f32": smooth.tobytes(),
        "smooth_bf16": (smooth.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "text": b"the quick brown fox jumps over the lazy dog; " * 4000,
        "over_128k": rng.randn(50_000).astype(np.float32).round(3).tobytes(),
        "multi_mb": rng.randn(1_000_000).astype(np.float32).round(2).tobytes(),
        "empty": b"",
    }[kind]


def _tensorstore_frame(data):
    """The zstd frame tensorstore's zarr driver writes for a uint8 chunk."""
    spec = {"driver": "zarr", "kvstore": {"driver": "memory"},
            "metadata": {"dtype": "|u1", "shape": [max(len(data), 1)],
                         "chunks": [max(len(data), 1)], "compressor": {"id": "zstd", "level": 1}},
            "create": True}
    arr = ts.open(spec).result()
    arr.write(np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)).result()
    frame = arr.kvstore.read("0").result().value
    return frame, (data or b"\0")


@pytest.mark.parametrize("kind", ["zeros", "random_f32", "smooth_f32", "smooth_bf16", "text",
                                  "over_128k", "multi_mb", "empty"])
def test_zstd_decodes_real_frames(kind):
    data = _payload(kind)
    frame, want = _tensorstore_frame(data)
    assert zstd.decompress(frame) == want
    out = np.empty(len(want), np.uint8)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == want
    for level, kw in ((12, {"write_checksum": True}), (-3, {"write_content_size": False}),
                      (3, {})):
        assert zstd.decompress(zstandard.ZstdCompressor(level=level, **kw).compress(data)) == data
    cobj = zstandard.ZstdCompressor(level=6, write_checksum=True).compressobj()
    streamed = cobj.compress(data[:len(data) // 2]) + cobj.compress(data[len(data) // 2:])
    assert zstd.decompress(streamed + cobj.flush()) == data


def test_crc32c_known_vectors():
    # RFC 3720 B.4's CRC-32C vectors
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert zstd.crc32c(bytes(range(32))) == 0x46DD794E
    assert zstd.crc32c(b"6789", zstd.crc32c(b"12345")) == 0xE3069283


def test_corrupted_frames_and_nodes_raise(tmp_path):
    data = _payload("text")
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0xFF  # the content checksum
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    raw = bytearray(zstandard.ZstdCompressor(level=1, write_content_size=False).compress(data))
    assert raw[4] == 0  # no content size, a window descriptor: the first block at byte 6
    raw[6] |= 0x06  # block type 3
    with pytest.raises(zstd.ZstdError, match="block type 3"):
        zstd.decompress(bytes(raw))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"\x28\xb5\x2f\xfd\x00")
    root = tmp_path / "db"
    ocdbt.write_ocdbt(str(root), {b"a": b"x" * 500, b"b": b"y"})
    node = next((root / "d").iterdir())
    buf = bytearray(node.read_bytes())
    buf[-10] ^= 1  # inside the last node's body
    node.write_bytes(bytes(buf))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.OcdbtReader(str(root))


# ----------------------------------------------------------------- 2 OCDBT
def test_ocdbt_reads_a_deep_store(tmp_path):
    root = tmp_path / "deep"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.RandomState(0)
    for j in range(3):  # one data file a commit
        with ts.Transaction() as txn:
            for i in range(80):
                kv.with_transaction(txn)[f"g{j}/key{i:04d}"] = rng.bytes(rng.randint(0, 48))
    reader = _same_as_tensorstore(root)
    assert reader.height >= 2 and reader.num_keys == 240
    assert len(list((root / "d").iterdir())) >= 3
    inline = [k for k in reader.list() if len(reader.read(k)) <= 16]
    assert inline and len(inline) < 240


def test_ocdbt_writer_reads_back_in_tensorstore(tmp_path):
    rng = np.random.RandomState(1)
    items = {f"k{i:04d}/{'x' * (i % 9)}".encode(): rng.bytes(rng.randint(0, 300))
             for i in range(400)}
    items[b"big"] = np.arange(50_000, dtype=np.float32)
    ocdbt.write_ocdbt(str(tmp_path / "w"), items, max_inline_value_bytes=50,
                      max_decoded_node_bytes=600)
    reader = _same_as_tensorstore(tmp_path / "w")
    assert reader.height >= 2


# ------------------------------------------------------------------ 3 zarr
def test_zarr_arrays_equal_tensorstore(tmp_path):
    import ml_dtypes

    root = tmp_path / "zarr"
    rng = np.random.RandomState(2)
    cases = {"f4": ("<f4", (5, 7), (5, 7)), "f2": ("<f2", (9,), (4,)), "i4": ("<i4", (), ()),
             "i8": ("<i8", (3, 4, 5), (2, 3, 2)), "u4": ("<u4", (6,), (6,)),
             "b1": ("|b1", (4, 4), (3, 3)), "bf16": ("bfloat16", (33, 65), (16, 64)),
             "absent": ("<f4", (8, 8), (4, 4)), "raw": ("<f4", (3, 3), (3, 3))}
    want = {}
    for name, (dt, shape, chunks) in cases.items():
        comp = None if name == "raw" else {"id": "zstd", "level": 1}
        arr = ts.open({"driver": "zarr",
                       "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                                   "path": f"{name}/"},
                       "metadata": {"dtype": dt, "shape": list(shape), "chunks": list(chunks),
                                    "compressor": comp,
                                    "fill_value": 0 if name == "absent" else None},
                       "create": True}).result()
        if dt == "bfloat16":
            v = rng.randn(*shape).astype(ml_dtypes.bfloat16)
        elif dt == "|b1":
            v = rng.rand(*shape) > 0.5
        else:
            v = (np.asarray(rng.randn(*shape)) * 100).astype(np.dtype(dt))
        if name == "absent":
            arr[0:4, 4:8].write(v[0:4, 4:8]).result()
        else:
            arr.write(v).result()
        want[name] = arr.read().result()
    reader = ocdbt.OcdbtReader(str(root))
    assert b"absent/0.0" not in reader.list()
    for name in cases:
        got = zarr2.read_into(reader, name)
        if got.dtype == torch.bfloat16:
            got, w = got.view(torch.int16).numpy(), want[name].view(np.int16)
        else:
            got, w = got.numpy(), want[name]
        assert got.dtype == w.dtype and got.shape == w.shape, name
        np.testing.assert_array_equal(got, w, err_msg=name)
    with pytest.raises(zarr2.ZarrError, match="dtype"):
        zarr2.ArraySpec("x", {"zarr_format": 2, "shape": [1], "chunks": [1], "dtype": "<c8"})
    with pytest.raises(zarr2.ZarrError, match="compressor"):
        zarr2.ArraySpec("x", {"zarr_format": 2, "shape": [1], "chunks": [1], "dtype": "<f4",
                              "compressor": {"id": "blosc"}})


# ------------------------------------------------------------- the JAX runs
def _jax_leaves(state):
    """{orbax path (int sequence keys): numpy leaf} of a JAX state."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(state)):
        keys = []
        for k in path:
            if isinstance(k, (jax.tree_util.SequenceKey, jax.tree_util.FlattenedIndexKey)):
                keys.append(getattr(k, "idx", getattr(k, "key", None)))
            else:
                keys.append(getattr(k, "key", getattr(k, "name", None)))
        out[tuple(keys)] = np.asarray(v)
    return out


def _micro_logdir(root, state, step, monitor_value=0.5):
    """A logdir as the JAX `main.py` leaves it: configs/ and checkpoints/."""
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager

    (root / "configs").mkdir(parents=True)
    shutil.copy(fx.MICRO, root / "configs" / "2026-01-01T00-00-00-project.yaml")
    mgr = JaxManager(str(root / "checkpoints"), monitor=fx.MONITOR)
    mgr.save(step, jax.device_get(state), metrics={fx.MONITOR: monitor_value})
    mgr.close()
    return root


_RUNS = {}


def _ldm(acc, tmp_path_factory):
    """JAX's micro LDM (accumulate_grad_batches `acc`): its steps, saved as
    a JAX logdir; the next step's draws and metrics and the state after
    it. Built once a module."""
    if acc not in _RUNS:
        steps = 2 if acc == 1 else 3  # MultiSteps: one update, a half-full accumulator
        masks_fn = next((r["run"].masks_fn for r in _RUNS.values()), None)
        with gc_paused():
            run = fx.MicroRun(accumulate=acc, masks_fn=masks_fn)
            for i in range(1, steps + 1):
                run.train(i)
            saved = run.state
            draws = run.draws(steps + 1)
            metrics = run.train(steps + 1)
        logdir = _micro_logdir(tmp_path_factory.mktemp(f"jax_micro_{acc}"), saved, steps)
        _RUNS[acc] = dict(acc=acc, run=run, saved=saved, steps=steps, draws=draws,
                          metrics=metrics, after=run.state, logdir=logdir)
    return _RUNS[acc]


@pytest.fixture(scope="module", params=[1, 2], ids=["adamw", "multisteps"])
def ldm_run(request, tmp_path_factory):
    return _ldm(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def adamw_run(tmp_path_factory):
    return _ldm(1, tmp_path_factory)


def _port_ldm(acc):
    cfg = t_config.load_config([str(fx.MICRO)])
    model, _ = t_config.model_from_config(cfg["model"], device="cpu")
    opt = t_training.make_optimizer(fx.LR, accumulate_grad_batches=acc)
    state, _ = t_training.init_train_state(model, opt, device="cpu")
    return model, opt, state


def _torch_batch(b):
    return {"img": torch.from_numpy(b["img"]),
            "mixed": {k: torch.from_numpy(v) for k, v in b["mixed"].items()}}


def _port_step(model, opt, state, batch, draws):
    """One port step with JAX's t, noise and dropout masks replayed."""
    step = t_training.make_train_step(model, opt, remat="none", device="cpu")
    mp = pytest.MonkeyPatch()
    model.training_loss = functools.partial(
        type(model).training_loss, model, t=torch.from_numpy(np.array(draws["t"])).long(),
        noise=torch.from_numpy(np.array(draws["noise"])))
    masks = [np.array(m) for m in draws["masks"]]
    mp.setattr(t_stdiff_model, "dropout", _replayed_dropout(masks))
    try:
        return step(state, _torch_batch(batch), torch.Generator().manual_seed(0))
    finally:
        del model.training_loss
        mp.undo()
        assert not masks, "a JAX dropout site was not replayed"


def _port_leaves(state, model):
    """{orbax path: numpy leaf} of a port state of `model` in JAX's layout."""
    out = {}
    for path, v in flax_import.export_state(
            flax_import.state_layout(state.state_dict(), model)).items():
        if callable(v):
            out[path] = v().numpy()
        elif v is not None and not isinstance(v, tuple):
            out[path] = np.asarray(v)
    return out


def _moments_close(got, want):
    """Adam moments within 1e-4 of each tensor's largest plus 1e-6 of the
    optimizer's largest (the VAE training tests' rule)."""
    top = max(float(np.abs(w).max()) for w in want.values() if w.size)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max(initial=0)) + 1e-6 * top,
                                   err_msg=str(k))


def _is_moment(path):
    return any(k in ("mu", "nu", "acc_grads") for k in path if isinstance(k, str))


# ------------------------------------------------------------- 4 LDM state
def test_ldm_state_imports_to_the_bit_and_steps_as_jax(ldm_run):
    model, opt, state = _port_ldm(ldm_run["acc"])
    ckpt = str(ldm_run["logdir"] / "checkpoints")
    CheckpointManager(ckpt, monitor=fx.MONITOR).restore_last(state, model)
    want = _jax_leaves(ldm_run["saved"])
    got = _port_leaves(state, model)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if g.dtype == np.float64:  # the EMA decay, a Python float in the port
            g = g.astype(w.dtype)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert state.step == ldm_run["steps"]
    # the step dir restores the same
    other, _, from_step = _port_ldm(ldm_run["acc"])
    CheckpointManager(ckpt, monitor=fx.MONITOR).restore(from_step, step=ldm_run["steps"],
                                                        model=other)
    for k, p in from_step.params.items():
        assert torch.equal(p, state.params[k]), k

    state, metrics = _port_step(model, opt, state, fx.batch(ldm_run["steps"] + 1),
                                ldm_run["draws"])
    jm = ldm_run["metrics"]
    for k in ("loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    after_j, after_t = _jax_leaves(ldm_run["after"]), _port_leaves(state, model)
    _moments_close({p: v for p, v in after_t.items() if _is_moment(p)},
                   {p: v for p, v in after_j.items() if _is_moment(p)})
    assert state.opt_state.count == int(after_j[(2, "gradient_step")] if ldm_run["acc"] > 1
                                        else after_j[(2, "inner_states", "train",
                                                      "inner_state", 0, "count")])


def test_import_names_the_leaf_it_cannot_place(ldm_run, tmp_path):
    """A JAX tree that trains what the port freezes, and a state without
    MultiSteps against one with it, raise naming a leaf."""
    model, opt, _ = _port_ldm(ldm_run["acc"])
    for p in model.cond_stage_model.parameters():  # cond_stage_trainable: false
        p.requires_grad_(False)
    state = t_training.init_train_state(model, opt, device="cpu")[0]
    ckpt = str(ldm_run["logdir"] / "checkpoints")
    with pytest.raises(ValueError, match="cond_stage_model"):
        CheckpointManager(ckpt, monitor=None).restore_last(state, model)
    other_model, _, other = _port_ldm(3 - ldm_run["acc"])
    with pytest.raises(ValueError, match="no counterpart in the port|the JAX tree lacks"):
        CheckpointManager(ckpt, monitor=None).restore_last(other, other_model)
    with pytest.raises(ValueError, match="give the model"):
        CheckpointManager(ckpt, monitor=None).restore_last(other)


# ------------------------------------------------------------- 6 the writer
def test_jax_restores_what_the_port_writes(ldm_run, tmp_path):
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager

    model, _, state = _port_ldm(ldm_run["acc"])
    CheckpointManager(str(ldm_run["logdir"] / "checkpoints"), monitor=None).restore_last(
        state, model)
    out = tmp_path / "written"
    nbytes = write_jax_checkpoint(str(out), state, ldm_run["steps"], model,
                                  metrics={fx.MONITOR: 0.25})
    assert nbytes > 2 * sum(p.numel() * 4 for p in state.params.values())
    # last/state shares the step's store
    for f in ("manifest.ocdbt", "_METADATA"):
        assert os.path.samefile(out / str(ldm_run["steps"]) / "default" / f,
                                out / "last" / "state" / f)
    template = jax.tree_util.tree_map(jnp.zeros_like, ldm_run["saved"])
    mgr = JaxManager(str(out), monitor=fx.MONITOR)
    assert mgr.latest_step() == ldm_run["steps"] and mgr.best_step() == ldm_run["steps"]
    want = _jax_leaves(ldm_run["saved"])
    # restore (the step dir) on one parameter, restore_last on the other
    restore = mgr.restore if ldm_run["acc"] == 1 else mgr.restore_last
    for restored in (restore(template),):
        got = _jax_leaves(restored)
        assert set(got) == set(want)
        for path, w in want.items():
            assert got[path].dtype == w.dtype, path
            np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    mgr.close()
    port = CheckpointManager(str(out), monitor=fx.MONITOR)
    assert port.latest_step() == ldm_run["steps"] and port.best_step() == ldm_run["steps"]
    # a tree through the plain writer and reader
    tree = [np.int32(3), {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": None},
            (), 0.125]
    orbax_format.write_orbax_tree(str(tmp_path / "tree"), tree)
    back = orbax_format.read_orbax_tree(str(tmp_path / "tree"))
    assert back[0] == 3 and back[1]["b"] is None and back[2] == () and back[3] == 0.125
    np.testing.assert_array_equal(back[1]["a"], tree[1]["a"])


def test_a_scheduled_optimizer_round_trips(adamw_run, tmp_path):
    """Under an LR schedule optax keeps the schedule's count: the port
    writes it from the optimizer it is given, JAX restores that with a
    scheduled template, and the port reads it back as its count."""
    from ealdm_tpu.training import TrainState as JState
    from ealdm_tpu.training import make_optimizer as j_make_optimizer
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager

    model, _, state = _port_ldm(1)
    CheckpointManager(str(adamw_run["logdir"] / "checkpoints"), monitor=None).restore_last(
        state, model)
    out = str(tmp_path / "scheduled")
    write_jax_checkpoint(out, state, adamw_run["steps"], model,
                         t_training.make_optimizer(fx.LR, schedule_fn=lambda s: 1.0))
    saved = adamw_run["saved"]
    j_opt = j_make_optimizer(fx.LR, saved.params, schedule_fn=lambda s: 1.0)
    template = jax.tree_util.tree_map(jnp.zeros_like, JState(
        step=saved.step, params=saved.params, opt_state=j_opt.init(saved.params),
        ema=saved.ema))
    mgr = JaxManager(out, monitor=None)
    got = _jax_leaves(mgr.restore_last(template))
    mgr.close()
    count = (2, "inner_states", "train", "inner_state", 2, "count")
    assert got.pop(count) == state.opt_state.count == adamw_run["steps"]
    want = _jax_leaves(saved)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    _, _, back = _port_ldm(1)
    CheckpointManager(out, monitor=None).restore_last(back, model)
    assert back.step == state.step and back.opt_state.count == state.opt_state.count
    for k, p in state.opt_state.mu.items():
        assert torch.equal(back.opt_state.mu[k], p), k


# ------------------------------------------------------------- 5 VAE state
@pytest.fixture(scope="module")
def vae_run(tmp_path_factory):
    from ealdm_tpu.config import instantiate_from_config
    from ealdm_tpu.models.ddpm import build_first_stage as j_build_first_stage
    from ealdm_tpu.training import vae_trainer as j_vae_trainer
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager
    from tests.test_torch_port_cond import flax_shapes_of
    from tests.test_torch_port_models import random_tree

    cfg = t_config.load_config([str(AE_TINY)])
    vae, loss = t_training.build_autoencoder(cfg["model"], device="cpu")
    ae_tree = random_tree(flax_shapes_of(vae), seed=1)["params"]
    loss_tree = random_tree(flax_shapes_of(loss), seed=2)["params"]
    jvae = j_build_first_stage(cfg["model"])
    jloss = instantiate_from_config(cfg["model"]["params"]["lossconfig"])
    lr = 1e-4
    opt_ae, opt_disc = optax.adam(lr, b1=0.5, b2=0.9), optax.adam(lr, b1=0.5, b2=0.9)
    ae_p = jax.tree_util.tree_map(jnp.asarray, ae_tree)
    loss_p = jax.tree_util.tree_map(jnp.asarray, loss_tree)
    state = j_vae_trainer.VAETrainState(
        step=jnp.zeros((), jnp.int32), ae_params=ae_p, loss_params=loss_p,
        opt_ae_state=opt_ae.init(ae_p), opt_disc_state=opt_disc.init(loss_p["discriminator"]))
    rng = np.random.RandomState(3)
    xs = [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    with gc_paused():
        step = j_vae_trainer.make_vae_train_step(jvae, jloss, opt_ae, opt_disc).lower(
            state, {"image": jnp.asarray(xs[0])}, keys[0]).compile(XLA)
        for i in range(2):
            state, _ = step(state, {"image": jnp.asarray(xs[i])}, keys[i])
        saved = state
        after, metrics = step(state, {"image": jnp.asarray(xs[2])}, keys[2])
    logdir = tmp_path_factory.mktemp("jax_vae")  # as the JAX main.py leaves one
    (logdir / "configs").mkdir()
    shutil.copy(AE_TINY, logdir / "configs" / "2026-01-01T00-00-00-project.yaml")
    root = logdir / "checkpoints"
    mgr = JaxManager(str(root), monitor="val/rec_loss")
    mgr.save(2, jax.device_get(saved), metrics={"val/rec_loss": 0.75})
    mgr.close()
    noise = np.asarray(jax.random.normal(keys[2], (2, 16, 16, 2)))
    return dict(cfg=cfg, lr=lr, ckpt=root, logdir=logdir, saved=saved, after=after,
                metrics=jax.device_get(metrics), x=xs[2], noise=noise)


def test_vae_state_imports_to_the_bit_and_steps_as_jax(vae_run, tmp_path):
    from ealdm_tpu.training.checkpoint import CheckpointManager as JaxManager

    vae, loss = t_training.build_autoencoder(vae_run["cfg"]["model"], device="cpu")
    state, opt_ae, opt_disc = t_training.init_vae_train_state(vae, loss, vae_run["lr"],
                                                              device="cpu")
    CheckpointManager(str(vae_run["ckpt"]), monitor="val/rec_loss").restore(state,
                                                                            model=(vae, loss))
    want = _jax_leaves(vae_run["saved"])
    got = _port_leaves(state, (vae, loss))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    assert state.step == 2
    # the port's writing restores in JAX
    out = tmp_path / "vae_written"
    write_jax_checkpoint(str(out), state, 2, (vae, loss))
    restored = JaxManager(str(out), monitor=None).restore_last(
        jax.tree_util.tree_map(jnp.zeros_like, vae_run["saved"]))
    for path, w in _jax_leaves(restored).items():
        np.testing.assert_array_equal(w, want[path], err_msg=str(path))
    # the next step
    step = t_training.make_vae_train_step(vae, loss, opt_ae, opt_disc, device="cpu")
    state, metrics = step(state, {"image": torch.from_numpy(vae_run["x"])},
                          noise=torch.from_numpy(vae_run["noise"]))
    want_m = vae_run["metrics"]
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(np.float64(metrics[k]), np.float64(want_m[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    after_j, after_t = _jax_leaves(vae_run["after"]), _port_leaves(state, (vae, loss))
    _moments_close({p: v for p, v in after_t.items() if _is_moment(p)},
                   {p: v for p, v in after_j.items() if _is_moment(p)})


def test_main_resumes_a_jax_first_stage_run(vae_run, tmp_path):
    """`ealdm_torch.main -r` on the VAE's JAX logdir restores its
    VAETrainState at JAX's step (the JAX `main.py` would restart it)."""
    from ealdm_torch.utils.png import encode_png

    rng = np.random.RandomState(5)
    dots = []
    for split, n in (("train", 2), ("validation", 2)):
        d = tmp_path / split
        d.mkdir()
        for i in range(n):
            (d / f"{i}.png").write_bytes(
                encode_png(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)))
        dots.append(f"data.params.{split}.params.data_root={d}")
    _, vae, state = t_main.main(["-r", str(vae_run["logdir"]), "--device", "cpu", *dots])
    assert state.step == 2
    want = _jax_leaves(vae_run["saved"])
    _, loss = t_training.build_autoencoder(vae_run["cfg"]["model"], device="meta")
    for path, v in _port_leaves(state, (vae, loss)).items():
        np.testing.assert_array_equal(v, want[path], err_msg=str(path))


# ------------------------------------------------------------- 7 full width
def _jax_layout(state_shapes):
    """{path: (kind, shape, dtype)} of a JAX state's shapes: an empty named
    tuple (a masked leaf, an EmptyState) is "none", a bare () "tuple"."""
    leaves = jax.tree_util.tree_leaves_with_path(
        state_shapes, is_leaf=lambda x: x is None or (isinstance(x, tuple) and not x))
    out = {}
    for path, v in leaves:
        keys = tuple(getattr(k, "idx", getattr(k, "key", getattr(k, "name", None)))
                     if not isinstance(k, jax.tree_util.DictKey) else k.key for k in path)
        if v is None or (isinstance(v, tuple) and type(v) is not tuple):
            out[keys] = ("none", None, None)
        elif isinstance(v, tuple):
            out[keys] = ("tuple", None, None)
        else:
            out[keys] = ("array", tuple(v.shape), np.dtype(v.dtype))
    return out


def _port_layout(layout):
    out = {}
    for path, s in layout.items():
        if s.kind in ("none", "tuple"):
            out[path] = (s.kind, None, None)
        elif s.kind in ("tensor", "zeros"):
            out[path] = ("array", tuple(s.shape), np.dtype(np.float32))
        else:
            out[path] = ("array", (), np.dtype(np.int32 if s.kind == "int" else np.float32))
    return out


def test_full_width_states_map_both_ways():
    from ealdm_tpu import config as j_config
    from ealdm_tpu.training import TrainState as JState
    from ealdm_tpu.training import make_optimizer as j_make_optimizer
    from ealdm_tpu.training.ema import ema_init as j_ema_init
    from tests.test_torch_port_config import _jax_example

    path = str(REPO / "configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml")
    cfg = t_config.load_config([path])
    jm, _ = j_config.model_from_config(cfg["model"])
    side = cfg["model"]["params"]["first_stage_config"]["params"]["ddconfig"]["resolution"]
    key = jax.random.key(0, impl="unsafe_rbg")
    with gc_paused():
        shapes = jax.eval_shape(lambda r, b: jm.init({"params": r, "dropout": r}, b, r,
                                                     method=jm.full_init),
                                key, _jax_example(cfg, side))["params"]
        sched = "scheduler_config" in cfg["model"]["params"]
        j_opt = j_make_optimizer(1e-5, shapes, schedule_fn=(lambda s: 1.0) if sched else None)
        j_state = jax.eval_shape(lambda p: JState(step=jnp.zeros((), jnp.int32), params=p,
                                                  opt_state=j_opt.init(p), ema=j_ema_init(p)),
                                 shapes)
    model, _ = t_config.model_from_config(cfg["model"], device="meta")
    t_opt = t_training.make_optimizer(1e-5, schedule_fn=(lambda s: 1.0) if sched else None)
    state, _ = t_training.init_train_state(model, t_opt, device="meta")
    layout = flax_import.state_layout(state.state_dict(), model, sched)
    want, got = _jax_layout(j_state), _port_layout(layout)
    assert set(got) == set(want)
    for p in want:
        assert got[p] == want[p], p
    assert len(layout) > 4 * 958
    # every flax leaf of the model maps back to the port parameter it came from
    plan = flax_import.module_plan(model)
    zero = flax_import.lstm_zero_biases(model)
    assert {r.port for r in plan.values()} | set(zero) == set(state.params)
    for name, rule in plan.items():
        assert rule.port in flax_import.port_names(name), name

    # the kl-f8 first stage and its loss
    from ealdm_tpu.config import instantiate_from_config
    from ealdm_tpu.models.ddpm import build_first_stage as j_first_stage
    from ealdm_tpu.models.distributions import DiagonalGaussian as JaxGaussian
    from ealdm_tpu.training.vae_trainer import VAETrainState as JVAEState

    fs = t_config.KL_F8_AE_TRAIN["model"]
    jvae, jloss = j_first_stage(fs), instantiate_from_config(fs["params"]["lossconfig"])
    x = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    with gc_paused():
        ae = jax.eval_shape(lambda r, x: jvae.init({"params": r}, x, r), key, x)["params"]
        ls = jax.eval_shape(lambda r, x: jloss.init(
            {"params": r}, x, x, JaxGaussian.from_moments(jnp.zeros((1, 32, 32, 8))), 0),
            key, x)["params"]
        adam = optax.adam(1e-5, b1=0.5, b2=0.9)
        j_vae = jax.eval_shape(lambda a, b: JVAEState(
            step=jnp.zeros((), jnp.int32), ae_params=a, loss_params=b,
            opt_ae_state=adam.init(a), opt_disc_state=adam.init(b["discriminator"])), ae, ls)
    vae, loss = t_training.build_autoencoder(fs, device="meta")
    vstate, _, _ = t_training.init_vae_train_state(vae, loss, 1e-5, device="meta")
    want = _jax_layout(j_vae)
    got = _port_layout(flax_import.state_layout(vstate.state_dict(), (vae, loss)))
    assert set(got) == set(want)
    for p in want:
        assert got[p] == want[p], p


def test_state_dict_to_flax_inverts_flax_to_state_dict():
    model, _, state = _port_ldm(1)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
        for m in model.modules():
            if isinstance(m, torch.nn.LSTM):
                m.bias_ih_l0.zero_()
    tree = flax_import.state_dict_to_flax(model)
    back = flax_import.flax_to_state_dict(tree)
    params = dict(model.named_parameters())
    assert set(back) == set(params)
    for k, p in params.items():
        np.testing.assert_array_equal(back[k], p.detach().numpy(), err_msg=k)
    lstm = next(m for m in model.modules() if isinstance(m, torch.nn.LSTM))
    with torch.no_grad():
        lstm.bias_ih_l0.fill_(1.0)
    with pytest.raises(ValueError, match="bias_ih_l0 is not 0"):
        flax_import.state_dict_to_flax(model)


def test_seeded_lstm_bias_ih_stays_zero_and_the_writer_checks_it(tmp_path):
    """`random_init_` leaves the LSTMs' bias_ih at 0 (flax's cell has one
    bias a gate), and `write_jax_checkpoint` refuses a state where it is
    not."""
    from ealdm_torch.utils.init import random_init_

    model, opt, state = _port_ldm(1)
    random_init_(model, seed=3)
    lstms = [m for m in model.modules() if isinstance(m, torch.nn.LSTM)]
    assert lstms and all(not m.bias_ih_l0.any() for m in lstms)
    assert all(m.bias_hh_l0.any() for m in lstms)
    write_jax_checkpoint(str(tmp_path / "ok"), state, 0, model)
    with torch.no_grad():
        lstms[0].bias_ih_l0.fill_(0.5)
    with pytest.raises(ValueError, match="bias_ih_l0 is not 0"):
        write_jax_checkpoint(str(tmp_path / "bad"), state, 0, model)


# ---------------------------------------------------------- 8 entry points
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from ealdm_torch.data.synthetic import generate_synthetic_dataset

    root = tmp_path_factory.mktemp("orbax_corpus")
    generate_synthetic_dataset(str(root), sites=("Site_A_01", "Site_B_02"), n_days=12,
                               image_size=16, seed=0)
    return root


def test_main_resumes_a_jax_logdir(adamw_run, corpus, tmp_path):
    ldm_run = adamw_run
    logdir = shutil.copytree(ldm_run["logdir"], tmp_path / "run")
    data = [f"data.params.train.params.path={corpus}/",
            f"data.params.train.params.path_weather={corpus}/",
            f"data.params.train.params.path_scaler={corpus}/scalers/"]
    _, model, restored = t_main.main(["-r", str(logdir), "--device", "cpu", *data])
    assert restored.step == 2
    want = _jax_leaves(ldm_run["saved"])
    for path, v in _port_leaves(restored, model).items():
        if path[0] == 1:
            np.testing.assert_array_equal(v, want[path], err_msg=str(path))
    _, _, state = t_main.main(["-r", str(logdir), "-t", "--device", "cpu", "--max_steps", "3",
                               "--log_every", "1", "--third_stage", "false", *data])
    assert state.step == 3
    assert (logdir / "checkpoints" / "last" / "state.pt").is_file()


def test_sample_diffusion_from_a_jax_logdir(adamw_run, tmp_path):
    ldm_run = adamw_run
    from ealdm_torch.scripts import sample_diffusion as t_sample

    model, _, state = _port_ldm(1)
    CheckpointManager(str(ldm_run["logdir"] / "checkpoints"), monitor=None).restore_last(
        state, model)
    port_dir = tmp_path / "port_run"
    shutil.copytree(ldm_run["logdir"] / "configs", port_dir / "configs")
    CheckpointManager(str(port_dir / "checkpoints"), monitor=None).save_last(state, 2)
    out = {}
    for name, logdir in (("jax", ldm_run["logdir"]), ("port", port_dir)):
        t_sample.main(["-r", str(logdir), "-n", "2", "--batch_size", "2", "-c", "2", "-l",
                       str(tmp_path / name), "--device", "cpu"])
        out[name] = np.load(tmp_path / name / "2_samples.npz")["arr_0"]
    np.testing.assert_array_equal(out["jax"], out["port"])


# ------------------------------------------------------------- 9 fixture
def test_committed_fixture_matches_a_fresh_jax_run(tmp_path, adamw_run):
    ldm_run = adamw_run
    with tarfile.open(fx.FIXTURE) as tar:
        tar.extractall(tmp_path, filter="data")
    meta = json.loads((tmp_path / "fixture.json").read_text())
    ckpt = tmp_path / "checkpoints"
    for item in (ckpt / "2" / "default", ckpt / "last" / "state"):
        reader = orbax_format.OrbaxItem(str(item))
        got = {}
        for path, vt in reader.leaves.items():
            if vt in ("None", "Tuple"):
                continue
            t = reader.read(path)
            got[orbax_format.path_name(path)] = hashlib.sha256(
                t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
        assert got == meta["leaves"], item
    assert CheckpointManager(str(ckpt), monitor=meta["monitor"]).best_step() == 2
    # a fresh JAX run: ldm_run's first two steps are the fixture's
    assert meta["step"] == ldm_run["steps"] and meta["learning_rate"] == fx.LR
    assert float(ldm_run["metrics"]["loss"]) == pytest.approx(meta["loss"], rel=1e-6)
    fresh = _jax_leaves(ldm_run["saved"])
    reader = orbax_format.OrbaxItem(str(ckpt / "last" / "state"))
    top = max(float(np.abs(v).max()) for p, v in fresh.items() if _is_moment(p) and v.size)
    for path in fresh:
        v = reader.read(path).numpy()
        tol = 1e-5 * top if _is_moment(path) else 4 * fx.LR
        np.testing.assert_allclose(v, fresh[path], rtol=0, atol=tol if v.ndim else 0,
                                   err_msg=str(path))
    with np.load(tmp_path / "step3.npz") as z:
        b3 = fx.batch(3)
        np.testing.assert_array_equal(z["img"], b3["img"])
        np.testing.assert_array_equal(z["t"], ldm_run["draws"]["t"])
        np.testing.assert_allclose(z["noise"], ldm_run["draws"]["noise"], rtol=0, atol=0)
