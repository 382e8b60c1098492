"""The JAX side of `tests/test_torch_port_orbax.py` and the writer of the
committed fixture `ealdm_torch/data/jax_ckpt_micro.tar.xz`:

    JAX_PLATFORMS=cpu python -m tests.jax_ckpt_fixture

`MicroRun` trains `configs/smoke/stdiff_micro.yaml`'s TrainState with the
JAX package's `make_train_step` (float32 on the CPU, XLA's backend
optimisations off, as the tests compile it): its weights are seeded values
in the tree of the JAX init, its batches and step keys fixed, and each
step's draws (t, the noise, the cond tower's dropout masks) can be read
off the key to replay them in the port. The fixture is what the JAX
package's `CheckpointManager.save` writes after two steps (`checkpoints/2/`
and `checkpoints/last/`), the YAML under `configs/`, the third step's batch
and draws (`step3.npz`) and `fixture.json`: each leaf's sha256 (of the
array's bytes in JAX's layout and dtype), the third step's loss and the
learning rate.
"""
import hashlib
import io
import json
import pathlib
import shutil
import sys
import tarfile
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ealdm_tpu import config as j_config  # noqa: E402
from ealdm_tpu.training import TrainState, make_optimizer, make_train_step  # noqa: E402
from ealdm_tpu.training.ema import ema_init  # noqa: E402
from tests.test_torch_port_models import mixed_batch, random_tree  # noqa: E402

MICRO = REPO / "configs" / "smoke" / "stdiff_micro.yaml"
FIXTURE = REPO / "ealdm_torch" / "data" / "jax_ckpt_micro.tar.xz"
XLA = {"xla_backend_optimization_level": 0}
LR = 2e-5
MONITOR = "val/loss_simple_ema"


def batch(i):
    """The i-th batch of 2: frames and the `mixed` conditioning, seeded."""
    rng = np.random.RandomState(10 + i)
    return {"img": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
            "mixed": mixed_batch(2, 16, seed=20 + i)}


def key(i):
    return jax.random.PRNGKey(100 + i)


def _jnp(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


class MicroRun:
    """The micro LDM's JAX model, optimizer (accumulate_grad_batches
    `accumulate`), state and compiled step."""

    def __init__(self, accumulate=1, masks_fn=None):
        from tests.test_torch_port_main import _dropout_masks_fn

        cfg = j_config.load_config([str(MICRO)])
        self.model, _ = j_config.model_from_config(cfg["model"])
        jm, ex = self.model, _jnp(batch(0))
        shapes = jax.eval_shape(lambda r: jm.init({"params": r, "dropout": r}, ex, r,
                                                  method=jm.full_init), jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(jnp.asarray, random_tree(shapes, seed=4)["params"])
        self.optimizer = make_optimizer(LR, params, accumulate_grad_batches=accumulate)
        self.state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=self.optimizer.init(params), ema=ema_init(params))
        self.step = make_train_step(jm, self.optimizer, donate=False, remat="none").lower(
            self.state, ex, key(0)).compile(XLA)
        # the masks do not depend on the optimizer: runs may share the program
        self.masks_fn = masks_fn or _dropout_masks_fn(jm).lower(params, ex, key(0)).compile(XLA)

    def draws(self, i):
        """Step i's t, noise and dropout keep masks at the current state."""
        rngs = jax.random.split(key(i), 4)  # training_loss: t from [1], the noise from [2]
        t = np.asarray(jax.random.randint(rngs[1], (2,), 0, self.model.timesteps))
        noise = np.asarray(jax.random.normal(rngs[2], (2, 8, 8, 4)))
        masks = [np.asarray(m) for m in self.masks_fn(self.state.params, _jnp(batch(i)),
                                                      key(i))]
        return {"t": t, "noise": noise, "masks": masks}

    def train(self, i):
        """Step i (its batch and key); returns its metrics."""
        self.state, metrics = self.step(self.state, _jnp(batch(i)), key(i))
        return jax.device_get(metrics)


def leaf_digests(state):
    """{orbax leaf name: sha256 of the array's bytes} of a JAX state."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(state)):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in path)
        out[name] = hashlib.sha256(np.ascontiguousarray(np.asarray(v)).tobytes()).hexdigest()
    return out


def fixture_contents():
    """(the state after two steps, step 3's draws, step 3's loss) of a
    fresh `MicroRun`."""
    run = MicroRun()
    for i in (1, 2):
        run.train(i)
    state = run.state
    draws = run.draws(3)
    loss = float(run.train(3)["loss"])
    return state, draws, loss


def write_fixture(out=FIXTURE):
    """Train, save with the JAX package's CheckpointManager and pack."""
    from ealdm_tpu.training.checkpoint import CheckpointManager

    state, draws, loss = fixture_contents()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        (root / "configs").mkdir()
        shutil.copy(MICRO, root / "configs" / "micro-project.yaml")
        mgr = CheckpointManager(str(root / "checkpoints"), monitor=MONITOR)
        mgr.save(2, jax.device_get(state), metrics={MONITOR: 0.5})
        mgr.close()
        b = batch(3)
        np.savez(root / "step3.npz", img=b["img"], t=draws["t"], noise=draws["noise"],
                 **{f"mixed_{k}": v for k, v in b["mixed"].items()},
                 **{f"mask_{i}": m for i, m in enumerate(draws["masks"])})
        meta = {"step": 2, "loss": loss, "learning_rate": LR, "monitor": MONITOR,
                "leaves": leaf_digests(state)}
        (root / "fixture.json").write_text(json.dumps(meta, indent=1, sort_keys=True))
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:xz", preset=9) as tar:
            for p in sorted(root.rglob("*")):
                info = tar.gettarinfo(str(p), str(p.relative_to(root)))
                info.mtime, info.uid, info.gid, info.uname, info.gname = 0, 0, 0, "", ""
                if p.is_file():
                    with open(p, "rb") as f:
                        tar.addfile(info, f)
                else:
                    tar.addfile(info)
        out.write_bytes(buf.getvalue())
    return out


if __name__ == "__main__":
    path = write_fixture()
    print(f"{path}: {path.stat().st_size} bytes")
