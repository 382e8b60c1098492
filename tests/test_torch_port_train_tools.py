"""The port's training tools against the JAX package's, on the CPU:

- `TBEventWriter` (`training/tensorboard.py`): the same bytes as JAX's for
  the same scalars, image and wall time (JAX's PNG encoder swapped for the
  port's zlib writer in both, since PIL and zlib compress differently);
- `utils/png.py`: what it writes decodes through PIL to the array it was
  given (greyscale and RGB, odd sides);
- `SetupCallback`'s YAML reads back through PyYAML's `safe_load` equal to
  the config, floats such as 1e-06 included, without PyYAML writing it;
- `to_uint8_grid`, `MetricLogger`'s JSONL, `Collector`, the scalers and
  `ImageLogger`'s condition CSV equal JAX's; `DeviceStatsCallback` on the
  CPU.
"""
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch.data import scalers as t_scalers
from ealdm_torch.training import callbacks as t_cb
from ealdm_torch.training import stats as t_stats
from ealdm_torch.training import tensorboard as t_tb
from ealdm_torch.utils.png import encode_png, save_png
from ealdm_tpu.data import scalers as j_scalers
from ealdm_tpu.training import callbacks as j_cb
from ealdm_tpu.training import stats as j_stats
from ealdm_tpu.training import tensorboard as j_tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixed_clock(monkeypatch):
    """One wall time and host name for both writers (the file name and
    every event's wall_time come from them)."""
    for mod in (j_tb, t_tb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    monkeypatch.setattr(j_tb, "_png_encode", encode_png)


def _write_events(mod, logdir):
    w = mod.TBEventWriter(str(logdir), suffix=".x")
    w.add_scalar("train/loss", 0.125, step=7)
    w.add_scalars({"a": 1.0, "b": np.float32(2.5), "skip": "str", "c": torch.tensor(3.5)},
                  step=8, prefix="val/")
    rng = np.random.RandomState(0)
    w.add_image("train/rgb", (rng.rand(9, 7, 3) * 255).astype(np.uint8), step=9)
    w.add_image("train/float", rng.uniform(-1, 1, (5, 6, 3)).astype(np.float32), step=10)
    w.add_image("train/grey", (rng.rand(4, 5) * 255).astype(np.uint8), step=11)
    w.close()
    files = glob.glob(os.path.join(str(logdir), "events.out.tfevents.*"))
    assert len(files) == 1
    with open(files[0], "rb") as f:
        return os.path.basename(files[0]), f.read()


def test_tensorboard_bytes_equal_jax(tmp_path, monkeypatch):
    _fixed_clock(monkeypatch)
    want = _write_events(j_tb, tmp_path / "jax")
    got = _write_events(t_tb, tmp_path / "port")
    assert got[0] == want[0]
    assert got[1] == want[1]
    for data in (b"", b"123456789", b"\x00" * 32, bytes(range(256))):
        assert t_tb.crc32c(data) == j_tb.crc32c(data)
    assert t_tb.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (3, 11, 1), (9, 13, 3), (64, 48, 3)])
def test_png_decodes_to_its_array(tmp_path, shape):
    from PIL import Image

    img = (np.random.RandomState(sum(shape)).rand(*shape) * 256).astype(np.uint8)
    path = tmp_path / "sub" / "x.png"
    save_png(str(path), img)
    with Image.open(path) as im:
        got = np.asarray(im)
        assert im.mode == ("RGB" if shape[-1] == 3 and len(shape) == 3 else "L")
    np.testing.assert_array_equal(got, img.reshape(got.shape))
    with pytest.raises(TypeError):
        encode_png(img.astype(np.float32))


def test_setup_callback_yaml_reads_back(tmp_path):
    """The KL autoencoder YAML as loaded, the port's trainable configs and
    the values a hand-written emitter gets wrong: exponent floats (PyYAML
    reads `1e-06` as a string), strings that look like numbers, booleans or
    null, quotes, colons and non-ASCII, empty containers, lists of dicts
    and of lists, infinities."""
    with open(os.path.join(REPO, "configs/autoencoder/autoencoder_kl_32x32x4.yaml")) as f:
        config = yaml.safe_load(f)
    config["port"] = {"vq": t_config.VQ_F8_AE_TRAIN, "kl": t_config.KL_F8_AE_TRAIN}
    config["edge"] = {
        "floats": [1e-06, 4.5e-06, 1.0, -0.5, 1e16, 12.0, 0.000001, 5.4e-05, float("inf"),
                   -float("inf"), 0.0, 3.14159],
        "strings": ["1e-06", "yes", "null", "true", "", "a: b", 'say "hi"', "x\ny", "ü", "-",
                    "#c", "01"],
        "ints": [0, -3, 10**12], "bools": [True, False], "none": None,
        "empty": {}, "empty_list": [], "nested": [[1, [2, 3]], [], {"k": [{"a": 1}]}],
        7: "int key",
    }
    cb = t_cb.SetupCallback(str(tmp_path / "run"), config)
    path = cb.on_start("2026-01-01T00-00-00")
    assert path == str(tmp_path / "run/configs/2026-01-01T00-00-00-project.yaml")
    for d in ("checkpoints", "configs"):
        assert os.path.isdir(tmp_path / "run" / d)
    with open(path) as f:
        back = yaml.safe_load(f)
    assert back == config
    assert back["edge"]["floats"][0] == 1e-06 and isinstance(back["edge"]["floats"][0], float)
    assert back["model"]["params"]["lossconfig"]["params"]["kl_weight"] == 1e-06
    assert math.isinf(back["edge"]["floats"][8])


def test_to_uint8_grid_matches_jax():
    rng = np.random.RandomState(1)
    for shape, nrow in (((5, 6, 4, 3), 4), ((3, 4, 4, 1), 2), ((2, 5, 3, 4), 4),
                        ((8, 2, 2, 3), 8)):
        x = rng.uniform(-1.3, 1.3, shape).astype(np.float32)
        want = j_cb.to_uint8_grid(x, nrow)
        np.testing.assert_array_equal(t_cb.to_uint8_grid(x, nrow), want)
        np.testing.assert_array_equal(t_cb.to_uint8_grid(torch.from_numpy(x), nrow), want)


def test_metric_logger_jsonl_matches_jax(tmp_path):
    metrics = {"train/loss": np.float32(0.1234567), "aeloss": np.float64(2.5), "n": 3,
               "skip": "str", "vec": np.ones(3, np.float32)}
    port = {k: torch.tensor(v) if isinstance(v, np.ndarray) or isinstance(v, np.generic)
            else v for k, v in metrics.items()}
    for mod, m, d in ((j_cb, metrics, "jax"), (t_cb, port, "port")):
        ml = mod.MetricLogger(str(tmp_path / d))
        ml.log(3, m, prefix="p/")
        ml.log(4, {"x": 1.5})
    lines = [open(tmp_path / d / "metrics.jsonl").read() for d in ("jax", "port")]
    assert lines[1] == lines[0]
    assert json.loads(lines[1].splitlines()[0]) == {"step": 3, "p/train/loss": float(
        np.float32(0.1234567)), "p/aeloss": 2.5, "p/n": 3.0}
    assert len(glob.glob(str(tmp_path / "port" / "tb" / "events.out.tfevents.*"))) == 1


def test_collector_matches_jax():
    got = {}
    for mod in (j_stats, t_stats):
        mod._counters.clear()
        mod.report("loss/a", [1.0, 2.0, 3.0])
        mod.report("loss/a", 4.0)
        mod.report("acc", np.array([0.5, 0.25]))
        mod.report("empty", [])
        mod.report0("x", 1.0, process_index=0)
        mod.report0("x", 1.0, process_index=1)
        mod.report0("y", 2.0)
        c = mod.Collector(regex="loss/.*|x|y")
        mod.report("loss/a", 10.0)
        c.update()
        got[mod] = (c.as_dict(), mod.Collector(keep_previous=False).as_dict())
        mod._counters.clear()
    assert json.dumps(got[t_stats]) == json.dumps(got[j_stats])  # NaN included
    t_stats.report("t", torch.tensor([1.0, 3.0]))
    assert t_stats.Collector().mean("t") == 2.0
    t_stats._counters.clear()


_RANK = """
import sys, torch, torch.distributed as dist
from ealdm_torch.training import stats
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2, rank=rank)
if rank:  # the names in another order on each process
    stats.report("loss", [2.0, 3.0])
stats.report0("first", 10.0 + rank)
if not rank:
    stats.report("loss", [1.0, 2.0])
c = stats.Collector()
print(c.num("loss"), c.mean("loss"), c.num("first"), c.mean("first"), flush=True)
dist.destroy_process_group()
"""


def test_collector_sums_over_processes():
    """Two processes on torch.distributed's gloo backend: each Collector
    holds both processes' moments (all_reduce), report0 counts process 0's
    alone, and the order in which each process reported does not matter."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), f"tcp://localhost:{port}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["4", "2.0", "1", "10.0"]


def test_image_logger_writes_each_grid(tmp_path):
    """`ImageLogger.log_img` over the port's `log_images` on the tiny
    flagship: a PNG for every image key (the zlib writer's, read back by
    PIL equal to the key's grid) and the condition CSV."""
    from PIL import Image

    from ealdm_torch.models.ddpm import LatentDiffusion
    from ealdm_torch.utils.init import random_init_

    torch.manual_seed(0)
    model = LatentDiffusion(**t_config.model_kwargs(t_config.TINY), device="cpu").eval()
    random_init_(model, seed=0)
    g = torch.Generator().manual_seed(1)
    res = t_config.TINY["res"]
    batch = {"img": torch.randn(2, res, res, 3, generator=g), "mixed": {
        "img": torch.randn(2, res, res, 3, generator=g),
        "img_random": torch.randn(2, res, res, 3, generator=g),
        "flow": torch.randn(2, 1, 1, generator=g), "weather": torch.randn(2, 1, 16, generator=g),
        "time": torch.rand(2, 1, generator=g)}}
    logger = t_cb.ImageLogger(str(tmp_path), max_images=2, log_steps=2)
    with torch.no_grad():
        logs = logger.log_img(model, batch, 7, torch.Generator().manual_seed(2), device="cpu")
    root = tmp_path / "images" / "train"
    written = sorted(p.name for p in root.glob("*.png"))
    want = sorted(f"{k}_gs-000007.png" for k, v in logs.items()
                  if v.dim() == 4 and not k.endswith("_latent") and k != "mask")
    assert written == want and len(want) >= 3
    for name in want:
        with Image.open(root / name) as im:
            np.testing.assert_array_equal(
                np.asarray(im), t_cb.to_uint8_grid(logs[name.split("_gs-")[0]]))
    assert (root / "conditions_gs-000007.csv").exists()


def test_scalers_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.randn(20, 3) * [1.0, 5.0, 0.0] + [0.0, 2.0, 7.0]
    for name, args in (("StandardScaler", ()), ("MinMaxScaler", ((-1.0, 1.0),))):
        j, t = getattr(j_scalers, name)(*args).fit(x), getattr(t_scalers, name)(*args).fit(x)
        np.testing.assert_array_equal(t.transform(x), j.transform(x))
        np.testing.assert_array_equal(t.inverse_transform(x), j.inverse_transform(x))
        assert t.to_dict() == j.to_dict()
        j_scalers.save_scaler(j, str(tmp_path / f"{name}.json"))
        back = t_scalers.load_scaler(str(tmp_path / f"{name}.json"))
        np.testing.assert_array_equal(back.transform(x), j.transform(x))
    labels = [["rain"], "sun", [], ["rain", "fog"]]
    j, t = j_scalers.MultiLabelBinarizer(["fog", "rain", "sun"]), t_scalers.MultiLabelBinarizer(
        ["fog", "rain", "sun"])
    np.testing.assert_array_equal(t.transform(labels), j.transform(labels))
    assert t.inverse_transform(t.transform(labels)) == j.inverse_transform(j.transform(labels))


def test_image_logger_condition_csv_matches_jax(tmp_path):
    """The de-normalised condition CSV of a `mixed` batch, through scalers
    saved by the JAX package."""
    rng = np.random.RandomState(3)
    mixed = {"flow": rng.randn(5, 1, 1), "weather": rng.randn(5, 1, 4), "time": rng.rand(5, 1)}
    for name, s in (("flow", j_scalers.StandardScaler().fit(rng.randn(30, 1) * 3)),
                    ("weather", j_scalers.MinMaxScaler().fit(rng.randn(30, 4))),
                    ("time", j_scalers.StandardScaler().fit(rng.rand(30, 1)))):
        j_scalers.save_scaler(s, str(tmp_path / f"{name}_scaler_trainval.json"))
    batch = {"img": np.zeros((5, 2, 2, 3)), "mixed": mixed}
    port_batch = {"img": torch.zeros(5, 2, 2, 3),
                  "mixed": {k: torch.from_numpy(v) for k, v in mixed.items()}}
    out = {}
    for mod, b, d in ((j_cb, batch, "jax"), (t_cb, port_batch, "port")):
        logger = mod.ImageLogger(str(tmp_path / d), max_images=4, scaler_dir=str(tmp_path))
        logger._write_condition_csv(b, 12, "train", str(tmp_path / d))
        with open(tmp_path / d / "conditions_gs-000012.csv") as f:
            out[d] = f.read()
    assert out["port"] == out["jax"]
    assert len(out["port"].splitlines()) == 5


def test_device_stats_callback_on_the_cpu(capsys):
    cb = t_cb.DeviceStatsCallback(device="cpu")
    cb.on_epoch_start()
    stats = cb.on_epoch_end()
    assert set(stats) == {"epoch_time_s"} and stats["epoch_time_s"] >= 0
    assert "Epoch time" in capsys.readouterr().out
