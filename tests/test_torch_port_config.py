"""The port's config system (`ealdm_torch/config.py`, with the YAML reader
`ealdm_torch/utils/yaml_subset.py`) against PyYAML and the JAX package's
`ealdm_tpu/config.py`:

- the reader gives what `yaml.safe_load` gives on every repo YAML
  (`configs/**/*.yaml`, `models/**/config.yaml`), on YAML 1.1's scalar
  rules (`1.0e-05` a float, `5e-4` a string, `~`, `yes`/`no`, flow lists,
  quoted strings, ...) and on what the port's `to_yaml` writes; it refuses
  what it does not take where PyYAML would read it;
- `load_config` (with dotlist overrides) equals JAX's on each repo YAML;
- the registry has JAX's keys, and its unported entries raise naming their
  ROADMAP item;
- `model_from_config` on torch's "meta" device has the parameter names and
  shapes of `jax.eval_shape` of JAX's init, for the flagship YAML, the
  unconditional VQ-f8 YAML and the micro STDiff YAML that
  `test_torch_port_main.py` trains.
"""
import glob
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch.training.callbacks import to_yaml
from ealdm_torch.utils.flax_import import flax_to_state_dict
from ealdm_torch.utils.yaml_subset import YAMLSubsetError, loads
from ealdm_tpu import config as j_config

REPO = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted(str(pathlib.Path(p).relative_to(REPO)) for p in
               glob.glob(str(REPO / "configs/**/*.yaml"), recursive=True)
               + glob.glob(str(REPO / "models/**/config.yaml"), recursive=True))


def _same(a, b):
    """Equal values of equal types (dict order included; NaN equals NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_there_are_forty_yamls():
    assert len(YAMLS) == 40


@pytest.mark.parametrize("path", YAMLS)
def test_reader_equals_pyyaml_on_repo_yamls(path):
    text = (REPO / path).read_text()
    assert _same(loads(text), yaml.safe_load(text))


SCALARS = [
    "1.0e-05", "5e-4", "1.e-6", "4.5e-6", "1e5", "1.5E+3", "0.", ".5", "-.inf", ".NaN", "+1",
    "-1", "0x1F", "012", "08", "0b101", "1_000", "190:20:30", "3:25:45.5", "~", "null", "Null",
    "", "yes", "No", "on", "OFF", "True", "tRue", "2021-03-01", "2021-03-01 12:00:00",
    "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.1 Z", "[1, 2]", "[null]", "[]",
    "{}", "[1, [2, 3], {a: [4]}]", "{a: 1, b}", "[a:b, c]", "'a''b'", '"a\\tb\\u00e9\\x41"',
    "'#not a comment'", "a #comment", "a#b", "foo bar", "/tmp/x/", "-", "- 1",
    "a: 1\nb: [1, {c: d, e: [f, 'g']}]\n", "- a\n- b: 1\n  c: 2\n- - x\n  - y\n",
    "k:\n- 1\n- 2\nj: 3\n", "k:\n  - a\n  -\n    b: 1\n", "a:\nb:\n", "'x': 1\n\"y\": 2\n",
    "k: [1,\n  2, 3]\n", "multi\n  line", "yes: no\n", "null: ~\n", "1: 2\n", "k: 'it''s'\n",
    "--- \nk: v\n...\n",
]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_equals_pyyaml_on_yaml11_cases(text):
    assert _same(loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["a: b: c", "@x", "`x", "[a, b]]", "{a: 1}}", "- a\nb: 1",
                                  "="])
def test_reader_refuses_what_pyyaml_refuses(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(YAMLSubsetError):
        loads(text)


@pytest.mark.parametrize("text", ["k: |\n  a\n", "&a x", "k: !!str 1"])
def test_reader_refuses_what_it_does_not_take(text):
    yaml.safe_load(text)
    with pytest.raises(YAMLSubsetError):
        loads(text)


def test_reader_reads_what_to_yaml_writes():
    cfg = t_config.load_config([str(REPO / "configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml")])
    cfg["extra"] = {"lr": 1e-6, "big": 1.5e300, "neg": -2.0, "nan": float("nan"),
                    "inf": float("inf"), "s": 'quote " and \\ and \n and é', "n": None,
                    "b": [True, False], "empty": {}, "none_list": [], "nested": [[1, 2], [{}]],
                    "num_str": "5e-4", "colon": "a: b", "hash": "x #y", 3: "int key"}
    text = to_yaml(cfg)
    assert _same(loads(text), yaml.safe_load(text))
    assert _same(loads(text), cfg)


DOTLISTS = [
    [],
    ["model.base_learning_rate=5e-4", "data.params.batch_size=4", "new.key.deep=[1, 2]",
     "lightning.trainer.benchmark=false", "model.params.flag=~", "x.path=/tmp/a b/",
     "x.flow={a: 1, b: [x, 'y']}", "x.quoted='5e-4'", "x.bad=[1, 2", "x.empty="],
]


@pytest.mark.parametrize("path", YAMLS)
def test_load_config_equals_jax(path):
    for dotlist in DOTLISTS:
        got = t_config.load_config([str(REPO / path)], dotlist)
        assert _same(got, j_config.load_config([str(REPO / path)], dotlist)), dotlist


def test_merge_and_dotlist_equal_jax():
    a = str(REPO / "configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml")
    b = str(REPO / "configs/smoke/stdiff_micro.yaml")
    assert _same(t_config.load_config([a, b], DOTLISTS[1]), j_config.load_config([a, b],
                                                                                  DOTLISTS[1]))
    with pytest.raises(ValueError):
        t_config.apply_dotlist({}, ["no_equals_sign"])


def test_registry_keys_equal_jax():
    assert set(t_config._REGISTRY) == set(j_config._REGISTRY)
    assert t_config._LD_KEYS == j_config._LD_KEYS
    for key, entry in t_config._REGISTRY.items():
        if isinstance(entry, t_config.NotPorted):
            with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
                t_config.resolve_target(key)
        else:
            assert callable(t_config.resolve_target(key)), key
    assert t_config.resolve_target("ealdm_tpu.data.pipeline:DataModule") is \
        t_config.resolve_target("main.DataModuleFromConfig")
    from ealdm_torch.third_stage import ThirdStageDataset

    assert t_config.resolve_target("STDiff.third_stage_dataset.ThirdStageDataset") is \
        ThirdStageDataset
    with pytest.raises(NotImplementedError, match="item 9"):
        t_config.instantiate_from_config({"target": "ldm.data.imagenet.ImageNetSRTrain",
                                          "params": {"size": 256}})
    assert t_config.instantiate_from_config("__is_first_stage__") == "__is_first_stage__"
    assert t_config.instantiate_from_config({"target": "torch.nn.Identity"}) is None


def _jax_example(cfg, side):
    """A batch of one for JAX's full_init, by the config's keys."""
    p = cfg["model"]["params"]
    img = jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32)
    batch = {p.get("first_stage_key", "img"): img}
    if p.get("cond_stage_key") == "mixed":
        z = lambda *s: jax.ShapeDtypeStruct((1, *s), jnp.float32)  # noqa: E731
        batch["mixed"] = {"img": img, "img_random": img, "flow": z(1, 1), "weather": z(1, 16),
                          "time": z(1)}
    elif p.get("cond_stage_key") == "class_label":
        batch["class_label"] = jax.ShapeDtypeStruct((1,), jnp.int32)
    return batch


@pytest.mark.parametrize("path", ["configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml",
                                  "configs/latent-diffusion/uncond_cin-ldm-vq-f8.yaml",
                                  "configs/smoke/stdiff_micro.yaml"])
def test_model_from_config_tree_equals_jax_init(path):
    cfg = t_config.load_config([str(REPO / path)])
    tm, lr = t_config.model_from_config(cfg["model"], device="meta")
    jm, jlr = j_config.model_from_config(cfg["model"])
    assert lr == jlr
    assert all(p.is_meta for p in tm.parameters())
    side = cfg["model"]["params"]["first_stage_config"]["params"]["ddconfig"]["resolution"]
    batch = _jax_example(cfg, side)
    key = jax.random.key(0, impl="unsafe_rbg")
    shapes = jax.eval_shape(lambda r, b: jm.init({"params": r, "dropout": r}, b, r,
                                                 method=jm.full_init), key, batch)
    # zero-stride views stand in for the arrays: the bridge only transposes them
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  shapes["params"])
    want = {k: tuple(np.shape(v)) for k, v in flax_to_state_dict(tree).items()}
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    for key in ("timesteps", "linear_start", "linear_end", "conditioning_key",
                "cond_stage_key", "first_stage_key", "cond_stage_trainable"):
        if key in cfg["model"]["params"]:
            assert getattr(tm, key) == getattr(jm, key), key
    assert tm.dtype == torch.float32
