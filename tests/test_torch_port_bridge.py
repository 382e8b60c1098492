"""The parameter bridge at the flagship width, and the port's hygiene:
it imports nothing of JAX, calls no library attention or compiler, and its
entry points do not fall back to the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealdm_torch import config as t_config
from ealdm_torch.config import FLAGSHIP, TINY, model_kwargs
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.utils import flax_import
from ealdm_tpu.models.ddpm import LatentDiffusion as JaxLDM

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_flagship_tree_maps_one_to_one():
    """The flagship's flax tree (shapes only: jax.eval_shape) maps onto the
    port built on the meta device: every port parameter is set once, with
    its shape, and every flax leaf is used."""
    b, res = 1, FLAGSHIP["res"]
    kw = model_kwargs(FLAGSHIP)
    jm = JaxLDM(**kw, dtype=jnp.bfloat16)
    batch = {"img": jnp.zeros((b, res, res, 3)), "mixed": {
        "img": jnp.zeros((b, res, res, 3)), "img_random": jnp.zeros((b, res, res, 3)),
        "flow": jnp.zeros((b, 1, 1)), "weather": jnp.zeros((b, 1, 16)),
        "time": jnp.zeros((b, 1))}}
    shapes = jax.eval_shape(
        lambda r: jm.init({"params": r, "dropout": r}, batch, r, method=jm.full_init),
        jax.random.PRNGKey(0))
    # zero-stride stand-ins: the bridge's transposes run without the memory
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    tm = TorchLDM(**kw, dtype=torch.bfloat16, device="meta")
    sd = flax_import.flax_to_state_dict(tree)
    flax_import.check_state_dict(tm, sd)
    params = dict(tm.named_parameters())
    assert set(sd) == set(params)
    # each flax OptimizedLSTMCell's 12 leaves become torch.nn.LSTM's 4 tensors
    n_lstm = sum(1 for k in params if k.endswith("weight_ih_l0"))
    assert n_lstm == 2
    assert n_leaves == len(params) + n_lstm * (12 - 4)
    assert sum(p.numel() for p in params.values()) > 4e8


def test_bridge_rejects_a_tree_that_does_not_fit():
    tm = TorchLDM(**model_kwargs(TINY), device="meta")
    tree = {"model": {"diffusion_model": {"conv_in": {
        "kernel": np.zeros((3, 3, 4, 64), np.float32),
        "bias": np.zeros(64, np.float32)}}}}
    with pytest.raises(ValueError, match="missing"):
        flax_import.check_state_dict(tm, flax_import.flax_to_state_dict(tree))
    with pytest.raises(ValueError, match="no rule"):
        flax_import.flax_to_state_dict({"x": {"weird": np.zeros(3)}})


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke) leaves jax, flax
    and ealdm_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ealdm_torch, ealdm_torch.inference, chip_smoke\n"
        "for m in pkgutil.walk_packages(ealdm_torch.__path__, 'ealdm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ealdm_tpu'))\n"
        "print(bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _sources():
    return sorted(p for p in (REPO / "ealdm_torch").rglob("*")
                  if p.suffix in (".py", ".cu", ".cuh", ".h"))


IMPORTS_JAX = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|ealdm_tpu)\b", re.M)
# what the card's machine does not have: a YAML parser, an imaging package,
# pandas, h5py
IMPORTS_MISSING = re.compile(r"^\s*(import|from)\s+(yaml|PIL|pandas|h5py)\b", re.M)


def test_source_scan():
    """No import of JAX or the JAX package, nor of PyYAML, PIL, pandas or
    h5py, no library attention and no torch.compile anywhere in the port; no
    JAX import and no torch.compile in chip_smoke.py (which times the library
    attention as a yardstick only). Comments may still name the JAX files
    each module is a counterpart of."""
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile")
    for p in _sources():
        text = p.read_text()
        assert not IMPORTS_JAX.search(text), p
        assert not IMPORTS_MISSING.search(text), p
        assert not banned.search(text), p
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not IMPORTS_JAX.search(smoke)
    assert "torch.compile" not in smoke


# the command-line tools' slice: every module it added is in the scan
CLI_SLICE_MODULES = (
    "utils/dnn.py", "misc.py", "util.py", "data/tokenizer.py", "models/resnet.py",
    "retrieval.py", "serving.py", "scripts/__init__.py", "scripts/_common.py",
    "scripts/sample_diffusion.py", "scripts/txt2img.py", "scripts/inpaint.py",
    "scripts/train_searcher.py", "scripts/knn2img.py", "scripts/train_tokenizer.py",
    "scripts/export_sampler.py",
)


def test_source_scan_covers_the_cli_slice():
    scanned = {p.relative_to(REPO / "ealdm_torch").as_posix() for p in _sources()}
    assert set(CLI_SLICE_MODULES) <= scanned


# the third stage's slice
THIRD_STAGE_SLICE_MODULES = ("metrics.py", "weights.py", "third_stage.py", "models/inception.py",
                             "models/clip.py", "training/vae_trainer.py", "main.py")


def test_source_scan_covers_the_third_stage_slice():
    scanned = {p.relative_to(REPO / "ealdm_torch").as_posix() for p in _sources()}
    assert set(THIRD_STAGE_SLICE_MODULES) <= scanned


def test_no_fallback_in_kernel_wrappers():
    """A wrapper given a CUDA tensor launches or raises: no try/except."""
    for rel in ("ops/attention.py", "ops/norms.py", "ops/bias_act.py", "kernels/build.py"):
        assert not re.search(r"^\s*(try|except)\b",
                             (REPO / "ealdm_torch" / rel).read_text(), re.M), rel


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without CUDA")
    kw = model_kwargs(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchLDM(**kw)
    tm = TorchLDM(**kw, device="cpu")
    from ealdm_torch.inference import sample_images

    with pytest.raises(RuntimeError, match="CUDA"):
        sample_images(tm, 1, (8, 8, 4), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        flax_import.load_flax_params(tm, {})
    from ealdm_torch.models.ddpm import DDPM as TorchDDPM
    from ealdm_torch.models.vae import AutoencoderKL as TorchKL

    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDDPM(kw["unet_config"])
    kl = t_config.vae_kwargs(t_config.KL_F4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchKL(**kl)
    assert next(TorchKL(**kl, device="meta").parameters()).device.type == "meta"


@pytest.mark.parametrize("where,key,value", [
    ("ddconfig", "tanh_out", True),
    ("ddconfig", "resamp_with_conv", False),
    ("unet_config", "dropout", 0.1),
    ("ddconfig", "double_z", True),
    ("ddconfig", "attn_type", "linear"),
    ("model", "parameterization", "v"),
])
def test_unported_options_raise(where, key, value):
    """An option no ported configuration sets is refused, not half-run."""
    kw = model_kwargs(TINY)
    target = {"unet_config": kw["unet_config"], "model": kw,
              "ddconfig": kw["first_stage_config"]["params"]["ddconfig"]}[where]
    target[key] = value
    with pytest.raises(NotImplementedError, match=key):
        TorchLDM(**kw, device="meta")


def test_configs_mirror_the_yaml_and_bench():
    """FLAGSHIP has the shapes and the diffusion settings of the flagship
    YAML's model.params, and TINY is bench.build_model(tiny=True)'s model."""
    import yaml

    import bench

    path = REPO / "configs" / "latent-diffusion" / "stdiff_cin-ldm-vq-f8.yaml"
    params = yaml.safe_load(path.read_text())["model"]["params"]
    flag = model_kwargs(FLAGSHIP)
    assert flag["unet_config"] == params["unet_config"]["params"]
    fs = dict(params["first_stage_config"]["params"])
    fs.pop("lossconfig")
    assert flag["first_stage_config"]["params"] == fs
    for key in ("timesteps", "linear_start", "linear_end", "conditioning_key",
                "cond_stage_key", "cond_stage_trainable"):
        assert flag[key] == params[key], key
    cond, cond_yaml = flag["cond_stage_config"], params["cond_stage_config"]
    assert cond["target"] == cond_yaml["target"]
    args, args_yaml = cond["params"]["cond_args"], cond_yaml["params"]["cond_args"]
    for key in ("type", "dims", "lr", "lin_lr", "include_lin", "noise"):
        assert args[key] == args_yaml[key], key
    # bench.py rounds the fourier frequencies the YAML spells out in full
    np.testing.assert_allclose(args["f_manual"], args_yaml["f_manual"], rtol=1e-4)
    assert FLAGSHIP["res"] == fs["ddconfig"]["resolution"]
    assert FLAGSHIP["zres"] == params["image_size"] == flag["unet_config"]["image_size"]
    jm = bench.build_model(tiny=True, batch_size=1)[0]
    tiny = model_kwargs(TINY)
    for key in ("unet_config", "first_stage_config", "cond_stage_config", "timesteps",
                "linear_start", "linear_end", "conditioning_key", "cond_stage_key",
                "unconditional_guidance_scale"):
        assert getattr(jm, key) == tiny[key], key


@pytest.mark.parametrize("name", ["INPAINT", "UNCOND", "PIXEL", "KL_F4"])
def test_unconditional_trees_map_one_to_one(name):
    """The full-width flax trees (shapes only) of the unconditional
    configurations map onto the port built on the meta device: the
    AttentionBlock UNets, VQ-f4, the identity first stage, and
    AutoencoderKL's 2 * embed_dim quant_conv and post_quant_conv."""
    from ealdm_torch.models.ddpm import DDPM as TorchDDPM
    from ealdm_torch.models.vae import AutoencoderKL as TorchKL
    from ealdm_tpu.models.vae import AutoencoderKL as JaxKL

    cfg = getattr(t_config, name)
    x = jnp.zeros((1, cfg["res"], cfg["res"], 3))
    if name == "KL_F4":
        kw = t_config.vae_kwargs(cfg)
        jm = JaxKL(**kw, dtype=jnp.bfloat16)
        shapes = jax.eval_shape(lambda r: jm.init({"params": r}, x, r), jax.random.PRNGKey(0))
        tm = TorchKL(**kw, dtype=torch.bfloat16, device="meta")
    else:
        kw = model_kwargs(cfg)
        jm = JaxLDM(**kw, dtype=jnp.bfloat16)
        shapes = jax.eval_shape(
            lambda r: jm.init({"params": r, "dropout": r}, {"img": x}, r, method=jm.full_init),
            jax.random.PRNGKey(0))
        tm = (TorchDDPM if name == "PIXEL" else TorchLDM)(**kw, dtype=torch.bfloat16,
                                                          device="meta")
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = flax_import.flax_to_state_dict(tree)
    flax_import.check_state_dict(tm, sd)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree)) == len(dict(tm.named_parameters()))


@pytest.mark.parametrize("name,path", [
    ("UNCOND", "latent-diffusion/uncond_cin-ldm-vq-f8.yaml"),
    ("PIXEL", "latent-diffusion/uncond_stdiff_cin-ldm-vq-f8.yaml"),
    ("KL_F4", "autoencoder/autoencoder_kl_64x64x3.yaml"),
])
def test_unconditional_configs_mirror_the_yaml(name, path):
    """UNCOND, PIXEL and KL_F4 have the widths and diffusion settings of
    their YAML's model.params, uncut."""
    import yaml

    params = yaml.safe_load((REPO / "configs" / path).read_text())["model"]["params"]
    cfg = getattr(t_config, name)
    if name == "KL_F4":
        kw = t_config.vae_kwargs(cfg)
        assert kw == {"embed_dim": params["embed_dim"], "ddconfig": params["ddconfig"]}
        return
    kw = model_kwargs(cfg)
    assert kw["unet_config"] == params["unet_config"]["params"]
    assert kw["cond_stage_config"] == params["cond_stage_config"]
    fs = params["first_stage_config"]
    assert kw["first_stage_config"]["target"] == fs["target"]
    assert kw["first_stage_config"].get("params", {}) == {
        k: v for k, v in fs.get("params", {}).items() if k != "lossconfig"}
    for key in ("timesteps", "linear_start", "linear_end", "num_timesteps_cond",
                "first_stage_key"):
        assert kw[key] == params[key], key
    assert cfg["res"] == (kw["unet_config"]["image_size"] if name == "PIXEL"
                          else fs["params"]["ddconfig"]["resolution"])
