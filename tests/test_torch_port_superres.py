"""The super-resolution workflow of the port (`ealdm_torch/notebook_helpers.py`)
against the root `notebook_helpers.py`, float32 on the CPU:

- `get_cond` of one uint8 array against JAX's of the same pixels as a PNG
  (the 4x bilinear upsample is `resize_nhwc` against `jax.image.resize`);
- `run` on the JAX test's `_tiny_sr_model` (tests/test_notebook_helpers.py)
  with a 48^2 LR image: its 192^2 upsample switches split-input patching on
  (the encode over 2x2 crops of 128^2), DDIM with 3 steps asked (4 run) at
  eta 1, JAX's x_T and step noise replayed; every logged tensor within
  1e-4 of its scale;
- the committed `ealdm_torch/data/superresolution_examples.npz` is the
  example PNG as PIL decodes it;
- `hoist_invariants` falls back to the plain step under
  `split_input_params`; the helpers that waited for the config system and
  the PNG reader work: `get_model("stdiff")` (the flagship's YAML, on
  "meta"), `get_model(run_dir=...)` (a run of `ealdm_torch.main`: its EMA
  weights), `visualize` and `visualize_cond_img`.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

import notebook_helpers as nh
from ealdm_torch import config as t_config
from ealdm_torch import notebook_helpers as tnh
from ealdm_torch.inference import hoist_invariants, make_eps_fn
from ealdm_torch.models.ddpm import LatentDiffusion as TorchLDM
from ealdm_torch.ops.patching import DEFAULT_SPLIT_PARAMS
from ealdm_torch.ops.schedules import DDIMSchedule, DiffusionSchedule
from ealdm_torch.training.callbacks import to_uint8_grid
from ealdm_tpu.ops import schedules as jax_schedules
from tests.test_notebook_helpers import _tiny_sr_model
from tests.test_torch_port_cond import build, gc_paused

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("unet_config", "first_stage_config", "cond_stage_config", "conditioning_key",
        "cond_stage_key", "timesteps", "unconditional_guidance_scale")


def _png(tmp_path, arr):
    from PIL import Image

    path = str(tmp_path / "lr.png")
    Image.fromarray(arr).save(path)
    return path


def _lr(side, seed=0):
    return (np.random.RandomState(seed).rand(side, side, 3) * 255).astype(np.uint8)


def test_get_cond_matches(tmp_path):
    arr = _lr(16)
    want = nh.get_cond("superresolution", _png(tmp_path, arr))
    got = tnh.get_cond("superresolution", arr, device="cpu")
    for key in ("LR_image", "image"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
    np.savez(tmp_path / "one.npz", lr=arr)
    assert torch.equal(tnh.get_cond("superresolution", str(tmp_path / "one.npz"),
                                    device="cpu")["LR_image"], got["LR_image"])
    # a PNG path reads through the port's PNG reader (JAX's reads it with PIL)
    from_png = tnh.get_cond("superresolution", str(tmp_path / "lr.png"), device="cpu")
    for key in ("LR_image", "image"):
        assert torch.equal(from_png[key], got[key])
    with pytest.raises(ValueError, match="npz"):
        tnh.get_cond("superresolution", str(tmp_path / "lr.jpg"), device="cpu")
    assert tnh.get_cond("class_conditional", 7, device="cpu")["class_label"].tolist() == [7]


class _JitApply:
    """A JAX LatentDiffusion whose `apply` jits each method (its non-array
    arguments static), as JAX's own programs run it: `notebook_helpers`
    calls `model.apply` eagerly, op by op, three times slower here."""

    def __init__(self, module):
        self._m, self._fns = module, {}

    def __getattr__(self, name):
        return getattr(self._m, name)

    def clone(self, **changes):
        return _JitApply(self._m.clone(**changes))

    def apply(self, variables, *args, method):
        if not args:  # the schedule, not an array program
            return self._m.apply(variables, method=method)
        dyn = [i for i, a in enumerate(args) if isinstance(a, (jax.Array, np.ndarray))]
        static = tuple((i, a) for i, a in enumerate(args) if i not in dyn)
        key = (method.__name__, len(args), static)
        if key not in self._fns:
            fixed = dict(static)

            def fn(v, *arrays):
                it = iter(arrays)
                full = [fixed[i] if i in fixed else next(it) for i in range(len(args))]
                return self._m.apply(v, *full, method=method)

            self._fns[key] = jax.jit(fn)
        return self._fns[key](variables, *[args[i] for i in dyn])


def _jax_draws(shape, steps):
    """make_convolutional_sample's draws (seed 0): ddim_sample's x_T from
    the second half of its key's split, each step's noise from the step
    key's second split."""
    rng, init = jax.random.split(jax.random.PRNGKey(0))
    x_T = np.array(jax.random.normal(init, shape))
    noise = [np.array(jax.random.normal(jax.random.split(k)[1], shape))
             for k in jax.random.split(rng, steps)]
    return x_T, noise


@gc_paused()
def test_run_superresolution_matches(tmp_path):
    jm_ref = _tiny_sr_model()
    jm, variables, tm = build({k: getattr(jm_ref, k) for k in KEYS}, seed=3)
    arr = _lr(48, seed=1)
    want = nh.run(_JitApply(jm), variables, _png(tmp_path, arr), task="superresolution",
                  custom_steps=3)
    latent = (1, 48, 48, 3)
    sched = jax_schedules.DiffusionSchedule.create(timesteps=jm.timesteps)
    steps = jax_schedules.DDIMSchedule.create(sched, 3).num_steps
    x_T, noise = _jax_draws(latent, steps)
    got = tnh.run(tm, arr, custom_steps=3, x_T=torch.from_numpy(x_T),
                  noise_fn=lambda i, shape: torch.from_numpy(noise[i]))
    assert tm.split_input_params is None  # patching ran on a clone
    assert tuple(got["sample"].shape) == (1, 192, 192, 3)
    assert tuple(got["progressive_row"].shape) == (4, 1, 48, 48, 3)
    for key in ("input", "reconstruction", "original_conditioning", "progressive_row",
                "sample", "sample_noquant", "sample_diff"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), err_msg=key)
    assert got["time"] > 0


def test_superresolution_npz_is_the_png():
    from PIL import Image

    pixels = np.load(REPO / "ealdm_torch" / "data" / "superresolution_examples.npz")
    assert pixels.files == ["sample_0"]
    png = Image.open(REPO / "data" / "example_conditioning" / "superresolution" / "sample_0.png")
    assert pixels["sample_0"].dtype == np.uint8
    np.testing.assert_array_equal(pixels["sample_0"], np.asarray(png.convert("RGB")))


UNCOND = dict(
    unet_config=dict(image_size=8, in_channels=3, out_channels=3, model_channels=16,
                     num_res_blocks=1, attention_resolutions=[], channel_mult=[1],
                     num_heads=1),
    cond_stage_config="__is_unconditional__", timesteps=20,
)


def test_hoisting_falls_back_under_split_input(tmp_path):
    """An unconditional model hoists its emb tables; its clone with
    split_input_params takes the plain step; `get_model("stdiff")` builds
    the flagship's YAML and `visualize` writes a grid that
    `visualize_cond_img` reads back."""
    tm = TorchLDM(**UNCOND, device="cpu")
    ddim = DDIMSchedule.create(DiffusionSchedule.create(timesteps=20), 3)
    assert hoist_invariants(tm, ddim)[3] is not None
    patched = tm.clone(split_input_params=dict(DEFAULT_SPLIT_PARAMS))
    eps_fn, c, uc, tables = hoist_invariants(patched, ddim)
    assert eps_fn.__code__ is make_eps_fn(patched).__code__
    assert c is None and uc is None and tables is None
    assert patched.model is tm.model  # the clone shares the modules
    stdiff = tnh.get_model("stdiff", device="meta")
    flagship, _ = t_config.model_from_config(t_config.load_config(
        [str(REPO / "configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml")])["model"],
        device="meta")
    assert {k: p.shape for k, p in stdiff.named_parameters()} == \
        {k: p.shape for k, p in flagship.named_parameters()}
    assert stdiff.cond_stage_key == "mixed" and not stdiff.training
    images = np.random.RandomState(1).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    png = tnh.visualize(images, str(tmp_path / "grid.png"))
    grid = tnh.visualize_cond_img(png)
    assert grid.shape == (8, 16, 3) and grid.dtype == np.uint8
    np.testing.assert_array_equal(grid, to_uint8_grid(images))
    path = tnh.select_cond_path("superresolution", root=str(REPO / "data/example_conditioning"))
    assert path.endswith("superresolution/sample_0.png")


def test_get_model_restores_a_run_dir(tmp_path):
    """`get_model(run_dir=...)` on a one-step run of `ealdm_torch.main` (the
    micro STDiff YAML on a synthetic corpus): the run's model with the EMA
    shadow of its last checkpoint."""
    from ealdm_torch import main as t_main
    from ealdm_torch.data.synthetic import generate_synthetic_dataset

    corpus = tmp_path / "corpus"
    generate_synthetic_dataset(str(corpus), n_days=8, image_size=16, seed=2)
    logdir, _, state = t_main.main([
        "-b", str(REPO / "configs/smoke/stdiff_micro.yaml"), "-t", "--device", "cpu",
        "--max_steps", "1", "--third_stage", "false", "-l", str(tmp_path / "logs"),
        f"data.params.train.params.path={corpus}/",
        f"data.params.train.params.path_weather={corpus}/"])
    model = tnh.get_model(run_dir=logdir, device="cpu")
    assert not model.training
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), state.ema.shadow[k]), k
    assert any(not torch.equal(state.ema.shadow[k], p) for k, p in state.params.items())
