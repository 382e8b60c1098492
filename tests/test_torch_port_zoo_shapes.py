"""The port's model zoo (`ealdm_torch/zoo.py`) against the JAX package's
(`ealdm_tpu/zoo.py`) at full width, without weights:

- the tables are the same data, and each LDM entry's keyword arguments are
  the fields of the module JAX's `zoo.build` makes;
- every `ealdm_tpu.zoo.names()` entry builds in the port on torch's "meta"
  device;
- for the entries the port's chip paths run (`ldm/lsun_churches256`,
  `ldm/inpainting_big`, `ldm/semantic_synthesis256`,
  `first_stage_models/vq-f4-noattn`, `ldm/bsr_sr`) the port's parameters
  have exactly the
  names and shapes of `flax_to_state_dict` of `jax.eval_shape` of the JAX
  init. (`jax.eval_shape` of one full-width zoo init takes 2-4 s here, so
  the other entries build without the comparison.)

It also holds `ealdm_torch/data/inpainting_examples.npz`, the pixels that
`chip_smoke.py` feeds `ldm/inpainting_big`, to the committed PNGs.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ealdm_torch import zoo
from ealdm_torch.utils.flax_import import flax_to_state_dict
from ealdm_tpu import zoo as jax_zoo


def test_tables_match():
    assert zoo.names() == jax_zoo.names()
    assert zoo.FIRST_STAGES == jax_zoo.FIRST_STAGES
    assert zoo.LDM_ZOO == jax_zoo.LDM_ZOO
    for name in jax_zoo.names():
        assert zoo.spec(name) == jax_zoo.spec(name)
        if name.startswith("ldm/"):
            jm = jax_zoo.build(name)
            for key, value in zoo.model_kwargs(name).items():
                assert getattr(jm, key) == value, (name, key)


@pytest.mark.parametrize("name", jax_zoo.names())
def test_every_entry_builds_on_meta(name):
    m = zoo.build(name, device="meta")
    params = list(m.parameters())
    assert params and all(p.is_meta for p in params)


def _touch_ldm(m, img, x, t, cond):
    """Every submodule of the JAX LDM once: the first stage's encode and
    decode, the cond stage on `cond` (or none) and the denoiser."""
    m.encode_first_stage(img, sample_posterior=False)
    m.decode_first_stage(x)
    c = None if cond is None else m.get_learned_conditioning(cond)
    if m.cond_stage_config == "__is_first_stage__":  # inpainting: join the mask
        c = jnp.concatenate([c, jnp.zeros(c.shape[:3] + (1,), c.dtype)], axis=-1)
    return m.apply_model(x, t, c)


def _jax_shapes(name):
    """The JAX init's parameter shapes of a zoo entry at batch 1."""
    jm = jax_zoo.build(name)
    key = jax.random.key(0, impl="unsafe_rbg")
    img = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    if name.startswith("first_stage_models/"):
        return jax.eval_shape(lambda r, x: jm.init(r, x, method=lambda m, x: m.decode_interface(
            m.encode_prequant(x))), key, img)
    spec = jax_zoo.spec(name)
    side = spec["unet"]["image_size"]
    x = jax.ShapeDtypeStruct((1, side, side, spec["unet"]["out_channels"]), jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.int32)
    cond = {"segmentation": jax.ShapeDtypeStruct((1, 256, 256, 182), jnp.float32),
            "masked_image": img,
            "LR_image": jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32),
            }.get(spec.get("cond_stage_key"))
    return jax.eval_shape(lambda r, *a: jm.init(r, *a, method=_touch_ldm), key, img, x, t,
                          cond)


@pytest.mark.parametrize("name", ["ldm/lsun_churches256", "ldm/inpainting_big",
                                  "ldm/semantic_synthesis256",
                                  "first_stage_models/vq-f4-noattn", "ldm/bsr_sr"])
def test_opened_entries_match_the_jax_tree(name):
    # zero-stride views stand in for the arrays: the bridge only transposes them
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                  _jax_shapes(name))
    want = {k: tuple(np.shape(v)) for k, v in flax_to_state_dict(tree).items()}
    got = {k: tuple(p.shape) for k, p in zoo.build(name, device="meta").named_parameters()}
    assert sorted(got) == sorted(want)
    assert got == want


def test_inpainting_examples_npz_is_the_pngs():
    """The npz holds the `data/inpainting_examples` PNGs decoded (uint8, RGB
    [H, W, 3] and mask [H, W, 1]), as PIL reads them; made with
    `np.savez_compressed` from these arrays."""
    from PIL import Image

    root = Path(__file__).resolve().parents[1]
    pixels = np.load(root / "ealdm_torch" / "data" / "inpainting_examples.npz")
    assert sorted(pixels.files) == ["example0", "example0_mask", "example1", "example1_mask"]
    for name in pixels.files:
        img = Image.open(root / "data" / "inpainting_examples" / f"{name}.png")
        want = np.asarray(img.convert("L"))[..., None] if name.endswith("_mask") else \
            np.asarray(img.convert("RGB"))
        assert pixels[name].dtype == np.uint8
        np.testing.assert_array_equal(pixels[name], want)
