"""`inference.log_images` of the port against the JAX package's, float32
on the CPU: the image logger's bundle of a tiny unconditional VQ LDM with
every row turned on. Its JAX side samples four chains, each compiled anew,
and decodes fourteen times op by op: about 20 s, so it has a file (and a
test worker) of its own.

Tolerance: 1e-5 of each compared entry's scale (float32 through the VQ
decoder, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ealdm_torch.inference import log_images
from ealdm_tpu.inference import log_images as jax_log_images
from tests.test_torch_port_cond import build, close_to_scale, gc_paused
from tests.test_torch_port_zoo import B, tiny_zoo

torch.set_num_threads(1)


@gc_paused()
def test_log_images_matches():
    """log_images on a tiny VQ unconditional LDM (celeba256's, one UNet
    level) with the inpainting, outpainting and progressive rows: JAX's keys in its
    order and shapes; the entries that draw no noise ("inputs",
    "reconstruction", "mask") by value; every entry finite."""
    kw = tiny_zoo("ldm/celeba256",
                  dict(image_size=8, model_channels=16, attention_resolutions=[],
                       channel_mult=[1], num_res_blocks=1, num_head_channels=16),
                  dict(resolution=16, ch=16, ch_mult=[1, 2], num_res_blocks=1), n_embed=32)
    jm, variables, tm = build(kw, seed=14)
    batch = {"img": np.random.RandomState(15).uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)}
    opts = dict(n=B, steps=2, eta=1.0, inpaint=True, plot_progressive_rows=True)
    want = jax_log_images(jm, variables, {"img": jnp.asarray(batch["img"])},
                          jax.random.PRNGKey(16), **opts)
    got = log_images(tm, {"img": torch.from_numpy(batch["img"])},
                     torch.Generator().manual_seed(16), device="cpu", **opts)
    assert list(got) == list(want)
    for key, value in got.items():
        assert tuple(value.shape) == tuple(want[key].shape), key
        assert bool(torch.isfinite(value).all()), key
    for key in ("inputs", "reconstruction", "mask"):
        close_to_scale(got[key], want[key])
    assert got["diffusion_row"].shape == (B, 16, 6 * 16, 3)


def test_layout_tokens_and_plot_match():
    """The "bbox_image" row's pieces: the port's BBoxTokenizer encodes and
    decodes a layout as JAX's does, and render_layout draws the same
    picture."""
    from ealdm_torch.data.layout import BBoxTokenizer, render_layout
    from ealdm_tpu.data import layout as j_layout

    boxes = [(3, 0.1, 0.2, 0.6, 0.9), (600, 0.75, 0.05, 0.3, 0.4), (17, 0.0, 0.0, 1.0, 1.0)]
    ids = BBoxTokenizer().encode(boxes)
    np.testing.assert_array_equal(ids, j_layout.BBoxTokenizer().encode(boxes))
    decoded = BBoxTokenizer().decode(ids)
    assert decoded == j_layout.BBoxTokenizer().decode(ids)
    np.testing.assert_array_equal(render_layout(decoded, 64),
                                  j_layout.render_layout(decoded, 64))
