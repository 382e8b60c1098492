"""Training under every conditioning key in the port against the JAX
package, float32 on the CPU, weights from one seeded random flax tree:
`LatentDiffusion.training_loss` and its gradients against
`jax.value_and_grad` of JAX's `training_loss` (train=False: no dropout),
fed the same t, noise and conditioning noise (JAX's own draws from its key,
replayed), for

- text: the tiny txt2img YAML (BERT cond stage, crossattn, target under
  `first_stage_key` "image"), and again with `num_timesteps_cond=4` (the
  shortened schedule noises the BERT context);
- class: a tiny cin256-v2 layout (trainable ClassEmbedder);
- LR_image: a tiny bsr_sr layout (Identity cond stage, concat), and again
  with split-input patching (patched encode, a 3x3 patched UNet);
- masked_image: `__is_first_stage__` on a VQ first stage, concat.

The loss within 1e-5 relative, each trainable gradient within 1e-4 of its
largest element. Then one `make_train_step` of the class model: the
trainable cond stage's parameters move, the frozen first stage's do not;
and `make_eval_step` on the LR model.
"""
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ealdm_torch import config as t_config
from ealdm_torch.training import init_train_state, make_eval_step, make_train_step
from ealdm_torch.utils.flax_import import flax_to_state_dict
from ealdm_tpu.config import _LD_KEYS
from ealdm_tpu.models.text_transformer import SimpleTokenizer as JaxTokenizer
from tests.test_torch_port_cond import build, gc_paused

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 2


def _text_kw():
    """The tiny txt2img YAML with a one-level UNet whose cross-attention is
    in the middle block only (JAX traces and compiles each block's
    backward, about a second apiece)."""
    p = yaml.safe_load((REPO / "configs/smoke/txt2img_tiny.yaml").read_text())["model"]["params"]
    kw = {k: p[k] for k in _LD_KEYS if k in p}
    kw.update(unet_config=dict(p["unet_config"]["params"], attention_resolutions=[],
                               channel_mult=[1]),
              first_stage_config=p["first_stage_config"],
              cond_stage_config=p["cond_stage_config"])
    return kw


def _class_kw():
    kw = t_config.model_kwargs(t_config.CIN256)
    kw["unet_config"].update(image_size=8, model_channels=16, channel_mult=[1],
                             attention_resolutions=[], num_res_blocks=1, context_dim=16)
    kw["first_stage_config"]["params"]["n_embed"] = 32
    kw["first_stage_config"]["params"]["ddconfig"].update(resolution=32, ch=16,
                                                          ch_mult=[1, 2, 2])
    kw["cond_stage_config"]["params"].update(n_classes=11, embed_dim=16)
    return kw


def _vq_f4(ch=8, n_embed=32, res=64):
    return {"target": "ldm.models.autoencoder.VQModelInterface", "params": {
        "embed_dim": 3, "n_embed": n_embed, "ddconfig": dict(
            double_z=False, z_channels=3, resolution=res, in_channels=3, out_ch=3, ch=ch,
            ch_mult=[1, 2, 4], num_res_blocks=1, attn_resolutions=[], dropout=0.0)}}


# the tiny super-resolution model of tests/test_notebook_helpers.py, its
# UNet cut to one level (as the others here)
SR = dict(
    unet_config=dict(image_size=16, in_channels=6, out_channels=3, model_channels=16,
                     attention_resolutions=[8], num_res_blocks=1, channel_mult=[1],
                     num_head_channels=8),
    first_stage_config=_vq_f4(), cond_stage_config={"target": "torch.nn.Identity"},
    conditioning_key="concat", cond_stage_key="LR_image", timesteps=20,
    unconditional_guidance_scale=1.0,
)
MASKED = dict(
    unet_config=dict(image_size=8, in_channels=6, out_channels=3, model_channels=16,
                     attention_resolutions=[], num_res_blocks=1, channel_mult=[1],
                     num_heads=2),
    first_stage_config=_vq_f4(ch=8, n_embed=16, res=32), cond_stage_config="__is_first_stage__",
    conditioning_key="concat", cond_stage_key="masked_image", timesteps=50,
    linear_start=0.0015, linear_end=0.0205,
)
PATCH = dict(ks=(8, 8), stride=(4, 4), vqf=4, patch_distributed_vq=True, tie_braker=False,
             clip_max_weight=0.5, clip_min_weight=0.01, clip_max_tie_weight=0.5,
             clip_min_tie_weight=0.01)


def _case(name):
    """(model kwargs, the batch as numpy, the latent's shape)."""
    rng = np.random.RandomState(11)

    def img(side):
        return rng.uniform(-1, 1, (B, side, side, 3)).astype(np.float32)

    if name.startswith("text"):
        kw = _text_kw()
        if name == "text_cond4":
            kw["num_timesteps_cond"] = 4
        csp = kw["cond_stage_config"]["params"]
        tok = JaxTokenizer(csp["vocab_size"], csp["max_seq_len"])
        ids = np.array(tok(["a lighthouse at dusk", "two cats on a sofa"]))
        return kw, {"image": img(32), "caption": ids}, (B, 16, 16, 4)
    if name == "class":
        return _class_kw(), {"image": img(32), "class_label": np.array([3, 10], np.int32)}, \
            (B, 8, 8, 3)
    if name.startswith("lr_image"):
        kw = copy.deepcopy(SR)
        if name == "lr_image_patched":
            kw["split_input_params"] = PATCH
        return kw, {"img": img(64), "LR_image": img(16)}, (B, 16, 16, 3)
    masked = img(32)
    masked[:, 8:24, 8:24] = 0.0
    return copy.deepcopy(MASKED), {"img": img(32), "masked_image": masked}, (B, 8, 8, 3)


def _jax_draws(jm, variables, batch, z_shape, rng):
    """JAX training_loss's t, noise and conditioning noise from `rng`
    (`ealdm_tpu/models/ddpm.py` training_loss: split into 4; t from the
    second key, the noise from the third, the conditioning's from the
    fourth)."""
    rngs = jax.random.split(rng, 4)
    t = jax.random.randint(rngs[1], (z_shape[0],), 0, jm.timesteps)
    noise = jax.random.normal(rngs[2], z_shape)
    c_noise = None
    if jm.num_timesteps_cond > 1:
        cond = jax.eval_shape(lambda v, c: jm.apply(v, c, method=jm.get_learned_conditioning),
                              variables, batch[jm.cond_stage_key])
        c_noise = torch.from_numpy(np.array(jax.random.normal(rngs[3], cond.shape)))
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise)), c_noise


def _close_to_max(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    limit = rel * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("name", ["text", "text_cond4", "class", "lr_image",
                                  "lr_image_patched", "masked_image"])
@gc_paused()
def test_training_loss_and_gradients_match(name):
    kw, batch, z_shape = _case(name)
    jm, variables, tm = build(kw, seed=12)
    rng = jax.random.PRNGKey(13)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(params):
        return jm.apply({"params": params}, jbatch, rng, train=False, method=jm.training_loss)

    # XLA's backend optimisations off: a third less compile time, float32 kept
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        variables["params"]).compile({"xla_backend_optimization_level": 0})
    (loss_j, metrics_j), grads_j = grad_fn(variables["params"])
    t, noise, c_noise = _jax_draws(jm, variables, batch, z_shape, rng)

    tm.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tm.training_loss(tb, None, t=t, noise=noise, cond_noise=c_noise,
                                     train=False)
    loss.backward()
    assert loss.item() == pytest.approx(float(loss_j), rel=1e-5)
    for k in ("loss_simple", "loss_vlb"):
        assert metrics[k].item() == pytest.approx(float(metrics_j[k]), rel=1e-5), k

    # A gradient that is zero in exact arithmetic (a bias or emb projection
    # before a GroupNorm of one channel a group; cross-attention's q and k
    # over a one-token context) is rounding noise on both sides, up to 2e-7
    # of the model's largest gradient here: both must stay below 1e-6 of it.
    want = flax_to_state_dict(jax.device_get(grads_j))
    trainable = [k for k, p in tm.named_parameters() if p.requires_grad]
    noise_floor = 1e-6 * max(np.abs(want[k]).max() for k in trainable)
    for k, p in tm.named_parameters():
        if not p.requires_grad:  # the frozen first stage (zeros in JAX)
            assert p.grad is None and k.startswith("first_stage_model"), k
            assert not np.any(want[k]), k
        elif np.abs(want[k]).max() <= noise_floor:
            assert p.grad.abs().max().item() <= noise_floor, k
        else:
            _close_to_max(p.grad, want[k], 1e-4, k)
    if tm.cond_stage_model is not None:
        assert any(k.startswith("cond_stage_model") for k in trainable)


@gc_paused()
def test_train_step_moves_the_cond_stage_and_not_the_first_stage():
    """One step of the class model (AdamW): every trainable tensor, the
    ClassEmbedder's table included, gets a gradient and moves; the first
    stage's tensors are left bit for bit. Then the eval step of the LR
    model, whose Identity conditioning `encode_inputs` encodes."""
    kw, batch, _ = _case("class")
    _, _, tm = build(kw, seed=14)
    state, opt = init_train_state(tm, learning_rate=1e-3, use_ema=False, device="cpu")
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    step = make_train_step(tm, opt, remat="none", device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step(state, tb, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["loss"].item()) and metrics["grad_norm"].item() > 0
    assert "cond_stage_model.embedding.embedding" in state.opt_state.mu
    for k, p in tm.named_parameters():
        moved = not torch.equal(p.detach(), before[k])
        assert moved == (not k.startswith("first_stage_model")), k

    kw, batch, _ = _case("lr_image")
    _, _, tm = build(kw, seed=15)
    state, _ = init_train_state(tm, use_ema=True, device="cpu")
    enc = tm.encode_inputs({k: torch.from_numpy(v) for k, v in batch.items()})
    assert torch.equal(enc["cond"], torch.from_numpy(batch["LR_image"]))
    out = make_eval_step(tm, device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())
    assert out["loss"].item() == pytest.approx(out["loss_ema"].item(), rel=1e-6)
