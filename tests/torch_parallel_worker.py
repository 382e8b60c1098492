"""Rank programs of tests/test_torch_port_parallel.py, spawned as one gloo
group on the CPU (`run_ranks`). They import torch and the port only, so a
rank starts in a few seconds; each writes what the test compares to
`<out>/rank<r>.pt`.
"""
import os
import socket

import numpy as np
import torch
import torch.multiprocessing as mp

DDPM_UNET = dict(image_size=8, in_channels=3, model_channels=8, out_channels=3,
                 num_res_blocks=1, attention_resolutions=[], channel_mult=[1], num_heads=1)
TP_UNET = dict(image_size=8, in_channels=3, model_channels=16, out_channels=3,
               num_res_blocks=1, attention_resolutions=[1], channel_mult=[1, 2], num_heads=2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), EALDM_DIST_TIMEOUT="60")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    from ealdm_torch.serving import maybe_initialize_distributed

    assert maybe_initialize_distributed(device="cpu")
    try:
        fn(rank, *args)
    finally:
        torch.distributed.destroy_process_group()


def start_ranks(fn, world: int, *args):
    """`fn(rank, *args)` in `world` spawned processes of one gloo group,
    running while the caller goes on; `join` waits for them."""
    return mp.start_processes(_entry, args=(world, free_port(), fn, args), nprocs=world,
                              start_method="spawn", join=False)


def join(ctx) -> None:
    """Wait for the ranks; raises when one failed (the others are ended)."""
    while not ctx.join():
        pass


def run_ranks(fn, world: int, *args):
    join(start_ranks(fn, world, *args))


def ddpm(params=None):
    from ealdm_torch.models.ddpm import DDPM
    from ealdm_torch.utils.flax_import import load_flax_params
    from ealdm_torch.utils.init import random_init_

    m = DDPM(unet_config=DDPM_UNET, timesteps=10, device="cpu")
    if params is None:
        random_init_(m, 5)
    else:
        load_flax_params(m, {"params": params}, device="cpu")
    return m


def _save(out, rank, prefix="", **kw):
    torch.save(kw, os.path.join(out, f"{prefix}rank{rank}.pt"))


def tp_sampling(rank, out, params, x_T, noises):
    """tests/test_tp_sampling.py's program at T = 2: the UNet cut over the
    model group, JAX's DDIM draws replayed."""
    from ealdm_torch.models import UNetModel
    from ealdm_torch.ops.schedules import DDIMSchedule, DiffusionSchedule
    from ealdm_torch.parallel import MeshConfig, create_mesh, shard_params
    from ealdm_torch.samplers import DDIMConfig, ddim_sample
    from ealdm_torch.utils.flax_import import load_flax_params

    unet = UNetModel(**TP_UNET)
    load_flax_params(unet, params, device="cpu")
    mesh = create_mesh(MeshConfig(model=2))
    shard_params(unet, mesh)
    ddim = DDIMSchedule.create(DiffusionSchedule.create(timesteps=20), 4)
    with torch.no_grad():
        z = ddim_sample(lambda x, t, c: unet(x, t), x_T.shape, ddim, DDIMConfig(num_steps=4),
                        x_T=torch.from_numpy(x_T),
                        noise_fn=lambda i, s: torch.from_numpy(noises[i].copy()))
    cut = {k: tuple(p.shape) for k, p in unet.named_parameters()
           if getattr(p, "tp_shard", None) is not None}
    _save(out, rank, z=z, cut=cut)


def _replayed(model, t, noise, rows):
    """model.training_loss with the step's t and noise (global arrays) cut
    to `rows`."""
    import functools

    model.training_loss = functools.partial(
        type(model).training_loss, model, t=torch.from_numpy(t[rows]).long(),
        noise=torch.from_numpy(noise[rows].copy()))


def dp_train(rank, out, params, batch, draws_by_step, lr):
    """tests/multiproc_worker.py's DDPM at --devices 2: two steps of the
    rank's rows with JAX's t and noise."""
    from ealdm_torch.parallel import MeshConfig, create_mesh, shard_batch
    from ealdm_torch.training import init_train_state, make_train_step

    m = ddpm(params)
    mesh = create_mesh(MeshConfig(data=2))
    state, opt = init_train_state(m, learning_rate=lr, device="cpu")
    step = make_train_step(m, opt, device="cpu", mesh=mesh)
    local = shard_batch({"img": torch.from_numpy(batch)}, mesh)
    b = local["img"].shape[0]
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    losses, norms = [], []
    for t, noise in draws_by_step:
        _replayed(m, t, noise, rows)
        state, metrics = step(state, local, torch.Generator().manual_seed(0))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    _save(out, rank, losses=losses, grad_norms=norms,
          params={k: p.detach().clone() for k, p in state.params.items()})


def dp_tp_train(rank, out, batch, lr, steps, sample_n):
    """The DDPM at dp2 x tp2 with the port's own draws: `steps` steps, the
    gathered state, this rank's state bytes, and a sampled batch of
    `sample_n` through `sample_images`."""
    from ealdm_torch.inference import sample_images
    from ealdm_torch.parallel import (MeshConfig, create_mesh, gather_state, shard_batch,
                                      shard_state)
    from ealdm_torch.parallel.sharding import _whole_tensor as whole_tensor
    from ealdm_torch.parallel.sharding import state_bytes
    from ealdm_torch.training import init_train_state, make_train_step

    m = ddpm()
    mesh = create_mesh(MeshConfig(data=2, model=2))
    state, opt = init_train_state(m, learning_rate=lr, device="cpu")
    shard_state(state, mesh, m)
    sd0 = {k: v.clone() for k, v in gather_state(state, mesh)["params"].items()}
    step = make_train_step(m, opt, device="cpu", mesh=mesh)
    local = shard_batch({"img": torch.from_numpy(batch)}, mesh)
    gen = torch.Generator().manual_seed(23)
    metrics, grads = [], None
    for _ in range(steps):
        state, mt = step(state, local, gen)
        metrics.append({k: float(v) for k, v in mt.items()})
        if grads is None:  # the first step's averaged gradients, whole
            grads = {k: whole_tensor(p.grad, getattr(p, "tp_shard", None))
                     for k, p in state.params.items() if p.grad is not None}
    sd = gather_state(state, mesh)
    imgs = sample_images(m, sample_n, (8, 8, 3), steps=3, eta=1.0, decode=False,
                         generator=torch.Generator().manual_seed(3), device="cpu", mesh=mesh)
    _save(out, rank, metrics=metrics, state=sd if rank == 0 else None,
          state0=sd0 if rank == 0 else None, grads=grads, bytes=state_bytes(state),
          samples=imgs)


def ddpm_state_numbers(lr, batch, steps, sample_n):
    """The same program in one process: metrics, state and samples."""
    from ealdm_torch.inference import sample_images
    from ealdm_torch.training import init_train_state, make_train_step

    m = ddpm()
    state, opt = init_train_state(m, learning_rate=lr, device="cpu")
    state0 = {k: v.clone() for k, v in state.state_dict()["params"].items()}
    step = make_train_step(m, opt, device="cpu")
    gen = torch.Generator().manual_seed(23)
    metrics, grads = [], None
    for _ in range(steps):
        state, mt = step(state, {"img": torch.from_numpy(batch)}, gen)
        metrics.append({k: float(v) for k, v in mt.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.params.items() if p.grad is not None}
    imgs = sample_images(m, sample_n, (8, 8, 3), steps=3, eta=1.0, decode=False,
                         generator=torch.Generator().manual_seed(3), device="cpu")
    return dict(model=m, state=state, state0=state0, metrics=metrics, grads=grads,
                samples=imgs)


def global_batch():
    return (np.random.RandomState(0).randn(16, 8, 8, 3).astype(np.float32) * 0.1)


AE_TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "smoke", "autoencoder_tiny.yaml")


def vae_numbers(mesh_fn, steps, lr):
    """The tiny KL autoencoder's VAE-GAN steps (GAN terms on from step 0) on
    a seeded batch of 4, data-parallel over `mesh_fn()` when given: each
    step's metrics and the updated parameters."""
    from ealdm_torch import config as t_config
    from ealdm_torch.parallel import shard_batch
    from ealdm_torch.training import (build_autoencoder, init_vae_train_state,
                                      make_vae_train_step, random_init_autoencoder_)

    cfg = t_config.load_config([AE_TINY], [])
    vae, loss = build_autoencoder(cfg["model"], device="cpu")
    random_init_autoencoder_(vae, loss, 0)
    state, opt_ae, opt_disc = init_vae_train_state(vae, loss, learning_rate=lr, device="cpu")
    mesh = mesh_fn() if mesh_fn is not None else None
    step = make_vae_train_step(vae, loss, opt_ae, opt_disc, device="cpu", mesh=mesh)
    images = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (4, 32, 32, 3))
                              .astype(np.float32))
    batch = {"image": images if mesh is None else shard_batch(images, mesh)}
    metrics = []
    for i in range(steps):
        state, m = step(state, batch, torch.Generator().manual_seed(7 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    params = {k: p.detach().clone() for k, p in {**state.ae_params,
                                                   **state.loss_params}.items()}
    return metrics, params


def vae_dp_train(rank, out, steps, lr):
    from ealdm_torch.parallel import MeshConfig, create_mesh

    metrics, params = vae_numbers(lambda: create_mesh(MeshConfig(data=2)), steps, lr)
    _save(out, rank, "vae_", metrics=metrics, params=params)


def layers_tp(rank, out):
    """`Dense`, `Conv2D` and `Embed` cut over a model group of two, trainable
    (their slice of the output, gathered) and frozen (the weight gathered),
    against the same layers whole on the same inputs: outputs, and the
    trainable ones' input and weight gradients (the rank's slice)."""
    from ealdm_torch.models.layers import Conv2D, Dense, Embed
    from ealdm_torch.parallel import MeshConfig, create_mesh, shard_params
    from ealdm_torch.utils.init import random_init_

    g = torch.Generator().manual_seed(0)
    inputs = {"dense": torch.randn(3, 5, 6, generator=g),
              "conv": torch.randn(2, 4, 6, 6, generator=g),
              "embed": torch.randint(0, 7, (3, 4), generator=g)}
    mesh = create_mesh(MeshConfig(model=2))

    def layers(frozen):
        out = torch.nn.ModuleDict({"dense": Dense(6, 8), "conv": Conv2D(4, 8, 3),
                                   "embed": Embed(7, 4)})
        random_init_(out, 1)
        return out.requires_grad_(not frozen)

    res = {}
    for frozen in (False, True):
        for kind, mods in (("whole", layers(frozen)),
                           ("cut", shard_params(layers(frozen), mesh))):
            for name, layer in mods.items():
                x = inputs[name].clone().requires_grad_(name != "embed" and not frozen)
                y = layer(x)
                grads = {}
                if not frozen:
                    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
                    (y * cot).sum().backward()
                    grads = {"x": x.grad, "weight": next(layer.parameters()).grad}
                res[(name, frozen, kind)] = (y.detach(), grads)
    _save(out, rank, "layers_", res=res, index=mesh.model_index)


def two_rank_jobs(rank, out, tp_args, dp_args, vae_args):
    """`layers_tp`, `tp_sampling`, `dp_train` and `vae_dp_train` in one
    spawn of two ranks."""
    layers_tp(rank, os.path.join(out, "tp"))
    tp_sampling(rank, os.path.join(out, "tp"), *tp_args)
    dp_train(rank, os.path.join(out, "dp"), *dp_args)
    vae_dp_train(rank, os.path.join(out, "dp"), *vae_args)
