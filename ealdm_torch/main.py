"""The port's training entry point (counterpart of the root `main.py`):

    python -m ealdm_torch.main -b configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml -t \\
        [--dtype bfloat16] [--device cuda] [--devices N] [--tp T] [a.b.c=value ...]
    torchrun --nproc_per_node N -m ealdm_torch.main -b ... -t [--tp T]

The YAML configs are merged left to right and the trailing `a.b.c=value`
overrides applied (`config.load_config`, with the port's YAML reader); the
run lives in a timestamped logdir with configs/, checkpoints/, images/,
metrics.jsonl and tb/. The learning rate scales as accumulate x devices x
batch x base_lr. An LDM config trains `make_train_step`
over the config's DataModule through the device prefetcher, with
`scale_by_std` from the first batch, the YAML's scheduler, EMA,
ImageLogger grids, validation through `make_eval_step` every
--val_every_epochs, top-k and last checkpoints on the config's monitor, and
a crash or SIGUSR1 checkpoint. A first-stage config (AutoencoderKL,
VQModel) trains the two-optimizer VAE-GAN step (`train_autoencoder`).
After an LDM's training on a `cond_stage_key: mixed` model, the third
stage runs unless `--third_stage false` (`third_stage.py`): a dump of the
train and the test split (`--third_stage_max_batches` batches each, with
the CLIP scorer then at 64^2, else 224^2), the heads' training and the
evaluation, with the flow scaler of the train data's path.
`-r <logdir or checkpoint>` reads the run's configs/*.yaml back and
restores its last checkpoint, the port's or one the JAX `main.py` wrote
(an orbax `last/state`, known by its files: `training/orbax_format.py`),
and trains on from its step; without `-t` the run is set up and returned.

Distribution, as the JAX `main.py`'s mesh: an LDM trains over a `data` x
`model` layout of N ranks (`--devices N`, `--tp T`: N / T data ranks, each
a model group of T ranks cutting the state by `parallel.shard_state`), one
process a rank. Under a launcher (torchrun, or any that sets the
environment `serving.maybe_initialize_distributed` reads) the ranks are its
processes and --devices defaults to WORLD_SIZE; otherwise --devices
defaults to the visible cards (1 on the CPU), and above 1 this process
builds the kernels once and spawns its N workers itself, after JAX's rule
(reduce N by T until the batch splits over N / T data ranks, with JAX's
"Reduced device count" line); a launcher's world the batch does not split
over is refused. Each rank loads its rows of the global batches; every rank
draws the same step seeds; the first batch's `scale_by_std` is the global
batch's. Rank 0 writes every file and the whole, gathered state as one
process writes it, so a checkpoint resumes under any layout. The image log
runs on the ranks of data index 0 (its batch: rank 0's rows), validation on
every rank; the third stage runs on rank 0 on the gathered model after the
others have left. A first-stage config is not distributed, as in JAX: its
learning rate scales by --devices, and under a launcher each rank runs the
whole step.

Deltas from the JAX `main.py`:
  * `--device` (default "cuda", which raises without a card; the tests
    pass "cpu");
  * no crash checkpoint when more than one rank runs (it would need every
    rank to gather the state);
  * attention at eligible self-attention sites runs the flash kernel
    (`kernel_settings`; the JAX `main.py` keeps dense attention);
  * weights are seeded random (`utils.init.random_init_`, seed `--seed`);
    the step's t, noise and dropout come from a CPU generator seeded with
    `--seed`, one draw a step;
  * `scale_by_std` measures 1/std of the first batch's latents through the
    model's own first stage (the JAX `main.py` encodes with a second random
    initialisation);
  * the third stage's two dumps draw from generators on the device, each
    seeded by a draw of the loop's generator;
  * `-r` resumes a first-stage run too, from its step (the JAX `main.py`
    reads the logdir's configs and starts its autoencoder at step 0).
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import glob
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

_AE_TARGETS = ("AutoencoderKL", "VQModel", "VQModelInterface")


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def get_parser():
    p = argparse.ArgumentParser(description="ealdm_torch trainer")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="",
                   help="resume from logdir or checkpoint dir")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml", default=[],
                   help="configs, merged left-to-right")
    p.add_argument("-t", "--train", action="store_true", default=False)
    p.add_argument("--no-test", action="store_true", default=False)
    p.add_argument("-d", "--debug", action="store_true", default=False)
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-f", "--postfix", type=str, default="")
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--scale_lr", type=str2bool, default=True)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=1000)
    p.add_argument("--devices", type=int, default=None,
                   help="ranks, one a device: WORLD_SIZE under a launcher, else the "
                        "visible cards (1 on the CPU)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace train steps 2..2+N with torch.profiler into <logdir>/profile")
    p.add_argument("--val_every_epochs", type=int, default=1)
    p.add_argument("--ckpt_every_epochs", type=int, default=1)
    p.add_argument("--third_stage", type=str2bool, default=True)
    p.add_argument("--third_stage_max_batches", type=int, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains: cuda (default; raises without a card) or cpu")
    return p


def init_model_weights(model, seed: int) -> None:
    """Seeded random weights of a freshly built LDM (no checkpoint is
    downloaded)."""
    from .utils.init import random_init_

    random_init_(model, seed)


def init_autoencoder_weights(vae, loss_module, seed: int) -> None:
    from .training import random_init_autoencoder_

    random_init_autoencoder_(vae, loss_module, seed)


def std_scale_factor(model, img) -> float:
    """1 / std of the first stage's latents of `img` (the reference's
    scale_by_std; a KL posterior's sample from a generator seeded with 1)."""
    dev = img.device
    with torch.no_grad():
        z = model.encode_first_stage(img, torch.Generator(device=dev).manual_seed(1))
    return float(1.0 / z.float().std(unbiased=False))


def _data(config, seed: int, rows=None):
    """(DataModule, batch size, dataset configs) of config.data; rows: a
    data rank's (index, count)."""
    from .data.pipeline import DataModule

    data_cfg = dict(config["data"]["params"])
    batch_size = data_cfg.pop("batch_size")
    dataset_cfgs = {k: data_cfg.pop(k) for k in ("train", "validation", "test", "predict")
                    if k in data_cfg}
    return (DataModule(batch_size=batch_size, dataset_configs=dataset_cfgs,
                       wrap=data_cfg.get("wrap", False), seed=seed, rows=rows),
            batch_size, dataset_cfgs)


def shrink_devices(n_dev: int, batch_size: int, tp: int) -> int:
    """JAX's rule: the per-step batch must split over the data ranks, so
    the device count drops by the tensor-parallel degree until it does."""
    while n_dev > 1 and batch_size % (n_dev // tp) != 0:
        n_dev -= tp
    return n_dev


def _visible_devices(device) -> int:
    """The default --devices outside a launcher: the visible cards (as JAX's
    len(jax.devices())), 1 on the CPU."""
    if torch.device(device).type != "cuda":
        return 1
    return max(1, torch.cuda.device_count())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, argv, now, cpu, on_batch, on_step, on_state):
    """One spawned rank: the launcher's environment, then `main`. Ranks on
    the CPU share its cores."""
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      EALDM_RUN_TIME=now)
    main(argv, on_batch=on_batch, on_step=on_step, on_state=on_state)


def spawn(argv, n: int, now: str, device, on_batch=None, on_step=None, on_state=None) -> None:
    """Run `main(argv)` in n new processes, ranks 0..n-1 of one group on
    this host (the hooks must pickle). The kernels are built first, so the
    ranks load one build instead of racing to make it. Raises when a rank
    fails, after ending the others."""
    import torch.multiprocessing as mp

    cpu = torch.device(device).type == "cpu"
    if not cpu:
        from .kernels.build import build_all

        build_all()
    mp.start_processes(_worker, nprocs=n, start_method="spawn", join=True,
                       args=(n, _free_port(), list(argv), now, cpu, on_batch, on_step, on_state))


def _with_devices(argv, n: int):
    """argv with --devices n."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--devices":
            argv[i + 1] = str(n)
            return argv
        if a.startswith("--devices="):
            argv[i] = f"--devices={n}"
            return argv
    return argv + ["--devices", str(n)]


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (), generator=generator))


def _host(metrics):
    """0-d tensors -> float32 numpy scalars (the JAX `main.py`'s device_get)."""
    return {k: np.float32(v.item()) if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def _batches(prefetch, timer):
    """The prefetcher's batches, the wait for each in timer's "data_wait"."""
    it = iter(prefetch)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        timer.add("data_wait", time.perf_counter() - t0)
        if batch is None:
            return
        yield batch


@contextlib.contextmanager
def kernel_settings():
    """The entry point's op settings, the process's own restored on leaving:
    attention at eligible self-attention sites through the flash kernel
    (`set_attention_impl("flash")`; the JAX `main.py` keeps the dense default),
    norm statistics in float32 (the default of both packages)."""
    from .ops import attention, norms

    saved = attention.attention_impl(), norms._NORM_STATS_DTYPE
    attention.set_attention_impl("flash")
    norms.set_norm_stats_precision("fp32")
    try:
        yield
    finally:
        attention.set_attention_impl(saved[0])
        norms.set_norm_stats_precision(saved[1])


def main(argv=None, *, on_batch=None, on_step=None, on_state=None, timer=None):
    """Train (with -t) or set up the run of `argv` (sys.argv[1:] if None);
    returns (logdir, model, state), or (logdir, None, None) where it spawned
    the ranks. `on_batch(step, batch, generator)`, if given, sees each
    training batch on the device before its step and the generator the step
    will draw from; `on_step(step, metrics)` sees each step's metrics
    (tensors on the device) right after it; `on_state(model, state, mesh)`
    sees an LDM's model and train state once, cut to the rank's slices,
    before the first step; `timer` (a `utils.profiling.StepTimer`) collects
    the loop's "data_wait" and "train_step" seconds. Spawned ranks take the
    three hooks (they must pickle), not the timer. Runs under
    `kernel_settings()`. The SIGUSR1 handler it installs (the crash
    checkpoint, which holds the run's state) gives way to the caller's own
    on return."""
    # finalize CUPTI when a trace ends (see utils/profiling.py)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        with kernel_settings():
            return _main(argv, on_batch, on_step, on_state, timer)
    finally:
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGUSR1, signal.SIG_DFL if previous is None else previous)


def _main(argv, on_batch, on_step, on_state, timer):
    argv = sys.argv[1:] if argv is None else list(argv)
    opt, unknown = get_parser().parse_known_args(argv)
    from .parallel import comm
    from .parallel.mesh import world
    from .serving import maybe_initialize_distributed

    # the process group of a launcher's environment (a no-op without one)
    maybe_initialize_distributed(opt.device)
    size, rank = world()
    launched = size > 1
    # one run time on every rank: the spawner's, else rank 0's
    now = os.environ.get("EALDM_RUN_TIME") or datetime.datetime.now().strftime(
        "%Y-%m-%dT%H-%M-%S")
    now = comm.broadcast_object(now)
    if opt.resume:
        paths = opt.resume.split("/")
        if os.path.isdir(opt.resume) and "checkpoints" not in paths:
            logdir = opt.resume.rstrip("/")
        else:
            logdir = "/".join(paths[:paths.index("checkpoints")])
        opt.base = sorted(glob.glob(os.path.join(logdir, "configs", "*.yaml"))) + opt.base
        resume_ckpt_dir = os.path.join(logdir, "checkpoints")
    else:
        name = "_" + (opt.name or (os.path.splitext(os.path.basename(opt.base[0]))[0]
                                   if opt.base else "run"))
        logdir = os.path.join(opt.logdir, now + name + opt.postfix)
        resume_ckpt_dir = None

    from .config import load_config, model_from_config
    from .data.pipeline import DevicePrefetcher
    from .training import (CheckpointManager, DeviceStatsCallback, ImageLogger, MetricLogger,
                           SetupCallback, build_scheduler, init_train_state, make_eval_step,
                           make_optimizer, make_train_step)
    from .parallel import MeshConfig, create_mesh, scale_learning_rate, shard_state
    from .parallel.sharding import unshard_params
    from .utils.device import rank_device
    from .utils.profiling import StepTimer, fence, trace

    config = load_config(opt.base, unknown)
    lightning_cfg = config.get("lightning", {})
    device = rank_device(opt.device)
    if config["model"].get("target", "").endswith(_AE_TARGETS):
        n_dev = opt.devices or (size if launched else _visible_devices(device))
        return train_autoencoder(opt, config, logdir, now, device, n_dev, on_batch=on_batch,
                                 on_step=on_step, timer=timer, resume_ckpt_dir=resume_ckpt_dir)

    # ----------------------------------------------------------------- mesh
    batch_size = config["data"]["params"]["batch_size"]
    if launched:
        if opt.devices is not None and opt.devices != size:
            raise ValueError(f"--devices {opt.devices} under a launcher of {size} ranks")
        n_dev = size
        if shrink_devices(n_dev, batch_size, opt.tp) != n_dev:
            raise ValueError(
                f"batch {batch_size} does not split over {n_dev // opt.tp} data ranks of "
                f"{size} ranks at --tp {opt.tp}; JAX's main.py reduces the device count by "
                f"the tensor-parallel degree until it does "
                f"({shrink_devices(n_dev, batch_size, opt.tp)} here): launch that many ranks")
    else:
        asked = opt.devices or _visible_devices(device)
        n_dev = shrink_devices(asked, batch_size, opt.tp)
        if n_dev != asked:
            print(f"Reduced device count to {n_dev} so batch {batch_size} shards evenly")
        if n_dev > 1:
            spawn(_with_devices(argv, n_dev), n_dev, now, device, on_batch, on_step, on_state)
            return logdir, None, None
    mesh = create_mesh(MeshConfig(data=n_dev // opt.tp, model=opt.tp), n_dev)
    step_mesh = mesh if mesh.size > 1 else None

    # ---------------------------------------------------------------- model
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    model, base_lr = model_from_config(config["model"], dtype=dtype, device=device)
    init_model_weights(model, opt.seed)
    model_params_cfg = config["model"].get("params", {})

    # ----------------------------------------------------------------- data
    data, batch_size, dataset_cfgs = _data(config, opt.seed,
                                           rows=(mesh.data_index, mesh.data))
    lr = scale_learning_rate(base_lr, batch_size, n_dev, opt.accumulate_grad_batches,
                             opt.scale_lr)
    if rank == 0 and opt.scale_lr:
        print(f"Setting learning rate to {lr:.2e} = {opt.accumulate_grad_batches} (accumulate) "
              f"* {n_dev} (devices) * {batch_size} (bs) * {base_lr:.2e} (base)")
    elif rank == 0:
        print(f"Using base learning rate {lr:.2e} (no scaling)")

    # ---------------------------------------------------------------- setup
    SetupCallback(logdir, config, name="project").on_start(now)
    metric_logger = MetricLogger(logdir)
    img_logger_cfg = lightning_cfg.get("callbacks", {}).get("image_logger", {}).get("params", {})
    train_ds_params = dataset_cfgs.get("train", {}).get("params", {})
    image_logger = ImageLogger(
        logdir, batch_frequency=img_logger_cfg.get("batch_frequency", 1000),
        max_images=min(img_logger_cfg.get("max_images", 8), batch_size),
        scaler_dir=train_ds_params.get("path_scaler") or train_ds_params.get("path"),
        log_steps=10 if opt.debug else 50, tb_writer=metric_logger.tb)
    device_stats = DeviceStatsCallback(device)
    monitor = model_params_cfg.get("monitor", "val/loss_simple_ema")
    ckpt_mgr = CheckpointManager(os.path.join(logdir, "checkpoints"), save_top_k=3,
                                 monitor=monitor, mesh=mesh)

    # ---------------------------------------------------------------- state
    train_loader = data.train_dataloader()
    if train_loader is None:
        raise ValueError("config.data must define a train dataset")
    # the global first batch (JAX's `example`) on every rank
    example = next(iter(data.train_dataloader(whole=True)))
    schedule_fn = None
    if "scheduler_config" in model_params_cfg:
        schedule_fn = build_scheduler(model_params_cfg["scheduler_config"])
    if model_params_cfg.get("scale_by_std") and not opt.resume:
        if model.scale_factor != 1.0:
            raise ValueError("rather not use custom rescaling and std-rescaling simultaneously")
        model.scale_factor = std_scale_factor(model, torch.from_numpy(example["img"]).to(device))
        print(f"### USING STD-RESCALING: scale_factor={model.scale_factor:.4f} ###")

    state, optimizer = init_train_state(model, learning_rate=lr,
                                        use_ema=model_params_cfg.get("use_ema", True),
                                        device=device)
    if schedule_fn is not None or opt.accumulate_grad_batches > 1:
        optimizer = make_optimizer(lr, schedule_fn=schedule_fn,
                                   accumulate_grad_batches=opt.accumulate_grad_batches)
        state.opt_state = optimizer.init(state.params)
    if resume_ckpt_dir is not None:
        # every rank reads the whole checkpoint, then cuts its slices
        CheckpointManager(resume_ckpt_dir, monitor=monitor).restore_last(state, model)
        print(f"Restored state at step {state.step} from {resume_ckpt_dir}")
    shard_state(state, mesh, model)
    if on_state is not None:
        on_state(model, state, mesh)
    train_step = make_train_step(model, optimizer, device=device, mesh=step_mesh)
    eval_step = make_eval_step(model, device=device, mesh=step_mesh)

    def melk(*args):
        """The crash (or SIGUSR1) checkpoint (one rank only: with more, it
        would need every rank)."""
        if mesh.size == 1:
            print("Saving crash checkpoint...", flush=True)
            ckpt_mgr.save_last(state, state.step)
        if args:
            sys.exit(0)

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGUSR1, melk)

    if not opt.train:
        print("No -t/--train flag: setup complete, exiting.")
        return logdir, model, state

    # ------------------------------------------------------------ train loop
    timer = timer if timer is not None else StepTimer()
    gen = torch.Generator().manual_seed(opt.seed)
    prof_start, prof_stop = (2, 2 + opt.profile) if opt.profile else (-1, -1)
    prof_ctx = None
    step = state.step
    try:
        for epoch in range(opt.max_epochs):
            device_stats.on_epoch_start()
            train_loader.set_epoch(epoch)
            for batch in _batches(DevicePrefetcher(train_loader, device), timer):
                if on_batch is not None:
                    on_batch(step, batch, gen)
                if step == prof_start:
                    prof_ctx = trace(os.path.join(logdir, "profile"))
                    prof_ctx.__enter__()
                with timer.section("train_step"):
                    state, metrics = train_step(state, batch, gen)
                    if opt.profile:  # so the bucket measures the device's time
                        fence(metrics["loss"])
                if on_step is not None:
                    on_step(step, metrics)
                if step == prof_stop and prof_ctx is not None:
                    prof_ctx.__exit__(None, None, None)
                    prof_ctx = None
                    print(f"profiler trace written to {logdir}/profile")
                step += 1
                if step % opt.log_every == 0:
                    metric_logger.log(step, _host(metrics), prefix="train/", echo=True)
                if image_logger.check_frequency(step):
                    # every rank draws the seed, so the step seeds stay alike
                    g = torch.Generator(device=device).manual_seed(_seed(gen))
                    if mesh.data_index == 0:
                        image_logger.log_img(model, batch, step, g, split="train",
                                             device=device)
                if opt.max_steps and step >= opt.max_steps:
                    break
            metric_logger.log(step, device_stats.on_epoch_end(), prefix="sys/")

            # ------------------------------------------------------ validation
            val_loader = data.val_dataloader()
            if val_loader is not None and epoch % opt.val_every_epochs == 0:
                vals = [_host(eval_step(state, vbatch, gen))
                        for vbatch in DevicePrefetcher(val_loader, device)]
                if vals:
                    agg = {f"val/{k}": float(np.mean([m[k] for m in vals])) for k in vals[0]}
                    metric_logger.log(step, agg, echo=True)
                    if epoch % opt.ckpt_every_epochs == 0:
                        ckpt_mgr.save(step, state, metrics=agg)
            elif epoch % opt.ckpt_every_epochs == 0:
                ckpt_mgr.save_last(state, step)
            if opt.max_steps and step >= opt.max_steps:
                break
    except (KeyboardInterrupt, Exception):
        melk()
        raise
    finally:
        if prof_ctx is not None:  # a trace left open by break or raise
            prof_ctx.__exit__(None, None, None)
        timer.report()

    ckpt_mgr.save_last(state, step)
    if rank == 0:
        print(f"Training done at step {step}; checkpoints in {logdir}/checkpoints")

    # ---------------------------------------------------------- third stage
    if opt.third_stage and model.cond_stage_key == "mixed":
        from .third_stage import ThirdStageModel, dump_third_stage_data

        # rank 0 alone, on the gathered model and the global batches
        unshard_params(model, mesh)
        if rank != 0:
            return logdir, model, state
        data.rows = None
        mb = opt.third_stage_max_batches
        for split in ("train", "test"):
            g = torch.Generator(device=device).manual_seed(_seed(gen))
            dump_third_stage_data(model, data, logdir, g, split=split, max_batches=mb,
                                  device=device)
        # capped (smoke) dumps score CLIP at 64^2; full runs at CLIP's 224^2
        ThirdStageModel(model, clip_image_size=64 if mb is not None else 224,
                        device=device).run(logdir, scaler_dir=train_ds_params.get("path"))
    return logdir, model, state


def train_autoencoder(opt, config, logdir, now, device, n_dev=1, on_batch=None, on_step=None,
                      timer=None, resume_ckpt_dir=None):
    """First-stage VAE-GAN training (AutoencoderKL / VQModel configs): the
    reference's two-optimizer protocol, both updates in one step
    (`training/vae_trainer.py`), float32 as the JAX `main.py` builds a first
    stage; after each epoch the validation logs, a checkpoint and the
    reconstruction grid of the first validation batch as a PNG. As the JAX
    `main.py`, the learning rate scales by `n_dev` devices and the step is
    not distributed (under a launcher every rank runs it; rank 0 writes).
    resume_ckpt_dir: a checkpoints dir whose `last` (the port's or the JAX
    package's) the state resumes from."""
    from .config import instantiate_from_config
    from .data.pipeline import DevicePrefetcher
    from .models.ddpm import build_first_stage
    from .models.vae import AutoencoderKL
    from .training import (CheckpointManager, DeviceStatsCallback, MetricLogger, SetupCallback,
                           init_vae_train_state, make_vae_eval_step, make_vae_train_step,
                           save_png, to_uint8_grid)
    from .utils.profiling import StepTimer

    mp = config["model"]["params"]
    base_lr = config["model"].get("base_learning_rate", 4.5e-6)
    vae = build_first_stage(config["model"], torch.float32, device)
    loss_module = instantiate_from_config(mp["lossconfig"], device=device)
    if loss_module is None:
        raise ValueError("autoencoder training requires a lossconfig")
    init_autoencoder_weights(vae, loss_module, opt.seed)

    data, batch_size, _ = _data(config, opt.seed)
    lr = (opt.accumulate_grad_batches * n_dev * batch_size * base_lr if opt.scale_lr
          else base_lr)
    print(f"Autoencoder learning rate: {lr:.2e}")

    SetupCallback(logdir, config, name="project").on_start(now)
    metric_logger = MetricLogger(logdir)
    device_stats = DeviceStatsCallback(device)
    monitor = mp.get("monitor", "val/rec_loss")
    ckpt_mgr = CheckpointManager(os.path.join(logdir, "checkpoints"), save_top_k=3,
                                 monitor=monitor)

    train_loader = data.train_dataloader()
    example = next(iter(train_loader))
    image_key = "image" if "image" in example else "img"
    state, opt_ae, opt_disc = init_vae_train_state(
        vae, loss_module, learning_rate=lr, lr_g_factor=mp.get("lr_g_factor", 1.0),
        device=device)
    if resume_ckpt_dir is not None:
        CheckpointManager(resume_ckpt_dir, monitor=monitor).restore_last(
            state, (vae, loss_module))
        print(f"Restored state at step {state.step} from {resume_ckpt_dir}")
    step_fn = make_vae_train_step(vae, loss_module, opt_ae, opt_disc, device=device)
    eval_fn = make_vae_eval_step(vae, loss_module, device=device)

    if not opt.train:
        print("No -t flag: setup complete.")
        return logdir, vae, state

    timer = timer if timer is not None else StepTimer()
    gen = torch.Generator().manual_seed(opt.seed)
    step = state.step
    for epoch in range(opt.max_epochs):
        device_stats.on_epoch_start()
        train_loader.set_epoch(epoch)
        for batch in _batches(DevicePrefetcher(train_loader, device), timer):
            if on_batch is not None:
                on_batch(step, batch, gen)
            with timer.section("train_step"):
                state, metrics = step_fn(state, {"image": batch[image_key]}, gen)
            if on_step is not None:
                on_step(step, metrics)
            step += 1
            if step % opt.log_every == 0:
                metric_logger.log(step, _host(metrics), echo=True)
            if opt.max_steps and step >= opt.max_steps:
                break
        metric_logger.log(step, device_stats.on_epoch_end(), prefix="sys/")

        val_loader = data.val_dataloader()
        if val_loader is not None:
            vals = [_host(eval_fn(state, {"image": vbatch[image_key]}, gen))
                    for vbatch in DevicePrefetcher(val_loader, device)]
            if vals:
                agg = {k: float(np.mean([m[k] for m in vals])) for k in vals[0]}
                metric_logger.log(step, agg, echo=True)
                ckpt_mgr.save(step, state, metrics=agg)
                # the reconstruction grid (the reference's log_images)
                x = torch.from_numpy(next(iter(val_loader))[image_key]).to(device)
                with torch.no_grad():
                    if isinstance(vae, AutoencoderKL):
                        rec = vae(x, torch.Generator(device=device).manual_seed(_seed(gen)))[0]
                    else:
                        rec = vae(x)[0]
                if ckpt_mgr.writer:
                    save_png(os.path.join(logdir, "images", "val", f"recon_gs-{step:06d}.png"),
                             to_uint8_grid(rec))
        else:
            ckpt_mgr.save_last(state, step)
        if opt.max_steps and step >= opt.max_steps:
            break
    timer.report()
    ckpt_mgr.save_last(state, step)
    print(f"Autoencoder training done at step {step}")
    return logdir, vae, state


if __name__ == "__main__":
    main()
