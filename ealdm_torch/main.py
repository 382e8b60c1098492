"""The port's training entry point (counterpart of the root `main.py`):

    python -m ealdm_torch.main -b configs/latent-diffusion/stdiff_cin-ldm-vq-f8.yaml -t \\
        [--dtype bfloat16] [--device cuda] [a.b.c=value ...]

The YAML configs are merged left to right and the trailing `a.b.c=value`
overrides applied (`config.load_config`, with the port's YAML reader); the
run lives in a timestamped logdir with configs/, checkpoints/, images/,
metrics.jsonl and tb/. The learning rate scales as accumulate x devices x
batch x base_lr with one device. An LDM config trains `make_train_step`
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
restores its last checkpoint; without `-t` the run is set up and returned.

Deltas from the JAX `main.py`:
  * `--device` (default "cuda", which raises without a card; the tests
    pass "cpu");
  * refused up front, with NotImplementedError naming ROADMAP queue 1 item
    6: `--devices` or `--tp` above 1 (one card);
  * attention at eligible self-attention sites runs the flash kernel
    (`kernel_settings`; the JAX `main.py` keeps dense attention);
  * weights are seeded random (`utils.init.random_init_`, seed `--seed`);
    the step's t, noise and dropout come from a CPU generator seeded with
    `--seed`, one draw a step;
  * `scale_by_std` measures 1/std of the first batch's latents through the
    model's own first stage (the JAX `main.py` encodes with a second random
    initialisation);
  * the third stage's two dumps draw from generators on the device, each
    seeded by a draw of the loop's generator.
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

_ITEM6 = "ROADMAP queue 1 item 6"
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
                   help="number of devices for the data axis (one card: 1)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree (1)")
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


def _data(config, seed: int):
    """(DataModule, batch size, dataset configs) of config.data."""
    from .data.pipeline import DataModule

    data_cfg = dict(config["data"]["params"])
    batch_size = data_cfg.pop("batch_size")
    dataset_cfgs = {k: data_cfg.pop(k) for k in ("train", "validation", "test", "predict")
                    if k in data_cfg}
    return (DataModule(batch_size=batch_size, dataset_configs=dataset_cfgs,
                       wrap=data_cfg.get("wrap", False), seed=seed),
            batch_size, dataset_cfgs)


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


def main(argv=None, *, on_batch=None, on_step=None, timer=None):
    """Train (with -t) or set up the run of `argv` (sys.argv[1:] if None);
    returns (logdir, model, state). `on_batch(step, batch, generator)`, if
    given, sees each training batch on the device before its step and the
    generator the step will draw from; `on_step(step, metrics)` sees each
    step's metrics (tensors on the device) right after it; `timer` (a
    `utils.profiling.StepTimer`) collects the loop's "data_wait" and
    "train_step" seconds. Runs under `kernel_settings()`. The SIGUSR1
    handler it installs (the crash checkpoint, which holds the run's state)
    gives way to the caller's own on return."""
    # finalize CUPTI when a trace ends (see utils/profiling.py)
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        with kernel_settings():
            return _main(argv, on_batch, on_step, timer)
    finally:
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGUSR1, signal.SIG_DFL if previous is None else previous)


def _main(argv, on_batch, on_step, timer):
    opt, unknown = get_parser().parse_known_args(argv)
    if (opt.devices or 1) > 1 or opt.tp > 1:
        raise NotImplementedError(f"--devices {opt.devices} --tp {opt.tp}: the port trains on "
                                  f"one card; distribution is {_ITEM6}")

    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
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
    from .utils.device import resolve_device
    from .utils.profiling import StepTimer, fence, trace

    config = load_config(opt.base, unknown)
    lightning_cfg = config.get("lightning", {})
    device = resolve_device(opt.device)
    if config["model"].get("target", "").endswith(_AE_TARGETS):
        return train_autoencoder(opt, config, logdir, now, device, on_batch=on_batch,
                                 on_step=on_step, timer=timer)

    # ---------------------------------------------------------------- model
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    model, base_lr = model_from_config(config["model"], dtype=dtype, device=device)
    init_model_weights(model, opt.seed)
    model_params_cfg = config["model"].get("params", {})

    # ----------------------------------------------------------------- data
    data, batch_size, dataset_cfgs = _data(config, opt.seed)
    n_dev = 1
    if opt.scale_lr:
        lr = opt.accumulate_grad_batches * n_dev * batch_size * base_lr
        print(f"Setting learning rate to {lr:.2e} = {opt.accumulate_grad_batches} (accumulate) "
              f"* {n_dev} (devices) * {batch_size} (bs) * {base_lr:.2e} (base)")
    else:
        lr = base_lr
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
                                 monitor=monitor)

    # ---------------------------------------------------------------- state
    train_loader = data.train_dataloader()
    if train_loader is None:
        raise ValueError("config.data must define a train dataset")
    example = next(iter(train_loader))
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
        CheckpointManager(resume_ckpt_dir, monitor=monitor).restore_last(state)
        print(f"Restored state at step {state.step} from {resume_ckpt_dir}")
    train_step = make_train_step(model, optimizer, device=device)
    eval_step = make_eval_step(model, device=device)

    def melk(*args):
        """The crash (or SIGUSR1) checkpoint."""
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
                    g = torch.Generator(device=device).manual_seed(_seed(gen))
                    image_logger.log_img(model, batch, step, g, split="train", device=device)
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
    print(f"Training done at step {step}; checkpoints in {logdir}/checkpoints")

    # ---------------------------------------------------------- third stage
    if opt.third_stage and model.cond_stage_key == "mixed":
        from .third_stage import ThirdStageModel, dump_third_stage_data

        mb = opt.third_stage_max_batches
        for split in ("train", "test"):
            g = torch.Generator(device=device).manual_seed(_seed(gen))
            dump_third_stage_data(model, data, logdir, g, split=split, max_batches=mb,
                                  device=device)
        # capped (smoke) dumps score CLIP at 64^2; full runs at CLIP's 224^2
        ThirdStageModel(model, clip_image_size=64 if mb is not None else 224,
                        device=device).run(logdir, scaler_dir=train_ds_params.get("path"))
    return logdir, model, state


def train_autoencoder(opt, config, logdir, now, device, on_batch=None, on_step=None,
                      timer=None):
    """First-stage VAE-GAN training (AutoencoderKL / VQModel configs): the
    reference's two-optimizer protocol, both updates in one step
    (`training/vae_trainer.py`), float32 as the JAX `main.py` builds a first
    stage; after each epoch the validation logs, a checkpoint and the
    reconstruction grid of the first validation batch as a PNG."""
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
    lr = (opt.accumulate_grad_batches * 1 * batch_size * base_lr if opt.scale_lr else base_lr)
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
    step_fn = make_vae_train_step(vae, loss_module, opt_ae, opt_disc, device=device)
    eval_fn = make_vae_eval_step(vae, loss_module, device=device)

    if not opt.train:
        print("No -t flag: setup complete.")
        return logdir, vae, state

    timer = timer if timer is not None else StepTimer()
    gen = torch.Generator().manual_seed(opt.seed)
    step = 0
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
