"""The third stage: evaluation and refinement of a trained STDiff LDM
(counterpart of `ealdm_tpu/third_stage.py`):

  * `dump_third_stage_data`: `inference.log_images` over a split, one
    `batch_%05d.npz` a batch with the image, the samples' VQ-quantized
    latent ("diff_samples_latent") and the batch's weather, labels, flow
    and time (the keys JAX writes);
  * `ThirdStageDataset`: those dumps as samples;
  * `ThirdStageModel`: the frozen LDM's decode of the dumped latents, a
    ResNet-50 trunk ("group" norm, frozen, pooled) under two heads, `fc_w`
    (10 weather labels, BCE) and `fc_f` (flow, MSE), trained with Adam;
    `test` scores FID (InceptionV3 pool3 features of the real and decoded
    images), the zero-shot CLIP agreement, the heads' agreement, the
    weather F1 and the flow MSE, and writes `third_stage_flow.csv`,
    `third_stage_results.csv` (and a plot where matplotlib imports);
    `refine_decoder` fine-tunes the first stage's decoder with the VQ-GAN
    loss.

The entry points run on the card unless asked for the CPU (`device`):
without a card they raise. The evaluation trunks have seeded weights
(InceptionV3 and the CLIP towers pinned to seed 0, independent of the
heads' seed); canonical checkpoints in $EALDM_WEIGHTS_DIR replace them
(`weights.py`). The heads and the CLIP towers also take carried flax
parameter trees of the JAX package's modules
(`utils.flax_import.load_flax_params`).

Deltas from the JAX module: the heads' trunk is frozen by taking no
backward through it (JAX computes its gradients and zeroes the update);
the dump draws from one `torch.Generator` where JAX splits a key a batch.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .data.pipeline import DataLoader, Dataset, to_device
from .data.stdiff import WEATHER_CLASSES
from .metrics import FID, label_agreement, multilabel_f1
from .models.layers import Dense
from .models.resnet import ResNet50
from .retrieval import _seeded_or_carried
from .utils.device import check_module_device, resolve_device


class CLIPZeroShot:
    """The zero-shot weather-label scorer: the class prompts through CLIP's
    text tower once, images through its ViT image tower, and each image's
    logits are the cosine similarities with the class embeddings. It scores
    the images' content, apart from the trained heads. Both towers are
    pinned to seed 0 (or take `text_params` / `image_params`, flax trees of
    the JAX embedders); `text_kwargs` / `image_kwargs` change the towers'
    geometry (a reduced scorer for a small checkpoint). On `device`, "cuda"
    unless given."""

    def __init__(self, class_names=WEATHER_CLASSES, embed_dim: int = 512,
                 image_size: int = 224, prompt: str = "a photo taken on a {} day",
                 text_kwargs: Optional[dict] = None, image_kwargs: Optional[dict] = None,
                 text_params: Optional[Mapping] = None, image_params: Optional[Mapping] = None,
                 device=None):
        from .models.encoders import FrozenCLIPTextEmbedder, FrozenClipImageEmbedder
        from .models.text_transformer import SimpleTokenizer

        self.device = dev = resolve_device(device)
        self.class_names = list(class_names)
        self.text_model = _seeded_or_carried(
            FrozenCLIPTextEmbedder(n_embed=embed_dim, device=dev, **(text_kwargs or {})),
            0, text_params, dev).requires_grad_(False)
        self.image_model = _seeded_or_carried(
            FrozenClipImageEmbedder(out_dim=embed_dim, image_size=image_size, device=dev,
                                    **(image_kwargs or {})),
            0, image_params, dev).requires_grad_(False)
        tower = self.text_model.model
        tokenizer = SimpleTokenizer(tower.token_embedding.embedding.shape[0],
                                    tower.positional_embedding.shape[0])
        self._tokens = tokenizer([prompt.format(c) for c in self.class_names])
        self.class_embeddings = self._embed_texts(self._tokens)

    @torch.no_grad()
    def _embed_texts(self, tokens):
        """[n_classes, D], L2-normalized by the text embedder."""
        return self.text_model(torch.as_tensor(tokens))[:, 0, :]

    def load_clip_weights(self, state_dict, tokens=None):
        """Install a CLIP checkpoint (OpenAI or Hugging Face naming:
        `models.clip.load_torch_clip_state`) into the towers it covers and
        recompute the class embeddings; `tokens` optionally gives real
        CLIP-BPE ids of the class prompts."""
        from .models.clip import load_torch_clip_state

        text, visual = load_torch_clip_state(state_dict)
        if text is not None:
            self.text_model.model.load_state_dict(text)
            self.class_embeddings = self._embed_texts(self._tokens if tokens is None
                                                      else tokens)
        if visual is not None:
            self.image_model.visual.load_state_dict(visual)

    @torch.no_grad()
    def logits(self, images) -> np.ndarray:
        """[B, n_classes] cosine-similarity logits of [-1, 1] NHWC images."""
        z = self.image_model(torch.as_tensor(images).to(self.device, torch.float32))
        return (z @ self.class_embeddings.T).cpu().numpy()

    def agreement(self, images, labels_multi_hot: np.ndarray) -> float:
        return label_agreement(self.logits(images), labels_multi_hot)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


@torch.no_grad()
def dump_third_stage_data(model, data, logdir: str, generator: torch.Generator,
                          split: str = "test", steps: int = 50,
                          max_batches: Optional[int] = None, device=None) -> str:
    """Sample each batch of `data`'s `split` loader (the train loader where
    there is no test one) through `log_images` (DDIM `steps`, the latents
    VQ-quantized) and write <logdir>/third_stage_data/<split>/batch_%05d.npz
    with img, latent, w, wlabel_nxt, flabel, flabel_nxt and t. Every draw
    comes from `generator` (on the model's device), batch after batch.
    Returns the directory."""
    from .inference import log_images

    dev = check_module_device(model, device)
    loader = data.test_dataloader() if split == "test" else data.train_dataloader()
    if loader is None:
        loader = data.train_dataloader()
    out_dir = os.path.join(logdir, "third_stage_data", split)
    os.makedirs(out_dir, exist_ok=True)
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        logs = log_images(model, to_device(batch, dev), generator, n=batch["img"].shape[0],
                          steps=steps, quantize_denoised=True, device=device)
        mixed = batch["mixed"]
        np.savez(os.path.join(out_dir, f"batch_{i:05d}.npz"),
                 img=_host(batch["img"]), latent=_host(logs["diff_samples_latent"]),
                 w=_host(mixed["weather"]), wlabel_nxt=_host(mixed["wlabel_nxt"]),
                 flabel=_host(mixed["flow"]), flabel_nxt=_host(mixed["label_nxt"]),
                 t=_host(mixed["time"]))
    return out_dir


class ThirdStageDataset(Dataset):
    """The per-batch npz dumps under `path`, one sample each row."""

    # dump files kept in memory: a shuffled loader revisits files all the
    # time, and one slot would read an npz for every sample
    _CACHE_FILES = 8

    def __init__(self, path: str, phase: str = "train"):
        self.files = sorted(glob.glob(os.path.join(path, "*.npz")))
        assert self.files, f"no third-stage dumps under {path}"
        self._index: List = []
        for fi, f in enumerate(self.files):
            with np.load(f) as z:
                n = z["img"].shape[0]
            self._index.extend((fi, j) for j in range(n))
        self._cache: Dict[int, Dict] = {}

    def __len__(self):
        return len(self._index)

    def _file(self, fi: int) -> Dict:
        if fi not in self._cache:
            if len(self._cache) >= self._CACHE_FILES:
                self._cache.pop(next(iter(self._cache)))
            with np.load(self.files[fi]) as z:
                self._cache[fi] = {k: z[k] for k in z.files}
        return self._cache[fi]

    def __getitem__(self, idx):
        fi, j = self._index[idx]
        return {k: v[j] for k, v in self._file(fi).items()}


class Refinement(nn.Module):
    """A residual latent correction: three 3x3 convolutions (ReLU between),
    the last initialized to zero, so that it starts as the identity. NHWC
    in and out; seeded with `seed` on `device` ("cuda" unless given)."""

    def __init__(self, channels: int = 4, hidden: int = 32, seed: int = 0, device=None):
        super().__init__()
        from .models.layers import Conv2D
        from .utils.init import random_init_

        with torch.device(resolve_device(device)):
            self.c1 = Conv2D(channels, hidden, 3, padding=1)
            self.c2 = Conv2D(hidden, hidden, 3, padding=1)
            self.c3 = Conv2D(hidden, channels, 3, padding=1)
        random_init_(self, seed)
        with torch.no_grad():
            self.c3.weight.zero_()
            self.c3.bias.zero_()

    def forward(self, z):
        h = F.relu(self.c2(F.relu(self.c1(z.permute(0, 3, 1, 2)))))
        return z + self.c3(h).permute(0, 2, 3, 1)


class Heads(nn.Module):
    """The pooled ResNet-50 ("group") features under `fc_w` and `fc_f`:
    [N, H, W, 3] -> (weather logits [N, num_classes], flow [N, 1],
    features [N, 2048]). Built on the ambient device."""

    def __init__(self, num_classes: int = len(WEATHER_CLASSES)):
        super().__init__()
        self.trunk = ResNet50()
        self.fc_w = Dense(2048, num_classes)
        self.fc_f = Dense(2048, 1)

    def forward(self, x):
        feats = self.trunk(x, pool=True)
        return self.fc_w(feats), self.fc_f(feats), feats


class ThirdStageModel:
    """The heads over decoded diffusion latents, their training, the
    evaluation and the decoder's refinement. `diffusion_model` (a trained
    LatentDiffusion with a VQ first stage) stays as it is but for
    `refine_decoder`. `head_params`: a flax tree of the JAX `Heads`, else
    the heads are seeded with `seed`. The evaluation trunks are pinned to
    seed 0, or take $EALDM_WEIGHTS_DIR's checkpoints. On `device`, "cuda"
    unless given; the model must lie there."""

    def __init__(self, diffusion_model, num_classes: int = len(WEATHER_CLASSES),
                 lr: float = 1e-4, seed: int = 0, clip_image_size: int = 224,
                 head_params: Optional[Mapping] = None, device=None):
        from .training.trainer import AdamW

        self.device = dev = check_module_device(diffusion_model, device)
        self.model = diffusion_model
        self.num_classes = num_classes
        with torch.device(dev):
            self.heads = _seeded_or_carried(Heads(num_classes), seed, head_params,
                                            dev).requires_grad_(False)
        # Adam on the heads only; the trunk is frozen and takes no backward
        self.head_train = {k: p.requires_grad_(True) for k, p in self.heads.named_parameters()
                           if k.startswith(("fc_w.", "fc_f."))}
        self.optimizer = AdamW(lr, weight_decay=0.0)
        self.opt_state = self.optimizer.init(self.head_train)
        # the evaluation trunks are built at their first use in test()
        self._clip_image_size = clip_image_size
        self._clip_scorer: Optional[CLIPZeroShot] = None
        self._fid: Optional[nn.Module] = None

    # ------------------------------------------------------------- trunks
    @property
    def clip_scorer(self) -> CLIPZeroShot:
        """The zero-shot scorer (image content against the class prompts'
        text embeddings, not the fc_w head); a canonical CLIP checkpoint in
        $EALDM_WEIGHTS_DIR is loaded into it when it is built."""
        if self._clip_scorer is None:
            self._clip_scorer = CLIPZeroShot(image_size=self._clip_image_size,
                                             device=self.device)
            from .weights import find_weights, load_state_dict_file

            path = find_weights("clip")
            if path is not None:
                self._clip_scorer.load_clip_weights(load_state_dict_file(path))
        return self._clip_scorer

    def _ensure_fid(self) -> nn.Module:
        """The FID trunk, InceptionV3 (pinned to seed 0, apart from the heads'
        seed), with a canonical checkpoint of $EALDM_WEIGHTS_DIR loaded."""
        if self._fid is None:
            from .models.inception import InceptionV3Features

            with torch.device(self.device):
                self._fid = InceptionV3Features().seeded_(0).eval().requires_grad_(False)
            from .weights import find_weights, load_state_dict_file

            path = find_weights("inception")
            if path is not None:
                self.load_fid_weights(load_state_dict_file(path))
        return self._fid

    def load_fid_weights(self, state_dict):
        """Install a torchvision-named InceptionV3 state dict (the
        pt_inception-2015-12-05 FID weights, say) into the FID trunk."""
        from .models.inception import load_torch_inception_state

        load_torch_inception_state(self._ensure_fid(), state_dict)

    @torch.no_grad()
    def _fid_feats(self, imgs) -> torch.Tensor:
        """[N, 2048] FID features of [-1, 1] NHWC images (the trunk takes
        [0, 1])."""
        return self._ensure_fid()((imgs.float() + 1.0) * 0.5)

    # ---------------------------------------------------------------- api
    @torch.no_grad()
    def decode(self, latent) -> torch.Tensor:
        """The frozen first stage's float32 images of dumped latents."""
        return self.model.decode_first_stage(latent.to(self.device)).float()

    def _batch_tensors(self, batch):
        tensors = to_device(batch, self.device)
        images = self.decode(tensors["latent"])
        n = images.shape[0]
        wlabel = tensors["wlabel_nxt"].reshape(n, -1).float()
        flabel = tensors["flabel_nxt"].reshape(n, -1)[:, :1].float()
        return images, wlabel, flabel

    def _heads(self, images):
        """(weather logits, flow): the trunk without a graph, the heads with."""
        with torch.no_grad():
            feats = self.heads.trunk(images, pool=True)
        return self.heads.fc_w(feats), self.heads.fc_f(feats)

    def train_step(self, images, wlabel, flabel) -> Dict[str, torch.Tensor]:
        """One Adam step of the heads on BCE(weather) + MSE(flow)."""
        logits_w, pred_f = self._heads(images)
        bce = F.binary_cross_entropy_with_logits(logits_w, wlabel)
        mse = torch.mean(torch.square(pred_f - flabel))
        loss = bce + mse
        grads = torch.autograd.grad(loss, list(self.head_train.values()))
        self.optimizer.apply(self.head_train, dict(zip(self.head_train, grads)), self.opt_state)
        return {"loss_w": bce.detach(), "loss_f": mse.detach(), "loss": loss.detach()}

    def train(self, loader: DataLoader, epochs: int = 1, log_every: int = 10):
        step = 0
        for _ in range(epochs):
            for batch in loader:
                metrics = self.train_step(*self._batch_tensors(batch))
                step += 1
                if step % log_every == 0:
                    print(f"third-stage step {step}: loss={float(metrics['loss']):.4f}",
                          flush=True)
        return self

    @torch.no_grad()
    def test(self, loader: DataLoader, logdir: str, scaler_dir: Optional[str] = None):
        fid = FID()
        w_true, w_pred, flow_true, flow_pred, times, clip_logits = [], [], [], [], [], []
        for batch in loader:
            images, wlabel, flabel = self._batch_tensors(batch)
            real = torch.as_tensor(batch["img"]).to(self.device, torch.float32)
            logits_w, pred_f = self._heads(images)
            fid.update(_host(self._fid_feats(real)), real=True)
            fid.update(_host(self._fid_feats(images)), real=False)
            clip_logits.append(self.clip_scorer.logits(images))
            w_true.append(_host(wlabel))
            w_pred.append(_host(torch.sigmoid(logits_w)))
            flow_true.append(_host(flabel))
            flow_pred.append(_host(pred_f))
            times.append(np.asarray(batch["t"]).reshape(len(images), -1)[:, :1])

        w_true, w_pred = np.concatenate(w_true), np.concatenate(w_pred)
        f_true, f_pred = np.concatenate(flow_true), np.concatenate(flow_pred)
        t_arr = np.concatenate(times)
        results = {
            "fid": fid.compute(),
            "weather_f1": multilabel_f1(w_true, w_pred),
            # zero-shot: argmax over CLIP's image-vs-class-text similarities
            "clip_agreement": label_agreement(np.concatenate(clip_logits), w_true),
            # the heads' own agreement, a separate diagnostic
            "head_agreement": label_agreement(w_pred, w_true),
            "flow_mse": float(np.mean((f_true - f_pred) ** 2)),
        }
        if scaler_dir:  # the CSV and the plot in flow units
            from .data.scalers import load_scaler

            p = os.path.join(scaler_dir, "flow_scaler_trainval.json")
            if os.path.exists(p):
                sc = load_scaler(p)
                f_true, f_pred = sc.inverse_transform(f_true), sc.inverse_transform(f_pred)

        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "third_stage_flow.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time", "flow_true", "flow_pred"])
            for i in range(len(f_true)):
                w.writerow([float(t_arr[i, 0]), float(f_true[i, 0]), float(f_pred[i, 0])])
        _plot_flow(os.path.join(logdir, "third_stage_flow.png"), t_arr, f_true, f_pred)
        with open(os.path.join(logdir, "third_stage_results.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(results))
            w.writerow([results[k] for k in results])
        print("third-stage results:", results, flush=True)
        return results

    def refine_loss(self, disc_start: int = 0):
        """The refinement's VQ-GAN loss (one-layer discriminator) on the
        model's device, seeded: LPIPS's VGG trunk with seed 1, the
        discriminator N(0, 0.02^2) with seed 2."""
        from .losses.vqperceptual import VQLPIPSWithDiscriminator
        from .utils.init import random_init_

        loss = VQLPIPSWithDiscriminator(disc_start=disc_start, disc_num_layers=1,
                                        device=self.device)
        random_init_(loss.perceptual.vgg, 1)
        loss.discriminator.init_weights_(torch.Generator().manual_seed(2))
        return loss

    def refine_decoder(self, loader: DataLoader, steps: int = 100, lr: float = 1e-5,
                       disc_start: int = 0, loss_module=None):
        """Fine-tune the first stage's decoder on the dumps with the VQ-GAN
        loss (`refine_loss`, or `loss_module`), in place: each step decodes
        the latents with a graph, takes d_weight from the gradients of the
        NLL and of the GAN loss with respect to the reconstruction, updates
        the decoder (Adam, b1 0.5, b2 0.9), then the discriminator on the
        detached reconstruction. Returns the last step's (generator loss,
        discriminator loss)."""
        from .losses.contperceptual import adaptive_d_weight
        from .training.trainer import AdamW

        loss_mod = loss_module if loss_module is not None else self.refine_loss(disc_start)
        decoder = self.model.first_stage_model.decoder
        dec = dict(decoder.named_parameters())
        disc = dict(loss_mod.discriminator.named_parameters())
        trainable = {k: p.requires_grad for k, p in dec.items()}
        for p in dec.values():
            p.requires_grad_(True)
        loss_mod.requires_grad_(False)
        for p in disc.values():
            p.requires_grad_(True)
        opt_g = AdamW(lr, weight_decay=0.0, b1=0.5, b2=0.9)
        opt_d = AdamW(lr, weight_decay=0.0, b1=0.5, b2=0.9)
        g_state, d_state = opt_g.init(dec), opt_d.init(disc)
        zero = torch.zeros((), device=self.device)
        gl = dl = None
        try:
            it = 0
            while it < steps:
                for batch in loader:
                    if it >= steps:
                        break
                    latent = torch.as_tensor(batch["latent"]).to(self.device)
                    real = torch.as_tensor(batch["img"]).to(self.device, torch.float32)
                    rec = self.model.decode_first_stage(latent).float()

                    def d_weight(nll, g):
                        nll_g, = torch.autograd.grad(nll, rec, retain_graph=True)
                        gan_g, = torch.autograd.grad(g, rec, retain_graph=True)
                        return adaptive_d_weight(nll_g, gan_g, loss_mod.disc_weight).detach()

                    gl, _ = loss_mod.generator_loss(zero, real, rec, it, d_weight)
                    grads = torch.autograd.grad(gl, list(dec.values()))
                    opt_g.apply(dec, dict(zip(dec, grads)), g_state)
                    dl, _ = loss_mod.discriminator_loss(real, rec, it)
                    grads = torch.autograd.grad(dl, list(disc.values()))
                    opt_d.apply(disc, dict(zip(disc, grads)), d_state)
                    it += 1
        finally:
            for k, p in dec.items():
                p.requires_grad_(trainable[k])
        return float(gl.detach()), float(dl.detach())

    def run(self, logdir: str, scaler_dir: Optional[str] = None, epochs: int = 1,
            batch_size: int = 4):
        """Train the heads on <logdir>/third_stage_data/train (test where
        there is no train dump) and evaluate on .../test (or train)."""
        base = os.path.join(logdir, "third_stage_data")
        train_dir = os.path.join(base, "train")
        test_dir = os.path.join(base, "test")
        if not os.path.isdir(train_dir):
            train_dir = test_dir
        train_ds = ThirdStageDataset(train_dir, "train")
        # clamped, so that a tiny dump still gives one batch (drop_last)
        self.train(DataLoader(train_ds, max(1, min(batch_size, len(train_ds))), shuffle=True),
                   epochs=epochs)
        test_ds = ThirdStageDataset(test_dir if os.path.isdir(test_dir) else train_dir)
        return self.test(DataLoader(test_ds, max(1, min(batch_size, len(test_ds)))), logdir,
                         scaler_dir)


def _plot_flow(path, t_arr, f_true, f_pred):
    """The true and predicted flow against time, where matplotlib imports."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = np.argsort(t_arr[:, 0])
    plt.figure(figsize=(10, 4))
    plt.plot(t_arr[order, 0], f_true[order, 0], label="true flow")
    plt.plot(t_arr[order, 0], f_pred[order, 0], label="predicted flow")
    plt.legend()
    plt.savefig(path, dpi=100)
    plt.close()
