"""Retrieval-augmented conditioning: a k-NN index over CLIP embeddings and
the [query; neighbours] context of retrieval-augmented sampling
(counterpart of `ealdm_tpu/retrieval.py` and of `scripts/knn2img.py`'s
search and conditioning).

`Searcher` keeps the L2-normalized database as one float32 [N, D] tensor on
its device (the card unless the caller says otherwise). The exact search is
one float32 matmul and a top-k; the partitioned search (spherical k-means
leaves, the closest leaves probed) scores only the probed leaves' members,
exactly. Every matmul here runs in IEEE float32 (TF32 off whatever the
caller's global setting), as the JAX package's `Precision.HIGHEST`. An
index saved by either package loads in the other (`save`, `load`).

`build_image_database` embeds an image folder (PNG and `.npy`; a `.jpg`
raises naming ROADMAP queue 1 item 9) through the ResNet-50 trunk's pooled,
L2-normalized features (`_embed_images_fn`); `_embed_texts_fn` is the
4-layer text transformer's mean-pooled embedding. The JAX package
initialises both from PRNGKey(0), which torch cannot draw: here each takes
seeded random weights (`utils.init.random_init_`), or a flax parameter tree
carried over through `utils.flax_import`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .utils.device import resolve_device


def _seeded_or_carried(module: torch.nn.Module, seed: int, params: Optional[Mapping], dev):
    from .utils.flax_import import load_flax_params
    from .utils.init import random_init_

    if params is None:
        random_init_(module, seed)
    else:
        load_flax_params(module, params, device=dev)
    return module.eval()


def _embed_images_fn(device=None, seed: int = 0, params: Optional[Mapping] = None):
    """images [B, H, W, 3] in [-1, 1] (numpy or tensor) -> [B, 2048]
    L2-normalized pooled ResNet-50 ("group" norm) features on `device`
    ("cuda" unless given); weights seeded with `seed`, or `params`, a
    flax tree of the JAX trunk."""
    from .models.resnet import ResNet50

    dev = resolve_device(device)
    with torch.device(dev):
        model = ResNet50()
    model = _seeded_or_carried(model, seed, params, dev)  # the draws on the host

    @torch.no_grad()
    def embed(x):
        feats = model(torch.as_tensor(x).to(dev, torch.float32), pool=True)
        return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-8)

    return embed


def _embed_texts_fn(device=None, seed: int = 0, params: Optional[Mapping] = None):
    """texts -> [B, 512] L2-normalized mean-pooled embeddings of the
    4-layer text transformer over the hermetic tokenizer (77 tokens), on
    `device`; weights seeded with `seed`, or `params`, a flax tree."""
    from .models.text_transformer import SimpleTokenizer, TextTransformer

    dev = resolve_device(device)
    tok = SimpleTokenizer(max_len=77)
    with torch.device(dev):
        model = TextTransformer(vocab_size=30522, max_len=77, dim=512, depth=4)
    model = _seeded_or_carried(model, seed, params, dev)

    @torch.no_grad()
    def embed(texts: Sequence[str]):
        pooled = model(tok(list(texts)).to(dev)).mean(dim=1)
        return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-8)

    return embed


def build_image_database(image_dir: str, size: int = 256, batch: int = 16, device=None,
                         seed: int = 0, params: Optional[Mapping] = None) -> Dict:
    """Embed every image under `image_dir` (`data.images.ImageFolderDataset`:
    centre crop, BICUBIC to size^2) -> {"embedding" [N, 2048], "img_id",
    "patch_coords" [N, 4] zeros, "paths"}, numpy arrays on the host."""
    from .data.images import ImageFolderDataset

    ds = ImageFolderDataset(image_dir, size=size)
    embed = _embed_images_fn(device, seed, params)
    embs, paths = [], []
    for start in range(0, len(ds), batch):
        items = [ds[i] for i in range(start, min(start + batch, len(ds)))]
        embs.append(embed(np.stack([it["image"] for it in items])).cpu().numpy())
        paths.extend(it["file_path_"] for it in items)
    return {"embedding": np.concatenate(embs), "img_id": np.arange(len(paths)),
            "patch_coords": np.zeros((len(paths), 4), np.int64), "paths": np.asarray(paths)}


@contextlib.contextmanager
def _ieee_float32():
    """CUDA matmuls in full float32 within the block, the caller's setting
    restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _normalized(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)


class Searcher:
    """Cosine k-NN over a normalized embedding database on `device`."""

    def __init__(self, embeddings, metadata: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        emb = torch.as_tensor(embeddings).to(self.device, torch.float32)
        self.embeddings = _normalized(emb)
        self.metadata = metadata or {}
        self._centroids = None
        self.default_leaves_to_search: Optional[int] = None

    @classmethod
    def from_database(cls, db: Dict, device=None) -> "Searcher":
        meta = {k: v for k, v in db.items() if k != "embedding"}
        return cls(db["embedding"], meta, device=device)

    @property
    def num_entries(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @property
    def partitioned(self) -> bool:
        return self._centroids is not None

    @torch.no_grad()
    def build_partitions(self, num_leaves: int, iters: int = 10, seed: int = 0) -> None:
        """The partitioned index (the JAX package's stand-in for ScaNN's
        tree, without its quantisation: scoring stays exact): spherical
        k-means from the entries `RandomState(seed)` chooses, every
        assignment one matmul and every leaf's sum one more (a one-hot
        [N, L] against the database, which repeats bit for bit where
        `index_add_`'s float atomics on the card would not); the leaves kept
        as one padded [L, M] index matrix with its mask, each leaf's members
        in increasing order."""
        emb = self.embeddings
        n = emb.shape[0]
        num_leaves = min(num_leaves, n)
        first = np.random.RandomState(seed).choice(n, num_leaves, replace=False)
        centroids = emb[torch.from_numpy(first).to(self.device)].clone()
        assign = None
        with _ieee_float32():
            for _ in range(iters):
                assign = torch.argmax(emb @ centroids.T, dim=1)
                onehot = torch.nn.functional.one_hot(assign, num_leaves).to(emb.dtype)
                sums = onehot.T @ emb
                counts = torch.bincount(assign, minlength=num_leaves)
                filled = counts > 0
                means = sums[filled] / counts[filled, None]
                centroids[filled] = _normalized(means)
        order = torch.argsort(assign, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(n, device=self.device) - starts[assign[order]]
        width = max(1, int(counts.max()))
        leaf_idx = torch.zeros(num_leaves, width, dtype=torch.int64, device=self.device)
        leaf_mask = torch.zeros(num_leaves, width, dtype=torch.bool, device=self.device)
        leaf_idx[assign[order], slot] = order
        leaf_mask[assign[order], slot] = True
        self._centroids, self._leaf_idx, self._leaf_mask = centroids, leaf_idx, leaf_mask

    @torch.no_grad()
    def search(self, queries, k: int = 10, leaves_to_search: Optional[int] = None) -> Dict:
        """queries [B, D] -> {"nn_indices" [B, k], "nn_scores", "nn_embeddings"
        [B, k, D]}, tensors on the Searcher's device (k capped at the
        database's size). With a partitioned index and `leaves_to_search`
        (given, or the `default_leaves_to_search` of `auto_build_searcher` /
        `load`), only the best leaves' members are scored; slots the probed
        leaves cannot fill are index -1, score -inf and a zero embedding.
        Otherwise one exact matmul over the whole database."""
        q = _normalized(torch.as_tensor(queries).to(self.device, torch.float32))
        kk = min(k, self.num_entries)
        if leaves_to_search is None:
            leaves_to_search = self.default_leaves_to_search
        with _ieee_float32():
            if leaves_to_search is None or not self.partitioned:
                scores, idx = torch.topk(q @ self.embeddings.T, kk, dim=1)
                return {"nn_indices": idx, "nn_scores": scores,
                        "nn_embeddings": self.embeddings[idx]}
            n_probe = min(leaves_to_search, self._centroids.shape[0])
            top_leaves = torch.topk(q @ self._centroids.T, n_probe, dim=1).indices
            cand_idx = self._leaf_idx[top_leaves].reshape(q.shape[0], -1)
            cand_mask = self._leaf_mask[top_leaves].reshape(q.shape[0], -1)
            scores = torch.einsum("bd,bcd->bc", q, self.embeddings[cand_idx])
        scores = scores.masked_fill(~cand_mask, float("-inf"))
        top_scores, top = torch.topk(scores, min(kk, scores.shape[1]), dim=1)
        idx = torch.where(torch.isfinite(top_scores), cand_idx.gather(1, top), -1)
        pad = kk - idx.shape[1]
        if pad:  # fewer candidates than k: pad to the fixed width
            idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
            top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=float("-inf"))
        emb = torch.where((idx >= 0)[..., None], self.embeddings[idx.clamp(min=0)], 0.0)
        return {"nn_indices": idx, "nn_scores": top_scores, "nn_embeddings": emb}

    def save(self, path: str):
        """The npz of the JAX package's `Searcher.save`: "embedding", the
        metadata, and the partitions under "_"-prefixed keys."""
        extra = {}
        if self.partitioned:
            extra = {"_centroids": self._centroids.cpu().numpy(),
                     "_leaf_idx": self._leaf_idx.cpu().numpy(),
                     "_leaf_mask": self._leaf_mask.cpu().numpy()}
            if self.default_leaves_to_search is not None:
                extra["_default_leaves_to_search"] = np.int64(self.default_leaves_to_search)
        np.savez(path, embedding=self.embeddings.cpu().numpy(), **self.metadata, **extra)

    @classmethod
    def load(cls, path: str, device=None) -> "Searcher":
        db = dict(np.load(path, allow_pickle=True))
        part = {k: db.pop(k) for k in list(db) if k.startswith("_")}
        s = cls.from_database(db, device=device)
        if part:
            s._centroids = torch.from_numpy(part["_centroids"]).to(s.device, torch.float32)
            s._leaf_idx = torch.from_numpy(part["_leaf_idx"]).to(s.device, torch.int64)
            s._leaf_mask = torch.from_numpy(part["_leaf_mask"]).to(s.device, torch.bool)
            if "_default_leaves_to_search" in part:
                s.default_leaves_to_search = int(part["_default_leaves_to_search"])
        return s

    def to(self, device) -> "Searcher":
        """A copy of this index (database, partitions, probe count) on
        `device`; the database is not normalized again."""
        s = Searcher.__new__(Searcher)
        s.__dict__.update(self.__dict__)
        s.device = resolve_device(device)
        for key in ("embeddings", "_centroids", "_leaf_idx", "_leaf_mask"):
            if getattr(self, key) is not None:
                setattr(s, key, getattr(self, key).to(s.device))
        return s


def auto_build_searcher(db: Dict, num_leaves: Optional[int] = None,
                        device=None) -> Searcher:
    """The index for a database's size (the reference's ScaNN rules): exact
    below 1e5 entries, else `num_leaves` (default int(sqrt(N))) partitions
    probed `num_leaves // 20` (at least 1) at a time."""
    s = Searcher.from_database(db, device=device)
    n = s.num_entries
    if n >= 1e5:
        leaves = num_leaves or int(np.sqrt(n))
        s.build_partitions(leaves)
        s.default_leaves_to_search = max(leaves // 20, 1)
    return s


@torch.no_grad()
def embed_queries(n: int, texts: Optional[Sequence[str]] = None, image=None,
                  text_embedder=None, image_embedder=None):
    """[n, D] L2-normalized CLIP query embeddings, as knn2img embeds them:
    `texts` cycled to n prompts through the text embedder (its first
    context token), or one image [1, H, W, 3] in [-1, 1] through the image
    embedder, repeated n times. On the embedder's device."""
    if image is not None:
        return image_embedder(image).repeat_interleave(n, dim=0)
    texts = list(texts)
    if not texts:
        raise ValueError("no prompts to embed")
    texts = (texts * ((n + len(texts) - 1) // len(texts)))[:n]
    tokens = text_embedder.tokenize(texts)
    return text_embedder(tokens)[:, 0, :]


@torch.no_grad()
def retrieval_conditioning(queries, searcher: Optional[Searcher] = None, k: int = 10,
                           guidance_scale: float = 5.0):
    """knn2img's cross-attention conditioning of `queries` [n, D]: the
    query token, followed with a `searcher` by its k nearest database
    entries, [n, 1 + k, D] float32 on the queries' device; the
    unconditional context is its zeros when guidance_scale is not 1, else
    None. The searcher must lie on the queries' device. Returns (cond,
    uncond, the search's result or None)."""
    c = queries.float()[:, None, :]
    nns = None
    if searcher is not None:
        if searcher.dim != queries.shape[-1]:
            raise ValueError(f"database dim {searcher.dim} != query dim {queries.shape[-1]}")
        if searcher.embeddings.device != queries.device:
            raise ValueError(f"the searcher is on {searcher.embeddings.device}, the queries on "
                             f"{queries.device}")
        nns = searcher.search(queries, k=k)
        c = torch.cat([c, nns["nn_embeddings"]], dim=1)
    uc = torch.zeros_like(c) if guidance_scale != 1.0 else None
    return c, uc, nns
