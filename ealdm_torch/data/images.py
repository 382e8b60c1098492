"""Image-folder datasets (counterpart of `ealdm_tpu/data/images.py`'s
`ImageFolderDataset` and `center_crop_resize`): a file list or a folder of
PNG or `.npy` images, centre-cropped to a square, resized, scaled to
[-1, 1].

The card's machine has no imaging package, so PNGs are read by
`utils/png.py` and the resize is Pillow's, in numpy: `resample` is
Pillow's separable convolution resize of 8-bit images (`Resample.c`), the
filter's support widened by the downscale factor, its weights normalised
and rounded to 22-bit fixed point, the horizontal pass first and its
result rounded to uint8 before the vertical pass. BICUBIC uses Pillow's
a = -0.5. JPEG and WebP have no decoder on the card: they raise
(`ImageSRDataset` and `degrade_sr_light`, which re-encode JPEG, wait with
them: ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from ..utils.png import load_png, to_rgb
from .pipeline import Dataset

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images
_JPEG_ITEM = "ROADMAP queue 1 item 9 (the JPEG data paths)"


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, out_size: int, kind: str):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc`: (first input
    index [out], fixed-point weights [out, ksize]; zero past each window)."""
    filt, support = FILTERS[kind]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx] = xmin
        weights[xx, :xmax] = [int(-0.5 + w * (1 << _PRECISION_BITS)) if w < 0
                              else int(0.5 + w * (1 << _PRECISION_BITS)) for w in k]
    return first, weights


def _pass(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One pass of the separable resize along `axis` (0 rows, 1 columns) of a
    uint8 [H, W, C] image."""
    in_size = img.shape[axis]
    first, weights = _coefficients(in_size, out_size, kind)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(weights.shape[1]):
        acc += src[idx[:, j]] * weights[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resample(img: np.ndarray, size, kind: str = "bicubic") -> np.ndarray:
    """Pillow's `Image.resize(size, BICUBIC or BILINEAR)` of a uint8 [H, W]
    or [H, W, C] image; size is (width, height) as Pillow takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resample takes uint8, not {img.dtype}")
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    flat = img.ndim == 2
    x = img[..., None] if flat else img
    if x.shape[1] != w:
        x = _pass(x, w, 1, kind)
    if x.shape[0] != h:
        x = _pass(x, h, 0, kind)
    return x[..., 0] if flat else x


def center_crop_resize(arr: np.ndarray, size: int) -> np.ndarray:
    """The centred square crop of a uint8 image, BICUBIC-resized to size^2."""
    h, w = arr.shape[:2]
    crop = min(h, w)
    top, left = (h - crop) // 2, (w - crop) // 2
    arr = arr[top:top + crop, left:left + crop]
    return resample(arr, (size, size), "bicubic")


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3]: PNG (any colour type the reader
    takes, converted as PIL's convert("RGB") does)."""
    if path.lower().endswith(".png"):
        return to_rgb(load_png(path))
    raise NotImplementedError(f"{path}: no decoder for this format on the card (PNG and .npy "
                              f"only; JPEG and WebP wait for {_JPEG_ITEM})")


class ImageFolderDataset(Dataset):
    """LSUN-style dataset from a file list or a folder of images: each item
    {key: [size, size, 3] float32 in [-1, 1], "file_path_": its path}."""

    def __init__(self, data_root: str, txt_file: Optional[str] = None, size: int = 256,
                 flip_p: float = 0.0, key: str = "image", seed: int = 0):
        self.data_root = data_root
        if txt_file:
            with open(txt_file) as f:
                rel = [line.strip() for line in f if line.strip()]
        else:
            exts = (".png", ".jpg", ".jpeg", ".webp", ".npy")
            rel = sorted(fn for fn in os.listdir(data_root) if fn.lower().endswith(exts))
        self.paths = [os.path.join(data_root, r) for r in rel]
        self.size = size
        self.flip_p = flip_p
        self.key = key
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.paths)

    def _load(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            return arr
        return read_image(path)

    def skip_item(self, idx) -> None:
        """The flip's draw of `self[idx]`, nothing loaded (`DataLoader`'s rows)."""
        if self.flip_p > 0:
            self._rng.rand()

    def __getitem__(self, idx):
        arr = center_crop_resize(self._load(self.paths[idx]), self.size)
        if self.flip_p > 0 and self._rng.rand() < self.flip_p:
            arr = arr[:, ::-1]
        img = arr.astype(np.float32) / 127.5 - 1.0
        return {self.key: img, "file_path_": self.paths[idx]}
