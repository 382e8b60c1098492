"""Evaluation metrics of the third stage (counterpart of
`ealdm_tpu/metrics.py`): PSNR, the Frechet distance and a streaming FID over
features, multi-label F1 (macro and micro) and the CLIP-style label
agreement.

Host numpy in float64, as in the JAX package: the features come off the
card once a batch, and the distance's matrix square root is scipy's
(`linalg.sqrtm`, retried with eps on the diagonals when it is not finite).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)  # the matrix alone: newer scipy has no disp=
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class FID:
    """Streaming FID: update(real or fake features) -> compute(). With a
    `feature_fn`, update takes images and maps them to features first."""

    def __init__(self, feature_fn: Optional[Callable] = None):
        self.feature_fn = feature_fn
        self._real = []
        self._fake = []

    def update(self, images_or_feats, real: bool):
        feats = (self.feature_fn(images_or_feats) if self.feature_fn is not None
                 else images_or_feats)
        feats = np.asarray(feats, np.float64).reshape(len(feats), -1)
        (self._real if real else self._fake).append(feats)

    def compute(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        cov_r = np.cov(real, rowvar=False)
        cov_f = np.cov(fake, rowvar=False)
        return frechet_distance(real.mean(0), cov_r, fake.mean(0), cov_f)

    def reset(self):
        self._real, self._fake = [], []


def multilabel_f1(y_true: np.ndarray, y_pred: np.ndarray, average: str = "macro") -> float:
    """F1 over multi-hot labels [N, C], each thresholded at 0.5 (sklearn's
    f1_score with zero_division 0, macro or micro)."""
    y_true = np.asarray(y_true) > 0.5
    y_pred = np.asarray(y_pred) > 0.5
    tp = (y_true & y_pred).sum(0).astype(np.float64)
    fp = (~y_true & y_pred).sum(0).astype(np.float64)
    fn = (y_true & ~y_pred).sum(0).astype(np.float64)
    if average == "micro":
        p = tp.sum() / max(tp.sum() + fp.sum(), 1e-12)
        r = tp.sum() / max(tp.sum() + fn.sum(), 1e-12)
        return float(2 * p * r / max(p + r, 1e-12))
    p = tp / np.maximum(tp + fp, 1e-12)
    r = tp / np.maximum(tp + fn, 1e-12)
    return float((2 * p * r / np.maximum(p + r, 1e-12)).mean())


def label_agreement(sim_logits: np.ndarray, labels_multi_hot: np.ndarray) -> float:
    """The share of samples whose argmax class is among their true labels
    (the zero-shot agreement of CLIP's logits, or of a head's scores)."""
    pred = np.argmax(sim_logits, axis=-1)
    hits = [float(labels_multi_hot[i, pred[i]] > 0.5) for i in range(len(pred))]
    return float(np.mean(hits)) if hits else 0.0
