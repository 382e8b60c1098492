"""Feature scalers with JSON persistence (the port's copy of
`ealdm_tpu/data/scalers.py`, numpy and json only, so that nothing of the JAX
package is imported).

sklearn's StandardScaler / MinMaxScaler / MultiLabelBinarizer as the
reference dataset fits and dumps them (`STDiff/dataset_wlbl.py:157-177`) and
its ImageLogger reloads them to inverse-transform the logged conditions
(`main.py:389-391`), kept as JSON files instead of joblib pickles.
"""
from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


class StandardScaler:
    def __init__(self):
        self.mean_ = None
        self.scale_ = None

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        std = x.std(axis=0)
        self.scale_ = np.where(std == 0, 1.0, std)
        return self

    def transform(self, x):
        return (np.asarray(x) - self.mean_) / self.scale_

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def inverse_transform(self, x):
        return np.asarray(x) * self.scale_ + self.mean_

    def to_dict(self):
        return {
            "type": "standard",
            "mean": np.asarray(self.mean_).tolist(),
            "scale": np.asarray(self.scale_).tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        s = cls()
        s.mean_ = np.asarray(d["mean"])
        s.scale_ = np.asarray(d["scale"])
        return s


class MinMaxScaler:
    def __init__(self, feature_range=(0.0, 1.0)):
        self.feature_range = tuple(feature_range)
        self.data_min_ = None
        self.data_max_ = None

    def fit(self, x):
        x = np.asarray(x, np.float64)
        self.data_min_ = x.min(axis=0)
        self.data_max_ = x.max(axis=0)
        return self

    def transform(self, x):
        lo, hi = self.feature_range
        span = np.where(
            self.data_max_ == self.data_min_, 1.0, self.data_max_ - self.data_min_
        )
        return (np.asarray(x) - self.data_min_) / span * (hi - lo) + lo

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def inverse_transform(self, x):
        lo, hi = self.feature_range
        span = np.where(
            self.data_max_ == self.data_min_, 1.0, self.data_max_ - self.data_min_
        )
        return (np.asarray(x) - lo) / (hi - lo) * span + self.data_min_

    def to_dict(self):
        return {
            "type": "minmax",
            "feature_range": list(self.feature_range),
            "min": np.asarray(self.data_min_).tolist(),
            "max": np.asarray(self.data_max_).tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        s = cls(tuple(d["feature_range"]))
        s.data_min_ = np.asarray(d["min"])
        s.data_max_ = np.asarray(d["max"])
        return s


class MultiLabelBinarizer:
    def __init__(self, classes: Sequence[str]):
        self.classes_ = list(classes)
        self._index = {c: i for i, c in enumerate(self.classes_)}

    def transform(self, label_lists) -> np.ndarray:
        out = np.zeros((len(label_lists), len(self.classes_)), np.float32)
        for i, labels in enumerate(label_lists):
            if isinstance(labels, str):
                labels = [labels]
            for lbl in labels or ():
                j = self._index.get(lbl)
                if j is not None:
                    out[i, j] = 1.0
        return out

    fit_transform = transform

    def inverse_transform(self, y: np.ndarray) -> List[List[str]]:
        return [
            [c for c, v in zip(self.classes_, row) if v > 0.5] for row in np.asarray(y)
        ]

    def to_dict(self):
        return {"type": "multilabel", "classes": self.classes_}

    @classmethod
    def from_dict(cls, d):
        return cls(d["classes"])


_TYPES = {
    "standard": StandardScaler,
    "minmax": MinMaxScaler,
    "multilabel": MultiLabelBinarizer,
}


def save_scaler(scaler, path: str):
    with open(path, "w") as f:
        json.dump(scaler.to_dict(), f)


def load_scaler(path: str):
    with open(path) as f:
        d = json.load(f)
    return _TYPES[d["type"]].from_dict(d)
