"""Layout tokens and their plot (counterpart of the parts of
`ealdm_tpu/data/layout.py` that `inference.log_images` needs): a layout is
a sequence of 5-token objects (class, then the x0, y0, x1, y1 corners
quantized to `n_bins` over [0, 1]) padded with `vocab_size - 1`, as the
`layout2img-openimages256` BERT reads it under `coordinates_bbox`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Box = Tuple[int, float, float, float, float]  # (class_id, x0, y0, x1, y1)


class BBoxTokenizer:
    """(class, corners) objects <-> fixed-length token sequences."""

    def __init__(self, vocab_size: int = 8192, n_classes: int = 601, n_bins: int = 256,
                 max_seq_len: int = 92):
        if n_classes + n_bins >= vocab_size:
            raise ValueError("the class and coordinate tokens must fit the vocab")
        self.n_classes, self.n_bins, self.max_seq_len = n_classes, n_bins, max_seq_len
        self.pad_id = vocab_size - 1
        self.max_objects = max_seq_len // 5

    def _quant(self, v: float) -> int:
        return self.n_classes + int(np.clip(v, 0.0, 1.0) * (self.n_bins - 1) + 0.5)

    def _dequant(self, tok: int) -> float:
        return (tok - self.n_classes) / (self.n_bins - 1)

    def encode(self, boxes: Sequence[Box]) -> np.ndarray:
        ids = []
        for cls, x0, y0, x1, y1 in boxes[: self.max_objects]:
            if not 0 <= cls < self.n_classes:
                raise ValueError(f"class {cls} out of range")
            ids.extend([cls, self._quant(x0), self._quant(y0), self._quant(x1),
                        self._quant(y1)])
        out = np.full((self.max_seq_len,), self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> List[Box]:
        boxes: List[Box] = []
        ids = [int(i) for i in ids if int(i) != self.pad_id]
        for i in range(0, len(ids) - 4, 5):
            boxes.append((ids[i], *(self._dequant(t) for t in ids[i + 1:i + 5])))
        return boxes


def render_layout(boxes: Sequence[Box], size: int = 256, n_classes: int = 601) -> np.ndarray:
    """A layout as filled class-coloured rectangles on white, [size, size, 3]
    in [-1, 1] (log_images' "bbox_image")."""
    img = np.ones((size, size, 3), np.float32)
    colors = np.random.RandomState(0).rand(n_classes, 3) * 0.9
    for cls, x0, y0, x1, y1 in boxes:
        a0, b0 = int(x0 * (size - 1)), int(y0 * (size - 1))
        a1, b1 = int(x1 * (size - 1)), int(y1 * (size - 1))
        a0, a1 = min(a0, a1), max(a0, a1)
        b0, b1 = min(b0, b1), max(b0, b1)
        img[b0:b1 + 1, a0:a1 + 1] = colors[cls % n_classes]
    return img * 2.0 - 1.0
