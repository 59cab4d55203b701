"""Synthetic classification data (counterpart of
``dcnn_tpu/data/synthetic.py``), so trainers and the chip smoke run without
a dataset on disk. The same seed gives the JAX loader's arrays bit for bit
(both draw from ``np.random.default_rng(seed)`` in the same order)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .loader import BaseDataLoader, one_hot


class SyntheticClassificationLoader(BaseDataLoader):
    """Separable class-conditioned Gaussian blobs in image tensors: noise of
    std 0.1, plus 3.0 at flat position ``7·class mod size`` of each sample
    when ``separable``."""

    def __init__(self, num_samples: int = 1024,
                 image_shape: Tuple[int, ...] = (3, 32, 32),
                 num_classes: int = 10, separable: bool = True, **kw):
        super().__init__(**kw)
        self.n_samples = int(num_samples)
        self.image_shape = tuple(image_shape)
        self.num_classes = int(num_classes)
        self.separable = separable

    def load_data(self) -> None:
        rng = np.random.default_rng(self.seed)
        labels = rng.integers(0, self.num_classes, size=self.n_samples)
        x = rng.normal(size=(self.n_samples, *self.image_shape)).astype(
            np.float32) * 0.1
        if self.separable:
            flat = x.reshape(self.n_samples, -1)
            for c in range(self.num_classes):
                flat[labels == c, c * 7 % flat.shape[1]] += 3.0
        self._x = x
        self._y = one_hot(labels, self.num_classes)
