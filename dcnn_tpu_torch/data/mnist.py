"""MNIST CSV reader (counterpart of ``dcnn_tpu/data/mnist.py``).

Rows of ``label,pix0..pix783`` after one header line, shaped 1×28×28 (or
28×28×1 in NHWC), labels one-hot over 10. Integer pixels in 0..255 load as
uint8, the wire dtype, and the loader's ``scale`` (1/255) carries the
normalization to the consumer's decode; fractional pixels load as float32
times 1/255, scale 1.0. Parsed by the native CSV parser
(``native.parse_label_csv``), as the JAX reader parses; files it refuses
(fractional pixels) and hosts without the library take numpy's
``loadtxt``, which gives the same arrays for integer CSVs.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from .loader import BaseDataLoader, one_hot


class MNISTDataLoader(BaseDataLoader):
    NUM_CLASSES = 10

    def __init__(self, csv_path: str, data_format: str = "NCHW", **kw):
        super().__init__(**kw)
        self.csv_path = csv_path
        self.data_format = data_format

    def load_data(self) -> None:
        if not os.path.isfile(self.csv_path):
            raise FileNotFoundError(self.csv_path)
        # scale 1.0: the native parser takes integer pixels 0..255 only, so
        # the unscaled float is exact and the uint8 cast lossless
        parsed = native.parse_label_csv(self.csv_path, 28 * 28, scale=1.0)
        if parsed is not None:
            pixels, labels = parsed
            labels = labels.astype(np.int64)
            pixels = pixels.astype(np.uint8)
        else:
            raw = np.loadtxt(self.csv_path, delimiter=",", skiprows=1,
                             dtype=np.float32, ndmin=2)
            labels = raw[:, 0].astype(np.int64)
            pix = raw[:, 1:]
            if (pix.size and np.all(pix == np.rint(pix)) and pix.min() >= 0
                    and pix.max() <= 255):
                pixels = pix.astype(np.uint8)
            else:
                pixels = pix * np.float32(1.0 / 255.0)
        imgs = pixels.reshape(-1, 1, 28, 28)
        if self.data_format == "NHWC":
            imgs = np.transpose(imgs, (0, 2, 3, 1))
        self._x = np.ascontiguousarray(imgs)
        self._y = one_hot(labels, self.NUM_CLASSES)
