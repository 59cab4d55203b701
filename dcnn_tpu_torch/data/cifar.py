"""CIFAR-10 and CIFAR-100 binary readers (counterpart of
``dcnn_tpu/data/cifar.py``).

Records of ``[label][3072 pixel bytes]`` (CIFAR-10) or ``[coarse][fine]
[3072 pixel bytes]`` (CIFAR-100), pixels plane-major R, G, B as 3×32×32.
Pixels stay uint8, the on-disk bytes being the wire format; the consumer's
decode multiplies by the loader's ``scale`` (1/255).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple, Union

import numpy as np

from .loader import BaseDataLoader, one_hot

_IMG_BYTES = 3 * 32 * 32

CIFAR10_CLASS_NAMES = ["airplane", "automobile", "bird", "cat", "deer",
                       "dog", "frog", "horse", "ship", "truck"]


def _decode_file(path: str, skip_bytes: int, label_col: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One binary file -> (images (N, 3, 32, 32) uint8, labels int64)."""
    rec = skip_bytes + _IMG_BYTES
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    raw = np.fromfile(path, dtype=np.uint8)
    if len(raw) % rec:
        raise ValueError(f"{path}: size {len(raw)} not a multiple of {rec}")
    rows = raw.reshape(-1, rec)
    return (rows[:, skip_bytes:].reshape(-1, 3, 32, 32),
            rows[:, label_col].astype(np.int64))


class _CifarLoader(BaseDataLoader):
    _SKIP = 1

    def __init__(self, files: Union[Sequence[str], str],
                 data_format: str = "NCHW", **kw):
        super().__init__(**kw)
        self.files: List[str] = ([files] if isinstance(files, str)
                                 else list(files))
        self.data_format = data_format

    def _label_col(self) -> int:
        return 0

    def load_data(self) -> None:
        parts = [_decode_file(p, self._SKIP, self._label_col())
                 for p in self.files]
        x = np.concatenate([im for im, _ in parts])
        if self.data_format == "NHWC":
            x = np.transpose(x, (0, 2, 3, 1))
        self._x = np.ascontiguousarray(x)
        self._y = one_hot(np.concatenate([lb for _, lb in parts]),
                          self.NUM_CLASSES)


class CIFAR10DataLoader(_CifarLoader):
    NUM_CLASSES = 10


class CIFAR100DataLoader(_CifarLoader):
    """CIFAR-100 with fine (default, 100 classes) or coarse (20) labels."""

    _SKIP = 2

    def __init__(self, files: Union[Sequence[str], str],
                 data_format: str = "NCHW", label_mode: str = "fine", **kw):
        if label_mode not in ("fine", "coarse"):
            raise ValueError("label_mode must be 'fine' or 'coarse'")
        super().__init__(files, data_format, **kw)
        self.label_mode = label_mode

    @property
    def NUM_CLASSES(self) -> int:  # noqa: N802 - constant-style
        return 100 if self.label_mode == "fine" else 20

    def _label_col(self) -> int:
        return 1 if self.label_mode == "fine" else 0
