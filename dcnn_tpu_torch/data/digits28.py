"""The bundled offline image dataset: the 8x8 handwritten digits upsampled
to MNIST's 28x28 and written as MNIST-format CSVs (counterpart of
``dcnn_tpu/data/digits28.py``, the dataset ``model_snapshots/
mnist_cnn_model`` was trained on).

The 8x8 images ship with the package (``digits8x8.npz``, UCI optdigits
under CC BY 4.0; see ``digits8x8.md``), so the CSVs build with numpy and
scipy alone, byte for byte the JAX package's (which reads the same images
through scikit-learn). :func:`ensure_digits28_csvs` generates
``<root>/data/digits28/{train,test}.csv`` (a seeded 80/20 split) where
they are missing; :class:`~dcnn_tpu_torch.data.MNISTDataLoader` reads the
files.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

DIGITS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits8x8.npz")


def load_digits8x8() -> Tuple[np.ndarray, np.ndarray]:
    """``(pixels, labels)``: float64 (1797, 64) in 0..16 and int64 (1797,),
    the arrays ``sklearn.datasets.load_digits(return_X_y=True)`` gives."""
    with np.load(DIGITS_NPZ) as f:
        return (f["pixels"].astype(np.float64),
                f["labels"].astype(np.int64))


def ensure_digits28_csvs(root: str) -> str:
    """Generate ``<root>/data/digits28/{train,test}.csv`` if absent; returns
    the dataset dir. Cheap and deterministic — a gitignored ``data/``
    regenerates identically on any host."""
    d = os.path.join(root, "data", "digits28")
    if all(os.path.isfile(os.path.join(d, f))
           for f in ("train.csv", "test.csv")):
        return d
    from scipy import ndimage

    X, y = load_digits8x8()
    X = X.reshape(-1, 8, 8) / 16.0
    X28 = np.stack([ndimage.zoom(img, 3.5, order=1) for img in X])
    X28 = np.clip(X28 * 255.0, 0, 255).astype(np.uint8).reshape(len(X), -1)

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(X28))
    n_test = len(X28) // 5
    splits = {"train.csv": idx[n_test:], "test.csv": idx[:n_test]}
    for name, rows in splits.items():
        path = os.path.join(d, name)
        if not os.path.exists(path):
            # temp-write + atomic rename: an interrupted run must never
            # leave a truncated CSV that later gates silently train on; the
            # temp name is the process's, so concurrent writers never share
            # one
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write("label," + ",".join(
                    f"pixel{i}" for i in range(784)) + "\n")
                for r in rows:
                    f.write(str(int(y[r])) + "," + ",".join(
                        map(str, X28[r])) + "\n")
            os.replace(tmp, path)
    return d
