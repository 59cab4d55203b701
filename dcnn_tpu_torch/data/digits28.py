"""The bundled offline image dataset: sklearn's 8x8 digits upsampled to
MNIST's 28x28 and written as MNIST-format CSVs (counterpart of
``dcnn_tpu/data/digits28.py``, the dataset ``model_snapshots/
mnist_cnn_model`` was trained on).

:func:`ensure_digits28_csvs` generates ``<root>/data/digits28/{train,
test}.csv`` (a seeded 80/20 split) where they are missing; it imports
scipy and sklearn only then. :class:`~dcnn_tpu_torch.data.MNISTDataLoader`
reads the files.
"""

from __future__ import annotations

import os

import numpy as np


def ensure_digits28_csvs(root: str) -> str:
    """Generate ``<root>/data/digits28/{train,test}.csv`` if absent; returns
    the dataset dir. Cheap and deterministic — a gitignored ``data/``
    regenerates identically on any host."""
    from scipy import ndimage
    from sklearn.datasets import load_digits

    d = os.path.join(root, "data", "digits28")
    if all(os.path.isfile(os.path.join(d, f))
           for f in ("train.csv", "test.csv")):
        return d
    X, y = load_digits(return_X_y=True)
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
            # leave a truncated CSV that later gates silently train on
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write("label," + ",".join(
                    f"pixel{i}" for i in range(784)) + "\n")
                for r in rows:
                    f.write(str(int(y[r])) + "," + ",".join(
                        map(str, X28[r])) + "\n")
            os.replace(tmp, path)
    return d
