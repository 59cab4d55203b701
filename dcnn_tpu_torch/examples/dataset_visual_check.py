"""Dataset visual sanity check (counterpart of
``examples/dataset_visual_check.py``): write a few decoded samples of a
loader as image files and print their labels, so a person can confirm
that the decode and augment pipeline neither shears images nor scrambles
labels.

Writes binary PPM (P6) files, which any image tool opens, and a coarse
ASCII preview to stdout for terminal-only hosts.

Usage:
    python -m dcnn_tpu_torch.examples.dataset_visual_check [dataset] [outdir] [n]

dataset: digits28 (default, bundled) | mnist | cifar10 | tiny_imagenet
(the latter three read the dataset under data/, at the paths
``accuracy_gates`` uses). The default outdir is ``visual_check_<dataset>``
under the temp dir.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from ..data.digits28 import ensure_digits28_csvs
from ..resilience.atomic import write_file_atomic
from .common import ROOT, setup


def _write_ppm(path: str, img: np.ndarray) -> None:
    """img: (H, W, C) float [0, 1] or uint8; C in {1, 3}."""
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    h, w, _ = img.shape
    write_file_atomic(path, f"P6\n{w} {h}\n255\n".encode() + img.tobytes())


def _ascii(img: np.ndarray, width: int = 32) -> str:
    """Coarse ASCII preview of a (H, W, C) image, [0, 1] float or uint8."""
    if img.dtype == np.uint8:
        img = img / 255.0
    g = img.mean(axis=-1)
    step = max(1, g.shape[1] // width)
    g = g[::step * 2, ::step]   # terminal cells are ~2x taller than wide
    ramp = " .:-=+*#%@"
    idx = np.clip((g * (len(ramp) - 1)).astype(int), 0, len(ramp) - 1)
    return "\n".join("".join(ramp[i] for i in row) for row in idx)


def _load(name: str):
    """Returns (loader, class_names or None). Loader batches are NHWC."""
    if name == "digits28":
        from ..data import MNISTDataLoader
        csv = os.path.join(ensure_digits28_csvs(ROOT), "train.csv")
        ld = MNISTDataLoader(csv, data_format="NHWC", batch_size=16,
                             shuffle=False)
    elif name == "mnist":
        from ..data import MNISTDataLoader
        ld = MNISTDataLoader(os.path.join(ROOT, "data/mnist/train.csv"),
                             data_format="NHWC", batch_size=16, shuffle=False)
    elif name == "cifar10":
        from ..data import CIFAR10DataLoader
        d = os.path.join(ROOT, "data/cifar-10-batches-bin")
        ld = CIFAR10DataLoader([os.path.join(d, "data_batch_1.bin")],
                               data_format="NHWC", batch_size=16,
                               shuffle=False)
    elif name == "tiny_imagenet":
        from ..data import TinyImageNetDataLoader
        ld = TinyImageNetDataLoader(
            os.path.join(ROOT, "data/tiny-imagenet-200"), split="train",
            data_format="NHWC", batch_size=16, shuffle=False)
    else:
        raise SystemExit(f"unknown dataset {name}")
    ld.load_data()
    return ld


def main() -> dict:
    setup("dataset_visual_check")
    name = sys.argv[1] if len(sys.argv) > 1 else "digits28"
    outdir = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        tempfile.gettempdir(), f"visual_check_{name}")
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    ld = _load(name)
    os.makedirs(outdir, exist_ok=True)
    x, y = next(iter(ld))
    x = np.asarray(x)
    y = np.asarray(y)
    labels = y.argmax(-1) if y.ndim == 2 else y
    for i in range(min(n, len(x))):
        path = os.path.join(outdir, f"{name}_{i}_label{int(labels[i])}.ppm")
        _write_ppm(path, x[i])
        print(f"--- sample {i}: label {int(labels[i])} -> {path}")
        print(_ascii(x[i]))
    print(f"wrote {min(n, len(x))} PPM files to {outdir}; "
          f"pixel range [{x.min():.3f}, {x.max():.3f}]")
    return {"written": min(n, len(x)), "outdir": outdir}


if __name__ == "__main__":
    main()
