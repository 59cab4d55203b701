"""Dataset downloader CLI (counterpart of ``dcnn_tpu/data/download.py``):
fetches MNIST, CIFAR-10, CIFAR-100, Tiny-ImageNet and UJIIndoorLoc into the
layout the loaders read (``data/mnist/*.csv``, ``data/cifar-10-batches-bin/``,
``data/cifar-100-binary/``, ``data/tiny-imagenet-200/``, ``data/uji/``),
from the same URLs with the same md5 checks. MNIST's IDX files become the
``label,1x1..28x28`` CSVs, byte for byte the JAX package's.

Usage:
    python -m dcnn_tpu_torch.data.download --root data mnist cifar10
    python -m dcnn_tpu_torch.data.download --root data all

Importing the module touches no network. A fetch is bounded: ``_fetch``
gives up after ``timeout`` seconds over all its retries and exits naming
the URL, so a host without a network fails fast and the command is re-run
where one exists.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import io
import os
import struct
import tarfile
import time
import urllib.request
import zipfile

MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist/"
MNIST_FILES = {
    "train-images-idx3-ubyte.gz": "f68b3c2dcbeaaa9fbdd348bbdeb94873",
    "train-labels-idx1-ubyte.gz": "d53e105ee54ea40749a09fcbcd1e9432",
    "t10k-images-idx3-ubyte.gz": "9fb629c4189551a2d022fa330f9573f3",
    "t10k-labels-idx1-ubyte.gz": "ec29112dd5afa0611ce80d1b7f02629c",
}
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-binary.tar.gz"
CIFAR10_MD5 = "c32a1d4ab5d03f1284b67883e8d87530"
CIFAR100_URL = "https://www.cs.toronto.edu/~kriz/cifar-100-binary.tar.gz"
CIFAR100_MD5 = "03b5dce01913d631647c71ecec9e9cb8"
TINY_IMAGENET_URL = "http://cs231n.stanford.edu/tiny-imagenet-200.zip"
TINY_IMAGENET_MD5 = "90528d7ca1a48142e341f4ef8d21d0de"
# UCI publishes no checksum for this archive; download_uji checks that
# both expected CSVs are in it
UJI_URL = "https://archive.ics.uci.edu/static/public/310/ujiindoorloc.zip"

FETCH_TIMEOUT_S = 120.0


def _fetch(url: str, md5: str | None = None,
           timeout: float = FETCH_TIMEOUT_S) -> bytes:
    """The bytes at ``url``, md5-checked; transient failures retried with
    backoff, all of it within ``timeout`` seconds. ``SystemExit`` naming
    the URL on failure."""
    from ..resilience.retry import retry_call

    print(f"fetching {url} ...", flush=True)
    deadline = time.monotonic() + timeout

    def attempt() -> bytes:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"no time left of {timeout:g} s")
        with urllib.request.urlopen(url, timeout=left) as r:
            return r.read()

    def transient(e: BaseException) -> bool:
        # a permanent 4xx (a dead mirror, 403) does not heal on retry;
        # 408/429, 5xx and code-less errors (resets, DNS) do
        code = getattr(e, "code", None)
        return not (isinstance(code, int) and 400 <= code < 500
                    and code not in (408, 429))

    try:
        data = retry_call(
            attempt, attempts=4, base=1.0, cap=15.0, timeout=timeout,
            retry_on=(OSError,), retry_if=transient, name="dataset_download",
            on_retry=lambda i, e, d: print(
                f"  retry {i + 1} for {url} in {d:.1f}s ({e})", flush=True))
    except OSError as e:
        raise SystemExit(
            f"download failed for {url}: {e}\n"
            "(no network here? re-run this command on a connected host and "
            "copy the data/ directory over)") from None
    if md5 is not None:
        got = hashlib.md5(data).hexdigest()
        if got != md5:
            raise SystemExit(f"md5 mismatch for {url}: {got} != {md5}")
    return data


def _replace_atomically(out_path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``out_path``, then rename:
    the loaders take an existing file for the dataset, so an interrupted
    write must leave none."""
    tmp = f"{out_path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, out_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _idx_to_csv(images: bytes, labels: bytes, out_csv: str) -> None:
    """An IDX image/label pair as the MNIST CSV schema (header, then
    ``label,784 pixels`` a row)."""
    magic, n, rows, cols = struct.unpack(">IIII", images[:16])
    if magic != 2051:
        raise ValueError(f"not an IDX image file (magic {magic})")
    lmagic, ln = struct.unpack(">II", labels[:8])
    if lmagic != 2049 or ln != n:
        raise ValueError(f"IDX labels (magic {lmagic}, {ln} items) do not "
                         f"match {n} images")
    px = memoryview(images)[16:]
    lb = memoryview(labels)[8:]
    d = rows * cols

    def write(f):
        f.write(("label," + ",".join(
            f"{r + 1}x{c + 1}" for r in range(rows) for c in range(cols))
            + "\n").encode())
        for i in range(n):
            row = px[i * d:(i + 1) * d]
            f.write((str(lb[i]) + "," + ",".join(map(str, row))
                     + "\n").encode())

    _replace_atomically(out_csv, write)
    print(f"wrote {out_csv} ({n} rows)")


def download_mnist(root: str) -> None:
    out = os.path.join(root, "mnist")
    os.makedirs(out, exist_ok=True)
    raw = {fname: gzip.decompress(_fetch(MNIST_BASE + fname, md5))
           for fname, md5 in MNIST_FILES.items()}
    _idx_to_csv(raw["train-images-idx3-ubyte.gz"],
                raw["train-labels-idx1-ubyte.gz"],
                os.path.join(out, "train.csv"))
    _idx_to_csv(raw["t10k-images-idx3-ubyte.gz"],
                raw["t10k-labels-idx1-ubyte.gz"],
                os.path.join(out, "test.csv"))


def _untar(data: bytes, root: str) -> None:
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
        tf.extractall(root)  # noqa: S202 - fixed, md5-checked archives


def download_cifar10(root: str) -> None:
    _untar(_fetch(CIFAR10_URL, CIFAR10_MD5), root)
    print(f"extracted {os.path.join(root, 'cifar-10-batches-bin')}")


def download_cifar100(root: str) -> None:
    _untar(_fetch(CIFAR100_URL, CIFAR100_MD5), root)
    print(f"extracted {os.path.join(root, 'cifar-100-binary')}")


def download_tiny_imagenet(root: str) -> None:
    data = _fetch(TINY_IMAGENET_URL, TINY_IMAGENET_MD5)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(root)
    print(f"extracted {os.path.join(root, 'tiny-imagenet-200')}")


def download_uji(root: str) -> None:
    out = os.path.join(root, "uji")
    os.makedirs(out, exist_ok=True)
    data = _fetch(UJI_URL)
    found = set()
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for name in zf.namelist():
            base = os.path.basename(name)
            if base.lower() in ("trainingdata.csv", "validationdata.csv"):
                with zf.open(name) as src:
                    body = src.read()
                _replace_atomically(os.path.join(out, base),
                                    lambda f, b=body: f.write(b))
                found.add(base.lower())
    if found != {"trainingdata.csv", "validationdata.csv"}:
        raise SystemExit(
            f"UJI archive missing expected CSVs (got {sorted(found)}); "
            "truncated or changed upstream archive")
    print(f"extracted {out}")


DATASETS = {
    "mnist": download_mnist,
    "cifar10": download_cifar10,
    "cifar100": download_cifar100,
    "tiny_imagenet": download_tiny_imagenet,
    "uji": download_uji,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("datasets", nargs="+",
                    choices=sorted(DATASETS) + ["all"],
                    help="datasets to fetch (or 'all')")
    ap.add_argument("--root", default="data",
                    help="data root dir (default: data)")
    args = ap.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    names = sorted(DATASETS) if "all" in args.datasets else args.datasets
    for name in names:
        DATASETS[name](args.root)


if __name__ == "__main__":
    main()
