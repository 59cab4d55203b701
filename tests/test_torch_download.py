"""``dcnn_tpu_torch.data.download`` against ``dcnn_tpu.data.download``.

Nothing is fetched: ``_idx_to_csv`` and ``_untar`` get local bytes, each
``download_*`` runs with ``_fetch`` replaced by a stub that serves local
archives by URL, and ``_fetch`` itself runs over a stubbed ``urlopen``.
Every file the port writes must be byte-equal to the JAX package's.
"""

import gzip
import hashlib
import io
import os
import struct
import tarfile
import urllib.error
import zipfile

import numpy as np
import pytest

from dcnn_tpu.data import download as jdl
from dcnn_tpu_torch.data import MNISTDataLoader
from dcnn_tpu_torch.data import download as tdl


def _idx(n, rows=28, cols=28, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, size=n, dtype=np.uint8)
    return (struct.pack(">IIII", 2051, n, rows, cols) + imgs.tobytes(),
            struct.pack(">II", 2049, n) + labels.tobytes(), imgs, labels)


def _tar_gz(files):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, body in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(body)
            tf.addfile(info, io.BytesIO(body))
    return buf.getvalue()


def _zip(files):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, body in files.items():
            zf.writestr(name, body)
    return buf.getvalue()


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _archives():
    tr_i, tr_l, _, _ = _idx(7, seed=1)
    te_i, te_l, _, _ = _idx(3, seed=2)
    mnist = {tdl.MNIST_BASE + "train-images-idx3-ubyte.gz": gzip.compress(tr_i),
             tdl.MNIST_BASE + "train-labels-idx1-ubyte.gz": gzip.compress(tr_l),
             tdl.MNIST_BASE + "t10k-images-idx3-ubyte.gz": gzip.compress(te_i),
             tdl.MNIST_BASE + "t10k-labels-idx1-ubyte.gz": gzip.compress(te_l)}
    rng = np.random.default_rng(3)
    rec = rng.integers(0, 256, size=(4, 3073), dtype=np.uint8).tobytes()
    return {
        **mnist,
        tdl.CIFAR10_URL: _tar_gz({
            f"cifar-10-batches-bin/data_batch_{i}.bin": rec for i in (1, 2)}),
        tdl.CIFAR100_URL: _tar_gz({"cifar-100-binary/train.bin": rec + rec,
                                   "cifar-100-binary/test.bin": rec}),
        tdl.TINY_IMAGENET_URL: _zip({
            "tiny-imagenet-200/wnids.txt": b"n01443537\nn01629819\n",
            "tiny-imagenet-200/val/val_annotations.txt":
                b"val_0.JPEG\tn01443537\t0\t0\t62\t62\n"}),
        tdl.UJI_URL: _zip({"UJIndoorLoc/trainingData.csv": b"a,b\n1,2\n",
                           "UJIndoorLoc/validationData.csv": b"a,b\n3,4\n",
                           "UJIndoorLoc/README": b"x"}),
    }


def test_urls_and_checksums_are_jax_s():
    assert tdl.MNIST_BASE == jdl.MNIST_BASE
    assert tdl.MNIST_FILES == jdl.MNIST_FILES
    for k in ("CIFAR10_URL", "CIFAR10_MD5", "CIFAR100_URL", "CIFAR100_MD5",
              "TINY_IMAGENET_URL", "TINY_IMAGENET_MD5", "UJI_URL"):
        assert getattr(tdl, k) == getattr(jdl, k), k
    assert sorted(tdl.DATASETS) == sorted(jdl.DATASETS)


@pytest.mark.parametrize("n,rows,cols", [(5, 28, 28), (1, 4, 3), (0, 2, 2)])
def test_idx_to_csv_byte_equal_to_jax(tmp_path, n, rows, cols):
    images, labels, imgs, lab = _idx(n, rows, cols, seed=n)
    jdl._idx_to_csv(images, labels, str(tmp_path / "jax.csv"))
    tdl._idx_to_csv(images, labels, str(tmp_path / "port.csv"))
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    assert sorted(os.listdir(tmp_path)) == ["jax.csv", "port.csv"]
    if rows == cols == 28 and n:
        ld = MNISTDataLoader(str(tmp_path / "port.csv"), batch_size=n,
                             shuffle=False)
        ld.load_data()
        x, y = next(iter(ld))
        np.testing.assert_array_equal(np.asarray(x).reshape(n, 28, 28), imgs)
        np.testing.assert_array_equal(np.asarray(y).argmax(1), lab)


def test_idx_to_csv_refuses_mismatched_files(tmp_path):
    images, labels, _, _ = _idx(4)
    _, other, _, _ = _idx(3)
    with pytest.raises(ValueError):
        tdl._idx_to_csv(struct.pack(">I", 2049) + images[4:], labels,
                        str(tmp_path / "a.csv"))
    with pytest.raises(ValueError):
        tdl._idx_to_csv(images, other, str(tmp_path / "b.csv"))
    assert os.listdir(tmp_path) == []


def test_untar_byte_equal_to_jax(tmp_path):
    data = _archives()[tdl.CIFAR100_URL]
    jdl._untar(data, str(tmp_path / "jax"))
    tdl._untar(data, str(tmp_path / "port"))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want and len(got) == 2


@pytest.mark.parametrize("name", sorted(tdl.DATASETS))
def test_download_writes_what_jax_writes(tmp_path, monkeypatch, name):
    served = _archives()
    calls = {"jax": [], "port": []}

    def stub(which):
        def fetch(url, md5=None, *args, **kwargs):
            calls[which].append((url, md5))
            return served[url]
        return fetch

    monkeypatch.setattr(jdl, "_fetch", stub("jax"))
    monkeypatch.setattr(tdl, "_fetch", stub("port"))
    jdl.DATASETS[name](str(tmp_path / "jax"))
    tdl.DATASETS[name](str(tmp_path / "port"))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want and got
    assert calls["port"] == calls["jax"]


def test_main_runs_the_named_datasets(tmp_path, monkeypatch):
    served = _archives()
    monkeypatch.setattr(tdl, "_fetch", lambda url, md5=None: served[url])
    tdl.main(["--root", str(tmp_path), "uji", "cifar10"])
    assert sorted(os.listdir(tmp_path)) == ["cifar-10-batches-bin", "uji"]
    with pytest.raises(SystemExit):
        tdl.main(["--root", str(tmp_path), "imagenet"])


def test_uji_without_both_csvs_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(tdl, "_fetch", lambda url, md5=None: _zip(
        {"x/trainingData.csv": b"a\n"}))
    with pytest.raises(SystemExit, match="missing expected CSVs"):
        tdl.download_uji(str(tmp_path))


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_fetch_checks_md5_and_retries_transient(monkeypatch):
    body = b"payload"
    seen = []

    def urlopen(url, timeout):
        seen.append(timeout)
        if len(seen) == 1:
            raise ConnectionResetError("reset")
        return _Resp(body)

    monkeypatch.setattr(tdl.urllib.request, "urlopen", urlopen)
    md5 = hashlib.md5(body).hexdigest()
    assert tdl._fetch("http://stub.invalid/x", md5, timeout=30.0) == body
    assert len(seen) == 2 and all(0 < t <= 30.0 for t in seen)
    with pytest.raises(SystemExit, match="md5 mismatch"):
        tdl._fetch("http://stub.invalid/x", "0" * 32, timeout=30.0)


def test_fetch_gives_up_within_its_timeout(monkeypatch):
    seen = []

    def urlopen(url, timeout):
        seen.append(timeout)
        raise urllib.error.URLError("unreachable")

    monkeypatch.setattr(tdl.urllib.request, "urlopen", urlopen)
    with pytest.raises(SystemExit, match="download failed for"):
        tdl._fetch("http://stub.invalid/y", timeout=5.0)
    assert 1 <= len(seen) <= 4 and all(t <= 5.0 for t in seen)

    def forbidden(url, timeout):
        seen.append(timeout)
        raise urllib.error.HTTPError(url, 404, "gone", {}, None)

    seen.clear()
    monkeypatch.setattr(tdl.urllib.request, "urlopen", forbidden)
    with pytest.raises(SystemExit, match="download failed for"):
        tdl._fetch("http://stub.invalid/z", timeout=5.0)
    assert len(seen) == 1  # a permanent 4xx is not retried
