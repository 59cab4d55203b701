"""End-to-end accuracy gates on real data (counterpart of
``examples/accuracy_gates.py``).

Gates:
  digits   — the 8x8 handwritten digits (scikit-learn's copy of UCI
             optdigits), a small CNN trained through the device-resident
             path with device augmentation, target >= 0.95. Recorded as
             skipped where scikit-learn is absent.
  digits28 — the same images upsampled to 28x28, written as MNIST CSVs
             from the bundled array, trained on the MNIST CNN through
             MNISTDataLoader with augmentation, target >= 0.99.
  mnist    — MNIST CSVs (data/mnist/train.csv, test.csv), MNIST CNN,
             target >= 0.99; tries ``data/download.py`` only when absent.
  cifar10  — CIFAR-10 binary batches, ResNet-9, target 0.85; tries the
             download only when absent.
  tiny_imagenet — ResNet-18 at 64x64, target 0.40; tries the download
             only when absent.

Each gate (``GATES[name](cfg)``, ``cfg`` the run's TrainingConfig: its
device and seed) trains through ``Trainer.fit`` (the best-val snapshot is the
model evaluated) and writes a record (dataset, model, epochs, wall clock,
seconds to the target, accuracy, device, precision mode, pass/fail) to
``RESULTS.json`` and a table to ``RESULTS.md`` under ``RESULTS_DIR``
(default ``dcnn_tpu_torch/_results/``). A gate whose dataset is absent and
cannot be fetched is recorded as skipped, with the command that fetches
it; a skip never replaces a real result.

Usage: python -m dcnn_tpu_torch.examples.accuracy_gates [digits digits28 mnist cifar10 tiny_imagenet]
Env: EPOCHS_DIGITS / EPOCHS_DIGITS28 / EPOCHS_MNIST / EPOCHS_CIFAR10 /
EPOCHS_TINY override epoch counts; DCNN_PRECISION selects the precision
mode (default parity); DEVICE_TYPE the device (default cuda).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..core.config import TrainingConfig
from ..core.precision import get_precision_mode, set_precision
from ..data.digits28 import ensure_digits28_csvs as _ensure_digits28
from ..nn.builder import SequentialBuilder
from ..ops.losses import softmax_cross_entropy
from ..optim import Adam
from ..resilience.atomic import write_file_atomic
from ..train import (Trainer, create_train_state, evaluate_classification,
                     load_checkpoint)
from ..utils.env import get_env
from .common import ROOT, setup

RESULTS_DIR = os.path.join(ROOT, "dcnn_tpu_torch", "_results")
# a gate's in-gate download: the TCP probe, then the whole fetch
PROBE_TIMEOUT_S = 5.0
DOWNLOAD_TIMEOUT_S = 900.0


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _train_and_eval(run_cfg, name, model, train_loader, val_loader, *,
                    epochs, lr, target, scheduler=None, weight_decay=0.0,
                    keep_snapshot_dir=None):
    t0 = time.perf_counter()
    opt = (Adam(lr, weight_decay=weight_decay, decouple_weight_decay=True)
           if weight_decay else Adam(lr))
    # snapshot_dir on: fit keeps the best-val checkpoint, the model the
    # gate evaluates; keep_snapshot_dir keeps it past the gate
    snap = keep_snapshot_dir or tempfile.mkdtemp(prefix=f"gate_{name}_")
    try:
        cfg = TrainingConfig(learning_rate=lr, snapshot_dir=snap,
                             device_type=run_cfg.device_type,
                             seed=run_cfg.seed)
        trainer = Trainer(model, opt, "softmax_crossentropy", config=cfg,
                          scheduler=scheduler)
        ts = create_train_state(
            model, opt, torch.Generator().manual_seed(cfg.seed),
            device=trainer.device)
        ts = trainer.fit(ts, train_loader, val_loader, epochs=epochs)
        wall = time.perf_counter() - t0
        best = ts.model
        try:
            best, _, _, _ = load_checkpoint(os.path.join(snap, model.name),
                                            device=trainer.device)
        except FileNotFoundError:
            pass  # no snapshot written (no val split): the final model
    finally:
        # the temp dir holds a whole checkpoint: it goes even if fit raises
        if keep_snapshot_dir is None:
            shutil.rmtree(snap, ignore_errors=True)
    val_loss, val_acc = evaluate_classification(best, softmax_cross_entropy,
                                                val_loader)
    history = [{k: (round(float(v), 5) if isinstance(v, (int, float)) else v)
                for k, v in h.items()} for h in trainer.history]
    # the training seconds until an epoch's val accuracy first met the
    # target (None: never)
    to_target, spent = None, 0.0
    for h in trainer.history:
        spent += h["seconds"]
        if h["val_acc"] is not None and h["val_acc"] >= target:
            to_target = round(spent, 3)
            break
    return {
        "gate": name,
        "model": model.name,
        "epochs": epochs,
        "batch_size": train_loader.batch_size,
        "train_samples": train_loader.num_samples,
        "val_samples": val_loader.num_samples,
        "val_acc": round(float(val_acc), 4),
        "val_loss": round(float(val_loss), 4),
        "target": target,
        "passed": bool(val_acc >= target),
        "wall_clock_s": round(wall, 1),
        "seconds_to_target": to_target,
        "device": _device_name(trainer.device),
        "precision": get_precision_mode(),
        "history": history,
    }


def _try_download(names):
    """A dataset fetch at gate time, where it is absent: a TCP probe of the
    dataset's host first (a host that drops packets fails in
    ``PROBE_TIMEOUT_S``, not in the downloader's timeouts), then
    ``python -m dcnn_tpu_torch.data.download`` in a subprocess bounded by
    ``DOWNLOAD_TIMEOUT_S``. True when it exited 0."""
    import socket
    import subprocess
    from urllib.parse import urlparse

    from ..data import download as dl

    hosts = {"mnist": dl.MNIST_BASE, "cifar10": dl.CIFAR10_URL,
             "cifar100": dl.CIFAR100_URL,
             "tiny_imagenet": dl.TINY_IMAGENET_URL, "uji": dl.UJI_URL}
    for name in names:
        url = urlparse(hosts.get(name, dl.MNIST_BASE))
        try:
            socket.create_connection(
                (url.hostname, url.port or (443 if url.scheme == "https"
                                            else 80)),
                timeout=PROBE_TIMEOUT_S).close()
        except OSError:
            return False
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dcnn_tpu_torch.data.download",
             "--root", os.path.join(ROOT, "data"), *names],
            capture_output=True, text=True, timeout=DOWNLOAD_TIMEOUT_S,
            cwd=ROOT)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def _skipped(gate, what):
    return {"gate": gate, "skipped":
            f"dataset absent ({what}) and in-gate download failed (no "
            f"egress); fetch with: python -m dcnn_tpu_torch.data.download "
            f"--root data {gate}"}


def gate_digits(cfg):
    """The 8x8 digits through the device-resident path (``DeviceDataset``
    with device augmentation)."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        return {"gate": "digits", "skipped": f"scikit-learn absent ({e})"}
    from ..data import DeviceAugmentBuilder, DeviceDataset

    X, y = load_digits(return_X_y=True)
    X8 = np.clip(X * (255.0 / 16.0), 0, 255).astype(np.uint8).reshape(
        -1, 8, 8, 1)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(X8))
    n_test = len(X8) // 5
    test_idx, train_idx = idx[:n_test], idx[n_test:]

    aug = (DeviceAugmentBuilder("NHWC")
           .random_crop(1).rotation(10, p=0.3).build())
    train = DeviceDataset(X8[train_idx], y[train_idx], 10, batch_size=64,
                          augment=aug, device=cfg.device_type)
    val = DeviceDataset(X8[test_idx], y[test_idx], 10, batch_size=256,
                        device=cfg.device_type)

    model = (SequentialBuilder(name="digits_cnn", data_format="NHWC")
             .input((8, 8, 1))
             .conv2d(16, 3, padding=1).batchnorm().activation("relu")
             .conv2d(32, 3, padding=1).batchnorm().activation("relu")
             .maxpool2d(2)
             .flatten().dense(64).activation("relu").dense(10)
             .build())
    epochs = int(get_env("EPOCHS_DIGITS", "20"))
    return _train_and_eval(cfg, "digits", model, train, val,
                           epochs=epochs, lr=1e-3, target=0.95)


def ensure_digits28_csvs() -> str:
    """The digits28 CSVs under the repo's ``data/``, generated where
    absent; returns their directory."""
    return _ensure_digits28(ROOT)


def gate_digits28(cfg):
    """The 28x28 real-image path: the digits upsampled to MNIST's geometry,
    read by MNISTDataLoader, trained on the MNIST CNN with augmentation,
    a cosine schedule and the best-val snapshot."""
    from ..data import AugmentationBuilder, MNISTDataLoader
    from ..models import create_mnist_trainer
    from ..optim import CosineAnnealingLR

    d = ensure_digits28_csvs()
    aug = (AugmentationBuilder(data_format="NCHW")
           .random_crop(2).rotation(10, p=0.5).build())
    train = MNISTDataLoader(os.path.join(d, "train.csv"), data_format="NCHW",
                            batch_size=64, seed=0, augmentation=aug)
    val = MNISTDataLoader(os.path.join(d, "test.csv"), data_format="NCHW",
                          batch_size=256, shuffle=False, drop_last=False)
    train.load_data()
    val.load_data()
    model = create_mnist_trainer()
    epochs = int(get_env("EPOCHS_DIGITS28", "40"))
    # the Trainer steps an epoch-cadence scheduler after each epoch, so a
    # warm-up variant's ramp would never run: plain cosine
    sched = CosineAnnealingLR(base_lr=1e-3, T_max=epochs, eta_min=1e-5)
    return _train_and_eval(cfg, "digits28", model, train, val,
                           epochs=epochs, lr=1e-3, target=0.99,
                           scheduler=sched, weight_decay=1e-4,
                           keep_snapshot_dir=os.environ.get(
                               "DIGITS28_SNAPSHOT_DIR"))


def gate_mnist(cfg):
    from ..data import MNISTDataLoader
    from ..models import create_mnist_trainer

    train_csv = get_env("MNIST_TRAIN_CSV",
                        os.path.join(ROOT, "data/mnist/train.csv"))
    test_csv = get_env("MNIST_TEST_CSV",
                       os.path.join(ROOT, "data/mnist/test.csv"))
    if not (os.path.isfile(train_csv) and os.path.isfile(test_csv)):
        _try_download(["mnist"])
    if not (os.path.isfile(train_csv) and os.path.isfile(test_csv)):
        return _skipped("mnist", train_csv)
    train = MNISTDataLoader(train_csv, data_format="NCHW", batch_size=128,
                            seed=0)
    val = MNISTDataLoader(test_csv, data_format="NCHW", batch_size=512,
                          shuffle=False, drop_last=False)
    train.load_data()
    val.load_data()
    model = create_mnist_trainer()
    epochs = int(get_env("EPOCHS_MNIST", "12"))
    return _train_and_eval(cfg, "mnist", model, train, val,
                           epochs=epochs, lr=1e-3, target=0.99)


def gate_cifar10(cfg):
    from ..data import CIFAR10DataLoader
    from ..models import create_resnet9_cifar10

    d = get_env("CIFAR10_DIR", os.path.join(ROOT, "data/cifar-10-batches-bin"))
    train_files = [os.path.join(d, f"data_batch_{i}.bin") for i in range(1, 6)]
    test_file = os.path.join(d, "test_batch.bin")
    if not all(map(os.path.isfile, train_files + [test_file])):
        _try_download(["cifar10"])
    if not all(map(os.path.isfile, train_files + [test_file])):
        return _skipped("cifar10", d)
    train = CIFAR10DataLoader(train_files, data_format="NCHW",
                              batch_size=256, seed=0)
    val = CIFAR10DataLoader(test_file, data_format="NCHW", batch_size=512,
                            shuffle=False, drop_last=False)
    train.load_data()
    val.load_data()
    model = create_resnet9_cifar10("NCHW")
    epochs = int(get_env("EPOCHS_CIFAR10", "20"))
    # top-1 recorded; 0.85 is the pass bar of a 20-epoch plain-Adam run
    return _train_and_eval(cfg, "cifar10", model, train, val,
                           epochs=epochs, lr=1e-3, target=0.85)


def gate_tiny_imagenet(cfg):
    from ..data import TinyImageNetDataLoader
    from ..models import create_resnet18_tiny_imagenet

    d = get_env("TINY_IMAGENET_DIR",
                os.path.join(ROOT, "data/tiny-imagenet-200"))
    if not os.path.isdir(d):
        _try_download(["tiny_imagenet"])
    if not os.path.isdir(d):
        return _skipped("tiny_imagenet", d)
    train = TinyImageNetDataLoader(d, split="train", data_format="NCHW",
                                   batch_size=256, seed=0)
    val = TinyImageNetDataLoader(d, split="val", data_format="NCHW",
                                 batch_size=512, shuffle=False,
                                 drop_last=False)
    train.load_data()
    val.load_data()
    model = create_resnet18_tiny_imagenet("NCHW")
    epochs = int(get_env("EPOCHS_TINY", "30"))
    return _train_and_eval(cfg, "tiny_imagenet", model, train, val,
                           epochs=epochs, lr=1e-3, target=0.40)


GATES = {"digits": gate_digits, "digits28": gate_digits28,
         "mnist": gate_mnist, "cifar10": gate_cifar10,
         "tiny_imagenet": gate_tiny_imagenet}


def write_results(results, out_dir):
    """Merge ``results`` into ``out_dir``'s RESULTS.json (a skip never
    replaces a real result) and rewrite RESULTS.md's table from it."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "RESULTS.json")
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    by_gate = {r["gate"]: r for r in existing}
    for r in results:
        if "skipped" not in r or r["gate"] not in by_gate:
            by_gate[r["gate"]] = r
    merged = list(by_gate.values())
    write_file_atomic(path, json.dumps(merged, indent=1).encode("utf-8"))
    md = ["# Accuracy gates (real data)", "",
          "Produced by `python -m dcnn_tpu_torch.examples.accuracy_gates`.",
          "",
          "| gate | model | epochs | val acc | target | passed | wall (s) "
          "| to target (s) | device | precision |",
          "|---|---|---|---|---|---|---|---|---|---|"]
    for r in merged:
        if "skipped" in r:
            md.append(f"| {r['gate']} | — | — | — | — | SKIPPED: "
                      f"{r['skipped']} | — | — | — | — |")
        else:
            md.append(
                f"| {r['gate']} | {r['model']} | {r['epochs']} "
                f"| {r['val_acc']} | {r['target']} "
                f"| {'yes' if r['passed'] else 'NO'} | {r['wall_clock_s']} "
                f"| {r['seconds_to_target']} | {r['device']} "
                f"| {r['precision']} |")
    write_file_atomic(os.path.join(out_dir, "RESULTS.md"),
                      ("\n".join(md) + "\n").encode("utf-8"))
    return merged


def main(argv=None):
    cfg = setup("accuracy_gates")
    # .env values land in os.environ after core.precision read its
    # import-time default, so the mode is applied here
    set_precision(os.environ.get("DCNN_PRECISION") or "parity")
    names = (sys.argv[1:] if argv is None else list(argv)) or list(GATES)
    unknown = [n for n in names if n not in GATES]
    if unknown:
        raise SystemExit(f"unknown gate(s) {unknown}; known: {sorted(GATES)}")
    results = []
    for name in names:
        print(f"--- gate: {name} ---", flush=True)
        res = GATES[name](cfg)
        print(json.dumps(res), flush=True)
        results.append(res)
    out_dir = os.environ.get("RESULTS_DIR", RESULTS_DIR)
    merged = write_results(results, out_dir)
    print(f"wrote {out_dir}/RESULTS.md and RESULTS.json ({len(merged)} gates)")
    return results


if __name__ == "__main__":
    main()
