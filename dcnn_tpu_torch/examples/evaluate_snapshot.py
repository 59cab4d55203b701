"""Eval-only inference driver (counterpart of
``examples/evaluate_snapshot.py``): load a saved snapshot and evaluate it
standalone.

Loads a best-val checkpoint (either package's format), folds BatchNorm into
the preceding layers (``nn.fold_batchnorm``, the graph a deployment
ships), quantizes it to int8 (``nn.quantize_model``, calibrated on the
train split, never the measured one), and evaluates top-1 of all three on
the digits28 test split, with throughput on the device. Gates: the fold
moves accuracy by at most 1e-3, int8 drops it by at most 0.5 pt.

Usage:
    python -m dcnn_tpu_torch.examples.evaluate_snapshot [snapshot_dir] [test_csv]

``EXPORT=1`` also writes the folded and int8 graphs as ``torch.export``
artifacts (``nn.export_inference``; ``EXPORT_DIR``, default
``dcnn_export`` under the temp dir) and checks each reloaded artifact's
predictions against the live model's on a real batch.

Defaults: ``model_snapshots/mnist_cnn_model`` (committed: a digits28
best-val checkpoint) and ``data/digits28/test.csv`` (generated where
absent from the bundled digits).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..data import MNISTDataLoader, decode_host
from ..data.digits28 import ensure_digits28_csvs
from ..nn import fold_batchnorm, quantize_model
from ..ops.losses import softmax_cross_entropy
from ..resilience.atomic import write_file_atomic
from ..train import (evaluate_classification, load_checkpoint,
                     make_eval_step)
from .common import ROOT, device_of, setup

FOLD_TOL = 1e-3
INT8_DROP = 0.005


def _data_format(model) -> str:
    # the per-sample input shape leads with channels in NCHW ((1, 28, 28))
    # and ends with them in NHWC ((28, 28, 1))
    return ("NCHW" if model.input_shape[0] <= model.input_shape[-1]
            else "NHWC")


def _eval_ips(model, val, step) -> float:
    """Images a second over the split through the eval step ``step``, the
    second full pass timed (the first warms the graphs up)."""
    for _ in range(2):
        t0 = time.perf_counter()
        evaluate_classification(model, softmax_cross_entropy, val,
                                eval_step=step)
        dt = time.perf_counter() - t0
    return val.num_samples / dt


def calibration_batch(csv: str, fmt: str, val) -> np.ndarray:
    """The first two 256-row batches of the split beside ``csv``'s, decoded
    to the model's input domain; the eval split itself where no train
    split is there (and that is said, since the int8 gate is then biased)."""
    train_csv = os.path.join(os.path.dirname(os.path.abspath(csv)),
                             "train.csv")
    if os.path.exists(train_csv):
        cal = MNISTDataLoader(train_csv, data_format=fmt, batch_size=256,
                              shuffle=False, drop_last=False)
        cal.load_data()
    else:
        print(f"calibration: no {train_csv}; falling back to the eval split "
              "(accuracy gate is then calibration-biased)")
        cal = val
    batches = []
    for xb, _ in cal:
        batches.append(decode_host(np.asarray(xb), cal.scale))
        if len(batches) >= 2:
            break
    return np.concatenate(batches)


def main(argv=None) -> dict:
    cfg = setup("evaluate_snapshot")
    dev = device_of(cfg.device_type)
    args = sys.argv[1:] if argv is None else list(argv)
    snap = args[0] if args else os.path.join(ROOT, "model_snapshots",
                                             "mnist_cnn_model")
    csv = (args[1] if len(args) > 1
           else os.path.join(ensure_digits28_csvs(ROOT), "test.csv"))

    model, _, _, meta = load_checkpoint(snap, device=dev)
    model.eval()
    print(f"loaded {snap}: model {model.name}, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"metadata {meta}")
    fmt = _data_format(model)
    val = MNISTDataLoader(csv, data_format=fmt, batch_size=256,
                          shuffle=False, drop_last=False)
    val.load_data()
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    loss, acc = evaluate_classification(model, softmax_cross_entropy, val)
    print(f"unfolded: top-1 {acc:.4f} loss {loss:.4f} "
          f"({val.num_samples} samples)")

    fmodel = fold_batchnorm(model)
    # one eval step a model: its graphs, captured in the accuracy pass, are
    # the ones the throughput passes replay
    fstep = make_eval_step(fmodel, softmax_cross_entropy)
    floss, facc = evaluate_classification(fmodel, softmax_cross_entropy, val,
                                          eval_step=fstep)
    print(f"BN-folded: top-1 {facc:.4f} loss {floss:.4f} "
          f"({len(fmodel.layers)} layers, was {len(model.layers)})")
    if abs(facc - acc) > FOLD_TOL:
        raise SystemExit(f"fold changed accuracy: {acc} -> {facc}")
    ips = _eval_ips(fmodel, val, fstep)
    print(f"inference throughput (BN-folded): {ips:,.0f} img/s on {kind}")

    calib = calibration_batch(csv, fmt, val)
    qmodel = quantize_model(model, calib)
    qstep = make_eval_step(qmodel, softmax_cross_entropy)
    qloss, qacc = evaluate_classification(qmodel, softmax_cross_entropy, val,
                                          eval_step=qstep)
    qips = _eval_ips(qmodel, val, qstep)
    print(f"int8 PTQ:  top-1 {qacc:.4f} loss {qloss:.4f} ({qips:,.0f} img/s)")
    if acc - qacc > INT8_DROP:
        raise SystemExit(f"int8 quantization dropped accuracy: {acc} -> "
                         f"{qacc}")

    if os.environ.get("EXPORT", "0") == "1":
        from ..nn import export_inference, load_inference

        out_dir = os.environ.get("EXPORT_DIR", os.path.join(
            tempfile.gettempdir(), "dcnn_export"))
        os.makedirs(out_dir, exist_ok=True)
        xb = torch.from_numpy(calib[:64]).to(dev)
        for tag, m in (("folded", fmodel), ("int8", qmodel)):
            blob = export_inference(m, device=dev)
            path = os.path.join(out_dir, f"{model.name}_{tag}.pt2")
            write_file_atomic(path, blob)
            with torch.inference_mode():
                live = m(xb)
            art = load_inference(blob)(xb)
            if not torch.equal(art.argmax(-1), live.argmax(-1)):
                raise SystemExit(f"{tag} artifact diverged from live model")
            print(f"exported {tag}: {path} ({len(blob):,} bytes, "
                  "artifact == live on a real batch)")
    return {"samples": val.num_samples, "device": kind,
            "unfolded": {"top1": acc, "loss": loss},
            "folded": {"top1": facc, "loss": floss, "img_per_s": ips},
            "int8": {"top1": qacc, "loss": qloss, "img_per_s": qips},
            "models": {"unfolded": model, "folded": fmodel, "int8": qmodel},
            "calib": calib}


if __name__ == "__main__":
    main()
