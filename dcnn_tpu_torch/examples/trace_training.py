"""Observability driver (counterpart of ``examples/trace_training.py``):
train 2 epochs on digits28 with the tracer on, export a Chrome
``trace_event`` file, and check it parses.

The process-global tracer records ``train.epoch``, ``train.step`` and
``train.eval`` on the "train" track; the run writes them as one JSON file
that Perfetto or ``chrome://tracing`` loads, and prints the metrics
registry's snapshot. The artifact is checked as Chrome-trace JSON before
the run reports success.

Usage:
    python -m dcnn_tpu_torch.examples.trace_training [out.json]

Env: ``TRACE_EPOCHS`` (default 2), ``TRACE_OUT`` (default
``dcnn_trace_training.json`` under the temp dir; argv wins),
``DEVICE_TYPE``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from ..obs import configure, get_registry, get_tracer
from .common import ROOT, loader_or_synthetic, setup


def train_traced(epochs: int = 2, device_type: str = "cuda"):
    """Train ``epochs`` on digits28 (synthetic where absent) with tracing
    on; returns the Trainer."""
    from ..core.config import TrainingConfig
    from ..data import MNISTDataLoader
    from ..models import create_mnist_trainer
    from ..optim import Adam
    from ..train import Trainer, create_train_state

    # no best-val snapshot: under the default snapshot_dir it would land
    # on model_snapshots/mnist_cnn_model, the committed snapshot
    cfg = TrainingConfig(epochs=epochs, batch_size=64, progress_interval=0,
                         device_type=device_type, snapshot_dir=None)

    def real():
        from ..data.digits28 import ensure_digits28_csvs

        d = ensure_digits28_csvs(ROOT)
        train = MNISTDataLoader(os.path.join(d, "train.csv"),
                                data_format="NCHW", batch_size=64, seed=0)
        val = MNISTDataLoader(os.path.join(d, "test.csv"),
                              data_format="NCHW", batch_size=256,
                              shuffle=False, drop_last=False)
        train.load_data()
        val.load_data()
        return train, val

    train, val = loader_or_synthetic(real, (1, 28, 28), 10, cfg,
                                     n_train=512, n_val=128)
    model = create_mnist_trainer()
    trainer = Trainer(model, Adam(1e-3), "softmax_crossentropy", cfg)
    ts = create_train_state(model, trainer.optimizer,
                            torch.Generator().manual_seed(0),
                            device=trainer.device)
    trainer.fit(ts, train, val, epochs=epochs)
    return trainer


def validate_chrome_trace(path: str) -> dict:
    """Load the artifact and check the trace_event invariants the viewers
    rely on; returns {span name: count}. Raises ``ValueError`` on a
    violation."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError("empty traceEvents")
    counts: dict = {}
    for ev in evs:
        if not {"ph", "pid", "tid", "name"} <= set(ev):
            raise ValueError(f"bad event {ev}")
        if ev["ph"] == "X":
            if "ts" not in ev or ev.get("dur", -1) < 0:
                raise ValueError(f"bad complete event {ev}")
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    named_tracks = {ev["args"]["name"] for ev in evs
                    if ev["ph"] == "M" and ev["name"] == "thread_name"}
    if "train" not in named_tracks:
        raise ValueError(f"no labeled train track: {named_tracks}")
    return counts


def main() -> dict:
    cfg = setup("trace_training")
    out_path = (sys.argv[1] if len(sys.argv) > 1
                else os.environ.get("TRACE_OUT", os.path.join(
                    tempfile.gettempdir(), "dcnn_trace_training.json")))
    epochs = int(os.environ.get("TRACE_EPOCHS", "2"))

    configure(enabled=True)
    try:
        trainer = train_traced(epochs, cfg.device_type)
    finally:
        configure(enabled=False)

    tracer = get_tracer()
    tracer.export_chrome(out_path)
    counts = validate_chrome_trace(out_path)
    if counts.get("train.epoch", 0) != epochs or \
            counts.get("train.step", 0) < epochs:
        raise SystemExit(f"trace spans {counts} for {epochs} epochs")

    print(f"trace: {out_path} ({len(tracer)} events) — "
          f"open at https://ui.perfetto.dev")
    print(f"spans: {counts}")
    print("metrics snapshot:")
    print(json.dumps(get_registry().snapshot(), indent=2, default=str))
    print(f"final val acc: {trainer.history[-1]['val_acc']}")
    return {"spans": counts, "val_acc": trainer.history[-1]["val_acc"]}


if __name__ == "__main__":
    main()
