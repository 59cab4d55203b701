"""Preemption-recovery driver (counterpart of ``examples/resume_training.py``):
kill a training run mid-epoch, restart it with ``resume="auto"``, and check
that the resumed run matches an uninterrupted one exactly.

A ``Trainer`` with ``checkpoint_dir`` and ``checkpoint_every=1`` commits an
atomic checkpoint each epoch; a seeded :class:`~dcnn_tpu_torch.resilience.
FaultPlan` raises :class:`~dcnn_tpu_torch.resilience.InjectedCrash` partway
through epoch 2 (nothing after the kill point runs, as in a preemption);
the restart restores the newest valid checkpoint and continues. The
resumed run's per-epoch losses and accuracies must equal the reference
run's and its final parameters must be bit for bit the same.

Usage:
    python -m dcnn_tpu_torch.examples.resume_training

Env: ``RESUME_EPOCHS`` (default 2), ``CKPT_DIR`` (default a temp dir; set
it to keep the checkpoints), ``DEVICE_TYPE``.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

from .common import ROOT, setup


def _loaders(batch_size=128):
    from ..data import MNISTDataLoader
    from ..data.digits28 import ensure_digits28_csvs

    d = ensure_digits28_csvs(ROOT)
    train = MNISTDataLoader(os.path.join(d, "train.csv"),
                            data_format="NCHW", batch_size=batch_size,
                            seed=0)
    val = MNISTDataLoader(os.path.join(d, "test.csv"), data_format="NCHW",
                          batch_size=256, shuffle=False, drop_last=False)
    train.load_data()
    val.load_data()
    return train, val


def run_training(ckpt_dir: str, epochs: int, resume: str = "never",
                 device_type: str = "cuda"):
    """One training run against ``ckpt_dir``; returns the Trainer (its
    ``history`` is the per-epoch record) and the final TrainState."""
    from ..core.config import TrainingConfig
    from ..nn import SequentialBuilder
    from ..optim import Adam
    from ..train import Trainer, create_train_state

    cfg = TrainingConfig(epochs=epochs, batch_size=128, learning_rate=1e-3,
                         seed=17, snapshot_dir=None, progress_interval=0,
                         checkpoint_dir=ckpt_dir, checkpoint_every=1,
                         resume=resume, device_type=device_type)
    model = (SequentialBuilder("resume_demo")
             .input((1, 28, 28))
             .conv2d(8, 3, 1, 1).batchnorm().activation("relu")
             .maxpool2d(2).flatten().dense(10)
             .build())
    opt = Adam(cfg.learning_rate)
    trainer = Trainer(model, opt, "softmax_crossentropy", config=cfg)
    ts = create_train_state(model, opt,
                            torch.Generator().manual_seed(cfg.seed),
                            device=trainer.device)
    train, val = _loaders(cfg.batch_size)
    ts = trainer.fit(ts, train, val, epochs=epochs)
    return trainer, ts


def demo_kill_and_resume(root_dir: str, epochs: int = 2,
                         device_type: str = "cuda"):
    """The whole drill; returns (reference history, resumed history,
    params equal)."""
    ref_dir = os.path.join(root_dir, "ref")
    crash_dir = os.path.join(root_dir, "crash")
    # the contract is bit for bit: on the card cuDNN's default conv
    # backward sums in an order that varies run to run, so the three runs
    # take its deterministic algorithms
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        return _drill(ref_dir, crash_dir, epochs, device_type)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _drill(ref_dir, crash_dir, epochs, device_type):
    from ..resilience import FaultPlan, InjectedCrash

    print(f"=== reference run ({epochs} epochs, never killed) ===")
    ref_trainer, ref_ts = run_training(ref_dir, epochs,
                                       device_type=device_type)

    # 1438 train samples / batch 128 = 11 steps an epoch; invocation 14 is
    # epoch 2, step 3: epoch 1's checkpoint is committed, epoch 2 dies
    print("=== victim run: killed mid-epoch 2 (fault plan) ===")
    plan = FaultPlan().arm("train.nonfinite_input", at=14,
                           exc=InjectedCrash)
    try:
        with plan:
            run_training(crash_dir, epochs, device_type=device_type)
        raise AssertionError("fault plan never fired")
    except InjectedCrash as e:
        print(f"    killed as planned: {e}")

    print('=== restart with resume="auto" ===')
    res_trainer, res_ts = run_training(crash_dir, epochs, resume="auto",
                                       device_type=device_type)

    ref_h, res_h = ref_trainer.history, res_trainer.history
    if not len(ref_h) == len(res_h) == epochs:
        raise AssertionError(f"histories of {len(ref_h)} and {len(res_h)} "
                             f"epochs, not {epochs}")
    for hr, hc in zip(ref_h, res_h):
        if (hr["train_loss"], hr["val_acc"]) != (hc["train_loss"],
                                                 hc["val_acc"]):
            raise AssertionError(f"resumed epoch differs: {hr} != {hc}")
    ref_p = dict(ref_ts.model.named_parameters())
    params_equal = all(torch.equal(p, ref_p[n])
                       for n, p in res_ts.model.named_parameters())
    if not params_equal:
        raise AssertionError("resumed params differ from the reference's")
    return ref_h, res_h, params_equal


def main() -> int:
    cfg = setup("resume_training (preemption-recovery smoke)")
    epochs = int(os.environ.get("RESUME_EPOCHS", "2"))
    keep_dir = os.environ.get("CKPT_DIR")
    if keep_dir:
        ref_h, res_h, _ = demo_kill_and_resume(keep_dir, epochs,
                                               cfg.device_type)
        print(f"checkpoints kept under {keep_dir}")
    else:
        with tempfile.TemporaryDirectory() as d:
            ref_h, res_h, _ = demo_kill_and_resume(d, epochs,
                                                   cfg.device_type)
    print("resumed run == uninterrupted run, per epoch:")
    for hr in res_h:
        print(f"  epoch {hr['epoch']}: loss {hr['train_loss']:.6f} "
              f"val acc {hr['val_acc']:.4f}")
    print("OK: bit-exact resume after mid-epoch kill")
    return 0


if __name__ == "__main__":
    sys.exit(main())
