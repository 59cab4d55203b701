"""The port's serving and diagnostic drivers (``dcnn_tpu_torch.examples``)
on the CPU.

Each runs in a subprocess at a smoke size under ``DEVICE_TYPE=cpu`` with a
timeout of its own and must exit 0 with its own checks. On the committed
snapshot, the port's ``evaluate_snapshot`` gives unfolded, BN-folded and
int8 top-1 on the digits28 test split each within 1 of the 359 samples of
the JAX package's (``load_checkpoint``, ``evaluate_classification``,
``fold_batchnorm``, ``quantize_model`` on the JAX CPU backend), and losses
within 1e-4 relative. ``common.setup`` on one ``.env`` gives the JAX
driver's ``TrainingConfig`` fields, ``device_type`` aside.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

REPO = Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "model_snapshots" / "mnist_cnn_model"
SMOKE_TIMEOUT_S = 300


def run_driver(name, *args, tmp, timeout=SMOKE_TIMEOUT_S, **env):
    """``python -m dcnn_tpu_torch.examples.<name>`` on the CPU from the
    repo's root, its files under ``tmp``; its stdout, after checking it
    exited 0."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "DCNN_PRECISION")}
    # two threads a driver: the suite runs beside it on every core
    e.update(PYTHONPATH=str(REPO), DEVICE_TYPE="cpu", OMP_NUM_THREADS="2",
             SNAPSHOT_DIR=str(tmp / "snap"), TMPDIR=str(tmp), **env)
    proc = subprocess.run(
        [sys.executable, "-m", f"dcnn_tpu_torch.examples.{name}", *args],
        cwd=REPO, env=e, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    return proc.stdout


def test_evaluate_snapshot_with_export(tmp_path):
    out = run_driver("evaluate_snapshot", tmp=tmp_path, EXPORT="1",
                     EXPORT_DIR=str(tmp_path / "export"))
    for tag in ("unfolded: top-1", "BN-folded: top-1", "int8 PTQ:  top-1",
                "exported folded:", "exported int8:"):
        assert tag in out, tag
    assert sorted(os.listdir(tmp_path / "export")) == [
        "mnist_cnn_model_folded.pt2", "mnist_cnn_model_int8.pt2"]


def test_evaluate_snapshot_matches_jax(monkeypatch):
    from dcnn_tpu.data import MNISTDataLoader as JaxMNIST
    from dcnn_tpu.nn import fold_batchnorm as jax_fold
    from dcnn_tpu.nn import quantize_model as jax_quantize
    from dcnn_tpu.ops.losses import softmax_cross_entropy as jax_ce
    from dcnn_tpu.train import load_checkpoint as jax_load
    from dcnn_tpu.train.trainer import evaluate_classification as jax_eval
    from dcnn_tpu_torch.examples import evaluate_snapshot

    monkeypatch.setenv("DEVICE_TYPE", "cpu")
    monkeypatch.delenv("EXPORT", raising=False)
    got = evaluate_snapshot.main([])
    assert got["samples"] == 359 and got["device"] == "cpu"

    model, params, state, _, _, _ = jax_load(str(SNAPSHOT))
    csv = REPO / "data" / "digits28" / "test.csv"
    val = JaxMNIST(str(csv), data_format="NCHW", batch_size=256,
                   shuffle=False, drop_last=False)
    val.load_data()
    want = {"unfolded": jax_eval(model, params, state, jax_ce, val)}
    fm, fp, fs = jax_fold(model, params, state)
    want["folded"] = jax_eval(fm, fp, fs, jax_ce, val)
    qm, qp, qs = jax_quantize(model, params, state,
                              jnp.asarray(got["calib"]))
    want["int8"] = jax_eval(qm, qp, qs, jax_ce, val)
    for kind, (loss, acc) in want.items():
        assert abs(got[kind]["top1"] - float(acc)) * 359 <= 1 + 1e-9, kind
        assert abs(got[kind]["loss"] - float(loss)) <= 1e-4 * abs(
            float(loss)), kind
    # the JAX driver's gates hold in the port
    assert abs(got["folded"]["top1"] - got["unfolded"]["top1"]) <= 1e-3
    assert got["unfolded"]["top1"] - got["int8"]["top1"] <= 0.005


@pytest.mark.parametrize("int8", ["0", "1"])
def test_serve_snapshot(tmp_path, int8):
    out = run_driver("serve_snapshot", tmp=tmp_path, INT8=int8,
                     SERVE_LOADS="200", SERVE_SECONDS="0.3")
    graph = "int8 graph" if int8 == "1" else "folded float graph"
    assert graph in out
    row = out.strip().splitlines()[-1].split()
    assert row[0] == "200" and float(row[-1]) >= 0.98


def test_serve_router(tmp_path):
    out = run_driver("serve_router", "--seconds", "0.4", tmp=tmp_path)
    assert "OK: kill survived with zero silent drops" in out
    assert "silent_drops=0" in out


def test_serve_decode(tmp_path):
    out = run_driver("serve_decode", tmp=tmp_path, DECODE_SEQS="6",
                     DECODE_MAX_NEW="5")
    assert "6/6 sequences identical to batch-of-one decode" in out


def test_serve_autoscale(tmp_path):
    out = run_driver("serve_autoscale", "--seconds", "60", tmp=tmp_path)
    assert "availability=1.000000" in out
    assert "quiet tick: action=down" in out


def test_hardware_info(tmp_path):
    out = run_driver("hardware_info_example", tmp=tmp_path)
    assert "CPU:0 (cpu): compute check OK" in out


def test_backend_comparison(tmp_path):
    out = run_driver("backend_comparison", tmp=tmp_path, SIZE="128")
    rows = [ln for ln in out.splitlines() if ln.startswith(("matmul",
                                                              "conv"))]
    assert len(rows) == 2 and all("max rel err" in r for r in rows)


def test_dataset_visual_check(tmp_path):
    out = run_driver("dataset_visual_check", "digits28",
                     str(tmp_path / "ppm"), "3", tmp=tmp_path)
    files = sorted(os.listdir(tmp_path / "ppm"))
    assert len(files) == 3 and all(f.endswith(".ppm") for f in files)
    with open(tmp_path / "ppm" / files[0], "rb") as f:
        assert f.read(2) == b"P6"
    assert "wrote 3 PPM files" in out


def _jax_common():
    """``examples/common.py`` as a module, ``sys.path`` put back."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_examples_common", REPO / "examples" / "common.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path[:] = saved


def test_setup_reads_the_env_as_jax_does(tmp_path, monkeypatch):
    from dcnn_tpu_torch.examples import common

    env = tmp_path / "test.env"
    env.write_text("EPOCHS=3\nBATCH_SIZE=16\nLEARNING_RATE=0.005\n"
                   "LR_DECAY_FACTOR=0.9\nNUM_MICROBATCHES=2\nSEED=7\n"
                   "PROFILER_TYPE=cumulative\nSTEPS_PER_DISPATCH=2\n"
                   "DEVICE_TYPE=cpu\n")
    saved = dict(os.environ)
    try:
        for k in ("EPOCHS", "BATCH_SIZE", "LEARNING_RATE", "SEED",
                  "LR_DECAY_FACTOR", "NUM_MICROBATCHES", "PROFILER_TYPE",
                  "STEPS_PER_DISPATCH", "DEVICE_TYPE"):
            os.environ.pop(k, None)
        os.environ["ENV_FILE"] = str(env)
        mine = common.setup("port").to_dict()
        theirs = _jax_common().setup("jax").to_dict()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert mine.pop("device_type") == "cpu"
    theirs.pop("device_type")
    assert mine == theirs
    assert mine["epochs"] == 3 and mine["profiler"] == "cumulative"


def test_synthetic_fallback_swaps_data_not_device(capsys):
    from dcnn_tpu_torch.core.config import TrainingConfig
    from dcnn_tpu_torch.examples import common

    def absent():
        raise FileNotFoundError("no such dataset")

    cfg = TrainingConfig(device_type="cpu", batch_size=8)
    train, val = common.loader_or_synthetic(absent, (1, 8, 8), 3, cfg,
                                            n_train=32, n_val=16)
    assert (train.num_samples, val.num_samples) == (32, 16)
    assert common.SYNTHETIC_MARK in capsys.readouterr().out
    train, val = common.loader_or_synthetic(absent, (1, 8, 8), 3, cfg)
    assert (train.num_samples, val.num_samples) == (2048, 512)
    with pytest.raises(SystemExit, match="DEVICE_TYPE=tpu"):
        common.device_of("tpu")


def test_time_callable_counts_a_call():
    from dcnn_tpu_torch.examples.common import time_callable

    calls = []
    t = time_callable(lambda: calls.append(1), steps=4, reps=2, warmup=1)
    assert len(calls) == 1 + 4 * 2 and t >= 0.0
