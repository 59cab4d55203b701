"""The port's training drivers (``dcnn_tpu_torch.examples``) on the CPU.

Each trainer runs in a subprocess at a smoke size (one epoch, a few steps)
under ``DEVICE_TYPE=cpu``, with a timeout of its own, and must exit 0
with its own checks. ``accuracy_gates`` runs its two offline gates for an
epoch and records the download gates as skipped with the download
stubbed (nothing is fetched). The long-context model, given the JAX
model's weights through ``interop.from_jax``, is held to the JAX model
with its flash attention in Pallas interpret mode at S=128, E=32, H=2;
the digits28 CSVs built from the bundled array are byte-equal to the JAX
package's (built through scikit-learn).
"""

import filecmp
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcnn_tpu.nn.attention_layer as jax_attention_layer
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.ops.losses import softmax_cross_entropy as jax_ce
from dcnn_tpu_torch.core.config import TrainingConfig
from dcnn_tpu_torch.examples import accuracy_gates, long_context_trainer
from dcnn_tpu_torch.interop import from_jax
from dcnn_tpu_torch.ops.losses import softmax_cross_entropy

REPO = Path(__file__).resolve().parent.parent
# the module (``dcnn_tpu.ops`` exports a function of the same name)
jax_attn = importlib.import_module("dcnn_tpu.ops.attention")
SMOKE_TIMEOUT_S = 300


def run_driver(name, *args, tmp, timeout=SMOKE_TIMEOUT_S, **env):
    """``python -m dcnn_tpu_torch.examples.<name>`` on the CPU from the
    repo's root, snapshots and results under ``tmp``; its stdout, after
    checking it exited 0."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "DCNN_PRECISION")}
    # two threads a driver: the suite runs beside it on every core
    e.update(PYTHONPATH=str(REPO), DEVICE_TYPE="cpu", OMP_NUM_THREADS="2",
             SNAPSHOT_DIR=str(tmp / "snap"), RESULTS_DIR=str(tmp / "res"),
             TMPDIR=str(tmp), **env)
    proc = subprocess.run(
        [sys.executable, "-m", f"dcnn_tpu_torch.examples.{name}", *args],
        cwd=REPO, env=e, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    return proc.stdout


def _cifar_records(path, rng, n, label_bytes, classes):
    """``n`` records of ``label_bytes`` labels and 3072 pixels."""
    labels = rng.integers(0, classes, size=(n, label_bytes), dtype=np.uint8)
    pix = rng.integers(0, 256, size=(n, 3072), dtype=np.uint8)
    np.concatenate([labels, pix], axis=1).tofile(path)


def write_cifar10(root, rng):
    """The five train batches and the test batch, 64 and 32 records."""
    root.mkdir()
    for i in range(1, 6):
        _cifar_records(root / f"data_batch_{i}.bin", rng, 64, 1, 10)
    _cifar_records(root / "test_batch.bin", rng, 32, 1, 10)
    return {"CIFAR10_DIR": str(root)}


def write_cifar100(root, rng):
    """``train.bin`` and ``test.bin``, coarse and fine labels."""
    root.mkdir()
    _cifar_records(root / "train.bin", rng, 256, 2, 20)
    _cifar_records(root / "test.bin", rng, 32, 2, 20)
    return {"CIFAR100_DIR": str(root)}


def write_tiny_imagenet(root, rng):
    """A two-class Tiny-ImageNet tree: 64 train PNGs a class, 16 val."""
    from PIL import Image

    wnids = ["n01", "n02"]
    (root / "val" / "images").mkdir(parents=True)
    (root / "wnids.txt").write_text("\n".join(wnids) + "\n")
    for wnid in wnids:
        d = root / "train" / wnid / "images"
        d.mkdir(parents=True)
        for i in range(64):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
                d / f"{wnid}_{i}.png")
    lines = []
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
            root / "val" / "images" / f"val_{i}.png")
        lines.append(f"val_{i}.png\t{wnids[i % 2]}\t0\t0\t63\t63")
    (root / "val" / "val_annotations.txt").write_text("\n".join(lines) + "\n")
    return {"TINY_IMAGENET_DIR": str(root)}


# driver -> (its env, a writer of a small dataset in its format, or None:
# no dataset is in the checkout, and the driver falls back to synthetic
# data at its own size)
TRAINERS = {
    "mnist_cnn_trainer": ({}, None),
    "cifar10_cnn_trainer": ({}, write_cifar10),
    "cifar10_resnet9": ({}, write_cifar10),
    "cifar100_cnn_trainer": ({}, write_cifar100),
    "tiny_imagenet_trainer": ({"MODEL": "resnet18"}, write_tiny_imagenet),
    "uji_ips_trainer": ({}, None),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_smoke_run(tmp_path, name):
    env, write = TRAINERS[name]
    if write is not None:
        env = {**env, **write(tmp_path / "data", np.random.default_rng(7))}
    out = run_driver(name, tmp=tmp_path, EPOCHS="1", **env)
    assert "epoch 1/1" in out
    # a written dataset is read; with none the driver's own fallback runs
    assert ("using synthetic" in out) == (write is None)


def test_long_context_smoke_run(tmp_path):
    out = run_driver("long_context_trainer", tmp=tmp_path, SEQ_LEN="128",
                     EMBED="32", BATCH="8", STEPS_PER_EPOCH="3", EPOCHS="2")
    lines = [ln for ln in out.splitlines() if ln.startswith("[S=128] epoch")]
    assert len(lines) == 2 and "tokens/s" in lines[-1]


def test_long_context_curriculum_phases(tmp_path):
    out = run_driver("long_context_trainer", tmp=tmp_path, SEQ_LEN="128",
                     EMBED="32", BATCH="4", STEPS_PER_EPOCH="2", EPOCHS="1",
                     CURRICULUM="96:1")
    assert "[S=96] epoch 1" in out and "[S=128] epoch 1" in out


def test_accuracy_gates_offline_gates(tmp_path):
    out = run_driver("accuracy_gates", "digits28", "digits", tmp=tmp_path,
                     EPOCHS_DIGITS28="1", EPOCHS_DIGITS="1")
    assert "using synthetic" not in out
    with open(tmp_path / "res" / "RESULTS.json") as f:
        recs = {r["gate"]: r for r in json.load(f)}
    assert set(recs) == {"digits28", "digits"}
    for r in recs.values():
        assert r["device"] == "cpu" and r["precision"] == "parity"
        assert r["val_samples"] == 359 and 0.0 <= r["val_acc"] <= 1.0
        assert "seconds_to_target" in r
    md = (tmp_path / "res" / "RESULTS.md").read_text()
    assert "| digits28 | mnist_cnn_model | 1 |" in md


@pytest.mark.parametrize("gate", ["mnist", "cifar10", "tiny_imagenet"])
def test_download_gates_skip_without_data(tmp_path, monkeypatch, gate):
    tried = []
    monkeypatch.setattr(accuracy_gates, "_try_download",
                        lambda names: tried.append(names) or False)
    monkeypatch.setenv("MNIST_TRAIN_CSV", str(tmp_path / "none.csv"))
    monkeypatch.setenv("CIFAR10_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("TINY_IMAGENET_DIR", str(tmp_path / "none"))
    rec = accuracy_gates.GATES[gate](TrainingConfig(device_type="cpu"))
    assert tried == [[gate]]
    assert set(rec) == {"gate", "skipped"} and rec["gate"] == gate
    assert "python -m dcnn_tpu_torch.data.download --root data" in \
        rec["skipped"]


def test_try_download_gives_up_at_the_probe(monkeypatch):
    import socket
    import subprocess as sp

    def refuse(*a, **k):
        raise OSError("unreachable")

    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(sp, "run", lambda *a, **k: pytest.fail("ran"))
    assert accuracy_gates._try_download(["mnist"]) is False


def test_digits_gate_skips_without_sklearn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    rec = accuracy_gates.gate_digits(TrainingConfig(device_type="cpu"))
    assert rec["gate"] == "digits" and "scikit-learn absent" in \
        rec["skipped"]


def test_results_keep_a_real_result_over_a_skip(tmp_path):
    real = {"gate": "mnist", "model": "m", "epochs": 1, "val_acc": 0.99,
            "target": 0.99, "passed": True, "wall_clock_s": 1.0,
            "seconds_to_target": 1.0, "device": "cpu",
            "precision": "parity"}
    accuracy_gates.write_results([real], str(tmp_path))
    merged = accuracy_gates.write_results(
        [{"gate": "mnist", "skipped": "absent"},
         {"gate": "cifar10", "skipped": "absent"}], str(tmp_path))
    assert [r.get("skipped") for r in merged] == [None, "absent"]
    assert "SKIPPED: absent" in (tmp_path / "RESULTS.md").read_text()


def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module; its
    ``from common import ...`` resolves to ``examples/common.py``, and
    ``sys.path`` and ``sys.modules['common']`` are put back afterwards."""
    saved_path = list(sys.path)
    saved_common = sys.modules.pop("common", None)
    sys.path.insert(0, str(REPO / "examples"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("common", None)
        if saved_common is not None:
            sys.modules["common"] = saved_common


def _marker_batch(rng, b, s, e, nc):
    """The retrieval task's batch in numpy, as both drivers draw it."""
    x = rng.normal(size=(b, s, e)).astype(np.float32) * np.float32(0.3)
    pos = rng.integers(0, s - 64, size=b)
    cls = rng.integers(0, nc, size=b)
    for i in range(b):
        x[i, pos[i], 0] += 4.0
        x[i, pos[i], 1 + cls[i]] += 4.0
    return x, np.eye(nc, dtype=np.float32)[cls]


def test_long_context_model_matches_jax_interpret(monkeypatch):
    S, E, H, B, NC = 128, 32, 2, 4, 16
    jlc = _jax_example("long_context_trainer")
    trunk_j = jlc.make_trunk(S, E, H)
    head_j = JaxBuilder("lc_head").input((E,)).dense(NC, True, "cls").build()
    key = jax.random.PRNGKey(0)
    tp, tstate = trunk_j.init(key)
    hp, hstate = head_j.init(jax.random.fold_in(key, 1))
    x, y = _marker_batch(np.random.default_rng(7), B, S, E, NC)

    monkeypatch.setattr(jax_attention_layer, "flash_attention",
                        functools.partial(jax_attn.flash_attention,
                                          interpret=True, block_q=64,
                                          block_kv=64))
    z, _ = trunk_j.apply(tp, tstate, jnp.asarray(x))
    want, _ = head_j.apply(hp, hstate, jnp.mean(z[:, -32:, :], axis=1))
    want_loss = float(jax_ce(want, jnp.asarray(y)))

    port_trunk = long_context_trainer.make_trunk(S, E, H)
    port_trunk.init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert port_trunk.get_config() == trunk_j.get_config()
    assert (long_context_trainer.make_head(E, NC).get_config()
            == head_j.get_config())
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    model = long_context_trainer.LongContextModel(
        from_jax(trunk_j.get_config(), to_np(tp), device="cpu"),
        from_jax(head_j.get_config(), to_np(hp), device="cpu")).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_loss = float(softmax_cross_entropy(got, torch.from_numpy(y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))


def test_long_context_batch_is_the_retrieval_task():
    gen = long_context_trainer.seeded("cpu", 42, 0, 1)
    x, y = long_context_trainer.make_device_batch(gen, 16, 256, 24, 8)
    assert x.shape == (16, 256, 24) and y.shape == (16, 8)
    cls = y.argmax(1)
    for i in range(16):
        marked = torch.nonzero(x[i, :, 0] > 2.5).flatten()
        assert marked.numel() == 1 and int(marked[0]) < 256 - 64
        p = int(marked[0])
        assert int(x[i, p, 1:9].argmax()) == int(cls[i])
    again = long_context_trainer.make_device_batch(
        long_context_trainer.seeded("cpu", 42, 0, 1), 16, 256, 24, 8)
    assert torch.equal(again[0], x) and torch.equal(again[1], y)


def test_digits28_csvs_byte_equal_to_jax(tmp_path):
    from dcnn_tpu.data.digits28 import ensure_digits28_csvs as jax_ensure
    from dcnn_tpu_torch.data.digits28 import (ensure_digits28_csvs,
                                              load_digits8x8)
    from sklearn.datasets import load_digits

    X, y = load_digits(return_X_y=True)
    px, lab = load_digits8x8()
    assert np.array_equal(px, X) and np.array_equal(lab, y)
    mine = ensure_digits28_csvs(str(tmp_path / "port"))
    theirs = jax_ensure(str(tmp_path / "jax"))
    for f in ("train.csv", "test.csv"):
        assert filecmp.cmp(os.path.join(mine, f), os.path.join(theirs, f),
                           shallow=False), f
    assert sorted(os.listdir(mine)) == ["test.csv", "train.csv"]
