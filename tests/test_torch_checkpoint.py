"""Checkpoints in the JAX package's format: the port held against the JAX
package on the CPU.

- The codec (``dcnn_tpu_torch/train/_msgpack.py``): msgpack values byte for
  byte against ``msgpack``; a model's whole checkpoint tree (narrow
  residual CNN in NCHW and NHWC, narrow ``mha_classifier``; SGD with
  momentum, Adam, AdamW, each after one update) byte for byte against
  ``flax.serialization.to_bytes`` of the JAX package's tree; flax's chunked
  form for arrays above ``MAX_CHUNK_SIZE`` (lowered in both for the test).
- Across packages: a checkpoint saved by either package loads in the other
  with identical arrays (params, batchnorm state, optimizer state) and an
  equal model config; the loaded models' logits agree to parity precision
  (1e-5 of the largest logit: convs summed in another order by XLA's and
  PyTorch's CPU kernels).
- The committed snapshot ``model_snapshots/mnist_cnn_model`` served by the
  port (``InferenceEngine.from_checkpoint(..., device="cpu", fold=True)``)
  against the JAX engine: logits within 1e-5 of the largest, equal top-1,
  and equal accuracy on digits28 test, generated by the port's
  ``ensure_digits28_csvs``.
- The default ``TrainingConfig`` with a val loader writes the best-val
  snapshot only when val accuracy improves, and JAX reads it.
"""

import functools
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from dcnn_tpu.data import MNISTDataLoader as JaxMNIST
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import Adam as JaxAdam
from dcnn_tpu.optim import AdamW as JaxAdamW
from dcnn_tpu.serve import InferenceEngine as JaxEngine
from dcnn_tpu.train import load_checkpoint as jax_load
from dcnn_tpu.train import save_checkpoint as jax_save
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import (
    MNISTDataLoader, SyntheticClassificationLoader, ensure_digits28_csvs,
)
from dcnn_tpu_torch.interop import (
    from_jax, opt_state_from_jax, opt_state_to_jax, state_to_jax, to_jax,
)
from dcnn_tpu_torch.optim import SGD, Adam, AdamW
from dcnn_tpu_torch.serve import InferenceEngine
from dcnn_tpu_torch.train import (
    _msgpack, create_train_state, load_checkpoint, save_checkpoint,
    train_classification_model,
)
from dcnn_tpu_torch.train import trainer as port_trainer
from dcnn_tpu_torch.train.checkpoint import HostSnapshot

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
cnn_tests = importlib.import_module("test_torch_cnn")
mha_tests = importlib.import_module("test_torch_model")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "model_snapshots", "mnist_cnn_model")
LOGIT_TOL = 1e-5
OPTIMIZERS = {
    "sgd": (lambda: JaxSGD(1e-2, momentum=0.9), lambda: SGD(1e-2, momentum=0.9)),
    "adam": (lambda: JaxAdam(1e-3), lambda: Adam(1e-3)),
    "adamw": (lambda: JaxAdamW(1e-3, weight_decay=0.01),
              lambda: AdamW(1e-3, weight_decay=0.01)),
}
MODELS = ["cnn_nchw", "cnn_nhwc", "mha"]


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_identical(a, b):
    """The same tree structure, and every array equal in dtype, shape and
    value."""
    assert (jax.tree_util.tree_structure(a)
            == jax.tree_util.tree_structure(b))
    la, lb = _leaves(a), _leaves(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _jax_model(which, seed=0):
    """(JAX model, params, state as numpy, a batch): random BN statistics
    and affine params, so a wrong array would show."""
    if which == "mha":
        jm = mha_tests._narrow_jax()
        params, state = jm.init(jax.random.PRNGKey(seed), jm.input_shape)
        pnp = jax.tree_util.tree_map(np.asarray, params)
        snp = jax.tree_util.tree_map(np.asarray, state)
        x = np.random.default_rng(seed).normal(size=(3, 16, 32)).astype(
            np.float32)
        return jm, pnp, snp, x
    return cnn_tests._narrow("NCHW" if which == "cnn_nchw" else "NHWC", seed)


def _jax_trained_opt(jm, pnp, snp, x, opt):
    """The JAX optimizer state after one update on a random gradient:
    velocity, m and v nonzero, Adam's t = 1."""
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(a.dtype)), pnp)
    new_params, opt_state = opt.update(grads, opt.init(tree(pnp)), tree(pnp),
                                       1e-3)
    return (jax.tree_util.tree_map(np.asarray, new_params),
            jax.tree_util.tree_map(np.asarray, opt_state))


@functools.lru_cache(maxsize=None)
def _pair(which, opt_name):
    """The same model, trained params, state and optimizer state in both
    packages: (jm, pnp, snp, jax opt, jax opt state, port model, port opt,
    port opt state, x); built once per case and only read by the tests."""
    jm, pnp, snp, x = _jax_model(which)
    jopt, topt_fn = OPTIMIZERS[opt_name]
    jopt = jopt()
    pnp, jos = _jax_trained_opt(jm, pnp, snp, x, jopt)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu")
    tos = opt_state_from_jax(tm, jos)
    return jm, pnp, snp, jopt, jos, tm, topt_fn(), tos, x


def _jax_logits(jm, pnp, snp, x):
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return np.asarray(jm.apply(tree(pnp), tree(snp), jnp.asarray(x),
                               training=False)[0])


def _port_logits(tm, x):
    with torch.no_grad():
        return tm.eval()(torch.from_numpy(x)).numpy()


def _close(got, want, tol=LOGIT_TOL):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


# -- the codec -------------------------------------------------------------

PRIMITIVES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
              -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.5, -1e300, True, False,
              None, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
              "e" * 70000, "ü", b"", b"x" * 255, b"y" * 256, b"z" * 70000,
              list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
              {str(i): i for i in range(70000)}]


@pytest.mark.parametrize("value", PRIMITIVES,
                         ids=lambda v: f"{type(v).__name__}{str(v)[:12]}")
def test_codec_matches_msgpack(value):
    """Every value in the smallest form msgpack picks: the same bytes, and
    each reads the other's."""
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("value", [np.float32(1.5), np.int64(-7),
                                   np.zeros((), np.int32),
                                   np.arange(12, dtype=np.float64).reshape(3, 4),
                                   np.ones((2, 0, 3), np.float32)],
                         ids=["f32", "i64", "int32_0d", "f64_3x4", "empty"])
def test_codec_numpy_matches_flax(value):
    """Numpy scalars as ext 3, arrays (0-d and empty included) as ext 1,
    as flax writes them; flax reads them back as they were."""
    want = serialization.msgpack_serialize({"x": value})
    assert _msgpack.to_bytes({"x": value}) == want
    back = serialization.msgpack_restore(_msgpack.to_bytes({"x": value}))["x"]
    assert type(back) is type(value) and np.array_equal(back, value)
    ours = _msgpack.msgpack_restore(want)["x"]
    assert type(ours) is type(value) and np.asarray(ours).dtype == value.dtype
    assert np.array_equal(ours, value)


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("which", MODELS)
def test_checkpoint_bytes_equal_flax(which, opt_name):
    """The port's arrays.msgpack for a model and optimizer state equals
    ``flax.serialization.to_bytes`` of the JAX package's tree for the same
    model, as ``save_checkpoint`` calls it (after its tree_map, which sorts
    dict keys): the same bytes, so the same file."""
    jm, pnp, snp, jopt, jos, tm, topt, tos, _ = _pair(which, opt_name)
    tree = {"params": pnp, "state": snp, "opt_state": jos}
    want = serialization.to_bytes(jax.tree_util.tree_map(jax.device_get, tree))
    got = _msgpack.to_bytes(HostSnapshot(tm, tos).tree())
    assert got == want
    # and the port restores the JAX bytes against its own template
    back = _msgpack.from_bytes(HostSnapshot(tm, tos).tree(), want)
    _assert_identical(back, tree)


def test_chunked_arrays_round_trip(monkeypatch):
    """flax's chunked form for arrays above MAX_CHUNK_SIZE (lowered to 64
    bytes in both): the port writes flax's bytes, and each package reads
    the other's arrays back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"big": rng.normal(size=(7, 5)).astype(np.float32),
            "nested": ({"w": rng.normal(size=(3, 11)).astype(np.float64),
                        "small": np.arange(4, dtype=np.int32)},),
            "odd": rng.integers(0, 9, size=(33,)).astype(np.int16)}
    # as save_checkpoint hands it over: tree_map sorts the dict keys
    want = serialization.to_bytes(jax.tree_util.tree_map(np.asarray, tree))
    got = _msgpack.to_bytes(tree)
    assert got == want
    raw = _msgpack.unpackb(got)
    assert raw["big"]["__msgpack_chunked_array__"] is True
    assert len(raw["big"]["chunks"]) == 3      # 140 bytes in 16-float chunks
    _assert_identical(_msgpack.from_bytes(tree, want), tree)
    _assert_identical(serialization.from_bytes(tree, got), tree)


def test_codec_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(_msgpack.packb({"a": 1})[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(_msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="bfloat16"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(
            1, msgpack.packb(((2,), "bfloat16", b"\x00" * 4),
                             use_bin_type=True))))
    with pytest.raises(ValueError, match="ext type 2"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(2, b"\x00")))
    with pytest.raises(TypeError, match="cannot serialize"):
        _msgpack.packb({"a": object()})
    with pytest.raises(ValueError, match="lacks keys"):
        _msgpack.from_bytes({"a": 0, "b": 0}, _msgpack.to_bytes({"a": 1}))


# -- across packages -------------------------------------------------------

@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("which", MODELS)
def test_jax_checkpoint_loads_in_port(tmp_path, which, opt_name):
    """JAX ``save_checkpoint`` -> port ``load_checkpoint``: identical
    params, batchnorm state and optimizer state, an equal config and
    metadata, logits at parity precision."""
    jm, pnp, snp, jopt, jos, _, _, _, x = _pair(which, opt_name)
    jax_save(str(tmp_path), jm, pnp, snp, jos, jopt, {"epoch": 3})
    model, opt_state, opt, md = load_checkpoint(str(tmp_path), device="cpu")
    assert model.get_config() == jm.get_config() and md == {"epoch": 3}
    assert opt.get_config() == jopt.get_config()
    _assert_identical(to_jax(model), pnp)
    _assert_identical(state_to_jax(model), snp)
    _assert_identical(opt_state_to_jax(model, opt_state), jos)
    _close(_port_logits(model, x), _jax_logits(jm, pnp, snp, x))


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("which", MODELS)
def test_port_checkpoint_loads_in_jax(tmp_path, which, opt_name):
    """Port ``save_checkpoint`` -> JAX ``load_checkpoint``: identical
    arrays (the JAX template restores every leaf), an equal config, and
    the two model.json files equal key for key."""
    jm, pnp, snp, jopt, jos, tm, topt, tos, x = _pair(which, opt_name)
    save_checkpoint(str(tmp_path / "port"), tm, tos, topt, {"epoch": 3})
    model, params, state, opt_state, opt, md = jax_load(str(tmp_path / "port"))
    assert model.get_config() == jm.get_config() and md == {"epoch": 3}
    assert opt.get_config() == jopt.get_config()
    _assert_identical(params, pnp)
    _assert_identical(state, snp)
    _assert_identical(opt_state, jos)
    _close(_jax_logits(model, params, state, x), _port_logits(tm, x))
    jax_save(str(tmp_path / "jax"), jm, pnp, snp, jos, jopt, {"epoch": 3})
    for name in ("model.json", "arrays.msgpack"):
        a = (tmp_path / "port" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        if name == "model.json":
            a, b = json.loads(a), json.loads(b)
        assert a == b, name


def test_checkpoint_without_optimizer_state(tmp_path):
    """No optimizer state: ``has_opt_state`` false in both packages, and
    either loads the other's."""
    jm, pnp, snp, x = _jax_model("cnn_nchw")
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu")
    save_checkpoint(str(tmp_path), tm)
    _, params, state, opt_state, opt, md = jax_load(str(tmp_path))
    assert opt_state is None and opt is None and md == {}
    _assert_identical(params, pnp)
    model, opt_state, opt, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert opt_state is None and opt is None
    _assert_identical(state_to_jax(model), snp)


def test_fp64_model_round_trips_in_fp64(tmp_path):
    """A checkpoint of an fp64 model (params, buffers and Adam's state)
    loads back in fp64, bit for bit; an fp32 one stays fp32."""
    jm, pnp, snp, _ = _jax_model("cnn_nchw")
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").double()
    opt = Adam(1e-3)
    ts = create_train_state(tm, opt)
    with torch.no_grad():
        for p in tm.parameters():  # below fp32's resolution of the weights
            p.add_(1e-12)
    save_checkpoint(str(tmp_path), tm, ts.opt_state, opt)
    model, opt_state, _, _ = load_checkpoint(str(tmp_path), device="cpu")
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              model.state_dict().items()):
        assert b.dtype == torch.float64, n
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for n, a in ts.opt_state["m"].items():
        torch.testing.assert_close(opt_state["m"][n], a, rtol=0, atol=0)
    save_checkpoint(str(tmp_path / "f32"), from_jax(
        jm.get_config(), pnp, snp, device="cpu"))
    model, _, _, _ = load_checkpoint(str(tmp_path / "f32"), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_load_refuses_a_mismatched_optimizer_state(tmp_path):
    jm, pnp, snp, jopt, jos, _, _, _, _ = _pair("cnn_nchw", "adam")
    jax_save(str(tmp_path), jm, pnp, snp, jos, jopt)
    man = json.loads((tmp_path / "model.json").read_text())
    man["optimizer"] = JaxSGD(1e-2, momentum=0.9).get_config()
    (tmp_path / "model.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="'velocity' does not fit"):
        load_checkpoint(str(tmp_path), device="cpu")


# -- the committed snapshot ------------------------------------------------

def test_committed_snapshot_served_matches_jax():
    """``model_snapshots/mnist_cnn_model`` on a seeded batch: the port's
    folded CPU engine against the JAX engine's (folded too), logits within
    1e-5 of the largest, equal top-1; the unfolded port model agrees."""
    x = np.random.default_rng(0).uniform(0, 1, size=(16, 1, 28, 28)).astype(
        np.float32)
    want = np.asarray(JaxEngine.from_checkpoint(
        SNAPSHOT, max_batch=16, warmup=False, aot_cache=False).infer(x))
    engine = InferenceEngine.from_checkpoint(SNAPSHOT, device="cpu",
                                             fold=True, max_batch=16)
    got = engine.infer(torch.from_numpy(x)).numpy()
    _close(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    model, _, _, md = load_checkpoint(SNAPSHOT, device="cpu")
    assert md["val_acc"] > 0.9
    _close(_port_logits(model, x), want)


def test_committed_snapshot_digits28_accuracy_matches_jax(tmp_path):
    """digits28 test (generated into tmp_path by the port's
    ``ensure_digits28_csvs``, read by both packages' MNIST readers): the
    port's folded engine scores the JAX engine's accuracy, prediction for
    prediction."""
    d = ensure_digits28_csvs(str(tmp_path))
    csv = os.path.join(d, "test.csv")
    ours = MNISTDataLoader(csv, batch_size=512, shuffle=False,
                           drop_last=False)
    ours.load_data()
    theirs = JaxMNIST(csv, batch_size=512, shuffle=False, drop_last=False)
    theirs.load_data()
    (x, y), = list(ours)
    (xj, yj), = list(theirs)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(xj))
    xf = (np.asarray(x, np.float32) * (1.0 / 255.0)
          if np.asarray(x).dtype == np.uint8 else np.asarray(x))
    want = np.asarray(JaxEngine.from_checkpoint(
        SNAPSHOT, max_batch=512, warmup=False, aot_cache=False).infer(xf))
    got = InferenceEngine.from_checkpoint(
        SNAPSHOT, device="cpu", max_batch=512, warmup=False).infer(
        torch.from_numpy(xf)).numpy()
    labels = np.asarray(y).argmax(-1)
    acc_port = float((got.argmax(-1) == labels).mean())
    acc_jax = float((want.argmax(-1) == labels).mean())
    assert acc_port == acc_jax and acc_jax > 0.9
    assert (got.argmax(-1) == want.argmax(-1)).all()


# -- the default config ----------------------------------------------------

def test_default_config_writes_best_val_snapshot(tmp_path, monkeypatch):
    """``train_classification_model`` with the default TrainingConfig (but
    the CPU and a snapshot_dir in tmp_path) and a val loader: the best-val
    snapshot is written in the epochs whose val accuracy beats every
    earlier one, with {epoch, val_acc, val_loss}, and JAX reads it."""
    saved = []
    real = port_trainer.save_checkpoint

    def counting(path, model, *a, **kw):
        saved.append(a[2]["epoch"] if len(a) > 2 else kw["metadata"]["epoch"])
        return real(path, model, *a, **kw)

    monkeypatch.setattr(port_trainer, "save_checkpoint", counting)
    cfg = TrainingConfig(device_type="cpu", snapshot_dir=str(tmp_path),
                         epochs=4, batch_size=16, progress_interval=0)
    assert TrainingConfig().snapshot_dir == "model_snapshots"
    jm, pnp, snp, _ = _jax_model("cnn_nchw")
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu")
    train = SyntheticClassificationLoader(64, (3, 16, 16), 10, batch_size=16,
                                          seed=1)
    val = SyntheticClassificationLoader(32, (3, 16, 16), 10, batch_size=16,
                                        seed=2, shuffle=False)
    train.load_data()
    val.load_data()
    ts, trainer = train_classification_model(
        tm, AdamW(1e-3, weight_decay=0.01), "softmax_crossentropy", train,
        val, config=cfg)
    accs = [h["val_acc"] for h in trainer.history]
    best = [e for e, a in enumerate(accs, 1) if a > max([-1.0, *accs[:e - 1]])]
    assert saved == best and saved
    snap = os.path.join(str(tmp_path), tm.name)
    model, params, state, opt_state, opt, md = jax_load(snap)
    assert md["epoch"] == best[-1] and md["val_acc"] == accs[best[-1] - 1]
    assert md["val_loss"] == trainer.history[best[-1] - 1]["val_loss"]
    assert model.get_config() == tm.get_config()
    assert int(opt_state["t"]) == 4 * best[-1]
    if best[-1] == len(accs):   # the last epoch's snapshot is the final model
        _assert_identical(params, to_jax(tm))
