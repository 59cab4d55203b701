"""Versioned hot-swap over real engines (``dcnn_tpu_torch/serve/swap.py``)
against the JAX package's, on checkpoints the JAX package commits.

The twins of the six cases of ``tests/test_swap.py``: the JAX
``CheckpointManager`` commits a tiny CNN's v1 and v2 (v2 = v1 + 0.25 in
every param), and the port's ``newest_valid_version``, ``EngineFactory``
and ``LocalReplica.swap`` work on that root:

- the newest valid version is the JAX package's; a bit-flipped newest
  commit is skipped to the previous valid one (warned, counted on the
  given registry, nothing renamed), and the factory refuses it;
- the port factory's engine is within atol 1e-4 / rtol 1e-4 of the JAX
  factory's engine at every bucket (folded fp32), and its int8 engine
  within ``INT8_JAX_TOL`` (1e-5) of the logit scale of the JAX int8
  engine, with equal argmax, from the same calibration batch;
- a port replica hot-swapped to v2 answers bit for bit what a fresh port
  engine of v2 answers at every bucket; a ``serve.swap`` fault mid-load
  leaves it serving v1; a missing version raises.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import SequentialBuilder
from dcnn_tpu.resilience.checkpoint import CheckpointManager, list_steps
from dcnn_tpu.serve import EngineFactory as JaxEngineFactory
from dcnn_tpu.serve import newest_valid_version as jax_newest
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from dcnn_tpu_torch.serve import (
    EngineFactory, InferenceEngine, LocalReplica, SwapError,
    newest_valid_version,
)

ATOL = RTOL = 1e-4
INT8_JAX_TOL = 1e-5  # max |port - JAX| over max |JAX logit|


def _tiny_model():
    return (SequentialBuilder(name="swp", data_format="NHWC")
            .input((8, 8, 3))
            .conv2d(4, 3, padding=1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(5)
            .build())


@pytest.fixture(scope="module")
def versions(tmp_path_factory):
    """A checkpoint root the JAX package committed: step 1, and step 2
    with every param moved by 0.25; a probe pool and a calibration
    batch."""
    root = str(tmp_path_factory.mktemp("ckpts"))
    model = _tiny_model()
    params1, state = model.init(jax.random.PRNGKey(0), model.input_shape)
    params2 = jax.tree_util.tree_map(lambda a: a + 0.25, params1)
    mgr = CheckpointManager(root, keep=5)
    mgr.save(1, model, params1, state)
    mgr.save(2, model, params2, state)
    mgr.close()
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    calib = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    return root, pool, calib


def _logits(engine, x):
    return np.asarray(engine.infer(x))


def test_newest_valid_version_picks_newest(versions):
    root, *_ = versions
    found = newest_valid_version(root, registry=MetricsRegistry())
    assert found is not None
    step, path = found
    assert step == 2 and path.endswith("ckpt-00000002")
    assert found == jax_newest(root)
    assert EngineFactory(root, device="cpu").newest() == 2


def test_corrupt_newest_skipped_to_previous_valid(versions, tmp_path):
    """A bit-flipped newest commit is skipped to the previous valid
    version: warned, counted, nothing renamed (a read-only consumer), as
    in the JAX package; the factory refuses the torn version itself."""
    root, *_ = versions
    work = str(tmp_path / "root")
    shutil.copytree(root, work)
    FaultPlan(seed=7).bit_flip(
        os.path.join(work, "ckpt-00000002", "arrays.msgpack"))

    reg = MetricsRegistry()
    with pytest.warns(UserWarning, match="torn/corrupt"):
        found = newest_valid_version(work, registry=reg)
    assert found is not None and found[0] == 1
    assert reg.snapshot()["serve_swap_versions_skipped_total"] == 1
    assert sorted(list_steps(work)) == [1, 2]
    with pytest.warns(UserWarning, match="torn/corrupt"):
        assert jax_newest(work)[0] == 1

    factory = EngineFactory(work, max_batch=4, registry=reg, device="cpu")
    with pytest.raises(Exception, match="checksum|missing"):
        factory(2)
    with pytest.warns(UserWarning, match="torn/corrupt"):
        assert factory.newest() == 1
    assert reg.snapshot()["serve_swap_versions_skipped_total"] == 2
    eng = factory(1)
    assert eng.version == 1 and eng.name == "v1"
    assert sorted(list_steps(work)) == [1, 2]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_factory_engine_matches_jax_factory_and_fresh(versions, int8):
    """The port factory's engine of the newest commit against the JAX
    factory's at every bucket, and bit for bit a fresh port engine from
    the same commit."""
    root, pool, calib = versions
    kw = {"max_batch": 4}
    if int8:
        kw["int8_calib"] = calib
    factory = EngineFactory(root, device="cpu", **kw)
    eng = factory(factory.newest())
    assert eng.version == 2 and eng.bucket_sizes == [1, 2, 4]
    assert eng.batch_invariant == int8
    want = JaxEngineFactory(root, **kw)(2)
    fresh = InferenceEngine.from_checkpoint(
        os.path.join(root, "ckpt-00000002"), device="cpu", **kw)
    for b in eng.bucket_sizes:
        got = _logits(eng, pool[:b])
        ref = np.asarray(want.infer(pool[:b]))
        if int8:
            assert np.abs(got - ref).max() <= \
                INT8_JAX_TOL * np.abs(ref).max()
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        else:
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got, _logits(fresh, pool[:b]))


def test_replica_hot_swap_bit_identity_every_bucket(versions):
    """drain -> load v2 -> rejoin through a port LocalReplica answers bit
    for bit what a fresh port engine of v2 answers, at every bucket; v1's
    answers differ (the swap really happened)."""
    root, pool, _ = versions
    factory = EngineFactory(root, max_batch=4, device="cpu")
    rep = LocalReplica(factory, 1, name="swapper", queue_capacity=32,
                       start=False)
    try:
        fresh1 = factory(1)
        f = rep.submit(pool[:2])
        rep.step()
        np.testing.assert_array_equal(f.result(timeout=0),
                                      _logits(fresh1, pool[:2]))
        rep.swap(2)
        assert rep.version == 2
        fresh2 = InferenceEngine.from_checkpoint(
            os.path.join(root, "ckpt-00000002"), max_batch=4, device="cpu")
        for b in fresh2.bucket_sizes:
            x = pool[:b] if b > 1 else pool[0]
            f = rep.submit(x)
            rep.step()
            np.testing.assert_array_equal(f.result(timeout=0),
                                          _logits(fresh2, x))
        assert not np.array_equal(_logits(fresh1, pool[:2]),
                                  _logits(fresh2, pool[:2]))
    finally:
        rep.close()


def test_swap_fault_mid_load_rejoins_old_version(versions):
    root, pool, _ = versions
    factory = EngineFactory(root, max_batch=4, device="cpu")
    plan = FaultPlan().arm("serve.swap", exc=InjectedFault, times=1)
    rep = LocalReplica(factory, 1, name="sticky", queue_capacity=32,
                       fault_plan=plan, start=False)
    try:
        with pytest.raises(SwapError, match="rejoined on old version"):
            rep.swap(2)
        assert rep.version == 1 and rep.health() is None
        f = rep.submit(pool[:2])
        rep.step()
        np.testing.assert_array_equal(f.result(timeout=0),
                                      _logits(factory(1), pool[:2]))
        rep.swap(2)  # the plan fired once: now it loads
        assert rep.version == 2
    finally:
        rep.close()


def test_factory_missing_version_raises(versions):
    root, *_ = versions
    factory = EngineFactory(root, max_batch=4, device="cpu")
    with pytest.raises(Exception, match="missing|checksum"):
        factory(99)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_factory_engine_on_cuda_raises_without_a_gpu(versions):
    """No fallback: a factory (and so a replica) asked for the card on a
    machine without one raises; ``device="cpu"`` is the way to the
    CPU."""
    root, *_ = versions
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineFactory(root, max_batch=4)(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalReplica(EngineFactory(root, max_batch=4), 1, start=False)
