"""The port's serving stack: ``InferenceEngine`` buckets and padding,
``DynamicBatcher`` batching, shedding, teardown, and ``ServeMetrics``.
These mirror ``tests/test_serve.py``; the model is a narrow attention
classifier on the CPU (the kernel's plain path), and the engine's answers
are held against the JAX model with the same weights.

The int8 engine (``from_model(..., int8_calib=...)``) is served from the
JAX tests' narrow conv model (NHWC 8x8x3, conv-BN-ReLU, pool, dense) and
from the attention classifier: ``batch_invariant``, its logits
bit-identical at every bucket and through ``DynamicBatcher``, and within
1e-5 of the logit scale of the JAX int8 engine with the same weights and
calibration batch (the float glue between the int8 layers sums in another
order)."""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.serve import InferenceEngine as JaxEngine
from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
from dcnn_tpu_torch.nn import Sequential
from dcnn_tpu_torch.serve import (
    DrainingError, DynamicBatcher, InferenceEngine, QueueFullError,
    ServeMetrics, ShutdownError, serve_buckets,
)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def tiny():
    jm = (JaxBuilder("srv").input((8, 16))
          .add_layer(JaxResidual(layers=[JaxMHA(num_heads=2, name="mha")],
                                 shortcut=[], name="blk"))
          .flatten().dense(5).build())
    params, state = jm.init(jax.random.PRNGKey(0), jm.input_shape)
    pool = np.random.default_rng(0).normal(size=(16, 8, 16)).astype(np.float32)
    jax_logits = np.asarray(jm.apply(params, state, jnp.asarray(pool))[0])
    model = from_jax(jm.get_config(),
                     jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return model, pool, jax_logits


@pytest.fixture(scope="module")
def engine(tiny):
    model, _, _ = tiny
    return InferenceEngine.from_model(model, max_batch=8, device="cpu")


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- engine

def test_serve_buckets():
    assert serve_buckets(1) == [1]
    assert serve_buckets(8) == [1, 2, 4, 8]
    assert serve_buckets(32) == [1, 2, 4, 8, 16, 32]
    assert serve_buckets(6) == [1, 2, 4, 6]
    with pytest.raises(ValueError):
        serve_buckets(0)


def test_engine_warms_every_bucket(engine):
    assert engine.bucket_sizes == [1, 2, 4, 8]
    assert sorted(engine.compile_stats) == [1, 2, 4, 8]
    assert all(st["warmup_s"] >= 0 for st in engine.compile_stats.values())
    assert engine.run_padded(torch.zeros(4, 8, 16)).shape == (4, 5)
    with pytest.raises(ValueError, match="no session"):
        engine.run_padded(torch.zeros(3, 8, 16))


def test_engine_bucket_math(engine):
    assert [engine.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    for n in (0, 9):
        with pytest.raises(ValueError):
            engine.bucket_for(n)


def test_engine_matches_jax_model(engine, tiny):
    _, pool, jax_logits = tiny
    np.testing.assert_allclose(_np(engine.infer(pool)), jax_logits,
                               atol=1e-4, rtol=1e-4)


def test_engine_infer_shapes_and_chunking(engine, tiny):
    _, pool, _ = tiny
    assert engine.infer(pool[0]).shape == (5,)
    assert engine.infer(pool[:3]).shape == (3, 5)
    y = engine.infer(pool)  # 16 rows > max_batch 8: two chunks
    assert y.shape == (16, 5)
    np.testing.assert_array_equal(_np(y[:8]), _np(engine.infer(pool[:8])))
    with pytest.raises(ValueError, match="trailing dims"):
        engine.infer(np.zeros((2, 4, 16), np.float32))


def test_engine_padding_is_row_exact_within_bucket(engine, tiny):
    _, pool, _ = tiny
    padded, n = engine.pad_to_bucket(pool[:5])
    assert padded.shape == (8, 8, 16) and n == 5
    assert torch.equal(padded[5:], torch.zeros(3, 8, 16))
    full = np.zeros((8, 8, 16), np.float32)
    full[:5] = pool[:5]
    np.testing.assert_array_equal(_np(engine.run_padded(padded))[:5],
                                  _np(engine.run_padded(torch.from_numpy(full)))[:5])


def test_engine_float_is_allclose_across_buckets(engine, tiny):
    _, pool, _ = tiny
    ref = _np(engine.infer(pool[:8]))
    for i in range(8):
        np.testing.assert_allclose(_np(engine.infer(pool[i])), ref[i],
                                   rtol=1e-5, atol=1e-5)


def test_engine_fold_without_batchnorm(tiny):
    """fold is accepted: with no batchnorm it is the identity."""
    model, pool, _ = tiny
    eng = InferenceEngine.from_model(model, fold=True, max_batch=2,
                                     device="cpu", warmup=False)
    assert eng.compile_stats.keys() == {1, 2}
    assert not eng.batch_invariant
    np.testing.assert_allclose(_np(eng.infer(pool[:2])),
                               _np(InferenceEngine.from_model(
                                   model, fold=False, max_batch=2,
                                   device="cpu").infer(pool[:2])),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- int8

INT8_JAX_TOL = 1e-5  # max |port - JAX| over max |JAX logit|


@pytest.fixture(scope="module")
def tiny_cnn():
    """The JAX serve tests' narrow conv model, weights drawn by the port
    (BN statistics at random) and carried to the JAX package."""
    jm = (JaxBuilder(name="srv", data_format="NHWC").input((8, 8, 3))
          .conv2d(4, 3, padding=1).batchnorm().activation("relu")
          .maxpool2d(2).flatten().dense(5).build())
    model = Sequential.from_config(jm.get_config()).init(
        generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    bn = model.layers[1]
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, 4)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 4)))
    calib = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    pool = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    return jm, model, calib, pool


@pytest.fixture(scope="module")
def int8_engine(tiny_cnn):
    _, model, calib, _ = tiny_cnn
    return InferenceEngine.from_model(model, int8_calib=calib, max_batch=8,
                                      device="cpu")


def test_engine_int8_is_batch_invariant(int8_engine, tiny_cnn):
    """The int8 graph's convs and GEMMs are exact integer sums: a
    request's logits are bit-identical whichever bucket served it."""
    *_, pool = tiny_cnn
    assert int8_engine.batch_invariant
    ref = _np(int8_engine.infer(pool[:8]))
    for i in range(8):
        np.testing.assert_array_equal(_np(int8_engine.infer(pool[i])),
                                      ref[i])
    for b in (2, 4):
        np.testing.assert_array_equal(_np(int8_engine.infer(pool[:b])),
                                      ref[:b])


def test_engine_int8_matches_jax_int8_engine(int8_engine, tiny_cnn):
    jm, model, calib, pool = tiny_cnn
    jeng = JaxEngine.from_model(jm, to_jax(model), state_to_jax(model),
                                int8_calib=jnp.asarray(calib), max_batch=8,
                                aot_cache=False)
    want = np.asarray(jeng.infer(pool[:8]))
    got = _np(int8_engine.infer(pool[:8]))
    assert np.abs(got - want).max() <= INT8_JAX_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_engine_int8_attention_is_batch_invariant(tiny):
    """The int8 attention classifier keeps a float core (the flash plain
    version here), each row its own: bit-identical across buckets too."""
    model, pool, _ = tiny
    eng = InferenceEngine.from_model(model, int8_calib=pool, max_batch=8,
                                     device="cpu")
    assert eng.batch_invariant
    ref = _np(eng.infer(pool[:8]))
    for i in range(8):
        np.testing.assert_array_equal(_np(eng.infer(pool[i])), ref[i])


def test_batcher_int8_bit_identical_to_engine_alone(int8_engine, tiny_cnn):
    *_, pool = tiny_cnn
    b = DynamicBatcher(int8_engine, max_batch=4, queue_capacity=64,
                       start=False)
    futs = [b.submit(pool[i]) for i in range(7)]  # batches of 4 + 3
    b.drain()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=1),
                                      _np(int8_engine.infer(pool[i])))


def test_batcher_int8_mixed_size_requests(int8_engine, tiny_cnn):
    *_, pool = tiny_cnn
    b = DynamicBatcher(int8_engine, max_batch=8, queue_capacity=64,
                       start=False)
    f2 = b.submit(pool[:2])
    f3 = b.submit(pool[2:5])
    f1 = b.submit(pool[5])
    b.drain()
    np.testing.assert_array_equal(f2.result(1),
                                  _np(int8_engine.infer(pool[:2])))
    np.testing.assert_array_equal(f3.result(1),
                                  _np(int8_engine.infer(pool[2:5])))
    np.testing.assert_array_equal(f1.result(1),
                                  _np(int8_engine.infer(pool[5])))
    assert f1.result(1).shape == (5,)


# ---------------------------------------------------------------- batcher

def test_batcher_matches_engine_and_mixed_sizes(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=8, queue_capacity=64, start=False)
    f2 = b.submit(pool[:2])
    f3 = b.submit(pool[2:5])
    f1 = b.submit(pool[5])
    b.drain()
    ref = _np(engine.infer(pool[:8]))  # the same bucket the batch ran in
    np.testing.assert_array_equal(f2.result(1), ref[:2])
    np.testing.assert_array_equal(f3.result(1), ref[2:5])
    np.testing.assert_array_equal(f1.result(1), ref[5])
    assert f1.result(1).shape == (5,)


def test_batcher_backpressure_sheds_and_drain_completes(engine, tiny):
    _, pool, _ = tiny
    mets = ServeMetrics()
    b = DynamicBatcher(engine, max_batch=4, queue_capacity=6, metrics=mets,
                       start=False)
    accepted = [b.submit(pool[i]) for i in range(6)]
    with pytest.raises(QueueFullError):
        b.submit(pool[6])
    with pytest.raises(QueueFullError):
        b.submit(pool[:2])
    assert b.queue_depth == 6
    b.drain()
    for i, f in enumerate(accepted):
        np.testing.assert_allclose(f.result(timeout=1), _np(engine.infer(pool[i])),
                                   rtol=1e-5, atol=1e-5)
    snap = mets.snapshot()
    assert snap["requests_completed"] == 6
    assert snap["requests_shed"] == 3
    assert snap["shed_fraction"] == pytest.approx(3 / 9)
    assert snap["queue_depth"] == 0
    with pytest.raises(DrainingError, match="draining or shut down"):
        b.submit(pool[0])


def test_batcher_deadline_batching_fake_clock(engine, tiny):
    _, pool, _ = tiny
    fc = FakeClock()
    mets = ServeMetrics(clock=fc)
    b = DynamicBatcher(engine, max_batch=4, max_wait_ms=10.0,
                       queue_capacity=64, metrics=mets, clock=fc, start=False)
    f0 = b.submit(pool[0])
    assert b.step(force=False) == 0
    fc.advance(0.004)
    f1 = b.submit(pool[1])
    assert b.step(force=False) == 0
    fc.advance(0.007)
    assert b.step(force=False) == 2
    assert f0.done() and f1.done()
    snap = mets.snapshot()
    assert snap["p99_ms"] == pytest.approx(11.0)
    assert snap["p50_ms"] == pytest.approx(11.0)
    assert snap["mean_ms"] == pytest.approx(9.0)
    assert snap["batches"] == 1 and snap["batch_occupancy"] == 1.0
    futs = [b.submit(pool[i]) for i in range(4)]
    assert b.step(force=False) == 4  # a full batch is due at once
    assert all(f.done() for f in futs)


def test_batcher_threaded(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=8, max_wait_ms=0.0,
                       queue_capacity=256)
    futs = [b.submit(pool[i % 16]) for i in range(48)]
    got = [f.result(timeout=30) for f in futs]
    b.shutdown()
    for i, y in enumerate(got):
        np.testing.assert_allclose(y, _np(engine.infer(pool[i % 16])),
                                   rtol=1e-5, atol=1e-5)
    snap = b.metrics.snapshot()
    assert snap["requests_completed"] == 48 and snap["requests_shed"] == 0
    assert snap["batches"] >= 1 and snap["p99_ms"] is not None


def test_batcher_submit_validation(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=4, start=False)
    with pytest.raises(ValueError, match="expected"):
        b.submit(np.zeros((4, 16), np.float32))
    with pytest.raises(ValueError, match="outside"):
        b.submit(pool[:5])
    b.drain()


def test_batcher_scatter_failure_to_futures(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=4, start=False)
    futs = [b.submit(pool[i]) for i in range(2)]

    def boom(x):
        raise RuntimeError("boom")

    b.engine = SimpleNamespace(run_padded=boom, pad_to_bucket=engine.pad_to_bucket,
                               input_shape=engine.input_shape)
    assert b.step() == 2
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=1)


def test_batcher_user_cancel_while_queued(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=4, start=False)
    f0 = b.submit(pool[0])
    f1 = b.submit(pool[1])
    assert f0.cancel()
    assert b.step() == 1
    assert f0.cancelled()
    np.testing.assert_allclose(f1.result(1), _np(engine.infer(pool[1])),
                               rtol=1e-5, atol=1e-5)
    b.drain()


def test_batcher_shutdown_without_drain_fails_pending(engine, tiny):
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=4, start=False)
    futs = [b.submit(pool[i]) for i in range(3)]
    b.shutdown(drain=False)
    for f in futs:
        assert f.done() and not f.cancelled()
        with pytest.raises(ShutdownError):
            f.result(timeout=0)
    assert b.queue_depth == 0
    with pytest.raises(RuntimeError):
        b.submit(pool[0])


def test_batcher_drain_timeout_fails_pending_not_orphans(engine, tiny):
    """A drain whose timeout trips releases every pending future with
    ShutdownError — including one held by a dispatch stuck in the engine —
    then raises TimeoutError; the late completion is absorbed."""
    _, pool, _ = tiny
    b = DynamicBatcher(engine, max_batch=2, max_wait_ms=0, queue_capacity=8)
    gate = threading.Event()

    def hung_run(padded):
        gate.wait(timeout=30)
        return engine.run_padded(padded)

    b.engine = SimpleNamespace(run_padded=hung_run,
                               pad_to_bucket=engine.pad_to_bucket,
                               input_shape=engine.input_shape,
                               name=engine.name, max_batch=engine.max_batch)
    f0 = b.submit(pool[0])
    for _ in range(100):
        if f0.running():
            break
        time.sleep(0.01)
    f1 = b.submit(pool[1])
    with pytest.raises(TimeoutError):
        b.drain(timeout=0.2)
    for f in (f0, f1):
        assert f.done()
        with pytest.raises(ShutdownError):
            f.result(timeout=0)
    gate.set()
    b._thread.join(timeout=30)
    assert not b._thread.is_alive()


def test_batcher_warms_buckets_on_its_dispatcher_thread(tiny):
    """The threaded batcher runs every bucket once on its own dispatcher
    thread before the constructor returns (cuDNN keeps handles and plans
    per thread); ``warm=False`` skips it, and a failing warm-up raises from
    the constructor."""
    model, pool, _ = tiny
    eng = InferenceEngine.from_model(model, max_batch=4, device="cpu",
                                     warmup=False)
    seen = []
    apply = eng._apply

    def recording(x):
        seen.append((threading.current_thread().name, x.shape[0]))
        return apply(x)

    eng._apply = recording
    b = DynamicBatcher(eng, max_batch=4)
    assert sorted(b.warmup_s) == [1, 2, 4]
    assert seen == [(b._thread.name, n) for n in (1, 2, 4)]
    np.testing.assert_allclose(b.submit(pool[0]).result(timeout=30),
                               _np(eng.infer(pool[0])), rtol=1e-5, atol=1e-5)
    b.shutdown()
    seen.clear()
    cold = DynamicBatcher(eng, max_batch=4, warm=False)
    assert cold.warmup_s == {} and seen == []
    cold.shutdown()

    def boom(x):
        raise RuntimeError("warm-up failed")

    eng._apply = boom
    with pytest.raises(RuntimeError, match="warm-up failed"):
        DynamicBatcher(eng, max_batch=4)


# ---------------------------------------------------------------- metrics

def test_metrics_fake_clock_exact():
    fc = FakeClock()
    m = ServeMetrics(clock=fc)
    for lat_ms in range(1, 11):
        m.record_done(lat_ms / 1e3)
    m.record_submit(10)
    m.record_shed(2)
    m.record_batch(6, 8)
    m.record_queue_depth(3)
    fc.advance(2.0)
    s = m.snapshot()
    assert s["throughput_rps"] == pytest.approx(5.0)
    assert s["p50_ms"] == pytest.approx(6.0)
    assert s["p95_ms"] == pytest.approx(10.0)
    assert s["p99_ms"] == pytest.approx(10.0)
    assert s["mean_ms"] == pytest.approx(5.5)
    assert s["batch_occupancy"] == pytest.approx(0.75)
    assert s["shed_fraction"] == pytest.approx(2 / 12)
    assert s["queue_depth"] == 3 and s["wall_s"] == pytest.approx(2.0)
    m.reset()
    s = m.snapshot()
    assert s["requests_completed"] == 0 and s["p50_ms"] is None
    assert s["throughput_rps"] is None


def test_metrics_rolling_window():
    m = ServeMetrics(window=4)
    for lat_ms in (100, 100, 100, 1, 1, 1, 1):
        m.record_done(lat_ms / 1e3)
    s = m.snapshot()
    assert s["p99_ms"] == pytest.approx(1.0)
    assert s["requests_completed"] == 7


def test_metrics_empty_snapshot_is_unambiguous():
    s = ServeMetrics(clock=FakeClock()).snapshot()
    assert s["p50_ms"] is None and s["batch_occupancy"] is None
    assert s["requests_completed"] == 0 and s["shed_fraction"] == 0.0


# ---------------------------------------------------------------- traffic

def test_rate_schedules_equal_jax():
    from dcnn_tpu.serve import traffic as jtraffic
    from dcnn_tpu_torch.serve import traffic

    pairs = [(traffic.diurnal(400.0, 40.0, 600.0, phase_s=7.0),
              jtraffic.diurnal(400.0, 40.0, 600.0, phase_s=7.0)),
             (traffic.spike(10.0, 100.0, 5.0, 2.0),
              jtraffic.spike(10.0, 100.0, 5.0, 2.0)),
             (traffic.step([(0.0, 5.0), (10.0, 50.0), (20.0, 2.0)]),
              jtraffic.step([(0.0, 5.0), (10.0, 50.0), (20.0, 2.0)]))]
    for mine, ref in pairs:
        for t in np.linspace(0.0, 700.0, 97):
            assert mine(float(t)) == ref(float(t))
    rate = traffic.diurnal(400.0, 40.0, period_s=600.0)
    assert rate(300.0) / rate(0.0) == pytest.approx(10.0)
    for bad in (lambda: traffic.diurnal(10.0, 20.0, period_s=60.0),
                lambda: traffic.step([(1.0, 5.0)]),
                lambda: traffic.spike(0.0, 1.0, 0.0, 1.0)):
        with pytest.raises(ValueError):
            bad()


class _Sink:
    def __init__(self, clock):
        self.clock, self.times = clock, []

    def submit(self, x):
        from concurrent.futures import Future

        self.times.append(self.clock.t)
        f = Future()
        f.set_result(x)
        return f


def test_open_loop_paces_to_the_schedule():
    from dcnn_tpu_torch.serve.traffic import open_loop, step

    fc = FakeClock()
    sink = _Sink(fc)
    open_loop(sink, [np.zeros(4, np.float32)],
              step([(0.0, 10.0), (5.0, 100.0)]), 10.0, clock=fc,
              sleep=fc.advance)
    assert abs(sum(t < 4.99 for t in sink.times) - 50) <= 1
    assert abs(sum(t >= 4.99 for t in sink.times) - 500) <= 1
    fc.t = 0.0
    sink2 = _Sink(fc)
    open_loop(sink2, [np.zeros(4, np.float32)], 20.0, 2.0, clock=fc,
              sleep=fc.advance)
    assert len(sink2.times) == 40
    with pytest.raises(ValueError, match="rounds to zero"):
        open_loop(_Sink(fc), [np.zeros(4, np.float32)],
                  step([(0.0, 10.0), (1.0, float("inf"))]), 5.0, clock=fc,
                  sleep=fc.advance)


def test_open_loop_through_int8_batcher_fake_clock(int8_engine, tiny_cnn):
    """Open-loop single requests through the int8 engine's batcher on a
    fake clock (no real sleeps): every accepted answer equals the engine
    alone; the ones past the queue's capacity are shed, not lost."""
    from dcnn_tpu_torch.serve.traffic import open_loop

    *_, pool = tiny_cnn
    fc = FakeClock()
    b = DynamicBatcher(int8_engine, max_batch=4, queue_capacity=12,
                       clock=fc, start=False)
    futs = open_loop(b, list(pool), 100.0, 0.2, clock=fc, sleep=fc.advance)
    b.drain()
    snap = b.metrics.snapshot()
    assert len(futs) == 12 and snap["requests_shed"] == 8
    for k, f in futs:
        np.testing.assert_array_equal(f.result(timeout=0),
                                      _np(int8_engine.infer(pool[k])))
