"""The port's goodput plane (``dcnn_tpu_torch/obs/goodput.py``,
``obs/anomaly.py``), the twin of the JAX package's
``tests/test_goodput.py``, sleep-free on fake clocks, detectors and
profilers:

- **ledger exactness**: exclusive attribution over a synthetic span set
  (an H2D put under compute is hidden, only the exposed tail is a stall;
  union math never double counts; a fully instrumented window leaves
  ``unattributed ≈ 0``), and a put-dominated wall classifies
  ``feed_bound``;
- **classifier hysteresis**: boundary noise cannot flap the state, a real
  shift flips after ``confirm_windows`` windows;
- **anomaly episodes**: one capture an episode, :func:`suppress` fencing
  expected stalls, the profiler capture through the non-raising
  ``try_trace`` (a ``torch.profiler`` trace) and its busy path counted;
- **/goodput** over a live TelemetryServer; the serving slot goodput of
  ``ServeMetrics`` and the batcher; a streaming epoch's wall attributed;
- **parity**: the same events through both packages' ``attribute`` and
  ``summarize``, the same windows through both classifiers: identical
  outputs;
- **span coverage**: every literal span name under ``dcnn_tpu_torch/``
  is a key of the port's ``SPAN_BUCKETS`` (the JAX package's GP01 lint,
  whose ``analysis/`` is not ported);
- the H100 peak behind ``mfu_live`` and the trainer's wiring of it;
- the bench regression gate (``obs/regress.py``) carrying the
  ``goodput_fraction`` spec, as the JAX package's does.
"""

import json
import os
import urllib.request

import pytest

from dcnn_tpu_torch.obs import MetricsRegistry, TelemetryServer
from dcnn_tpu_torch.obs.anomaly import AnomalyMonitor, EwmaBand, suppress
from dcnn_tpu_torch.obs.goodput import (BUCKETS, SPAN_BUCKETS, STATE_CODES,
                                  BottleneckClassifier, GoodputLedger,
                                  GoodputMonitor, attribute, bucket_of,
                                  classify_window, summarize)
from dcnn_tpu_torch.obs.tracer import Tracer


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ev(name, t0, dur, **args):
    """A Tracer.events()-shaped dict."""
    return {"name": name, "ts_s": t0, "dur_s": dur, "track": "t",
            "args": args}


# ------------------------------------------------------------ attribution

def test_attribute_exclusive_overlap_claim_order():
    """compute 0–1 fully hides the first half of an h2d.put 0.5–1.5;
    only the exposed 0.5 s lands in h2d, and the exposed feed tail in
    feed_stall. Every second attributed exactly once."""
    doc = attribute([
        _ev("train.step", 0.0, 1.0),
        _ev("h2d.put", 0.5, 1.0),       # 0.5 hidden under compute
        _ev("feed.gather", 1.5, 0.5),   # fully exposed
    ])
    assert doc["wall_s"] == pytest.approx(2.0)
    assert doc["buckets"]["compute"] == pytest.approx(1.0)
    assert doc["buckets"]["h2d"] == pytest.approx(0.5)
    assert doc["buckets"]["feed_stall"] == pytest.approx(0.5)
    assert doc["unattributed_s"] == pytest.approx(0.0)
    assert doc["goodput_fraction"] == pytest.approx(0.5)
    # total conservation: buckets + unattributed == wall
    assert (sum(doc["buckets"].values()) + doc["unattributed_s"]
            == pytest.approx(doc["wall_s"]))


def test_attribute_union_never_double_counts():
    """Three overlapping same-bucket spans count their union once."""
    doc = attribute([_ev("feed.gather", 0.0, 1.0),
                     _ev("feed.augment", 0.5, 1.0),
                     _ev("feed.pack", 1.0, 1.0)])
    assert doc["buckets"]["feed_stall"] == pytest.approx(2.0)
    assert doc["attributed_s"] == pytest.approx(2.0)


def test_attribute_structural_spans_excluded():
    """train.epoch is a container: its children carry the time, the
    envelope itself must not double-attribute (or widen the extent)."""
    doc = attribute([_ev("train.epoch", 0.0, 10.0),
                     _ev("train.step", 1.0, 2.0)])
    assert doc["wall_s"] == pytest.approx(2.0)   # extent = the step span
    assert doc["buckets"]["compute"] == pytest.approx(2.0)
    assert doc["unattributed_s"] == pytest.approx(0.0)


def test_attribute_window_clipping():
    doc = attribute([_ev("train.step", 0.0, 10.0)], t0=4.0, t1=6.0)
    assert doc["wall_s"] == pytest.approx(2.0)
    assert doc["buckets"]["compute"] == pytest.approx(2.0)
    # and a gap the spans don't cover is unattributed, not invented
    doc = attribute([_ev("train.step", 0.0, 1.0)], t0=0.0, t1=4.0)
    assert doc["unattributed_s"] == pytest.approx(3.0)
    assert doc["goodput_fraction"] == pytest.approx(0.25)


def test_bench_r05_shape_classifies_feed_bound():
    """The r5 capture: 8.1 s of exposed put against a 0.7 s step in an
    8.8 s wall — the ledger must call it feed-bound (acceptance)."""
    doc = summarize([_ev("h2d.put", 0.0, 8.1),
                     _ev("train.step", 8.1, 0.7)], t0=0.0, t1=8.8)
    assert doc["verdict"] == "feed_bound"
    assert doc["buckets"]["h2d"] == pytest.approx(8.1)


def test_classify_window_rule_order():
    def doc(**b):
        buckets = {k: 0.0 for k in BUCKETS}
        buckets.update(b)
        return {"wall_s": 10.0, "buckets": buckets}
    assert classify_window(doc(compute=9.0)) == "compute_bound"
    assert classify_window(doc(compile=4.0, compute=6.0)) == "compile_bound"
    assert classify_window(doc(feed_stall=3.0, h2d=2.5)) == "feed_bound"
    assert classify_window(doc(checkpoint=3.0, recovery=2.5)) == "io_bound"
    assert classify_window(doc(compute=3.0)) == "healthy"
    assert classify_window({"wall_s": 0.0, "buckets": {}}) == "healthy"


def test_bucket_of_globs_and_unknown():
    assert bucket_of("train.step") == "compute"
    assert bucket_of("nobody.knows.this") is None
    assert bucket_of("demo.9", {"demo.*": "compute"}) == "compute"


def test_span_buckets_values_are_buckets():
    """Every non-None value in the normative table is a real bucket."""
    assert set(v for v in SPAN_BUCKETS.values() if v is not None) <= \
        set(BUCKETS)


# ------------------------------------------------------------- classifier

def _window(wall, **b):
    buckets = {k: 0.0 for k in BUCKETS}
    buckets.update(b)
    return {"wall_s": wall, "buckets": buckets}


class RecordingStore:
    def __init__(self):
        self.series = {}

    def add(self, name, value, **kw):
        self.series.setdefault(name, []).append(value)


def test_classifier_boundary_noise_does_not_flap():
    """Feed fraction oscillating 0.48↔0.55 around the 0.50 entry: once
    feed-bound, the exit margin (0.50 − 0.15) holds the state."""
    c = BottleneckClassifier(confirm_windows=2)
    for _ in range(2):
        c.observe(_window(10.0, feed_stall=5.5, compute=4.5))
    assert c.state == "feed_bound" and c.flips == 1
    for frac in (4.8, 5.5, 4.6, 5.2, 4.8):   # noise inside the band
        c.observe(_window(10.0, feed_stall=frac, compute=10.0 - frac))
    assert c.state == "feed_bound" and c.flips == 1


def test_classifier_real_shift_flips_after_confirm_windows():
    flips = []
    store = RecordingStore()
    c = BottleneckClassifier(store=store, confirm_windows=3,
                             on_change=lambda o, n: flips.append((o, n)))
    for _ in range(3):
        c.observe(_window(10.0, feed_stall=7.0, compute=3.0))
    assert c.state == "feed_bound"
    # genuinely compute-dominated now: feed drops below 0.35 exit line
    for i in range(3):
        c.observe(_window(10.0, compute=9.0, feed_stall=1.0))
        if i < 2:
            assert c.state == "feed_bound"   # still dwelling
    assert c.state == "compute_bound"
    assert flips == [("healthy", "feed_bound"),
                     ("feed_bound", "compute_bound")]
    # tsdb series: the state code plus the 0/1 per-state series the
    # shipped alert rules consume
    assert store.series["goodput_bottleneck_state"][-1] == \
        float(STATE_CODES["compute_bound"])
    assert store.series["goodput_bottleneck_compute_bound"][-1] == 1.0
    assert store.series["goodput_bottleneck_feed_bound"][-1] == 0.0


def test_classifier_interrupted_streak_resets_dwell():
    c = BottleneckClassifier(confirm_windows=2)
    c.observe(_window(10.0, feed_stall=7.0, compute=3.0))
    c.observe(_window(10.0, compute=3.0))              # healthy interlude
    c.observe(_window(10.0, feed_stall=7.0, compute=3.0))
    assert c.state == "healthy"                        # streak broken
    c.observe(_window(10.0, feed_stall=7.0, compute=3.0))
    assert c.state == "feed_bound"


# ---------------------------------------------------------------- ledger

def _make_tracer(clock):
    return Tracer(capacity=4096, clock=clock, enabled=True)


def test_ledger_snapshot_publishes_gauges():
    clock = FakeClock(100.0)
    tr = _make_tracer(clock)          # epoch = 100.0
    reg = MetricsRegistry()
    led = GoodputLedger(tracer=tr, registry=reg)
    tr.record_span("train.step", 100.0, 101.0)
    tr.record_span("h2d.put", 101.0, 101.5, bytes=5 * 10**9)
    clock.t = 102.0
    doc = led.snapshot(t0=0.0, t1=2.0, publish=True)
    snap = reg.snapshot()
    assert snap["goodput_fraction"] == pytest.approx(0.5)
    assert snap["goodput_wall_seconds"] == pytest.approx(2.0)
    assert snap["goodput_compute_seconds"] == pytest.approx(1.0)
    assert snap["goodput_h2d_seconds"] == pytest.approx(0.5)
    assert snap["goodput_unattributed_seconds"] == pytest.approx(0.5)
    # live bandwidth over the put union: 5 GB in 0.5 s = 10 GB/s
    assert snap["goodput_h2d_gbps"] == pytest.approx(10.0)
    assert doc["steps"] == pytest.approx(1.0)
    # no model costs wired -> the gauge is absent, not a lying 0.0
    assert "mfu_live" not in snap and doc["mfu_live"] is None


def test_ledger_trailing_window_and_abs_anchor():
    clock = FakeClock(50.0)
    tr = _make_tracer(clock)
    led = GoodputLedger(tracer=tr, registry=MetricsRegistry())
    tr.record_span("train.step", 50.0, 51.0)    # rel 0..1
    tr.record_span("train.step", 58.0, 59.0)    # rel 8..9
    clock.t = 60.0
    # trailing 5 s window ending "now" (rel 10): only the second step
    doc = led.snapshot(window_s=5.0)
    assert doc["buckets"]["compute"] == pytest.approx(1.0)
    assert doc["wall_s"] == pytest.approx(5.0)
    # clock-domain anchor (an epoch-start perf_counter stamp)
    doc = led.snapshot(t0_abs=50.0)
    assert doc["wall_s"] == pytest.approx(10.0)
    assert doc["buckets"]["compute"] == pytest.approx(2.0)


def test_ledger_mfu_live_and_chunk_steps():
    clock = FakeClock(0.0)
    tr = _make_tracer(clock)
    reg = MetricsRegistry()
    led = GoodputLedger(tracer=tr, registry=reg)
    led.set_model_costs(flops_per_sample=1e9, peak_tflops=1.0,
                        samples_per_step=100.0)
    # a chunk span covering 10 inner steps in 2 s -> 5 steps/s
    tr.record_span("train.chunk", 0.0, 2.0, steps=10)
    clock.t = 2.0
    doc = led.snapshot(t0=0.0, t1=2.0, publish=True)
    assert doc["steps"] == pytest.approx(10.0)
    assert doc["step_rate"] == pytest.approx(5.0)
    # 5 steps/s × 100 samples × 1e9 flops = 5e11 flop/s vs 1e12 peak
    assert doc["mfu_live"] == pytest.approx(0.5)
    assert reg.snapshot()["mfu_live"] == pytest.approx(0.5)


# --------------------------------------------------------------- anomaly

class FakeFlight:
    def __init__(self, path="/tmp/bundle"):
        self.calls = []
        self.path = path

    def record(self, trigger, **kw):
        self.calls.append((trigger, kw))
        return self.path


class FakeProfileCM:
    def __init__(self, log):
        self.log = log

    def __enter__(self):
        self.log.append("enter")
        return "/tmp/prof"

    def __exit__(self, *exc):
        self.log.append("exit")
        return False


def _anomaly(flight=None, profiler=None, **kw):
    kw.setdefault("detector", EwmaBand(warmup=4, min_rel=0.5))
    return AnomalyMonitor(registry=MetricsRegistry(),
                          flight=flight if flight is not None
                          else FakeFlight(),
                          profiler=profiler, **kw)


def test_ewma_band_warmup_and_regression_does_not_learn():
    band = EwmaBand(warmup=4, min_rel=0.5, band=3.0)
    assert band.threshold() is None
    for _ in range(4):
        assert band.observe(1.0) is False     # warmup never breaches
    thr = band.threshold()
    assert thr == pytest.approx(1.5)          # rel floor dominates
    mean_before = band.mean
    for _ in range(10):
        assert band.observe(5.0) is True      # sustained regression
    assert band.mean == pytest.approx(mean_before)  # band didn't learn it


def test_anomaly_exactly_one_capture_per_episode():
    log = []
    flight = FakeFlight()
    mon = _anomaly(flight=flight, profiler=lambda d: FakeProfileCM(log),
                   profile_steps=2, recover_samples=3)
    for _ in range(4):
        assert mon.observe_step(1.0) is False
    # sustained 9x regression: first sample opens THE episode
    assert mon.observe_step(9.0) is True
    for _ in range(5):
        assert mon.observe_step(9.0) is False   # same episode, no refire
    st = mon.stats()
    assert st["episodes"] == 1 and st["captures"] == 1
    assert len(flight.calls) == 1
    trigger, kw = flight.calls[0]
    assert trigger == "goodput_anomaly"
    assert kw["extra"]["trigger_kind"] == "step_time_breach"
    # profile entered on capture, closed after profile_steps further steps
    assert log == ["enter", "exit"]
    # recovery closes the episode; the NEXT breach is a new one
    for _ in range(3):
        mon.observe_step(1.0)
    assert mon.observe_step(9.0) is True
    assert mon.stats()["episodes"] == 2 and len(flight.calls) == 2


def test_anomaly_recovery_requires_consecutive_in_band():
    mon = _anomaly(profiler=lambda d: None, recover_samples=3)
    for _ in range(4):
        mon.observe_step(1.0)
    mon.observe_step(9.0)
    # 2 ok, then a breach: streak resets, episode stays open
    mon.observe_step(1.0)
    mon.observe_step(1.0)
    assert mon.observe_step(9.0) is False
    assert mon.stats()["episodes"] == 1


def test_anomaly_ledger_snapshot_rides_the_bundle():
    flight = FakeFlight()
    mon = _anomaly(flight=flight, profiler=lambda d: None)
    for _ in range(4):
        mon.observe_step(1.0)
    mon.observe_step(9.0, ledger_doc={"wall_s": 30.0, "bottleneck": "x"})
    assert flight.calls[0][1]["extra"]["ledger"]["wall_s"] == 30.0


def test_anomaly_suppress_fences_expected_stalls():
    mon = _anomaly(profiler=lambda d: None)
    for _ in range(4):
        mon.observe_step(1.0)
    mean_before = mon.detector.mean
    with suppress():
        with suppress():                      # re-entrant
            for _ in range(10):
                assert mon.observe_step(50.0) is False
        assert mon.observe_step(50.0) is False
    assert mon.stats()["episodes"] == 0
    assert mon.detector.mean == pytest.approx(mean_before)
    # fence lifted: the same sample now opens an episode
    assert mon.observe_step(50.0) is True


def test_anomaly_profiler_busy_counted_not_raised():
    reg = MetricsRegistry()
    mon = AnomalyMonitor(registry=reg, flight=FakeFlight(),
                         detector=EwmaBand(warmup=2),
                         profiler=lambda d: None)   # always busy
    mon.observe_step(1.0)
    mon.observe_step(1.0)
    mon.observe_step(9.0)
    assert reg.snapshot()["goodput_capture_profile_skipped_total"] == 1
    assert reg.snapshot()["goodput_anomaly_episodes_total"] == 1


def test_anomaly_flip_capture_and_opt_out():
    flight = FakeFlight()
    mon = _anomaly(flight=flight, profiler=lambda d: None)
    mon.on_classification_flip("healthy", "feed_bound",
                               ledger_doc={"wall_s": 1.0})
    assert len(flight.calls) == 1
    assert flight.calls[0][1]["extra"]["detail"]["transition"] == \
        "healthy->feed_bound"
    quiet = _anomaly(flight=FakeFlight(), profiler=lambda d: None,
                     flip_captures=False)
    quiet.on_classification_flip("healthy", "feed_bound")
    assert quiet.stats()["episodes"] == 0


def test_anomaly_close_exits_open_profile():
    log = []
    mon = _anomaly(profiler=lambda d: FakeProfileCM(log),
                   profile_steps=100)
    for _ in range(4):
        mon.observe_step(1.0)
    mon.observe_step(9.0)
    assert log == ["enter"]
    mon.close()
    assert log == ["enter", "exit"]


# ------------------------------------------------------------- try_trace

def test_try_trace_claim_and_busy_counter(tmp_path):
    """The port's ``try_trace``: a ``torch.profiler`` capture (on the CPU
    here) written as ``trace.json`` under its own subdirectory; while it
    holds the slot a second claim returns None (counted) and ``trace``
    raises."""
    from dcnn_tpu_torch.obs import get_registry
    from dcnn_tpu_torch.train import profiling
    busy0 = get_registry().snapshot().get("profiler_trace_busy_total", 0)
    cm = profiling.try_trace(str(tmp_path))
    assert cm is not None                     # claim taken at call time
    with cm as path:
        # slot held: the concurrent claim loses politely
        assert profiling.try_trace(str(tmp_path)) is None
        with pytest.raises(RuntimeError):
            profiling.trace(str(tmp_path))    # raising form still raises
    assert os.path.isfile(os.path.join(path, "trace.json"))
    assert get_registry().snapshot()["profiler_trace_busy_total"] == \
        busy0 + 1
    # released on exit: the next claim wins again
    cm2 = profiling.try_trace(str(tmp_path))
    assert cm2 is not None
    with cm2 as path:
        assert str(tmp_path) in path


# ------------------------------------------------- monitor + /goodput

def test_monitor_poll_flip_feeds_anomaly_and_endpoint():
    clock = FakeClock(0.0)
    tr = _make_tracer(clock)
    reg = MetricsRegistry()
    store = RecordingStore()
    flight = FakeFlight()
    anomaly = AnomalyMonitor(registry=reg, flight=flight,
                             detector=EwmaBand(warmup=4),
                             profiler=lambda d: None)
    mon = GoodputMonitor(tracer=tr, registry=reg, store=store,
                         window_s=10.0, anomaly=anomaly,
                         classifier=BottleneckClassifier(
                             store=store, confirm_windows=1))
    tr.record_span("h2d.put", 0.0, 8.0)
    clock.t = 10.0
    doc = mon.poll()
    assert doc["bottleneck"] == "feed_bound"
    assert reg.snapshot()["goodput_bottleneck_state"] == \
        float(STATE_CODES["feed_bound"])
    # the confirmed flip fired one anomaly capture through the chain
    assert len(flight.calls) == 1
    assert flight.calls[0][1]["extra"]["trigger_kind"] == "bottleneck_flip"

    srv = TelemetryServer(registry=reg, port=0)
    mon.attach(srv)
    srv.start()
    try:
        with urllib.request.urlopen(srv.url + "/goodput", timeout=10) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
    assert body["window_s"] == 10.0
    assert body["bottleneck"]["state"] == "feed_bound"
    assert body["bottleneck"]["confirm_windows"] == 1
    assert set(body["ledger"]["buckets"]) == set(BUCKETS)
    assert body["anomaly"]["episodes"] == 1
    mon.close()


def test_monitor_observe_step_routes_to_detector():
    reg = MetricsRegistry()
    anomaly = AnomalyMonitor(registry=reg, flight=FakeFlight(),
                             detector=EwmaBand(warmup=2),
                             profiler=lambda d: None)
    mon = GoodputMonitor(tracer=Tracer(clock=FakeClock(), enabled=True),
                         registry=reg, window_s=1.0, anomaly=anomaly)
    mon.observe_step(1.0)
    mon.observe_step(1.0)
    mon.observe_step(9.0)
    assert anomaly.stats()["episodes"] == 1


# ------------------------------------------------------ shipped alerts

def test_goodput_alert_rules_fire_on_sustained_feed_bound():
    from dcnn_tpu_torch.obs.rules import RuleEngine, goodput_alert_rules
    from dcnn_tpu_torch.obs.tsdb import TimeSeriesStore
    clock = FakeClock(1000.0)
    store = TimeSeriesStore(clock=clock)
    engine = RuleEngine(store, registry=MetricsRegistry(),
                        flight=FakeFlight(), clock=clock)
    for rule in goodput_alert_rules(window_s=60.0, for_s=30.0):
        engine.add_alert(rule)
    # classifier holding feed-bound: 0/1 series pinned at 1 long enough
    for _ in range(8):
        store.add("goodput_bottleneck_feed_bound", 1.0)
        store.add("goodput_bottleneck_compile_bound", 0.0)
        store.add("goodput_fraction", 0.9)
        engine.evaluate()
        clock.advance(10.0)
    assert engine.firing() == ["goodput_feed_bound_sustained"]
    # a single healthy window resolves it (min_over_time drops below 1)
    store.add("goodput_bottleneck_feed_bound", 0.0)
    engine.evaluate()
    assert engine.firing() == []


# ------------------------------------------------- serving slot goodput

def test_serve_metrics_slot_occupancy_decomposition():
    from dcnn_tpu_torch.serve.metrics import ServeMetrics
    clock = FakeClock(0.0)
    m = ServeMetrics(clock=clock)
    assert m.snapshot()["slot_goodput"] is None   # no data != 100% idle
    m.record_slot_state("idle")
    clock.advance(3.0)
    m.record_slot_state("occupied")
    clock.advance(6.0)
    m.record_slot_state("draining")
    clock.advance(1.0)
    s = m.snapshot()
    assert s["slot_state"] == "draining"
    # the OPEN draining interval is credited too: 3 + 6 + 1 = 10
    assert s["slot_seconds"] == pytest.approx(
        {"idle": 3.0, "occupied": 6.0, "draining": 1.0})
    assert s["slot_goodput"] == pytest.approx(0.6)
    with pytest.raises(ValueError):
        m.record_slot_state("on_fire")

    def scalar(text, name):
        line = [l for l in text.splitlines()
                if l.startswith(name + " ")][0]
        return float(line.split()[-1])
    text = m.prometheus()
    assert scalar(text, "serve_slot_goodput") == pytest.approx(0.6)
    assert scalar(text, "serve_slot_occupied_seconds_total") == \
        pytest.approx(6.0)
    assert scalar(text, "serve_slot_idle_seconds_total") == \
        pytest.approx(3.0)


class SlotFakeEngine:
    """Batcher-compatible engine without a model (tests/test_router
    idiom)."""

    input_shape = (4,)
    max_batch = 8
    bucket_sizes = [1, 2, 4, 8]
    name = "slotfake"
    batch_invariant = True

    def bucket_for(self, n):
        for b in self.bucket_sizes:
            if b >= n:
                return b
        raise ValueError(n)

    def pad_to_bucket(self, x):
        import numpy as np
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        b = self.bucket_for(n)
        if b > n:
            x = np.concatenate([x, np.zeros((b - n, 4), np.float32)])
        return x, n

    def run_padded(self, x):
        import torch
        return torch.as_tensor(x)  # the port's engines return tensors

    def warm(self):
        return {}


def test_batcher_marks_slot_states_over_lifecycle():
    # start=False + step(): the occupied->idle transition happens
    # synchronously under the test's control (the threaded loop flips
    # back to idle the instant a batch completes — unobservable reliably)
    import numpy as np
    from dcnn_tpu_torch.serve.batcher import DynamicBatcher
    b = DynamicBatcher(SlotFakeEngine(), max_wait_ms=1.0, start=False)
    assert b.metrics.snapshot()["slot_state"] == "idle"   # from birth
    fut = b.submit(np.ones((1, 4), np.float32))
    assert b.step() == 1
    fut.result(timeout=10)
    snap = b.metrics.snapshot()
    assert snap["slot_state"] == "idle"       # batch done, slot free
    assert snap["slot_seconds"]["occupied"] > 0.0
    b.shutdown()
    assert b.metrics.snapshot()["slot_state"] == "draining"


# ------------------------------------------- live streaming attribution

def test_streaming_run_attributes_wall_time():
    """Acceptance: an instrumented streaming epoch's span extent is
    ≥ 95% attributed — the feed/transfer/step spans cover the wall."""
    import numpy as np
    import torch
    from dcnn_tpu_torch.data import StreamingDeviceDataset, make_shard_step, \
        train_streaming_epoch
    from dcnn_tpu_torch.nn.builder import SequentialBuilder
    from dcnn_tpu_torch.obs import configure, get_tracer
    from dcnn_tpu_torch.ops.losses import softmax_cross_entropy
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.train.trainer import create_train_state

    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, size=(512, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, 10, size=512).astype(np.int64)
    model = (SequentialBuilder(name="gp_cnn", data_format="NHWC")
             .input((28, 28, 1))
             .conv2d(16, 3, padding=1).activation("relu")
             .flatten().dense(10).build())
    opt = SGD(0.05)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(0),
                            device="cpu")
    ds = StreamingDeviceDataset(x, y, 10, batch_size=32, shard_batches=4)
    step = make_shard_step(model, softmax_cross_entropy, opt,
                           num_classes=10, batch_size=32, shard_batches=4)
    t = configure(enabled=True)
    t.clear()
    try:
        train_streaming_epoch(step, ts, ds, 1, 0.05)
        doc = attribute(get_tracer().events())
    finally:
        configure(enabled=False)
        t.clear()  # the global buffer: later tests assert it empty
    assert doc["wall_s"] > 0
    assert doc["unattributed_s"] < 0.05 * doc["wall_s"], doc


# ----------------------------------------------------- span coverage

def _literal_span_names(root):
    """Every literal span name the package records: the first argument of
    ``.span(...)``, ``.begin(...)`` and ``.record_span(...)`` calls, by
    file; and the span calls whose name is not a literal."""
    import ast

    names, dynamic = {}, []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("span", "begin",
                                               "record_span")
                        and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.setdefault(arg.value, []).append(path)
                elif (isinstance(arg, ast.JoinedStr)
                      or node.func.attr != "begin"):
                    # .begin(ts, lr) of a train step is no span
                    dynamic.append(f"{path}:{node.lineno}")
    return names, dynamic


def test_span_coverage_every_literal_span_is_mapped():
    """The port's stand-in for the JAX package's GP01 lint: every literal
    span name under ``dcnn_tpu_torch/`` is a key of ``SPAN_BUCKETS`` (a
    new span cannot silently become ``unattributed``), and a call whose
    name is not a literal is only the tracer's own plumbing."""
    import dcnn_tpu_torch

    root = os.path.dirname(dcnn_tpu_torch.__file__)
    names, dynamic = _literal_span_names(root)
    assert len(names) >= 30  # the scan sees the package's spans
    unmapped = {n: p for n, p in names.items()
                if n not in SPAN_BUCKETS and bucket_of(n) is None
                and "." in n}
    assert not unmapped, unmapped
    assert all(os.path.join("obs", "tracer.py") in d
               or os.path.join("obs", "flight.py") in d
               for d in dynamic), dynamic


def test_span_table_is_the_jax_packages():
    """The bucket names, their claim order, the classifier's states and
    the span table are the JAX package's, key for key."""
    from dcnn_tpu.obs import goodput as jg

    from dcnn_tpu_torch.obs import goodput as pg

    assert pg.BUCKETS == jg.BUCKETS and pg.CLAIM_ORDER == jg.CLAIM_ORDER
    assert pg.STATES == jg.STATES and pg.STATE_CODES == jg.STATE_CODES
    assert pg.SPAN_BUCKETS == jg.SPAN_BUCKETS


def test_regress_gate_carries_goodput_fraction_spec():
    """The port's bench gate knows the metric, at the wide tolerance a
    scheduling-noisy fraction needs, spec for spec the JAX gate's;
    captures without the path are skipped, not failed."""
    from dcnn_tpu.obs.regress import DEFAULT_METRICS as JAX_METRICS

    from dcnn_tpu_torch.obs.regress import DEFAULT_METRICS, compare

    spec = {m.name: m for m in DEFAULT_METRICS}["goodput_fraction"]
    assert spec.path == "telemetry_essentials.goodput.goodput_fraction"
    assert spec.higher_is_better and spec.tolerance == 0.25
    jax_spec = {m.name: m for m in JAX_METRICS}["goodput_fraction"]
    assert (spec.path, spec.higher_is_better, spec.tolerance, spec.guard,
            spec.fallback, spec.atol) == (
        jax_spec.path, jax_spec.higher_is_better, jax_spec.tolerance,
        jax_spec.guard, jax_spec.fallback, jax_spec.atol)
    cap = {"telemetry_essentials": {"goodput": {"goodput_fraction": 0.9}}}
    rows = {r["metric"]: r for r in compare([{"value": 1.0}, cap])["metrics"]}
    assert rows["goodput_fraction"]["verdict"].startswith("skipped")


# ------------------------------------------------------------- parity

def _random_events(seed, n=60):
    """A random span stream over every bucket, structural spans and
    unknown names included, with overlaps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = sorted(SPAN_BUCKETS) + ["nobody.knows", "train.epoch"]
    evs = []
    for _ in range(n):
        t0 = float(rng.uniform(0.0, 20.0))
        evs.append(_ev(names[int(rng.integers(len(names)))], t0,
                       float(rng.exponential(0.8)),
                       bytes=int(rng.integers(0, 10**8))))
    evs.append({"name": "train.step", "ts_s": 1.0, "dur_s": None,
                "track": "t", "args": {}})  # an instant: no duration
    return evs


@pytest.mark.parametrize("seed,window", [(0, None), (1, None),
                                         (2, (3.0, 11.0)), (3, (0.0, 40.0))])
def test_attribute_and_summarize_parity_with_jax(seed, window):
    """The same event list through both packages' ``attribute`` and
    ``summarize``: identical documents (every bucket second, the
    unattributed residue, the fraction and the verdict)."""
    from dcnn_tpu.obs import goodput as jg

    evs = _random_events(seed)
    kw = {} if window is None else {"t0": window[0], "t1": window[1]}
    assert attribute(evs, **kw) == jg.attribute(evs, **kw)
    assert summarize(evs, **kw) == jg.summarize(evs, **kw)


def test_classifier_parity_with_jax():
    """The same window stream (noise around every entry threshold, real
    shifts) through both packages' classifiers: the same state after each
    window, the same flips, the same tsdb series."""
    import numpy as np

    from dcnn_tpu.obs import goodput as jg

    rng = np.random.default_rng(5)
    flips_p, flips_j = [], []
    sp, sj = RecordingStore(), RecordingStore()
    cp = BottleneckClassifier(store=sp, confirm_windows=2,
                              on_change=lambda o, n: flips_p.append((o, n)))
    cj = jg.BottleneckClassifier(
        store=sj, confirm_windows=2,
        on_change=lambda o, n: flips_j.append((o, n)))
    for i in range(200):
        regime = (i // 25) % len(BUCKETS)
        w = {b: float(rng.uniform(0.0, 1.0)) for b in BUCKETS}
        w[BUCKETS[regime]] += float(rng.uniform(3.0, 9.0))
        doc = _window(float(sum(w.values()) + rng.uniform(0, 2)), **w)
        assert cp.observe(doc) == cj.observe(doc)
    assert flips_p == flips_j and len(flips_p) > 3
    assert sp.series == sj.series


def test_anomaly_parity_with_jax():
    """The same step-wall stream (warm-up, noise, a sustained regression,
    recovery, another breach) through both packages' anomaly monitors:
    the same episode openings, thresholds and stats."""
    import numpy as np

    from dcnn_tpu.obs import anomaly as ja

    rng = np.random.default_rng(9)
    walls = list(rng.normal(1.0, 0.05, 30)) + [4.0] * 10 \
        + list(rng.normal(1.0, 0.05, 10)) + [5.0] * 3
    fp, fj = FakeFlight(), FakeFlight()
    mp = AnomalyMonitor(registry=MetricsRegistry(), flight=fp,
                        profiler=lambda d: None)
    mj = ja.AnomalyMonitor(registry=MetricsRegistry(), flight=fj,
                           profiler=lambda d: None)
    for w in walls:
        assert mp.observe_step(w) == mj.observe_step(w)
        assert mp.detector.threshold() == mj.detector.threshold()
    assert mp.stats() == mj.stats()
    assert mp.stats()["episodes"] == 2
    assert [c[1]["extra"] for c in fp.calls] == \
        [c[1]["extra"] for c in fj.calls]


# -------------------------------------------------------- mfu_live

@pytest.mark.parametrize("name,dtype,tf32,want", [
    ("NVIDIA H100 80GB HBM3", "float32", False, 67.0),
    ("NVIDIA H100 80GB HBM3", "float32", True, 495.0),
    ("NVIDIA H100 80GB HBM3", "bfloat16", False, 989.0),
    ("NVIDIA H100 80GB HBM3", "float64", False, None),
    ("NVIDIA A100-SXM4-80GB", "bfloat16", False, None)])
def test_peak_tflops_is_the_h100s(name, dtype, tf32, want):
    """``mfu_live``'s peak: an H100's dense figure for the step's dtype
    (``PERF.md``'s "Device" row), and None for any other dtype or card,
    so that the gauge stays absent rather than wrong."""
    from dcnn_tpu_torch.obs.xla import peak_tflops

    assert peak_tflops(dtype, name, tf32=tf32) == want


def test_trainer_mfu_costs(monkeypatch):
    """The trainer hands the monitor 3 x the model's forward FLOPs a
    sample and the H100's fp32 peak on an H100; nothing on the CPU."""
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.nn import SequentialBuilder as PortBuilder
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.train import Trainer

    model = (PortBuilder("mfu").input((1, 8, 8)).conv2d(2, 3, 1, 1)
             .flatten().dense(10).build()).init(device="cpu")
    tr = Trainer(model, Adam(), "softmax_crossentropy",
                 TrainingConfig(device_type="cpu"))
    assert tr._mfu_costs() == {}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    tr.device = torch.device("cuda")
    assert tr._mfu_costs() == {
        "flops_per_sample": 3.0 * model.forward_complexity(),
        "peak_tflops": 67.0}


def test_trainer_observes_every_step(monkeypatch):
    """With ``metrics_port`` the per-batch loop hands the goodput monitor
    one step wall a batch (taken around the span that ends on the loss
    read), and the plane is torn down after the fit."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data.loader import ArrayDataLoader
    from dcnn_tpu_torch.nn import SequentialBuilder as PortBuilder
    from dcnn_tpu_torch.obs import goodput as pg
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.train import Trainer, create_train_state

    walls = []
    monkeypatch.setattr(pg.GoodputMonitor, "observe_step",
                        lambda self, dt: walls.append(dt))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 1, 8, 8)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 12)]
    model = (PortBuilder("obs_steps").input((1, 8, 8)).conv2d(2, 3, 1, 1)
             .activation("relu").flatten().dense(10).build())
    tr = Trainer(model, Adam(1e-3), "softmax_crossentropy",
                 TrainingConfig(epochs=2, snapshot_dir=None, metrics_port=0,
                                progress_interval=0, device_type="cpu"))
    ts = create_train_state(model, Adam(1e-3),
                            torch.Generator().manual_seed(0), device="cpu")
    tr.fit(ts, ArrayDataLoader(x, y, batch_size=4, shuffle=True))
    assert len(walls) == 6 and all(w > 0 for w in walls)
    assert tr.telemetry is None and tr._goodput is None


def test_flip_capture_profiles_on_the_observing_thread():
    """The port's departures from the JAX monitor: a flip (seen on the
    sampler's thread) writes its bundle at once and opens its profiler
    capture at the next observed step, on the training thread; the sample
    after the flip, the samples under the monitor's own capture and the
    one after it closes are dropped (a capture's cost opens no second
    episode), and the band resumes after that."""
    import threading

    log, threads = [], []

    class CM(FakeProfileCM):
        def __enter__(self):
            threads.append(threading.get_ident())
            return super().__enter__()

    flight = FakeFlight()
    mon = _anomaly(flight=flight, profiler=lambda d: CM(log),
                   profile_steps=3)
    for _ in range(4):
        mon.observe_step(1.0)
    t = threading.Thread(target=mon.on_classification_flip,
                         args=("compute_bound", "feed_bound"))
    t.start()
    t.join()
    assert len(flight.calls) == 1 and log == []  # bundle now, no profile
    assert mon.observe_step(50.0) is False       # beside the flip: dropped
    assert log == ["enter"] and threads == [threading.get_ident()]
    for _ in range(3):                           # under the capture
        assert mon.observe_step(50.0) is False
    assert log == ["enter", "exit"]
    assert mon.observe_step(50.0) is False       # after the export: dropped
    assert mon.stats()["episodes"] == 1 and len(flight.calls) == 1
    assert mon.detector.mean == pytest.approx(1.0)
    assert mon.observe_step(50.0) is True        # the band is live again
    assert len(flight.calls) == 2


def test_windows_over_a_capture_are_not_classified():
    """A goodput window that overlaps the anomaly monitor's own capture
    (a profile pending or open, or closed less than a window ago) is
    published but not classified: the capture's stall, unattributed
    time, cannot flip the verdict into a second capture. Quiet again a
    window after the capture ends, the classifier resumes."""
    clock = FakeClock(0.0)
    tr = _make_tracer(clock)
    reg = MetricsRegistry()
    flight = FakeFlight()
    anomaly = AnomalyMonitor(registry=reg, flight=flight,
                             detector=EwmaBand(warmup=4),
                             profiler=lambda d: FakeProfileCM([]),
                             profile_steps=2, clock=clock)
    mon = GoodputMonitor(tracer=tr, registry=reg, window_s=10.0,
                         anomaly=anomaly,
                         classifier=BottleneckClassifier(confirm_windows=1))
    assert anomaly.quiet_for(10.0)
    tr.record_span("h2d.put", 0.0, 8.0)
    clock.t = 10.0
    assert mon.poll()["bottleneck"] == "feed_bound"  # the flip, captured
    assert len(flight.calls) == 1 and not anomaly.quiet_for(10.0)
    clock.t = 30.0                     # the loop stalled: nothing recorded
    assert mon.poll()["bottleneck"] == "feed_bound"  # held, not classified
    for _ in range(4):                 # the profile opens, runs and closes
        anomaly.observe_step(1.0)
    assert not anomaly.stats()["profile_open"]
    assert not anomaly.quiet_for(10.0)  # closed less than a window ago
    assert mon.poll()["bottleneck"] == "feed_bound"
    clock.t = 40.0
    assert anomaly.quiet_for(10.0)
    assert mon.poll()["bottleneck"] == "healthy"     # classified again
    assert len(flight.calls) == 2 and mon.classifier.flips == 2
