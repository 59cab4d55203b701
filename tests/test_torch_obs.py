"""The port's observability core against the JAX package's, on the CPU.

- the registry, and its Prometheus text byte for byte the JAX renderer's
  for the same calls (plain registry, ``ServeMetrics``, ``DecodeMetrics``,
  histograms included), ``parse_prometheus_text`` round trips;
- the tracer: exact timestamps on a fake clock, ids and context
  propagation (``inject``/``activate``), JSONL and Chrome exports, the
  ring buffer's saturation gauges, the disabled no-op path;
- the span names, tracks and attribute keys of a narrow ``Trainer.fit``
  (host loader, chunked ``PrefetchLoader``, resident ``DeviceDataset``), of
  a ``DynamicBatcher`` run and of a ``ContinuousBatcher`` run, equal to the
  JAX package's for the same loop;
- ``LayerProfiler``'s layer names and call counts against the JAX
  profiler's on a narrow CNN, the profiled fit bit-identical to the plain
  one, ``profiling.trace`` over ``torch.profiler``;
- ``hard_fence``, debug mode (``FloatingPointError`` on a NaN batch in both
  packages, ``checked`` naming the layer), the flight recorder's
  ``nonfinite_guard`` and ``watchdog_stall`` bundles, ``utils/env`` and
  ``resilience/retry`` against their JAX twins.

No test asserts a wall-clock bound: fake clocks and injected ``clock=``
drive every timestamp that is checked.
"""

import json
import math
import os
import random
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu import obs as jobs
from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.data import ArrayDataLoader as JaxLoader
from dcnn_tpu.data import DeviceDataset as JaxDeviceDataset
from dcnn_tpu.data import PrefetchLoader as JaxPrefetch
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch import obs
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import ArrayDataLoader, DeviceDataset, PrefetchLoader
from dcnn_tpu_torch.interop import from_jax
from dcnn_tpu_torch.obs import MetricsRegistry
from dcnn_tpu_torch.obs.exposition import parse_prometheus_text
from dcnn_tpu_torch.obs.tracer import _NULL_SPAN, Tracer
from dcnn_tpu_torch.optim import SGD
from dcnn_tpu_torch.train import Trainer, create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = "softmax_crossentropy"
_ID_KEYS = ("trace_id", "span_id", "parent_id")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def tracers():
    """Both packages' process-global tracers enabled and empty for one
    test, disabled and emptied afterwards."""
    mine, theirs = obs.configure(enabled=True), jobs.configure(enabled=True)
    mine.clear()
    theirs.clear()
    yield mine, theirs
    obs.configure(enabled=False)
    jobs.configure(enabled=False)
    mine.clear()
    theirs.clear()


def _user_args(ev):
    return {k: v for k, v in ev["args"].items() if k not in _ID_KEYS}


def _shapes(events, prefixes=None):
    """The set of (name, track, attribute keys) of a tracer's events."""
    return {(e["name"], e["track"], tuple(sorted(e["args"])))
            for e in events
            if prefixes is None or e["name"].startswith(prefixes)}


# ----------------------------------------------------------------- registry

def test_counter_gauge_histogram_basics():
    r = MetricsRegistry()
    c = r.counter("foo_total")
    c.inc()
    c.inc(3)
    assert c.value == 4 and isinstance(c.value, int)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("depth")
    g.set(7)
    g.add(2)
    assert g.value == 9
    h = r.histogram("lat_seconds")
    for v in (1e-5, 1e-3, 0.5):
        h.observe(v)
    hv = h.value
    assert hv["count"] == 3 and hv["sum"] == pytest.approx(0.50101)
    assert hv["min"] == 1e-5 and hv["max"] == 0.5 and hv["overflow"] == 0
    h.observe(1e9)
    assert h.value["overflow"] == 1
    cum = h.cumulative()
    assert cum[-1] == (float("inf"), 4)
    assert [c for _, c in cum] == sorted(c for _, c in cum)


def test_registry_identity_kind_collision_and_instruments():
    r = MetricsRegistry()
    assert r.counter("a") is r.counter("a")
    assert r.counter("h2d.bytes") is r.counter("h2d_bytes")
    with pytest.raises(ValueError):
        r.gauge("a")
    with pytest.raises(ValueError):
        r.counter("0bad name!")
    r.gauge("b")
    assert [n for n, _ in r.instruments()] == ["a", "b", "h2d_bytes"]


def test_registry_concurrent_increments_exact():
    r = MetricsRegistry()
    c = r.counter("hits_total")
    h = r.histogram("obs_seconds")

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(1e-3)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 16000 and h.value["count"] == 16000


def test_registry_reset_keeps_instrument_identity():
    fc = FakeClock()
    r = MetricsRegistry(clock=fc)
    c = r.counter("x_total")
    c.inc(9)
    fc.advance(3.0)
    r.reset()
    assert c.value == 0 and r.counter("x_total") is c
    assert r.snapshot()["_wall_s"] == 0.0


def _fill(reg):
    """The same calls on either package's registry."""
    reg.counter("reqs_total", 'requests "served"\nback\\slash').inc(5)
    reg.counter("bytes_total").inc(3)
    reg.gauge("depth", "queue depth").set(3)
    reg.gauge("ratio").set(0.125)
    reg.gauge("neg").set(-2.5)
    h = reg.histogram("lat_seconds", "latency")
    for v in (1e-7, 3e-6, 2e-3, 0.7, 1e9):
        h.observe(v)
    h2 = reg.histogram("size_bytes", "sizes", start=1.0, factor=4.0,
                       buckets=6)
    for v in (1, 3, 17, 4096, 10 ** 7):
        h2.observe(v)
    reg.histogram("empty_seconds")


def test_exposition_byte_equal_to_jax():
    mine, theirs = MetricsRegistry(), jobs.MetricsRegistry()
    _fill(mine)
    _fill(theirs)
    text = mine.prometheus()
    assert text == theirs.prometheus()
    assert "# HELP reqs_total requests \"served\"\\nback\\\\slash" in text
    assert 'lat_seconds_bucket{le="+Inf"} 5' in text


def _serve_calls(m, fc):
    m.record_slot_state("idle")
    m.record_submit(4)
    m.record_shed(1)
    m.record_queue_depth(4)
    fc.advance(0.5)
    m.record_slot_state("occupied")
    m.record_batch(3, 4)
    fc.advance(0.25)
    m.record_done(0.010, 3)
    m.record_done(0.030, 1)
    m.record_slot_state("idle")
    fc.advance(1.0)


def test_serve_metrics_prometheus_byte_equal_to_jax():
    from dcnn_tpu.serve import ServeMetrics as JaxServeMetrics
    from dcnn_tpu_torch.serve import ServeMetrics

    fa, fb = FakeClock(), FakeClock()
    mine, theirs = ServeMetrics(clock=fa), JaxServeMetrics(clock=fb)
    _serve_calls(mine, fa)
    _serve_calls(theirs, fb)
    text = mine.prometheus()
    assert text == theirs.prometheus()
    assert "serve_samples_submitted_total 4" in text
    assert "serve_latency_window_p50_ms 30.0" in text
    assert mine.snapshot() == theirs.snapshot()


def test_decode_metrics_prometheus_byte_equal_to_jax():
    from dcnn_tpu.serve.metrics import DecodeMetrics as JaxDecodeMetrics
    from dcnn_tpu_torch.serve.metrics import DecodeMetrics

    outs = []
    for cls in (DecodeMetrics, JaxDecodeMetrics):
        fc = FakeClock()
        m = cls(clock=fc)
        m.record_submit(3)
        m.record_admit(2)
        m.record_prefill(5)
        m.record_step(2, 4)
        fc.advance(0.2)
        m.record_token(2)
        m.record_ttft(0.2)
        m.record_pages(6)
        m.record_queue_depth(1)
        m.record_evict()
        m.record_complete()
        fc.advance(0.8)
        outs.append(m.prometheus())
    assert outs[0] == outs[1]
    fams = parse_prometheus_text(outs[0])
    assert fams["decode_tokens_total"]["value"] == 2
    assert fams["decode_ttft_window_p50_ms"]["value"] == pytest.approx(200.0)


def test_parse_equals_jax_parse_and_round_trips():
    from dcnn_tpu.obs.exposition import parse_prometheus_text as jparse
    from dcnn_tpu_torch.obs.exposition import render_histogram

    reg = MetricsRegistry()
    _fill(reg)
    text = reg.prometheus()
    fams = parse_prometheus_text(text)
    assert fams == jparse(text)
    assert fams["reqs_total"]["help"] == 'requests "served"\nback\\slash'
    hist = fams["lat_seconds"]
    assert hist["count"] == 5 and hist["buckets"][-1] == (float("inf"), 5)
    again = "\n".join(render_histogram("lat_seconds", hist["buckets"],
                                       hist["sum"], hist["count"],
                                       help=hist["help"]))
    assert parse_prometheus_text(again)["lat_seconds"] == hist


# ------------------------------------------------------------------- tracer

def test_tracer_fake_clock_exact():
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    with t.span("a.work", track="x", k=1):
        fc.advance(0.25)
    fc.advance(1.0)
    with t.span("a.work", track="x"):
        fc.advance(0.5)
    evs = t.events()
    assert evs[0]["ts_s"] == 0.0 and evs[0]["dur_s"] == 0.25
    assert evs[1]["ts_s"] == 1.25 and evs[1]["dur_s"] == 0.5
    assert evs[0]["track"] == "x" and _user_args(evs[0]) == {"k": 1}
    assert evs[0]["args"]["trace_id"] != evs[1]["args"]["trace_id"]
    assert "parent_id" not in evs[0]["args"]
    assert t.span_counts() == {"a.work": 2}


def test_tracer_ids_and_context_propagation():
    t = Tracer(enabled=True)
    with t.span("outer", track="x") as outer:
        carrier = t.inject()
        assert carrier == outer.context()
        with t.span("inner", track="x"):
            t.instant("mark", track="x")
    # a carrier adopted on another thread parents that thread's spans
    seen = {}

    def remote():
        with t.activate(carrier):
            with t.span("remote", track="y") as s:
                seen["ctx"] = s.context()

    th = threading.Thread(target=remote)
    th.start()
    th.join()
    ev = {e["name"]: e for e in t.events()}
    o, i, r = ev["outer"]["args"], ev["inner"]["args"], ev["remote"]["args"]
    assert i["trace_id"] == o["trace_id"] == r["trace_id"]
    assert i["parent_id"] == o["span_id"] and r["parent_id"] == o["span_id"]
    assert ev["mark"]["args"]["parent_id"] == i["span_id"]
    assert len({o["span_id"], i["span_id"], r["span_id"]}) == 3
    # an explicit parent= wins over the thread's context; malformed
    # carriers are no-ops
    with t.span("root2") as root2:
        pass
    with t.span("child", parent=root2):
        pass
    assert t.events()[-1]["args"]["parent_id"] == root2.span_id
    assert t.activate({"nope": 1}) is _NULL_SPAN
    assert t.activate(None) is _NULL_SPAN
    assert t.inject() is None  # nothing active here


def test_tracer_record_span_and_cross_thread_end():
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    t.record_span("feed.gather", 1.0, 1.5, track="feed-w3", shard=2)
    h = t.begin("q.wait", track="queue", req=7)
    fc.advance(0.125)
    th = threading.Thread(target=lambda: t.end(h, dispatched=True))
    th.start()
    th.join()
    evs = t.events()
    assert evs[0] == {"name": "feed.gather", "ts_s": 1.0, "dur_s": 0.5,
                      "track": "feed-w3", "args": {"shard": 2}}
    assert evs[1]["track"] == "queue" and evs[1]["dur_s"] == 0.125
    assert _user_args(evs[1]) == {"req": 7, "dispatched": True}


def test_tracer_ring_buffer_and_saturation_gauges():
    fc = FakeClock()
    t = Tracer(capacity=100, clock=fc, enabled=True)
    for i in range(250):
        with t.span("s", i=i):
            fc.advance(0.001)
    assert [e["args"]["i"] for e in t.events()] == list(range(150, 250))
    assert t.dropped == 150
    reg = MetricsRegistry()
    t.export_gauges(reg)
    t.export_gauges(reg)  # synced by delta: never double-counted
    snap = reg.snapshot()
    assert snap["trace_events_dropped_total"] == 150
    assert snap["trace_buffer_events"] == 100
    assert snap["trace_buffer_capacity"] == 100


def test_tracer_instant_and_error_annotation():
    t = Tracer(enabled=True)
    t.instant("boom.mark", track="x", n=3)
    with pytest.raises(RuntimeError):
        with t.span("failing.op", track="x"):
            raise RuntimeError("nope")
    evs = t.events()
    assert evs[0]["dur_s"] is None and evs[0]["args"] == {"n": 3}
    assert evs[1]["args"]["error"] == "RuntimeError"


def test_chrome_and_jsonl_exports(tmp_path):
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    with t.span("a.x", track="alpha", k=1, obj=object()):
        fc.advance(0.002)
    t.instant("a.mark", track="beta")
    with open(t.export_chrome(str(tmp_path / "trace.json"))) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    insts = [e for e in evs if e["ph"] == "i"]
    names = {m["args"]["name"]: m["tid"] for m in evs
             if m["ph"] == "M" and m["name"] == "thread_name"}
    assert xs[0]["dur"] == pytest.approx(2000.0) and xs[0]["cat"] == "a"
    assert set(names) == {"alpha", "beta"}
    assert xs[0]["tid"] == names["alpha"] and insts[0]["tid"] == names["beta"]
    assert isinstance(xs[0]["args"]["obj"], str)  # made JSON-safe
    with open(t.export_jsonl(str(tmp_path / "t.jsonl"))) as f:
        lines = [json.loads(l) for l in f]
    assert lines[0]["shard"]["format"] == "dcnn-trace-jsonl/1"
    assert lines[0]["shard"]["pid"] == os.getpid()
    assert [l["name"] for l in lines[1:]] == ["a.x", "a.mark"]


def test_jsonl_shard_reads_in_the_jax_merge_tool(tmp_path):
    """The port's JSONL shard has the JAX package's format: its merge CLI
    turns it into a Chrome trace with the same spans."""
    from dcnn_tpu.obs import trace as jtrace

    t = Tracer(enabled=True)
    t.process_name = "port"
    with t.span("outer", track="x"):
        with t.span("inner", track="x"):
            pass
    shard = t.export_jsonl(str(tmp_path / "port.jsonl"))
    out = str(tmp_path / "merged.json")
    jtrace.merge_shards([shard], out)
    with open(out) as f:
        merged = json.load(f)["traceEvents"]
    assert sorted(e["name"] for e in merged if e["ph"] == "X") == [
        "inner", "outer"]


def test_disabled_tracer_is_a_noop():
    """Disabled, every recording entry point is the shared module-level
    null function and nothing records (the functional half of the JAX
    test; no timing bound)."""
    t = Tracer(enabled=False)
    assert t.span("x", k=1) is _NULL_SPAN
    with t.span("x") as s:
        assert s.set(a=1) is _NULL_SPAN
    t.end(t.begin("y"))
    t.instant("z")
    t.record_span("w", 0.0, 1.0)
    assert t.inject() is None and t.activate({"trace_id": "t"}) is _NULL_SPAN
    assert len(t) == 0
    assert obs.get_tracer().enabled is (os.environ.get("DCNN_TRACE") == "1")


def test_configure_preserves_identity_and_capacity():
    t = obs.get_tracer()
    assert obs.configure(enabled=True) is t
    try:
        t.clear()
        for i in range(20):
            with t.span("s", i=i):
                pass
        obs.configure(capacity=10)
        assert [e["args"]["i"] for e in t.events()] == list(range(10, 20))
    finally:
        obs.configure(enabled=False, capacity=65536)
        t.clear()


def test_dcnn_trace_env_enables_the_global_tracer():
    code = ("from dcnn_tpu_torch.obs import get_tracer\n"
            "t = get_tracer()\n"
            "with t.span('x'):\n    pass\n"
            "print(t.enabled, len(t))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**env, "DCNN_TRACE": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["True", "1"], out.stderr[-2000:]


# -------------------------------------------------- span parity with JAX

def _jax_cnn(hw=8):
    return (JaxBuilder(name="obs_cnn", data_format="NHWC").input((hw, hw, 1))
            .conv2d(4, 3, padding=1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(8).activation("relu").dense(4)
            .build())


def _blobs(n, seed, hw=8):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, size=n)
    x = np.clip((y[:, None, None, None] * 50 + 20).astype(np.float32)
                + rng.normal(0, 10, size=(n, hw, hw, 1)), 0, 255)
    return x.astype(np.uint8), y.astype(np.int64)


def _pair(seed=3):
    jm = _jax_cnn()
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = from_jax(jm.get_config(), jax.tree_util.tree_map(np.array, params),
                  jax.tree_util.tree_map(np.array, state), device="cpu")
    return jm, params, state, tm


def _fit_both(kind, tracers, **port_kw):
    """One narrow fit in each package, with each global tracer on (the
    port's config with ``port_kw`` besides); returns (port events, JAX
    events, port trainer, JAX trainer)."""
    mine, theirs = tracers
    x, y = _blobs(48, 1)
    xv, yv = _blobs(16, 2)
    oh, ohv = (np.eye(4, dtype=np.float32)[a] for a in (y, yv))
    jm, params, state, tm = _pair()
    spd = 2 if kind == "chunked" else 1
    kw = dict(learning_rate=0.05, snapshot_dir=None, progress_interval=0,
              steps_per_dispatch=spd)
    if kind == "resident":
        jtr, jva = (JaxDeviceDataset(x, y, 4, batch_size=8),
                    JaxDeviceDataset(xv, yv, 4, batch_size=8))
        ptr, pva = (DeviceDataset(x, y, 4, batch_size=8, device="cpu"),
                    DeviceDataset(xv, yv, 4, batch_size=8, device="cpu"))
    elif kind == "chunked":
        jtr = JaxPrefetch(JaxLoader(x, oh, batch_size=8, seed=2),
                          stage_batches=2)
        ptr = PrefetchLoader(ArrayDataLoader(x, oh, batch_size=8, seed=2),
                             stage_batches=2, device="cpu")
        jva = JaxLoader(xv, ohv, batch_size=8, shuffle=False)
        pva = ArrayDataLoader(xv, ohv, batch_size=8, shuffle=False)
    else:
        jtr = JaxLoader(x, oh, batch_size=8, seed=2)
        ptr = ArrayDataLoader(x, oh, batch_size=8, seed=2)
        jva = JaxLoader(xv, ohv, batch_size=8, shuffle=False)
        pva = ArrayDataLoader(xv, ohv, batch_size=8, shuffle=False)
    mine.clear()
    theirs.clear()
    jopt, opt = JaxSGD(0.05, momentum=0.9), SGD(0.05, momentum=0.9)
    jt = jax_trainer.Trainer(jm, jopt, LOSS, JaxConfig(**kw))
    jt.fit(jax_trainer.TrainState(params, state, jopt.init(params),
                                  jnp.zeros((), jnp.int32)),
           jtr, jva, epochs=2)
    tt = Trainer(tm, opt, LOSS, TrainingConfig(device_type="cpu", **kw,
                                               **port_kw))
    tt.fit(create_train_state(tm, opt), ptr, pva, epochs=2)
    for ld in (ptr, jtr):
        if hasattr(ld, "close"):
            ld.close()
    return mine.events(), theirs.events(), tt, jt


@pytest.mark.parametrize("kind,span", [("host", "train.step"),
                                       ("chunked", "train.chunk"),
                                       ("resident", "train.resident_epoch")])
def test_trainer_fit_spans_equal_jax(kind, span, tracers):
    got, want, tt, jt = _fit_both(kind, tracers)
    assert _shapes(got, ("train.",)) == _shapes(want, ("train.",))
    names = [e["name"] for e in got if e["name"].startswith("train.")]
    assert names == [e["name"] for e in want
                     if e["name"].startswith("train.")]
    assert names.count("train.epoch") == 2 and span in names
    assert names.count("train.eval") == 2
    # the step spans nest under their epoch's span
    ep = {e["args"]["span_id"] for e in got if e["name"] == "train.epoch"}
    assert all(e["args"]["parent_id"] in ep for e in got
               if e["name"] == span)
    if kind != "resident":  # the resident epoch draws its own order
        for a, b in zip(tt.history, jt.history):
            np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                       rtol=1e-4, atol=1e-5)


def test_jax_host_loop_spans_are_the_ones_chip_smoke_pins(tracers):
    """``chip_smoke.py``'s obs phase holds the traced ``mha_classifier``
    fit on the card to ``OBS_TRAIN_SPANS``: the JAX trainer's host loop
    with a val loader records exactly those (name, track, keys)."""
    import importlib

    sys.path.insert(0, REPO)
    smoke = importlib.import_module("chip_smoke")
    got, want, _, _ = _fit_both("host", tracers)
    assert _shapes(want) == smoke.OBS_TRAIN_SPANS == _shapes(got)


def test_batcher_spans_equal_jax(tracers):
    from dcnn_tpu.serve import DynamicBatcher as JaxBatcher
    from dcnn_tpu.serve import InferenceEngine as JaxEngine
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine

    mine, theirs = tracers
    jm, params, state, tm = _pair()
    jeng = JaxEngine.from_model(jm, params, state, max_batch=4)
    peng = InferenceEngine.from_model(tm, max_batch=4, device="cpu")
    pool = _blobs(8, 5)[0].astype(np.float32) / 255
    outs = []
    for b in (JaxBatcher(jeng, start=False, queue_capacity=4),
              DynamicBatcher(peng, start=False, queue_capacity=4)):
        f1 = b.submit(pool[0])
        b.step()                   # one single-trace request
        f2 = [b.submit(pool[i]) for i in (1, 2)]
        b.step()                   # a batch of two traces
        f3 = b.submit(pool[3])
        with pytest.raises(Exception, match="capacity"):
            b.submit(pool[:4])     # 1 queued + 4 > 4: shed
        b.shutdown(drain=False)    # the queued one fails
        outs.append([f1.result(1)] + [f.result(1) for f in f2])
        assert f3.exception(1) is not None
    got, want = mine.events(), theirs.events()
    assert _shapes(got) == _shapes(want)
    keys = {(n, t) for n, t, _ in _shapes(got)}
    assert {("serve.compile", "serve"), ("serve.warmup", "serve"),
            ("serve.queue", "serve.queue"), ("serve.shed", "serve.queue"),
            ("serve.dispatch", "serve"), ("serve.infer", "serve")} <= keys
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_decode_spans_equal_jax(tracers):
    from dcnn_tpu.models.decoder import MHADecoder as JaxDecoder
    from dcnn_tpu.serve.decode import ContinuousBatcher as JaxCB
    from dcnn_tpu.serve.decode import DecodeEngine as JaxDE
    from dcnn_tpu_torch.models.decoder import MHADecoder
    from dcnn_tpu_torch.serve.decode import ContinuousBatcher, DecodeEngine

    mine, theirs = tracers
    kw = dict(vocab_size=16, embed_dim=16, num_heads=2, num_layers=1,
              max_seq_len=16)
    jdec = JaxDecoder(**kw)
    jparams = jdec.init(jax.random.PRNGKey(0))
    pdec = MHADecoder(**kw).init(generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    ekw = dict(max_slots=2, page_size=4, max_pages_per_seq=2)
    toks = []
    for cb in (JaxCB(JaxDE(jdec, jparams, **ekw), start=False),
               ContinuousBatcher(DecodeEngine(pdec, **ekw), start=False)):
        futs = [cb.submit([1, 2, 3], max_new_tokens=3),
                cb.submit([4], max_new_tokens=2)]
        steps = 0
        while cb.step():
            steps += 1
        toks.append([list(f.result(1)) for f in futs])
        cb.shutdown()
    got, want = mine.events(), theirs.events()
    assert _shapes(got) == _shapes(want)
    n_step = [sum(e["name"] == "decode.step" for e in evs)
              for evs in (got, want)]
    assert n_step[0] == n_step[1] == steps
    assert [len(t) for t in toks[0]] == [len(t) for t in toks[1]]


# ---------------------------------------------------------------- profiler

def test_layer_profiler_names_and_counts_equal_jax():
    from dcnn_tpu.core.config import ProfilerType as JaxPT
    from dcnn_tpu.train.profiling import LayerProfiler as JaxLP
    from dcnn_tpu_torch.core import ProfilerType
    from dcnn_tpu_torch.train.profiling import LayerProfiler

    jm, params, state, tm = _pair()
    x = _blobs(8, 4)[0].astype(np.float32) / 255
    jp, pp = JaxLP(JaxPT.CUMULATIVE), LayerProfiler(ProfilerType.CUMULATIVE)
    key = jax.random.PRNGKey(1)
    for _ in range(2):
        jl, _ = jp.profile_forward(jm, params, state, jnp.asarray(x),
                                   training=True, rng=key)
        jp.profile_backward(jm, params, state, jnp.asarray(x),
                            jnp.ones_like(jl), rng=key)
        pl = pp.profile_forward(tm, torch.from_numpy(x), training=True)
        g = pp.profile_backward(tm, torch.from_numpy(x), torch.ones_like(pl))
    assert list(pp.forward_us) == list(jp.forward_us)
    assert list(pp.backward_us) == list(jp.backward_us)
    assert dict(pp.counts) == dict(jp.counts) == {
        n: 2 for n in jp.forward_us}
    assert all(v >= 0 for v in pp.forward_us.values())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert g.shape == x.shape
    assert all(p.grad is None for p in tm.parameters())
    lines = pp.summary().splitlines()
    assert lines[0].split() == ["layer", "fwd", "µs", "bwd", "µs", "calls"]
    assert [l.split()[0] for l in lines[1:-1]] == list(jp.forward_us)
    assert lines[-1].startswith("TOTAL")
    pp.mode = ProfilerType.NORMAL
    pp.maybe_clear_per_batch()
    assert not pp.forward_us and not pp.counts


@pytest.mark.parametrize("kind", ["host", "chunked", "resident"])
def test_profiled_fit_is_bit_identical_to_the_plain_fit(kind, tracers,
                                                        capsys):
    """``profiler=NORMAL`` runs one profiled forward and backward per epoch
    outside the step and prints the table; the run's losses and params are
    bit for bit the plain run's (buffers put back, no gradient touched)."""
    from dcnn_tpu_torch.core import ProfilerType

    runs = []
    for prof in (ProfilerType.NONE, ProfilerType.NORMAL):
        got, _, tt, _ = _fit_both(kind, tracers, profiler=prof)
        runs.append((tt, [p.detach().clone() for p in tt.model.state_dict()
                          .values()]))
    (a, pa), (b, pb) = runs
    assert [h["train_loss"] for h in a.history] == [
        h["train_loss"] for h in b.history]
    assert all(torch.equal(u, v) for u, v in zip(pa, pb))
    assert b.profiler is not None and a.profiler is None
    out = capsys.readouterr().out
    assert out.count("TOTAL") == 2  # one table an epoch
    assert set(b.profiler.forward_us) == {l.name for l in b.model.layers}
    assert all(b.profiler.backward_us[n] > 0 for n in b.profiler.backward_us)


def test_profiling_trace_subdirs_nesting_and_span(tmp_path, tracers):
    from dcnn_tpu_torch.train.profiling import trace, try_trace

    parent = str(tmp_path / "prof")
    with trace(parent) as d1:
        torch.ones(4) @ torch.ones(4)
    with trace(parent) as d2:
        pass
    assert d1 != d2 and os.path.dirname(d1) == parent
    assert os.path.isfile(os.path.join(d1, "trace.json"))
    with trace(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="does not nest"):
            trace(str(tmp_path / "b"))
        assert try_trace(str(tmp_path / "c")) is None
    assert obs.get_registry().counter("profiler_trace_busy_total").value >= 1
    evs = [e for e in tracers[0].events() if e["name"] == "profiler.xprof"]
    assert len(evs) == 3 and evs[0]["args"]["log_dir"] == d1
    assert evs[0]["track"] == "profiler"


# ------------------------------------------------------- fence and debug

def test_hard_fence_walks_trees_and_is_a_noop_on_the_cpu():
    from dcnn_tpu_torch.core.fence import _leaves, hard_fence

    tree = {"a": torch.ones(3), "b": [torch.zeros(0), (torch.ones(2, 2),)],
            "c": "not a tensor", "d": 7}
    assert len(list(_leaves(tree))) == 3
    assert hard_fence(tree) is None
    assert hard_fence(torch.ones(1)) is None and hard_fence([]) is None


def _nan_fit(debug):
    """One epoch of the port's narrow CNN whose third batch is NaN, with
    the non-finite guard skipping."""
    x, y = _blobs(32, 6)
    xf = x.astype(np.float32)
    xf[16:24] = np.nan
    oh = np.eye(4, dtype=np.float32)[y]
    tm = _pair()[3]
    kw = dict(learning_rate=0.05, snapshot_dir=None, progress_interval=0,
              nonfinite_policy="skip_step", debug=debug)
    opt = SGD(0.05)
    tt = Trainer(tm, opt, LOSS, TrainingConfig(device_type="cpu", **kw))
    ld = ArrayDataLoader(xf, oh, batch_size=8, shuffle=False)
    return lambda: tt.fit(create_train_state(tm, opt), ld, epochs=1)


def test_debug_mode_raises_floating_point_error_in_both_packages():
    """A NaN batch through each package's train step in debug mode raises
    ``FloatingPointError`` (JAX: ``jax_debug_nans``); through the port's
    ``Trainer.fit(debug=True)`` it names the step, before the step guard
    sees it."""
    from dcnn_tpu.core import debug as jdebug
    from dcnn_tpu.ops.losses import get_loss as jax_get_loss
    from dcnn_tpu_torch.core import debug
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.train import make_train_step

    jm, params, state, tm = _pair()
    x = np.full((8, 8, 8, 1), np.nan, np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(8) % 4]
    jopt, opt = JaxSGD(0.05), SGD(0.05)
    jstep = jax_trainer.make_train_step(jm, jax_get_loss(LOSS), jopt)
    jts = jax_trainer.TrainState(params, state, jopt.init(params),
                                 jnp.zeros((), jnp.int32))
    step = make_train_step(tm, get_loss(LOSS), opt)
    try:
        with jdebug.debug_mode():
            with pytest.raises(FloatingPointError):
                jstep(jts, jnp.asarray(x), jnp.asarray(y),
                      jax.random.PRNGKey(0), 0.05)
        with debug.debug_mode():
            with pytest.raises(FloatingPointError, match="train step 1"):
                step(create_train_state(tm, opt), torch.from_numpy(x),
                     torch.from_numpy(y), 0.05)
        with pytest.raises(FloatingPointError, match="train step 3"):
            _nan_fit(debug=True)()
    finally:
        jdebug.disable_debug_mode()
        debug.disable_debug_mode()
    # without debug mode the guard skips the batch in both
    with pytest.warns(UserWarning, match="step skipped"):
        _nan_fit(debug=False)()


def test_debug_mode_scopes_and_anomaly_detection():
    from dcnn_tpu_torch.core import debug

    assert not debug.debug_nans()
    with debug.debug_mode(checks=True):
        assert debug.debug_nans() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="train step 4"):
            debug.check_finite(4, torch.tensor(float("nan")),
                               torch.tensor(1.0))
        debug.check_finite(5, torch.tensor(1.0), torch.tensor(2.0))
    assert not debug.debug_nans() and not torch.is_anomaly_enabled()


def test_checked_names_the_first_non_finite_layer():
    from dcnn_tpu_torch.core.debug import checked
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.train import make_train_step

    _, _, _, tm = _pair()
    opt = SGD(0.05)
    ts = create_train_state(tm, opt)
    step = checked(make_train_step(tm, get_loss(LOSS), opt))
    x = torch.from_numpy(_blobs(4, 7)[0].astype(np.float32) / 255)
    y = torch.eye(4)
    loss, _ = step(ts, x, y, 0.05)
    assert math.isfinite(float(loss)) and ts.step == 1
    # poison the batchnorm's scale: its output is the first non-finite
    bn = tm.layers[1]
    with torch.no_grad():
        next(bn.parameters()).fill_(float("inf"))
    with pytest.raises(FloatingPointError, match=repr(bn.name)):
        step(ts, x, y, 0.05)
    assert all(not l._forward_hooks for l in tm.layers)  # hooks removed


def test_dcnn_debug_env_turns_the_mode_on_at_import():
    code = ("import dcnn_tpu_torch\n"
            "from dcnn_tpu_torch.core import debug\n"
            "print(debug.debug_nans())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**env, "DCNN_DEBUG": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["True"], out.stderr[-2000:]


# ---------------------------------------------------------- flight bundles

def test_guard_skip_writes_one_nonfinite_bundle(tmp_path):
    """A NaN batch under policy skip_step writes exactly one
    ``nonfinite_guard`` bundle with the JAX recorder's files and manifest
    keys."""
    from dcnn_tpu.obs.flight import FlightRecorder as JaxFR
    from dcnn_tpu.resilience.guards import StepGuard as JaxGuard
    from dcnn_tpu_torch.obs.flight import FlightRecorder, get_flight_recorder

    rec = get_flight_recorder()
    old = rec.directory
    try:
        fit = _nan_fit(debug=False)
        from dcnn_tpu_torch.obs import configure_flight
        configure_flight(str(tmp_path / "port"))
        with pytest.warns(UserWarning):
            fit()
        bundles = rec.bundles()
    finally:
        rec.directory = old
    assert [b["trigger"] for b in bundles] == ["nonfinite_guard"]
    assert "step 3" in bundles[0]["reasons"][0]
    jrec = JaxFR(str(tmp_path / "jax"), min_interval_s=0.0,
                 registry=jobs.MetricsRegistry())
    with pytest.warns(UserWarning):
        JaxGuard("skip_step", registry=jobs.MetricsRegistry(),
                 flight=jrec).observe(3, True, float("nan"))
    mine, theirs = bundles[0]["path"], jrec.bundles()[0]["path"]
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    with open(os.path.join(mine, "MANIFEST.json")) as f:
        m = json.load(f)
    with open(os.path.join(theirs, "MANIFEST.json")) as f:
        j = json.load(f)
    assert sorted(m) == sorted(j) and m["trigger"] == j["trigger"]
    with open(os.path.join(mine, "extra.json")) as f:
        assert json.load(f)["policy"] == "skip_step"
    assert FlightRecorder(None).record("x") is None  # disabled: no-op


def test_watchdog_stall_writes_one_bundle_per_stall(tmp_path):
    from dcnn_tpu_torch.obs.flight import FlightRecorder
    from dcnn_tpu_torch.resilience.guards import StallWatchdog

    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    rec = FlightRecorder(str(tmp_path), clock=fc, min_interval_s=0.0,
                         registry=reg, tracer=Tracer(enabled=True))
    wd = StallWatchdog(5.0, clock=fc, registry=reg, flight=rec)
    fc.advance(6.0)
    with pytest.warns(UserWarning):
        assert wd.check()
    assert wd.check()          # the same stall: no second bundle
    wd.beat()
    fc.advance(6.0)
    with pytest.warns(UserWarning):
        assert wd.check()
    b = rec.bundles()
    assert [x["trigger"] for x in b] == ["watchdog_stall"] * 2
    with open(os.path.join(b[0]["path"], "extra.json")) as f:
        extra = json.load(f)
    assert extra["timeout_s"] == 5.0 and extra["age_s"] == 6.0
    assert reg.snapshot()["flight_records_total"] == 2


def test_flight_keep_k_cooldown_and_failure_counting(tmp_path):
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    rec = obs.FlightRecorder(str(tmp_path), keep=2, min_interval_s=10.0,
                             clock=fc, registry=reg)
    paths = []
    for i in range(4):
        paths.append(rec.record("t", reasons=[str(i)]))
        fc.advance(11.0)
    assert rec.record("t") is not None
    assert rec.record("t") is None  # inside the cooldown
    assert len(rec.bundles()) == 2
    assert reg.snapshot()["flight_records_suppressed_total"] == 1
    (tmp_path / "file").write_text("x")
    bad = obs.FlightRecorder(str(tmp_path / "file"), registry=reg)
    assert bad.record("t") is None
    assert reg.snapshot()["flight_record_failures_total"] == 1


# ----------------------------------------------------------- env and retry

def test_env_file_and_get_env_equal_jax(tmp_path, monkeypatch):
    from dcnn_tpu.utils import env as jenv
    from dcnn_tpu_torch.core.config import get_env as config_get_env
    from dcnn_tpu_torch.utils import env

    assert config_get_env is env.get_env
    p = tmp_path / ".env"
    p.write_text("# comment\nOBS_A = 3\nOBS_B='yes'\n\nOBS_C=\"x y\"\n"
                 "noequals\nOBS_D=0.5\n")
    for k in ("OBS_A", "OBS_B", "OBS_C", "OBS_D"):
        monkeypatch.delenv(k, raising=False)
    assert env.load_env_file(str(p))
    got = {k: os.environ[k] for k in ("OBS_A", "OBS_B", "OBS_C", "OBS_D")}
    for k in got:
        monkeypatch.delenv(k)
    assert jenv.load_env_file(str(p))
    assert got == {k: os.environ[k] for k in got}
    assert not env.load_env_file(str(tmp_path / "missing"))
    for name, default in (("OBS_A", 0), ("OBS_B", False), ("OBS_C", ""),
                          ("OBS_D", 1.0), ("OBS_MISSING", 7)):
        assert env.get_env(name, default) == jenv.get_env(name, default)
    monkeypatch.setenv("OBS_BAD", "maybe")
    with pytest.raises(ValueError, match="not a boolean"):
        env.get_env("OBS_BAD", True)


def test_retry_schedule_and_counters_equal_jax():
    from dcnn_tpu.resilience import retry as jretry
    from dcnn_tpu_torch.resilience.retry import (
        backoff_delays, retriable, retry_call,
    )

    assert (list(backoff_delays(6, base=0.1, cap=1.0,
                                rng=random.Random(3)))
            == list(jretry.backoff_delays(6, base=0.1, cap=1.0,
                                          rng=random.Random(3))))
    fc, slept, calls = FakeClock(), [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    reg = MetricsRegistry()
    assert retry_call(flaky, attempts=5, sleep=slept.append, clock=fc,
                      rng=random.Random(0), name="unit",
                      registry=reg) == "ok"
    assert len(slept) == 2 and reg.snapshot()["unit_retry_attempts_total"] == 2
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("x")), attempts=2,
                   sleep=lambda s: None, registry=reg)
    with pytest.raises(KeyError):  # not retried: re-raised at once
        retry_call(lambda: {}["k"], attempts=3, registry=reg)

    @retriable(attempts=2, sleep=lambda s: None, registry=reg)
    def once():
        return 5
    assert once() == 5
