"""The port's telemetry plane (``dcnn_tpu_torch.obs``), the portable part
of the JAX package's ``tests/test_obs_server.py``: the exposition's format
rules, the HTTP server on an ephemeral port (``/metrics``, ``/healthz``
flipping to 503 on a stalled watchdog and on a rotting checkpoint,
``/snapshot``), the batcher's telemetry lifecycle over the port's engine
(``start_telemetry`` twice without a leaked port), ``obs/xla`` (FLOPs
through ``FlopCounterMode``, the compile counters, ``sample_hbm`` returning
``None`` without a card), the tracer's flush and truncation, and the
render -> parse round trip, and the trainer's ``metrics_port`` (a live
fit scraped mid-epoch, gated on an event; a failed bind that still stops
the watchdog). No test here waits on a wall clock: fakes, injected clocks
and events drive every state.
"""

import gzip
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.obs import MetricsRegistry, TelemetryServer
from dcnn_tpu_torch.obs.exposition import CONTENT_TYPE
from dcnn_tpu_torch.obs.server import checkpoint_check, watchdog_check
from dcnn_tpu_torch.obs.tracer import Tracer
from dcnn_tpu_torch.obs import xla as obs_xla


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _get(url, timeout=10):
    """(status, headers, body_bytes) for a GET, 4xx/5xx included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# ------------------------------------------------ exposition conformance

def assert_exposition_conformant(text: str):
    """The format rules every scraper assumes, checked line by line."""
    lines = [l for l in text.splitlines() if l]
    types = {}   # series name -> declared type
    helped = set()
    samples = {}  # name -> value str (scalar series)
    buckets = {}  # hist name -> list[(le_str, cum_int)]
    for line in lines:
        if line.startswith("# HELP "):
            name = line.split()[2]
            assert name not in types, f"HELP after TYPE for {name}"
            helped.add(name)
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert kind in ("counter", "gauge", "histogram")
            assert name not in types, f"duplicate TYPE for {name}"
            types[name] = kind
        else:
            name, _, value = line.partition(" ")
            if "{" in name:
                base, _, rest = name.partition("{")
                assert base.endswith("_bucket"), name
                assert rest.startswith('le="') and rest.endswith('"}'), name
                buckets.setdefault(base[: -len("_bucket")], []).append(
                    (rest[4:-2], int(value)))
            else:
                float(value)  # every sample parses as a number
                samples[name] = value
    for name, kind in types.items():
        if kind == "counter":
            assert name.endswith("_total"), \
                f"counter {name} missing _total suffix"
            assert name in samples
        elif kind == "histogram":
            cums = buckets.get(name)
            assert cums, f"histogram {name} has no _bucket series"
            assert cums[-1][0] == "+Inf", f"{name} buckets must end at +Inf"
            counts = [c for _, c in cums]
            assert counts == sorted(counts), f"{name} buckets not cumulative"
            assert f"{name}_sum" in samples and f"{name}_count" in samples
            assert int(samples[f"{name}_count"]) == cums[-1][1], \
                f"{name}_count != +Inf bucket"
    return types, samples


def test_registry_exposition_conformant():
    r = MetricsRegistry()
    r.counter("reqs_total", "requests\nserved").inc(5)
    r.gauge("depth", "queue depth").set(3)
    h = r.histogram("lat_seconds", "latency")
    for v in (1e-5, 2e-3, 0.7, 1e9):  # incl. the +Inf overflow bucket
        h.observe(v)
    types, samples = assert_exposition_conformant(r.prometheus())
    assert types == {"reqs_total": "counter", "depth": "gauge",
                     "lat_seconds": "histogram"}
    # HELP newline escaped per the exposition spec, never a raw newline
    assert "# HELP reqs_total requests\\nserved" in r.prometheus()


def test_serve_metrics_exposition_conformant_and_shared():
    from dcnn_tpu_torch.serve import ServeMetrics

    fc = FakeClock()
    m = ServeMetrics(clock=fc)
    m.record_submit(4)
    m.record_queue_depth(4)
    m.record_batch(4, 8)
    fc.advance(0.25)
    m.record_done(0.25, 4)
    text = m.prometheus()
    types, samples = assert_exposition_conformant(text)
    # derived windowed gauges carry TYPE headers through the SAME renderer
    assert types["serve_latency_window_p99_ms"] == "gauge"
    assert samples["serve_samples_completed_total"] == "4"
    assert types["serve_latency_seconds"] == "histogram"


def test_builtin_guard_counter_name_conforms():
    # the StepGuard skip counter is part of the /healthz flag contract —
    # its name must carry the counter suffix
    from dcnn_tpu_torch.resilience.guards import StepGuard

    reg = MetricsRegistry()
    g = StepGuard("skip_step", registry=reg)
    with pytest.warns(UserWarning):
        assert g.observe(1, True) == "skipped"
    assert reg.counter("train_skipped_steps_total").value == 1
    assert_exposition_conformant(reg.prometheus())


# ------------------------------------------------------- TelemetryServer

def test_server_end_to_end_ephemeral_port():
    reg = MetricsRegistry()
    reg.counter("pings_total", "pings").inc(2)
    tr = Tracer(enabled=True)
    with tr.span("unit.op", track="t", k=1):
        pass
    srv = TelemetryServer(registry=reg, tracer=tr, port=0).start()
    try:
        assert srv.port > 0
        code, hdrs, body = _get(srv.url + "/metrics")
        assert code == 200 and hdrs["Content-Type"] == CONTENT_TYPE
        assert_exposition_conformant(body.decode())
        assert "pings_total 2" in body.decode()

        code, _, body = _get(srv.url + "/healthz")
        h = json.loads(body)
        assert code == 200 and h["status"] == "ok" and h["reasons"] == []

        code, _, body = _get(srv.url + "/snapshot")
        s = json.loads(body)
        assert code == 200
        assert s["metrics"]["pings_total"] == 2
        assert s["span_counts"] == {"unit.op": 1}
        assert s["spans"][0]["name"] == "unit.op"
        args = s["spans"][0]["args"]
        assert args["k"] == 1
        assert args["trace_id"] and args["span_id"]

        code, _, body = _get(srv.url + "/nope")
        assert code == 404 and "routes" in json.loads(body)
    finally:
        srv.stop()
    srv.stop()  # idempotent
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + "/metrics", timeout=2)


def test_snapshot_events_bounded():
    tr = Tracer(enabled=True)
    for i in range(5):
        with tr.span("op", i=i):
            pass
    srv = TelemetryServer(registry=MetricsRegistry(), tracer=tr,
                          snapshot_events=2)
    snap = srv.snapshot()  # the body, called directly: no socket
    assert [e["args"]["i"] for e in snap["spans"]] == [3, 4]
    assert snap["span_counts"] == {"op": 5}


def test_healthz_watchdog_stall_flips_503():
    from dcnn_tpu_torch.resilience.guards import StallWatchdog

    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    wd = StallWatchdog(5.0, clock=fc, registry=reg)  # never start()ed
    srv = TelemetryServer(registry=reg, clock=fc).add_check(
        "watchdog", watchdog_check(wd)).start()
    try:
        code, _, body = _get(srv.url + "/healthz")
        assert code == 200
        fc.advance(6.0)  # past timeout_s, no beat: stalled
        with pytest.warns(UserWarning):
            code, _, body = _get(srv.url + "/healthz")
        h = json.loads(body)
        assert code == 503 and h["status"] == "unhealthy"
        assert h["checks"]["watchdog"]["ok"] is False
        assert "stalled" in h["reasons"][0]
        # the registry stall flags ride along for the scraper
        assert h["flags"]["train_stalled"] == 1
        wd.beat()  # recovery: next scrape is healthy again
        code, _, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["flags"][
            "train_stalled"] == 0
    finally:
        srv.stop()


def test_healthz_corrupt_checkpoint_flips_503():
    class RottingManager:  # injectable fake: check() is the real contract
        def check(self):
            raise RuntimeError("async save failed: checksum mismatch")

    class HealthyManager:
        def check(self):
            return None

    srv = TelemetryServer(registry=MetricsRegistry()).add_check(
        "checkpoint", checkpoint_check(HealthyManager())).start()
    try:
        code, _, _ = _get(srv.url + "/healthz")
        assert code == 200
    finally:
        srv.stop()

    srv = TelemetryServer(registry=MetricsRegistry()).add_check(
        "checkpoint", checkpoint_check(RottingManager())).start()
    try:
        code, _, body = _get(srv.url + "/healthz")
        h = json.loads(body)
        assert code == 503
        assert "checkpoint save failing" in h["checks"]["checkpoint"][
            "reason"]
        assert "checksum mismatch" in h["reasons"][0]
    finally:
        srv.stop()


def test_checkpoint_health_probe_is_latching_and_non_consuming(tmp_path):
    """A real CheckpointManager with a failing async save: the /healthz
    probe must (a) stay degraded across repeated scrapes, and (b) NOT
    steal the failure from the trainer's own one-shot check() fail-fast."""
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager
    from dcnn_tpu_torch.train.trainer import create_train_state

    model = SequentialBuilder("ck").input((4,)).dense(2).build()
    opt = Adam(1e-3)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(0),
                            device="cpu")

    def bad_write(path, data):
        raise OSError("disk full")

    cm = CheckpointManager(str(tmp_path), io_write=bad_write,
                           registry=MetricsRegistry())
    try:
        fut = cm.save_async(1, model, ts.opt_state, opt, {})
        assert isinstance(fut.exception(timeout=30), OSError)
        chk = checkpoint_check(cm)
        assert "disk full" in chk()
        assert "disk full" in chk()  # second scrape: still degraded
        with pytest.raises(OSError):
            cm.check()               # trainer fail-fast NOT disarmed
        assert "disk full" in chk()  # latched even after check() consumed
    finally:
        cm.close()


def test_healthz_registry_stall_flag_without_check():
    # a process that wired a watchdog to the registry but not to the
    # server still degrades: the gauge alone flips /healthz
    reg = MetricsRegistry()
    reg.gauge("train_stalled").set(1)
    code, body = TelemetryServer(registry=reg).health()
    assert code == 503 and "train_stalled" in body["reasons"][0]


def test_health_check_exception_counts_as_degraded():
    srv = TelemetryServer(registry=MetricsRegistry())
    srv.add_check("boom", lambda: (_ for _ in ()).throw(OSError("disk")))
    code, body = srv.health()
    assert code == 503 and "OSError" in body["checks"]["boom"]["reason"]


# ------------------------------------------------------------ serve wiring

def _tiny_engine(max_batch=4):
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.serve import InferenceEngine

    model = (SequentialBuilder("obs_srv").input((1, 8, 8))
             .conv2d(4, 3, 1, 1).activation("relu").flatten().dense(10)
             .build()).init(generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return InferenceEngine.from_model(model, max_batch=max_batch,
                                      device="cpu")


def test_engine_cost_stats_and_compile_counters():
    from dcnn_tpu_torch.obs import get_registry

    before = get_registry().counter("compile_total").value
    eng = _tiny_engine(max_batch=4)
    # one compile event per bucket (the first call), all counted on the
    # shared registry
    assert get_registry().counter("compile_total").value \
        == before + len(eng.bucket_sizes)
    top = eng.compile_stats[eng.max_batch]
    # the aten ops' FLOPs of one call at the bucket: the conv and the dense
    conv = 2 * 4 * 1 * 9 * 8 * 8 * eng.max_batch
    dense = 2 * 256 * 10 * eng.max_batch
    assert top["flops"] == conv + dense
    assert "bytes_accessed" not in top  # eager PyTorch has no byte count
    assert get_registry().gauge("serve_flops_per_sample").value \
        == (conv + dense) / eng.max_batch


def test_batcher_telemetry_lifecycle():
    from dcnn_tpu_torch.serve import DynamicBatcher

    eng = _tiny_engine()
    b = DynamicBatcher(eng, start=False)  # synchronous: fully deterministic
    srv = b.start_telemetry()
    try:
        fut = b.submit(np.zeros((1, 8, 8), np.float32))
        b.step()
        assert fut.result(timeout=10).shape == (10,)

        code, hdrs, body = _get(srv.url + "/metrics")
        text = body.decode()
        assert code == 200
        assert_exposition_conformant(text)
        # the serve exposition (registry + windowed gauges), not the bare
        # global registry — the exact-percentile series must be present
        assert "serve_samples_completed_total 1" in text
        assert "serve_latency_window_p99_ms" in text
        # engine cost gauges AND compile accounting mirrored onto the
        # (private) scrape registry
        assert "serve_flops_per_sample" in text
        assert f"compile_total {len(eng.bucket_sizes)}" in text

        code, _, _ = _get(srv.url + "/healthz")
        assert code == 200

        code, _, body = _get(srv.url + "/snapshot")
        s = json.loads(body)
        assert s["serve"]["requests_completed"] == 1
        assert s["engine"]["buckets"] == eng.bucket_sizes
        assert s["engine"]["compile_stats"][str(eng.max_batch)]["flops"] > 0

        b.drain()  # draining replica: scrapeable but unhealthy — the
        # router contract: stop routing BEFORE requests fail
        code, _, body = _get(srv.url + "/healthz")
        h = json.loads(body)
        assert code == 503 and "draining" in h["reasons"][0]
        code, _, _ = _get(srv.url + "/metrics")
        assert code == 200
    finally:
        b.shutdown()
    assert b._telemetry is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + "/healthz", timeout=2)


# ----------------------------------------------------------- train wiring

def test_trainer_live_scrape():
    """Twin of the JAX test: a live fit (mid-epoch, gated on an event, no
    sleeps) answers ``/metrics``, ``/healthz``, ``/snapshot`` and
    ``/goodput`` on its ephemeral port; the server is gone after
    ``fit()`` returns."""
    from dcnn_tpu_torch.core.config import TrainingConfig
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.train.trainer import Trainer, create_train_state

    model = (SequentialBuilder("obs_live").input((1, 8, 8))
             .conv2d(2, 3, 1, 1).activation("relu").flatten().dense(10)
             .build())
    x = np.zeros((4, 1, 8, 8), np.float32)
    y = np.eye(10, dtype=np.float32)[np.zeros(4, int)]

    class GatedLoader:
        batch_size = 4

        def __init__(self):
            self.mid_epoch = threading.Event()
            self.release = threading.Event()

        def __iter__(self):
            yield x, y
            self.mid_epoch.set()
            assert self.release.wait(60)
            yield x, y

    cfg = TrainingConfig(epochs=1, snapshot_dir=None, metrics_port=0,
                         progress_interval=0, device_type="cpu")
    trainer = Trainer(model, Adam(1e-3), "softmax_crossentropy", cfg)
    ts = create_train_state(model, Adam(1e-3),
                            torch.Generator().manual_seed(0), device="cpu")
    loader = GatedLoader()
    err = []

    def run():
        try:
            trainer.fit(ts, loader, epochs=1)
        except BaseException as e:  # surfaced after join
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    try:
        assert loader.mid_epoch.wait(60), "training never reached batch 1"
        srv = trainer.telemetry
        assert srv is not None
        code, hdrs, body = _get(srv.url + "/metrics")
        assert code == 200 and hdrs["Content-Type"] == CONTENT_TYPE
        assert_exposition_conformant(body.decode())
        code, _, body = _get(srv.url + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert "alerts" in health["checks"]
        code, _, body = _get(srv.url + "/snapshot")
        assert code == 200 and "metrics" in json.loads(body)
        code, _, body = _get(srv.url + "/goodput")
        doc = json.loads(body)
        assert code == 200 and doc["bottleneck"]["state"] in (
            "healthy", "feed_bound", "compute_bound", "compile_bound",
            "io_bound")
        assert "anomaly" in doc
        url = srv.url
    finally:
        loader.release.set()
        th.join(120)
    assert not err, err
    assert trainer.telemetry is None  # stopped by fit()'s finally
    assert trainer._tsdb is None and trainer._goodput is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_trainer_server_bind_failure_stops_watchdog():
    """Twin of the JAX test: a failed telemetry bind (a fixed port
    already in use) must not leak the already-started stall watchdog."""
    import socket

    from dcnn_tpu_torch.core.config import TrainingConfig
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.train.trainer import Trainer, create_train_state

    blocker = socket.socket()
    try:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        model = SequentialBuilder("bindfail").input((4,)).dense(2).build()
        cfg = TrainingConfig(epochs=1, snapshot_dir=None,
                             metrics_port=port, stall_timeout_s=60,
                             progress_interval=0, device_type="cpu")
        trainer = Trainer(model, Adam(1e-3), "softmax_crossentropy", cfg)
        ts = create_train_state(model, Adam(1e-3),
                                torch.Generator().manual_seed(0),
                                device="cpu")
        with pytest.raises(OSError):
            trainer.fit(ts, [], epochs=1)
        assert trainer.watchdog is None and trainer.telemetry is None
    finally:
        blocker.close()


def test_start_telemetry_twice_replaces_not_leaks():
    from dcnn_tpu_torch.serve import DynamicBatcher

    eng = _tiny_engine()
    b = DynamicBatcher(eng, start=False)
    try:
        first = b.start_telemetry()
        first_url = first.url
        second = b.start_telemetry()
        assert b._telemetry is second
        # the first server's port is released, the second one answers
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(first_url + "/healthz", timeout=2)
        code, _, body = _get(second.url + "/metrics")
        assert code == 200
        # compile counters mirrored exactly once across both calls
        assert f"compile_total {len(eng.bucket_sizes)}" in body.decode()
    finally:
        b.shutdown()


# --------------------------------------------------------------- obs/xla

def test_jit_cost_of_real_executable():
    a = torch.ones(32, 32)
    cost = obs_xla.jit_cost(lambda a, b: torch.tanh(a @ b).sum(), a, a)
    assert cost is not None and cost["flops"] == 2 * 32 ** 3
    assert cost["bytes_accessed"] is None and cost["bytes_per_flop"] is None


def test_jit_cost_failure_is_none():
    def boom(*a):
        raise TypeError("nope")

    assert obs_xla.jit_cost(boom, 1) is None
    assert obs_xla.executable_cost(object()) is None
    # a call with no counted op has no cost either
    assert obs_xla.jit_cost(lambda: None) is None


def test_record_compile_counters():
    reg = MetricsRegistry()
    obs_xla.record_compile(2.5, what="unit", registry=reg)
    obs_xla.record_compile(1.5, what="unit", registry=reg)
    snap = reg.snapshot()
    assert snap["compile_total"] == 2
    assert snap["compile_seconds_total"] == pytest.approx(4.0)
    assert snap["compile_unit_seconds_total"] == pytest.approx(4.0)


def test_analytic_mfu():
    assert obs_xla.analytic_mfu(2e9, 1000.0, 197.0) == pytest.approx(
        2e12 / 197e12)
    assert obs_xla.analytic_mfu(None, 1000.0, 197.0) is None
    assert obs_xla.analytic_mfu(2e9, 1000.0, None) is None


def test_sample_hbm_watermark_and_latch(monkeypatch):
    stats = {0: {"allocated_bytes.all.current": 1 << 30,
                 "allocated_bytes.all.peak": 2 << 30},
             1: {"allocated_bytes.all.current": 3 << 30,
                 "allocated_bytes.all.peak": 4 << 30},
             2: {"allocated_bytes.all.current": 1 << 20,
                 "allocated_bytes.all.peak": 1 << 20}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (0, 16 << 30))
    monkeypatch.setattr(obs_xla, "_HBM_SUPPORTED", None)
    reg = MetricsRegistry()
    s = obs_xla.sample_hbm(reg, devices=[0, 1])
    assert s["hbm_bytes_in_use"] == 4 << 30
    assert s["hbm_bytes_limit"] == 32 << 30
    assert s["hbm_peak_bytes"] == 4 << 30
    # the watermark is monotone: a lower later sample never regresses it
    obs_xla.sample_hbm(reg, devices=[2])
    assert reg.gauge("hbm_peak_bytes").value == 4 << 30
    assert reg.gauge("hbm_bytes_in_use").value == 1 << 20
    monkeypatch.undo()

    # no card: None, and the latch makes later calls free no-ops
    monkeypatch.setattr(obs_xla, "_HBM_SUPPORTED", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert obs_xla.sample_hbm(reg) is None
    assert obs_xla._HBM_SUPPORTED is False
    assert obs_xla.sample_hbm(reg) is None


# ------------------------------------------------------ tracer satellites

def _jsonl_events(lines):
    """Parsed JSONL events, skipping the shard-header line (detected by
    its "shard" key; events always carry "name")."""
    out = []
    for line in lines:
        obj = json.loads(line)
        if "shard" in obj and "name" not in obj:
            continue
        out.append(obj)
    return out


def test_flush_jsonl_plain_and_gzip(tmp_path):
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    for i in range(4):
        with t.span("op", i=i):
            fc.advance(0.5)
    plain = str(tmp_path / "t.jsonl")
    t.export_jsonl(plain)  # export does NOT clear
    assert len(t) == 4
    gz = str(tmp_path / "t.jsonl.gz")
    t.flush_jsonl(gz, gzip=True)  # flush writes then clears
    assert len(t) == 0
    with open(plain) as f:
        plain_evs = _jsonl_events(f)
    with gzip.open(gz, "rt") as f:
        gz_evs = _jsonl_events(f)
    assert plain_evs == gz_evs
    assert [e["args"]["i"] for e in gz_evs] == [0, 1, 2, 3]
    assert all(e["dur_s"] == 0.5 for e in gz_evs)


def test_flush_jsonl_concurrent_events_survive_and_epoch_persists(
        tmp_path, monkeypatch):
    """Events recorded DURING the flush write land in the buffer for the
    next flush (never lost, never duplicated), and the tracer epoch is
    untouched so timestamps stay monotone across flushes."""
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    with t.span("a"):
        fc.advance(1.0)
    orig = t._write_jsonl

    def write_and_record(evs, path, gz):  # a recorder wins the race
        orig(evs, path, gz)
        with t.span("b"):
            fc.advance(1.0)

    monkeypatch.setattr(t, "_write_jsonl", write_and_record)
    p1 = str(tmp_path / "f1.jsonl")
    t.flush_jsonl(p1)
    monkeypatch.setattr(t, "_write_jsonl", orig)
    assert [e["name"] for e in t.events()] == ["b"]  # survived the flush
    with open(p1) as f:
        assert [e["name"] for e in _jsonl_events(f)] == ["a"]
    p2 = str(tmp_path / "f2.jsonl")
    t.flush_jsonl(p2)
    with open(p2) as f:
        evs2 = _jsonl_events(f)
    assert [e["name"] for e in evs2] == ["b"]
    assert evs2[0]["ts_s"] == 1.0  # same epoch as before the first flush
    assert len(t) == 0


def test_flush_jsonl_saturated_ring_never_overpops(tmp_path, monkeypatch):
    """Ring AT CAPACITY during the flush write: eviction removes exported
    events from the left while new ones arrive — the drain must stop at
    the first unexported event instead of popping len(snapshot) blindly
    (which would eat never-exported events)."""
    fc = FakeClock()
    t = Tracer(capacity=4, clock=fc, enabled=True)
    for i in range(4):  # ring full: snapshot will be exactly capacity
        with t.span("old", i=i):
            fc.advance(1.0)
    orig = t._write_jsonl

    def write_and_record(evs, path, gz):
        orig(evs, path, gz)
        for j in range(2):  # evicts two exported 'old' events
            with t.span("new", j=j):
                fc.advance(1.0)

    monkeypatch.setattr(t, "_write_jsonl", write_and_record)
    p = str(tmp_path / "sat.jsonl")
    t.flush_jsonl(p)
    with open(p) as f:
        assert [e["name"] for e in _jsonl_events(f)] == ["old"] * 4
    # both never-exported events survive; all exported ones are gone
    assert [(e["name"], e["args"]["j"]) for e in t.events()] == [
        ("new", 0), ("new", 1)]


def test_flush_jsonl_failed_write_keeps_events(tmp_path):
    t = Tracer(enabled=True)
    with t.span("op"):
        pass
    bad = str(tmp_path / "dir_not_file")
    os.makedirs(bad)
    with pytest.raises(IsADirectoryError):
        t.flush_jsonl(bad)
    assert len(t) == 1  # clear only happens after a successful write


def test_export_chrome_truncation_note(tmp_path):
    fc = FakeClock()
    t = Tracer(clock=fc, enabled=True)
    for i in range(10):
        with t.span("op", i=i):
            fc.advance(0.1)
    path = str(tmp_path / "trace.json")
    t.export_chrome(path, max_events=4)
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    real = [e for e in evs if e["ph"] in ("X", "i")]
    note, spans = real[0], real[1:]
    # newest 4 survive, and the drop is explicit — log-truncation style
    assert [e["args"]["i"] for e in spans] == [6, 7, 8, 9]
    assert note["name"] == "tracer.truncated" and note["ph"] == "i"
    assert note["args"]["dropped_older_events"] == 6
    assert "6 older events truncated" in note["args"]["note"]

    # under the cap: no note, nothing dropped
    t.export_chrome(path, max_events=100)
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert [e["name"] for e in evs if e["ph"] != "M"] == ["op"] * 10

    with pytest.raises(ValueError):
        t.export_chrome(path, max_events=0)


# ------------------------------------------- render -> parse round trip
# parse_prometheus_text reads the text an external scraper reads, so the
# inverse must round-trip everything the shared renderer emits.

def test_parse_round_trips_registry_exposition():
    from dcnn_tpu_torch.obs.exposition import (
        parse_prometheus_text, render_histogram, scalar_values,
    )

    r = MetricsRegistry()
    r.counter("reqs_total", "requests\nserved").inc(5)
    r.gauge("depth", "queue depth").set(3)
    h = r.histogram("lat_seconds", "latency")
    for v in (1e-5, 2e-3, 0.7, 1e9):  # incl. the +Inf overflow bucket
        h.observe(v)
    fams = parse_prometheus_text(r.prometheus())
    assert fams["reqs_total"]["kind"] == "counter"
    assert fams["reqs_total"]["value"] == 5.0
    # HELP unescaping is the exact inverse of the renderer's escaping
    assert fams["reqs_total"]["help"] == "requests\nserved"
    assert fams["depth"]["kind"] == "gauge" and fams["depth"]["value"] == 3.0
    hist = fams["lat_seconds"]
    assert hist["kind"] == "histogram"
    assert hist["count"] == 4
    assert hist["sum"] == pytest.approx(1e9 + 0.7 + 2e-3 + 1e-5)
    assert hist["buckets"][-1] == (float("inf"), 4)
    cums = [c for _, c in hist["buckets"]]
    assert cums == sorted(cums)
    # render(parse(render(x))) is the identity on values: the parsed
    # buckets/sum/count ARE render_histogram's input shape
    again = "\n".join(render_histogram(
        "lat_seconds", hist["buckets"], hist["sum"], hist["count"],
        help=hist["help"]))
    assert parse_prometheus_text(again)["lat_seconds"] == hist
    # the flattened scalar view
    flat = scalar_values(fams)
    assert flat["reqs_total"] == 5.0 and flat["depth"] == 3.0
    assert "lat_seconds" not in flat  # histograms are not scalars


def test_parse_round_trips_serve_metrics_exposition():
    from dcnn_tpu_torch.obs.exposition import parse_prometheus_text, scalar_values
    from dcnn_tpu_torch.serve import ServeMetrics

    fc = FakeClock()
    m = ServeMetrics(clock=fc)
    m.record_submit(4)
    m.record_queue_depth(4)
    m.record_batch(4, 8)
    fc.advance(0.25)
    m.record_done(0.25, 4)
    fams = parse_prometheus_text(m.prometheus())
    vals = scalar_values(fams)
    assert vals["serve_queue_depth"] == 4.0
    assert vals["serve_samples_completed_total"] == 4.0
    assert "serve_latency_window_p99_ms" in vals
    assert fams["serve_latency_seconds"]["kind"] == "histogram"
    assert fams["serve_latency_seconds"]["count"] == \
        fams["serve_latency_seconds"]["buckets"][-1][1]


def test_parse_label_escapes_and_untyped_series():
    from dcnn_tpu_torch.obs.exposition import (
        escape_label_value, parse_prometheus_text,
    )

    raw = 'a "quoted\\path"\nline2'
    text = (f'weird{{path="{escape_label_value(raw)}",x="1"}} 2.5\n'
            "no_type_series 7\n")
    fams = parse_prometheus_text(text)
    labels, value = fams["weird"]["samples"][0]
    assert labels == {"path": raw, "x": "1"}
    assert value == 2.5
    assert fams["no_type_series"]["kind"] == "untyped"
    assert fams["no_type_series"]["value"] == 7.0


def test_parse_rejects_malformed_lines():
    from dcnn_tpu_torch.obs.exposition import parse_prometheus_text

    # a scrape that half-parses must not feed a decision
    with pytest.raises(ValueError, match="line 2"):
        parse_prometheus_text("ok 1\nbroken_series_without_value\n")
    with pytest.raises(ValueError, match="unparseable"):
        parse_prometheus_text("bad_value nope\n")
