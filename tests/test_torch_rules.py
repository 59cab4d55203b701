"""The port's alert and recording rules (``dcnn_tpu_torch/obs/rules.py``),
the twin of the JAX package's ``tests/test_rules.py``: the
pending→firing→resolved state machine under a fake clock (no sleeps), the
three rule kinds, ``for_s`` hold windows, exposition and ``/healthz``
integration, and the ``alert_firing`` flight trigger; then the same sample
stream through both packages' engines, whose transitions, alert docs and
exposition lines must be identical."""

import json
import os

import pytest

from dcnn_tpu_torch.obs.flight import FlightRecorder
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.obs.rules import AlertRule, RecordingRule, RuleEngine, \
    rules_check
from dcnn_tpu_torch.obs.server import TelemetryServer
from dcnn_tpu_torch.obs.tsdb import TimeSeriesStore


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_engine(fc, **kw):
    store = TimeSeriesStore(clock=fc)
    reg = kw.pop("registry", None) or MetricsRegistry(clock=fc)
    return RuleEngine(store, registry=reg, clock=fc, **kw), store, reg


def drive(fc, store, eng, series, value, ticks, dt=1.0):
    out = []
    for _ in range(ticks):
        fc.advance(dt)
        if value is not None:
            store.add(series, value)
        out.extend(eng.evaluate())
    return out


# ----------------------------------------------------------- state machine

def test_threshold_pending_firing_resolved_edges():
    """The full life of one alert, with for_s hold: breach -> pending,
    held past for_s -> firing (one fired edge), clear -> inactive (one
    resolved edge) — all under the fake clock."""
    fc = FakeClock()
    eng, store, reg = make_engine(fc)
    eng.add_alert(name="p99", series="p99_ms", op=">", threshold=200.0,
                  for_s=3.0, window_s=60.0)
    assert drive(fc, store, eng, "p99_ms", 100.0, 3) == []
    trs = drive(fc, store, eng, "p99_ms", 500.0, 1)
    assert [(t["from"], t["to"]) for t in trs] == [("inactive", "pending")]
    pending_t = trs[0]["t"]
    trs = drive(fc, store, eng, "p99_ms", 500.0, 5)
    fired = [t for t in trs if t["to"] == "firing"]
    assert len(fired) == 1
    # fires within the for_s budget (+ one evaluation tick of slack)
    assert eng.alerts()[0]["state"] == "firing"
    assert fired[0]["t"] - pending_t == pytest.approx(3.0, abs=1.0)
    trs = drive(fc, store, eng, "p99_ms", 50.0, 1)
    assert [(t["from"], t["to"]) for t in trs] == [("firing", "inactive")]
    snap = reg.snapshot()
    assert snap["alerts_fired_total"] == 1
    assert snap["alerts_resolved_total"] == 1
    assert snap["alerts_firing"] == 0
    # alert_state history rode the tsdb: 0 -> 1 -> 2 -> 0
    states = [v for _, v in store.range('alert_state{rule="p99"}', 100.0)]
    assert 1 in states and 2 in states and states[-1] == 0


def test_short_spike_never_fires():
    """A breach shorter than for_s stays pending and ages out — the hold
    window IS the page-noise filter."""
    fc = FakeClock()
    eng, store, reg = make_engine(fc)
    eng.add_alert(name="p99", series="p99_ms", op=">", threshold=200.0,
                  for_s=5.0, window_s=60.0)
    drive(fc, store, eng, "p99_ms", 100.0, 2)
    trs = drive(fc, store, eng, "p99_ms", 500.0, 3)   # 3 s < for_s
    assert [t["to"] for t in trs] == ["pending"]
    trs = drive(fc, store, eng, "p99_ms", 100.0, 3)
    assert [(t["from"], t["to"]) for t in trs] == [("pending", "inactive")]
    assert reg.snapshot()["alerts_fired_total"] == 0


def test_for_s_zero_fires_immediately():
    fc = FakeClock()
    eng, store, _ = make_engine(fc)
    eng.add_alert(name="hot", series="g", op=">=", threshold=1.0,
                  for_s=0.0, window_s=10.0)
    trs = drive(fc, store, eng, "g", 2.0, 1)
    assert [t["to"] for t in trs] == ["firing"]


def test_rate_rule():
    """kind=rate compares the per-second increase — 'errors are
    climbing' without precomputing a gauge."""
    fc = FakeClock()
    eng, store, _ = make_engine(fc)
    eng.add_alert(name="err_rate", series="errors_total", kind="rate",
                  op=">", threshold=2.0, for_s=0.0, window_s=10.0)
    t = [0.0]
    for i in range(5):                      # +1/s: healthy
        fc.advance(1.0)
        t[0] += 1.0
        store.add("errors_total", t[0])
        assert eng.evaluate() == []
    for i in range(5):                      # +10/s: breach
        fc.advance(1.0)
        t[0] += 10.0
        store.add("errors_total", t[0])
    trs = eng.evaluate()
    assert [t_["to"] for t_ in trs] == ["firing"]
    assert eng.alerts()[0]["value"] > 2.0


def test_absence_rule():
    """kind=absence fires when a series goes stale — the half-dead
    scrape target the PR 11 lesson demands stays visible."""
    fc = FakeClock()
    eng, store, _ = make_engine(fc)
    eng.add_alert(name="target_gone", series="up", kind="absence",
                  window_s=5.0, for_s=0.0)
    # never-seen series is absent from the start
    fc.advance(1.0)
    assert [t["to"] for t in eng.evaluate()] == ["firing"]
    store.add("up", 1.0)
    assert [(t["from"], t["to"]) for t in eng.evaluate()] \
        == [("firing", "inactive")]
    # fresh samples keep it quiet; staleness past window_s re-fires
    drive(fc, store, eng, "up", 1.0, 4)
    assert eng.alerts()[0]["state"] == "inactive"
    trs = drive(fc, store, eng, None, None, 7)
    assert [t["to"] for t in trs] == ["firing"]
    assert eng.alerts()[0]["value"] > 5.0   # the observed staleness age


def test_no_data_is_not_a_threshold_breach():
    fc = FakeClock()
    eng, store, _ = make_engine(fc)
    eng.add_alert(name="p99", series="p99_ms", op=">", threshold=1.0,
                  for_s=0.0, window_s=10.0)
    fc.advance(1.0)
    assert eng.evaluate() == []
    assert eng.alerts()[0]["state"] == "inactive"


def test_quantile_fn_threshold_rule():
    """A threshold rule over quantile_over_time: the honest windowed p99
    straight from histogram buckets."""
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    store = TimeSeriesStore(clock=fc)
    eng = RuleEngine(store, registry=reg, clock=fc)
    eng.add_alert(name="lat_p99", series="lat_seconds",
                  fn="quantile_over_time", q=0.99, op=">",
                  threshold=0.05, for_s=0.0, window_s=20.0)
    h = reg.histogram("lat_seconds", start=1e-3, factor=2.0, buckets=12)
    from dcnn_tpu_torch.obs.tsdb import TsdbSampler
    sampler = TsdbSampler(store, registry=reg, clock=fc)
    sampler.add_after_sample(eng.evaluate)
    for _ in range(5):
        fc.advance(1.0)
        h.observe(0.002)
        sampler.sample_once()
    assert eng.alerts()[0]["state"] == "inactive"
    for _ in range(3):
        fc.advance(1.0)
        h.observe(0.2)
        sampler.sample_once()
    assert eng.alerts()[0]["state"] == "firing"


# -------------------------------------------------------- recording rules

def test_recording_rule_writes_series():
    fc = FakeClock()
    eng, store, _ = make_engine(fc)
    eng.add_recording(name="req_rate", series="reqs_total", fn="rate",
                      window_s=10.0)
    for i in range(6):
        fc.advance(1.0)
        store.add("reqs_total", 7.0 * (i + 1))
        eng.evaluate()
    assert store.latest("req_rate")[1] == pytest.approx(7.0)
    # recorded series are alertable like any other
    eng.add_alert(name="hot", series="req_rate", op=">", threshold=5.0,
                  for_s=0.0, window_s=10.0)
    fc.advance(1.0)
    store.add("reqs_total", 7.0 * 7)
    assert any(t["to"] == "firing" for t in eng.evaluate())


def test_broken_rule_counted_not_fatal():
    fc = FakeClock()
    eng, store, reg = make_engine(fc)
    eng.add_recording(RecordingRule(name="r", series="x", fn="rate",
                                    window_s=10.0))
    # a rule whose query raises must not kill the pass
    eng.add_alert(name="bad", series="h", fn="quantile_over_time",
                  q=0.99, op=">", threshold=1.0, window_s=10.0)
    store.quantile_over_time = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("boom"))
    fc.advance(1.0)
    assert eng.evaluate() == []
    assert reg.snapshot()["alert_eval_errors_total"] >= 1
    assert eng.alerts()[0]["last_error"] == "RuntimeError: boom"


# -------------------------------------------------- exposition + healthz

def test_prometheus_lines_and_metrics_text():
    fc = FakeClock()
    eng, store, reg = make_engine(fc)
    eng.add_alert(name="a", series="g", op=">", threshold=1.0,
                  for_s=0.0, window_s=10.0)
    eng.add_alert(name="b", series="g", op=">", threshold=100.0,
                  for_s=0.0, window_s=10.0)
    drive(fc, store, eng, "g", 5.0, 1)
    lines = eng.prometheus_lines()
    assert lines[0] == "# TYPE alert_state gauge"
    assert 'alert_state{rule="a"} 2' in lines
    assert 'alert_state{rule="b"} 0' in lines
    text = eng.metrics_text(reg.prometheus)()
    assert 'alert_state{rule="a"} 2' in text
    # the wrapped text still parses under the shared exposition parser
    from dcnn_tpu_torch.obs.exposition import parse_prometheus_text
    fams = parse_prometheus_text(text)
    samples = dict()
    for labels, v in fams["alert_state"]["samples"]:
        samples[labels["rule"]] = v
    assert samples == {"a": 2.0, "b": 0.0}


def test_rules_check_degrades_healthz_with_rule_name():
    fc = FakeClock()
    eng, store, reg = make_engine(fc)
    eng.add_alert(name="queue_deep", series="depth", op=">",
                  threshold=10.0, for_s=0.0, window_s=10.0)
    srv = TelemetryServer(registry=reg, clock=fc)
    srv.add_check("alerts", rules_check(eng))
    code, body = srv.health()
    assert code == 200
    drive(fc, store, eng, "depth", 50.0, 1)
    code, body = srv.health()
    assert code == 503
    assert any("queue_deep" in r for r in body["reasons"])
    drive(fc, store, eng, "depth", 1.0, 1)
    assert srv.health()[0] == 200


# ------------------------------------------------------- flight integration

def test_alert_firing_flight_bundle_carries_window(tmp_path):
    """The firing edge dumps ONE alert_firing bundle with the rule, the
    observed value, and the offending series' recent window — plus the
    store's full history.jsonl when attached."""
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    store = TimeSeriesStore(clock=fc)
    fl = FlightRecorder(str(tmp_path), registry=reg, clock=fc,
                        min_interval_s=0.0).attach_tsdb(store)
    eng = RuleEngine(store, registry=reg, flight=fl, clock=fc)
    eng.add_alert(name="p99", series="p99_ms", op=">", threshold=200.0,
                  for_s=2.0, window_s=60.0,
                  description="latency SLO")
    drive(fc, store, eng, "p99_ms", 100.0, 5)
    drive(fc, store, eng, "p99_ms", 900.0, 4)
    assert eng.alerts()[0]["state"] == "firing"
    bundles = fl.bundles()
    assert [b["trigger"] for b in bundles] == ["alert_firing"]
    bpath = bundles[0]["path"]
    cfg = json.load(open(os.path.join(bpath, "config.json")))
    assert cfg["rule"] == "p99" and cfg["threshold"] == 200.0
    extra = json.load(open(os.path.join(bpath, "extra.json")))
    assert extra["value"] == 900.0
    window_vals = [v for _, v in extra["window"]]
    assert 100.0 in window_vals and 900.0 in window_vals  # pre-trigger
    assert os.path.isfile(os.path.join(bpath, "history.jsonl"))
    # firing again after resolve dumps a second bundle, not per-tick spam
    drive(fc, store, eng, "p99_ms", 900.0, 5)
    assert len(fl.bundles()) == 1


# ------------------------------------------------------------- validation

def test_rule_validation():
    fc = FakeClock()
    eng, _, _ = make_engine(fc)
    with pytest.raises(ValueError):
        AlertRule(name="x", series="s", kind="weird")
    with pytest.raises(ValueError):
        AlertRule(name="x", series="s", op="!=")
    with pytest.raises(ValueError):
        AlertRule(name="x", series="s", fn="median")
    with pytest.raises(ValueError):
        AlertRule(name="x", series="s", for_s=-1)
    with pytest.raises(ValueError):
        RecordingRule(name="x", series="s", fn="nope")
    eng.add_alert(name="dup", series="s")
    with pytest.raises(ValueError):
        eng.add_alert(name="dup", series="s")


# ------------------------------------------------------------- parity

def test_rule_engine_parity_with_jax(tmp_path):
    """The same rules and the same sample stream (a threshold breach held
    past its window, a rate rule, a stale series, a recording rule)
    through both packages' engines on fake clocks: identical transitions
    each pass, alert docs, exposition lines and recorded series."""
    import numpy as np

    from dcnn_tpu.obs import rules as jr
    from dcnn_tpu.obs.flight import FlightRecorder as JaxFlight
    from dcnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
    from dcnn_tpu.obs.tsdb import TimeSeriesStore as JaxStore

    def engine(pkg):
        fc = FakeClock(100.0)
        if pkg == "port":
            store = TimeSeriesStore(clock=fc)
            eng = RuleEngine(store, registry=MetricsRegistry(clock=fc),
                             clock=fc, flight=FlightRecorder(
                                 str(tmp_path / "port"), clock=fc))
            mk_alert, mk_rec = AlertRule, RecordingRule
        else:
            store = JaxStore(clock=fc)
            eng = jr.RuleEngine(store, registry=JaxRegistry(clock=fc),
                                clock=fc, flight=JaxFlight(
                                    str(tmp_path / "jax"), clock=fc))
            mk_alert, mk_rec = jr.AlertRule, jr.RecordingRule
        eng.add_alert(mk_alert(name="hot", series="temp", op=">",
                               threshold=0.7, fn="avg_over_time",
                               window_s=5.0, for_s=3.0))
        eng.add_alert(mk_alert(name="errors", series="errs_total",
                               kind="rate", op=">", threshold=0.5,
                               window_s=4.0, for_s=0.0))
        eng.add_alert(mk_alert(name="stale", series="beat",
                               kind="absence", window_s=3.0))
        eng.add_recording(mk_rec(name="temp_max", series="temp",
                                 fn="max_over_time", window_s=6.0))
        return fc, store, eng

    rng = np.random.default_rng(3)
    runs = {p: engine(p) for p in ("port", "jax")}
    errs = 0.0
    for i in range(40):
        temp = float(rng.uniform(0.3, 1.0)) + (0.5 if 10 <= i < 20 else 0)
        errs += float(rng.integers(0, 3)) if i >= 25 else 0.0
        out = {}
        for pkg, (fc, store, eng) in runs.items():
            fc.advance(1.0)
            store.add("temp", temp)
            store.add("errs_total", errs)
            if i < 30:
                store.add("beat", 1.0)
            out[pkg] = eng.evaluate()
        assert out["port"] == out["jax"], (i, out)
    (_, sp, ep), (_, sj, ej) = runs["port"], runs["jax"]
    assert ep.alerts() == ej.alerts()
    assert ep.prometheus_lines() == ej.prometheus_lines()
    assert ep.firing() == ej.firing()
    assert sp.range("temp_max") == sj.range("temp_max")
    fired = sum(a["fired_total"] for a in ep.alerts())
    assert fired >= 3  # every kind fired at least once
