"""The port's fleet aggregation (``dcnn_tpu_torch/obs/fleet.py``) held to
the JAX package's ``tests/test_fleet.py`` case for case, and to the fleet
slot-goodput case of ``tests/test_goodput.py``, on the CPU.

- **Parity**: the same exposition texts (real ``ServeMetrics`` renders,
  hand-made scalars, a torn body, a dark target) go through both
  packages' ``FleetAggregator.poll``: the merged series' names and
  values (``m{replica=...}``, ``m{fleet="sum"}``, ``m{fleet="max"}``,
  ``fleet_target_up``), ``fleet_doc()`` without its timestamps and
  per-scrape durations, ``health_rollup()`` and the aggregator's own
  counters are equal.
- Live ephemeral-port targets: ``/fleet``, ``/alerts``, the roll-up
  ``/healthz`` and the per-rule ``alert_state`` lines; a half-dead and an
  unhealthy target; the poll-time health cache; a dead target costing one
  fetch; the server's per-endpoint self-observability.
- The autoscaler reads through its aggregator (the soak's history), and
  the three-replica latency-fault alert lifecycle end to end on a fake
  clock, with its ``alert_firing`` bundle read by the port's
  ``inspect_bundle``.

No case has a wall-clock bound.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import dcnn_tpu.obs.fleet as j_fleet
import dcnn_tpu.obs.registry as j_registry
import dcnn_tpu.serve.metrics as j_metrics
import dcnn_tpu.serve.soak as j_soak
import dcnn_tpu_torch.obs.fleet as t_fleet
import dcnn_tpu_torch.obs.registry as t_registry
from dcnn_tpu_torch.obs.fleet import FleetAggregator, HttpScraper
from dcnn_tpu_torch.obs.flight import FlightRecorder
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.obs.rules import RuleEngine
from dcnn_tpu_torch.obs.server import TelemetryServer
from dcnn_tpu_torch.obs.trace import inspect_bundle
from dcnn_tpu_torch.obs.tsdb import load_history
from dcnn_tpu_torch.serve.metrics import ServeMetrics
from dcnn_tpu_torch.serve.soak import (ManualClock,
                                       make_soak_replica_factory,
                                       run_diurnal_soak)
from dcnn_tpu_torch.serve.traffic import open_loop


def _get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.getcode(), json.loads(r.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


# --------------------------------------------------------------- parity

def _expositions(metrics_cls, fc):
    """Two replicas' real ``ServeMetrics`` renders: distinct completions,
    queue depths and slot seconds."""
    out = {}
    for name, n in (("r0", 3), ("r1", 5)):
        m = metrics_cls(clock=fc)
        for _ in range(n):
            m.record_submit(1)
            fc.advance(0.010)
            m.record_done(0.010)
        m.record_queue_depth(n)
        m.record_slot_state("occupied")
        fc.advance(0.5 * n)
        m.record_slot_state("idle")
        out[name] = m
    return out


def _agg_record(agg, reg):
    """What one aggregator shows: every series' latest value, the fleet
    doc without timestamps and scrape durations, the health roll-up and
    the aggregator's own counters."""
    store = agg.store
    series = {k: store.latest(k)[1] for k in store.series_names()}
    doc = agg.fleet_doc()
    for info in doc["targets"].values():
        info.pop("t"), info.pop("dur_s")
    counters = {k: v for k, v in reg.snapshot().items()
                if k.startswith("fleet_") and k != "fleet_scrape_seconds"}
    counters["scrapes_timed"] = reg.snapshot()["fleet_scrape_seconds"][
        "count"]
    return series, doc, agg.health_rollup(), counters


def _parity_run(fleet, registry, metrics_cls):
    fc = ManualClock()
    reps = _expositions(metrics_cls, fc)
    reg = registry.MetricsRegistry(clock=fc)
    agg = fleet.FleetAggregator(registry=reg, clock=fc)
    state = {"text": "ok_total 1\ng 2.5\n"}
    for name, m in reps.items():
        agg.add_target(name, scrape=m.prometheus)
    agg.add_target("flaky", scrape=lambda: state["text"])
    records = []
    for text in ("ok_total 1\ng 2.5\n", None, "torn{ garbage\n",
                 "ok_total 3\ng 0.5\n"):
        state["text"] = text
        fc.advance(1.0)
        res = agg.poll()
        records.append({n: {k: v for k, v in r.items() if k != "dur_s"}
                        for n, r in res.items()})
        records.append(_agg_record(agg, reg))
    # an explicit mapping is the fleet for this pass: r1 scaled away
    fc.advance(1.0)
    agg.poll(targets={"r0": reps["r0"].prometheus})
    records.append(_agg_record(agg, reg))
    return records


def test_poll_parity_with_jax():
    """The same texts through both packages' ``poll``: equal series,
    docs, roll-ups and counters, pass by pass."""
    want = _parity_run(j_fleet, j_registry, j_metrics.ServeMetrics)
    got = _parity_run(t_fleet, t_registry, ServeMetrics)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    series, doc, rollup, _ = got[-1]
    assert series['serve_queue_depth{fleet="sum"}'] == 3.0
    assert doc["slot_goodput"]["replicas"]["r0"]["goodput"] is not None
    assert rollup is None


def test_soak_aggregator_history_parity():
    """Both soaks' aggregator stores hold the same series with the same
    points (the ``history`` block's source)."""
    _, js, _ = j_soak.run_diurnal_soak(seconds=40.0, period=40.0,
                                       kill_at=20.0, canary_at=25.0)
    _, ts, _ = run_diurnal_soak(seconds=40.0, period=40.0, kill_at=20.0,
                                canary_at=25.0)
    jstore, tstore = js.aggregator.store, ts.aggregator.store
    assert tstore.series_names() == jstore.series_names()
    for k in jstore.series_names():
        assert tstore.range(k) == jstore.range(k), k


# ------------------------------------------------- render→parse→aggregate

def test_render_parse_aggregate_round_trip_real_expositions():
    fc = ManualClock()
    reps = {}
    for name, n_completed in (("r0", 3), ("r1", 5)):
        m = ServeMetrics(clock=fc)
        for _ in range(n_completed):
            m.record_submit(1)
            fc.advance(0.010)
            m.record_done(0.010)
        m.record_queue_depth(n_completed)
        reps[name] = m
    agg = FleetAggregator(registry=MetricsRegistry(clock=fc), clock=fc)
    for name, m in reps.items():
        agg.add_target(name, scrape=m.prometheus)
    res = agg.poll()
    assert all(r["values"] is not None for r in res.values())
    for name, m in reps.items():
        assert agg.store.latest(
            f'serve_queue_depth{{replica="{name}"}}')[1] \
            == m.snapshot()["queue_depth"]
    assert agg.store.latest('serve_queue_depth{fleet="sum"}')[1] == 8.0
    assert agg.store.latest('serve_queue_depth{fleet="max"}')[1] == 5.0
    assert agg.fleet_doc()["series"]["serve_queue_depth"] == {
        "replicas": {"r0": 3.0, "r1": 5.0}, "sum": 8.0, "max": 5.0}


def test_fleet_endpoints_over_live_ephemeral_servers():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.gauge("serve_queue_depth").set(2.0)
    r2.gauge("serve_queue_depth").set(6.0)
    s1 = TelemetryServer(registry=r1).start()
    s2 = TelemetryServer(registry=r2).start()
    freg = MetricsRegistry()
    agg = FleetAggregator(registry=freg)
    eng = RuleEngine(agg.store, registry=freg)
    eng.add_alert(name="deep", series='serve_queue_depth{fleet="max"}',
                  op=">", threshold=4.0, for_s=0.0, window_s=60.0)
    agg.rules = eng
    agg.add_target("r1", server=s1)
    agg.add_target("r2", url=s2.url)
    try:
        agg.poll()
        fsrv = agg.serve()
        assert agg.serve() is fsrv and agg.server is fsrv
        code, fleet = _get_json(f"{fsrv.url}/fleet")
        assert code == 200
        assert fleet["targets"]["r1"]["up"] and fleet["targets"]["r2"]["up"]
        assert fleet["series"]["serve_queue_depth"]["sum"] == 8.0
        assert fleet["polls"] == 1
        code, alerts = _get_json(f"{fsrv.url}/alerts")
        assert code == 200 and alerts["firing"] == ["deep"]
        code, health = _get_json(f"{fsrv.url}/healthz")
        assert code == 503
        assert any("deep" in r for r in health["reasons"])
        with urllib.request.urlopen(f"{fsrv.url}/metrics") as r:
            text = r.read().decode("utf-8")
        assert 'alert_state{rule="deep"} 2' in text
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{fsrv.url}/nope")
        assert "/fleet" in json.loads(e.value.read())["routes"]
    finally:
        agg.close()
        s1.stop()
        s2.stop()


def test_half_dead_target_is_visible():
    freg = MetricsRegistry()
    agg = FleetAggregator(registry=freg)
    state = {"text": "ok_total 1\n"}
    agg.add_target("good", scrape=lambda: "g 1\n")
    agg.add_target("flaky", scrape=lambda: state["text"])
    agg.poll()
    assert agg.health_rollup() is None
    state["text"] = None
    agg.poll()
    assert freg.snapshot()["fleet_scrape_errors_total"] == 1
    assert agg.store.latest('fleet_target_up{replica="flaky"}')[1] == 0.0
    assert agg.store.latest('fleet_target_up{replica="good"}')[1] == 1.0
    assert "flaky" in agg.health_rollup()
    state["text"] = "torn{ garbage\n"
    res = agg.poll()
    assert res["flaky"]["parse_error"] is not None
    assert freg.snapshot()["fleet_scrape_errors_total"] == 2
    assert "flaky" in agg.health_rollup()
    snap = freg.snapshot()
    assert snap["fleet_targets"] == 2 and snap["fleet_targets_up"] == 1
    assert snap["fleet_scrape_seconds"]["count"] >= 6


def test_unhealthy_target_degrades_rollup():
    srv = TelemetryServer(registry=MetricsRegistry())
    srv.add_check("stuck", lambda: "wedged on purpose")
    srv.start()
    agg = FleetAggregator(registry=MetricsRegistry())
    agg.add_target("r0", server=srv)
    try:
        agg.poll()
        rollup = agg.health_rollup()
        assert rollup is not None and "wedged on purpose" in rollup
    finally:
        agg.close()
        srv.stop()


def test_scrape_self_observability_per_endpoint():
    reg = MetricsRegistry()
    srv = TelemetryServer(registry=reg)
    srv.add_route("/boom", lambda: (_ for _ in ()).throw(
        RuntimeError("broken provider")))
    srv.start()
    try:
        for _ in range(2):
            urllib.request.urlopen(f"{srv.url}/metrics").read()
        _get_json(f"{srv.url}/healthz")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/boom")
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{srv.url}/unknown")
        snap = reg.snapshot()
        assert snap["scrape_requests_metrics_total"] == 2
        assert snap["scrape_requests_healthz_total"] == 1
        assert snap["scrape_requests_boom_total"] == 1
        assert snap["scrape_errors_boom_total"] == 1
        assert snap["scrape_requests_other_total"] == 1
        assert snap["scrape_requests_total"] == 5
        assert snap["scrape_errors_total"] == 1
        assert snap["scrape_duration_seconds"]["count"] == 5
        with urllib.request.urlopen(f"{srv.url}/metrics") as r:
            assert "scrape_requests_metrics_total 2" in r.read().decode()
    finally:
        srv.stop()


def test_http_scraper_reexport_and_add_route_guards():
    from dcnn_tpu_torch.obs import FleetAggregator as Lazy
    from dcnn_tpu_torch.obs import HttpScraper as LazyScraper
    from dcnn_tpu_torch.serve import HttpScraper as FromServe
    from dcnn_tpu_torch.serve.autoscale import HttpScraper as FromAutoscale
    assert FromAutoscale is HttpScraper is FromServe is LazyScraper
    assert Lazy is FleetAggregator
    srv = TelemetryServer(registry=MetricsRegistry())
    with pytest.raises(ValueError):
        srv.add_route("no-slash", dict)
    with pytest.raises(ValueError):
        srv.add_route("/metrics", dict)
    agg = FleetAggregator(registry=MetricsRegistry())
    with pytest.raises(ValueError):
        agg.add_target("x")
    agg.add_target("x", scrape=lambda: None)
    with pytest.raises(ValueError):
        agg.add_target("x", scrape=lambda: None)
    agg.remove_target("x")
    assert agg.targets() == []
    assert repr(agg) == "FleetAggregator(targets=0, polls=0)"


def test_dynamic_targets_evict_from_last_poll_view():
    agg = FleetAggregator(registry=MetricsRegistry())
    agg.poll(targets={"r0": lambda: "g 1\n", "r1": lambda: None})
    assert "r1" in agg.health_rollup()
    agg.poll(targets={"r0": lambda: "g 2\n"})
    assert agg.health_rollup() is None
    assert set(agg.fleet_doc()["targets"]) == {"r0"}


def test_health_rollup_reads_poll_cache_not_live(monkeypatch):
    srv = TelemetryServer(registry=MetricsRegistry())
    srv.add_check("stuck", lambda: "wedged")
    srv.start()
    agg = FleetAggregator(registry=MetricsRegistry())
    agg.add_target("r0", server=srv)
    try:
        agg.poll()
        monkeypatch.setattr(
            agg, "_fetch_healthz",
            lambda spec: (_ for _ in ()).throw(
                AssertionError("roll-up must not fetch live")))
        assert "wedged" in agg.health_rollup()
    finally:
        agg.close()
        srv.stop()


def test_replica_flight_bundles_carry_history(tmp_path):
    """A serve-side bundle carries history.jsonl with the exposition's
    windowed gauges, read back by ``load_history`` and the port's
    ``inspect_bundle``; shutdown detaches only the batcher's own store."""
    from dcnn_tpu_torch.obs.flight import get_flight_recorder
    from dcnn_tpu_torch.serve.batcher import DynamicBatcher
    from dcnn_tpu_torch.serve.soak import SyntheticEngine

    rec = get_flight_recorder()
    old = rec.directory, rec._tsdb
    rec.directory, rec._tsdb = str(tmp_path), None
    batcher = DynamicBatcher(SyntheticEngine(), start=False)
    try:
        batcher.start_telemetry(port=0)
        assert rec._tsdb is batcher._tsdb.store
        fut = batcher.submit(np.full((4,), 7, np.float32))
        batcher.step(force=True)
        np.testing.assert_array_equal(fut.result(), np.full((4,), 8.0))
        batcher._tsdb.sample_once()
        path = rec.record("healthz_degraded", reasons=["test"])
        assert path is not None
        assert "history.jsonl" in os.listdir(path)
        _meta, series = load_history(os.path.join(path, "history.jsonl"))
        for k in ("serve_latency_window_p99_ms", "serve_shed_fraction",
                  "serve_queue_depth"):
            assert k in series
        assert inspect_bundle(path)["history"]["series"] > 0
    finally:
        batcher.shutdown(drain=False)
        assert rec._tsdb is None
        rec.directory, rec._tsdb = old


def test_dead_target_costs_one_timeout_no_healthz_fetch(monkeypatch):
    agg = FleetAggregator(registry=MetricsRegistry())
    agg.add_target("dead", url="http://127.0.0.1:9")
    agg.add_target("live", scrape=lambda: "g 1\n")
    monkeypatch.setattr(
        agg, "_fetch_healthz",
        lambda spec: (_ for _ in ()).throw(
            AssertionError("healthz must not be fetched for a dead "
                           "target")))
    res = agg.poll()
    assert res["live"]["values"] == {"g": 1.0}
    assert not res["dead"]["fetched"]
    assert "dead" in agg.health_rollup()


def test_http_scraper_against_a_live_target_and_a_dead_one():
    reg = MetricsRegistry()
    reg.gauge("serve_queue_depth").set(4.0)
    srv = TelemetryServer(registry=reg).start()
    try:
        scraper = HttpScraper({"r0": srv.url, "gone": "http://127.0.0.1:9"},
                              timeout_s=2.0)
        assert "serve_queue_depth 4" in scraper("r0")
        assert scraper.healthz("r0")["status"] == "ok"
        assert scraper("gone") is None and scraper.healthz("gone") is None
        assert scraper("unknown") is None
    finally:
        srv.stop()


def test_trailing_slash_counts_as_other_not_endpoint():
    reg = MetricsRegistry()
    srv = TelemetryServer(registry=reg).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/healthz/")
        assert e.value.code == 404
        snap = reg.snapshot()
        assert snap.get("scrape_requests_healthz_total", 0) == 0
        assert snap["scrape_requests_other_total"] == 1
    finally:
        srv.stop()


def test_hyphenated_route_slug_mints_valid_counters():
    reg = MetricsRegistry()
    srv = TelemetryServer(registry=reg)
    srv.add_route("/my-route", lambda: {"ok": True})
    srv.start()
    try:
        _get_json(f"{srv.url}/my-route")
        snap = reg.snapshot()
        assert snap["scrape_requests_my_route_total"] == 1
        assert snap["scrape_requests_total"] == 1
    finally:
        srv.stop()


def test_fleet_slot_goodput_aggregation_skips_non_serving():
    """The twin of the fleet slot case of ``tests/test_goodput.py``, held
    to the JAX roll-up too."""
    last = {
        "replica-a": {"values": {"serve_slot_occupied_seconds_total": 6.0,
                                 "serve_slot_idle_seconds_total": 3.0,
                                 "serve_slot_draining_seconds_total": 1.0}},
        "replica-b": {"values": {"serve_slot_occupied_seconds_total": 2.0,
                                 "serve_slot_idle_seconds_total": 8.0,
                                 "serve_slot_draining_seconds_total": 0.0}},
        "trainer": {"values": {"goodput_fraction": 0.9}},
    }
    doc = FleetAggregator._slot_goodput(last)
    assert set(doc["replicas"]) == {"replica-a", "replica-b"}
    assert doc["replicas"]["replica-a"]["goodput"] == pytest.approx(0.6)
    assert doc["fleet"]["goodput"] == pytest.approx(8.0 / 20.0)
    assert doc == j_fleet.FleetAggregator._slot_goodput(last)
    assert FleetAggregator._slot_goodput({})["fleet"]["goodput"] is None


# ---------------------------------------------- autoscaler-on-aggregator

def test_autoscaler_reads_through_aggregator():
    report, scaler, router = run_diurnal_soak()
    assert report["silently_dropped"] == 0
    assert report["availability"] >= 0.999, report
    assert report["scale_ups"] >= 2, report
    store = scaler.aggregator.store
    assert store.points() > 0
    assert any(k.startswith("serve_latency_window_p99_ms{replica=")
               for k in store.series_names())
    assert store.latest('serve_queue_depth{fleet="sum"}') is not None
    hist = report["history"]
    assert hist["series"] > 0 and hist["points"] > 0
    assert hist["p99_ms_max"]["points"] > 0
    snap = router.metrics.registry.snapshot()
    assert snap["fleet_polls_total"] > 0
    assert snap["fleet_scrape_requests_total"] > 0


# -------------------------------------------------- the alert lifecycle

def test_e2e_three_replica_fleet_latency_fault_alert_lifecycle(tmp_path):
    """Three in-process replicas under open-loop load with an injected
    latency fault: the p99 alert goes pending then firing within its
    ``for_s``, the fleet /healthz degrades naming the rule, an
    ``alert_firing`` bundle carries the pre-trigger history, /fleet
    serves the merged labeled series, and removing the fault resolves
    the alert. Sleep-free."""
    fc = ManualClock()
    factory = make_soak_replica_factory(fc, queue_capacity=64, window=32)
    state = {"slow": False}
    replicas = [factory(1) for _ in range(3)]

    def pump_all():
        for rep in replicas:
            try:
                rep.step(force=True)
            except Exception:
                pass

    class RoundRobin:
        def __init__(self):
            self.i = 0

        def submit(self, x):
            self.i += 1
            return replicas[self.i % len(replicas)].submit(x)

    router = RoundRobin()
    freg = MetricsRegistry(clock=fc)
    fl = FlightRecorder(str(tmp_path), registry=freg, clock=fc,
                        min_interval_s=0.0)
    agg = FleetAggregator(registry=freg, clock=fc)
    fl.attach_tsdb(agg.store)
    eng = RuleEngine(agg.store, registry=freg, flight=fl, clock=fc)
    FOR_S, TICK = 3.0, 1.0
    eng.add_alert(name="fleet_p99_slo",
                  series='serve_latency_window_p99_ms{fleet="max"}',
                  op=">", threshold=200.0, for_s=FOR_S, window_s=30.0,
                  description="fleet p99 over SLO")
    agg.rules = eng
    for rep in replicas:
        agg.add_target(rep.name, scrape=rep.metrics.prometheus)
    fsrv = agg.serve()
    try:
        nxt = {"pump": 0.0, "poll": 0.0}
        alert_log = []

        def drive_sleep(dt):
            t_end = fc.t + dt
            while fc.t < t_end:
                t = min(t_end, nxt["pump"], nxt["poll"])
                if fc.t < t:
                    fc.advance(t - fc.t)
                if fc.t >= nxt["pump"]:
                    pump_all()
                    nxt["pump"] += 0.8 if state["slow"] else 0.05
                if fc.t >= nxt["poll"]:
                    agg.poll()
                    st = eng.alerts()[0]
                    if not alert_log or alert_log[-1][1] != st["state"]:
                        alert_log.append((fc.t, st["state"]))
                    nxt["poll"] += TICK

        samples = [np.full((4,), 7, np.float32)]
        open_loop(router, samples, 40.0, 10.0, clock=fc, sleep=drive_sleep)
        assert eng.alerts()[0]["state"] == "inactive"
        state["slow"] = True
        open_loop(router, samples, 40.0, 12.0, clock=fc, sleep=drive_sleep)
        states = [s for _, s in alert_log]
        assert "pending" in states and "firing" in states
        t_pending = next(t for t, s in alert_log if s == "pending")
        t_firing = next(t for t, s in alert_log if s == "firing")
        assert FOR_S <= t_firing - t_pending <= FOR_S + 2 * TICK, alert_log
        code, health = _get_json(f"{fsrv.url}/healthz")
        assert code == 503
        assert any("fleet_p99_slo" in r for r in health["reasons"])
        code, fleet = _get_json(f"{fsrv.url}/fleet")
        assert code == 200
        row = fleet["series"]["serve_latency_window_p99_ms"]
        assert set(row["replicas"]) == {r.name for r in replicas}
        assert row["max"] > 200.0
        code, alerts = _get_json(f"{fsrv.url}/alerts")
        assert alerts["firing"] == ["fleet_p99_slo"]
        bundles = fl.bundles()
        assert [b["trigger"] for b in bundles] == ["alert_firing"]
        bpath = bundles[0]["path"]
        with open(os.path.join(bpath, "extra.json")) as f:
            window_ts = [t for t, _ in json.load(f)["window"]]
        assert window_ts and min(window_ts) < t_firing
        _meta, series = load_history(os.path.join(bpath, "history.jsonl"))
        assert any(k.startswith("serve_latency_window_p99_ms{replica=")
                   for k in series)
        assert inspect_bundle(bpath)["history"]["series"] > 0
        state["slow"] = False
        open_loop(router, samples, 40.0, 30.0, clock=fc, sleep=drive_sleep)
        assert eng.alerts()[0]["state"] == "inactive", alert_log
        assert eng.alerts()[0]["resolved_total"] == 1
        code, _ = _get_json(f"{fsrv.url}/healthz")
        assert code == 200
    finally:
        agg.close()
        for rep in replicas:
            try:
                rep.close()
            except Exception:
                pass
