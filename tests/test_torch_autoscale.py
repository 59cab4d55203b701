"""The port's autoscaler (``dcnn_tpu_torch/serve/autoscale.py``), its
elastic-training twin (``parallel/autoscale.py``) and the shared soak
(``serve/soak.py``), held to the JAX package's ``tests/test_autoscale.py``
case for case, on the CPU.

Every case is a *scenario*: one function that drives a package through
the reference test's script, asserts the reference test's contract and
returns a record of what it observed (actions, fleet sizes, counters,
lease accounting). :func:`twin` runs it through both packages, the JAX
one first, and requires equal records. Fake clocks throughout; the
host-timed entries of a registry snapshot (its ``_wall_s`` and the
aggregator's ``fleet_scrape_seconds``) are left out of a record.

- **Rate schedules and open-loop pacing** (``serve/traffic.py``).
- **Graceful scale-down**: the five ``Router.decommission`` cases.
- **Device leases**: the strict-priority broker, the training lease's
  floor, the deferred and declined revocations of
  ``LeasedElasticTrainer``.
- **Control loop**: scale-up on breach, cooldowns, the HBM watermark
  guard (a scrape that carries ``hbm_bytes_*``; ``ServeMetrics`` carries
  none in either package), lease blocking, reaping, victims, the
  down-guard, parse failures, repair.
- **The diurnal soak**: ``run_diurnal_soak()`` on both packages'
  ``ManualClock``s gives equal reports, key by key, ``history`` included;
  the real-clock variant stays ``slow`` as its twin is.
- **Device-lease handoff**: serving's scale-up revokes a device from a
  live elastic world of 2 that shrinks to 1 and keeps training; the
  world regrows from the newest commit. Run through both packages with
  the JAX test's dense model and with a 1-layer flash ``mha_classifier``
  (S=8, E=16); final params within the JAX test's
  ``RTOL, ATOL = 2e-4, 2e-5`` of an uninterrupted fixed-world run of the
  same package, and of the other package's leased run.
"""

import functools
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import dcnn_tpu.obs.exposition as j_expo
import dcnn_tpu.obs.registry as j_registry
import dcnn_tpu.obs.server as j_server
import dcnn_tpu.parallel as j_parallel
import dcnn_tpu.parallel.elastic as j_elastic
import dcnn_tpu.serve as j_serve
import dcnn_tpu.serve.batcher as j_batcher
import dcnn_tpu.serve.replica as j_replica
import dcnn_tpu.serve.soak as j_soak
import dcnn_tpu_torch.obs.exposition as t_expo
import dcnn_tpu_torch.obs.registry as t_registry
import dcnn_tpu_torch.obs.server as t_server
import dcnn_tpu_torch.parallel as t_parallel
import dcnn_tpu_torch.parallel.elastic as t_elastic
import dcnn_tpu_torch.serve as t_serve
import dcnn_tpu_torch.serve.batcher as t_batcher
import dcnn_tpu_torch.serve.replica as t_replica
import dcnn_tpu_torch.serve.soak as t_soak

RTOL, ATOL = 2e-4, 2e-5  # the elastic reshard's FP-reassociation bound


def _package(name, serve, soak, registry, expo, server, batcher, replica,
             parallel, elastic):
    P = SimpleNamespace(name=name)
    for n in serve.__all__:
        setattr(P, n, getattr(serve, n))
    P.FakeClock = soak.ManualClock
    P.make_replica_factory = soak.make_soak_replica_factory
    P.run_diurnal_soak = soak.run_diurnal_soak
    P.fake_engine_factory = soak.synthetic_engine_factory
    P.MetricsRegistry = registry.MetricsRegistry
    P.render_scalar = expo.render_scalar
    P.parse_prometheus_text = expo.parse_prometheus_text
    P.scalar_values = expo.scalar_values
    P.TelemetryServer = server.TelemetryServer
    P.DynamicBatcher = batcher.DynamicBatcher
    P.ReplicaError = replica.ReplicaError
    P.TrainLease = parallel.TrainLease
    P.LeasedElasticTrainer = parallel.LeasedElasticTrainer
    P.PreemptedError = elastic.PreemptedError
    return P


JAX = _package("jax", j_serve, j_soak, j_registry, j_expo, j_server,
               j_batcher, j_replica, j_parallel, j_elastic)
TORCH = _package("torch", t_serve, t_soak, t_registry, t_expo, t_server,
                 t_batcher, t_replica, t_parallel, t_elastic)


def twin(scenario, *args):
    """Run ``scenario(P, *args)`` through the JAX package, then the port;
    the two records must be equal. Returns the port's record."""
    want = scenario(JAX, *args)
    got = scenario(TORCH, *args)
    assert got == want, (got, want)
    return got


def snap(registry):
    """A registry snapshot without its host-timed entries: the snapshot's
    own ``_wall_s`` and the scrape histogram."""
    return {k: v for k, v in registry.snapshot().items()
            if k != "_wall_s" and not k.startswith("fleet_scrape_seconds")}


def served(futs):
    """Each future's result as a list, or its error's type name."""
    out = []
    for f in futs:
        f = f[1] if isinstance(f, tuple) else f
        if not f.done():
            out.append("undone")
        elif f.exception() is not None:
            out.append(type(f.exception()).__name__)
        else:
            out.append(np.asarray(f.result()).tolist())
    return out


# ------------------------------------------------------------ rate schedules

def s_schedules(P):
    rate = P.diurnal(400.0, 40.0, period_s=600.0)
    assert rate(0.0) == pytest.approx(40.0)
    assert rate(300.0) == pytest.approx(400.0)
    assert rate(600.0) == pytest.approx(40.0)
    assert rate(300.0) / rate(0.0) == pytest.approx(10.0)
    with pytest.raises(ValueError, match="trough"):
        P.diurnal(10.0, 20.0, period_s=60.0)
    r = P.spike(10.0, 100.0, at_s=5.0, width_s=2.0)
    assert r(4.9) == 10.0 and r(5.0) == 100.0
    assert r(6.9) == 100.0 and r(7.0) == 10.0
    s = P.step([(0.0, 5.0), (10.0, 50.0), (20.0, 2.0)])
    assert s(0.0) == 5.0 and s(9.9) == 5.0
    assert s(10.0) == 50.0 and s(25.0) == 2.0
    with pytest.raises(ValueError, match="start at t=0"):
        P.step([(1.0, 5.0)])
    return [rate(t) for t in np.linspace(0, 600, 13)]


def test_diurnal_spike_and_step_schedules():
    twin(s_schedules)


class _Sink:
    def __init__(self, fc=None):
        self.fc, self.times = fc, []

    def submit(self, x):
        from concurrent.futures import Future
        if self.fc is not None:
            self.times.append(self.fc.t)
        f = Future()
        f.set_result(x)
        return f


def s_open_loop_pacing(P):
    fc = P.FakeClock()
    sink = _Sink(fc)
    rate = P.step([(0.0, 10.0), (5.0, 100.0)])
    P.open_loop(sink, [np.zeros(4, np.float32)], rate, 10.0,
                clock=fc, sleep=fc.advance)
    first = sum(1 for t in sink.times if t < 4.99)
    second = sum(1 for t in sink.times if t >= 4.99)
    assert abs(first - 50) <= 1 and abs(second - 500) <= 1
    sink2 = _Sink(fc)
    fc.t = 0.0
    P.open_loop(sink2, [np.zeros(4, np.float32)], 20.0, 2.0,
                clock=fc, sleep=fc.advance)
    assert len(sink2.times) == 40
    fc.t = 0.0
    with pytest.raises(ValueError, match="rounds to zero"):
        P.open_loop(_Sink(), [np.zeros(4, np.float32)],
                    P.step([(0.0, 10.0), (1.0, float("inf"))]), 5.0,
                    clock=fc, sleep=fc.advance)
    return [first, second, sink.times[:20]]


def test_open_loop_paces_to_the_schedule_and_rejects_too_fast():
    twin(s_open_loop_pacing)


# --------------------------------------------------- graceful decommission
# The scale-down path the autoscaler stands on: twins of the five
# Router.decommission cases.

def make_fleet(P, n=3, *, queue_capacity=16, pump_on_sleep=True):
    fc = P.FakeClock()
    factory = P.make_replica_factory(fc, queue_capacity=queue_capacity,
                                     prefix="r")
    reps = [factory(1) for _ in range(n)]

    def sleep(dt):
        fc.advance(dt)
        if pump_on_sleep:
            for r in reps:
                try:
                    r.step(force=True)
                except Exception:
                    pass
    router = P.Router(reps, clock=fc, sleep=sleep)
    return router, reps, fc


def pump(reps, rounds=4):
    for _ in range(rounds):
        for r in reps:
            try:
                while r.step():
                    pass
            except Exception:
                pass


def s_decommission_drains_then_removes(P):
    router, reps, _fc = make_fleet(P, 3)
    futs = [router.submit(np.full((4,), i, np.float32)) for i in range(24)]
    victim = reps[0].name
    report = router.decommission(victim, timeout=5.0)
    assert victim not in router.replica_names()
    assert report["swept"] == 0
    pump(reps)
    assert router.outstanding() == 0
    for f in futs:
        assert f.done() and f.exception() is None
    s = router.metrics.registry.snapshot()
    assert s["serve_router_decommissions_total"] == 1
    assert s["serve_router_decommission_sweeps_total"] == 0
    return [report, served(futs), router.replica_names()]


def test_decommission_drains_then_removes():
    twin(s_decommission_drains_then_removes)


def s_decommission_stops_admission(P):
    router, reps, _fc = make_fleet(P, 2, pump_on_sleep=False)
    report = router.decommission(reps[0].name, timeout=1.0)
    for i in range(8):
        router.submit(np.full((4,), i, np.float32))
    pump(reps)
    stats = router.replica_stats()
    assert reps[0].name not in stats
    assert stats[reps[1].name]["completed"] == 8
    return [report, sorted(stats)]


def test_decommission_stops_admission_to_victim_immediately():
    twin(s_decommission_stops_admission)


def s_kill_draining_replica(P):
    router, reps, fc = make_fleet(P, 2, pump_on_sleep=False)
    victim = reps[0]
    futs = [router.submit(np.full((4,), i, np.float32)) for i in range(16)]
    kills = [0]

    def killer_sleep(dt):
        fc.advance(dt)
        if kills[0] == 0:
            kills[0] = 1
            victim.kill()
        pump([reps[1]])
    router._sleep = killer_sleep
    report = router.decommission(victim.name, timeout=5.0)
    pump([reps[1]])
    assert router.outstanding() == 0
    assert [f for f in futs if not f.done()] == []
    assert sum(1 for f in futs if f.exception() is None) == 16
    assert victim.name not in router.replica_names()
    return [report, served(futs)]


def test_kill_draining_replica_mid_decommission_no_silent_drops():
    twin(s_kill_draining_replica)


def s_decommission_timeout_sweeps(P):
    router, reps, fc = make_fleet(P, 2, pump_on_sleep=False)
    futs = [router.submit(np.full((4,), i, np.float32)) for i in range(8)]

    def sleep(dt):
        fc.advance(dt)
        pump([reps[1]])
    router._sleep = sleep
    report = router.decommission(reps[0].name, timeout=0.5)
    pump([reps[1]])
    assert router.outstanding() == 0
    assert all(f.done() for f in futs)
    assert sum(1 for f in futs if f.exception() is None) == 8
    s = router.metrics.registry.snapshot()
    if report["swept"]:
        assert s["serve_router_decommission_sweeps_total"] == 1
    return [report, served(futs),
            s["serve_router_decommission_sweeps_total"]]


def test_decommission_timeout_sweeps_typed():
    twin(s_decommission_timeout_sweeps)


def s_draining_not_flapped(P):
    router, reps, _fc = make_fleet(P, 2, pump_on_sleep=False)
    victim = reps[0]
    for i in range(4):
        router.submit(np.full((4,), i, np.float32))
    done = []
    t = threading.Thread(
        target=lambda: done.append(
            router.decommission(victim.name, timeout=None)), daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        stats = router.replica_stats()
        if victim.name in stats \
                and stats[victim.name]["state"] == "draining":
            break
        time.sleep(0.005)
    report = router.check_replicas()
    assert "draining" in report[victim.name]
    assert router.replica_stats()[victim.name]["state"] == "draining"
    with pytest.raises(P.ReplicaError, match="decommissioned"):
        router.swap_replica(victim.name, 2)
    pump(reps)
    t.join(timeout=5.0)
    assert not t.is_alive() and done
    return [report, done]


def test_draining_replica_not_flapped_up_by_sweep():
    twin(s_draining_not_flapped)


def s_swap_does_not_resurrect(P):
    fc = P.FakeClock()
    factory = P.make_replica_factory(fc, prefix="r")
    reps = [factory(1) for _ in range(2)]
    router = P.Router(reps, clock=fc, sleep=lambda s: fc.advance(s),
                      metrics=P.RouterMetrics(clock=fc))
    orig_swap = reps[0].swap

    def racing_swap(version):
        with router._lock:
            router._handles[reps[0].name].state = "draining"
        return orig_swap(version)

    reps[0].swap = racing_swap
    router.swap_replica(reps[0].name, 2)
    st = router.replica_stats()[reps[0].name]
    assert st["state"] == "draining" and st["version"] == 2
    return st


def test_swap_completion_does_not_resurrect_draining_replica():
    twin(s_swap_does_not_resurrect)


# ------------------------------------------------------- device-lease broker

def s_broker(P):
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(4, registry=reg)
    revokes = []
    broker.register("train", priority=0, held=3,
                    on_revoke=lambda k: revokes.append(k))
    broker.register("serve", priority=1, held=1)
    assert broker.free() == 0
    assert broker.request("serve", 1) == 0
    assert revokes == [1] and broker.revoke_pending("train") == 1
    assert broker.request("serve", 1) == 0
    assert revokes == [1]
    broker.release("train", 1)
    assert broker.revoke_pending("train") == 0
    assert broker.request("serve", 1) == 1
    assert broker.held("serve") == 2 and broker.held("train") == 2
    broker.release("serve", 1)
    assert broker.request("train", 1) == 1
    revokes.clear()
    assert broker.request("train", 1) == 0
    assert revokes == []
    with pytest.raises(ValueError, match="cannot release"):
        broker.release("serve", 99)
    with pytest.raises(KeyError):
        broker.request("ghost", 1)
    assert reg.snapshot()["lease_revocations_total"] == 1
    return [snap(reg), repr(broker)]


def test_broker_grant_release_and_priority_revocation():
    twin(s_broker)


def s_train_lease_floor(P):
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(2, registry=reg)
    lease = P.TrainLease(broker, initial=2, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=0)
    seen = []
    lease.add_listener(seen.append)
    assert broker.request("serve", 2) == 0
    assert seen == [1]
    lease.surrender(1)
    assert broker.request("serve", 2) == 1
    assert lease.held() == 1
    assert broker.request("serve", 1) == 0
    assert seen == [1]
    assert reg.snapshot()["train_lease_preemptions_total"] == 1
    return snap(reg)


def test_train_lease_floor_and_listener():
    twin(s_train_lease_floor)


# ------------------------------------------------------- control-loop units

def _breach_text(P, p99=1000.0, depth=30.0, shed=0.0, hbm=None):
    lines = []
    lines += P.render_scalar("serve_queue_depth", "gauge", depth)
    lines += P.render_scalar("serve_latency_window_p99_ms", "gauge", p99)
    lines += P.render_scalar("serve_shed_fraction", "gauge", shed)
    if hbm is not None:
        lines += P.render_scalar("hbm_bytes_in_use", "gauge", hbm * 100.0)
        lines += P.render_scalar("hbm_bytes_limit", "gauge", 100.0)
    return "\n".join(lines) + "\n"


def _idle_text(P):
    return _breach_text(P, p99=1.0, depth=0.0)


def make_scaler(P, fc, *, cfg=None, scrape=None, broker=None, n_boot=1,
                factory=None):
    factory = factory if factory is not None \
        else P.make_replica_factory(fc)
    reps = [factory(1) for _ in range(n_boot)]
    router = P.Router(reps, clock=fc, sleep=lambda s: fc.advance(s),
                      metrics=P.RouterMetrics(clock=fc))
    scaler = P.Autoscaler(
        router, factory,
        config=cfg if cfg is not None else P.AutoscalerConfig(
            up_cooldown_s=0.0, down_cooldown_s=0.0, breach_ticks=1,
            idle_ticks=2, max_replicas=4),
        broker=broker, clock=fc,
        scrape=scrape if scrape is not None else (lambda n, r: None))
    return scaler, router, reps


def _turn(out):
    """A tick's answer without the drain report's host-timed fields."""
    return {k: v for k, v in out.items() if k != "drain"}


def s_http_scraper(P):
    b = P.DynamicBatcher(P.fake_engine_factory(1), start=False)
    srv = b.start_telemetry()
    degraded = P.TelemetryServer(registry=P.MetricsRegistry())
    degraded.add_check("scaler", lambda: "scale-up blocked: no lease")
    degraded.start()
    try:
        fut = b.submit(np.zeros((4,), np.float32))
        b.step()
        fut.result(timeout=10)
        scraper = P.HttpScraper({"r0": srv.url, "bad": degraded.url,
                                 "gone": "http://127.0.0.1:9"})
        vals = P.scalar_values(P.parse_prometheus_text(scraper("r0", None)))
        assert vals["serve_samples_completed_total"] == 1
        assert "serve_queue_depth" in vals
        assert scraper.healthz("r0")["status"] == "ok"
        body = scraper.healthz("bad")
        assert body["status"] == "unhealthy"
        assert any("no lease" in r for r in body["reasons"])
        assert scraper("gone", None) is None
        assert scraper.healthz("gone") is None
        assert scraper("unknown", None) is None
    finally:
        degraded.stop()
        b.shutdown(drain=False)
    return [sorted(vals), body["reasons"]]


def test_http_scraper_reads_real_telemetry_endpoints():
    twin(s_http_scraper)


def s_up_on_breach_down_when_idle(P):
    fc = P.FakeClock()
    mode = {"text": _breach_text(P)}
    scaler, router, _ = make_scaler(P, fc, scrape=lambda n, r: mode["text"])
    outs = [scaler.tick()]
    assert outs[-1]["action"] == "up" and len(router.replica_names()) == 2
    fc.advance(1.0)
    mode["text"] = _idle_text(P)
    outs.append(scaler.tick())
    assert outs[-1]["action"] == "hold"
    fc.advance(1.0)
    outs.append(scaler.tick())
    assert outs[-1]["action"] == "down"
    assert len(router.replica_names()) == 1
    fc.advance(1.0)
    outs.append(scaler.tick())
    fc.advance(1.0)
    outs.append(scaler.tick())
    assert outs[-1]["action"] == "hold"
    assert len(router.replica_names()) == 1
    s = snap(router.metrics.registry)
    assert s["autoscale_scale_ups_total"] == 1
    assert s["autoscale_scale_downs_total"] == 1
    return [[_turn(o) for o in outs], s, scaler.snapshot()]


def test_scaler_scales_up_on_breach_and_down_when_idle():
    twin(s_up_on_breach_down_when_idle)


def s_cooldowns(P):
    fc = P.FakeClock()
    cfg = P.AutoscalerConfig(up_cooldown_s=10.0, breach_ticks=2,
                             max_replicas=4)
    scaler, router, _ = make_scaler(P, fc, cfg=cfg,
                                    scrape=lambda n, r: _breach_text(P))
    acts = [scaler.tick()["action"]]
    for dt in (1.0, 1.0, 10.0):
        fc.advance(dt)
        acts.append(scaler.tick()["action"])
    assert acts == ["hold", "up", "hold", "up"]
    assert len(router.replica_names()) == 3
    return [acts, snap(router.metrics.registry)]


def test_scaler_cooldowns_and_breach_ticks():
    twin(s_cooldowns)


def s_hbm_guard(P):
    fc = P.FakeClock()
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: _breach_text(P, hbm=0.97))
    out = scaler.tick()
    assert out["action"] == "blocked" and out["reason"] == "hbm watermark"
    assert len(router.replica_names()) == 1
    reason = P.autoscale_check(scaler)()
    assert "hbm" in (reason or "")
    assert router.metrics.registry.snapshot()[
        "autoscale_hbm_blocked_total"] == 1
    scaler.scrape = lambda n, r: _idle_text(P)
    fc.advance(1.0)
    scaler.tick()
    assert P.autoscale_check(scaler)() is None
    return [out, reason]


def test_scaler_hbm_watermark_guard_blocks_up():
    twin(s_hbm_guard)


def s_lease_blocked_then_granted(P):
    fc = P.FakeClock()
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(2, registry=reg)
    broker.register("other", priority=0, held=1)
    broker.register("serve", priority=1, held=1)
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: _breach_text(P), broker=broker)
    outs = [scaler.tick()]
    assert outs[-1]["action"] == "blocked"
    assert outs[-1]["reason"] == "awaiting lease"
    assert "lease" in P.autoscale_check(scaler)()
    broker.release("other", 1)
    fc.advance(1.0)
    outs.append(scaler.tick())
    assert outs[-1]["action"] == "up" and broker.held("serve") == 2
    fc.advance(1.0)
    idle = _idle_text(P)
    scaler.scrape = lambda n, r: idle
    outs.append(scaler.tick())
    fc.advance(1.0)
    outs.append(scaler.tick())
    assert outs[-1]["action"] == "down"
    assert broker.held("serve") == 1 and broker.free() == 1
    return [[_turn(o) for o in outs], snap(reg)]


def test_scaler_lease_blocked_then_granted():
    twin(s_lease_blocked_then_granted)


def s_reaps_dead_owned(P):
    fc = P.FakeClock()
    broker = P.DeviceLeaseBroker(2, registry=P.MetricsRegistry())
    broker.register("serve", priority=1, held=1)
    mode = {"text": _breach_text(P)}
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: mode["text"], broker=broker)
    out = scaler.tick()
    assert out["action"] == "up" and broker.held("serve") == 2
    victim = out["added"][0]
    router.replicas()[victim].kill()
    mode["text"] = _idle_text(P)
    fc.advance(1.0)
    scaler.tick()
    assert victim not in router.replica_names()
    assert scaler.owned_replicas() == []
    assert broker.held("serve") == 1 and broker.free() == 1
    return [out, router.replica_names()]


def test_scaler_reaps_dead_owned_replica_and_returns_lease():
    twin(s_reaps_dead_owned)


def s_version_fn_failure(P):
    fc = P.FakeClock()
    broker = P.DeviceLeaseBroker(2, registry=P.MetricsRegistry())
    broker.register("serve", priority=1, held=1)

    def bad_version():
        raise RuntimeError("version store unreachable")

    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: _breach_text(P), broker=broker)
    scaler.version_fn = bad_version
    out = scaler.tick()
    assert out["action"] == "error"
    assert "version store unreachable" in (P.autoscale_check(scaler)() or "")
    assert broker.held("serve") == 1 and broker.free() == 1
    assert len(router.replica_names()) == 1
    return out


def test_scaler_version_fn_failure_does_not_strand_leases():
    twin(s_version_fn_failure)


def s_canary_victim_and_stable_version(P):
    fc = P.FakeClock()
    factory = P.make_replica_factory(fc)
    scaler, router, reps = make_scaler(
        P, fc, factory=factory, n_boot=2,
        cfg=P.AutoscalerConfig(up_cooldown_s=0.0, down_cooldown_s=0.0,
                               breach_ticks=1, idle_ticks=1,
                               max_replicas=4, min_replicas=1))
    router.swap_replica(reps[0].name, 2, canary=True)
    mode = {"text": _breach_text(P)}
    scaler.scrape = lambda n, r: mode["text"]
    up = scaler.tick()
    assert up["action"] == "up"
    assert router.replica_stats()[up["added"][0]]["version"] == 1
    mode["text"] = _idle_text(P)
    fc.advance(1.0)
    down = scaler.tick()
    assert down["action"] == "down" and down["removed"] != reps[0].name
    assert router.replica_stats()[reps[0].name]["canary"]
    return [_turn(up), _turn(down)]


def test_scaler_never_picks_canary_victim_and_joins_stable_version():
    twin(s_canary_victim_and_stable_version)


def s_collect_read_only(P):
    fc = P.FakeClock()
    scaler, router, _ = make_scaler(P, fc,
                                    scrape=lambda n, r: _idle_text(P))
    scaler.tick()
    router.metrics.record_submit("normal", 10)
    router.metrics.record_shed("normal", 10)
    fleet = scaler.collect()
    assert fleet.shed_fraction == pytest.approx(0.5)
    fc.advance(1.0)
    out = scaler.tick()
    assert out["shed_fraction"] == pytest.approx(0.5)
    assert out["action"] == "up"
    scaler.scrape = lambda n, r: "torn mid-write garbage\n"
    scaler.collect()
    assert P.autoscale_check(scaler)() is None
    s = router.metrics.registry.snapshot()
    assert s.get("autoscale_scrape_parse_failures_total", 0) == 0
    return [fleet.shed_fraction, fleet.offered, out]


def test_collect_is_read_only_for_out_of_band_callers():
    twin(s_collect_read_only)


def s_down_guard(P):
    fc = P.FakeClock()
    mode = {"text": _idle_text(P)}
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: mode["text"],
        cfg=P.AutoscalerConfig(up_cooldown_s=0.0, down_cooldown_s=0.0,
                               breach_ticks=1, idle_ticks=1,
                               max_replicas=4))
    scaler.tick()
    router.metrics.record_submit("normal", 100)
    mode["text"] = _breach_text(P)
    fc.advance(1.0)
    assert scaler.tick()["action"] == "up"
    mode["text"] = _idle_text(P)
    router.metrics.record_submit("normal", 100)
    fc.advance(1.0)
    hold = scaler.tick()
    assert hold["action"] == "hold"
    assert hold["reason"] == "traffic needs fleet"
    assert len(router.replica_names()) == 2
    fc.advance(1.0)
    down = scaler.tick()
    assert down["action"] == "down" and len(router.replica_names()) == 1
    return [hold, _turn(down)]


def test_down_guard_refuses_shrink_while_traffic_needs_fleet():
    twin(s_down_guard)


def s_down_guard_trough_pin(P):
    fc = P.FakeClock()
    mode = {"text": _idle_text(P)}
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: mode["text"],
        cfg=P.AutoscalerConfig(up_cooldown_s=0.0, down_cooldown_s=0.0,
                               breach_ticks=1, idle_ticks=1,
                               max_replicas=4))

    def turn(rate, text):
        mode["text"] = text
        router.metrics.record_submit("normal", rate)
        fc.advance(1.0)
        return scaler.tick()

    scaler.tick()
    outs = [turn(100, _breach_text(P))]       # the peak grows the fleet
    outs.append(turn(10, _idle_text(P)))      # the trough shrinks it
    assert [o["action"] for o in outs] == ["up", "down"]
    # a stall at the trough breaches once: the scale-up sets the demand
    # watermark to the trough's 10/s over 2 replicas
    outs.append(turn(10, _breach_text(P)))
    assert outs[-1]["action"] == "up"
    # the trough goes on, idle: 10/s on 1 replica projects above 0.9 x 5/s
    # on every turn, so the fleet never shrinks again
    pinned = [turn(10, _idle_text(P)) for _ in range(20)]
    assert {(o["action"], o.get("reason")) for o in pinned} == {
        ("hold", "traffic needs fleet")}
    assert len(router.replica_names()) == 2
    # only traffic below the watermark (0.9 x 5/s) lets it go
    outs.append(turn(4, _idle_text(P)))
    assert outs[-1]["action"] == "down"
    assert len(router.replica_names()) == 1
    return [[_turn(o) for o in outs + pinned], snap(router.metrics.registry)]


def test_down_guard_pins_fleet_after_a_trough_scale_up():
    """The demand watermark that guards a scale-down is the per-replica
    rate at the last pressure-driven scale-up. A breach at the trough (a
    host stall) sets it to the trough's rate, and every later idle turn at
    that rate holds the fleet: the same in both packages."""
    twin(s_down_guard_trough_pin)


def s_miswired_lease_release(P):
    fc = P.FakeClock()
    broker = P.DeviceLeaseBroker(2, registry=P.MetricsRegistry())
    broker.register("serve", priority=1, held=0)
    scaler, router, _ = make_scaler(
        P, fc, scrape=lambda n, r: _idle_text(P), n_boot=2, broker=broker)
    scaler.tick()
    fc.advance(1.0)
    out = scaler.tick()
    assert out["action"] == "down" and len(router.replica_names()) == 1
    reason = P.autoscale_check(scaler)() or ""
    assert "lease release failed" in reason
    return [_turn(out), reason]


def test_miswired_lease_release_surfaces_without_failing_the_turn():
    twin(s_miswired_lease_release)


def s_scrape_parse_failure(P):
    fc = P.FakeClock()
    mode = {"text": "serve_queue_depth not-a-number garbage\n"}
    scaler, router, _ = make_scaler(P, fc, scrape=lambda n, r: mode["text"])
    out = scaler.tick()
    assert out["action"] != "error"
    reason = P.autoscale_check(scaler)()
    assert reason is not None and "unparseable" in reason
    assert router.metrics.registry.snapshot()[
        "autoscale_scrape_parse_failures_total"] >= 1
    mode["text"] = _idle_text(P)
    fc.advance(1.0)
    scaler.tick()
    assert P.autoscale_check(scaler)() is None
    return [out, reason]


def test_scrape_parse_failure_degrades_healthz_not_silent():
    twin(s_scrape_parse_failure)


def s_repair_below_min(P):
    fc = P.FakeClock()
    cfg = P.AutoscalerConfig(up_cooldown_s=100.0, breach_ticks=3,
                             min_replicas=1, max_replicas=4)
    scaler, router, reps = make_scaler(P, fc, cfg=cfg,
                                       scrape=lambda n, r: _idle_text(P))
    reps[0].kill()
    out = scaler.tick()
    assert out["action"] == "up"
    assert len([n for n, st in router.replica_stats().items()
                if st["state"] == "up"]) >= 1
    return out


def test_scaler_repairs_fleet_below_min():
    twin(s_repair_below_min)


@pytest.mark.parametrize("P", [JAX, TORCH], ids=["jax", "torch"])
def test_autoscaler_config_validation(P):
    with pytest.raises(ValueError, match="hysteresis"):
        P.AutoscalerConfig(high_utilization=0.3, low_utilization=0.5)
    with pytest.raises(ValueError, match="min_replicas"):
        P.AutoscalerConfig(min_replicas=5, max_replicas=2)
    with pytest.raises(ValueError, match="breach_ticks"):
        P.AutoscalerConfig(breach_ticks=0)


def s_scrape_round_trip(P):
    fc = P.FakeClock()
    rep = P.LocalReplica(P.fake_engine_factory, 1, name="rt",
                         queue_capacity=16, clock=fc, start=False)
    router = P.Router([rep], clock=fc, sleep=lambda s: fc.advance(s),
                      metrics=P.RouterMetrics(clock=fc))
    scaler = P.Autoscaler(router, lambda v: None, clock=fc)
    for i in range(4):
        router.submit(np.full((4,), i, np.float32))
    fleet = scaler.collect()
    assert fleet.replicas[0].queue_depth == 4.0
    assert fleet.utilization == pytest.approx(4.0 / 16.0)
    rep.step()
    fc.advance(0.010)
    vals = P.scalar_values(P.parse_prometheus_text(rep.metrics.prometheus()))
    assert vals["serve_queue_depth"] == 0.0
    return [vars(fleet.replicas[0]), fleet.utilization, vals]


def test_scrape_signals_round_trip_from_real_replica():
    twin(s_scrape_round_trip)


# ------------------------------------------------------------ the diurnal soak

def test_diurnal_soak_reports_equal_and_gates_hold():
    """The acceptance soak, sleep-free, through both packages: equal
    reports key by key (``history`` included), and the JAX test's gates
    on the port's."""
    want, _, _ = JAX.run_diurnal_soak()
    report, scaler, router = TORCH.run_diurnal_soak()
    assert set(report) == set(want)
    for k in want:
        assert report[k] == want[k], k
    cfg = scaler.cfg
    assert report["silently_dropped"] == 0
    assert report["outstanding_after"] == 0
    assert report["availability"] >= 0.999, report
    assert report["scale_ups"] >= 2 and report["peak_fleet"] >= 3
    assert report["scale_downs"] >= 1 and report["final_fleet"] <= 2
    assert report["slo_violation_minutes"] <= 1.0, report
    if report["reaction_max_s"] is not None:
        assert report["reaction_max_s"] <= cfg.up_cooldown_s + 2.0, report
    s = router.metrics.registry.snapshot()
    assert s["serve_router_replica_deaths_total"] >= 1
    assert s["serve_router_swaps_total"] >= 1


@pytest.mark.slow
def test_diurnal_soak_real_time():
    """Real-clock variant (threaded dispatchers, real sleeps) through the
    port: a compact diurnal cycle through live LocalReplicas."""
    P = TORCH
    count = [0]

    def factory(version):
        count[0] += 1
        return P.LocalReplica(
            P.fake_engine_factory, 1 if version is None else version,
            name=f"rt{count[0]}", queue_capacity=64, max_wait_ms=1.0)

    router = P.Router([factory(1)], metrics=P.RouterMetrics())
    cfg = P.AutoscalerConfig(
        slo_p99_ms=100.0, high_utilization=0.5, low_utilization=0.1,
        min_replicas=1, max_replicas=4, up_cooldown_s=0.5,
        down_cooldown_s=2.0, breach_ticks=1, idle_ticks=2,
        drain_timeout_s=5.0)
    scaler = P.Autoscaler(router, factory, config=cfg)
    scaler.start(interval_s=0.25)
    try:
        futs = P.open_loop(router, [np.full((4,), 3, np.float32)],
                           P.diurnal(800.0, 80.0, period_s=6.0), 6.0)
        deadline = time.monotonic() + 10.0
        while router.outstanding() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        scaler.stop()
    done = sum(1 for _, f in futs if f.done())
    completed = sum(1 for _, f in futs
                    if f.done() and f.exception() is None)
    assert len(futs) - done == 0
    assert completed / len(futs) >= 0.99
    router.shutdown(drain=False)
    for rep in list(router.replicas().values()):
        try:
            rep.close()
        except Exception:
            pass


# ---------------------------------------------- device-lease handoff (e2e)

def _dense_jax_model():
    from dcnn_tpu.nn import SequentialBuilder
    return (SequentialBuilder("leased_model").input((16,))
            .dense(32).activation("relu").dense(4).build())


def _flash_jax_model():
    """``mha_classifier``'s structure cut to one attention block at S=8,
    E=16 (2 heads), flash attention."""
    from dcnn_tpu.nn import SequentialBuilder
    from dcnn_tpu.nn.attention_layer import MultiHeadAttentionLayer
    from dcnn_tpu.nn.residual import ResidualBlock
    return (SequentialBuilder("leased_mha").input((8, 16))
            .add_layer(ResidualBlock(
                layers=[MultiHeadAttentionLayer(num_heads=2, impl="flash",
                                                name="attn0_mha")],
                shortcut=[], activation="relu", name="attn0"))
            .flatten("flatten").dense(4, True, "head").build())


MODELS = {"dense": (_dense_jax_model, (16,)),
          "flash_mha": (_flash_jax_model, (8, 16))}


@functools.lru_cache(maxsize=None)
def _data(kind):
    from dcnn_tpu_torch.data.loader import one_hot
    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, *MODELS[kind][1])).astype(np.float32)
    return x, one_hot(rng.integers(0, 4, 48), 4)


@functools.lru_cache(maxsize=None)
def _init(kind):
    """The model's config and the weights the JAX controllers initialise
    from seed 3 (the port's start from the same weights)."""
    from dcnn_tpu.optim import SGD
    from dcnn_tpu.train.trainer import create_train_state
    m = MODELS[kind][0]()
    ts = create_train_state(m, SGD(0.05), jax.random.PRNGKey(3))
    return m.get_config(), jax.tree_util.tree_map(np.asarray, ts.params)


def _elastic_kw(ckpt_dir, epochs):
    return dict(epochs=epochs, learning_rate=0.05, seed=3,
                snapshot_dir=None, elastic=True, elastic_microbatches=2,
                elastic_timeout_s=15.0, elastic_heartbeat_s=0.0,
                elastic_ckpt_steps=2, elastic_min_world=1,
                checkpoint_dir=ckpt_dir)


def controller_factory(P, kind, ckpt_dir, epochs=4):
    """``make(rank, peers, sock)`` building one controller of ``P`` over
    the model ``kind``; the port's start from the JAX controllers'
    initial weights (``fit``'s ``ts`` bound, ``resume`` still honoured)."""
    x, y = _data(kind)
    if P is JAX:
        from dcnn_tpu.core.config import TrainingConfig
        from dcnn_tpu.data.loader import ArrayDataLoader
        from dcnn_tpu.optim import SGD

        def make(rank, peers, sock):
            return j_elastic.ElasticController(
                MODELS[kind][0](), SGD(0.05), "softmax_crossentropy",
                ArrayDataLoader(x, y, batch_size=12, seed=7),
                config=TrainingConfig(**_elastic_kw(ckpt_dir, epochs)),
                rank=rank, peers=peers, listen_sock=sock)
        return make
    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data.loader import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.train import create_train_state
    cfg, params = _init(kind)

    def make(rank, peers, sock):
        model, opt = from_jax(cfg, params, device="cpu"), SGD(0.05)
        ctl = t_elastic.ElasticController(
            model, opt, "softmax_crossentropy",
            ArrayDataLoader(x, y, batch_size=12, seed=7),
            config=TrainingConfig(device_type="cpu",
                                  **_elastic_kw(ckpt_dir, epochs)),
            rank=rank, peers=peers, listen_sock=sock)
        ctl.fit = functools.partial(ctl.fit, create_train_state(model, opt))
        return ctl
    return make


def params_of(P, ts):
    if P is JAX:
        return [np.asarray(a) for a in
                jax.tree_util.tree_leaves(jax.device_get(ts.params))]
    from dcnn_tpu_torch.interop import to_jax
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(to_jax(ts.model))]


def s_lease_handoff(P, kind, root):
    """The JAX test's handoff, through ``P``: returns the leased run's
    and the uninterrupted run's final params, and the lease accounting."""
    import os
    base = P.LeasedElasticTrainer(
        controller_factory(P, kind, os.path.join(root, P.name, "base")))
    res = base.run_segment(4, target_world=2, resume=True)
    assert all(not isinstance(r, BaseException) for r in res.values()), res
    base_params = params_of(P, res[0])

    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(3, registry=reg)
    lease = P.TrainLease(broker, initial=2, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=1)
    fc = P.FakeClock()
    rep_factory = P.make_replica_factory(fc, prefix="ho")
    router = P.Router([rep_factory(1)], clock=fc,
                      sleep=lambda s: fc.advance(s),
                      metrics=P.RouterMetrics(clock=fc))
    mode = {"text": _breach_text(P)}
    scaler = P.Autoscaler(
        router, rep_factory,
        config=P.AutoscalerConfig(up_cooldown_s=0.0, down_cooldown_s=0.0,
                                  breach_ticks=1, idle_ticks=1,
                                  min_replicas=1, max_replicas=2),
        broker=broker, tenant="serve", clock=fc,
        scrape=lambda n, r: mode["text"])
    trainer = P.LeasedElasticTrainer(
        controller_factory(P, kind, os.path.join(root, P.name, "leased")),
        lease=lease, min_world=1)
    controllers = {}
    orig_make = trainer.make_controller

    def tracking_make(rank, peers, sock):
        ctl = orig_make(rank, peers, sock)
        controllers[rank] = ctl
        return ctl
    trainer.make_controller = tracking_make

    seg1 = {}
    t1 = threading.Thread(target=lambda: seg1.update(
        trainer.run_segment(3, target_world=2, resume=True)), daemon=True)
    t1.start()
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        ctl = controllers.get(0)
        if ctl is not None and len(ctl.step_log) >= 2:
            break
        time.sleep(0.01)
    else:
        pytest.fail("training world never made progress")
    first = scaler.tick()
    assert first["action"] == "blocked"
    assert first["reason"] == "awaiting lease"
    granted = {}
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline:
        fc.advance(1.0)
        out = scaler.tick()
        if out["action"] == "up":
            granted.update(out)
            break
        time.sleep(0.02)
    assert granted, "serving scale-up never got the revoked device"
    assert len(router.replica_names()) == 2
    t1.join(timeout=180)
    assert not t1.is_alive()
    assert seg1[1] == "preempted"
    assert not isinstance(seg1[0], BaseException), seg1[0]
    assert controllers[0].world == 1
    assert controllers[0].stats["reconfigures"] >= 1
    assert reg.snapshot()["train_lease_preemptions_total"] == 1
    mode["text"] = _idle_text(P)
    fc.advance(1.0)
    assert scaler.tick()["action"] == "down"
    assert broker.free() == 1
    seg2 = trainer.run_segment(4, target_world=2, resume=True)
    assert trainer.segments[-1]["world"] == 2
    assert all(not isinstance(r, BaseException) for r in seg2.values())
    for a, b in zip(params_of(P, seg2[0]), params_of(P, seg2[1])):
        np.testing.assert_array_equal(a, b)
    leased = params_of(P, seg2[0])
    for a, b in zip(base_params, leased):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    return {"segments": trainer.segments, "lease": snap(reg),
            "base": base_params, "leased": leased}


@pytest.mark.parametrize("kind", ["dense", "flash_mha"])
def test_device_lease_handoff_end_to_end(kind, tmp_path):
    """Both packages' handoffs: the same segments and lease counters, and
    the port's final params within ``RTOL, ATOL`` of the JAX run's (and
    of its own uninterrupted run, inside the scenario)."""
    want = s_lease_handoff(JAX, kind, str(tmp_path))
    got = s_lease_handoff(TORCH, kind, str(tmp_path))
    assert got["segments"] == want["segments"]
    assert got["lease"] == want["lease"]
    for key in ("base", "leased"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_preempt_raises_at_next_beat(tmp_path):
    """Preempted before its first beat, a controller's segment answers
    "preempted"; nothing ran, and a later segment starts clean."""
    trainer = TORCH.LeasedElasticTrainer(controller_factory(
        TORCH, "dense", str(tmp_path / "solo")))
    orig = trainer.make_controller

    def tracking(rank, peers, sock):
        ctl = orig(rank, peers, sock)
        ctl.preempt("unit test")
        return ctl
    trainer.make_controller = tracking
    assert trainer.run_segment(1, target_world=1, resume=True) == {
        0: "preempted"}
    trainer.make_controller = orig
    res = trainer.run_segment(1, target_world=1, resume=True)
    assert len(res) == 1 and not isinstance(res[0], BaseException)
    assert trainer.segments == [
        {"world": 1, "epochs_to": 1, "preempted": [0]},
        {"world": 1, "epochs_to": 1, "preempted": []}]


class _FakeCtl:
    """A controller that trains until ``release`` (or raises
    ``PreemptedError`` once preempted, with ``raise_on_preempt``)."""

    def __init__(self, P, release, raise_on_preempt):
        self.P, self.release = P, release
        self.raise_on_preempt = raise_on_preempt
        self.preempted = threading.Event()
        self.preempts = 0

    def preempt(self, reason=""):
        self.preempts += 1
        self.preempted.set()

    def fit(self, epochs, resume=True):
        if not self.raise_on_preempt:
            self.release.wait(10.0)
            return "done"
        while not self.release.is_set():
            if self.preempted.wait(0.005):
                raise self.P.PreemptedError("preempted")
        return "done"


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def s_picked_victim_declines(P):
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(2, registry=reg)
    lease = P.TrainLease(broker, initial=2, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=0)
    release = threading.Event()
    ctls = {}

    def make(rank, peers, sock):
        ctls[rank] = _FakeCtl(P, release, raise_on_preempt=False)
        return ctls[rank]

    trainer = P.LeasedElasticTrainer(make, lease=lease, min_world=1,
                                     registry=reg)
    seg = threading.Thread(
        target=lambda: trainer.run_segment(1, target_world=2), daemon=True)
    seg.start()
    assert _wait(lambda: len(ctls) == 2)
    assert broker.request("serve", 1) == 0
    assert _wait(lambda: ctls[1].preempted.is_set())
    release.set()
    seg.join(timeout=30.0)
    assert not seg.is_alive()
    assert broker.revoke_pending("train") == 0 and lease.held() == 2
    rev0 = reg.snapshot()["lease_revocations_total"]
    assert broker.request("serve", 1) == 0
    assert reg.snapshot()["lease_revocations_total"] == rev0 + 1
    return [trainer.segments, trainer.last_results, ctls[0].preempts,
            ctls[1].preempts]


def test_picked_victim_that_exits_normally_declines_its_chip():
    twin(s_picked_victim_declines)


def s_unpickable_revocation(P):
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(4, registry=reg)
    lease = P.TrainLease(broker, initial=3, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=1)
    release = threading.Event()
    ctls = {}

    def make(rank, peers, sock):
        ctls[rank] = _FakeCtl(P, release, raise_on_preempt=True)
        return ctls[rank]

    trainer = P.LeasedElasticTrainer(make, lease=lease, min_world=2,
                                     registry=reg)
    seg = threading.Thread(
        target=lambda: trainer.run_segment(1, target_world=3), daemon=True)
    seg.start()
    assert _wait(lambda: len(ctls) == 3)
    assert broker.request("serve", 2) == 0
    assert _wait(lambda: broker.revoke_pending("train") == 0
                 and broker.free() == 1)
    assert lease.held() == 2 and broker.free() == 1
    rev0 = reg.snapshot()["lease_revocations_total"]
    assert broker.request("serve", 2) == 1
    assert reg.snapshot()["lease_revocations_total"] == rev0 + 1
    assert _wait(lambda: broker.revoke_pending("train") == 0)
    release.set()
    seg.join(timeout=30.0)
    assert not seg.is_alive()
    assert lease.held() == 2
    return [trainer.segments, trainer.last_results, snap(reg),
            [ctls[r].preempts for r in range(3)]]


def test_unpickable_revocation_declined_under_min_world_floor():
    twin(s_unpickable_revocation)


def s_never_repicks_inflight(P):
    trainer = P.LeasedElasticTrainer(lambda *a: None, min_world=1)
    ctls = {r: _FakeCtl(P, threading.Event(), False) for r in range(3)}
    trainer._live.update(ctls)
    trainer._on_revoke(1)
    assert ctls[2].preempts == 1
    trainer._on_revoke(1)
    assert ctls[2].preempts == 1 and ctls[1].preempts == 1
    assert trainer._deferred_revoke == 0
    trainer._on_revoke(1)
    assert ctls[0].preempts == 0
    assert trainer._deferred_revoke == 1
    return [[c.preempts for c in ctls.values()],
            sorted(trainer._preempt_pending), trainer._deferred_revoke]


def test_pick_victims_never_repicks_inflight_preemption():
    twin(s_never_repicks_inflight)


def test_segment_gap_revocation_applies_to_the_next_fleet():
    """A revocation landing between two segments (no controller alive) is
    kept by the lifetime-scoped listener and preempts the highest rank of
    the next fleet as it registers: the device is surrendered, not lost,
    and the broker's pending count returns to 0."""
    P = TORCH
    reg = P.MetricsRegistry()
    broker = P.DeviceLeaseBroker(3, registry=reg)
    lease = P.TrainLease(broker, initial=2, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=1)
    release = threading.Event()
    ctls = {}

    def make(rank, peers, sock):
        ctls[rank] = _FakeCtl(P, release, raise_on_preempt=True)
        return ctls[rank]

    trainer = P.LeasedElasticTrainer(make, lease=lease, min_world=1,
                                     registry=reg)
    assert broker.request("serve", 1) == 0      # fires in the gap
    assert trainer._deferred_revoke == 1
    res = {}
    seg = threading.Thread(target=lambda: res.update(
        trainer.run_segment(1, target_world=2)), daemon=True)
    seg.start()
    assert _wait(lambda: broker.free() == 1)    # rank 1 surrendered
    release.set()
    seg.join(timeout=30.0)
    assert not seg.is_alive()
    assert res == {0: "done", 1: "preempted"}
    assert trainer._deferred_revoke == 0
    assert broker.revoke_pending("train") == 0
    assert lease.held() == 1 and broker.request("serve", 1) == 1
