"""The router tier of the port (``dcnn_tpu_torch/serve/router.py``,
``replica.py``, ``swap.py``'s ``ModelVersionManager`` and
``metrics.py``'s ``RouterMetrics``) against the JAX package's.

Every case of ``tests/test_router.py`` (but the bench and example
smokes), the router cases of ``tests/test_slowness.py`` (hedging,
probation) and of ``tests/test_trace_dist.py`` (request traces, the
replica-death and canary-rollback flight bundles) runs here as a
*scenario*: one function that drives a package through the reference
test's script and asserts the reference test's contract. Each test runs
the scenario through both packages, with the same seeds and fake clocks,
and requires the same record from both: every future's resolution or
typed error, ``RouterMetrics.snapshot()``, ``replica_stats()``, each
replica's ``ServeMetrics.snapshot()`` and ``prometheus()`` text of the
router and of every replica, byte for byte. The TCP cases run real
sockets on threads, so only their deterministic parts are recorded.

Replicas wrap fake engines (``logits = x + version``): the JAX one
returns numpy, the port's a torch tensor, as each package's batcher
expects. No case has a wall-clock bound.
"""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dcnn_tpu.obs as j_obs
import dcnn_tpu.obs.flight as j_flight
import dcnn_tpu.resilience.faults as j_faults
import dcnn_tpu.resilience.slowness as j_slowness
import dcnn_tpu.serve as j_serve
import dcnn_tpu.serve.batcher as j_batcher
import dcnn_tpu_torch.obs as t_obs
import dcnn_tpu_torch.obs.flight as t_flight
import dcnn_tpu_torch.resilience.faults as t_faults
import dcnn_tpu_torch.resilience.slowness as t_slowness
import dcnn_tpu_torch.serve as t_serve
import dcnn_tpu_torch.serve.batcher as t_batcher


class FakeClock:
    __name__ = "fake_clock"

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _fake_engine_class(to_out):
    class FakeEngine:
        """Batcher-compatible engine: logits = x + version, so a result
        proves WHICH model version served it."""

        def __init__(self, version=1, name="fake"):
            self.input_shape = (4,)
            self.max_batch = 8
            self.bucket_sizes = [1, 2, 4, 8]
            self.name = name
            self.version = version
            self.batch_invariant = True

        def bucket_for(self, n):
            for b in self.bucket_sizes:
                if b >= n:
                    return b
            raise ValueError(n)

        def pad_to_bucket(self, x):
            x = np.asarray(x, np.float32)
            n = x.shape[0]
            b = self.bucket_for(n)
            if b > n:
                x = np.concatenate([x, np.zeros((b - n, 4), np.float32)])
            return x, n

        def run_padded(self, x):
            return to_out(np.asarray(x, np.float32) + self.version)

        def warm(self):
            # the port's batcher warms its engine on the dispatcher
            return {}

    return FakeEngine


def _package(name, serve, batcher, faults, slowness, obs, flight, to_out):
    P = SimpleNamespace(name=name, FakeEngine=_fake_engine_class(to_out),
                        FaultPlan=faults.FaultPlan,
                        InjectedCrash=faults.InjectedCrash,
                        InjectedFault=faults.InjectedFault,
                        install=faults.install, clear=faults.clear,
                        DrainingError=batcher.DrainingError,
                        SlownessConfig=slowness.SlownessConfig,
                        configure=obs.configure,
                        FlightRecorder=flight.FlightRecorder)
    for n in serve.__all__:
        setattr(P, n, getattr(serve, n))
    return P


JAX = _package("jax", j_serve, j_batcher, j_faults, j_slowness, j_obs,
               j_flight, np.asarray)
TORCH = _package("torch", t_serve, t_batcher, t_faults, t_slowness, t_obs,
                 t_flight, torch.from_numpy)


class FakeFactory:
    """EngineFactory stand-in: ``newest()`` is a settable attribute, and
    every built engine encodes its version in its outputs."""

    def __init__(self, P, newest_version=1):
        self.P = P
        self.newest_version = newest_version
        self.built = []

    def newest(self):
        return self.newest_version

    def __call__(self, version):
        self.built.append(version)
        return self.P.FakeEngine(version)


def make_fleet(P, n=3, *, version=1, queue_capacity=16, clock=None,
               shares=None, max_readmits=3, failure_eject_threshold=0,
               **router_kw):
    """(router, replicas, plans, clock): start=False replicas pumped by
    hand, the router's backoff sleeps advancing the fake clock."""
    fc = clock if clock is not None else FakeClock()
    factory = FakeFactory(P, newest_version=version)
    plans, reps = {}, []
    for i in range(n):
        plans[f"r{i}"] = P.FaultPlan()
        reps.append(P.LocalReplica(
            factory, version, name=f"r{i}", queue_capacity=queue_capacity,
            clock=fc, fault_plan=plans[f"r{i}"], start=False))
    router = P.Router(reps, clock=fc, sleep=lambda s: fc.advance(s),
                      shares=shares, max_readmits=max_readmits,
                      failure_eject_threshold=failure_eject_threshold,
                      **router_kw)
    return router, reps, plans, fc


def pump(reps, rounds=4):
    """Dispatch every queued request, re-admissions included."""
    for _ in range(rounds):
        for r in reps:
            while r.step():
                pass


def outcome(f):
    """A future's resolution: ("ok", logits), ("error", type name), or
    ("pending",) / ("cancelled",)."""
    if f.cancelled():
        return ("cancelled",)
    if not f.done():
        return ("pending",)
    e = f.exception()
    if e is not None:
        return ("error", type(e).__name__)
    return ("ok", np.asarray(f.result()).tolist())


def record(router, futs=(), reps=(), **extra):
    """What the two packages must agree on after one scenario."""
    return {"futures": [outcome(f) for f in futs],
            "outstanding": router.outstanding(),
            "router_snapshot": router.metrics.snapshot(),
            "router_prometheus": router.metrics.prometheus(),
            "replica_stats": router.replica_stats(),
            "replicas": {r.name: (r.metrics.snapshot(),
                                  r.metrics.prometheus())
                         for r in reps},
            **extra}


def twin(scenario, *args):
    """Run ``scenario`` through the JAX package and the port; their
    records must be equal (the Prometheus texts byte for byte)."""
    want = scenario(JAX, *args)
    got = scenario(TORCH, *args)
    assert got == want
    return got


# ------------------------------------------------------------- basic routing

def s_results_match_and_distribute(P):
    router, reps, _, _ = make_fleet(P, 3)
    futs = [router.submit(np.full((4,), i, np.float32)) for i in range(12)]
    pump(reps)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=0),
                                      np.full((4,), i + 1, np.float32))
    assert router.outstanding() == 0
    stats = router.replica_stats()
    assert all(st["completed"] >= 1 for st in stats.values())
    assert sum(st["completed"] for st in stats.values()) == 12
    return record(router, futs, reps)


def test_router_results_match_and_distribute():
    twin(s_results_match_and_distribute)


def s_batch_requests_and_single_shape(P):
    router, reps, _, _ = make_fleet(P, 2)
    fb = router.submit(np.zeros((3, 4), np.float32))
    fs = router.submit(np.zeros((4,), np.float32))
    pump(reps)
    assert np.asarray(fb.result(0)).shape == (3, 4)
    assert np.asarray(fs.result(0)).shape == (4,)
    return record(router, [fb, fs], reps)


def test_router_batch_requests_and_single_shape():
    twin(s_batch_requests_and_single_shape)


def s_unknown_priority_raises(P):
    router, _, _, _ = make_fleet(P, 1)
    with pytest.raises(ValueError, match="unknown priority") as ei:
        router.submit(np.zeros(4, np.float32), priority="urgent")
    return record(router, msg=str(ei.value))


def test_router_unknown_priority_raises():
    twin(s_unknown_priority_raises)


def s_submit_after_shutdown_is_typed(P):
    router, _, _, _ = make_fleet(P, 1)
    router.shutdown(drain=False)
    with pytest.raises(P.DrainingError):
        router.submit(np.zeros(4, np.float32))
    return record(router)


def test_router_submit_after_shutdown_is_typed():
    twin(s_submit_after_shutdown_is_typed)


# ------------------------------------------------------- priority admission

def s_low_priority_sheds_first(P):
    router, reps, _, _ = make_fleet(
        P, 2, queue_capacity=8,
        shares={"high": 1.0, "normal": 0.85, "low": 0.6})
    held = [router.submit(np.zeros((2, 4), np.float32)) for _ in range(5)]
    assert router.outstanding() == 10
    with pytest.raises(P.RouterShedError):
        router.submit(np.zeros(4, np.float32), priority="low")
    ok_n = router.submit(np.zeros(4, np.float32), priority="normal")
    ok_h = router.submit(np.zeros(4, np.float32), priority="high")
    more = [router.submit(np.zeros(4, np.float32), priority="high")
            for _ in range(2)]
    with pytest.raises(P.RouterShedError):
        router.submit(np.zeros(4, np.float32), priority="normal")
    ok_h2 = router.submit(np.zeros(4, np.float32), priority="high")
    pump(reps)
    futs = held + more + [ok_n, ok_h, ok_h2]
    for f in futs:
        assert f.exception(timeout=0) is None
    snap = router.metrics.snapshot()
    assert snap["low"]["shed"] == 1 and snap["low"]["completed"] == 0
    assert snap["normal"]["shed"] == 1
    assert snap["high"]["shed"] == 0 and snap["high"]["completed"] == 4
    assert snap["total"]["shed_fraction"] > 0
    assert router.outstanding() == 0
    assert router.metrics.capacity_rows.value == 16
    return record(router, futs, reps)


def test_low_priority_sheds_first_under_load():
    twin(s_low_priority_sheds_first)


def test_shed_is_queue_full_error_for_open_loop():
    for P in (JAX, TORCH):
        assert issubclass(P.RouterShedError, P.QueueFullError)
        assert issubclass(P.NoReplicasError, P.ReplicaError)
        assert issubclass(P.ReplicaDeadError, P.ReplicaError)
        assert issubclass(P.SwapError, P.ReplicaError)
    assert TORCH.PRIORITIES == JAX.PRIORITIES


def s_every_replica_full_sheds_and_unadmits(P):
    router, reps, _, _ = make_fleet(P, 2, queue_capacity=4)
    held = [router.submit(np.zeros((3, 4), np.float32)) for _ in range(2)]
    assert router.outstanding() == 6
    with pytest.raises(P.RouterShedError):
        router.submit(np.zeros((2, 4), np.float32))
    assert router.outstanding() == 6
    snap = router.metrics.snapshot()["normal"]
    assert snap["requests"] == 6 and snap["shed"] == 2
    pump(reps)
    assert router.outstanding() == 0
    for f in held:
        assert f.exception(timeout=0) is None
    return record(router, held, reps)


def test_every_replica_full_sheds_and_unadmits():
    twin(s_every_replica_full_sheds_and_unadmits)


def s_cancelled_then_failed_retires_ledger(P):
    router, reps, plans, _ = make_fleet(P, 1)
    plans["r0"].arm("serve.replica_infer", exc=P.InjectedFault, times=1)
    f = router.submit(np.zeros(4, np.float32))
    assert f.cancel()
    pump(reps)
    assert router.outstanding() == 0
    f2 = router.submit(np.zeros(4, np.float32))
    pump(reps)
    assert f2.exception(timeout=0) is None
    return record(router, [f, f2], reps)


def test_cancelled_then_failed_request_retires_ledger():
    twin(s_cancelled_then_failed_retires_ledger)


# ------------------------------------------------------ death + re-admission

def s_kill_reroutes_queued(P):
    router, reps, _, _ = make_fleet(P, 3)
    futs = [router.submit(np.full((4,), i, np.float32)) for i in range(9)]
    reps[0].kill()
    router.check_replicas()
    pump(reps)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=0),
                                      np.full((4,), i + 1, np.float32))
    assert router.outstanding() == 0
    assert router.replica_stats()["r0"]["state"] == "dead"
    assert router.metrics.registry.snapshot()[
        "serve_router_replica_deaths_total"] == 1
    return record(router, futs, reps)


def test_kill_reroutes_queued_requests_to_survivors():
    twin(s_kill_reroutes_queued)


def s_all_replicas_dead_fails_typed(P):
    router, reps, _, _ = make_fleet(P, 2, max_readmits=1)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(4)]
    for r in reps:
        r.kill()
    router.check_replicas()
    for f in futs:
        with pytest.raises((P.ReplicaDeadError, P.NoReplicasError)):
            f.result(timeout=0)
    assert router.outstanding() == 0
    with pytest.raises(P.RouterShedError):
        router.submit(np.zeros(4, np.float32))
    assert router.health_reason() is not None
    return record(router, futs, reps, health=router.health_reason())


def test_all_replicas_dead_fails_typed_not_silent():
    twin(s_all_replicas_dead_fails_typed)


def s_restarted_replica_rejoins(P):
    router, reps, _, _ = make_fleet(P, 2)
    reps[1].kill()
    router.check_replicas()
    assert router.replica_stats()["r1"]["state"] == "dead"
    reps[1].restart()
    report = router.check_replicas()
    assert report["r1"] == "rejoined"
    assert router.replica_stats()["r1"]["state"] == "up"
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(8)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in futs)
    assert router.replica_stats()["r1"]["completed"] >= 1
    assert router.metrics.registry.snapshot()[
        "serve_router_rejoins_total"] == 1
    return record(router, futs, reps, report=report)


def test_restarted_replica_rejoins_and_serves():
    twin(s_restarted_replica_rejoins)


def s_chaos_kill_mid_open_loop(P):
    fc = FakeClock()
    router, reps, plans, _ = make_fleet(P, 3, queue_capacity=64, clock=fc)
    plans["r1"].arm("serve.replica_infer", at=19, exc=P.InjectedCrash)
    ticks = {"n": 0}

    def soak_sleep(dt):
        fc.advance(dt)
        pump(reps, rounds=1)
        ticks["n"] += 1
        if ticks["n"] % 10 == 0:
            router.check_replicas()

    samples = [np.full((4,), i, np.float32) for i in range(16)]
    futs = P.open_loop(router, samples, offered_rps=200.0, seconds=1.0,
                       clock=fc, sleep=soak_sleep)
    router.check_replicas()
    pump(reps)
    router.check_replicas()
    pump(reps)
    assert len(futs) > 100
    completed = 0
    for i, f in futs:
        assert f.done(), "accepted request neither completed nor failed"
        if f.exception() is None:
            np.testing.assert_array_equal(
                f.result(), np.asarray(samples[i]) + 1.0)
            completed += 1
        else:
            assert isinstance(f.exception(),
                              (P.ReplicaDeadError, P.NoReplicasError))
    assert router.outstanding() == 0
    assert completed >= len(futs) - 8
    stats = router.replica_stats()
    assert stats["r1"]["state"] == "dead"
    reps[1].restart()
    assert router.check_replicas()["r1"] == "rejoined"
    f = router.submit(np.zeros(4, np.float32))
    pump(reps)
    assert f.exception(timeout=0) is None
    return record(router, [f for _, f in futs] + [f], reps,
                  indices=[i for i, _ in futs])


def test_chaos_faultplan_kill_mid_open_loop_soak():
    twin(s_chaos_kill_mid_open_loop)


def s_transient_fault_retried_elsewhere(P):
    router, reps, plans, _ = make_fleet(P, 2)
    plans["r0"].arm("serve.replica_infer", exc=P.InjectedFault, times=1)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(4)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in futs)
    stats = router.replica_stats()
    assert stats["r0"]["failed"] >= 1 and stats["r0"]["state"] == "up"
    assert router.metrics.registry.snapshot()[
        "serve_router_readmits_total"] >= 1
    return record(router, futs, reps)


def test_transient_replica_fault_is_retried_elsewhere():
    twin(s_transient_fault_retried_elsewhere)


def s_failure_eject_threshold(P):
    router, reps, plans, _ = make_fleet(P, 2, failure_eject_threshold=3)
    plans["r0"].arm("serve.replica_infer", exc=P.InjectedFault)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(12)]
    pump(reps, rounds=6)
    assert all(f.exception(timeout=0) is None for f in futs)
    assert router.replica_stats()["r0"]["state"] == "dead"
    report = router.check_replicas()
    assert "explicit rejoin" in report["r0"]
    assert router.replica_stats()["r0"]["state"] == "dead"
    plans["r0"].disarm("serve.replica_infer")
    router.rejoin("r0")
    assert router.replica_stats()["r0"]["state"] == "up"
    more = [router.submit(np.zeros(4, np.float32)) for _ in range(6)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in more)
    assert router.replica_stats()["r0"]["completed"] >= 1
    return record(router, futs + more, reps, report=report)


def test_failure_eject_threshold():
    twin(s_failure_eject_threshold)


def s_malformed_request_unadmits(P):
    router, reps, _, _ = make_fleet(P, 2, queue_capacity=64)
    with pytest.raises(ValueError, match="outside"):
        router.submit(np.zeros((9, 4), np.float32))
    assert router.outstanding() == 0
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(4)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in futs)
    assert router.outstanding() == 0
    return record(router, futs, reps)


def test_malformed_request_unadmits_no_ledger_leak():
    twin(s_malformed_request_unadmits)


def s_serve_route_fault_point(P):
    plan = P.FaultPlan().arm("serve.route", at=1, times=1)
    router, reps, _, _ = make_fleet(P, 1)
    P.install(plan)
    try:
        f = router.submit(np.zeros(4, np.float32))
        with pytest.raises(P.InjectedFault):
            router.submit(np.zeros(4, np.float32))
    finally:
        P.clear()
    pump(reps)
    assert router.outstanding() == 0
    return record(router, [f], reps)


def test_serve_route_fault_point():
    twin(s_serve_route_fault_point)


# ------------------------------------------------------------------ hot-swap

def s_swap_replica_drain_load_rejoin(P):
    router, reps, _, _ = make_fleet(P, 2, version=1)
    router.swap_replica("r0", 2)
    stats = router.replica_stats()
    assert stats["r0"]["version"] == 2 and stats["r0"]["state"] == "up"
    assert stats["r1"]["version"] == 1
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(8)]
    pump(reps)
    served = {float(f.result(timeout=0)[0]) for f in futs}
    assert served == {1.0, 2.0}
    assert router.metrics.registry.snapshot()[
        "serve_router_swaps_total"] == 1
    return record(router, futs, reps)


def test_swap_replica_drain_load_rejoin():
    twin(s_swap_replica_drain_load_rejoin)


def s_swap_failure_rejoins_old_version(P):
    router, reps, plans, _ = make_fleet(P, 1, version=1)
    plans["r0"].arm("serve.swap", exc=P.InjectedFault, times=1)
    with pytest.raises(P.SwapError) as ei:
        router.swap_replica("r0", 2)
    stats = router.replica_stats()
    assert stats["r0"]["version"] == 1 and stats["r0"]["state"] == "up"
    f = router.submit(np.zeros(4, np.float32))
    pump(reps)
    assert float(f.result(timeout=0)[0]) == 1.0
    snap = router.metrics.registry.snapshot()
    assert snap["serve_router_swap_failures_total"] == 1
    assert snap["serve_router_swaps_total"] == 0
    return record(router, [f], reps, msg=str(ei.value))


def test_swap_failure_rejoins_old_version():
    twin(s_swap_failure_rejoins_old_version)


def s_mvm_canary_then_promote(P):
    fc = FakeClock()
    router, reps, _, _ = make_fleet(P, 4, version=1, clock=fc)
    factory = FakeFactory(P, newest_version=1)
    mvm = P.ModelVersionManager(router, factory, canary_fraction=0.25,
                                observe_s=10.0, min_canary_requests=5,
                                clock=fc)
    polls = [mvm.poll()]
    assert polls[-1]["action"] == "none"
    factory.newest_version = 2
    polls.append(mvm.poll())
    res = polls[-1]
    assert res["action"] == "canary" and len(res["canaries"]) == 1
    canary = res["canaries"][0]
    assert router.replica_stats()[canary]["version"] == 2
    assert router.metrics.canary_replicas.value == 1
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(24)]
    pump(reps)
    assert {float(f.result(timeout=0)[0]) for f in futs} == {1.0, 2.0}
    assert router.metrics.snapshot()["total"]["shed"] == 0
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "canary_wait"
    fc.advance(11.0)
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "promoted"
    assert all(st["version"] == 2
               for st in router.replica_stats().values())
    assert mvm.current_version == 2 and mvm.state == "idle"
    assert router.metrics.canary_replicas.value == 0
    assert router.metrics.registry.snapshot()[
        "serve_router_promotions_total"] == 1
    return record(router, futs, reps, polls=polls)


def test_mvm_canary_then_promote_zero_shed():
    twin(s_mvm_canary_then_promote)


def s_mvm_degraded_canary_rollback(P):
    fc = FakeClock()
    router, reps, plans, _ = make_fleet(P, 4, version=1, clock=fc)
    factory = FakeFactory(P, newest_version=2)
    mvm = P.ModelVersionManager(router, factory, canary_fraction=0.25,
                                observe_s=10.0, min_canary_requests=5,
                                max_error_delta=0.02, clock=fc)
    polls = [mvm.poll()]
    assert polls[-1]["action"] == "canary"
    canary = polls[-1]["canaries"][0]
    plans[canary].arm("serve.replica_infer", exc=P.InjectedFault)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(32)]
    pump(reps, rounds=6)
    assert all(f.exception(timeout=0) is None for f in futs)
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "rolled_back"
    assert "error ratio" in polls[-1]["reason"]
    plans[canary].disarm("serve.replica_infer")
    assert all(st["version"] == 1
               for st in router.replica_stats().values())
    assert mvm.current_version == 1 and mvm.quarantined == {2}
    assert router.metrics.registry.snapshot()[
        "serve_router_rollbacks_total"] == 1
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "none"
    more = [router.submit(np.zeros(4, np.float32)) for _ in range(8)]
    pump(reps)
    assert {float(f.result(timeout=0)[0]) for f in more} == {1.0}
    return record(router, futs + more, reps, polls=polls)


def test_mvm_degraded_canary_instant_rollback():
    twin(s_mvm_degraded_canary_rollback)


def s_mvm_single_transient_failure(P):
    fc = FakeClock()
    router, reps, plans, _ = make_fleet(P, 4, version=1, clock=fc)
    factory = FakeFactory(P, newest_version=2)
    mvm = P.ModelVersionManager(router, factory, canary_fraction=0.25,
                                observe_s=10.0, min_canary_requests=5,
                                min_error_samples=5, clock=fc)
    polls = [mvm.poll()]
    canary = polls[-1]["canaries"][0]
    plans[canary].arm("serve.replica_infer", exc=P.InjectedFault, times=1)
    f = router.submit(np.zeros(4, np.float32))
    pump(reps)
    assert f.exception(timeout=0) is None
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "canary_wait"
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(24)]
    pump(reps)
    assert all(fu.exception(timeout=0) is None for fu in futs)
    fc.advance(11.0)
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "promoted"
    assert mvm.quarantined == set()
    return record(router, [f] + futs, reps, polls=polls)


def test_mvm_single_transient_canary_failure_no_rollback():
    twin(s_mvm_single_transient_failure)


def s_mvm_reconciles_missed_promote(P):
    fc = FakeClock()
    router, reps, _, _ = make_fleet(P, 4, version=1, clock=fc)
    factory = FakeFactory(P, newest_version=2)
    mvm = P.ModelVersionManager(router, factory, canary_fraction=0.25,
                                observe_s=1.0, min_canary_requests=2,
                                clock=fc)
    polls = [mvm.poll()]
    assert polls[-1]["action"] == "canary"
    reps[3].kill()
    router.check_replicas()
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(8)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in futs)
    fc.advance(2.0)
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "promoted"
    reps[3].restart()
    assert router.check_replicas()["r3"] == "rejoined"
    assert router.replica_stats()["r3"]["version"] == 1
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "reconciled"
    assert polls[-1]["reconciled"] == ["r3"]
    assert all(st["version"] == 2
               for st in router.replica_stats().values())
    polls.append(mvm.poll())
    assert polls[-1]["action"] == "none"
    return record(router, futs, reps, polls=polls)


def test_mvm_reconciles_replica_that_missed_promote():
    twin(s_mvm_reconciles_missed_promote)


def s_mvm_unloadable_version_quarantined(P):
    fc = FakeClock()
    router, reps, plans, _ = make_fleet(P, 2, version=1, clock=fc)
    factory = FakeFactory(P, newest_version=2)
    for p in plans.values():
        p.arm("serve.swap", exc=P.InjectedFault, times=1)
    mvm = P.ModelVersionManager(router, factory, clock=fc)
    res = mvm.poll()
    assert res["action"] == "swap_failed"
    assert mvm.quarantined == {2} and mvm.state == "idle"
    assert all(st["version"] == 1
               for st in router.replica_stats().values())
    assert mvm.poll()["action"] == "none"
    return record(router, [], reps, action=res["action"],
                  canaries=res["canaries"])


def test_mvm_unloadable_version_quarantined():
    twin(s_mvm_unloadable_version_quarantined)


# ----------------------------------------------------------------- TCP tier
# real sockets and threads: the records keep the deterministic parts

def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def s_tcp_end_to_end(P):
    backend = P.LocalReplica(P.FakeEngine(version=7), name="backend",
                             queue_capacity=32, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    client = P.TcpReplica("127.0.0.1", server.port, name="remote")
    try:
        futs = [client.submit(np.full((4,), i, np.float32))
                for i in range(6)]
        out = [np.asarray(f.result(timeout=30)).tolist() for f in futs]
        for i, y in enumerate(out):
            np.testing.assert_array_equal(y, np.full((4,), i + 7))
        client.ping()
        assert _wait(lambda: client.version is not None)
        assert client.version == 7
        assert client.input_shape == (4,)
        assert client.health() is None and not client.is_dead()
        st = client.stats()
        assert st["version"] == 7 and st["state"] == "up"
        return {"results": out, "stats": {k: st[k] for k in
                                          ("name", "state", "version")},
                "queue_capacity": client.queue_capacity}
    finally:
        client.close()
        server.close()
        backend.close()


def test_tcp_replica_end_to_end():
    twin(s_tcp_end_to_end)


def s_tcp_connection_close_fails_pending(P):
    backend = P.LocalReplica(P.FakeEngine(version=7), name="backend",
                             queue_capacity=32, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    client = P.TcpReplica("127.0.0.1", server.port, name="remote")
    try:
        backend.kill()
        server.close()
        assert _wait(client.is_dead)
        with pytest.raises(P.ReplicaDeadError):
            client.submit(np.zeros(4, np.float32))
        return {"dead": client.is_dead(),
                "health": client.health().split(":")[0]}
    finally:
        client.close()
        backend.close()


def test_tcp_replica_connection_close_fails_pending():
    twin(s_tcp_connection_close_fails_pending)


def s_tcp_last_heard_timeout(P):
    backend = P.LocalReplica(P.FakeEngine(), name="backend",
                             queue_capacity=8, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    fc = FakeClock(100.0)
    client = P.TcpReplica("127.0.0.1", server.port, name="remote",
                          timeout_s=5.0, clock=fc)
    try:
        assert _wait(lambda: client.version is not None)
        assert client.health() is None
        client._chan.send = lambda *a, **k: None  # black-hole the link
        fc.advance(6.0)
        assert client.health() is None   # asks (ping), does not convict
        assert not client.is_dead()
        fc.advance(6.0)
        reason = client.health()
        assert reason is not None and "unresponsive" in reason
        assert client.is_dead()
        return {"reason": reason}
    finally:
        client.close()
        server.close()
        backend.close()


def test_tcp_replica_last_heard_timeout():
    twin(s_tcp_last_heard_timeout)


def s_router_sweep_convicts_partitioned_tcp(P):
    backend = P.LocalReplica(P.FakeEngine(), name="backend",
                             queue_capacity=8, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    fc = FakeClock(100.0)
    client = P.TcpReplica("127.0.0.1", server.port, name="tcp0",
                          timeout_s=5.0, clock=fc)
    local = P.LocalReplica(P.FakeEngine(), name="local0", queue_capacity=8,
                           max_wait_ms=0.0)
    router = P.Router([client, local])
    try:
        assert _wait(lambda: client.version is not None)
        first = router.check_replicas()
        assert first["tcp0"] == "up"
        client._chan.send = lambda *a, **k: None
        fc.advance(6.0)
        router.check_replicas()
        assert not client.is_dead()
        fc.advance(6.0)
        report = router.check_replicas()
        assert client.is_dead()
        assert "ejected" in report["tcp0"]
        assert router.replica_stats()["tcp0"]["state"] == "dead"
        return {"first": first, "report": report,
                "deaths": router.metrics.registry.snapshot()[
                    "serve_router_replica_deaths_total"]}
    finally:
        router.shutdown(drain=False)
        client.close()
        server.close()
        backend.close()
        local.close()


def test_router_sweep_convicts_partitioned_tcp_replica():
    twin(s_router_sweep_convicts_partitioned_tcp)


def s_tcp_slow_sweep_no_false_eject(P):
    backend = P.LocalReplica(P.FakeEngine(), name="backend",
                             queue_capacity=8, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    fc = FakeClock(100.0)
    client = P.TcpReplica("127.0.0.1", server.port, name="remote",
                          timeout_s=2.0, clock=fc)
    try:
        assert _wait(lambda: client.version is not None)
        verdicts = []
        for _ in range(3):
            fc.advance(6.0)
            client.health()

            def heard():
                with client._lock:
                    return client._last_heard >= fc() - 0.1

            _wait(heard)
            verdicts.append(client.health())
            assert verdicts[-1] is None
            assert not client.is_dead()
        return {"verdicts": verdicts}
    finally:
        client.close()
        server.close()
        backend.close()


def test_tcp_replica_slow_sweep_does_not_false_eject():
    twin(s_tcp_slow_sweep_no_false_eject)


def s_router_over_tcp_kill_failover(P):
    backend = P.LocalReplica(P.FakeEngine(version=1), name="backend",
                             queue_capacity=32, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    client = P.TcpReplica("127.0.0.1", server.port, name="tcp0")
    local = P.LocalReplica(P.FakeEngine(version=1), name="local0",
                           queue_capacity=32, max_wait_ms=0.0)
    router = P.Router([client, local])
    try:
        futs = [router.submit(np.full((4,), i, np.float32))
                for i in range(12)]
        server.close()
        backend.kill()
        router.check_replicas()
        for i, f in enumerate(futs):
            try:
                np.testing.assert_array_equal(
                    f.result(timeout=30), np.full((4,), i + 1, np.float32))
            except (P.ReplicaDeadError, P.NoReplicasError):
                pass  # typed: acceptable for in-flight rows
            assert f.done()
        deadline = time.monotonic() + 10
        while ((router.outstanding()
                or router.replica_stats()["tcp0"]["state"] != "dead")
               and time.monotonic() < deadline):
            router.check_replicas()
            time.sleep(0.005)
        assert router.outstanding() == 0
        assert router.replica_stats()["tcp0"]["state"] == "dead"
        return {"done": all(f.done() for f in futs),
                "state": router.replica_stats()["tcp0"]["state"]}
    finally:
        router.shutdown(drain=False)
        client.close()
        local.close()


def test_router_over_tcp_replicas_kill_and_failover():
    twin(s_router_over_tcp_kill_failover)


def s_tcp_remote_swap(P):
    backend = P.LocalReplica(FakeFactory(P), 1, name="versioned",
                             queue_capacity=8, max_wait_ms=0.0)
    server = P.ReplicaServer(backend, port=0)
    client = P.TcpReplica("127.0.0.1", server.port, name="remote2")
    try:
        f = client.submit(np.zeros(4, np.float32))
        before = np.asarray(f.result(timeout=30)).tolist()
        np.testing.assert_array_equal(before, np.ones(4))
        client.swap(5, timeout=30)
        f = client.submit(np.zeros(4, np.float32))
        after = np.asarray(f.result(timeout=30)).tolist()
        np.testing.assert_array_equal(after, np.full((4,), 5.0))
        return {"before": before, "after": after, "version": backend.version}
    finally:
        client.close()
        server.close()
        backend.close()


def test_tcp_remote_swap():
    twin(s_tcp_remote_swap)


@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"),
                                                   ("torch", "jax")])
def test_tcp_replica_talks_to_the_other_package(server_pkg, client_pkg):
    """The replica frames are the JAX package's: a port client serves
    through a JAX replica server and the other way round, the remote
    swap included."""
    S = {"jax": JAX, "torch": TORCH}[server_pkg]
    C = {"jax": JAX, "torch": TORCH}[client_pkg]
    backend = S.LocalReplica(FakeFactory(S), 1, name="versioned",
                             queue_capacity=8, max_wait_ms=0.0)
    server = S.ReplicaServer(backend, port=0)
    client = C.TcpReplica("127.0.0.1", server.port, name="remote")
    try:
        f = client.submit(np.full((2, 4), 3.0, np.float32))
        np.testing.assert_array_equal(f.result(timeout=30),
                                      np.full((2, 4), 4.0))
        assert client.input_shape == (4,) and client.version == 1
        client.swap(4, timeout=30)
        f = client.submit(np.zeros(4, np.float32))
        np.testing.assert_array_equal(f.result(timeout=30),
                                      np.full((4,), 4.0))
        assert client.stats()["version"] == 4
    finally:
        client.close()
        server.close()
        backend.close()


# ----------------------------------------------------- telemetry + metrics

def s_healthz_degrades_and_recovers(P):
    from urllib.error import HTTPError
    from urllib.request import urlopen

    router, reps, _, _ = make_fleet(P, 2, queue_capacity=8)
    srv = router.start_telemetry(port=0)
    try:
        with urlopen(f"{srv.url}/healthz", timeout=10) as resp:
            up = json.loads(resp.read())
        assert resp.status == 200 and up["status"] == "ok"
        assert up["flags"]["serve_router_replicas"] == 2
        for r in reps:
            r.kill()
        with pytest.raises(HTTPError) as ei:
            urlopen(f"{srv.url}/healthz", timeout=10)
        assert ei.value.code == 503
        down = json.loads(ei.value.read())
        assert any("routable" in r for r in down["reasons"])
        assert down["flags"]["serve_router_replicas_routable"] == 0
        with urlopen(f"{srv.url}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "serve_router_replica_deaths_total 2" in text
        for r in reps:
            r.restart()
        with urlopen(f"{srv.url}/healthz", timeout=10) as resp:
            again = json.loads(resp.read())
        assert again["status"] == "ok"
        return {"up": up["flags"], "down": (down["reasons"], down["flags"]),
                "again": again["status"],
                "deaths": [l for l in text.splitlines()
                           if l.startswith("serve_router_replica_deaths")]}
    finally:
        router.shutdown(drain=False)


def test_router_healthz_degrades_and_recovers():
    twin(s_healthz_degrades_and_recovers)


def s_metrics_prometheus_conformance(P):
    fc = FakeClock()
    m = P.RouterMetrics(clock=fc)
    m.record_submit("high", 2)
    m.record_shed("low", 1)
    m.record_done("high", 0.01, 2)
    m.record_failed("normal", 1)
    m.record_replica_death()
    m.record_rollback()
    for rec in (m.record_readmit, m.record_rejoin, m.record_replica_error,
                m.record_promotion, m.record_hedge, m.record_hedge_win,
                m.record_probation, m.record_probation_rejoin):
        rec()
    m.record_swap(ok=True)
    m.record_swap(ok=False)
    m.record_decommission(clean=False)
    m.version.set(3)
    text = m.prometheus()
    lines = text.splitlines()
    for p in ("high", "normal", "low"):
        for family in (f"serve_router_requests_{p}_total",
                       f"serve_router_shed_{p}_total",
                       f"serve_router_completed_{p}_total",
                       f"serve_router_failed_{p}_total",
                       f"serve_router_latency_seconds_{p}"):
            assert f"# TYPE {family}" in text, family
    assert "serve_router_requests_high_total 2" in lines
    assert "serve_router_shed_low_total 1" in lines
    assert "serve_router_replica_deaths_total 1" in lines
    assert "serve_router_rollbacks_total 1" in lines
    assert 'serve_router_latency_seconds_high_bucket{le="+Inf"} 1' in lines
    assert "serve_router_latency_seconds_high_count 1" in lines
    assert "serve_router_latency_window_p99_ms_high 10.0" in lines
    for ln in lines:
        if ln.startswith("# TYPE") and ln.endswith(" counter"):
            assert ln.split()[2].endswith("_total"), ln
    return {"text": text, "snapshot": m.snapshot(),
            "registry": m.registry.snapshot(), "p99": m.p99_ms(1),
            "repr": repr(m)}


def test_router_metrics_prometheus_conformance():
    twin(s_metrics_prometheus_conformance)


def s_metrics_snapshot_totals(P):
    fc = FakeClock()
    m = P.RouterMetrics(clock=fc)
    m.record_submit("normal", 3)
    m.record_done("normal", 0.002, 3)
    m.record_shed("low", 2)
    fc.advance(1.0)
    s = m.snapshot()
    assert s["normal"]["completed"] == 3
    assert s["normal"]["p50_ms"] == pytest.approx(2.0)
    assert s["low"]["shed"] == 2 and s["low"]["p50_ms"] is None
    assert s["total"]["shed_fraction"] == pytest.approx(2 / 5)
    assert s["total"]["throughput_rps"] == pytest.approx(3.0)
    with pytest.raises(ValueError):
        P.RouterMetrics(window=0)
    return {"snapshot": s, "text": m.prometheus()}


def test_router_metrics_snapshot_totals():
    twin(s_metrics_snapshot_totals)


def s_drain_completes_ledger(P):
    fc = FakeClock()
    router, reps, _, _ = make_fleet(P, 2, clock=fc)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(6)]

    def pump_sleep(dt):
        fc.advance(dt)
        pump(reps, rounds=1)

    router._sleep = pump_sleep
    router.drain(timeout=5.0)
    assert all(f.exception(timeout=0) is None for f in futs)
    with pytest.raises(P.DrainingError):
        router.submit(np.zeros(4, np.float32))
    return record(router, futs, reps)


def test_router_drain_completes_ledger():
    twin(s_drain_completes_ledger)


# ------------------------------------------- gray failure: hedging, probation

def _prime_p99(router, reps, fc, n=20, lat=0.01):
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(n)]
    fc.advance(lat)
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in futs)
    return futs


def _one_outstanding(router, exclude=()):
    return [name for name, st in router.replica_stats().items()
            if st["outstanding"] > 0 and name not in exclude]


def _slow_fleet(P, n, **kw):
    return make_fleet(P, n, queue_capacity=64, **kw)


def s_slow_replica_point_on_dispatch(P):
    router, reps, plans, _ = _slow_fleet(P, 1)
    plans["r0"].slow("serve.slow_replica", delay_s=0.0)
    f = router.submit(np.zeros(4, np.float32))
    pump(reps)
    assert f.exception(timeout=0) is None
    assert plans["r0"].slow_count("serve.slow_replica") >= 1
    return record(router, [f], reps,
                  slow=plans["r0"].slow_count("serve.slow_replica"))


def test_serve_slow_replica_point_is_on_the_dispatch_path():
    twin(s_slow_replica_point_on_dispatch)


def s_hedge_fires_after_delay(P):
    router, reps, _, fc = _slow_fleet(P, 3, hedge=True, hedge_min_s=0.05)
    primed = _prime_p99(router, reps, fc)
    done_before = sum(
        st["completed"] for st in router.replica_stats().values())
    f = router.submit(np.zeros(4, np.float32))
    primary = _one_outstanding(router)
    assert len(primary) == 1
    fc.advance(0.04)
    assert router.check_hedges() == 0
    fc.advance(0.02)
    assert router.check_hedges() == 1
    assert router.check_hedges() == 0
    hedge = _one_outstanding(router, exclude=primary)
    assert len(hedge) == 1 and hedge != primary
    by_name = {r.name: r for r in reps}
    while by_name[hedge[0]].step():
        pass
    np.testing.assert_array_equal(f.result(timeout=0),
                                  np.ones(4, np.float32))
    assert router.outstanding() == 0
    while by_name[primary[0]].step():
        pass
    assert router.outstanding() == 0
    snap = router.metrics.registry.snapshot()
    assert snap["serve_router_hedges_total"] == 1
    assert snap["serve_router_hedge_wins_total"] == 1
    done = sum(v for k, v in snap.items()
               if k.startswith("serve_router_completed_"))
    assert done == 21
    assert sum(st["completed"]
               for st in router.replica_stats().values()) == done_before + 2
    return record(router, primed + [f], reps, primary=primary, hedge=hedge)


def test_hedge_fires_after_delay_and_loser_resolves_nothing():
    twin(s_hedge_fires_after_delay)


def s_hedged_not_readmitted(P):
    router, reps, plans, fc = _slow_fleet(P, 3, hedge=True,
                                          hedge_min_s=0.05)
    _prime_p99(router, reps, fc)
    f = router.submit(np.zeros(4, np.float32))
    primary = _one_outstanding(router)[0]
    fc.advance(0.06)
    assert router.check_hedges() == 1
    plans[primary].arm("serve.replica_infer", exc=P.InjectedFault, times=1)
    by_name = {r.name: r for r in reps}
    while by_name[primary].step():
        pass
    assert not f.done()
    assert router.metrics.registry.snapshot().get(
        "serve_router_readmits_total", 0) == 0
    pump(reps)
    assert f.exception(timeout=0) is None
    assert router.outstanding() == 0
    return record(router, [f], reps)


def test_hedged_request_not_readmitted_while_hedge_inflight():
    twin(s_hedged_not_readmitted)


def s_hedge_cancellation_safe(P):
    router, reps, _, fc = _slow_fleet(P, 3, hedge=True, hedge_min_s=0.05)
    _prime_p99(router, reps, fc)
    f = router.submit(np.zeros(4, np.float32))
    fc.advance(0.06)
    assert router.check_hedges() == 1
    assert f.cancel()
    pump(reps)
    assert router.outstanding() == 0
    return record(router, [f], reps)


def test_hedge_cancellation_safe():
    twin(s_hedge_cancellation_safe)


def s_hedge_no_spare_replica(P):
    router, reps, _, fc = _slow_fleet(P, 1, hedge=True, hedge_min_s=0.05)
    _prime_p99(router, reps, fc, n=20)
    f = router.submit(np.zeros(4, np.float32))
    fc.advance(0.06)
    assert router.check_hedges() == 0
    pump(reps)
    assert f.exception(timeout=0) is None
    assert router.metrics.registry.snapshot()[
        "serve_router_hedges_total"] == 0
    return record(router, [f], reps)


def test_hedge_with_no_spare_replica_is_opportunistic():
    twin(s_hedge_no_spare_replica)


def s_hedging_off_until_p99(P):
    router, _, _, fc = _slow_fleet(P, 2, hedge=True, hedge_min_s=0.05)
    f = router.submit(np.zeros(4, np.float32))
    fc.advance(10.0)
    assert router.check_hedges() == 0
    return record(router, [f])


def test_hedging_off_until_p99_exists():
    twin(s_hedging_off_until_p99)


def _slow_round(router, reps, fc, slow="r0", fast_lat=0.01, slow_lat=1.0):
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(len(reps))]
    fc.advance(fast_lat)
    for r in reps:
        if r.name != slow:
            while r.step():
                pass
    fc.advance(slow_lat - fast_lat)
    for r in reps:
        if r.name == slow:
            while r.step():
                pass
    assert all(f.exception(timeout=0) is None for f in futs)
    return futs


def s_probation_and_auto_rejoin(P):
    router, reps, _, fc = _slow_fleet(
        P, 3, slow_detect=True, probation_cooldown_s=5.0,
        slow_config=P.SlownessConfig(min_peers=3, min_samples=2,
                                     dwell_s=0.5))
    futs = []
    for _ in range(3):
        futs += _slow_round(router, reps, fc)
        router.check_probation()
    stats = router.replica_stats()
    assert stats["r0"]["probation"] is True
    assert stats["r0"]["state"] == "up"
    snap = router.metrics.registry.snapshot()
    assert snap["serve_router_probations_total"] == 1
    assert snap["serve_router_probation_replicas"] == 1
    more = [router.submit(np.zeros(4, np.float32)) for _ in range(4)]
    pump([r for r in reps if r.name != "r0"])
    assert all(f.exception(timeout=0) is None for f in more)
    assert router.replica_stats()["r0"]["outstanding"] == 0
    assert router.check_probation() == ["r0"]
    fc.advance(6.0)
    assert router.check_probation() == []
    assert router.replica_stats()["r0"]["probation"] is False
    snap = router.metrics.registry.snapshot()
    assert snap["serve_router_probation_rejoins_total"] == 1
    assert snap["serve_router_probation_replicas"] == 0
    assert router.slowness.state("r0") == "healthy"
    last = [router.submit(np.zeros(4, np.float32)) for _ in range(3)]
    pump(reps)
    assert all(f.exception(timeout=0) is None for f in last)
    return record(router, futs + more + last, reps,
                  slowness=router.slowness.snapshot())


def test_slow_replica_probation_and_auto_rejoin():
    twin(s_probation_and_auto_rejoin)


def s_probation_rides_check_replicas(P):
    router, reps, _, fc = _slow_fleet(
        P, 3, slow_detect=True, probation_cooldown_s=50.0,
        slow_config=P.SlownessConfig(min_peers=3, min_samples=2,
                                     dwell_s=0.5))
    futs = []
    for _ in range(3):
        futs += _slow_round(router, reps, fc)
        router.check_replicas()
    report = router.check_replicas()
    assert report["r0"] == "up (probation)"
    return record(router, futs, reps, report=report)


def test_probation_sweep_rides_check_replicas():
    twin(s_probation_rides_check_replicas)


def test_hedge_and_slow_env_knobs(monkeypatch):
    """``DCNN_HEDGE*`` and ``DCNN_SLOW_*`` configure both packages'
    routers alike when the arguments are left None."""
    monkeypatch.setenv("DCNN_HEDGE", "1")
    monkeypatch.setenv("DCNN_HEDGE_MULT", "2.5")
    monkeypatch.setenv("DCNN_HEDGE_MIN_S", "0.03")
    monkeypatch.setenv("DCNN_SLOW_DETECT", "true")
    monkeypatch.setenv("DCNN_SLOW_PROBATION_S", "7")
    got = {}
    for P in (JAX, TORCH):
        r = P.Router([])
        got[P.name] = (r.hedge, r.hedge_multiplier, r.hedge_min_s,
                       r.slow_detect, r.probation_cooldown_s)
    assert got["torch"] == got["jax"] == (True, 2.5, 0.03, True, 7.0)


# ------------------------------------------- traces and flight bundles

def _fake_factory(P):
    return lambda version: P.FakeEngine(1 if version is None else version)


def _by_name(events):
    out = {}
    for e in events:
        out.setdefault(e["name"], []).append(e)
    return out


def _traced(P, body):
    t = P.configure(enabled=True)
    t.clear()
    try:
        return body(t)
    finally:
        P.configure(enabled=False)
        t.clear()


def _chain(evs):
    """The serving chain's trace-id and parent-id structure, ids replaced
    by their first-seen order so two packages' traces compare."""
    names = {}

    def nid(v):
        return names.setdefault(v, len(names)) if v is not None else None

    return [(n, [(nid(e["args"].get("trace_id")),
                  nid(e["args"].get("parent_id")),
                  nid(e["args"].get("span_id"))) for e in evs[n]])
            for n in ("serve.request", "serve.queue", "serve.dispatch",
                      "serve.infer")]


def s_trace_spans_local_replica(P):
    def body(t):
        rep = P.LocalReplica(_fake_factory(P), 1, name="r0", start=False)
        router = P.Router([rep])
        fut = router.submit(np.zeros(4, np.float32))
        rep.step(force=True)
        assert fut.result(timeout=5) is not None
        evs = _by_name(t.events())
        req = evs["serve.request"][0]["args"]
        q = evs["serve.queue"][0]["args"]
        d = evs["serve.dispatch"][0]["args"]
        inf = evs["serve.infer"][0]["args"]
        assert q["trace_id"] == d["trace_id"] == inf["trace_id"] \
            == req["trace_id"]
        assert q["parent_id"] == req["span_id"]
        assert d["parent_id"] == q["span_id"]
        assert inf["parent_id"] == d["span_id"]
        assert req["outcome"] == "ok"
        router.shutdown()
        rep.close()
        return {"chain": _chain(evs), "outcome": req["outcome"]}

    return _traced(P, body)


def test_router_request_trace_spans_local_replica():
    twin(s_trace_spans_local_replica)


def s_trace_crosses_tcp_boundary(P):
    def body(t):
        rep = P.LocalReplica(_fake_factory(P), 1, name="r0", start=True)
        srv = P.ReplicaServer(rep, port=0)
        cli = P.TcpReplica("127.0.0.1", srv.port, name="tcp0")
        router = P.Router([cli])
        try:
            assert cli.clock_offset_s is not None
            assert abs(cli.clock_offset_s) < 1.0
            fut = router.submit(np.zeros(4, np.float32))
            assert fut.result(timeout=10) is not None
            _wait(lambda: "serve.infer" in _by_name(t.events()))
            evs = _by_name(t.events())
            tid = evs["serve.request"][0]["args"]["trace_id"]
            for n in ("serve.queue", "serve.dispatch", "serve.infer"):
                assert any(e["args"].get("trace_id") == tid
                           for e in evs[n]), n
            return {"spans": sorted(n for n in evs if n.startswith(
                "serve."))}
        finally:
            router.shutdown()
            cli.close()
            srv.close()
            rep.close()

    return _traced(P, body)


def test_router_request_trace_crosses_tcp_boundary():
    twin(s_trace_crosses_tcp_boundary)


def s_mixed_trace_batch(P):
    def body(t):
        rep = P.LocalReplica(_fake_factory(P), 1, name="r0", start=False)
        router = P.Router([rep])
        f1 = router.submit(np.zeros(4, np.float32))
        f2 = router.submit(np.ones(4, np.float32))
        rep.step(force=True)
        assert f1.result(timeout=5) is not None
        assert f2.result(timeout=5) is not None
        evs = _by_name(t.events())
        reqs = {e["args"]["trace_id"] for e in evs["serve.request"]}
        assert len(reqs) == 2
        d = evs["serve.dispatch"][0]["args"]
        assert set(d["trace_ids"]) == reqs
        assert "parent_id" not in d
        router.shutdown()
        rep.close()
        return {"n_trace_ids": len(d["trace_ids"]),
                "results": [outcome(f1), outcome(f2)]}

    return _traced(P, body)


def test_mixed_trace_batch_records_trace_ids_list():
    twin(s_mixed_trace_batch)


def s_replica_death_flight_bundle(P, root):
    rec = P.FlightRecorder(os.path.join(root, P.name), min_interval_s=0.0)
    rep0 = P.LocalReplica(_fake_factory(P), 1, name="r0", start=False)
    rep1 = P.LocalReplica(_fake_factory(P), 1, name="r1", start=False)
    router = P.Router([rep0, rep1], flight=rec, min_routable=1)
    rep1.kill()
    router.check_replicas()
    bundles = rec.bundles()
    assert [b["trigger"] for b in bundles] == ["replica_death"]
    with open(os.path.join(bundles[0]["path"], "extra.json")) as f:
        extra = json.load(f)
    assert extra["replica"] == "r1"
    with open(os.path.join(bundles[0]["path"], "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["serve_router_replica_deaths_total"] == 1
    router.check_replicas()
    assert len(rec.bundles()) == 1
    router.shutdown()
    rep0.close()
    metrics.pop("_wall_s")  # the registry's own wall clock
    return {"extra": extra, "metrics": metrics}


def test_replica_death_trigger_through_router(tmp_path):
    twin(s_replica_death_flight_bundle, str(tmp_path))


def s_canary_rollback_flight_bundle(P, root):
    fc = FakeClock()
    rec = P.FlightRecorder(os.path.join(root, P.name), min_interval_s=0.0)
    plans = {f"r{i}": P.FaultPlan() for i in range(4)}
    factory = FakeFactory(P, newest_version=2)
    reps = [P.LocalReplica(factory, 1, name=f"r{i}", clock=fc,
                           fault_plan=plans[f"r{i}"], start=False)
            for i in range(4)]
    router = P.Router(reps, clock=fc, sleep=lambda s: fc.advance(s))
    mvm = P.ModelVersionManager(router, factory, canary_fraction=0.25,
                                observe_s=10.0, min_canary_requests=5,
                                max_error_delta=0.02, clock=fc, flight=rec)
    res = mvm.poll()
    assert res["action"] == "canary"
    canary = res["canaries"][0]
    plans[canary].arm("serve.replica_infer", exc=P.InjectedFault)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(32)]
    for _ in range(6):
        for r in reps:
            r.step(force=True)
    assert all(f.exception(timeout=5) is None for f in futs)
    res = mvm.poll()
    assert res["action"] == "rolled_back"
    bundles = [b for b in rec.bundles() if b["trigger"] == "canary_rollback"]
    assert len(bundles) == 1
    with open(os.path.join(bundles[0]["path"], "config.json")) as f:
        cfg = json.load(f)
    assert cfg["version"] == 2 and canary in cfg["canaries"]
    out = record(router, futs, reps, config=cfg)
    router.shutdown()
    for r in reps:
        r.close()
    return out


def test_canary_rollback_trigger(tmp_path):
    twin(s_canary_rollback_flight_bundle, str(tmp_path))
