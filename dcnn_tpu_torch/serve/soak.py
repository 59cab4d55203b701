"""The shared diurnal autoscale soak (counterpart of
``dcnn_tpu/serve/soak.py``).

An open-loop soak: a 10x peak-to-trough diurnal traffic curve through the
router while the autoscaler breathes the fleet, with a replica preemption
and a canary swap injected mid-load, reported as availability,
SLO-violation minutes and scale-up reaction time. The tests drive it,
and ``chip_smoke.py`` drives the same injections
(:class:`SoakInjections`) over engines on the card.

Everything runs on a :class:`ManualClock` (no real sleeps): replica
dispatchers are stepped on a fixed service cadence and the autoscaler is
ticked on its own cadence by :func:`run_diurnal_soak`'s virtual-time
event loop, so a four-minute soak takes well under a second of wall and
is exactly reproducible. The replicas are real ``LocalReplica``s over a
:class:`SyntheticEngine` (``x + version`` on CPU tensors: the control
loop under test is the router and autoscaler tier, not the card).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .autoscale import Autoscaler, AutoscalerConfig
from .metrics import RouterMetrics, ServeMetrics
from .replica import LocalReplica
from .router import Router
from .traffic import diurnal, open_loop


class ManualClock:
    """A monotonic clock advanced by hand — the injectable-clock twin of
    ``time.monotonic`` every layer of the serve stack accepts."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class SyntheticEngine:
    """Batcher-compatible engine without a model: logits = x + version,
    a CPU tensor. Deterministic and instant, so soak outcomes measure the
    control loop, not compute jitter."""

    def __init__(self, version: Any = 1, name: str = "synthetic",
                 features: int = 4):
        self.input_shape = (features,)
        self.max_batch = 8
        self.bucket_sizes = [1, 2, 4, 8]
        self.name = name
        self.version = version
        self.batch_invariant = True

    def bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if b >= n:
                return b
        raise ValueError(n)

    def pad_to_bucket(self, x):
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        b = self.bucket_for(n)
        if b > n:
            pad = np.zeros((b - n,) + x.shape[1:], np.float32)
            x = np.concatenate([x, pad])
        return x, n

    def run_padded(self, x):
        return torch.as_tensor(np.asarray(x, np.float32)) + (self.version
                                                             or 0)

    def warm(self):
        # nothing to warm: the dispatcher's warm-up is a no-op here
        return {}


def synthetic_engine_factory(version: Any) -> SyntheticEngine:
    return SyntheticEngine(1 if version is None else version)


def make_soak_replica_factory(clock: Callable[[], float], *,
                              queue_capacity: int = 32,
                              prefix: str = "as",
                              window: Optional[int] = None
                              ) -> Callable[[Any], LocalReplica]:
    """``factory(version) -> LocalReplica`` over :class:`SyntheticEngine`
    — the autoscaler's spin-up path in every soak consumer. ``window``
    sizes the replica's ServeMetrics latency window (small windows age a
    cleared overload out of the p99 breach verdict quickly)."""
    made = [0]

    def factory(version: Any) -> LocalReplica:
        made[0] += 1
        metrics = (ServeMetrics(window=window, clock=clock)
                   if window is not None else None)
        return LocalReplica(
            synthetic_engine_factory, 1 if version is None else version,
            name=f"{prefix}{made[0]}", queue_capacity=queue_capacity,
            clock=clock, start=False, metrics=metrics)
    return factory


class SoakInjections:
    """The soak's fault schedule and its autoscaler turns, shared by
    :func:`run_diurnal_soak` and the autoscale phase of ``chip_smoke.py``.
    A turn is due every ``tick_dt`` from 0 (``next_tick``). At the first
    turn at or after ``kill_at`` a replica is preempted: ``kill()``, by
    default the router's last live replica; a ``kill`` that returns
    ``None`` found no victim and is tried again at the next turn. At the
    first turn at or after ``canary_at`` a canary starts: ``canary()``, by
    default ``router.swap_replica`` of the first routable replica to
    version 2. ``None`` for a time skips that injection. Then the
    autoscaler ticks and the routable fleet size is recorded in
    ``fleet_sizes`` as ``(t, size)``; ``events`` maps ``"killed"`` and
    ``"canary"`` to ``(what kill/canary returned, t)``."""

    def __init__(self, router: Router, scaler: Autoscaler, *,
                 tick_dt: float = 1.0, kill_at: Optional[float] = None,
                 canary_at: Optional[float] = None,
                 kill: Optional[Callable[[], Any]] = None,
                 canary: Optional[Callable[[], Any]] = None):
        self.router, self.scaler, self.tick_dt = router, scaler, tick_dt
        self.kill_at, self.canary_at = kill_at, canary_at
        self._kill = kill if kill is not None else self._kill_last
        self._canary = canary if canary is not None else self._swap_first
        self.next_tick = 0.0
        self.events: Dict[str, Tuple[Any, float]] = {}
        self.fleet_sizes: List[Tuple[float, int]] = []

    def _kill_last(self) -> str:
        name, rep = [(n, r) for n, r in self.router.replicas().items()
                     if not r.is_dead()][-1]
        rep.kill()  # preemption mid-load
        return name

    def _swap_first(self) -> str:
        up = [n for n, st in self.router.replica_stats().items()
              if st["state"] == "up"]
        self.router.swap_replica(up[0], 2, canary=True)
        return up[0]

    def turn(self, t: float) -> Dict[str, Any]:
        """The injections due at ``t``, then one autoscaler tick; returns
        the tick's answer."""
        if ("killed" not in self.events and self.kill_at is not None
                and t >= self.kill_at):
            victim = self._kill()
            if victim is not None:
                self.events["killed"] = (victim, t)
        if ("canary" not in self.events and self.canary_at is not None
                and t >= self.canary_at):
            self.events["canary"] = (self._canary(), t)
        out = self.scaler.tick()
        self.fleet_sizes.append((t, sum(
            1 for st in self.router.replica_stats().values()
            if st["state"] == "up")))
        self.next_tick += self.tick_dt
        return out


def run_diurnal_soak(*, seconds: float = 240.0, period: float = 240.0,
                     peak: float = 200.0, trough: float = 20.0,
                     service_dt: float = 0.1, tick_dt: float = 1.0,
                     kill_at: Optional[float] = 100.0,
                     canary_at: Optional[float] = 140.0,
                     slo_p99_ms: float = 150.0,
                     config: Optional[AutoscalerConfig] = None,
                     on_tick: Optional[Callable[[float, int], None]] = None
                     ) -> Tuple[Dict[str, Any], Autoscaler, Router]:
    """The sleep-free soak (module docstring). Returns
    ``(report, scaler, router)``; the report carries the JAX package's
    keys (availability, slo_violation_minutes, reaction_max_s, the
    breathing evidence and the aggregator's ``history``).
    ``kill_at``/``canary_at`` of ``None`` skip that injection;
    ``on_tick(t, fleet_size)`` observes each autoscaler turn."""
    fc = ManualClock()
    # window=512: the replica p99 describes the last few seconds of
    # traffic at soak rates, so a cleared overload ages out of the
    # breach verdict quickly instead of pinning it for half a minute
    factory = make_soak_replica_factory(fc, queue_capacity=32, window=512)
    boot = factory(1)
    cfg = config if config is not None else AutoscalerConfig(
        slo_p99_ms=slo_p99_ms, max_shed_fraction=0.0,
        high_utilization=0.70, low_utilization=0.20,
        min_replicas=1, max_replicas=6,
        up_cooldown_s=5.0, down_cooldown_s=20.0,
        breach_ticks=1, idle_ticks=3, drain_timeout_s=2.0)

    def pump_all():
        for rep in router.replicas().values():
            try:
                rep.step(force=True)
            except Exception:
                pass

    def router_sleep(dt):
        fc.advance(dt)
        pump_all()
    # router_sleep closes over `router` by name — bound below, before any
    # drain/decommission can call it
    router = Router(clock=fc, sleep=router_sleep,
                    metrics=RouterMetrics(clock=fc))
    router.add_replica(boot)
    scaler = Autoscaler(router, factory, config=cfg, clock=fc)

    inject = SoakInjections(router, scaler, tick_dt=tick_dt,
                            kill_at=kill_at, canary_at=canary_at)
    next_service = [0.0]

    def drive_until(t_end):
        while fc.t < t_end:
            nxt = min(t_end, next_service[0], inject.next_tick)
            if fc.t < nxt:
                fc.advance(nxt - fc.t)
            if fc.t >= next_service[0]:
                pump_all()
                next_service[0] += service_dt
            if fc.t >= inject.next_tick:
                inject.turn(fc.t)
                if on_tick is not None:
                    on_tick(*inject.fleet_sizes[-1])

    def soak_sleep(dt):
        drive_until(fc.t + dt)

    rate = diurnal(peak, trough, period_s=period)
    samples = [np.full((4,), 7, np.float32)]
    futs = open_loop(router, samples, rate, seconds,
                     clock=fc, sleep=soak_sleep)
    # run down the tail: no new arrivals, let everything settle
    deadline = fc.t + 30.0
    while router.outstanding() and fc.t < deadline:
        drive_until(fc.t + service_dt)
    accepted = len(futs)
    completed = sum(1 for _, f in futs
                    if f.done() and f.exception() is None)
    typed = sum(1 for _, f in futs
                if f.done() and f.exception() is not None)
    undone = accepted - completed - typed
    snap = scaler.router.metrics.registry.snapshot()
    sizes = [n for _, n in inject.fleet_sizes]
    report = {
        "accepted": accepted,
        "completed": completed,
        "typed_failures": typed,
        "silently_dropped": undone,
        "availability": completed / accepted if accepted else None,
        "outstanding_after": router.outstanding(),
        "scale_ups": snap["autoscale_scale_ups_total"],
        "scale_downs": snap["autoscale_scale_downs_total"],
        "slo_violation_minutes":
            snap["autoscale_slo_violation_seconds_total"] / 60.0,
        "reaction_max_s": snap["autoscale_scale_up_reaction_seconds"]["max"],
        "peak_fleet": max(sizes),
        "final_fleet": sizes[-1],
        "shed": snap["serve_router_shed_normal_total"],
    }
    # monitoring-plane evidence: every tick's collect() flowed through
    # the scaler's FleetAggregator, so its tsdb holds the soak's
    # time-resolved fleet history
    from ..obs.tsdb import series_stats
    store = scaler.aggregator.store
    report["history"] = {
        "series": len(store.series_names()),
        "points": store.points(),
        "p99_ms_max": series_stats(
            store.range('serve_latency_window_p99_ms{fleet="max"}')),
        "queue_depth_sum": series_stats(
            store.range('serve_queue_depth{fleet="sum"}')),
    }
    return report, scaler, router
