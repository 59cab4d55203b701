"""Serving metrics (counterpart of ``dcnn_tpu/serve/metrics.py``):
:class:`ServeMetrics` for ``DynamicBatcher`` (rolling latency percentiles,
queue depth, batch occupancy, throughput and shed accounting),
:class:`RouterMetrics` for the ``Router`` (per-priority requests, sheds,
completions, failures and latency; fleet gauges; swap, canary, hedge and
probation counters) and :class:`DecodeMetrics` for ``ContinuousBatcher``
(tokens, prefill tokens, slots, pages, admissions, evictions and time to
first token).

Every timestamp comes from an injectable ``clock`` (default
``time.monotonic``), so tests drive it by hand and assert exact values.
Every recorder also feeds a
:class:`~dcnn_tpu_torch.obs.registry.MetricsRegistry` (a private one per
instance unless ``registry=`` shares one; constructing on a shared registry
never resets its instruments, :meth:`ServeMetrics.reset` does).
``prometheus()`` renders that registry and appends the exact windowed
views as gauges, byte for byte the JAX module's text for the same calls.
:meth:`snapshot` reads the plain fields under one lock, so its percentiles
stay exact. :class:`RouterMetrics` (with :data:`PRIORITIES`) is the router
tier's accounting on the same rules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..obs.registry import MetricsRegistry


#: Dispatch-slot goodput states: a replica's dispatcher is either running
#: a batch (occupied), waiting for work (idle), or refusing new work on
#: the way down (draining). Time-weighted via ``record_slot_state``.
SLOT_STATES = ("idle", "occupied", "draining")


class ServeMetrics:
    """Rolling serving statistics exported as a plain dict.

    ``window`` bounds the latency/occupancy deques — percentiles describe
    the last ``window`` completed requests, not all of history, so a load
    spike ages out instead of polluting the p99 forever. Counters
    (submitted / completed / shed) are cumulative since construction or
    :meth:`reset`.
    """

    def __init__(self, *, window: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._clock = clock
        self._window = window
        self._lock = threading.Lock()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=clock))
        self._submitted = self.registry.counter(
            "serve_samples_submitted_total",
            "samples accepted into the request queue")
        self._completed = self.registry.counter(
            "serve_samples_completed_total", "samples served")
        self._shed = self.registry.counter(
            "serve_samples_shed_total", "samples rejected by backpressure")
        self._batches = self.registry.counter(
            "serve_batches_total", "dispatched batches")
        self._queue_depth = self.registry.gauge(
            "serve_queue_depth", "samples currently queued")
        self._lat_hist = self.registry.histogram(
            "serve_latency_seconds", "request latency (submit to complete)")
        self._slot_counters = {
            state: self.registry.counter(
                f"serve_slot_{state}_seconds_total",
                f"cumulative seconds the dispatch slot spent {state}")
            for state in SLOT_STATES}
        # initialize the per-instance state WITHOUT touching the registry
        # instruments: on an injected shared registry they may belong to a
        # live sibling instance, and a counter must never go backwards
        # because someone constructed a second batcher
        self._init_local()

    def _init_local(self) -> None:
        with self._lock:
            self._lat_s: deque = deque(maxlen=self._window)
            self._occ: deque = deque(maxlen=self._window)
            self._submitted_n = 0
            self._completed_n = 0
            self._shed_n = 0
            self._batches_n = 0
            self._depth_n = 0
            self._slot_state: Optional[str] = None
            self._slot_t = 0.0
            self._slot_s = {state: 0.0 for state in SLOT_STATES}
            self._t0 = self._clock()

    def reset(self) -> None:
        """Zero every counter and restart the throughput wall-clock. Also
        resets this instance's registry instruments — on an injected
        shared registry that zeroes the shared series (an explicit caller
        decision here, never an accident of construction)."""
        self._init_local()
        for inst in (self._submitted, self._completed, self._shed,
                     self._batches, self._queue_depth, self._lat_hist,
                     *self._slot_counters.values()):
            inst.reset()

    # -- recorders (all O(1), thread-safe) --
    def record_submit(self, n: int = 1) -> None:
        """A request of ``n`` samples was accepted into the queue."""
        with self._lock:
            self._submitted_n += n
        self._submitted.inc(n)

    def record_shed(self, n: int = 1) -> None:
        """A request of ``n`` samples was rejected by backpressure."""
        with self._lock:
            self._shed_n += n
        self._shed.inc(n)

    def record_queue_depth(self, depth: int) -> None:
        """Gauge: samples currently queued (set on enqueue and dispatch)."""
        with self._lock:
            self._depth_n = depth
        self._queue_depth.set(depth)

    def record_batch(self, size: int, bucket: int) -> None:
        """A batch of ``size`` real samples ran in a ``bucket``-sized
        session; occupancy = size/bucket (the padding waste indicator)."""
        with self._lock:
            self._batches_n += 1
            self._occ.append(size / max(bucket, 1))
        self._batches.inc()

    def record_done(self, latency_s: float, n: int = 1) -> None:
        """A request of ``n`` samples completed ``latency_s`` after it was
        submitted (queue wait + batching delay + compute)."""
        with self._lock:
            self._completed_n += n
            self._lat_s.append(latency_s)
        self._completed.inc(n)
        self._lat_hist.observe(latency_s)

    def record_slot_state(self, state: str) -> None:
        """The dispatch slot entered ``state`` (one of
        :data:`SLOT_STATES`). Time-weighted: the interval since the
        previous transition is credited to the previous state, locally
        and on the ``serve_slot_<state>_seconds_total`` counters (the
        per-replica goodput decomposition)."""
        if state not in SLOT_STATES:
            raise ValueError(f"slot state must be one of {SLOT_STATES}, "
                             f"got {state!r}")
        now = self._clock()
        prev: Optional[str] = None
        dt = 0.0
        with self._lock:
            if self._slot_state is not None:
                prev = self._slot_state
                dt = max(now - self._slot_t, 0.0)
                self._slot_s[prev] += dt
            self._slot_state = state
            self._slot_t = now
        if prev is not None and dt > 0:
            self._slot_counters[prev].inc(dt)

    # -- export --
    def snapshot(self) -> Dict[str, Optional[float]]:
        """Point-in-time view (every field read under ONE lock — e.g.
        ``requests_completed`` always agrees with the latency window).
        Latency keys are ``None`` until the first completion so a consumer
        can't mistake 'no data' for 'zero ms'."""
        with self._lock:
            now = self._clock()
            lat = sorted(self._lat_s)
            occ = list(self._occ)
            submitted, completed = self._submitted_n, self._completed_n
            shed, batches = self._shed_n, self._batches_n
            depth = self._depth_n
            wall_s = max(now - self._t0, 0.0)
            slot = dict(self._slot_s)
            slot_state = self._slot_state
            if slot_state is not None:
                # credit the open interval so the decomposition always
                # sums to the time since the first transition
                slot[slot_state] += max(now - self._slot_t, 0.0)

        def pct(q: float) -> Optional[float]:
            if not lat:
                return None
            i = min(int(q * (len(lat) - 1) + 0.5), len(lat) - 1)
            return lat[i] * 1e3

        offered = submitted + shed
        slot_total = sum(slot.values())
        return {
            "slot_state": slot_state,
            "slot_seconds": slot,
            # None until the first transition: no data is not 100% idle
            "slot_goodput": (slot["occupied"] / slot_total)
            if slot_total > 0 else None,
            "requests_submitted": submitted,
            "requests_completed": completed,
            "requests_shed": shed,
            "shed_fraction": (shed / offered) if offered else 0.0,
            "queue_depth": depth,
            "batches": batches,
            "batch_occupancy": (sum(occ) / len(occ)) if occ else None,
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "p99_ms": pct(0.99),
            "mean_ms": (sum(lat) / len(lat) * 1e3) if lat else None,
            "throughput_rps": (completed / wall_s) if wall_s > 0 else None,
            "wall_s": wall_s,
        }

    def prometheus(self) -> str:
        """Prometheus text exposition: the registry instruments (counters,
        queue-depth gauge, latency histogram) plus the exact windowed
        percentiles/occupancy appended as gauges (they are derived views
        over the rolling window, not registry instruments)."""
        from ..obs.exposition import render_scalar

        s = self.snapshot()
        lines = [self.registry.prometheus().rstrip("\n")]
        derived = {
            "serve_latency_window_p50_ms": s["p50_ms"],
            "serve_latency_window_p95_ms": s["p95_ms"],
            "serve_latency_window_p99_ms": s["p99_ms"],
            "serve_latency_window_mean_ms": s["mean_ms"],
            "serve_batch_occupancy": s["batch_occupancy"],
            "serve_shed_fraction": s["shed_fraction"],
            "serve_throughput_rps": s["throughput_rps"],
            "serve_slot_goodput": s["slot_goodput"],
        }
        for name, v in derived.items():
            if v is None:
                continue  # absent series, not a lying 0.0
            lines.extend(render_scalar(
                name, "gauge", v))  # dcnn: metric=serve_latency_window_*_ms,serve_batch_occupancy,serve_shed_fraction,serve_throughput_rps,serve_slot_goodput
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"ServeMetrics(completed={s['requests_completed']}, "
                f"shed={s['requests_shed']}, p99_ms={s['p99_ms']})")


#: Router priority classes, best first. Admission shares are keyed on
#: these; anything else at ``Router.submit`` is a ``ValueError``.
PRIORITIES = ("high", "normal", "low")


class RouterMetrics:
    """Router-tier accounting: per-priority-class request/shed/latency
    series plus fleet gauges and swap/rollback counters, on the same
    rules as :class:`ServeMetrics` — injectable clock, O(1) recorders,
    one private registry per instance (``registry=`` to pool), exact
    windowed percentiles per priority in :meth:`snapshot`, Prometheus
    text via the shared :mod:`~dcnn_tpu_torch.obs.exposition` renderer.

    The registry has no label support (by design, as in the JAX package),
    so per-priority series are name-suffixed and keep the ``_total``
    counter convention: ``serve_router_requests_<class>_total``,
    ``serve_router_shed_<class>_total``,
    ``serve_router_completed_<class>_total``,
    ``serve_router_failed_<class>_total``, and histogram
    ``serve_router_latency_seconds_<class>``. Fleet state rides gauges
    (``serve_router_replicas`` / ``_replicas_routable`` /
    ``_outstanding_rows`` / ``_capacity_rows`` / ``_canary_replicas`` /
    ``_version``) and lifecycle counters
    (``serve_router_readmits_total``, ``serve_router_replica_deaths_total``,
    ``serve_router_rejoins_total``, ``serve_router_replica_errors_total``,
    ``serve_router_swaps_total``, ``serve_router_swap_failures_total``,
    ``serve_router_promotions_total``, ``serve_router_rollbacks_total``).
    Gray-failure serving: ``serve_router_hedges_total`` /
    ``serve_router_hedge_wins_total`` count tail-latency hedging,
    ``serve_router_probations_total`` /
    ``serve_router_probation_rejoins_total`` + gauge
    ``serve_router_probation_replicas`` track slow-replica probation.
    """

    def __init__(self, *, window: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._clock = clock
        self._window = window
        self._lock = threading.Lock()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=clock))
        r = self.registry
        self._req = {p: r.counter(f"serve_router_requests_{p}_total",
                                  f"{p}-priority requests admitted")
                     for p in PRIORITIES}
        self._shed = {p: r.counter(f"serve_router_shed_{p}_total",
                                   f"{p}-priority requests shed at admission")
                      for p in PRIORITIES}
        self._done = {p: r.counter(f"serve_router_completed_{p}_total",
                                   f"{p}-priority requests completed")
                      for p in PRIORITIES}
        self._fail = {p: r.counter(f"serve_router_failed_{p}_total",
                                   f"{p}-priority requests failed with a "
                                   f"typed error")
                      for p in PRIORITIES}
        self._lat_hist = {p: r.histogram(
            f"serve_router_latency_seconds_{p}",
            f"{p}-priority request latency (admit to complete)")
            for p in PRIORITIES}
        self._readmits = r.counter(
            "serve_router_readmits_total",
            "accepted requests re-admitted to a surviving replica")
        self._deaths = r.counter("serve_router_replica_deaths_total",
                                 "replicas ejected as dead")
        self._rejoins = r.counter("serve_router_rejoins_total",
                                  "dead replicas re-admitted to the fleet")
        self._errors = r.counter("serve_router_replica_errors_total",
                                 "request failures attributed to a replica")
        self._swaps = r.counter("serve_router_swaps_total",
                                "completed replica version swaps")
        self._swap_failures = r.counter(
            "serve_router_swap_failures_total",
            "version swaps that failed (replica rejoined on old version)")
        self._promotions = r.counter(
            "serve_router_promotions_total",
            "canary versions promoted to the whole fleet")
        self._rollbacks = r.counter(
            "serve_router_rollbacks_total",
            "canary versions rolled back on regression")
        self._decommissions = r.counter(
            "serve_router_decommissions_total",
            "replicas removed via graceful drain-then-remove")
        self._decommission_sweeps = r.counter(
            "serve_router_decommission_sweeps_total",
            "decommissions that had to force-sweep outstanding work "
            "(drain timeout or death mid-drain); the work failed typed "
            "and re-admitted — never silently dropped")
        self._hedges = r.counter(
            "serve_router_hedges_total",
            "tail requests duplicated to a second replica after the "
            "hedge delay")
        self._hedge_wins = r.counter(
            "serve_router_hedge_wins_total",
            "hedged requests where the duplicate answered first")
        self._probations = r.counter(
            "serve_router_probations_total",
            "replicas demoted to probation as sustained latency outliers")
        self._probation_rejoins = r.counter(
            "serve_router_probation_rejoins_total",
            "probation replicas released after a clean probe")
        self.replicas = r.gauge("serve_router_replicas",
                                "replicas known to the router")
        self.replicas_routable = r.gauge(
            "serve_router_replicas_routable",
            "replicas currently accepting traffic")
        self.outstanding_rows = r.gauge(
            "serve_router_outstanding_rows",
            "accepted sample rows not yet resolved")
        self.capacity_rows = r.gauge(
            "serve_router_capacity_rows",
            "aggregate queue capacity of routable replicas")
        self.canary_replicas = r.gauge(
            "serve_router_canary_replicas",
            "replicas currently serving the canary version")
        self.version = r.gauge("serve_router_version",
                               "fleet model version (checkpoint step)")
        self.probation_replicas = r.gauge(
            "serve_router_probation_replicas",
            "replicas currently held in latency probation")
        self._init_local()

    def _init_local(self) -> None:
        with self._lock:
            self._lat_s = {p: deque(maxlen=self._window) for p in PRIORITIES}
            self._counts = {p: {"requests": 0, "shed": 0, "completed": 0,
                                "failed": 0} for p in PRIORITIES}
            self._t0 = self._clock()

    # -- recorders (all O(1), thread-safe) --
    def record_submit(self, priority: str, n: int = 1) -> None:
        with self._lock:
            self._counts[priority]["requests"] += n
        self._req[priority].inc(n)

    def record_shed(self, priority: str, n: int = 1) -> None:
        with self._lock:
            self._counts[priority]["shed"] += n
        self._shed[priority].inc(n)

    def record_done(self, priority: str, latency_s: float,
                    n: int = 1) -> None:
        with self._lock:
            self._counts[priority]["completed"] += n
            self._lat_s[priority].append(latency_s)
        self._done[priority].inc(n)
        self._lat_hist[priority].observe(latency_s)

    def record_failed(self, priority: str, n: int = 1) -> None:
        with self._lock:
            self._counts[priority]["failed"] += n
        self._fail[priority].inc(n)

    def record_readmit(self) -> None:
        self._readmits.inc()

    def record_replica_death(self) -> None:
        self._deaths.inc()

    def record_rejoin(self) -> None:
        self._rejoins.inc()

    def record_replica_error(self) -> None:
        self._errors.inc()

    def record_swap(self, ok: bool) -> None:
        (self._swaps if ok else self._swap_failures).inc()

    def record_promotion(self) -> None:
        self._promotions.inc()

    def record_rollback(self) -> None:
        self._rollbacks.inc()

    def record_decommission(self, clean: bool = True) -> None:
        self._decommissions.inc()
        if not clean:
            self._decommission_sweeps.inc()

    def record_hedge(self) -> None:
        self._hedges.inc()

    def record_hedge_win(self) -> None:
        self._hedge_wins.inc()

    def record_probation(self) -> None:
        self._probations.inc()

    def record_probation_rejoin(self) -> None:
        self._probation_rejoins.inc()

    def p99_ms(self, min_samples: int = 20) -> Optional[float]:
        """Exact windowed p99 across ALL priority classes — the hedge
        delay's base signal. ``None`` until ``min_samples`` completions
        exist (a hedge delay derived from two data points would fire on
        noise)."""
        with self._lock:
            lat = sorted(v for p in PRIORITIES for v in self._lat_s[p])
        if len(lat) < max(min_samples, 1):
            return None
        i = min(int(0.99 * (len(lat) - 1) + 0.5), len(lat) - 1)
        return lat[i] * 1e3

    # -- export --
    def snapshot(self) -> Dict[str, object]:
        """Point-in-time per-priority view + totals, consistent under one
        lock; latency keys ``None`` until the first completion (same
        no-data-is-not-zero rule as :meth:`ServeMetrics.snapshot`)."""
        with self._lock:
            lat = {p: sorted(self._lat_s[p]) for p in PRIORITIES}
            counts = {p: dict(self._counts[p]) for p in PRIORITIES}
            wall_s = max(self._clock() - self._t0, 0.0)

        def pct(vals, q):
            if not vals:
                return None
            i = min(int(q * (len(vals) - 1) + 0.5), len(vals) - 1)
            return vals[i] * 1e3

        out: Dict[str, object] = {"wall_s": wall_s}
        totals = {"requests": 0, "shed": 0, "completed": 0, "failed": 0}
        for p in PRIORITIES:
            c = counts[p]
            offered = c["requests"] + c["shed"]
            out[p] = {
                **c,
                "shed_fraction": (c["shed"] / offered) if offered else 0.0,
                "p50_ms": pct(lat[p], 0.50),
                "p99_ms": pct(lat[p], 0.99),
                "mean_ms": (sum(lat[p]) / len(lat[p]) * 1e3)
                if lat[p] else None,
            }
            for k in totals:
                totals[k] += c[k]
        offered = totals["requests"] + totals["shed"]
        totals["shed_fraction"] = (totals["shed"] / offered) if offered \
            else 0.0
        completed = totals["completed"]
        totals["throughput_rps"] = (completed / wall_s) if wall_s > 0 \
            else None
        out["total"] = totals
        return out

    def prometheus(self) -> str:
        """Registry instruments plus the exact per-priority windowed
        percentiles appended as gauges (derived views, like
        :meth:`ServeMetrics.prometheus`)."""
        from ..obs.exposition import render_scalar

        s = self.snapshot()
        lines = [self.registry.prometheus().rstrip("\n")]
        for p in PRIORITIES:
            for key, v in ((f"serve_router_latency_window_p50_ms_{p}",
                            s[p]["p50_ms"]),
                           (f"serve_router_latency_window_p99_ms_{p}",
                            s[p]["p99_ms"])):
                if v is None:
                    continue  # absent series, not a lying 0.0
                lines.extend(render_scalar(
                    key, "gauge", v))  # dcnn: metric=serve_router_latency_window_*
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        t = self.snapshot()["total"]
        return (f"RouterMetrics(completed={t['completed']}, "
                f"shed={t['shed']}, failed={t['failed']})")


class DecodeMetrics:
    """Continuous-batching decode telemetry (``serve/decode.py``), on the
    port's :class:`~dcnn_tpu_torch.obs.registry.MetricsRegistry` (a
    private one unless ``registry=`` shares one): thread-safe O(1)
    recorders, an injectable clock, one-lock :meth:`snapshot`.

    Its vocabulary: **tokens** (generated, the unit throughput is priced
    in) against **prefill tokens** (prompt and replay steps that write K/V
    and emit nothing), **slots** (occupancy = active / max over the step
    window), **pages** in use, admissions and evictions
    (preempt-and-recompute), and **TTFT** (submit to first generated
    token)."""

    def __init__(self, *, window: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._clock = clock
        self._window = window
        self._lock = threading.Lock()
        self.registry = (registry if registry is not None
                         else MetricsRegistry(clock=clock))
        r = self.registry
        self._submitted = r.counter(
            "decode_sequences_submitted_total",
            "sequences accepted into the decode queue")
        self._shed = r.counter(
            "decode_sequences_shed_total",
            "sequences rejected by decode-queue backpressure")
        self._admissions = r.counter(
            "decode_admissions_total",
            "sequences admitted into a running batch at a step boundary")
        self._evictions = r.counter(
            "decode_evictions_total",
            "sequences preempted to the queue on page exhaustion "
            "(recompute-on-readmission)")
        self._completions = r.counter(
            "decode_completions_total",
            "sequences decoded to max_new_tokens or EOS")
        self._tokens = r.counter(
            "decode_tokens_total", "tokens generated (emission steps)")
        self._prefill = r.counter(
            "decode_prefill_tokens_total",
            "prompt/replay tokens consumed (KV written, nothing emitted)")
        self._steps = r.counter(
            "decode_steps_total", "fixed-shape decode steps dispatched")
        self._active = r.gauge(
            "decode_active_slots", "sequences resident in decode slots")
        self._pages = r.gauge(
            "decode_pages_in_use", "KV pages currently allocated")
        self._queue_depth = r.gauge(
            "decode_queue_depth", "sequences waiting for a slot")
        self._ttft_hist = r.histogram(
            "decode_ttft_seconds",
            "time to first generated token (submit to first emission)")
        self._init_local()

    def _init_local(self) -> None:
        with self._lock:
            self._ttft_s: deque = deque(maxlen=self._window)
            self._occ: deque = deque(maxlen=self._window)
            self._counts = {k: 0 for k in (
                "submitted", "shed", "admitted", "evicted", "completed",
                "tokens", "prefill_tokens", "steps")}
            self._active_n = 0
            self._pages_n = 0
            self._depth_n = 0
            self._t0 = self._clock()

    def reset(self) -> None:
        """Zero everything, this instance's registry instruments included,
        and restart the throughput wall clock."""
        self._init_local()
        for inst in (self._submitted, self._shed, self._admissions,
                     self._evictions, self._completions, self._tokens,
                     self._prefill, self._steps, self._active, self._pages,
                     self._queue_depth, self._ttft_hist):
            inst.reset()

    def _count(self, key: str, counter, n: int) -> None:
        with self._lock:
            self._counts[key] += n
        counter.inc(n)

    # -- recorders (O(1), thread-safe) --
    def record_submit(self, n: int = 1) -> None:
        self._count("submitted", self._submitted, n)

    def record_shed(self, n: int = 1) -> None:
        self._count("shed", self._shed, n)

    def record_admit(self, n: int = 1) -> None:
        self._count("admitted", self._admissions, n)

    def record_evict(self, n: int = 1) -> None:
        self._count("evicted", self._evictions, n)

    def record_complete(self, n: int = 1) -> None:
        self._count("completed", self._completions, n)

    def record_token(self, n: int = 1) -> None:
        self._count("tokens", self._tokens, n)

    def record_prefill(self, n: int = 1) -> None:
        self._count("prefill_tokens", self._prefill, n)

    def record_ttft(self, seconds: float) -> None:
        with self._lock:
            self._ttft_s.append(seconds)
        self._ttft_hist.observe(seconds)

    def record_step(self, active: int, max_slots: int) -> None:
        """One decode step ran with ``active`` of ``max_slots`` slots
        occupied."""
        with self._lock:
            self._counts["steps"] += 1
            self._occ.append(active / max(max_slots, 1))
            self._active_n = active
        self._steps.inc()
        self._active.set(active)

    def record_pages(self, pages_in_use: int) -> None:
        with self._lock:
            self._pages_n = pages_in_use
        self._pages.set(pages_in_use)

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._depth_n = depth
        self._queue_depth.set(depth)

    # -- export --
    def snapshot(self) -> Dict[str, Optional[float]]:
        """Point-in-time view under one lock. The TTFT keys and
        ``slot_occupancy`` are ``None`` until data exists;
        ``tokens_per_sec`` counts generated tokens only."""
        with self._lock:
            now = self._clock()
            ttft = sorted(self._ttft_s)
            occ = list(self._occ)
            c = dict(self._counts)
            active, pages = self._active_n, self._pages_n
            depth = self._depth_n
            wall_s = max(now - self._t0, 0.0)

        def pct(q: float) -> Optional[float]:
            if not ttft:
                return None
            i = min(int(q * (len(ttft) - 1) + 0.5), len(ttft) - 1)
            return ttft[i] * 1e3

        return {
            "sequences_submitted": c["submitted"],
            "sequences_shed": c["shed"],
            "admissions": c["admitted"],
            "evictions": c["evicted"],
            "completions": c["completed"],
            "tokens": c["tokens"],
            "prefill_tokens": c["prefill_tokens"],
            "steps": c["steps"],
            "active_slots": active,
            "pages_in_use": pages,
            "queue_depth": depth,
            "slot_occupancy": (sum(occ) / len(occ)) if occ else None,
            "ttft_p50_ms": pct(0.50),
            "ttft_p99_ms": pct(0.99),
            "ttft_mean_ms": (sum(ttft) / len(ttft) * 1e3) if ttft else None,
            "tokens_per_sec": (c["tokens"] / wall_s) if wall_s > 0 else None,
            "wall_s": wall_s,
        }

    def prometheus(self) -> str:
        """Registry instruments plus the derived windowed views appended
        as gauges (the split of :meth:`ServeMetrics.prometheus`)."""
        from ..obs.exposition import render_scalar

        s = self.snapshot()
        lines = [self.registry.prometheus().rstrip("\n")]
        derived = {
            "decode_ttft_window_p50_ms": s["ttft_p50_ms"],
            "decode_ttft_window_p99_ms": s["ttft_p99_ms"],
            "decode_slot_occupancy": s["slot_occupancy"],
            "decode_tokens_per_sec": s["tokens_per_sec"],
        }
        for name, v in derived.items():
            if v is None:
                continue  # absent series, not a lying 0.0
            lines.extend(render_scalar(
                name, "gauge", v))  # dcnn: metric=decode_ttft_window_*_ms,decode_slot_occupancy,decode_tokens_per_sec
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"DecodeMetrics(tokens={s['tokens']}, "
                f"completions={s['completions']}, "
                f"occupancy={s['slot_occupancy']})")
