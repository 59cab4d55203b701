"""Serving metrics (the part of ``dcnn_tpu/serve/metrics.py`` the batchers
need): :class:`ServeMetrics` for ``DynamicBatcher`` (rolling latency
percentiles, queue depth, batch occupancy, throughput and shed accounting)
and :class:`DecodeMetrics` for ``ContinuousBatcher`` (tokens, prefill
tokens, slots, pages, admissions, evictions and time to first token).

Every timestamp comes from an injectable ``clock`` (default
``time.monotonic``), so tests drive it by hand and assert exact values.
Every recorder also feeds a
:class:`~dcnn_tpu_torch.obs.registry.MetricsRegistry` (a private one per
instance unless ``registry=`` shares one; constructing on a shared registry
never resets its instruments, :meth:`ServeMetrics.reset` does).
``prometheus()`` renders that registry and appends the exact windowed
views as gauges, byte for byte the JAX module's text for the same calls.
:meth:`snapshot` reads the plain fields under one lock, so its percentiles
stay exact. The router metrics of the JAX module are not ported yet
(``ROADMAP.md`` Queue 1 item 5).
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
            lines.extend(render_scalar(name, "gauge", v))
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"ServeMetrics(completed={s['requests_completed']}, "
                f"shed={s['requests_shed']}, p99_ms={s['p99_ms']})")


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
            lines.extend(render_scalar(name, "gauge", v))
        return "\n".join(lines) + "\n"

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"DecodeMetrics(tokens={s['tokens']}, "
                f"completions={s['completions']}, "
                f"occupancy={s['slot_occupancy']})")
