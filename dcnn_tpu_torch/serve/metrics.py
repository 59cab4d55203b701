"""Serving metrics (the part of ``dcnn_tpu/serve/metrics.py`` the batchers
need): :class:`ServeMetrics` for ``DynamicBatcher`` (rolling latency
percentiles, queue depth, batch occupancy, throughput and shed accounting)
and :class:`DecodeMetrics` for ``ContinuousBatcher`` (tokens, prefill
tokens, slots, pages, admissions, evictions and time to first token).

Every timestamp comes from an injectable ``clock`` (default
``time.monotonic``), so tests drive it by hand and assert exact values.
The Prometheus text exposition, slot goodput and the router metrics of the
JAX module are not ported yet (``ROADMAP.md`` Queue 1 item 9).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..obs.registry import MetricsRegistry


class ServeMetrics:
    """Rolling serving statistics exported as a plain dict. Percentiles
    describe the last ``window`` completed requests; counters are cumulative
    since construction or :meth:`reset`. Recorders are thread-safe."""

    def __init__(self, *, window: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._clock = clock
        self._window = window
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Zero every counter and restart the throughput wall clock."""
        with self._lock:
            self._lat_s: deque = deque(maxlen=self._window)
            self._occ: deque = deque(maxlen=self._window)
            self._submitted_n = 0
            self._completed_n = 0
            self._shed_n = 0
            self._batches_n = 0
            self._depth_n = 0
            self._t0 = self._clock()

    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self._submitted_n += n

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._shed_n += n

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._depth_n = depth

    def record_batch(self, size: int, bucket: int) -> None:
        """``size`` real samples ran in a ``bucket``-sized session;
        occupancy = size/bucket (the padding waste indicator)."""
        with self._lock:
            self._batches_n += 1
            self._occ.append(size / max(bucket, 1))

    def record_done(self, latency_s: float, n: int = 1) -> None:
        """A request of ``n`` samples completed ``latency_s`` after submit."""
        with self._lock:
            self._completed_n += n
            self._lat_s.append(latency_s)

    def snapshot(self) -> Dict[str, Optional[float]]:
        """Point-in-time view read under one lock. Latency keys are ``None``
        until the first completion, so 'no data' never reads as 0 ms."""
        with self._lock:
            now = self._clock()
            lat = sorted(self._lat_s)
            occ = list(self._occ)
            submitted, completed = self._submitted_n, self._completed_n
            shed, batches = self._shed_n, self._batches_n
            depth = self._depth_n
            wall_s = max(now - self._t0, 0.0)

        def pct(q: float) -> Optional[float]:
            if not lat:
                return None
            i = min(int(q * (len(lat) - 1) + 0.5), len(lat) - 1)
            return lat[i] * 1e3

        offered = submitted + shed
        return {
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
            "sequences preempted to the queue on page exhaustion")
        self._completions = r.counter(
            "decode_completions_total",
            "sequences decoded to max_new_tokens or EOS")
        self._tokens = r.counter(
            "decode_tokens_total", "tokens generated (emission steps)")
        self._prefill = r.counter(
            "decode_prefill_tokens_total",
            "prompt/replay tokens consumed (K/V written, nothing emitted)")
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
        """Waits for the registry's Prometheus text exposition, which the
        port does not have yet (``ROADMAP.md`` Queue 1 item 9)."""
        raise NotImplementedError(
            "DecodeMetrics.prometheus needs the registry's Prometheus text "
            "exposition, not ported yet (ROADMAP.md Queue 1 item 9); use "
            "snapshot() or registry.snapshot()")

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"DecodeMetrics(tokens={s['tokens']}, "
                f"completions={s['completions']}, "
                f"occupancy={s['slot_occupancy']})")
