"""Serving metrics (the part of ``dcnn_tpu/serve/metrics.py`` the batcher
needs): rolling latency percentiles, queue depth, batch occupancy,
throughput and shed accounting.

Every timestamp comes from an injectable ``clock`` (default
``time.monotonic``), so tests drive it by hand and assert exact values.
The Prometheus registry, slot goodput and the router/decode metrics of the
JAX module are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional


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
