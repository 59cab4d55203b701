"""Metrics registry: Counter / Gauge / Histogram (counterpart of
``dcnn_tpu/obs/registry.py``).

- O(1) recorders: ``Counter.inc``, ``Gauge.set`` and ``Histogram.observe``
  each take one lock and touch one slot; sorting happens in
  ``snapshot()``, on the reader's thread.
- Histogram buckets are fixed and log-spaced (``start * factor**i``), so
  relative error is the same at every scale and ``observe`` allocates
  nothing.
- ``snapshot()`` exports a plain dict, ``prometheus()`` the text
  exposition format (:mod:`.exposition`, byte for byte the JAX
  renderer's), ``instruments()`` the typed view the tsdb sampler reads;
  every instrument has ``reset()``.

:func:`get_registry` is the process-global registry, the default sink of
the port's own instruments (checkpoint saves and restores, the step guard,
the stall watchdog).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Tuple


def _valid_name(name: str) -> str:
    """Prometheus metric names: ``[a-zA-Z_:][a-zA-Z0-9_:]*``. Dots (our
    span-style names) map to underscores; anything else invalid raises —
    a silently mangled name is a metric nobody finds again."""
    out = name.replace(".", "_")
    # isascii() too: str.isalnum is Unicode-aware, but the Prometheus
    # grammar is ASCII-only — 'µ' must raise here, not poison the scrape
    ok = (bool(out) and out.isascii() and not out[0].isdigit()
          and all(c.isalnum() or c in "_:" for c in out))
    if not ok:
        raise ValueError(f"invalid metric name {name!r}")
    return out


class Counter:
    """Monotone cumulative count. ``inc`` is O(1) and thread-safe."""

    __slots__ = ("name", "help", "_lock", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: "int | float" = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Last-written value (queue depth, lr, inflight peak)."""

    __slots__ = ("name", "help", "_lock", "_v")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def add(self, n: float) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Histogram:
    """Fixed log-spaced-bucket histogram.

    Upper bounds are ``start * factor**i`` for ``i in range(buckets)`` plus
    an implicit +Inf overflow bucket. The default layout (1 µs → ~18 min at
    x2) covers every duration this framework measures; byte-sized
    histograms pass their own ``start``/``factor``. ``observe`` is O(log B)
    over B≈31 fixed bounds (one ``bisect`` on a prebuilt list — no
    allocation, no resize, safely "O(1)" for hot-path purposes).
    """

    __slots__ = ("name", "help", "bounds", "_lock", "_counts", "_sum",
                 "_count", "_min", "_max")

    def __init__(self, name: str, help: str = "", *, start: float = 1e-6,
                 factor: float = 2.0, buckets: int = 31):
        if start <= 0 or factor <= 1 or buckets < 1:
            raise ValueError(
                f"histogram {name}: need start > 0, factor > 1, buckets >= 1"
                f" (got {start}, {factor}, {buckets})")
        self.name = name
        self.help = help
        self.bounds: List[float] = [start * factor ** i for i in range(buckets)]
        self._lock = threading.Lock()
        self._counts = [0] * (buckets + 1)  # +1: the +Inf overflow bucket
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def value(self) -> Dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "mean": (self._sum / self._count) if self._count else None,
                "buckets": {b: c for b, c in zip(self.bounds, self._counts)
                            if c},
                "overflow": self._counts[-1],
            }

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs ending with (inf, count):
        the Prometheus ``_bucket{le=...}`` series."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self.bounds, self._counts):
                acc += c
                out.append((b, acc))
            out.append((float("inf"), acc + self._counts[-1]))
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0
            self._min = self._max = None


class MetricsRegistry:
    """Thread-safe get-or-create instrument store.

    ``counter(name)`` twice returns the SAME object (the point of a
    registry: two modules incrementing ``ckpt_saves_total`` share one
    stream); asking for an existing name as a different kind raises.
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._t0 = clock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        name = _valid_name(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *, start: float = 1e-6,
                  factor: float = 2.0, buckets: int = 31) -> Histogram:
        return self._get_or_create(Histogram, name, help, start=start,
                                   factor=factor, buckets=buckets)

    # -- export ------------------------------------------------------------
    def instruments(self) -> List[Tuple[str, object]]:
        """Sorted ``(name, instrument)`` pairs: the typed view the tsdb
        sampler reads (histograms keep their ``cumulative()`` buckets,
        which ``snapshot()`` flattens away)."""
        with self._lock:
            return sorted(self._instruments.items())

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time ``{name: value}`` dict (histograms expand to their
        stats dict). Sorted for stable JSON diffs."""
        with self._lock:
            items = sorted(self._instruments.items())
        out: Dict[str, object] = {}
        for name, inst in items:
            out[name] = inst.value
        out["_wall_s"] = max(self._clock() - self._t0, 0.0)
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4), rendered by
        :mod:`.exposition`, which ``ServeMetrics.prometheus`` shares."""
        from .exposition import render_instruments

        with self._lock:
            items = sorted(self._instruments.items())
        return "\n".join(render_instruments(items)) + "\n"

    def reset(self) -> None:
        """Zero every instrument and restart the wall clock. Instrument
        identities are kept: holders of a Counter keep a valid object."""
        with self._lock:
            insts = list(self._instruments.values())
            self._t0 = self._clock()
        for inst in insts:
            inst.reset()


_GLOBAL_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry: the default sink of the port's own
    instruments."""
    return _GLOBAL_REGISTRY
