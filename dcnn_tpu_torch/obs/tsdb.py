"""Fixed-memory in-process time-series store (counterpart of
``dcnn_tpu/obs/tsdb.py``).

``/metrics`` serves the registry as of the scrape and a flight bundle the
counters as of its trigger; this store keeps the history between them.

- :class:`TimeSeriesStore`: per-series **ring buffers** (fine tier, one
  point per sample) plus a **downsampled coarse tier** (min/max/mean over
  ``downsample`` fine points), both fixed-capacity: memory is bounded by
  ``series x (retention + coarse_retention)`` whatever the run length.
  Labeled series (``name{replica="r0"}``) share the exposition's escape
  rules.
- :class:`TsdbSampler`: a daemon thread that snapshots a
  :class:`~dcnn_tpu_torch.obs.registry.MetricsRegistry` (or exposition
  text, ``text_fn=``) into the store at a cadence. Injectable clock,
  ``Event.wait``-paced; tests drive :meth:`TsdbSampler.sample_once` by
  hand.
- A query API in the PromQL-over-time vocabulary: :meth:`range`,
  :meth:`delta`, :meth:`rate`, :meth:`avg_over_time` /
  :meth:`max_over_time` / :meth:`min_over_time`, and
  :meth:`quantile_over_time` (histogram quantile from bucket-count deltas
  over a window).
- **Atomic JSONL persistence** (:meth:`persist`, through the port's
  ``resilience.atomic``): flight bundles carry ``history.jsonl``;
  :func:`load_history` reads it back. The format is the JAX package's.
- A postmortem CLI: ``python -m dcnn_tpu_torch.obs.tsdb
  report|export|plot`` (``plot`` renders an ASCII sparkline).

Standard library only, like the rest of ``obs``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .exposition import escape_label_value

#: history.jsonl schema version (bumped on incompatible layout changes)
_SCHEMA = 1


def render_series_key(name: str, labels: Optional[Dict[str, str]] = None
                      ) -> str:
    """Canonical series key: ``name`` or ``name{k="v",...}`` with sorted
    keys and exposition-rule escaping — the same spelling a Prometheus
    exposition line would use."""
    if not labels:
        return name
    body = ",".join(f'{k}="{escape_label_value(str(v))}"'
                    for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


class _Ring:
    """Fixed-capacity ring of tuples. Preallocated; append is O(1) and
    allocation-free after the first lap."""

    __slots__ = ("cap", "_buf", "_n", "_i")

    def __init__(self, cap: int):
        self.cap = cap
        self._buf: List[Any] = [None] * cap
        self._n = 0
        self._i = 0

    def append(self, item) -> None:
        self._buf[self._i] = item
        self._i = (self._i + 1) % self.cap
        if self._n < self.cap:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    def items(self) -> List[Any]:
        """Chronological contents (oldest first)."""
        if self._n < self.cap:
            return self._buf[:self._n]
        return self._buf[self._i:] + self._buf[:self._i]


class Series:
    """One series: fine ring of ``(t, v)`` + coarse ring of
    ``(t, min, max, mean, count)`` summarizing ``downsample`` fine points
    each. NOT thread-safe on its own — the owning store's lock guards it."""

    __slots__ = ("key", "name", "labels", "fine", "coarse", "first_t",
                 "_b_t", "_b_min", "_b_max", "_b_sum", "_b_n",
                 "_downsample")

    def __init__(self, key: str, name: str, labels: Dict[str, str], *,
                 retention: int, downsample: int, coarse_retention: int):
        self.key = key
        self.name = name
        self.labels = labels
        self.fine = _Ring(retention)
        self.coarse = _Ring(coarse_retention)
        self.first_t: Optional[float] = None  # first-EVER point (survives
        self._downsample = downsample         # ring eviction)
        self._b_t = 0.0
        self._b_min = float("inf")
        self._b_max = float("-inf")
        self._b_sum = 0.0
        self._b_n = 0

    def add(self, t: float, v: float) -> None:
        if self.first_t is None:
            self.first_t = t
        self.fine.append((t, v))
        self._b_t = t
        if v < self._b_min:
            self._b_min = v
        if v > self._b_max:
            self._b_max = v
        self._b_sum += v
        self._b_n += 1
        if self._b_n >= self._downsample:
            self.coarse.append((self._b_t, self._b_min, self._b_max,
                                self._b_sum / self._b_n, self._b_n))
            self._b_min = float("inf")
            self._b_max = float("-inf")
            self._b_sum = 0.0
            self._b_n = 0


class TimeSeriesStore:
    """Thread-safe fixed-memory store of :class:`Series` ring buffers.

    ``max_series`` bounds cardinality: past it, NEW series are dropped
    (counted on :attr:`dropped_series`) rather than growing without
    bound — a labeled-series explosion must degrade history, not the
    process. All timestamps are in the injected ``clock`` domain
    (monotonic by default); ``wall_clock`` anchors persistence so a
    reader can map them back to wall time.
    """

    def __init__(self, *, retention: int = 600, downsample: int = 10,
                 coarse_retention: int = 360, max_series: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        if retention < 2 or downsample < 1 or coarse_retention < 1:
            raise ValueError(
                f"need retention >= 2, downsample >= 1, coarse_retention "
                f">= 1 (got {retention}, {downsample}, {coarse_retention})")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self.retention = retention
        self.downsample = downsample
        self.coarse_retention = coarse_retention
        self.max_series = max_series
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}   # dcnn: guarded_by=_lock
        self._dropped = 0                      # dcnn: guarded_by=_lock
        self._samples = 0                      # dcnn: guarded_by=_lock

    # -- writing -----------------------------------------------------------
    def add(self, name: str, value: float, *, t: Optional[float] = None,
            labels: Optional[Dict[str, str]] = None) -> None:
        """Record one point. ``t`` defaults to the store clock's now."""
        if t is None:
            t = self._clock()
        key = render_series_key(name, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._dropped += 1
                    return
                s = Series(key, name, dict(labels or {}),
                           retention=self.retention,
                           downsample=self.downsample,
                           coarse_retention=self.coarse_retention)
                self._series[key] = s
            s.add(t, float(value))

    def sample_registry(self, registry, *, t: Optional[float] = None
                        ) -> int:
        """One sampling pass over a registry: every Counter/Gauge becomes
        a point on its own series; every Histogram becomes ``_sum`` /
        ``_count`` points plus per-bucket **cumulative** counts
        (``name_bucket{le="..."}``, non-empty buckets only) — exactly the
        shape :meth:`quantile_over_time` consumes. Returns the number of
        points written."""
        from .registry import Counter, Gauge, Histogram

        if t is None:
            t = self._clock()
        wrote = 0
        for name, inst in registry.instruments():
            if isinstance(inst, Histogram):
                v = inst.value
                self.add(name + "_sum", v["sum"], t=t)
                self.add(name + "_count", v["count"], t=t)
                wrote += 2
                for bound, cum in inst.cumulative()[:-1]:
                    if cum:
                        self.add(name + "_bucket", cum, t=t,
                                 labels={"le": repr(bound)})
                        wrote += 1
            elif isinstance(inst, (Counter, Gauge)):
                self.add(name, float(inst.value), t=t)
                wrote += 1
        with self._lock:
            self._samples += 1
        return wrote

    def sample_exposition(self, text: str, *, t: Optional[float] = None
                          ) -> int:
        """One sampling pass over Prometheus exposition TEXT (the same
        contract an external scraper reads): scalar families become points,
        histogram families become ``_sum``/``_count`` + cumulative
        bucket points. This is how a surface whose exposition carries
        DERIVED gauges (``ServeMetrics.prometheus`` — windowed p99, shed
        fraction) gets them into history: they exist only in the text,
        never in the registry. Returns points written; malformed text
        raises ``ValueError`` (parse contract)."""
        from .exposition import parse_prometheus_text

        if t is None:
            t = self._clock()
        wrote = 0
        for name, fam in parse_prometheus_text(text).items():
            if fam.get("kind") == "histogram":
                if "sum" in fam:
                    self.add(name + "_sum", fam["sum"], t=t)
                    wrote += 1
                if "count" in fam:
                    self.add(name + "_count", fam["count"], t=t)
                    wrote += 1
                for bound, cum in fam.get("buckets", []):
                    if cum and bound != float("inf"):
                        self.add(name + "_bucket", cum, t=t,
                                 labels={"le": repr(bound)})
                        wrote += 1
            elif "value" in fam:
                self.add(name, float(fam["value"]), t=t)
                wrote += 1
        with self._lock:
            self._samples += 1
        return wrote

    # -- introspection -----------------------------------------------------
    @property
    def dropped_series(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self) -> int:
        """Total fine points currently retained (bounded by
        ``series x retention`` — the fixed-memory invariant)."""
        with self._lock:
            return sum(len(s.fine) for s in self._series.values())

    def summary(self) -> Dict[str, Any]:
        """Small JSON block for ``/snapshot``: shape, not data."""
        with self._lock:
            return {"series": len(self._series),
                    "points": sum(len(s.fine) for s in
                                  self._series.values()),
                    "samples": self._samples,
                    "dropped_series": self._dropped,
                    "retention": self.retention,
                    "downsample": self.downsample}

    # -- queries -----------------------------------------------------------
    def _get(self, key: str) -> Optional[Series]:
        return self._series.get(key)

    def range(self, key: str, window_s: Optional[float] = None, *,
              tier: str = "fine") -> List[Tuple[float, ...]]:
        """Chronological points of one series key. ``tier="fine"`` yields
        ``(t, v)``; ``tier="coarse"`` yields ``(t, min, max, mean,
        count)``. ``window_s`` keeps only points newer than ``now -
        window_s``."""
        if tier not in ("fine", "coarse"):
            raise ValueError(f"tier must be fine|coarse, got {tier!r}")
        now = self._clock()
        with self._lock:
            s = self._get(key)
            if s is None:
                return []
            pts = (s.fine if tier == "fine" else s.coarse).items()
        if window_s is not None:
            cut = now - window_s
            pts = [p for p in pts if p[0] >= cut]
        return pts

    def latest(self, key: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            s = self._get(key)
            if s is None or not len(s.fine):
                return None
            pts = s.fine.items()
        return pts[-1]

    def value_at_or_before(self, key: str, t: float,
                           default: Optional[float] = None
                           ) -> Optional[float]:
        """Newest value with timestamp <= ``t`` (cumulative series are
        step functions — between samples the value holds)."""
        with self._lock:
            s = self._get(key)
            pts = s.fine.items() if s is not None else []
        best = default
        for pt, pv in pts:
            if pt <= t:
                best = pv
            else:
                break
        return best

    def delta(self, key: str, window_s: float) -> Optional[float]:
        """last - first over the window (None with < 2 points)."""
        pts = self.range(key, window_s)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, key: str, window_s: float) -> Optional[float]:
        """Per-second increase over the window — the counter verb."""
        pts = self.range(key, window_s)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def avg_over_time(self, key: str, window_s: float) -> Optional[float]:
        pts = self.range(key, window_s)
        if not pts:
            return None
        return sum(p[1] for p in pts) / len(pts)

    def max_over_time(self, key: str, window_s: float) -> Optional[float]:
        pts = self.range(key, window_s)
        if not pts:
            return None
        return max(p[1] for p in pts)

    def min_over_time(self, key: str, window_s: float) -> Optional[float]:
        pts = self.range(key, window_s)
        if not pts:
            return None
        return min(p[1] for p in pts)

    def _window_delta(self, key: str, start: float, now: float
                      ) -> Optional[float]:
        """Increase of a cumulative series over ``[start, now]`` with one
        consistent basis for every series of a histogram family: the
        newest value at-or-before ``start`` when retained; the oldest
        retained point when eviction already ate the true basis (the
        closest available approximation — and the SAME one for count and
        buckets, so a quantile never mixes bases); exactly 0 when the
        series was born inside the window (cumulatives start at 0)."""
        with self._lock:
            s = self._get(key)
            if s is None:
                return None
            pts = s.fine.items()
            first_t = s.first_t
        if not pts:
            return None
        end_v = None
        for pt, pv in pts:
            if pt <= now:
                end_v = pv
            else:
                break
        if end_v is None:
            return None
        start_v: Optional[float] = None
        for pt, pv in pts:
            if pt <= start:
                start_v = pv
            else:
                break
        if start_v is None:
            start_v = 0.0 if (first_t is None or first_t > start) \
                else pts[0][1]
        return end_v - start_v

    def quantile_over_time(self, hist_name: str, q: float,
                           window_s: float) -> Optional[float]:
        """Histogram quantile from bucket-count **deltas** over the
        window (the ``histogram_quantile(rate(...))`` shape): linear
        interpolation inside the winning bucket, bounded above by the
        largest finite bucket bound. ``None`` when the window saw no
        observations."""
        if not 0 <= q <= 1:
            raise ValueError(f"q must be in [0, 1], got {q}")
        now = self._clock()
        start = now - window_s
        prefix = hist_name + "_bucket"
        with self._lock:
            buckets = [(float(s.labels["le"]), s.key)
                       for s in self._series.values()
                       if s.name == prefix and "le" in s.labels]
        if not buckets:
            return None
        total = self._window_delta(hist_name + "_count", start, now)
        if total is None or total <= 0:
            return None
        target = q * total
        buckets.sort()
        prev_bound = 0.0
        acc_prev = 0.0
        for bound, key in buckets:
            acc = self._window_delta(key, start, now) or 0.0
            if acc >= target:
                span = acc - acc_prev
                frac = ((target - acc_prev) / span) if span > 0 else 1.0
                return prev_bound + (bound - prev_bound) * frac
            prev_bound, acc_prev = bound, acc
        # target beyond the largest finite bucket: report its bound (the
        # observation landed in the +Inf overflow — no finite estimate)
        return buckets[-1][0]

    # -- persistence -------------------------------------------------------
    def to_jsonl_bytes(self) -> bytes:
        """The ``history.jsonl`` document: a header line with store meta
        (schema, knobs, wall anchor mapping the monotonic domain to wall
        time) then one line per series with fine + coarse points."""
        with self._lock:
            series = list(self._series.values())
            samples = self._samples
        header = {"tsdb": {
            "schema": _SCHEMA,
            "retention": self.retention,
            "downsample": self.downsample,
            "coarse_retention": self.coarse_retention,
            "samples": samples,
            # wall = t + wall_anchor for any point timestamp t
            "wall_anchor": self._wall() - self._clock(),
        }}
        lines = [json.dumps(header)]
        for s in sorted(series, key=lambda s: s.key):
            with self._lock:
                fine = [(round(t, 4), v) for t, v in s.fine.items()]
                coarse = [(round(c[0], 4),) + tuple(c[1:])
                          for c in s.coarse.items()]
            lines.append(json.dumps({
                "series": s.key, "name": s.name, "labels": s.labels,
                "points": fine, "coarse": coarse}))
        return ("\n".join(lines) + "\n").encode("utf-8")

    def persist(self, path: str) -> str:
        """Atomic JSONL dump (tmp sibling + fsync + replace — a
        preempted dump can never publish a torn history file)."""
        from ..resilience.atomic import write_file_atomic

        write_file_atomic(path, self.to_jsonl_bytes())
        return path


def load_history(path: str) -> Tuple[Dict[str, Any],
                                     Dict[str, Dict[str, Any]]]:
    """Read a ``history.jsonl`` back: ``(meta, {series_key: {"name",
    "labels", "points", "coarse"}})``. Malformed lines raise — a
    half-trusted history misleads a postmortem."""
    meta: Dict[str, Any] = {}
    series: Dict[str, Dict[str, Any]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: bad JSONL: {e}") from e
            if "tsdb" in obj:
                meta = dict(obj["tsdb"])
            elif "series" in obj:
                series[obj["series"]] = {
                    "name": obj.get("name", obj["series"]),
                    "labels": obj.get("labels", {}),
                    "points": [tuple(p) for p in obj.get("points", [])],
                    "coarse": [tuple(c) for c in obj.get("coarse", [])],
                }
            else:
                raise ValueError(f"{path}:{lineno}: neither header nor "
                                 f"series: {obj!r}")
    return meta, series


def series_stats(points: List[Tuple[float, float]]) -> Dict[str, Any]:
    """min/mean/max/last over ``(t, v)`` points — the compact block
    `report` prints."""
    if not points:
        return {"points": 0, "min": None, "mean": None, "max": None,
                "last": None}
    vals = [p[1] for p in points]
    return {"points": len(vals), "min": min(vals),
            "mean": sum(vals) / len(vals), "max": max(vals),
            "last": vals[-1]}


def summarize_history(path: str, *, top: int = 8) -> Dict[str, Any]:
    """Front-page summary of a ``history.jsonl`` (a flight bundle's):
    series/point counts, covered time span, and
    stats for the busiest series."""
    meta, series = load_history(path)
    t_lo: Optional[float] = None
    t_hi: Optional[float] = None
    total = 0
    for s in series.values():
        for t, _v in s["points"]:
            t_lo = t if t_lo is None or t < t_lo else t_lo
            t_hi = t if t_hi is None or t > t_hi else t_hi
        total += len(s["points"])
    busiest = sorted(series.items(), key=lambda kv: -len(kv[1]["points"]))
    return {
        "series": len(series),
        "points": total,
        "span_s": (round(t_hi - t_lo, 3)
                   if t_lo is not None and t_hi is not None else None),
        "samples": meta.get("samples"),
        "top": {k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                    for kk, vv in series_stats(v["points"]).items()}
                for k, v in busiest[:top]},
    }


class TsdbSampler:
    """The cadence thread: snapshot ``registry`` into ``store`` every
    ``interval_s``. Daemon + :meth:`stop`-joinable; never started =
    zero threads. ``after_sample`` callbacks run after each pass on the
    sampler thread — the rule engine's evaluation hook. ``text_fn``
    switches the pass to exposition-text sampling
    (:meth:`TimeSeriesStore.sample_exposition`) — the wiring for
    surfaces like ``ServeMetrics`` whose derived windowed gauges exist
    only in their rendered text."""

    def __init__(self, store: TimeSeriesStore, *, registry=None,
                 interval_s: float = 1.0,
                 text_fn: Optional[Callable[[], str]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tick_clock: Callable[[], float] = time.perf_counter):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.store = store
        self.text_fn = text_fn
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self.registry = registry
        self.interval_s = interval_s
        self._clock = clock
        self._tick_clock = tick_clock
        self._after: List[Callable[[TimeSeriesStore], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = self.registry.counter(
            "tsdb_samples_total", "tsdb sampling passes completed")
        self._errors = self.registry.counter(
            "tsdb_sample_errors_total", "tsdb sampling passes that raised")
        self._tick_hist = self.registry.histogram(
            "tsdb_sample_seconds", "wall per tsdb sampling pass")
        self._series_gauge = self.registry.gauge(
            "tsdb_series", "series currently retained in the tsdb")

    def add_after_sample(self, fn: Callable[[TimeSeriesStore], None]
                         ) -> "TsdbSampler":
        """Register a post-pass hook (rule evaluation). Wire before
        :meth:`start` — the list is read from the sampler thread."""
        self._after.append(fn)
        return self

    def sample_once(self) -> int:
        """One pass: snapshot the registry, refresh the sampler's own
        instruments, run the hooks. Returns points written. Exceptions
        are counted and re-raised — the thread loop swallows them so a
        broken provider cannot kill the cadence, while a by-hand test
        caller still sees the failure."""
        t0 = self._tick_clock()
        try:
            if self.text_fn is not None:
                wrote = self.store.sample_exposition(self.text_fn(),
                                                     t=self._clock())
            else:
                wrote = self.store.sample_registry(self.registry,
                                                   t=self._clock())
            for fn in self._after:
                fn(self.store)
        except Exception:
            self._errors.inc()
            raise
        finally:
            self._tick_hist.observe(self._tick_clock() - t0)
        self._samples.inc()
        self._series_gauge.set(len(self.store.series_names()))
        return wrote

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TsdbSampler":
        """Idempotent; one daemon thread paced by ``Event.wait`` (a
        :meth:`stop` wakes it immediately — no sleep to ride out)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dcnn-tsdb-sampler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                pass  # counted in sample_once; cadence must survive

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "TsdbSampler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# -------------------------------------------------------------------- CLI

_SPARK = " .:-=+*#%@"


def sparkline(values: List[float], *, width: int = 60) -> str:
    """ASCII sparkline (pure-ASCII ramp — 2 a.m. terminals over serial
    consoles included). Values are binned to ``width`` columns by mean."""
    if not values:
        return ""
    if len(values) > width:
        binned = []
        step = len(values) / width
        for i in range(width):
            lo, hi = int(i * step), max(int((i + 1) * step), int(i * step) + 1)
            chunk = values[lo:hi]
            binned.append(sum(chunk) / len(chunk))
        values = binned
    lo, hi = min(values), max(values)
    span = hi - lo
    out = []
    for v in values:
        frac = (v - lo) / span if span > 0 else 0.5
        out.append(_SPARK[min(int(frac * (len(_SPARK) - 1) + 0.5),
                              len(_SPARK) - 1)])
    return "".join(out)


def _cli_report(path: str) -> int:
    meta, series = load_history(path)
    print(f"{path}: {len(series)} series, "
          f"{sum(len(s['points']) for s in series.values())} points "
          f"(schema {meta.get('schema')}, {meta.get('samples')} samples)")
    width = max((len(k) for k in series), default=0)
    for key in sorted(series):
        st = series_stats(series[key]["points"])
        if not st["points"]:
            continue
        print(f"  {key:<{width}}  n={st['points']:<5d} "
              f"min={st['min']:<12.6g} mean={st['mean']:<12.6g} "
              f"max={st['max']:<12.6g} last={st['last']:.6g}")
    return 0


def _cli_export(path: str, out: Optional[str]) -> int:
    meta, series = load_history(path)
    doc = {"meta": meta,
           "series": {k: {"labels": v["labels"], "points": v["points"]}
                      for k, v in series.items()}}
    text = json.dumps(doc, indent=1)
    if out:
        from ..resilience.atomic import write_file_atomic
        write_file_atomic(out, text.encode("utf-8"))
        print(f"exported {len(series)} series -> {out}")
    else:
        print(text)
    return 0


def _cli_plot(path: str, series_key: str, width: int) -> int:
    _meta, series = load_history(path)
    matches = [k for k in series
               if k == series_key or series[k]["name"] == series_key]
    if not matches:
        print(f"error: series {series_key!r} not in {path}; have:",
              *sorted(series), sep="\n  ")
        return 1
    for k in sorted(matches):
        pts = series[k]["points"]
        st = series_stats(pts)
        if not st["points"]:
            continue
        print(f"{k}  [{st['min']:.6g} .. {st['max']:.6g}] "
              f"last={st['last']:.6g}")
        print(f"  |{sparkline([p[1] for p in pts], width=width)}|")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.obs.tsdb",
        description="Inspect persisted tsdb history (history.jsonl from "
                    "flight bundles).")
    sub = ap.add_subparsers(dest="cmd")
    rp = sub.add_parser("report", help="per-series min/mean/max/last table")
    rp.add_argument("history", help="history.jsonl path")
    ep = sub.add_parser("export", help="history -> one JSON document")
    ep.add_argument("history")
    ep.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    pp = sub.add_parser("plot", help="ASCII sparkline of one series")
    pp.add_argument("history")
    pp.add_argument("series", help="series key or bare metric name")
    pp.add_argument("--width", type=int, default=60)
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2
    try:
        if args.cmd == "report":
            return _cli_report(args.history)
        if args.cmd == "export":
            return _cli_export(args.history, args.out)
        return _cli_plot(args.history, args.series, args.width)
    except BrokenPipeError:
        return 0  # `... report | head` closing early is not an error
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
