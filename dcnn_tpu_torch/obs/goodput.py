"""Goodput accounting (counterpart of ``dcnn_tpu/obs/goodput.py``):
attribute every second of wall time to a bucket.

The tracer records *what happened*; this module says *where the time
went*. It consumes the span stream and attributes a window of wall time
to exclusive buckets — ``compute``, ``eval``, ``compile``, ``checkpoint``,
``recovery``, ``h2d``, ``feed_stall`` — plus the residual
``unattributed``. Overlap between spans (a feed worker packing while the
card steps, an H2D put under a step) is resolved with interval-union
math and a fixed claim priority (:data:`CLAIM_ORDER`): compute claims
first, so feed/transfer work that overlaps compute is *hidden* latency and
only the exposed remainder counts as a stall. ``goodput_fraction`` is
``compute / wall``. A span's interval is host time: a step span ends where
the loop reads its loss, so it covers the card's work.

Three layers, each usable alone:

- :func:`attribute` / :func:`summarize`: pure functions over an event
  list (``Tracer.events()`` dicts or a replayed JSONL export).
- :class:`GoodputLedger`: binds a tracer + registry and publishes the
  window as gauges (``goodput_fraction``, ``goodput_<bucket>_seconds``,
  ``goodput_h2d_gbps`` from per-put ``bytes`` attrs, ``mfu_live`` from
  ``obs/xla.py``'s :func:`~dcnn_tpu_torch.obs.xla.analytic_mfu`, a FLOP
  count per sample and the card's peak for the step's dtype
  (:func:`~dcnn_tpu_torch.obs.xla.peak_tflops`), at the measured step
  rate).
- :class:`BottleneckClassifier` + :class:`GoodputMonitor`: the rolling
  verdict (feed-bound / compute-bound / compile-bound / io-bound /
  healthy) with dwell + exit-margin hysteresis, fed into a
  :class:`~dcnn_tpu_torch.obs.tsdb.TimeSeriesStore` for the shipped
  :func:`~dcnn_tpu_torch.obs.rules.goodput_alert_rules`, plus the
  ``/goodput`` endpoint and the hook into
  :mod:`~dcnn_tpu_torch.obs.anomaly`.

:data:`SPAN_BUCKETS` is the span→bucket table, the JAX package's: every
span name the port records is a key of it (the tests check every literal
span name under ``dcnn_tpu_torch/``), so new instrumentation cannot
silently become ``unattributed``. A value of ``None`` marks a
*structural* span, a container whose children carry the time
(``train.epoch``, ``h2d.shard``, ``pipe.batch``), excluded from
attribution so the parent/child double count never happens.

Standard library only at import time, like the rest of
``dcnn_tpu_torch.obs``.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from .registry import MetricsRegistry, get_registry
from .tracer import Tracer, get_tracer

# Attribution buckets, and the order in which they claim wall time.
# Earlier buckets win overlap: compute first (overlapped feed/H2D work is
# hidden, not a stall), feed_stall last (what it keeps is by construction
# *exposed* host-feed time — the true stall).
BUCKETS: Tuple[str, ...] = ("compute", "eval", "compile", "checkpoint",
                            "recovery", "h2d", "feed_stall")
CLAIM_ORDER: Tuple[str, ...] = BUCKETS

# The span→bucket map. None = structural/container span whose time is
# carried by its children (excluded from attribution). Keys may be globs.
SPAN_BUCKETS: Dict[str, Optional[str]] = {
    # training step loop — the device doing the actual work
    "train.step": "compute",
    "train.chunk": "compute",
    "train.resident_epoch": "compute",
    "train.shard_dispatch": "compute",
    "train.eval": "eval",
    "train.epoch": None,
    # elastic data parallelism
    "elastic.step": "compute",
    "elastic.rebuild": "recovery",
    "elastic.reconfigure": "recovery",
    "elastic.restore": "recovery",
    # host-driven / compiled pipeline
    "pipe.fwd": "compute",
    "pipe.bwd": "compute",
    "pipe.commit": "compute",
    "pipe.recover": "recovery",
    "pipe.batch": None,
    "pipe.compiled.step": "compute",
    # host→device transfer plane
    "h2d.put": "h2d",
    "h2d.put_labels": "h2d",
    "h2d.gather": "feed_stall",
    "h2d.shard": None,
    # feed worker pool (replayed via record_span)
    "feed.gather": "feed_stall",
    "feed.augment": "feed_stall",
    "feed.pack": "feed_stall",
    # serving
    "serve.infer": "compute",
    "serve.dispatch": "compute",
    "serve.queue": "feed_stall",
    "serve.compile": "compile",
    "serve.warmup": "compile",
    "serve.request": None,
    "serve.shed": None,
    # continuous-batching decode (serve/decode.py)
    "decode.step": "compute",
    # checkpointing
    "checkpoint.save": "checkpoint",
    "checkpoint.restore": "checkpoint",
    "checkpoint.snapshot": "checkpoint",
    # observability's own artifacts
    "profiler.xprof": None,
    "tracer.truncated": None,
}

# Spans whose `bytes` attr feeds the live H2D bandwidth gauge.
_H2D_BYTE_SPANS = ("h2d.put", "h2d.put_labels")
# Spans that count toward the live step rate (train.chunk carries a
# `steps` attr covering its inner loop).
_STEP_SPANS = ("train.step", "elastic.step")

Interval = Tuple[float, float]


def _merge(intervals: Sequence[Interval]) -> List[Interval]:
    """Sort + coalesce — same union math as ``transfer.union_seconds``."""
    out: List[Interval] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _subtract(intervals: Sequence[Interval],
              claimed: Sequence[Interval]) -> List[Interval]:
    """``intervals - claimed``; both inputs must be merged/sorted."""
    out: List[Interval] = []
    ci = 0
    for s, e in intervals:
        while ci < len(claimed) and claimed[ci][1] <= s:
            ci += 1
        j = ci
        while s < e and j < len(claimed) and claimed[j][0] < e:
            cs, ce = claimed[j]
            if cs > s:
                out.append((s, cs))
            s = max(s, ce)
            j += 1
        if s < e:
            out.append((s, e))
    return out


def _total(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def bucket_of(name: str,
              mapping: Mapping[str, Optional[str]] = SPAN_BUCKETS
              ) -> Optional[str]:
    """Bucket for a span name, or None (structural or unknown). Exact
    match first, then glob keys."""
    if name in mapping:
        return mapping[name]
    import fnmatch
    for pat, b in mapping.items():
        if "*" in pat and fnmatch.fnmatchcase(name, pat):
            return b
    return None


def attribute(events: Sequence[Mapping[str, Any]], *,
              t0: Optional[float] = None,
              t1: Optional[float] = None) -> Dict[str, Any]:
    """Exclusive wall-time attribution over ``Tracer.events()``-shaped
    dicts. Window defaults to the span extent (min start .. max end of
    non-structural spans); spans are clipped to it. Returns the ledger
    doc: wall/bucket/unattributed seconds and ``goodput_fraction``."""
    spans: List[Tuple[float, float, str]] = []
    for ev in events:
        dur = ev.get("dur_s")
        if dur is None:
            continue
        b = bucket_of(str(ev.get("name", "")))
        if b is None:
            continue
        s = float(ev["ts_s"])
        e = s + float(dur)
        if e > s:
            spans.append((s, e, b))
    if t0 is None:
        t0 = min((s for s, _, _ in spans), default=0.0)
    if t1 is None:
        t1 = max((e for _, e, _ in spans), default=t0)
    wall = max(0.0, float(t1) - float(t0))
    buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
    claimed: List[Interval] = []
    for b in CLAIM_ORDER:
        ivs = _merge([(max(s, t0), min(e, t1))
                      for s, e, bb in spans if bb == b])
        free = _merge(_subtract(ivs, claimed))
        buckets[b] = _total(free)
        claimed = _merge(list(claimed) + free)
    attributed = _total(claimed)
    return {
        "t0_s": float(t0), "t1_s": float(t1), "wall_s": wall,
        "buckets": buckets,
        "attributed_s": attributed,
        "unattributed_s": max(0.0, wall - attributed),
        "goodput_fraction": (buckets["compute"] / wall) if wall > 0 else 0.0,
    }


# Classifier thresholds (fraction of window wall). Entry order is the
# rule order: compile dominates (a recompile storm shows up under every
# other symptom), then exposed feed (feed_stall + h2d: a put-dominated
# wall is feed-bound), then checkpoint/recovery, then a
# compute-dominated window is (boringly, correctly) compute-bound.
_STATE_FRACS: Dict[str, Tuple[str, ...]] = {
    "compile_bound": ("compile",),
    "feed_bound": ("feed_stall", "h2d"),
    "io_bound": ("checkpoint", "recovery"),
    "compute_bound": ("compute", "eval"),
}
_ENTER_FRAC: Dict[str, float] = {
    "compile_bound": 0.30,
    "feed_bound": 0.50,
    "io_bound": 0.50,
    "compute_bound": 0.70,
}
STATES: Tuple[str, ...] = ("healthy", "feed_bound", "compute_bound",
                           "compile_bound", "io_bound")
STATE_CODES: Dict[str, int] = {s: i for i, s in enumerate(STATES)}


def classify_window(doc: Mapping[str, Any], *,
                    enter: Optional[Mapping[str, float]] = None) -> str:
    """Raw (memoryless) verdict for one ledger window."""
    wall = float(doc.get("wall_s") or 0.0)
    if wall <= 0:
        return "healthy"
    buckets = doc["buckets"]
    thresholds = dict(_ENTER_FRAC)
    if enter:
        thresholds.update(enter)
    for state in ("compile_bound", "feed_bound", "io_bound",
                  "compute_bound"):
        frac = sum(buckets.get(n, 0.0) for n in _STATE_FRACS[state]) / wall
        if frac >= thresholds[state]:
            return state
    return "healthy"


def summarize(events: Sequence[Mapping[str, Any]], *,
              t0: Optional[float] = None,
              t1: Optional[float] = None) -> Dict[str, Any]:
    """:func:`attribute` + the raw classifier verdict, the one-shot form
    for a recorded timeline."""
    doc = attribute(events, t0=t0, t1=t1)
    doc["verdict"] = classify_window(doc)
    return doc


class BottleneckClassifier:
    """Rolling-window verdict with hysteresis.

    Two anti-flap mechanisms compose: a *dwell* (a new raw verdict must
    repeat for ``confirm_windows`` consecutive windows before the state
    flips) and an *exit margin* (while in a bound state, that state's
    fraction must drop ``margin`` below its entry threshold before any
    other verdict is even considered — boundary noise around the entry
    threshold cannot oscillate the state). Each observation is recorded
    into the tsdb as ``goodput_bottleneck_state`` (the
    :data:`STATE_CODES` code) plus one 0/1 series per state
    (``goodput_bottleneck_<state>``) so ``for_s``-held alert rules can
    express "feed-bound sustained > N windows".
    """

    def __init__(self, *, store: Optional[Any] = None,
                 confirm_windows: int = 2, margin: float = 0.15,
                 enter: Optional[Mapping[str, float]] = None,
                 on_change: Optional[Callable[[str, str], None]] = None):
        self._store = store
        self.confirm_windows = max(1, int(confirm_windows))
        self.margin = float(margin)
        self._enter = dict(_ENTER_FRAC)
        if enter:
            self._enter.update(enter)
        self.on_change = on_change
        self._state = "healthy"
        self._pending: Optional[str] = None
        self._streak = 0
        self._flips = 0

    @property
    def state(self) -> str:
        return self._state

    @property
    def flips(self) -> int:
        return self._flips

    def _fraction(self, doc: Mapping[str, Any], state: str) -> float:
        wall = float(doc.get("wall_s") or 0.0)
        if wall <= 0:
            return 0.0
        b = doc["buckets"]
        return sum(b.get(n, 0.0) for n in _STATE_FRACS[state]) / wall

    def observe(self, doc: Mapping[str, Any]) -> str:
        raw = classify_window(doc, enter=self._enter)
        if self._state != "healthy" and raw != self._state:
            # exit margin: stay put while still inside the hysteresis band
            if (self._fraction(doc, self._state)
                    >= self._enter[self._state] - self.margin):
                raw = self._state
        if raw == self._state:
            self._pending, self._streak = None, 0
        else:
            if raw != self._pending:
                self._pending, self._streak = raw, 0
            self._streak += 1
            if self._streak >= self.confirm_windows:
                old, self._state = self._state, raw
                self._pending, self._streak = None, 0
                self._flips += 1
                if self.on_change is not None:
                    self.on_change(old, raw)
        if self._store is not None:
            self._store.add("goodput_bottleneck_state",
                            float(STATE_CODES[self._state]))
            for s in STATES:
                if s != "healthy":
                    self._store.add(f"goodput_bottleneck_{s}",
                                    1.0 if s == self._state else 0.0)
        return self._state


class GoodputLedger:
    """Tracer-bound ledger that publishes a window as registry gauges.

    ``flops_per_sample`` / ``peak_tflops`` / ``samples_per_step`` are the
    model-cost inputs for ``mfu_live`` (a step's FLOPs a sample over the
    card's peak, :func:`~dcnn_tpu_torch.obs.xla.analytic_mfu`, at the
    step rate measured from ``train.step``/``train.chunk`` spans);
    when any is missing the gauge is simply not set — absent series, not
    a lying 0.0. Same for ``goodput_h2d_gbps`` when no put carried a
    ``bytes`` attr in the window.
    """

    def __init__(self, *, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 flops_per_sample: Optional[float] = None,
                 peak_tflops: Optional[float] = None,
                 samples_per_step: Optional[float] = None):
        self._tracer = tracer if tracer is not None else get_tracer()
        self._registry = (registry if registry is not None
                          else get_registry())
        self.flops_per_sample = flops_per_sample
        self.peak_tflops = peak_tflops
        self.samples_per_step = samples_per_step

    def set_model_costs(self, *, flops_per_sample: Optional[float] = None,
                        peak_tflops: Optional[float] = None,
                        samples_per_step: Optional[float] = None) -> None:
        if flops_per_sample is not None:
            self.flops_per_sample = float(flops_per_sample)
        if peak_tflops is not None:
            self.peak_tflops = float(peak_tflops)
        if samples_per_step is not None:
            self.samples_per_step = float(samples_per_step)

    def _now_rel(self) -> float:
        tr = self._tracer
        clock = getattr(tr, "_clock", None)
        epoch = getattr(tr, "_epoch", 0.0)
        if clock is None:  # disabled no-op tracer facade
            return 0.0
        return clock() - epoch

    def abs_to_rel(self, t_abs: float) -> float:
        """Convert a stamp from the tracer's clock domain (default
        ``time.perf_counter``) to event-relative time."""
        return float(t_abs) - getattr(self._tracer, "_epoch", 0.0)

    def snapshot(self, *, window_s: Optional[float] = None,
                 t0: Optional[float] = None, t1: Optional[float] = None,
                 t0_abs: Optional[float] = None,
                 publish: bool = False) -> Dict[str, Any]:
        """Ledger doc for a window. Precedence: explicit ``t0``/``t1``
        (event-relative) > ``t0_abs`` (clock-domain, e.g. an epoch-start
        ``perf_counter()``) > trailing ``window_s`` ending now > the
        full span extent of the buffer."""
        events = self._tracer.events()
        if t0 is None and t0_abs is not None:
            t0 = self.abs_to_rel(t0_abs)
            if t1 is None:
                t1 = self._now_rel()
        if t0 is None and window_s is not None:
            if t1 is None:
                t1 = self._now_rel()
            t0 = max(0.0, t1 - float(window_s))
        doc = attribute(events, t0=t0, t1=t1)
        doc["verdict"] = classify_window(doc)
        self._augment(doc, events)
        if publish:
            self.publish(doc)
        return doc

    def _augment(self, doc: Dict[str, Any],
                 events: Sequence[Mapping[str, Any]]) -> None:
        t0, t1 = doc["t0_s"], doc["t1_s"]
        wall = doc["wall_s"]
        h2d_bytes = 0
        h2d_iv: List[Interval] = []
        steps = 0.0
        for ev in events:
            dur = ev.get("dur_s")
            if dur is None:
                continue
            s = float(ev["ts_s"])
            e = s + float(dur)
            if e <= t0 or s >= t1:
                continue
            name = ev.get("name")
            if name in _H2D_BYTE_SPANS:
                h2d_iv.append((max(s, t0), min(e, t1)))
                try:
                    h2d_bytes += int((ev.get("args") or {})
                                     .get("bytes") or 0)
                except (TypeError, ValueError):
                    pass
            elif name in _STEP_SPANS:
                steps += 1.0
            elif name == "train.chunk":
                try:
                    steps += float((ev.get("args") or {})
                                   .get("steps") or 0.0)
                except (TypeError, ValueError):
                    pass
        put_s = _total(_merge(h2d_iv))
        doc["h2d_put_union_s"] = put_s
        doc["h2d_bytes"] = h2d_bytes
        doc["h2d_gbps"] = ((h2d_bytes / put_s) / 1e9
                           if put_s > 0 and h2d_bytes > 0 else None)
        doc["steps"] = steps
        rate = steps / wall if wall > 0 else 0.0
        doc["step_rate"] = rate
        mfu = None
        if (self.samples_per_step and self.flops_per_sample
                and self.peak_tflops and rate > 0):
            from .xla import analytic_mfu
            mfu = analytic_mfu(self.flops_per_sample,
                               rate * self.samples_per_step,
                               self.peak_tflops)
        doc["mfu_live"] = mfu

    def publish(self, doc: Mapping[str, Any]) -> None:
        reg = self._registry
        reg.gauge("goodput_fraction",
                  "fraction of window wall time the compute bucket "
                  "claimed (ledger window)").set(doc["goodput_fraction"])
        reg.gauge("goodput_wall_seconds",
                  "ledger window wall seconds").set(doc["wall_s"])
        reg.gauge("goodput_unattributed_seconds",
                  "window seconds no instrumented span accounts for"
                  ).set(doc["unattributed_s"])
        for b in BUCKETS:
            reg.gauge(f"goodput_{b}_seconds",
                      "window wall seconds attributed to this bucket"
                      ).set(doc["buckets"][b])
        if doc.get("h2d_gbps") is not None:
            reg.gauge("goodput_h2d_gbps",
                      "live H2D bandwidth over the put-span union"
                      ).set(doc["h2d_gbps"])
        if doc.get("mfu_live") is not None:
            reg.gauge("mfu_live",
                      "analytic MFU at the measured live step rate"
                      ).set(doc["mfu_live"])


class GoodputMonitor:
    """The orchestrator the trainer wires up: one :meth:`poll` per tsdb
    sampler pass publishes the trailing-window ledger, runs the
    classifier, and (via :mod:`~dcnn_tpu_torch.obs.anomaly`) turns a verdict
    flip into a bounded capture. A window that overlaps that capture is
    published but not classified (the port's departure: the capture's own
    stall must not flip the verdict). :meth:`attach` serves the whole
    thing as the ``/goodput`` endpoint."""

    def __init__(self, *, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 store: Optional[Any] = None,
                 window_s: float = 30.0,
                 ledger: Optional[GoodputLedger] = None,
                 classifier: Optional[BottleneckClassifier] = None,
                 anomaly: Optional[Any] = None,
                 **ledger_kw: Any):
        self.window_s = float(window_s)
        self.ledger = ledger if ledger is not None else GoodputLedger(
            tracer=tracer, registry=registry, **ledger_kw)
        self.anomaly = anomaly
        self.classifier = (classifier if classifier is not None
                           else BottleneckClassifier(store=store))
        user_cb = self.classifier.on_change

        def _flip(old: str, new: str) -> None:
            if user_cb is not None:
                user_cb(old, new)
            if self.anomaly is not None:
                self.anomaly.on_classification_flip(
                    old, new, ledger_doc=self._last)

        self.classifier.on_change = _flip
        self._last: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()

    def poll(self, _store: Optional[Any] = None) -> Optional[Dict[str, Any]]:
        """One window: snapshot → publish gauges → classify. Signature is
        ``TsdbSampler.add_after_sample``-compatible and it never raises —
        a ledger bug must not kill the sampling cadence."""
        try:
            with self._lock:
                doc = self.ledger.snapshot(window_s=self.window_s,
                                           publish=True)
                # a window over the anomaly monitor's own capture is not
                # classified (obs/anomaly.py): the verdict holds
                if self.anomaly is None or self.anomaly.quiet_for(
                        self.window_s):
                    state = self.classifier.observe(doc)
                else:
                    state = self.classifier.state
                doc["bottleneck"] = state
                self.ledger._registry.gauge(
                    "goodput_bottleneck_state",
                    "classifier state code (0 healthy, 1 feed, 2 compute,"
                    " 3 compile, 4 io)").set(float(STATE_CODES[state]))
                self._last = doc
                return doc
        except Exception:  # pragma: no cover - defensive
            return None

    def observe_step(self, dt_s: float) -> None:
        """Per-step hook from the training loop — feeds the anomaly
        detector's step-time EWMA band."""
        if self.anomaly is not None:
            self.anomaly.observe_step(dt_s, ledger_doc=self._last)

    def doc(self) -> Dict[str, Any]:
        """``/goodput`` body."""
        last = self._last if self._last is not None else self.poll()
        body: Dict[str, Any] = {
            "window_s": self.window_s,
            "ledger": last,
            "bottleneck": {
                "state": self.classifier.state,
                "flips": self.classifier.flips,
                "confirm_windows": self.classifier.confirm_windows,
                "margin": self.classifier.margin,
            },
        }
        if self.anomaly is not None:
            body["anomaly"] = self.anomaly.stats()
        return body

    def attach(self, server: Any) -> "GoodputMonitor":
        """Serve :meth:`doc` as ``GET /goodput`` on a TelemetryServer."""
        server.add_route("/goodput", self.doc)
        return self

    def close(self) -> None:
        if self.anomaly is not None:
            self.anomaly.close()
