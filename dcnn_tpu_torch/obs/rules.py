"""Declarative recording + alert rules over the in-process tsdb
(counterpart of ``dcnn_tpu/obs/rules.py``).

The Prometheus recording/alerting-rule model, scaled down to one
process: a :class:`RuleEngine` owns a list of rules evaluated against a
:class:`~dcnn_tpu_torch.obs.tsdb.TimeSeriesStore` on every sampling pass
(``TsdbSampler.add_after_sample(engine.evaluate)``) or by hand in tests.

- **Recording rules** precompute a query (``rate`` / ``delta`` /
  ``avg_over_time`` / ``max_over_time`` / ``quantile_over_time`` /
  ``latest``) into a NEW tsdb series each evaluation — the derived
  series dashboards and other rules read (``router_rps`` from
  ``serve_samples_submitted_total``).
- **Alert rules** (:class:`AlertRule`) come in three kinds —
  ``threshold`` (a query result compared against a bound), ``rate``
  (per-second increase compared against a bound: "errors are climbing"),
  and ``absence`` (no new sample for ``window_s``: a half-dead scrape
  target or a stalled sampler) — each with a ``for_s`` **hold window**:
  the condition must stay true that long before the alert fires, so a
  one-tick spike stays ``pending`` and ages out instead of paging.

State machine per alert (the Prometheus vocabulary)::

    inactive -> pending   condition newly true (held < for_s)
    pending  -> firing    condition held for >= for_s   [EDGE: fired]
    pending  -> inactive  condition cleared before the hold elapsed
    firing   -> inactive  condition cleared              [EDGE: resolved]

Firing edges drive the existing degradation machinery:

- ``alerts_fired_total`` / ``alerts_resolved_total`` counters and
  ``alerts_firing`` / ``alerts_pending`` gauges on the wired registry,
  plus per-rule ``alert_state{rule="..."}`` series on the shared text
  exposition via :meth:`RuleEngine.prometheus_lines` (0 inactive,
  1 pending, 2 firing);
- a :class:`~dcnn_tpu_torch.obs.flight.FlightRecorder` bundle per firing
  edge (trigger ``alert_firing``) carrying the rule, the observed value, and
  the offending series' recent window — the minutes *before* the page;
- :func:`rules_check` degrades a ``TelemetryServer``'s ``/healthz`` to
  503 while any alert is firing, with the rule named in ``reasons``.

Evaluation is injectable-clock and sleep-free like everything else in
``obs``; the engine never raises from :meth:`evaluate` hooks (a broken
rule is counted on ``alert_eval_errors_total`` and surfaced per rule).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .exposition import escape_label_value
from .tsdb import TimeSeriesStore

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: query verbs a rule may apply to its series before comparing
_FNS = ("latest", "rate", "delta", "avg_over_time", "max_over_time",
        "min_over_time", "quantile_over_time")


def _query(store: TimeSeriesStore, series: str, fn: str, window_s: float,
           q: float) -> Optional[float]:
    if fn == "latest":
        pt = store.latest(series)
        return pt[1] if pt is not None else None
    if fn == "quantile_over_time":
        return store.quantile_over_time(series, q, window_s)
    return getattr(store, fn)(series, window_s)


@dataclass
class RecordingRule:
    """``name = fn(series[window_s])`` evaluated each pass into the
    store (``quantile_over_time`` reads ``q``; ``latest`` ignores the
    window)."""

    name: str
    series: str
    fn: str = "latest"
    window_s: float = 60.0
    q: float = 0.99

    def __post_init__(self):
        if self.fn not in _FNS:
            raise ValueError(f"recording rule {self.name}: fn must be one "
                             f"of {_FNS}, got {self.fn!r}")


@dataclass
class AlertRule:
    """One declarative alert (module docstring for the state machine).

    ``kind="threshold"``: ``fn(series[window_s]) op threshold``.
    ``kind="rate"``: ``rate(series[window_s]) op threshold``.
    ``kind="absence"``: no sample for ``series`` within ``window_s``
    (``threshold``/``op``/``fn`` unused — the condition is staleness).
    """

    name: str
    series: str
    kind: str = "threshold"
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 60.0
    for_s: float = 0.0
    fn: str = "latest"
    q: float = 0.99
    severity: str = "page"
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("threshold", "rate", "absence"):
            raise ValueError(f"alert {self.name}: kind must be "
                             f"threshold|rate|absence, got {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"alert {self.name}: op must be one of "
                             f"{sorted(_OPS)}, got {self.op!r}")
        if self.fn not in _FNS:
            raise ValueError(f"alert {self.name}: fn must be one of "
                             f"{_FNS}, got {self.fn!r}")
        if self.for_s < 0 or self.window_s <= 0:
            raise ValueError(f"alert {self.name}: need for_s >= 0 and "
                             f"window_s > 0")


@dataclass
class _AlertState:
    rule: AlertRule
    state: str = "inactive"          # inactive | pending | firing
    pending_since: Optional[float] = None
    firing_since: Optional[float] = None
    value: Optional[float] = None
    last_error: Optional[str] = None
    fired_total: int = 0
    resolved_total: int = 0

    def doc(self) -> Dict[str, Any]:
        r = self.rule
        return {
            "name": r.name, "series": r.series, "kind": r.kind,
            "state": self.state, "value": self.value,
            "pending_since": self.pending_since,
            "firing_since": self.firing_since,
            "for_s": r.for_s, "window_s": r.window_s,
            "threshold": None if r.kind == "absence" else r.threshold,
            "op": None if r.kind == "absence" else r.op,
            "severity": r.severity, "description": r.description,
            "fired_total": self.fired_total,
            "resolved_total": self.resolved_total,
            "last_error": self.last_error,
        }


class RuleEngine:
    """Recording + alert rules over one store; see the module docstring.

    Wire rules before handing :meth:`evaluate` to a sampler; the engine
    lock makes wiring-after-start safe anyway. ``history_window_s``
    bounds the series window a firing bundle carries."""

    def __init__(self, store: TimeSeriesStore, *, registry=None,
                 flight=None, clock: Callable[[], float] = time.monotonic,
                 history_window_s: float = 120.0):
        self.store = store
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self._reg = registry
        self._flight = flight  # None: the process-global recorder
        self._clock = clock
        self.history_window_s = history_window_s
        self._lock = threading.Lock()
        self._recording: List[RecordingRule] = []  # dcnn: guarded_by=_lock
        self._alerts: List[_AlertState] = []       # dcnn: guarded_by=_lock
        self._fired = registry.counter(
            "alerts_fired_total", "alert pending->firing transitions")
        self._resolved = registry.counter(
            "alerts_resolved_total", "alert firing->inactive transitions")
        self._eval_errors = registry.counter(
            "alert_eval_errors_total", "rule evaluations that raised")
        self._firing_gauge = registry.gauge(
            "alerts_firing", "alert rules currently firing")
        self._pending_gauge = registry.gauge(
            "alerts_pending", "alert rules currently pending")

    # -- wiring ------------------------------------------------------------
    def add_recording(self, rule: "RecordingRule | None" = None, **kw
                      ) -> "RuleEngine":
        rule = rule if rule is not None else RecordingRule(**kw)
        with self._lock:
            self._recording.append(rule)
        return self

    def add_alert(self, rule: "AlertRule | None" = None, **kw
                  ) -> "RuleEngine":
        rule = rule if rule is not None else AlertRule(**kw)
        with self._lock:
            if any(a.rule.name == rule.name for a in self._alerts):
                raise ValueError(f"alert {rule.name!r} already registered")
            self._alerts.append(_AlertState(rule))
        return self

    # -- evaluation --------------------------------------------------------
    def evaluate(self, _store=None) -> List[Dict[str, Any]]:
        """One pass over every rule; returns the TRANSITIONS this pass
        produced (``{"rule", "from", "to", "value"}`` dicts — what tests
        and the fleet ``/alerts`` change feed assert on). Never raises:
        a broken rule records its error and stays put. The ``_store``
        parameter is ignored (it lets the bound method BE the sampler's
        ``after_sample`` hook)."""
        now = self._clock()
        with self._lock:
            recording = list(self._recording)
            alerts = list(self._alerts)
        for rr in recording:
            try:
                v = _query(self.store, rr.series, rr.fn, rr.window_s, rr.q)
            except Exception:
                self._eval_errors.inc()
                continue
            if v is not None:
                self.store.add(rr.name, v, t=now)
        transitions: List[Dict[str, Any]] = []
        fire_bundles: List[Dict[str, Any]] = []
        for st in alerts:
            try:
                cond, value = self._condition(st.rule, now)
            except Exception as e:
                self._eval_errors.inc()
                with self._lock:
                    st.last_error = f"{type(e).__name__}: {e}"
                continue
            with self._lock:
                st.last_error = None
                st.value = value
                before = st.state
                if cond:
                    if st.state == "inactive":
                        st.state = "pending"
                        st.pending_since = now
                    if st.state == "pending" \
                            and now - st.pending_since >= st.rule.for_s:
                        st.state = "firing"
                        st.firing_since = now
                        st.fired_total += 1
                else:
                    if st.state == "firing":
                        st.resolved_total += 1
                    st.state = "inactive"
                    st.pending_since = None
                    st.firing_since = None
                after = st.state
            if after != before:
                transitions.append({"rule": st.rule.name, "from": before,
                                    "to": after, "value": value, "t": now})
                if after == "firing":
                    self._fired.inc()
                    fire_bundles.append(self._fire_payload(st, value, now))
                if before == "firing":
                    self._resolved.inc()
            # the per-rule state series rides the tsdb too, so history
            # shows WHEN an alert was pending/firing next to the data
            self.store.add("alert_state", self._state_num(after), t=now,
                           labels={"rule": st.rule.name})
        with self._lock:
            firing = sum(1 for a in self._alerts if a.state == "firing")
            pending = sum(1 for a in self._alerts if a.state == "pending")
        self._firing_gauge.set(firing)
        self._pending_gauge.set(pending)
        # flight dumps OUTSIDE the lock (file I/O must not serialize
        # handler threads reading alert state); record() never raises
        for payload in fire_bundles:
            from .flight import resolve_flight_recorder
            resolve_flight_recorder(self._flight).record(
                "alert_firing", registry=self._reg, **payload)
        return transitions

    def _condition(self, rule: AlertRule, now: float):
        if rule.kind == "absence":
            pt = self.store.latest(rule.series)
            age = None if pt is None else now - pt[0]
            absent = pt is None or age > rule.window_s
            return absent, age
        if rule.kind == "rate":
            v = self.store.rate(rule.series, rule.window_s)
        else:
            v = _query(self.store, rule.series, rule.fn, rule.window_s,
                       rule.q)
        if v is None:
            return False, None  # no data is NOT a threshold breach
        return _OPS[rule.op](v, rule.threshold), v

    @staticmethod
    def _state_num(state: str) -> int:
        return {"inactive": 0, "pending": 1, "firing": 2}[state]

    def _fire_payload(self, st: _AlertState, value, now: float
                      ) -> Dict[str, Any]:
        r = st.rule
        reason = (f"alert {r.name}: {r.kind} on {r.series} "
                  + (f"(no sample for > {r.window_s:g}s)"
                     if r.kind == "absence"
                     else f"({value} {r.op} {r.threshold:g})")
                  + f" held {r.for_s:g}s")
        return {
            "reasons": [reason],
            "config": {"rule": r.name, "series": r.series, "kind": r.kind,
                       "op": r.op, "threshold": r.threshold,
                       "window_s": r.window_s, "for_s": r.for_s,
                       "severity": r.severity,
                       "description": r.description},
            "extra": {"value": value, "t": now,
                      "window": self.store.range(
                          r.series, self.history_window_s)},
        }

    # -- export ------------------------------------------------------------
    def alerts(self) -> List[Dict[str, Any]]:
        """Every alert's current state doc, firing first — the
        ``/alerts`` endpoint body."""
        with self._lock:
            docs = [a.doc() for a in self._alerts]
        order = {"firing": 0, "pending": 1, "inactive": 2}
        docs.sort(key=lambda d: (order.get(d["state"], 3), d["name"]))
        return docs

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(a.rule.name for a in self._alerts
                          if a.state == "firing")

    def prometheus_lines(self) -> List[str]:
        """Per-rule ``alert_state{rule="..."}`` exposition lines
        (0 inactive / 1 pending / 2 firing) — append to a registry
        exposition via ``metrics_text`` composition."""
        with self._lock:
            states = [(a.rule.name, self._state_num(a.state))
                      for a in self._alerts]
        lines = ["# TYPE alert_state gauge"] if states else []
        for name, num in sorted(states):
            lines.append(
                f'alert_state{{rule="{escape_label_value(name)}"}} {num}')
        return lines

    def metrics_text(self, base: Callable[[], str]) -> Callable[[], str]:
        """Wrap a ``/metrics`` body provider so the per-rule
        ``alert_state`` series ride the same exposition."""
        def _text() -> str:
            body = base()
            lines = self.prometheus_lines()
            if not lines:
                return body
            return body.rstrip("\n") + "\n" + "\n".join(lines) + "\n"
        return _text


def rules_check(engine: RuleEngine) -> Callable[[], Optional[str]]:
    """Health check for a :class:`~dcnn_tpu_torch.obs.server.TelemetryServer`:
    degraded while ANY alert rule is firing, naming every firing rule —
    the ``/healthz`` 503 an operator (or the fleet roll-up) reads."""
    def _check() -> Optional[str]:
        firing = engine.firing()
        if firing:
            return "alerts firing: " + ", ".join(firing)
        return None
    return _check


def goodput_alert_rules(*, window_s: float = 120.0, for_s: float = 180.0,
                        min_goodput: float = 0.25) -> List[AlertRule]:
    """The shipped goodput alert pack. Series come from the
    :class:`~dcnn_tpu_torch.obs.goodput.GoodputMonitor` poll (classifier 0/1
    state series) and the tsdb-sampled ``goodput_fraction`` gauge.
    ``for_s`` over the 0/1 ``min_over_time`` is exactly "feed-bound
    sustained > N windows" — a single-window blip never pages."""
    return [
        AlertRule(name="goodput_feed_bound_sustained",
                  series="goodput_bottleneck_feed_bound",
                  op=">=", threshold=1.0, fn="min_over_time",
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="classifier has held feed-bound for the "
                              "whole window — the host feed is the wall"),
        AlertRule(name="goodput_compile_bound_sustained",
                  series="goodput_bottleneck_compile_bound",
                  op=">=", threshold=1.0, fn="min_over_time",
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="sustained compile-bound windows — likely "
                              "a capture storm (check the graph sessions / "
                              "AOT cache)"),
        AlertRule(name="goodput_low_fraction",
                  series="goodput_fraction",
                  op="<", threshold=min_goodput, fn="avg_over_time",
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="average goodput below the floor — most "
                              "wall time is not compute"),
    ]


def gray_failure_alert_rules(*, window_s: float = 120.0,
                             for_s: float = 60.0,
                             max_imbalance: float = 2.0,
                             max_hedge_rate: float = 0.5) -> List[AlertRule]:
    """The shipped gray-failure (fail-slow) alert pack. Series are the
    tsdb-sampled detector surfaces: conviction/hedge counters and the
    imbalance/probation gauges. Convictions page immediately (an
    eviction already happened — the hold is on the *band* alerts, which
    watch symptoms that may self-resolve)."""
    return [
        AlertRule(name="gray_straggler_convicted",
                  series="elastic_stragglers_evicted_total",
                  kind="rate", op=">", threshold=0.0,
                  window_s=window_s, for_s=0.0, severity="page",
                  description="the elastic leader convicted and evicted a "
                              "straggler — a host is fail-slow (flight "
                              "bundle trigger straggler_convicted has the "
                              "verdict)"),
        AlertRule(name="gray_stage_imbalance_sustained",
                  series="pipeline_stage_imbalance",
                  op=">", threshold=max_imbalance, fn="min_over_time",
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="max/median pipeline stage wall has held "
                              "above the band for the whole window — a "
                              "stage is dragging the pipeline (rebalance "
                              "should fire; if it did and imbalance "
                              "persists, the host itself is sick)"),
        AlertRule(name="gray_hedge_rate_high",
                  series="serve_router_hedges_total",
                  kind="rate", op=">", threshold=max_hedge_rate,
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="hedged requests per second above the band "
                              "— tail latency is chronically bad, not a "
                              "blip (check replica probation + p99)"),
        AlertRule(name="gray_replica_probation",
                  series="serve_router_probation_replicas",
                  op=">=", threshold=1.0, fn="min_over_time",
                  window_s=window_s, for_s=for_s, severity="ticket",
                  description="at least one serving replica has sat in "
                              "slow-replica probation for the whole "
                              "window — it is not recovering on its own"),
    ]
