"""Fleet aggregation: N telemetry surfaces merged into one monitoring
plane (counterpart of ``dcnn_tpu/obs/fleet.py``).

Every trainer, replica and coordinator of the port can serve its own
``TelemetryServer``; :class:`FleetAggregator` is the tier above them, the
in-process analogue of a Prometheus server federating its targets:

- **Targets** are added by URL (:class:`HttpScraper` transport: real
  fleets), by in-process ``TelemetryServer`` (reads ``metrics_body()``
  directly: the same text, no socket), or by bare scrape callable (the
  autoscaler's replica wiring). One :meth:`poll` scrapes every target,
  parses the exposition through the same
  :func:`~dcnn_tpu_torch.obs.exposition.parse_prometheus_text` an
  external Prometheus speaks, and merges the scalars into **labeled
  fleet series** in the aggregator's own tsdb: per replica
  (``m{replica="r0"}``) plus ``m{fleet="sum"}`` / ``m{fleet="max"}``.
- **Scrape self-observability**: every target scrape is timed
  (``fleet_scrape_seconds``) and counted (``fleet_scrape_requests_total``
  / ``fleet_scrape_errors_total``), a per-target
  ``fleet_target_up{replica=...}`` series records reachability, and the
  ``fleet_targets`` / ``fleet_targets_up`` gauges make a half-dead target
  visible on the aggregator's own exposition.
- **Serving**: :meth:`serve` stands up a ``TelemetryServer`` with the
  fleet's registry and three fleet routes: ``/fleet`` (merged labeled
  series, per-target status, the slot-goodput roll-up), ``/alerts`` (the
  rule engine's state docs), and ``/healthz`` carrying a **fleet roll-up
  check** (degraded when any target is unreachable or itself 503) and,
  when rules are wired, :func:`~dcnn_tpu_torch.obs.rules.rules_check`.
- The :class:`~dcnn_tpu_torch.serve.autoscale.Autoscaler` reads its
  replica signals through an aggregator: one scrape surface for
  decisions, dashboards and alerts.

Deterministic and injectable like the rest of ``obs``: tests drive
:meth:`poll` by hand under fake clocks; :meth:`start` polls on an
``Event.wait``-paced daemon thread. Standard library only.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from .exposition import parse_prometheus_text, scalar_values
from .rules import RuleEngine, rules_check
from .server import TelemetryServer
from .tsdb import TimeSeriesStore


class HttpScraper:
    """Scrape callable over real telemetry endpoints (the production
    transport, shared with the autoscaler): ``scraper =
    HttpScraper({"r0": url, ...})``. Fetches ``<url>/metrics`` exposition
    text with a hard timeout; a fetch failure returns ``None`` (the
    target scores as signal-less — liveness verdicts stay with their
    owners)."""

    def __init__(self, urls: Dict[str, str], *, timeout_s: float = 2.0):
        self.urls = dict(urls)
        self.timeout_s = timeout_s

    def healthz(self, name: str) -> Optional[Dict[str, Any]]:
        """The parsed ``/healthz`` JSON body (any status code — a 503
        carries the machine-readable degradation reasons), or ``None``
        when unreachable."""
        url = self.urls.get(name)
        if url is None:
            return None
        try:
            with urllib.request.urlopen(f"{url}/healthz",
                                        timeout=self.timeout_s) as r:
                return json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read().decode("utf-8"))
            except Exception:
                return None
        except Exception:
            return None

    def __call__(self, name: str, replica=None) -> Optional[str]:
        url = self.urls.get(name)
        if url is None:
            return None
        try:
            with urllib.request.urlopen(f"{url}/metrics",
                                        timeout=self.timeout_s) as r:
                return r.read().decode("utf-8")
        except Exception:
            return None


class FleetAggregator:
    """Scrape-merge-serve over N telemetry targets (module docstring).

    ``store`` defaults to a fresh :class:`TimeSeriesStore` on the same
    clock; ``rules`` (a :class:`~dcnn_tpu_torch.obs.rules.RuleEngine` over that
    store) is evaluated after every poll, so fleet-level alert rules see
    each new merge immediately. The aggregator's own instruments land on
    ``registry`` (default: process-global)."""

    def __init__(self, *, store: Optional[TimeSeriesStore] = None,
                 registry=None, rules: Optional[RuleEngine] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tick_clock: Callable[[], float] = time.perf_counter,
                 timeout_s: float = 2.0):
        self._clock = clock
        self._tick = tick_clock
        self.timeout_s = timeout_s
        self.store = store if store is not None \
            else TimeSeriesStore(clock=clock)
        self.rules = rules
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self._reg = registry
        self._lock = threading.Lock()
        self._targets: Dict[str, Dict[str, Any]] = {}  # dcnn: guarded_by=_lock
        self._last: Dict[str, Dict[str, Any]] = {}     # dcnn: guarded_by=_lock
        self._polls = 0                                # dcnn: guarded_by=_lock
        self._server: Optional[TelemetryServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._scrapes = registry.counter(
            "fleet_scrape_requests_total", "fleet target scrapes attempted")
        self._scrape_errors = registry.counter(
            "fleet_scrape_errors_total",
            "fleet target scrapes that failed to fetch or parse")
        self._scrape_hist = registry.histogram(
            "fleet_scrape_seconds", "wall per fleet target scrape")
        self._targets_gauge = registry.gauge(
            "fleet_targets", "targets registered with the aggregator")
        self._up_gauge = registry.gauge(
            "fleet_targets_up", "targets whose last scrape succeeded")
        self._polls_counter = registry.counter(
            "fleet_polls_total", "fleet poll passes completed")

    # -- targets -----------------------------------------------------------
    def add_target(self, name: str, *, url: Optional[str] = None,
                   server: Optional[TelemetryServer] = None,
                   scrape: Optional[Callable[[], Optional[str]]] = None,
                   healthz: Optional[Callable[[], Optional[Dict]]] = None
                   ) -> "FleetAggregator":
        """Register one scrape target: exactly one of ``url`` (HTTP),
        ``server`` (in-process fast path), or ``scrape`` (bare text
        callable; pair with ``healthz`` to join the health roll-up)."""
        if sum(x is not None for x in (url, server, scrape)) != 1:
            raise ValueError(
                f"target {name!r}: exactly one of url/server/scrape")
        spec = {"url": url, "server": server, "scrape": scrape,
                "healthz": healthz}
        with self._lock:
            if name in self._targets:
                raise ValueError(f"target {name!r} already registered")
            self._targets[name] = spec
            self._targets_gauge.set(len(self._targets))
        return self

    def remove_target(self, name: str) -> None:
        with self._lock:
            self._targets.pop(name, None)
            self._last.pop(name, None)
            self._targets_gauge.set(len(self._targets))

    def targets(self) -> List[str]:
        with self._lock:
            return sorted(self._targets)

    # -- scraping ----------------------------------------------------------
    def _fetch(self, name: str, spec: Dict[str, Any]) -> Optional[str]:
        if spec.get("url") is not None:
            return HttpScraper({name: spec["url"]},
                               timeout_s=self.timeout_s)(name)
        if spec.get("server") is not None:
            try:
                return spec["server"].metrics_body()
            except Exception:
                return None
        try:
            return spec["scrape"]()
        except Exception:
            return None

    def _fetch_healthz(self, spec: Dict[str, Any]
                       ) -> Optional[Dict[str, Any]]:
        if spec.get("url") is not None:
            return HttpScraper({"_": spec["url"]},
                               timeout_s=self.timeout_s).healthz("_")
        if spec.get("server") is not None:
            try:
                return spec["server"].health()[1]
            except Exception:
                return None
        if spec.get("healthz") is not None:
            try:
                return spec["healthz"]()
            except Exception:
                return None
        return None  # bare scrape targets opt out of the roll-up

    def _probe(self, name: str, spec: Dict[str, Any]):
        """One target's fetch pass (worker-thread body): metrics text +
        — only when the text arrived and the target is health-capable —
        its ``/healthz`` body. A dead target costs ONE timeout, not
        two."""
        t0 = self._tick()
        text = self._fetch(name, spec)
        dur = self._tick() - t0
        health = None
        if text is not None and (spec.get("url") is not None
                                 or spec.get("server") is not None
                                 or spec.get("healthz") is not None):
            health = self._fetch_healthz(spec)
        return text, dur, health

    def poll(self, targets: Optional[Dict[str, Callable[[], Optional[str]]]]
             = None) -> Dict[str, Dict[str, Any]]:
        """One scrape-and-merge pass. ``targets`` overrides the
        registered set for this pass with ``{name: scrape_callable}`` —
        the autoscaler's dynamic replica fleet — otherwise every
        registered target is scraped. Returns per-target results::

            {name: {"values": {metric: value} | None,   # parsed scalars
                    "fetched": bool,                     # text arrived
                    "parse_error": str | None,
                    "dur_s": float}}

        Every pass also writes the merged series (per-replica +
        sum/max), per-target up/latency history, and — when a rule
        engine is wired — evaluates the rules against the fresh merge.
        Fetches run OUTSIDE the aggregator lock and CONCURRENTLY across
        targets (one dead host costs the pass one timeout, not
        targets x timeout — rule hold windows stay on cadence); parsing
        and store writes stay on the calling thread."""
        if targets is not None:
            specs: Dict[str, Dict[str, Any]] = {
                n: {"scrape": fn} for n, fn in targets.items()}
        else:
            with self._lock:
                specs = dict(self._targets)
        now = self._clock()
        store = self.store  # thread-safe under its OWN lock (obs/tsdb.py)
        probes: Dict[str, Any] = {}
        if len(specs) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(8, len(specs)),
                    thread_name_prefix="dcnn-fleet-scrape") as pool:
                futs = {n: pool.submit(self._probe, n, spec)
                        for n, spec in specs.items()}
                probes = {n: f.result() for n, f in futs.items()}
        else:
            probes = {n: self._probe(n, spec)
                      for n, spec in specs.items()}
        results: Dict[str, Dict[str, Any]] = {}
        merged: Dict[str, Dict[str, float]] = {}
        healths: Dict[str, Optional[Dict[str, Any]]] = {}
        up = 0
        for name in specs:
            text, dur, healths[name] = probes[name]
            self._scrapes.inc()
            self._scrape_hist.observe(dur)
            res: Dict[str, Any] = {"values": None, "fetched": text is not
                                   None, "parse_error": None, "dur_s": dur}
            if text is None:
                self._scrape_errors.inc()
            else:
                try:
                    vals = scalar_values(parse_prometheus_text(text))
                except ValueError as e:
                    res["parse_error"] = str(e)
                    self._scrape_errors.inc()
                else:
                    res["values"] = vals
                    up += 1
                    for m, v in vals.items():
                        store.add(m, v, t=now, labels={"replica": name})
                        merged.setdefault(m, {})[name] = v
            store.add("fleet_target_up",
                      1.0 if res["values"] is not None else 0.0,
                      t=now, labels={"replica": name})
            results[name] = res
        for m, by_replica in merged.items():
            vals = list(by_replica.values())
            store.add(m, sum(vals), t=now, labels={"fleet": "sum"})
            store.add(m, max(vals), t=now, labels={"fleet": "max"})
        self._up_gauge.set(up)
        self._polls_counter.inc()
        with self._lock:
            self._polls += 1
            if targets is not None:
                # an explicit mapping IS the fleet for this pass: a
                # replica the autoscaler scaled away must age out of
                # /fleet and the health roll-up, not 503 them forever
                for stale in set(self._last) - set(specs):
                    self._last.pop(stale, None)
            for name, res in results.items():
                body = healths.get(name)
                self._last[name] = {
                    "t": now, "up": res["values"] is not None,
                    "dur_s": res["dur_s"],
                    "parse_error": res["parse_error"],
                    "values": res["values"],
                    # health cached AT POLL TIME so the roll-up check
                    # never blocks a /healthz probe on live fetches
                    "health_status": (body.get("status")
                                      if body is not None else None),
                    "health_reasons": (list(body.get("reasons") or [])
                                       if body is not None else []),
                }
        if self.rules is not None:
            self.rules.evaluate()
        return results

    # -- endpoint bodies ---------------------------------------------------
    def fleet_doc(self) -> Dict[str, Any]:
        """The ``/fleet`` body: per-target status + the merged labeled
        series' latest values (``sum`` / ``max`` / per-replica) + store
        shape — one request answers "what is the fleet doing"."""
        with self._lock:
            last = {n: dict(v) for n, v in self._last.items()}
            polls = self._polls
        series: Dict[str, Dict[str, Any]] = {}
        for name, info in last.items():
            for m, v in (info.get("values") or {}).items():
                row = series.setdefault(m, {"replicas": {}})
                row["replicas"][name] = v
        for m, row in series.items():
            vals = list(row["replicas"].values())
            row["sum"] = sum(vals)
            row["max"] = max(vals)
        return {
            "polls": polls,
            "targets": {n: {k: v for k, v in info.items()
                            if k != "values"}
                        for n, info in last.items()},
            "series": series,
            "slot_goodput": self._slot_goodput(last),
            "tsdb": self.store.summary(),
        }

    @staticmethod
    def _slot_goodput(last: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Per-replica + fleet slot-occupancy goodput derived from the
        ``serve_slot_{occupied,idle,draining}_seconds_total`` counters
        each replica exposes (serve/metrics.py): occupied / total, the
        serving twin of the trainer's ``goodput_fraction``. Replicas not
        exposing the counters (trainers, old builds) are skipped."""
        per: Dict[str, Dict[str, Any]] = {}
        tot = {"occupied": 0.0, "idle": 0.0, "draining": 0.0}
        for name, info in last.items():
            vals = info.get("values") or {}
            secs = {s: vals.get(f"serve_slot_{s}_seconds_total")
                    for s in tot}
            if any(v is None for v in secs.values()):
                continue
            total = sum(secs.values())
            per[name] = {"seconds": secs,
                         "goodput": (secs["occupied"] / total)
                         if total > 0 else None}
            for s in tot:
                tot[s] += secs[s]
        fleet_total = sum(tot.values())
        return {"replicas": per,
                "fleet": {"seconds": tot,
                          "goodput": (tot["occupied"] / fleet_total)
                          if fleet_total > 0 else None}}

    def alerts_doc(self) -> Dict[str, Any]:
        """The ``/alerts`` body: every rule's state doc (firing first),
        or an explicit "no rules wired" shape."""
        if self.rules is None:
            return {"rules": 0, "alerts": []}
        docs = self.rules.alerts()
        return {"rules": len(docs), "alerts": docs,
                "firing": self.rules.firing()}

    def health_rollup(self) -> Optional[str]:
        """Fleet ``/healthz`` roll-up check: degraded when any target's
        last scrape failed, or any health-capable target reported itself
        unhealthy at the last poll (its own reasons quoted — one probe
        explains the whole fleet). Reads ONLY poll-time cached state, so
        a probe never blocks on live fetches to slow/dead targets.
        Healthy before the first poll: an empty aggregator is not a
        degraded one."""
        with self._lock:
            last = {n: dict(v) for n, v in self._last.items()}
        problems: List[str] = []
        for name in sorted(last):
            info = last[name]
            if not info["up"]:
                why = info.get("parse_error") or "scrape failed"
                problems.append(f"{name}: {why}")
            elif info.get("health_status") not in ("ok", None):
                reasons = ", ".join(info.get("health_reasons") or []) \
                    or "unhealthy"
                problems.append(f"{name}: {reasons}")
        if problems:
            return "; ".join(problems)
        return None

    # -- serving -----------------------------------------------------------
    def serve(self, *, host: str = "127.0.0.1", port: int = 0
              ) -> TelemetryServer:
        """Stand up THE fleet scrape surface: ``/fleet``, ``/alerts``,
        ``/metrics`` (aggregator registry + per-rule ``alert_state``
        lines), and ``/healthz`` carrying the fleet roll-up and firing
        alerts. Idempotent per aggregator; :meth:`close` stops it."""
        if self._server is not None:
            return self._server
        srv = TelemetryServer(registry=self._reg, host=host, port=port,
                              clock=self._clock)
        srv.set_identity(component="fleet")
        srv.add_route("/fleet", self.fleet_doc)
        srv.add_route("/alerts", self.alerts_doc)
        srv.add_check("fleet_targets", self.health_rollup)
        if self.rules is not None:
            srv.add_check("alerts", rules_check(self.rules))
            srv.metrics_text = self.rules.metrics_text(srv.metrics_text)
        srv.add_snapshot("tsdb", self.store.summary)
        self._server = srv.start()
        return srv

    @property
    def server(self) -> Optional[TelemetryServer]:
        return self._server

    # -- background polling ------------------------------------------------
    def start(self, interval_s: float = 2.0) -> "FleetAggregator":
        """Poll on a daemon thread every ``interval_s``; idempotent.
        Tests drive :meth:`poll` by hand instead."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s,), daemon=True,
            name="dcnn-fleet-aggregator")
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.poll()
            except Exception:
                pass  # a broken pass must not kill the cadence

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5.0)

    def close(self) -> None:
        """Stop the poll thread and the fleet server (idempotent)."""
        self.stop()
        srv = self._server
        self._server = None
        if srv is not None:
            srv.stop()

    def __enter__(self) -> "FleetAggregator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        with self._lock:
            n, polls = len(self._targets), self._polls
        return f"FleetAggregator(targets={n}, polls={polls})"
