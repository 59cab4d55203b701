"""HTTP exposition server: ``/metrics``, ``/healthz``, ``/snapshot``
(counterpart of ``dcnn_tpu/obs/server.py``).

Endpoints (all GET; anything else is 404):

- ``/metrics``: Prometheus text exposition (format 0.0.4). The body is
  ``registry.prometheus()`` unless a ``metrics_text`` callable overrides it
  (the serve wiring passes ``ServeMetrics.prometheus``, so the windowed
  percentile gauges ride along).
- ``/healthz``: JSON liveness and resilience state. 200 while every
  registered check passes, 503 the moment one fails, with a
  machine-readable body: ``{"status": "unhealthy", "reasons": [...],
  "checks": {name: {"ok": bool, "reason": ...}}}``. A check returns
  ``None``/``True`` when healthy or a reason string when degraded; one
  that raises counts as degraded. Adapters: :func:`watchdog_check`
  (``StallWatchdog``), :func:`checkpoint_check` (``CheckpointManager``'s
  failing async saves), and the duck-typed :func:`elastic_check` and
  :func:`pipeline_check`. The body also carries the registry's resilience
  flags (``train_stalled``, ``train_skipped_steps_total``, ``ckpt_*``).
- ``/snapshot``: JSON debug dump: the registry ``snapshot()``, the newest
  tracer spans (bounded by ``snapshot_events``), per-name span counts, and
  extra provider blocks the owner registered (the serve wiring adds the
  live ``ServeMetrics.snapshot()``).

Standard library only (``http.server``; ``ThreadingHTTPServer``, so a slow
scraper never blocks a health probe). Registry, tracer, clock and checks
are injectable; tests bind port 0. Handlers only read. :meth:`stop` is
idempotent.
"""

from __future__ import annotations

import json
import os
import socket as _socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from .exposition import CONTENT_TYPE
from .registry import MetricsRegistry, get_registry
from .tracer import Tracer, _json_safe, get_tracer

# registry series mirrored into the /healthz body when present — the
# resilience flags a router wants alongside the up/down verdict
_HEALTH_FLAGS = (
    "train_stalled", "train_last_progress_age_s", "train_stall_flags_total",
    "train_skipped_steps_total", "train_rollbacks_total",
    "ckpt_last_step", "ckpt_saves_total", "ckpt_restore_skipped_total",
    "elastic_generation", "elastic_world_size", "elastic_reconfiguring",
    "elastic_reconfigures_total", "elastic_peers_lost_total",
    # TCP pipeline (parallel/distributed_pipeline.py): generation + stage
    # count + the recovery counters a prober wants next to the verdict
    "pipeline_generation", "pipeline_stages", "pipeline_recovering",
    "pipeline_stages_lost_total", "pipeline_recoveries_total",
    "pipeline_stage_respawns_total", "pipeline_replayed_batches_total",
    "pipeline_batches_lost_total",
    # router tier (serve/router.py): fleet shape + the counters a prober
    # wants next to the 200/503 verdict
    "serve_router_replicas", "serve_router_replicas_routable",
    "serve_router_canary_replicas", "serve_router_version",
    "serve_router_replica_deaths_total", "serve_router_rejoins_total",
    "serve_router_rollbacks_total", "serve_router_promotions_total",
    # autoscaler (serve/autoscale.py): is the loop in breach, what fleet
    # size is it steering toward, and can it actually grow (lease/HBM
    # pins surface as reasons via autoscale_check; these flags give the
    # prober the numbers next to that verdict)
    "autoscale_breach", "autoscale_replicas_target",
    "autoscale_scale_ups_total", "autoscale_scale_downs_total",
    "autoscale_lease_blocked_total", "autoscale_hbm_blocked_total",
    "autoscale_last_scale_up_reaction_s",
    "serve_router_decommissions_total",
    "serve_router_decommission_sweeps_total",
    "lease_free_devices",
    # goodput plane (obs/goodput.py): where the wall time went and what
    # the classifier currently blames, next to the 200/503 verdict
    "goodput_fraction", "goodput_bottleneck_state",
    "goodput_unattributed_seconds",
    # gray-failure plane (resilience/slowness.py; docs/reliability.md
    # §11): fail-slow verdicts next to the fail-stop ones
    "elastic_stragglers_evicted_total", "elastic_slow_leader_total",
    "pipeline_rebalances_total", "pipeline_stage_imbalance",
    "serve_router_hedges_total", "serve_router_hedge_wins_total",
    "serve_router_probation_replicas", "feed_worker_recycled_total",
)


def watchdog_check(watchdog) -> Callable[[], Optional[str]]:
    """Health check over a :class:`~dcnn_tpu_torch.resilience.guards.StallWatchdog`:
    degraded while the loop it watches has not beaten within its timeout.
    Calls ``check()`` live, so the endpoint sees a stall the moment it is
    scraped — not at the next poll tick."""
    def _check() -> Optional[str]:
        if watchdog.check():
            return (f"stalled: no progress for > "
                    f"{watchdog.timeout_s:g}s")
        return None
    return _check


def elastic_check(controller) -> Callable[[], Optional[str]]:
    """Health check over an elastic controller (duck-typed: any object
    with ``reconfiguring``, ``generation`` and ``world``): degraded **while a reconfiguration is in
    flight** — survivors are mid-barrier / restoring a checkpoint and the
    replica is not serving useful steps, so a router or fleet scheduler
    should treat it like a draining replica, not a dead one. Healthy
    again the moment the new generation is established (the ``/healthz``
    body's ``elastic_generation`` / ``elastic_world_size`` flags say what
    it reconfigured *to*)."""
    def _check() -> Optional[str]:
        if getattr(controller, "reconfiguring", False):
            return (f"elastic reconfiguration in flight "
                    f"(generation {getattr(controller, 'generation', '?')}, "
                    f"world {getattr(controller, 'world', '?')})")
        return None
    return _check


def pipeline_check(coordinator) -> Callable[[], Optional[str]]:
    """Health check over a pipeline coordinator (duck-typed: any object
    with ``recovering``, ``generation`` and ``num_stages``): degraded **while a stage-loss recovery is in flight** — the
    coordinator is mid-sweep / restoring a commit / replaying the batch
    journal and is not making forward progress on new batches, so a fleet
    scheduler should treat the run like a draining replica, not a dead
    one. Healthy again the moment the re-shipped generation is serving
    (the body's ``pipeline_generation`` / ``pipeline_stages`` flags say
    what it recovered *to*)."""
    def _check() -> Optional[str]:
        if getattr(coordinator, "recovering", False):
            return (f"pipeline recovery in flight "
                    f"(generation {getattr(coordinator, 'generation', '?')}, "
                    f"stages {getattr(coordinator, 'num_stages', '?')})")
        return None
    return _check


def checkpoint_check(manager) -> Callable[[], Optional[str]]:
    """Health check over a
    :class:`~dcnn_tpu_torch.resilience.checkpoint.CheckpointManager`: degraded
    once an async save has failed — a run whose checkpoints are rotting
    is not preemption-safe and a router should know before it matters.

    Prefers the manager's NON-consuming, latching ``health()`` probe:
    ``check()`` is a one-shot that drops inspected futures, so a scrape
    calling it would steal the failure from the trainer's own
    per-cadence fail-fast and report healthy again on the next scrape.
    A fake without ``health()`` falls back to ``check()``."""
    def _check() -> Optional[str]:
        probe = getattr(manager, "health", None)
        try:
            exc = probe() if probe is not None else manager.check()
        except Exception as e:
            exc = e
        if exc is not None:
            return f"checkpoint save failing: {type(exc).__name__}: {exc}"
        return None
    return _check


class _Handler(BaseHTTPRequestHandler):
    # the owning TelemetryServer is attached to the server object
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, default=str).encode("utf-8"),
                   "application/json")

    def do_GET(self):  # noqa: N802 (http.server API)
        owner: "TelemetryServer" = self.server.owner  # type: ignore
        path = self.path.split("?", 1)[0]
        t0 = time.perf_counter()
        endpoint = owner._endpoint_slug(path)
        failed = False
        try:
            if path == "/metrics":
                code, raw, ctype = (200, owner.metrics_body().encode(
                    "utf-8"), CONTENT_TYPE)
            else:
                if path == "/healthz":
                    code, body = owner.health()
                elif path == "/snapshot":
                    code, body = 200, owner.snapshot()
                elif path in owner._routes:
                    code, body = owner.route_body(path)
                else:
                    code, body = 404, {"error": f"no route {path}",
                                       "routes": ["/metrics", "/healthz",
                                                  "/snapshot",
                                                  *sorted(owner._routes)]}
                raw, ctype = (json.dumps(body, default=str).encode("utf-8"),
                              "application/json")
        except Exception as e:  # a broken provider must not kill the server
            failed = True
            code, ctype = 500, "application/json"
            raw = json.dumps({"error": f"{type(e).__name__}: {e}"},
                             default=str).encode("utf-8")
        # scrape self-observability: per-endpoint request/error counters + one shared duration
        # histogram on the SAME registry this surface exposes. Accounted
        # BEFORE the bytes hit the wire: a client that has seen the
        # response must find the scrape already counted — probes and
        # tests legitimately race on exactly that edge.
        try:
            owner._observe_scrape(endpoint, time.perf_counter() - t0,
                                  failed)
        except Exception:
            pass  # self-accounting must never break a scrape
        try:
            self._send(code, raw, ctype)
        except Exception:
            pass  # peer gone mid-write: nothing useful to do


class TelemetryServer:
    """Threaded HTTP exposition server over one registry + tracer.

    ``port=0`` binds an ephemeral port (read it back from :attr:`port`
    after :meth:`start` — the test/e2e pattern); a fixed port is the
    production scrape target. ``metrics_text`` overrides the ``/metrics``
    body provider; ``extra_snapshot`` callables contribute named blocks to
    ``/snapshot``.
    """

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Callable[[], float] = time.monotonic,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics_text: Optional[Callable[[], str]] = None,
                 snapshot_events: int = 256):
        if snapshot_events < 0:
            raise ValueError(
                f"snapshot_events must be >= 0, got {snapshot_events}")
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._clock = clock
        self._host = host
        self._port = port
        self.metrics_text = (metrics_text if metrics_text is not None
                             else self.registry.prometheus)
        self._snapshot_events = snapshot_events
        self._checks: List[Tuple[str, Callable[[], Any]]] = []
        self._extra_snapshot: Dict[str, Callable[[], Any]] = {}
        self._routes: Dict[str, Callable[[], Any]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = clock()
        # trace identity for /snapshot: merged multi-process traces need
        # to attribute each shard (host, pid, rank/component/name —
        # whatever the owner sets via set_identity)
        self._identity: Dict[str, Any] = {}
        # flight recorder + healthz edge detection (attach_flight):
        # handler threads race on the 200→503 transition, so the edge
        # state is lock-guarded
        self._flight = None
        self._edge_lock = threading.Lock()
        self._last_ok = True                    # dcnn: guarded_by=_edge_lock

    # -- wiring ------------------------------------------------------------
    def add_check(self, name: str, fn: Callable[[], Any]
                  ) -> "TelemetryServer":
        """Register a health check: ``fn()`` returns ``None``/``True`` when
        healthy, a reason string when degraded; raising counts as degraded.
        Returns self for chaining."""
        self._checks.append((name, fn))
        return self

    def set_identity(self, **identity: Any) -> "TelemetryServer":
        """Name this process for merged-trace attribution: ``/snapshot``'s
        ``process`` block carries host + pid plus whatever the owner sets
        here (``component="router"``, ``rank=2``, ...). Also stamps the
        tracer's ``process_name`` (JSONL shard headers) when unset."""
        self._identity.update(identity)
        if getattr(self.tracer, "process_name", None) is None:
            name = identity.get("name") or identity.get("component")
            if name is not None:
                self.tracer.process_name = str(name)
        return self

    def attach_flight(self, recorder) -> "TelemetryServer":
        """Wire a :class:`~dcnn_tpu_torch.obs.flight.FlightRecorder` to this
        surface: the ``/healthz`` 200→503 **transition** dumps a
        ``healthz_degraded`` bundle carrying the full 503 body (reasons,
        checks, flags), and ``/snapshot`` gains a ``flight`` block
        listing retained bundles. Edge-triggered: a fleet that stays
        degraded records once per degradation episode, not per scrape."""
        self._flight = recorder
        self.add_snapshot("flight", lambda: {
            "dir": recorder.directory,
            "enabled": recorder.enabled,
            "bundles": recorder.bundles(),
        })
        return self

    def add_snapshot(self, name: str, fn: Callable[[], Any]
                     ) -> "TelemetryServer":
        """Register an extra ``/snapshot`` block (``fn()`` must return a
        JSON-representable value)."""
        self._extra_snapshot[name] = fn
        return self

    def add_route(self, path: str, fn: Callable[[], Any]
                  ) -> "TelemetryServer":
        """Register an extra GET route serving JSON: ``fn()`` returns
        either a JSON-representable body (→ 200) or a ``(status_code,
        body)`` tuple. The built-in three routes cannot be shadowed —
        their contracts are load-bearing (router/probe/scraper). Wire
        routes before :meth:`start` (the handler reads the table from
        its own threads)."""
        if not path.startswith("/"):
            raise ValueError(f"route must start with '/', got {path!r}")
        if path in ("/metrics", "/healthz", "/snapshot"):
            raise ValueError(f"route {path} is built in")
        self._routes[path] = fn
        return self

    # -- endpoint bodies (exercised directly by unit tests) ----------------
    def health(self) -> Tuple[int, Dict[str, Any]]:
        """(status_code, body) for ``/healthz``: 200 iff every check
        passes, else 503 with every failing check's machine-readable
        reason."""
        checks: Dict[str, Any] = {}
        reasons: List[str] = []
        for name, fn in self._checks:
            try:
                res = fn()
            except Exception as e:
                res = f"{type(e).__name__}: {e}"
            if res is None or res is True:
                checks[name] = {"ok": True}
            else:
                reason = res if isinstance(res, str) else repr(res)
                checks[name] = {"ok": False, "reason": reason}
                reasons.append(f"{name}: {reason}")
        snap = self.registry.snapshot()
        flags = {k: snap[k] for k in _HEALTH_FLAGS if k in snap}
        # the stall gauge doubles as a registry-only degradation signal for
        # processes that wired a watchdog to the registry but not to us
        if not any(n == "watchdog" for n, _ in self._checks):
            if flags.get("train_stalled"):
                reasons.append("train_stalled: registry flag set")
        # same contract for the elastic controller: a process that set the
        # reconfiguring flag on the registry degrades even without the
        # explicit elastic_check adapter registered
        if not any(n == "elastic" for n, _ in self._checks):
            if flags.get("elastic_reconfiguring"):
                reasons.append("elastic_reconfiguring: registry flag set")
        ok = not reasons
        body = {
            "status": "ok" if ok else "unhealthy",
            "reasons": reasons,
            "checks": checks,
            "flags": flags,
            "uptime_s": round(max(self._clock() - self._t0, 0.0), 3),
        }
        # flight recorder on the DEGRADATION EDGE: exactly one bundle per
        # 200→503 transition (concurrent scrapes race on the edge, so it
        # is claimed under the lock), carrying this very body — the 503's
        # machine-readable reasons are postmortem evidence, not just a
        # one-shot scrape response
        with self._edge_lock:
            degraded_edge = self._last_ok and not ok
            self._last_ok = ok
        if degraded_edge and self._flight is not None:
            self._flight.record("healthz_degraded", reasons=reasons,
                                health=body, registry=self.registry,
                                tracer=self.tracer)
        return (200 if ok else 503), body

    def route_body(self, path: str) -> Tuple[int, Any]:
        """(status_code, body) for a registered extra route."""
        res = self._routes[path]()
        if isinstance(res, tuple) and len(res) == 2 \
                and isinstance(res[0], int):
            return res
        return 200, res

    # -- scrape self-observability -----------------------------------------
    _KNOWN_ENDPOINTS = ("metrics", "healthz", "snapshot")

    def _endpoint_slug(self, path: str) -> str:
        """Bounded-cardinality endpoint label for a request path. ONLY
        an exactly-matched route earns its own counter — ``/healthz/``
        404s, so counting it as ``healthz`` would mask exactly the
        misconfigured-probe case the counters exist to expose; it and
        every other unmatched path land on ``other``. Route names are
        sanitized to the metric-name grammar (``/my-route`` mints
        ``scrape_requests_my_route_total``, not a ValueError that skips
        the accounting)."""
        name = path.lstrip("/")
        if not (name in self._KNOWN_ENDPOINTS and path == f"/{name}") \
                and path not in self._routes:
            return "other"
        name = "".join(c if (c.isalnum() and c.isascii()) or c == "_"
                       else "_" for c in name.replace("/", "_"))
        if not name or name[0].isdigit():
            name = f"r_{name}"
        return name

    def _observe_scrape(self, endpoint: str, dur_s: float,
                        failed: bool) -> None:
        reg = self.registry
        reg.counter("scrape_requests_total",
                    "telemetry HTTP requests served").inc()
        reg.counter(f"scrape_requests_{endpoint}_total",  # dcnn: metric=scrape_requests_*_total
                    f"telemetry requests served on /{endpoint}").inc()
        if failed:
            reg.counter("scrape_errors_total",
                        "telemetry HTTP requests that failed (500)").inc()
            reg.counter(f"scrape_errors_{endpoint}_total",  # dcnn: metric=scrape_errors_*_total
                        f"failed telemetry requests on /{endpoint}").inc()
        reg.histogram("scrape_duration_seconds",
                      "wall per telemetry HTTP request").observe(dur_s)

    def metrics_body(self) -> str:
        """The ``/metrics`` body: refreshes the tracer's saturation
        series (``trace_events_dropped_total`` + buffer occupancy
        gauges) onto the registry first, so a saturated tracer is
        visible on the scrape that would otherwise miss it."""
        try:
            self.tracer.export_gauges(self.registry)
        except Exception:
            pass  # a broken gauge refresh must not kill the scrape
        return self.metrics_text()

    def snapshot(self) -> Dict[str, Any]:
        """Body for ``/snapshot``: registry dump + newest tracer spans +
        this process's trace identity (merged traces are attributable)."""
        try:
            self.tracer.export_gauges(self.registry)
        except Exception:
            pass
        events = self.tracer.events()[-self._snapshot_events:] \
            if self._snapshot_events else []
        for ev in events:  # tracer attrs may hold arbitrary objects
            ev["args"] = {k: _json_safe(v) for k, v in ev["args"].items()}
        out: Dict[str, Any] = {
            "metrics": self.registry.snapshot(),
            "spans": events,
            "span_counts": self.tracer.span_counts(),
            "tracer_enabled": self.tracer.enabled,
            "process": {
                "host": _socket.gethostname(),
                "pid": os.getpid(),
                "name": getattr(self.tracer, "process_name", None),
                "trace_events_dropped": getattr(self.tracer, "dropped", 0),
                **self._identity,
            },
        }
        for name, fn in self._extra_snapshot.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        httpd.daemon_threads = True
        httpd.owner = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._port = httpd.server_address[1]  # resolve an ephemeral bind
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"dcnn-telemetry-{self._port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful, idempotent shutdown: stop serving, join, close."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        state = "listening" if self._httpd is not None else "stopped"
        return (f"TelemetryServer({self.url}, {state}, "
                f"checks={[n for n, _ in self._checks]})")
