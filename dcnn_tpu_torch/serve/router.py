"""Fault-tolerant multi-replica serving router (counterpart of
``dcnn_tpu/serve/router.py``).

The tier between "one engine + one batcher on one device" and heavy
traffic: a :class:`Router` fronts N replicas
(:mod:`~dcnn_tpu_torch.serve.replica` — in-process or behind TCP hosts)
and owns three guarantees the single-replica stack cannot give:

1. **SLO-aware admission.** Requests carry a priority class
   (``high`` / ``normal`` / ``low``). Admission is layered on the
   ``DynamicBatcher`` shed path: the router admits a class only while
   total outstanding rows stay under that class's share of the fleet's
   aggregate queue capacity (``high`` = 1.0 by default), so under load
   the low class saturates — and sheds — first, and the shed error is
   the same *typed backpressure* (:class:`RouterShedError`, a
   ``QueueFullError``) callers already handle. A request that clears
   admission but finds every individual replica full is shed too
   (admission is aggregate; per-replica capacity is the ground truth).
2. **No silent drops.** Every admitted request enters an accepted-ledger
   and leaves it in exactly one of two ways: its future resolves with
   the result, or with a *typed* error. A replica that dies with
   accepted-but-unanswered requests (connection close, injected crash,
   last-heard timeout — never detected by hanging) is ejected and those
   requests are **re-admitted to survivors** through the shared
   ``resilience.retry`` backoff primitive, bounded by ``max_readmits``;
   exhaustion resolves the future with the last typed error. A restarted
   replica rejoins on the next :meth:`Router.check_replicas` sweep.
3. **Health/latency-driven routing.** Dispatch picks the routable
   replica with the fewest router-tracked outstanding rows (ties: lowest
   completion-latency EWMA) — the per-replica ``/healthz`` + ``/metrics``
   contract stays the external scrape surface, while in-band
   the router reads the same verdicts via ``replica.health()``/pongs.

Versioned hot-swap / canary / rollback live in
:class:`~dcnn_tpu_torch.serve.swap.ModelVersionManager`, which drives
:meth:`Router.swap_replica` (drain → load → rejoin per replica).

Observability: every decision lands on
:class:`~dcnn_tpu_torch.serve.metrics.RouterMetrics` (``serve_router_*``
series), and :meth:`Router.start_telemetry` exposes the router's own
``/metrics`` / ``/healthz`` / ``/snapshot`` — ``/healthz`` goes 503 when
no replica is routable, when the router is draining, or when a sweep
finds the fleet degraded below ``min_routable``.

Gray failure (fail-slow): a replica
that stays alive but answers 10x slower defeats guarantees 2 and 3 — it
passes every health probe while dragging the tail. Two mitigations,
both off by default:

- **Hedged requests** (``hedge=True`` / ``DCNN_HEDGE``; "The Tail at
  Scale", Dean & Barroso): :meth:`Router.check_hedges` duplicates an
  in-flight request older than the hedge delay (``hedge_multiplier`` ×
  the fleet-wide windowed p99, floored at ``hedge_min_s``) to a second
  replica that has not seen it. First settle wins through the accepted
  ledger's exactly-once retire — the loser resolves nothing, so the
  no-silent-drop guarantee gains a no-double-resolve twin for free.
- **Slow-replica probation** (``slow_detect=True`` /
  ``DCNN_SLOW_DETECT``): per-replica completion latencies feed a
  :class:`~dcnn_tpu_torch.resilience.slowness.SlownessDetector`; a replica
  convicted as a *sustained* relative outlier is demoted to probation
  (sorts last in routing — traffic only when nothing healthier can
  take it), and auto-rejoins after ``probation_cooldown_s`` once its
  health probe passes clean, its score forgotten so fresh traffic
  re-judges it (a still-slow replica re-convicts after the dwell). A
  fleet-wide slowdown moves the median with everyone — nobody convicts.

Chaos surface: ``serve.route`` trips in :meth:`Router.submit` (armed =
routing-layer failure), ``serve.replica_infer`` in every replica
dispatch, ``serve.swap`` in the version-load path, and the
``serve.slow_replica`` delay point (``FaultPlan.slow``) stretches a
replica's engine wall.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import CancelledError, Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs import get_tracer
from ..resilience import faults as _faults
from ..resilience.retry import retry_call
from ..resilience.slowness import SlownessConfig, SlownessDetector
from ..utils.env import get_env
from .batcher import DrainingError, QueueFullError
from .metrics import PRIORITIES, RouterMetrics
from .replica import DEATH_ERRORS, ReplicaDeadError, ReplicaError

#: Default admission shares: the fraction of aggregate fleet queue
#: capacity each priority class may fill. ``high`` may use everything;
#: ``low`` sheds once the fleet is 60% committed — the SLO knob.
DEFAULT_SHARES: Dict[str, float] = {"high": 1.0, "normal": 0.85,
                                    "low": 0.6}


class RouterShedError(QueueFullError):
    """Admission rejected this request (its priority class is over its
    share, or the fleet is out of capacity). Subclasses
    ``QueueFullError`` so every existing backpressure handler — the
    open-loop generator included — treats router shed as batcher shed."""


class NoReplicasError(ReplicaError):
    """No routable replica exists (all dead/draining). Typed terminal
    failure for accepted requests that exhausted re-admission."""


class _Handle:
    """Router-side state for one replica. Every field except ``name`` and
    ``replica`` is mutated under the router's ``_lock``."""

    __slots__ = ("name", "replica", "state", "outstanding", "completed",
                 "failed", "consecutive_failures", "ewma_ms", "canary",
                 "last_seq", "auto_rejoin", "probation", "probation_since")

    def __init__(self, name: str, replica):
        self.name = name
        self.replica = replica
        self.state = "up"            # up | unroutable | draining | dead
        self.outstanding = 0         # rows dispatched, not yet settled
        self.completed = 0
        self.failed = 0
        self.consecutive_failures = 0
        self.ewma_ms: Optional[float] = None
        self.canary = False
        self.last_seq = 0            # routing round-robin stamp
        # False when ejected for failing REQUESTS while health passed
        # (failure_eject_threshold): the sweep must not flap it back in
        # on the same health probe that was lying — rejoin is explicit
        self.auto_rejoin = True
        # latency probation (gray failure): still "up" but sorts last in
        # routing until the cooldown elapses and a probe passes clean
        self.probation = False
        self.probation_since = 0.0


class _Request:
    __slots__ = ("x", "n", "priority", "future", "t_submit", "attempts",
                 "tried", "span", "hedged", "dispatched", "hedge_names",
                 "inflight")

    def __init__(self, x, n, priority, t_submit):
        self.x, self.n, self.priority = x, n, priority
        self.future: Future = Future()
        self.t_submit = t_submit
        self.attempts = 0            # re-admissions consumed
        self.tried: set = set()      # replica names tried THIS admission
        # root distributed-trace span (admit → resolve): every replica
        # hop runs under its context, so one request is ONE trace across
        # the fleet (null handle when tracing is off)
        self.span = None
        # hedging state (check_hedges), mutated under the router lock:
        self.hedged = False          # a duplicate was already launched
        self.dispatched: set = set()  # every replica ever holding this
        self.hedge_names: set = set()  # the duplicates' replicas
        self.inflight = 0            # live dispatches; >0 blocks readmit


class Router:
    """N-replica serving front-end: priority admission, least-loaded
    routing, replica-death re-admission, rejoin, hot-swap hooks.

    ``clock``/``sleep`` are injectable (the re-admission backoff and all
    latency accounting run sleep-free in tests). ``replicas`` may be an
    iterable of replica objects (named by their ``.name``) or
    ``(name, replica)`` pairs.
    """

    def __init__(self, replicas=(), *, shares: Optional[Dict[str, float]]
                 = None, max_readmits: int = 3, min_routable: int = 1,
                 failure_eject_threshold: int = 0,
                 metrics: Optional[RouterMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 name: str = "router", flight=None,
                 hedge: Optional[bool] = None,
                 hedge_multiplier: Optional[float] = None,
                 hedge_min_s: Optional[float] = None,
                 slow_detect: Optional[bool] = None,
                 slow_config: Optional[SlownessConfig] = None,
                 probation_cooldown_s: Optional[float] = None):
        self.name = name
        self.shares = dict(DEFAULT_SHARES if shares is None else shares)
        unknown = set(self.shares) - set(PRIORITIES)
        if unknown:
            raise ValueError(f"unknown priority classes {sorted(unknown)}; "
                             f"known: {PRIORITIES}")
        for p in PRIORITIES:
            self.shares.setdefault(p, 1.0)
        self.max_readmits = max_readmits
        self.min_routable = min_routable
        # >0: eject a replica after this many CONSECUTIVE failed requests
        # even while its health probe still passes (a replica that answers
        # pings but fails every request is dead for routing purposes)
        self.failure_eject_threshold = failure_eject_threshold
        self.metrics = metrics if metrics is not None else RouterMetrics(
            clock=clock)
        # gray-failure serving knobs (module docstring): None = read the
        # env so a deployed router is switchable without a code change
        self.hedge = bool(get_env("DCNN_HEDGE", False)
                          if hedge is None else hedge)
        self.hedge_multiplier = float(
            get_env("DCNN_HEDGE_MULT", 3.0)
            if hedge_multiplier is None else hedge_multiplier)
        self.hedge_min_s = float(get_env("DCNN_HEDGE_MIN_S", 0.01)
                                 if hedge_min_s is None else hedge_min_s)
        self.slow_detect = bool(get_env("DCNN_SLOW_DETECT", False)
                                if slow_detect is None else slow_detect)
        self.probation_cooldown_s = float(
            get_env("DCNN_SLOW_PROBATION_S", 5.0)
            if probation_cooldown_s is None else probation_cooldown_s)
        self.slowness = SlownessDetector(SlownessConfig.from_env(slow_config),
                                         clock=clock)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._handles: Dict[str, _Handle] = {}  # dcnn: guarded_by=_lock
        self._ledger: set = set()               # dcnn: guarded_by=_lock
        self._outstanding = 0                   # dcnn: guarded_by=_lock
        self._closing = False                   # dcnn: guarded_by=_lock
        self._seq = 0                           # dcnn: guarded_by=_lock
        self._telemetry = None
        # failure flight recorder (obs/flight.py): replica death/eviction
        # dumps a postmortem bundle. None = the process-global recorder
        # (disabled unless DCNN_FLIGHT_DIR / configure_flight enabled it).
        self._flight = flight
        for item in replicas:
            if isinstance(item, tuple):
                self.add_replica(item[1], name=item[0])
            else:
                self.add_replica(item)

    # -- fleet management --------------------------------------------------
    def add_replica(self, replica, name: Optional[str] = None) -> str:
        with self._lock:
            if name is None:
                name = getattr(replica, "name", None) \
                    or f"replica-{len(self._handles)}"
            if name in self._handles:
                raise ValueError(f"replica {name!r} already registered")
            self._handles[name] = _Handle(name, replica)
            self._update_gauges_locked()
        return name

    def remove_replica(self, name: str) -> None:
        """Administratively drop a replica (it is NOT closed — the caller
        owns its lifecycle). In-flight requests settle normally."""
        with self._lock:
            self._handles.pop(name, None)
            self._update_gauges_locked()

    def decommission(self, name: str,
                     timeout: Optional[float] = 30.0) -> Dict[str, Any]:
        """Graceful scale-down: **drain, then remove** — the path the
        autoscaler shrinks the fleet through, and the reason scale-down
        can never violate the accepted-ledger no-silent-drop guarantee.

        1. The victim goes ``draining``: admission capacity and routing
           exclude it immediately (new traffic lands on the rest of the
           fleet), but work already dispatched to it keeps running.
        2. Wait (injectable clock/sleep, like :meth:`drain`) until every
           outstanding row settles. A victim that dies mid-drain is
           swept (``kill()``) so its accepted-but-unanswered requests
           fail typed and **re-admit to survivors now** — same path as
           an ejection.
        3. On ``timeout`` the remainder is force-swept the same way —
           typed failure + re-admission, never an orphan.
        4. ``remove_replica``. Late settles are safe after removal: the
           settle callback holds the handle object and the ledger, not
           the fleet map.

        The replica object is NOT closed (the caller — typically the
        autoscaler, which built it — owns its lifecycle). Returns
        ``{"drained": rows_settled_cleanly, "swept": rows_force_failed,
        "was_dead": bool}``."""
        with self._lock:
            h = self._handles.get(name)
            if h is None:
                raise KeyError(f"no replica {name!r}")
            was_dead = h.state == "dead"
            start_outstanding = h.outstanding
            if not was_dead:
                h.state = "draining"
                self._update_gauges_locked()
        deadline = (self._clock() + timeout) if timeout is not None \
            else None
        swept = 0
        while True:
            with self._lock:
                outstanding = h.outstanding
                dead = h.state == "dead"
            if outstanding <= 0:
                break
            if dead or (deadline is not None
                        and self._clock() >= deadline):
                # died mid-drain, or out of patience: sweep the replica's
                # queue so everything it still holds fails typed and the
                # settle path re-admits it to survivors — the ledger
                # completes every accepted request either way
                if not dead:
                    self._note_dead(h, "decommission drain timed out")
                swept = outstanding
                try:
                    h.replica.kill()
                except Exception:
                    pass
                # give the sweep's synchronous settle callbacks (and a
                # TCP replica's reader-side failure path) a bounded
                # window to run down
                grace = self._clock() + 5.0
                while self._clock() < grace:
                    with self._lock:
                        if h.outstanding <= 0:
                            break
                    self._sleep(0.005)
                break
            self._sleep(0.005)
        with self._lock:
            self._handles.pop(name, None)
            self._update_gauges_locked()
        # clean == "no force-sweep happened": removing an already-settled
        # corpse (was_dead, swept 0) is not a sweep and must not trip
        # alerts on serve_router_decommission_sweeps_total
        self.metrics.record_decommission(clean=swept == 0)
        return {"drained": max(start_outstanding - swept, 0),
                "swept": swept, "was_dead": was_dead}

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._handles)

    def replicas(self) -> Dict[str, Any]:
        """Point-in-time ``{name: replica_object}`` snapshot — the
        autoscaler's scrape pass reads each replica's exposition surface
        through this (never the router's internals)."""
        with self._lock:
            return {h.name: h.replica for h in self._handles.values()}

    def _update_gauges_locked(self) -> None:
        m = self.metrics
        m.replicas.set(len(self._handles))
        routable = [h for h in self._handles.values() if h.state == "up"]
        m.replicas_routable.set(len(routable))
        m.capacity_rows.set(sum(h.replica.queue_capacity for h in routable))
        m.outstanding_rows.set(self._outstanding)
        m.canary_replicas.set(
            sum(1 for h in self._handles.values() if h.canary))
        m.probation_replicas.set(
            sum(1 for h in self._handles.values() if h.probation))

    # -- admission + dispatch ----------------------------------------------
    def submit(self, x, priority: str = "normal") -> Future:
        """Admit one request (single sample or small batch, batcher
        conventions) into its priority class. Returns a future resolving
        to the logits, or to a typed error — never silently dropped.
        Raises :class:`RouterShedError` at admission (not accepted) and
        ``DrainingError`` after :meth:`drain`/:meth:`shutdown`."""
        if priority not in self.shares:
            raise ValueError(f"unknown priority {priority!r}; "
                             f"known: {PRIORITIES}")
        _faults.trip("serve.route", priority=priority)
        x = np.asarray(x)
        with self._lock:
            if self._closing:
                raise DrainingError("router is draining or shut down")
            shp = self._input_shape_locked()
            n = 1 if (shp is not None and tuple(x.shape) == shp) \
                else (int(x.shape[0]) if x.ndim > 0 else 1)
            cap = sum(h.replica.queue_capacity
                      for h in self._handles.values() if h.state == "up")
            limit = self.shares[priority] * cap
            if cap == 0 or self._outstanding + n > limit:
                self.metrics.record_shed(priority, n)
                raise RouterShedError(
                    f"{priority}-priority request of {n} shed: outstanding "
                    f"{self._outstanding} + {n} over class limit "
                    f"{limit:g} (fleet capacity {cap})")
            req = _Request(x, n, priority, self._clock())
            self._ledger.add(req)
            self._outstanding += n
            self.metrics.outstanding_rows.set(self._outstanding)
        tracer = get_tracer()
        # ONE root span per admitted request, admit → resolve. Dispatch
        # runs under its context so the whole chain — replica submit, the
        # batcher's queue/dispatch/infer spans, the TCP infer frame's
        # _trace carrier — shares this trace_id across threads AND
        # processes. Ended exactly once, where the ledger retires.
        req.span = tracer.begin("serve.request", track="router",
                                priority=priority, n=n)
        try:
            with tracer.activate(req.span):
                self._first_dispatch(req)
        except RouterShedError:
            # aggregate admission passed but every replica's own queue
            # shed: undo acceptance — the caller sees one coherent shed,
            # counted ONLY as shed (it was never truly admitted)
            if self._retire(req):
                self.metrics.record_shed(priority, req.n)
                tracer.end(req.span, outcome="shed")
            raise
        except BaseException as e:
            # anything non-typed out of the dispatch path (a malformed
            # request the replica's own validation rejects, an injected
            # routing fault) is the CALLER's error: un-admit so the
            # ledger cannot leak the request, then propagate. The span
            # ends only when THIS path retired the request — a typed
            # resolve inside dispatch already ended it.
            if self._retire(req):
                tracer.end(req.span, outcome=type(e).__name__)
            raise
        # counted as admitted only once placement is secured (or the
        # future already failed typed — still an accepted request), so a
        # shed request never double-counts in offered traffic
        self.metrics.record_submit(priority, n)
        return req.future

    def _input_shape_locked(self):
        for h in self._handles.values():
            shp = getattr(h.replica, "input_shape", None)
            if shp is not None:
                return tuple(shp)
        return None

    def _pick(self, exclude: set) -> Optional[_Handle]:
        """Least-outstanding routable replica not in ``exclude``.
        Probation replicas sort last outright (they take traffic only
        when nothing healthier can). Remaining ties break on the
        completion-latency EWMA quantized to ~30% log buckets
        (meaningfully slower replicas get less traffic; noise-level
        differences do not starve anyone), then on
        least-recently-dispatched — so an idle fleet round-robins instead
        of pinning everything to whichever replica happens to sort
        first."""
        with self._lock:
            candidates = [h for h in self._handles.values()
                          if h.state == "up" and h.name not in exclude]
            if not candidates:
                return None

            def score(h: _Handle):
                lat = (int(math.log(h.ewma_ms) * 4.0)
                       if h.ewma_ms is not None and h.ewma_ms > 0 else 0)
                return (h.probation, h.outstanding, lat, h.last_seq)

            best = min(candidates, key=score)
            self._seq += 1
            best.last_seq = self._seq
            return best

    def _try_replica(self, req: _Request) -> None:
        """One dispatch attempt: pick, submit, register the settle
        callback. Raises the replica's typed rejection for the retry
        wrapper to classify."""
        h = self._pick(req.tried)
        if h is None:
            with self._lock:
                fleet = {n: hh.state for n, hh in self._handles.items()}
            raise NoReplicasError(
                f"no routable replica for {req.priority}-priority request "
                f"(fleet: {fleet})")
        try:
            inner = h.replica.submit(req.x)
        except DEATH_ERRORS as e:
            req.tried.add(h.name)
            self._note_dead(h, f"submit failed: {e}")
            raise ReplicaDeadError(str(e)) from e
        except (QueueFullError, DrainingError, ReplicaError):
            req.tried.add(h.name)
            raise
        with self._lock:
            h.outstanding += req.n
            req.inflight += 1
            req.dispatched.add(h.name)
        inner.add_done_callback(lambda f, h=h: self._settle(req, h, f))

    def _first_dispatch(self, req: _Request) -> None:
        """Initial placement: walk the routable replicas once, least
        loaded first. Every replica shedding ⇒ RouterShedError (the
        caller un-admits); no replica at all ⇒ the future resolves with
        NoReplicasError (the request WAS admitted against capacity that
        vanished between admission and dispatch)."""
        last: Optional[BaseException] = None
        with self._lock:
            rounds = max(len(self._handles), 1)
        for _ in range(rounds):
            try:
                self._try_replica(req)
                return
            except (QueueFullError, DrainingError, ReplicaDeadError) as e:
                last = e
            except NoReplicasError as e:
                # candidates ran out mid-walk (dead handles shrink the
                # pool below `rounds`): if every replica actually TRIED
                # shed, this is still one coherent shed, not a typed
                # admitted-then-failed — availability metrics must not
                # blame overload on replica deaths
                if isinstance(last, (QueueFullError, DrainingError)):
                    break
                self._resolve_exc(req, e)
                return
        if isinstance(last, (QueueFullError, DrainingError)):
            raise RouterShedError(f"every routable replica shed: {last}")
        self._resolve_exc(req, NoReplicasError(
            f"no replica accepted the request: {last}"))

    def _readmit(self, req: _Request, failed: str) -> None:
        """Re-admission after a replica-attributed failure: the accepted
        request MUST complete or fail typed. The replica that just failed
        it is excluded whenever another routable one exists (a request
        must not ping-pong into the same degraded replica); the attempt
        loop rides the shared resilience.retry backoff (visible as
        ``serve_router_readmit_retry_attempts_total``)."""
        with self._lock:
            attempts = min(max(2, len(self._handles) + 1), 5)
        self.metrics.record_readmit()

        def attempt() -> None:
            # fresh exclusion set each backoff attempt: a replica that
            # shed on the PREVIOUS attempt gets reconsidered after the
            # sleep (queues drain in milliseconds) — only the replica
            # that just failed this request stays excluded, and only
            # while another routable one exists
            with self._lock:
                others = any(h.state == "up" and h.name != failed
                             for h in self._handles.values())
            req.tried = {failed} if others else set()
            # re-dispatch stays inside the request's root trace (this
            # runs on whatever thread settled the failed future — the
            # submitter's context is long gone)
            with get_tracer().activate(req.span):
                self._try_replica(req)

        try:
            # NOTE: this runs on whatever thread settled the failed future
            # — usually the dying replica's dispatcher — so the backoff
            # budget is deliberately tiny (<= 4 sleeps capped at 20 ms,
            # ~80 ms worst case per request): a survivors-briefly-full
            # fleet gets a fair second chance without parking a
            # dispatcher thread for whole backoff windows. Exhaustion is
            # a typed failure, counted, never a silent drop.
            retry_call(attempt,
                       attempts=attempts,
                       base=0.002, cap=0.02, timeout=0.25,
                       retry_on=(QueueFullError, DrainingError,
                                 ReplicaError),
                       retry_if=lambda e: not isinstance(
                           e, NoReplicasError),
                       sleep=self._sleep, clock=self._clock,
                       registry=self.metrics.registry,
                       name="serve_router_readmit")
        except NoReplicasError as e:
            self._resolve_exc(req, e)
        except (QueueFullError, DrainingError, ReplicaError) as e:
            self._resolve_exc(req, ReplicaDeadError(
                f"re-admission exhausted after replica death: {e}"))
        except BaseException as e:
            # the request is already accepted: whatever went wrong, its
            # future must resolve typed (never a silent ledger leak)
            self._resolve_exc(req, ReplicaError(
                f"re-admission failed: {type(e).__name__}: {e}"))

    # -- settlement --------------------------------------------------------
    def _settle(self, req: _Request, h: _Handle, inner: Future) -> None:
        exc: Optional[BaseException]
        if inner.cancelled():
            exc = CancelledError("replica-level future cancelled")
        else:
            exc = inner.exception()
        with self._lock:
            h.outstanding = max(h.outstanding - req.n, 0)
            req.inflight = max(req.inflight - 1, 0)
        if exc is None:
            t_done = self._clock()
            lat_ms = (t_done - req.t_submit) * 1e3
            with self._lock:
                h.completed += 1
                h.consecutive_failures = 0
                h.ewma_ms = (lat_ms if h.ewma_ms is None
                             else 0.8 * h.ewma_ms + 0.2 * lat_ms)
            if self.slow_detect:
                # probation signal: admit-to-complete wall attributed to
                # the replica that served it (the losing half of a hedged
                # pair lands here too — correctly, with its big latency)
                self.slowness.observe(h.name, lat_ms)
            won = self._resolve_ok(req, inner.result(),
                                   latency_s=t_done - req.t_submit)
            if won and h.name in req.hedge_names:
                self.metrics.record_hedge_win()
            return
        # replica-attributed failure: count it, maybe eject, re-admit
        self.metrics.record_replica_error()
        dead = isinstance(exc, DEATH_ERRORS)
        with self._lock:
            h.failed += 1
            h.consecutive_failures += 1
            over = (self.failure_eject_threshold > 0
                    and h.consecutive_failures
                    >= self.failure_eject_threshold)
            closing = self._closing
        if dead:
            self._note_dead(h, f"request failed: {type(exc).__name__}: "
                               f"{exc}")
        elif over:
            with self._lock:
                h.auto_rejoin = False  # its health probe still passes —
                # only an explicit rejoin() may re-admit it
            self._note_dead(h, f"{h.consecutive_failures} consecutive "
                               f"request failures")
        if req.future.done():
            # resolved while in flight — a drain timeout (already
            # retired) or a caller cancel (not): retire here so a
            # cancelled-then-failed request cannot leak the ledger
            if self._retire(req):
                get_tracer().end(req.span, outcome="cancelled")
            return
        with self._lock:
            still_inflight = req.inflight > 0
        if still_inflight:
            # a hedge (or, if the hedge just failed, the primary) still
            # holds a live dispatch for this request — it owns settlement
            # now; re-admitting here would triple-dispatch the request
            return
        if closing or req.attempts >= self.max_readmits:
            self._resolve_exc(req, exc if isinstance(exc, ReplicaError)
                              else ReplicaDeadError(
                                  f"replica {h.name} failed the request "
                                  f"({type(exc).__name__}: {exc}) and "
                                  f"re-admission is exhausted"))
            return
        req.attempts += 1
        self._readmit(req, failed=h.name)

    def _retire(self, req: _Request) -> bool:
        """Remove ``req`` from the ledger exactly once. False when someone
        (a drain timeout racing a late settle) already did — the loser
        must not decrement outstanding a second time."""
        with self._lock:
            if req not in self._ledger:
                return False
            self._ledger.discard(req)
            self._outstanding -= req.n
            self.metrics.outstanding_rows.set(self._outstanding)
            return True

    def _resolve_ok(self, req: _Request, result,
                    latency_s: float) -> bool:
        """True iff THIS call retired the request — the hedging dedupe:
        the first settle of a hedged pair wins the ledger, the loser
        resolves nothing (and must not count a hedge win)."""
        if not self._retire(req):
            return False
        get_tracer().end(req.span, outcome="ok",
                         latency_ms=round(latency_s * 1e3, 3))
        try:
            req.future.set_result(result)
            self.metrics.record_done(req.priority, latency_s, req.n)
        except InvalidStateError:
            pass  # cancelled by the caller while in flight
        return True

    def _resolve_exc(self, req: _Request, exc: BaseException) -> None:
        if not self._retire(req):
            return
        get_tracer().end(req.span, outcome=type(exc).__name__)
        try:
            req.future.set_exception(exc)
            self.metrics.record_failed(req.priority, req.n)
        except InvalidStateError:
            pass

    # -- liveness ----------------------------------------------------------
    def _flight_recorder(self):
        from ..obs.flight import resolve_flight_recorder
        return resolve_flight_recorder(self._flight)

    def _note_dead(self, h: _Handle, reason: str) -> None:
        with self._lock:
            if h.state == "dead":
                return
            h.state = "dead"
            h.probation = False  # death supersedes latency probation
            self._update_gauges_locked()
        # a corpse's latency score must not keep shifting the fleet median
        self.slowness.forget(h.name)
        self.metrics.record_replica_death()
        # postmortem evidence AT the death edge (once per ejection — the
        # guard above makes this edge-triggered): recent spans hold the
        # victim's last requests, the registry snapshot the fleet state.
        # record() never raises and is a no-op while the recorder is off.
        self._flight_recorder().record(
            "replica_death",
            reasons=[f"replica {h.name}: {reason}"],
            registry=self.metrics.registry,
            extra={"replica": h.name, "router": self.name,
                   "fleet": self.replica_stats()})

    # -- gray failure: hedging + probation (module docstring) -----------
    def _hedge_delay_s(self) -> Optional[float]:
        """p99-derived hedge trigger: ``hedge_multiplier`` × the exact
        fleet-wide windowed p99, floored at ``hedge_min_s``; ``None``
        (no hedging) until enough completions exist to make the p99
        meaningful."""
        p99 = self.metrics.p99_ms()
        if p99 is None:
            return None
        return max(self.hedge_min_s, self.hedge_multiplier * p99 / 1e3)

    def check_hedges(self) -> int:
        """Tail-latency hedging sweep ("The Tail at Scale"): every
        accepted request with exactly one live dispatch older than the
        hedge delay gets a duplicate on a replica that has not seen it.
        First settle wins through the ledger's exactly-once retire; the
        loser resolves nothing. Runs from :meth:`check_replicas` (and by
        hand in tests/tight loops). Returns hedges launched."""
        if not self.hedge:
            return 0
        delay = self._hedge_delay_s()
        if delay is None:
            return 0
        now = self._clock()
        with self._lock:
            due = [req for req in self._ledger
                   if not req.hedged and req.inflight == 1
                   and now - req.t_submit >= delay
                   and not req.future.done()]
            for req in due:
                req.hedged = True  # claimed under the lock: a racing
                #                    sweep cannot double-hedge
        launched = 0
        for req in due:
            if self._hedge_one(req):
                launched += 1
        return launched

    def _hedge_one(self, req: _Request) -> bool:
        """Dispatch the duplicate. Mirrors ``_try_replica`` but never
        escalates: a hedge that cannot place (no untried routable
        replica, or its submit sheds) is simply dropped — the primary
        still owns the request, and hedging is strictly opportunistic
        extra load, never extra failure."""
        with self._lock:
            exclude = set(req.dispatched)
        h = self._pick(exclude)
        if h is None:
            return False
        try:
            with get_tracer().activate(req.span):
                inner = h.replica.submit(req.x)
        except DEATH_ERRORS as e:
            self._note_dead(h, f"hedge submit failed: {e}")
            return False
        except Exception:
            return False
        with self._lock:
            h.outstanding += req.n
            req.inflight += 1
            req.dispatched.add(h.name)
            req.hedge_names.add(h.name)
        self.metrics.record_hedge()
        inner.add_done_callback(lambda f, h=h: self._settle(req, h, f))
        return True

    def check_probation(self) -> List[str]:
        """Slow-replica probation sweep: steps the latency slowness
        detector; a replica convicted as a *sustained* relative outlier
        (probation → convict with dwell) is
        demoted — still "up", but it sorts last in routing. Release
        needs the cooldown to elapse AND a clean health probe (the
        eject/rejoin plumbing's probe); the released replica's score is
        forgotten so fresh traffic re-judges it from scratch — a
        still-slow replica re-convicts after the dwell. Returns the
        names currently held in probation."""
        if not self.slow_detect:
            return []
        now = self._clock()
        for tr in self.slowness.evaluate():
            if tr["to"] != "convicted":
                continue
            with self._lock:
                h = self._handles.get(str(tr["component"]))
                if h is None or h.probation:
                    continue
                h.probation = True
                h.probation_since = now
                self._update_gauges_locked()
            self.metrics.record_probation()
            self._flight_recorder().record(
                "replica_probation",
                reasons=[f"replica {tr['component']} latency EWMA "
                         f"{tr['ewma']:.2f}ms vs fleet median "
                         f"{tr['median']:.2f}ms — sustained outlier"],
                config={"cooldown_s": self.probation_cooldown_s},
                registry=self.metrics.registry,
                extra={"router": self.name,
                       "slowness": self.slowness.snapshot(),
                       "fleet": self.replica_stats()})
        with self._lock:
            held = [h for h in self._handles.values() if h.probation]
        still: List[str] = []
        for h in held:
            release = now - h.probation_since >= self.probation_cooldown_s
            if release:
                try:
                    release = (h.replica.health() is None
                               and not h.replica.is_dead())
                except Exception:
                    release = False
            if release:
                with self._lock:
                    h.probation = False
                    self._update_gauges_locked()
                self.slowness.forget(h.name)
                self.metrics.record_probation_rejoin()
            else:
                still.append(h.name)
        return still

    def check_replicas(self) -> Dict[str, Any]:
        """One liveness sweep — the router's heartbeat, called by the
        telemetry health check, the version manager's poll, or a test by
        hand (sleep-free):

        - ping every replica (refreshes TCP last-heard windows);
        - a replica whose ``health()``/``is_dead()`` says dead is ejected
          (``kill()`` sweeps its queue so accepted requests fail typed
          and re-admit NOW, not at some timeout);
        - an ejected replica that reports alive again (restarted process,
          re-established channel) **rejoins**;
        - returns the per-replica verdict map."""
        with self._lock:
            handles = list(self._handles.values())
        report: Dict[str, Any] = {}
        for h in handles:
            r = h.replica
            try:
                r.ping()
            except Exception:
                pass  # ping failures surface via health() below
            try:
                reason = r.health()
                hard_dead = r.is_dead()
            except Exception as e:
                reason, hard_dead = f"health probe failed: {e}", True
            with self._lock:
                state, auto = h.state, h.auto_rejoin
            if state == "draining":
                # mid-decommission: never flapped back to "up" by a
                # passing probe (the decommission owns the state from
                # here), but a death mid-drain is ejected NOW so its
                # accepted work re-admits instead of waiting out the
                # drain timeout
                if hard_dead:
                    self._note_dead(h, reason or "died while draining")
                    try:
                        r.kill()
                    except Exception:
                        pass
                    report[h.name] = f"ejected mid-drain ({reason})"
                else:
                    report[h.name] = "draining (decommission in progress)"
                continue
            if state == "dead":
                if not hard_dead and reason is None and auto:
                    with self._lock:
                        h.state = "up"
                        h.consecutive_failures = 0
                        self._update_gauges_locked()
                    self.metrics.record_rejoin()
                    report[h.name] = "rejoined"
                elif not auto:
                    report[h.name] = "dead (ejected for request " \
                                     "failures; explicit rejoin() required)"
                else:
                    report[h.name] = f"dead ({reason})"
                continue
            if hard_dead:
                self._note_dead(h, reason or "reported dead")
                try:
                    r.kill()  # sweep its queue: typed failures re-admit
                except Exception:
                    pass
                report[h.name] = f"ejected ({reason})"
            elif reason is not None:
                with self._lock:
                    h.state = "unroutable"
                    self._update_gauges_locked()
                report[h.name] = f"unroutable ({reason})"
            else:
                with self._lock:
                    if h.state == "unroutable":
                        h.state = "up"
                        self._update_gauges_locked()
                report[h.name] = "up"
        # the gray-failure sweeps ride the same heartbeat: probation
        # verdicts step first (so a convicted replica stops catching
        # hedges), then overdue tail requests hedge out
        for name in self.check_probation():
            report[name] = f"{report.get(name, 'up')} (probation)"
        self.check_hedges()
        return report

    def rejoin(self, name: str) -> None:
        """Explicitly re-admit a replica ejected by
        ``failure_eject_threshold`` (the sweep never auto-rejoins those —
        its health probe was passing while requests failed, so only an
        operator/controller decision brings it back)."""
        with self._lock:
            h = self._handles.get(name)
            if h is None:
                raise KeyError(f"no replica {name!r}")
            h.auto_rejoin = True
            h.consecutive_failures = 0
            if h.state == "dead" and not h.replica.is_dead():
                h.state = "up"
                self._update_gauges_locked()
                rejoined = True
            else:
                rejoined = False
        if rejoined:
            self.metrics.record_rejoin()

    # -- hot-swap hook (driven by swap.ModelVersionManager) ---------------
    def swap_replica(self, name: str, version, *,
                     canary: bool = False) -> None:
        """Drain → load ``version`` → rejoin for one replica. The replica
        is unroutable for the duration (new traffic fails over); a load
        failure rejoins it on the old version and re-raises
        :class:`~dcnn_tpu_torch.serve.replica.SwapError`."""
        with self._lock:
            h = self._handles.get(name)
            if h is None:
                raise KeyError(f"no replica {name!r}")
            if h.state == "dead":
                raise ReplicaDeadError(f"replica {name!r} is dead")
            if h.state == "draining":
                raise ReplicaError(
                    f"replica {name!r} is being decommissioned; it cannot "
                    f"take a version swap")
            h.state = "unroutable"
            self._update_gauges_locked()
        try:
            h.replica.swap(version)
        except Exception:
            self.metrics.record_swap(ok=False)
            if h.replica.is_dead():
                # through _note_dead so the death is COUNTED — a replica
                # lost mid-swap must show on serve_router_replica_deaths
                self._note_dead(h, "died during version swap")
            else:
                with self._lock:
                    if h.state == "unroutable":
                        h.state = "up"  # rejoined on the old version
                    self._update_gauges_locked()
            raise
        with self._lock:
            # only an undisturbed swap rejoins: a concurrent decommission
            # (state "draining") or death sweep (state "dead") that landed
            # mid-load owns the handle now — resurrecting it to "up" would
            # route new traffic at a replica being drained or killed
            if h.state == "unroutable":
                h.state = "up"
                h.canary = canary
                h.consecutive_failures = 0
            self._update_gauges_locked()
        self.metrics.record_swap(ok=True)

    def set_canary(self, name: str, canary: bool) -> None:
        with self._lock:
            h = self._handles.get(name)
            if h is not None:
                h.canary = canary
                self._update_gauges_locked()

    def replica_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-replica router-side accounting — the feed the version
        manager judges canaries on."""
        with self._lock:
            return {h.name: {
                "state": h.state,
                "canary": h.canary,
                "version": h.replica.version,
                "outstanding": h.outstanding,
                "completed": h.completed,
                "failed": h.failed,
                "consecutive_failures": h.consecutive_failures,
                "ewma_ms": h.ewma_ms,
                "probation": h.probation,
            } for h in self._handles.values()}

    # -- health / telemetry ------------------------------------------------
    def health_reason(self) -> Optional[str]:
        """``None`` while the router can serve: not draining, and at
        least ``min_routable`` replicas routable."""
        with self._lock:
            if self._closing:
                return "draining or shut down: not accepting requests"
            routable = sum(1 for h in self._handles.values()
                           if h.state == "up")
        if routable < self.min_routable:
            return (f"degraded: {routable} routable replica(s), "
                    f"need >= {self.min_routable}")
        return None

    def outstanding(self) -> int:
        """Accepted-but-unresolved rows — the ledger sweep tests assert
        this returns to 0 (nothing silently dropped)."""
        with self._lock:
            return self._outstanding

    def start_telemetry(self, port: int = 0, host: str = "127.0.0.1"):
        """The router's own scrape surface: ``/metrics`` =
        ``RouterMetrics.prometheus()``, ``/healthz`` runs a live
        :meth:`check_replicas` sweep then applies :meth:`health_reason`
        (a scrape sees a dead replica the moment it is scraped, not at
        the next sweep), ``/snapshot`` adds per-replica stats."""
        from ..obs.server import TelemetryServer

        if self._telemetry is not None:
            self._telemetry.stop()
            self._telemetry = None

        def _check() -> Optional[str]:
            self.check_replicas()
            return self.health_reason()

        srv = TelemetryServer(registry=self.metrics.registry,
                              metrics_text=self.metrics.prometheus,
                              host=host, port=port)
        srv.set_identity(component="router", name=self.name)
        srv.attach_flight(self._flight_recorder())
        srv.add_check("router", _check)
        srv.add_snapshot("router", self.metrics.snapshot)
        srv.add_snapshot("replicas", self.replica_stats)
        self._telemetry = srv.start()
        return srv

    # -- teardown ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop intake; wait for the accepted ledger to empty (replicas
        keep dispatching their queues). On timeout the remaining ledger
        is failed typed — never orphaned — and ``TimeoutError`` raises."""
        with self._lock:
            self._closing = True
        deadline = (self._clock() + timeout) if timeout is not None else None
        while True:
            with self._lock:
                if not self._ledger:
                    return
            if deadline is not None and self._clock() >= deadline:
                break
            self._sleep(0.005)
        with self._lock:
            pending = list(self._ledger)
        exc = DrainingError(f"router drain timed out after {timeout}s")
        for req in pending:
            self._resolve_exc(req, exc)
        raise TimeoutError(
            f"router drain did not finish in {timeout}s "
            f"({len(pending)} accepted request(s) failed typed)")

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """``drain=True`` completes the ledger first. Replicas are NOT
        closed (the caller owns them) but the telemetry port is always
        released."""
        try:
            if drain:
                self.drain(timeout)
            else:
                with self._lock:
                    self._closing = True
                    pending = list(self._ledger)
                exc = DrainingError("router shut down without drain")
                for req in pending:
                    self._resolve_exc(req, exc)
        finally:
            if self._telemetry is not None:
                self._telemetry.stop()
                self._telemetry = None

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def __repr__(self) -> str:
        with self._lock:
            states = {h.name: h.state for h in self._handles.values()}
        return f"Router({self.name!r}, replicas={states})"
