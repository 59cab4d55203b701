"""Telemetry-driven autoscaler (counterpart of
``dcnn_tpu/serve/autoscale.py``): the control loop over the router's
live admit, eject and rejoin, the engine factory's spin-up and the
elastic trainer's reshape.

- **Signals come off the scrape surface, not private objects.** Each
  tick reads every replica's Prometheus exposition text (in process via
  ``replica.metrics.prometheus()``, or over HTTP via
  :class:`~dcnn_tpu_torch.obs.fleet.HttpScraper`) through the shared
  :class:`~dcnn_tpu_torch.obs.fleet.FleetAggregator`: the autoscaler's
  only contract with a replica is the text an external Prometheus reads
  (queue depth, windowed p99, shed fraction, and the HBM watermark
  gauges where a scrape carries them), and the aggregator keeps the
  per-replica and sum/max history in its tsdb. Router-level shed/offered
  counters are read as per-tick deltas, so the breach verdict tracks
  current traffic, not history.
- **Deterministic, with an injectable clock.** :meth:`Autoscaler.tick`
  is one decision turn; tests drive the whole diurnal soak sleep-free
  under a fake clock. :meth:`Autoscaler.start` ticks on a daemon thread.
- **Hysteresis and cooldowns.** Scale-up and scale-down trigger on
  separate utilization bands with separate consecutive-tick
  requirements and cooldowns: up is fast (a breach is user-visible),
  down is slow.
- **Scale-up**: new replicas come from the injected ``factory(version)``
  (on the card, an :class:`~dcnn_tpu_torch.serve.swap.EngineFactory`
  build whose engine captures its bucket graphs under the process-wide
  capture lock while the other replicas replay; a failed capture fails
  the build, never falls back to eager). Spin-up wall is recorded per
  replica (``autoscale_spinup_seconds``).
- **Scale-down is drain-then-remove** (:meth:`Router.decommission`): the
  accepted-ledger no-silent-drop guarantee holds through a shrink, and a
  victim dying mid-drain re-admits its work to survivors. The retired
  replica is closed, which gives its engine's graph pool back.
- **Shared hardware**: with a :class:`DeviceLeaseBroker`, every replica
  costs a device lease. The serving tenant outranks training: a scale-up
  that finds no free device fires a revocation at the training tenant
  (whose elastic twin, :mod:`dcnn_tpu_torch.parallel.autoscale`, shrinks
  the training world and surrenders the device); the autoscaler retries
  next tick, so the handoff needs no blocking rendezvous. Scale-down
  returns the lease.

SLO accounting: ``autoscale_slo_violation_seconds_total`` integrates
breach time tick by tick, and the first scale-up of each breach episode
records breach start to capacity added on
``autoscale_scale_up_reaction_seconds``. The first breaching tick of an
episode records an ``autoscale_slo_breach`` flight bundle.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# HttpScraper lives in obs/fleet.py with the monitoring plane; it is
# re-exported here, where the JAX package also exports it
from ..obs.fleet import FleetAggregator, HttpScraper  # noqa: F401
from .router import Router


@dataclass
class AutoscalerConfig:
    """SLO targets + hysteresis/cooldown knobs.

    The scale-up band must sit strictly above the scale-down band
    (``low_utilization < high_utilization``) — the gap IS the
    hysteresis; a single threshold would flap a fleet whose load sits on
    it."""

    slo_p99_ms: float = 200.0        # windowed p99 above this = breach
    max_shed_fraction: float = 0.0   # any admission shed = breach
    high_utilization: float = 0.80   # mean queue fill that triggers up
    low_utilization: float = 0.30    # mean queue fill that allows down
    min_replicas: int = 1
    max_replicas: int = 8
    up_cooldown_s: float = 5.0       # min gap between scale-ups
    down_cooldown_s: float = 30.0    # min gap between scale-downs
    breach_ticks: int = 1            # consecutive breach ticks before up
    idle_ticks: int = 3              # consecutive idle ticks before down
    step_up: int = 1                 # replicas added per scale-up
    max_hbm_fraction: float = 0.92   # scale-up blocked past this
    drain_timeout_s: float = 30.0    # decommission drain budget
    # scale-down traffic guard: a fleet that is KEEPING UP reads ~0
    # instantaneous queue depth between ticks, so utilization alone
    # would shrink it at steady peak load and pay a breach + re-grow
    # limit cycle every down_cooldown_s. Down is therefore also gated on
    # offered traffic: the projected per-replica rate after the shrink
    # must stay under this fraction of the per-replica rate that forced
    # the last pressure-driven scale-up. 0 disables the guard.
    down_headroom: float = 0.9

    def __post_init__(self):
        if not 0 <= self.low_utilization < self.high_utilization:
            raise ValueError(
                f"need 0 <= low_utilization < high_utilization for a "
                f"hysteresis band, got {self.low_utilization} / "
                f"{self.high_utilization}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas} / {self.max_replicas}")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if self.breach_ticks < 1 or self.idle_ticks < 1:
            raise ValueError("breach_ticks / idle_ticks must be >= 1")
        if self.step_up < 1:
            raise ValueError("step_up must be >= 1")


@dataclass
class ReplicaSignals:
    """One replica's scraped view for one tick. ``shed_fraction`` is the
    replica's LIFETIME shed/offered ratio (ServeMetrics semantics) —
    carried for operator visibility via ``FleetSignals.replicas``; the
    breach verdict's shed signal is the router-tier per-tick delta
    (``FleetSignals.shed_fraction``), which tracks current traffic
    instead of pinning breach on history."""

    name: str
    routable: bool
    queue_depth: float = 0.0
    queue_capacity: float = 0.0
    p99_ms: Optional[float] = None
    shed_fraction: float = 0.0
    hbm_fraction: Optional[float] = None


@dataclass
class FleetSignals:
    """The aggregate the decision runs on. ``p99_ms`` is the worst
    routable replica's windowed p99 (a breach on ANY replica is a
    user-visible breach); ``utilization`` is the mean queue fill;
    ``shed_fraction`` is the router-tier *per-tick* shed ratio."""

    replicas: List[ReplicaSignals] = field(default_factory=list)
    routable: int = 0
    utilization: float = 0.0
    p99_ms: Optional[float] = None
    shed_fraction: float = 0.0
    offered: float = 0.0             # requests offered since last tick
    hbm_fraction: Optional[float] = None


def _default_scrape(name: str, replica) -> Optional[str]:
    """In-process scrape: the replica's own ``ServeMetrics`` exposition
    text — the same bytes its HTTP ``/metrics`` serves, so the parse
    path (and therefore the whole signal contract) is identical in tests
    and production."""
    m = getattr(replica, "metrics", None)
    if m is None:
        return None
    try:
        return m.prometheus()
    except Exception:
        return None


class DeviceLeaseBroker:
    """Arbitrates a fixed pool of accelerator devices between tenants
    with strict priority — the shared-hardware contract between the
    serving fleet and the elastic training world.

    Rules:

    - ``register`` each tenant once with a ``priority`` (higher wins;
      serving registers above training) and an optional ``on_revoke``
      callback.
    - :meth:`request` grants only devices that are free *right now* and
      returns the granted count. A shortfall fires ``on_revoke(k)`` at
      lower-priority holders (largest holders first) — **a notification,
      not a seizure**: the holder surrenders by calling :meth:`release`
      when its own protocol allows (the elastic trainer finishes its
      reshape first). The claimant polls ``request`` again; no blocking
      rendezvous, no deadlock.
    - Revocations are edge-triggered per shortfall: a pending revocation
      is remembered so a claimant retrying every tick does not spam the
      holder with duplicate revokes for the same devices. A holder that
      cannot fulfil part of a revocation (e.g. a ``min_hold`` floor)
      must :meth:`decline` that part — otherwise the phantom pending
      count would suppress every future revocation even after the
      holder re-grew and COULD surrender (permanent starvation of the
      higher-priority tenant).
    - All accounting is lock-guarded; callbacks fire OUTSIDE the lock
      (an ``on_revoke`` is free to call back into the broker).
    """

    def __init__(self, devices: int, *,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.devices = devices
        self._clock = clock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._reg = registry
        self._lock = threading.Lock()
        self._held: Dict[str, int] = {}        # dcnn: guarded_by=_lock
        self._priority: Dict[str, int] = {}    # dcnn: guarded_by=_lock
        self._on_revoke: Dict[str, Optional[Callable[[int], None]]] = {}  # dcnn: guarded_by=_lock
        self._revoke_pending: Dict[str, int] = {}  # dcnn: guarded_by=_lock
        self._grants = registry.counter(
            "lease_grants_total", "device leases granted")
        self._revocations = registry.counter(
            "lease_revocations_total",
            "devices asked back from lower-priority tenants")
        self._free_gauge = registry.gauge(
            "lease_free_devices", "devices currently unleased")
        self._free_gauge.set(devices)

    def register(self, tenant: str, *, priority: int = 0, held: int = 0,
                 on_revoke: Optional[Callable[[int], None]] = None
                 ) -> None:
        """Add a tenant. ``held`` pre-assigns devices the tenant already
        physically owns at wiring time (the usual bootstrap: training
        starts holding the night fleet)."""
        with self._lock:
            if tenant in self._held:
                raise ValueError(f"tenant {tenant!r} already registered")
            total = sum(self._held.values()) + held
            if held < 0 or total > self.devices:
                raise ValueError(
                    f"cannot pre-assign {held} devices to {tenant!r}: "
                    f"{total} > pool of {self.devices}")
            self._held[tenant] = held
            self._priority[tenant] = priority
            self._on_revoke[tenant] = on_revoke
            self._revoke_pending[tenant] = 0
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        free = self.devices - sum(self._held.values())
        self._free_gauge.set(free)
        for tenant, n in self._held.items():
            self._reg.gauge(
                f"lease_held_{tenant}",
                f"devices leased to tenant {tenant}").set(n)

    def held(self, tenant: str) -> int:
        with self._lock:
            return self._held.get(tenant, 0)

    def free(self) -> int:
        with self._lock:
            return self.devices - sum(self._held.values())

    def request(self, tenant: str, n: int) -> int:
        """Grant up to ``n`` free devices now; fire revocations at
        lower-priority holders for any shortfall. Returns the granted
        count (0 is a normal answer — retry after the holders
        surrender)."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        revoke_calls: List = []
        with self._lock:
            if tenant not in self._held:
                raise KeyError(f"tenant {tenant!r} not registered")
            free = self.devices - sum(self._held.values())
            granted = min(free, n)
            if granted > 0:
                self._held[tenant] += granted
                self._grants.inc(granted)
                self._update_gauges_locked()
            shortfall = n - granted
            if shortfall > 0:
                my_pri = self._priority[tenant]
                # devices already asked back count against the shortfall —
                # a claimant retrying every tick must not spam duplicate
                # revokes for the same devices (edge-triggered contract)
                already_pending = sum(
                    p for t, p in self._revoke_pending.items()
                    if self._priority[t] < my_pri and t != tenant)
                shortfall -= already_pending
                holders = sorted(
                    ((t, h) for t, h in self._held.items()
                     if self._priority[t] < my_pri and t != tenant),
                    key=lambda th: (-th[1], self._priority[th[0]]))
                for t, h in holders:
                    if shortfall <= 0:
                        break
                    revocable = h - self._revoke_pending[t]
                    k = min(max(revocable, 0), shortfall)
                    if k <= 0:
                        continue
                    self._revoke_pending[t] += k
                    shortfall -= k
                    self._revocations.inc(k)
                    cb = self._on_revoke[t]
                    if cb is not None:
                        revoke_calls.append((cb, k))
        for cb, k in revoke_calls:
            cb(k)
        return granted

    def release(self, tenant: str, n: int) -> None:
        """Hand ``n`` held devices back to the pool (a surrender after a
        revocation, or a voluntary scale-down)."""
        with self._lock:
            if tenant not in self._held:
                raise KeyError(f"tenant {tenant!r} not registered")
            if n < 1 or n > self._held[tenant]:
                raise ValueError(
                    f"tenant {tenant!r} cannot release {n} of "
                    f"{self._held[tenant]} held device(s)")
            self._held[tenant] -= n
            self._revoke_pending[tenant] = max(
                self._revoke_pending[tenant] - n, 0)
            self._update_gauges_locked()

    def decline(self, tenant: str, n: int) -> None:
        """Refuse ``n`` devices of a pending revocation without
        releasing them (the holder's own floor forbids surrendering).
        The claimant's next :meth:`request` re-fires a revocation for
        the shortfall, so a holder that later re-grows past its floor
        is asked again instead of being shadowed by stale pending."""
        if n < 1:
            return
        with self._lock:
            if tenant not in self._held:
                raise KeyError(f"tenant {tenant!r} not registered")
            self._revoke_pending[tenant] = max(
                self._revoke_pending[tenant] - n, 0)

    def revoke_pending(self, tenant: str) -> int:
        """Devices this tenant has been asked to surrender and has not
        yet released — the elastic twin polls this to size its shrink."""
        with self._lock:
            return self._revoke_pending.get(tenant, 0)

    def __repr__(self) -> str:
        with self._lock:
            held = dict(self._held)
            free = self.devices - sum(held.values())
        return f"DeviceLeaseBroker(free={free}, held={held})"


class Autoscaler:
    """The serving-fleet control loop over a :class:`Router`.

    ``factory(version) -> replica`` builds one new replica ready for
    ``Router.add_replica`` (the spin-up path); the autoscaler
    owns the replicas it builds (closes them after decommission) and
    ONLY those — the bootstrap fleet stays the caller's. ``version_fn``
    overrides which version new replicas load (default: the modal
    version among routable replicas, so a mid-canary scale-up joins the
    stable set, not the canary)."""

    def __init__(self, router: Router, factory: Callable[[Any], Any], *,
                 config: Optional[AutoscalerConfig] = None,
                 broker: Optional[DeviceLeaseBroker] = None,
                 tenant: str = "serve",
                 version_fn: Optional[Callable[[], Any]] = None,
                 scrape: Callable[[str, Any], Optional[str]]
                 = _default_scrape,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "autoscaler", flight=None,
                 aggregator: Optional[FleetAggregator] = None):
        self.router = router
        self.factory = factory
        self.cfg = config if config is not None else AutoscalerConfig()
        self.broker = broker
        self.tenant = tenant
        self.version_fn = version_fn
        self.scrape = scrape
        self.name = name
        self._flight = flight  # None: process-global flight recorder
        self._clock = clock
        self._reg = registry if registry is not None \
            else router.metrics.registry
        # the ONE scrape surface (obs/fleet.py): every tick's replica
        # expositions flow through the aggregator, which parses them,
        # retains per-replica + sum/max fleet history in its tsdb, and
        # counts per-target scrape latency/failures — the autoscaler
        # keeps only the DECISION state (deltas, hysteresis runs)
        self.aggregator = aggregator if aggregator is not None \
            else FleetAggregator(registry=self._reg, clock=clock)
        self._lock = threading.Lock()
        self._owned: Dict[str, Any] = {}      # dcnn: guarded_by=_lock
        self._spawned = 0                     # dcnn: guarded_by=_lock
        self._breach_run = 0                  # dcnn: guarded_by=_lock
        self._idle_run = 0                    # dcnn: guarded_by=_lock
        self._breach_since: Optional[float] = None  # dcnn: guarded_by=_lock
        self._breach_reacted = False          # dcnn: guarded_by=_lock
        self._slo_breached = False            # dcnn: guarded_by=_lock
        self._last_up: Optional[float] = None  # dcnn: guarded_by=_lock
        self._last_down: Optional[float] = None  # dcnn: guarded_by=_lock
        self._last_tick: Optional[float] = None  # dcnn: guarded_by=_lock
        # baseline the per-tick shed delta on the router's CURRENT
        # counters — attached to a long-lived router, tick 1 must not
        # read the entire shed history as one tick's shed fraction
        totals = router.metrics.snapshot()["total"]
        self._last_counts = {"requests": totals["requests"],
                             "shed": totals["shed"]}  # dcnn: guarded_by=_lock
        self._last_error: Optional[str] = None  # dcnn: guarded_by=_lock
        self._blocked_reason: Optional[str] = None  # dcnn: guarded_by=_lock
        self._scrape_error: Optional[str] = None  # dcnn: guarded_by=_lock
        # per-replica offered rps at the last pressure-driven scale-up —
        # the demand watermark the down_headroom guard projects against
        self._up_rate: Optional[float] = None  # dcnn: guarded_by=_lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        r = self._reg
        self._ticks = r.counter("autoscale_ticks_total",
                                "autoscaler decision turns")
        self._ups = r.counter("autoscale_scale_ups_total",
                              "scale-up actions taken")
        self._downs = r.counter("autoscale_scale_downs_total",
                                "scale-down (decommission) actions taken")
        self._up_failures = r.counter(
            "autoscale_scale_up_failures_total",
            "replica factory/spin-up failures during scale-up")
        self._lease_blocked = r.counter(
            "autoscale_lease_blocked_total",
            "scale-up ticks blocked waiting on a device lease")
        self._scrape_failures = r.counter(
            "autoscale_scrape_parse_failures_total",
            "replica /metrics bodies that failed to parse")
        self._hbm_blocked = r.counter(
            "autoscale_hbm_blocked_total",
            "scale-up ticks refused at the HBM watermark guard")
        self._slo_violation_s = r.counter(
            "autoscale_slo_violation_seconds_total",
            "integrated wall seconds spent in SLO breach")
        self._spinup_hist = r.histogram(
            "autoscale_spinup_seconds",
            "replica factory + fleet-join wall per scale-up replica")
        self._reaction_hist = r.histogram(
            "autoscale_scale_up_reaction_seconds",
            "breach start to first capacity added, per breach episode")
        self._breach_gauge = r.gauge(
            "autoscale_breach", "1 while the fleet is in SLO breach")
        self._target_gauge = r.gauge(
            "autoscale_replicas_target",
            "fleet size the autoscaler is steering toward")
        self._reaction_gauge = r.gauge(
            "autoscale_last_scale_up_reaction_s",
            "most recent breach-to-scale-up reaction")
        self._devices_gauge = r.gauge(
            "autoscale_devices_held",
            "device leases held by the serving tenant")
        self._target_gauge.set(len(router.replica_names()))

    # -- signals -----------------------------------------------------------
    def collect(self, *, _commit: bool = False) -> FleetSignals:
        """One scrape pass THROUGH the aggregator: per-replica exposition
        text → parsed signals + the router's per-tick shed delta. The
        aggregator does the scraping/parsing/history bookkeeping
        (obs/fleet.py); this method reduces its results to the decision
        signals. Public calls are READ-ONLY on decision state: only the
        decision loop commits the counter baseline (``_commit``) — an
        operator dashboard polling ``collect()`` between ticks must not
        consume the shed delta and blind the next tick's breach
        verdict."""
        stats = self.router.replica_stats()
        fleet = FleetSignals()
        fills: List[float] = []
        hbms: List[float] = []
        handles = self.router.replicas()
        parse_errors: List[str] = []
        scraped = self.aggregator.poll(targets={
            rname: (lambda rn=rname: self.scrape(rn, handles.get(rn)))
            for rname in stats})
        for rname, st in stats.items():
            sig = ReplicaSignals(name=rname,
                                 routable=st["state"] == "up")
            res = scraped.get(rname, {})
            if res.get("parse_error"):
                # a half-parsed scrape must not feed the decision — but
                # it must not be INVISIBLE either: the replica scores
                # signal-less (a latency-only breach there goes dark),
                # so count it and degrade /healthz via autoscale_check
                # until a tick parses clean
                parse_errors.append(f"{rname}: {res['parse_error']}")
                if _commit:
                    self._scrape_failures.inc()
            vals = res.get("values")
            if res.get("fetched"):
                vals = vals if vals is not None else {}
                sig.queue_depth = float(vals.get("serve_queue_depth", 0.0))
                sig.p99_ms = vals.get("serve_latency_window_p99_ms")
                sig.shed_fraction = float(
                    vals.get("serve_shed_fraction", 0.0))
                limit = vals.get("hbm_bytes_limit")
                used = vals.get("hbm_bytes_in_use")
                if limit and used is not None:
                    sig.hbm_fraction = float(used) / float(limit)
            cap = getattr(handles.get(rname), "queue_capacity", 0)
            sig.queue_capacity = float(cap or 0)
            fleet.replicas.append(sig)
            if sig.routable:
                fleet.routable += 1
                # router-side outstanding covers rows in flight even when
                # a replica exposes no scrape text
                depth = max(sig.queue_depth, float(st["outstanding"]))
                if sig.queue_capacity > 0:
                    fills.append(depth / sig.queue_capacity)
                if sig.p99_ms is not None:
                    fleet.p99_ms = (sig.p99_ms if fleet.p99_ms is None
                                    else max(fleet.p99_ms, sig.p99_ms))
                if sig.hbm_fraction is not None:
                    hbms.append(sig.hbm_fraction)
        fleet.utilization = (sum(fills) / len(fills)) if fills else 0.0
        fleet.hbm_fraction = (sum(hbms) / len(hbms)) if hbms else None
        totals = self.router.metrics.snapshot()["total"]
        with self._lock:
            if _commit:
                # like the counter baseline, scrape health is DECISION
                # state: a dashboard poll must neither clear a tick's
                # degradation nor degrade /healthz over a blip no tick saw
                self._scrape_error = (parse_errors[-1] if parse_errors
                                      else None)
            d_req = totals["requests"] - self._last_counts["requests"]
            d_shed = totals["shed"] - self._last_counts["shed"]
            if _commit:
                self._last_counts = {"requests": totals["requests"],
                                     "shed": totals["shed"]}
        offered = d_req + d_shed
        fleet.offered = float(offered)
        fleet.shed_fraction = (d_shed / offered) if offered > 0 else 0.0
        return fleet

    def _pick_version(self) -> Any:
        if self.version_fn is not None:
            return self.version_fn()
        counts: Dict[Any, int] = {}
        for st in self.router.replica_stats().values():
            if st["state"] == "up" and not st["canary"] \
                    and st["version"] is not None:
                counts[st["version"]] = counts.get(st["version"], 0) + 1
        if not counts:
            return None
        return max(counts.items(), key=lambda kv: kv[1])[0]

    # -- the decision turn -------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """One control-loop turn: scrape → classify → (maybe) act.
        Returns ``{"action": "up" | "down" | "hold" | "blocked",
        ...}``. Never raises — a broken turn is recorded and surfaces
        via :func:`autoscale_check`."""
        with self._lock:
            # this turn's verdict replaces the last one: a clean turn
            # clears a prior error/block so a transient failure (or an
            # HBM/lease block whose scale-up demand has since passed)
            # cannot pin /healthz degraded for the process lifetime
            self._last_error = None
            self._blocked_reason = None
        try:
            return self._tick_inner()
        except Exception as e:
            msg = f"{type(e).__name__}: {e}"
            with self._lock:
                self._last_error = msg
            return {"action": "error", "error": msg}

    def _tick_inner(self) -> Dict[str, Any]:
        self._ticks.inc()
        now = self._clock()
        self.router.check_replicas()
        self._reap_dead_owned()
        fleet = self.collect(_commit=True)
        cfg = self.cfg
        breach_p99 = (fleet.p99_ms is not None
                      and fleet.p99_ms > cfg.slo_p99_ms)
        breach_shed = fleet.shed_fraction > cfg.max_shed_fraction
        breach_none = fleet.routable < cfg.min_replicas
        hot = fleet.utilization > cfg.high_utilization
        breach = breach_p99 or breach_shed or breach_none
        # "pressure" (breach OR running hot) drives scale-up; only a true
        # SLO breach accrues violation seconds — pre-emptive growth on
        # utilization is the loop doing its job BEFORE users notice
        pressure = breach or hot
        idle = (not pressure
                and fleet.utilization < cfg.low_utilization
                and fleet.shed_fraction == 0.0)
        with self._lock:
            dt = (now - self._last_tick) if self._last_tick is not None \
                else 0.0
            self._last_tick = now
            if pressure:
                if self._breach_since is None:
                    self._breach_since = now
                    self._breach_reacted = False
                self._breach_run += 1
                self._idle_run = 0
            else:
                self._breach_since = None
                self._breach_run = 0
                self._idle_run = self._idle_run + 1 if idle else 0
            breach_run, idle_run = self._breach_run, self._idle_run
            last_up, last_down = self._last_up, self._last_down
        if breach and dt > 0:
            self._slo_violation_s.inc(dt)
        self._breach_gauge.set(1 if breach else 0)
        # flight recorder at the SLO-breach EDGE (first breaching tick of
        # an episode — `breach`, not `pressure`: pre-emptive growth on
        # utilization is the loop working, not a violation). record()
        # never raises, honoring tick()'s never-raise contract.
        with self._lock:
            breach_edge = breach and not self._slo_breached
            self._slo_breached = breach
        if breach_edge:
            from ..obs.flight import resolve_flight_recorder
            resolve_flight_recorder(self._flight).record(
                "autoscale_slo_breach",
                reasons=[r for r, hit in (
                    (f"p99 {fleet.p99_ms}ms > slo {cfg.slo_p99_ms}ms",
                     breach_p99),
                    (f"shed fraction {fleet.shed_fraction:.4f} > "
                     f"{cfg.max_shed_fraction:g}", breach_shed),
                    (f"routable {fleet.routable} < min_replicas "
                     f"{cfg.min_replicas}", breach_none)) if hit],
                registry=self._reg,
                config={"slo_p99_ms": cfg.slo_p99_ms,
                        "max_shed_fraction": cfg.max_shed_fraction,
                        "min_replicas": cfg.min_replicas,
                        "max_replicas": cfg.max_replicas},
                extra={"routable": fleet.routable,
                       "p99_ms": fleet.p99_ms,
                       "shed_fraction": fleet.shed_fraction,
                       "utilization": fleet.utilization})
        out: Dict[str, Any] = {
            "routable": fleet.routable,
            "utilization": round(fleet.utilization, 4),
            "p99_ms": fleet.p99_ms,
            "shed_fraction": round(fleet.shed_fraction, 4),
            "breach": breach,
        }
        want_up = pressure and breach_run >= cfg.breach_ticks
        # a fleet below min_replicas is always grown, cooldown or not —
        # that is availability repair, not load-tracking
        repair = fleet.routable < cfg.min_replicas
        if repair:
            want_up = True
        if want_up:
            if fleet.routable >= cfg.max_replicas:
                out.update(action="blocked", reason="at max_replicas")
                return out
            if (fleet.routable >= cfg.min_replicas
                    and last_up is not None
                    and now - last_up < cfg.up_cooldown_s):
                out.update(action="hold", reason="up cooldown")
                return out
            if fleet.hbm_fraction is not None \
                    and fleet.hbm_fraction > cfg.max_hbm_fraction:
                self._hbm_blocked.inc()
                self._set_blocked(f"hbm watermark "
                                  f"{fleet.hbm_fraction:.2f} > "
                                  f"{cfg.max_hbm_fraction:g}")
                out.update(action="blocked", reason="hbm watermark")
                return out
            return self._scale_up(fleet, now, out,
                                  rate_now=(fleet.offered / dt)
                                  if (dt > 0 and not repair) else None)
        if idle and idle_run >= cfg.idle_ticks \
                and fleet.routable > cfg.min_replicas:
            if last_down is not None \
                    and now - last_down < cfg.down_cooldown_s:
                out.update(action="hold", reason="down cooldown")
                return out
            # traffic guard: instantaneous queues read ~0 on a fleet
            # that is keeping up — project the post-shrink per-replica
            # offered rate against the demand watermark instead of
            # decommissioning at steady peak and paying a breach +
            # re-grow limit cycle every down_cooldown_s
            rate_now = (fleet.offered / dt) if dt > 0 else None
            with self._lock:
                up_rate = self._up_rate
            if (cfg.down_headroom > 0 and up_rate is not None
                    and rate_now is not None and fleet.routable > 1
                    and rate_now / (fleet.routable - 1)
                    > up_rate * cfg.down_headroom):
                out.update(action="hold", reason="traffic needs fleet")
                return out
            return self._scale_down(fleet, now, out)
        out.update(action="hold")
        return out

    def _set_blocked(self, reason: Optional[str]) -> None:
        with self._lock:
            self._blocked_reason = reason

    def _release_lease(self, n: int = 1) -> None:
        if self.broker is None:
            return
        try:
            self.broker.release(self.tenant, n)
        except ValueError as e:
            # mis-wired lease bootstrap (serve registered without
            # held=<bootstrap fleet size>): the
            # fleet change already happened, so surface the accounting
            # error without failing the turn
            with self._lock:
                self._last_error = f"lease release failed: {e}"
        self._devices_gauge.set(self.broker.held(self.tenant))

    def _reap_dead_owned(self) -> None:
        """Reclaim owned replicas that died (preemption, crash) and that
        the sweep could not revive: drop them from the fleet map, close
        them, and return their device leases. Without this, a dead owned
        replica is unreachable forever — ``_scale_down`` only ever
        considers routable victims and nobody restarts an
        autoscaler-owned replica — so its lease and dispatcher/HBM would
        leak until the pool starved every future scale-up."""
        stats = self.router.replica_stats()
        with self._lock:
            owned = list(self._owned)
        for rname in owned:
            st = stats.get(rname)
            if st is not None and st["state"] != "dead":
                continue
            if st is not None:
                # death detection already swept + re-admitted its ledger
                self.router.remove_replica(rname)
            with self._lock:
                replica = self._owned.pop(rname, None)
            if replica is not None:
                try:
                    replica.close()
                except Exception:
                    pass
            self._release_lease()

    def _scale_up(self, fleet: FleetSignals, now: float,
                  out: Dict[str, Any], *,
                  rate_now: Optional[float] = None) -> Dict[str, Any]:
        cfg = self.cfg
        need = min(cfg.step_up, cfg.max_replicas - fleet.routable)
        # resolve the version BEFORE taking leases: a raising version_fn
        # must not strand granted devices behind tick()'s catch-all
        version = self._pick_version()
        if self.broker is not None:
            granted = self.broker.request(self.tenant, need)
            self._devices_gauge.set(self.broker.held(self.tenant))
            if granted == 0:
                self._lease_blocked.inc()
                self._set_blocked(
                    "scale-up waiting on a device lease (revocation "
                    "sent to lower-priority tenants)")
                out.update(action="blocked", reason="awaiting lease")
                return out
            need = granted
        added: List[str] = []
        for _ in range(need):
            t0 = self._clock()
            replica = None
            try:
                replica = self.factory(version)
                rname = self.router.add_replica(replica)
            except Exception as e:
                self._up_failures.inc()
                if replica is not None:
                    # built but never joined the fleet: nobody else owns
                    # it, so close it here or leak its dispatcher/HBM
                    try:
                        replica.close()
                    except Exception:
                        pass
                self._release_lease()
                with self._lock:
                    self._last_error = (f"scale-up factory failed: "
                                        f"{type(e).__name__}: {e}")
                continue
            self._spinup_hist.observe(self._clock() - t0)
            with self._lock:
                self._owned[rname] = replica
                self._spawned += 1
            added.append(rname)
        if added:
            self._ups.inc()
            with self._lock:
                self._last_up = now
                if rate_now is not None and rate_now > 0:
                    # the demand a one-smaller fleet could not carry,
                    # per replica of the fleet sized to carry it —
                    # repair scale-ups (rate_now=None) never lower it
                    self._up_rate = rate_now / (fleet.routable
                                                + len(added))
                since, reacted = self._breach_since, self._breach_reacted
                if since is not None and not reacted:
                    self._breach_reacted = True
            if since is not None and not reacted:
                reaction = now - since
                self._reaction_hist.observe(reaction)
                self._reaction_gauge.set(reaction)
            self._target_gauge.set(fleet.routable + len(added))
            out.update(action="up", added=added, version=version)
        else:
            out.update(action="blocked", reason="factory failures")
        return out

    def _scale_down(self, fleet: FleetSignals, now: float,
                    out: Dict[str, Any]) -> Dict[str, Any]:
        stats = self.router.replica_stats()
        # victim: least-loaded routable non-canary (a canary is the
        # version manager's experiment — never the autoscaler's victim);
        # prefer replicas this autoscaler spawned so the bootstrap fleet
        # survives a quiet night
        with self._lock:
            owned = set(self._owned)
        candidates = [(n, st) for n, st in stats.items()
                      if st["state"] == "up" and not st["canary"]]
        if not candidates:
            out.update(action="hold", reason="no eligible victim")
            return out
        candidates.sort(key=lambda kv: (kv[0] not in owned,
                                        kv[1]["outstanding"]))
        victim = candidates[0][0]
        report = self.router.decommission(
            victim, timeout=self.cfg.drain_timeout_s)
        with self._lock:
            replica = self._owned.pop(victim, None)
            self._last_down = now
            self._idle_run = 0
        if replica is not None:
            try:
                replica.close()
            except Exception:
                pass
        self._release_lease()
        self._downs.inc()
        self._target_gauge.set(max(fleet.routable - 1,
                                   self.cfg.min_replicas))
        out.update(action="down", removed=victim, drain=report)
        return out

    # -- introspection / health --------------------------------------------
    @property
    def last_error(self) -> Optional[str]:
        with self._lock:
            return self._last_error

    @property
    def blocked_reason(self) -> Optional[str]:
        with self._lock:
            return self._blocked_reason

    @property
    def scrape_error(self) -> Optional[str]:
        """The most recent tick's replica ``/metrics`` parse failure, or
        ``None`` when every scraped body parsed clean."""
        with self._lock:
            return self._scrape_error

    def owned_replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._owned)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "owned": sorted(self._owned),
                "spawned_total": self._spawned,
                "breach_run": self._breach_run,
                "idle_run": self._idle_run,
                "blocked": self._blocked_reason,
                "last_error": self._last_error,
                "scrape_error": self._scrape_error,
                "tsdb": self.aggregator.store.summary(),
            }

    # -- background polling (production convenience) -----------------------
    def start(self, interval_s: float = 2.0) -> "Autoscaler":
        """Tick on a daemon thread every ``interval_s``; idempotent.
        Tests never call this — they drive :meth:`tick` by hand under a
        fake clock."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s,), daemon=True,
            name=f"dcnn-{self.name}")
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            self.tick()  # tick() never raises — errors land on last_error

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        with self._lock:
            owned, blocked = len(self._owned), self._blocked_reason
        return (f"Autoscaler({self.name!r}, owned={owned}, "
                f"blocked={blocked!r})")


def autoscale_check(scaler: Autoscaler) -> Callable[[], Optional[str]]:
    """Health check over an :class:`Autoscaler` for a
    :class:`~dcnn_tpu_torch.obs.server.TelemetryServer`: degraded while the
    last decision turn errored, or while a needed scale-up is pinned
    (lease/HBM blocked during a breach) — the operator should know the
    fleet cannot grow BEFORE the SLO graph says it mattered."""
    def _check() -> Optional[str]:
        err = scaler.last_error
        if err is not None:
            return f"autoscaler turn failed: {err}"
        blocked = scaler.blocked_reason
        if blocked is not None:
            return f"scale-up blocked: {blocked}"
        scrape = scaler.scrape_error
        if scrape is not None:
            return f"replica scrape unparseable: {scrape}"
        return None
    return _check
