"""The elastic-training side of the device-lease contract (counterpart
of ``dcnn_tpu/parallel/autoscale.py``).

``serve/autoscale.py`` owns the broker and the serving fleet; this module
lets the **training world** share the same devices:

- :class:`TrainLease`: the training tenant's view of a
  :class:`~dcnn_tpu_torch.serve.autoscale.DeviceLeaseBroker`. Training
  registers *below* serving priority, so a serving scale-up that finds
  no free device fires this lease's revocation path. A revocation is a
  notification: the lease picks victims (highest ranks first, never
  below ``min_hold``), asks each controller to
  :meth:`~dcnn_tpu_torch.parallel.elastic.ElasticController.preempt`,
  and the device is surrendered only AFTER the controller has left
  cleanly; the surviving peers reshape through the elastic
  reconfiguration protocol and training never stops.
- :class:`LeasedElasticTrainer`: runs training as segments over in-process
  controller fleets (one thread per leased host over loopback; a
  deployment runs one process per host speaking the same protocol).
  Each :meth:`~LeasedElasticTrainer.run_segment` stands the fleet up at
  the currently leased world size, resumed from the shared checkpoint
  root (``fit(resume=True)``); **shrink happens live mid-segment**
  (revocation, preempt, reshape); **growth happens at segment
  boundaries**: the fleet restarts larger from the newest commit, since
  the elastic mesh only shrinks within a generation.

Shared state: the revocation listener is lifetime-scoped (registered
once, in the constructor), so a revocation that lands in the gap between
two segments is kept in ``_deferred_revoke`` and applied as the next
fleet registers; what the ``min_world`` floor makes undeliverable is
declined back to the broker. Dropping either would leave the broker's
edge-triggered pending count suppressing every later revocation, and the
serving tenant lease-blocked for ever.

Numerics: shrink is the elastic reshard (global batch and optimizer
trajectory fixed; reassociation of the gradient sum the only change)
and growth a checksum-verified restore, so a leased run's final params
match an uninterrupted fixed-world run within the reshard tolerance.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..obs import get_registry
from .comm import listen
from .elastic import PeerSpec, PreemptedError


class TrainLease:
    """Training tenant over a device-lease broker.

    ``min_hold`` is the floor training never surrenders below (a run
    that gave up its last chip is a stopped run, which is an operator
    decision, not an autoscaler's) — revocations beyond it are
    *declined* back to the broker, so the serving side stays
    lease-blocked (and re-asks on every retry) without a phantom
    pending count suppressing revocations after training re-grows.
    """

    def __init__(self, broker, *, tenant: str = "train",
                 initial: int = 0, priority: int = 0, min_hold: int = 1,
                 registry=None):
        if min_hold < 0:
            raise ValueError(f"min_hold must be >= 0, got {min_hold}")
        self.broker = broker
        self.tenant = tenant
        self.min_hold = min_hold
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._listeners: List[Callable[[int], None]] = []  # dcnn: guarded_by=_lock
        self._pending_surrender = 0  # accepted, not yet released  # dcnn: guarded_by=_lock
        self._preemptions = self._reg.counter(
            "train_lease_preemptions_total",
            "training hosts preempted for a serving scale-up")
        broker.register(tenant, priority=priority, held=initial,
                        on_revoke=self._revoked)

    def add_listener(self, fn: Callable[[int], None]) -> None:
        """``fn(k)`` fires when the broker asks ``k`` devices back
        (already clamped to what :attr:`min_hold` allows surrendering)."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _revoked(self, k: int) -> None:
        # held() still counts chips whose surrender is in flight
        # (preempt -> controller exit -> release), so subtract those or
        # back-to-back revocations would dig below min_hold
        with self._lock:
            surrenderable = max(
                self.held() - self.min_hold - self._pending_surrender, 0)
            take = min(k, surrenderable)
            self._pending_surrender += take
            listeners = list(self._listeners)
        if k - take > 0:
            self.broker.decline(self.tenant, k - take)
        if take <= 0:
            return
        for fn in listeners:
            fn(take)

    def held(self) -> int:
        return self.broker.held(self.tenant)

    def try_grow(self, n: int) -> int:
        """Ask for up to ``n`` more devices; only free ones are granted
        (training outranks nobody — it never triggers revocations)."""
        if n <= 0:
            return 0
        return self.broker.request(self.tenant, n)

    def surrender(self, n: int = 1) -> None:
        """Return ``n`` devices — called AFTER the preempted controllers
        have left (checkpoint root quiet)."""
        with self._lock:
            self._pending_surrender = max(self._pending_surrender - n, 0)
        self._preemptions.inc(n)
        self.broker.release(self.tenant, n)

    def decline(self, n: int = 1) -> None:
        """Un-accept ``n`` surrenders that will not happen (a picked
        victim left WITHOUT handing over its chip — fit() finished or
        failed some other way before the preemption could land). Hands
        the pending count back to the broker so the claimant's next
        request re-fires the revocation instead of being suppressed by
        a phantom pending forever."""
        with self._lock:
            self._pending_surrender = max(self._pending_surrender - n, 0)
        self.broker.decline(self.tenant, n)


class LeasedElasticTrainer:
    """Drives elastic training as lease-sized segments (module
    docstring). ``make_controller(rank, peers, listen_sock) ->
    ElasticController`` builds one per-host controller — the caller owns
    model/optimizer/loader/config (and must point every controller at
    one shared ``checkpoint_dir``: it is both the reshape restore point
    and the grow-segment resume point)."""

    def __init__(self, make_controller: Callable[..., Any], *,
                 lease: Optional[TrainLease] = None, min_world: int = 1,
                 registry=None):
        if min_world < 1:
            raise ValueError(f"min_world must be >= 1, got {min_world}")
        self.make_controller = make_controller
        self.lease = lease
        self.min_world = min_world
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._live: Dict[int, Any] = {}     # dcnn: guarded_by=_lock
        self._preempted: List[int] = []     # dcnn: guarded_by=_lock
        self._preempt_pending: set = set()  # dcnn: guarded_by=_lock
        self._deferred_revoke = 0           # dcnn: guarded_by=_lock
        self.segments: List[Dict[str, Any]] = []
        self.last_results: Dict[int, Any] = {}
        # the listener is LIFETIME-scoped, not segment-scoped: a
        # revocation landing in a segment gap must land on
        # _deferred_revoke (applied as the next fleet registers) — a
        # per-segment listener would drop it, and the broker's
        # edge-triggered pending accounting would then suppress every
        # re-notification, pinning the serving tenant lease-blocked
        # forever
        if lease is not None:
            lease.add_listener(self._on_revoke)

    def world(self) -> int:
        """The world size the next segment would run at."""
        held = self.lease.held() if self.lease is not None else 0
        return max(held, self.min_world)

    def _on_revoke(self, k: int) -> None:
        """Broker revocation mid-segment: preempt the ``k`` highest-rank
        controllers still alive (lowest ranks carry leadership and the
        checkpoint cadence), keeping at least ``min_world``. A revocation
        landing in a segment gap (no controllers up yet) is deferred and
        applied as the next segment's fleet registers — the broker's
        revoke is edge-triggered, so dropping it would pin the serving
        tenant lease-blocked forever."""
        with self._lock:
            self._deferred_revoke += k
        for _rank, ctl in self._pick_victims():
            ctl.preempt("device lease revoked for a serving scale-up")
        self._reconcile_deferred()

    def _reconcile_deferred(self) -> None:
        """Decline the part of the deferred revocation that ``min_world``
        makes undeliverable. The lease clamps acceptance only by its own
        ``min_hold``; when ``min_world`` is the stricter floor (or a
        capped segment left fewer preemptable ranks than chips held), the
        accepted-but-unpickable remainder would sit in ``_pending_
        surrender``/broker ``_revoke_pending`` forever — and that phantom
        pending suppresses every future revocation, permanently
        lease-starving the serving tenant."""
        if self.lease is None:
            return
        with self._lock:
            deferred = self._deferred_revoke
            inflight = len(self._preempt_pending)
        if deferred <= 0:
            return
        # chips still surrenderable once every in-flight preemption
        # lands; anything deferred past that can never be delivered
        deliverable = max(self.lease.held() - inflight - self.min_world, 0)
        undeliverable = deferred - deliverable
        if undeliverable > 0:
            with self._lock:
                self._deferred_revoke = max(
                    self._deferred_revoke - undeliverable, 0)
            self.lease.decline(undeliverable)

    def _pick_victims(self) -> List:
        """Claim up to ``_deferred_revoke`` victims (highest ranks first,
        floor at ``min_world``); takes the lock itself so a revocation
        landing between a caller's registration and the pick just means
        the pick sees it — preempt() is called outside any lock. Ranks
        whose preemption is already in flight (picked but still mid-exit,
        so still in ``_live``) are excluded: re-picking one would consume
        the revocation on an idempotent ``Event.set`` that frees no
        additional chip, wedging the lease accounting for good."""
        with self._lock:
            alive = sorted(r for r in self._live
                           if r not in self._preempt_pending)
            victims = []
            for rank in reversed(alive):
                if self._deferred_revoke <= 0 \
                        or len(alive) - len(victims) <= self.min_world:
                    break
                victims.append(rank)
                self._preempt_pending.add(rank)
                self._deferred_revoke -= 1
            return [(r, self._live[r]) for r in victims]

    def run_segment(self, epochs: int, *, target_world: Optional[int]
                    = None, resume: bool = True) -> Dict[int, Any]:
        """One fleet lifetime: (maybe) grow the lease toward
        ``target_world``, stand up that many peers, train to global
        epoch ``epochs``, return ``{rank: TrainState | "preempted" |
        Exception}``. The broker may shrink the fleet mid-segment; the
        survivors' result carries the training state."""
        if self.lease is not None:
            held = self.lease.held()
            want = target_world if target_world is not None else held
            if want > held:
                self.lease.try_grow(want - held)
            world = max(self.lease.held(), self.min_world)
            if target_world is not None:
                world = min(world, target_world)
        else:
            world = target_world if target_world is not None \
                else self.min_world
        socks = [listen(0, host="127.0.0.1") for _ in range(world)]
        peers = [PeerSpec(i, "127.0.0.1", s.getsockname()[1])
                 for i, s in enumerate(socks)]
        results: Dict[int, Any] = {}
        with self._lock:
            self._preempted = []

        def runner(rank: int) -> None:
            ctl = None
            surrendered = False
            try:
                ctl = self.make_controller(rank, peers, socks[rank])
                with self._lock:
                    self._live[rank] = ctl
                # a revocation deferred from a segment gap applies now
                for _r, c in self._pick_victims():
                    c.preempt(
                        "device lease revoked for a serving scale-up")
                results[rank] = ctl.fit(epochs=epochs, resume=resume)
            except PreemptedError:
                results[rank] = "preempted"
                with self._lock:
                    self._preempted.append(rank)
                if self.lease is not None:
                    # the controller has closed its membership and left
                    # the checkpoint root: the chip is safe to hand over
                    surrendered = True
                    self.lease.surrender(1)
            except Exception as e:
                # a constructor failure must surface like any other rank
                # failure; close the orphaned listen socket so peers
                # dialing this rank fail fast instead of waiting out the
                # full membership timeout
                results[rank] = e
                if ctl is None:
                    try:
                        socks[rank].close()
                    except OSError:
                        pass
            finally:
                with self._lock:
                    self._live.pop(rank, None)
                    was_picked = rank in self._preempt_pending
                    self._preempt_pending.discard(rank)
                if was_picked and not surrendered \
                        and self.lease is not None:
                    # picked as a victim but left some other way (fit()
                    # finished before the beat, evicted, crashed): the
                    # accepted surrender must be handed back or the
                    # phantom pending suppresses every future revocation
                    # and the serving tenant stays lease-blocked forever
                    self.lease.decline(1)

        threads: List[threading.Thread] = []
        for i in range(world):
            t = threading.Thread(target=runner, args=(i,),
                                 daemon=True,
                                 name=f"dcnn-leased-train-{i}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("leased training segment hung")
        # a revocation left undeliverable by this segment's (possibly
        # capped) world hands its pending back before the gap
        self._reconcile_deferred()
        with self._lock:
            preempted = list(self._preempted)
        self.segments.append({"world": world, "epochs_to": epochs,
                              "preempted": sorted(preempted)})
        self.last_results = results
        self._reg.counter(
            "train_segments_total",
            "leased elastic training segments completed").inc()
        return results
