"""Serving replicas: the router-facing unit of the multi-replica tier
(counterpart of ``dcnn_tpu/serve/replica.py``).

A *replica* is one ``InferenceEngine`` + ``DynamicBatcher`` pair with a
version identity, a health verdict, and a hot-swap protocol. The router
(``serve/router.py``) speaks one small interface to every replica —
``submit`` / ``health`` / ``is_dead`` / ``swap`` / ``queue_capacity`` /
``version`` — so an in-process replica and one living behind a TCP host
are interchangeable:

- :class:`LocalReplica` — engine + batcher in this process. Hot-swap is
  **drain → load → rejoin**: intake is refused (typed
  :class:`~dcnn_tpu_torch.serve.batcher.DrainingError`) while the old batcher
  completes everything it accepted, the new version's engine is built by
  the replica's ``factory(version)``, and a fresh batcher rejoins with
  continuous metrics. A failed load **rejoins on the old version**
  (never a dead replica because a canary checkpoint was bad).
- :class:`ReplicaServer` / :class:`TcpReplica` — the same unit behind
  ``parallel/comm.py`` framing: ``infer``/``result``/``error`` frames
  with per-request ids, ``ping``/``pong`` liveness carrying the remote
  health verdict + version, and a remote ``swap`` command. The client
  detects replica death **both** ways the elastic mesh does —
  immediately via connection close (reader thread ``on_close``) and via
  a last-heard timeout for the partitioned-but-open case — never by
  hanging on a recv; pending request futures are failed with
  :class:`ReplicaDeadError` so the router can re-admit them, and sends
  ride a kernel ``SO_SNDTIMEO`` deadline
  (:meth:`~dcnn_tpu_torch.parallel.comm.Channel.set_send_timeout`).

Fault injection (``resilience/faults.py``): every dispatch passes the
``serve.replica_infer`` trip point — armed with ``InjectedFault`` it is a
per-request replica error (the canary-degradation fixture: the router
re-admits the request elsewhere and counts the failure against this
replica/version); armed with ``InjectedCrash`` it is the
kill-this-replica simulation (the replica marks itself dead, in-flight
requests fail, the router ejects it). ``serve.swap`` fires in the swap
load path. Replicas accept a per-instance
:class:`~dcnn_tpu_torch.resilience.faults.FaultPlan` so multi-replica tests
can kill exactly one victim.

Where the port departs from the JAX package:

- A swap gives the retired engine's CUDA graph pool back: the engine's
  ``_release`` runs once its batcher has drained (the JAX package leaves the
  old executable to the garbage collector; here a pool's segments stay
  reserved while any graph captured into it lives, and a leaked reference
  would keep one pool a swap).
- The dispatch waits for the engine's output on its stream before the
  ``serve.slow_replica`` delay reads the batch's wall (a CUDA engine
  returns before its work is done; the batcher waits for the logits right
  after anyway), so an armed slowdown stretches what the router sees.
"""

from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import get_tracer
from ..parallel.comm import Channel, ChannelClosed, connect, listen
from ..resilience import faults as _faults
from ..resilience.faults import InjectedCrash
from .batcher import (
    DrainingError, DynamicBatcher, QueueFullError, ShutdownError,
)
from .metrics import ServeMetrics


class ReplicaError(RuntimeError):
    """A request failed for a replica-attributable reason (remote engine
    error, protocol error). The router counts it against the replica and
    re-admits the request elsewhere."""


class ReplicaDeadError(ReplicaError):
    """The replica is gone — crashed, killed, or unreachable. Requests it
    had accepted but not answered surface this (or ``ShutdownError``) so
    the router can re-admit them to survivors."""


class SwapError(ReplicaError):
    """A version swap failed; the replica rejoined on its old version."""


#: Exception classes the router treats as "the replica died" (re-admit,
#: eject) rather than "this one request failed" (re-admit, count error).
DEATH_ERRORS = (ReplicaDeadError, ShutdownError, InjectedCrash,
                ConnectionError, BrokenPipeError, OSError)


class _TrippedEngine:
    """Engine proxy inserting the ``serve.replica_infer`` fault trip in
    front of every dispatch. An ``InjectedCrash`` marks the owning
    replica dead before surfacing (the batcher scatters it to the batch's
    futures — exactly what a process death does to in-flight requests);
    an ``InjectedFault`` surfaces as a plain per-request engine error."""

    def __init__(self, engine, replica: "LocalReplica"):
        self._engine = engine
        self._replica = replica

    def run_padded(self, x):
        try:
            self._replica._trip("serve.replica_infer")
        except InjectedCrash:
            self._replica._note_crash("injected crash mid-infer")
            raise
        t0 = self._replica._clock()
        out = self._engine.run_padded(x)
        if isinstance(out, torch.Tensor) and out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        # gray-failure injection (FaultPlan.slow): stretch this batch's
        # engine wall INSIDE the dispatch — the replica stays alive and
        # healthy-looking while every completion latency it reports grows
        self._replica._slowdown("serve.slow_replica",
                                self._replica._clock() - t0)
        return out

    def __getattr__(self, name):
        return getattr(self._engine, name)


class LocalReplica:
    """One in-process serving replica with versioned hot-swap.

    ``factory(version) -> engine`` builds an engine for a model version
    (see :class:`~dcnn_tpu_torch.serve.swap.EngineFactory`); passing an engine
    *instance* instead pins the replica to it (``swap`` then raises
    :class:`SwapError` — there is nothing to load versions from).

    ``start=False`` propagates to every batcher this replica ever owns:
    no dispatcher thread runs and tests pump dispatch with :meth:`step`,
    so the whole death/swap/canary protocol is exercised sleep-free.
    """

    def __init__(self, factory: Any, version: Any = None, *,
                 name: str = "replica", max_batch: Optional[int] = None,
                 max_wait_ms: float = 2.0, queue_capacity: int = 128,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 drain_timeout_s: Optional[float] = 60.0,
                 fault_plan=None, start: bool = True):
        self.name = name
        self._clock = clock
        self._plan = fault_plan
        self._start = start
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._queue_capacity = queue_capacity
        self.drain_timeout_s = drain_timeout_s
        if callable(factory) and not hasattr(factory, "run_padded"):
            self._factory: Optional[Callable[[Any], Any]] = factory
            engine = factory(version)
        else:
            self._factory = None
            engine = factory
            if version is None:
                version = getattr(engine, "version", None)
        self.metrics = metrics if metrics is not None else ServeMetrics(
            clock=clock)
        self._lock = threading.Lock()
        self._state = "up"                 # dcnn: guarded_by=_lock
        self._dead_reason: Optional[str] = None  # dcnn: guarded_by=_lock
        self._version = version            # dcnn: guarded_by=_lock
        self._engine = engine              # dcnn: guarded_by=_lock
        self._batcher = self._make_batcher(engine)  # dcnn: guarded_by=_lock

    # -- internals ---------------------------------------------------------
    def _make_batcher(self, engine) -> DynamicBatcher:
        return DynamicBatcher(
            _TrippedEngine(engine, self), max_batch=self._max_batch,
            max_wait_ms=self._max_wait_ms,
            queue_capacity=self._queue_capacity, metrics=self.metrics,
            clock=self._clock, start=self._start)

    def _trip(self, point: str, **ctx) -> None:
        _faults.trip(point, replica=self.name, **ctx)
        if self._plan is not None:
            self._plan.trip(point, replica=self.name, **ctx)

    def _slowdown(self, point: str, base_s: float, **ctx) -> float:
        """Delay-injection twin of :meth:`_trip` (``FaultPlan.slow``):
        sleeps the armed extra inside the dispatch, so the latency the
        router observes — and judges probation/hedging on — actually
        grows."""
        extra = _faults.slowdown(point, base_s, replica=self.name, **ctx)
        if self._plan is not None:
            extra += self._plan.slowdown(point, base_s,
                                         replica=self.name, **ctx)
        if extra > 0.0:
            time.sleep(extra)
        return extra

    def _note_crash(self, reason: str) -> None:
        """Mark this replica dead without tearing anything down — called
        from the dispatcher thread mid-crash, where joining ourselves
        would deadlock. :meth:`kill` (the router's eject sweep, or the
        test's top-level crash handler) does the actual teardown."""
        with self._lock:
            if self._state != "dead":
                self._state = "dead"
                self._dead_reason = reason

    # -- the router-facing interface ---------------------------------------
    @property
    def version(self):
        with self._lock:
            return self._version

    @property
    def input_shape(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._engine.input_shape)

    @property
    def queue_capacity(self) -> int:
        return self._queue_capacity

    @property
    def outstanding_rows(self) -> int:
        with self._lock:
            batcher = self._batcher
        return batcher.queue_depth if batcher is not None else 0

    def submit(self, x) -> Future:
        """Enqueue one request (batcher conventions). Raises
        :class:`ReplicaDeadError` when dead, ``DrainingError`` mid-swap,
        ``QueueFullError`` on shed."""
        with self._lock:
            state, batcher = self._state, self._batcher
            reason = self._dead_reason
        if state == "dead":
            raise ReplicaDeadError(f"replica {self.name} is dead: {reason}")
        if state != "up":
            raise DrainingError(f"replica {self.name} is {state}")
        return batcher.submit(x)

    def health(self) -> Optional[str]:
        """``None`` while routable; otherwise the machine-readable reason
        (the same contract as ``DynamicBatcher.health_reason`` — a
        degraded replica must fail health BEFORE requests error)."""
        with self._lock:
            state, reason, batcher = (self._state, self._dead_reason,
                                      self._batcher)
        if state in ("dead", "closed"):
            return f"dead: {reason}"
        if state != "up":
            return f"{state}: version swap in progress"
        return batcher.health_reason()

    def is_dead(self) -> bool:
        with self._lock:
            return self._state in ("dead", "closed")

    def ping(self) -> None:
        """Liveness probe — a no-op in process (health() is authoritative
        and always fresh); the TCP twin sends a real PING frame."""

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            state, version = self._state, self._version
        return {"name": self.name, "state": state, "version": version,
                "queue_depth": self.outstanding_rows,
                "metrics": self.metrics.snapshot()}

    def step(self, force: bool = True) -> int:
        """Pump one synchronous dispatch (``start=False`` test mode)."""
        with self._lock:
            batcher = self._batcher
        return batcher.step(force) if batcher is not None else 0

    def start_telemetry(self, port: int = 0, host: str = "127.0.0.1"):
        """Per-replica HTTP scrape surface (see
        :meth:`DynamicBatcher.start_telemetry`)."""
        with self._lock:
            batcher = self._batcher
        srv = batcher.start_telemetry(port=port, host=host)
        srv.add_check("replica", self.health)
        return srv

    # -- hot-swap ----------------------------------------------------------
    def swap(self, version) -> None:
        """Drain → load ``version`` → rejoin.

        The old batcher completes everything it accepted (new intake gets
        ``DrainingError`` — the router fails over), the factory builds the
        new engine (``serve.swap`` fault point), and a fresh batcher
        rejoins; the old engine's graph pool is then given back
        (``_release``, where the engine has one). On a load failure the
        replica **rejoins on the old engine** and raises
        :class:`SwapError`; an ``InjectedCrash`` at the swap point kills
        the replica instead (crash-mid-swap simulation)."""
        with self._lock:
            if self._state == "dead":
                raise ReplicaDeadError(
                    f"replica {self.name} is dead: {self._dead_reason}")
            if self._factory is None:
                raise SwapError(
                    f"replica {self.name} wraps a fixed engine; construct "
                    f"it with a factory (serve/swap.py EngineFactory) to "
                    f"hot-swap versions")
            if self._state != "up":
                raise SwapError(f"replica {self.name} already swapping")
            self._state = "loading"
            old_batcher = self._batcher
            old_engine = self._engine
        try:
            old_batcher.drain(timeout=self.drain_timeout_s)
        except TimeoutError:
            pass  # pending futures were failed (ShutdownError) — the
            # router re-admits them; the swap itself proceeds
        try:
            self._trip("serve.swap", version=version)
            engine = self._factory(version)
        except InjectedCrash:
            self._note_crash("injected crash mid-swap")
            raise
        except Exception as e:
            with self._lock:
                self._batcher = self._make_batcher(old_engine)
                self._state = "up"
            raise SwapError(
                f"replica {self.name}: loading version {version!r} failed "
                f"({type(e).__name__}: {e}); rejoined on old version "
                f"{self.version!r}") from e
        with self._lock:
            self._engine = engine
            self._batcher = self._make_batcher(engine)
            self._version = version
            self._state = "up"
        release = getattr(old_engine, "_release", None)
        if release is not None and old_engine is not engine:
            release()

    # -- lifecycle ---------------------------------------------------------
    def kill(self) -> None:
        """Simulate (or finish, after :meth:`_note_crash`) replica death:
        refuse intake, fail everything queued with ``ShutdownError`` so
        the router's ledger re-admits it, stop the dispatcher. Idempotent."""
        with self._lock:
            if self._state == "dead" and self._batcher is None:
                return
            self._state = "dead"
            if self._dead_reason is None:
                self._dead_reason = "killed"
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.shutdown(drain=False)

    def restart(self) -> None:
        """Rejoin after :meth:`kill`: a fresh batcher over the current
        engine (the restarted process re-loads the same version)."""
        with self._lock:
            if self._state != "dead":
                raise RuntimeError(
                    f"replica {self.name} is {self._state}, not dead")
            self._batcher = self._make_batcher(self._engine)
            self._state = "up"
            self._dead_reason = None

    def close(self) -> None:
        """Graceful teardown: drain accepted work, then stop. An engine
        this replica built from its factory then gives its graph pool
        back (``_release``), as a swap's retired engine does: a replica
        the autoscaler scaled down holds no device memory. An engine
        passed in stays the caller's."""
        with self._lock:
            if self._state == "closed":
                return
            batcher, self._batcher = self._batcher, None
            self._state = "closed"
            self._dead_reason = "closed"
            engine = self._engine
        if batcher is not None:
            batcher.shutdown(drain=True, timeout=self.drain_timeout_s)
        release = getattr(engine, "_release", None)
        if release is not None and self._factory is not None:
            release()

    def __enter__(self) -> "LocalReplica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        with self._lock:
            return (f"LocalReplica({self.name!r}, state={self._state!r}, "
                    f"version={self._version!r})")


# --------------------------------------------------------------- TCP tier

class ReplicaServer:
    """Serves one :class:`LocalReplica` over ``parallel/comm.py`` framing.

    Frames (client → server): ``infer {id} + payload``, ``ping``,
    ``swap {id, version}``, ``stats {id}``. Replies: ``result {id} +
    payload`` / ``error {id, etype, emsg, dead}`` / ``pong {health,
    version, queue_depth, queue_capacity, input_shape}`` / ``swapped
    {id, version}`` / ``stats {id, ...}``. Multiple router connections
    are accepted; each gets its own reader thread. ``close()`` joins
    every thread it spawned."""

    def __init__(self, replica: LocalReplica, *, port: int = 0,
                 host: str = "127.0.0.1", own_replica: bool = False):
        self.replica = replica
        self._own = own_replica
        self._listener = listen(port, host)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._closed = False                      # dcnn: guarded_by=_lock
        self._channels: List[Channel] = []        # dcnn: guarded_by=_lock
        self._threads: List[threading.Thread] = []  # dcnn: guarded_by=_lock
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"dcnn-replica-srv-{self.port}")
        with self._lock:
            self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            ch = Channel(sock)
            t = threading.Thread(target=self._serve, args=(ch,),
                                 daemon=True,
                                 name=f"dcnn-replica-conn-{self.port}")
            with self._lock:
                if self._closed:
                    ch.close()
                    return
                self._channels.append(ch)
                self._threads.append(t)
            t.start()

    def _serve(self, ch: Channel) -> None:
        try:
            while True:
                cmd, meta, payload = ch.recv()
                try:
                    self._handle(ch, cmd, meta, payload)
                except (ChannelClosed, ConnectionError, OSError):
                    raise
                except Exception as e:
                    # a handler exception is ONE request's failure, not
                    # the channel's: reply typed (the error frame exists
                    # for exactly this) instead of unwinding the reader
                    # and failing every in-flight request on this
                    # connection
                    self._send(ch, "error",
                               self._err_meta(meta.get("id"), e))
        except (ChannelClosed, ConnectionError, OSError):
            pass  # router went away; its pending futures are its problem

    def _send(self, ch: Channel, cmd: str, meta: Dict[str, Any],
              array=None) -> None:
        try:
            ch.send(cmd, meta, array=array, attempts=1)
        except (ChannelClosed, ConnectionError, OSError):
            pass  # client gone mid-reply

    def _pong_meta(self) -> Dict[str, Any]:
        r = self.replica
        return {"health": r.health(), "version": r.version,
                "queue_depth": r.outstanding_rows,
                "queue_capacity": r.queue_capacity,
                "input_shape": list(r.input_shape)}

    # dcnn: protocol=replica.c2s role=handler
    def _handle(self, ch: Channel, cmd: str, meta: Dict[str, Any],
                payload) -> None:  # dcnn: protocol=replica.s2c role=sender
        if cmd == "infer":
            rid = meta["id"]
            try:
                # adopt the router's trace context for this hop: the
                # batcher's serve.queue span (begun inside submit) — and
                # through it the dispatch/infer spans — join the
                # router-side request trace across the process boundary
                with get_tracer().activate(meta.get("_trace")):
                    fut = self.replica.submit(payload)
            except Exception as e:
                self._send(ch, "error", self._err_meta(rid, e))
                return
            fut.add_done_callback(lambda f: self._reply(ch, rid, f))
        elif cmd == "ping":
            # echo the client's monotonic stamp + our own: the client
            # estimates the cross-process clock offset the trace-merge
            # CLI aligns shards with (NTP-style midpoint; exact on one
            # host where perf_counter is CLOCK_MONOTONIC system-wide)
            pong = self._pong_meta()
            if "t_mono" in meta:
                pong["t_echo"] = meta["t_mono"]
                pong["t_srv"] = time.perf_counter()
            self._send(ch, "pong", pong)
        elif cmd == "swap":
            # swap drains — seconds of wall — and must not block this
            # reader (pings keep flowing or the client calls us dead)
            t = threading.Thread(
                target=self._do_swap, args=(ch, meta["id"], meta["version"]),
                daemon=True, name=f"dcnn-replica-swap-{self.port}")
            with self._lock:
                self._threads.append(t)
            t.start()
        elif cmd == "stats":
            self._send(ch, "stats", {"id": meta["id"],
                                     **self.replica.stats()})
        else:
            self._send(ch, "error", {"id": meta.get("id"),
                                     "etype": "ValueError",
                                     "emsg": f"unknown cmd {cmd!r}",
                                     "dead": False})

    @staticmethod
    def _err_meta(rid, exc: BaseException) -> Dict[str, Any]:
        return {"id": rid, "etype": type(exc).__name__, "emsg": str(exc),
                "dead": isinstance(exc, DEATH_ERRORS)}

    def _reply(self, ch: Channel, rid,
               fut: Future) -> None:  # dcnn: protocol=replica.s2c role=sender
        if fut.cancelled():
            self._send(ch, "error", {"id": rid, "etype": "CancelledError",
                                     "emsg": "cancelled", "dead": False})
            return
        exc = fut.exception()
        if exc is None:
            self._send(ch, "result", {"id": rid},
                       array=np.asarray(fut.result()))
        else:
            self._send(ch, "error", self._err_meta(rid, exc))

    def _do_swap(self, ch: Channel, rid,
                 version) -> None:  # dcnn: protocol=replica.s2c role=sender
        try:
            self.replica.swap(version)
        except Exception as e:
            self._send(ch, "error", self._err_meta(rid, e))
            return
        self._send(ch, "swapped", {"id": rid, "version": version})

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            channels = list(self._channels)
            threads = list(self._threads)
        try:
            # a bare close() does not wake a thread blocked in accept();
            # shutdown() does, so the acceptor exits now, not at a join
            # timeout
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        for ch in channels:
            ch.close()
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        if self._own:
            self.replica.close()

    def __enter__(self) -> "ReplicaServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TcpReplica:
    """Router-side client for a :class:`ReplicaServer` — the same
    interface as :class:`LocalReplica`, over one framed channel.

    Death is detected like the elastic membership mesh: immediately when
    the connection closes (reader thread ``on_close`` path), and by a
    **last-heard timeout** (``timeout_s`` since the last frame of any
    kind) for the partitioned-but-open case — :meth:`health` never
    blocks, and once either fires every pending request future fails
    with :class:`ReplicaDeadError` so the router re-admits the work."""

    def __init__(self, host: str, port: int, *, name: Optional[str] = None,
                 timeout_s: float = 10.0, connect_timeout: float = 10.0,
                 queue_capacity_hint: int = 128,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name if name is not None else f"tcp-{host}:{port}"
        self.timeout_s = timeout_s
        self._clock = clock
        self._chan = connect(host, port, timeout=connect_timeout)
        self._chan.set_send_timeout(timeout_s)
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[Future, int]] = {}  # dcnn: guarded_by=_lock
        self._swaps: Dict[int, Future] = {}       # dcnn: guarded_by=_lock
        self._stats: Dict[int, Future] = {}       # dcnn: guarded_by=_lock
        self._next_id = 0                         # dcnn: guarded_by=_lock
        self._last_heard = clock()                # dcnn: guarded_by=_lock
        self._last_ping = clock()                 # dcnn: guarded_by=_lock
        self._dead_reason: Optional[str] = None   # dcnn: guarded_by=_lock
        self._remote: Dict[str, Any] = {          # dcnn: guarded_by=_lock
            "health": None, "version": None, "queue_depth": 0,
            "queue_capacity": queue_capacity_hint, "input_shape": None}
        # perf_counter-domain offset to the server process, estimated
        # from the ping/pong handshake (NTP midpoint) — the per-shard
        # alignment hint for merging the processes' trace shards
        self.clock_offset_s: Optional[float] = None  # dcnn: guarded_by=_lock
        self.rtt_s: Optional[float] = None        # dcnn: guarded_by=_lock
        self._pong = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"dcnn-replica-cli-{host}:{port}")
        self._reader.start()
        # handshake: the first pong carries the remote identity
        # (input_shape, version, queue_capacity) that the router's
        # admission/row accounting needs — wait for it here so a freshly
        # constructed replica never makes the router mis-count rows
        # (a single sample would otherwise be admitted as shape[0] rows).
        # A server too slow to pong within the budget degrades to the
        # hints; health() still works.
        self.ping()
        self._pong.wait(timeout=connect_timeout)

    # -- wire --------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                cmd, meta, payload = self._chan.recv()
                self._on_frame(cmd, meta, payload)
        except (ChannelClosed, ConnectionError, OSError) as e:
            self._mark_dead(f"connection closed: {e}")

    # dcnn: protocol=replica.s2c role=handler
    def _on_frame(self, cmd: str, meta: Dict[str, Any], payload) -> None:
        with self._lock:
            self._last_heard = self._clock()
        if cmd == "result":
            with self._lock:
                fut, _ = self._pending.pop(meta["id"], (None, 0))
            if fut is not None:
                try:
                    fut.set_result(payload)
                except InvalidStateError:
                    pass
        elif cmd == "error":
            self._on_error(meta)
        elif cmd == "pong":
            te, ts_srv = meta.get("t_echo"), meta.get("t_srv")
            with self._lock:
                self._remote.update(
                    {k: meta.get(k, self._remote.get(k))
                     for k in ("health", "version", "queue_depth",
                               "queue_capacity", "input_shape")})
                if te is not None and ts_srv is not None:
                    # handshake clock alignment: offset such that
                    # server_perf_counter ≈ client_perf_counter + offset
                    now = time.perf_counter()
                    rtt = max(now - float(te), 0.0)
                    self.rtt_s = rtt
                    self.clock_offset_s = float(ts_srv) - (float(te)
                                                           + rtt / 2.0)
            self._pong.set()
        elif cmd == "swapped":
            with self._lock:
                fut = self._swaps.pop(meta["id"], None)
            if fut is not None:
                try:
                    fut.set_result(meta["version"])
                except InvalidStateError:
                    pass
        elif cmd == "stats":
            with self._lock:
                fut = self._stats.pop(meta.pop("id"), None)
            if fut is not None:
                try:
                    fut.set_result(meta)
                except InvalidStateError:
                    pass

    def _on_error(self, meta: Dict[str, Any]) -> None:
        rid = meta.get("id")
        etype = meta.get("etype", "ReplicaError")
        emsg = meta.get("emsg", "")
        # re-typed so the router's shed/failover/death classification
        # works identically for local and remote replicas
        if meta.get("dead"):
            exc: BaseException = ReplicaDeadError(f"{etype}: {emsg}")
        elif etype == "QueueFullError":
            exc = QueueFullError(emsg)
        elif etype == "DrainingError":
            exc = DrainingError(emsg)
        else:
            exc = ReplicaError(f"{etype}: {emsg}")
        with self._lock:
            fut, _ = self._pending.pop(rid, (None, 0))
            sfut = self._swaps.pop(rid, None)
            # stats futures too: an error reply carrying a stats id
            # otherwise strands stats() for its full timeout
            tfut = self._stats.pop(rid, None)
        for f in (fut, sfut, tfut):
            if f is not None:
                try:
                    f.set_exception(exc)
                except InvalidStateError:
                    pass

    def _mark_dead(self, reason: str) -> None:
        with self._lock:
            if self._dead_reason is not None:
                return
            self._dead_reason = reason
            pending = list(self._pending.values())
            swaps = list(self._swaps.values())
            stats = list(self._stats.values())
            self._pending.clear()
            self._swaps.clear()
            self._stats.clear()
        exc = ReplicaDeadError(f"replica {self.name}: {reason}")
        for fut, _ in pending:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass
        for fut in swaps + stats:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass

    def _send(self, cmd: str, meta: Dict[str, Any], array=None) -> None:
        try:
            self._chan.send(cmd, meta, array=array, attempts=1)
        except (ChannelClosed, ConnectionError, OSError) as e:
            self._mark_dead(f"send failed: {e}")
            raise ReplicaDeadError(
                f"replica {self.name}: send failed: {e}") from e

    # -- the router-facing interface ---------------------------------------
    @property
    def version(self):
        with self._lock:
            return self._remote["version"]

    @property
    def input_shape(self):
        with self._lock:
            shp = self._remote["input_shape"]
        return tuple(shp) if shp is not None else None

    @property
    def queue_capacity(self) -> int:
        with self._lock:
            return int(self._remote["queue_capacity"])

    @property
    def outstanding_rows(self) -> int:
        with self._lock:
            return sum(n for _, n in self._pending.values())

    def submit(self, x) -> Future:  # dcnn: protocol=replica.c2s role=sender
        x = np.asarray(x, dtype=np.float32)
        with self._lock:
            if self._dead_reason is not None:
                raise ReplicaDeadError(
                    f"replica {self.name} is dead: {self._dead_reason}")
            rid = self._next_id
            self._next_id += 1
            fut: Future = Future()
            shp = self._remote["input_shape"]
            single = shp is not None and tuple(x.shape) == tuple(shp)
            n = 1 if single or x.ndim == 0 else int(x.shape[0])
            self._pending[rid] = (fut, n)
        try:
            self._send("infer", {"id": rid}, array=x)
        except ReplicaDeadError:
            with self._lock:
                self._pending.pop(rid, None)
            raise
        return fut

    def ping(self) -> None:  # dcnn: protocol=replica.c2s role=sender
        """Fire-and-forget liveness probe; the pong refreshes
        ``last_heard`` + the cached remote health/version. Send failures
        mark the replica dead (that IS the probe result).

        ``_last_ping`` records the FIRST probe since the last frame
        heard and is not reset while that probe is outstanding —
        otherwise a sweep's ping-then-health pattern would rewind the
        probe clock every pass and the unanswered-probe conviction in
        :meth:`health` could never fire."""
        with self._lock:
            if self._last_ping <= self._last_heard:
                self._last_ping = self._clock()
        try:
            self._send("ping", {"t_mono": time.perf_counter()})
        except ReplicaDeadError:
            pass  # already marked dead with the reason

    def health(self) -> Optional[str]:
        """Last-heard liveness that never false-positives on an IDLE
        replica: silence past ``timeout_s`` only escalates to dead after
        a probe sent SINCE the last frame has itself gone unanswered for
        the timeout window. A sweep cadence slower than ``timeout_s``
        therefore asks first (ping) and convicts on the next look — a
        healthy-but-quiet fleet is never ejected, while a genuinely
        partitioned peer is declared within one probe window and its
        pending work re-admitted (never waiting on TCP retransmit
        timescales)."""
        now = self._clock()
        with self._lock:
            if self._dead_reason is not None:
                return f"dead: {self._dead_reason}"
            age = now - self._last_heard
            probe_age = now - self._last_ping
            probed_since_heard = self._last_ping > self._last_heard
            remote = self._remote["health"]
        if age > self.timeout_s:
            if probed_since_heard and probe_age > self.timeout_s:
                self._mark_dead(
                    f"unresponsive: last frame {age:.1f}s ago and a probe "
                    f"{probe_age:.1f}s ago went unanswered "
                    f"(timeout {self.timeout_s:g}s)")
                return f"dead: unresponsive for {age:.1f}s"
            if not probed_since_heard:
                self.ping()  # ask now; the next look convicts or clears
        return remote

    def is_dead(self) -> bool:
        with self._lock:
            return self._dead_reason is not None

    def stats(self, timeout: Optional[float] = 10.0
              ) -> Dict[str, Any]:  # dcnn: protocol=replica.c2s role=sender
        with self._lock:
            if self._dead_reason is not None:
                raise ReplicaDeadError(
                    f"replica {self.name} is dead: {self._dead_reason}")
            rid = self._next_id
            self._next_id += 1
            fut: Future = Future()
            self._stats[rid] = fut
        self._send("stats", {"id": rid})
        return fut.result(timeout=timeout)

    def swap(self, version,
             timeout: Optional[float] = 300.0
             ) -> None:  # dcnn: protocol=replica.c2s role=sender
        """Remote drain → load → rejoin; blocks until the server answers
        ``swapped`` or ``error`` (re-raised typed). A wait past
        ``timeout`` surfaces as :class:`SwapError` too, with the pending
        entry dropped so a late reply cannot land in an orphan."""
        with self._lock:
            if self._dead_reason is not None:
                raise ReplicaDeadError(
                    f"replica {self.name} is dead: {self._dead_reason}")
            rid = self._next_id
            self._next_id += 1
            fut: Future = Future()
            self._swaps[rid] = fut
        self._send("swap", {"id": rid, "version": version})
        exc: BaseException
        try:
            fut.result(timeout=timeout)
            return
        except ReplicaError as e:
            exc = e
        except (TimeoutError, FutureTimeoutError) as e:
            # pre-3.11 futures raise their own TimeoutError class
            with self._lock:
                self._swaps.pop(rid, None)
            exc = e
        raise SwapError(f"replica {self.name}: remote swap to "
                        f"{version!r} failed: {exc}") from exc

    def close(self) -> None:
        self._chan.close()
        self._reader.join(timeout=10.0)
        self._mark_dead("closed by router")

    def __enter__(self) -> "TcpReplica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        with self._lock:
            dead = self._dead_reason
        state = f"dead: {dead}" if dead else "up"
        return f"TcpReplica({self.name!r}, {state})"
