"""Elastic, preemption-tolerant data-parallel training (counterpart of
``dcnn_tpu/parallel/elastic.py``).

Losing one host mid-epoch must cost seconds of re-run work, not the run.
The controller composes the port's atomic checksum-verified checkpoints,
the shared retry primitive, stall-watchdog-style liveness, deterministic
fault injection and the single batch-order definition
(``BaseDataLoader.batch_indices``):

- **Membership / heartbeat** (:class:`Membership`): a full mesh of framed
  TCP channels (``parallel/comm.py``) between the data-parallel hosts.
  Every control frame is generation-stamped; peers beat each step (plus an
  optional background beat thread), and peer death is detected by
  connection close and by last-heard timeouts — never by hanging on a
  recv.
- **Lockstep DP step**: each host computes the gradient **sum** over its
  contiguous slice of a fixed *global microbatch grid* of K microbatches
  (``data_parallel.make_elastic_grad_step``), packed on the card with its
  microbatch-weighted batchnorm state into one vector, copied to the host
  once into a reused pinned buffer and shipped to the generation's leader
  (lowest surviving rank), which sums the payloads in arrival order,
  divides by K and broadcasts the one mean; every host copies it to the
  card once and applies the identical optimizer update
  (``make_elastic_apply_step``), so params stay bit-identical across hosts
  without a parameter broadcast. A world of one keeps the vector on the
  card.
- **Reconfiguration protocol** (on :class:`~.multihost.PeerLostError` or
  an incoming RECONF): survivors barrier on a new generation id, the new
  leader restores the newest valid commit of the shared checkpoint root,
  broadcasts ``RECONF{gen, survivors, ckpt_step, epoch, step}``, and each
  survivor restores into its live tensors, acks, and rebuilds its local
  step for the new world size. The batch plan is re-derived over the SAME
  K-microbatch grid, so the **global batch and the optimizer trajectory
  are fixed across the reshard** (FP reassociation of the gradient sum is
  the only difference). A second loss during recovery re-enters the
  protocol with the shrunken survivor set. A peer absent from the new
  survivor list raises :class:`EvictedError` and must exit.

What is preserved across a reshard: the global batch's membership, order
and size — exactly; the optimizer trajectory — within FP-reassociation
tolerance; per-microbatch dropout draws — yes (keys folded by *global*
microbatch index); batchnorm statistics — approximately (per-host
sequential EMA, microbatch-count-weighted mean across hosts).

Fault points, the JAX package's: ``elastic.heartbeat`` (armed with
``InjectedCrash`` = the kill-a-host simulation), ``elastic.reconfigure``
(a crash during recovery) and the delay hook ``elastic.slow_peer``
(``FaultPlan.slow``: this peer's local compute runs slow without dying).

**Straggler eviction** (``config.slow_detect``): every peer measures its
local-compute wall per step (before the exchange, which equalizes full
steps) and piggybacks it as ``wall_s`` on BEAT and GRADS frames; only the
generation leader convicts through a
:class:`~dcnn_tpu_torch.resilience.slowness.SlownessDetector`, marks the
straggler dead and reconfigures without it. A slow leader cannot evict
itself (surfaced, counted, never self-evicted).

The protocol's commands (HELLO, BEAT, GRADS, GSUM, RECONF, RECONF_ACK)
and meta keys are the JAX package's. Where the port departs from it: the
train state lives in the model's tensors, so a restore copies into them
(the grad step's CUDA graphs keep their addresses); one graph session a
local microbatch count replaces the per-count re-jit; the AOT cache holds
kernel libraries only (the port has no serializable step). As in the JAX
package, a reconfiguration runs under ``obs.anomaly.suppress()``: its
expected stall feeds neither the goodput anomaly detector's step-time
band nor a capture. ``clock`` and ``sleep`` are injectable, so a test drives
the straggler detector on a fake clock.
"""

from __future__ import annotations

import copy
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graphs import GraphPool
from ..core.keys import fold_in
from ..data.wire import decode_batch, wire_scale
from ..obs import get_registry, get_tracer
from ..resilience import faults as _faults
from ..train.trainer import (TrainState, _copy_into, create_train_state,
                             wire_aot)
from .comm import Channel, Inbox, connect, listen
from .data_parallel import make_elastic_apply_step, make_elastic_grad_step
from .multihost import PeerLostError


@dataclass(frozen=True)
class PeerSpec:
    """One data-parallel host: initial ``rank`` (stable identity for the
    whole run — survivor *positions* are re-derived per generation, ranks
    never are) and its control-plane listen address."""

    rank: int
    host: str
    port: int


def parse_peers(spec: str) -> List[PeerSpec]:
    """``"host:port,host:port,..."`` → :class:`PeerSpec` list; rank =
    position (the ``ELASTIC_PEERS`` env format)."""
    out: List[PeerSpec] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append(PeerSpec(len(out), host or "127.0.0.1", int(port)))
    return out


def microbatch_span(total: int, world: int, position: int) -> Tuple[int, int]:
    """Contiguous ``[lo, hi)`` slice of the global K-microbatch grid owned
    by survivor ``position`` of ``world`` — remainder microbatches go to
    the lowest positions, so every grid cell is owned exactly once."""
    if not 0 <= position < world:
        raise ValueError(f"position {position} outside world {world}")
    base, extra = divmod(total, world)
    lo = position * base + min(position, extra)
    hi = lo + base + (1 if position < extra else 0)
    return lo, hi


class EvictedError(RuntimeError):
    """This peer was declared dead by the surviving quorum — it must exit
    rather than fight the new generation for the checkpoint directory."""


class PreemptedError(RuntimeError):
    """This host was asked to leave the training world
    (:meth:`ElasticController.preempt`). Raised from the step loop at the
    next beat; the controller closes its membership, so the surviving
    peers observe exactly a host death and reshape."""


class WorldCollapsedError(RuntimeError):
    """Fewer survivors than ``elastic_min_world``."""


class _ReconfigureSignal(Exception):
    """Internal control flow: a RECONF frame for a newer generation
    arrived while this peer was mid-step."""

    def __init__(self, meta: Dict[str, Any]):
        self.meta = meta
        super().__init__(f"reconfigure to generation {meta.get('gen')}")


class Membership:
    """Liveness-tracked full mesh of framed channels between DP hosts.

    Peer death is detected by (a) connection close — the reader thread's
    ``on_close`` — and (b) ``check_peers()`` last-heard timeouts
    (injectable clock), which cover the hung-but-connected case. Every
    mutation of the peer tables is lock-guarded."""

    def __init__(self, rank: int, peers: List[PeerSpec], *,
                 listen_sock: Optional[socket.socket] = None,
                 heartbeat_s: float = 0.0, peer_timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, compress: bool | str = False):
        self.rank = rank
        self.peers = {p.rank: p for p in peers}
        self.compress = compress
        if rank not in self.peers:
            raise ValueError(f"rank {rank} not in peer list "
                             f"{sorted(self.peers)}")
        self.heartbeat_s = heartbeat_s
        self.peer_timeout_s = peer_timeout_s
        self._clock = clock
        self._reg = registry if registry is not None else get_registry()
        self.inbox = Inbox()
        self._listen = listen_sock
        self._lock = threading.Lock()
        self._channels: Dict[int, Channel] = {}   # dcnn: guarded_by=_lock
        # perf_counter offsets (dialer_clock - our_clock) of peers that
        # dialed us, from their HELLO stamp: the trace merge's --offset
        self._clock_offsets: Dict[int, float] = {}  # dcnn: guarded_by=_lock
        self._last_heard: Dict[int, float] = {}   # dcnn: guarded_by=_lock
        self._dead: Dict[int, float] = {}         # dcnn: guarded_by=_lock
        self._detections: List[Tuple[int, float]] = []  # dcnn: guarded_by=_lock
        self._beat_meta: Dict[str, Any] = {}      # dcnn: guarded_by=_lock
        self._closed = False                      # dcnn: guarded_by=_lock
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- bootstrap ---------------------------------------------------------
    def connect_all(self, timeout: float = 60.0) -> None:  # dcnn: protocol=elastic.hello role=sender
        # dcnn: protocol=elastic.hello role=handler
        """Establish the full mesh: dial every lower rank, accept every
        higher one (each pair has exactly one dialer), HELLO-stamp each
        connection so accepted sockets map to ranks."""
        deadline = self._clock() + timeout
        for r in sorted(self.peers):
            if r >= self.rank:
                continue
            p = self.peers[r]
            ch = connect(p.host, p.port,
                         timeout=max(deadline - self._clock(), 1.0),
                         compress=self.compress)
            ch.send("HELLO", {"rank": self.rank,
                              "t_mono": time.perf_counter()})
            self._register(r, ch)
        expected = {r for r in self.peers if r > self.rank}
        if expected and self._listen is None:
            me = self.peers[self.rank]
            self._listen = listen(me.port, host=me.host)
        while expected:
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise PeerLostError("elastic bootstrap",
                                    f"peers never connected within "
                                    f"{timeout}s", sorted(expected))
            self._listen.settimeout(remaining)
            try:
                sock, _ = self._listen.accept()
            except socket.timeout:
                continue
            ch = Channel(sock, compress=self.compress)
            sock.settimeout(max(deadline - self._clock(), 1.0))
            cmd, meta, _ = ch.recv()
            sock.settimeout(None)
            if cmd != "HELLO" or meta.get("rank") not in expected:
                ch.close()
                continue
            if "t_mono" in meta:
                off = float(meta["t_mono"]) - time.perf_counter()
                with self._lock:
                    self._clock_offsets[meta["rank"]] = off
            self._register(meta["rank"], ch)
            expected.discard(meta["rank"])
        if self._listen is not None:
            # the mesh is complete; the world only shrinks in this design
            self._listen.close()
            self._listen = None
        if self.heartbeat_s > 0:
            self._start_beat_thread()

    def _register(self, rank: int, ch: Channel) -> None:
        # kernel-level send deadline: a silently partitioned peer must
        # fail the send within peer_timeout_s (rides the mark-dead path)
        ch.set_send_timeout(self.peer_timeout_s)
        with self._lock:
            self._channels[rank] = ch
            self._last_heard[rank] = self._clock()
        self.inbox.attach(ch, on_close=lambda _c, r=rank: self._mark_dead(r))

    # -- liveness ----------------------------------------------------------
    def _mark_dead(self, rank: int) -> None:
        with self._lock:
            if self._closed or rank in self._dead:
                return
            now = self._clock()
            self._dead[rank] = now
            self._detections.append((rank, now - self._last_heard[rank]))
        self._reg.counter("elastic_peers_lost_total",
                          "DP peers lost (closed or timed out)").inc()

    def evict(self, rank: int) -> None:
        """Administratively declare ``rank`` dead — the gray-failure
        conviction path; the RECONF ``include_dead`` delivery tells the
        convicted host to exit via :class:`EvictedError`."""
        self._mark_dead(rank)

    def heard(self, rank: Optional[int]) -> None:
        if rank is None:
            return
        with self._lock:
            if rank in self._last_heard:
                self._last_heard[rank] = self._clock()

    def check_peers(self) -> List[int]:
        """Timeout-based death: peers silent for longer than
        ``peer_timeout_s`` are declared dead. Returns newly dead ranks."""
        newly: List[int] = []
        with self._lock:
            now = self._clock()
            for r in self._channels:
                if r in self._dead:
                    continue
                if now - self._last_heard[r] > self.peer_timeout_s:
                    self._dead[r] = now
                    self._detections.append((r, now - self._last_heard[r]))
                    newly.append(r)
        for _ in newly:
            self._reg.counter("elastic_peers_lost_total",
                              "DP peers lost (closed or timed out)").inc()
        return newly

    def alive(self) -> List[int]:
        """Sorted surviving ranks, always including self."""
        with self._lock:
            others = [r for r in self._channels if r not in self._dead]
        return sorted(others + [self.rank])

    def dead(self) -> Set[int]:
        with self._lock:
            return set(self._dead)

    def pop_detections(self) -> List[Tuple[int, float]]:
        """(rank, seconds-silent-before-declared-dead) pairs recorded
        since the last call."""
        with self._lock:
            out, self._detections = self._detections, []
        return out

    def clock_offsets(self) -> Dict[int, float]:
        """Per-peer perf_counter offsets from HELLO stamps (peers that
        dialed us), ``peer_clock - our_clock``."""
        with self._lock:
            return dict(self._clock_offsets)

    # -- frames ------------------------------------------------------------
    def send(self, rank: int, cmd: str, meta: Dict[str, Any],
             array=None, *, attempts: int = 3) -> None:
        """Send one frame to ``rank``; a failed (post-retry) send marks
        the peer dead and raises :class:`PeerLostError`."""
        with self._lock:
            ch = self._channels.get(rank)
            gone = rank in self._dead
        if ch is None or gone:
            raise PeerLostError(f"send {cmd}", "peer already dead", [rank])
        m = dict(meta)
        m["rank"] = self.rank
        try:
            ch.send(cmd, m, array=array, attempts=attempts)
        except OSError as e:
            self._mark_dead(rank)
            raise PeerLostError(f"send {cmd}", str(e), [rank]) from e

    def broadcast(self, cmd: str, meta: Dict[str, Any], array=None, *,
                  attempts: int = 3, include_dead: bool = False) -> List[int]:
        """Best-effort send to every live peer; returns ranks lost during
        the broadcast (marked dead, not raised). ``include_dead``: also try
        peers already marked dead whose channels are still open (RECONF,
        so a wedged peer learns it was evicted); failures to them are
        swallowed."""
        with self._lock:
            dead = set(self._dead)
            targets = [(r, ch) for r, ch in self._channels.items()
                       if include_dead or r not in dead]
        lost: List[int] = []
        for r, ch in targets:
            m = dict(meta)
            m["rank"] = self.rank
            try:
                ch.send(cmd, m, array=array, attempts=attempts)
            except OSError:
                if r not in dead:
                    self._mark_dead(r)
                    lost.append(r)
        return lost

    def set_beat_meta(self, **meta: Any) -> None:
        """What the background beat thread stamps on its BEAT frames."""
        with self._lock:
            self._beat_meta = dict(meta)

    def beat_all(self) -> None:  # dcnn: protocol=elastic.mesh role=sender frames=BEAT
        with self._lock:
            meta = dict(self._beat_meta)
        self.broadcast("BEAT", meta, attempts=1)

    def _start_beat_thread(self) -> None:
        if self._hb_thread is not None:
            return

        def loop() -> None:
            while not self._hb_stop.wait(self.heartbeat_s):
                self.beat_all()

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"dcnn-elastic-beat-{self.rank}")
        self._hb_thread.start()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Stop the beat thread and close every channel and the listener.
        Idempotent; also what a simulated host death calls."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        with self._lock:
            self._closed = True
            chans = list(self._channels.values())
            lst, self._listen = self._listen, None
        for ch in chans:
            ch.close()
        if lst is not None:
            lst.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _clone_tree(tree):
    """A detached copy of a state tree (dicts of tensors and ints)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return copy.deepcopy(tree)


class ElasticController:
    """Generation-aware elastic DP trainer over a :class:`Membership`.

    One instance per host, training ``model`` (its params and buffers, in
    place) on ``config.device_type``. ``fit`` runs the epoch loop in
    lockstep with the surviving peers and reconfigures on peer loss — see
    the module docstring for the protocol and the numerics contract.

    ``stats["exchange"]`` sums, over the steps that exchanged, the
    seconds of the copy to the host, the network (sending, waiting for the
    leader's mean or the peers' sums, broadcasting), the leader's sum and
    the copy back, and the payload bytes sent and received;
    ``stats["reconfigure_at"]`` holds the wall-clock time (``time.time``)
    each reconfiguration began. Beyond the JAX package's keys, a
    ``step_log`` entry holds the step's global mean ``loss``, its
    ``seconds`` (beat to update),
    where it exchanged that step's ``exchange``, and where the leader
    saved a checkpoint after it the save's ``save_s`` (which the peers'
    next exchange waits for)."""

    def __init__(self, model, optimizer, loss_fn: Callable, loader, *,
                 config, rank: int, peers: List[PeerSpec],
                 listen_sock: Optional[socket.socket] = None,
                 fault_plan: Optional[_faults.FaultPlan] = None,
                 feed_pool=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        from ..ops.losses import get_loss

        self.model = model
        self.optimizer = optimizer
        self.loss_fn = get_loss(loss_fn) if isinstance(loss_fn, str) \
            else loss_fn
        self.loader = loader
        self.cfg = config
        self.rank = rank
        self.device = resolve_device(config.device_type)
        self._clock = clock
        self._sleep = sleep
        self._reg = registry if registry is not None else get_registry()
        self._faults_plan = fault_plan
        self._pool = feed_pool
        self.membership = Membership(
            rank, peers, listen_sock=listen_sock,
            heartbeat_s=config.elastic_heartbeat_s,
            peer_timeout_s=config.elastic_timeout_s,
            clock=clock, registry=self._reg,
            compress=getattr(config, "elastic_compress", False))
        # the global microbatch grid K is FIXED for the run: re-partitioned
        # (never re-gridded) across whatever world survives
        self.total_microbatches = config.elastic_microbatches or len(peers)
        if loader.batch_size % self.total_microbatches:
            raise ValueError(
                f"batch_size {loader.batch_size} not divisible by the "
                f"global microbatch grid K={self.total_microbatches}")
        if self.total_microbatches % len(peers):
            raise ValueError(
                f"K={self.total_microbatches} microbatches not divisible "
                f"by the initial world size {len(peers)} — start from an "
                f"even grid (uneven shares are for degraded worlds)")
        if not getattr(loader, "drop_last", True):
            raise ValueError(
                "elastic training requires drop_last=True: a ragged tail "
                "batch cannot tile the fixed microbatch grid")
        self.mb_rows = loader.batch_size // self.total_microbatches
        if len(peers) > 1 and not config.checkpoint_dir:
            import warnings
            warnings.warn(
                "elastic training without checkpoint_dir: a peer loss "
                "rewinds ALL survivors to the initial state (epoch 1, "
                "step 0) — set checkpoint_dir (+ elastic_ckpt_steps) so "
                "a reconfiguration restores recent progress instead",
                stacklevel=2)
        if config.checkpoint_dir:
            from ..resilience.checkpoint import CheckpointManager
            self.checkpoints = CheckpointManager(
                config.checkpoint_dir, keep=config.checkpoint_keep)
        else:
            self.checkpoints = None
        self.lr = config.learning_rate
        self.gen = 0
        self.survivors = sorted(self.membership.peers)
        self.world = len(self.survivors)
        self.position = self.survivors.index(rank)
        self.reconfiguring = False
        self.history: List[Dict[str, Any]] = []
        self.step_log: List[Dict[str, Any]] = []
        self.stats: Dict[str, Any] = {
            "reconfigures": 0, "peers_lost": 0, "detection_s": [],
            "restore_s": [], "reconfigure_s": [], "steps_lost": [],
            "stragglers_evicted": 0, "reconfigure_at": [],
            "exchange": {"steps": 0, "d2h_s": 0.0, "net_s": 0.0,
                         "sum_s": 0.0, "h2d_s": 0.0, "bytes": 0}}
        self.poll_s = 0.02
        # one grad step (one graph session on CUDA) a local microbatch
        # count, sharing one memory pool
        self._grad_steps: Dict[int, Any] = {}
        self._graphs = GraphPool(self.device)
        self._apply = make_elastic_apply_step(optimizer)
        self._flat_size = 0
        self._host_out = self._host_in = self._mean = None
        self._ex_step: Optional[Dict[str, float]] = None  # this step's
        self._init_snapshot = None
        self._last_saved_step = -1
        # the leader's elastic.reconfigure span, adopted by every survivor
        # via the RECONF frame's _trace carrier
        self._gen_ctx = None
        if getattr(config, "slow_detect", False):
            from ..resilience.slowness import (SlownessConfig,
                                               SlownessDetector)
            self.slowness = SlownessDetector(
                SlownessConfig.from_env(SlownessConfig(
                    dwell_s=getattr(config, "slow_dwell_s", 1.0),
                    ratio=getattr(config, "slow_ratio", 2.0),
                    mad_k=getattr(config, "slow_mad_k", 4.0),
                    min_samples=getattr(config, "slow_min_samples", 3))),
                clock=clock)
        else:
            self.slowness = None
        self._last_wall: Optional[float] = None
        self._preempt = threading.Event()
        self._preempt_reason = "preempted"
        # the kernel libraries from the AOT cache (all it holds for a step)
        wire_aot(self.device, getattr(config, "aot_cache_dir", None))

    # -- plumbing ----------------------------------------------------------
    def _trip(self, point: str, **ctx) -> None:
        if self._faults_plan is not None:
            self._faults_plan.trip(point, **ctx)
        else:
            _faults.trip(point, **ctx)

    def _slow_sleep(self, point: str, base_s: float, **ctx) -> float:
        """Delay-injection twin of :meth:`_trip` (``FaultPlan.slow``):
        sleeps the armed extra wall inside the caller's timing window."""
        extra = _faults.slowdown(point, base_s, **ctx)
        if self._faults_plan is not None:
            extra += self._faults_plan.slowdown(point, base_s, **ctx)
        if extra > 0.0:
            self._sleep(extra)
        return extra

    @property
    def generation(self) -> int:
        return self.gen

    def is_leader(self) -> bool:
        return self.position == 0

    def preempt(self, reason: str = "device lease revoked") -> None:
        """Ask this controller to leave the world at the next step beat
        (thread-safe)."""
        self._preempt_reason = reason
        self._preempt.set()

    def _leader_rank(self) -> int:
        return self.survivors[0]

    def _local_span(self) -> Tuple[int, int]:
        return microbatch_span(self.total_microbatches, self.world,
                               self.position)

    def _build(self, ts: TrainState) -> None:
        """(Re)build the local compute for the current world/position: a
        grad step for the local microbatch count (kept a count), and the
        exchange's buffers."""
        with get_tracer().span("elastic.rebuild", track="elastic",
                               rank=self.rank, gen=self.gen,
                               world=self.world):
            lo, hi = self._local_span()
            a = hi - lo
            if a not in self._grad_steps:
                self._grad_steps[a] = make_elastic_grad_step(
                    self.model, self.loss_fn, a, pool=self._graphs)
            n = (sum(p.numel() for p in self.model.parameters())
                 + sum(b.numel() for b in self.model.buffers()
                       if b.is_floating_point()) + 1)
            if n != self._flat_size:
                dt = next(self.model.parameters()).dtype
                pin = self.device.type == "cuda"
                self._host_out = torch.empty(n, dtype=dt, pin_memory=pin)
                self._host_in = torch.empty(n - 1, dtype=dt, pin_memory=pin)
                self._mean = torch.empty(n, dtype=dt, device=self.device)
                self._flat_size = n
            self._reg.gauge("elastic_generation",
                            "current elastic generation id").set(self.gen)
            self._reg.gauge("elastic_world_size",
                            "surviving data-parallel world size"
                            ).set(self.world)

    def _epoch_plan(self, epoch: int) -> List[np.ndarray]:
        """The epoch's global batches — identical on every host for every
        world size."""
        self.loader.shuffle(epoch)
        return [np.ascontiguousarray(b, np.int64)
                for b in self.loader.batch_indices()]

    # -- fit ---------------------------------------------------------------
    def fit(self, ts: Optional[TrainState] = None,
            epochs: Optional[int] = None, val_loader=None,
            seed: Optional[int] = None, resume: bool = False
            ) -> TrainState:
        """Run the elastic epoch loop to (global) epoch ``epochs``. Without
        ``ts`` the model is initialised from ``seed`` on the config's
        device. ``resume=True`` restores the newest valid commit of the
        shared checkpoint root before the first step (the segment-restart
        path); with no commit it is a no-op."""
        seed = seed if seed is not None else self.cfg.seed
        epochs = epochs or self.cfg.epochs
        if ts is None:
            ts = create_train_state(self.model, self.optimizer,
                                    torch.Generator().manual_seed(seed),
                                    device=self.device)
        # the step-0 restore target for a loss before the first commit
        self._init_snapshot = (_clone_tree(dict(self.model.state_dict())),
                               _clone_tree(ts.opt_state))
        epoch, step = 1, 0
        gs = 0
        if resume and self.checkpoints is not None:
            epoch, step, gs, _ = self._restore(ts)
        self.membership.connect_all(
            timeout=max(self.cfg.elastic_timeout_s * 4, 30.0))
        self._build(ts)
        self._reg.gauge("elastic_reconfiguring",
                        "1 while a reconfiguration is in flight").set(0)
        try:
            while epoch <= epochs:
                plan = self._epoch_plan(epoch)
                try:
                    gs = self._run_epoch(ts, plan, epoch, step, gs, seed)
                    self._epoch_end(ts, epoch, gs, val_loader)
                    epoch, step = epoch + 1, 0
                except (PeerLostError, _ReconfigureSignal) as sig:
                    epoch, step, gs = self._reconfigure(sig, ts, gs)
        finally:
            self.membership.close()
            if self.checkpoints is not None:
                self.checkpoints.close()
        return ts

    def _run_epoch(self, ts: TrainState, plan: List[np.ndarray], epoch: int,
                   start_step: int, gs: int, seed: int) -> int:
        epoch_key = fold_in(seed, epoch)
        lo, hi = self._local_span()
        gstep = self._grad_steps[hi - lo]
        shard_iter = None
        if self._pool is not None:
            # the grid slices the compute path consumes, so an uneven
            # degraded share still feeds each host exactly its rows
            sels = [idx[lo * self.mb_rows:hi * self.mb_rows]
                    for idx in plan[start_step:]]
            shard_iter = self._pool.shards(iter(sels), epoch=epoch)
        t0 = self._clock()
        try:
            gs, loss_acc, n_steps = self._step_loop(
                ts, plan, epoch, start_step, gs, epoch_key, gstep, lo, hi,
                shard_iter)
        finally:
            if shard_iter is not None:
                # a reconfiguration abandons the iterator mid-epoch
                shard_iter.close()
        if n_steps:
            self.history.append({
                "epoch": epoch, "train_loss": loss_acc / n_steps,
                "seconds": self._clock() - t0, "world": self.world,
                "gen": self.gen, "lr": self.lr})
        return gs

    def _step_loop(self, ts: TrainState, plan: List[np.ndarray], epoch: int,
                   start_step: int, gs: int, epoch_key: int, gstep,
                   lo: int, hi: int, shard_iter):
        tracer = get_tracer()
        a = hi - lo
        scale = wire_scale(self.loader)
        loss_acc, n_steps = 0.0, 0
        for s in range(start_step, len(plan)):
            self._beat(gs)
            t_step = time.perf_counter()
            self._ex_step = {} if self.world > 1 else None
            idx = plan[s]
            sel = idx[lo * self.mb_rows:hi * self.mb_rows]
            if shard_iter is not None:
                shard = next(shard_iter)
                x, y = shard.for_put()
            else:
                shard = None
                x, y = self.loader.rows(sel)
            with tracer.span("elastic.step", track="elastic",
                             parent=self._gen_ctx, rank=self.rank,
                             gen=self.gen, step=gs):
                # local-compute wall: measured BEFORE the exchange, which
                # equalizes full-step walls across the fleet
                t_local = self._clock()
                xd = decode_batch(torch.as_tensor(x).to(self.device), scale)
                yd = torch.as_tensor(y).to(self.device)
                flat = gstep.packed(ts, xd, yd, fold_in(epoch_key, s), lo)
                flat = self._to_host(flat)
                self._slow_sleep("elastic.slow_peer",
                                 self._clock() - t_local,
                                 gen=self.gen, step=gs)
                wall = self._clock() - t_local
                self._last_wall = wall
                if self.slowness is not None:
                    self.slowness.observe(f"rank{self.rank}", wall)
                avg, mean_loss = self._exchange(flat, a, gs, wall_s=wall)
                self._check_slowness()
                self._apply_mean(ts, gstep, avg)
            if shard is not None:
                shard.release()
            gs += 1
            loss_acc += mean_loss
            n_steps += 1
            self.step_log.append({
                "gs": gs, "gen": self.gen, "world": self.world,
                "epoch": epoch, "step": s,
                "global_rows": int(len(idx)), "loss": mean_loss,
                "seconds": time.perf_counter() - t_step,
                **({"exchange": self._ex_step} if self._ex_step else {})})
            if (self.is_leader() and self.checkpoints is not None
                    and self.cfg.elastic_ckpt_steps > 0
                    and gs % self.cfg.elastic_ckpt_steps == 0):
                t_save = time.perf_counter()
                self._save(ts, epoch, s + 1, gs)
                self.step_log[-1]["save_s"] = time.perf_counter() - t_save
        if shard_iter is not None:
            if next(shard_iter, None) is not None:
                raise RuntimeError("feed pool produced more shards than "
                                   "the epoch plan")
        return gs, loss_acc, n_steps

    def _to_host(self, flat: torch.Tensor):
        """A world above one ships the packed vector: one copy into the
        reused pinned buffer (a numpy view of it is returned). A world of
        one keeps it on the card."""
        if self.world == 1:
            return flat
        if flat.is_cuda:  # the grad step done: the copy's seconds alone
            torch.cuda.current_stream(flat.device).synchronize()
        t0 = time.perf_counter()
        self._host_out.copy_(flat, non_blocking=True)
        if flat.is_cuda:
            torch.cuda.current_stream(flat.device).synchronize()
        self._ex_add(d2h_s=time.perf_counter() - t0)
        return self._host_out.numpy()

    def _ex_add(self, **seconds_or_bytes) -> None:
        """Count exchange seconds and bytes on the run's totals and on this
        step's ``step_log`` entry."""
        tot = self.stats["exchange"]
        for k, v in seconds_or_bytes.items():
            tot[k] += v
            if self._ex_step is not None:
                self._ex_step[k] = self._ex_step.get(k, 0) + v

    def _apply_mean(self, ts: TrainState, gstep, avg) -> None:
        """The broadcast mean onto the card (one copy), the batchnorm state
        replaced by it and the optimizer update on its gradients."""
        n = self._flat_size - 1
        if isinstance(avg, torch.Tensor):
            self._mean[:n].copy_(avg)
        else:
            t0 = time.perf_counter()
            np.copyto(self._host_in.numpy(), avg)
            self._mean[:n].copy_(self._host_in, non_blocking=True)
            if self._mean.is_cuda:
                # the stream was drained by the copy out: this waits for
                # the copy in alone (its seconds, and _host_in free again)
                torch.cuda.current_stream(self.device).synchronize()
            self._ex_add(h2d_s=time.perf_counter() - t0)
        grads, state, _ = gstep.unpack(self._mean)
        bufs = dict(self.model.named_buffers())
        with torch.no_grad():
            for name, v in state.items():
                bufs[name].copy_(v)
        self._apply(dict(self.model.named_parameters()), ts.opt_state,
                    grads, self.lr)
        ts.step += 1

    def _epoch_end(self, ts: TrainState, epoch: int, gs: int,
                   val_loader) -> None:
        if val_loader is not None and self.is_leader():
            from ..train.trainer import evaluate_classification
            val_loss, val_acc = evaluate_classification(
                self.model, self.loss_fn, val_loader)
            if self.history:
                self.history[-1]["val_loss"] = val_loss
                self.history[-1]["val_acc"] = val_acc
        if self.cfg.lr_decay_factor != 1.0 \
                and epoch % self.cfg.lr_decay_interval == 0:
            self.lr *= self.cfg.lr_decay_factor
        if self.is_leader() and self.checkpoints is not None:
            # epoch-boundary anchor AFTER the decay: resume trains epoch+1
            # with exactly the lr the uninterrupted run would use
            self._save(ts, epoch + 1, 0, gs)

    def _beat(self, gs: int) -> None:
        if self._preempt.is_set():
            raise PreemptedError(
                f"rank {self.rank} preempted at step {gs}: "
                f"{self._preempt_reason}")
        # the elastic.heartbeat fault point armed with InjectedCrash here
        # IS the kill-a-host simulation
        self._trip("elastic.heartbeat", gen=self.gen, step=gs)
        self.membership.set_beat_meta(gen=self.gen, step=gs,
                                      wall_s=self._last_wall)
        self.membership.beat_all()

    def _check_slowness(self) -> None:
        """Leader-only gray-failure conviction sweep: a convicted
        straggler is marked dead and surfaced as
        :class:`~.multihost.PeerLostError`."""
        det = self.slowness
        if det is None:
            return
        transitions = det.evaluate()
        if not self.is_leader():
            return
        for tr in transitions:
            if tr["to"] != "convicted":
                continue
            victim = int(str(tr["component"])[len("rank"):])
            from ..obs.flight import resolve_flight_recorder
            if victim == self.rank:
                # the leader cannot evict itself: surface the verdict and
                # keep training at the degraded rate
                self._reg.counter(
                    "elastic_slow_leader_total",
                    "leader self-convictions (surfaced, never "
                    "self-evicted)").inc()
                resolve_flight_recorder().record(
                    "straggler_convicted", registry=self._reg,
                    reasons=[f"leader rank {victim} is the straggler — "
                             f"cannot self-evict"],
                    extra={"victim": victim, "gen": self.gen,
                           "self_conviction": True,
                           "slowness": det.snapshot()})
                continue
            reason = (f"rank {victim} convicted as straggler: local wall "
                      f"EWMA {tr['ewma']:.6g}s vs fleet median "
                      f"{tr['median']:.6g}s")
            resolve_flight_recorder().record(
                "straggler_convicted", registry=self._reg,
                reasons=[reason],
                config={"slow_dwell_s": det.config.dwell_s,
                        "slow_ratio": det.config.ratio,
                        "slow_mad_k": det.config.mad_k},
                extra={"victim": victim, "gen": self.gen,
                       "slowness": det.snapshot()})
            self._reg.counter(
                "elastic_stragglers_evicted_total",
                "DP peers evicted on gray-failure conviction").inc()
            self.stats["stragglers_evicted"] += 1
            det.forget(str(tr["component"]))
            self.membership.evict(victim)
            raise PeerLostError("straggler eviction", reason, [victim])

    # -- gradient exchange -------------------------------------------------
    # dcnn: protocol=elastic.mesh role=sender
    def _exchange(self, flat, local_mb: int, gs: int,
                  wall_s: Optional[float] = None):
        """All-reduce of the packed (grad-sum ‖ scaled-state) vector over
        the surviving world via the generation leader; returns the global
        /K mean (a numpy array, or for a world of one a card tensor) and
        the mean loss. Every peer gets the bytes the leader computed once,
        so replicated state never drifts."""
        k = float(self.total_microbatches)
        loss_sum = float(flat[-1])
        if self.world == 1:
            return flat[:-1] / k, loss_sum / k
        payload_out = flat[:-1]
        self.stats["exchange"]["steps"] += 1
        deadline = self._clock() + self.cfg.elastic_timeout_s
        t0 = time.perf_counter()
        if self.is_leader():
            total = payload_out.astype(np.float32, copy=True)
            loss_total = loss_sum
            mb_total = local_mb
            expect = set(self.survivors) - {self.rank}
            t_sum = 0.0
            while expect:
                _cmd, meta, payload = self._recv(
                    {"GRADS"}, deadline, expect,
                    match=lambda m: m.get("step") == gs)
                ts0 = time.perf_counter()
                total += payload
                t_sum += time.perf_counter() - ts0
                self._ex_add(bytes=payload.nbytes)
                loss_total += float(meta["loss"])
                mb_total += int(meta["mb"])
                expect.discard(meta["rank"])
            if mb_total != self.total_microbatches:
                raise RuntimeError(
                    f"global batch integrity violated: {mb_total} of "
                    f"{self.total_microbatches} microbatches arrived for "
                    f"step {gs}")
            ts0 = time.perf_counter()
            avg = np.divide(total, np.float32(k), out=total)
            t_sum += time.perf_counter() - ts0
            mean_loss = loss_total / k
            lost = self.membership.broadcast(
                "GSUM", {"gen": self.gen, "step": gs, "loss": mean_loss},
                array=avg)
            self._ex_add(bytes=avg.nbytes * (len(self.survivors) - 1),
                         sum_s=t_sum,
                         net_s=time.perf_counter() - t0 - t_sum)
            if lost:
                raise PeerLostError("GSUM broadcast",
                                    "peer died receiving the reduced "
                                    "gradients", lost)
            return avg, mean_loss
        leader = self._leader_rank()
        self.membership.send(
            leader, "GRADS",
            {"gen": self.gen, "step": gs, "loss": loss_sum,
             "mb": local_mb, "wall_s": wall_s}, array=payload_out)
        _cmd, meta, payload = self._recv(
            {"GSUM"}, deadline, {leader},
            match=lambda m: m.get("step") == gs)
        self._ex_add(bytes=payload_out.nbytes + payload.nbytes,
                     net_s=time.perf_counter() - t0)
        return payload, float(meta["loss"])

    # dcnn: protocol=elastic.mesh role=handler frames=GRADS,GSUM,RECONF_ACK
    def _recv(self, want: Set[str], deadline: float, expect: Set[int],
              match: Optional[Callable[[Dict], bool]] = None,
              accept_reconf: bool = False):
        """Generation-aware receive: BEATs refresh liveness, stale
        generations are dropped, a RECONF for a newer generation raises
        :class:`_ReconfigureSignal` (or is returned when
        ``accept_reconf``), a dead expected peer or an expired deadline
        raises :class:`PeerLostError`."""
        while True:
            gone = self.membership.dead() & expect
            # a peer that closed after its last frame (a leader that
            # finished right after its GSUM broadcast) is judged dead only
            # once its queued frames are read
            if gone and self.membership.inbox.empty():
                raise PeerLostError(f"waiting for {sorted(want)}",
                                    "peer connection lost", sorted(gone))
            if self._clock() > deadline:
                raise PeerLostError(
                    f"waiting for {sorted(want)}",
                    f"no frame within {self.cfg.elastic_timeout_s}s at "
                    f"generation {self.gen}", sorted(expect))
            try:
                cmd, meta, payload, _ch = self.membership.inbox.get(
                    timeout=self.poll_s)
            except TimeoutError:
                # ONLY judge peer silence when the inbox is drained: a
                # long local phase leaves peers' BEATs queued unread
                self.membership.check_peers()
                continue
            self.membership.heard(meta.get("rank"))
            if self.slowness is not None:
                # feeding is universal, convicting leader-only; dead
                # peers' stale walls would re-seed a forgotten component
                w, r = meta.get("wall_s"), meta.get("rank")
                if (w is not None and r is not None
                        and r not in self.membership.dead()):
                    self.slowness.observe(f"rank{r}", float(w))
            if cmd == "BEAT":
                continue
            mgen = meta.get("gen", -1)
            if cmd == "RECONF" and mgen > self.gen:
                if accept_reconf and cmd in want:
                    return cmd, meta, payload
                raise _ReconfigureSignal(meta)
            if mgen != self.gen:
                self._reg.counter(
                    "elastic_stale_frames_total",
                    "frames dropped for generation mismatch").inc()
                continue
            if cmd in want and (match is None or match(meta)):
                return cmd, meta, payload
            self._reg.counter(
                "elastic_stale_frames_total",
                "frames dropped for generation mismatch").inc()

    # -- checkpointing -----------------------------------------------------
    def _save(self, ts: TrainState, epoch: int, step_in_epoch: int,
              gs: int) -> None:
        if gs == self._last_saved_step:
            return
        self.checkpoints.save(
            gs, self.model, ts.opt_state, self.optimizer,
            {"epoch": epoch, "step_in_epoch": step_in_epoch,
             "global_step": gs, "lr": float(self.lr),
             "elastic_gen": self.gen, "world": self.world})
        self._last_saved_step = gs

    def _restore(self, ts: TrainState, expect_step: Optional[int] = None
                 ) -> Tuple[int, int, int, int]:
        """Copy the newest valid commit (or the initial snapshot when none
        exists) into the live model and ``ts``; returns (epoch,
        step_in_epoch, global_step, ckpt_step). ``expect_step`` (from the
        leader's RECONF) cross-checks that every survivor restored the SAME
        commit."""
        t0 = self._clock()
        with get_tracer().span("elastic.restore", track="elastic",
                               rank=self.rank, gen=self.gen) as rs:
            restored = (self.checkpoints.restore_latest(device=self.device)
                        if self.checkpoints is not None else None)
            rs.set(found=restored is not None,
                   ckpt_step=getattr(restored, "step", None))
        if restored is None:
            sd, opt = self._init_snapshot
            self.model.load_state_dict(sd)
            ts.opt_state = _copy_into(ts.opt_state, _clone_tree(opt))
            epoch, step, gs, ckpt_step = 1, 0, 0, -1
            self.lr = self.cfg.learning_rate
        else:
            md = restored.metadata
            gs = int(md.get("global_step", 0))
            self.model.load_state_dict(restored.model.state_dict())
            ts.opt_state = _copy_into(ts.opt_state, restored.opt_state)
            epoch = int(md.get("epoch", 1))
            step = int(md.get("step_in_epoch", 0))
            self.lr = float(md.get("lr", self.lr))
            ckpt_step = restored.step
        ts.step = gs
        # the restored commit already exists at ckpt_step: never re-save it
        self._last_saved_step = ckpt_step
        if expect_step is not None and ckpt_step != expect_step:
            raise RuntimeError(
                f"survivors disagree on the restore point: leader restored "
                f"commit {expect_step}, this host found {ckpt_step} — the "
                f"hosts are not sharing one checkpoint root")
        self.stats["restore_s"].append(self._clock() - t0)
        return epoch, step, gs, ckpt_step

    # -- reconfiguration ---------------------------------------------------
    def _reconfigure(self, sig, ts: TrainState, gs: int
                     ) -> Tuple[int, int, int]:
        """Survive a peer loss: loop the single-shot protocol until a
        generation sticks — a second loss mid-recovery re-enters with the
        shrunken survivor set."""
        t0 = self._clock()
        self.stats["reconfigure_at"].append(time.time())
        self.reconfiguring = True
        self._reg.gauge("elastic_reconfiguring",
                        "1 while a reconfiguration is in flight").set(1)
        tracer = get_tracer()
        rspan = tracer.begin("elastic.reconfigure", track="elastic",
                             rank=self.rank, gen_from=self.gen)
        # an expected stall: fenced from the goodput anomaly detector, so a
        # planned recovery never burns a capture (obs/anomaly.py)
        from ..obs.anomaly import suppress as _anomaly_suppress
        try:
            with _anomaly_suppress():
                while True:
                    try:
                        with tracer.activate(rspan):
                            out = self._reconfigure_once(sig, ts)
                        break
                    except (PeerLostError, _ReconfigureSignal) as again:
                        sig = again
            epoch, step, new_gs = out
            if self._gen_ctx is None or self.rank == self.survivors[0]:
                self._gen_ctx = rspan.context()
            for _rank, age in self.membership.pop_detections():
                self.stats["detection_s"].append(age)
                self._reg.histogram(
                    "elastic_detection_seconds",
                    "silence before a peer was declared dead").observe(age)
            lost_steps = max(gs - new_gs, 0)
            self.stats["steps_lost"].append(lost_steps)
            self.stats["peers_lost"] = len(self.membership.dead())
            self.stats["reconfigures"] += 1
            self.stats["reconfigure_s"].append(self._clock() - t0)
            self._reg.counter("elastic_reconfigures_total",
                              "completed reconfigurations").inc()
            self._reg.counter("elastic_steps_lost_total",
                              "optimizer steps re-run after restores"
                              ).inc(lost_steps)
            if self.stats["restore_s"]:
                self._reg.histogram(
                    "elastic_restore_seconds",
                    "checkpoint restore wall during reconfiguration"
                ).observe(self.stats["restore_s"][-1])
            return epoch, step, new_gs
        finally:
            tracer.end(rspan, gen=self.gen, world=self.world)
            self.reconfiguring = False
            self._reg.gauge("elastic_reconfiguring",
                            "1 while a reconfiguration is in flight").set(0)

    # dcnn: protocol=elastic.mesh role=sender
    def _reconfigure_once(self, sig, ts: TrainState) -> Tuple[int, int, int]:
        self._trip("elastic.reconfigure", gen=self.gen)
        if isinstance(sig, _ReconfigureSignal) \
                and sig.meta.get("gen", -1) > self.gen:
            # an established quorum already moved on: join it as a
            # follower regardless of this host's own membership view
            return self._join_reconf(sig.meta, ts)
        self.membership.check_peers()
        survivors = self.membership.alive()
        floor = max(1, self.cfg.elastic_min_world)
        if len(survivors) < floor:
            raise WorldCollapsedError(
                f"{len(survivors)} survivor(s) < elastic_min_world "
                f"{floor}")
        if self.rank == survivors[0]:
            # leader: bump the generation FIRST so every frame of the old
            # generation (stragglers' GRADS too) is stale
            new_gen = self.gen + 1
            self.gen = new_gen
            epoch, step, new_gs, ckpt_step = self._restore(ts)
            meta = {"gen": new_gen, "survivors": survivors,
                    "ckpt_step": ckpt_step, "epoch": epoch,
                    "step_in_epoch": step, "global_step": new_gs,
                    "lr": self.lr}
            lost = self.membership.broadcast("RECONF", meta,
                                             include_dead=True)
            if lost:
                raise PeerLostError("RECONF broadcast", "peer died while "
                                    "joining the new generation", lost)
            expect = set(survivors) - {self.rank}
            deadline = self._clock() + self.cfg.elastic_timeout_s
            while expect:
                _cmd, m, _p = self._recv({"RECONF_ACK"}, deadline, expect)
                expect.discard(m["rank"])
        else:
            leader = survivors[0]
            deadline = self._clock() + self.cfg.elastic_timeout_s
            _cmd, meta, _p = self._recv(
                {"RECONF"}, deadline, {leader}, accept_reconf=True)
            return self._join_reconf(meta, ts)
        self.survivors = survivors
        self.world = len(survivors)
        self.position = survivors.index(self.rank)
        self._build(ts)
        return epoch, step, new_gs

    # dcnn: protocol=elastic.mesh role=sender
    def _join_reconf(self, meta: Dict[str, Any], ts: TrainState
                     ) -> Tuple[int, int, int]:
        """Adopt an established generation as a follower: restore the
        commit the leader named, ack, rebuild for the new world — under
        the leader's reconfiguration trace."""
        survivors = list(meta["survivors"])
        if self.rank not in survivors:
            raise EvictedError(
                f"rank {self.rank} excluded from generation "
                f"{meta['gen']} (survivors {survivors}) — the quorum "
                f"timed this host out; exiting")
        self.gen = int(meta["gen"])
        tracer = get_tracer()
        ctx = meta.get("_trace")
        if ctx is not None:
            self._gen_ctx = ctx
        with tracer.activate(ctx):
            epoch, step, new_gs, _ = self._restore(
                ts, expect_step=meta["ckpt_step"])
            self.lr = float(meta["lr"])
            self.membership.send(meta["rank"], "RECONF_ACK",
                                 {"gen": self.gen})
            self.survivors = survivors
            self.world = len(survivors)
            self.position = survivors.index(self.rank)
            self._build(ts)
        return epoch, step, new_gs


def elastic_fit(trainer, ts, train_loader, val_loader=None,
                epochs: Optional[int] = None,
                seed: Optional[int] = None):
    """``Trainer.fit``'s elastic delegation: build the controller from the
    trainer's model/optimizer/loss/config, wire the telemetry plane
    (``/healthz`` reports degraded while a reconfiguration is in flight),
    run, and hand the history back to the trainer."""
    cfg = trainer.config
    peers = parse_peers(cfg.elastic_peers) if cfg.elastic_peers else []
    if not peers:
        peers = [PeerSpec(0, "127.0.0.1", 0)]
    rank = cfg.elastic_rank
    if rank < 0:
        from ..utils.env import get_env
        rank = get_env("PROCESS_ID", 0)
    pool = None
    if cfg.feed_workers > 0:
        # slots sized to the full global batch: a degraded world can
        # concentrate every row on one survivor
        from ..data.workers import FeedWorkerPool
        train_loader._ensure_loaded()
        pool = FeedWorkerPool(train_loader._x, train_loader._y,
                              max_rows=train_loader.batch_size,
                              num_workers=cfg.feed_workers,
                              seed=train_loader.seed)
    controller = ElasticController(
        trainer.model, trainer.optimizer, trainer.loss_fn, train_loader,
        config=cfg, rank=rank, peers=peers, feed_pool=pool)
    trainer.elastic = controller
    telemetry = None
    try:
        if cfg.metrics_port >= 0:
            from ..obs import (TelemetryServer, elastic_check,
                               get_flight_recorder)
            telemetry = TelemetryServer(port=cfg.metrics_port)
            telemetry.set_identity(component="elastic", rank=rank)
            telemetry.attach_flight(get_flight_recorder())
            telemetry.add_check("elastic", elastic_check(controller))
            if controller.checkpoints is not None:
                from ..obs import checkpoint_check
                telemetry.add_check(
                    "checkpoint", checkpoint_check(controller.checkpoints))
            telemetry.start()
            print(f"telemetry: {telemetry.url}/metrics /healthz /snapshot",
                  flush=True)
        ts = controller.fit(ts, epochs=epochs, val_loader=val_loader,
                            seed=seed)
        trainer.history = controller.history
        return ts
    finally:
        if telemetry is not None:
            telemetry.stop()
        if pool is not None:
            pool.close()
