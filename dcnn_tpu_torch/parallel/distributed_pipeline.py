"""Multi-process pipeline coordinator over TCP stage workers (counterpart
of ``dcnn_tpu/parallel/distributed_pipeline.py``).

The coordinator owns the full model, partitions it, ships stage configs
and weights to worker processes (:mod:`.worker`), then drives the sync and
semi-async schedules by streaming microbatches into stage 0 and gradients
into stage N-1. Its public surface is the in-process coordinator's
(``deploy_stages``, ``train_batch_sync``/``_semi_async``, ``forward_only``,
``collect_load_reports``, ``gathered_params``), so a trainer swaps one for
the other; workers run the same :class:`~.pipeline.PipelineStage`, so both
give the same numbers (``tests/test_torch_distributed_pipeline.py``).

Self-healing, as in the JAX package:

- **Liveness.** Workers BEAT every ``PipelineTimeouts.heartbeat_s`` and the
  coordinator beats back. A stage silent past ``convict_s`` gets one
  HEALTH_CHECK probe; a probe unanswered past ``probe_s`` convicts it. A
  closed connection (a dead worker's kernel closing its sockets) is
  detected at once by the reader thread's ``on_close``.
- **Recovery** (:class:`StageLostError` -> ``_recover``): bump the batch
  generation (fencing both ends), sweep the original worker addresses
  (healthy channels reused, dead ones re-dialled for ``respawn_s`` so a
  respawned worker rejoins, unreachable ones dropped), then gather the
  live weights if every old stage is reachable, configured and at the
  coordinator's batch vintage, else restore the newest checksum-valid
  :class:`~dcnn_tpu_torch.resilience.checkpoint.CheckpointManager` commit
  (or the deploy-time snapshot); repartition over the survivors, re-ship
  configs, weights and optimizer state (``pipeline.weight_ship`` fault
  point), replay the batch journal past the restore point and retry the
  aborted batch: no batch is lost while the journal covers the commit
  cadence.
- **Evidence.** ``pipeline_stage_death`` and ``pipeline_rebalance`` flight
  bundles; ``pipeline_generation`` / ``pipeline_stages`` /
  ``pipeline_recovering`` / ``pipeline_stage_imbalance`` gauges;
  ``pipeline_stages_lost_total``, ``pipeline_recoveries_total``,
  ``pipeline_stage_respawns_total``, ``pipeline_replayed_batches_total``,
  ``pipeline_batches_lost_total``, ``pipeline_journal_dropped_total`` and
  ``pipeline_rebalances_total`` counters; ``pipeline_detection_seconds``
  and ``pipeline_recovery_seconds`` histograms; ``obs.server.
  pipeline_check`` degrades ``/healthz`` while a recovery is in flight.
- An ERROR_REPORT from a live worker (its own exception, a failed kernel
  launch included) raises :class:`PipelineWorkerError` after an
  ``abort()``: a deterministic remote error surfaces; it never re-deploys
  and never runs the stage elsewhere. One that names a ``lost_stage`` (a
  worker's send to, or dial of, its neighbour failed) is that
  neighbour's loss: a port addition, since a fast stage's report can
  reach the coordinator before the dead neighbour's close does.
- **Gray failure.** :meth:`maybe_rebalance` feeds measured per-stage walls
  (``collect_load_reports``; needs ``track_load``) into a
  :class:`~dcnn_tpu_torch.resilience.slowness.SlownessDetector`; a stage
  convicted as a sustained outlier triggers a rebalance through the same
  fenced machinery: live weights gathered, layer ranges re-split by the
  measured walls (:class:`~.partitioner.MeasuredPartitioner`), re-shipped.

Where the port departs from the JAX package:

- The loss and its gradient with respect to the last stage's output are
  computed on the coordinator's own device (``device=``, the card unless
  ``"cpu"``), with ``ops.losses.get_loss`` and autograd, as the in-process
  coordinator computes them on its last stage.
- A microbatch's key is the port's int key (``fold_in(rng, i)``; the stage
  folds in its id, :func:`~.pipeline.stage_key`), not JAX key data.
- ``deploy_stages(generator=None)`` ships the model's current weights when
  it has any (``interop.from_jax`` models train from the JAX weights), and
  initialises it from ``generator`` first otherwise.
- The weight blob carries params, layer state and optimizer state by name
  (``Sequential.split_params`` names; ``merge_named`` on the way back),
  bfloat16 as its 16-bit patterns, not as JAX tree leaves.
- A checkpoint commit writes the gathered weights into the coordinator's
  model and saves it (the port's ``CheckpointManager.save`` takes a model).
- The JAX package's stages rebuild their jitted functions through the AOT
  cache on a re-ship; the port's stages are eager, so a re-ship builds the
  stage from its config and installs the weights, and the kernels come
  from the build directory the process already loaded.
"""

from __future__ import annotations

import collections
import io
import json
import os as _os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..core.keys import fold_in
from ..nn.sequential import Sequential, merge_named
from ..obs import get_registry, get_tracer
from ..ops.losses import get_loss
from ..optim.optimizers import Optimizer
from ..resilience import faults as _faults
from ..resilience.slowness import SlownessConfig, SlownessDetector
from .comm import Channel, Inbox, connect, parse_addr
from .partitioner import MeasuredPartitioner, NaivePartitioner, Partitioner
from .pipeline import split_microbatches


class PipelineWorkerError(RuntimeError):
    """A stage worker reported an exception (ERROR_REPORT)."""

    def __init__(self, stage_id: int, remote_traceback: str):
        super().__init__(
            f"stage {stage_id} failed remotely:\n{remote_traceback}")
        self.stage_id = stage_id
        self.remote_traceback = remote_traceback


class StageLostError(RuntimeError):
    """A stage worker died (connection closed, send failed, or convicted
    by probe-then-convict): the recovery trigger. Distinct from
    :class:`PipelineWorkerError`, a live worker's own exception, which is
    never recovered by re-deploying."""

    def __init__(self, stage_id: int, reason: str):
        super().__init__(f"stage {stage_id} lost: {reason}")
        self.stage_id = stage_id
        self.reason = reason


class PipelineCollapsedError(RuntimeError):
    """Fewer reachable workers than ``min_stages`` after a recovery
    sweep."""


@dataclass(frozen=True)
class PipelineTimeouts:
    """The coordinator/worker timeout contract: every wait on either end
    derives from these fields.

    - ``batch_s``: deadline of any single protocol wait (the ``timeout=``
      constructor argument maps here).
    - ``heartbeat_s``: BEAT cadence, both directions; ``0`` turns liveness
      off and every wait is a single ``batch_s`` wait.
    - ``convict_s`` (default ``5 × heartbeat_s``): stage silence before a
      probe; ``probe_s`` (default ``3 × heartbeat_s``): an unanswered probe
      older than this convicts.
    - ``worker_coord_timeout_s`` (default ``convict_s + probe_s``):
      coordinator silence before a worker drops it and listens for a
      replacement; shipped inside CONFIG_TRANSFER.
    - ``drain_s`` (default ``max(2 × heartbeat_s, 2.0)``): abort-ack drain.
    - ``poll_s``: inbox poll granularity while liveness is on.
    - ``connect_s``: bootstrap dial-in budget a worker; ``respawn_s``: how
      long a recovery sweep re-dials a dead worker's address.
    - ``idle_poll_s``: the worker's idle inbox poll with liveness off.
    """

    batch_s: float = 120.0
    heartbeat_s: float = 1.0
    convict_s: Optional[float] = None
    probe_s: Optional[float] = None
    worker_coord_timeout_s: Optional[float] = None
    drain_s: Optional[float] = None
    poll_s: float = 0.05
    connect_s: float = 60.0
    respawn_s: float = 5.0
    idle_poll_s: float = 60.0

    def convict(self) -> float:
        return self.convict_s if self.convict_s is not None \
            else 5.0 * self.heartbeat_s

    def probe(self) -> float:
        return self.probe_s if self.probe_s is not None \
            else 3.0 * self.heartbeat_s

    def coord_timeout(self) -> float:
        return self.worker_coord_timeout_s \
            if self.worker_coord_timeout_s is not None \
            else self.convict() + self.probe()

    def drain(self) -> float:
        return self.drain_s if self.drain_s is not None \
            else max(2.0 * self.heartbeat_s, 2.0)


# -- the weight blob: params, layer state and optimizer state by name -----

def _leaf(v) -> Tuple[np.ndarray, str]:
    """A blob entry: a tensor (``"t"``; bfloat16 as its bits, ``"bf16"``),
    an int (``"int"``, Adam's step) or a float (``"float"``)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bf16"
        return t.numpy(), "t"
    if isinstance(v, (bool, int, np.integer)):
        return np.asarray(int(v), np.int64), "int"
    if isinstance(v, (float, np.floating)):
        return np.asarray(float(v), np.float64), "float"
    return np.asarray(v), "t"


def _from_leaf(a: np.ndarray, kind: str):
    if kind == "int":
        return int(a)
    if kind == "float":
        return float(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if kind == "bf16" else t


def _pack_weights(params: Mapping[str, Any], state: Mapping[str, Any],
                  opt_state: Optional[Mapping[str, Any]] = None) -> bytes:
    """One npz blob of a stage's (or the model's) params, layer state and,
    optionally, optimizer state, each entry under its name; the index
    (``__index__``, JSON) lists ``[section, key, name, kind]`` per array.
    Tensors on a card are copied on the current stream."""
    index: List[list] = []
    arrays: Dict[str, np.ndarray] = {}

    def put(section, key, name, value):
        a, kind = _leaf(value)
        arrays[f"a{len(index)}"] = a
        index.append([section, key, name, kind])

    for n, v in params.items():
        put("p", None, n, v)
    for n, v in state.items():
        put("s", None, n, v)
    for k, v in (opt_state or {}).items():
        if isinstance(v, Mapping):
            for n, t in v.items():
                put("o", k, n, t)
        else:
            put("o", k, None, v)
    meta = {"entries": index, "opt": opt_state is not None,
            "opt_maps": sorted(k for k, v in (opt_state or {}).items()
                               if isinstance(v, Mapping))}
    buf = io.BytesIO()
    np.savez(buf, __index__=np.asarray(json.dumps(meta)), **arrays)
    return buf.getvalue()


def _unpack_weights(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, Any],
                                          Optional[Dict[str, Any]]]:
    """Inverse of :func:`_pack_weights`: ``(params, state, opt_state)`` as
    host tensors under their names; ``opt_state`` None when the blob
    carried none."""
    npz = np.load(io.BytesIO(blob), allow_pickle=False)
    meta = json.loads(str(npz["__index__"]))
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    opt: Dict[str, Any] = {k: {} for k in meta["opt_maps"]}
    for i, (section, key, name, kind) in enumerate(meta["entries"]):
        v = _from_leaf(npz[f"a{i}"], kind)
        if section == "p":
            params[name] = v
        elif section == "s":
            state[name] = v
        elif name is None:
            opt[key] = v
        else:
            opt[key][name] = v
    return params, state, (opt if meta["opt"] else None)


def _host_named(named) -> Dict[str, torch.Tensor]:
    """Own host copies of ``named`` (a live model's tensors are updated in
    place)."""
    return {n: t.detach().to("cpu", copy=True) for n, t in dict(named).items()}


class DistributedPipelineCoordinator:
    def __init__(self, model: Sequential, optimizer: Optimizer, loss: str,
                 workers: Sequence[str],
                 partitioner: Optional[Partitioner] = None,
                 num_microbatches: int = 4,
                 track_load: "bool | str" = False,
                 compress: "bool | str" = False, timeout: float = 120.0,
                 *, device: DeviceLike = None,
                 timeouts: Optional[PipelineTimeouts] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 8, checkpoint_keep: int = 3,
                 recover: bool = True, max_recoveries: int = 8,
                 min_stages: int = 1, journal_limit: int = 64,
                 fault_plan: Optional[_faults.FaultPlan] = None,
                 slow_config: Optional[SlownessConfig] = None,
                 flight=None, clock=time.monotonic, registry=None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = get_loss(loss)
        self.device = resolve_device(device)
        self.worker_addrs = list(workers)     # the original list, immutable
        self.active_addrs = list(workers)     # index == current stage id
        self.num_stages = len(self.worker_addrs)
        self.partitioner = partitioner or NaivePartitioner()
        self.num_microbatches = num_microbatches
        self.track_load = track_load
        self.compress = compress
        self.t = timeouts if timeouts is not None \
            else PipelineTimeouts(batch_s=timeout)
        self.timeout = self.t.batch_s
        self.recover = recover
        self.max_recoveries = max_recoveries
        self.min_stages = max(min_stages, 1)
        self.checkpoint_every = checkpoint_every
        self.journal_limit = journal_limit
        if checkpoint_dir:
            from ..resilience.checkpoint import CheckpointManager
            self.checkpoints = CheckpointManager(checkpoint_dir,
                                                 keep=checkpoint_keep)
        else:
            self.checkpoints = None
        self._faults_plan = fault_plan
        self._flight = flight
        self._clock = clock
        self._reg = registry if registry is not None else get_registry()
        self.inbox = Inbox()
        self.chans: List[Channel] = []
        self.partitions: List[Tuple[int, int]] = []
        # batch generation: bumped on abort; both ends drop messages of a
        # dead generation, so in-flight stragglers cannot poison a batch
        self._gen = 0
        # completed batches: the commits' vintage, the journal's coordinate
        self._batch = 0
        self._journal: "collections.deque[Dict[str, Any]]" = \
            collections.deque()
        # messages a buffering join (health_check) deferred: _recv takes
        # them before the socket inbox, so none is lost
        self._deferred = collections.deque()
        # liveness state, shared with the comm reader threads (_on_close)
        # and the beat thread
        self._lock = threading.Lock()
        self._live_enabled = self.t.heartbeat_s > 0
        self._chan_sid: Dict[int, int] = {}  # dcnn: guarded_by=_lock
        self._last_heard: Dict[int, float] = {}  # dcnn: guarded_by=_lock
        self._probe_at: Dict[int, float] = {}  # dcnn: guarded_by=_lock
        self._dead: Dict[int, float] = {}  # dcnn: guarded_by=_lock
        self._detections: List[Tuple[int, float]] = []  # dcnn: guarded_by=_lock
        self._closed = False  # dcnn: guarded_by=_lock
        self._beat_stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None
        self.recovering = False
        self._init_weights = None                 # the last-resort restore
        # gray-failure rebalance: stages are unique, so min_peers relaxes
        # to 2 (a fleet-wide slowdown still leaves no outlier)
        self.slowness = SlownessDetector(
            SlownessConfig.from_env(
                slow_config if slow_config is not None
                else SlownessConfig(min_peers=2)),
            clock=clock)
        self.stats: Dict[str, Any] = {
            "recoveries": 0, "respawns": 0, "detection_s": [],
            "recovery_s": [], "replayed_batches": 0, "batches_lost": 0,
            "rebalances": 0}

    # -- plumbing ----------------------------------------------------------
    def _trip(self, point: str, **ctx) -> None:
        if self._faults_plan is not None:
            self._faults_plan.trip(point, **ctx)
        else:
            _faults.trip(point, **ctx)

    @property
    def generation(self) -> int:
        return self._gen

    # -- deploy --
    def deploy_stages(self, generator: Optional[torch.Generator] = None
                      ) -> None:  # dcnn: protocol=pipe.c2w role=sender
        """Connect to every worker, partition and ship each stage its
        config and weights. The model is initialised from ``generator`` on
        the coordinator's device first when one is given or it has no
        parameters yet; otherwise its current weights are shipped."""
        if generator is not None or next(self.model.parameters(),
                                         None) is None:
            self.model.init(generator=generator, device=self.device)
        params = _host_named(self.model.named_parameters())
        state = _host_named(self.model.named_buffers())
        # the restore target for a loss before the first commit (batch 0)
        self._init_weights = {"p": params, "s": state,
                              "o": self.optimizer.init(params)}

        alive: List[Tuple[str, Channel]] = []
        for addr in self.worker_addrs:
            host, port = parse_addr(addr)
            chan = connect(host, port, timeout=self.t.connect_s,
                           compress=self.compress)
            chan.send("HELLO", {"role": "coordinator"})
            if self._live_enabled:
                chan.set_send_timeout(self.t.convict() + self.t.probe())
            self.inbox.attach(chan, on_close=self._on_close)
            alive.append((addr, chan))
        self._install_workers(alive)
        self._ship_stages(params, state, None)
        self._start_beat()

    def _install_workers(self, alive: List[Tuple[str, Channel]]) -> None:
        """Adopt (addr, chan) as the stage set (index == stage id) and reset
        the liveness tables."""
        self.active_addrs = [a for a, _ in alive]
        self.chans = [c for _, c in alive]
        self.num_stages = len(self.chans)
        with self._lock:
            now = self._clock()
            self._chan_sid = {id(c): i for i, c in enumerate(self.chans)}
            self._last_heard = {i: now for i in range(len(self.chans))}
            self._probe_at = {}
            self._dead = {}
        self._reg.gauge("pipeline_stages",
                        "current pipeline stage count").set(self.num_stages)
        self._reg.gauge("pipeline_generation",
                        "current pipeline batch generation").set(self._gen)

    def _ship_stages(self, params, state, opt_state) -> None:  # dcnn: protocol=pipe.c2w role=sender
        """(Re)partition over the current workers and ship configs and
        weights (and, on a recovery or rebalance, the optimizer state,
        split by ``Optimizer.split_state``, so momentum survives a
        repartition). The ``pipeline.weight_ship`` fault point fires per
        stage before its send: armed with ``exc=OSError`` it is a torn
        weight ship."""
        self.partitions = self.partitioner.get_partitions(self.model,
                                                          self.num_stages)
        stage_models = self.model.split(self.partitions)
        sp = self.model.split_params(params, self.partitions)
        ss = self.model.split_params(state, self.partitions)
        so = (self.optimizer.split_state(opt_state, self.partitions)
              if opt_state is not None else [None] * self.num_stages)
        for sid in range(self.num_stages):
            blob = _pack_weights(sp[sid], ss[sid], so[sid])
            meta = {
                "stage_id": sid,
                "is_first": sid == 0,
                "is_last": sid == self.num_stages - 1,
                # echoed in WEIGHTS, so a gather can prove the worker holds
                # the coordinator's partitioning
                "layers": list(self.partitions[sid]),
                "model": stage_models[sid].get_config(),
                "optimizer": self.optimizer.get_config(),
                "track_load": self.track_load,
                "next_addr": (self.active_addrs[sid + 1]
                              if sid < self.num_stages - 1 else None),
                "gen": self._gen,
                "batch": self._batch,
                "heartbeat_s": self.t.heartbeat_s,
                "coord_timeout_s": (self.t.coord_timeout()
                                    if self._live_enabled else 0.0),
                # next-hop dial budget: short under liveness (a hop dead
                # inside it re-enters recovery through ERROR_REPORT)
                "connect_s": (max(self.t.respawn_s, 2.0)
                              if self._live_enabled else self.t.connect_s),
            }
            try:
                self._trip("pipeline.weight_ship", stage=sid)
                self.chans[sid].send("CONFIG_TRANSFER", meta, raw=blob)
            except OSError as e:
                self._mark_dead(sid, f"weight ship failed: {e}")
                raise StageLostError(sid, f"weight ship failed: {e}") from e
        self._join("CONFIG_RECEIVED", self.num_stages, buffer_others=True)

    # -- liveness ----------------------------------------------------------
    def _on_close(self, chan: Channel) -> None:
        with self._lock:
            sid = self._chan_sid.get(id(chan))
            if sid is None or self._closed or sid in self._dead:
                return
            now = self._clock()
            self._dead[sid] = now
            self._detections.append(
                (sid, now - self._last_heard.get(sid, now)))
        self._reg.counter("pipeline_stages_lost_total",
                          "pipeline stage workers lost").inc()

    def _mark_dead(self, sid: int, reason: str) -> None:
        with self._lock:
            if sid in self._dead or self._closed:
                return
            now = self._clock()
            self._dead[sid] = now
            self._detections.append(
                (sid, now - self._last_heard.get(sid, now)))
        self._reg.counter("pipeline_stages_lost_total",
                          "pipeline stage workers lost").inc()

    def _heard(self, chan: Optional[Channel]) -> None:
        if chan is None or not getattr(self, "_live_enabled", False):
            return
        with self._lock:
            sid = self._chan_sid.get(id(chan))
            if sid is not None:
                self._last_heard[sid] = self._clock()
                self._probe_at.pop(sid, None)

    def _check_liveness(self) -> None:  # dcnn: protocol=pipe.c2w role=sender
        """Probe-then-convict: silence past ``convict_s`` sends one
        HEALTH_CHECK probe, a probe unanswered for ``probe_s`` convicts; a
        closed connection or a failed send is immediate. Raises
        :class:`StageLostError` for the first dead stage found."""
        if not getattr(self, "_live_enabled", False):
            return
        probes: List[int] = []
        lost: Optional[Tuple[int, str]] = None
        convicted = False  # this call moved the stage into _dead
        with self._lock:
            now = self._clock()
            for sid in range(len(self.chans)):
                if sid in self._dead:
                    lost = (sid, "connection closed or send failed")
                    break
                silent = now - self._last_heard.get(sid, now)
                probed = self._probe_at.get(sid)
                if probed is not None and now - probed > self.t.probe():
                    self._dead[sid] = now
                    self._detections.append((sid, silent))
                    convicted = True
                    lost = (sid, f"unanswered probe after {silent:.2f}s "
                                 f"of silence")
                    break
                if probed is None and silent > self.t.convict():
                    self._probe_at[sid] = now
                    probes.append(sid)
        if lost is not None:
            if convicted:
                self._reg.counter("pipeline_stages_lost_total",
                                  "pipeline stage workers lost").inc()
            raise StageLostError(*lost)
        for sid in probes:
            # nonce "probe": _recv drops the ack once it refreshed last-heard
            try:
                self.chans[sid].send("HEALTH_CHECK", {"nonce": "probe"},
                                     attempts=1)
            except OSError as e:
                self._mark_dead(sid, f"probe send failed: {e}")
                raise StageLostError(sid, f"probe send failed: {e}") from e

    def _beat_targets(self) -> List[Channel]:
        with self._lock:
            return [c for i, c in enumerate(self.chans)
                    if i not in self._dead]

    def _start_beat(self) -> None:
        """Coordinator -> worker BEATs, which the workers' own conviction of
        a dead coordinator listens for; stopped by :meth:`shutdown`."""
        if not self._live_enabled or self._beat_thread is not None:
            return
        self._beat_stop = threading.Event()
        stop = self._beat_stop

        def loop() -> None:  # dcnn: protocol=pipe.c2w role=sender
            while not stop.wait(self.t.heartbeat_s):
                for ch in self._beat_targets():
                    try:
                        ch.send("BEAT", {"gen": self._gen}, attempts=1)
                    except OSError:
                        pass  # on_close or the next probe handles it
        self._beat_thread = threading.Thread(
            target=loop, daemon=True, name="dcnn-pipe-coord-beat")
        self._beat_thread.start()

    # -- fenced receive: drops messages of aborted generations --
    # dcnn: protocol=pipe.w2c role=handler
    def _recv(self) -> Tuple[str, Dict, Any]:
        clock = getattr(self, "_clock", time.monotonic)
        deadline = clock() + self.timeout
        while True:
            if self._deferred:
                c, meta, payload = self._deferred.popleft()
            else:
                self._check_liveness()
                poll = (self.t.poll_s
                        if getattr(self, "_live_enabled", False)
                        else self.timeout)
                try:
                    c, meta, payload, chan = self.inbox.get(
                        timeout=min(poll, max(deadline - clock(), 1e-3)))
                except TimeoutError:
                    if clock() >= deadline:
                        raise TimeoutError(
                            f"no message within {self.timeout}s") from None
                    continue
                self._heard(chan)
                if c == "BEAT":
                    continue
            if c == "ABORTED":
                continue  # abort()'s drain consumes these; a leftover
            g = meta.get("gen")
            if c in ("FORWARD_RESULT", "BACKWARD_DONE", "ERROR_REPORT",
                     "CONFIG_RECEIVED", "PARAMETERS_UPDATED") and \
                    g is not None and g != self._gen:
                continue  # a straggler of a dead batch or an old deploy
            if c == "HEALTH_ACK" and \
                    meta.get("nonce") != getattr(self, "_health_nonce", None):
                continue  # a probe's or a timed-out round's ack
            if c == "WEIGHTS" and \
                    meta.get("nonce") != getattr(self, "_gather_nonce", None):
                continue
            if c in ("PROFILING_REPORT", "PROFILING_CLEARED") and \
                    meta.get("nonce") != getattr(self, "_profiling_nonce", None):
                continue
            if c == "LOAD_REPORT" and \
                    meta.get("nonce") != getattr(self, "_load_nonce", None):
                continue
            if c == "ERROR_REPORT":
                lost = meta.get("lost_stage")
                if lost is not None and 0 <= lost < len(self.chans):
                    # a neighbour's link failed: that stage's loss, which
                    # may reach us before its own connection's close
                    self._mark_dead(lost, "lost by a neighbour")
                    raise StageLostError(lost, f"stage {meta.get('stage_id')}"
                                               f" lost its link to it")
                self.abort()
                raise PipelineWorkerError(meta.get("stage_id", -1),
                                          meta.get("error", "?"))
            return c, meta, payload

    def _join(self, cmd: str, count: int,
              buffer_others: bool = False) -> List[Tuple[Dict, Any]]:
        """Collect ``count`` messages of kind ``cmd``. With
        ``buffer_others`` (health probes, weight gathers, config acks),
        other messages are deferred for the next join, not protocol
        errors; they re-enter through _recv, fenced as ever."""
        got: List[Tuple[Dict, Any]] = []
        deferred: List[Tuple[str, Dict, Any]] = []
        try:
            while len(got) < count:
                c, meta, payload = self._recv()
                if c == cmd:
                    got.append((meta, payload))
                elif buffer_others:
                    deferred.append((c, meta, payload))
                else:
                    raise RuntimeError(f"expected {cmd}, got {c}")
        finally:
            self._deferred.extend(deferred)
        return got

    def _send_stage(self, sid: int, cmd: str,
                    meta: Optional[Dict[str, Any]] = None,
                    array=None, raw: Optional[bytes] = None) -> None:
        """Send to stage ``sid``; a failed send marks it dead and raises
        :class:`StageLostError`."""
        try:
            self.chans[sid].send(cmd, meta, array=array, raw=raw)
        except OSError as e:
            self._mark_dead(sid, f"send {cmd} failed: {e}")
            raise StageLostError(sid, f"send {cmd} failed: {e}") from e

    # -- schedules (the in-process coordinator's numbers) --
    # dcnn: protocol=pipe.c2w role=sender
    def _send_forward(self, mb_id: int, x, key: int,
                      training: bool = True) -> None:
        self._send_stage(0, "FORWARD_JOB", {
            "mb_id": mb_id, "gen": self._gen, "rng": int(key),
            "training": training}, array=x)

    def _loss_and_grad(self, payload, target):
        """The microbatch's loss times its size (a device scalar), the
        loss's gradient with respect to the output, and the output, on the
        coordinator's device."""
        out = torch.as_tensor(payload).to(self.device)
        leaf = out.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss_fn(leaf, target)
        (g,) = torch.autograd.grad(loss, leaf)
        return loss.detach() * out.shape[0], g, out

    def train_batch_sync(self, x, y, lr, rng: Optional[int] = None
                         ) -> Tuple[float, torch.Tensor]:
        """GPipe: every microbatch's forward, then every backward, then one
        update. Returns (mean loss, logits on the coordinator's device)."""
        return self._train_batch(x, y, lr, rng, "sync")

    def train_batch_semi_async(self, x, y, lr, rng: Optional[int] = None
                               ) -> Tuple[float, torch.Tensor]:
        """Each microbatch's backward is sent the moment its forward result
        arrives; later microbatches' forwards are already downstream."""
        return self._train_batch(x, y, lr, rng, "semi_async")

    def _train_batch(self, x, y, lr, rng, schedule: str):
        rng = 0 if rng is None else int(rng)
        fn = (self._batch_sync if schedule == "sync"
              else self._batch_semi_async)
        out = self._with_recovery(lambda: fn(x, y, lr, rng))
        self._batch += 1
        self._journal_append(x, y, lr, rng, schedule)
        if (self.checkpoints is not None and self.checkpoint_every > 0
                and self._batch % self.checkpoint_every == 0):
            # a death during the commit's gather re-enters recovery (which
            # replays this batch from the journal) and retries the commit
            self._with_recovery(self._commit)
        return out

    def _targets(self, y) -> List[torch.Tensor]:
        return split_microbatches(torch.as_tensor(y).to(self.device),
                                  self.num_microbatches)

    @staticmethod
    def _finish(losses: Dict[int, torch.Tensor],
                outputs: Dict[int, torch.Tensor], n: int):
        order = sorted(outputs)
        total = sum(torch.stack([losses[i] for i in order]).tolist())
        return total / n, torch.cat([outputs[i] for i in order])

    # dcnn: protocol=pipe.c2w role=sender
    def _batch_sync(self, x, y, lr, rng: int, bno: Optional[int] = None):
        bno = bno if bno is not None else self._batch + 1
        mb_x = split_microbatches(x, self.num_microbatches)
        mb_y = self._targets(y)
        for i, mx in enumerate(mb_x):
            self._send_forward(i, mx, fold_in(rng, i))
        results = self._join("FORWARD_RESULT", len(mb_x))
        payloads = {m["mb_id"]: p for m, p in results}
        losses: Dict[int, torch.Tensor] = {}
        outputs: Dict[int, torch.Tensor] = {}
        for i, my in enumerate(mb_y):
            losses[i], grad, outputs[i] = self._loss_and_grad(payloads[i], my)
            self._send_stage(self.num_stages - 1, "BACKWARD_JOB",
                             {"mb_id": i, "gen": self._gen}, array=grad)
        self._join("BACKWARD_DONE", len(mb_x))
        self.update_parameters(lr, batch=bno)
        return self._finish(losses, outputs, x.shape[0])

    # dcnn: protocol=pipe.c2w role=sender
    def _batch_semi_async(self, x, y, lr, rng: int,
                          bno: Optional[int] = None):
        bno = bno if bno is not None else self._batch + 1
        mb_x = split_microbatches(x, self.num_microbatches)
        mb_y = self._targets(y)
        losses: Dict[int, torch.Tensor] = {}
        outputs: Dict[int, torch.Tensor] = {}
        backwards_done = 0
        for i, mx in enumerate(mb_x):
            self._send_forward(i, mx, fold_in(rng, i))
        while backwards_done < len(mb_x):
            cmd, meta, payload = self._recv()
            if cmd == "FORWARD_RESULT":
                i = meta["mb_id"]
                losses[i], grad, outputs[i] = self._loss_and_grad(payload,
                                                                  mb_y[i])
                self._send_stage(self.num_stages - 1, "BACKWARD_JOB",
                                 {"mb_id": i, "gen": self._gen}, array=grad)
            elif cmd == "BACKWARD_DONE":
                backwards_done += 1
            else:
                raise RuntimeError(
                    f"unexpected {cmd} during semi-async batch")
        self.update_parameters(lr, batch=bno)
        return self._finish(losses, outputs, x.shape[0])

    def forward_only(self, x, training: bool = False) -> torch.Tensor:
        """The chained forward in eval mode (key 0), whatever ``training``
        says, as in the in-process coordinator: the output on the
        coordinator's device."""
        def run():
            self._send_forward(-1, x, 0, training=False)
            [(_, payload)] = self._join("FORWARD_RESULT", 1)
            return torch.as_tensor(payload).to(self.device)
        return self._with_recovery(run)

    # -- parameter update broadcast --
    # dcnn: protocol=pipe.c2w role=sender
    def update_parameters(self, lr, batch: Optional[int] = None) -> None:
        for sid in range(self.num_stages):
            meta = {"lr": float(lr)}
            if batch is not None:
                meta["batch"] = int(batch)
            self._send_stage(sid, "UPDATE_PARAMETERS", meta)
        self._join("PARAMETERS_UPDATED", self.num_stages)

    # -- nonce-fenced rounds --
    # dcnn: protocol=pipe.c2w role=sender frames=LOAD_REPORT_REQUEST,PRINT_PROFILING,CLEAR_PROFILING,GATHER_WEIGHTS,HEALTH_CHECK
    def _round(self, request: str, reply: str, attr: str,
               count: Optional[int] = None) -> List[Tuple[Dict, Any]]:
        """Broadcast ``request`` under a fresh nonce kept in ``attr`` and
        join ``count`` (every stage) ``reply`` messages: a reply of a
        timed-out earlier round never satisfies this one."""
        count = self.num_stages if count is None else count
        nonce = int.from_bytes(_os.urandom(4), "little")
        setattr(self, attr, nonce)
        try:
            for sid in range(count):
                self._send_stage(sid, request, {"nonce": nonce})
            return self._join(reply, count, buffer_others=True)
        finally:
            setattr(self, attr, None)

    def collect_load_reports(self) -> List[Dict[str, float]]:  # dcnn: protocol=pipe.c2w role=sender
        got = self._round("LOAD_REPORT_REQUEST", "LOAD_REPORT", "_load_nonce")
        by_stage = {m["stage_id"]: m["report"] for m, _ in got}
        return [by_stage[i] for i in range(self.num_stages)]

    # -- gray-failure rebalance --
    def stage_walls(self) -> List[float]:
        """Measured per-stage wall (mean forward + backward ms) from one
        load-report round; unmeasured stages report 0."""
        reports = self.collect_load_reports()
        return [float(r.get("avg_forward_ms", 0.0))
                + float(r.get("avg_backward_ms", 0.0)) for r in reports]

    def maybe_rebalance(self) -> bool:
        """Feed the measured walls to the slowness detector; once a stage
        is convicted as a sustained outlier, repartition by the walls
        through the recovery machinery (live weights gathered, exact
        momentum, no rewind). Call between batches. True iff a rebalance
        shipped."""
        walls = self.stage_walls()
        measured = [w for w in walls if w > 0.0]
        if measured:
            s = sorted(measured)
            mid = len(s) // 2
            med = s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])
            self._reg.gauge(
                "pipeline_stage_imbalance",
                "max/median measured per-stage wall ratio").set(
                    max(measured) / med if med > 0 else 0.0)
        for sid, w in enumerate(walls):
            if w > 0.0:
                self.slowness.observe(f"stage{sid}", w)
        convicted = [tr for tr in self.slowness.evaluate()
                     if tr["to"] == "convicted"]
        if not convicted:
            return False
        from ..obs.flight import resolve_flight_recorder
        resolve_flight_recorder(self._flight).record(
            "pipeline_rebalance",
            reasons=[f"{tr['component']} wall {tr['ewma']:.2f}ms vs "
                     f"fleet median {tr['median']:.2f}ms — sustained "
                     f"outlier" for tr in convicted],
            config={"generation": self._gen, "batch": self._batch,
                    "stages": self.num_stages,
                    "partitions": [list(p) for p in self.partitions]},
            extra={"walls_ms": walls,
                   "slowness": self.slowness.snapshot()},
            registry=self._reg)
        ok = self._with_recovery(lambda: self._do_rebalance(walls))
        if ok:
            self.stats["rebalances"] += 1
            self._reg.counter(
                "pipeline_rebalances_total",
                "gray-failure layer-range rebalances shipped").inc()
            for sid in range(len(walls)):
                self.slowness.forget(f"stage{sid}")
        return ok

    def _do_rebalance(self, walls: List[float]) -> bool:
        part = MeasuredPartitioner(self.partitions, walls)
        new_parts = part.get_partitions(self.model, self.num_stages)
        if new_parts == self.partitions:
            return False
        full = self._assemble_full(self._gather_stage_blobs(),
                                   self.partitions, expect_batch=self._batch)
        if full is None:
            return False  # an inconsistent gather between batches
        params, state, opt = full
        self.abort()  # generation bump: the recovery's straggler fence
        # the measured cost model stays: later repartitions reuse it
        self.partitioner = part
        self._ship_stages(params, state, opt)
        return True

    # -- per-layer profiling broadcast --
    def collect_profiling(self) -> List[Dict[str, Any]]:
        """Every worker replays its latest microbatch through the fenced
        per-layer profiler and returns its table, ordered by stage. Run
        between batches."""
        got = self._round("PRINT_PROFILING", "PROFILING_REPORT",
                          "_profiling_nonce")
        by_stage = {m["stage_id"]: m["profile"] for m, _ in got}
        return [by_stage[i] for i in range(self.num_stages)]

    def clear_profiling(self) -> None:
        self._round("CLEAR_PROFILING", "PROFILING_CLEARED",
                    "_profiling_nonce")

    # -- weight gather --
    def _gather_stage_blobs(self) -> List[Tuple[Dict, Any]]:  # dcnn: protocol=pipe.c2w role=sender
        return self._round("GATHER_WEIGHTS", "WEIGHTS", "_gather_nonce",
                           count=len(self.chans))

    def _assemble_full(self, replies: List[Tuple[Dict, Any]],
                       partitions: List[Tuple[int, int]],
                       expect_batch: Optional[int]):
        """The full model's (params, state, opt_state) from the stages'
        WEIGHTS blobs, or None when the set is incomplete, unconfigured, at
        mixed batch vintages, on another partitioning or holding other
        names: the caller then restores a commit instead."""
        by_sid: Dict[int, Tuple[Dict, Any]] = {}
        for meta, payload in replies:
            if not meta.get("configured"):
                return None
            by_sid[meta["stage_id"]] = (meta, payload)
        if set(by_sid) != set(range(len(partitions))):
            return None
        vintages = {m.get("batch") for m, _ in by_sid.values()}
        if expect_batch is not None and vintages != {expect_batch}:
            return None
        for sid, (start, end) in enumerate(partitions):
            if by_sid[sid][0].get("layers") != [start, end]:
                return None
        want_p = self.model.split_params(
            dict(self.model.named_parameters()), partitions)
        want_s = self.model.split_params(
            dict(self.model.named_buffers()), partitions)
        ps, ss, os_ = [], [], []
        for sid in range(len(partitions)):
            p, s, o = _unpack_weights(by_sid[sid][1])
            if set(p) != set(want_p[sid]) or set(s) != set(want_s[sid]):
                return None  # not this model's stage
            ps.append(p)
            ss.append(s)
            os_.append(o if o is not None else self.optimizer.init(p))
        return (merge_named(ps, partitions), merge_named(ss, partitions),
                self.optimizer.merge_state(os_, partitions))

    def gathered_params(self) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]:
        """(params, state) of the full model gathered live from the
        workers, on the host, under the full model's names."""
        full = self._assemble_full(self._gather_stage_blobs(), self.partitions,
                                   expect_batch=None)
        if full is None:
            raise RuntimeError("workers returned an incomplete or "
                               "unconfigured stage set")
        return full[0], full[1]

    def _load_model(self, params: Mapping[str, Any],
                    state: Mapping[str, Any]) -> None:
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(params[n])
            for n, b in self.model.named_buffers():
                b.copy_(state[n])

    def _commit(self) -> None:
        """Gather the live weights, write them into the coordinator's model
        and commit it through the checkpoint manager (metadata: the batch
        vintage); trim the journal to one extra commit window (insurance
        against a corrupt newest commit)."""
        with get_tracer().span("pipe.commit", track="pipeline",
                               batch=self._batch):
            full = self._assemble_full(self._gather_stage_blobs(),
                                       self.partitions,
                                       expect_batch=self._batch)
            if full is None:
                raise RuntimeError(
                    "weight gather at checkpoint cadence returned an "
                    "inconsistent stage set")
            params, state, opt = full
            self._load_model(params, state)
            self.checkpoints.save(
                self._batch, self.model, opt, self.optimizer,
                {"batch": self._batch, "gen": self._gen,
                 "stages": self.num_stages})
        floor = self._batch - max(self.checkpoint_every, 1)
        while self._journal and self._journal[0]["batch"] <= floor:
            self._journal.popleft()

    def _journal_append(self, x, y, lr, rng: int, schedule: str) -> None:
        # own copies: a caller reusing one staging buffer would otherwise
        # alias every entry to the newest batch
        def own(a):
            return (a.detach().clone() if isinstance(a, torch.Tensor)
                    else np.array(a, copy=True))
        self._journal.append({"batch": self._batch, "x": own(x), "y": own(y),
                              "lr": lr, "rng": rng, "schedule": schedule})
        while len(self._journal) > self.journal_limit:
            self._journal.popleft()
            self._reg.counter(
                "pipeline_journal_dropped_total",
                "journaled batches dropped past journal_limit — a "
                "recovery past this horizon loses batches").inc()

    # -- recovery ----------------------------------------------------------
    def _with_recovery(self, fn):
        """Run one protocol unit; on :class:`StageLostError` recover and
        retry it. A loss during recovery re-enters with the shrunken set
        (bounded by ``max_recoveries``). A live worker's exception and the
        other failures abort and raise."""
        attempt = 0
        while True:
            try:
                return fn()
            except PipelineWorkerError:
                raise  # _recv already aborted; the worker is alive
            except StageLostError as e:
                err: Exception = e
            except (TimeoutError, RuntimeError, OSError):
                self.abort()
                raise
            while True:
                attempt += 1
                if not self.recover or attempt > self.max_recoveries:
                    try:
                        self.abort()
                    except OSError:
                        pass
                    raise err
                try:
                    self._recover(err)
                    break
                except (StageLostError, PipelineWorkerError) as again:
                    err = again  # a second fault: re-enter
                except (TimeoutError, RuntimeError, OSError):
                    try:
                        self.abort()
                    except OSError:
                        pass
                    raise

    def _recover(self, err: Exception) -> None:
        """Fence the dead batch, rebuild the worker set, gather or restore,
        repartition and re-ship, replay the journal."""
        t0 = self._clock()
        self.recovering = True
        self._reg.gauge("pipeline_recovering",
                        "1 while a pipeline recovery is in flight").set(1)
        with self._lock:
            detections = list(self._detections)
            self._detections = []
            dead_now = sorted(self._dead)
        for _sid, age in detections:
            self.stats["detection_s"].append(age)
            self._reg.histogram(
                "pipeline_detection_seconds",
                "silence before a stage was declared dead").observe(age)
        from ..obs.flight import resolve_flight_recorder
        resolve_flight_recorder(self._flight).record(
            "pipeline_stage_death",
            reasons=[str(err)],
            config={"generation": self._gen, "batch": self._batch,
                    "stages": self.num_stages, "dead_stages": dead_now,
                    "active_addrs": self.active_addrs,
                    "worker_addrs": self.worker_addrs},
            registry=self._reg)
        try:
            with get_tracer().span("pipe.recover", track="pipeline",
                                   gen_from=self._gen, dead=dead_now):
                self._recover_inner()
            wall = self._clock() - t0
            self.stats["recoveries"] += 1
            self.stats["recovery_s"].append(wall)
            self._reg.counter("pipeline_recoveries_total",
                              "completed pipeline recoveries").inc()
            self._reg.histogram(
                "pipeline_recovery_seconds",
                "stage-loss to pipeline-serving-again wall").observe(wall)
        finally:
            self.recovering = False
            self._reg.gauge("pipeline_recovering",
                            "1 while a pipeline recovery is in flight"
                            ).set(0)

    def _recover_inner(self) -> None:
        old_partitions = list(self.partitions)
        self.abort()
        self._install_workers(self._rebuild_channels())
        # gather-or-restore: a complete, configured old stage set at this
        # batch yields the live weights (no rewind); else the newest commit
        full = None
        if len(self.chans) >= len(old_partitions):
            try:
                full = self._assemble_full(self._gather_stage_blobs(),
                                           old_partitions,
                                           expect_batch=self._batch)
            except (StageLostError, TimeoutError, RuntimeError):
                full = None
        if full is not None:
            params, state, opt = full
            from_batch = self._batch
        else:
            params, state, opt, from_batch = self._restore_weights()
        self._ship_stages(params, state, opt)
        self._start_beat()
        self._replay_journal(from_batch)

    def _rebuild_channels(self) -> List[Tuple[str, Channel]]:  # dcnn: protocol=pipe.c2w role=sender
        """Sweep the original addresses: healthy channels reused, dead ones
        closed and re-dialled for ``respawn_s`` (a success counts on
        ``pipeline_stage_respawns_total``), unreachable ones dropped this
        generation and tried again on the next sweep."""
        with self._lock:
            dead_sids = set(self._dead)
        current = dict(zip(self.active_addrs, self.chans))
        dead_addrs = {self.active_addrs[sid] for sid in dead_sids
                      if sid < len(self.active_addrs)}
        alive: List[Tuple[str, Channel]] = []
        for addr in self.worker_addrs:
            ch = current.get(addr)
            if ch is not None and addr not in dead_addrs:
                alive.append((addr, ch))
                continue
            if ch is not None:
                ch.close()
            host, port = parse_addr(addr)
            try:
                nch = connect(host, port, timeout=self.t.respawn_s,
                              compress=self.compress,
                              name="pipeline_reconnect")
            except (ConnectionError, OSError):
                continue
            try:
                nch.send("HELLO", {"role": "coordinator"})
            except OSError:
                nch.close()
                continue
            if self._live_enabled:
                nch.set_send_timeout(self.t.convict() + self.t.probe())
            self.inbox.attach(nch, on_close=self._on_close)
            alive.append((addr, nch))
            self.stats["respawns"] += 1
            self._reg.counter(
                "pipeline_stage_respawns_total",
                "dead pipeline workers that came back on a recovery "
                "sweep").inc()
        if len(alive) < self.min_stages:
            raise PipelineCollapsedError(
                f"{len(alive)} reachable worker(s) < min_stages "
                f"{self.min_stages}")
        return alive

    def _restore_weights(self):
        """The newest checksum-valid commit (torn ones skipped), else the
        deploy-time snapshot: (params, state, opt_state, batch vintage)."""
        restored = self.checkpoints.restore_latest(device=self.device) \
            if self.checkpoints is not None else None
        if restored is not None:
            m = restored.model
            return (_host_named(m.named_parameters()),
                    _host_named(m.named_buffers()), restored.opt_state,
                    int(restored.metadata.get("batch", 0)))
        snap = self._init_weights
        if snap is None:
            raise RuntimeError("no checkpoint and no initial snapshot — "
                               "deploy_stages was never called")
        return snap["p"], snap["s"], snap["o"], 0

    def _replay_journal(self, from_batch: int) -> None:
        """Re-run every journaled batch newer than the restore point, with
        its inputs and key; batches the journal no longer covers count as
        lost."""
        entries = [e for e in self._journal if e["batch"] > from_batch]
        lost = (self._batch - from_batch) - len(entries)
        if lost > 0:
            self.stats["batches_lost"] += lost
            self._reg.counter(
                "pipeline_batches_lost_total",
                "batches unrecoverable after a stage loss (journal "
                "horizon exceeded)").inc(lost)
        for e in entries:
            fn = (self._batch_sync if e["schedule"] == "sync"
                  else self._batch_semi_async)
            fn(e["x"], e["y"], e["lr"], e["rng"], bno=e["batch"])
            self.stats["replayed_batches"] += 1
            self._reg.counter("pipeline_replayed_batches_total",
                              "journaled batches re-run by recovery").inc()

    # -- failure handling --
    # dcnn: protocol=pipe.w2c role=handler frames=*
    def abort(self) -> None:  # dcnn: protocol=pipe.c2w role=sender
        """Bump the generation (fencing every in-flight message of the dead
        batch on both ends), broadcast ABORT (caches, gradients and layer
        state reset), drain the live stages' ABORTED acks within
        ``PipelineTimeouts.drain()``."""
        self._gen += 1
        self._reg.gauge("pipeline_generation",
                        "current pipeline batch generation").set(self._gen)
        for chan in self.chans:
            try:
                chan.send("ABORT", {"gen": self._gen}, attempts=1)
            except OSError:
                pass
        with self._lock:
            expect = self.num_stages - len(self._dead)
        acked = 0
        deadline = self._clock() + self.t.drain()
        while acked < expect:
            remaining = deadline - self._clock()
            if remaining <= 0:
                break
            try:
                cmd, meta, _, chan = self.inbox.get(timeout=remaining)
            except TimeoutError:
                break
            self._heard(chan)
            if cmd == "ABORTED" and meta.get("gen") == self._gen:
                acked += 1

    def health_check(self) -> List[Dict[str, Any]]:  # dcnn: protocol=pipe.c2w role=sender
        """One vitals dict per stage ({stage_id, configured, gen, batch,
        rss_kb}), ordered by stage; raises ``TimeoutError`` or
        :class:`StageLostError` if a worker is dead. Batch messages that
        arrive meanwhile are deferred, not dropped."""
        acks = self._round("HEALTH_CHECK", "HEALTH_ACK", "_health_nonce")
        return sorted((m for m, _ in acks),
                      key=lambda v: v.get("stage_id", -1))

    def shutdown(self) -> None:  # dcnn: protocol=pipe.c2w role=sender
        """Stop the beats, send SHUTDOWN to every worker, close the
        channels and the checkpoint manager."""
        self._beat_stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=5.0)
            self._beat_thread = None
        with self._lock:
            self._closed = True
        for chan in self.chans:
            try:
                chan.send("SHUTDOWN", {}, attempts=1)
            except OSError:
                pass
        for chan in self.chans:
            chan.close()
        self.chans = []
        # each reader wakes on its closed socket: wait for them, so the
        # process never exits under a waking thread
        self.inbox.join(timeout=5.0)
        if self.checkpoints is not None:
            self.checkpoints.close()

    def __del__(self):
        try:
            self._beat_stop.set()
        except Exception:
            pass
