"""Standalone pipeline stage worker, the cross-process deployment's runtime
(counterpart of ``dcnn_tpu/parallel/worker.py`` and
``examples/network_worker.py``).

A worker listens on a port, receives its stage as a JSON config and a
weight blob (CONFIG_TRANSFER), builds it with
:meth:`~.pipeline.PipelineStage.from_config` on its device, dials the next
stage, then serves FORWARD_JOB / BACKWARD_JOB / UPDATE_PARAMETERS until
SHUTDOWN. Its compute is the :class:`~.pipeline.PipelineStage` the
in-process coordinator runs, so a multi-process run gives the in-process
numbers (``tests/test_torch_distributed_pipeline.py``).

Message flow (the coordinator drives, ``distributed_pipeline.py``):

  coordinator --FORWARD_JOB--> stage0 --FORWARD_JOB--> ... --> stageN-1
  stageN-1 --FORWARD_RESULT--> coordinator
  coordinator --BACKWARD_JOB--> stageN-1 --BACKWARD_JOB--> ... --> stage0
  stage0 --BACKWARD_DONE--> coordinator        (the input's gradient stays)
  coordinator --UPDATE_PARAMETERS--> all; each acks PARAMETERS_UPDATED
  coordinator --GATHER_WEIGHTS--> all; each replies WEIGHTS (params, layer
                                  state and optimizer state, by name)

Liveness: ``heartbeat_s`` and ``coord_timeout_s`` arrive in CONFIG_TRANSFER
from the coordinator's ``PipelineTimeouts``. The worker beats the
coordinator, and a coordinator that closed its connection or stayed silent
past ``coord_timeout_s`` (judged only with the inbox drained) is dropped:
the worker keeps its stage and weights and listens for a replacement.

Failures: an exception in a handler goes upstream as ERROR_REPORT with its
traceback (a failed kernel launch included: it never falls back to another
device). A failed send to, or dial of, a neighbouring stage names that
stage as ``lost_stage``: its death can reach the coordinator this way
before its own connection's close does, and it is a stage loss, not this
worker's error. :class:`~dcnn_tpu_torch.resilience.faults.InjectedCrash` from the
armed ``pipeline.stage_death`` point (fired per dispatched job) is not
reported: it stands in for SIGKILL, and the serve loop closes every
socket. ``pipeline.slow_stage`` (``FaultPlan.slow``) delays a forward or
backward inside its measured wall.

Where the port departs from the JAX package: a microbatch's key is an int;
the payload goes onto the stage's device with one copy and the output
leaves it through :meth:`~.comm.Channel.send`, queued on the stage's
stream; weights are installed by name, not against a ``model.init``
treedef, and the gather blob is built by name.

Run one a stage (on the card unless ``--device cpu``; with no card and no
``--device cpu`` it raises at start):

  python -m dcnn_tpu_torch.parallel.worker --port 9601 [--compress CODEC]
      [--device cpu] [--deterministic]

Before it listens it pays the process's one-time costs (:func:`warm_up`).
It prints one JSON line on stdout when it listens (``{"listening": port,
"device": ...}``) and one on SHUTDOWN, its last: the device's name, the
kernel launch counters of its process and the framed bytes it sent and
received; then it exits.
"""

from __future__ import annotations

import argparse
import json
import os
import socket as _socket
import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..resilience import faults as _faults
from .comm import Channel, Inbox, connect, listen, parse_addr
from .distributed_pipeline import _pack_weights, _unpack_weights
from .pipeline import PipelineStage


class PeerLost(ConnectionError):
    """A send to, or the dial of, a neighbouring stage failed: reported to
    the coordinator as that stage's loss (ERROR_REPORT ``lost_stage``),
    not as this worker's own error."""

    def __init__(self, stage_id: int, cause: BaseException):
        super().__init__(f"link to stage {stage_id} failed: {cause!r}")
        self.stage_id = stage_id


def _tensor(payload) -> torch.Tensor:
    """A received array as a host tensor over the same memory."""
    if isinstance(payload, torch.Tensor):
        return payload
    a = np.asarray(payload)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class StageWorker:
    """Event loop around one :class:`PipelineStage` on ``device`` (the card
    unless ``"cpu"``; resolved at construction, so a worker asked for a
    card on a host without one raises there). The worker has no timeout
    policy of its own: ``idle_poll_s`` is the inbox poll before a
    coordinator configures liveness."""

    def __init__(self, port: int, compress: "bool | str" = False, *,
                 device: DeviceLike = None, listen_sock=None,
                 idle_poll_s: float = 60.0,
                 fault_plan: Optional[_faults.FaultPlan] = None,
                 clock=time.monotonic):
        self.port = port
        self.compress = compress
        self.device = resolve_device(device)
        self.inbox = Inbox()
        self.stage: Optional[PipelineStage] = None
        self.next: Optional[Channel] = None
        self.prev: Optional[Channel] = None
        self.is_first = False
        self.is_last = False
        self._running = False
        self._srv = listen_sock
        self._idle_poll_s = idle_poll_s
        self._faults_plan = fault_plan
        self._clock = clock
        self._state_snap = None       # batch-start layer state, for ABORT
        self._applied_batch = 0       # last UPDATE_PARAMETERS batch vintage
        self._layers = None           # the [start, end) range this stage holds
        # shared with the beat thread and the readers' on_close callbacks
        self._lock = threading.Lock()
        self.coord: Optional[Channel] = None   # dcnn: guarded_by=_lock
        self.stage_id = -1                     # dcnn: guarded_by=_lock
        self.gen = 0                           # dcnn: guarded_by=_lock
        self._hb_s = 0.0                       # dcnn: guarded_by=_lock
        self._coord_timeout_s = 0.0            # dcnn: guarded_by=_lock
        self._coord_heard = 0.0                # dcnn: guarded_by=_lock
        self._coord_lost = False               # dcnn: guarded_by=_lock
        self._beat_stop = threading.Event()
        self._beat_thread: Optional[threading.Thread] = None

    # -- plumbing ----------------------------------------------------------
    def _trip(self, point: str, **ctx) -> None:
        if self._faults_plan is not None:
            self._faults_plan.trip(point, **ctx)
        else:
            _faults.trip(point, **ctx)

    def _slowdown(self, point: str, base_s: float, **ctx) -> float:
        """Sleep the armed extra (``FaultPlan.slow``) inside the dispatch;
        the caller folds it into the load tracker, so the coordinator's
        rebalancer reads the slowness."""
        extra = _faults.slowdown(point, base_s, **ctx)
        if self._faults_plan is not None:
            extra += self._faults_plan.slowdown(point, base_s, **ctx)
        if extra > 0.0:
            time.sleep(extra)
        return extra

    def _coord_chan(self) -> Optional[Channel]:
        with self._lock:
            return self.coord

    def _gen_now(self) -> int:
        with self._lock:
            return self.gen

    def _sid(self) -> int:
        with self._lock:
            return self.stage_id

    # -- connection intake --
    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            chan = Channel(sock, compress=self.compress)
            self.inbox.attach(chan, on_close=self._on_chan_close)

    def _on_chan_close(self, chan: Channel) -> None:
        with self._lock:
            if chan is self.coord:
                self._coord_lost = True

    # -- coordinator liveness ---------------------------------------------
    def _check_coordinator(self, drained: bool = True) -> None:
        """Drop a dead coordinator: its connection closed, or its BEATs
        stopped for ``coord_timeout_s``. Silence is judged only with the
        inbox drained (a long dispatch leaves BEATs queued unread);
        close-based conviction is immediate. The stage and its weights
        stay, for a replacement coordinator."""
        ch = None
        with self._lock:
            if self.coord is None:
                return
            lost = self._coord_lost
            if not lost and drained and self._hb_s > 0 \
                    and self._coord_timeout_s > 0 \
                    and self._clock() - self._coord_heard \
                    > self._coord_timeout_s:
                lost = True
            if lost:
                ch, self.coord = self.coord, None
                self._coord_lost = False
        if ch is not None:
            ch.close()

    def _poll_s(self) -> float:
        with self._lock:
            hb = self._hb_s
        return min(hb, 1.0) if hb > 0 else self._idle_poll_s

    def _start_beat(self, hb_s: float) -> None:
        with self._lock:
            self._hb_s = float(hb_s)
        if self._beat_thread is not None or hb_s <= 0:
            return
        self._beat_stop = threading.Event()
        stop = self._beat_stop

        def loop() -> None:  # dcnn: protocol=pipe.w2c role=sender
            first = True
            while first or not stop.wait(hb_s):
                first = False
                with self._lock:
                    coord, sid, gen = self.coord, self.stage_id, self.gen
                if coord is None:
                    continue
                try:
                    coord.send("BEAT", {"stage_id": sid, "gen": gen},
                               attempts=1)
                except OSError:
                    pass  # the reader's on_close convicts the coordinator
        self._beat_thread = threading.Thread(
            target=loop, daemon=True, name=f"dcnn-pipe-beat-{self.port}")
        self._beat_thread.start()

    def _stop_beat(self) -> None:
        self._beat_stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=5.0)
            self._beat_thread = None

    # -- lifecycle ---------------------------------------------------------
    def serve(self) -> None:  # dcnn: protocol=pipe.w2c role=sender
        """Listen and process messages until SHUTDOWN or :meth:`stop`."""
        if self._srv is None:
            self._srv = listen(self.port)
        self.port = self._srv.getsockname()[1]
        self._running = True
        acceptor = threading.Thread(target=self._accept_loop, daemon=True)
        acceptor.start()
        try:
            while self._running:
                self._check_coordinator(drained=False)
                try:
                    cmd, meta, payload, chan = self.inbox.get(
                        timeout=self._poll_s())
                except TimeoutError:
                    self._check_coordinator(drained=True)
                    continue
                with self._lock:
                    if chan is self.coord:
                        self._coord_heard = self._clock()
                if cmd in ("BEAT", "_STOP"):
                    continue
                try:
                    self._dispatch(cmd, meta, payload, chan)
                except _faults.InjectedCrash:
                    raise  # the SIGKILL stand-in: never reported
                except Exception as e:  # noqa: BLE001 — reported, not fatal
                    err = {"stage_id": self._sid(), "gen": meta.get("gen"),
                           "error": traceback.format_exc()}
                    if isinstance(e, PeerLost):
                        err["lost_stage"] = e.stage_id
                    coord = self._coord_chan()
                    if coord is not None:
                        try:
                            coord.send("ERROR_REPORT", err)
                        except OSError:
                            pass
        finally:
            self._running = False
            self._close_all()
            self._stop_beat()
            # the acceptor and the readers wake on the closed sockets: wait
            # for them, so the process never exits under a waking thread
            acceptor.join(timeout=5.0)
            self.inbox.join(timeout=5.0)

    def _shutdown_listener(self) -> None:
        """Shut down and close the listener, so a dead worker's port stops
        completing handshakes at once."""
        if self._srv is None:
            return
        try:
            self._srv.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass

    def _close_all(self) -> None:
        """Close every socket the worker owns, as a dead process's kernel
        would."""
        self._shutdown_listener()
        with self._lock:
            coord, self.coord = self.coord, None
        for c in (coord, self.next, self.prev):
            if c is not None:
                c.close()

    def stop(self) -> None:
        """Thread-safe stop: wakes the serve loop at once."""
        self._running = False
        self._shutdown_listener()
        self.inbox.post("_STOP")

    # -- dispatch --
    def _send_out(self, chan: Channel, cmd: str, meta: Dict[str, Any],
                  t: torch.Tensor) -> None:
        """Send a tensor the stage produced: its host copy is queued on the
        stage's stream, after the work that made it."""
        with self.stage.running():
            if chan is self._coord_chan():
                chan.send(cmd, meta, array=t)
                return
            peer = self._sid() + (1 if chan is self.next else -1)
            try:
                chan.send(cmd, meta, array=t)
            except OSError as e:
                raise PeerLost(peer, e) from e

    # dcnn: protocol=pipe.c2w role=handler frames=BEAT,_STOP
    def _dispatch(self, cmd: str, meta: Dict[str, Any], payload: Any,
                  chan: Channel) -> None:  # dcnn: protocol=pipe.w2c role=sender
        if cmd in ("FORWARD_JOB", "BACKWARD_JOB", "UPDATE_PARAMETERS",
                   "CONFIG_TRANSFER", "GATHER_WEIGHTS"):
            # the kill-a-stage point, fired per dispatched job: a test's
            # at=k lands on an exact microbatch or re-ship
            self._trip("pipeline.stage_death", cmd=cmd,
                       mb=meta.get("mb_id"), stage=self._sid())

        if cmd == "HELLO":
            role = meta["role"]
            if role == "coordinator":
                with self._lock:
                    old, self.coord = self.coord, chan
                    self._coord_heard = self._clock()
                    self._coord_lost = False
                if old is not None and old is not chan:
                    old.close()
            elif role == "prev_stage":
                old, self.prev = self.prev, chan
                if old is not None and old is not chan:
                    old.close()
            return

        # deliberate non-fence: a re-deploy adopts the shipped generation
        # (a respawned coordinator restarts its own count, so a worker
        # that refused lower gens could never be re-deployed)
        if cmd == "CONFIG_TRANSFER":  # dcnn: disable=PR02
            self._handle_configuration(meta, payload)
            return

        if cmd in ("FORWARD_JOB", "BACKWARD_JOB") and \
                meta.get("gen", 0) < self._gen_now():
            return  # a stale job of an aborted batch

        if cmd == "FORWARD_JOB":
            mb_id = meta["mb_id"]
            training = meta.get("training", True)
            if training and not self.stage.batch_open():
                # batch start: ABORT puts back the BN statistics this
                # batch's forwards move
                self._state_snap = self.stage.snapshot_state()
            t0 = self._clock()
            y = self.stage.forward(mb_id, _tensor(payload), int(meta["rng"]),
                                   training=training)
            extra = self._slowdown("pipeline.slow_stage",
                                   self._clock() - t0, cmd="FORWARD_JOB",
                                   mb=mb_id, stage=self._sid())
            if extra > 0.0:
                self.stage.load.forward_ms += extra * 1e3
            if self.is_last:
                self._send_out(self._coord_chan(), "FORWARD_RESULT",
                               {"mb_id": mb_id, "gen": meta.get("gen", 0)}, y)
            else:
                self._send_out(self.next, "FORWARD_JOB", dict(meta),
                               y)  # dcnn: protocol=pipe.c2w
            return

        if cmd == "BACKWARD_JOB":
            mb_id = meta["mb_id"]
            t0 = self._clock()
            xgrad = self.stage.backward(mb_id, _tensor(payload))
            extra = self._slowdown("pipeline.slow_stage",
                                   self._clock() - t0, cmd="BACKWARD_JOB",
                                   mb=mb_id, stage=self._sid())
            if extra > 0.0:
                self.stage.load.backward_ms += extra * 1e3
            if self.is_first:
                self._coord_chan().send(
                    "BACKWARD_DONE",
                    {"mb_id": mb_id, "gen": meta.get("gen", 0)})
            else:
                # dcnn: protocol=pipe.c2w
                self._send_out(self.prev, "BACKWARD_JOB",
                               {"mb_id": mb_id, "gen": meta.get("gen", 0)},
                               xgrad)
            return

        if cmd == "UPDATE_PARAMETERS":
            self.stage.apply_updates(meta["lr"])
            self._applied_batch = int(meta.get("batch",
                                               self._applied_batch + 1))
            self._state_snap = None  # the batch is committed
            # the gen echo: an ack lingering across a recovery's bump never
            # satisfies the new generation's join
            self._coord_chan().send("PARAMETERS_UPDATED",
                                    {"stage_id": self._sid(),
                                     "gen": self._gen_now()})
            return

        # deliberate non-fence: the nonce is ECHOED (inside
        # _handle_gather's WEIGHTS reply) for the coordinator to fence
        if cmd == "GATHER_WEIGHTS":  # dcnn: disable=PR02
            self._handle_gather(meta)
            return

        if cmd == "LOAD_REPORT_REQUEST":
            self._coord_chan().send(
                "LOAD_REPORT", {"stage_id": self._sid(),
                                "nonce": meta.get("nonce"),
                                "report": self.stage.load.report()})
            return

        if cmd == "PRINT_PROFILING":
            self._coord_chan().send(
                "PROFILING_REPORT",
                {"stage_id": self._sid(), "nonce": meta.get("nonce"),
                 "profile": self.stage.collect_profile()})
            return

        if cmd == "CLEAR_PROFILING":
            self.stage.clear_profile()
            self._coord_chan().send(
                "PROFILING_CLEARED", {"stage_id": self._sid(),
                                      "nonce": meta.get("nonce")})
            return

        if cmd == "HEALTH_CHECK":
            # vitals; also the coordinator's liveness probe (nonce "probe")
            from ..utils.hardware import get_memory_usage_kb
            self._coord_chan().send("HEALTH_ACK", {
                "stage_id": self._sid(),
                "nonce": meta.get("nonce"),
                "configured": self.stage is not None,
                "gen": self._gen_now(),
                "batch": self._applied_batch,
                "rss_kb": get_memory_usage_kb(),
            })
            return

        if cmd == "ABORT":
            # drop residuals and accumulated gradients, put the layer state
            # back to batch start; generations only advance, so a straggler
            # ABORT of an older recovery is dropped unacked
            g = meta.get("gen")
            with self._lock:
                if g is not None and g <= self.gen:
                    return
                self.gen = self.gen + 1 if g is None else int(g)
            if self.stage is not None:
                if self._state_snap is not None:
                    self.stage.abort(self._state_snap)
                else:
                    self.stage.abort()
                self._state_snap = None
            self._coord_chan().send("ABORTED", {"stage_id": self._sid(),
                                                "gen": self._gen_now()})
            return

        if cmd == "SHUTDOWN":
            self._running = False
            return

        raise ValueError(f"unknown command {cmd!r}")

    # -- CONFIG_TRANSFER --
    def _handle_configuration(self, meta: Dict[str, Any],
                              payload: Any) -> None:  # dcnn: protocol=pipe.w2c role=sender
        with self._lock:
            self.stage_id = meta["stage_id"]
            # a recovery re-ship carries the post-abort generation
            self.gen = int(meta.get("gen", self.gen))
        self.is_first = meta["is_first"]
        self.is_last = meta["is_last"]
        self.stage = PipelineStage.from_config(
            meta["stage_id"], meta["model"], meta["optimizer"], self.device,
            track_load=meta.get("track_load", False))
        self._state_snap = None
        self._applied_batch = int(meta.get("batch", 0))
        self._layers = meta.get("layers")
        # the weights by name; the optimizer state rides along on recovery
        # re-ships, so a repartition keeps momentum exactly
        params, state, opt_state = _unpack_weights(payload)
        self.stage.set_weights(params, state, opt_state)

        # a re-deploy replaces the downstream chain
        if self.next is not None:
            self.next.close()
            self.next = None
        if meta.get("next_addr"):
            host, port = parse_addr(meta["next_addr"])
            try:
                self.next = connect(host, port, compress=self.compress,
                                    timeout=float(meta.get("connect_s", 60.0)))
                self.next.send("HELLO", {"role": "prev_stage"})  # dcnn: protocol=pipe.c2w
            except OSError as e:
                raise PeerLost(self._sid() + 1, e) from e
            self.inbox.attach(self.next, on_close=self._on_chan_close)

        self._start_beat(float(meta.get("heartbeat_s", 0.0)))
        with self._lock:
            self._coord_timeout_s = float(meta.get("coord_timeout_s", 0.0))
            self._coord_heard = self._clock()
        self._coord_chan().send("CONFIG_RECEIVED",
                                {"stage_id": self._sid(),
                                 "gen": self._gen_now()})

    def _handle_gather(self, meta: Dict[str, Any]) -> None:  # dcnn: protocol=pipe.w2c role=sender
        coord = self._coord_chan()
        st = self.stage
        if st is None or st.opt_state is None:
            coord.send("WEIGHTS", {"stage_id": self._sid(),
                                   "nonce": meta.get("nonce"),
                                   "configured": False})
            return
        with st.running():  # the host copies follow the stage's updates
            blob = _pack_weights(st.params, st.state, st.opt_state)
        coord.send("WEIGHTS", {"stage_id": self._sid(),
                               "nonce": meta.get("nonce"),
                               "configured": True,
                               "batch": self._applied_batch,
                               "layers": self._layers}, raw=blob)


def run_worker(port: int, compress: "bool | str" = False, **kw) -> None:
    StageWorker(port, compress=compress, **kw).serve()


def launch_counts() -> Dict[str, int]:
    """The kernel launch counters of this process."""
    from ..ops import _kernels

    return {fn.__name__: fn.launches for fn in _kernels.COUNTED}


def wire_bytes() -> Dict[str, int]:
    """The framed bytes this process sent and received."""
    from ..obs.registry import get_registry

    reg = get_registry()
    return {d: int(reg.counter(f"comm_bytes_{d}_total").value)
            for d in ("sent", "received")}


def warm_up(device: torch.device) -> None:
    """Pay this process's one-time costs before it listens, so a stage's
    first batch does not: the ``dcnn::`` ops' first dispatch (through
    their plain versions on the CPU: no kernel launches, no counter
    moves), the CUDA context and the kernel libraries of the build
    directory (:func:`~dcnn_tpu_torch.ops._kernels.build`)."""
    from ..ops import _kernels
    from ..ops.attention import flash_attention

    q = torch.zeros(1, 1, 2, 8, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _kernels.build()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.parallel.worker",
        description="Pipeline stage worker: serves one stage of a "
                    "DistributedPipelineCoordinator over TCP.")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="0.0.0.0",
                    help="address to listen on (default all)")
    ap.add_argument("--compress", default="",
                    help="codec of the frames this worker sends: raw, zlib, "
                         "zstd, lz4, shuffle-lz4 or shuffle-zstd (default "
                         "raw); receiving decodes any")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    ap.add_argument("--deterministic", action="store_true",
                    help="cudnn.deterministic in this process")
    args = ap.parse_args(argv)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
    w = StageWorker(args.port, compress=args.compress or False,
                    device=args.device)
    warm_up(w.device)
    w._srv = listen(args.port, args.host)
    print(json.dumps({"listening": w._srv.getsockname()[1],
                      "device": str(w.device)}), flush=True)
    w.serve()
    dev = (torch.cuda.get_device_name(w.device) if w.device.type == "cuda"
           else "cpu")
    print(json.dumps({"shutdown": True, "device": dev,
                      "launches": launch_counts(),
                      "wire_bytes": wire_bytes()}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the process's work is done and reported: leave without the C++
    # runtimes' static destructors, which can abort (std::terminate) on a
    # pool thread they still hold once the interpreter has finalized
    os._exit(code)
