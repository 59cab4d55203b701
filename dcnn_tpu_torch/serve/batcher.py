"""Dynamic batcher (counterpart of ``dcnn_tpu/serve/batcher.py``).

Single requests arrive asynchronously; the device's throughput lives at
large batches. A batching window reconciles the two: hold the first
request at most ``max_wait_ms``, group what arrives meanwhile up to
``max_batch``, run once, scatter results. With

- a bounded queue (capacity in samples): beyond it :meth:`submit` raises
  :class:`QueueFullError` at once, so the server sheds load instead of
  letting latency grow without bound;
- a dispatcher thread that first warms the engine's buckets on itself
  (``warm``; cuDNN's handles and plans are per-thread in PyTorch), then
  pops a batch when it is due (full, oldest
  request past its deadline, or draining), pads it to the engine's bucket,
  runs it and resolves the per-request futures; the constructor returns
  once the warm-up is done, so no request waits for it;
- teardown with a no-orphan guarantee: :meth:`drain` completes everything
  accepted; :meth:`shutdown` with ``drain=False`` fails queued requests
  with :class:`ShutdownError`; a :meth:`drain` that trips its timeout fails
  every pending future the same way before raising.

With ``start=False`` no thread runs and :meth:`step` dispatches
synchronously through the same ``_pop_due`` core; with an injected
``clock`` the whole pipeline is testable sleep-free.

Spans (the JAX package's names, tracks and attributes): ``serve.queue``
(track ``serve.queue``) from submit to dispatch, the ``serve.shed``
instant, ``serve.dispatch`` and the nested ``serve.infer`` (track
``serve``), whose end waits for the logits on the host, as the result
copy does anyway. :meth:`start_telemetry` serves ``/metrics``,
``/healthz`` (:meth:`health_reason`) and ``/snapshot`` over HTTP, with a
tsdb sampler of the exposition text for as long as it is up.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional

import numpy as np

from ..obs.tracer import get_tracer
from ..obs.xla import sample_hbm
from .engine import InferenceEngine
from .metrics import ServeMetrics


class QueueFullError(RuntimeError):
    """Backpressure: the bounded request queue is at capacity."""


class DrainingError(RuntimeError):
    """Intake refused because the batcher is draining or shut down."""


class ShutdownError(RuntimeError):
    """The batcher shut down (or a timed drain gave up) before this request
    could be served. Raised from the request's future."""


class _Request:
    __slots__ = ("x", "n", "single", "future", "t_submit", "span")

    def __init__(self, x, n, single, future, t_submit, span=None):
        self.x, self.n, self.single = x, n, single
        self.future, self.t_submit = future, t_submit
        self.span = span  # serve.queue handle (enqueue -> dispatch)


class DynamicBatcher:
    """Thread-safe request queue + batching dispatcher over an
    :class:`~dcnn_tpu_torch.serve.engine.InferenceEngine`.

    ``max_wait_ms`` trades tail latency for occupancy; ``queue_capacity``
    is in samples. With ``warm`` (threaded mode) the dispatcher runs
    :meth:`InferenceEngine.warm` before the constructor returns, and a
    failure there raises from the constructor.
    """

    def __init__(self, engine: InferenceEngine, *,
                 max_batch: Optional[int] = None, max_wait_ms: float = 2.0,
                 queue_capacity: int = 128,
                 metrics: Optional[ServeMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True, warm: bool = True):
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, "
                             f"got {queue_capacity}")
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.queue_capacity = queue_capacity
        self.metrics = metrics if metrics is not None else ServeMetrics(
            clock=clock)
        # the dispatch slot exists, idle, from construction
        self.metrics.record_slot_state("idle")
        self._clock = clock
        self._q: deque = deque()  # guarded by _cond
        self._rows = 0  # guarded by _cond
        # every accepted, not-yet-resolved future: the no-orphan ledger
        self._accepted: set = set()  # guarded by _cond
        self._cond = threading.Condition()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        self._telemetry = None  # TelemetryServer from start_telemetry()
        self._tsdb = None  # TsdbSampler riding the telemetry lifecycle
        self._compile_mirrored = False  # engine compile counters copied
        # onto the scrape registry at most once
        # seconds the dispatcher spent warming each bucket on itself
        self.warmup_s: dict = {}
        if start:
            warmed = threading.Event()
            failure: list = []
            self._thread = threading.Thread(
                target=self._loop, args=(warm, warmed, failure),
                daemon=True,
                name=f"dcnn-torch-serve-batcher-{engine.name}")
            self._thread.start()
            warmed.wait()
            if failure:
                self._thread.join()
                self._thread = None
                raise failure[0]
            if metrics is None:  # its throughput clock starts when ready
                self.metrics.reset()
                self.metrics.record_slot_state("idle")

    def submit(self, x) -> Future:
        """Enqueue one request: a single sample ``input_shape`` (the future
        resolves to ``(classes,)`` logits) or a batch ``(n, *input_shape)``
        with ``n <= max_batch`` (resolves to ``(n, classes)``). Raises
        :class:`QueueFullError` at capacity and :class:`DrainingError`
        after :meth:`drain`/:meth:`shutdown`."""
        x = np.asarray(x)
        shp = self.engine.input_shape
        single = x.shape == shp
        if single:
            x = x[None]
        if x.ndim != len(shp) + 1 or x.shape[1:] != shp:
            raise ValueError(f"expected {shp} or (n, *{shp}), "
                             f"got shape {x.shape}")
        n = x.shape[0]
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"request batch {n} outside [1, "
                             f"{self.max_batch}]; chunk it or use "
                             f"engine.infer")
        fut: Future = Future()
        tracer = get_tracer()
        with self._cond:
            if self._closing:
                raise DrainingError("batcher is draining or shut down")
            if self._rows + n > self.queue_capacity:
                self.metrics.record_shed(n)
                tracer.instant("serve.shed", track="serve.queue", n=n)
                raise QueueFullError(
                    f"queue at capacity ({self._rows}/{self.queue_capacity}"
                    f" samples); request of {n} shed")
            self._q.append(_Request(
                x, n, single, fut, self._clock(),
                span=tracer.begin("serve.queue", track="serve.queue", n=n)))
            self._accepted.add(fut)
            self._rows += n
            self.metrics.record_submit(n)
            self.metrics.record_queue_depth(self._rows)
            self._cond.notify_all()
        return fut

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return self._rows

    # -- telemetry ---------------------------------------------------------
    def health_reason(self) -> Optional[str]:
        """``None`` while this batcher can accept traffic, else the
        machine-readable reason it cannot: a draining or dead batcher fails
        health before requests error."""
        if self._closing:
            return "draining or shut down: not accepting requests"
        if self._thread is not None and not self._thread.is_alive():
            return "dispatcher thread dead"
        return None

    def start_telemetry(self, port: int = 0, host: str = "127.0.0.1"):
        """Expose this batcher over HTTP
        (:class:`~dcnn_tpu_torch.obs.server.TelemetryServer`): ``/metrics``
        is ``ServeMetrics.prometheus()``, ``/healthz`` follows
        :meth:`health_reason`, ``/snapshot`` adds the live serve snapshot,
        the engine's buckets and compile stats, and the tsdb summary.
        ``port=0`` binds an ephemeral port (read ``.port`` back). The
        engine's cost gauges, the card's memory gauges and the engine's
        compile counters are mirrored onto the scrape registry (the
        counters once). A :class:`~dcnn_tpu_torch.obs.tsdb.TsdbSampler`
        samples the exposition text every ``DCNN_TSDB_INTERVAL`` seconds
        (default 1) into a store the process-global flight recorder
        attaches. The server survives :meth:`drain` (``/healthz`` then
        503) and stops at :meth:`shutdown`; calling this again stops the
        previous server first. Returns the started server."""
        from ..obs.flight import get_flight_recorder
        from ..obs.server import TelemetryServer
        from ..obs.tsdb import TimeSeriesStore, TsdbSampler

        self._stop_telemetry()
        srv = TelemetryServer(registry=self.metrics.registry,
                              metrics_text=self.metrics.prometheus,
                              host=host, port=port)
        srv.set_identity(component="replica", name=self.engine.name)
        srv.attach_flight(get_flight_recorder())
        reg = self.metrics.registry
        if hasattr(self.engine, "_export_cost_gauges"):
            self.engine._export_cost_gauges(reg)
        sample_hbm(reg)
        compile_stats = getattr(self.engine, "compile_stats", None)
        if compile_stats and reg is not getattr(
                self.engine, "registry", None) \
                and not self._compile_mirrored:
            self._compile_mirrored = True
            secs = sum(st.get("compile_s", 0.0)
                       for st in compile_stats.values())
            reg.counter("compile_total",
                        "XLA executables compiled").inc(len(compile_stats))
            reg.counter("compile_seconds_total",
                        "wall seconds spent compiling").inc(secs)
            reg.counter("compile_serve_seconds_total",
                        "wall seconds compiling serve executables").inc(
                secs)
        srv.add_check("batcher", self.health_reason)
        srv.add_snapshot("serve", self.metrics.snapshot)
        srv.add_snapshot("engine", lambda: {
            "name": self.engine.name,
            "version": getattr(self.engine, "version", None),
            "buckets": self.engine.bucket_sizes,
            "batch_invariant": self.engine.batch_invariant,
            "compile_stats": getattr(self.engine, "compile_stats", {}),
        })
        store = TimeSeriesStore()
        self._tsdb = TsdbSampler(
            store, registry=self.metrics.registry,
            text_fn=self.metrics.prometheus,
            interval_s=float(os.environ.get(
                "DCNN_TSDB_INTERVAL", "1.0"))).start()
        srv.add_snapshot("tsdb", store.summary)
        get_flight_recorder().attach_tsdb(store)
        self._telemetry = srv.start()
        return srv

    def _stop_telemetry(self) -> None:
        """Stop the scrape server and its history sampler (idempotent)."""
        if self._tsdb is not None:
            from ..obs.flight import get_flight_recorder
            rec = get_flight_recorder()
            # detach only our store: a later batcher's attachment wins
            if getattr(rec, "_tsdb", None) is self._tsdb.store:
                rec.attach_tsdb(None)
            self._tsdb.stop()
            self._tsdb = None
        if self._telemetry is not None:
            self._telemetry.stop()
            self._telemetry = None

    def _pop_due(self, force: bool) -> List[_Request]:
        """Pop up to ``max_batch`` samples' worth of whole requests, if a
        dispatch is due. Never splits a request."""
        with self._cond:
            if not self._q:
                return []
            due = (force or self._closing
                   or self._rows >= self.max_batch
                   or self._clock() >= self._q[0].t_submit + self.max_wait_s)
            if not due:
                return []
            tracer = get_tracer()
            batch, rows = [], 0
            while self._q and rows + self._q[0].n <= self.max_batch:
                req = self._q.popleft()
                self._rows -= req.n
                # claims the request for this batch; drops one the caller
                # cancelled while queued
                if not req.future.set_running_or_notify_cancel():
                    tracer.end(req.span, cancelled=True)
                    self._accepted.discard(req.future)
                    continue
                tracer.end(req.span)  # queue residency
                rows += req.n
                batch.append(req)
            self.metrics.record_queue_depth(self._rows)
            return batch

    def _run(self, batch: List[_Request]) -> None:
        tracer = get_tracer()
        self.metrics.record_slot_state("occupied")
        try:
            x = (batch[0].x if len(batch) == 1
                 else np.concatenate([r.x for r in batch]))
            rows = x.shape[0]
            # trace parentage: a single-trace batch parents its spans under
            # that trace; a mixed batch records the trace ids instead
            parent, extra = None, {}
            if tracer.enabled:
                ctxs = [c for c in (r.span.context() if r.span is not None
                                    else None for r in batch) if c]
                tids = {c["trace_id"] for c in ctxs}
                parent = ctxs[0] if len(tids) == 1 else None
                if len(tids) > 1:
                    extra = {"trace_ids": sorted(tids)[:8]}
            with tracer.span("serve.dispatch", track="serve", parent=parent,
                             requests=len(batch), rows=rows,
                             **extra) as dspan:
                padded, _ = self.engine.pad_to_bucket(x)
                dspan.set(bucket=int(padded.shape[0]))
                # copying to host waits for the device (the result is
                # needed there anyway), so recorded latency and the infer
                # span cover the whole computation
                with tracer.span("serve.infer", track="serve",
                                 bucket=int(padded.shape[0]), rows=rows):
                    y = self.engine.run_padded(padded).float().cpu().numpy()
            t_done = self._clock()
            off = 0
            for r in batch:
                try:
                    r.future.set_result(y[off] if r.single
                                        else y[off:off + r.n])
                    self.metrics.record_done(t_done - r.t_submit, r.n)
                except InvalidStateError:
                    pass  # failed by a timed-out drain racing this dispatch
                off += r.n
            self.metrics.record_batch(rows, padded.shape[0])
            # dispatch-boundary memory watermark: a latched no-op without
            # a card; the allocator's counters, no device wait
            sample_hbm(self.metrics.registry)
        except Exception as e:  # scatter the failure, keep the thread alive
            for r in batch:
                if not r.future.done():
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        pass
        finally:
            with self._cond:
                for r in batch:
                    self._accepted.discard(r.future)
                closing = self._closing
            self.metrics.record_slot_state(
                "draining" if closing else "idle")

    def step(self, force: bool = True) -> int:
        """Synchronously dispatch one batch (``start=False`` mode and
        :meth:`drain`). ``force=False`` dispatches only if due. Returns the
        number of requests served."""
        batch = self._pop_due(force)
        if batch:
            self._run(batch)
        return len(batch)

    def _loop(self, warm: bool, warmed: threading.Event,
              failure: list) -> None:
        try:
            if warm:
                self.warmup_s = self.engine.warm()
        except Exception as e:  # raised by the constructor
            failure.append(e)
            return
        finally:
            warmed.set()
        while True:
            with self._cond:
                while not self._q and not self._closing:
                    self._cond.wait()
                if not self._q:  # closing and fully drained
                    return
                # hold for the batching window; re-check the queue on each
                # wakeup (a concurrent step() may have emptied it)
                while (self._q and self._rows < self.max_batch
                       and not self._closing):
                    remaining = (self._q[0].t_submit + self.max_wait_s
                                 - self._clock())
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            batch = self._pop_due(force=True)
            if batch:
                self._run(batch)

    def _fail_pending(self, exc: Exception) -> int:
        """Resolve every still-pending accepted future with ``exc``.
        Returns how many this call failed."""
        with self._cond:
            queued = list(self._q)
            self._q.clear()
            self._rows = 0
            pending = set(self._accepted)
            self._accepted.clear()
            self.metrics.record_queue_depth(0)
        tracer = get_tracer()
        for r in queued:
            tracer.end(r.span, failed=type(exc).__name__)
        failed = 0
        for fut in pending:
            try:
                fut.set_exception(exc)
                failed += 1
            except InvalidStateError:
                pass  # resolved (or cancelled) while we swept
        return failed

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop accepting requests; complete everything accepted. If
        ``timeout`` trips, every pending future fails with
        :class:`ShutdownError` and ``TimeoutError`` raises."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self.metrics.record_slot_state("draining")
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                n = self._fail_pending(ShutdownError(
                    f"drain timed out after {timeout}s with requests "
                    f"pending; the batcher is shutting down"))
                raise TimeoutError(
                    f"drain did not finish in {timeout}s "
                    f"({n} pending request(s) failed with ShutdownError)")
            self._thread = None
        else:
            while self.step(force=True):
                pass

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """``drain=True``: :meth:`drain`. ``drain=False``: refuse intake and
        fail queued requests with :class:`ShutdownError`."""
        if drain:
            try:
                self.drain(timeout)
            finally:
                # even an expired drain releases the scrape port
                self._stop_telemetry()
            return
        exc = ShutdownError("batcher shut down without drain")
        with self._cond:
            self._closing = True
            queued = list(self._q)
            self._q.clear()
            self._rows = 0
            for r in queued:
                self._accepted.discard(r.future)
            self.metrics.record_queue_depth(0)
            self._cond.notify_all()
        self.metrics.record_slot_state("draining")
        tracer = get_tracer()
        for r in queued:
            try:
                r.future.set_exception(exc)
            except InvalidStateError:
                pass  # caller cancelled it while queued
            tracer.end(r.span, failed="ShutdownError")
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._fail_pending(exc)  # sweep any remainder: no future orphaned
        self._stop_telemetry()

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def __repr__(self) -> str:
        return (f"DynamicBatcher(engine={self.engine.name!r}, "
                f"max_batch={self.max_batch}, "
                f"max_wait_ms={self.max_wait_s * 1e3:g}, "
                f"capacity={self.queue_capacity})")
