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
``clock`` the whole pipeline is testable sleep-free. The JAX module's
telemetry server and tracer spans are not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional

import numpy as np

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
    __slots__ = ("x", "n", "single", "future", "t_submit")

    def __init__(self, x, n, single, future, t_submit):
        self.x, self.n, self.single = x, n, single
        self.future, self.t_submit = future, t_submit


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
        self._clock = clock
        self._q: deque = deque()  # guarded by _cond
        self._rows = 0  # guarded by _cond
        # every accepted, not-yet-resolved future: the no-orphan ledger
        self._accepted: set = set()  # guarded by _cond
        self._cond = threading.Condition()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
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
        with self._cond:
            if self._closing:
                raise DrainingError("batcher is draining or shut down")
            if self._rows + n > self.queue_capacity:
                self.metrics.record_shed(n)
                raise QueueFullError(
                    f"queue at capacity ({self._rows}/{self.queue_capacity}"
                    f" samples); request of {n} shed")
            self._q.append(_Request(x, n, single, fut, self._clock()))
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
            batch, rows = [], 0
            while self._q and rows + self._q[0].n <= self.max_batch:
                req = self._q.popleft()
                self._rows -= req.n
                # claims the request for this batch; drops one the caller
                # cancelled while queued
                if not req.future.set_running_or_notify_cancel():
                    self._accepted.discard(req.future)
                    continue
                rows += req.n
                batch.append(req)
            self.metrics.record_queue_depth(self._rows)
            return batch

    def _run(self, batch: List[_Request]) -> None:
        try:
            x = (batch[0].x if len(batch) == 1
                 else np.concatenate([r.x for r in batch]))
            rows = x.shape[0]
            padded, _ = self.engine.pad_to_bucket(x)
            # copying to host waits for the device, so recorded latency
            # covers the whole computation
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
            self._q.clear()
            self._rows = 0
            pending = set(self._accepted)
            self._accepted.clear()
            self.metrics.record_queue_depth(0)
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
            self.drain(timeout)
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
        for r in queued:
            try:
                r.future.set_exception(exc)
            except InvalidStateError:
                pass  # caller cancelled it while queued
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._fail_pending(exc)  # sweep any remainder: no future orphaned

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def __repr__(self) -> str:
        return (f"DynamicBatcher(engine={self.engine.name!r}, "
                f"max_batch={self.max_batch}, "
                f"max_wait_ms={self.max_wait_s * 1e3:g}, "
                f"capacity={self.queue_capacity})")
