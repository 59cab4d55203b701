"""Prefetching loader: host batch preparation and the host-to-device copy
overlap the device's steps (counterpart of ``dcnn_tpu/data/prefetch.py``).

A producer thread walks the host loader, optionally applies a host
``transform``, and copies each batch to the device: into a pinned buffer,
then a non-blocking copy on the producer's own CUDA stream (or through a
:class:`~.transfer.TransferEngine`), then the ``device_transform`` on that
stream, then one CUDA event. A bounded queue (``depth``) holds the batches
in flight. The consumer's stream waits for a batch's event before the
batch is yielded, and the batch's tensors are marked as used on that
stream (``record_stream``), so a batch is never read before its copy has
landed and its memory is not handed out again while the consumer's work
on it is queued. Pinned buffers come from PyTorch's caching host
allocator, which reuses one only after the copies recorded on it have
finished; the numpy source (a loader's batch, a worker's shared-memory
slot) is copied into the pinned buffer on the host and released after.

Usage::

    loader = PrefetchLoader(inner_loader, depth=2)
    for x, y in loader:          # x, y are device tensors
        loss, _ = step(ts, x, y, lr)
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .transfer import land, torch_dtype

_SENTINEL = object()


class PrefetchLoader:
    """Wraps any ``BaseDataLoader``-style iterable of (x, y) numpy batches.

    ``depth`` bounds the batches in flight on the device (2 hides host
    preparation in steady state). ``transform(x, y) -> (x, y)`` runs on the
    producer thread before the copy (host augmentation); ``device_transform(x,
    y) -> (x, y)`` runs on the producer's stream after it. When the inner
    loader ships uint8 (its ``wire_dtype``) and no ``device_transform`` is
    given, the wire decode (``wire.default_decode_transform``) is installed:
    the copy moves 1-byte pixels and the yielded x is ``float32 * scale``,
    labels untouched. ``stage_batches=K`` stacks K batches per copy and
    yields [K, B, ...] tensors for ``train.make_multi_step`` (a ragged tail
    batch is its own [1, B', ...] chunk). ``transfer_engine`` (caller-owned)
    ships each copy chunked over its threads and streams, concatenated on
    the device (the same bytes). ``feed_workers=N`` hands the host side of
    the producer (row gather, an optional picklable ``worker_augment``
    applied in float32 with per-(epoch, chunk) seeded draws, collation into
    the staged layout) to a :class:`~.workers.FeedWorkerPool` of N worker
    processes; without ``worker_augment`` the batches are bit-identical to
    the serial producer's. It needs an inner loader with in-memory arrays
    and no ``augmentation`` hook (its one sequential generator cannot be
    split; move the recipe to ``worker_augment``), and refuses
    ``transform``. ``worker_pool`` injects a caller-owned pool; ``close()``
    (or leaving ``with PrefetchLoader(...)``) releases an internally built
    one. ``device`` is where batches go (CUDA unless ``"cpu"``; by default
    the engine's device where one is given). ``sharding`` (a data-parallel
    placement) is not ported yet and raises.
    """

    def __init__(self, inner, depth: int = 2, sharding: Optional[Any] = None,
                 transform: Optional[Callable] = None,
                 device_transform: Optional[Callable] = None,
                 stage_batches: int = 1,
                 transfer_engine: Optional[Any] = None,
                 feed_workers: int = 0,
                 worker_augment: Optional[Callable] = None,
                 worker_pool: Optional[Any] = None, device=None):
        if sharding is not None:
            raise NotImplementedError(
                "PrefetchLoader(sharding=...): data-parallel placement is not "
                "ported to dcnn_tpu_torch yet (ROADMAP.md Queue 1 item 6, "
                "Parallel)")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if stage_batches < 1:
            raise ValueError("stage_batches must be >= 1")
        if feed_workers < 0:
            raise ValueError("feed_workers must be >= 0")
        self.inner = inner
        self.depth = depth
        self.transform = transform
        self.device_transform = device_transform
        self._auto_xform: Optional[Callable] = None
        self._auto_xform_ready = False
        self.stage_batches = stage_batches
        self.transfer_engine = transfer_engine
        self.feed_workers = feed_workers
        self.worker_augment = worker_augment
        self._pool = worker_pool
        self._own_pool = False
        if device is None and transfer_engine is not None:
            device = transfer_engine.device
        self.device = resolve_device(device)
        if self._pooled and transform is not None:
            raise ValueError(
                "transform= runs on the serial producer thread and cannot "
                "compose with the worker pool; express it as a picklable "
                "worker_augment (AugmentationStrategy) instead")

    # passthroughs, so a PrefetchLoader is a drop-in for Trainer.fit
    @property
    def batch_size(self):
        return self.inner.batch_size

    @property
    def num_samples(self):
        return self.inner.num_samples

    def __len__(self):
        return len(self.inner)

    def shuffle(self, epoch: int) -> None:
        if hasattr(self.inner, "shuffle"):
            self.inner.shuffle(epoch)

    @property
    def wire_dtype(self):
        """What the copy moves: the inner loader's wire dtype (the decode
        happens after the copy here)."""
        return getattr(self.inner, "wire_dtype", None)

    @property
    def scale(self):
        return getattr(self.inner, "scale", 1.0)

    def _device_xform(self) -> Optional[Callable]:
        """The explicit ``device_transform``, or the wire decode for a
        uint8 inner loader."""
        if self.device_transform is not None:
            return self.device_transform
        if not self._auto_xform_ready:
            wd = self.wire_dtype
            if wd is not None and np.dtype(wd) == np.uint8:
                from .wire import default_decode_transform
                self._auto_xform = default_decode_transform(float(self.scale))
            self._auto_xform_ready = True
        return self._auto_xform

    # -- worker-pool delegation -------------------------------------------
    @property
    def _pooled(self) -> bool:
        return self.feed_workers > 0 or self._pool is not None

    def close(self) -> None:
        """Release an internally built worker pool (idempotent); a
        caller-provided ``worker_pool`` is the caller's to close."""
        if self._own_pool and self._pool is not None:
            self._pool.close()
            self._pool = None
            self._own_pool = False

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - a finalizer must not raise
            pass

    def _ensure_pool(self):
        if self._pool is not None:
            return self._pool
        from .workers import FeedWorkerPool

        inner = self.inner
        if hasattr(inner, "_ensure_loaded"):
            inner._ensure_loaded()
        x = getattr(inner, "_x", None)
        y = getattr(inner, "_y", None)
        if x is None or y is None:
            raise ValueError(
                "feed_workers= needs a BaseDataLoader-style inner with "
                "in-memory arrays (the pool gathers rows itself); got "
                f"{type(inner).__name__}")
        self._pool = FeedWorkerPool(
            x, y, self.stage_batches * inner.batch_size,
            num_workers=self.feed_workers, augment=self.worker_augment,
            seed=getattr(inner, "seed", 0))
        self._own_pool = True
        return self._pool

    def _pool_plan(self):
        """The inner loader's batch plan (its ``batch_indices()``, the one
        definition of batch order) grouped into pool tasks along the staged
        chunks: full batches in groups of ``stage_batches``, a ragged tail
        batch on its own, so the pooled epoch yields the serial producer's
        chunks."""
        inner = self.inner
        if getattr(inner, "augmentation", None) is not None:
            raise ValueError(
                "the inner loader's augmentation hook draws from one "
                "sequential rng and cannot be parallelized bit-stably; "
                "move the recipe to worker_augment=")
        if not hasattr(inner, "batch_indices"):
            raise ValueError(
                "feed_workers= needs a BaseDataLoader-style inner exposing "
                "batch_indices() (the shared batch-order plan); got "
                f"{type(inner).__name__}")
        b = inner.batch_size
        sels, group = [], []
        for take in inner.batch_indices():
            if len(take) < b:
                if group:
                    sels.append(np.concatenate(group))
                    group = []
                sels.append(np.asarray(take, np.int64))
                continue
            group.append(np.asarray(take, np.int64))
            if len(group) == self.stage_batches:
                sels.append(np.concatenate(group))
                group = []
        if group:
            sels.append(np.concatenate(group))
        return sels

    # -- the copy ------------------------------------------------------------
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` onto the device on the current (side) stream: host copy
        into a pinned buffer, then a non-blocking copy from it."""
        arr = np.asarray(arr)
        pinned = torch.empty(arr.shape, dtype=torch_dtype(arr.dtype),
                             pin_memory=True)
        np.copyto(pinned.numpy(), arr)
        out = torch.empty(arr.shape, dtype=pinned.dtype, device=self.device)
        out.copy_(pinned, non_blocking=True)
        return out

    def _device_put(self, x, y, side):
        """One batch (or staged chunk) onto the device: ``(dx, dy,
        events)``; the source arrays may be reused when this returns."""
        xform = self._device_xform()
        if self.device.type != "cuda":
            dx = (self.transfer_engine.put_array(x)
                  if self.transfer_engine is not None
                  else torch.from_numpy(np.array(x)))
            dy = torch.from_numpy(np.array(y))
            if xform is not None:
                dx, dy = xform(dx, dy)
            return dx, dy, []
        if self.transfer_engine is not None:
            dx, x_events = self.transfer_engine.put_array_async(x)
        with torch.cuda.stream(side):
            if self.transfer_engine is not None:
                for ev in x_events:
                    side.wait_event(ev)
                dx.record_stream(side)
            else:
                dx = self._h2d(x)
            dy = self._h2d(y)
            if xform is not None:
                dx, dy = xform(dx, dy)
            ev = torch.cuda.Event()
            ev.record(side)
        return dx, dy, [ev]

    def _side_stream(self):
        return (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

    def _produce_pooled(self, q: queue.Queue, stop: threading.Event,
                        err: list) -> None:
        try:
            pool = self._ensure_pool()
            side = self._side_stream()
            epoch = int(getattr(self.inner, "_epoch", 0))
            b = self.inner.batch_size
            it = pool.shards(self._pool_plan(), epoch=epoch)
            try:
                for ps in it:
                    if stop.is_set():
                        return
                    xh, yh = ps.for_put()
                    if self.stage_batches > 1:
                        # the collated rows as [K, B, ...] (a view of the
                        # slot); a ragged tail ships as [1, B', ...]
                        k = max(ps.rows // b, 1) if ps.rows % b == 0 else 1
                        xh = xh.reshape(k, ps.rows // k, *xh.shape[1:])
                        yh = yh.reshape(k, ps.rows // k, *yh.shape[1:])
                    item = self._device_put(xh, yh, side)
                    del xh, yh
                    ps.release()  # the rows were copied out of the slot
                    q.put(item)
            finally:
                it.close()
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def produce():
            try:
                side = self._side_stream()
                if self.stage_batches == 1:
                    for x, y in self.inner:
                        if stop.is_set():
                            return
                        if self.transform is not None:
                            x, y = self.transform(x, y)
                        q.put(self._device_put(x, y, side))
                    return
                # staged: K host batches stacked into one [K, B, ...] copy
                xs, ys = [], []
                for x, y in self.inner:
                    if stop.is_set():
                        return
                    if self.transform is not None:
                        x, y = self.transform(x, y)
                    # a ragged batch cannot stack with full ones: flush, then
                    # ship it as its own chunk
                    if xs and x.shape[0] != xs[0].shape[0]:
                        q.put(self._device_put(np.stack(xs), np.stack(ys),
                                               side))
                        xs, ys = [], []
                    xs.append(x)
                    ys.append(y)
                    if len(xs) == self.stage_batches:
                        q.put(self._device_put(np.stack(xs), np.stack(ys),
                                               side))
                        xs, ys = [], []
                if xs and not stop.is_set():
                    q.put(self._device_put(np.stack(xs), np.stack(ys), side))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)
            finally:
                q.put(_SENTINEL)

        if self._pooled:
            produce = lambda: self._produce_pooled(q, stop, err)  # noqa: E731
        t = threading.Thread(target=produce, name="prefetch-producer",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                dx, dy, events = item
                land(events, dx, dy)
                yield dx, dy
        finally:
            # a consumer that stopped early: tell the producer to quit, then
            # drain to the sentinel so its bounded put cannot block forever
            stop.set()
            while t.is_alive() or not q.empty():
                try:
                    if q.get(timeout=0.1) is _SENTINEL:
                        break
                except queue.Empty:
                    continue
            t.join()
        if err:
            raise err[0]
