"""Streaming device feed for datasets larger than device memory (counterpart
of ``dcnn_tpu/data/streaming.py``).

The dataset lives in host memory as uint8 and streams through the device in
shards of K batches, double-buffered: while shard i trains (one call of the
shard step: shuffle on the device, then decode, augment, one-hot and K
train steps, the resident feed's body), a producer thread ships shard i+1
through the :class:`~.transfer.TransferEngine` (C chunks gathered in
parallel, copied from pinned buffers on the engine's streams) or, with
``workers``, through a :class:`~.workers.FeedWorkerPool` that gathers,
augments and packs each shard into shared-memory slots first. A queue of
depth 1 bounds device memory at about three shards (training, queued, in
transfer). The shard's losses stay on the device; the epoch reads their
mean once.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import native
from ..core.keys import fold_in, split
from ..core.precision import get_compute_dtype
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..resilience import faults as _faults
from .transfer import TransferEngine, land
from .workers import FeedWorkerPool


def make_shard_step(model, loss_fn: Callable, optimizer, *, num_classes: int,
                    batch_size: int, shard_batches: int,
                    augment: Optional[Callable] = None,
                    scale: float = 1.0 / 255.0, num_microbatches: int = 1):
    """Build the per-shard train call: ``step(ts, x_u8, y, key, lr) -> (ts,
    mean_loss)``, ``x_u8`` the shard's (K*B, ...) rows on the device (or the
    engine's chunk tuple, concatenated here), ``mean_loss`` a device
    scalar. The shard is shuffled on the device from ``split(key)[0]`` and
    runs the resident feed's batch body with step keys ``fold_in(split(key)
    [1], i)``."""
    from ..train.trainer import make_train_step
    from . import device_dataset as dd

    train_step = make_train_step(model, loss_fn, optimizer, num_microbatches)
    body = dd.BatchStep(train_step, num_classes=num_classes, scale=scale,
                        cdt=get_compute_dtype(), augment=augment)
    k, b = shard_batches, batch_size
    shard: list = []  # the body's rows: one buffer a shard is copied into

    def step(ts, x_u8, y, key: int, lr):
        if isinstance(x_u8, (tuple, list)):
            x_u8 = torch.cat(x_u8)
        if x_u8.shape[0] != k * b:
            raise ValueError(f"shard must hold exactly {k}x{b} samples, "
                             f"got {x_u8.shape[0]}")
        if not shard or shard[0].shape != x_u8.shape \
                or shard[0].dtype != x_u8.dtype \
                or shard[0].device != x_u8.device:
            shard[:] = [torch.empty_like(x_u8), torch.empty_like(y)]
        xs, ys = shard
        xs.copy_(x_u8)
        ys.copy_(y)
        kperm, kstep = split(key)
        dev = x_u8.device
        idx = dd.permutation(kperm, k * b, k * b, dev).reshape(k, b)
        lrs = dd.lr_per_step(lr, k, dev)
        losses = torch.stack([body(ts, xs, ys, idx[i], fold_in(kstep, i),
                                   lrs[i])
                              for i in range(k)])
        return ts, losses.mean()

    return step


class StreamingDeviceDataset:
    """A host uint8 split streamed through the device in double-buffered
    shards of ``shard_batches`` batches. Each epoch permutes the samples on
    the host (``np.random.default_rng(seed)``, the JAX package's draws), so
    shard membership and the dropped remainder rotate.

    ``workers``/``host_augment`` are the defaults of
    :func:`train_streaming_epoch`'s worker pool (0 and None: the serial
    producer)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int, *,
                 batch_size: int, shard_batches: int = 8, seed: int = 0,
                 workers: int = 0, host_augment=None):
        x = np.ascontiguousarray(x)
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(axis=-1)
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch {len(x)} vs {len(y)}")
        self.x, self.y = x, y.astype(np.int32)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        self.shard_batches = int(shard_batches)
        self.shard_samples = self.batch_size * self.shard_batches
        if len(x) < self.shard_samples:
            raise ValueError(
                f"dataset ({len(x)}) smaller than one shard "
                f"({self.shard_samples}); use DeviceDataset (resident) instead")
        self.num_shards = len(x) // self.shard_samples
        self.seed = int(seed)
        self.workers = int(workers)
        self.host_augment = host_augment
        self._rng = np.random.default_rng(seed)

    @property
    def steps_per_epoch(self) -> int:
        return self.num_shards * self.shard_batches

    def shard_selections(self):
        """One sorted int64 row selection per shard, from a fresh
        permutation of the samples (the unit the engine's chunk tasks
        gather from)."""
        perm = self._rng.permutation(len(self.x))
        for s in range(self.num_shards):
            sel = perm[s * self.shard_samples:(s + 1) * self.shard_samples]
            sel.sort()
            yield sel.astype(np.int64, copy=False)

    def shards(self):
        """(x_u8 shard, y shard) host arrays, gathered by
        ``native.gather_rows``."""
        for sel in self.shard_selections():
            yield native.gather_rows(self.x, sel), native.gather_rows(
                self.y, sel)


def _model_device(ts) -> torch.device:
    return next(ts.model.parameters()).device


def train_streaming_epoch(step, ts, dataset: StreamingDeviceDataset,
                          key: int, lr, *,
                          timeline: Optional[List[dict]] = None,
                          engine: Optional[TransferEngine] = None,
                          workers: Optional[int] = None,
                          host_augment=None,
                          worker_pool: Optional[FeedWorkerPool] = None,
                          epoch: int = 0):
    """One epoch: a producer thread ships shards to the model's device while
    the calling thread trains on the shard before. Shard ``i`` trains with
    the key ``fold_in(key, i)``.

    ``engine``: a caller-owned :class:`~.transfer.TransferEngine` (on the
    model's device); by default a private one of 4 chunks x 2 threads,
    closed on return. ``workers`` (default: the dataset's) hands the gather,
    an optional ``host_augment`` (an ``AugmentationStrategy`` in float32,
    re-quantized to uint8) and the packing to a
    :class:`~.workers.FeedWorkerPool` of that many processes; the producer
    ships filled slots through the engine and releases each after its
    copy has landed (hence a fenced engine). ``worker_pool`` passes a
    caller-owned pool, reused across epochs. The shards are bit-identical
    for every worker count; ``epoch`` seeds the per-shard augmentation.

    ``timeline``: a list that receives one dict per shard (``shard``,
    ``gather_s``, ``put_s``, ``feed_wall_s``, ``queue_wait_s``,
    ``dispatch_s``, ``put_done_t``, ``dispatch_t``, ``chunks``,
    ``inflight_max``, ``h2d_gbps``, ``bytes``, and ``prep`` from a pool).

    Returns (ts, mean loss as a float)."""
    t_epoch0 = time.perf_counter()
    device = _model_device(ts)
    if workers is None:
        workers = getattr(dataset, "workers", 0)
    if host_augment is None:
        host_augment = getattr(dataset, "host_augment", None)
    use_pool = worker_pool is not None or workers > 0 \
        or host_augment is not None
    # validate before building any owned resource
    if worker_pool is not None:
        if worker_pool.max_rows < dataset.shard_samples:
            raise ValueError(f"worker pool slots hold "
                             f"{worker_pool.max_rows} rows; the dataset's "
                             f"shards need {dataset.shard_samples}")
        pooled_workers = worker_pool.num_workers
    else:
        pooled_workers = workers
    if use_pool and pooled_workers > 0 and engine is not None \
            and not engine.fence:
        # a slot must not be rewritten before its bytes have landed
        raise ValueError("worker-pool feed requires a fenced "
                         "TransferEngine (fence=True)")
    if engine is not None and engine.device != device:
        raise ValueError(f"engine ships to {engine.device}, the model is "
                         f"on {device}")
    own_engine = engine is None
    if own_engine:
        engine = TransferEngine(num_chunks=4, num_threads=2,
                                reassemble="chunks", device=device)
    own_pool = worker_pool is None and use_pool
    pool = worker_pool
    if own_pool:
        try:
            pool = FeedWorkerPool(dataset.x, dataset.y,
                                  dataset.shard_samples,
                                  num_workers=workers, augment=host_augment,
                                  seed=getattr(dataset, "seed", 0))
        except BaseException:
            if own_engine:
                engine.close()
            raise
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        # never park in q.put for good: the consumer may have died and set
        # `stop`; re-check it every tick so the thread always exits
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def shard_plan():
        if hasattr(dataset, "shard_selections"):
            for sel in dataset.shard_selections():
                yield dataset.x, dataset.y, sel
        else:
            for sx, sy in dataset.shards():
                yield sx, sy, None

    def produce_pooled():
        it = pool.shards(dataset.shard_selections(), epoch=epoch)
        try:
            for i, ps in enumerate(it):
                if stop.is_set():
                    return
                _faults.trip("stream.produce", shard=i)
                sx_h, sy_h = ps.for_put()
                sx, sy, stats = engine.put_shard(sx_h, sy_h, None,
                                                 t_base=t_epoch0)
                prep = ps.stats
                del sx_h, sy_h
                ps.release()  # fenced engine: the copies have landed
                stats = dict(stats)
                stats["prep"] = {
                    "worker": prep.get("worker"),
                    "gather_s": prep["gather_s"],
                    "augment_s": prep["augment_s"],
                    "pack_s": prep["pack_s"],
                    "prep_s": prep["prep_s"],
                    "prep_t0": prep["gather_t0"] - t_epoch0,
                    "prep_t1": prep["pack_t1"] - t_epoch0,
                }
                if not put_or_stop(
                        (i, sx, sy, stats, time.perf_counter() - t_epoch0)):
                    return
        finally:
            it.close()

    def produce_serial():
        it = shard_plan()
        i = 0
        while not stop.is_set():
            nxt = next(it, None)
            if nxt is None:
                break
            # an armed "stream.produce" fault raises here at shard i: the
            # sentinel path below delivers it to the training loop
            _faults.trip("stream.produce", shard=i)
            sx, sy, stats = engine.put_shard(nxt[0], nxt[1], nxt[2],
                                             t_base=t_epoch0)
            if not put_or_stop(
                    (i, sx, sy, stats, time.perf_counter() - t_epoch0)):
                return
            i += 1

    def producer():
        # the last item is None or the producer's exception, never missing
        err = None
        try:
            if pool is not None:
                produce_pooled()
            else:
                produce_serial()
        except BaseException as e:  # noqa: BLE001 - forwarded, not dropped
            err = e
        put_or_stop(err)

    worker = threading.Thread(target=producer, name="stream-feed",
                              daemon=True)
    worker.start()
    losses = []
    fed_bytes = 0
    try:
        while True:
            t3 = time.perf_counter()
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            i, sx, sy, stats, put_done_t = item
            land(stats["events"], sx, sy)
            t4 = time.perf_counter()
            # the issue wall of the shard's step, not device time (the
            # engine's h2d.* spans carry the feed side)
            with get_tracer().span("train.shard_dispatch", track="train",
                                   shard=i):
                ts, loss = step(ts, sx, sy, fold_in(key, i), lr)
            t5 = time.perf_counter()
            del sx, sy
            losses.append(loss)
            fed_bytes += int(stats["bytes"])
            if timeline is not None:
                entry = {
                    "shard": i, "gather_s": stats["gather_s"],
                    "put_s": stats["put_s"],
                    "feed_wall_s": stats["wall_s"],
                    "queue_wait_s": t4 - t3, "dispatch_s": t5 - t4,
                    "put_done_t": put_done_t,
                    "dispatch_t": t5 - t_epoch0,
                    "chunks": stats["chunks"],
                    "inflight_max": stats["inflight_max"],
                    "h2d_gbps": stats["h2d_gbps"],
                    "bytes": stats["bytes"]}
                if "prep" in stats:
                    entry["prep"] = stats["prep"]
                timeline.append(entry)
    finally:
        stop.set()
        worker.join(timeout=60.0)
        if own_engine:
            engine.close()
        if own_pool:
            pool.close()
    fed_images = len(losses) * int(getattr(dataset, "shard_samples", 0))
    if fed_images:
        reg = get_registry()
        reg.gauge("feed_wire_bytes_per_image",
                  "bytes shipped host-to-device per image, last streaming "
                  "epoch").set(fed_bytes / fed_images)
        reg.gauge("feed_wire_epoch_bytes",
                  "total bytes shipped host-to-device, last streaming "
                  "epoch").set(float(fed_bytes))
    # one reduction on the device, one read
    mean = float(torch.stack(losses).mean()) if losses else 0.0
    return ts, mean
