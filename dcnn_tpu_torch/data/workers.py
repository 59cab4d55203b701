"""Parallel host input pipeline: a shared-memory worker pool for gather,
augment and collate (counterpart of ``dcnn_tpu/data/workers.py``), numpy
only.

::

    selections --> FeedWorkerPool --> ordered PreparedShard stream
                     |  task queue (epoch, shard, slot, sel)
                     +- worker 0 -+   gather -> augment -> pack
                     +- worker 1 -+   into a preallocated shared-memory
                     +- worker N -+   ring-buffer slot
                     result queue (+ per-phase walls)

- **Slots, not pickles.** Prepared shards land in preallocated
  ``multiprocessing.shared_memory`` slots (:class:`ShmSlots`;
  :class:`LocalSlots` is the in-process ring of the thread backend). The
  consumer gets numpy views of a slot and must copy them out before
  :meth:`PreparedShard.release`: the port's transfer engine and
  ``PrefetchLoader`` copy every put (into a pinned buffer on CUDA, into a
  fresh array on the CPU, where ``torch.from_numpy`` would alias the slot),
  and release the slot only after the copy (on CUDA: after the copy's
  event). A shard is dispatched only once a free slot is leased for it, so
  at most ``num_slots`` shards are in flight.
- **Determinism.** Augmentation draws from ``shard_rng(seed, epoch,
  shard)``, independent of the worker and of completion order, and results
  are delivered in shard order: the pool's output is bit-identical to
  :func:`serial_shards` for every worker count, and to the JAX package's
  pool for the same (seed, epoch, shard), since this is the same numpy
  code.
- **Failure degrades, never corrupts.** A worker that reports an error or
  dies mid-shard (liveness polling; an ``InjectedCrash`` at the
  ``feed.prepare`` fault point stands in for a kill) has its shard
  produced in-process, retried once; ``feed_worker_failures_total``
  counts the events. A stall with no worker busy rescues unclaimed
  shards.

Process start method: ``spawn`` by default. The parent is a CUDA process
with threads (the prefetch producer, the transfer pool), where ``fork`` is
unsafe; spawned workers import this module afresh, never touch CUDA, and
see the dataset through a shared-memory copy (which costs the dataset's
size in host memory once). ``mp_context="fork"`` shares the dataset
copy-on-write instead, the JAX package's default.

- **Gray failure is recycled** (``slow_detect``, default the
  ``DCNN_SLOW_DETECT`` env, off): every worker's prep wall feeds a
  :class:`~dcnn_tpu_torch.resilience.slowness.SlownessDetector`, and a
  worker convicted as a sustained outlier against its peers is retired
  through the worker-death fallback (``feed_worker_recycled_total``). The
  ``feed.slow_worker`` delay point (``FaultPlan.slow``) stretches a
  worker's prep wall. Output bytes never depend on which worker made them.
- Each shard's gather, augment and pack phases are replayed onto the
  tracer as ``feed.gather`` / ``feed.augment`` / ``feed.pack`` spans on a
  ``feed-w<i>`` track (``feed-inline`` for the parent).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .. import native
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..resilience import faults as _faults
from ..resilience.slowness import SlownessConfig, SlownessDetector
from ..utils.env import get_env

FALLBACK_RETRY_S = 0.05  # pause before the inline fallback's second try

__all__ = [
    "FeedWorkerPool", "PreparedShard", "ShmSlots", "LocalSlots",
    "host_shard_plan", "prepare_shard", "serial_shards", "shard_rng",
]


# ---------------------------------------------------------------------------
# deterministic shard preparation (the ONE definition both the serial path
# and every worker run — bit-identity between them is the whole contract)
# ---------------------------------------------------------------------------

def shard_rng(seed: int, epoch: int, shard: int) -> np.random.Generator:
    """The augmentation generator for one (epoch, shard) cell. Derivation
    must not involve the worker id or any completion order: any worker —
    or the serial path — preparing this shard draws the same stream."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=int(seed) & (2 ** 63 - 1),
                               spawn_key=(int(epoch), int(shard))))


def prepare_shard(x: np.ndarray, y: np.ndarray, sel: np.ndarray, *,
                  augment=None, rng: Optional[np.random.Generator] = None,
                  out_x: Optional[np.ndarray] = None,
                  out_y: Optional[np.ndarray] = None):
    """Gather rows ``sel`` of ``(x, y)``, optionally augment, and pack to
    the wire layout — into ``out_x``/``out_y`` (ring-buffer slot views)
    when given, fresh arrays otherwise.

    Phases (each stamped in the returned timings):

    - **gather** — row gather of ``x`` (``native.gather_rows`` chunk-
      parallel memcpy; ``np.take(out=)`` when gathering straight into a
      slot — bit-identical either way).
    - **augment** — uint8 → float32 decode + the
      :class:`~dcnn_tpu_torch.data.augment.AugmentationStrategy` pipeline,
      consuming ``rng``. Skipped (0 s) when ``augment`` is None.
    - **pack** — re-quantize to the wire dtype (uint8 datasets stay uint8
      on the wire: clip to [0, 255] + round-to-nearest), copy into the
      slot, and gather/pack the labels.

    Returns ``(x_out, y_out, timings)`` where ``timings`` carries absolute
    ``perf_counter`` start/end stamps per phase plus summed walls."""
    sel = np.ascontiguousarray(sel, np.int64)
    t_g0 = time.perf_counter()
    if augment is None:
        if out_x is None:
            xg = native.gather_rows(x, sel)
        else:
            np.take(x, sel, axis=0, out=out_x)
            xg = out_x
        t_g1 = t_a1 = t_p0 = time.perf_counter()
    else:
        if rng is None:
            raise ValueError("prepare_shard: augment requires rng "
                             "(use shard_rng(seed, epoch, shard))")
        raw = native.gather_rows(x, sel)
        t_g1 = time.perf_counter()
        xf = augment(raw.astype(np.float32), rng)
        if xf.shape != raw.shape:
            raise ValueError(f"augment changed the batch shape "
                             f"{raw.shape} -> {xf.shape}")
        t_a1 = t_p0 = time.perf_counter()
        if x.dtype == np.uint8:
            # uint8 wire format: clip + round-to-nearest, exact integers —
            # the unsafe cast below is then value-exact
            np.clip(xf, 0.0, 255.0, out=xf)
            np.rint(xf, out=xf)
            if out_x is None:
                xg = xf.astype(np.uint8)
            else:
                np.copyto(out_x, xf, casting="unsafe")
                xg = out_x
        else:
            if out_x is None:
                xg = np.ascontiguousarray(xf.astype(x.dtype, copy=False))
            else:
                np.copyto(out_x, xf, casting="unsafe")
                xg = out_x
    if out_y is None:
        yg = native.gather_rows(y, sel)
    else:
        np.take(y, sel, axis=0, out=out_y)
        yg = out_y
    t_p1 = time.perf_counter()
    timings = {
        "rows": int(sel.shape[0]),
        "gather_t0": t_g0, "gather_t1": t_g1,
        "augment_t0": t_g1, "augment_t1": t_a1,
        "pack_t0": t_p0, "pack_t1": t_p1,
        "gather_s": t_g1 - t_g0,
        "augment_s": t_a1 - t_g1,
        "pack_s": t_p1 - t_p0,
        "prep_s": t_p1 - t_g0,
    }
    return xg, yg, timings


def serial_shards(x: np.ndarray, y: np.ndarray, selections: Iterable, *,
                  augment=None, seed: int = 0, epoch: int = 0):
    """The serial reference path: prepare every shard in the calling
    thread, same RNG derivation as the pool — the bit-identity baseline
    the worker pool is asserted against. Yields ``(x, y, timings)``."""
    for i, sel in enumerate(selections):
        rng = shard_rng(seed, epoch, i) if augment is not None else None
        yield prepare_shard(x, y, sel, augment=augment, rng=rng)


def host_shard_plan(loader, epoch: int, rank: int, world_size: int,
                    start_step: int = 0):
    """The world-size-parameterized selection plan for a
    :class:`FeedWorkerPool` feeding ONE host of a data-parallel group:
    this host's per-step row-index arrays for ``epoch``, starting at
    global step ``start_step`` within the epoch.

    Derived from ``BaseDataLoader.shard_batch_indices`` — the single
    batch-order definition — so a reshard re-plans the pool by simply
    calling this again with the new ``(rank, world_size)`` and the
    restored ``start_step``: the union over hosts of the new plan is
    bit-identical to the old global batch sequence, only the per-host
    split moves. This is the *equal-split* view (requires
    ``batch_size % world_size == 0``); the elastic controller
    (``parallel/elastic.py``) derives its pool selections from the same
    ``batch_indices`` plan via its microbatch-grid span instead, which
    also covers uneven degraded worlds. Selections are materialized
    (list) because the pool may be driven multiple times from the same
    plan across a retry."""
    loader.shuffle(epoch)
    plan = [np.ascontiguousarray(sel, np.int64)
            for sel in loader.shard_batch_indices(rank, world_size)]
    if not 0 <= start_step <= len(plan):
        raise ValueError(f"start_step {start_step} outside epoch of "
                         f"{len(plan)} steps")
    return plan[start_step:]


# ---------------------------------------------------------------------------
# slot allocators: the preallocated ring the pool writes through
# ---------------------------------------------------------------------------

def _align64(n: int) -> int:
    return (n + 63) & ~63


class _SlotGeometry:
    """Shared layout math for both allocators: per slot, the x region at
    offset 0 and the y region at the next 64-byte boundary."""

    def __init__(self, max_rows: int, x_row_shape: Tuple[int, ...],
                 x_dtype, y_row_shape: Tuple[int, ...], y_dtype):
        self.max_rows = int(max_rows)
        self.x_row_shape = tuple(int(d) for d in x_row_shape)
        self.x_dtype = np.dtype(x_dtype)
        self.y_row_shape = tuple(int(d) for d in y_row_shape)
        self.y_dtype = np.dtype(y_dtype)
        x_row = self.x_dtype.itemsize * int(
            np.prod(self.x_row_shape, dtype=np.int64))
        y_row = self.y_dtype.itemsize * int(
            np.prod(self.y_row_shape, dtype=np.int64))
        self.y_offset = _align64(self.max_rows * x_row)
        self.nbytes = max(self.y_offset + self.max_rows * y_row, 1)

    def x_view(self, buf, rows: int) -> np.ndarray:
        return np.ndarray((rows, *self.x_row_shape), self.x_dtype,
                          buffer=buf, offset=0)

    def y_view(self, buf, rows: int) -> np.ndarray:
        return np.ndarray((rows, *self.y_row_shape), self.y_dtype,
                          buffer=buf, offset=self.y_offset)

    def spec(self) -> dict:
        return {"max_rows": self.max_rows,
                "x_row_shape": self.x_row_shape,
                "x_dtype": self.x_dtype.str,
                "y_row_shape": self.y_row_shape,
                "y_dtype": self.y_dtype.str}

    @classmethod
    def from_spec(cls, spec: dict) -> "_SlotGeometry":
        return cls(spec["max_rows"], spec["x_row_shape"], spec["x_dtype"],
                   spec["y_row_shape"], spec["y_dtype"])


class LocalSlots:
    """In-process slot ring (plain numpy buffers) — the "fake" allocator:
    same interface and layout as :class:`ShmSlots` without OS shared
    memory, for the thread backend and sleep-free tier-1 tests."""

    def __init__(self, num_slots: int, max_rows: int, x_row_shape, x_dtype,
                 y_row_shape, y_dtype):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.geom = _SlotGeometry(max_rows, x_row_shape, x_dtype,
                                  y_row_shape, y_dtype)
        self.num_slots = int(num_slots)
        self._bufs = [np.zeros(self.geom.nbytes, np.uint8)
                      for _ in range(self.num_slots)]

    def x_view(self, slot: int, rows: int) -> np.ndarray:
        return self.geom.x_view(self._bufs[slot].data, rows)

    def y_view(self, slot: int, rows: int) -> np.ndarray:
        return self.geom.y_view(self._bufs[slot].data, rows)

    def close(self) -> None:
        self._bufs = []


class ShmSlots:
    """``multiprocessing.shared_memory`` slot ring: one segment per slot,
    created by the parent, attached by name in worker processes. The
    parent owns the segments (``close()`` unlinks); workers only close
    their mappings."""

    def __init__(self, num_slots: int, max_rows: int, x_row_shape, x_dtype,
                 y_row_shape, y_dtype, *, _attach: Optional[dict] = None):
        from multiprocessing import shared_memory

        if _attach is not None:
            self.geom = _SlotGeometry.from_spec(_attach)
            self._owner = False
            # NB: attaching re-registers the name with the resource
            # tracker, but parent and workers share one tracker process
            # (fd inherited at start) whose cache is a set — the duplicate
            # collapses, and the parent's unlink unregisters it once.
            self._segs = [shared_memory.SharedMemory(name=n)
                          for n in _attach["names"]]
            self.num_slots = len(self._segs)
            return
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.geom = _SlotGeometry(max_rows, x_row_shape, x_dtype,
                                  y_row_shape, y_dtype)
        self.num_slots = int(num_slots)
        self._owner = True
        self._segs = [shared_memory.SharedMemory(create=True,
                                                 size=self.geom.nbytes)
                      for _ in range(self.num_slots)]

    def spec(self) -> dict:
        s = self.geom.spec()
        s["names"] = [seg.name for seg in self._segs]
        return s

    @classmethod
    def attach(cls, spec: dict) -> "ShmSlots":
        return cls(0, 0, (), np.uint8, (), np.uint8, _attach=spec)

    def x_view(self, slot: int, rows: int) -> np.ndarray:
        return self.geom.x_view(self._segs[slot].buf, rows)

    def y_view(self, slot: int, rows: int) -> np.ndarray:
        return self.geom.y_view(self._segs[slot].buf, rows)

    def close(self) -> None:
        for seg in self._segs:
            try:
                seg.close()
            except BufferError:
                # a consumer still holds a slot view; leak the mapping
                # rather than crash teardown — the segment is unlinked
                # below so the OS reclaims it when the view dies
                pass
            if self._owner:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
        self._segs = []

    def __del__(self):
        # a ring abandoned without close() (an injected slots= allocator
        # whose pool construction raised, an interrupted test) must not
        # leak named OS segments until the resource tracker's exit sweep;
        # close() is idempotent and BufferError/FileNotFoundError-safe
        try:
            self.close()
        except Exception:
            pass


class _SharedArray:
    """A read-only dataset copy in shared memory (spawn backend: the only
    way a worker can see the dataset without per-task pickling)."""

    def __init__(self, shm, view: np.ndarray, owner: bool):
        self._shm = shm
        self.view = view
        self._owner = owner

    @classmethod
    def create(cls, arr: np.ndarray) -> "_SharedArray":
        from multiprocessing import shared_memory

        arr = np.ascontiguousarray(arr)
        shm = shared_memory.SharedMemory(create=True,
                                         size=max(arr.nbytes, 1))
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
        view[...] = arr
        return cls(shm, view, owner=True)

    def spec(self) -> tuple:
        return (self._shm.name, self.view.shape, self.view.dtype.str)

    @classmethod
    def attach(cls, spec: tuple) -> "_SharedArray":
        from multiprocessing import shared_memory

        name, shape, dtype = spec
        shm = shared_memory.SharedMemory(name=name)
        return cls(shm, np.ndarray(shape, np.dtype(dtype), buffer=shm.buf),
                   owner=False)

    def close(self) -> None:
        view, self.view = self.view, None
        del view
        try:
            self._shm.close()
        except BufferError:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# worker body (runs in a thread or a child process)
# ---------------------------------------------------------------------------

def _worker_loop(wid: int, task_get, result_put, x, y, slots, augment,
                 seed: int, retired=None) -> None:
    """Take ``(epoch, shard, slot, sel)`` tasks until the ``None``
    sentinel. The ``feed.prepare`` fault point sits between the claim
    report and the work: an armed ``InjectedCrash`` there stands in for a
    worker lost mid-shard (no report; the parent notices by liveness), any
    other armed fault exercises the error report. The ``feed.slow_worker``
    delay point stretches the prep wall the parent's recycler judges.
    ``retired`` (thread backend) is the recycle flag: a convicted worker
    refuses its next claim and exits, and the parent produces the shard
    inline, the worker-death fallback."""
    while True:
        task = task_get()
        if task is None:
            return
        epoch, idx, slot_id, sel = task
        if retired is not None and retired():
            result_put(("retired", wid, epoch, idx))
            return
        result_put(("start", wid, epoch, idx))
        try:
            _faults.trip("feed.prepare", worker=wid, shard=idx)
            rows = int(sel.shape[0])
            out_x = slots.x_view(slot_id, rows)
            out_y = slots.y_view(slot_id, rows)
            rng = (shard_rng(seed, epoch, idx)
                   if augment is not None else None)
            _, _, t = prepare_shard(x, y, sel, augment=augment, rng=rng,
                                    out_x=out_x, out_y=out_y)
            del out_x, out_y
            extra = _faults.slowdown("feed.slow_worker", t["prep_s"],
                                     worker=wid, shard=idx)
            if extra > 0.0:
                # sleep inside the shard and fold the stretch into the
                # reported walls: the parent sees a slow worker
                time.sleep(extra)
                t["pack_t1"] += extra
                t["pack_s"] += extra
                t["prep_s"] += extra
            t["worker"] = wid
            result_put(("done", wid, epoch, idx, t))
        except _faults.InjectedCrash:
            raise  # a stand-in for SIGKILL: report nothing, just die
        except BaseException as e:  # noqa: BLE001 - reported, not dropped
            result_put(("error", wid, epoch, idx, repr(e)))


def _process_worker_main(wid, task_q, result_q, dataset, slots_spec,
                         augment, seed):
    """Child-process entry: resolve the dataset (inherited directly under
    fork, attached from shared memory under spawn), attach the slot ring,
    run the loop. An InjectedCrash hard-exits (``os._exit``) so no Python
    cleanup runs, the closest stand-in for a preemption. The child never
    touches CUDA."""
    if dataset[0] == "direct":
        shared = []
        x, y = dataset[1], dataset[2]
    else:
        sx = _SharedArray.attach(dataset[1])
        sy = _SharedArray.attach(dataset[2])
        shared = [sx, sy]
        x, y = sx.view, sy.view
    slots = ShmSlots.attach(slots_spec)
    try:
        _worker_loop(wid, task_q.get, result_q.put, x, y, slots, augment,
                     seed)
    except _faults.InjectedCrash:
        os._exit(13)
    finally:
        slots.close()
        for s in shared:
            s.close()


class _WorkerHandle:
    """Uniform liveness surface over a worker thread or process."""

    def __init__(self, wid: int, impl):
        self.wid = wid
        self.impl = impl
        self.reported_dead = False

    def is_alive(self) -> bool:
        return self.impl.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self.impl.join(timeout)

    def terminate(self) -> None:
        if hasattr(self.impl, "terminate"):
            self.impl.terminate()


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class PreparedShard:
    """One prepared shard, leased from the ring. ``x``/``y`` are numpy
    views of the slot (or plain arrays for inline-fallback rescues) —
    valid until :meth:`release`. ``stats`` carries the worker id and
    per-phase walls."""

    __slots__ = ("idx", "x", "y", "rows", "stats", "_pool", "_slot",
                 "_released")

    def __init__(self, idx, x, y, rows, stats, pool, slot):
        self.idx = idx
        self.x = x
        self.y = y
        self.rows = rows
        self.stats = stats
        self._pool = pool
        self._slot = slot
        self._released = False

    @property
    def leased(self) -> bool:
        """True when ``x``/``y`` are views of a recyclable ring slot (a
        consumer must then have copied them, and on CUDA seen the copy
        land, before :meth:`release`); False for materialized arrays
        (serial path, inline rescues)."""
        return self._slot is not None

    def for_put(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(x, y)`` to copy from before :meth:`release`: the slot views
        themselves. Every put of the port copies (``torch.from_numpy``
        would alias the slot; the transfer engine and ``PrefetchLoader``
        never hand it a slot view)."""
        return self.x, self.y

    def release(self) -> None:
        """Return the slot to the ring (idempotent). Call once the bytes
        have been copied out, e.g. after a fenced
        ``TransferEngine.put_shard``."""
        if self._released:
            return
        self._released = True
        self.x = self.y = None  # drop buffer views before any shm close
        if self._slot is not None:
            self._pool._release_slot(self._slot)


class FeedWorkerPool:
    """Multiprocess (or thread) input-worker pool over a slot ring.

    Args:
      x, y: the host dataset (rows gathered by ``sel`` per task). Kept by
        reference for inline fallback; workers see it through shared
        memory (spawn), copy-on-write (fork) or directly (threads).
      max_rows: slot capacity in rows (= the largest shard this pool will
        be asked to prepare).
      num_workers: worker count. 0 is allowed and means "no workers":
        :meth:`shards` degenerates to the serial path in the calling
        thread (same RNG derivation — the bit-identity reference).
      augment: optional picklable batch callable
        (:class:`~dcnn_tpu_torch.data.augment.AugmentationStrategy`) applied by
        the workers in float32, re-quantized to the wire dtype.
      seed: augmentation seed (feeds :func:`shard_rng`).
      num_slots: ring depth — the back-pressure bound on in-flight shards
        (default ``num_workers + 2``: one being consumed, workers busy,
        one queued ahead).
      backend: ``"process"`` (default) or ``"thread"`` (no processes —
        numpy gathers release the GIL, and tests run sleep-free).
      mp_context: multiprocessing start method (default ``spawn``; the
        module docstring says why).
      slots: a pre-built allocator (:class:`ShmSlots` / :class:`LocalSlots`)
        — injectable for tests; defaults to ShmSlots for processes,
        LocalSlots for threads.
      poll_s: result-queue poll interval — also the worker-death detection
        latency bound.
      stall_timeout_s: with no worker message for this long and work
        outstanding, unclaimed shards are rescued inline (covers the
        narrow task-lost-with-its-worker window).
      slow_detect: enable the gray-failure recycler (default: the
        ``DCNN_SLOW_DETECT`` env, off). Per-worker prep walls feed a
        :class:`~dcnn_tpu_torch.resilience.slowness.SlownessDetector`; a
        convicted worker (a sustained outlier against its peers; a
        fleet-wide slowdown convicts nobody) is retired through the
        worker-death fallback and counted on ``feed_worker_recycled_total``.
        Shard RNG never involves the worker id, so the bytes are unchanged.
      slow_config: detector knobs (default ``min_peers=2`` and the
        ``DCNN_SLOW_*`` env overrides).
      registry, tracer: where the counters and the feed spans go (the
        process-global ones by default).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, max_rows: int, *,
                 num_workers: int, augment=None, seed: int = 0,
                 num_slots: Optional[int] = None, backend: str = "process",
                 mp_context: Optional[str] = None, slots=None,
                 poll_s: float = 0.1, stall_timeout_s: float = 120.0,
                 slow_detect: Optional[bool] = None,
                 slow_config: Optional[SlownessConfig] = None,
                 registry=None, tracer=None):
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        if backend not in ("process", "thread"):
            raise ValueError(f"backend must be 'process' or 'thread', "
                             f"got {backend!r}")
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch {len(x)} vs {len(y)}")
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        self.max_rows = int(max_rows)
        self.num_workers = int(num_workers)
        self.augment = augment
        self.seed = int(seed)
        self.backend = backend
        self.poll_s = float(poll_s)
        self.stall_timeout_s = float(stall_timeout_s)
        self.num_slots = int(num_slots if num_slots is not None
                             else self.num_workers + 2)
        self._tracer = tracer
        reg = registry if registry is not None else get_registry()
        self._c_shards = reg.counter("feed_shards_total",
                                     "shards prepared by the feed pool")
        self._c_fail = reg.counter("feed_worker_failures_total",
                                   "feed worker errors/deaths recovered "
                                   "by inline fallback")
        self._c_recycled = reg.counter(
            "feed_worker_recycled_total",
            "slow (gray-failing) feed workers recycled through the "
            "worker-death fallback")
        self._g_depth = reg.gauge("feed_queue_depth",
                                  "feed shards in flight (leased slots)")
        self._g_busy = reg.gauge("feed_workers_busy",
                                 "feed workers currently preparing a shard")
        self._g_free = reg.gauge("feed_slots_free",
                                 "free feed ring-buffer slots")

        self.slow_detect = (get_env("DCNN_SLOW_DETECT", False)
                            if slow_detect is None else bool(slow_detect))
        self._slowness = SlownessDetector(SlownessConfig.from_env(
            slow_config if slow_config is not None
            else SlownessConfig(min_peers=2)))
        self._retired: set = set()

        self._closed = False
        self._active = False
        self._broken: Optional[str] = None
        self._busy: set = set()
        # (epoch, shard) -> slot: slots poisoned by a stall rescue — an
        # unclaimed task MIGHT still be produced by a worker later, so its
        # slot stays out of the ring until that late result (if ever)
        # settles it. Pool-level: late results can cross epoch boundaries.
        self._poisoned: Dict[Tuple[int, int], int] = {}
        self._workers: List[_WorkerHandle] = []
        self._shared_dataset: List[_SharedArray] = []
        self._own_slots = slots is None

        if self.num_workers == 0:
            self.slots = slots
            self._task_q = self._result_q = None
            return

        if backend == "thread":
            self.slots = slots if slots is not None else LocalSlots(
                self.num_slots, self.max_rows, self.x.shape[1:],
                self.x.dtype, self.y.shape[1:], self.y.dtype)
            self._task_q: queue.Queue = queue.Queue()
            self._result_q: queue.Queue = queue.Queue()
            for wid in range(self.num_workers):
                t = threading.Thread(
                    target=self._thread_worker_main, args=(wid,),
                    name=f"feed-w{wid}", daemon=True)
                t.start()
                self._workers.append(_WorkerHandle(wid, t))
        else:
            import multiprocessing as mp

            method = mp_context or "spawn"
            ctx = mp.get_context(method)
            self.slots = slots if slots is not None else ShmSlots(
                self.num_slots, self.max_rows, self.x.shape[1:],
                self.x.dtype, self.y.shape[1:], self.y.dtype)
            if not isinstance(self.slots, ShmSlots):
                raise ValueError("process backend requires ShmSlots "
                                 "(workers attach by name)")
            if method == "fork":
                dataset = ("direct", self.x, self.y)
            else:
                sx = _SharedArray.create(self.x)
                sy = _SharedArray.create(self.y)
                self._shared_dataset = [sx, sy]
                dataset = ("shm", sx.spec(), sy.spec())
            self._task_q = ctx.Queue()
            self._result_q = ctx.Queue()
            for wid in range(self.num_workers):
                p = ctx.Process(
                    target=_process_worker_main,
                    args=(wid, self._task_q, self._result_q, dataset,
                          self.slots.spec(), self.augment, self.seed),
                    name=f"feed-w{wid}", daemon=True)
                p.start()
                self._workers.append(_WorkerHandle(wid, p))

        self._free: queue.Queue = queue.Queue()
        for sid in range(self.num_slots):
            self._free.put(sid)
        self._g_free.set(self.num_slots)

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "FeedWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        # last-resort cleanup for abandoned pools (a Trainer-held loader
        # dropped without close()): unlinks the shm ring instead of
        # leaking it to the resource tracker's shutdown sweep. Short join
        # budget — finalizers must not hang teardown.
        try:
            if not getattr(self, "_closed", True):
                self.close(timeout=1.0)
        except Exception:
            pass

    def alive_workers(self) -> int:
        return sum(1 for h in self._workers if h.is_alive())

    def close(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: sentinel every worker, join, terminate
        stragglers (process backend), release shared memory."""
        if self._closed:
            return
        self._closed = True
        if self._task_q is not None:
            for _ in self._workers:
                try:
                    self._task_q.put(None)
                except Exception:
                    break
        deadline = time.monotonic() + timeout
        for h in self._workers:
            h.join(max(deadline - time.monotonic(), 0.1))
            if h.is_alive():
                h.terminate()
                h.join(1.0)
        if self._own_slots and self.slots is not None:
            self.slots.close()
        for s in self._shared_dataset:
            s.close()
        self._shared_dataset = []
        for q_ in (self._task_q, self._result_q):
            if q_ is not None and hasattr(q_, "close"):
                q_.close()
                q_.cancel_join_thread()
        self._g_busy.set(0)
        self._g_depth.set(0)

    # -- internals ---------------------------------------------------------
    def _thread_worker_main(self, wid: int) -> None:
        try:
            _worker_loop(wid, self._task_q.get, self._result_q.put,
                         self.x, self.y, self.slots, self.augment, self.seed,
                         retired=lambda: wid in self._retired)
        except _faults.InjectedCrash:
            return  # simulated hard death: exit silently, liveness notices

    def _release_slot(self, sid: int) -> None:
        self._free.put(sid)
        self._g_free.set(self._free.qsize())

    def _note_worker_wall(self, wid, prep_s: float) -> None:
        """Gray-failure recycler: score this worker's prep wall against its
        peers; a convicted worker is retired through the worker-death
        fallback."""
        if not isinstance(wid, int) or wid in self._retired:
            return  # "inline" rescues are the parent; a retired worker's
            # straggling report must not re-enter the forgotten score
        self._slowness.observe(f"w{wid}", prep_s)
        for tr in self._slowness.evaluate():
            if tr["to"] == "convicted":
                self._recycle_worker(int(str(tr["component"])[1:]))

    def _recycle_worker(self, wid: int) -> None:
        h = next((h for h in self._workers if h.wid == wid), None)
        if h is None or h.reported_dead or wid in self._retired:
            return
        if self.alive_workers() <= 1:
            return  # never retire the last producer
        self._retired.add(wid)
        self._slowness.forget(f"w{wid}")
        self._c_recycled.inc()
        # process backend: kill now (the death fallback rescues its
        # in-flight shard); thread backend: the retired() flag makes the
        # worker refuse its next claim and exit
        h.terminate()

    def _emit_spans(self, idx: int, t: dict) -> None:
        tr = self._tracer if self._tracer is not None else get_tracer()
        wid = t.get("worker", "inline")
        track = f"feed-w{wid}" if wid != "inline" else "feed-inline"
        rows = t.get("rows")
        tr.record_span("feed.gather", t["gather_t0"], t["gather_t1"],
                       track=track, shard=idx, rows=rows)
        if t["augment_s"] > 0:
            tr.record_span("feed.augment", t["augment_t0"], t["augment_t1"],
                           track=track, shard=idx, rows=rows)
        tr.record_span("feed.pack", t["pack_t0"], t["pack_t1"],
                       track=track, shard=idx, rows=rows)

    def _produce_inline(self, epoch: int, idx: int, sel: np.ndarray,
                        slot: Optional[int]) -> dict:
        """In-process fallback production (worker error/death), tried
        twice; a fresh rng per attempt, so a half-consumed stream never
        leaks between tries."""
        def attempt():
            rng = (shard_rng(self.seed, epoch, idx)
                   if self.augment is not None else None)
            if slot is not None:
                rows = int(sel.shape[0])
                out_x = self.slots.x_view(slot, rows)
                out_y = self.slots.y_view(slot, rows)
                _, _, t = prepare_shard(self.x, self.y, sel,
                                        augment=self.augment, rng=rng,
                                        out_x=out_x, out_y=out_y)
                return {"timings": t}
            xg, yg, t = prepare_shard(self.x, self.y, sel,
                                      augment=self.augment, rng=rng)
            return {"timings": t, "arrays": (xg, yg)}

        try:
            out = attempt()
        except Exception:  # noqa: BLE001 - one retry; a second failure raises
            time.sleep(FALLBACK_RETRY_S)
            out = attempt()
        out["timings"]["worker"] = "inline"
        return out

    def _prepared(self, idx: int, info: dict) -> PreparedShard:
        rows = int(info["sel"].shape[0])
        self._c_shards.inc()
        self._emit_spans(idx, info["timings"])
        if info.get("arrays") is not None:
            xg, yg = info["arrays"]
            return PreparedShard(idx, xg, yg, rows, info["timings"],
                                 self, None)
        sid = info["slot"]
        return PreparedShard(idx, self.slots.x_view(sid, rows),
                             self.slots.y_view(sid, rows), rows,
                             info["timings"], self, sid)

    def _handle_dead_workers(self, inflight: Dict[int, dict],
                             ready: Dict[int, dict], epoch: int) -> bool:
        """Liveness sweep: shards claimed by a newly-dead worker are
        produced inline; once NO worker is left, the task queue is drained
        and everything still in flight is produced inline."""
        newly = [h for h in self._workers
                 if not h.reported_dead and not h.is_alive()]
        if not newly:
            return False
        for h in newly:
            h.reported_dead = True
        dead_wids = {h.wid for h in newly}
        self._busy -= dead_wids
        self._g_busy.set(len(self._busy))
        for i, info in list(inflight.items()):
            if info["wid"] in dead_wids:
                self._c_fail.inc()
                res = self._produce_inline(epoch, i, info["sel"],
                                           info["slot"])
                info["timings"] = res["timings"]
                ready[i] = inflight.pop(i)
        if self.alive_workers() == 0:
            # no one left to claim queued tasks: drain + inline the rest
            while True:
                try:
                    task = self._task_q.get_nowait()
                except (queue.Empty, OSError, ValueError):
                    break
                if task is None:
                    continue
            for i, info in list(inflight.items()):
                self._c_fail.inc()
                res = self._produce_inline(epoch, i, info["sel"],
                                           info["slot"])
                info["timings"] = res["timings"]
                ready[i] = inflight.pop(i)
        self._g_depth.set(len(inflight))
        return True

    def _rescue_stalled(self, inflight: Dict[int, dict],
                        ready: Dict[int, dict], epoch: int) -> None:
        """Stall scavenger for the narrow task-lost window (a worker died
        between dequeuing a task and reporting its claim): no message for
        ``stall_timeout_s``, unclaimed shards outstanding, and — the
        guard that keeps slow-but-healthy epochs untouched — NO live
        worker mid-shard. A busy worker means progress is coming; queued
        tasks behind it are merely waiting, not lost. Rescued shards are
        produced inline into fresh arrays; the leased slot moves to the
        poisoned ledger (a worker could still pop the task and write) and
        returns to the ring only when/if its late result arrives."""
        live = {h.wid for h in self._workers if h.is_alive()}
        if self._busy & live:
            return
        for i, info in list(inflight.items()):
            if info["wid"] is None:
                self._c_fail.inc()
                res = self._produce_inline(epoch, i, info["sel"], None)
                ready[i] = {"sel": info["sel"], "slot": None,
                            "timings": res["timings"],
                            "arrays": res.get("arrays")}
                self._poisoned[(epoch, i)] = info["slot"]
                inflight.pop(i)
        self._g_depth.set(len(inflight))

    def _pump(self, inflight: Dict[int, dict], ready: Dict[int, dict],
              epoch: int, discard: bool = False) -> bool:
        """Wait for one worker message (or the poll tick) and fold it into
        the epoch state. Returns True if anything progressed."""
        try:
            msg = self._result_q.get(timeout=self.poll_s)
        except queue.Empty:
            return self._handle_dead_workers(inflight, ready, epoch)
        kind, wid, msg_epoch, idx = msg[0], msg[1], msg[2], msg[3]
        if kind == "start":
            if msg_epoch == epoch and idx in inflight:
                inflight[idx]["wid"] = wid
            self._busy.add(wid)
            self._g_busy.set(len(self._busy))
            return True
        # done, error and retired all end the worker's claim
        self._busy.discard(wid)
        self._g_busy.set(len(self._busy))
        sid = self._poisoned.pop((msg_epoch, idx), None)
        if sid is not None:
            # late result for a shard already rescued inline (possibly in
            # a prior epoch): the slot is finally safe to recycle, the
            # result itself is dropped
            self._release_slot(sid)
            return True
        if msg_epoch != epoch or idx not in inflight:
            return True  # stale: a drained epoch already settled this
        info = inflight.pop(idx)
        if kind == "done":
            info["timings"] = msg[4]
            if self.slow_detect:
                self._note_worker_wall(wid, msg[4].get("prep_s", 0.0))
            if discard:
                self._release_slot(info["slot"])
            else:
                ready[idx] = info
        elif discard:
            # errored/refused shard during abandoned-epoch teardown: nobody
            # will consume it — just recycle the slot, don't re-produce
            # data that would immediately be dropped
            self._c_fail.inc()
            self._release_slot(info["slot"])
        else:  # "error"/"retired": the shard is produced inline
            self._c_fail.inc()
            res = self._produce_inline(epoch, idx, info["sel"], info["slot"])
            info["timings"] = res["timings"]
            ready[idx] = info
        self._g_depth.set(len(inflight))
        return True

    # -- API ---------------------------------------------------------------
    def shards(self, selections: Iterable, *,
               epoch: int = 0) -> Iterator[PreparedShard]:
        """Prepare every selection and yield :class:`PreparedShard`\\ s in
        shard order, regardless of worker completion order. The caller
        must ``release()`` each shard once its bytes are on the wire; at
        most ``num_slots`` shards are ever in flight (back-pressure).

        With ``num_workers=0`` this is exactly :func:`serial_shards` in
        the calling thread."""
        if self._closed:
            raise RuntimeError("FeedWorkerPool is closed")
        if self._broken:
            raise RuntimeError(f"FeedWorkerPool is broken: {self._broken}")
        if self.num_workers == 0:
            for i, (xg, yg, t) in enumerate(serial_shards(
                    self.x, self.y, selections, augment=self.augment,
                    seed=self.seed, epoch=epoch)):
                self._c_shards.inc()
                self._emit_spans(i, t)
                yield PreparedShard(i, xg, yg, int(xg.shape[0]), t, self,
                                    None)
            return
        if self._active:
            raise RuntimeError("a previous shards() iterator is still "
                               "active on this pool")
        self._active = True
        it = iter(enumerate(selections))
        inflight: Dict[int, dict] = {}
        ready: Dict[int, dict] = {}
        exhausted = False
        next_idx = 0
        last_progress = time.monotonic()
        try:
            while True:
                while not exhausted:
                    try:
                        sid = self._free.get_nowait()
                    except queue.Empty:
                        break
                    nxt = next(it, None)
                    if nxt is None:
                        self._release_slot(sid)
                        exhausted = True
                        break
                    i, sel = nxt
                    sel = np.ascontiguousarray(sel, np.int64)
                    if sel.ndim != 1:
                        raise ValueError("selections must be 1-D row-index "
                                         "arrays")
                    if sel.shape[0] > self.max_rows:
                        raise ValueError(
                            f"shard of {sel.shape[0]} rows exceeds the "
                            f"pool's slot capacity {self.max_rows}")
                    inflight[i] = {"slot": sid, "sel": sel, "wid": None}
                    self._g_free.set(self._free.qsize())
                    self._g_depth.set(len(inflight))
                    if self.alive_workers() == 0:
                        # fully degraded: every worker is gone (their queue
                        # was drained when the last one died) — produce
                        # straight into the leased slot in-process
                        self._c_fail.inc()
                        res = self._produce_inline(epoch, i, sel, sid)
                        info = inflight.pop(i)
                        info["timings"] = res["timings"]
                        ready[i] = info
                        self._g_depth.set(len(inflight))
                    else:
                        self._task_q.put((epoch, i, sid, sel))
                if next_idx in ready:
                    info = ready.pop(next_idx)
                    ps = self._prepared(next_idx, info)
                    next_idx += 1
                    last_progress = time.monotonic()
                    yield ps
                    continue
                if exhausted and not inflight and not ready:
                    return
                if self._pump(inflight, ready, epoch):
                    last_progress = time.monotonic()
                elif (time.monotonic() - last_progress
                      > self.stall_timeout_s):
                    self._rescue_stalled(inflight, ready, epoch)
                    last_progress = time.monotonic()
        finally:
            self._active = False
            for info in ready.values():
                if info.get("slot") is not None:
                    self._release_slot(info["slot"])
            ready.clear()
            if inflight:
                # consumer abandoned the epoch mid-flight: drain worker
                # results (bounded) so their slots return to the ring
                deadline = time.monotonic() + max(5.0, 10 * self.poll_s)
                while inflight and time.monotonic() < deadline:
                    self._pump(inflight, ready, epoch, discard=True)
                    for info in ready.values():
                        if info.get("slot") is not None:
                            self._release_slot(info["slot"])
                    ready.clear()
                if inflight:
                    self._broken = (f"{len(inflight)} shard(s) never "
                                    f"returned from workers")
            self._g_depth.set(0)
