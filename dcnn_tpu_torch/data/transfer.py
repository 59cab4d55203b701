"""Chunked multi-stream host-to-device transfer engine (counterpart of
``dcnn_tpu/data/transfer.py``), and the staging copy of a whole split.

Each shipment is split into C row-range chunks. A pool of transfer threads
gathers each chunk (``native.gather_rows``, chunk-parallel) straight into a
pinned host buffer and copies it to the card with a non-blocking copy on the
thread's own CUDA stream, so several copies are in flight at once and the
gather of chunk k+1 overlaps the copy of chunk k. Each chunk records a CUDA
event. The chunks are then

- handed to the consumer as a tuple (``reassemble="chunks"``): the
  streaming shard step concatenates them itself; or
- concatenated on the card (``reassemble="concat"``) for consumers that need
  one tensor (``PrefetchLoader``, ``DeviceDataset`` staging).

A consumer never reads a chunk before its copy has landed: the events
travel with the shipment (``stats["events"]``) and :func:`land` makes the
consumer's stream wait for them and marks the tensors as used on it, so the
caching allocator does not hand their memory to another stream early. With
``fence=True`` (the default, as in the JAX package) each pool thread also
waits on the host for its chunk's copy, so the spans time the copy itself
and a caller may reuse the source bytes as soon as the call returns.
Pinned buffers come from PyTorch's caching host allocator, which reuses a
buffer only after the copies recorded on it have finished.

On the CPU (``device="cpu"``) a chunk is a copy of the rows; chunking is
pure data movement, so every path gives the bytes of a plain copy. The
stats dict carries the JAX package's keys: per-chunk spans, the peak number
of puts in flight, and the copy rate over the union of the put spans.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..core.device import resolve_device
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer

STAGE_CHUNK_BYTES = 64 << 20


def chunk_bounds(n: int, num_chunks: int) -> List[Tuple[int, int]]:
    """Split ``range(n)`` into up to ``num_chunks`` contiguous, non-empty,
    balanced spans (sizes differ by at most 1, the remainder spread over
    the leading chunks); ``n < num_chunks`` gives ``n`` one-row chunks."""
    if n < 0:
        raise ValueError(f"chunk_bounds: negative n {n}")
    if num_chunks < 1:
        raise ValueError(f"chunk_bounds: num_chunks must be >= 1, "
                         f"got {num_chunks}")
    c = min(num_chunks, n)
    if c == 0:
        return []
    base, extra = divmod(n, c)
    bounds, lo = [], 0
    for k in range(c):
        hi = lo + base + (1 if k < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def max_inflight(spans: Sequence[dict]) -> int:
    """Peak number of simultaneously open ``[put_start_t, put_end_t)``
    intervals of recorded chunk spans."""
    events = []
    for s in spans:
        events.append((s["put_start_t"], 1))
        events.append((s["put_end_t"], -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Wall covered by the union of ``(lo, hi)`` intervals (overlapping
    spans count once)."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _tensors(items):
    for t in items:
        if isinstance(t, (tuple, list)):
            yield from _tensors(t)
        elif isinstance(t, torch.Tensor):
            yield t


def land(events, *tensors) -> None:
    """Make the current CUDA stream wait for ``events`` (the copies that
    produced ``tensors``) and mark the tensors as used on it. A no-op for
    CPU tensors and an empty event list."""
    if not events:
        return
    cuda = [t for t in _tensors(tensors) if t.is_cuda]
    if not cuda:
        return
    stream = torch.cuda.current_stream(cuda[0].device)
    for ev in events:
        stream.wait_event(ev)
    for t in cuda:
        t.record_stream(stream)


def stage_array(arr: np.ndarray, device,
                chunk_bytes: int = STAGE_CHUNK_BYTES) -> torch.Tensor:
    """A copy of ``arr`` on ``device``. On CUDA through two pinned buffers
    of ``chunk_bytes``, reused in turn (the host fills one while the other's
    copy runs on a side stream): pinning the whole array afresh would cost
    more than the copy. The current stream waits for the copies."""
    device = torch.device(device)
    arr = np.ascontiguousarray(arr)
    if device.type != "cuda":
        return torch.from_numpy(arr.copy()).to(device)
    out = torch.empty(arr.shape, dtype=torch_dtype(arr.dtype), device=device)
    nbytes = arr.nbytes
    if nbytes == 0:
        return out
    src = arr.reshape(-1).view(np.uint8)
    dst = out.view(-1).view(torch.uint8)
    chunk = min(int(chunk_bytes), nbytes)
    bufs = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    done: List[Optional[torch.cuda.Event]] = [None, None]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for i, lo in enumerate(range(0, nbytes, chunk)):
            b, hi = i % 2, min(lo + chunk, nbytes)
            if done[b] is not None:
                done[b].synchronize()  # its previous copy has read it
            bufs[b].numpy()[:hi - lo] = src[lo:hi]
            dst[lo:hi].copy_(bufs[b][:hi - lo], non_blocking=True)
            done[b] = torch.cuda.Event()
            done[b].record(side)
    torch.cuda.current_stream(device).wait_stream(side)
    return out


class TransferEngine:
    """A pool of transfer threads shipping host arrays to a device in
    chunks.

    Args:
      num_chunks: chunks per shipment (C).
      num_threads: pool size, the bound on copies in flight; each thread
        copies on its own CUDA stream.
      device: the target (CUDA unless ``"cpu"``).
      reassemble: ``"chunks"`` returns the chunk tuple; ``"concat"`` one
        tensor concatenated on the device.
      fence: each pool thread waits for its chunk's copy to land (default),
        so the spans time the copy and the source may be reused on return.
    """

    def __init__(self, *, num_chunks: int = 4, num_threads: int = 2,
                 device=None, reassemble: str = "chunks", fence: bool = True):
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
        if num_threads < 1:
            raise ValueError(f"num_threads must be >= 1, got {num_threads}")
        if reassemble not in ("chunks", "concat"):
            raise ValueError(f"reassemble must be 'chunks' or 'concat', "
                             f"got {reassemble!r}")
        self.device = resolve_device(device)
        self.num_chunks = int(num_chunks)
        self.num_threads = int(num_threads)
        self.reassemble = reassemble
        self.fence = fence
        self._cuda = self.device.type == "cuda"
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads,
                                        thread_name_prefix="h2d-xfer")
        self._local = threading.local()
        self._lock = threading.Lock()
        self._inflight = 0
        self._closed = False
        reg = get_registry()
        self._m_bytes = reg.counter("h2d_bytes_total",
                                    "bytes shipped host->device")
        self._m_chunks = reg.counter("h2d_chunks_total",
                                     "chunk transfers issued")
        self._m_put_s = reg.histogram("h2d_put_seconds",
                                      "per-shipment union of put spans")
        self._m_inflight = reg.gauge("h2d_inflight_max",
                                     "peak concurrent puts, last shipment")
        self._m_gbps = reg.gauge("h2d_gbps",
                                 "effective H2D rate, last shipment")

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "TransferEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals ---------------------------------------------------------
    def _stream(self) -> "torch.cuda.Stream":
        s = getattr(self._local, "stream", None)
        if s is None:
            s = self._local.stream = torch.cuda.Stream(self.device)
        return s

    def _host_buffer(self, shape, dtype) -> Tuple[np.ndarray, object]:
        """A host array to gather into: a pinned tensor's memory on CUDA."""
        if not self._cuda:
            return np.empty(shape, dtype), None
        pinned = torch.empty(shape, dtype=torch_dtype(dtype), pin_memory=True)
        return pinned.numpy(), pinned

    def _copy(self, host: np.ndarray, pinned):
        """The host rows onto the device: (tensor, event or None)."""
        if not self._cuda:
            return torch.from_numpy(host), None
        s = self._stream()
        with torch.cuda.stream(s):
            d = torch.empty(pinned.shape, dtype=pinned.dtype,
                            device=self.device)
            d.copy_(pinned, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(s)
        if self.fence:
            ev.synchronize()
        return d, ev

    def _rows(self, arr: np.ndarray, sel, lo: int, hi: int):
        """Rows [lo, hi) of ``arr`` (of ``sel`` when given), gathered into a
        fresh host buffer: (host array, pinned tensor or None)."""
        host, pinned = self._host_buffer((hi - lo, *arr.shape[1:]),
                                         arr.dtype)
        if sel is not None:
            native.gather_rows(arr, sel[lo:hi], out=host)
        else:
            np.copyto(host, arr[lo:hi])
        return host, pinned

    def _ship_chunk(self, k: int, arr: np.ndarray, sel, lo: int, hi: int,
                    t_base: float, peak: list):
        """One pool task: gather rows [lo, hi) and copy them to the device.
        Returns (device chunk, event, span dict). Each phase is also a
        tracer span (``h2d.gather``, ``h2d.put``) on the pool thread's
        track, so chunk overlap shows in the trace; the span dict, from
        which ``inflight_max`` and ``h2d_gbps`` come, works with tracing
        off."""
        tracer = get_tracer()
        t0 = time.perf_counter()
        with tracer.span("h2d.gather", chunk=k, rows=hi - lo):
            host, pinned = self._rows(arr, sel, lo, hi)
        t1 = time.perf_counter()
        with self._lock:
            self._inflight += 1
            peak[0] = max(peak[0], self._inflight)
        try:
            with tracer.span("h2d.put", chunk=k, rows=hi - lo,
                             bytes=int(host.nbytes)):
                d, ev = self._copy(host, pinned)
        finally:
            with self._lock:
                self._inflight -= 1
        t2 = time.perf_counter()
        span = {"chunk": k, "rows": hi - lo, "bytes": int(host.nbytes),
                "gather_s": t1 - t0, "put_s": t2 - t1,
                "put_start_t": t1 - t_base, "put_end_t": t2 - t_base}
        return d, ev, span

    def _submit(self, arr: np.ndarray, sel, t_base: float, peak: list):
        if self._closed:
            raise RuntimeError("TransferEngine is closed")
        n = int(sel.shape[0]) if sel is not None else int(arr.shape[0])
        # zero rows still ship one empty chunk, so the caller always gets a
        # well-formed tensor or 1-tuple back
        bounds = chunk_bounds(n, self.num_chunks) or [(0, 0)]
        return [self._pool.submit(self._ship_chunk, k, arr, sel, lo, hi,
                                  t_base, peak)
                for k, (lo, hi) in enumerate(bounds)]

    @staticmethod
    def _collect(futs):
        """Await every chunk; a failure in any re-raises here after the
        rest have settled, never a partial shard."""
        results, first_err = [], None
        for f in futs:
            try:
                results.append(f.result())
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return ([d for d, _, _ in results],
                [e for _, e, _ in results if e is not None],
                [s for _, _, s in results])

    def _concat(self, chunks, events):
        """One tensor from the chunks, concatenated on this thread's stream
        after their copies: (tensor, events to land it)."""
        if len(chunks) == 1:
            return chunks[0], events
        if not self._cuda:
            return torch.cat(chunks), []
        s = self._stream()
        with torch.cuda.stream(s):
            for ev in events:
                s.wait_event(ev)
            for c in chunks:
                c.record_stream(s)
            out = torch.cat(chunks)
            ev = torch.cuda.Event()
            ev.record(s)
        return out, [ev]

    @staticmethod
    def _stats(spans: List[dict], peak: int, wall_s: float) -> dict:
        total_bytes = sum(s["bytes"] for s in spans)
        put_union = union_seconds(
            [(s["put_start_t"], s["put_end_t"]) for s in spans])
        return {
            "chunks": spans,
            "gather_s": sum(s["gather_s"] for s in spans),
            "put_s": put_union,
            "wall_s": wall_s,
            "bytes": total_bytes,
            "inflight_max": peak,
            "h2d_gbps": (total_bytes / put_union / 1e9) if put_union > 0
                        else None,
        }

    # -- API ---------------------------------------------------------------
    def put_shard(self, x: np.ndarray, y: Optional[np.ndarray] = None,
                  sel: Optional[np.ndarray] = None, *,
                  t_base: Optional[float] = None):
        """Ship one shard: ``x`` chunked across the pool, ``y`` (labels, a
        few KB) in one copy from the calling thread while the chunks fly.
        ``sel`` selects rows of both; each chunk gathers its own range.

        Returns ``(dx, dy, stats)``: ``dx`` the chunk tuple or one tensor
        (per ``reassemble``), ``stats`` the per-chunk spans,
        ``inflight_max``, ``h2d_gbps`` and, under ``"events"``, the CUDA
        events a consumer passes to :func:`land` before reading."""
        t_base = time.perf_counter() if t_base is None else t_base
        t_call0 = time.perf_counter()
        tracer = get_tracer()
        shard_span = tracer.begin("h2d.shard", track="h2d",
                                  rows=int(sel.shape[0] if sel is not None
                                           else x.shape[0]))
        try:
            peak = [0]
            futs = self._submit(x, sel, t_base, peak)
            dy, y_events = None, []
            if y is not None:
                try:
                    rows = len(sel) if sel is not None else len(y)
                    with tracer.span("h2d.put_labels", track="h2d"):
                        host, pinned = self._rows(y, sel, 0, rows)
                        dy, ev = self._copy(host, pinned)
                    y_events = [ev] if ev is not None else []
                except BaseException:
                    self._collect(futs)  # let the chunks settle first
                    raise
            chunks, events, spans = self._collect(futs)
            if self.reassemble == "concat":
                dx, events = self._concat(chunks, events)
            else:
                dx = tuple(chunks)
            stats = self._stats(spans, peak[0],
                                time.perf_counter() - t_call0)
        except BaseException as e:
            # the failing shipment must not be the one missing from the
            # trace
            tracer.end(shard_span, error=type(e).__name__)
            raise
        tracer.end(shard_span, bytes=stats["bytes"],
                   inflight_max=stats["inflight_max"])
        stats["events"] = events + y_events
        self._m_bytes.inc(stats["bytes"])
        self._m_chunks.inc(len(spans))
        self._m_put_s.observe(stats["put_s"])
        self._m_inflight.set(stats["inflight_max"])
        if stats["h2d_gbps"] is not None:
            self._m_gbps.set(stats["h2d_gbps"])
        return dx, dy, stats

    def put_array_async(self, arr: np.ndarray):
        """One array chunk-pipelined into ONE tensor: ``(tensor, events)``,
        to be landed (:func:`land`) by the consumer. The reassembly holds
        the chunks and the result at once (~2x the array on the device)."""
        peak = [0]
        futs = self._submit(np.asarray(arr), None, time.perf_counter(), peak)
        chunks, events, _ = self._collect(futs)
        return self._concat(chunks, events)

    def put_array(self, arr: np.ndarray) -> torch.Tensor:
        """One array chunk-pipelined into one tensor, landed for the calling
        thread's current stream: the drop-in for a plain copy."""
        out, events = self.put_array_async(arr)
        land(events, out)
        return out
