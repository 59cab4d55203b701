"""Structured span tracing with a bounded ring buffer and Chrome-trace
export (counterpart of ``dcnn_tpu/obs/tracer.py``).

A **span** is a named ``[t0, t1)`` interval with attributes, recorded on a
**track** (a labeled row in the viewer: one per transfer thread, one for
the serve queue, one per feed worker). The event store exports to JSONL
(one event per line) and to Chrome ``trace_event`` JSON, which Perfetto and
``chrome://tracing`` load, with ``thread_name`` metadata so tracks appear
labeled.

1. **Disabled is free.** When tracing is off, ``span``/``begin``/``end``/
   ``instant`` are module-level no-op functions swapped onto the instance.
2. **Bounded memory.** Events land in a ``deque(maxlen=capacity)``, which
   drops the oldest events under pressure; ``deque.append`` is one C-level
   op, so recording needs no lock.
3. **Injectable clock**: tests pass a fake clock and assert timestamps and
   durations by exact equality.
4. **Cross-thread spans.** ``begin()``/``end()`` return and consume an
   explicit handle for intervals that open on one thread and close on
   another; the handle carries its track.

Spans record **host clocks**. A span never waits for the card: it adds no
``torch.cuda.synchronize`` and reads nothing from the device, so around an
asynchronous launch it measures the host's issue wall, not device time.
Call sites that need device-true intervals fence first
(:func:`dcnn_tpu_torch.core.fence.hard_fence`).

**Distributed identity.** Every recorded span carries ``trace_id`` /
``span_id`` / ``parent_id`` in its attrs. Parentage comes from a
per-thread context stack: entering ``with tracer.span(...)`` activates the
span for the thread, so nested spans chain; :meth:`Tracer.inject`
snapshots the active context as a JSON-safe carrier dict and
:meth:`Tracer.activate` adopts a carrier from another thread or process.
The JSONL shards (``dcnn-trace-jsonl/1``, the JAX package's format)
merge into one Chrome trace through the port's own CLI,
``python -m dcnn_tpu_torch.obs.trace merge``. Disabled, ``inject``
returns ``None`` and ``activate`` the shared null context manager.

**Saturation is visible.** Ring-buffer eviction increments
:attr:`Tracer.dropped`, and :meth:`Tracer.export_gauges` mirrors it to the
registry as ``trace_events_dropped_total`` plus ``trace_buffer_events`` /
``trace_buffer_capacity``.
"""

from __future__ import annotations

import gzip as _gzip
import itertools
import json
import os
import socket as _socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

# per-process id prefix: pid + random so ids never collide across the
# fleet's processes (a forked child inherits it, but forked feed workers
# replay via record_span on the parent's tracer — they mint no ids)
_ID_PREFIX = f"{os.getpid():x}{os.urandom(3).hex()}"
_IDS = itertools.count(1)


def _new_id(kind: str) -> str:
    """Process-unique id: ``<pid-hex><rand6><kind><counter-hex>``.
    ``next()`` on itertools.count is GIL-atomic — no lock on the span
    hot path."""
    return f"{_ID_PREFIX}{kind}{next(_IDS):x}"


class _NullSpan:
    """Singleton no-op span/handle: context manager, ``set()`` sink,
    ``context()`` carrier source (always ``None``)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def context(self) -> None:
        return None


_NULL_SPAN = _NullSpan()


def _null_span(name, **attrs):
    """Disabled-path ``span``/``begin``/``instant``: a plain module-level
    function (the cheapest callable CPython has — no bound-method alloc)
    returning the shared null span."""
    return _NULL_SPAN


def _null_end(handle, **attrs):
    return None


def _null_record_span(name, t0_s, t1_s, *, track=None, **attrs):
    return None


def _null_inject():
    return None


def _null_activate(carrier=None):
    # the null span IS a no-op context manager — reuse it
    return _NULL_SPAN


class _Span:
    """Live span: context-manager for same-thread use, explicit handle for
    cross-thread ``begin``/``end``. ``track`` pins the display row; default
    is the recording thread's name.

    Identity: ``trace_id``/``span_id`` are minted at construction
    (``parent_id`` from the thread's active context, or an explicit
    ``parent=`` carrier). Entering the context manager additionally
    *activates* the span on this thread so children chain; ``begin()``
    handles are never activated (they may end on another thread) — use
    ``tracer.activate(handle)`` to parent work under one explicitly."""

    __slots__ = ("_tracer", "name", "track", "attrs", "t0",
                 "trace_id", "span_id", "parent_id", "_pushed")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 attrs: Dict[str, Any], parent=None):
        self._tracer = tracer
        self.name = name
        self.track = track
        self.attrs = attrs
        self._pushed = False
        ctx = parent if parent is not None else tracer._current()
        if ctx is not None and not isinstance(ctx, dict):
            ctx = ctx.context()  # a _Span / handle was passed as parent
        if ctx:
            self.trace_id = ctx.get("trace_id")
            self.parent_id = ctx.get("span_id")
        else:
            self.trace_id = _new_id("t")
            self.parent_id = None
        self.span_id = _new_id("s")
        self.t0 = tracer._clock()

    def set(self, **attrs) -> "_Span":
        """Attach attributes mid-span (e.g. bytes known only after the
        gather)."""
        self.attrs.update(attrs)
        return self

    def context(self) -> Dict[str, str]:
        """JSON-safe carrier for cross-thread/cross-process propagation —
        what ``tracer.inject()`` returns for the active span and what
        ``tracer.activate(...)`` accepts."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def __enter__(self) -> "_Span":
        # re-stamp: construction may predate entry (begin() handles are
        # stamped at begin, but `with tracer.span(...)` should measure the
        # block, not the call)
        self.t0 = self._tracer._clock()
        self._tracer._stack().append(self)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._pushed:
            st = self._tracer._stack()
            # pop by identity: a mismatched exit (forked generator, crash
            # mid-push) must not unwind someone else's context
            if st and st[-1] is self:
                st.pop()
            elif self in st:
                st.remove(self)
            self._pushed = False
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(self)
        return False


class _Activation:
    """Context manager adopting a foreign trace context (a carrier dict
    from :meth:`Tracer.inject`, possibly received over the wire) on this
    thread: spans created inside become its children."""

    __slots__ = ("_tracer", "_ctx")

    def __init__(self, tracer: "Tracer", ctx: Dict[str, Any]):
        self._tracer = tracer
        self._ctx = ctx

    def context(self) -> Dict[str, Any]:
        return self._ctx

    def __enter__(self) -> "_Activation":
        self._tracer._stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        st = self._tracer._stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        return False


class Tracer:
    """Span recorder over a bounded ring buffer.

    ``enabled=False`` (the default for the process-global instance) swaps
    every recording entry point for a no-op function; ``set_enabled(True)``
    swaps the real ones back in. The swap is per-instance attribute
    assignment, so call sites holding the tracer object observe the change
    immediately and pay zero branching when disabled.
    """

    def __init__(self, *, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._epoch = clock()
        self._events: deque = deque(maxlen=capacity)
        self.capacity = capacity
        # per-thread active-context stack (trace propagation). Lazy per
        # thread; never touched on the disabled path.
        self._tls = threading.local()
        # ring-buffer eviction accounting: lock-free increment on the hot
        # path (under the GIL a lost count needs preemption mid-RMW — a
        # saturation *signal*, not an exactness contract); export_gauges
        # syncs the delta onto a registry counter under _sync_lock.
        self._dropped = 0
        self._sync_lock = threading.Lock()
        self._dropped_synced = 0                # dcnn: guarded_by=_sync_lock
        # identity stamped into JSONL shard headers / merge metadata
        self.process_name: Optional[str] = None
        self.set_enabled(enabled)

    # -- enable/disable ----------------------------------------------------
    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)
        if self.enabled:
            self.span = self._span
            self.begin = self._span  # same stamped handle, no CM entry needed
            self.end = self._end
            self.instant = self._instant
            self.record_span = self._record_span
            self.inject = self._inject
            self.activate = self._activate
        else:
            self.span = _null_span
            self.begin = _null_span
            self.end = _null_end
            self.instant = _null_span
            self.record_span = _null_record_span
            self.inject = _null_inject
            self.activate = _null_activate

    # -- context propagation -----------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current(self):
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else None

    def _inject(self) -> Optional[Dict[str, Any]]:
        """The thread's active trace context as a JSON-safe carrier
        (``{"trace_id", "span_id"}``), or ``None`` when no span is
        active. Put it in a message's metadata and :meth:`activate` it on
        the receiving side."""
        top = self._current()
        return top.context() if top is not None else None

    def _activate(self, carrier=None):
        """Adopt ``carrier`` (an :meth:`inject` dict, a live span/handle,
        or ``None``) as this thread's active context for the ``with``
        block. ``None`` / malformed carriers are a no-op context manager,
        so receivers can pass ``meta.get("_trace")`` unconditionally."""
        if carrier is None:
            return _NULL_SPAN
        if isinstance(carrier, (_Span, _Activation)):
            carrier = carrier.context()
        if not isinstance(carrier, dict) or not carrier.get("trace_id"):
            return _NULL_SPAN
        return _Activation(self, carrier)

    # -- recording (real implementations) ----------------------------------
    def _span(self, name: str, *, track: Optional[str] = None,
              parent=None, **attrs) -> _Span:
        return _Span(self, name, track, attrs, parent=parent)

    def _end(self, handle: _Span, **attrs) -> None:
        """Close a ``begin()`` handle (cross-thread safe). Ending the null
        handle (begun while disabled) is a no-op, so an enable/disable flip
        mid-span never raises."""
        if handle is _NULL_SPAN or handle is None:
            return
        if attrs:
            handle.attrs.update(attrs)
        self._record(handle)

    def _record_span(self, name: str, t0_s: float, t1_s: float, *,
                     track: Optional[str] = None, **attrs) -> None:
        """Record an already-measured ``[t0_s, t1_s)`` interval (timestamps
        in this tracer's clock domain — ``time.perf_counter`` for the global
        instance). The replay entry point for intervals measured where the
        tracer can't run: feed-worker processes time their gather/augment/
        pack phases with ``perf_counter`` (CLOCK_MONOTONIC — one clock
        system-wide on Linux, so child stamps land on the parent timeline)
        and the parent replays them onto per-worker tracks."""
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        self._events.append(
            (name, t0_s - self._epoch, max(t1_s - t0_s, 0.0),
             track if track is not None else threading.current_thread().name,
             attrs))

    def _instant(self, name: str, *, track: Optional[str] = None, **attrs):
        t = self._clock()
        top = self._current()
        if top is not None:  # instants inherit the active trace identity
            ctx = top.context()
            attrs["trace_id"] = ctx.get("trace_id")
            attrs["parent_id"] = ctx.get("span_id")
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        self._events.append(
            (name, t - self._epoch, None,
             track if track is not None else threading.current_thread().name,
             attrs))
        return _NULL_SPAN

    def _record(self, span: _Span) -> None:
        t1 = self._clock()
        track = (span.track if span.track is not None
                 else threading.current_thread().name)
        # identity rides in attrs so the event-tuple shape (and every
        # exporter) stays unchanged; the merge CLI correlates on these keys
        a = span.attrs
        a["trace_id"] = span.trace_id
        a["span_id"] = span.span_id
        if span.parent_id is not None:
            a["parent_id"] = span.parent_id
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        # one GIL-atomic append — concurrent recorders never lose or tear
        # an event, and maxlen evicts the oldest under pressure
        self._events.append(
            (span.name, span.t0 - self._epoch, t1 - span.t0, track, a))

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring buffer since construction — the
        saturation signal ``export_gauges`` mirrors onto the registry."""
        return self._dropped

    def export_gauges(self, registry=None) -> None:
        """Mirror ring-buffer saturation onto a registry:
        ``trace_events_dropped_total`` (counter — synced by delta, so
        repeated scrapes never double-count), ``trace_buffer_events``
        occupancy and ``trace_buffer_capacity`` gauges. Called by the
        telemetry server's ``/metrics``/``/snapshot`` paths: a saturated
        tracer is visible on the
        same surface everything else is."""
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        with self._sync_lock:
            d = self._dropped
            delta = d - self._dropped_synced
            self._dropped_synced = d
        c = registry.counter("trace_events_dropped_total",
                             "span events evicted from the tracer ring "
                             "buffer (saturation — raise capacity or "
                             "flush more often)")
        if delta > 0:
            c.inc(delta)
        registry.gauge("trace_buffer_events",
                       "events currently in the tracer ring buffer").set(
            len(self._events))
        registry.gauge("trace_buffer_capacity",
                       "tracer ring buffer capacity").set(self.capacity)

    def _events_list(self) -> list:
        """Reader-side copy of the ring buffer. ``list(deque)`` is one
        C-level call (atomic under the CPython GIL), but that is an
        implementation detail — retry on the 'deque mutated during
        iteration' RuntimeError so a live-recording tracer can always be
        exported mid-run (a server exports while request threads
        record)."""
        for _ in range(8):
            try:
                return list(self._events)
            except RuntimeError:  # concurrent append won the race; retry
                continue
        return list(self._events)  # last attempt unguarded: surface the bug

    def events(self) -> List[Dict[str, Any]]:
        """Copy of the buffer as dicts, oldest first. ``ts_s`` is seconds
        since the tracer epoch; ``dur_s`` is None for instant events."""
        return [{"name": n, "ts_s": ts, "dur_s": dur, "track": track,
                 "args": dict(attrs)}
                for (n, ts, dur, track, attrs) in self._events_list()]

    def clear(self) -> None:
        self._events.clear()
        self._epoch = self._clock()

    def span_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for (n, *_rest) in self._events_list():
            counts[n] = counts.get(n, 0) + 1
        return counts

    # -- exporters ---------------------------------------------------------
    def shard_meta(self) -> Dict[str, Any]:
        """The JSONL shard header: everything the merge tool
        (``python -m dcnn_tpu_torch.obs.trace merge``, :mod:`.trace`)
        needs to place this process's events on a shared timeline — the
        tracer epoch in its own clock
        domain (``perf_counter`` = CLOCK_MONOTONIC on Linux: one clock
        system-wide, so same-host shards align exactly), plus the process
        identity merged traces are attributed to."""
        return {
            "format": "dcnn-trace-jsonl/1",
            "epoch_s": self._epoch,
            "host": _socket.gethostname(),
            "pid": os.getpid(),
            "process": self.process_name,
            "clock": getattr(self._clock, "__name__", str(self._clock)),
            "dropped": self._dropped,
        }

    def _write_jsonl(self, evs: list, path: str, gzip: bool) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # tmp sibling + os.replace: a crash mid-export must never leave a
        # torn artifact at the published path (flush_jsonl's drop-nothing
        # contract also depends on the failed write being invisible)
        tmp = f"{path}.tmp-{os.getpid()}"
        opener = (lambda p: _gzip.open(p, "wt")) if gzip else \
            (lambda p: open(p, "w"))
        try:
            with opener(tmp) as f:
                # header line first: readers detect it by the "shard" key
                # (events always carry "name")
                f.write(json.dumps({"shard": self.shard_meta()}) + "\n")
                for (n, ts, dur, track, attrs) in evs:
                    f.write(json.dumps({"name": n, "ts_s": ts, "dur_s": dur,
                                        "track": track,
                                        "args": {k: _json_safe(v)
                                                 for k, v in attrs.items()}
                                        }) + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def export_jsonl(self, path: str, *, gzip: bool = False) -> str:
        """One JSON object per line per event. ``gzip=True`` writes the
        stream gzip-compressed (span JSONL compresses ~10x — the names and
        tracks repeat every line)."""
        self._write_jsonl(self._events_list(), path, gzip)
        return path

    def flush_jsonl(self, path: str, *, gzip: bool = False) -> str:
        """Export, then drop EXACTLY the exported events — the
        periodic-drain entry point for long soaks: flush the ring to disk
        before eviction loses the oldest events, keep recording.

        Concurrency contract: events recorded while the file is being
        written are NOT lost — only events from the snapshot that reached
        disk are popped (checked by identity, so a saturated ring that
        evicted already-exported events during the write never makes the
        drain over-pop unexported ones), and concurrent appends land on
        the other end, so they ride the next flush. A failed write drops
        nothing. The tracer epoch is untouched, so timestamps stay
        monotone across flushes and spans straddling a flush stay valid
        (``clear()``, by contrast, restarts the timeline)."""
        evs = self._events_list()
        self._write_jsonl(evs, path, gzip)
        exported = set(map(id, evs))  # attrs dicts make tuples unhashable
        for _ in range(len(evs)):
            try:
                head = self._events.popleft()
            except IndexError:  # eviction raced us: already gone
                break
            if id(head) not in exported:
                # eviction consumed the rest of the exported prefix while
                # we drained; this event is newer than the snapshot — put
                # it back and stop (ring just shed one slot, so the
                # appendleft cannot evict)
                self._events.appendleft(head)
                break
        return path

    def export_chrome(self, path: str, *,
                      max_events: Optional[int] = None) -> str:
        """Chrome ``trace_event`` JSON (Perfetto / chrome://tracing).

        Complete spans become ``ph:"X"`` events (µs timestamps); instants
        become ``ph:"i"``. Each distinct track maps to a stable tid
        (first-seen order) with a ``thread_name`` metadata record, so the
        viewer shows labeled rows ("h2d-xfer_0", "serve", "feed-w0"), not
        anonymous thread ids.

        ``max_events`` caps the exported event count (viewers choke on
        multi-million-event files): the NEWEST ``max_events`` survive and
        the drop is explicit, never silent — a ``tracer.truncated`` instant
        at the head of the trace (on a ``tracer`` track) says exactly how
        many older events were cut, log-truncation style."""
        evs = self._events_list()
        truncated = 0
        if max_events is not None:
            if max_events < 1:
                raise ValueError(
                    f"max_events must be >= 1, got {max_events}")
            if len(evs) > max_events:
                truncated = len(evs) - max_events
                evs = evs[-max_events:]
                # an explicit head-of-trace note, stamped just before the
                # oldest surviving event so it sorts first in the viewer
                evs = [("tracer.truncated", evs[0][1], None, "tracer",
                        {"dropped_older_events": truncated,
                         "note": f"... {truncated} older events truncated "
                                 f"(max_events={max_events})"})] + evs
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = [{
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "dcnn_tpu_torch"}}]
        for (_n, _ts, _dur, track, _a) in evs:
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append({"ph": "M", "pid": 1, "tid": tids[track],
                            "name": "thread_name",
                            "args": {"name": track}})
        for (name, ts, dur, track, attrs) in evs:
            ev: Dict[str, Any] = {
                "name": name, "pid": 1, "tid": tids[track],
                "ts": round(ts * 1e6, 3), "cat": name.split(".", 1)[0],
                "args": {k: _json_safe(v) for k, v in attrs.items()},
            }
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"   # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            out.append(ev)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # same commit discipline as _write_jsonl: never a torn trace at the
        # path a viewer is pointed at
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


# -- process-global tracer -------------------------------------------------
_GLOBAL_TRACER = Tracer(
    enabled=os.environ.get("DCNN_TRACE", "0") == "1")


def get_tracer() -> Tracer:
    """The process-global tracer every built-in call site records through.
    Disabled by default (no-op entry points); enable with
    :func:`configure` or ``DCNN_TRACE=1``."""
    return _GLOBAL_TRACER


def configure(*, enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              clock: Optional[Callable[[], float]] = None) -> Tracer:
    """Reconfigure the process-global tracer IN PLACE (object identity is
    preserved — call sites that hoisted ``get_tracer()`` stay wired).
    A ``capacity`` change keeps the newest events that fit; a ``clock``
    change clears the buffer (events from two clock domains on one
    timeline would be garbage)."""
    t = _GLOBAL_TRACER
    if capacity is not None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        t._events = deque(t._events, maxlen=capacity)
        t.capacity = capacity
    if clock is not None:
        t._clock = clock
        t._events.clear()
        t._epoch = clock()
    if enabled is not None:
        t.set_enabled(enabled)
    return t
