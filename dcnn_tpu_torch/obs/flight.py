"""Failure flight recorder: postmortem bundles on degradation edges
(counterpart of ``dcnn_tpu/obs/flight.py``).

When a degradation edge fires (a step guard's bad-step streak starts, the
stall watchdog sees a stall, ``/healthz`` flips to 503), the recorder
atomically dumps a bounded bundle of what a postmortem wants:

- ``spans.jsonl``: the newest tracer events, in the tracer's JSONL shard
  format;
- ``metrics.json``: the registry snapshot as of the failure;
- ``history.jsonl``: the attached tsdb's retained window, when one is
  attached (:meth:`FlightRecorder.attach_tsdb`);
- ``healthz.json``: the 503 body, when a health transition triggered it;
- ``config.json``: the offending configuration the trigger site owns;
- ``MANIFEST.json``: trigger, timestamps, process identity, reasons.

Triggers wired in the port: ``healthz_degraded`` (TelemetryServer 200 to
503 edge), ``watchdog_stall`` (StallWatchdog) and ``nonfinite_guard``
(StepGuard bad-step streak start).

- **Never raises.** A recorder failure is counted
  (``flight_record_failures_total``) and swallowed.
- **Atomic and bounded.** Bundles are staged and published with the
  port's ``resilience.atomic`` (``stage_dir``, per-file
  ``write_file_atomic``, ``commit_dir``); keep-K retention bounds disk and
  a per-trigger ``min_interval_s`` cooldown bounds dump storms.
- **Injectable** clock, wall clock, tracer and registry.
- **Off by default.** The process-global recorder
  (:func:`get_flight_recorder`) is disabled until ``DCNN_FLIGHT_DIR`` is
  set or :func:`configure_flight` names a directory (``DCNN_FLIGHT_KEEP``
  sets how many bundles it keeps). Each process should own its directory.
"""

from __future__ import annotations

import json
import os
import shutil
import socket as _socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience.atomic import (
    commit_dir, stage_dir, sweep_stale_tmp, write_file_atomic,
)
from .tracer import _json_safe

#: Bundle directory name prefix — everything else in the flight dir
#: (tmp- staging, stray files) is ignored by listing and GC.
_BUNDLE_PREFIX = "fb-"


def _safe_slug(name: str) -> str:
    out = "".join(c if (c.isalnum() or c in "-_") else "_" for c in name)
    return out[:64] or "trigger"


class FlightRecorder:
    """Atomic keep-K postmortem bundle writer over one flight directory.

    ``directory=None`` disables the recorder: :meth:`record` returns
    ``None`` immediately and :meth:`bundles` returns ``[]`` — the state
    every process starts in unless ``DCNN_FLIGHT_DIR`` is set.
    """

    def __init__(self, directory: Optional[str] = None, *,
                 keep: int = 8, span_limit: int = 2048,
                 min_interval_s: float = 30.0,
                 tracer=None, registry=None, tsdb=None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if span_limit < 0:
            raise ValueError(
                f"span_limit must be >= 0, got {span_limit}")
        self.directory = directory
        self.keep = keep
        self.span_limit = span_limit
        self.min_interval_s = min_interval_s
        self._tracer = tracer
        self._registry = registry
        self._tsdb = tsdb
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}   # dcnn: guarded_by=_lock
        self._seq = 0                       # dcnn: guarded_by=_lock
        self._swept = False                 # dcnn: guarded_by=_lock
        # stale tmp- staging dirs from a preempted process are swept
        # lazily at the first record (the dir may not exist yet here)

    # -- wiring ------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def attach_tsdb(self, store) -> "FlightRecorder":
        """Wire a :class:`~dcnn_tpu_torch.obs.tsdb.TimeSeriesStore`: every
        bundle gains ``history.jsonl`` — the store's retained window, so
        a postmortem shows the minutes BEFORE the trigger, not just the
        counters at it. ``None`` detaches (owners detach at shutdown so
        a dead run's store is not dumped into a later bundle)."""
        self._tsdb = store
        return self

    def _default_tracer(self):
        if self._tracer is not None:
            return self._tracer
        from .tracer import get_tracer
        return get_tracer()

    def _default_registry(self):
        if self._registry is not None:
            return self._registry
        from .registry import get_registry
        return get_registry()

    # -- recording ---------------------------------------------------------
    def record(self, trigger: str, *,
               reasons: Optional[List[str]] = None,
               health: Optional[Dict[str, Any]] = None,
               config: Optional[Dict[str, Any]] = None,
               extra: Optional[Dict[str, Any]] = None,
               registry=None, tracer=None) -> Optional[str]:
        """Dump one postmortem bundle for ``trigger``; returns the
        committed bundle path, or ``None`` when disabled, suppressed by
        the per-trigger cooldown, or failed (failures are counted, never
        raised — see the module docstring)."""
        if not self.directory:
            return None
        try:
            return self._record(trigger, reasons, health, config, extra,
                                registry, tracer)
        except Exception:
            try:
                self._default_registry().counter(
                    "flight_record_failures_total",
                    "flight-recorder dumps that failed").inc()
            except Exception:
                pass
            return None

    def _record(self, trigger, reasons, health, config, extra,
                registry, tracer) -> Optional[str]:
        now = self._clock()
        with self._lock:
            last = self._last.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                self._default_registry().counter(
                    "flight_records_suppressed_total",
                    "flight dumps suppressed by the per-trigger "
                    "cooldown").inc()
                return None
            self._last[trigger] = now
            self._seq += 1
            seq = self._seq
            sweep = not self._swept
            self._swept = True
        try:
            return self._dump(trigger, reasons, health, config, extra,
                              registry, tracer, now, seq, sweep)
        except BaseException:
            # the cooldown stamp was a CLAIM, not a record: a failed
            # dump (unwritable dir, ENOSPC) must not suppress the next
            # episode's evidence for min_interval_s — release it so the
            # next edge retries (unless a concurrent success re-stamped)
            with self._lock:
                if self._last.get(trigger) == now:
                    del self._last[trigger]
            raise

    def _dump(self, trigger, reasons, health, config, extra,
              registry, tracer, now, seq, sweep) -> Optional[str]:
        os.makedirs(self.directory, exist_ok=True)
        if sweep:
            sweep_stale_tmp(self.directory)
        trc = tracer if tracer is not None else self._default_tracer()
        reg = registry if registry is not None else self._default_registry()
        t_wall = self._wall()
        spans = trc.events()[-self.span_limit:] if self.span_limit else []
        manifest = {
            "trigger": trigger,
            "t_wall": t_wall,
            "t_mono": now,
            "host": _socket.gethostname(),
            "pid": os.getpid(),
            "process": getattr(trc, "process_name", None),
            "reasons": list(reasons or []),
            "spans": len(spans),
            "tracer_enabled": getattr(trc, "enabled", False),
        }
        name = f"{_BUNDLE_PREFIX}{int(t_wall * 1000):015d}-{seq:04d}-" \
               f"{_safe_slug(trigger)}"
        tsdb = self._tsdb
        if tsdb is not None:
            try:
                history = tsdb.to_jsonl_bytes()
            except Exception:
                history = None  # a broken store must not cost the bundle
            manifest["history_series"] = (len(tsdb.series_names())
                                          if history is not None else None)
        else:
            history = None
        tmp = stage_dir(self.directory)
        try:
            self._stage_json(tmp, "MANIFEST.json", manifest)
            self._stage_spans(tmp, trc, spans)
            if history is not None:
                write_file_atomic(os.path.join(tmp, "history.jsonl"),
                                  history)
            self._stage_json(tmp, "metrics.json", reg.snapshot())
            if health is not None:
                self._stage_json(tmp, "healthz.json", health)
            if config is not None:
                self._stage_json(tmp, "config.json", config)
            if extra is not None:
                self._stage_json(tmp, "extra.json", extra)
            final = os.path.join(self.directory, name)
            commit_dir(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise  # _record's outer handler releases the cooldown stamp
        self._gc()
        reg.counter("flight_records_total",
                    "flight-recorder bundles committed").inc()
        reg.gauge("flight_bundles",
                  "bundles currently retained").set(len(self._list_dirs()))
        return final

    @staticmethod
    def _stage_json(tmp: str, name: str, obj: Any) -> None:
        data = json.dumps(obj, default=str, indent=1).encode("utf-8")
        write_file_atomic(os.path.join(tmp, name), data)

    @staticmethod
    def _stage_spans(tmp: str, trc, spans: List[Dict[str, Any]]) -> None:
        """Bundle spans in the JSONL shard format (header + one event
        per line), so a bundle's spans read exactly like a live shard."""
        lines = [json.dumps({"shard": trc.shard_meta()})] if hasattr(
            trc, "shard_meta") else []
        for ev in spans:
            ev = dict(ev)
            ev["args"] = {k: _json_safe(v)
                          for k, v in dict(ev.get("args") or {}).items()}
            lines.append(json.dumps(ev, default=str))
        write_file_atomic(os.path.join(tmp, "spans.jsonl"),
                          ("\n".join(lines) + "\n").encode("utf-8"))

    # -- retention / listing -----------------------------------------------
    def _list_dirs(self) -> List[str]:
        if not self.directory or not os.path.isdir(self.directory):
            return []
        return sorted(n for n in os.listdir(self.directory)
                      if n.startswith(_BUNDLE_PREFIX))

    def _gc(self) -> None:
        names = self._list_dirs()
        for n in names[:max(len(names) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, n),
                          ignore_errors=True)

    def bundles(self) -> List[Dict[str, Any]]:
        """Retained bundles, newest first: ``{path, trigger, t_wall,
        reasons}`` — the block ``/snapshot`` lists so an operator finds
        the evidence from the same surface that showed the 503."""
        out: List[Dict[str, Any]] = []
        for n in reversed(self._list_dirs()):
            path = os.path.join(self.directory, n)
            entry: Dict[str, Any] = {"path": path}
            try:
                with open(os.path.join(path, "MANIFEST.json")) as f:
                    md = json.load(f)
                entry.update(trigger=md.get("trigger"),
                             t_wall=md.get("t_wall"),
                             reasons=md.get("reasons", []))
            except (OSError, ValueError):
                # name carries enough to find it; a torn manifest cannot
                # exist (commit is atomic) but a deleted-mid-list one can
                entry["trigger"] = n.rsplit("-", 1)[-1]
            out.append(entry)
        return out


# -- process-global recorder -------------------------------------------------
_GLOBAL_FLIGHT = FlightRecorder(
    os.environ.get("DCNN_FLIGHT_DIR") or None,
    keep=int(os.environ.get("DCNN_FLIGHT_KEEP", "8")))


def get_flight_recorder() -> FlightRecorder:
    """The process-global flight recorder every built-in trigger site
    records through. Disabled (``record`` → None) until
    ``DCNN_FLIGHT_DIR`` is set or :func:`configure_flight` names a
    directory."""
    return _GLOBAL_FLIGHT


def resolve_flight_recorder(flight: Optional[FlightRecorder] = None
                            ) -> FlightRecorder:
    """THE trigger-site fallback: an explicitly injected recorder wins
    (tests, per-component dirs), else the process-global one. Every
    built-in trigger site resolves through here so the lazy-import
    fallback cannot drift between call sites."""
    return flight if flight is not None else _GLOBAL_FLIGHT


def configure_flight(directory: Optional[str] = None, *,
                     keep: Optional[int] = None,
                     span_limit: Optional[int] = None,
                     min_interval_s: Optional[float] = None,
                     tsdb=None) -> FlightRecorder:
    """Reconfigure the process-global recorder IN PLACE (identity
    preserved — trigger sites that hoisted it stay wired). Passing a
    ``directory`` enables it; ``None`` leaves the current one. ``tsdb``
    attaches a history store (see :meth:`FlightRecorder.attach_tsdb`)."""
    r = _GLOBAL_FLIGHT
    if directory is not None:
        r.directory = directory
        with r._lock:
            r._swept = False  # new dir: sweep its stale tmp- on first use
    if tsdb is not None:
        r.attach_tsdb(tsdb)
    if keep is not None:
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        r.keep = keep
    if span_limit is not None:
        r.span_limit = span_limit
    if min_interval_s is not None:
        r.min_interval_s = min_interval_s
    return r
