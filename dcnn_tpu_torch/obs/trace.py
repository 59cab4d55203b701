"""Multi-process trace merge and flight-bundle inspection CLI
(counterpart of ``dcnn_tpu/obs/trace.py``).

``obs/tracer.py`` gives every process identity-stamped spans and a JSONL
shard exporter (``dcnn-trace-jsonl/1``); ``parallel/comm.py`` carries the
trace context across every framed hop. This module merges the
per-process shards into **one** Perfetto-loadable Chrome trace, where a
request (or a reconfiguration) reads as a single cross-process timeline:

    python -m dcnn_tpu_torch.obs.trace merge router.jsonl replica-*.jsonl \\
        -o fleet_trace.json
    python -m dcnn_tpu_torch.obs.trace inspect flight/fb-...-replica_death

Clock alignment: shard events are relative to each tracer's epoch, and
the shard header (first JSONL line) carries that epoch in the process's
``perf_counter`` domain. On one host ``perf_counter`` is
``CLOCK_MONOTONIC``, one clock system-wide on Linux, so same-host shards
align **exactly** with no configuration. Across hosts, pass
``--offset <shard-basename>=<seconds>`` per shard; the live system
measures these offsets at handshake time (``TcpReplica.clock_offset_s``,
``Membership.clock_offsets()``). A shard may also carry
``clock_offset_s`` in its header, applied when no flag overrides it.

Merged layout: one Chrome **pid** per shard (``process_name`` from the
shard's host/pid/name identity), one **tid** per (shard, track) with
``thread_name`` metadata. Span args (``trace_id``/``span_id``/
``parent_id`` included) ride through untouched, so Perfetto's args search
finds every span of a trace across all processes.

Exit codes: 0 ok, 1 validation or tool failure, 2 usage. Standard
library only.
"""

from __future__ import annotations

import argparse
import gzip as _gzip
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple


# --------------------------------------------------------------- shard IO

def read_shard(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Parse one JSONL shard (plain or ``.gz``) into ``(meta, events)``.
    The header line is recognized by its ``shard`` key; a headerless file
    (hand-made fixture) yields ``meta == {}``. Malformed lines raise —
    a half-merged timeline is worse than no timeline."""
    opener = _gzip.open if path.endswith(".gz") else open
    meta: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    with opener(path, "rt") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: bad JSONL: {e}") from e
            if "shard" in obj and "name" not in obj:
                meta = dict(obj["shard"])
            elif "name" in obj:
                events.append(obj)
            else:
                raise ValueError(f"{path}:{lineno}: neither a shard "
                                 f"header nor an event: {obj!r}")
    return meta, events


def _shard_label(path: str) -> str:
    return os.path.basename(path)


def _process_name(path: str, meta: Dict[str, Any]) -> str:
    name = meta.get("process")
    host = meta.get("host")
    pid = meta.get("pid")
    base = name if name else _shard_label(path)
    if host and pid:
        return f"{base} ({host}:{pid})"
    return str(base)


# ----------------------------------------------------------------- merge

def merge_shards(paths: List[str], out: str, *,
                 offsets: Optional[Dict[str, float]] = None,
                 max_events: Optional[int] = None) -> Dict[str, Any]:
    """Merge JSONL shards into one Chrome ``trace_event`` file at
    ``out`` (written atomically: tmp sibling + ``os.replace``). Returns
    a summary dict: event counts, distinct trace ids, per-shard identity,
    and total events the writers reported dropping."""
    if not paths:
        raise ValueError("no shards to merge")
    offsets = dict(offsets or {})
    shards = []
    for p in paths:
        meta, events = read_shard(p)
        off = offsets.get(_shard_label(p),
                          float(meta.get("clock_offset_s") or 0.0))
        shards.append((p, meta, events, float(meta.get("epoch_s") or 0.0),
                       off))

    # absolute timeline: t_abs = epoch + ts - offset (an offset measured
    # as "server_clock - client_clock" maps a server shard BACK onto the
    # reference timeline); normalized to the earliest event so the
    # viewer opens at t=0
    t_min: Optional[float] = None
    for (_p, _m, events, epoch, off) in shards:
        for ev in events:
            t = epoch + float(ev["ts_s"]) - off
            if t_min is None or t < t_min:
                t_min = t
    t_min = t_min or 0.0

    chrome: List[Dict[str, Any]] = []
    tids: Dict[Tuple[int, str], int] = {}
    next_tid = 1
    trace_ids = set()
    total = 0
    dropped = 0
    shard_summaries = []
    for i, (p, meta, events, epoch, off) in enumerate(shards):
        pid = i + 1
        chrome.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": _process_name(p, meta)}})
        dropped += int(meta.get("dropped") or 0)
        for ev in events:
            track = ev.get("track") or "main"
            key = (pid, track)
            if key not in tids:
                tids[key] = next_tid
                chrome.append({"ph": "M", "pid": pid, "tid": next_tid,
                               "name": "thread_name",
                               "args": {"name": track}})
                next_tid += 1
            args = dict(ev.get("args") or {})
            tid_val = args.get("trace_id")
            if tid_val:
                trace_ids.add(tid_val)
            ts_us = round((epoch + float(ev["ts_s"]) - off - t_min) * 1e6,
                          3)
            rec: Dict[str, Any] = {
                "name": ev["name"], "pid": pid, "tid": tids[key],
                "ts": ts_us, "cat": str(ev["name"]).split(".", 1)[0],
                "args": args,
            }
            if ev.get("dur_s") is None:
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(float(ev["dur_s"]) * 1e6, 3)
            chrome.append(rec)
            total += 1
        shard_summaries.append({
            "path": p, "events": len(events), "offset_s": off,
            "process": _process_name(p, meta),
        })

    if max_events is not None and total > max_events:
        # newest-N survive, like Tracer.export_chrome — metadata records
        # (ph M) are kept, the drop is explicit in the summary
        metas = [e for e in chrome if e["ph"] == "M"]
        evs = sorted((e for e in chrome if e["ph"] != "M"),
                     key=lambda e: e["ts"])
        cut = len(evs) - max_events
        chrome = metas + evs[cut:]
        dropped += cut

    # events sorted by timestamp read better in "flow" tooling; Perfetto
    # does not require it but diffable output does
    metas = [e for e in chrome if e["ph"] == "M"]
    evs = sorted((e for e in chrome if e["ph"] != "M"),
                 key=lambda e: e["ts"])
    doc = {"traceEvents": metas + evs, "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = f"{out}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return {
        "out": out,
        "shards": shard_summaries,
        "events": len(evs),
        "trace_ids": len(trace_ids),
        "events_dropped_by_writers": dropped,
    }


# ------------------------------------------------------------- validation

#: Chrome trace_event phases this repo emits.
_PHASES = {"X", "i", "M"}


def validate_chrome(path: str) -> List[str]:
    """Schema problems in a Chrome trace file (empty list = loadable by
    Perfetto/chrome://tracing as far as this repo's emitters go)."""
    problems: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable: {e}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in ev:
                problems.append(f"event {i}: missing {k}")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: non-numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete span without dur")
        if not isinstance(ev.get("args", {}), dict):
            problems.append(f"event {i}: args not a dict")
    return problems


# ------------------------------------------------------- bundle inspection

def inspect_bundle(path: str) -> Dict[str, Any]:
    """Summarize one flight-recorder bundle directory: manifest, files,
    span/trace counts, healthz reasons — the postmortem's front page."""
    if not os.path.isdir(path):
        raise ValueError(f"not a bundle directory: {path}")
    out: Dict[str, Any] = {"path": path,
                           "files": sorted(os.listdir(path))}
    mpath = os.path.join(path, "MANIFEST.json")
    try:
        with open(mpath) as f:
            out["manifest"] = json.load(f)
    except (OSError, ValueError) as e:
        out["manifest_error"] = str(e)
    spath = os.path.join(path, "spans.jsonl")
    if os.path.isfile(spath):
        _meta, events = read_shard(spath)
        out["spans"] = len(events)
        counts: Dict[str, int] = {}
        traces = set()
        for ev in events:
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
            t = (ev.get("args") or {}).get("trace_id")
            if t:
                traces.add(t)
        out["span_counts"] = counts
        out["trace_ids"] = len(traces)
    hpath = os.path.join(path, "healthz.json")
    if os.path.isfile(hpath):
        try:
            with open(hpath) as f:
                h = json.load(f)
            out["healthz"] = {"status": h.get("status"),
                              "reasons": h.get("reasons")}
        except (OSError, ValueError) as e:
            out["healthz_error"] = str(e)
    # tsdb history window (obs/tsdb.py): the minutes BEFORE the trigger
    tpath = os.path.join(path, "history.jsonl")
    if os.path.isfile(tpath):
        try:
            from .tsdb import summarize_history
            out["history"] = summarize_history(tpath)
        except (OSError, ValueError) as e:
            out["history_error"] = str(e)
    return out


# -------------------------------------------------------------------- CLI

def _parse_offsets(pairs: List[str]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in pairs:
        name, sep, val = p.rpartition("=")
        if not sep:
            raise ValueError(f"--offset wants <shard-basename>=<seconds>, "
                             f"got {p!r}")
        out[name] = float(val)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.obs.trace",
        description="Merge per-process trace shards into one "
                    "Perfetto-loadable Chrome trace; inspect flight "
                    "bundles.")
    sub = ap.add_subparsers(dest="cmd")
    mp = sub.add_parser("merge", help="merge JSONL shards → Chrome trace")
    mp.add_argument("shards", nargs="+",
                    help="JSONL shard files (Tracer.export_jsonl / "
                         "flush_jsonl output, .gz ok; a flight bundle's "
                         "spans.jsonl works too)")
    mp.add_argument("-o", "--out", required=True,
                    help="merged Chrome trace path")
    mp.add_argument("--offset", action="append", default=[],
                    metavar="SHARD=SECONDS",
                    help="clock offset for one shard (basename match): "
                         "its events shift by -SECONDS onto the "
                         "reference timeline; measured at handshake "
                         "(TcpReplica.clock_offset_s, "
                         "Membership.clock_offsets)")
    mp.add_argument("--max-events", type=int, default=None,
                    help="keep only the newest N events (viewers choke "
                         "on multi-million-event files)")
    mp.add_argument("--json", action="store_true",
                    help="print the summary as JSON")
    ip = sub.add_parser("inspect", help="summarize a flight bundle")
    ip.add_argument("bundle", help="flight bundle directory (fb-*)")
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2
    try:
        if args.cmd == "merge":
            summary = merge_shards(
                list(args.shards), args.out,
                offsets=_parse_offsets(list(args.offset)),
                max_events=args.max_events)
            problems = validate_chrome(args.out)
            if problems:
                print("merged trace FAILED schema validation:",
                      file=sys.stderr)
                for p in problems[:20]:
                    print(f"  {p}", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(summary, indent=1))
            else:
                print(f"merged {len(summary['shards'])} shard(s), "
                      f"{summary['events']} events, "
                      f"{summary['trace_ids']} distinct traces "
                      f"-> {summary['out']}")
                for s in summary["shards"]:
                    print(f"  {s['process']}: {s['events']} events "
                          f"(offset {s['offset_s']:+g}s) [{s['path']}]")
                if summary["events_dropped_by_writers"]:
                    print(f"  note: writers reported "
                          f"{summary['events_dropped_by_writers']} "
                          f"events dropped before export "
                          f"(ring saturation / --max-events)")
            return 0
        summary = inspect_bundle(args.bundle)
        print(json.dumps(summary, indent=1, default=str))
        return 0
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
