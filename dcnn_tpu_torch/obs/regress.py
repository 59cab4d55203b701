"""Bench-history regression gate over the port's ``BENCH_TORCH_r*.json``
captures (counterpart of ``dcnn_tpu/obs/regress.py`` and of its command
line, ``benchmarks/compare.py``).

Each bench capture of the port is one ``BENCH_TORCH_rNN.json`` file; this
module compares the newest capture against a trailing window of prior
captures, per metric, and answers one question: *did we just get
meaningfully worse at anything we already did better?*

Gate semantics (deliberately asymmetric: improvements always pass):

- per metric, the baseline is the **best** value in the trailing window
  (max for higher-is-better, min for lower-is-better), so a regression
  cannot hide behind a weak early capture;
- a regression is a relative move past the metric's ``tolerance``
  (default 20%): ``newest < best × (1 - tol) - atol`` for
  higher-is-better, ``newest > best × (1 + tol) + atol`` for
  lower-is-better;
- metrics absent from a capture are skipped for that capture: the history
  may grow richer over time without old files being rewritten;
- a metric may declare a ``guard`` path: only window captures whose guard
  value equals the newest capture's are comparable (``compile_s`` is
  guarded on ``phases.compile_cache_hit``: a cold compile after a warm one
  is a cache state change, not a compiler regression).

**Departure from the JAX package, by design: the file name.**
:func:`find_bench_files`, and so :func:`gate_current` and the command
line's default, read only ``BENCH_TORCH_rNN.json``. The JAX package's
``BENCH_r*.json`` captures are another platform's figures; holding the
card's captures against them would gate nothing. Neither package's glob
matches the other's files. Everything else (the specs, the verdicts, the
report and its text) is the JAX module's, so both give the same answer on
the same history.

Command line::

    python -m dcnn_tpu_torch.obs.regress               # BENCH_TORCH_r*.json
                                                        # in the repo root
    python -m dcnn_tpu_torch.obs.regress A.json B.json  # oldest first; the
                                                        # last file is gated
    python -m dcnn_tpu_torch.obs.regress --window 3 --tolerance 0.15
    python -m dcnn_tpu_torch.obs.regress --json         # the whole report
    python -m dcnn_tpu_torch.obs.regress --self-test    # the fixture run

Exit code: 0 no regression, 1 regression(s) flagged, 2 fewer than two
captures or a bad knob. Standard library only.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import re
import sys
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

BENCH_PATTERN = "BENCH_TORCH_r*.json"
_BENCH_RE = re.compile(r"BENCH_TORCH_r(\d+)\.json$")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass(frozen=True)
class MetricSpec:
    """One gated metric: a dotted ``path`` into the capture's parsed JSON,
    a direction, and an optional noise tolerance / comparability guard.
    ``fallback`` names a second path tried when ``path`` is absent (a
    renamed key: ``mfu_formula`` reads older captures' ``mfu``)."""

    name: str
    path: str
    higher_is_better: bool = True
    tolerance: Optional[float] = None  # None -> the gate's default
    guard: Optional[str] = None        # dotted path; must match to compare
    fallback: Optional[str] = None     # alternate path for older captures
    # absolute slack beside the relative band: a lower-is-better metric
    # that legitimately records 0.0 would otherwise flag every later
    # nonzero capture, since best=0 collapses the relative band
    atol: float = 0.0


# The JAX package's gate set, spec for spec. Every tolerance, atol and
# guard below is the JAX module's value, so both packages give the same
# verdict on the same history; those tolerances were set from the other
# platform's run-to-run noise, and the port's benchmark re-derives them
# from the card's spread.
DEFAULT_METRICS: Sequence[MetricSpec] = (
    MetricSpec("img_per_sec", "value"),
    MetricSpec("mfu_formula", "mfu_formula", fallback="mfu"),
    MetricSpec("mfu_analytic", "mfu_analytic"),
    MetricSpec("h2d_gbps", "h2d_gbps", tolerance=0.75),
    MetricSpec("compile_s", "phases.compile_s", higher_is_better=False,
               tolerance=0.5, guard="phases.compile_cache_hit"),
    # guarded on the warm-hit flag: a warm pass that missed the cache is
    # a full compile wall, not a slower warm start
    MetricSpec("aot_warm_start_s", "phases.aot_warm_start_s",
               higher_is_better=False, tolerance=0.5,
               guard="aot.train.warm_hit"),
    MetricSpec("serve_int8_img_per_sec", "infer_int8_img_per_sec"),
    MetricSpec("serve_router_capacity_img_per_sec",
               "serving.router.capacity_img_per_sec",
               guard="serving.router.replicas"),
    MetricSpec("serve_router_capacity_scaling",
               "serving.router.capacity_scaling_x",
               guard="serving.router.replicas"),
    MetricSpec("serve_router_kill_availability",
               "serving.router.kill_soak.availability", tolerance=0.05),
    MetricSpec("autoscale.availability", "autoscale.availability",
               tolerance=0.01),
    # a clean soak records exactly 0.0; values inside the soak's budget
    # are operating as designed, not a regression against a perfect window
    MetricSpec("autoscale.slo_violation_minutes",
               "autoscale.slo_violation_minutes", higher_is_better=False,
               tolerance=0.5, atol=1.0),
    # reaction time is budgeted by the cooldown: the guard pins the knob
    MetricSpec("autoscale.scale_up_reaction_s",
               "autoscale.scale_up_reaction_s", higher_is_better=False,
               tolerance=0.5, guard="autoscale.up_cooldown_s", atol=5.0),
    # the pipeline kill-a-stage probe; batches_lost must stay 0, so any
    # increase flags (a per-metric tolerance of 0.0 is legal)
    MetricSpec("pipeline.detection_s", "resilience.pipeline.detection_s",
               higher_is_better=False, tolerance=1.0, atol=0.5,
               guard="resilience.pipeline.stages"),
    MetricSpec("pipeline.repartition_wall_s",
               "resilience.pipeline.repartition_wall_s",
               higher_is_better=False, tolerance=1.0, atol=2.0,
               guard="resilience.pipeline.stages"),
    MetricSpec("pipeline.batches_lost", "resilience.pipeline.batches_lost",
               higher_is_better=False, tolerance=0.0,
               guard="resilience.pipeline.stages"),
    # bytes shipped host to device per image is a design invariant of the
    # uint8 wire; streaming throughput compares only at the same wire
    MetricSpec("wire_bytes_per_image",
               "streaming_timeline.wire_bytes_per_image",
               higher_is_better=False, tolerance=0.05),
    MetricSpec("streaming_img_per_sec", "streaming_img_per_sec",
               tolerance=0.3,
               guard="streaming_timeline.wire_bytes_per_image"),
    MetricSpec("goodput_fraction",
               "telemetry_essentials.goodput.goodput_fraction",
               tolerance=0.25),
    # gray-failure probes: loopback sub-second walls (atol slack); the
    # hedged p99 is a ratio, so the machine's speed divides out
    MetricSpec("gray.detection_s", "resilience.gray.detection_s",
               higher_is_better=False, tolerance=1.0, atol=1.0,
               guard="resilience.gray.peers"),
    MetricSpec("gray.evict_wall_s", "resilience.gray.evict_wall_s",
               higher_is_better=False, tolerance=1.0, atol=1.0,
               guard="resilience.gray.peers"),
    MetricSpec("gray.hedge_p99_ratio", "resilience.gray.hedge_p99_ratio",
               higher_is_better=False, tolerance=0.5, atol=0.5,
               guard="resilience.gray.hedge_replicas"),
    # continuous-batching decode, guarded on the probe's slot count
    MetricSpec("decode.tokens_per_sec", "decode.tokens_per_sec",
               tolerance=0.3, guard="decode.max_slots"),
    MetricSpec("decode.ttft_p99_ms", "decode.ttft_p99_ms",
               higher_is_better=False, tolerance=1.0, atol=10.0,
               guard="decode.max_slots"),
    MetricSpec("decode.slot_occupancy", "decode.slot_occupancy",
               tolerance=0.25, guard="decode.max_slots"),
)

DEFAULT_TOLERANCE = 0.2
DEFAULT_WINDOW = 4


def get_path(d: Any, path: str) -> Optional[Any]:
    """Resolve a dotted path into nested dicts; None on any miss."""
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def load_capture(path: str) -> Optional[Dict[str, Any]]:
    """One capture file → its parsed-metrics dict, or None when unreadable.
    A capture wrapped under ``"parsed"`` is unwrapped; a bare bench JSON
    is accepted when it carries ``"metric"``."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        return data["parsed"]
    if isinstance(data, dict) and "metric" in data:
        return data
    return None


def find_bench_files(root: str) -> List[str]:
    """``BENCH_TORCH_r*.json`` under ``root``, oldest → newest by capture
    number (not mtime: a re-checkout resets mtimes, numbers stay)."""
    hits = []
    for p in _glob.glob(os.path.join(root, BENCH_PATTERN)):
        m = _BENCH_RE.search(os.path.basename(p))
        if m:
            hits.append((int(m.group(1)), p))
    return [p for _, p in sorted(hits)]


def compare(history: Sequence[Dict[str, Any]], *,
            metrics: Sequence[MetricSpec] = DEFAULT_METRICS,
            tolerance: float = DEFAULT_TOLERANCE,
            window: int = DEFAULT_WINDOW) -> Dict[str, Any]:
    """Gate the LAST entry of ``history`` against the trailing window of
    earlier entries. Returns the report dict; raises ``ValueError`` on an
    empty history or nonsensical knobs."""
    if not history:
        raise ValueError("empty bench history: nothing to compare")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not 0 < tolerance < 1:
        raise ValueError(f"tolerance must be in (0, 1), got {tolerance}")
    newest, prior = history[-1], list(history[:-1])
    rows: List[Dict[str, Any]] = []
    regressions: List[str] = []

    def resolve(entry, spec):
        v = get_path(entry, spec.path)
        if v is None and spec.fallback:
            v = get_path(entry, spec.fallback)
        return v

    for spec in metrics:
        tol = spec.tolerance if spec.tolerance is not None else tolerance
        cur = resolve(newest, spec)
        row: Dict[str, Any] = {
            "metric": spec.name, "path": spec.path,
            "higher_is_better": spec.higher_is_better,
            "tolerance": tol, "newest": cur,
        }
        if not isinstance(cur, (int, float)):
            row["verdict"] = "skipped: metric absent from newest capture"
            rows.append(row)
            continue
        guard_val = get_path(newest, spec.guard) if spec.guard else None
        vals: List[float] = []
        for entry in reversed(prior):  # newest-first until the window fills
            v = resolve(entry, spec)
            if not isinstance(v, (int, float)):
                continue
            if spec.guard and get_path(entry, spec.guard) != guard_val:
                continue  # another regime: not comparable
            vals.append(float(v))
            if len(vals) >= window:
                break
        if not vals:
            row["verdict"] = "skipped: no comparable prior capture"
            rows.append(row)
            continue
        best = max(vals) if spec.higher_is_better else min(vals)
        ratio = (float(cur) / best) if best else None
        if spec.higher_is_better:
            regressed = float(cur) < best * (1.0 - tol) - spec.atol
        else:
            regressed = float(cur) > best * (1.0 + tol) + spec.atol
        row.update({"window": list(reversed(vals)), "best": best,
                    "ratio": round(ratio, 4) if ratio is not None else None,
                    "verdict": "REGRESSED" if regressed else "ok"})
        rows.append(row)
        if regressed:
            regressions.append(spec.name)
    return {"metrics": rows, "regressions": regressions,
            "ok": not regressions, "window": window,
            "default_tolerance": tolerance}


def compare_files(paths: Sequence[str], **kw) -> Dict[str, Any]:
    """:func:`compare` over capture FILES (oldest → newest). Unreadable
    files are reported under ``unparseable_files``, never dropped
    silently."""
    history, skipped = [], []
    used = []
    for p in paths:
        cap = load_capture(p)
        if cap is None:
            skipped.append(p)
            continue
        history.append(cap)
        used.append(p)
    report = compare(history, **kw)
    report["files"] = used
    report["unparseable_files"] = skipped
    return report


def gate_current(current: Dict[str, Any], root: str, **kw
                 ) -> Optional[Dict[str, Any]]:
    """Gate an in-flight bench result against the ``BENCH_TORCH_r*.json``
    history under ``root``. ``None`` when there is no history (nothing to
    regress against); never raises, a failure comes back as
    ``{"error": ...}``: the gate rides along a bench run and must not end
    it."""
    try:
        files = find_bench_files(root)
        history = [c for c in (load_capture(p) for p in files)
                   if c is not None]
        if not history:
            return None
        report = compare(history + [current], **kw)
        report["baseline_files"] = files
        return report
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable table for the command line."""
    lines = []
    for row in report["metrics"]:
        if "best" not in row:
            lines.append(f"  {row['metric']:<24} {row['verdict']}")
            continue
        arrow = "↑" if row["higher_is_better"] else "↓"
        lines.append(
            f"  {row['metric']:<24} {arrow} newest {row['newest']:g} "
            f"vs best-of-{len(row['window'])} {row['best']:g} "
            f"(ratio {row['ratio']}, tol {row['tolerance']:.0%}) "
            f"-> {row['verdict']}")
    verdict = ("OK: no regressions" if report["ok"] else
               f"REGRESSED: {', '.join(report['regressions'])}")
    return "\n".join(lines + [verdict])


# --------------------------------------------------------- the self-test

# Made-up fixture captures in the shape of a real history: img/s growing
# run over run, metrics appearing over time, one noisy series (h2d_gbps
# bouncing within its wide tolerance).
_FIXTURE_HISTORY = [
    {"metric": "m", "value": 1500.0},
    {"metric": "m", "value": 4100.0, "mfu": 0.21, "h2d_gbps": 24.0},
    {"metric": "m", "value": 4500.0, "mfu": 0.23, "h2d_gbps": 8.5},
    {"metric": "m", "value": 4700.0, "mfu": 0.24, "h2d_gbps": 22.0},
    {"metric": "m", "value": 4900.0, "mfu": 0.25, "h2d_gbps": 9.0,
     "infer_int8_img_per_sec": 60000.0,
     "phases": {"compile_s": 40.0, "compile_cache_hit": None}},
]
# planted: img/s 25% below the window's best; the gate must flag it alone
_FIXTURE_REGRESSED = {
    "metric": "m", "value": 3675.0, "mfu": 0.245, "h2d_gbps": 20.0,
    "infer_int8_img_per_sec": 60500.0,
    "phases": {"compile_s": 41.0, "compile_cache_hit": None}}
# planted clean: every metric within its tolerance; the gate must pass it
_FIXTURE_CLEAN = {
    "metric": "m", "value": 4850.0, "mfu": 0.248, "h2d_gbps": 19.0,
    "infer_int8_img_per_sec": 59500.0,
    "phases": {"compile_s": 39.5, "compile_cache_hit": None}}


def self_test() -> int:
    """Fixture run: write captures under the port's file name, plant a
    regression, check that the gate catches exactly it. Prints PASS/FAIL
    lines; returns an exit code."""
    failures = []

    def check(name, cond):
        print(f"  {'PASS' if cond else 'FAIL'}: {name}")
        if not cond:
            failures.append(name)

    def write(d, n, cap):
        # a fixture in the self-test's own temp dir, gone when it ends: a
        # torn file could only fail the self-test
        path = os.path.join(d, f"BENCH_TORCH_r{n:02d}.json")
        with open(path, "w") as f:  # dcnn: disable=AT01
            json.dump({"n": n, "parsed": cap}, f)

    with tempfile.TemporaryDirectory() as d:
        for i, cap in enumerate(_FIXTURE_HISTORY, start=1):
            write(d, i, cap)
        files = find_bench_files(d)
        check("fixture discovery finds 5 captures in order",
              len(files) == 5 and files == sorted(files))

        clean = compare_files(files)
        check("clean fixture trajectory passes", clean["ok"])

        # append the planted-regression capture as r06 and re-gate
        write(d, 6, _FIXTURE_REGRESSED)
        flagged = compare_files(find_bench_files(d))
        check("planted 25% img/s regression is flagged",
              not flagged["ok"] and "img_per_sec" in flagged["regressions"])
        check("only the planted metric is flagged",
              flagged["regressions"] == ["img_per_sec"])

        # replace r06 with an in-tolerance capture: must pass again
        write(d, 6, _FIXTURE_CLEAN)
        ok_again = compare_files(find_bench_files(d))
        check("in-tolerance follow-up capture passes", ok_again["ok"])

        # lower-is-better: compile_s blowing up must flag (same
        # cache-warmth guard value as the prior capture)
        blown = dict(_FIXTURE_CLEAN)
        blown["phases"] = {"compile_s": 120.0, "compile_cache_hit": None}
        write(d, 6, blown)
        comp = compare_files(find_bench_files(d))
        check("compile_s blow-up (same cache state) is flagged",
              "compile_s" in comp["regressions"])

        # ...but a cache-warmth change makes compile_s incomparable
        warm = dict(blown)
        warm["phases"] = {"compile_s": 120.0, "compile_cache_hit": True}
        write(d, 6, warm)
        guarded = compare_files(find_bench_files(d))
        row = next(r for r in guarded["metrics"]
                   if r["metric"] == "compile_s")
        check("compile_s skipped across a cache-warmth change",
              row["verdict"].startswith("skipped"))

    print("self-test:", "PASS" if not failures else
          f"FAIL ({len(failures)}: {failures})")
    return 0 if not failures else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.obs.regress",
        description="gate the newest bench capture against the trailing "
                    "window of prior captures")
    ap.add_argument("files", nargs="*",
                    help="capture files oldest->newest (default: "
                         f"{BENCH_PATTERN} in the repo root)")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help="trailing captures compared per metric "
                         "(default %(default)s)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="default relative tolerance; per-metric overrides "
                         "in DEFAULT_METRICS still apply "
                         "(default %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--self-test", action="store_true",
                    help="run the fixture-based gate self-test and exit")
    args = ap.parse_args(argv)

    if args.self_test:
        return self_test()

    files = args.files or find_bench_files(_ROOT)
    if len(files) < 2:
        print(f"need >= 2 captures to compare, found {len(files)} "
              f"({files or f'no {BENCH_PATTERN} in {_ROOT}'})",
              file=sys.stderr)
        return 2
    try:
        report = compare_files(files, window=args.window,
                               tolerance=args.tolerance)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"gating {os.path.basename(report['files'][-1])} against "
              f"{len(report['files']) - 1} prior capture(s), "
              f"window {report['window']}:")
        print(format_report(report))
        if report["unparseable_files"]:
            print(f"  (skipped unparseable: "
                  f"{report['unparseable_files']})")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
