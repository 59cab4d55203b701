"""CLI: ``python -m dcnn_tpu_torch.analysis [paths...]``.

Exit codes: 0 = clean (no unsuppressed findings), 1 = unsuppressed
findings, 2 = usage/internal error. ``--json`` emits a machine-readable
report (the shape the bench/CI tooling consumes); default output is one
``path:line: CHECK (symbol) message`` line per finding plus a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .core import (Baseline, DEFAULT_BASELINE, all_checks, analyze_paths,
                   unsuppressed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dcnn_tpu_torch.analysis",
        description="Capture-safety / concurrency / atomicity static "
                    "analysis")
    p.add_argument("paths", nargs="*", default=["dcnn_tpu_torch"],
                   help="files or directories to analyze "
                        "(default: dcnn_tpu_torch)")
    p.add_argument("--json", action="store_true",
                   help="emit a JSON report instead of text")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline file of accepted findings "
                        "(default: the committed package baseline)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write a skeleton baseline covering every current "
                        "unsuppressed finding, then exit 0")
    p.add_argument("--checks", default=None,
                   help="comma-separated check ids to run "
                        "(default: all)")
    p.add_argument("--list-checks", action="store_true",
                   help="print the check-id table and exit")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed findings in the text output")
    p.add_argument("--only", default=None, metavar="PATHS",
                   help="comma-separated display paths: analyze the full "
                        "paths given, report findings only for these "
                        "files (keeps whole-project checks like "
                        "DL01/PR01 accurate while scoping the report)")
    p.add_argument("--fault-coverage", action="store_true",
                   help="FC01: every fault trip point referenced in the "
                        "package must be armed by a test_torch_*.py test "
                        "under --tests")
    p.add_argument("--metric-drift", action="store_true",
                   help="MD01: emitted obs.registry metric names and "
                        "docs/observability.md must agree, both ways")
    p.add_argument("--span-coverage", action="store_true",
                   help="GP01: every tracer span recorded in the package "
                        "must map to a goodput bucket in "
                        "obs/goodput.SPAN_BUCKETS")
    p.add_argument("--tests", default="tests",
                   help="tests directory for --fault-coverage "
                        "(default: tests)")
    p.add_argument("--doc", default=os.path.join("docs",
                                                 "observability.md"),
                   help="metric documentation for --metric-drift")
    return p


def _run_lints(args) -> int:
    """The cross-directory coverage lints (FC01/MD01/GP01). The package dir is
    the first positional path."""
    from .core import load_project
    from .coverage import (check_fault_coverage, check_metric_drift,
                           check_span_coverage)

    pkg = args.paths[0] if args.paths else "dcnn_tpu_torch"
    project = load_project([pkg])  # parsed once, shared by all the lints
    findings = []
    if args.fault_coverage:
        findings += check_fault_coverage(pkg, args.tests, project=project)
    if args.metric_drift:
        findings += check_metric_drift(pkg, args.doc, project=project)
    if args.span_coverage:
        findings += check_span_coverage(pkg, project=project)
    if args.only:
        scope = {s.strip().replace(os.sep, "/")
                 for s in args.only.split(",") if s.strip()}
        findings = [f for f in findings if f.path in scope]
    live = [f for f in findings if not f.suppressed]
    if args.json:
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "unsuppressed": len(live)}, indent=2))
    else:
        for f in (findings if args.show_suppressed else live):
            print(f.render())
        print(f"{len(live)} finding(s)")
    return 1 if live else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        for cid, check in sorted(all_checks().items()):
            print(f"{cid}  {check.name:20s} {check.description}")
        return 0
    for p in args.paths:
        if not os.path.exists(p):
            print(f"error: no such path {p!r}", file=sys.stderr)
            return 2
    if args.fault_coverage or args.metric_drift or args.span_coverage:
        return _run_lints(args)
    checks = ([c.strip() for c in args.checks.split(",") if c.strip()]
              if args.checks else None)
    baseline = Baseline() if args.no_baseline else Baseline.load(
        args.baseline)
    t0 = time.perf_counter()
    try:
        findings = analyze_paths(args.paths, checks=checks,
                                 baseline=baseline)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    if args.only:
        if args.write_baseline:
            # a baseline rendered from a filtered report would silently
            # drop every out-of-scope accepted finding
            print("error: --only cannot be combined with "
                  "--write-baseline", file=sys.stderr)
            return 2
        scope = {s.strip().replace(os.sep, "/")
                 for s in args.only.split(",") if s.strip()}
        findings = [f for f in findings if f.path in scope]
    live = unsuppressed(findings)
    if args.write_baseline:
        # dogfood the committed-artifact discipline this suite enforces
        # (resilience.atomic is plain Python: the CLI runs on any host)
        from ..resilience.atomic import write_file_atomic
        write_file_atomic(args.write_baseline,
                          Baseline.render(findings).encode("utf-8"))
        print(f"wrote {len(live)} finding(s) to {args.write_baseline} — "
              f"fill in the justifications before committing")
        return 0
    if args.json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "unsuppressed": len(live),
            "suppressed": len(findings) - len(live),
            "wall_s": round(wall, 3),
            "checks": sorted(checks or all_checks()),
        }, indent=2))
    else:
        shown = findings if args.show_suppressed else live
        for f in shown:
            print(f.render())
        n_inline = sum(1 for f in findings if f.suppressed_by == "inline")
        n_base = sum(1 for f in findings if f.suppressed_by == "baseline")
        print(f"{len(live)} finding(s), {n_inline} inline-suppressed, "
              f"{n_base} baselined ({wall:.2f}s)")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
