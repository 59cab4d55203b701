"""Repo-contract coverage lints: fault-point arming, metric-name drift,
and tracer-span → goodput-bucket coverage.

These lints close gaps the AST checks cannot see because the contract
spans directories the package analysis never reads (``tests/``, ``docs/``)
or a normative table in another module (``obs/goodput.py``):

- **FC01 fault-unarmed** (``python -m dcnn_tpu_torch.analysis
  --fault-coverage``): every :func:`~dcnn_tpu_torch.resilience.faults.trip`
  point referenced in the package must be armed by at least one of the
  port's tests (``test_torch_*.py`` under ``tests/``) — a fault hook nobody
  arms is a recovery path nobody has ever executed, and it ships silently.
  A point that only a test of the JAX package arms has never run in the
  port. Detection is textual on the test side (the point name, quoted, in
  a port test file), AST-based on the production side (string-literal
  first argument of a ``trip``/``_trip`` call, or of their
  delay-injection twins ``slowdown``/``_slowdown``/``_slow_sleep`` —
  ``FaultPlan.slow`` points are recovery paths too).
- **MD01 metric-drift** (``--metric-drift``): every Counter/Gauge/
  Histogram name emitted through ``obs.registry``-style calls
  (``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)``) must appear
  in ``docs/observability.md`` (the port emits the JAX package's metric
  names; the lint reads that file and never edits it), and every
  documented series with a metric-shaped suffix must still be emitted by
  live code — no documented-but-dead rows. F-strings become globs
  (``serve_router_requests_{p}_total`` ↔ the documented
  ``serve_router_requests_<class>_total``); ``{a,b}`` brace groups in the
  docs expand; a dynamically-named instrument that the AST cannot
  resolve must carry a ``# dcnn: metric=<glob>`` declaration on its line
  (globs join the emitted set) or it is itself a finding.
- **GP01 span-unmapped** (``--span-coverage``): every tracer span name
  recorded in the package must map to a goodput bucket in
  ``obs/goodput.SPAN_BUCKETS`` (:func:`check_span_coverage`) — unmapped
  instrumentation silently becomes ``unattributed`` wall time in every
  ledger window. A call whose receiver resolves to a project class
  defined outside ``obs/tracer.py`` (``TrainStep.begin(ts, lr)``) is
  another API's method, not a span.

All three lints return ordinary :class:`~dcnn_tpu_torch.analysis.core.Finding`
objects (inline ``# dcnn: disable=FC01/MD01/GP01`` suppression applies)
and exit nonzero from the CLI on unsuppressed findings.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ClassIndex, receiver_class
from .callgraph import call_name as _call_tail
from .core import Finding, SourceModule, load_project

# the port's own tests: a point only the JAX package's tests arm has
# never run in the port
PORT_TESTS = "test_torch_"
TRIP_TAILS = {"trip", "_trip",
              # the delay-injection twins (FaultPlan.slow): a slowdown
              # hook nobody arms is a gray-failure path nobody has ever
              # executed — exactly the FC01 contract
              "slowdown", "_slowdown", "_slow_sleep"}
# registry get-or-create calls plus the exposition-side derived-gauge
# renderer (the windowed percentiles ride render_scalar, not the registry)
METRIC_TAILS = {"counter", "gauge", "histogram", "render_scalar"}
# tutorial placeholders in the docs quickstart are not series claims
DOC_PLACEHOLDER_PREFIX = "my_"
# infrastructure modules whose counter()/gauge() mentions are definitions,
# not emissions
METRIC_INFRA = ("obs/registry.py", "obs/exposition.py")
METRIC_SUFFIXES = ("_total", "_seconds", "_ms", "_bytes", "_kb", "_gbps",
                   "_ips", "_depth")

_DOC_TOKEN_RE = re.compile(r"`([^`]+)`")
_NAME_RE = re.compile(r"^[A-Za-z_*][A-Za-z0-9_*]*$")


# --------------------------------------------------------------- FC01 --

def collect_trip_points(project: Dict[str, SourceModule]
                        ) -> Dict[str, Tuple[str, int, str]]:
    """``{point name: (path, line, symbol)}`` for every string-literal
    trip point referenced in the package."""
    out: Dict[str, Tuple[str, int, str]] = {}
    for path, mod in project.items():
        if path.endswith("analysis") or "/analysis/" in path:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _call_tail(node.func) in TRIP_TAILS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            point = node.args[0].value
            fn = mod.enclosing_function(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            out.setdefault(point, (path, node.lineno, qn))
    return out


def check_fault_coverage(pkg_dir: str, tests_dir: str, *,
                         project: Optional[Dict[str, SourceModule]] = None
                         ) -> List[Finding]:
    """FC01: every trip point in ``pkg_dir`` appears (as a string) in at
    least one port test file (``test_torch_*.py``) under ``tests_dir``.
    ``project`` lets a caller running several lints share one parsed
    tree."""
    if project is None:
        project = load_project([pkg_dir])
    points = collect_trip_points(project)
    corpus: List[str] = []
    for dirpath, dirnames, filenames in os.walk(tests_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.startswith(PORT_TESTS) and f.endswith(".py"):
                with open(os.path.join(dirpath, f), "r",
                          encoding="utf-8") as fh:
                    corpus.append(fh.read())
    blob = "\n".join(corpus)
    out: List[Finding] = []
    for point, (path, line, qn) in sorted(points.items()):
        # quoted, whole-name match: 'ckpt.write' must not count as armed
        # because a test arms 'ckpt.write_meta' (or mentions the name in
        # a bare comment)
        if re.search(r"['\"]" + re.escape(point) + r"['\"]", blob):
            continue
        out.append(Finding(
            "FC01", path, line, qn, point,
            f"fault point '{point}' is referenced in production code but "
            f"armed by no {PORT_TESTS}*.py test under {tests_dir}/ — its "
            f"recovery path has "
            f"never executed; add a test arming it (FaultPlan.arm"
            f"('{point}', ...))"))
    for f in out:
        mod = project.get(f.path)
        if mod is not None and mod.is_suppressed("FC01", f.line):
            f.suppressed_by = "inline"
    return out


# --------------------------------------------------------------- MD01 --

def _name_pattern(node: ast.AST) -> Optional[str]:
    """Metric-name expression -> exact name or ``*`` glob, or None when
    unresolvable. Handles string constants, f-strings, and ``a + b``
    concatenation with constant parts."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _name_pattern(node.left)
        right = _name_pattern(node.right)
        if left is None and right is None:
            return None
        return (left or "*") + (right or "*")
    return None


def collect_emitted(project: Dict[str, SourceModule]
                    ) -> Tuple[Dict[str, Tuple[str, int, str]],
                               List[Finding]]:
    """(``{name-or-glob: site}``, unresolvable-name findings)."""
    emitted: Dict[str, Tuple[str, int, str]] = {}
    problems: List[Finding] = []
    for path, mod in project.items():
        if path.endswith(METRIC_INFRA) or "/analysis/" in path:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _call_tail(node.func) in METRIC_TAILS
                    and node.args):
                continue
            fn = mod.enclosing_function(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            # a # dcnn: metric= declaration on the call's lines wins
            end = getattr(node, "end_lineno", node.lineno)
            declared = None
            for ln in range(node.lineno, end + 1):
                if ln in mod.metric_names:
                    declared = mod.metric_names[ln]
                    break
            if declared is not None:
                for g in declared:
                    emitted.setdefault(g, (path, node.lineno, qn))
                continue
            pat = _name_pattern(node.args[0])
            if pat is None:
                problems.append(Finding(
                    "MD01", path, node.lineno, qn, "<unresolvable>",
                    f".{_call_tail(node.func)}() with a dynamic metric "
                    f"name the lint cannot resolve — declare it with "
                    f"'# dcnn: metric=<glob>' on this line"))
                continue
            emitted.setdefault(pat, (path, node.lineno, qn))
    return emitted, problems


def _doc_tokens(doc_text: str) -> Set[str]:
    """Backticked metric-name candidates: brace groups expanded,
    ``<placeholder>`` segments mapped to ``*``. Fenced ``` blocks are
    stripped first (their triple backticks would break inline-span
    pairing) — metric mentions inside them still count via a plain
    name-shaped scan of their contents."""
    fenced = re.findall(r"```.*?```", doc_text, flags=re.S)
    inline_text = re.sub(r"```.*?```", " ", doc_text, flags=re.S)
    out: Set[str] = set()
    spans = list(_DOC_TOKEN_RE.findall(inline_text))
    for block in fenced:
        spans.extend(re.findall(r"[A-Za-z_][A-Za-z0-9_<>{},*]*_[A-Za-z0-9_"
                                r"<>{},*]+", block))
    for span in spans:
        # split on whitespace/slashes only — commas inside {a,b} brace
        # groups are expansion alternatives, not separators
        for raw in re.split(r"[\s/]+", span):
            raw = raw.strip("`.,:;()")
            if not raw or "_" not in raw:
                continue
            tok = re.sub(r"<[^<>]*>", "*", raw)
            expands = [""]
            ok = True
            while "{" in tok:
                m = re.search(r"\{([^{}]*)\}", tok)
                if m is None or not m.group(1):
                    ok = False
                    break
                pre = tok[:m.start()]
                alts = m.group(1).split(",")
                expands = [e + pre + a for e in expands for a in alts]
                tok = tok[m.end():]
            if not ok:
                continue
            for e in expands:
                cand = e + tok
                if _NAME_RE.match(cand):
                    out.add(cand)
    return out


def _matches(a: str, b: str) -> bool:
    """Glob-tolerant name match in either direction."""
    return fnmatch.fnmatchcase(a, b) or fnmatch.fnmatchcase(b, a)


def check_metric_drift(pkg_dir: str, doc_path: str, *,
                       project: Optional[Dict[str, SourceModule]] = None
                       ) -> List[Finding]:
    """MD01 both directions: emitted-but-undocumented (every emitted
    name/glob must match a documented token) and documented-but-dead
    (documented tokens with a metric suffix must match an emission)."""
    if project is None:
        project = load_project([pkg_dir])
    emitted, out = collect_emitted(project)
    doc_rel = os.path.basename(doc_path)
    if not os.path.isfile(doc_path):
        out.append(Finding("MD01", doc_rel, 0, "<doc>", "missing",
                           f"metric documentation {doc_path} not found"))
        return out
    with open(doc_path, "r", encoding="utf-8") as f:
        doc_text = f.read()
    tokens = {t for t in _doc_tokens(doc_text)
              if not t.startswith(DOC_PLACEHOLDER_PREFIX)}
    for pat, (path, line, qn) in sorted(emitted.items()):
        if any(_matches(pat, t) for t in tokens):
            continue
        out.append(Finding(
            "MD01", path, line, qn, pat,
            f"metric '{pat}' is emitted here but never appears in "
            f"{doc_rel} — document the series (or fix the name)"))
    doc_lines = doc_text.splitlines()
    for tok in sorted(tokens):
        if not tok.endswith(METRIC_SUFFIXES):
            continue
        if any(_matches(tok, p) for p in emitted):
            continue
        # anchor on the longest literal segment of the token — a leading
        # wildcard must not anchor everything to line 1
        parts = [p for p in tok.split("*") if p]
        probe = max(parts, key=len) if parts else None
        line = next((i for i, t in enumerate(doc_lines, start=1)
                     if probe is not None and probe in t), 0)
        out.append(Finding(
            "MD01", doc_rel, line, "<doc>", tok,
            f"documented series '{tok}' matches no emission in "
            f"{pkg_dir}/ — a dead row misleads every operator reading "
            f"the table; delete it or restore the instrument"))
    for f in out:
        mod = project.get(f.path)
        if mod is not None and mod.is_suppressed("MD01", f.line):
            f.suppressed_by = "inline"
    return out


# -- GP01: tracer-span → goodput-bucket coverage -------------------------

#: Tracer recording entry points whose first argument is the span name.
SPAN_TAILS = {"span", "begin", "instant", "record_span"}
#: The recording machinery itself (name *parameters*, export artifacts) —
#: excluded like METRIC_INFRA.
SPAN_INFRA = ("obs/tracer.py",)
#: Where the normative mapping lives.
GOODPUT_MODULE = "obs/goodput.py"


def collect_span_buckets(project: Dict[str, SourceModule]
                         ) -> Optional[Dict[str, Optional[str]]]:
    """AST-extract the ``SPAN_BUCKETS`` dict literal from
    ``obs/goodput.py`` — parsed, never imported, so the lint runs on a
    host that can't import the package (same reason the other lints work
    on trees)."""
    for path, mod in project.items():
        if not path.endswith(GOODPUT_MODULE):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                target = node.target
            else:
                continue
            if (isinstance(target, ast.Name)
                    and target.id == "SPAN_BUCKETS"
                    and isinstance(node.value, ast.Dict)):
                mapping: Dict[str, Optional[str]] = {}
                for k, v in zip(node.value.keys, node.value.values):
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and isinstance(v, ast.Constant)):
                        mapping[k.value] = v.value
                return mapping
    return None


def _other_api(classes: ClassIndex, path: str, mod: SourceModule,
               fn: Optional[ast.AST], func: ast.AST) -> bool:
    """``recv.begin(...)`` whose receiver is a project class defined
    outside the tracer module: that class's own method, not a span."""
    if not isinstance(func, ast.Attribute):
        return False
    cname = receiver_class(classes, path, mod, fn, func.value)
    if cname is None:
        return False
    return all(not cpath.endswith(SPAN_INFRA)
               for cpath, _ in classes.classes.get(cname, []))


def check_span_coverage(pkg_dir: str, *,
                        project: Optional[Dict[str, SourceModule]] = None,
                        mapping: Optional[Dict[str, Optional[str]]] = None
                        ) -> List[Finding]:
    """GP01 span-unmapped (``--span-coverage``): every span name recorded
    through a tracer entry point (``.span``/``.begin``/``.instant``/
    ``.record_span``) in the package must map to a goodput bucket in
    ``obs/goodput.SPAN_BUCKETS`` (``None`` — a structural container — is
    an explicit decision and passes). Unmapped instrumentation would
    silently become ``unattributed`` wall time in every ledger window,
    defeating the 100%-attribution contract. F-string names become globs
    and match glob-tolerantly against the mapping keys (either side may
    hold the wildcard); a dynamic name the AST cannot resolve is itself
    a finding. Only dotted ``family.name`` strings are treated as span
    names, and a call whose receiver resolves to a project class defined
    outside ``obs/tracer.py`` is skipped — other APIs' ``.begin(...)``
    calls don't trip the lint.
    Inline ``# dcnn: disable=GP01`` applies."""
    if project is None:
        project = load_project([pkg_dir])
    out: List[Finding] = []
    if mapping is None:
        mapping = collect_span_buckets(project)
        if mapping is None:
            out.append(Finding(
                "GP01", GOODPUT_MODULE, 0, "<module>", "SPAN_BUCKETS",
                "obs/goodput.py SPAN_BUCKETS dict literal not found — "
                "the span→bucket contract has no source of truth"))
            return out
    keys = list(mapping)
    classes = ClassIndex(project)
    for path, mod in project.items():
        if path.endswith(SPAN_INFRA) or "/analysis/" in path:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _call_tail(node.func) in SPAN_TAILS
                    and node.args):
                continue
            fn = mod.enclosing_function(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            if _other_api(classes, path, mod, fn, node.func):
                continue
            pat = _name_pattern(node.args[0])
            if pat is None:
                out.append(Finding(
                    "GP01", path, node.lineno, qn, "<unresolvable>",
                    f".{_call_tail(node.func)}() with a dynamic span "
                    f"name the lint cannot resolve — use a literal "
                    f"family.name (or suppress with a mapping decision)"))
                continue
            if "." not in pat:
                continue  # not a span-name shape: some other .begin() API
            if any(_matches(pat, k) for k in keys):
                continue
            out.append(Finding(
                "GP01", path, node.lineno, qn, pat,
                f"span '{pat}' is recorded here but missing from "
                f"obs/goodput.SPAN_BUCKETS — map it to a bucket (or None "
                f"for structural spans) so its time can't silently become "
                f"unattributed"))
    for f in out:
        mod = project.get(f.path)
        if mod is not None and mod.is_suppressed("GP01", f.line):
            f.suppressed_by = "inline"
    return out
