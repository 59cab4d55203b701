"""Shared infrastructure for the static-analysis suite.

The port's correctness rests on three conventions that no compiler
checks: code captured into a CUDA graph is host-sync- and side-effect-free,
the determinism-contract modules never touch global RNG state, and every
cross-thread attribute is lock-disciplined. This module holds what every
check family shares (the JAX package's suite has the same infrastructure,
and one annotation serves both tools):

- :class:`SourceModule` — one parsed file: AST + parent links +
  the inline-suppression map (``# dcnn: disable=<check-id>[,<id>...]``)
  and ``# dcnn: guarded_by=<lock>`` annotations.
- :class:`Finding` — one diagnostic, with a line-number-free stable
  ``key`` (check id + path + enclosing symbol + detail token) so
  baseline entries survive unrelated edits.
- :class:`Baseline` — the committed accepted-findings file
  (``dcnn_tpu_torch/analysis/baseline.json``): findings whose keys appear
  there are reported as suppressed, not failures. Every entry carries a
  justification — a baseline without reasons is just a mute button.
- :func:`analyze_paths` — parse, run the registered checks, resolve
  suppressions; the one entry point the CLI and tests share.

Suppression resolution order: inline comment first (same line as the
finding), then baseline key. Unparseable files produce a ``PARSE``
finding instead of crashing the run — a syntax error is a finding, not
an analyzer failure.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

_DISABLE_RE = re.compile(r"#\s*dcnn:\s*disable=([A-Za-z0-9_,\s-]+)")
_GUARDED_RE = re.compile(r"#\s*dcnn:\s*guarded_by=([A-Za-z_][A-Za-z0-9_]*)")
# protocol map annotations (PR01/PR02): declared like guarded_by —
#   # dcnn: protocol=<name> role=sender
#   # dcnn: protocol=<name> role=handler [frames=EXTRA,FRAMES|*]
# attached to the innermost enclosing function; a bare
# ``# dcnn: protocol=<name>`` on a send-call line rebinds that one send.
_PROTOCOL_RE = re.compile(
    r"#\s*dcnn:\s*protocol=([A-Za-z_][A-Za-z0-9_.-]*)"
    r"(?:\s+role=(sender|handler))?"
    r"(?:\s+frames=([A-Za-z0-9_,*]+))?")
# metric-name declaration for dynamically-named instruments (the
# metric-drift lint): ``reg.counter(name, ...)  # dcnn: metric=aot_*_total``
_METRIC_RE = re.compile(r"#\s*dcnn:\s*metric=([A-Za-z0-9_,*]+)")

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


@dataclass
class Finding:
    """One diagnostic. ``detail`` is a stable token (attribute name, call
    name) — together with the enclosing ``symbol`` it forms a baseline
    key that survives line-number drift."""

    check_id: str
    path: str
    line: int
    symbol: str
    detail: str
    message: str
    suppressed_by: Optional[str] = None  # None | "inline" | "baseline"

    @property
    def key(self) -> str:
        return f"{self.check_id}::{self.path}::{self.symbol}::{self.detail}"

    @property
    def suppressed(self) -> bool:
        return self.suppressed_by is not None

    def render(self) -> str:
        tag = f" [suppressed:{self.suppressed_by}]" if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.check_id} "
                f"({self.symbol}) {self.message}{tag}")

    def to_dict(self) -> dict:
        return {"check_id": self.check_id, "path": self.path,
                "line": self.line, "symbol": self.symbol,
                "detail": self.detail, "message": self.message,
                "key": self.key, "suppressed_by": self.suppressed_by}


class SourceModule:
    """One parsed source file plus the derived maps every check needs."""

    def __init__(self, display_path: str, source: str):
        self.path = display_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=display_path)
        # parent links: ast has none, and every check needs "am I inside a
        # with/def/class" questions answered
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # inline suppressions: line -> set of disabled check ids ("all"
        # disables everything on that line)
        self.suppressions: Dict[int, Set[str]] = {}
        # guarded_by annotations: line -> lock attribute name
        self.guarded_by: Dict[int, str] = {}
        # protocol annotations: line -> {"name", "role", "frames"}
        # (role None = a line-scoped send rebinding; frames None = derive
        # from the handler's own dispatch constants)
        self.protocols: Dict[int, Dict[str, object]] = {}
        # metric-name declarations: line -> [glob, ...]
        self.metric_names: Dict[int, List[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if m:
                self.suppressions[i] = {
                    t.strip() for t in m.group(1).split(",") if t.strip()}
            g = _GUARDED_RE.search(text)
            if g:
                self.guarded_by[i] = g.group(1)
            p = _PROTOCOL_RE.search(text)
            if p:
                frames = None
                if p.group(3):
                    frames = {f.strip() for f in p.group(3).split(",")
                              if f.strip()}
                self.protocols[i] = {"name": p.group(1),
                                     "role": p.group(2), "frames": frames}
            mm = _METRIC_RE.search(text)
            if mm:
                self.metric_names[i] = [t.strip()
                                        for t in mm.group(1).split(",")
                                        if t.strip()]

    # -- tree helpers --------------------------------------------------------
    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted enclosing-scope name for diagnostics/baseline keys:
        ``Class.method``, ``outer.<locals>.inner``, or ``<module>``."""
        parts: List[str] = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            parts.append(node.name)
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                parts.append(a.name)
        return ".".join(reversed(parts)) if parts else "<module>"

    def is_suppressed(self, check_id: str, line: int) -> bool:
        ids = self.suppressions.get(line)
        return bool(ids) and (check_id in ids or "all" in ids)


class Baseline:
    """The committed accepted-findings file. Schema::

        {"findings": [{"key": "...", "justification": "..."}]}
    """

    def __init__(self, entries: Optional[Dict[str, str]] = None):
        self.entries: Dict[str, str] = dict(entries or {})

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if not path or not os.path.isfile(path):
            return cls()
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        entries: Dict[str, str] = {}
        for item in data.get("findings", []):
            entries[item["key"]] = item.get("justification", "")
        return cls(entries)

    def covers(self, finding: Finding) -> bool:
        return finding.key in self.entries

    @staticmethod
    def render(findings: Sequence[Finding]) -> str:
        """Skeleton baseline JSON for ``--write-baseline``: every live
        unsuppressed finding, justification left for the author to fill —
        an empty justification is a review comment waiting to happen."""
        items = [{"key": f.key, "justification": ""}
                 for f in findings if not f.suppressed]
        return json.dumps({"findings": items}, indent=2, sort_keys=True) + "\n"


# -- check registry ---------------------------------------------------------

# each check family registers ``fn(project) -> List[Finding]`` where
# ``project`` is the full Dict[path, SourceModule] — capture safety needs the
# cross-module call graph, so the unit of analysis is the project, not the
# file
CheckFn = Callable[[Dict[str, SourceModule]], List[Finding]]


@dataclass
class Check:
    check_id: str
    name: str
    description: str
    fn: CheckFn = field(repr=False)


_REGISTRY: Dict[str, Check] = {}


def register(check_id: str, name: str, description: str):
    def deco(fn: CheckFn) -> CheckFn:
        _REGISTRY[check_id] = Check(check_id, name, description, fn)
        return fn
    return deco


def all_checks() -> Dict[str, Check]:
    # import for side effect: the families register themselves
    from . import (atomicity, concurrency, locks,  # noqa: F401
                   protocol, retrace, trace_safety)
    return dict(_REGISTRY)


# -- file collection / entry point ------------------------------------------

def _collect_files(paths: Sequence[str]) -> List[tuple]:
    """(display_path, absolute_path) for every .py under ``paths``.
    Display paths are relative to each argument's parent directory, so
    baseline keys look like ``dcnn_tpu_torch/obs/tracer.py`` regardless of the
    CWD the CLI ran from."""
    out: List[tuple] = []
    cwd = os.getcwd()
    for p in paths:
        absroot = os.path.abspath(p)
        if os.path.isfile(absroot):
            # single-file runs must produce the SAME display path (and
            # therefore the same baseline keys and path-suffix rule scope —
            # TS04's determinism modules, AT01's atomic-module exemption)
            # as the directory run that covers the file: CWD-relative when
            # under the CWD (the repo-root invocation), basename otherwise
            if absroot.startswith(cwd + os.sep):
                display = os.path.relpath(absroot, cwd).replace(os.sep, "/")
            else:
                display = os.path.basename(absroot)
            out.append((display, absroot))
            continue
        base = os.path.dirname(absroot)
        for dirpath, dirnames, filenames in os.walk(absroot):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    ap = os.path.join(dirpath, fn)
                    out.append((os.path.relpath(ap, base).replace(os.sep, "/"),
                                ap))
    return out


def load_project(paths: Sequence[str]) -> Dict[str, SourceModule]:
    project: Dict[str, SourceModule] = {}
    for display, ap in _collect_files(paths):
        with open(ap, "r", encoding="utf-8") as f:
            src = f.read()
        project[display] = SourceModule(display, src)
    return project


def analyze_paths(paths: Sequence[str], *,
                  checks: Optional[Sequence[str]] = None,
                  baseline: Optional[Baseline] = None) -> List[Finding]:
    """Run the suite over ``paths`` and return every finding, suppressed
    ones included (``suppressed_by`` says how). ``checks`` restricts to a
    subset of check ids. Unparseable files yield a ``PARSE`` finding."""
    registry = all_checks()
    selected = list(registry) if checks is None else list(checks)
    unknown = [c for c in selected if c not in registry]
    if unknown:
        raise ValueError(f"unknown check id(s) {unknown}; "
                         f"known: {sorted(registry)}")
    project: Dict[str, SourceModule] = {}
    findings: List[Finding] = []
    for display, ap in _collect_files(paths):
        with open(ap, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            project[display] = SourceModule(display, src)
        except SyntaxError as e:
            findings.append(Finding(
                "PARSE", display, e.lineno or 0, "<module>", "syntax",
                f"cannot parse: {e.msg}"))
    for cid in selected:
        findings.extend(registry[cid].fn(project))
    findings.sort(key=lambda f: (f.path, f.line, f.check_id))
    base = baseline if baseline is not None else Baseline()
    for f in findings:
        mod = project.get(f.path)
        if mod is not None and mod.is_suppressed(f.check_id, f.line):
            f.suppressed_by = "inline"
        elif base.covers(f):
            f.suppressed_by = "baseline"
    return findings


def unsuppressed(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if not f.suppressed]
