"""Atomicity check (AT01).

The durability contract (the JAX package's docs/reliability.md): anything a restart might
read — checkpoints, manifests, dataset caches, bench/trace artifacts —
is published with tmp-sibling + fsync + ``os.replace``
(``resilience/atomic.py``), never with a bare ``open(path, "w")`` that a
preemption can leave half-written.

**AT01 atomic-commit** flags write-mode ``open()`` (``w``/``wb``/
``wt``/``w+``/``x``…) and ``np.save`` / ``np.savez`` /
``np.savez_compressed`` calls unless the enclosing context already
speaks the atomic protocol:

- the module IS the protocol (``resilience/atomic.py``);
- the enclosing function also calls ``os.replace`` / ``os.rename`` or
  one of the atomic helpers (``write_file_atomic`` / ``commit_dir`` /
  ``stage_dir``) — i.e. the bare write targets a staging path that is
  later published atomically;
- the write target is an in-memory buffer (first argument named
  ``buf``/``bio``/``buffer`` or an ``io.BytesIO()`` call) — no file to
  tear.

Everything else is either a real torn-write window (fix it: route
through ``resilience.atomic``) or a deliberate exception (suppress it
inline with a justification — e.g. the fault injector whose whole job
is writing corrupt bytes).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .core import Finding, SourceModule, register

ATOMIC_MODULES = ("resilience/atomic.py",)
# helpers recognized by bare (possibly imported) name
ATOMIC_HELPERS = {"write_file_atomic", "commit_dir", "stage_dir"}
# and the os-module publish calls — matched ONLY as os.replace/os.rename,
# otherwise any str.replace() in the function would silently disarm AT01
OS_PUBLISH = {"replace", "rename"}
NP_SAVERS = {"save", "savez", "savez_compressed"}
BUFFER_NAMES = {"buf", "bio", "buffer", "fileobj", "stream"}


def _call_tail(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _write_mode(node: ast.Call) -> Optional[str]:
    """The mode string of an ``open()``-style call if it writes."""
    mode = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
            and isinstance(node.args[1].value, str):
        mode = node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            mode = kw.value.value
    if mode is not None and any(c in mode for c in "wx"):
        return mode
    return None


def _is_open(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name) and f.id == "open":
        return True
    # gzip.open / _gzip.open / io.open — same torn-write semantics
    return isinstance(f, ast.Attribute) and f.attr == "open"


def _is_np_save(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr in NP_SAVERS
            and isinstance(f.value, ast.Name)
            and f.value.id in ("np", "numpy"))


def _buffer_target(node: ast.Call) -> bool:
    if not node.args:
        return False
    a = node.args[0]
    if isinstance(a, ast.Name) and a.id in BUFFER_NAMES:
        return True
    return isinstance(a, ast.Call) and _call_tail(a.func) == "BytesIO"


def _scope_uses_atomic_protocol(mod: SourceModule, node: ast.AST) -> bool:
    """Does the enclosing function (or, for lambdas, the function the
    lambda is defined in) call an atomic helper or os.replace/os.rename?"""
    fn = mod.enclosing_function(node)
    if fn is None:
        return False
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if _call_tail(f) in ATOMIC_HELPERS:
            return True
        if (isinstance(f, ast.Attribute) and f.attr in OS_PUBLISH
                and isinstance(f.value, ast.Name) and f.value.id == "os"):
            return True
    return False


@register("AT01", "atomic-commit",
          "bare write on a commit path must route through resilience.atomic")
def check_atomic_commit(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        if path.endswith(ATOMIC_MODULES):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_open(node):
                mode = _write_mode(node)
                if mode is None:
                    continue
                if _scope_uses_atomic_protocol(mod, node):
                    continue
                fn = mod.enclosing_function(node)
                qn = mod.qualname(fn if fn is not None else mod.tree)
                out.append(Finding(
                    "AT01", path, node.lineno, qn, f"open:{mode}",
                    f"bare open(..., {mode!r}) can leave a torn file on "
                    f"preemption; stage + os.replace, or use "
                    f"resilience.atomic.write_file_atomic"))
            elif _is_np_save(node):
                if _buffer_target(node):
                    continue
                if _scope_uses_atomic_protocol(mod, node):
                    continue
                fn = mod.enclosing_function(node)
                qn = mod.qualname(fn if fn is not None else mod.tree)
                out.append(Finding(
                    "AT01", path, node.lineno, qn,
                    f"np.{_call_tail(node.func)}",
                    f"np.{_call_tail(node.func)} writes in place; a "
                    f"preempted save leaves a torn artifact the next run "
                    f"loads — write to a tmp sibling and os.replace"))
    return out
