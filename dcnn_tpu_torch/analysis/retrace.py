"""Recapture detection (TS06): the JAX suite's retrace check, re-aimed at
CUDA graph sessions.

A :class:`~dcnn_tpu_torch.core.graphs.Session` captures a graph when it is
built and keeps the memory of its pool for as long as it lives; a
*silent recapture* re-pays the eager warm-up and the capture at runtime and
grows the pool, with no error and no counter. The recaptures this check can
see statically:

- **session-per-call** — ``Session(...)(x)``: the graph is captured for one
  call and thrown away; store the session and call the stored one.
- **session-in-loop** — a ``Session(...)`` built lexically inside a
  ``for``/``while`` body and not stored under a key (``sessions[key] =
  Session(...)``): one capture per iteration.
- **per-call key** — a ``SessionCache.lookup`` key (its first argument, or
  the tuple a local name bound it to) holding a computed per-call value: a
  call, arithmetic or an f-string. Every new value captures a new graph and
  keeps its pool. Constants, plain names, attributes (``x.dtype``) and
  shape tuples (``tuple(x.shape)``, or a ``tuple(...)`` over shapes) are
  what a key is made of.

Bindings are resolved within one function, as in the JAX suite; a key built
in another function, or a session built through a dynamically selected
factory, is out of sight.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .callgraph import SESSION_TAILS, call_name
from .core import Finding, SourceModule, register


def _is_session(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_name(node.func) in SESSION_TAILS


def _shape_tuple(expr: ast.AST) -> bool:
    """``tuple(...)`` over something that reads a ``.shape``."""
    return (isinstance(expr, ast.Call) and call_name(expr.func) == "tuple"
            and any(isinstance(n, ast.Attribute) and n.attr == "shape"
                    for a in expr.args for n in ast.walk(a)))


def _per_call(expr: ast.AST) -> Optional[ast.AST]:
    """The first element of a key expression whose value plausibly varies
    per call (a call that is not a shape tuple, arithmetic, an f-string),
    or None."""
    if isinstance(expr, ast.Tuple):
        for e in expr.elts:
            got = _per_call(e)
            if got is not None:
                return got
        return None
    if isinstance(expr, ast.Starred):
        return _per_call(expr.value)
    if _shape_tuple(expr):
        return None
    if isinstance(expr, (ast.Call, ast.BinOp, ast.JoinedStr)):
        return expr
    return None


def _in_loop(mod: SourceModule, node: ast.AST) -> bool:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.For, ast.While)):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False
    return False


def _stored_under_key(mod: SourceModule, node: ast.AST) -> bool:
    """``... = sessions[key] = Session(...)``: some target is a
    subscript."""
    parent = mod.parents.get(node)
    return isinstance(parent, ast.Assign) and any(
        isinstance(t, ast.Subscript) for t in parent.targets)


def _key_expr(mod: SourceModule, call: ast.Call) -> Optional[ast.AST]:
    """The key of a ``lookup`` call, through one local binding."""
    key = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "key"), None)
    if not isinstance(key, ast.Name):
        return key
    fn = mod.enclosing_function(call)
    if fn is None:
        return None
    bound = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and node.lineno < call.lineno \
                and any(isinstance(t, ast.Name) and t.id == key.id
                        for t in node.targets):
            bound = node.value  # the last binding before the call
    return bound


def _session_cache_lookup(mod: SourceModule, call: ast.Call) -> bool:
    """A ``<x>.lookup(...)`` call whose receiver is (or may be) a
    ``SessionCache``: one assigned ``SessionCache()`` in this module, or a
    call passing a capture factory (a lambda) third or as ``capture=``."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "lookup"):
        return False
    factory = call.args[2] if len(call.args) >= 3 else next(
        (kw.value for kw in call.keywords if kw.arg == "capture"), None)
    if isinstance(factory, ast.Lambda):
        return True
    recv = ast.unparse(call.func.value)
    return any(isinstance(n, ast.Assign) and _is_cache_ctor(n.value)
               and any(ast.unparse(t) == recv for t in n.targets)
               for n in ast.walk(mod.tree))


def _is_cache_ctor(value: ast.AST) -> bool:
    return isinstance(value, ast.Call) and call_name(value.func) \
        == "SessionCache"


@register("TS06", "recapture",
          "session usage that captures per call: sessions built and "
          "dropped, built in loops, or cached under per-call keys")
def check_retrace(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = mod.enclosing_function(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            if _is_session(node):
                parent = mod.parents.get(node)
                if isinstance(parent, ast.Call) and parent.func is node:
                    out.append(Finding(
                        "TS06", path, node.lineno, qn, "session-per-call",
                        "Session(...)(...) captures a graph for one call and "
                        "drops it; store the session and call the stored "
                        "one"))
                elif _in_loop(mod, node) and not _stored_under_key(mod,
                                                                   node):
                    out.append(Finding(
                        "TS06", path, node.lineno, qn, "session-in-loop",
                        "Session built inside a loop body and not stored "
                        "under a key — one capture (and one pool's "
                        "memory) per iteration; key it or hoist it"))
            elif _session_cache_lookup(mod, node):
                key = _key_expr(mod, node)
                bad = _per_call(key) if key is not None else None
                if bad is not None:
                    what = ast.unparse(bad)
                    out.append(Finding(
                        "TS06", path, node.lineno, qn, f"lookup-key:{what}",
                        f"SessionCache.lookup key holds '{what}', a value "
                        f"computed per call — every new value captures a "
                        f"new graph and keeps its pool; key on shapes, "
                        f"dtypes and flags"))
    return out
