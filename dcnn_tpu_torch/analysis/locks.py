"""Deadlock checks (DL01-DL02) over a whole-package lock model.

The four framed-TCP surfaces (elastic membership, self-healing pipeline,
router/replica tier, autoscaler/broker) plus the tracer/flight layer all
hold nested locks today; their review-hardening logs are a catalog of
two wedge classes no per-file lint can see:

- **DL01 lock-order** — a cycle in the package-wide lock-acquisition
  graph. Nodes are ``<module-stem>.<Class>.<lock-attr>`` (or
  ``<module-stem>.<name>`` for module-level locks); an edge A→B is
  recorded whenever code lexically inside ``with A`` acquires B — in the
  same function, or transitively through any call the upgraded call
  graph can resolve (``self.m()``, cross-class ``self.attr.m()``,
  module-level functions). Two threads taking a cycle's locks in
  opposite orders deadlock; a cycle is a finding even if today's thread
  schedule never interleaves, because the next refactor makes it.
- **DL02 blocking-under-lock** — a blocking call while holding a lock:
  socket ``sendall``/``recv``/``accept``/``connect``, framed-channel
  ``send`` (a string-literal frame name in the first args), Future
  ``.result()``, queue ``.get()`` (queue-typed receiver or a
  ``timeout=`` kwarg), thread ``.join()``, ``sleep``, and ``flock``.
  The lock holds for the full network/IO stall, so one slow peer wedges
  every thread that touches the lock — the class PRs 8-13 each fixed by
  hand at least once. Findings are reported in the function that
  *acquired* the lock: a call whose callee transitively blocks is
  flagged at the call site under the ``with``, so a deliberate
  lock-serialized send (``Channel.send``) suppresses at its own site
  without muting its callers.

The lock model is lexical: ``with self._lock`` / ``with _MODULE_LOCK``
scopes only (bare ``.acquire()`` is invisible), and only attributes or
module names assigned a ``Lock``/``RLock``/``Condition``/``Semaphore``
construction count as locks — a ``with plan:`` context manager is not
tracked. ``Condition.wait`` is deliberately NOT a blocking op for its
own condition (it releases it), and is left out of the blocking set
entirely to keep the signal clean.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import FunctionIndex, FuncKey, call_name
from .core import Finding, SourceModule, register

LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}
QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
               "JoinableQueue"}
THREAD_CTORS = {"Thread", "Process"}

# attribute-call tails that block unconditionally
BLOCKING_ATTRS = {"sendall", "recv", "recv_into", "recvfrom", "accept",
                  "sendto", "create_connection", "result", "flock",
                  "sleep"}
# bare-name calls that block
BLOCKING_NAMES = {"sleep", "flock", "create_connection"}

_MAX_DEPTH = 6


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class LockModel:
    """Whole-project lock facts: which attrs/names are lock-typed, which
    are queue/thread-typed (for the DL02 matchers), node naming."""

    def __init__(self, project: Dict[str, SourceModule],
                 index: FunctionIndex):
        self.project = project
        self.index = index
        # (path, class name) -> {attr} for lock-/queue-/thread-typed attrs
        self.lock_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self.queue_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self.thread_attrs: Dict[Tuple[str, str], Set[str]] = {}
        # path -> {module-level lock names}
        self.module_locks: Dict[str, Set[str]] = {}
        for path, mod in project.items():
            self.module_locks[path] = set()
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign):
                    continue
                tail = (call_name(node.value.func)
                        if isinstance(node.value, ast.Call) else None)
                if tail is None:
                    continue
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        cls = mod.enclosing_class(node)
                        if cls is None:
                            continue
                        key = (path, cls.name)
                        if tail in LOCK_CTORS:
                            self.lock_attrs.setdefault(key, set()).add(attr)
                        elif tail in QUEUE_CTORS:
                            self.queue_attrs.setdefault(key, set()).add(attr)
                        elif tail in THREAD_CTORS:
                            self.thread_attrs.setdefault(key, set()).add(attr)
                    elif isinstance(t, ast.Name) and isinstance(
                            mod.parents.get(node), ast.Module) \
                            and tail in LOCK_CTORS:
                        self.module_locks[path].add(t.id)

    # -- node naming ---------------------------------------------------------
    def lock_node(self, path: str, fn: Optional[ast.AST],
                  ctx: ast.AST) -> Optional[Tuple[str, str]]:
        """(node id, lock attr/name) for a ``with`` context expression
        that is a tracked lock, else None."""
        mod = self.project[path]
        attr = _self_attr(ctx)
        if attr is not None:
            cls = mod.enclosing_class(ctx)
            if cls is not None and attr in self.lock_attrs.get(
                    (path, cls.name), set()):
                return f"{_stem(path)}.{cls.name}.{attr}", attr
            return None
        if isinstance(ctx, ast.Name) and ctx.id in self.module_locks[path]:
            return f"{_stem(path)}.{ctx.id}", ctx.id
        return None


def _with_locks(model: LockModel, path: str, fn: Optional[ast.AST],
                node: ast.With) -> List[Tuple[str, str]]:
    out = []
    for item in node.items:
        ln = model.lock_node(path, fn, item.context_expr)
        if ln is not None:
            out.append(ln)
    return out


def _is_queue_recv(model: LockModel, path: str, mod: SourceModule,
                   node: ast.Call) -> bool:
    """``<queue>.get(...)`` — queue-typed receiver, or any ``.get`` with
    a ``timeout=`` kwarg (dict.get has none)."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "get"):
        return False
    if any(kw.arg == "timeout" for kw in node.keywords):
        return True
    attr = _self_attr(f.value)
    if attr is not None:
        cls = mod.enclosing_class(node)
        if cls is not None and attr in model.queue_attrs.get(
                (path, cls.name), set()):
            return True
    return False


def _is_thread_join(model: LockModel, path: str, mod: SourceModule,
                    node: ast.Call) -> bool:
    """``<thread>.join(...)`` — thread-typed receiver or a ``timeout=``
    kwarg (str.join takes none)."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "join"):
        return False
    if any(kw.arg == "timeout" for kw in node.keywords):
        return True
    attr = _self_attr(f.value)
    if attr is not None:
        cls = mod.enclosing_class(node)
        if cls is not None and attr in model.thread_attrs.get(
                (path, cls.name), set()):
            return True
    return False


def _is_frame_send(node: ast.Call) -> bool:
    """``<chan>.send("CMD", ...)`` — the framed-channel idiom: an
    attribute-call tail containing ``send``/``broadcast`` with a string
    literal in the first two positional args, or (the variable-cmd
    forwarding idiom: ``ch.send(cmd, meta)``) two or more positional
    args — generator ``.send`` takes exactly one, and a 2-arg
    ``socket.send(data, flags)`` blocks anyway."""
    tail = call_name(node.func)
    if tail is None or not isinstance(node.func, ast.Attribute):
        return False
    if "send" not in tail and tail != "broadcast":
        return False
    if len(node.args) >= 2:
        return True
    for a in node.args[:2]:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return True
    return False


def _blocking_op(model: LockModel, path: str, mod: SourceModule,
                 node: ast.Call) -> Optional[str]:
    """The blocking-op token for a call, or None."""
    f = node.func
    tail = call_name(f)
    if isinstance(f, ast.Attribute) and tail in BLOCKING_ATTRS:
        return tail
    if isinstance(f, ast.Name) and tail in BLOCKING_NAMES:
        return tail
    if _is_frame_send(node):
        return f"{tail}(frame)"
    if _is_queue_recv(model, path, mod, node):
        return "queue.get"
    if _is_thread_join(model, path, mod, node):
        return "join"
    return None


class LockAnalysis:
    """One pass over every function: builds the acquisition-edge graph
    (DL01) and the blocking-under-lock findings (DL02)."""

    def __init__(self, project: Dict[str, SourceModule]):
        self.project = project
        self.index = FunctionIndex(project)
        self.model = LockModel(project, self.index)
        # edges: (src node, dst node) -> (path, line, symbol) of the
        # acquisition that recorded it first
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.dl02: List[Finding] = []
        self._acquires_memo: Dict[FuncKey, Set[str]] = {}
        self._blocks_memo: Dict[FuncKey, Optional[str]] = {}
        for key, fn in sorted(self.index.functions.items()):
            self._walk_fn(key, fn)

    # -- transitive facts ----------------------------------------------------
    def _acquires(self, key: FuncKey, depth: int = 0,
                  seen: Optional[Set[FuncKey]] = None) -> Set[str]:
        """Lock nodes ``key`` (transitively) acquires. Only root calls
        memoize: a result computed under an active cycle cut (``seen``
        pruned a mutually-recursive leg) is incomplete, and caching it
        would hide edges from every later caller."""
        if key in self._acquires_memo:
            return self._acquires_memo[key]
        root = seen is None
        if root:
            seen = set()
        if key in seen or depth > _MAX_DEPTH:
            return set()
        seen.add(key)
        path, _qn = key
        fn = self.index.functions[key]
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                out.update(n for n, _a in _with_locks(
                    self.model, path, fn, node))
            elif isinstance(node, ast.Call):
                for ck in self.index.resolve_call(path, fn, node.func):
                    out.update(self._acquires(ck, depth + 1, seen))
        if root:
            self._acquires_memo[key] = out
        return out

    def _blocks(self, key: FuncKey, depth: int = 0,
                seen: Optional[Set[FuncKey]] = None) -> Optional[str]:
        """First blocking-op token ``key`` (transitively) reaches, or
        None. Lock state inside the callee is irrelevant — a callee that
        blocks under its own lock still stalls the caller."""
        if key in self._blocks_memo:
            return self._blocks_memo[key]
        root = seen is None
        if root:
            seen = set()
        if key in seen or depth > _MAX_DEPTH:
            return None
        seen.add(key)
        path, _qn = key
        fn = self.index.functions[key]
        mod = self.project[path]
        found: Optional[str] = None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            op = _blocking_op(self.model, path, mod, node)
            if op is not None:
                found = op
                break
            for ck in self.index.resolve_call(path, fn, node.func):
                sub = self._blocks(ck, depth + 1, seen)
                if sub is not None:
                    found = f"{call_name(node.func)}->{sub}"
                    break
            if found:
                break
        if root:
            self._blocks_memo[key] = found
        return found

    # -- per-function lexical walk ------------------------------------------
    def _walk_fn(self, key: FuncKey, fn: ast.AST) -> None:
        path, qn = key
        self._walk_body(key, fn, list(ast.iter_child_nodes(fn)), ())

    def _walk_body(self, key: FuncKey, fn: ast.AST,
                   nodes: List[ast.AST], held: Tuple[str, ...]) -> None:
        path, qn = key
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue  # separate entries; a nested def does not run here
            if isinstance(node, ast.With):
                acquired = _with_locks(self.model, path, fn, node)
                # edges from every already-held lock to each new one, AND
                # between the statement's own items in order — a
                # multi-item ``with A, B:`` acquires A then B, an
                # ordering fact the graph must learn
                for i, (n, _attr) in enumerate(acquired):
                    for h in list(held) + [m for m, _a in acquired[:i]]:
                        if h != n and (h, n) not in self.edges:
                            self.edges[(h, n)] = (path, node.lineno, qn)
                new_held = held + tuple(n for n, _a in acquired
                                        if n not in held)
                # context expressions evaluate under the OLD held set
                for item in node.items:
                    self._walk_body(key, fn, [item.context_expr], held)
                self._walk_body(key, fn, list(node.body), new_held)
                continue
            if isinstance(node, ast.Call):
                self._handle_call(key, fn, node, held)
            self._walk_body(key, fn, list(ast.iter_child_nodes(node)), held)

    def _handle_call(self, key: FuncKey, fn: ast.AST, node: ast.Call,
                     held: Tuple[str, ...]) -> None:
        path, qn = key
        mod = self.project[path]
        callees = self.index.resolve_call(path, fn, node.func)
        if held:
            op = _blocking_op(self.model, path, mod, node)
            if op is not None:
                self.dl02.append(Finding(
                    "DL02", path, node.lineno, qn,
                    f"{held[-1]}:{op}",
                    f"blocking call '{op}' while holding "
                    f"{' -> '.join(held)} — the lock holds for the full "
                    f"IO stall; move the blocking call outside the "
                    f"'with', or snapshot state under the lock and send "
                    f"after"))
            else:
                for ck in callees:
                    sub = self._blocks(ck)
                    if sub is not None:
                        self.dl02.append(Finding(
                            "DL02", path, node.lineno, qn,
                            f"{held[-1]}:{call_name(node.func)}",
                            f"call '{call_name(node.func)}' blocks "
                            f"(via {sub}) while holding "
                            f"{' -> '.join(held)} — hoist the call out "
                            f"of the 'with' block"))
                        break
        if held and callees:
            for ck in callees:
                for n in self._acquires(ck):
                    for h in held:
                        if h != n and (h, n) not in self.edges:
                            self.edges[(h, n)] = (path, node.lineno, qn)


_CACHE: dict = {}


def _analysis(project: Dict[str, SourceModule]) -> LockAnalysis:
    cached = _CACHE.get(id(project))
    if cached is not None and cached[0] is project:
        return cached[1]
    a = LockAnalysis(project)
    _CACHE.clear()
    _CACHE[id(project)] = (project, a)
    return a


def _cycles(edges: Dict[Tuple[str, str], Tuple[str, int, str]]
            ) -> List[List[str]]:
    """Elementary cycles via DFS from each node (graphs here are tiny).
    Each cycle is canonicalized to start at its smallest node so the
    finding key is stable."""
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    out: List[List[str]] = []
    seen_keys: Set[Tuple[str, ...]] = set()

    def dfs(start: str, cur: str, path: List[str],
            on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(cur, ())):
            if nxt == start and len(path) > 1:
                i = path.index(min(path))
                canon = tuple(path[i:] + path[:i])
                if canon not in seen_keys:
                    seen_keys.add(canon)
                    out.append(list(canon))
            elif nxt not in on_path and nxt > start:
                # only explore nodes > start: every cycle is found from
                # its smallest node exactly once
                on_path.add(nxt)
                dfs(start, nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    for n in sorted(graph):
        dfs(n, n, [n], {n})
    return out


@register("DL01", "lock-order",
          "cycle in the package-wide lock-acquisition graph")
def check_lock_order(project: Dict[str, SourceModule]) -> List[Finding]:
    a = _analysis(project)
    out: List[Finding] = []
    for cycle in _cycles(a.edges):
        # anchor the finding at the acquisition site of the cycle's
        # first edge (smallest node -> its successor)
        nxt = cycle[(cycle.index(min(cycle)) + 1) % len(cycle)]
        path, line, sym = a.edges.get(
            (min(cycle), nxt), next(iter(a.edges.values())))
        chain = " -> ".join(cycle + [cycle[0]])
        out.append(Finding(
            "DL01", path, line, sym, "|".join(sorted(cycle)),
            f"lock-order cycle {chain}: two threads taking these locks "
            f"in different orders deadlock; establish one global order "
            f"(or drop the nested acquisition)"))
    return out


@register("DL02", "blocking-under-lock",
          "socket/queue/future/join/sleep call while holding a lock")
def check_blocking_under_lock(project: Dict[str, SourceModule]
                              ) -> List[Finding]:
    return list(_analysis(project).dl02)
