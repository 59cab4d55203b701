"""Concurrency checks (CC01-CC03).

25 lock/thread sites across the batcher, feed workers, transfer pool,
async saver, and telemetry server share mutable state with only
convention guarding them; these checks turn the convention into a lint.

- **CC01 guarded-by** — the lock-discipline rule. For each class that
  spawns a thread (``threading.Thread(target=self._m)`` /
  ``target=<nested fn>`` / ``pool.submit(self._m)``): any attribute
  *written* (assigned, augmented, or mutated via ``append``-class
  methods) by a thread-reachable method and *accessed* by a
  non-thread-reachable method must (a) carry a
  ``# dcnn: guarded_by=<lock>`` annotation on an assignment in
  ``__init__``, and (b) have every access outside ``__init__`` sit
  inside ``with self.<lock>``. Attributes holding synchronized objects
  (``Lock`` / ``RLock`` / ``Condition`` / ``Event`` / ``Semaphore`` /
  ``queue.Queue`` family) are exempt — they synchronize themselves.
- **CC02 thread-lifecycle** — every ``threading.Thread`` must be
  joined (``.join`` on the storing attribute/name somewhere in the
  class/function), or be ``daemon=True`` AND owned by a class with a
  finalizer (``close`` / ``stop`` / ``shutdown`` / ``drain`` /
  ``__del__`` / ``__exit__``). A daemon thread nobody can stop is a
  leaked poll loop past the first refactor.
- **CC03 resource-lifecycle** — ``shared_memory.SharedMemory``,
  HTTP servers, and executor/pool objects must be reachable from a
  context manager or ``__del__``: created inside a ``with``, explicitly
  closed in the creating function, handed off (returned / passed on —
  the receiver is then the owner under this same rule), or stored on a
  class that defines ``__del__`` / ``__exit__``.

Known blind spots (docs/static_analysis.md describes them for both\nsuites): lock
acquisition in a caller does not cover a callee's access, reachability
is per-class (threads handed module-level functions are not traced into
them), and ownership hand-offs are trusted, not verified.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, SourceModule, register

LOCK_TYPES = {"Lock", "RLock", "Condition", "Event", "Semaphore",
              "BoundedSemaphore", "Barrier"}
QUEUE_TYPES = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
               "JoinableQueue"}
MUTATORS = {"append", "extend", "add", "update", "remove", "discard",
            "pop", "popleft", "appendleft", "clear", "insert",
            "setdefault", "sort", "reverse"}
FINALIZERS = {"close", "stop", "shutdown", "drain", "join",
              "__del__", "__exit__"}
RESOURCE_TYPES = {"SharedMemory", "ThreadingHTTPServer", "HTTPServer",
                  "ThreadPoolExecutor", "ProcessPoolExecutor", "Pool"}
CLEANUP_CALLS = {"close", "shutdown", "unlink", "terminate", "stop",
                 "server_close", "join"}


def _call_tail(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_thread_ctor(node: ast.Call) -> bool:
    return _call_tail(node.func) == "Thread"


def _kw(node: ast.Call, name: str):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` -> ``x``."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _under_self_lock(mod: SourceModule, node: ast.AST,
                     lock: str) -> bool:
    """Is ``node`` lexically inside ``with self.<lock>`` (any item)?"""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                if _self_attr(item.context_expr) == lock:
                    return True
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
    return False


class _ClassModel:
    """Per-class facts CC01 needs: thread-entry methods, writes/accesses
    per attribute, lock-typed attrs, guarded_by annotations."""

    def __init__(self, mod: SourceModule, cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.methods = _methods(cls)
        self.synced_attrs: Set[str] = set()     # Lock/Queue-typed
        self.assigned_attrs: Set[str] = set()   # every self.<attr> = ...
        self.annotations: Dict[str, str] = {}   # attr -> lock name
        self.thread_entries: Set[str] = set()
        self._scan_init()
        self._find_thread_entries()
        self.thread_reachable = self._propagate(self.thread_entries)

    def _scan_init(self) -> None:
        for m in self.methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    self.assigned_attrs.add(attr)
                    tail = (_call_tail(value.func)
                            if isinstance(value, ast.Call) else None)
                    if tail in LOCK_TYPES | QUEUE_TYPES:
                        self.synced_attrs.add(attr)
                    lock = self.mod.guarded_by.get(node.lineno)
                    if lock:
                        self.annotations[attr] = lock

    def _find_thread_entries(self) -> None:
        """Methods that run on a spawned thread: Thread(target=self.m),
        Thread(target=<nested fn calling self.m>), pool.submit(self.m)."""
        for m in self.methods.values():
            nested = {n.name: n for n in ast.walk(m)
                      if isinstance(n, ast.FunctionDef) and n is not m}
            for node in ast.walk(m):
                if not isinstance(node, ast.Call):
                    continue
                target = None
                if _is_thread_ctor(node):
                    target = _kw(node, "target")
                elif _call_tail(node.func) == "submit" and node.args:
                    target = node.args[0]
                if target is None:
                    continue
                attr = _self_attr(target)
                if attr is not None and attr in self.methods:
                    self.thread_entries.add(attr)
                elif isinstance(target, ast.Name) and target.id in nested:
                    # nested thread body: its self.m() calls are the entries
                    for sub in ast.walk(nested[target.id]):
                        if isinstance(sub, ast.Call):
                            m2 = _self_attr(sub.func)
                            if m2 is not None and m2 in self.methods:
                                self.thread_entries.add(m2)

    def _propagate(self, seeds: Set[str]) -> Set[str]:
        reach = set(seeds)
        work = list(seeds)
        while work:
            name = work.pop()
            fn = self.methods.get(name)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    m2 = _self_attr(node.func)
                    if m2 is not None and m2 in self.methods \
                            and m2 not in reach:
                        reach.add(m2)
                        work.append(m2)
        return reach

    def attr_events(self) -> List[Tuple[str, str, str, ast.AST]]:
        """(attr, kind, method, node) for every ``self.attr`` touch
        outside ``__init__``: kind in {write, mutate, read}."""
        out = []
        for mname, fn in self.methods.items():
            if mname == "__init__":
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr:
                            out.append((attr, "write", mname, node))
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    attr = _self_attr(node.target)
                    if attr:
                        out.append((attr, "write", mname, node))
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in MUTATORS:
                    attr = _self_attr(node.func.value)
                    if attr:
                        out.append((attr, "mutate", mname, node))
                elif isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load):
                    attr = _self_attr(node)
                    if attr:
                        out.append((attr, "read", mname, node))
        return out


@register("CC01", "guarded-by",
          "cross-thread attribute must be annotated and lock-guarded")
def check_guarded_by(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            model = _ClassModel(mod, node)
            if not model.thread_entries:
                continue
            events = model.attr_events()
            written_by_thread = {
                a for (a, kind, m, _n) in events
                if kind in ("write", "mutate")
                and m in model.thread_reachable}
            accessed_elsewhere = {
                a for (a, _k, m, _n) in events
                if m not in model.thread_reachable}
            candidates = ((written_by_thread & accessed_elsewhere)
                          - model.synced_attrs)
            for attr in sorted(candidates):
                qn = f"{node.name}"
                lock = model.annotations.get(attr)
                first = next(n for (a, k, _m, n) in events if a == attr
                             and k in ("write", "mutate"))
                if lock is None:
                    out.append(Finding(
                        "CC01", path, first.lineno, qn, attr,
                        f"'{attr}' is written on a spawned thread and "
                        f"accessed from other methods but carries no "
                        f"'# dcnn: guarded_by=<lock>' annotation in "
                        f"__init__"))
                    continue
                # the named lock must at least be an attribute this class
                # assigns — Lock()-typed locally, or injected through the
                # constructor (the codebase's injectable-dependency idiom);
                # a typo'd name that is never assigned is still an error
                if lock not in model.synced_attrs \
                        and lock not in model.assigned_attrs:
                    out.append(Finding(
                        "CC01", path, first.lineno, qn, attr,
                        f"'{attr}' is guarded_by='{lock}' but no "
                        f"attribute '{lock}' is ever assigned on "
                        f"{node.name}"))
                    continue
                for (a, kind, m, n) in events:
                    if a != attr:
                        continue
                    if not _under_self_lock(mod, n, lock):
                        out.append(Finding(
                            "CC01", path, n.lineno, f"{qn}.{m}", attr,
                            f"{kind} of '{attr}' (guarded_by={lock}) "
                            f"outside 'with self.{lock}'"))
    return out


@register("CC02", "thread-lifecycle",
          "thread must be joined or daemonized with an owner finalizer")
def check_thread_lifecycle(project: Dict[str, SourceModule]
                           ) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                continue
            fn = mod.enclosing_function(node)
            cls = mod.enclosing_class(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            daemon = _kw(node, "daemon")
            is_daemon = isinstance(daemon, ast.Constant) \
                and daemon.value is True
            # where does the Thread object land?
            parent = mod.parents.get(node)
            stored_attr = stored_name = None
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    if _self_attr(t):
                        stored_attr = _self_attr(t)
                    elif isinstance(t, ast.Name):
                        stored_name = t.id
            joined = False
            if stored_attr and cls is not None:
                for sub in ast.walk(cls):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "join"
                            and _self_attr(sub.func.value) == stored_attr):
                        joined = True
            elif stored_name and fn is not None:
                for sub in ast.walk(fn):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "join"
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == stored_name):
                        joined = True
            if joined:
                continue
            if is_daemon and cls is not None \
                    and FINALIZERS & set(_methods(cls)):
                continue
            detail = stored_attr or stored_name or "<unnamed>"
            if is_daemon:
                out.append(Finding(
                    "CC02", path, node.lineno, qn, detail,
                    f"daemon thread '{detail}' has no reachable finalizer "
                    f"(owner defines none of {sorted(FINALIZERS)}) and is "
                    f"never joined"))
            else:
                out.append(Finding(
                    "CC02", path, node.lineno, qn, detail,
                    f"non-daemon thread '{detail}' is never joined — it "
                    f"will block interpreter exit; join it, or daemonize "
                    f"with an owner close()/stop()"))
    return out


def _escapes(mod: SourceModule, creation: ast.Call,
             fn: Optional[ast.FunctionDef]) -> bool:
    """Creation expression is returned or passed into another call —
    ownership moves to the receiver (checked there if it stores it)."""
    parent = mod.parents.get(creation)
    while isinstance(parent, (ast.Call, ast.ListComp, ast.List, ast.Tuple,
                              ast.Return, ast.comprehension)):
        if isinstance(parent, ast.Return):
            return True
        if isinstance(parent, ast.Call) and parent is not creation:
            return True
        parent = mod.parents.get(parent)
    return False


@register("CC03", "resource-lifecycle",
          "shm/HTTP-server/pool must be reachable from a context manager "
          "or __del__")
def check_resource_lifecycle(project: Dict[str, SourceModule]
                             ) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _call_tail(node.func) in RESOURCE_TYPES):
                continue
            fn = mod.enclosing_function(node)
            cls = mod.enclosing_class(node)
            qn = mod.qualname(fn if fn is not None else mod.tree)
            rtype = _call_tail(node.func)
            # inside a with statement?
            in_with = False
            for anc in mod.ancestors(node):
                if isinstance(anc, ast.With):
                    in_with = True
                    break
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break
            if in_with:
                continue
            # find the binding: self.attr / local name (possibly via a
            # comprehension or list literal)
            stored_attr = stored_name = None
            anc: ast.AST = node
            while True:
                parent = mod.parents.get(anc)
                if isinstance(parent, ast.Assign):
                    for t in parent.targets:
                        if _self_attr(t):
                            stored_attr = _self_attr(t)
                        elif isinstance(t, ast.Name):
                            stored_name = t.id
                    break
                if not isinstance(parent, (ast.ListComp, ast.List,
                                           ast.Tuple, ast.GeneratorExp)):
                    break
                anc = parent
            if stored_attr is None and stored_name is None:
                if _escapes(mod, node, fn):
                    continue  # handed off; receiver owns it
                out.append(Finding(
                    "CC03", path, node.lineno, qn, rtype or "resource",
                    f"{rtype} created without a binding, a 'with' block, "
                    f"or a hand-off — nothing can ever release it"))
                continue
            if stored_name is not None and fn is not None:
                cleaned = handed_off = False
                for sub in ast.walk(fn):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in CLEANUP_CALLS
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == stored_name):
                        cleaned = True
                    # self.x = name / return name / f(name): ownership moves
                    if isinstance(sub, ast.Assign) \
                            and isinstance(sub.value, ast.Name) \
                            and sub.value.id == stored_name:
                        for t in sub.targets:
                            if _self_attr(t):
                                stored_attr = _self_attr(t)
                                handed_off = True
                    if isinstance(sub, ast.Return) \
                            and isinstance(sub.value, ast.Name) \
                            and sub.value.id == stored_name:
                        handed_off = True
                    if isinstance(sub, ast.Call):
                        for a in list(sub.args) + [k.value
                                                   for k in sub.keywords]:
                            if isinstance(a, ast.Name) \
                                    and a.id == stored_name:
                                handed_off = True
                if cleaned or (handed_off and stored_attr is None):
                    continue
            if stored_attr is not None:
                if cls is not None and {"__del__", "__exit__"} \
                        & set(_methods(cls)):
                    continue
                out.append(Finding(
                    "CC03", path, node.lineno, qn, stored_attr,
                    f"{rtype} stored on self.{stored_attr} but "
                    f"{cls.name if cls else 'the owner'} defines neither "
                    f"__del__ nor __exit__ — an abandoned instance leaks "
                    f"the resource"))
            else:
                out.append(Finding(
                    "CC03", path, node.lineno, qn,
                    stored_name or rtype or "resource",
                    f"{rtype} bound to '{stored_name}' is neither closed "
                    f"in this function, used via 'with', nor handed off"))
    return out
