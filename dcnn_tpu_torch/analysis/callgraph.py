"""Call-graph construction: which functions run under a CUDA graph capture?

The capture-safety family (:mod:`.trace_safety`) needs the set of
functions whose Python runs while :class:`~dcnn_tpu_torch.core.graphs.Session`
captures a graph (or while an exporter or autograd runs them with the same
rules): capture runs ``fn``'s Python once, and each replay runs none of it.
A host read there raises :class:`~dcnn_tpu_torch.core.graphs.CaptureError`;
a ``print``, a Python-side write or a draw from a generator the graph does
not hold happens at capture and never again. These are the hazards that the
JAX package's suite finds under ``jax.jit``; the roots here take the place
of its trace roots one for one.

Roots (functions whose Python runs under capture):

- the ``fn`` of every ``Session(name, fn, example, ...)`` (positional 2 or
  ``fn=``): a name, a bound method (``self._body``), or a lambda, including
  one built inside a ``SessionCache.lookup`` capture factory. Where ``fn``
  is a parameter of the function that builds the session (a forwarder such
  as ``TrainStep.capture(name, fn, ...)``), the argument that each caller
  of the forwarder passes in its place is the root;
- ``forward`` and ``backward`` of every ``torch.autograd.Function``
  subclass;
- every op body made by ``torch.library.custom_op`` (directly, or through
  a project function that returns ``custom_op(...)``), and every rule
  registered with ``register_fake``, ``register_kernel`` or
  ``register_autograd`` (its backward and ``setup_context``);
- the ``forward`` of the module given to ``torch.export.export`` (by its
  constructor or its annotated type).

Propagation from the roots, as in the JAX suite:

- calls by bare name to a function defined in the same module;
- calls by bare name to a function imported with ``from X import name``
  where some analyzed module defines ``name``;
- ``self.method()`` calls to methods of the same class, and
  ``self.<attr>.m()`` / ``<local>.m()`` where :class:`ClassIndex` types
  the receiver;
- nested defs of a captured function;
- functions passed to the combinators that run them under the caller's
  capture (``checkpoint``, ``vmap``, ``grad``).

Limitations (as the JAX suite's): resolution is name-based, with no type
inference beyond :class:`ClassIndex` (``model(x)`` does not pull a
module's ``forward`` in), and dynamically selected callees are invisible.
A lambda root is analysed as a function of its own, keyed
``<enclosing>.<lambda>`` (``<lambda#2>`` for the second in one scope).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import SourceModule

# combinators that run a function argument under the caller's capture
# (torch's counterparts of the JAX suite's)
PROPAGATING = {"checkpoint", "vmap", "grad"}
SESSION_TAILS = {"Session"}
CUSTOM_OP_TAILS = {"custom_op"}
# a custom op's rules: its fake (meta) rule, its kernels, its backward
OP_RULE_TAILS = {"register_fake", "register_kernel", "register_autograd"}
AUTOGRAD_METHODS = ("forward", "backward")


def call_name(func: ast.AST) -> Optional[str]:
    """Trailing name of a call target: ``jax.jit`` -> ``jit``,
    ``jit`` -> ``jit``, anything else -> None."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def is_self_call(func: ast.AST) -> Optional[str]:
    """``self.method(...)`` -> ``method``."""
    if (isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"):
        return func.attr
    return None


FuncKey = Tuple[str, str]  # (module path, qualname)


class ClassIndex:
    """Cross-class attribute typing: which project class does
    ``self.<attr>`` (or a module-level/local binding) hold an instance
    of? Resolution is name-based over ``self.x = ClassName(...)``
    assignments (and ``mod.ClassName(...)`` by trailing name) — the one
    inference step that turns ``self.chan.send(...)`` into an edge into
    ``Channel.send`` for the lock/protocol/blocking analyses."""

    def __init__(self, project: Dict[str, SourceModule]):
        self.project = project
        self._local_cache: Dict[int, Dict[str, str]] = {}
        # class name -> [(module path, ClassDef)]
        self.classes: Dict[str, List[Tuple[str, ast.ClassDef]]] = {}
        for path, mod in project.items():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, []).append(
                        (path, node))
        # (module path, class name) -> {attr -> attr's class name}
        self.attr_types: Dict[Tuple[str, str], Dict[str, str]] = {}
        # module path -> {module-level name -> class name}
        self.global_types: Dict[str, Dict[str, str]] = {}
        for path, mod in project.items():
            self.global_types[path] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.AnnAssign):
                    # ``self.coord: Optional[Channel] = None`` — the
                    # annotation types the attribute even when the value
                    # doesn't (the deferred-construction idiom)
                    t = node.target
                    cname = self._annotation_class(node.annotation)
                    if (cname is not None and isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        cls = mod.enclosing_class(node)
                        if cls is not None:
                            self.attr_types.setdefault(
                                (path, cls.name), {})[t.attr] = cname
                    continue
                if not isinstance(node, ast.Assign):
                    continue
                cname = self._ctor_name(node.value)
                if cname is None:
                    # ``self.x = param`` where the enclosing function
                    # annotates ``param`` with a project class
                    cname = self._param_class(mod, node)
                if cname is None:
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        cls = mod.enclosing_class(node)
                        if cls is not None:
                            self.attr_types.setdefault(
                                (path, cls.name), {})[t.attr] = cname
                    elif isinstance(t, ast.Name) and isinstance(
                            mod.parents.get(node), ast.Module):
                        self.global_types[path][t.id] = cname

    def _ctor_name(self, value: ast.AST) -> Optional[str]:
        """``Foo(...)`` / ``pkg.Foo(...)`` -> ``Foo`` iff Foo is a class
        defined somewhere in the project."""
        if not isinstance(value, ast.Call):
            return None
        name = call_name(value.func)
        if name in self.classes:
            return name
        return None

    def _annotation_class(self, ann: Optional[ast.AST]) -> Optional[str]:
        """First project-class name mentioned anywhere in an annotation
        (``Channel``, ``Optional[Channel]``, ``"Channel"``)."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str) \
                and ann.value in self.classes:
            return ann.value
        for node in ast.walk(ann):
            if isinstance(node, ast.Name) and node.id in self.classes:
                return node.id
            if isinstance(node, ast.Attribute) and node.attr in self.classes:
                return node.attr
        return None

    def _param_class(self, mod: SourceModule,
                     assign: ast.Assign) -> Optional[str]:
        if not isinstance(assign.value, ast.Name):
            return None
        fn = mod.enclosing_function(assign)
        if fn is None:
            return None
        ann = self.param_annotation(fn, assign.value.id)
        return self._annotation_class(ann)

    @staticmethod
    def param_annotation(fn, name: str) -> Optional[ast.AST]:
        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            if arg.arg == name:
                return arg.annotation
        return None

    def local_types(self, fn: ast.AST) -> Dict[str, str]:
        """Names bound to project-class constructions inside ``fn``
        (memoized — resolve_call asks per call site)."""
        cached = self._local_cache.get(id(fn))
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                cname = self._ctor_name(node.value)
                if cname is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = cname
        self._local_cache[id(fn)] = out
        return out


class FunctionIndex:
    """Every def in the project, plus the name maps the walk resolves
    against."""

    def __init__(self, project: Dict[str, SourceModule]):
        self.project = project
        self.class_index = ClassIndex(project)
        self.functions: Dict[FuncKey, ast.FunctionDef] = {}
        # module -> bare name -> qualnames defined at module top level
        self.module_defs: Dict[str, Dict[str, List[str]]] = {}
        # bare name -> [(module, qualname)] over ALL modules (for
        # from-import resolution)
        self.by_name: Dict[str, List[FuncKey]] = {}
        # module -> names brought in via ``from X import name``
        self.from_imports: Dict[str, Set[str]] = {}
        # (module, class name) -> method name -> qualname
        self.methods: Dict[Tuple[str, str], Dict[str, str]] = {}
        for path, mod in project.items():
            self.module_defs[path] = {}
            self.from_imports[path] = set()
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = mod.qualname(node)
                    self.functions[(path, qn)] = node
                    self.by_name.setdefault(node.name, []).append((path, qn))
                    parent = mod.parents.get(node)
                    if isinstance(parent, ast.Module):
                        self.module_defs[path].setdefault(
                            node.name, []).append(qn)
                    elif isinstance(parent, ast.ClassDef):
                        self.methods.setdefault(
                            (path, parent.name), {})[node.name] = qn
                elif isinstance(node, ast.ImportFrom):
                    for alias in node.names:
                        self.from_imports[path].add(alias.asname or alias.name)

    def method_of(self, cname: str, mname: str) -> List[FuncKey]:
        """Definitions of ``<cname>.<mname>`` across the project."""
        out: List[FuncKey] = []
        for cpath, _cls in self.class_index.classes.get(cname, []):
            qn = self.methods.get((cpath, cname), {}).get(mname)
            if qn is not None:
                out.append((cpath, qn))
        return out

    def resolve_call(self, path: str, caller: ast.FunctionDef,
                     func: ast.AST) -> List[FuncKey]:
        """Possible definitions a call target refers to."""
        mod = self.project[path]
        self_m = is_self_call(func)
        if self_m is not None:
            cls = mod.enclosing_class(caller)
            if cls is not None:
                qn = self.methods.get((path, cls.name), {}).get(self_m)
                if qn is not None:
                    return [(path, qn)]
            return []
        if isinstance(func, ast.Attribute):
            # cross-class attribute resolution: self.<attr>.<m>() through
            # the ClassIndex type map, <local>.<m>() through local ctor
            # bindings, <GLOBAL>.<m>() through module-level bindings
            recv = func.value
            cname: Optional[str] = None
            if (isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"):
                cls = mod.enclosing_class(caller)
                if cls is not None:
                    cname = self.class_index.attr_types.get(
                        (path, cls.name), {}).get(recv.attr)
            elif isinstance(recv, ast.Name):
                cname = self.class_index.local_types(caller).get(recv.id) \
                    or self.class_index.global_types.get(path, {}).get(
                        recv.id) \
                    or self.class_index._annotation_class(
                        ClassIndex.param_annotation(caller, recv.id))
            if cname is not None:
                return self.method_of(cname, func.attr)
        if isinstance(func, ast.Name):
            name = func.id
            # nested def in the caller's own scope wins
            for stmt in ast.walk(caller):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name == name and stmt is not caller:
                    return [(path, mod.qualname(stmt))]
            local = self.module_defs.get(path, {}).get(name)
            if local:
                return [(path, q) for q in local]
            if name in self.from_imports.get(path, set()):
                return list(self.by_name.get(name, []))
        return []


def _function_args(call: ast.Call) -> List[ast.AST]:
    return list(call.args) + [kw.value for kw in call.keywords]


def _aliases(classes: ClassIndex, fn: ast.AST) -> Dict[str, ast.AST]:
    """Names ``fn`` binds to an attribute (``step = self.step``),
    memoized on ``classes`` as its local types are."""
    cache = classes.__dict__.setdefault("_alias_cache", {})
    got = cache.get(id(fn))
    if got is None:
        got = cache[id(fn)] = {
            n.targets[0].id: n.value for n in ast.walk(fn)
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Attribute)}
    return got


def receiver_class(classes: ClassIndex, path: str, mod: SourceModule,
                   fn: Optional[ast.AST], recv: ast.AST) -> Optional[str]:
    """The project class of ``recv``, a method call's receiver or a called
    instance: ``self`` is the enclosing class; ``self.<attr>``, a name (a
    local or an annotated parameter of ``fn`` or of a def around it, a
    local alias ``x = self.<attr>``, a module global) and a constructor
    call as :class:`ClassIndex` types them. None where unresolved."""
    if isinstance(recv, ast.Name) and recv.id == "self":
        cls = mod.enclosing_class(recv)
        return cls.name if cls is not None else None
    if (isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"):
        cls = mod.enclosing_class(recv)
        if cls is None:
            return None
        return classes.attr_types.get((path, cls.name), {}).get(recv.attr)
    if isinstance(recv, ast.Name):
        scope = fn
        while scope is not None:
            got = classes.local_types(scope).get(recv.id) \
                or classes._annotation_class(
                    ClassIndex.param_annotation(scope, recv.id))
            if got:
                return got
            alias = _aliases(classes, scope).get(recv.id)
            if alias is not None:
                return receiver_class(classes, path, mod, scope, alias)
            scope = mod.enclosing_function(scope)
        return classes.global_types.get(path, {}).get(recv.id)
    if isinstance(recv, ast.Call):
        return classes._ctor_name(recv)
    return None


def _is_def(node: ast.AST) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def _positional_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [arg.arg for arg in (a.posonlyargs + a.args)]


def _is_method(mod: SourceModule, fn: ast.AST) -> bool:
    """A def in a class body that takes its instance (or class) first."""
    if not isinstance(mod.parents.get(fn), ast.ClassDef):
        return False
    return not any(call_name(d) == "staticmethod" for d in fn.decorator_list)


class CaptureGraph:
    """The capture roots of a project and the set of functions they reach.

    ``roots`` and ``captured`` map ``(module path, qualname)`` to the
    reason the function is in the set (the root or edge that pulled it
    in); ``nodes`` maps every key to its def or lambda node."""

    def __init__(self, project: Dict[str, SourceModule]):
        self.project = project
        self.index = FunctionIndex(project)
        self.nodes: Dict[FuncKey, ast.AST] = dict(self.index.functions)
        self.roots: Dict[FuncKey, str] = {}
        self.captured: Dict[FuncKey, str] = {}
        # function key -> (call-site position, parameter name) of the
        # parameter it hands to Session as fn
        self.forwarders: Dict[FuncKey, Tuple[int, str]] = {}
        self._calls: List[Tuple[str, SourceModule, ast.Call]] = [
            (path, mod, node) for path, mod in project.items()
            for node in ast.walk(mod.tree) if isinstance(node, ast.Call)]
        self._work: List[FuncKey] = []
        self._defs_by_qn: Dict[str, Dict[str, List[ast.AST]]] = {}
        self._lambdas: Dict[int, List[ast.AST]] = {}
        self._find_roots()
        self._propagate()

    # -- keys --------------------------------------------------------------
    def def_key(self, path: str, node: ast.AST) -> FuncKey:
        """The key of a def or lambda node. A def that a later def of the
        same qualname shadows (``@op.register_fake`` over ``def _``) gets
        ``#<n>``, its place among them; a lambda gets ``<lambda>`` in its
        scope (``<lambda#2>`` for the second)."""
        mod = self.project[path]
        qn = mod.qualname(node)
        if isinstance(node, ast.Lambda):
            scope = mod.enclosing_function(node) or mod.tree
            lams = self._lambdas.get(id(scope))
            if lams is None:
                lams = self._lambdas[id(scope)] = sorted(
                    (n for n in ast.walk(scope) if isinstance(n, ast.Lambda)
                     and (mod.enclosing_function(n) or mod.tree) is scope),
                    key=lambda n: (n.lineno, n.col_offset))
            k = lams.index(node)
            key = (path, f"{qn}.<lambda>" if k == 0
                   else f"{qn}.<lambda#{k + 1}>")
        else:
            by_qn = self._defs_by_qn.get(path)
            if by_qn is None:
                by_qn = self._defs_by_qn[path] = {}
                for n in ast.walk(mod.tree):
                    if _is_def(n):
                        by_qn.setdefault(mod.qualname(n), []).append(n)
            same = by_qn[qn]
            key = (path, qn if len(same) == 1
                   else f"{qn}#{same.index(node) + 1}")
        self.nodes[key] = node
        return key

    def _context(self, path: str, node: ast.AST) -> Optional[ast.AST]:
        """The def that name resolution runs in for ``node``: the node
        itself, or for a lambda the def around it (None at module
        level)."""
        if isinstance(node, ast.Lambda):
            return self.project[path].enclosing_function(node)
        return node

    def resolve(self, path: str, caller: Optional[ast.AST],
                func: ast.AST) -> List[FuncKey]:
        """:meth:`FunctionIndex.resolve_call`, and at module level the
        same-module and from-import names."""
        if caller is not None:
            return self.index.resolve_call(path, caller, func)
        if isinstance(func, ast.Name):
            local = self.index.module_defs.get(path, {}).get(func.id)
            if local:
                return [(path, q) for q in local]
            if func.id in self.index.from_imports.get(path, set()):
                return list(self.index.by_name.get(func.id, []))
        return []

    def _instance_class(self, path: str, caller: Optional[ast.AST],
                        recv: ast.AST) -> Optional[str]:
        return receiver_class(self.index.class_index, path,
                              self.project[path], caller, recv)

    def callees(self, path: str, call: ast.Call,
                names: Set[str]) -> List[FuncKey]:
        """What ``call`` may run among functions named ``names``: a
        resolved def, or ``__call__`` of an instance whose class
        :class:`ClassIndex` knows."""
        caller = self.project[path].enclosing_function(call)
        out: List[FuncKey] = []
        if call_name(call.func) in names:
            out = self.resolve(path, caller, call.func)
        if "__call__" in names and isinstance(call.func,
                                              (ast.Name, ast.Attribute)):
            cname = self._instance_class(path, caller, call.func)
            if cname is not None:
                out = out + self.index.method_of(cname, "__call__")
        return out

    # -- roots -------------------------------------------------------------
    def _add(self, key: FuncKey, reason: str, root: bool = False) -> None:
        if key in self.index.functions and _is_def(self.nodes[key]):
            # a resolved name: the def's own key (``_#2`` for a shadowed
            # one), so no def is checked twice
            key = self.def_key(key[0], self.nodes[key])
        if key in self.nodes and key not in self.captured:
            self.captured[key] = reason
            self._work.append(key)
            if root:
                self.roots[key] = reason

    def _fn_value(self, path: str, caller: Optional[ast.AST],
                  value: ast.AST, reason: str, *, root: bool,
                  forward: bool) -> None:
        """Add the function(s) that the expression ``value`` names: a
        lambda, a def by name, a bound method, ``functools.partial(f,
        ...)``. A parameter of ``caller`` makes ``caller`` a forwarder
        (where ``forward``)."""
        if isinstance(value, ast.Lambda):
            self._add(self.def_key(path, value), reason, root)
            return
        if isinstance(value, ast.Call) and call_name(value.func) == "partial" \
                and value.args:
            self._fn_value(path, caller, value.args[0], reason, root=root,
                           forward=forward)
            return
        if forward and isinstance(value, ast.Name) and caller is not None \
                and _is_def(caller):
            params = _positional_params(caller)
            kw = [a.arg for a in caller.args.kwonlyargs]
            if value.id in params or value.id in kw:
                mod = self.project[path]
                pos = (params.index(value.id) if value.id in params else -1)
                if pos >= 0 and _is_method(mod, caller):
                    pos -= 1
                key = self.def_key(path, caller)
                if key not in self.forwarders:
                    self.forwarders[key] = (pos, value.id)
                return
        if isinstance(value, (ast.Name, ast.Attribute)):
            for key in self.resolve(path, caller, value):
                self._add(key, reason, root)

    def _session_fn(self, call: ast.Call) -> Optional[ast.AST]:
        if len(call.args) >= 2:
            return call.args[1]
        return next((kw.value for kw in call.keywords if kw.arg == "fn"),
                    None)

    def _find_roots(self) -> None:
        factories: Set[str] = set()  # functions returning custom_op(...)
        for path, mod in self.project.items():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Return) \
                        and isinstance(node.value, ast.Call) \
                        and call_name(node.value.func) in CUSTOM_OP_TAILS:
                    fn = mod.enclosing_function(node)
                    if fn is not None:
                        factories.add(fn.name)
        for path, mod in self.project.items():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self._autograd_roots(path, mod, node)
                elif _is_def(node):
                    self._op_roots(path, node, factories)
        for path, mod, call in self._calls:
            name = call_name(call.func)
            caller = mod.enclosing_function(call)
            where = f"{path}::{mod.qualname(caller or mod.tree)}"
            if name in SESSION_TAILS:
                fn = self._session_fn(call)
                if fn is not None:
                    self._fn_value(path, caller, fn, f"Session fn in {where}",
                                   root=True, forward=True)
            elif name in CUSTOM_OP_TAILS | OP_RULE_TAILS:
                for a in _function_args(call):
                    if isinstance(a, (ast.Name, ast.Lambda)):
                        self._fn_value(path, caller, a, f"{name}() in {where}",
                                       root=True, forward=False)
            elif name == "export" and isinstance(call.func, ast.Attribute) \
                    and call_name(call.func.value) == "export" and call.args:
                cname = self._instance_class(path, caller, call.args[0])
                for key in (self.index.method_of(cname, "forward")
                            if cname else []):
                    self._add(key, f"torch.export.export in {where}", True)
        self._forwarded()

    def _autograd_roots(self, path: str, mod: SourceModule,
                        cls: ast.ClassDef) -> None:
        def is_function(b: ast.AST) -> bool:
            if isinstance(b, ast.Attribute):
                return b.attr == "Function" and call_name(b.value) \
                    == "autograd"
            return isinstance(b, ast.Name) and b.id == "Function" \
                and "Function" in self.index.from_imports.get(path, set())
        if not any(is_function(b) for b in cls.bases):
            return
        for item in cls.body:
            if _is_def(item) and item.name in AUTOGRAD_METHODS:
                self._add(self.def_key(path, item),
                          f"autograd.Function {cls.name}.{item.name}", True)

    def _op_roots(self, path: str, node: ast.AST, factories: Set[str]) -> None:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = call_name(target)
            if name in OP_RULE_TAILS:
                reason = f"@{name}"
            elif isinstance(dec, ast.Call) and (
                    name in CUSTOM_OP_TAILS or name in factories):
                reason = f"@{name}(...) custom op"
            else:
                continue
            self._add(self.def_key(path, node), reason, True)

    def _forwarded(self) -> None:
        """Roots through forwarders: what each call of a forwarder passes
        in the place of its fn parameter (a chain of forwarders too)."""
        done: Set[Tuple[FuncKey, int]] = set()
        while True:
            before = len(self.forwarders)
            names = {qn.rsplit(".", 1)[-1].split("#")[0]
                     for _, qn in self.forwarders}
            for path, mod, call in self._calls:
                if call_name(call.func) not in names \
                        and "__call__" not in names:
                    continue
                for key in self.callees(path, call, names):
                    if key not in self.forwarders or (key, id(call)) in done:
                        continue
                    done.add((key, id(call)))
                    pos, pname = self.forwarders[key]
                    arg = (call.args[pos] if 0 <= pos < len(call.args)
                           else next((kw.value for kw in call.keywords
                                      if kw.arg == pname), None))
                    if arg is None:
                        continue
                    caller = mod.enclosing_function(call)
                    self._fn_value(
                        path, caller, arg,
                        f"Session fn through {key[1]}() in {path}::"
                        f"{mod.qualname(caller or mod.tree)}",
                        root=True, forward=True)
            if len(self.forwarders) == before:
                return

    # -- propagation -------------------------------------------------------
    def _propagate(self) -> None:
        while self._work:
            path, qn = key = self._work.pop()
            fn = self.nodes[key]
            mod = self.project[path]
            ctx = self._context(path, fn)
            # the body only: decorators and defaults run at definition
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            inner = [n for b in body for n in ast.walk(b)]
            for node in inner:
                if _is_def(node):
                    self._add(self.def_key(path, node), f"nested in {qn}")
            for node in inner:
                if not isinstance(node, ast.Call):
                    continue
                for k in self.resolve(path, ctx, node.func):
                    self._add(k, f"called from {qn}")
                if call_name(node.func) in PROPAGATING:
                    for arg in _function_args(node):
                        if isinstance(arg, (ast.Name, ast.Attribute,
                                            ast.Lambda)) \
                                and mod.enclosing_function(node) is not None:
                            self._fn_value(path, ctx, arg,
                                           f"passed from {qn}", root=False,
                                           forward=False)


_GRAPH_CACHE: dict = {}


def capture_graph(project: Dict[str, SourceModule]) -> CaptureGraph:
    """The :class:`CaptureGraph` of ``project``, built once per project
    object (the five capture checks share it)."""
    cached = _GRAPH_CACHE.get(id(project))
    if cached is not None and cached[0] is project:
        return cached[1]
    graph = CaptureGraph(project)
    _GRAPH_CACHE.clear()
    _GRAPH_CACHE[id(project)] = (project, graph)
    return graph


def captured_functions(project: Dict[str, SourceModule]
                       ) -> Dict[FuncKey, str]:
    """``{(module, qualname): reason}`` for every function whose Python
    runs under capture: the roots and what they reach."""
    return dict(capture_graph(project).captured)
