"""Capture-safety checks (TS01-TS05): the JAX suite's trace-safety family,
re-aimed at CUDA graph capture.

What "captured" means here is computed by :mod:`.callgraph`: the set of
functions reachable from a ``Session``'s ``fn``, an ``autograd.Function``'s
``forward``/``backward``, a custom op's body or rule, or the module given to
``torch.export.export``. Capture runs that Python once; every replay runs
only the kernels it launched. Inside that set:

- **TS01 capture-host-sync** — calls that read the card from the host:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``torch.cuda.synchronize()`` and a stream's or event's
  ``.synchronize()``, and ``np.asarray`` / ``np.array`` / ``np.copy`` of a
  captured parameter. Under capture they raise (a
  :class:`~dcnn_tpu_torch.core.graphs.CaptureError`); eagerly they fence
  the card on every step.
- **TS02 capture-host-cast** — ``float()`` / ``int()`` / ``bool()`` /
  ``complex()`` over an expression that mentions a tensor parameter
  (``.shape`` / ``.ndim`` / ``.dtype`` / ``.size()`` / ``.numel()``
  subtrees are host metadata and exempt): a host read, as TS01. A
  parameter annotated as a host value (``scale: float``,
  ``causal: Optional[bool]``, ``torch.dtype``) is not a tensor parameter.
- **TS03 capture-print** — ``print()`` in captured code prints once, at
  capture, and never at a replay.
- **TS05 capture-impure** — Python-side state that outlives the capture:
  ``global`` / ``nonlocal`` writes, assignment or augmented assignment to
  ``self.<attr>`` or through a closed-over name, and mutator-method calls
  (``append`` / ``update`` / ...) on closed-over containers. They happen
  at capture only and silently stop happening per step. In-place tensor
  work is what a graph replays, so it is not a finding: ``_``-suffixed
  tensor methods (``copy_``, ``add_``, ``zero_``, ...) and ``out=`` calls
  never match (they are not mutators), and a subscript assignment is a
  tensor write when its index is a slice, an ``...`` or a tuple holding
  one (``buf[:n] = x``, ``out[..., 0] = y``, ``t[:, i] += v``): only
  arrays take such an index. A subscript with a plain key (``cache[k] =
  v``, ``stats["n"] += 1``) is a container write, a finding.

Outside the captured set:

- **TS04 global-rng** — inside the determinism-contract modules
  (``data/workers.py``, ``data/augment.py``, ``data/streaming.py``, the
  JAX suite's list): ``np.random.*`` global state and stdlib
  ``random.*`` module-level calls, ``torch.manual_seed`` /
  ``torch.cuda.manual_seed*``, and torch's sampling calls (``rand``,
  ``randn``, ``randint``, ``randperm``, ``bernoulli``, ``multinomial``,
  ``normal``, and the in-place ``normal_`` / ``uniform_`` /
  ``bernoulli_`` / ``random_`` / ``exponential_``) made without
  ``generator=``. The feed's bit-exactness contract requires every draw to
  flow from an explicit, seeded generator.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from .callgraph import call_name, capture_graph
from .core import Finding, SourceModule, register

# zero-argument calls that read the card (or wait for it) from the host
HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
HOST_MATERIALIZE = {"asarray", "array", "copy"}  # np.<name>(param)
HOST_CASTS = {"float", "int", "bool", "complex"}
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "numel"}
MUTATORS = {"append", "extend", "add", "update", "remove", "discard",
            "pop", "popleft", "appendleft", "clear", "insert",
            "setdefault", "sort", "reverse", "write"}

# modules bound by the bit-exactness determinism contract (suffix match)
DETERMINISM_MODULES = ("data/workers.py", "data/augment.py",
                       "data/streaming.py")

# np.random attributes that do NOT touch the global BitGenerator
SEEDED_RNG_OK = {"Generator", "default_rng", "SeedSequence", "PCG64",
                 "Philox", "SFC64", "MT19937", "BitGenerator", "RandomState"}

_STDLIB_RANDOM_GLOBALS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "seed", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "triangular",
}

# torch.<name>(...) draws from the default generator unless given one
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                  "multinomial", "normal"}
# <tensor>.<name>(...) in-place draws, likewise
TORCH_INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                          "exponential_"}


def _np_random_attr(node: ast.AST) -> Optional[str]:
    """``np.random.X`` / ``numpy.random.X`` -> ``X``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "random"
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id in ("np", "numpy")):
        return node.attr
    return None


def _torch_rng(node: ast.Call) -> Optional[str]:
    """The global-state torch RNG call ``node`` makes, or None:
    ``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]``, or a sampler
    without ``generator=``."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    root = f.value
    torch_mod = isinstance(root, ast.Name) and root.id == "torch"
    cuda_mod = (isinstance(root, ast.Attribute) and root.attr == "cuda"
                and isinstance(root.value, ast.Name)
                and root.value.id == "torch")
    if f.attr.startswith("manual_seed") and (torch_mod or cuda_mod):
        return f"{'torch.cuda' if cuda_mod else 'torch'}.{f.attr}"
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    if torch_mod and f.attr in TORCH_SAMPLERS:
        return f"torch.{f.attr}"
    if f.attr in TORCH_INPLACE_SAMPLERS:
        return f".{f.attr}"
    return None


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters plus names bound inside ``fn`` itself (excluding nested
    defs' internals) — anything NOT in this set that the body touches is
    closed-over or global."""
    names: Set[str] = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs):
        names.add(arg.arg)
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    for node in _own_nodes(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not fn:
            names.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            # declared, but NOT local for purity purposes
            names.difference_update(node.names)
    return names


def _own_nodes(fn: ast.AST):
    """Walk ``fn`` without descending into nested function/class defs or
    lambdas — they are separate entries in the captured set where they are
    captured, and are checked on their own."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _params(fn: ast.AST) -> Set[str]:
    a = fn.args
    out = {arg.arg for arg in (a.posonlyargs + a.args + a.kwonlyargs)}
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    out.discard("self")
    return out


# an annotation made of these names only types a host value, not a tensor
SCALAR_ANNOTATIONS = {"float", "int", "bool", "str", "complex", "Optional",
                      "Union", "None", "torch.dtype", "torch.device"}


def _tensor_params(fn: ast.AST) -> Set[str]:
    """:func:`_params` less those annotated as host values (``scale:
    float``, ``causal: Optional[bool]``, ``cdt: torch.dtype``): a cast of
    one reads no card."""
    a = fn.args
    scalar = set()
    for arg in (a.posonlyargs + a.args + a.kwonlyargs):
        ann = arg.annotation
        if ann is None:
            continue
        names = re.findall(r"[A-Za-z_][\w.]*", ast.unparse(ann))
        if names and all(n in SCALAR_ANNOTATIONS for n in names):
            scalar.add(arg.arg)
    return _params(fn) - scalar


def _mentions_param(node: ast.AST, params: Set[str]) -> bool:
    """Does the expression reference a captured parameter in a non-static
    position? ``x`` yes; ``x.shape[0]`` and ``x.size(0)`` no (host
    metadata)."""
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if isinstance(node, ast.Name):
        return node.id in params
    return any(_mentions_param(c, params) for c in ast.iter_child_nodes(node))


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost name of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _tensor_index(sl: ast.AST) -> bool:
    """An index only an array takes: a slice, ``...``, or a tuple holding
    one (``t[:n]``, ``t[..., 0]``, ``t[:, i]``)."""
    if isinstance(sl, ast.Slice):
        return True
    if isinstance(sl, ast.Constant) and sl.value is Ellipsis:
        return True
    return isinstance(sl, ast.Tuple) and any(_tensor_index(e)
                                             for e in sl.elts)


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    cands = node.args[:1] + [kw.value for kw in node.keywords
                             if kw.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Call) and call_name(c.func) == "device" \
                and c.args:
            c = c.args[0]
        if isinstance(c, ast.Constant) and isinstance(c.value, str) \
                and c.value.split(":")[0] == "cpu":
            return True
    return False


def _iter_captured(project: Dict[str, SourceModule]):
    graph = capture_graph(project)
    for key in sorted(graph.captured):
        path, qn = key
        yield path, project[path], qn, graph.nodes[key]


@register("TS01", "capture-host-sync",
          "host sync / host read inside captured code")
def check_host_sync(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod, qn, fn in _iter_captured(project):
        params = _tensor_params(fn)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_ATTRS \
                    and (not node.args or f.attr == "synchronize"):
                out.append(Finding(
                    "TS01", path, node.lineno, qn, f.attr,
                    f".{f.attr}() reads the card from the host inside "
                    f"captured code (CaptureError under capture, a fence "
                    f"eagerly); return the tensor and read it after the "
                    f"replay"))
            elif _to_cpu(node):
                out.append(Finding(
                    "TS01", path, node.lineno, qn, "to-cpu",
                    ".to('cpu') inside captured code is a device->host "
                    "copy a graph cannot hold; move it out of the captured "
                    "function"))
            elif (isinstance(f, ast.Attribute) and f.attr in HOST_MATERIALIZE
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy") and node.args
                    and _mentions_param(node.args[0], params)):
                out.append(Finding(
                    "TS01", path, node.lineno, qn, f"np.{f.attr}",
                    f"np.{f.attr}() on a captured tensor materializes it "
                    f"on the host; keep it a tensor"))
    return out


@register("TS02", "capture-host-cast",
          "float()/int()/bool() on a tensor inside captured code")
def check_host_cast(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod, qn, fn in _iter_captured(project):
        params = _tensor_params(fn)
        for node in _own_nodes(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in HOST_CASTS and len(node.args) == 1
                    and _mentions_param(node.args[0], params)):
                out.append(Finding(
                    "TS02", path, node.lineno, qn, node.func.id,
                    f"{node.func.id}() on a tensor is a host read inside "
                    f"captured code; keep it a tensor or read it after "
                    f"the replay"))
    return out


@register("TS03", "capture-print", "print() inside captured code")
def check_trace_print(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod, qn, fn in _iter_captured(project):
        for node in _own_nodes(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                out.append(Finding(
                    "TS03", path, node.lineno, qn, "print",
                    "print() in captured code runs once at capture, never "
                    "at a replay; print from the caller after the step"))
    return out


@register("TS04", "global-rng",
          "global-state RNG in a determinism-contract module")
def check_global_rng(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod in project.items():
        if not path.endswith(DETERMINISM_MODULES):
            continue
        for node in ast.walk(mod.tree):
            attr = _np_random_attr(node)
            symbol = mod.qualname(mod.enclosing_function(node) or mod.tree)
            if attr is not None and attr not in SEEDED_RNG_OK:
                out.append(Finding(
                    "TS04", path, node.lineno, symbol, attr,
                    f"np.random.{attr} uses the process-global BitGenerator; "
                    f"this module is under the bit-exactness contract — "
                    f"derive a seeded Generator instead"))
            elif not isinstance(node, ast.Call):
                continue
            elif (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "random"
                    and node.func.attr in _STDLIB_RANDOM_GLOBALS):
                out.append(Finding(
                    "TS04", path, node.lineno, symbol,
                    f"random.{node.func.attr}",
                    f"stdlib random.{node.func.attr}() draws from global "
                    f"state; use a seeded random.Random / np Generator"))
            else:
                what = _torch_rng(node)
                if what is not None:
                    out.append(Finding(
                        "TS04", path, node.lineno, symbol, what,
                        f"{what}() uses torch's global generator; this "
                        f"module is under the bit-exactness contract — "
                        f"pass an explicit generator="))
    return out


@register("TS05", "capture-impure",
          "Python-side state written inside captured code")
def check_trace_impure(project: Dict[str, SourceModule]) -> List[Finding]:
    out: List[Finding] = []
    for path, mod, qn, fn in _iter_captured(project):
        local = _local_names(fn)
        declared_global: Set[str] = set()
        for node in _own_nodes(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                declared_global.update(node.names)
        for node in _own_nodes(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                for t in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                          else [t]):
                    if isinstance(t, ast.Name) and t.id in declared_global:
                        out.append(Finding(
                            "TS05", path, node.lineno, qn, t.id,
                            f"write to global/nonlocal '{t.id}' inside "
                            f"captured code happens once at capture, not "
                            f"per replay"))
                    elif isinstance(t, (ast.Attribute, ast.Subscript)):
                        if isinstance(t, ast.Subscript) \
                                and _tensor_index(t.slice):
                            continue  # a tensor write: the graph holds it
                        root = _root_name(t)
                        if root is not None and (root == "self"
                                                 or root not in local):
                            out.append(Finding(
                                "TS05", path, node.lineno, qn, root,
                                f"write to '{ast.unparse(t)}' inside "
                                f"captured code happens at capture only; "
                                f"return the value, or keep it in a "
                                f"tensor the step writes in place"))
            # mutator calls count only in statement position (result
            # discarded): ``lst.append(x)`` mutates, ``opt.update(...)``
            # assigned to a name is an API call returning new state. The
            # chain root decides locality — ``self.history.append`` is a
            # closed-over mutation just like a bare ``acc.append``
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in MUTATORS:
                node = node.value
                root = _root_name(node.func.value)
                if root is not None and (root == "self"
                                         or root not in local):
                    target = ast.unparse(node.func.value)
                    out.append(Finding(
                        "TS05", path, node.lineno, qn, root,
                        f"'{target}.{node.func.attr}()' mutates Python "
                        f"state inside captured code; it runs at capture "
                        f"only — return the data instead"))
    return out
