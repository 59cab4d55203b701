"""Frame-protocol conformance checks (PR01-PR02).

The four framed-TCP surfaces (``parallel/comm.py`` channels) each define
a directional frame vocabulary: elastic membership
(HELLO/BEAT/GRADS/GSUM/RECONF/RECONF_ACK), the self-healing pipeline
(coordinator→worker jobs, worker→coordinator results/acks), and the
router↔replica tier (infer/ping/swap/stats vs result/error/pong/...).
Their wedge classes are (a) a sender growing a new frame type no
receiver loop has an arm for — the frame is silently dropped or hits an
``unknown command`` error path in production, and (b) a
generation/nonce-stamped frame whose receiver uses the payload without
fence-comparing the stamp — the straggler-poisoning class every
review-hardening pass of PRs 8-13 fixed by hand somewhere.

Protocols are declared with a lightweight annotation map (the
``guarded_by`` precedent), attached to the innermost enclosing function:

.. code-block:: python

    def _pump(self):      # dcnn: protocol=replica.c2s role=handler
        ...
    def submit(self, x):  # dcnn: protocol=replica.c2s role=sender
        self._send("infer", {"id": rid}, array=x)

- ``role=sender``: every frame the function emits (a string literal in
  the first two positional args of a ``*send*``/``broadcast`` call)
  joins the protocol's emitted set. A bare
  ``# dcnn: protocol=<name>`` on a send-call line rebinds that single
  send to another protocol (for mixed-direction functions).
- ``role=handler``: the function is a receiver loop; its handled set is
  every string constant compared against a bare name (``cmd == "X"``,
  ``cmd in ("X", "Y")``), plus an optional ``frames=A,B`` extension for
  dynamically dispatched arms (``frames=*`` exempts the handler from
  exhaustiveness entirely — the elastic ``want``-set pattern).

**PR01 frame-unhandled**: for every protocol, every emitted frame must
appear in every handler's handled set (a protocol with senders but no
handler is itself a finding). **PR02 unfenced-stamp**: every frame sent
with a ``gen``/``generation``/``nonce`` meta key must land in handlers
that compare that key somewhere (``meta["gen"]`` / ``meta.get("gen")``
in a comparison, directly or through a local alias) — a handler that
never fences the stamp will happily apply a straggler from a dead
generation.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import call_name
from .core import Finding, SourceModule, register

STAMP_KEYS = ("gen", "generation", "nonce")


def _is_send_tail(func: ast.AST) -> bool:
    tail = call_name(func)
    return tail is not None and ("send" in tail
                                 or tail in ("broadcast", "post"))


def _send_frame(node: ast.Call) -> Optional[str]:
    """Frame name of a ``*send*``/``broadcast``/``post`` call: the first
    string literal among the first two positional args."""
    if not _is_send_tail(node.func):
        return None
    for a in node.args[:2]:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None


def _dict_aliases(fn: ast.AST) -> Dict[str, ast.Dict]:
    """Local names assigned a dict literal (``meta = {...}`` then
    ``send(cmd, meta)``)."""
    out: Dict[str, ast.Dict] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Dict):
            out[node.targets[0].id] = node.value
    return out


def _stamp_keys(node: ast.Call,
                aliases: Optional[Dict[str, ast.Dict]] = None) -> Set[str]:
    """Stamp keys present in the call's meta dict literal(s), following
    one level of local ``meta = {...}`` aliasing."""
    out: Set[str] = set()
    for a in list(node.args) + [kw.value for kw in node.keywords]:
        if isinstance(a, ast.Name) and aliases and a.id in aliases:
            a = aliases[a.id]
        if isinstance(a, ast.Dict):
            for k in a.keys:
                if isinstance(k, ast.Constant) and k.value in STAMP_KEYS:
                    out.add(k.value)
    return out


def _functions(mod: SourceModule):
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _enclosing_fn_at(mod: SourceModule, line: int):
    """Innermost function whose span contains ``line``; an annotation on
    its own line attaches to a ``def`` starting within the next two
    lines (the decorator-position idiom)."""
    best = None
    for fn in _functions(mod):
        end = getattr(fn, "end_lineno", fn.lineno)
        if fn.lineno <= line <= end:
            if best is None or fn.lineno > best.lineno:
                best = fn
    if best is not None:
        return best
    following = [fn for fn in _functions(mod)
                 if line < fn.lineno <= line + 2]
    return min(following, key=lambda f: f.lineno) if following else None


def _handled_constants(fn: ast.AST) -> Set[str]:
    """String constants compared against a bare name: ``cmd == "X"``,
    ``cmd != "X"``, ``cmd in ("X", "Y")``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(isinstance(s, ast.Name) for s in sides):
            continue
        for s in sides:
            if isinstance(s, ast.Constant) and isinstance(s.value, str):
                out.add(s.value)
            elif isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                for el in s.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        out.add(el.value)
    return out


def _access_key(node: ast.AST) -> Optional[str]:
    """``meta["gen"]`` / ``meta.get("gen")`` -> ``gen``."""
    if isinstance(node, ast.Subscript) \
            and isinstance(node.slice, ast.Constant) \
            and node.slice.value in STAMP_KEYS:
        return node.slice.value
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value in STAMP_KEYS:
        return node.args[0].value
    return None


def _if_frames(test: ast.AST) -> Set[str]:
    """Frame constants a dispatch test names — same collection rule as
    the handler-wide scan, applied to one If's test."""
    return _handled_constants(test)


class HandlerFences:
    """Arm-granular stamp-fence facts for one handler function.

    An *arm* is an ``if``/``elif`` whose test names frame constants. A
    stamp compare fences: the whole handler when it sits outside every
    arm (the receive-loop fence pattern), or just its arm's frames when
    it sits inside one (including the arm's own test). A drop-only arm
    (body of ``continue``/``pass``/bare ``return``) never uses the
    payload and is exempt."""

    def __init__(self, mod: SourceModule, fn: ast.AST):
        self.mod = mod
        self.fn = fn
        self.arms: List[Tuple[ast.If, Set[str]]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.If):
                frames = _if_frames(node.test)
                if frames:
                    self.arms.append((node, frames))
        aliases: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                for sub in ast.walk(node.value):
                    k = _access_key(sub)
                    if k is not None:
                        aliases[node.targets[0].id] = k
        self.global_fences: Set[str] = set()
        # frame -> fenced stamp keys (via a compare in that frame's arm)
        self.arm_fences: Dict[str, Set[str]] = {}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            keys: Set[str] = set()
            for side in [node.left] + list(node.comparators):
                for sub in ast.walk(side):
                    k = _access_key(sub)
                    if k is not None:
                        keys.add(k)
                    if isinstance(sub, ast.Name) and sub.id in aliases:
                        keys.add(aliases[sub.id])
            if not keys:
                continue
            arm = self._enclosing_arm(node)
            if arm is None:
                self.global_fences |= keys
            else:
                for f in arm[1]:
                    self.arm_fences.setdefault(f, set()).update(keys)
        self.drop_frames: Set[str] = set()
        for node, frames in self.arms:
            if all(isinstance(s, (ast.Continue, ast.Pass))
                   or (isinstance(s, ast.Return) and s.value is None)
                   for s in node.body):
                self.drop_frames |= frames
        # echo exemption: an arm that ships the incoming stamp back out
        # through a send call (``{"nonce": meta.get("nonce")}``) is the
        # responder half of a round-trip — the *sender* fences the echo;
        # the responder has nothing to compare against
        self.echoed: Dict[str, Set[str]] = {}  # frame -> echoed keys
        for node, frames in self.arms:
            keys: Set[str] = set()
            # scan the arm's BODY only (like drop_frames above): walking
            # the If node itself would include the whole elif chain via
            # orelse, leaking a later arm's echo onto earlier frames
            for sub in (s for stmt in node.body for s in ast.walk(stmt)):
                if not isinstance(sub, ast.Call) \
                        or not _is_send_tail(sub.func):
                    continue
                for inner in ast.walk(sub):
                    k = _access_key(inner)
                    if k is not None:
                        keys.add(k)
            for f in frames:
                self.echoed.setdefault(f, set()).update(keys)

    def _enclosing_arm(self, node: ast.AST) -> Optional[Tuple[ast.If,
                                                              Set[str]]]:
        """Innermost arm whose test or body contains ``node``. A compare
        inside an arm's own test counts as that arm's fence."""
        arm_by_id = {id(a): (a, f) for a, f in self.arms}
        for anc in [node] + list(self.mod.ancestors(node)):
            got = arm_by_id.get(id(anc))
            if got is not None:
                return got
        return None

    def arm_line(self, frame: str) -> Optional[int]:
        """Line of the most specific arm naming ``frame`` (fewest frames
        in its test) — the line an inline suppression should anchor
        on."""
        best: Optional[Tuple[int, int]] = None
        for node, frames in self.arms:
            if frame in frames:
                cand = (len(frames), node.lineno)
                if best is None or cand < best:
                    best = cand
        return best[1] if best else None

    def fenced(self, frame: str, key: str) -> bool:
        if frame in self.drop_frames:
            return True
        if key in self.global_fences:
            return True
        if key in self.echoed.get(frame, set()):
            return True
        return key in self.arm_fences.get(frame, set())


class ProtocolMap:
    """The declared protocols of a project: per protocol name, the
    emitted frames (with sites), stamped frames, and handler functions
    (with handled sets and fenced stamp keys)."""

    def __init__(self, project: Dict[str, SourceModule]):
        # name -> frame -> (path, line, symbol) of one emitting site
        self.emitted: Dict[str, Dict[str, Tuple[str, int, str]]] = {}
        # name -> frame -> {stamp keys}
        self.stamps: Dict[str, Dict[str, Set[str]]] = {}
        # name -> [(path, qualname, handled frames|None wildcard,
        #           declared frames, HandlerFences, def line)]
        self.handlers: Dict[str, List[Tuple[str, str, Optional[Set[str]],
                                            Set[str], HandlerFences,
                                            int]]] = {}
        for path, mod in project.items():
            # function-scoped roles
            fn_roles: Dict[int, List[Dict[str, object]]] = {}
            line_proto: Dict[int, str] = {}
            for line, ann in mod.protocols.items():
                if ann["role"] is None:
                    line_proto[line] = str(ann["name"])
                    continue
                fn = _enclosing_fn_at(mod, line)
                if fn is None:
                    continue
                fn_roles.setdefault(id(fn), []).append(ann)
            for fn in _functions(mod):
                anns = fn_roles.get(id(fn), [])
                qn = mod.qualname(fn)
                sender_of = [a for a in anns if a["role"] == "sender"]
                for a in anns:
                    if a["role"] != "handler":
                        continue
                    name = str(a["name"])
                    frames = a["frames"]
                    declared: Set[str] = set()
                    if frames is not None and "*" in frames:
                        handled: Optional[Set[str]] = None  # wildcard
                    else:
                        handled = _handled_constants(fn)
                        if frames:
                            # declared-only frames (no arm of their own)
                            # are consumed dynamically — PR02 judges the
                            # dynamic consumer, not this loop
                            declared = set(frames) - handled
                            handled |= declared
                    self.handlers.setdefault(name, []).append(
                        (path, qn, handled, declared,
                         HandlerFences(mod, fn), fn.lineno))
                if not sender_of and not line_proto:
                    continue
                aliases = _dict_aliases(fn)
                unresolved_stamps: Set[str] = set()
                # lines covered by any send call in this function: a
                # look-back rebind must not steal the trailing
                # annotation of the PREVIOUS send's last line
                send_lines: Set[int] = set()
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call) \
                            and _is_send_tail(node.func):
                        send_lines.update(range(
                            node.lineno,
                            getattr(node, "end_lineno", node.lineno) + 1))
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    frame = _send_frame(node)
                    if frame is None:
                        # a send-tail call with a variable frame name:
                        # its stamp keys belong to the sender
                        # annotation's declared frames (below)
                        if _is_send_tail(node.func):
                            unresolved_stamps |= _stamp_keys(node, aliases)
                        continue
                    # a line-scoped rebinding may sit on any line of the
                    # (possibly wrapped) call, or on the line just above
                    # — but a line-above annotation that belongs to
                    # another send call's span stays with that call
                    end = getattr(node, "end_lineno", node.lineno)
                    rebind = next((line_proto[ln] for ln in
                                   range(node.lineno, end + 1)
                                   if ln in line_proto), None)
                    above = node.lineno - 1
                    if rebind is None and above in line_proto \
                            and above not in send_lines:
                        rebind = line_proto[above]
                    protos = ([rebind] if rebind is not None
                              else [str(a["name"]) for a in sender_of])
                    for pname in protos:
                        self.emitted.setdefault(pname, {}).setdefault(
                            frame, (path, node.lineno, qn))
                        keys = _stamp_keys(node, aliases)
                        if keys:
                            self.stamps.setdefault(pname, {}).setdefault(
                                frame, set()).update(keys)
                # sender frames= declaration: frames emitted through a
                # variable (request/reply helpers) are declared by name;
                # stamp keys seen on variable-frame sends attach to them
                for a in sender_of:
                    if not a["frames"]:
                        continue
                    pname = str(a["name"])
                    for frame in a["frames"]:  # type: ignore[union-attr]
                        self.emitted.setdefault(pname, {}).setdefault(
                            frame, (path, fn.lineno, qn))
                        if unresolved_stamps:
                            self.stamps.setdefault(pname, {}).setdefault(
                                frame, set()).update(unresolved_stamps)


_CACHE: dict = {}


def protocol_map(project: Dict[str, SourceModule]) -> ProtocolMap:
    cached = _CACHE.get(id(project))
    if cached is not None and cached[0] is project:
        return cached[1]
    pm = ProtocolMap(project)
    _CACHE.clear()
    _CACHE[id(project)] = (project, pm)
    return pm


@register("PR01", "frame-unhandled",
          "a sender's frame type has no arm in a protocol handler")
def check_frame_handled(project: Dict[str, SourceModule]) -> List[Finding]:
    pm = protocol_map(project)
    out: List[Finding] = []
    for pname, frames in sorted(pm.emitted.items()):
        handlers = pm.handlers.get(pname, [])
        if not handlers:
            path, line, qn = next(iter(frames.values()))
            out.append(Finding(
                "PR01", path, line, qn, f"{pname}:<no-handler>",
                f"protocol '{pname}' has annotated senders but no "
                f"'role=handler' function — annotate the receiver loop"))
            continue
        for frame, (spath, sline, sqn) in sorted(frames.items()):
            for hpath, hqn, handled, _declared, _fences, hline in handlers:
                if handled is None or frame in handled:
                    continue
                out.append(Finding(
                    "PR01", hpath, hline, hqn, f"{pname}:{frame}",
                    f"frame '{frame}' (sent at {spath}:{sline} in {sqn}) "
                    f"has no arm in this '{pname}' handler — add a "
                    f"dispatch arm or 'frames={frame}' if it is consumed "
                    f"dynamically"))
    return out


@register("PR02", "unfenced-stamp",
          "a gen/nonce-stamped frame's handler never compares the stamp")
def check_stamp_fenced(project: Dict[str, SourceModule]) -> List[Finding]:
    pm = protocol_map(project)
    out: List[Finding] = []
    for pname, frames in sorted(pm.stamps.items()):
        handlers = pm.handlers.get(pname, [])
        for frame, keys in sorted(frames.items()):
            for key in sorted(keys):
                for hpath, hqn, handled, declared, fences, hline in handlers:
                    if handled is None:
                        continue  # wildcard: consumed dynamically
                    if frame not in handled:
                        continue  # PR01's business
                    if frame in declared:
                        # declared (not discovered as an arm): consumed
                        # dynamically elsewhere — fencing judged there
                        continue
                    if fences.fenced(frame, key):
                        continue
                    line = fences.arm_line(frame) or hline
                    out.append(Finding(
                        "PR02", hpath, line, hqn,
                        f"{pname}:{frame}:{key}",
                        f"frame '{frame}' is stamped with '{key}' by its "
                        f"sender but this '{pname}' handler's arm never "
                        f"compares the stamp — a straggler from a dead "
                        f"{key} would be applied; fence it "
                        f"(e.g. meta.get('{key}') != self.{key})"))
    return out
