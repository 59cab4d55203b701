"""The kernel build directory as a persistent compile cache (counterpart of
``dcnn_tpu/utils/compile_cache.py``).

The JAX package's persistent cache holds XLA executables. The port's
counterpart is the directory its CUDA kernels are built into
(:mod:`~dcnn_tpu_torch.ops._kernels`): one shared library a source, named
by a hash of its source, headers and flags. Every process that finds a
library there loads it instead of running ``nvcc``.

Cache-root resolution (one knob, shared with the executable cache,
:mod:`~dcnn_tpu_torch.aot`):

1. ``AOT_CACHE``: setting it both places the kernel builds and enables the
   executable cache;
2. ``DCNN_COMPILE_CACHE``: places the kernel builds only;
3. the ``cache_dir`` argument (default ``dcnn_tpu_torch/_build/``).

Layout under the root: the libraries directly in it, the executable cache
under ``<root>/aot``.

What can go wrong with a build directory, and what guards it:

- **Another toolchain or card.** A ``.kernels-fingerprint`` stamp records
  torch, the CUDA runtime, ``nvcc --version`` and the card's capability. A
  stamp that disagrees on a field both sides know drops the libraries
  (:func:`_rotate_if_stale`); a process without a compiler does not ask
  for one, and leaves that field unread.
- **A killed build.** ``nvcc`` writes ``<library>.<pid>.tmp`` and renames
  it into place, so a killed build leaves its ``.tmp`` behind, never a torn
  library; :func:`_sweep_torn_entries` drops the ``.tmp`` files of writers
  that are dead.
- **A crashed session.** The session-integrity protocol below, as in the
  JAX package: a library survives the enable-time sweep only if the
  session that built it exited cleanly.

    <root>/.kernels-committed      names of ``*.so`` libraries whose
                                   building session finished cleanly
                                   (atexit / SIGTERM)
    <root>/.kernels-inflight/<pid> live marker per enabling process; a
                                   sweep never deletes while another
                                   enabler is alive
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import signal
import subprocess
from typing import Dict, Optional

# named apart from the JAX package's markers, so one root can hold both
_STAMP = ".kernels-fingerprint"
_COMMITTED = ".kernels-committed"
_INFLIGHT = ".kernels-inflight"
_LIBRARY = ".so"
_TMP = ".tmp"

# root -> names of libraries present when the session began
_SESSIONS: "dict[str, set[str]]" = {}
_HOOKS_INSTALLED = False


def _default_root() -> str:
    from ..ops import _kernels

    return str(_kernels.BUILD_DIR)


def resolve_cache_root(cache_dir: Optional[str] = None) -> str:
    """The one cache-root resolution every entry point shares
    (precedence in the module docstring)."""
    return (os.environ.get("AOT_CACHE", "").strip()
            or os.environ.get("DCNN_COMPILE_CACHE", "").strip()
            or cache_dir or _default_root())


def nvcc_version() -> Optional[str]:
    """The last line of ``nvcc --version`` where a compiler is on ``PATH``
    or under ``CUDA_HOME``, else None (a host that only loads libraries
    needs none)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            try:
                out = subprocess.run([cand, "--version"], capture_output=True,
                                     text=True, timeout=60).stdout
            except (OSError, subprocess.SubprocessError):
                return None
            lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
            return lines[-1] if lines else None
    return None


def runtime_fingerprint() -> Dict[str, Optional[str]]:
    """What a build directory's libraries were made with: torch, the CUDA
    runtime torch was built for, ``nvcc --version`` and the card's compute
    capability (None where unknown: no compiler, no card)."""
    import torch

    cap = None
    if torch.cuda.is_available():
        cap = "%d.%d" % torch.cuda.get_device_capability(0)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_version(), "capability": cap}


def _read_stamp(root: str) -> Optional[Dict[str, Optional[str]]]:
    try:
        with open(os.path.join(root, _STAMP), "r", encoding="utf-8") as f:
            stamp = json.load(f)
        return stamp if isinstance(stamp, dict) else {}
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return {}  # unreadable: no field can vouch for the libraries


def _libraries(root: str) -> "set[str]":
    try:
        return {n for n in os.listdir(root) if n.endswith(_LIBRARY)}
    except OSError:
        return set()


def _rotate_if_stale(root: str, fingerprint: Dict[str, Optional[str]]) -> int:
    """Drop the libraries of a build directory whose stamp names another
    runtime, then stamp it with ``fingerprint``. A field is compared only
    where both the stamp and ``fingerprint`` know it (a warm start without
    a compiler reads no ``nvcc``); an unreadable stamp is stale. A root
    without a stamp is fresh or predates the stamp: its libraries are kept
    (their names hash their sources and flags). Returns how many libraries
    were dropped."""
    stamp = _read_stamp(root)
    stale = stamp is not None and (not stamp or any(
        stamp.get(k) is not None and v is not None and stamp[k] != v
        for k, v in fingerprint.items()))
    dropped = 0
    if stale:
        for name in _libraries(root):
            try:
                os.unlink(os.path.join(root, name))
                dropped += 1
            except OSError:
                pass
    merged = dict(fingerprint)
    if stamp and not stale:  # keep what this process could not read
        merged.update({k: v for k, v in stamp.items()
                       if merged.get(k) is None})
    if merged != stamp:
        try:
            os.makedirs(root, exist_ok=True)
            tmp = os.path.join(root, f"{_STAMP}.tmp.{os.getpid()}")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(merged, f, sort_keys=True)
            os.replace(tmp, os.path.join(root, _STAMP))
        except OSError:
            pass  # unwritable root: builds will fail there too
    return dropped


def _writer_pid(name: str) -> Optional[int]:
    """The pid in a build's temporary name, ``<library>.<pid>[.<tid>].tmp``."""
    m = re.search(r"\.(\d+)(?:\.\d+)?\.tmp$", name)
    return int(m.group(1)) if m else None


def _sweep_torn_entries(root: str) -> int:
    """Drop the temporary files of builds whose writer is dead (a killed
    ``nvcc`` or ``g++``). A live writer's file may be a build in flight and
    stays. Returns how many were dropped."""
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    n = 0
    for name in names:
        if not name.endswith(_TMP) or name.startswith("."):
            continue
        pid = _writer_pid(name)
        if pid is not None and (pid == os.getpid() or _pid_alive(pid)):
            continue
        try:
            os.unlink(os.path.join(root, name))
            n += 1
        except OSError:
            pass
    return n


# -- session-integrity protocol (quarantine of crashed builders) ---------

def _read_committed(root: str) -> "set[str]":
    try:
        with open(os.path.join(root, _COMMITTED), encoding="utf-8") as f:
            return {ln.strip() for ln in f if ln.strip()}
    except OSError:
        return set()


def _write_committed(root: str, names: "set[str]") -> None:
    path = os.path.join(root, _COMMITTED)
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("".join(n + "\n" for n in sorted(names)))
        os.replace(tmp, path)
    except OSError:
        pass  # unwritable root: builds no-op too


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: alive, someone else's
    return True


def _other_live_enablers(root: str) -> bool:
    """True if another live process has this root enabled. Dead markers
    (crashed or killed enablers) are pruned on the way."""
    d = os.path.join(root, _INFLIGHT)
    try:
        names = os.listdir(d)
    except OSError:
        return False
    alive = False
    for n in names:
        try:
            pid = int(n)
        except ValueError:
            continue
        if pid == os.getpid():
            continue
        if _pid_alive(pid):
            alive = True
        else:
            try:
                os.unlink(os.path.join(d, n))
            except OSError:
                pass
    return alive


def _sweep_uncommitted(root: str) -> int:
    """Drop libraries whose building session never exited cleanly.

    Skipped while another live enabler shares the root (its builds are
    legitimately uncommitted); with no manifest at all the present
    libraries are committed wholesale instead of dropped."""
    present = _libraries(root)
    if not os.path.exists(os.path.join(root, _COMMITTED)):
        # a root from before the protocol (possibly empty: the write arms
        # the sweep for libraries a first session builds and then crashes)
        _write_committed(root, present)
        return 0
    if not present or _other_live_enablers(root):
        return 0
    committed = _read_committed(root)
    n = 0
    for name in present - committed:
        try:
            os.unlink(os.path.join(root, name))
            n += 1
        except OSError:
            pass
    return n


def _finish_sessions() -> None:
    """Clean-exit hook: commit every library built during this session
    (present now, absent at enable time), prune names whose files are
    gone, drop the inflight marker."""
    for root, before in list(_SESSIONS.items()):
        present = _libraries(root)
        _write_committed(root, (_read_committed(root)
                                | (present - before)) & present)
        try:
            os.unlink(os.path.join(root, _INFLIGHT, str(os.getpid())))
        except OSError:
            pass
    _SESSIONS.clear()


def _on_sigterm(signum, frame):  # pragma: no cover - exercised via kill
    # a TERM kill (a runner's timeout) is an orderly death, not a crash:
    # commit the session, then die with the default disposition
    _finish_sessions()
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def _register_session(root: str) -> None:
    global _HOOKS_INSTALLED
    if root in _SESSIONS:
        return
    _SESSIONS[root] = _libraries(root)
    try:
        os.makedirs(os.path.join(root, _INFLIGHT), exist_ok=True)
        # existence-only marker: content is irrelevant, a torn write is
        # indistinguishable from a whole one
        marker = os.path.join(root, _INFLIGHT, str(os.getpid()))
        with open(marker, "w", encoding="utf-8") as f:  # dcnn: disable=AT01
            f.write("")
    except OSError:
        pass
    if not _HOOKS_INSTALLED:
        _HOOKS_INSTALLED = True
        atexit.register(_finish_sessions)
        try:
            # chain only onto the default disposition, never over a
            # handler the host application installed
            if signal.getsignal(signal.SIGTERM) is signal.SIG_DFL:
                signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass  # not the main thread: atexit still covers


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Resolve the kernel build directory, check it once a process
    (stamp, torn builds, crashed sessions; the drops counted on
    ``compile_cache_quarantined_total``) and return it. Idempotent: the
    kernel build calls it before each build."""
    root = os.path.abspath(resolve_cache_root(cache_dir))
    if root in _SESSIONS:
        return root
    os.makedirs(root, exist_ok=True)
    swept = _rotate_if_stale(root, runtime_fingerprint())
    swept += _sweep_torn_entries(root) + _sweep_uncommitted(root)
    _register_session(root)
    try:
        from ..obs.registry import get_registry

        get_registry().counter(
            "compile_cache_quarantined_total",
            "cache entries dropped as torn or minted by a session that "
            "never exited cleanly").inc(swept)
    except Exception:
        pass  # the build must never depend on the metrics
    return root
