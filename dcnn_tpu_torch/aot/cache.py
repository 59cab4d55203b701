"""Persistent on-disk store for the port's compiled artifacts (counterpart
of ``dcnn_tpu/aot/cache.py``).

An entry is a kernel library (the shared object ``nvcc`` built from
``ops/csrc/*.cu``) or an exported serving program (the ``.pt2`` bytes of
:func:`~dcnn_tpu_torch.nn.export.export_inference`). Layout, one immutable
directory per entry under the cache root::

    <root>/
      .lock                     cross-process advisory lock (fcntl.flock)
      <key>/                    key = keys.cache_key sha256 hex
        payload.bin             the library's or the program's bytes
        MANIFEST.json           sha256 + size of payload, creation time,
                                backend fingerprint, key material, label
        hits                    load counter sidecar (not checksummed:
                                MANIFEST integrity covers the payload only)
      tmp-<uuid>/               in-flight staging (resilience.atomic)
      corrupt-<key>-<uuid>/     quarantined entries awaiting the age sweep

Durability and sharing contracts, as in the JAX package:

- **Trusted root.** A hit loads a shared library with ``ctypes`` or
  unpickles an exported program: bytes from a directory another user
  controls are arbitrary code execution, and the checksum MANIFEST beside
  them is no defence. A root that another user owns or can write (below
  any ancestor that is not sticky) is refused (:meth:`_check_root_trusted`).
- **Atomic commits.** An entry is staged complete under ``tmp-<uuid>``,
  fsynced, and published by one ``os.replace``, so a reader sees no entry
  or a whole one.
- **Checksum MANIFEST.** ``lookup`` verifies the payload's SHA-256 before
  returning it; a mismatch quarantines the entry (renamed ``corrupt-*``,
  counted) and reports a miss, so the caller builds again.
- **Version staleness is a miss.** The backend fingerprint is part of the
  key; entries whose MANIFEST fingerprint disagrees anyway (hand-copied
  caches) are skipped and left for GC.
- **Cross-process locking.** Every mutation runs under an exclusive
  ``flock`` on ``<root>/.lock``, reads under a shared one.
- **Keep-K GC.** After each commit the least recently used entries beyond
  ``keep`` are removed. ``tmp-``/``corrupt-`` dirs older than an hour are
  swept at construction.

Fault points (``resilience.faults``): ``aot.commit`` fires before a
commit's staging, ``aot.load`` before a lookup's read.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional

try:
    import fcntl
except ImportError:  # non-POSIX: advisory locking degrades to a no-op
    fcntl = None

from ..resilience import faults as _faults
from ..resilience.atomic import fsync_path, stage_dir, write_file_atomic
from .keys import STALE_FIELDS

_PAYLOAD = "payload.bin"
_MANIFEST = "MANIFEST.json"
_HITS = "hits"
_DEFAULT_KEEP = 64
_SWEEP_AGE_S = 3600.0


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ExecutableCache:
    """Shared persistent store rooted at ``root`` (typically
    ``<compile-cache-root>/aot``, :mod:`~dcnn_tpu_torch.aot.warm`)."""

    def __init__(self, root: str, *, keep: Optional[int] = None,
                 registry=None, clock=time.time):
        self.root = os.path.abspath(root)
        if keep is None:
            keep = int(os.environ.get("AOT_CACHE_KEEP", _DEFAULT_KEEP))
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.keep = keep
        self.registry = registry
        self._clock = clock
        os.makedirs(self.root, mode=0o700, exist_ok=True)
        self._check_root_trusted()
        self._sweep_stale()

    def _check_root_trusted(self) -> None:
        """Refuse a cache root another user could have planted or can
        swap out. A hit loads a shared library with ``ctypes`` or
        unpickles an exported program: executing bytes from a directory
        an attacker controls is arbitrary code execution, and the checksum
        MANIFEST is no defense (they sit in the same directory). The ssh
        strict-modes walk: the root AND every ancestor must be owned by us
        (or root) and not world-writable — except sticky world-writable
        dirs (``/tmp`` itself, 1777), where the kernel already forbids
        other users renaming entries they don't own, so a 0700 root under
        ``/tmp`` stays trusted. Every refusal degrades to uncached builds
        via the callers' guards."""
        if not hasattr(os, "getuid"):
            return  # non-POSIX: no uid/mode semantics to check
        uid = os.getuid()
        path = os.path.realpath(self.root)
        while True:
            st = os.stat(path)
            sticky_shared = (st.st_mode & 0o1000) and (st.st_mode & 0o002)
            if not sticky_shared:
                # sticky world-writable dirs (/tmp, 1777 — whatever their
                # owner, which varies across container images) are the
                # platform's shared-tmp contract: the kernel forbids
                # non-owners renaming entries they don't own, so our 0700
                # entry beneath them is safe. Everything else must be
                # ours (or root's) and not world-writable.
                if st.st_uid not in (uid, 0):
                    raise ValueError(
                        f"aot cache path {path!r} is owned by uid "
                        f"{st.st_uid}, not us (uid {uid}) — refusing to "
                        f"load artifacts through a directory another "
                        f"user controls")
                if st.st_mode & 0o002:
                    raise ValueError(
                        f"aot cache path {path!r} is world-writable "
                        f"without the sticky bit (mode "
                        f"{oct(st.st_mode & 0o7777)}) — any user could "
                        f"swap a payload in; chmod o-w it or point "
                        f"AOT_CACHE at a private directory")
            parent = os.path.dirname(path)
            if parent == path:
                return
            path = parent

    # -- locking -----------------------------------------------------------
    @contextlib.contextmanager
    def _lock(self, *, exclusive: bool):
        """Advisory cross-process lock over the whole cache dir. Each
        acquisition opens its own fd, so in-process threads serialize
        against each other too (flock is per open-file-description)."""
        if fcntl is None:
            yield
            return
        fd = os.open(os.path.join(self.root, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
            yield
        finally:
            os.close(fd)  # closing releases the flock

    # -- observability -----------------------------------------------------
    def _count(self, event: str, seconds: float = 0.0) -> None:
        from ..obs.xla import record_aot
        record_aot(event, seconds, registry=self.registry)

    # -- entry paths -------------------------------------------------------
    def _entry_dir(self, key: str) -> str:
        if not key or os.sep in key or key.startswith((".", "tmp-",
                                                       "corrupt-")):
            raise ValueError(f"malformed cache key {key!r}")
        return os.path.join(self.root, key)

    def has(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self._entry_dir(key), _MANIFEST))

    # -- core operations ---------------------------------------------------
    def lookup(self, key: str,
               fingerprint: Optional[Dict[str, Any]] = None
               ) -> Optional[bytes]:
        """Checksum-verified payload bytes for ``key``, or ``None`` on a
        miss. A corrupt entry (torn/bit-flipped payload, unreadable
        MANIFEST) is quarantined and reported as a miss; an entry whose
        recorded fingerprint disagrees with ``fingerprint`` (stale
        version) is skipped — present but not loadable here."""
        _faults.trip("aot.load", key=key)
        d = self._entry_dir(key)
        corrupt_reason = None
        with self._lock(exclusive=False):
            try:
                with open(os.path.join(d, _MANIFEST), "r",
                          encoding="utf-8") as f:
                    manifest = json.load(f)
            except FileNotFoundError:
                return None
            except (OSError, ValueError) as e:
                corrupt_reason = f"unreadable MANIFEST: {e}"
                manifest = None
            payload = None
            if manifest is not None:
                if fingerprint is not None:
                    rec = (manifest.get("material") or {}).get(
                        "fingerprint") or {}
                    for field in STALE_FIELDS:
                        if field in rec and rec[field] != fingerprint.get(
                                field):
                            self._count("stale")
                            return None
                try:
                    with open(os.path.join(d, _PAYLOAD), "rb") as f:
                        payload = f.read()
                except OSError as e:
                    corrupt_reason = f"unreadable payload: {e}"
                else:
                    if _sha256(payload) != manifest.get("sha256"):
                        corrupt_reason = "payload checksum mismatch"
                        payload = None
        if corrupt_reason is not None:
            self.quarantine(key, corrupt_reason)
            return None
        self._record_hit(key)
        return payload

    def commit(self, key: str, payload: bytes,
               meta: Optional[Dict[str, Any]] = None) -> bool:
        """Atomically publish ``payload`` under ``key``; ``False`` when a
        sibling process already committed it (their bytes are equivalent
        by key construction — first writer wins). Runs keep-K GC after a
        successful publish."""
        _faults.trip("aot.commit", key=key)
        final = self._entry_dir(key)
        if os.path.isdir(final):
            return False
        manifest = dict(meta or {})
        manifest.update({
            "key": key,
            "sha256": _sha256(payload),
            "size": len(payload),
            "created_unix": self._clock(),
        })
        # Stage AND fsync the (potentially multi-hundred-MB) payload
        # UNLOCKED — the uuid tmp name is collision-free, and holding the
        # fleet-wide exclusive flock through the write+flush would block
        # every sibling replica's lookup for the whole copy, during
        # exactly the spin-up window the cache exists to accelerate. The
        # protocol is resilience.atomic's stage→fsync→os.replace, with
        # the data flushes hoisted out of the lock: it covers only the
        # publish decision (exists-check, rename, parent fsync, GC).
        tmp = stage_dir(self.root)
        try:
            with open(os.path.join(tmp, _PAYLOAD), "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, _MANIFEST), "w",
                      encoding="utf-8") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            fsync_path(tmp)
            with self._lock(exclusive=True):
                if os.path.isdir(final):  # a sibling published first
                    shutil.rmtree(tmp, ignore_errors=True)
                    return False
                os.replace(tmp, final)
                fsync_path(self.root)
                self._gc_locked(self.keep)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._count("commit")
        return True

    def quarantine(self, key: str, reason: str = "") -> bool:
        """Move a corrupt entry aside (``corrupt-<key>-<uuid>``) so the
        caller can recompile and recommit under the same key. Quarantined
        dirs are swept by age at construction time."""
        d = self._entry_dir(key)
        with self._lock(exclusive=True):
            if not os.path.isdir(d):
                return False
            dst = os.path.join(self.root,
                               f"corrupt-{key[:16]}-{uuid.uuid4().hex[:8]}")
            try:
                os.replace(d, dst)
            except OSError:
                return False
        import warnings
        warnings.warn(f"aot cache: quarantined corrupt entry {key[:16]}… "
                      f"({reason or 'integrity failure'}); it will be "
                      f"built again", stacklevel=2)
        self._count("quarantined")
        return True

    def _record_hit(self, key: str) -> None:
        """Bump the hit sidecar (best-effort — a lost bump only skews the
        listing, never correctness). The write also touches the entry
        dir's mtime, which is what keep-K GC orders by (LRU)."""
        d = self._entry_dir(key)
        with self._lock(exclusive=True):
            try:
                try:
                    with open(os.path.join(d, _HITS), "r",
                              encoding="utf-8") as f:
                        n = int(f.read().strip() or 0)
                except (OSError, ValueError):
                    n = 0
                write_file_atomic(os.path.join(d, _HITS),
                                  str(n + 1).encode("utf-8"))
            except OSError:
                pass

    # -- retention ---------------------------------------------------------
    def _entry_names(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return [n for n in names
                if not n.startswith((".", "tmp-", "corrupt-"))
                and os.path.isdir(os.path.join(self.root, n))]

    def _gc_locked(self, keep: int) -> int:
        entries = []
        for name in self._entry_names():
            try:
                mtime = os.path.getmtime(os.path.join(self.root, name))
            except OSError:
                continue
            entries.append((mtime, name))
        entries.sort(reverse=True)  # newest-used first
        removed = 0
        for _, name in entries[keep:]:
            shutil.rmtree(os.path.join(self.root, name),
                          ignore_errors=True)
            removed += 1
        return removed

    def gc(self, keep: Optional[int] = None) -> int:
        """Keep the ``keep`` most-recently-used entries; returns how many
        were removed."""
        k = self.keep if keep is None else keep
        if k < 1:
            raise ValueError(f"keep must be >= 1, got {k}")
        with self._lock(exclusive=True):
            return self._gc_locked(k)

    def _sweep_stale(self) -> int:
        """Remove ``tmp-``/``corrupt-`` dirs older than an hour. Young
        ones are left alone: a ``tmp-`` may be a sibling process's
        in-flight commit."""
        removed = 0
        with self._lock(exclusive=True):
            try:
                names = os.listdir(self.root)
            except OSError:
                return 0
            now = self._clock()
            for name in names:
                if not name.startswith(("tmp-", "corrupt-")):
                    continue
                p = os.path.join(self.root, name)
                try:
                    age = now - os.path.getmtime(p)
                except OSError:
                    continue
                if age > _SWEEP_AGE_S:
                    shutil.rmtree(p, ignore_errors=True)
                    removed += 1
        return removed

    # -- introspection (the CLI's data source) -----------------------------
    def entries(self) -> List[Dict[str, Any]]:
        """One summary dict per committed entry, newest-used first."""
        out = []
        with self._lock(exclusive=False):
            for name in self._entry_names():
                d = os.path.join(self.root, name)
                row: Dict[str, Any] = {"key": name}
                try:
                    with open(os.path.join(d, _MANIFEST), "r",
                              encoding="utf-8") as f:
                        m = json.load(f)
                except (OSError, ValueError):
                    row["error"] = "unreadable MANIFEST"
                    out.append(row)
                    continue
                row.update({
                    "what": m.get("what", ""),
                    "avals": m.get("avals", ""),
                    "size": m.get("size"),
                    "age_s": round(max(
                        self._clock() - m.get("created_unix", 0.0), 0.0), 1),
                    "torch": (m.get("material") or {}).get(
                        "fingerprint", {}).get("torch"),
                })
                try:
                    with open(os.path.join(d, _HITS), "r",
                              encoding="utf-8") as f:
                        row["hits"] = int(f.read().strip() or 0)
                except (OSError, ValueError):
                    row["hits"] = 0
                try:
                    row["last_used_s"] = round(max(
                        self._clock() - os.path.getmtime(d), 0.0), 1)
                except OSError:
                    pass
                out.append(row)
        out.sort(key=lambda r: r.get("last_used_s", float("inf")))
        return out

    def __repr__(self) -> str:
        return (f"ExecutableCache({self.root!r}, keep={self.keep}, "
                f"entries={len(self._entry_names())})")
