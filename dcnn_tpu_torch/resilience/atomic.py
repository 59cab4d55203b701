"""Atomic file and directory commits (counterpart of
``dcnn_tpu/resilience/atomic.py``).

- :func:`write_file_atomic`: write to ``<path>.tmp-<uuid>``, flush,
  ``fsync``, ``os.replace`` onto ``path``. A reader, or a restart after a
  crash, sees the old complete bytes or the new complete bytes, never a
  torn prefix.
- :func:`stage_dir` / :func:`commit_dir`: the directory form. The caller
  stages a complete checkpoint under a ``tmp-<uuid>`` sibling, then one
  ``os.replace(tmp, final)`` is the commit point; an ``fsync`` of the parent
  makes the rename itself durable.

Standard library only: ``train/checkpoint.py`` and
``resilience/checkpoint.py`` share it.
"""

from __future__ import annotations

import hashlib
import os
import uuid


def fsync_path(path: str) -> None:
    """fsync a file or directory (directories need their own fd on POSIX;
    platforms that refuse O_RDONLY dir fsync just skip — rename ordering is
    still preserved by the filesystem there)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_file_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` such that ``path`` is never observable
    half-written: tmp sibling + fsync + ``os.replace``."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_path(os.path.dirname(os.path.abspath(path)))


def stage_dir(parent: str) -> str:
    """Create and return a fresh ``tmp-<uuid>`` staging directory under
    ``parent``. Stale ones (from a preempted process) are cleaned by
    :func:`sweep_stale_tmp`."""
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"tmp-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    return tmp


def commit_dir(tmp: str, final: str) -> None:
    """Atomically publish a fully-staged directory: fsync its files and
    itself, then one ``os.replace`` rename. ``final`` must not exist (the
    caller's naming scheme — step-numbered checkpoint dirs — guarantees
    uniqueness; overwriting a committed checkpoint is never correct)."""
    for name in sorted(os.listdir(tmp)):
        fsync_path(os.path.join(tmp, name))
    fsync_path(tmp)
    os.replace(tmp, final)
    fsync_path(os.path.dirname(os.path.abspath(final)))


def sweep_stale_tmp(parent: str, prefixes=("tmp-",)) -> int:
    """Remove leftover ``tmp-*`` staging dirs (a preempted process's
    unfinished saves) — and, when asked, ``corrupt-*`` quarantine dirs
    from prior restores. Returns how many were removed. Only call from a
    context that owns ``parent`` exclusively (manager startup), never
    concurrently with an in-flight save."""
    import shutil

    removed = 0
    if not os.path.isdir(parent):
        return 0
    for name in os.listdir(parent):
        if name.startswith(tuple(prefixes)):
            shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
            removed += 1
    return removed


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()
