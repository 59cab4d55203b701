"""Checkpoints with atomic commits, async saves and checksum-verified
restore (counterpart of ``dcnn_tpu/resilience/checkpoint.py``).

``train/checkpoint.py`` defines the format (``model.json`` +
``arrays.msgpack``, the JAX package's own); this module adds the lifecycle:

- **Atomic commit.** A save stages everything under ``tmp-<uuid>/`` inside
  the checkpoint root, writes ``MANIFEST.json`` (per-file SHA-256 and byte
  sizes, step, metadata) last, then publishes with one
  ``os.replace(tmp, ckpt-<step>)``. A crash at any instant leaves either no
  ``ckpt-<step>`` or a complete, checksum-valid one.
- **Async save.** :meth:`CheckpointManager.save_async` takes the snapshot
  on the calling (training) thread: the port's step updates params and
  optimizer state in place, so the arrays are copied (CUDA: queued on the
  current stream into pinned host buffers, with an event) before the next
  step can touch them. The saver thread waits for the event, serializes,
  hashes, writes and commits.
- **Retention.** The ``keep`` newest committed checkpoints survive; older
  ones are removed after each successful commit.
- **Verified restore.** :func:`restore_latest` scans ``ckpt-*`` newest
  first, verifies every file against the manifest, and quarantines a
  torn or bit-flipped one as ``corrupt-*`` (``ckpt_restore_skipped_total``)
  before going on to the next.

Trip points (``resilience/faults.py``): ``ckpt.write`` (mid-stage, files
partial), ``ckpt.before_rename`` (staged, not committed),
``ckpt.after_rename`` (committed, retention not yet run). The JAX
package's ``checkpoint.*`` tracer spans wait for the tracer's port.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import uuid
import warnings
from concurrent.futures import Future
from typing import Any, Callable, Dict, NamedTuple, Optional

from ..core.device import DeviceLike
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from . import faults
from .atomic import commit_dir, sha256_file, stage_dir, sweep_stale_tmp

_MANIFEST = "MANIFEST.json"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")


def _ckpt_name(step: int) -> str:
    return f"ckpt-{step:08d}"


def _default_write(path: str, data: bytes) -> None:
    # plain write inside a tmp-<uuid> staging dir — commit_dir (the
    # caller's publish point) fsyncs and os.replace's the whole directory,
    # so per-file atomicity here would be redundant work
    with open(path, "wb") as f:  # dcnn: disable=AT01
        f.write(data)


class RestoredCheckpoint(NamedTuple):
    """A restored checkpoint: the model (which holds params and batchnorm
    statistics) on the device asked for, the optimizer state, the
    optimizer, the metadata, the step and the directory."""
    model: Any
    opt_state: Any
    optimizer: Any
    metadata: Dict[str, Any]
    step: int
    path: str


def verify_dir(path: str) -> bool:
    """True iff ``path`` holds a complete checkpoint whose files match its
    manifest's SHA-256 sums. Cheap checks (existence, size) run first.
    Picks the newest valid checkpoint without loading anything."""
    mpath = os.path.join(path, _MANIFEST)
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError):
        return False
    for name, info in files.items():
        fpath = os.path.join(path, name)
        try:
            if os.path.getsize(fpath) != info["bytes"]:
                return False
            if sha256_file(fpath) != info["sha256"]:
                return False
        except (OSError, KeyError):
            return False
    return True


def list_steps(directory: str) -> Dict[int, str]:
    """Committed checkpoint steps under ``directory`` → absolute path.
    Presence only; validity is :func:`verify_dir`'s job."""
    out: Dict[int, str] = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            out[int(m.group(1))] = os.path.join(directory, name)
    return out


def restore_latest(directory: str, *, device: DeviceLike = None,
                   registry=None) -> Optional[RestoredCheckpoint]:
    """Load the newest checksum-valid checkpoint under ``directory`` onto
    ``device`` (CUDA unless ``"cpu"``), skipping torn/corrupt candidates
    (each skip increments ``ckpt_restore_skipped_total`` and warns).
    Returns ``None`` when no valid checkpoint exists — callers decide
    whether that means "cold start" (``resume='auto'``) or an error."""
    from ..train.checkpoint import load_checkpoint

    reg = registry if registry is not None else get_registry()
    steps = sorted(list_steps(directory).items(), reverse=True)
    tracer = get_tracer()
    for step, path in steps:
        with tracer.span("checkpoint.restore", track="ckpt", step=step):
            if not verify_dir(path):
                # quarantine, don't just skip: a resumed run will want to
                # commit this step number again, and an immutable corrupt
                # dir squatting on it would turn recovery into
                # FileExistsError. The bytes survive (renamed) for
                # forensics; corrupt-* never matches list_steps.
                quarantine = os.path.join(
                    directory,
                    f"corrupt-{os.path.basename(path)}-{uuid.uuid4().hex}")
                try:
                    os.replace(path, quarantine)
                    where = f"quarantined as {quarantine}"
                except OSError:
                    where = "left in place (rename failed)"
                warnings.warn(
                    f"skipping torn/corrupt checkpoint {path} "
                    f"(manifest/checksum mismatch); {where}", stacklevel=2)
                reg.counter("ckpt_restore_skipped_total",
                            "corrupt checkpoints skipped on restore").inc()
                continue
            model, opt_state, optimizer, metadata = load_checkpoint(
                path, device=device)
            reg.counter("ckpt_restores_total",
                        "successful checkpoint restores").inc()
            return RestoredCheckpoint(model, opt_state, optimizer, metadata,
                                      step, path)
    return None


class CheckpointManager:
    """Owns one checkpoint root directory: atomic saves (sync or async),
    keep-last-K retention, verified restore.

    ``io_write(path, data)`` is injectable so tests can model a slow or
    crashing filesystem without touching real disk timing; ``clock`` feeds
    the save-duration histogram.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 io_write: Callable[[str, bytes], None] = _default_write,
                 clock: Callable[[], float] = time.perf_counter,
                 registry=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        self._io_write = io_write
        self._clock = clock
        self._reg = registry if registry is not None else get_registry()
        os.makedirs(directory, exist_ok=True)
        # stale tmp-* dirs are a previous (preempted) process's unfinished
        # saves; corrupt-* dirs are checksum-failed quarantines from prior
        # restores — committed ckpt-* dirs are never touched here
        sweep_stale_tmp(directory, prefixes=("tmp-", "corrupt-"))
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pending: list = []  # async-save futures not yet inspected
        self._last_failure: Optional[BaseException] = None  # health() latch
        # pinned host buffers for two snapshots in flight, reused
        from ..train.checkpoint import PinnedPool
        self.pinned = PinnedPool(2)

    # -- serialization (format owned by train/checkpoint.py) --
    def _snapshot(self, model, opt_state, optimizer, metadata) -> tuple:
        """What a save needs, taken on the calling (training) thread: the
        manifest (metadata frozen by a JSON round trip: the trainer keeps
        appending to its history while the saver thread serializes) and a
        :class:`~dcnn_tpu_torch.train.checkpoint.HostSnapshot` of the
        arrays, whose copies are queued on the current stream before the
        next step can update anything in place, into a set of
        :attr:`pinned`'s buffers: two snapshots in flight reuse their
        pinned memory, and a third waits for the saver to release one
        rather than pin more."""
        from ..train.checkpoint import HostSnapshot, checkpoint_manifest

        manifest = checkpoint_manifest(model, optimizer, metadata,
                                       opt_state is not None)
        return manifest, HostSnapshot(model, opt_state, pool=self.pinned)

    def _write_and_commit(self, step: int, model_manifest: dict,
                          snapshot) -> str:
        from ..train import _msgpack

        t0 = self._clock()
        final = os.path.join(self.directory, _ckpt_name(step))
        if os.path.exists(final):
            raise FileExistsError(
                f"checkpoint for step {step} already exists at {final}; "
                f"committed checkpoints are immutable")
        tmp = stage_dir(self.directory)
        try:
            model_bytes = json.dumps(model_manifest, indent=2).encode("utf-8")
            self._io_write(os.path.join(tmp, "model.json"), model_bytes)
            faults.trip("ckpt.write", step=step)
            array_bytes = _msgpack.to_bytes(snapshot.tree())
            # the bytes are serialized: the host copies can go back to the
            # allocator before the hashing and writes, so a save that comes
            # meanwhile reuses them instead of pinning memory afresh
            snapshot.release()
            self._io_write(os.path.join(tmp, "arrays.msgpack"), array_bytes)
            manifest = {
                "format": 1,
                "step": step,
                "metadata": model_manifest.get("metadata", {}),
                "files": {
                    "model.json": {
                        "sha256": sha256_file(os.path.join(tmp, "model.json")),
                        "bytes": len(model_bytes)},
                    "arrays.msgpack": {
                        "sha256": sha256_file(
                            os.path.join(tmp, "arrays.msgpack")),
                        "bytes": len(array_bytes)},
                },
            }
            self._io_write(os.path.join(tmp, _MANIFEST),
                           json.dumps(manifest, indent=2).encode("utf-8"))
            faults.trip("ckpt.before_rename", step=step)
            commit_dir(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        faults.trip("ckpt.after_rename", step=step)
        self._reg.counter("ckpt_saves_total", "committed checkpoints").inc()
        self._reg.gauge("ckpt_last_step", "last committed step").set(step)
        self._reg.histogram("ckpt_save_seconds",
                            "serialize+write+commit wall").observe(
            max(self._clock() - t0, 0.0))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(list_steps(self.directory).items(), reverse=True)
        for step, path in steps[self.keep:]:
            shutil.rmtree(path, ignore_errors=True)
            self._reg.counter("ckpt_gc_removed_total",
                              "checkpoints removed by retention").inc()

    # -- sync save --
    def save(self, step: int, model, opt_state=None, optimizer=None,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Atomic synchronous save; returns the committed directory."""
        with get_tracer().span("checkpoint.save", track="ckpt", step=step,
                               mode="sync"):
            manifest, snapshot = self._snapshot(model, opt_state, optimizer,
                                                metadata)
            try:
                with self._lock:
                    return self._write_and_commit(step, manifest, snapshot)
            finally:
                snapshot.release()

    # -- async save --
    def _saver_loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            self._run_job(*job)
            del job  # not held while the loop waits for the next one

    def _run_job(self, step, manifest, snapshot, fut: Future) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        if step is None:  # wait() barrier marker: everything before it ran
            fut.set_result(None)
            return
        try:
            with get_tracer().span("checkpoint.save", track="ckpt",
                                   step=step, mode="async"):
                with self._lock:
                    path = self._write_and_commit(step, manifest, snapshot)
            fut.set_result(path)
        except BaseException as e:  # surfaced via the future / wait()
            fut.set_exception(e)
        finally:
            snapshot.release()  # a failed save gives its buffers back too

    def save_async(self, step: int, model, opt_state=None, optimizer=None,
                   metadata: Optional[Dict[str, Any]] = None) -> Future:
        """Non-blocking save: the snapshot's copies are queued here (the
        training thread's only cost); the wait for them, serialization,
        hashing, writes and the commit run on the saver thread. Returns a
        Future resolving to the committed path."""
        with get_tracer().span("checkpoint.snapshot", track="ckpt",
                               step=step):
            manifest, snapshot = self._snapshot(model, opt_state, optimizer,
                                                metadata)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._saver_loop, daemon=True, name="dcnn-ckpt-saver")
            self._thread.start()
        fut: Future = Future()
        self._pending.append(fut)
        self._q.put((step, manifest, snapshot, fut))
        return fut

    def check(self) -> None:
        """Non-blocking failure probe: re-raises the first *completed*
        async save's exception, dropping inspected futures. Call once per
        save cadence (the Trainer does, each checkpoint epoch) so a run
        that believes it is preemption-safe learns its saves are failing
        at the SECOND checkpoint, not after the last epoch."""
        still_pending = []
        first_exc = None
        for f in self._pending:
            if not f.done():
                still_pending.append(f)
                continue
            exc = f.exception()
            if exc is not None and first_exc is None:
                first_exc = exc
        self._pending = still_pending
        if first_exc is not None:
            self._last_failure = first_exc
            raise first_exc

    def health(self) -> Optional[BaseException]:
        """NON-consuming failure probe for health endpoints: the first
        known save failure (latched — once a save has failed this manager
        reports unhealthy until the process decides otherwise), or
        ``None``. Unlike :meth:`check` it never drops pending futures and
        never raises, so a ``/healthz`` scrape can poll it at any cadence
        WITHOUT disarming the trainer's own per-cadence ``check()``
        fail-fast."""
        if self._last_failure is None:
            for f in self._pending:
                if f.done():
                    exc = f.exception()
                    if exc is not None:
                        self._last_failure = exc
                        break
        return self._last_failure

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every queued async save has committed. Re-raises the
        first failed save's exception. Call before process exit (and the
        Trainer does, at the end of ``fit``) — an abandoned queue is a
        silently missing checkpoint."""
        if self._thread is None or not self._thread.is_alive():
            return
        # a barrier marker rides the same queue: once its future resolves,
        # every job enqueued before it has fully run (single saver thread,
        # FIFO queue)
        fut: Future = Future()
        self._q.put((None, None, None, fut))
        fut.result(timeout=timeout)
        pending, self._pending = self._pending, []
        for f in pending:
            exc = f.exception()
            if exc is not None:
                raise exc

    def restore_latest(self, *, device: DeviceLike = None
                       ) -> Optional[RestoredCheckpoint]:
        return restore_latest(self.directory, device=device,
                              registry=self._reg)

    def latest_step(self) -> Optional[int]:
        steps = list_steps(self.directory)
        return max(steps) if steps else None

    def close(self) -> None:
        """Stop the saver thread after draining queued saves."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=60.0)
        self._thread = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
