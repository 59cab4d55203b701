"""Versioned model hot-swap: checkpoint watching, canary rollout,
auto-promote, instant rollback (counterpart of ``dcnn_tpu/serve/swap.py``).

The training side already gives serving everything it needs for safe
version changes: ``CheckpointManager`` commits are atomic directories
with checksum-verified manifests, so "the newest version" is a
well-defined, corruption-proof question. This module closes the loop:

- :func:`newest_valid_version` — the newest **checksum-valid** committed
  step under a checkpoint root. A torn/bit-flipped newest commit is
  skipped to the previous valid one (warned + counted on
  ``serve_swap_versions_skipped_total``) and — unlike the training-side
  ``restore_latest`` — **never quarantined or renamed**: the serving
  tier is a read-only consumer of the training run's directory.
- :class:`EngineFactory` — ``factory(version) -> InferenceEngine`` over
  a checkpoint root with the deployment transforms (fold / int8 calib)
  fixed at construction, so every replica of a fleet builds *the same
  graph* for a given version. The ``serve.swap`` fault point fires in
  the load path. Its keyword arguments forward to
  :meth:`~dcnn_tpu_torch.serve.engine.InferenceEngine.from_checkpoint`,
  ``device`` among them (the card unless ``device="cpu"``), where the JAX
  factory forwards ``seed``.
- :class:`ModelVersionManager` — the control loop over a
  :class:`~dcnn_tpu_torch.serve.router.Router`:

  1. **Watch**: each :meth:`poll` discovers the newest valid version.
  2. **Canary**: a new version rolls out to ``ceil(canary_fraction·N)``
     replicas via drain → load → rejoin (``Router.swap_replica``); the
     rest keep serving the old version, so traffic is mixed-version with
     zero shed increase (capacity only dips by the replica being
     drained, which admission sees).
  3. **Judge**: per-replica completion/failure/latency deltas since
     canary start (``Router.replica_stats``). An error-rate or latency
     regression against the stable set triggers **instant rollback** —
     canaries are swapped back and the version is quarantined (never
     auto-retried). A clean observation window
     (``observe_s`` on the injectable clock, ``min_canary_requests``
     completions) **auto-promotes**: the remaining replicas swap up.

  Everything is driven by explicit :meth:`poll` calls — sleep-free under
  a fake clock in tests; production wires :meth:`start` (a daemon poll
  thread with a ``stop()`` owner, or calls ``poll()`` from any existing
  control loop).
"""

from __future__ import annotations

import math
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import get_registry
from ..resilience import faults as _faults
from ..resilience.checkpoint import list_steps, verify_dir
from .replica import SwapError


class NoValidVersionError(RuntimeError):
    """No checksum-valid committed checkpoint exists under the root."""


def newest_valid_version(directory: str, *, registry=None
                         ) -> Optional[Tuple[int, str]]:
    """``(step, path)`` of the newest checksum-valid ``ckpt-*`` commit
    under ``directory``, or ``None`` when no valid one exists. Corrupt
    newer candidates are skipped (warned, counted) but never touched on
    disk — read-only by contract."""
    reg = registry if registry is not None else get_registry()
    for step, path in sorted(list_steps(directory).items(), reverse=True):
        if verify_dir(path):
            return step, path
        warnings.warn(
            f"serve/swap: skipping torn/corrupt checkpoint {path} "
            f"(manifest/checksum mismatch); falling back to the previous "
            f"valid version", stacklevel=2)
        reg.counter("serve_swap_versions_skipped_total",
                    "corrupt checkpoint versions skipped by the serving "
                    "tier").inc()
    return None


class EngineFactory:
    """``factory(version) -> InferenceEngine`` over one checkpoint root.

    The deployment transforms are fixed here — every replica built from
    this factory serves the identical graph for a given version (the
    int8 calibration batch included, so the cross-bucket bit-identity
    contract holds fleet-wide; a replica in another process builds its
    factory from the very same array). ``engine_kwargs`` forward to
    :meth:`InferenceEngine.from_checkpoint` (``device``, ``max_batch``,
    ``fold``, ``int8_calib``, ...)."""

    def __init__(self, directory: str, *, registry=None, **engine_kwargs):
        self.directory = directory
        self._registry = registry
        self._kw = engine_kwargs

    def newest(self) -> Optional[int]:
        """Newest checksum-valid version (step), or ``None``."""
        found = newest_valid_version(self.directory,
                                     registry=self._registry)
        return found[0] if found else None

    def __call__(self, version: int):
        from .engine import InferenceEngine

        _faults.trip("serve.swap", version=version,
                     directory=self.directory)
        path = os.path.join(self.directory, f"ckpt-{int(version):08d}")
        if not verify_dir(path):
            raise NoValidVersionError(
                f"version {version} at {path} is missing or fails its "
                f"manifest checksums")
        kw = dict(self._kw)
        kw.setdefault("name", f"v{int(version)}")
        eng = InferenceEngine.from_checkpoint(path, **kw)
        eng.version = int(version)
        return eng


class ModelVersionManager:
    """Canary rollout / auto-promote / instant rollback over a router.

    ``factory`` is typically an :class:`EngineFactory` (its ``newest()``
    is the version watch); any object with ``newest() -> version`` works
    — the actual loading happens inside each replica's own factory via
    ``Router.swap_replica``. Judgement thresholds:

    - ``max_error_delta`` — rollback when the canary set's failure ratio
      since canary start exceeds the stable set's by more than this;
    - ``max_latency_ratio`` — rollback when the canary set's mean
      completion-latency EWMA exceeds ``max_latency_ratio ×`` the stable
      set's (an EWMA verdict, deliberately named so — windowed p99 is on
      the per-replica scrape surface but is not what this judges; both
      sides need
      ``min_canary_requests`` completions first — latency noise on three
      requests must not roll a good version back).
    """

    def __init__(self, router, factory, *, canary_fraction: float = 0.25,
                 observe_s: float = 30.0, min_canary_requests: int = 20,
                 min_error_samples: int = 5,
                 max_error_delta: float = 0.02,
                 max_latency_ratio: float = 3.0,
                 current_version: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 flight=None):
        if not 0.0 < canary_fraction <= 1.0:
            raise ValueError(f"canary_fraction must be in (0, 1], "
                             f"got {canary_fraction}")
        self._flight = flight  # None: process-global flight recorder
        self.router = router
        self.factory = factory
        self.canary_fraction = canary_fraction
        self.observe_s = observe_s
        self.min_canary_requests = min_canary_requests
        # floor for the error-ratio rollback: one transient failure on a
        # canary's very first request (the same class the router happily
        # re-admits) must not permanently quarantine a good version
        self.min_error_samples = min_error_samples
        self.max_error_delta = max_error_delta
        self.max_latency_ratio = max_latency_ratio
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "idle"                 # dcnn: guarded_by=_lock
        self._current = current_version      # dcnn: guarded_by=_lock
        self._target: Optional[int] = None   # dcnn: guarded_by=_lock
        self._canaries: List[str] = []       # dcnn: guarded_by=_lock
        self._pre_versions: Dict[str, Any] = {}  # dcnn: guarded_by=_lock
        self._t_canary: float = 0.0          # dcnn: guarded_by=_lock
        self._base: Dict[str, Dict] = {}     # dcnn: guarded_by=_lock
        self._quarantined: set = set()       # dcnn: guarded_by=_lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if current_version is None:
            # adopt the fleet's version (first replica that knows one)
            for st in router.replica_stats().values():
                if st["version"] is not None:
                    with self._lock:
                        self._current = st["version"]
                    break
        self._export_gauges()

    # -- introspection -----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def current_version(self):
        with self._lock:
            return self._current

    @property
    def target_version(self):
        with self._lock:
            return self._target

    @property
    def canaries(self) -> List[str]:
        with self._lock:
            return list(self._canaries)

    @property
    def quarantined(self) -> set:
        with self._lock:
            return set(self._quarantined)

    def _export_gauges(self) -> None:
        with self._lock:
            cur = self._current
        if cur is not None:
            self.router.metrics.version.set(cur)

    # -- the control loop --------------------------------------------------
    def poll(self) -> Dict[str, Any]:
        """One state-machine turn. Returns
        ``{"action": ..., "version": ..., "canaries": [...]}`` where
        action ∈ ``none | canary | canary_wait | promoted | rolled_back |
        swap_failed``."""
        self.router.check_replicas()  # judge on fresh liveness
        with self._lock:
            state = self._state
        if state == "idle":
            return self._poll_idle()
        return self._poll_canary()

    def _poll_idle(self) -> Dict[str, Any]:
        newest = self.factory.newest()
        with self._lock:
            cur, quarantined = self._current, set(self._quarantined)
        if newest is None or newest in quarantined \
                or (cur is not None and newest <= cur):
            healed = self._reconcile(cur)
            out = {"action": "none", "version": cur, "canaries": []}
            if healed:
                out["action"] = "reconciled"
                out["reconciled"] = healed
            return out
        return self._begin_canary(newest)

    def _reconcile(self, cur) -> List[str]:
        """Heal version drift: a replica that was dead through a promote
        (it rejoins serving the pre-promote version) or whose
        promote-time swap failed is swapped up to ``cur`` here — the idle
        watch converges the fleet instead of serving mixed versions
        forever. Failures stay visible via the swap_failures counter and
        are retried next poll."""
        if cur is None:
            return []
        healed: List[str] = []
        for name, st in self.router.replica_stats().items():
            if st["state"] == "up" and st["version"] is not None \
                    and st["version"] != cur:
                try:
                    self.router.swap_replica(name, cur, canary=False)
                    healed.append(name)
                except Exception:
                    pass
        return healed

    def _begin_canary(self, version: int) -> Dict[str, Any]:
        stats = self.router.replica_stats()
        up = sorted(n for n, st in stats.items() if st["state"] == "up")
        if not up:
            return {"action": "none", "version": self.current_version,
                    "canaries": [], "reason": "no routable replicas"}
        k = max(1, math.ceil(self.canary_fraction * len(up)))
        k = min(k, len(up))
        # remember each canary's OWN pre-canary version: rollback returns
        # a replica to what IT was serving, which works even when the
        # manager never learned a fleet-wide current version
        pre = {name: stats[name]["version"] for name in up[:k]}
        canaries: List[str] = []
        version_failed: Optional[SwapError] = None
        for name in up[:k]:
            try:
                self.router.swap_replica(name, version, canary=True)
                canaries.append(name)
            except SwapError as e:
                # the VERSION failed to load — a version verdict
                version_failed = e
                break
            except Exception:
                # the REPLICA failed (died between the snapshot and the
                # swap) — not the version's fault: skip it, don't
                # quarantine; the liveness sweep owns the replica
                continue
        if version_failed is not None:
            # the version cannot even load — quarantine it now and undo
            # any canary that did come up
            for name in canaries:
                old = pre.get(name)
                try:
                    if old is not None:
                        self.router.swap_replica(name, old, canary=False)
                    else:
                        self.router.set_canary(name, False)
                except Exception:
                    self.router.set_canary(name, False)
            with self._lock:
                self._quarantined.add(version)
            return {"action": "swap_failed", "version": version,
                    "canaries": canaries, "reason": str(version_failed)}
        if not canaries:
            # only replica failures — retry the rollout on a later poll
            return {"action": "none", "version": self.current_version,
                    "canaries": [],
                    "reason": "no canary could be started (replica "
                              "failures, version not judged)"}
        with self._lock:
            self._state = "canary"
            self._target = version
            self._canaries = canaries
            self._pre_versions = {n: pre.get(n) for n in canaries}
            self._t_canary = self._clock()
            self._base = {n: dict(st) for n, st in
                          self.router.replica_stats().items()}
        self.router.metrics.registry.gauge(
            "serve_router_target_version",
            "version under canary").set(version)
        return {"action": "canary", "version": version,
                "canaries": list(canaries)}

    def _deltas(self) -> Tuple[Dict[str, int], Dict[str, int],
                               Optional[float], Optional[float]]:
        """(canary {completed, failed}, stable {completed, failed},
        canary ewma_ms, stable ewma_ms) since canary start."""
        stats = self.router.replica_stats()
        with self._lock:
            base, canaries = self._base, set(self._canaries)
        cd = {"completed": 0, "failed": 0}
        sd = {"completed": 0, "failed": 0}
        c_lat: List[float] = []
        s_lat: List[float] = []
        for name, st in stats.items():
            b = base.get(name, {"completed": 0, "failed": 0})
            d = (cd if name in canaries else sd)
            d["completed"] += st["completed"] - b["completed"]
            d["failed"] += st["failed"] - b["failed"]
            if st["ewma_ms"] is not None:
                (c_lat if name in canaries else s_lat).append(st["ewma_ms"])
        c_ewma = (sum(c_lat) / len(c_lat)) if c_lat else None
        s_ewma = (sum(s_lat) / len(s_lat)) if s_lat else None
        return cd, sd, c_ewma, s_ewma

    @staticmethod
    def _ratio(d: Dict[str, int]) -> Optional[float]:
        n = d["completed"] + d["failed"]
        return (d["failed"] / n) if n else None

    def _poll_canary(self) -> Dict[str, Any]:
        cd, sd, c_ewma, s_ewma = self._deltas()
        with self._lock:
            version, canaries = self._target, list(self._canaries)
            elapsed = self._clock() - self._t_canary
        c_ratio, s_ratio = self._ratio(cd), self._ratio(sd)
        # -- instant rollback: error-rate regression -----------------------
        # two floors against small-sample noise: enough total samples AND
        # at least two failures — one transiently-failed (and re-admitted)
        # request is never a version verdict
        if c_ratio is not None and cd["failed"] >= 2 \
                and cd["completed"] + cd["failed"] >= self.min_error_samples \
                and c_ratio > (s_ratio or 0.0) + self.max_error_delta:
            return self._rollback(
                f"canary error ratio {c_ratio:.3f} vs stable "
                f"{(s_ratio or 0.0):.3f} (+{self.max_error_delta:g} "
                f"allowed)")
        # -- instant rollback: latency regression --------------------------
        enough = (cd["completed"] >= self.min_canary_requests
                  and sd["completed"] >= self.min_canary_requests)
        if enough and c_ewma is not None and s_ewma is not None \
                and s_ewma > 0 and c_ewma > self.max_latency_ratio * s_ewma:
            return self._rollback(
                f"canary latency {c_ewma:.2f}ms vs stable "
                f"{s_ewma:.2f}ms (> {self.max_latency_ratio:g}x)")
        # -- promote on a clean window -------------------------------------
        if elapsed >= self.observe_s \
                and cd["completed"] >= self.min_canary_requests:
            return self._promote()
        return {"action": "canary_wait", "version": version,
                "canaries": canaries, "elapsed_s": elapsed,
                "canary": cd, "stable": sd}

    def _rollback(self, reason: str) -> Dict[str, Any]:
        with self._lock:
            version, canaries = self._target, list(self._canaries)
            old = self._current
            pre = dict(self._pre_versions)
        for name in canaries:
            # prefer the replica's OWN pre-canary version (defined even
            # when the manager never learned a fleet-wide current one)
            target = pre.get(name) if pre.get(name) is not None else old
            try:
                if target is not None:
                    self.router.swap_replica(name, target, canary=False)
                else:
                    self.router.set_canary(name, False)
            except Exception:
                # a canary that cannot even reload the old version is a
                # replica problem, not a version problem — the liveness
                # sweep owns it from here
                self.router.set_canary(name, False)
        with self._lock:
            self._quarantined.add(version)
            quarantined = sorted(map(repr, self._quarantined))
            self._state = "idle"
            self._target = None
            self._canaries = []
            self._pre_versions = {}
            self._base = {}
        self.router.metrics.record_rollback()
        self._export_gauges()
        # postmortem bundle at the rollback edge: the judged deltas in
        # `reason`, the quarantined version, and the spans/metrics of the
        # canary window (no-op while the flight recorder is disabled)
        from ..obs.flight import resolve_flight_recorder
        resolve_flight_recorder(self._flight).record(
            "canary_rollback", reasons=[reason],
            registry=self.router.metrics.registry,
            config={"version": version, "canaries": canaries,
                    "pre_versions": {k: repr(v) for k, v in pre.items()},
                    "quarantined": quarantined})
        return {"action": "rolled_back", "version": version,
                "canaries": canaries, "reason": reason}

    def _promote(self) -> Dict[str, Any]:
        with self._lock:
            version, canaries = self._target, set(self._canaries)
        stats = self.router.replica_stats()
        rest = sorted(n for n, st in stats.items()
                      if st["state"] == "up" and n not in canaries
                      and st["version"] != version)
        failed: List[str] = []
        for name in rest:
            try:
                self.router.swap_replica(name, version, canary=False)
            except Exception:
                failed.append(name)  # SwapError: rejoined on the old
                # version; death mid-promote: the sweep owns it — either
                # way the idle watch's _reconcile converges it later
        for name in canaries:
            self.router.set_canary(name, False)
        with self._lock:
            self._current = version
            self._state = "idle"
            self._target = None
            self._canaries = []
            self._pre_versions = {}
            self._base = {}
        self.router.metrics.record_promotion()
        self._export_gauges()
        return {"action": "promoted", "version": version,
                "canaries": sorted(canaries), "swap_failed": failed}

    # -- background polling (production convenience) -----------------------
    def start(self, interval_s: float = 5.0) -> "ModelVersionManager":
        """Poll on a daemon thread every ``interval_s``; idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, args=(interval_s,), daemon=True,
            name="dcnn-version-manager")
        self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.poll()
            except Exception:
                pass  # a broken poll must not kill the watch loop;
                # verdicts surface via counters/healthz, not this thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self) -> None:
        self.stop()

    def __enter__(self) -> "ModelVersionManager":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        with self._lock:
            return (f"ModelVersionManager(state={self._state!r}, "
                    f"current={self._current!r}, target={self._target!r})")
