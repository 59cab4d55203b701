"""Anomaly-triggered capture (counterpart of ``dcnn_tpu/obs/anomaly.py``):
the run that regresses collects its own postmortem evidence.

Two trigger classes, one capture path:

- **step-time band breach**: :class:`EwmaBand` keeps an EWMA mean and
  variance of the per-step wall time; a sample above
  ``mean + band·std`` (and above ``mean·(1 + min_rel)``, so a
  microsecond-noise band cannot trip) opens a *breach episode*.
- **bottleneck flip**: the :class:`~dcnn_tpu_torch.obs.goodput
  .BottleneckClassifier` changing state (wired through
  :class:`~dcnn_tpu_torch.obs.goodput.GoodputMonitor`).

Each episode fires **exactly one** bounded capture: a flight-recorder
bundle (:mod:`~dcnn_tpu_torch.obs.flight`) tagged with the ledger
snapshot, plus a ``torch.profiler`` capture opened through the
non-raising :func:`~dcnn_tpu_torch.train.profiling.try_trace` (so an
operator's own trace always wins; the anomaly path just counts the miss)
and closed after ``profile_steps`` further steps. The episode ends only
after ``recover_samples`` consecutive in-band steps; a permanent
regression therefore captures once, not once per window. Breached samples
do not feed the EWMA: the band must not learn the anomaly.

Expected stalls (an elastic reconfiguration re-sharding the world) are
fenced with the process-global :func:`suppress` context manager: samples
observed under it neither feed the band nor open episodes.

Departures from the JAX monitor, so that a capture does not perturb
what it watches into a second capture. A flip is seen on the sampler's
thread, so its capture's profiler opens on the training thread, at the
next step it observes (``torch.profiler`` records the CPU ops of the
thread that starts it, and the capture's span closes on the thread that
opened it). The capture is quarantined: a step sample taken while the
monitor's own profiler capture is open, the first one after a flip's
bundle was written beside the step and the first one after the capture
closes (its trace export stalls the loop and idles the card) are dropped
like suppressed ones, and :meth:`AnomalyMonitor.quiet_for` tells the
goodput monitor not to classify a window that overlaps the capture (the
export's stall, and a first profiler start's CUPTI set-up of seconds,
would read as unattributed time and flip the verdict).

Everything is injectable (clock, detector, profiler, flight recorder) so
the tests run sleep-free. Standard library only at import time.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from .registry import MetricsRegistry, get_registry

_suppress_lock = threading.Lock()
_suppress_depth = 0


@contextlib.contextmanager
def suppress() -> Iterator[None]:
    """Fence an expected stall (reconfigure, planned checkpoint storm):
    step samples observed inside the block are dropped — they neither
    update the EWMA band nor trigger captures. Re-entrant and
    cross-thread (the depth is process-global: the stall is a property
    of the process, not of the observing thread)."""
    global _suppress_depth
    with _suppress_lock:
        _suppress_depth += 1
    try:
        yield
    finally:
        with _suppress_lock:
            _suppress_depth -= 1


def is_suppressed() -> bool:
    with _suppress_lock:
        return _suppress_depth > 0


class EwmaBand:
    """EWMA mean/std band over a scalar stream.

    :meth:`observe` returns True when the sample breaches the band that
    existed *before* the sample — and only in-band samples update the
    state, so a sustained regression cannot drag the band up and
    silently end its own episode. The first ``warmup`` samples always
    update and never breach."""

    def __init__(self, *, alpha: float = 0.2, band: float = 3.0,
                 min_rel: float = 0.5, warmup: int = 8):
        self.alpha = float(alpha)
        self.band = float(band)
        self.min_rel = float(min_rel)
        self.warmup = int(warmup)
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0

    @property
    def mean(self) -> Optional[float]:
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(0.0, self._var))

    def threshold(self) -> Optional[float]:
        """Current breach threshold, or None during warmup."""
        if self._mean is None or self._n < self.warmup:
            return None
        return max(self._mean + self.band * self.std,
                   self._mean * (1.0 + self.min_rel))

    def observe(self, x: float) -> bool:
        x = float(x)
        thr = self.threshold()
        breach = thr is not None and x > thr
        if not breach:
            if self._mean is None:
                self._mean = x
            else:
                d = x - self._mean
                self._mean += self.alpha * d
                self._var = (1.0 - self.alpha) * (self._var
                                                  + self.alpha * d * d)
            self._n += 1
        return breach


def _default_profiler(log_dir: Optional[str]):
    """Lazy bridge to ``train.profiling.try_trace``, imported only when a
    capture fires, so that this module imports no torch."""
    from ..train.profiling import try_trace
    return try_trace(log_dir) if log_dir else None


class AnomalyMonitor:
    """Exactly-one-capture-per-episode state machine.

    ``profiler`` is a callable ``(log_dir) -> context manager | None``
    (default: :func:`try_trace`); ``flight`` defaults to the process
    flight recorder. Counters: ``goodput_anomaly_episodes_total`` (one
    per opened episode, labeled by construction via the trigger reason
    inside the bundle), ``goodput_captures_total`` (bundles actually
    written), ``goodput_capture_profile_skipped_total`` (a capture that
    wanted a profiler capture but one was already active)."""

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[Any] = None,
                 detector: Optional[EwmaBand] = None,
                 profiler: Optional[Callable[[Optional[str]], Any]] = None,
                 profile_dir: Optional[str] = None,
                 profile_steps: int = 8,
                 recover_samples: int = 4,
                 flip_captures: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self._registry = (registry if registry is not None
                          else get_registry())
        self._flight = flight
        self.detector = detector if detector is not None else EwmaBand()
        self._profiler = (profiler if profiler is not None
                          else _default_profiler)
        self.profile_dir = profile_dir
        self.profile_steps = max(1, int(profile_steps))
        self.recover_samples = max(1, int(recover_samples))
        self.flip_captures = bool(flip_captures)
        self._lock = threading.Lock()
        self._in_episode = False
        self._ok_streak = 0
        self._episodes = 0
        self._captures = 0
        self._profile_cm: Optional[Any] = None
        self._profile_path: Optional[str] = None
        self._profile_left = 0
        # a flip's profiler capture, opened at the next observed step
        self._profile_pending = False
        # the capture perturbed the next step sample: drop it
        self._drop_next = False
        # when the last capture ended (bundle written, profile closed)
        self._clock = clock
        self._capture_end: Optional[float] = None
        self._last_bundle: Optional[str] = None

    def _resolve_flight(self):
        if self._flight is not None:
            return self._flight
        from .flight import get_flight_recorder
        return get_flight_recorder()

    def observe_step(self, dt_s: float, *,
                     ledger_doc: Optional[Dict[str, Any]] = None) -> bool:
        """Feed one step wall time; returns True when this sample opened
        an episode (and fired its one capture)."""
        if is_suppressed():
            return False
        with self._lock:
            perturbed = self._profile_cm is not None or self._drop_next
            self._drop_next = False
            self._tick_profile_locked()
            if self._profile_pending:
                self._profile_pending = False
                self._open_profile_locked()
            if perturbed:
                return False
            breach = self.detector.observe(dt_s)
            if breach:
                self._ok_streak = 0
                if self._in_episode:
                    return False
                self._in_episode = True
                self._episodes += 1
                self._registry.counter(
                    "goodput_anomaly_episodes_total",
                    "anomaly episodes opened (band breach or verdict "
                    "flip)").inc()
                self._capture_locked("step_time_breach", ledger_doc,
                                     dt_s=float(dt_s),
                                     threshold=self.detector.threshold())
                return True
            if self._in_episode:
                self._ok_streak += 1
                if self._ok_streak >= self.recover_samples:
                    self._in_episode = False
                    self._ok_streak = 0
            return False

    def on_classification_flip(self, old: str, new: str, *,
                               ledger_doc: Optional[Dict[str, Any]] = None
                               ) -> None:
        """Bottleneck verdict changed — one capture per flip edge (the
        classifier's own hysteresis is the episode boundary here)."""
        if not self.flip_captures or is_suppressed():
            return
        with self._lock:
            self._episodes += 1
            self._registry.counter(
                "goodput_anomaly_episodes_total",
                "anomaly episodes opened (band breach or verdict "
                "flip)").inc()
            self._capture_locked("bottleneck_flip", ledger_doc,
                                 defer_profile=True,
                                 transition=f"{old}->{new}")
            self._drop_next = True

    def _capture_locked(self, kind: str,
                        ledger_doc: Optional[Dict[str, Any]],
                        defer_profile: bool = False,
                        **detail: Any) -> None:
        extra: Dict[str, Any] = {"trigger_kind": kind, "detail": detail}
        if ledger_doc is not None:
            extra["ledger"] = ledger_doc
        try:
            flight = self._resolve_flight()
            path = flight.record("goodput_anomaly",
                                 reasons=[f"goodput anomaly: {kind}"],
                                 extra=extra, registry=self._registry)
        except Exception:  # pragma: no cover - flight never raises, belt
            path = None
        if path is not None:
            self._last_bundle = path
            self._captures += 1
            self._registry.counter(
                "goodput_captures_total",
                "anomaly flight bundles written").inc()
        self._capture_end = self._clock()
        if self._profile_cm is not None or self._profile_pending:
            self._count_profile_skipped()
        elif defer_profile:
            self._profile_pending = True
        else:
            self._open_profile_locked()

    def _count_profile_skipped(self) -> None:
        self._registry.counter(
            "goodput_capture_profile_skipped_total",
            "anomaly captures that could not open a profiler capture "
            "(one already active or profiling unavailable)").inc()

    def _open_profile_locked(self) -> None:
        cm = None
        try:
            cm = self._profiler(self.profile_dir)
        except Exception:  # pragma: no cover - profiler is best-effort
            cm = None
        if cm is None:
            self._count_profile_skipped()
            return
        try:
            self._profile_path = cm.__enter__()
            self._profile_cm = cm
            self._profile_left = self.profile_steps
        except Exception:  # pragma: no cover
            self._profile_cm = None

    def _tick_profile_locked(self) -> None:
        if self._profile_cm is None:
            return
        self._profile_left -= 1
        if self._profile_left <= 0:
            cm, self._profile_cm = self._profile_cm, None
            try:
                cm.__exit__(None, None, None)
            except Exception:  # pragma: no cover
                pass
            self._drop_next = True
            self._capture_end = self._clock()

    def quiet_for(self, window_s: float) -> bool:
        """Whether no capture of this monitor was active in the last
        ``window_s`` seconds (no profile open or pending, the last one
        ended at least that long ago): a goodput window that overlaps a
        capture measures the capture, not the run."""
        with self._lock:
            if self._profile_cm is not None or self._profile_pending:
                return False
            return (self._capture_end is None
                    or self._clock() - self._capture_end >= window_s)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "in_episode": self._in_episode,
                "episodes": self._episodes,
                "captures": self._captures,
                "profile_open": self._profile_cm is not None,
                "profile_path": self._profile_path,
                "last_bundle": self._last_bundle,
                "band": {
                    "mean": self.detector.mean,
                    "std": self.detector.std,
                    "threshold": self.detector.threshold(),
                },
            }

    def close(self) -> None:
        """Close any open profile (end-of-run teardown)."""
        with self._lock:
            self._profile_pending = False
            if self._profile_cm is not None:
                cm, self._profile_cm = self._profile_cm, None
                try:
                    cm.__exit__(None, None, None)
                except Exception:  # pragma: no cover
                    pass
