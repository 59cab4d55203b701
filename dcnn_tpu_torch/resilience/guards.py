"""Step guards: a non-finite loss or gradient defence and a stall
watchdog (counterpart of ``dcnn_tpu/resilience/guards.py``).

- **Detection and neutralisation** live in
  ``train.make_train_step(guard=True)``: the step computes ``bad =
  ~isfinite(loss) | ~isfinite(Σ‖g‖²)`` after the backward and decides
  before the optimizer touches anything. The port's step updates the model
  in place, and the training forward has already moved the batchnorm
  running statistics by then, so the guarded step copies those buffers
  before the forward and puts them back on a bad step: a skipped step
  leaves params, optimizer state, step count and running statistics
  bit-identical to not having run it.
- **Host-side policy** lives here, in :class:`StepGuard`: ``"raise"``
  aborts with :class:`NonFiniteError` naming the step; ``"skip_step"``
  counts the skip (``train_skipped_steps_total``) and goes on;
  ``"rollback"`` skips until ``rollback_after`` consecutive bad steps, then
  tells the trainer to restore the newest checkpoint.

:class:`StallWatchdog` flags (never kills) a loop that stopped beating:
``train_stalled`` / ``train_stall_flags_total`` on the metrics registry.
Both write a flight-recorder bundle on their degradation edge
(``nonfinite_guard`` at the start of a bad-step streak or before a
``"raise"`` abort, ``watchdog_stall`` when a stall is first flagged), to
the process-global recorder unless ``flight=`` injects one; a disabled
recorder makes that a no-op.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Callable, Iterable, Optional

import torch

from ..obs.registry import get_registry


class NonFiniteError(FloatingPointError):
    """Training produced a non-finite loss or gradient norm."""

    def __init__(self, step: int, loss: float):
        self.step = step
        self.loss = loss
        super().__init__(
            f"non-finite loss/gradient at train step {step} (loss={loss!r}); "
            f"policy 'raise' aborts — use nonfinite_policy='skip_step' or "
            f"'rollback' to continue past transient bad batches")


def global_norm_sq(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ‖t‖² over tensors, as a 0-d fp32 tensor on their device (one
    multi-tensor norm): the non-finiteness probe, non-finite iff a NaN or
    Inf is anywhere (or the sum overflows fp32, as in the JAX package)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm(tensors)).float().square().sum()


class StepGuard:
    """Host-side policy for the guarded step's ``bad`` flag. Returns one of
    ``"ok" | "skipped" | "rollback"`` per step; raises for policy
    ``"raise"``."""

    POLICIES = ("raise", "skip_step", "rollback")

    def __init__(self, policy: str = "raise", *, rollback_after: int = 3,
                 registry=None, flight=None):
        if policy not in self.POLICIES:
            raise ValueError(f"nonfinite_policy must be one of "
                             f"{self.POLICIES}, got {policy!r}")
        if rollback_after < 1:
            raise ValueError(f"rollback_after must be >= 1, "
                             f"got {rollback_after}")
        self.policy = policy
        self.rollback_after = rollback_after
        self._reg = registry if registry is not None else get_registry()
        self.consecutive_bad = 0
        self.total_skipped = 0
        self._flight = flight  # None: the process-global recorder

    def _flight_recorder(self):
        from ..obs.flight import resolve_flight_recorder
        return resolve_flight_recorder(self._flight)

    def observe(self, step: int, bad: bool,
                loss: float = math.nan) -> str:
        if not bad:
            self.consecutive_bad = 0
            return "ok"
        if self.policy == "raise":
            # postmortem before the abort (a no-op while the recorder is
            # disabled; never raises on its own)
            self._flight_recorder().record(
                "nonfinite_guard",
                reasons=[f"non-finite loss/grad at step {step} "
                         f"(loss={loss!r}); policy 'raise' aborts"],
                registry=self._reg,
                extra={"step": step, "loss": repr(loss),
                       "policy": self.policy})
            raise NonFiniteError(step, loss)
        if self.consecutive_bad == 0:
            # the degradation edge, the start of a bad-step streak: one
            # bundle an episode
            self._flight_recorder().record(
                "nonfinite_guard",
                reasons=[f"non-finite loss/grad at step {step}: "
                         f"policy {self.policy!r}"],
                registry=self._reg,
                extra={"step": step, "loss": repr(loss),
                       "policy": self.policy,
                       "rollback_after": self.rollback_after})
        self.consecutive_bad += 1
        self.total_skipped += 1
        self._reg.counter("train_skipped_steps_total",
                          "train steps skipped by the non-finite guard").inc()
        warnings.warn(
            f"non-finite loss/grad at step {step}: step skipped "
            f"({self.consecutive_bad} consecutive)", stacklevel=2)
        if (self.policy == "rollback"
                and self.consecutive_bad >= self.rollback_after):
            self.consecutive_bad = 0
            self._reg.counter(
                "train_rollbacks_total",
                "rollbacks to last checkpoint by the guard").inc()
            return "rollback"
        return "skipped"


class StallWatchdog:
    """Flags (never kills) a training loop that stopped making progress.

    ``beat()`` on every progress event; ``check()`` returns True and
    records on the registry iff the last beat is older than ``timeout_s``.
    ``start()`` polls ``check`` on a daemon thread for production runs;
    tests drive ``check()`` directly with an injected clock and never
    sleep. Repeated checks during one stall flag once (edge-triggered) —
    a new flag needs a beat in between.
    """

    def __init__(self, timeout_s: float, *,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, name: str = "train", flight=None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self._clock = clock
        self._reg = registry if registry is not None else get_registry()
        self._name = name
        self._flight = flight  # None: the process-global recorder
        # beat() runs on the training thread, check() on the poll thread:
        # the beat/flag pair must change together or a beat landing between
        # check()'s read and its flag write un-stalls a loop the poll
        # thread is about to (wrongly) flag
        self._lock = threading.Lock()
        self._last_beat = clock()  # dcnn: guarded_by=_lock
        self._flagged = False  # dcnn: guarded_by=_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        with self._lock:
            self._last_beat = self._clock()
            was_flagged, self._flagged = self._flagged, False
        if was_flagged:
            self._reg.gauge(f"{self._name}_stalled",
                            "1 while the loop is flagged stalled").set(0)

    def check(self) -> bool:
        with self._lock:
            age = self._clock() - self._last_beat
            stalled = age > self.timeout_s
            newly = stalled and not self._flagged
            if newly:
                self._flagged = True
        self._reg.gauge(
            f"{self._name}_last_progress_age_s",
            "seconds since the loop last made progress").set(age)
        if not stalled:
            return False
        if newly:
            self._reg.counter(f"{self._name}_stall_flags_total",
                              "distinct stalls flagged").inc()
            self._reg.gauge(f"{self._name}_stalled",
                            "1 while the loop is flagged stalled").set(1)
            warnings.warn(
                f"{self._name} loop stalled: no progress for {age:.1f}s "
                f"(timeout {self.timeout_s:.1f}s)", stacklevel=2)
            # edge-triggered postmortem: the spans leading into the stall
            # say what stopped beating
            from ..obs.flight import resolve_flight_recorder
            resolve_flight_recorder(self._flight).record(
                "watchdog_stall",
                reasons=[f"{self._name} loop: no progress for {age:.1f}s "
                         f"(timeout {self.timeout_s:g}s)"],
                registry=self._reg,
                extra={"watchdog": self._name, "age_s": age,
                       "timeout_s": self.timeout_s})
        return True

    def start(self, poll_s: Optional[float] = None) -> "StallWatchdog":
        if self._thread is not None:
            return self
        interval = poll_s if poll_s is not None else max(
            self.timeout_s / 4.0, 0.05)

        def loop():
            while not self._stop.wait(interval):
                self.check()

        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"dcnn-{self._name}-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop = threading.Event()
