"""Deterministic, seeded fault injection for testing recovery paths
(counterpart of ``dcnn_tpu/resilience/faults.py``).

Production call sites carry named trip points
(``trip("ckpt.before_rename", step=...)``), and a test arms a
:class:`FaultPlan` that decides, from its seed and arm counts, which
invocation of which point raises.

- **Free when disarmed.** :func:`trip` checks one module global against
  ``None``.
- **Deterministic.** A plan is armed for a point name plus an optional
  ``at=`` invocation index (0-based, per point) and ``times=`` count. The
  only randomness, :meth:`FaultPlan.bit_flip`'s choice of byte, comes from
  the plan's own seeded ``random.Random``.
- ``InjectedFault`` is a ``RuntimeError``, so ``except OSError`` clauses do
  not swallow it; :class:`InjectedCrash` stands in for a hard kill.

The port's trip points have the JAX package's names:

==============================  ==============================================
``ckpt.write``                  crash mid-save, files partially on disk
``ckpt.before_rename``          crash after a checkpoint's files are written
                                but before the atomic commit rename
``ckpt.after_rename``           crash just after the commit rename (the new
                                checkpoint exists; retention never ran)
``train.nonfinite_input``       poison the training batch at global step
                                ``at=j`` so the loss goes non-finite; armed
                                with ``exc=InjectedCrash`` it kills the run
                                mid-epoch instead
==============================  ==============================================

Delay hooks (fail-slow, not fail-stop): :meth:`FaultPlan.slow` arms a
point so that :func:`slowdown` returns extra seconds for the call site to
sleep inside its measured window, as a degraded host would run. The port's
delay point is ``feed.slow_worker`` (a feed worker's prep wall;
``data/workers.py``). Standard library only.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple, Type


class InjectedFault(RuntimeError):
    """A fault raised by an armed :class:`FaultPlan` trip point."""

    def __init__(self, point: str, invocation: int, **context):
        self.point = point
        self.invocation = invocation
        self.context = context
        ctx = "".join(f" {k}={v!r}" for k, v in sorted(context.items()))
        super().__init__(
            f"injected fault at {point!r} (invocation {invocation}){ctx}")


class InjectedCrash(InjectedFault):
    """A fault standing in for a hard preemption (SIGKILL) — the process
    would be gone, so recovery code must never rely on catching it. Tests
    catch it at top level to simulate the restart."""


class FaultPlan:
    """A seeded set of armed trip points.

    ``plan.arm("ckpt.before_rename", exc=InjectedCrash)`` arms every
    invocation; ``at=k`` starts firing at the (0-based) k-th invocation of
    that point; ``times=n`` (default unlimited) disarms after n firings.
    Compositions read naturally: ``at=2, times=1`` is "exactly the third
    invocation"; ``at=4, times=2`` is "two consecutive faults starting at
    the fifth"; ``times=2, exc=OSError`` is the "fail twice then recover"
    idiom retry tests want.

    Invocation counters are per point, start at 0, and are also the
    post-mortem record: ``plan.count("ckpt.before_rename")`` tells a test
    how often production code actually passed the point.
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._armed: Dict[str, Tuple[Optional[int], Optional[int],
                                     Type[BaseException]]] = {}
        self._counts: Dict[str, int] = {}
        self._slow_armed: Dict[str, Tuple[Optional[int], Optional[int],
                                          Optional[float],
                                          Optional[float]]] = {}  # dcnn: guarded_by=_lock
        self._slow_counts: Dict[str, int] = {}  # dcnn: guarded_by=_lock

    def arm(self, point: str, *, at: Optional[int] = None,
            times: Optional[int] = None,
            exc: Type[BaseException] = InjectedFault) -> "FaultPlan":
        with self._lock:
            self._armed[point] = (at, times, exc)
        return self

    def disarm(self, point: str) -> "FaultPlan":
        with self._lock:
            self._armed.pop(point, None)
        return self

    def count(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def _check(self, point: str, context: dict) -> None:
        with self._lock:
            n = self._counts.get(point, 0)
            self._counts[point] = n + 1
            spec = self._armed.get(point)
            if spec is None:
                return
            at, times, exc = spec
            if at is not None and n < at:
                return
            if times is not None:
                times -= 1
                if times <= 0:
                    self._armed.pop(point, None)
                else:
                    self._armed[point] = (at, times, exc)
        if issubclass(exc, InjectedFault):
            raise exc(point, n, **context)
        raise exc(f"injected fault at {point!r} (invocation {n})")

    def trip(self, point: str, **context) -> None:
        """Per-plan trip: check THIS plan (not the process-global one), for
        simulations that hand one plan to each of several in-process
        components."""
        self._check(point, context)

    # -- delay injection (fail-slow, not fail-stop) ------------------------
    def slow(self, point: str, *, factor: Optional[float] = None,
             delay_s: Optional[float] = None, at: Optional[int] = None,
             times: Optional[int] = None) -> "FaultPlan":
        """Arm ``point`` as a **delay** hook: every matching
        :meth:`slowdown` query returns extra seconds for the call site to
        sleep. Exactly one of ``factor`` (scale the measured wall — a
        ``factor=10`` component runs 10x slow) or ``delay_s`` (fixed
        stall) must be given; ``at``/``times`` window invocations exactly
        like :meth:`arm`."""
        if (factor is None) == (delay_s is None):
            raise ValueError(
                "FaultPlan.slow wants exactly one of factor= or delay_s=")
        if factor is not None and factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {factor}")
        if delay_s is not None and delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        with self._lock:
            self._slow_armed[point] = (at, times, factor, delay_s)
        return self

    def unslow(self, point: str) -> "FaultPlan":
        """Disarm a :meth:`slow` point — the fault "clears" (recovery /
        probation-rejoin fixtures)."""
        with self._lock:
            self._slow_armed.pop(point, None)
        return self

    def slow_count(self, point: str) -> int:
        with self._lock:
            return self._slow_counts.get(point, 0)

    def slowdown(self, point: str, base_s: float = 0.0,
                 **context) -> float:
        """Per-plan delay query: extra seconds the call site should
        sleep on top of the ``base_s`` wall it measured — 0.0 unless
        :meth:`slow` armed this point and the invocation window matches.
        Deterministic like :meth:`trip`; never raises."""
        with self._lock:
            n = self._slow_counts.get(point, 0)
            self._slow_counts[point] = n + 1
            spec = self._slow_armed.get(point)
            if spec is None:
                return 0.0
            at, times, factor, delay_s = spec
            if at is not None and n < at:
                return 0.0
            if times is not None:
                times -= 1
                if times <= 0:
                    self._slow_armed.pop(point, None)
                else:
                    self._slow_armed[point] = (at, times, factor, delay_s)
        if delay_s is not None:
            return delay_s
        return base_s * max(float(factor) - 1.0, 0.0)

    # -- corruption utility (not a trip point: tests call it directly) --
    def bit_flip(self, path: str) -> Tuple[int, int]:
        """Flip one bit of one byte of ``path`` in place (choice drawn from
        the plan's seeded rng). Returns ``(offset, bit)`` for the record.
        The canonical way to manufacture a checksum-invalid checkpoint."""
        with open(path, "rb") as f:
            data = bytearray(f.read())
        if not data:
            raise ValueError(f"cannot bit-flip empty file {path}")
        off = self.rng.randrange(len(data))
        bit = self.rng.randrange(8)
        data[off] ^= 1 << bit
        # in-place corruption IS the point here — this manufactures the
        # torn/bit-flipped artifact the restore path must survive
        with open(path, "wb") as f:  # dcnn: disable=AT01
            f.write(data)
        return off, bit

    # -- context-manager arming --
    def __enter__(self) -> "FaultPlan":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        clear()


# One process-global active plan: production trip points check a single
# module global against None, so the disarmed cost is one load + one jump.
_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def trip(point: str, **context) -> None:
    """Production-side hook: raises iff a plan is installed and armed for
    this point/invocation. Free (one global check) otherwise."""
    if _ACTIVE is not None:
        _ACTIVE._check(point, context)


def slowdown(point: str, base_s: float = 0.0, **context) -> float:
    """Production-side delay hook (the fail-slow twin of :func:`trip`):
    extra seconds to sleep at this point — 0.0 (one global check, no
    allocation) unless an installed plan armed it via
    :meth:`FaultPlan.slow`. Call sites sleep the return value INSIDE
    their measured timing window so detectors see the slowness exactly
    as a degraded host would produce it."""
    if _ACTIVE is not None:
        return _ACTIVE.slowdown(point, base_s, **context)
    return 0.0
