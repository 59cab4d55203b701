"""Bounded exponential backoff with jitter (counterpart of
``dcnn_tpu/resilience/retry.py``).

- **Bounded.** Every loop ends, by attempt count (``attempts``) or by
  deadline (``timeout`` seconds from the first call), whichever comes
  first. The last exception is re-raised unwrapped.
- **Exponential with jitter.** The delay before retry *i* (0-based) is
  ``min(cap, base * 2**i)`` scaled by ``0.5 + 0.5*rand()``. The rng is
  injectable and seedable, so tests assert the exact delay sequence.
- **Injectable clock and sleep** (``clock=``, ``sleep=``), so a test runs
  the whole schedule without sleeping.

Every retry (not first attempts) increments the registry's
``retry_attempts_total`` and a per-site ``<name>_retry_attempts_total``.
:func:`retry_call` is the explicit form, :func:`retriable` the decorator.
Both honor an armed :class:`~dcnn_tpu_torch.resilience.faults.FaultPlan`,
whose faults are raised inside the wrapped callable by its own trip points.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..obs.registry import get_registry

T = TypeVar("T")


def backoff_delays(attempts: int, *, base: float = 0.2, cap: float = 5.0,
                   rng: Optional[random.Random] = None):
    """The delay schedule :func:`retry_call` uses, as a generator —
    ``min(cap, base*2**i)`` equal-jittered to ``[0.5d, d)``. Exposed so
    tests (and capacity planning) can enumerate it without running a
    failure."""
    r = rng if rng is not None else random
    for i in range(attempts):
        d = min(cap, base * (2.0 ** i))
        yield d * (0.5 + 0.5 * r.random())


def retry_call(fn: Callable[..., T], *args,
               attempts: int = 5,
               base: float = 0.2, cap: float = 5.0,
               timeout: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               retry_if: Optional[Callable[[BaseException], bool]] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               rng: Optional[random.Random] = None,
               name: str = "generic",
               on_retry: Optional[Callable[[int, BaseException, float],
                                           None]] = None,
               registry=None,
               **kwargs) -> T:
    """Call ``fn(*args, **kwargs)``; on ``retry_on`` exceptions, back off
    and retry up to ``attempts`` total tries or until ``timeout`` seconds
    have elapsed since the first try. Re-raises the last exception.

    ``retry_if(exc)``, when given, refines ``retry_on``: a matching
    exception is only retried if the predicate returns True (the hook for
    "OSError, but not a permanent HTTP 404"). ``on_retry(attempt_index,
    exc, delay_s)`` is invoked before each sleep — the hook call sites use
    for logging without coupling this module to any logger."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    reg = registry if registry is not None else get_registry()
    deadline = (clock() + timeout) if timeout is not None else None
    delays = backoff_delays(attempts - 1, base=base, cap=cap, rng=rng)
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if retry_if is not None and not retry_if(e):
                raise
            last = e
            if i == attempts - 1:
                break
            delay = next(delays)
            if deadline is not None:
                remaining = deadline - clock()
                if remaining <= 0:
                    break
                delay = min(delay, remaining)
            reg.counter("retry_attempts_total",
                        "retries across all call sites").inc()
            reg.counter(f"{name}_retry_attempts_total",
                        f"retries at the {name} call site").inc()
            if on_retry is not None:
                on_retry(i, e, delay)
            sleep(delay)
    assert last is not None
    raise last


def retriable(**retry_kwargs):
    """Decorator form: ``@retriable(attempts=3, retry_on=(OSError,),
    name="download")``. Keyword arguments are :func:`retry_call`'s."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, **retry_kwargs, **kwargs)

        return wrapper

    return deco
