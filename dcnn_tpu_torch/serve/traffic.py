"""Open-loop traffic generation for serving measurement (counterpart of
``dcnn_tpu/serve/traffic.py``).

Open loop means arrivals follow the offered rate whatever the completions:
a closed loop throttles itself to what the server sustains and hides the
queue growth that load shedding exists to bound. When the generator falls
behind schedule (a slow ``submit``) it does not sleep until it has caught
up, so the offered average rate holds.

``offered_rps`` is a constant or a rate schedule, any ``f(t_rel) -> rps``
over seconds since the run started; :func:`diurnal`, :func:`spike` and
:func:`step` build the common ones. Under a schedule the gap after an
arrival at ``t`` is ``1 / rate(t)``, so the offered rate tracks the
schedule arrival by arrival.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Sequence, Tuple, Union

from .batcher import DynamicBatcher, QueueFullError

#: A time-varying offered rate: seconds since the run started -> rps.
RateFn = Callable[[float], float]


def diurnal(peak_rps: float, trough_rps: float, period_s: float, *,
            phase_s: float = 0.0) -> RateFn:
    """Sinusoidal day/night curve between ``trough_rps`` and ``peak_rps``
    with period ``period_s``; the run starts at the trough (shift with
    ``phase_s``)."""
    if not 0 < trough_rps <= peak_rps:
        raise ValueError(f"need 0 < trough <= peak, got "
                         f"{trough_rps}/{peak_rps}")
    if period_s <= 0:
        raise ValueError(f"period_s must be > 0, got {period_s}")
    mid = (peak_rps + trough_rps) / 2.0
    amp = (peak_rps - trough_rps) / 2.0

    def rate(t: float) -> float:
        # cos starts at the trough: -cos(0) = -1
        return mid - amp * math.cos(2.0 * math.pi * (t + phase_s)
                                    / period_s)
    return rate


def spike(base_rps: float, spike_rps: float, at_s: float,
          width_s: float) -> RateFn:
    """Flat ``base_rps`` with a rectangular burst to ``spike_rps`` over
    ``[at_s, at_s + width_s)``."""
    if base_rps <= 0 or spike_rps <= 0:
        raise ValueError("rates must be > 0")
    if width_s <= 0:
        raise ValueError(f"width_s must be > 0, got {width_s}")

    def rate(t: float) -> float:
        return spike_rps if at_s <= t < at_s + width_s else base_rps
    return rate


def step(levels: Sequence[Tuple[float, float]]) -> RateFn:
    """Piecewise-constant schedule from ``(from_s, rps)`` pairs: the rate
    holds each level from its start time until the next level's. The
    first level must start at 0 so the rate is defined everywhere."""
    lv = sorted((float(t), float(r)) for t, r in levels)
    if not lv or lv[0][0] != 0.0:
        raise ValueError("levels must be non-empty and start at t=0")
    if any(r <= 0 for _, r in lv):
        raise ValueError("every level's rps must be > 0")

    def rate(t: float) -> float:
        cur = lv[0][1]
        for start, r in lv:
            if t < start:
                break
            cur = r
        return cur
    return rate


def open_loop(batcher: DynamicBatcher, samples: Sequence,
              offered_rps: Union[float, RateFn], seconds: float, *,
              clock: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep
              ) -> List[Tuple[int, "object"]]:
    """Submit single-sample requests from ``samples`` (cycled) at the
    offered rate (constant or a :data:`RateFn` schedule) for ``seconds``.
    Returns ``[(sample_index, future), ...]`` for every accepted request;
    shed requests are counted by the batcher's metrics. ``clock`` and
    ``sleep`` are injectable."""
    if callable(offered_rps):
        rate: RateFn = offered_rps
        if rate(0.0) <= 0:
            raise ValueError("rate schedule must be > 0 at t=0")
    else:
        if offered_rps <= 0:
            raise ValueError(f"offered_rps must be > 0, got {offered_rps}")
        rate = lambda t, r=float(offered_rps): r  # noqa: E731
    futs: List[Tuple[int, object]] = []
    t0 = clock()
    # schedule time accumulates on a nanosecond grid: without the
    # rounding, fifty 0.1s gaps land at 4.999999999999998 and a schedule
    # breakpoint at t=5.0 is evaluated one full slow-rate gap late
    t_rel, i = 0.0, 0
    while t_rel < seconds:
        dt = (t0 + t_rel) - clock()
        if dt > 0:
            sleep(dt)
        k = i % len(samples)
        try:
            futs.append((k, batcher.submit(samples[k])))
        except QueueFullError:
            pass  # shed: the bounded queue working as designed
        i += 1
        r = rate(t_rel)
        if not (r > 0):          # also catches NaN
            raise ValueError(f"rate schedule returned {r} at "
                             f"t={t_rel:.3f}; rates must stay > 0")
        nxt = round(t_rel + 1.0 / r, 9)
        if nxt <= t_rel:
            # inf or above ~2e9 rps: the gap rounds to zero on the
            # nanosecond grid; raising beats spinning forever
            raise ValueError(
                f"rate schedule returned {r} rps at t={t_rel:.3f}; "
                f"the per-arrival gap rounds to zero on the nanosecond "
                f"grid")
        t_rel = nxt
    return futs
