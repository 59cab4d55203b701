"""Gray-failure (fail-slow) detection by relative performance
(counterpart of ``dcnn_tpu/resilience/slowness.py``).

A component that stays alive while running many times slower defeats every
fail-stop check: it keeps beating and answering. This detector scores each
component against its peers. In the port it drives the feed worker pool's
recycler (``data/workers.py``, ``FeedWorkerPool(slow_detect=True)``); the
JAX package's elastic, pipeline and router surfaces use the same contract.

- **Relative, not absolute.** A component is judged against the median of
  its peers' EWMA walls. The outlier test is MAD-based and ratio-floored
  (``ewma > ratio * median``), so a fleet with a tiny spread cannot convict
  on noise.
- **A fleet-wide slowdown never convicts.** Everyone slow together moves
  the median with them, and below ``min_peers`` scored components nobody
  is judged at all.
- **Probation, then conviction, with dwell and exit hysteresis.** An
  outlier enters probation and is convicted only after ``dwell_s`` of
  sustained outlier-hood; it clears only below ``exit_ratio * median``.
- **Injectable clock, no threads.** ``observe()`` is O(1); callers pump
  :meth:`SlownessDetector.evaluate` from their own sweeps.

Standard library only. :meth:`SlownessConfig.from_env` reads the
``DCNN_SLOW_*`` overrides the JAX package reads.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

#: Detector states, in escalation order.
STATES = ("healthy", "probation", "convicted")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


@dataclass(frozen=True)
class SlownessConfig:
    """Knobs for one :class:`SlownessDetector` (all surfaces share this
    shape; each surface resolves its own instance). Env overrides via
    :meth:`from_env` use the ``DCNN_SLOW_*`` names."""

    #: EWMA weight of the newest wall sample (higher = faster reaction,
    #: noisier score).
    ewma_alpha: float = 0.3
    #: Samples a component must contribute before it is scored at all.
    min_samples: int = 3
    #: Scored components required before ANYONE can be judged — below
    #: this there is no meaningful fleet median (and a 2-component
    #: "fleet" would let each convict the other).
    min_peers: int = 3
    #: MAD multiplier: outlier iff ``ewma > median + mad_k * MAD`` …
    mad_k: float = 4.0
    #: … AND ``ewma > ratio * median`` (the floor that keeps a tiny-MAD
    #: fleet from convicting on noise).
    ratio: float = 2.0
    #: Exit hysteresis: probation/conviction clears only below
    #: ``exit_ratio * median`` (must be < ratio to make a real band).
    exit_ratio: float = 1.5
    #: Seconds of *sustained* outlier-hood in probation before convict.
    dwell_s: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}")
        if self.min_peers < 2:
            raise ValueError(f"min_peers must be >= 2, got {self.min_peers}")
        if self.ratio <= 1.0:
            raise ValueError(f"ratio must be > 1, got {self.ratio}")
        if not (1.0 <= self.exit_ratio <= self.ratio):
            raise ValueError(
                f"exit_ratio must be in [1, ratio={self.ratio}], "
                f"got {self.exit_ratio}")
        if self.dwell_s < 0.0:
            raise ValueError(f"dwell_s must be >= 0, got {self.dwell_s}")

    @classmethod
    def from_env(cls, base: Optional["SlownessConfig"] = None
                 ) -> "SlownessConfig":
        b = base if base is not None else cls()
        return replace(
            b,
            ewma_alpha=_env_float("DCNN_SLOW_EWMA_ALPHA", b.ewma_alpha),
            min_samples=_env_int("DCNN_SLOW_MIN_SAMPLES", b.min_samples),
            min_peers=_env_int("DCNN_SLOW_MIN_PEERS", b.min_peers),
            mad_k=_env_float("DCNN_SLOW_MAD_K", b.mad_k),
            ratio=_env_float("DCNN_SLOW_RATIO", b.ratio),
            exit_ratio=_env_float("DCNN_SLOW_EXIT_RATIO", b.exit_ratio),
            dwell_s=_env_float("DCNN_SLOW_DWELL_S", b.dwell_s),
        )


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class SlownessDetector:
    """Per-component relative-performance scoring with a probation →
    convict state machine.

    ``observe(component, wall_s)`` feeds one wall sample (O(1) EWMA
    update); ``evaluate()`` re-scores the fleet and returns the state
    transitions that fired — the caller acts on ``to == "convicted"``
    (evict / probation / rebalance) and ``to == "healthy"`` (rejoin).
    A caller that removes a component from the fleet calls
    :meth:`forget` so a stale score cannot shift the median.
    """

    def __init__(self, config: Optional[SlownessConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config if config is not None else SlownessConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._ewma: Dict[str, float] = {}    # dcnn: guarded_by=_lock
        self._n: Dict[str, int] = {}         # dcnn: guarded_by=_lock
        self._state: Dict[str, str] = {}     # dcnn: guarded_by=_lock
        self._since: Dict[str, float] = {}   # dcnn: guarded_by=_lock
        # probation entry stamp, for the dwell test

    # -- feeding -----------------------------------------------------------
    def observe(self, component: str, wall_s: float) -> None:
        """One wall-clock sample for ``component`` (seconds or any
        consistent unit — the detector is scale-free, all tests are
        relative to the fleet median)."""
        if wall_s < 0.0:
            return  # clock skew artifact; never poison the score
        a = self.config.ewma_alpha
        with self._lock:
            prev = self._ewma.get(component)
            self._ewma[component] = (wall_s if prev is None
                                     else (1.0 - a) * prev + a * wall_s)
            self._n[component] = self._n.get(component, 0) + 1
            self._state.setdefault(component, "healthy")

    def forget(self, component: str) -> None:
        """Drop a component (evicted / decommissioned) so its stale
        score stops shifting the fleet median."""
        with self._lock:
            self._ewma.pop(component, None)
            self._n.pop(component, None)
            self._state.pop(component, None)
            self._since.pop(component, None)

    # -- scoring -----------------------------------------------------------
    def _scored(self) -> Dict[str, float]:
        # dcnn: guarded_by=_lock (caller holds)
        ms = self.config.min_samples
        return {c: v for c, v in self._ewma.items()
                if self._n.get(c, 0) >= ms}

    def fleet_median(self) -> Optional[float]:
        with self._lock:
            scored = self._scored()
        return _median(list(scored.values())) if scored else None

    def evaluate(self) -> List[Dict[str, object]]:
        """Re-score every component against the fleet median and step
        the state machines. Returns the transitions that fired, each
        ``{"component", "from", "to", "ewma", "median", "t"}`` — enough
        for the caller's flight bundle to explain the verdict."""
        now = self._clock()
        cfg = self.config
        out: List[Dict[str, object]] = []
        with self._lock:
            scored = self._scored()
            if len(scored) < cfg.min_peers:
                # the hard rule's small-fleet half: no meaningful median
                # below min_peers components — nobody is judged, and
                # anyone already in probation un-flags (the fleet they
                # were an outlier of no longer exists)
                for c, st in list(self._state.items()):
                    if st == "probation":
                        self._state[c] = "healthy"
                        self._since.pop(c, None)
                        out.append({"component": c, "from": st,
                                    "to": "healthy",
                                    "ewma": self._ewma.get(c),
                                    "median": None, "t": now})
                return out
            med = _median(list(scored.values()))
            mad = _median([abs(v - med) for v in scored.values()])
            enter = max(med + cfg.mad_k * mad, cfg.ratio * med)
            leave = cfg.exit_ratio * med
            for c, v in scored.items():
                st = self._state.get(c, "healthy")
                new = st
                if st == "healthy":
                    if v > enter:
                        new = "probation"
                        self._since[c] = now
                elif st == "probation":
                    if v <= leave:
                        new = "healthy"
                        self._since.pop(c, None)
                    elif (v > enter
                          and now - self._since.get(c, now) >= cfg.dwell_s):
                        new = "convicted"
                else:  # convicted
                    if v <= leave:
                        new = "healthy"
                        self._since.pop(c, None)
                if new != st:
                    self._state[c] = new
                    out.append({"component": c, "from": st, "to": new,
                                "ewma": v, "median": med, "t": now})
        return out

    def probe_ok(self, component: str, wall_s: float) -> bool:
        """Recovery probe: would a component performing ``wall_s`` be
        clean relative to the current fleet (below the exit band)?
        Drives rejoin and probation release. With no scored
        fleet to compare against it passes — the same fail-open stance
        as the fleet-wide rule (no relative evidence, no verdict)."""
        with self._lock:
            scored = {c: v for c, v in self._scored().items()
                      if c != component}
        if len(scored) < max(self.config.min_peers - 1, 1):
            return True
        med = _median(list(scored.values()))
        return wall_s <= self.config.exit_ratio * med

    # -- introspection -----------------------------------------------------
    def state(self, component: str) -> str:
        with self._lock:
            return self._state.get(component, "healthy")

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def convicted(self) -> List[str]:
        with self._lock:
            return sorted(c for c, s in self._state.items()
                          if s == "convicted")

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-component ``{ewma, samples, state, ratio_to_median}`` —
        the ``/healthz`` + flight-bundle view."""
        with self._lock:
            scored = self._scored()
            med = _median(list(scored.values())) if scored else None
            return {c: {"ewma": self._ewma[c],
                        "samples": self._n.get(c, 0),
                        "state": self._state.get(c, "healthy"),
                        "ratio_to_median": (self._ewma[c] / med
                                            if med else None)}
                    for c in self._ewma}

    def __repr__(self) -> str:
        with self._lock:
            n = len(self._ewma)
            bad = sorted(c for c, s in self._state.items()
                         if s != "healthy")
        return f"SlownessDetector(components={n}, flagged={bad})"
