"""Fail-slow (gray-failure) tolerance in the port: the twin of the JAX
package's ``tests/test_slowness.py`` for what the port has. The shared
:class:`SlownessDetector` contract on fake clocks, the ``FaultPlan.slow``
delay hooks, the feed worker pool's recycler (bit-identical to
``serial_shards``), and the detector and the delay hooks held to the JAX
package's on the same inputs. The elastic, pipeline and router surfaces
wait for ``ROADMAP.md`` Queue 1 items 4-6.
"""

import numpy as np
import pytest

from dcnn_tpu_torch.resilience.faults import (
    FaultPlan, clear, install, slowdown,
)
from dcnn_tpu_torch.resilience.slowness import (
    SlownessConfig, SlownessDetector,
)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# SlownessConfig validation + env plumbing
# ---------------------------------------------------------------------------

def test_slowness_config_validation():
    with pytest.raises(ValueError, match="min_peers"):
        SlownessConfig(min_peers=1)
    with pytest.raises(ValueError, match="ratio must be > 1"):
        SlownessConfig(ratio=1.0)
    with pytest.raises(ValueError, match="exit_ratio"):
        SlownessConfig(ratio=2.0, exit_ratio=2.5)
    with pytest.raises(ValueError, match="ewma_alpha"):
        SlownessConfig(ewma_alpha=0.0)
    with pytest.raises(ValueError, match="dwell_s"):
        SlownessConfig(dwell_s=-0.1)
    with pytest.raises(ValueError, match="min_samples"):
        SlownessConfig(min_samples=0)


def test_slowness_config_from_env(monkeypatch):
    monkeypatch.setenv("DCNN_SLOW_RATIO", "3.5")
    monkeypatch.setenv("DCNN_SLOW_MIN_PEERS", "4")
    cfg = SlownessConfig.from_env(SlownessConfig(dwell_s=0.7))
    assert cfg.ratio == 3.5
    assert cfg.min_peers == 4
    assert cfg.dwell_s == 0.7          # base fields survive the overlay
    assert cfg.mad_k == 4.0            # untouched default


# ---------------------------------------------------------------------------
# detector state machine (fake clock, sleep-free)
# ---------------------------------------------------------------------------

def _det(fc, **kw):
    kw.setdefault("ewma_alpha", 1.0)   # score == last sample: exact tests
    kw.setdefault("min_samples", 1)
    kw.setdefault("dwell_s", 5.0)
    return SlownessDetector(SlownessConfig(**kw), clock=fc)


def _feed(det, walls):
    for c, w in walls.items():
        det.observe(c, w)


def test_outlier_convicts_only_after_dwell():
    fc = FakeClock()
    det = _det(fc)
    _feed(det, {"a": 1.0, "b": 1.0, "c": 1.0, "d": 10.0})
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("d", "probation")]
    assert trs[0]["median"] == 1.0
    fc.advance(4.9)                    # inside the dwell: one GC pause
    _feed(det, {"a": 1.0, "b": 1.0, "c": 1.0, "d": 10.0})
    assert det.evaluate() == []
    assert det.state("d") == "probation"
    fc.advance(0.2)                    # sustained past dwell_s
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("d", "convicted")]
    assert det.convicted() == ["d"]
    # recovery: below the exit band -> healthy again
    det.observe("d", 1.4)              # <= exit_ratio(1.5) * median(1.0)
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("d", "healthy")]


def test_exit_hysteresis_band_does_not_flap():
    """Between ``exit_ratio*median`` and the entry threshold, a component
    neither clears nor re-enters — the band gap is the flap filter, and
    the original probation stamp keeps the dwell clock honest."""
    fc = FakeClock()
    det = _det(fc)
    _feed(det, {"a": 1.0, "b": 1.0, "c": 1.0, "d": 10.0})
    det.evaluate()                     # d -> probation at t=0
    fc.advance(3.0)
    det.observe("d", 1.8)              # in the band: 1.5 < 1.8 < 2.0
    assert det.evaluate() == []        # no transition either way
    assert det.state("d") == "probation"
    fc.advance(3.0)                    # 6 s since entry: dwell elapsed
    det.observe("d", 10.0)             # outlier again
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("d", "convicted")]


def test_fleet_wide_slowdown_convicts_nobody():
    """THE hard rule: everyone slow together moves the median with them
    — no outlier, no verdict (the input got bigger, nobody gray-failed)."""
    fc = FakeClock()
    det = _det(fc)
    _feed(det, {"a": 1.0, "b": 1.0, "c": 1.1, "d": 0.9})
    assert det.evaluate() == []
    for _ in range(5):
        fc.advance(10.0)               # far past any dwell
        _feed(det, {"a": 10.0, "b": 10.0, "c": 11.0, "d": 9.0})
        assert det.evaluate() == []
    assert set(det.states().values()) == {"healthy"}


def test_below_min_peers_nobody_judged_and_probation_unflags():
    fc = FakeClock()
    det = _det(fc, min_peers=3)
    _feed(det, {"a": 1.0, "b": 100.0})
    assert det.evaluate() == []        # 2 scored < min_peers: no median
    assert det.state("b") == "healthy"
    # grow the fleet -> b becomes a judged outlier
    det.observe("c", 1.0)
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("b", "probation")]
    # shrink it again (eviction elsewhere): probation un-flags — the
    # fleet b was an outlier of no longer exists
    det.forget("c")
    trs = det.evaluate()
    assert [(t["component"], t["to"]) for t in trs] == [("b", "healthy")]


def test_min_samples_gates_scoring():
    fc = FakeClock()
    det = _det(fc, min_samples=3)
    for _ in range(2):
        _feed(det, {"a": 1.0, "b": 1.0, "c": 50.0})
    assert det.fleet_median() is None  # nobody has 3 samples yet
    assert det.evaluate() == []
    _feed(det, {"a": 1.0, "b": 1.0, "c": 50.0})
    assert det.fleet_median() == 1.0
    assert [t["to"] for t in det.evaluate()] == ["probation"]


def test_probe_ok_excludes_probed_component_and_fails_open():
    fc = FakeClock()
    det = _det(fc)
    _feed(det, {"a": 1.0, "b": 1.0, "c": 1.0})
    assert det.probe_ok("d", 1.2)      # <= exit_ratio * median
    assert not det.probe_ok("d", 2.0)
    # the probed component's own (stale, huge) score must not judge it
    det.observe("d", 50.0)
    assert det.probe_ok("d", 1.2)
    # no fleet to compare against: fail open, like the min_peers rule
    lone = _det(FakeClock())
    _feed(lone, {"a": 1.0})
    assert lone.probe_ok("a", 100.0)


def test_observe_ignores_negative_walls_and_snapshot_shape():
    fc = FakeClock()
    det = _det(fc)
    det.observe("a", -1.0)             # clock-skew artifact
    assert det.fleet_median() is None
    _feed(det, {"a": 2.0, "b": 2.0, "c": 4.0})
    snap = det.snapshot()
    assert snap["c"]["ratio_to_median"] == pytest.approx(2.0)
    assert snap["a"]["state"] == "healthy"
    assert snap["a"]["samples"] == 1
    det.forget("a")
    assert "a" not in det.snapshot()


# ---------------------------------------------------------------------------
# FaultPlan.slow — the delay-injection twin of arm()
# ---------------------------------------------------------------------------

def test_faultplan_slow_validation():
    with pytest.raises(ValueError, match="exactly one"):
        FaultPlan().slow("p")
    with pytest.raises(ValueError, match="exactly one"):
        FaultPlan().slow("p", factor=2.0, delay_s=1.0)
    with pytest.raises(ValueError, match="factor"):
        FaultPlan().slow("p", factor=0.5)
    with pytest.raises(ValueError, match="delay_s"):
        FaultPlan().slow("p", delay_s=-1.0)


def test_faultplan_slow_factor_and_delay():
    plan = FaultPlan().slow("p", factor=3.0)
    assert plan.slowdown("p", 2.0) == pytest.approx(4.0)  # base*(f-1)
    plan.unslow("p")
    assert plan.slowdown("p", 2.0) == 0.0
    plan.slow("p", delay_s=0.5)
    assert plan.slowdown("p", 100.0) == pytest.approx(0.5)  # fixed stall
    assert plan.slowdown("other", 1.0) == 0.0


def test_faultplan_slow_at_times_window():
    plan = FaultPlan().slow("p", delay_s=1.0, at=1, times=2)
    got = [plan.slowdown("p") for _ in range(4)]
    assert got == [0.0, 1.0, 1.0, 0.0]  # fires at invocations 1 and 2
    assert plan.slow_count("p") == 4    # every query counted


def test_module_global_slowdown_hook():
    plan = FaultPlan().slow("p", delay_s=0.25)
    assert slowdown("p", 1.0) == 0.0    # nothing installed
    install(plan)
    try:
        assert slowdown("p", 1.0) == pytest.approx(0.25)
    finally:
        clear()
    assert slowdown("p", 1.0) == 0.0


# ---------------------------------------------------------------------------
# feed-worker recycle
# ---------------------------------------------------------------------------

def _feed_data(n=96):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    return x, y


def test_feed_slow_worker_point_inflates_walls_bit_identically():
    """``feed.slow_worker`` stretches the reported prep wall INSIDE the
    worker (a genuinely slow worker, not a lying fast one) and never
    touches the output bytes."""
    from dcnn_tpu_torch.data.workers import FeedWorkerPool, serial_shards

    x, y = _feed_data()
    sels = [np.arange(i * 12, (i + 1) * 12) for i in range(4)]
    ser = [(a.copy(), b.copy()) for a, b, _ in
           serial_shards(x, y, sels, seed=5, epoch=1)]
    plan = FaultPlan().slow("feed.slow_worker", delay_s=0.004)
    install(plan)
    try:
        pool = FeedWorkerPool(x, y, 12, num_workers=2, backend="thread",
                              seed=5, poll_s=0.02)
        got, walls = [], []
        for ps in pool.shards(iter(sels), epoch=1):
            got.append((ps.x.copy(), ps.y.copy()))
            walls.append(ps.stats["prep_s"])
            ps.release()
        pool.close()
    finally:
        clear()
    assert plan.slow_count("feed.slow_worker") >= 1
    assert max(walls) >= 0.004          # the stall is in the report
    for (sx, sy), (gx, gy) in zip(ser, got):
        np.testing.assert_array_equal(sx, gx)
        np.testing.assert_array_equal(sy, gy)


def test_convicted_slow_worker_recycled_bit_identically():
    """A convicted worker is retired through the worker-death fallback:
    it refuses its next claim and exits, its shard is produced inline,
    the counter records it, and the epoch's bytes are untouched (shard
    RNG never involves the worker id)."""
    from dcnn_tpu_torch.data.workers import FeedWorkerPool, serial_shards
    from dcnn_tpu_torch.obs.registry import MetricsRegistry

    x, y = _feed_data()
    sels = [np.arange(i * 12, (i + 1) * 12) for i in range(6)]
    reg = MetricsRegistry()
    pool = FeedWorkerPool(
        x, y, 12, num_workers=3, backend="thread", seed=5, poll_s=0.02,
        registry=reg, slow_detect=True,
        slow_config=SlownessConfig(min_peers=2, min_samples=2,
                                   dwell_s=0.0))
    try:
        # drive the recycler exactly as _pump does, with synthetic walls:
        # w2 is a sustained 20x outlier, w0/w1 the healthy fleet
        for _ in range(3):
            pool._note_worker_wall(0, 0.001)
            pool._note_worker_wall(1, 0.001)
            pool._note_worker_wall(2, 0.02)
        assert 2 in pool._retired
        assert reg.snapshot()["feed_worker_recycled_total"] == 1
        # the retired worker's score no longer shifts the fleet median
        assert "w2" not in pool._slowness.snapshot()
        # the epoch still lands, bit-identical to the serial reference
        ser = [(a.copy(), b.copy()) for a, b, _ in
               serial_shards(x, y, sels, seed=5, epoch=2)]
        got, producers = [], []
        for ps in pool.shards(iter(sels), epoch=2):
            got.append((ps.x.copy(), ps.y.copy()))
            producers.append(ps.stats.get("worker"))
            ps.release()
        for (sx, sy), (gx, gy) in zip(ser, got):
            np.testing.assert_array_equal(sx, gx)
            np.testing.assert_array_equal(sy, gy)
        # the retired worker never produces again: any task it claims is
        # refused and rescued inline (it may idle-block on an empty queue
        # rather than exit, so assert on output, not thread liveness)
        assert producers and 2 not in producers
    finally:
        pool.close()


def test_last_producer_is_never_recycled():
    from dcnn_tpu_torch.data.workers import FeedWorkerPool
    from dcnn_tpu_torch.obs.registry import MetricsRegistry

    x, y = _feed_data(24)
    reg = MetricsRegistry()
    pool = FeedWorkerPool(x, y, 12, num_workers=1, backend="thread",
                          seed=5, poll_s=0.02, registry=reg,
                          slow_detect=True)
    try:
        pool._recycle_worker(0)          # even a direct conviction
        assert pool._retired == set()
        assert reg.snapshot()["feed_worker_recycled_total"] == 0
        assert pool.alive_workers() == 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# held to the JAX package on the same inputs
# ---------------------------------------------------------------------------

def test_detector_transitions_equal_jax_on_a_random_stream():
    """Both detectors fed the same seeded walls on the same fake clock emit
    the same transitions, states and snapshots at every evaluation."""
    from dcnn_tpu.resilience import slowness as jslow

    rng = np.random.default_rng(7)
    kw = dict(ewma_alpha=0.4, min_samples=2, min_peers=3, dwell_s=1.5)
    fa, fb = FakeClock(), FakeClock()
    mine = SlownessDetector(SlownessConfig(**kw), clock=fa)
    theirs = jslow.SlownessDetector(jslow.SlownessConfig(**kw), clock=fb)
    seen = set()
    for step in range(60):
        for c in ("a", "b", "c", "d", "e"):
            w = float(rng.lognormal(0.0, 0.2))
            if c == "e" and 10 <= step < 35:
                w *= 6.0               # a sustained outlier, then recovery
            mine.observe(c, w)
            theirs.observe(c, w)
        fa.advance(0.5)
        fb.advance(0.5)
        got, want = mine.evaluate(), theirs.evaluate()
        assert got == want, step
        seen.update(t["to"] for t in got)
        assert mine.snapshot() == theirs.snapshot()
    assert {"probation", "convicted", "healthy"} <= seen


def test_faultplan_slow_equals_jax():
    from dcnn_tpu.resilience import faults as jfaults

    mine, theirs = FaultPlan(), jfaults.FaultPlan()
    for plan in (mine, theirs):
        plan.slow("p", factor=2.5, at=1, times=3)
        plan.slow("q", delay_s=0.125)
    calls = [("p", 0.4), ("q", 1.0), ("p", 0.4), ("p", 2.0), ("x", 1.0),
             ("p", 1.0), ("p", 1.0)]
    assert ([mine.slowdown(p, b) for p, b in calls]
            == [theirs.slowdown(p, b) for p, b in calls])
    assert mine.slow_count("p") == theirs.slow_count("p") == 5
    mine.unslow("q")
    theirs.unslow("q")
    assert mine.slowdown("q", 1.0) == theirs.slowdown("q", 1.0) == 0.0


def test_recycler_pool_shards_equal_the_jax_pool():
    """The port's pool with the recycler on, a worker convicted and retired
    mid-run, hands out the bytes the JAX package's pool hands out."""
    from dcnn_tpu.data.workers import FeedWorkerPool as JaxPool
    from dcnn_tpu_torch.data.workers import FeedWorkerPool
    from dcnn_tpu_torch.obs.registry import MetricsRegistry

    x, y = _feed_data()
    sels = [np.arange(i * 12, (i + 1) * 12) for i in range(8)]
    cfg = SlownessConfig(min_peers=2, min_samples=1, dwell_s=0.0)
    pool = FeedWorkerPool(x, y, 12, num_workers=3, backend="thread",
                          seed=9, poll_s=0.02, registry=MetricsRegistry(),
                          slow_detect=True, slow_config=cfg)
    jpool = JaxPool(x, y, 12, num_workers=2, backend="thread", seed=9,
                    poll_s=0.02)
    try:
        for _ in range(2):
            pool._note_worker_wall(0, 0.001)
            pool._note_worker_wall(1, 0.001)
            pool._note_worker_wall(2, 0.05)
        assert pool._retired == {2}
        for epoch in (1, 2):
            got = [(ps.x.copy(), ps.y.copy(), ps.release())[:2]
                   for ps in pool.shards(iter(sels), epoch=epoch)]
            want = [(ps.x.copy(), ps.y.copy(), ps.release())[:2]
                    for ps in jpool.shards(iter(sels), epoch=epoch)]
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)
    finally:
        pool.close()
        jpool.close()
