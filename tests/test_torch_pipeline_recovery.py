"""The port's self-healing TCP pipeline on the CPU: twins of
``tests/test_pipeline_recovery.py`` (the kill matrix, semi-async, respawn,
double fault, torn weight ship, dead and wedged coordinators,
probe-then-convict, the timeout contract, optimizer state split/merge,
commit cadence, gather vintage, bf16 through the wire, ``pipeline_check``)
and of the pipeline half of ``tests/test_slowness.py`` (the measured
partitioner, a slow stage's rebalance).

Fleets are ``StageWorker`` threads over loopback sockets, victims killed
by per-worker ``FaultPlan``s arming ``pipeline.stage_death`` with
``InjectedCrash`` (the worker's sockets close as a dead process's do, so
the coordinator sees the death at once through the connection's close).
Conviction by silence is tested on fake clocks; the heartbeat of the
fleets is 1 s, so no test depends on how fast a thread is scheduled, and
none asserts a wall-clock bound.

Tolerances, the JAX package's for the same properties: a recovered run's
params within rtol 2e-4, atol 2e-5 of the uninterrupted run's (a
repartition reassociates nothing on the CPU, so they are usually equal);
a respawn (same partitions) bit for bit; a rebalance within rtol 2e-4,
atol 2e-5."""

import threading
import time

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.core import get_precision_mode, set_precision
from dcnn_tpu_torch.nn import SequentialBuilder
from dcnn_tpu_torch.obs.flight import FlightRecorder
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.optim import SGD, Adam
from dcnn_tpu_torch.parallel import (
    DistributedPipelineCoordinator, InProcessPipelineCoordinator,
    PipelineTimeouts, StageWorker, comm,
)
from dcnn_tpu_torch.parallel.distributed_pipeline import (
    PipelineCollapsedError, StageLostError,
)
from dcnn_tpu_torch.resilience import FaultPlan
from dcnn_tpu_torch.resilience.faults import InjectedCrash
from dcnn_tpu_torch.resilience.slowness import SlownessConfig

RTOL, ATOL = 2e-4, 2e-5
T = PipelineTimeouts(batch_s=120.0, heartbeat_s=1.0, respawn_s=0.5)


def _model(seed=0):
    m = (SequentialBuilder("heal_pipe").input((16,))
         .dense(32).activation("relu")
         .dense(24).activation("relu")
         .dense(4).build())
    return m.init(generator=torch.Generator().manual_seed(seed), device="cpu")


def _batches(n=6, n_rows=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n_rows, 16)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, n_rows)])
            for _ in range(n)]


class _Fleet:
    """N StageWorker threads on pre-bound loopback sockets."""

    def __init__(self, n=3, plans=None):
        self.socks = [comm.listen(0, host="127.0.0.1") for _ in range(n)]
        self.addrs = [f"127.0.0.1:{s.getsockname()[1]}" for s in self.socks]
        self.plans = plans or [FaultPlan() for _ in range(n)]
        self.workers = [StageWorker(0, listen_sock=s, fault_plan=p,
                                    device="cpu")
                        for s, p in zip(self.socks, self.plans)]
        self.threads = [threading.Thread(target=self._serve, args=(w,),
                                         daemon=True) for w in self.workers]
        for t in self.threads:
            t.start()

    @staticmethod
    def _serve(w):
        try:
            w.serve()
        except InjectedCrash:
            pass  # the simulated kill: serve() closed the sockets

    def close(self):
        for w in self.workers:
            w.stop()
        for t in self.threads:
            t.join(timeout=30)


def _coordinator(addrs, optimizer=None, model=None, **kw):
    kw.setdefault("timeouts", T)
    return DistributedPipelineCoordinator(
        model if model is not None else _model(),
        optimizer or SGD(0.05, momentum=0.9), "softmax_crossentropy",
        workers=addrs, num_microbatches=2, device="cpu", **kw)


def _run(co, n=6, schedule="sync"):
    co.deploy_stages()
    fn = getattr(co, f"train_batch_{schedule}")
    losses = [fn(x, y, 0.05, b)[0] for b, (x, y) in enumerate(_batches(n))]
    params, state = co.gathered_params()
    return losses, params, state


@pytest.fixture(scope="module")
def uninterrupted():
    fleet = _Fleet(3)
    try:
        co = _coordinator(fleet.addrs)
        out = _run(co)
        co.shutdown()
        return out
    finally:
        fleet.close()


def _assert_close(p, ref_p):
    assert list(p) == list(ref_p)
    for n in ref_p:
        np.testing.assert_allclose(p[n].numpy(), ref_p[n].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_uninterrupted_equals_in_process(uninterrupted):
    """The reference the matrix is held to is itself the in-process
    coordinator's run, bit for bit."""
    losses, p, _ = uninterrupted
    ref = InProcessPipelineCoordinator(
        _model(), SGD(0.05, momentum=0.9), "softmax_crossentropy", 3,
        devices=["cpu"] * 3, num_microbatches=2)
    ref.deploy_stages()
    want = [ref.train_batch_sync(x, y, 0.05, b)[0]
            for b, (x, y) in enumerate(_batches(6))]
    assert losses == want
    rp, _ = ref.gathered_params()
    assert all(torch.equal(p[n], rp[n]) for n in rp)


# -- the kill matrix: every victim position, mid-batch ---------------------

@pytest.mark.parametrize("victim", [0, 1, 2])
def test_kill_any_stage_mid_batch_params_match(victim, uninterrupted,
                                               tmp_path):
    """Stage ``victim`` dies on batch 3's first backward: the run
    repartitions over the 2 survivors, restores the batch-2 commit,
    replays the journal and the aborted batch, and lands on the
    uninterrupted run's params with no batch lost and one
    ``pipeline_stage_death`` bundle."""
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    # per worker: CONFIG@0, per batch F,F,B,B,U (+GATHER at the batch-2
    # commit): 14 is batch 3's first backward at every position
    plans[victim].arm("pipeline.stage_death", at=14, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    flight = FlightRecorder(str(tmp_path / "flight"))
    reg = MetricsRegistry()
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2, flight=flight, registry=reg)
        _losses, p, _s = _run(co)
        co.shutdown()
    finally:
        fleet.close()
    _assert_close(p, ref_p)
    assert co.stats["recoveries"] == 1
    assert co.stats["batches_lost"] == 0
    assert co.stats["replayed_batches"] == 0  # the commit was batch 2
    assert co.num_stages == 2 and co.generation >= 1
    assert co.stats["detection_s"], "no detection recorded"
    assert [b["trigger"] for b in flight.bundles()] == ["pipeline_stage_death"]
    snap = reg.snapshot()
    assert snap["pipeline_recoveries_total"] == 1
    assert snap["pipeline_stages_lost_total"] >= 1
    assert snap["pipeline_stages"] == 2
    assert snap["pipeline_recovering"] == 0


def test_semi_async_schedule_recovers_too(uninterrupted, tmp_path):
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    plans[1].arm("pipeline.stage_death", at=14, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2)
        _losses, p, _ = _run(co, schedule="semi_async")
        co.shutdown()
    finally:
        fleet.close()
    _assert_close(p, ref_p)
    assert co.stats["recoveries"] == 1 and co.stats["batches_lost"] == 0


def test_kill_past_a_commit_replays_the_journal(uninterrupted, tmp_path):
    """A death on batch 4 (commit at batch 2) replays batch 3 from the
    journal before the aborted batch."""
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    plans[2].arm("pipeline.stage_death", at=17, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2)
        _losses, p, _ = _run(co)
        co.shutdown()
    finally:
        fleet.close()
    _assert_close(p, ref_p)
    assert co.stats["replayed_batches"] == 1
    assert co.stats["batches_lost"] == 0


def test_kill_without_checkpoint_restores_deploy_snapshot(uninterrupted):
    """No checkpoint manager: the deploy-time snapshot is the restore
    target and the journal replays every batch."""
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    plans[1].arm("pipeline.stage_death", at=12, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    try:
        co = _coordinator(fleet.addrs)
        _losses, p, _ = _run(co)
        co.shutdown()
    finally:
        fleet.close()
    _assert_close(p, ref_p)
    assert co.stats["replayed_batches"] == 2
    assert co.stats["batches_lost"] == 0


# -- respawn path: bit-exact replay ----------------------------------------

def test_respawned_worker_rejoins_bit_exact(uninterrupted, tmp_path):
    """The dead worker's port comes back within ``respawn_s``: 3 stages,
    the same partitions, and the replayed trajectory bit for bit."""
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    plans[1].arm("pipeline.stage_death", at=14, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    respawned = {}

    def respawn():
        fleet.threads[1].join(timeout=120)
        host, port = comm.parse_addr(fleet.addrs[1])
        w = StageWorker(0, listen_sock=comm.listen(port, host=host),
                        device="cpu")
        respawned["worker"] = w
        _Fleet._serve(w)

    watcher = threading.Thread(target=respawn, daemon=True)
    watcher.start()
    try:
        co = _coordinator(
            fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
            checkpoint_every=2,
            timeouts=PipelineTimeouts(batch_s=120.0, heartbeat_s=1.0,
                                      respawn_s=60.0))
        _losses, p, _s = _run(co)
        co.shutdown()
    finally:
        fleet.close()
        if "worker" in respawned:
            respawned["worker"].stop()
        watcher.join(timeout=30)
    assert co.num_stages == 3
    assert co.stats["respawns"] >= 1
    assert co.stats["batches_lost"] == 0
    assert all(torch.equal(p[n], ref_p[n]) for n in ref_p)


# -- double faults ---------------------------------------------------------

def test_second_death_during_recovery_reenters(uninterrupted, tmp_path):
    """Stage 0 dies on batch 3's second backward, stage 2 on the recovery's
    re-ship: the recovery re-enters with the shrunken set and finishes on
    1 stage, params still matching."""
    _, ref_p, _ = uninterrupted
    plans = [FaultPlan() for _ in range(3)]
    plans[0].arm("pipeline.stage_death", at=15, exc=InjectedCrash)
    plans[2].arm("pipeline.stage_death", at=16, exc=InjectedCrash)
    fleet = _Fleet(3, plans)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2)
        _losses, p, _s = _run(co)
        co.shutdown()
    finally:
        fleet.close()
    assert co.num_stages == 1
    assert co.stats["batches_lost"] == 0
    _assert_close(p, ref_p)


def test_torn_weight_ship_reenters_idempotently(uninterrupted, tmp_path):
    """``pipeline.weight_ship`` armed with OSError on the coordinator: the
    first recovery's re-ship fails mid-send, and the recovery re-enters
    (fresh generation, fresh sweep); the run completes and matches."""
    _, ref_p, _ = uninterrupted
    wplans = [FaultPlan() for _ in range(3)]
    wplans[1].arm("pipeline.stage_death", at=14, exc=InjectedCrash)
    fleet = _Fleet(3, wplans)
    cplan = FaultPlan().arm("pipeline.weight_ship", at=3, times=1,
                            exc=OSError)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2, fault_plan=cplan)
        _losses, p, _s = _run(co)
        co.shutdown()
    finally:
        fleet.close()
    assert cplan.count("pipeline.weight_ship") > 4
    assert co.generation >= 2
    assert co.stats["batches_lost"] == 0
    _assert_close(p, ref_p)


def test_collapse_below_min_stages_raises(tmp_path):
    plans = [FaultPlan() for _ in range(2)]
    plans[1].arm("pipeline.stage_death", at=2, exc=InjectedCrash)
    fleet = _Fleet(2, plans)
    try:
        co = _coordinator(fleet.addrs, min_stages=2)
        co.deploy_stages()
        x, y = _batches(1)[0]
        with pytest.raises(PipelineCollapsedError):
            co.train_batch_sync(x, y, 0.05, 0)
        co.shutdown()
    finally:
        fleet.close()


# -- worker outlives a dead coordinator ------------------------------------

def _wait_for(pred, deadline_s=120.0):
    end = time.monotonic() + deadline_s
    while not pred() and time.monotonic() < end:
        time.sleep(0.02)
    return pred()


def test_worker_outlives_dead_coordinator():
    """Coordinator A dies abruptly (channels closed, no SHUTDOWN): each
    worker drops it, keeps its stage and listens; coordinator B deploys
    onto the same fleet and trains."""
    fleet = _Fleet(2)
    try:
        a = _coordinator(fleet.addrs)
        a.deploy_stages()
        x, y = _batches(1)[0]
        a.train_batch_sync(x, y, 0.05, 0)
        a._beat_stop.set()
        for ch in a.chans:
            ch.close()
        assert _wait_for(lambda: all(w._coord_chan() is None
                                     for w in fleet.workers)), \
            "workers did not drop the dead coordinator"
        assert all(w.stage is not None for w in fleet.workers)
        b = _coordinator(fleet.addrs, model=_model(seed=1))
        b.deploy_stages()
        loss, _ = b.train_batch_sync(x, y, 0.05, 1)
        assert np.isfinite(loss)
        assert b.health_check()[0]["configured"]
        b.shutdown()
    finally:
        fleet.close()


def test_wedged_coordinator_convicted_by_silence():
    """Coordinator silence past ``coord_timeout_s`` drops it, judged only
    with the inbox drained (fake clock)."""
    clock = [0.0]
    w = StageWorker(0, device="cpu", clock=lambda: clock[0])
    closed = []

    class FakeChan:
        def close(self):
            closed.append(True)
    with w._lock:
        w.coord = FakeChan()
        w._hb_s = 0.05
        w._coord_timeout_s = 0.4
        w._coord_heard = 0.0
    clock[0] = 0.3
    w._check_coordinator()
    assert w._coord_chan() is not None
    clock[0] = 0.5
    w._check_coordinator(drained=False)
    assert w._coord_chan() is not None
    w._check_coordinator(drained=True)
    assert w._coord_chan() is None and closed


# -- coordinator-side liveness units (fake clocks) --------------------------

class _FakeChan:
    def __init__(self):
        self.sent = []
        self.timeout = None

    def send(self, cmd, meta=None, array=None, raw=None, **kw):
        self.sent.append((cmd, meta))

    def set_send_timeout(self, s):
        self.timeout = s

    def close(self):
        pass


def test_probe_then_convict_unit():
    clock = [0.0]
    co = _coordinator(["127.0.0.1:1"],
                      timeouts=PipelineTimeouts(batch_s=60.0,
                                                heartbeat_s=1.0),
                      clock=lambda: clock[0])
    ch = _FakeChan()
    co._install_workers([("127.0.0.1:1", ch)])
    clock[0] = 4.0
    co._check_liveness()
    assert not ch.sent
    clock[0] = 5.5
    co._check_liveness()
    assert [c for c, _ in ch.sent] == ["HEALTH_CHECK"]
    co._check_liveness()
    assert len(ch.sent) == 1
    co._heard(ch)
    clock[0] = 9.0
    co._check_liveness()
    assert len(ch.sent) == 1
    clock[0] = 11.0
    co._check_liveness()
    assert len(ch.sent) == 2
    clock[0] = 14.5
    with pytest.raises(StageLostError, match="unanswered probe"):
        co._check_liveness()
    assert co._detections and co._detections[0][1] == pytest.approx(9.0)


def test_connection_close_is_immediate():
    clock = [0.0]
    co = _coordinator(["127.0.0.1:1"], clock=lambda: clock[0])
    ch = _FakeChan()
    co._install_workers([("127.0.0.1:1", ch)])
    co._on_close(ch)
    with pytest.raises(StageLostError, match="closed"):
        co._check_liveness()


def test_liveness_off_never_probes():
    clock = [0.0]
    co = _coordinator(["127.0.0.1:1"], clock=lambda: clock[0],
                      timeouts=PipelineTimeouts(heartbeat_s=0.0))
    ch = _FakeChan()
    co._install_workers([("127.0.0.1:1", ch)])
    clock[0] = 1e6
    co._check_liveness()
    assert not ch.sent


# -- the timeout contract --------------------------------------------------

def test_timeouts_contract_derivations():
    t = PipelineTimeouts(heartbeat_s=0.5)
    assert t.convict() == pytest.approx(2.5)
    assert t.probe() == pytest.approx(1.5)
    assert t.coord_timeout() == pytest.approx(4.0)
    assert t.drain() == pytest.approx(2.0)
    t2 = PipelineTimeouts(heartbeat_s=2.0, convict_s=3.0, probe_s=1.0,
                          drain_s=0.5, worker_coord_timeout_s=9.0)
    assert (t2.convict(), t2.probe(), t2.drain(), t2.coord_timeout()) == \
        (3.0, 1.0, 0.5, 9.0)
    co = DistributedPipelineCoordinator(
        _model(), SGD(0.05), "softmax_crossentropy",
        workers=["127.0.0.1:1"], timeout=42.0, device="cpu")
    assert co.t.batch_s == 42.0 and co.timeout == 42.0


def test_timeouts_match_jax_defaults():
    from dcnn_tpu.parallel import PipelineTimeouts as JaxTimeouts

    assert PipelineTimeouts() .__dict__ == JaxTimeouts().__dict__
    for hb in (0.05, 0.5, 2.0):
        a, b = PipelineTimeouts(heartbeat_s=hb), JaxTimeouts(heartbeat_s=hb)
        assert (a.convict(), a.probe(), a.coord_timeout(), a.drain()) == \
            (b.convict(), b.probe(), b.coord_timeout(), b.drain())


# -- optimizer state split/merge (a repartition keeps momentum) ------------

@pytest.mark.parametrize("opt", [SGD(0.05, momentum=0.9), Adam(1e-3),
                                 SGD(0.05)])
def test_optimizer_state_split_merge_roundtrip(opt):
    model = _model()
    full = opt.init(dict(model.named_parameters()))
    for v in full.values():
        if isinstance(v, dict):
            for t in v.values():
                t.add_(1.0)
    partitions = [(0, 2), (2, 4), (4, 5)]
    merged = opt.merge_state(opt.split_state(full, partitions), partitions)
    assert list(merged) == list(full)
    for k, v in full.items():
        if isinstance(v, dict):
            assert list(merged[k]) == list(v)
            assert all(torch.equal(merged[k][n], v[n]) for n in v)
        else:
            assert merged[k] == v


# -- checkpoint cadence and journal ----------------------------------------

def test_commit_cadence_and_journal_trim(tmp_path):
    from dcnn_tpu_torch.resilience.checkpoint import list_steps

    fleet = _Fleet(2)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2, checkpoint_keep=2)
        co.deploy_stages()
        for b, (x, y) in enumerate(_batches(6)):
            co.train_batch_sync(x, y, 0.05, b)
        assert sorted(list_steps(str(tmp_path / "ck"))) == [4, 6]
        assert [e["batch"] for e in co._journal] == [5, 6]
        r = co.checkpoints.restore_latest(device="cpu")
        assert r.metadata["batch"] == 6 and r.metadata["stages"] == 2
        p, s = co.gathered_params()
        assert all(torch.equal(t, p[n])
                   for n, t in r.model.named_parameters())
        co.shutdown()
    finally:
        fleet.close()


def test_gather_vintage_and_momentum_roundtrip(tmp_path):
    """A commit carries the optimizer's momentum, full-model shaped, equal
    to the stages' live state."""
    fleet = _Fleet(2)
    try:
        co = _coordinator(fleet.addrs, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_every=2)
        co.deploy_stages()
        for b, (x, y) in enumerate(_batches(2)):
            co.train_batch_sync(x, y, 0.05, b)
        r = co.checkpoints.restore_latest(device="cpu")
        vel = r.opt_state["velocity"]
        assert sorted(vel) == sorted(n for n, _ in co.model.named_parameters())
        assert any(float(v.abs().max()) > 0 for v in vel.values())
        full = co._assemble_full(co._gather_stage_blobs(), co.partitions,
                                 expect_batch=2)
        assert full is not None
        assert all(torch.equal(vel[n], full[2]["velocity"][n]) for n in vel)
        # a gather at another vintage or partitioning is not assembled
        assert co._assemble_full(co._gather_stage_blobs(), co.partitions,
                                 expect_batch=1) is None
        assert co._assemble_full(co._gather_stage_blobs(), [(0, 2), (2, 5)],
                                 expect_batch=2) is None
        co.shutdown()
    finally:
        fleet.close()


# -- the wire under bf16 ----------------------------------------------------

def test_bf16_activation_survives_wire_framing():
    from dcnn_tpu_torch.utils.compression import MetaCompressor

    mc = MetaCompressor()
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32)).to(torch.bfloat16)
    back = mc.decompress_array(mc.compress_array(a))
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, a)


def test_bf16_mode_pipeline_through_the_wire_equals_in_process():
    """Under the bf16 precision mode the activations and gradients on the
    wire are bfloat16: the TCP run equals the in-process one bit for
    bit."""
    mode = get_precision_mode()
    set_precision("bf16")
    fleet = _Fleet(2)
    try:
        co = _coordinator(fleet.addrs)
        co.deploy_stages()
        ref = InProcessPipelineCoordinator(
            _model(), SGD(0.05, momentum=0.9), "softmax_crossentropy", 2,
            devices=["cpu"] * 2, num_microbatches=2)
        ref.deploy_stages()
        for b, (x, y) in enumerate(_batches(3)):
            got = co.train_batch_sync(x, y, 0.05, b)
            want = ref.train_batch_sync(x, y, 0.05, b)
            assert got[1].dtype == torch.bfloat16
            assert got[0] == want[0] and torch.equal(got[1], want[1])
        p, _ = co.gathered_params()
        rp, _ = ref.gathered_params()
        assert all(torch.equal(p[n], rp[n]) for n in rp)
        co.shutdown()
    finally:
        fleet.close()
        set_precision(mode)


# -- healthz adapter -------------------------------------------------------

def test_pipeline_check_degrades_while_recovering():
    from dcnn_tpu_torch.obs.server import pipeline_check

    co = _coordinator(["127.0.0.1:1"])
    check = pipeline_check(co)
    assert check() is None
    co.recovering = True
    co._gen = 3
    reason = check()
    assert "recovery in flight" in reason and "generation 3" in reason


# -- the pipeline half of tests/test_slowness.py ----------------------------

def _p_model():
    b = SequentialBuilder("slow_pipe").input((16,))
    for _ in range(6):
        b = b.dense(16)
    return b.dense(4).build()


def test_measured_partitioner_sheds_layers_off_slow_stage():
    from dcnn_tpu_torch.parallel.partitioner import (
        FlopBalancedPartitioner, MeasuredPartitioner, NaivePartitioner)

    model = _p_model()
    naive = NaivePartitioner().get_partitions(model, 3)
    new = MeasuredPartitioner(naive, [1.0, 30.0, 1.0]).get_partitions(model,
                                                                      3)
    assert new != naive
    assert new[1][1] - new[1][0] < naive[1][1] - naive[1][0]
    assert new[0][0] == 0 and new[-1][1] == len(model.layers)
    for (_, e), (s, _) in zip(new, new[1:]):
        assert e == s
    flat = MeasuredPartitioner(naive, [0.0, 0.0, 0.0])
    assert flat.get_partitions(model, 3) == \
        FlopBalancedPartitioner().get_partitions(model, 3)
    with pytest.raises(ValueError, match="partitions vs"):
        MeasuredPartitioner(naive, [1.0, 2.0])


def _pipe_run(addrs, *, batches, rebalance=False, clock=None, **kw):
    extra = {} if clock is None else {"clock": clock}
    co = DistributedPipelineCoordinator(
        _p_model().init(generator=torch.Generator().manual_seed(0),
                        device="cpu"),
        SGD(0.05, momentum=0.9), "softmax_crossentropy", workers=addrs,
        num_microbatches=2, device="cpu", timeouts=T, **extra, **kw)
    co.deploy_stages()
    for b, (x, y) in enumerate(batches):
        co.train_batch_sync(x, y, 0.05, b)
        if rebalance:
            if clock is not None:
                clock.advance(1.0)  # the detector's dwell, on a fake clock
            co.maybe_rebalance()
    params, _ = co.gathered_params()
    co.shutdown()
    return co, params


class _Clock:
    """A monotonic clock the test advances; real time is added so that
    the protocol's waits still end."""

    def __init__(self):
        self.offset = 0.0

    def advance(self, s):
        self.offset += s

    def __call__(self):
        return time.monotonic() + self.offset


def test_slow_stage_triggers_measured_rebalance(tmp_path):
    """Stage 1 armed ``pipeline.slow_stage`` (50 ms a forward or backward,
    added to its measured wall): the between-batch sweep convicts it as a
    sustained outlier and ships a measured repartition (exact momentum, no
    rewind): final params match the run without the fault, no batch lost,
    and the evidence (imbalance gauge, counter, flight bundle) recorded."""
    batches = [(x, y) for x, y in _batches(8, 8, 0)]
    f = _Fleet(3)
    try:
        _co, ref_params = _pipe_run(f.addrs, batches=batches,
                                    track_load=True)
    finally:
        f.close()

    plans = [FaultPlan() for _ in range(3)]
    plans[1].slow("pipeline.slow_stage", delay_s=0.05)
    reg = MetricsRegistry()
    flight = FlightRecorder(str(tmp_path / "flight"))
    f = _Fleet(3, plans)
    try:
        co, params = _pipe_run(
            f.addrs, batches=batches, rebalance=True, track_load=True,
            registry=reg, flight=flight, clock=_Clock(),
            slow_config=SlownessConfig(min_peers=2, min_samples=2,
                                       dwell_s=0.05))
    finally:
        f.close()
    assert plans[1].slow_count("pipeline.slow_stage") > 0
    assert co.stats["rebalances"] >= 1
    assert co.stats["batches_lost"] == 0
    snap = reg.snapshot()
    assert snap["pipeline_rebalances_total"] == co.stats["rebalances"]
    assert snap["pipeline_stage_imbalance"] > 1.5
    assert any(b["trigger"] == "pipeline_rebalance" for b in flight.bundles())
    for n in ref_params:
        np.testing.assert_allclose(params[n].numpy(), ref_params[n].numpy(),
                                   rtol=RTOL, atol=ATOL)
