"""The port's elastic data parallelism (``parallel/elastic.py``) held to
the JAX package's ``tests/test_elastic.py``, case for case, on the CPU;
and the elastic cases of ``tests/test_slowness.py`` and
``tests/test_trace_dist.py``.

Fleets are threads in one process over loopback sockets, as there. Every
scenario runs twice: a fleet of the port's controllers and a fleet of the
JAX package's, from the same weights (made by the JAX package from the
fleet's seed, carried across by ``interop.from_jax``) over the same rows.
Tolerances: the JAX test's ``RTOL, ATOL = 2e-4, 2e-5`` between a
scenario's run and its uninterrupted baseline (FP reassociation of the
gradient sum), and the same bound between the port's fleet and the JAX
fleet of one scenario; replicas within one fleet are bit-identical.

The straggler case drives the detector on fake clocks (each controller's
``clock`` ticks 10 ms a read, and the injected ``sleep`` of the
``elastic.slow_peer`` delay advances it instead of sleeping), so no bound
on wall-clock time decides it.
"""

import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.data.loader import ArrayDataLoader as JaxLoader
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.parallel import comm as jax_comm
from dcnn_tpu.parallel.elastic import ElasticController as JaxController
from dcnn_tpu.parallel.elastic import PeerSpec as JaxPeerSpec
from dcnn_tpu.resilience import FaultPlan as JaxFaultPlan
from dcnn_tpu.resilience.faults import InjectedCrash as JaxCrash
from dcnn_tpu.train.trainer import create_train_state as jax_create
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data.loader import ArrayDataLoader, one_hot
from dcnn_tpu_torch.interop import (from_jax, grads_to_jax, state_to_jax,
                                    to_jax)
from dcnn_tpu_torch.optim import SGD
from dcnn_tpu_torch.parallel import comm
from dcnn_tpu_torch.parallel.elastic import (
    ElasticController, EvictedError, Membership, PeerSpec,
    WorldCollapsedError, microbatch_span, parse_peers)
from dcnn_tpu_torch.parallel.multihost import PeerLostError
from dcnn_tpu_torch.resilience import FaultPlan
from dcnn_tpu_torch.resilience.faults import InjectedCrash
from dcnn_tpu_torch.train import create_train_state

_rng = np.random.default_rng(0)
X = _rng.normal(size=(48, 16)).astype(np.float32)
Y = one_hot(_rng.integers(0, 4, 48), 4)
BATCH = 12  # 4 global steps/epoch over the 48 rows
SEED = 3

RTOL, ATOL = 2e-4, 2e-5  # FP reassociation of the gradient sum only


def _jax_model():
    # stateless layers only, as in the JAX test: batchnorm statistics are
    # approximately (not bit-) preserved across a reshard
    return (JaxBuilder("elastic_model").input((16,))
            .dense(32).activation("relu").dense(4).build())


# the weights the JAX controllers initialise from seed 3
_JM = _jax_model()
INIT = jax.tree_util.tree_map(
    np.asarray, jax_create(_JM, JaxSGD(0.05), jax.random.PRNGKey(SEED)).params)
CONFIG = _JM.get_config()


def _jax_bn_model():
    # the batchnorm twin: its running statistics are threaded through a
    # host's microbatches, then averaged across hosts by microbatch count
    return (JaxBuilder("elastic_bn").input((16,)).dense(32).batchnorm()
            .activation("relu").dense(4).build())


_JBN = _jax_bn_model()
_BN_TS = jax_create(_JBN, JaxSGD(0.05), jax.random.PRNGKey(SEED))
BN_INIT = jax.tree_util.tree_map(np.asarray, _BN_TS.params)
BN_STATE = jax.tree_util.tree_map(np.asarray, _BN_TS.state)
BN_CONFIG = _JBN.get_config()


def _port_model(bn=False):
    if bn:
        return from_jax(BN_CONFIG, BN_INIT, BN_STATE, device="cpu")
    return from_jax(CONFIG, INIT, device="cpu")


def _loader(pkg="port", **kw):
    cls = ArrayDataLoader if pkg == "port" else JaxLoader
    return cls(X, Y, batch_size=BATCH, seed=7, **kw)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _port_params(ts, bn=False):
    state = _leaves(state_to_jax(ts.model)) if bn else []
    return _leaves(to_jax(ts.model)) + state


def _jax_params(ts, bn=False):
    state = _leaves(jax.device_get(ts.state)) if bn else []
    return _leaves(jax.device_get(ts.params)) + state


class FakeClock:
    """A controller's clock: each read advances ``tick`` seconds, and
    ``sleep`` advances it without sleeping."""

    def __init__(self, tick=0.01):
        self.t, self.tick = 0.0, tick
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            self.t += self.tick
            return self.t

    def sleep(self, s):
        with self.lock:
            self.t += s


def _plan(pkg, spec):
    """A fault plan of ``pkg`` from ``[(method, point, kwargs), ...]``;
    ``crash=True`` arms the package's ``InjectedCrash``."""
    plan = FaultPlan() if pkg == "port" else JaxFaultPlan()
    crash = InjectedCrash if pkg == "port" else JaxCrash
    for method, point, kw in spec:
        kw = dict(kw)
        if kw.pop("crash", False):
            kw["exc"] = crash
        getattr(plan, method)(point, **kw)
    return plan


def run_fleet(pkg, n, *, epochs=3, faults=None, ckpt_dir=None, ckpt_steps=2,
              k=2, min_world=1, slow=False, fake_clock=False, join=None,
              feed_pool=None, bn=False):
    """N in-process peers of ``pkg`` ("port" or "jax") over loopback;
    returns (controllers, results, plans) where a result is the final
    params' leaves (then the running statistics' with ``bn``, which
    trains the batchnorm model), the string "crashed" (simulated host
    death), or the raised exception."""
    faults = faults or {}
    plans = {r: _plan(pkg, spec) for r, spec in faults.items()}
    lib = comm if pkg == "port" else jax_comm
    socks = [lib.listen(0, host="127.0.0.1") for _ in range(n)]
    spec_cls = PeerSpec if pkg == "port" else JaxPeerSpec
    peers = [spec_cls(i, "127.0.0.1", s.getsockname()[1])
             for i, s in enumerate(socks)]
    ctls, results = {}, {}

    def runner(i):
        kw = dict(epochs=epochs, learning_rate=0.05, seed=SEED,
                  snapshot_dir=None, elastic=True, elastic_microbatches=k,
                  elastic_timeout_s=20.0 if slow else 15.0,
                  elastic_heartbeat_s=0.0, elastic_ckpt_steps=ckpt_steps,
                  elastic_min_world=min_world, checkpoint_dir=ckpt_dir)
        if slow:
            kw.update(slow_detect=True, slow_dwell_s=0.2,
                      slow_min_samples=2)
        crash = InjectedCrash if pkg == "port" else JaxCrash
        try:
            if pkg == "port":
                cfg = TrainingConfig(device_type="cpu", **kw)
                clock = FakeClock() if fake_clock else None
                extra = ({"clock": clock, "sleep": clock.sleep}
                         if clock is not None else {})
                model = _port_model(bn)
                opt = SGD(0.05)
                ctl = ElasticController(
                    model, opt, "softmax_crossentropy", _loader(),
                    config=cfg, rank=i, peers=peers, listen_sock=socks[i],
                    fault_plan=plans.get(i), feed_pool=feed_pool, **extra)
                ctls[i] = ctl
                ts = ctl.fit(create_train_state(model, opt), epochs=epochs)
                results[i] = _port_params(ts, bn)
            else:
                ctl = JaxController(
                    _jax_bn_model() if bn else _jax_model(), JaxSGD(0.05),
                    "softmax_crossentropy", _loader("jax"), config=JaxConfig(**kw), rank=i,
                    peers=peers, listen_sock=socks[i],
                    fault_plan=plans.get(i))
                ctls[i] = ctl
                results[i] = _jax_params(ctl.fit(epochs=epochs), bn)
        except crash:
            results[i] = "crashed"
        except Exception as e:  # surfaced to the asserting test
            results[i] = e

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for i in (join if join is not None else range(n)):
        threads[i].join(timeout=120)
        assert not threads[i].is_alive(), f"elastic {pkg} rank {i} hung"
    return ctls, results, plans


def _close(a, b):
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _ok(results, *ranks):
    for r in ranks:
        assert not isinstance(results[r], (str, BaseException)), results[r]


@pytest.fixture(scope="module")
def baseline2():
    """Never-interrupted fixed-world run: 2 peers, K=2, in both packages;
    replicated params bit-identical across the port's peers."""
    ctls, results, _ = run_fleet("port", 2, k=2)
    _equal(results[0], results[1])
    _jc, jres, _ = run_fleet("jax", 2, k=2)
    _close(results[0], jres[0])
    return results[0], ctls[0]


@pytest.fixture(scope="module")
def baseline3():
    """Never-interrupted fixed-world run: 3 peers, K=6."""
    _c, results, _ = run_fleet("port", 3, k=6)
    _jc, jres, _ = run_fleet("jax", 3, k=6)
    _close(results[0], jres[0])
    return results[0]


@pytest.fixture(scope="module")
def baseline3_k3():
    _c, results, _ = run_fleet("port", 3, k=3)
    return results[0]


def _scenario(n, faults, **kw):
    """One scenario in both packages (each with its own checkpoint root):
    the port's (controllers, results) and the JAX fleet's results."""
    with tempfile.TemporaryDirectory() as d:
        ctls, results, _ = run_fleet("port", n, faults=faults, ckpt_dir=d,
                                     **kw)
    with tempfile.TemporaryDirectory() as d:
        _jc, jres, _ = run_fleet("jax", n, faults=faults, ckpt_dir=d, **kw)
    return ctls, results, jres


KILL = ("arm", "elastic.heartbeat", {"at": 6, "crash": True})


# ---------------------------------------------------------------------------
# plan / grid unit coverage
# ---------------------------------------------------------------------------

def test_microbatch_span_partitions_every_world():
    from dcnn_tpu.parallel.elastic import microbatch_span as jax_span

    for total in (1, 2, 3, 6, 8):
        for world in range(1, total + 1):
            owned = []
            for p in range(world):
                lo, hi = microbatch_span(total, world, p)
                assert (lo, hi) == jax_span(total, world, p)
                owned.extend(range(lo, hi))
            assert owned == list(range(total)), (total, world)
    with pytest.raises(ValueError, match="outside world"):
        microbatch_span(4, 2, 2)


def test_shard_batch_indices_union_is_the_global_plan():
    loader, jl = _loader(), _loader("jax")
    loader.shuffle(5)
    jl.shuffle(5)
    ref = [np.asarray(b) for b in loader.batch_indices()]
    for a, b in zip(ref, jl.batch_indices()):
        np.testing.assert_array_equal(a, b)
    for world in (1, 2, 3, 4, 6):
        shards = []
        for r in range(world):
            loader.shuffle(5)
            shards.append(list(loader.shard_batch_indices(r, world)))
        for bi, batch in enumerate(ref):
            got = np.concatenate([shards[r][bi] for r in range(world)])
            np.testing.assert_array_equal(got, batch)


def test_shard_batch_indices_validation():
    loader = _loader()
    with pytest.raises(ValueError, match="divisible"):
        list(loader.shard_batch_indices(0, 5))  # 12 % 5 != 0
    with pytest.raises(ValueError, match="outside world"):
        list(loader.shard_batch_indices(2, 2))
    ragged = _loader(drop_last=False)
    with pytest.raises(ValueError, match="drop_last"):
        list(ragged.shard_batch_indices(0, 2))


def test_host_shard_plan_drives_feed_pool_bit_identically():
    from dcnn_tpu.data.workers import host_shard_plan as jax_plan
    from dcnn_tpu_torch.data.workers import FeedWorkerPool, host_shard_plan

    loader = _loader()
    plan = host_shard_plan(loader, epoch=2, rank=1, world_size=2)
    for a, b in zip(plan, jax_plan(_loader("jax"), epoch=2, rank=1,
                                   world_size=2)):
        np.testing.assert_array_equal(a, b)
    loader.shuffle(2)
    ref = list(loader.shard_batch_indices(1, 2))
    assert len(plan) == len(ref)
    for a, b in zip(plan, ref):
        np.testing.assert_array_equal(a, b)
    replanned = host_shard_plan(loader, epoch=2, rank=0, world_size=1,
                                start_step=2)
    loader.shuffle(2)
    full = [np.asarray(b) for b in loader.batch_indices()]
    for got, want in zip(replanned, full[2:]):
        np.testing.assert_array_equal(got, want)
    pool = FeedWorkerPool(X, Y, max_rows=BATCH, num_workers=0)
    for sel, shard in zip(plan, pool.shards(iter(plan), epoch=2)):
        xg, yg = shard.for_put()
        np.testing.assert_array_equal(xg, X[sel])
        np.testing.assert_array_equal(yg, Y[sel])
        shard.release()
    pool.close()


def test_parse_peers():
    from dcnn_tpu.parallel.elastic import parse_peers as jax_parse

    spec = "10.0.0.1:5000, 10.0.0.2:5001,:5002"
    peers = parse_peers(spec)
    assert peers == [PeerSpec(0, "10.0.0.1", 5000),
                     PeerSpec(1, "10.0.0.2", 5001),
                     PeerSpec(2, "127.0.0.1", 5002)]
    assert [(p.rank, p.host, p.port) for p in peers] == \
        [(p.rank, p.host, p.port) for p in jax_parse(spec)]


# ---------------------------------------------------------------------------
# the headline: kill a host mid-epoch
# ---------------------------------------------------------------------------

def test_solo_elastic_is_deterministic():
    _c1, r1, _ = run_fleet("port", 1, k=2)
    _c2, r2, _ = run_fleet("port", 1, k=2)
    _equal(r1[0], r2[0])
    _jc, jr, _ = run_fleet("jax", 1, k=2)
    _close(r1[0], jr[0])


def test_kill_a_host_mid_epoch_params_match_uninterrupted(baseline2):
    base_params, base_ctl = baseline2
    ctls, results, jres = _scenario(2, {1: [KILL]})
    assert results[1] == "crashed" and jres[1] == "crashed"
    survivor = ctls[0]
    _ok(results, 0)
    assert survivor.stats["reconfigures"] == 1
    assert survivor.gen == 1 and survivor.world == 1
    # every executed optimizer step consumed exactly the global batch
    assert {e["global_rows"] for e in survivor.step_log} == {BATCH}
    assert {e["world"] for e in survivor.step_log} == {1, 2}
    _close(base_params, results[0])
    _close(results[0], jres[0])
    assert len(base_ctl.step_log) == 12
    assert [e["gs"] for e in survivor.step_log][-1] == 12


def test_kill_the_leader_survivor_takes_over(baseline2):
    base_params, _ = baseline2
    ctls, results, jres = _scenario(2, {0: [KILL]})
    assert results[0] == "crashed" and jres[0] == "crashed"
    new_leader = ctls[1]
    _ok(results, 1)
    assert new_leader.gen == 1 and new_leader.world == 1
    assert new_leader.is_leader()
    _close(base_params, results[1])
    _close(results[1], jres[1])


def test_second_loss_during_recovery_is_survived(baseline3):
    """Peer 2 dies mid-epoch; peer 1 dies at reconfiguration entry — the
    leader's first recovery wave fails and the protocol re-enters with
    the shrunken survivor set."""
    faults = {2: [("arm", "elastic.heartbeat", {"at": 5, "crash": True})],
              1: [("arm", "elastic.reconfigure", {"crash": True})]}
    ctls, results, jres = _scenario(3, faults, k=6)
    assert results[2] == "crashed" and results[1] == "crashed"
    leader = ctls[0]
    _ok(results, 0)
    assert leader.gen == 2 and leader.world == 1
    assert leader.stats["peers_lost"] == 2
    _close(baseline3, results[0])
    _close(results[0], jres[0])


def test_uneven_degraded_grid_keeps_global_batch(baseline3_k3):
    """K=3 microbatches over 2 survivors (2+1 microbatches) still sum to
    the exact global batch."""
    faults = {1: [("arm", "elastic.heartbeat", {"at": 5, "crash": True})]}
    ctls, results, jres = _scenario(3, faults, k=3)
    assert results[1] == "crashed"
    _ok(results, 0, 2)
    for r in (0, 2):
        assert ctls[r].world == 2
    _equal(results[0], results[2])
    _close(baseline3_k3, results[0])
    _close(results[0], jres[0])


def test_evicted_peer_exits_instead_of_fighting_the_quorum():
    cfg = TrainingConfig(elastic=True, elastic_microbatches=2,
                         elastic_heartbeat_s=0.0, snapshot_dir=None,
                         device_type="cpu")
    model = _port_model()
    ctl = ElasticController(
        model, SGD(0.05), "softmax_crossentropy", _loader(), config=cfg,
        rank=1, peers=[PeerSpec(0, "127.0.0.1", 0),
                       PeerSpec(1, "127.0.0.1", 0)])
    ts = create_train_state(model, SGD(0.05))
    with pytest.raises(EvictedError, match="excluded from generation 5"):
        ctl._join_reconf({"gen": 5, "survivors": [0], "ckpt_step": -1,
                          "lr": 0.05}, ts)


def test_min_world_floor_aborts_instead_of_limping():
    _c, results, jres = _scenario(2, {1: [KILL]}, min_world=2)
    assert results[1] == "crashed"
    assert isinstance(results[0], WorldCollapsedError)
    assert type(jres[0]).__name__ == "WorldCollapsedError"


# ---------------------------------------------------------------------------
# membership liveness (fake clock, no sockets)
# ---------------------------------------------------------------------------

def test_membership_timeout_detection_fake_clock():
    from dcnn_tpu_torch.obs.registry import MetricsRegistry

    t = [0.0]
    reg = MetricsRegistry()
    m = Membership(0, [PeerSpec(0, "h", 1), PeerSpec(1, "h", 2)],
                   peer_timeout_s=5.0, clock=lambda: t[0], registry=reg)

    class FakeChan:
        def close(self):
            pass

    with m._lock:
        m._channels[1] = FakeChan()
        m._last_heard[1] = t[0]
    assert m.check_peers() == []
    t[0] = 4.0
    m.heard(1)
    t[0] = 8.9  # 4.9s silent — under the timeout
    assert m.check_peers() == []
    assert m.alive() == [0, 1]
    t[0] = 9.1  # 5.1s silent
    assert m.check_peers() == [1]
    assert m.alive() == [0]
    dets = m.pop_detections()
    assert len(dets) == 1
    rank, age = dets[0]
    assert rank == 1 and age == pytest.approx(5.1)
    assert reg.counter("elastic_peers_lost_total").value == 1
    t[0] = 20.0
    assert m.check_peers() == []


def test_membership_beat_thread_lifecycle():
    m = Membership(0, [PeerSpec(0, "h", 1)], heartbeat_s=0.01)
    m._start_beat_thread()
    assert m._hb_thread is not None and m._hb_thread.is_alive()
    m.close()
    assert m._hb_thread is None
    m.close()  # idempotent


# ---------------------------------------------------------------------------
# multihost: typed PeerLostError instead of hanging/leaking
# ---------------------------------------------------------------------------

class _FakeKv:
    def __init__(self, fail=False):
        self.fail = fail
        self.store = {}
        self.barriers = []

    def key_value_set(self, key, value):
        self.store[key] = value

    def blocking_key_value_get(self, key, timeout_ms):
        if self.fail:
            raise RuntimeError(f"Deadline Exceeded after {timeout_ms}ms")
        return self.store[key]

    def wait_at_barrier(self, name, timeout_ms):
        if self.fail:
            raise RuntimeError(f"Barrier timed out after {timeout_ms}ms")
        self.barriers.append(name)


def test_multihost_barrier_raises_typed_peer_lost():
    from dcnn_tpu_torch.parallel import multihost

    kv = _FakeKv(fail=True)
    with pytest.raises(PeerLostError, match=r"barrier\('epoch-1'\)"):
        multihost.barrier("epoch-1", timeout_ms=10, client=kv)
    kv_ok = _FakeKv()
    multihost.barrier("epoch-1", timeout_ms=10, client=kv_ok)
    assert kv_ok.barriers == ["epoch-1"]


def test_multihost_broadcast_config_raises_typed_peer_lost(monkeypatch):
    from dcnn_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    kv = _FakeKv(fail=True)
    with pytest.raises(PeerLostError, match="broadcast_config"):
        multihost.broadcast_config("cfg", {"a": 1}, timeout_ms=10,
                                   client=kv)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    kv_ok = _FakeKv()
    assert multihost.broadcast_config("cfg", {"a": 1}, client=kv_ok) \
        == {"a": 1}
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert multihost.broadcast_config("cfg", {}, client=kv_ok) == {"a": 1}


# ---------------------------------------------------------------------------
# comm: the send path rides the shared retry primitive
# ---------------------------------------------------------------------------

def _channel_pair():
    srv = comm.listen(0, host="127.0.0.1")
    tx = comm.connect("127.0.0.1", srv.getsockname()[1], timeout=5.0)
    sock, _ = srv.accept()
    srv.close()
    return tx, comm.Channel(sock)


def test_send_retries_flaky_fault_then_delivers():
    from dcnn_tpu_torch.obs import get_registry

    tx, rx = _channel_pair()
    try:
        reg = get_registry()
        before = reg.counter("comm_send_retry_attempts_total").value
        with FaultPlan().arm("comm.send", times=2, exc=OSError) as plan:
            tx.send("PING", {"n": 7}, array=np.arange(4, dtype=np.float32),
                    attempts=4, sleep=lambda s: None)
            assert plan.count("comm.send") == 3
        cmd, meta, payload = rx.recv()
        assert cmd == "PING" and meta["n"] == 7
        np.testing.assert_array_equal(payload,
                                      np.arange(4, dtype=np.float32))
        assert reg.counter("comm_send_retry_attempts_total").value \
            == before + 2
    finally:
        tx.close()
        rx.close()


def test_send_exhausted_retries_reraise():
    tx, rx = _channel_pair()
    try:
        with FaultPlan().arm("comm.send", exc=OSError):
            with pytest.raises(OSError):
                tx.send("PING", {}, attempts=3, sleep=lambda s: None)
    finally:
        tx.close()
        rx.close()


def test_send_on_broken_socket_fails_fast_not_retried():
    tx, rx = _channel_pair()
    rx.close()
    big = np.zeros(1 << 20, dtype=np.float32)  # overflow the socket buffer
    slept = []
    with pytest.raises(OSError):
        for _ in range(64):
            tx.send("DATA", {}, array=big, attempts=3,
                    sleep=lambda s: slept.append(s))
    assert tx._broken
    assert slept == []
    with pytest.raises(comm.ChannelClosed):
        tx.send("DATA", {}, attempts=3, sleep=lambda s: None)
    tx.close()


def test_injected_crash_on_send_is_not_retried():
    tx, rx = _channel_pair()
    try:
        with FaultPlan().arm("comm.send", exc=InjectedCrash):
            with pytest.raises(InjectedCrash):
                tx.send("PING", {}, attempts=5, sleep=lambda s: None)
    finally:
        tx.close()
        rx.close()


# ---------------------------------------------------------------------------
# obs: /healthz degrades while reconfiguring
# ---------------------------------------------------------------------------

def test_healthz_degrades_while_reconfiguring():
    from dcnn_tpu_torch.obs import TelemetryServer, elastic_check
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.obs.tracer import Tracer

    class FakeController:
        reconfiguring = False
        generation = 3
        world = 2

    ctl = FakeController()
    srv = TelemetryServer(registry=MetricsRegistry(), tracer=Tracer())
    srv.add_check("elastic", elastic_check(ctl))
    code, body = srv.health()
    assert code == 200
    ctl.reconfiguring = True
    code, body = srv.health()
    assert code == 503
    assert any("reconfiguration in flight" in r for r in body["reasons"])
    assert "generation 3" in body["reasons"][0]
    ctl.reconfiguring = False
    code, _ = srv.health()
    assert code == 200


def test_healthz_registry_flag_fallback_without_check():
    from dcnn_tpu_torch.obs import TelemetryServer
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.obs.tracer import Tracer

    reg = MetricsRegistry()
    srv = TelemetryServer(registry=reg, tracer=Tracer())
    assert srv.health()[0] == 200
    reg.gauge("elastic_reconfiguring", "flag").set(1)
    code, body = srv.health()
    assert code == 503
    assert any("elastic_reconfiguring" in r for r in body["reasons"])
    reg.gauge("elastic_reconfiguring", "flag").set(0)
    assert srv.health()[0] == 200


# ---------------------------------------------------------------------------
# feed pool re-plan + trainer delegation
# ---------------------------------------------------------------------------

def test_elastic_with_feed_pool_matches_plain_path():
    from dcnn_tpu_torch.data.workers import FeedWorkerPool

    _c, r_plain, _ = run_fleet("port", 1, k=2, epochs=2)
    pool = FeedWorkerPool(X, Y, max_rows=BATCH, num_workers=0)
    _c2, r_pool, _ = run_fleet("port", 1, k=2, epochs=2, feed_pool=pool)
    pool.close()
    _equal(r_plain[0], r_pool[0])
    _jc, jr, _ = run_fleet("jax", 1, k=2, epochs=2)
    _close(r_pool[0], jr[0])


def _trainer(cfg):
    from dcnn_tpu_torch.train import Trainer

    model = _port_model()
    trainer = Trainer(model, SGD(0.05), "softmax_crossentropy", cfg)
    return trainer, create_train_state(model, trainer.optimizer)


def test_trainer_fit_delegates_to_elastic():
    cfg = TrainingConfig(
        epochs=2, learning_rate=0.05, seed=SEED, snapshot_dir=None,
        elastic=True, elastic_rank=0, elastic_microbatches=1,
        elastic_heartbeat_s=0.0, device_type="cpu")
    trainer, ts = _trainer(cfg)
    ts = trainer.fit(ts, _loader())
    assert len(trainer.history) == 2
    assert trainer.history[0]["world"] == 1
    assert np.isfinite(trainer.history[-1]["train_loss"])
    assert trainer.elastic.world == 1
    _jc, jr, _ = run_fleet("jax", 1, k=1, epochs=2)
    _close(_port_params(ts), jr[0])


def test_elastic_fit_wires_feed_workers(monkeypatch):
    """``feed_workers`` is not a silent no-op on the elastic path:
    elastic_fit builds the pool and hands it to the controller (patched
    to the serial backend for determinism)."""
    import dcnn_tpu_torch.data.workers as workers_mod

    created = {}
    real_pool = workers_mod.FeedWorkerPool

    def fake_pool(x, y, max_rows, **kw):
        created.update(kw, max_rows=max_rows)
        return real_pool(x, y, max_rows, num_workers=0,
                         seed=kw.get("seed", 0))

    monkeypatch.setattr(workers_mod, "FeedWorkerPool", fake_pool)
    cfg = TrainingConfig(
        epochs=1, learning_rate=0.05, seed=SEED, snapshot_dir=None,
        elastic=True, elastic_rank=0, elastic_microbatches=1,
        elastic_heartbeat_s=0.0, feed_workers=3, device_type="cpu")
    trainer, ts = _trainer(cfg)
    trainer.fit(ts, _loader())
    assert created["num_workers"] == 3
    assert created["max_rows"] == BATCH
    _c, r_plain, _ = run_fleet("port", 1, k=1, epochs=1)
    t2, ts2 = _trainer(cfg)
    ts2 = t2.fit(ts2, _loader())
    _equal(r_plain[0], _port_params(ts2))


def test_elastic_validates_grid_divisibility():
    cfg = TrainingConfig(elastic=True, elastic_microbatches=5,
                         device_type="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ElasticController(
            _port_model(), SGD(0.05), "softmax_crossentropy", _loader(),
            config=cfg, rank=0, peers=[PeerSpec(0, "127.0.0.1", 0)])
    cfg2 = TrainingConfig(elastic=True, elastic_microbatches=3,
                          device_type="cpu")
    with pytest.raises(ValueError, match="initial world"):
        ElasticController(
            _port_model(), SGD(0.05), "softmax_crossentropy", _loader(),
            config=cfg2, rank=0,
            peers=[PeerSpec(0, "127.0.0.1", 0),
                   PeerSpec(1, "127.0.0.1", 1)])


# ---------------------------------------------------------------------------
# tests/test_slowness.py: straggler eviction, on fake clocks
# ---------------------------------------------------------------------------

def test_slow_peer_convicted_and_evicted_params_match(baseline3):
    """Rank 2 armed ``elastic.slow_peer`` (50 ms of fake time a step):
    the leader convicts it, evicts it through the normal reconfiguration,
    and the 2 survivors finish matching the uninterrupted 3-peer run (the
    port's, which matches the JAX package's)."""
    slow = ("slow", "elastic.slow_peer", {"delay_s": 0.05})
    with tempfile.TemporaryDirectory() as d:
        ctls, results, plans = run_fleet(
            "port", 3, k=6, epochs=3, faults={2: [slow]}, ckpt_dir=d,
            slow=True, fake_clock=True, join=[0, 1])
    leader = ctls[0]
    _ok(results, 0, 1)
    assert plans[2].slow_count("elastic.slow_peer") > 0
    assert leader.stats["stragglers_evicted"] == 1
    assert leader.world == 2 and leader.gen >= 1
    assert sorted(leader.survivors) == [0, 1]
    assert {e["global_rows"] for e in leader.step_log} == {BATCH}
    _equal(results[0], results[1])
    _close(baseline3, results[0])


def test_fleet_wide_slowdown_evicts_nobody_elastic():
    """Every peer slowed alike: the median moves with the fleet, nobody
    is convicted, training completes at world 3."""
    slow = ("slow", "elastic.slow_peer", {"factor": 2.5})
    ctls, results, _ = run_fleet(
        "port", 3, k=6, epochs=2, faults={i: [slow] for i in range(3)},
        slow=True, fake_clock=True)
    for i in range(3):
        _ok(results, i)
        assert ctls[i].stats["stragglers_evicted"] == 0
        assert ctls[i].world == 3 and ctls[i].gen == 0


# ---------------------------------------------------------------------------
# tests/test_trace_dist.py: a reconfiguration is one trace
# ---------------------------------------------------------------------------

def test_elastic_reconfiguration_is_one_trace():
    """3 peers, one killed mid-epoch: the follower's restore and rebuild
    spans join the LEADER's elastic.reconfigure trace via the RECONF
    frame's ``_trace`` carrier, and the generation's steps carry it."""
    from dcnn_tpu_torch.obs import configure, get_tracer

    was = get_tracer().enabled
    tracer = configure(enabled=True)
    tracer.clear()
    try:
        kill = ("arm", "elastic.heartbeat", {"at": 5, "crash": True})
        with tempfile.TemporaryDirectory() as d:
            _c, results, _ = run_fleet("port", 3, k=6, epochs=2,
                                       faults={2: [kill]}, ckpt_dir=d)
        evs = tracer.events()
    finally:
        configure(enabled=was)
    assert results[2] == "crashed"
    _ok(results, 0, 1)
    by = {}
    for e in evs:
        by.setdefault(e["name"], []).append(e)
    recs = [e for e in by.get("elastic.reconfigure", [])
            if e["args"].get("rank") == 0 and e["args"].get("gen", 0) > 0]
    assert recs, by.keys()
    lead_tid = recs[-1]["args"]["trace_id"]
    for phase in ("elastic.restore", "elastic.rebuild"):
        joined = [e for e in by.get(phase, [])
                  if e["args"].get("rank") == 1
                  and e["args"].get("trace_id") == lead_tid]
        assert joined, (phase, [e["args"] for e in by.get(phase, [])])
    assert [e for e in by.get("elastic.step", [])
            if e["args"].get("trace_id") == lead_tid]


def test_packed_vector_is_grads_scaled_state_and_loss():
    """The exchanged vector: the gradient sum of the local microbatches,
    ``a ×`` the batchnorm state threaded through them, and the loss sum;
    ``__call__`` gives the JAX step's triple back."""
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.parallel import make_elastic_grad_step

    m = (SequentialBuilder("bn").input((6,)).dense(5).batchnorm()
         .activation("relu").dense(3).build())
    m.init(generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 6)).astype(np.float32))
    y = torch.eye(3)[torch.arange(8) % 3]
    loss = get_loss("softmax_crossentropy")
    start = {k: v.clone() for k, v in m.state_dict().items()}
    step = make_elastic_grad_step(m, loss, 2)
    grads, state, loss_sum = step(None, x, y, 0, 0)
    # the same two microbatches by hand
    m.load_state_dict(start)
    for p in m.parameters():
        p.grad = None
    total = 0.0
    for xi, yi in zip(x.chunk(2), y.chunk(2)):
        li = loss(m(xi), yi)
        li.backward()
        total += float(li)
    for n, p in m.named_parameters():
        torch.testing.assert_close(grads[n], p.grad, rtol=0, atol=0)
    for n, b in m.named_buffers():
        torch.testing.assert_close(state[n], b, rtol=1e-7, atol=0)
    assert float(loss_sum) == pytest.approx(total, rel=1e-6)


@pytest.mark.parametrize("a,mb0", [(1, 0), (2, 2), (4, 0)])
def test_elastic_grad_step_matches_jax_on_batchnorm(a, mb0):
    """``make_elastic_grad_step``'s ``(grad_sum, state_final, loss_sum)``
    on the batchnorm model against the JAX package's from the same weights
    and rows: the gradient sum of ``a`` microbatches and the running
    statistics threaded through them, within ``RTOL, ATOL``."""
    from dcnn_tpu.ops.losses import get_loss as jax_get_loss
    from dcnn_tpu.parallel.data_parallel import \
        make_elastic_grad_step as jax_grad_step
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.parallel import make_elastic_grad_step

    x, y = X[:4 * a], Y[:4 * a]
    g_j, s_j, l_j = jax_grad_step(
        _JBN, jax_get_loss("softmax_crossentropy"), a)(
            BN_INIT, BN_STATE, x, y, jax.random.PRNGKey(0), mb0)
    m = _port_model(bn=True)
    grads, state, loss_sum = make_elastic_grad_step(
        m, get_loss("softmax_crossentropy"), a)(
            None, torch.from_numpy(x), torch.from_numpy(y), 0, mb0)
    for n, p in m.named_parameters():
        p.grad = grads[n]
    _close(_leaves(grads_to_jax(m)), _leaves(g_j))
    with torch.no_grad():
        for n, b in m.named_buffers():
            b.copy_(state[n])
    got_state = _leaves(state_to_jax(m))
    _close(got_state, _leaves(s_j))
    # the statistics moved: the comparison is not of two initial states
    assert any(not np.allclose(g, s0)
               for g, s0 in zip(got_state, _leaves(BN_STATE)))
    assert float(loss_sum) == pytest.approx(float(l_j), rel=RTOL)


@pytest.mark.parametrize("k", [2, 4])
def test_batchnorm_fleet_matches_jax_fleet(k):
    """An uninterrupted 2-peer fleet of the batchnorm model, K=2 and K=4,
    in both packages: params and running statistics (each host's
    statistics threaded through its microbatches, then averaged weighted
    by microbatch count) within ``RTOL, ATOL``; replicas bit-identical."""
    ctls, results, _ = run_fleet("port", 2, k=k, bn=True)
    _ok(results, 0, 1)
    _equal(results[0], results[1])
    for h in ctls[0].history:  # each step's loss, the epoch's mean of them
        losses = [e["loss"] for e in ctls[0].step_log
                  if e["epoch"] == h["epoch"]]
        assert np.mean(losses) == pytest.approx(h["train_loss"], rel=1e-12)
    _jc, jres, _ = run_fleet("jax", 2, k=k, bn=True)
    _ok(jres, 0, 1)
    _close(results[0], jres[0])
    n_state = len(_leaves(BN_STATE))
    assert any(not np.allclose(g, s0) for g, s0 in
               zip(results[0][-n_state:], _leaves(BN_STATE)))


def test_elastic_fit_serves_its_telemetry(monkeypatch):
    """With ``metrics_port`` the elastic fit serves ``/healthz`` over its
    controller (JAX ``elastic_fit``'s wiring), and the non-elastic fit
    serves the trainer's own plane, ``/goodput`` among its routes."""
    import dataclasses

    import dcnn_tpu_torch.obs as obs

    served = []

    class Recorded(obs.TelemetryServer):
        def start(self):
            served.append(self)
            return super().start()

    monkeypatch.setattr(obs, "TelemetryServer", Recorded)
    cfg = TrainingConfig(
        epochs=1, learning_rate=0.05, seed=SEED, snapshot_dir=None,
        elastic=True, elastic_rank=0, elastic_microbatches=1,
        elastic_heartbeat_s=0.0, metrics_port=0, device_type="cpu")
    trainer, ts = _trainer(cfg)
    trainer.fit(ts, _loader())
    assert len(served) == 1
    code, body = served[0].health()
    assert code == 200, body
    trainer, ts = _trainer(dataclasses.replace(cfg, elastic=False))
    trainer.fit(ts, _loader())
    assert len(served) == 2
    code, body = served[1].health()
    assert code == 200, body
    code, doc = served[1].route_body("/goodput")
    assert code == 200 and "bottleneck" in doc, doc


def test_reconfiguration_suppresses_the_anomaly_monitor(monkeypatch,
                                                        tmp_path):
    """A host killed mid-epoch: the survivor's reconfiguration runs under
    ``obs.anomaly.suppress()`` (as JAX ``elastic.py`` fences it), so a
    step-time sample observed during it opens no anomaly episode and feeds
    no band; the fence is lifted after."""
    from dcnn_tpu_torch.obs import MetricsRegistry, anomaly

    seen = []
    orig = ElasticController._reconfigure_once

    def spy(self, sig, ts):
        mon = anomaly.AnomalyMonitor(
            registry=MetricsRegistry(), flight=_NoFlight(),
            detector=anomaly.EwmaBand(warmup=0), profiler=lambda d: None)
        seen.append((anomaly.is_suppressed(), mon.observe_step(1e6),
                     mon.detector.mean))
        return orig(self, sig, ts)

    monkeypatch.setattr(ElasticController, "_reconfigure_once", spy)
    ctls, results, _ = run_fleet("port", 2, faults={1: [KILL]},
                                 ckpt_dir=str(tmp_path))
    assert results[1] == "crashed"
    _ok(results, 0)
    assert ctls[0].stats["reconfigures"] == 1
    assert seen and all(s == (True, False, None) for s in seen), seen
    assert not anomaly.is_suppressed()


class _NoFlight:
    def record(self, trigger, **kw):
        raise AssertionError(f"a capture fired under suppress: {trigger}")


def test_recv_reads_a_closed_peers_queued_frame_first():
    """A leader that broadcasts its last GSUM and finishes closes its
    connection; the follower must still read the queued frame before it
    judges the leader dead (else it drops the step and reconfigures
    alone). ``_recv`` returns a dead peer's queued frame, and raises
    ``PeerLostError`` only once the inbox is drained."""
    from types import SimpleNamespace

    from dcnn_tpu_torch.obs import MetricsRegistry

    inbox = comm.Inbox()
    inbox.post("GSUM", {"gen": 0, "step": 11, "rank": 0}, "payload")
    membership = SimpleNamespace(inbox=inbox, dead=lambda: {0},
                                 heard=lambda r: None,
                                 check_peers=lambda: None)
    clock = FakeClock()
    ctl = SimpleNamespace(membership=membership, _clock=clock, poll_s=0.0,
                          cfg=SimpleNamespace(elastic_timeout_s=5.0),
                          slowness=None, gen=0, _reg=MetricsRegistry())
    got = ElasticController._recv(ctl, {"GSUM"}, clock() + 5.0, {0},
                                  match=lambda m: m.get("step") == 11)
    assert got[0] == "GSUM" and got[2] == "payload"
    with pytest.raises(PeerLostError, match="peer connection lost"):
        ElasticController._recv(ctl, {"GSUM"}, clock() + 5.0, {0})
