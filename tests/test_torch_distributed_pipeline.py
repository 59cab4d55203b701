"""The port's TCP pipeline (``dcnn_tpu_torch/parallel/distributed_pipeline.py``
and ``worker.py``) held on the CPU against the port's in-process pipeline
and the JAX package's: twins of ``tests/test_distributed_pipeline.py``
over two ``python -m dcnn_tpu_torch.parallel.worker --device cpu``
processes, of the socket-free coordinator cases of
``tests/test_pipeline_failures.py`` and of ``tests/test_protocol_fences.py``.

The module's fleet of two worker processes serves one
``DistributedPipelineCoordinator`` that runs in lockstep with the port's
``InProcessPipelineCoordinator`` and the JAX package's, all three from one
set of JAX weights (``interop.from_jax``), over the same batches. Against
the port's in-process coordinator every loss, logit and parameter is equal
bit for bit; against the JAX package's within ``test_torch_pipeline.py``'s
tolerances: loss 1e-4 relative / 1e-5 absolute, logits 1e-4 / 1e-5,
params 1e-3 / 1e-5. No wall-clock bound is asserted: the timeouts are
generous (heartbeat 1 s, batch 120 s) and only bound a hang.
"""

import collections
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.parallel import InProcessPipelineCoordinator as JaxCoord
from dcnn_tpu.parallel import PipelineError as JaxPipelineError
from dcnn_tpu_torch.interop import from_jax, to_jax
from dcnn_tpu_torch.obs import get_registry
from dcnn_tpu_torch.optim import SGD, Adam
from dcnn_tpu_torch.parallel import (
    DistributedPipelineCoordinator, InProcessPipelineCoordinator,
    PipelineError, PipelineTimeouts, PipelineWorkerError,
)
from dcnn_tpu_torch.parallel.comm import Inbox
from dcnn_tpu_torch.parallel.distributed_pipeline import (
    _pack_weights, _unpack_weights,
)
from dcnn_tpu_torch.parallel.pipeline import format_profiling
from dcnn_tpu_torch.parallel.worker import StageWorker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(3)
LOSS = "softmax_crossentropy"
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
T = PipelineTimeouts(batch_s=120.0, heartbeat_s=1.0, connect_s=120.0)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def _jax_model():
    return (JaxBuilder("dist_pipe_test").input((3, 8, 8))
            .conv2d(4, 3, 1, 1).activation("relu")
            .conv2d(4, 3, 1, 1).activation("relu")
            .flatten().dense(16).activation("relu").dense(4).build())


def _port_model(jm):
    p, s = jm.init(KEY)
    np_tree = jax.tree_util.tree_map(np.asarray, (p, s))
    return from_jax(jm.get_config(), *np_tree, device="cpu")


def _batch(rng, n=8, hw=8):
    x = rng.normal(size=(n, 3, hw, hw)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=n)]
    return x, y


def _env():
    # not DCNN_PRECISION: a test that imported bench.py (another file on
    # the same xdist worker) set it to bf16 in this process, and the
    # workers compute at the port's default (parity), as the reference
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DCNN_PRECISION")}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture(scope="module")
def workers():
    """Two stage-worker processes on free ports, on the CPU."""
    ports = _free_ports(2)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dcnn_tpu_torch.parallel.worker", "--port",
         str(p), "--host", "127.0.0.1", "--device", "cpu"],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in ports]
    yield [f"127.0.0.1:{p}" for p in ports], procs
    for pr in procs:
        if pr.poll() is None:
            pr.kill()
        pr.wait(timeout=30)


class Lockstep:
    """The TCP coordinator beside the port's and the JAX package's
    in-process coordinators, from one set of JAX weights."""

    def __init__(self, addrs):
        jm = _jax_model()
        self.jm = jm
        self.tcp = DistributedPipelineCoordinator(
            _port_model(jm), SGD(0.05, momentum=0.9), LOSS, workers=addrs,
            num_microbatches=2, track_load=True, compress="shuffle-lz4",
            device="cpu", timeouts=T)
        self.tcp.deploy_stages()
        self.ref = InProcessPipelineCoordinator(
            _port_model(jm), SGD(0.05, momentum=0.9), LOSS, num_stages=2,
            devices=["cpu", "cpu"], num_microbatches=2)
        self.ref.deploy_stages()
        self.jax = JaxCoord(jm, JaxSGD(0.05, momentum=0.9), LOSS,
                            num_stages=2, num_microbatches=2)
        self.jax.deploy_stages(KEY)

    def train(self, schedule, x, y, lr, key):
        name = f"train_batch_{schedule}"
        got = getattr(self.tcp, name)(x, y, lr, key)
        ref = getattr(self.ref, name)(x, y, lr, key)
        jx = getattr(self.jax, name)(x, y, lr, jax.random.PRNGKey(key))
        assert got[0] == ref[0]
        assert torch.equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], jx[0], **LOSS_TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jx[1]),
                                   **FWD_TOL)
        return got[0]

    def check_params(self):
        p, s = self.tcp.gathered_params()
        rp, rs = self.ref.gathered_params()
        assert list(p) == list(rp) and list(s) == list(rs)
        for n in rp:
            assert torch.equal(p[n], rp[n]), n
        m = _port_model(self.jm)
        with torch.no_grad():
            for n, t in m.named_parameters():
                t.copy_(p[n])
        jp, _ = self.jax.gathered_params()
        for a, b in zip(jax.tree_util.tree_leaves(to_jax(m)),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       **PARAM_TOL)


@pytest.fixture(scope="module")
def lockstep(workers):
    addrs, _ = workers
    ls = Lockstep(addrs)
    yield ls
    ls.tcp.shutdown()


def test_sync_matches_in_process_bit_for_bit_and_jax(lockstep):
    rng = np.random.default_rng(7)
    for b in range(3):
        x, y = _batch(rng)
        lockstep.train("sync", x, y, 0.05, 100 + b)
    lockstep.check_params()
    assert lockstep.tcp.partitions == lockstep.ref.partitions == [(0, 4),
                                                                  (4, 8)]


def test_semi_async_matches_in_process_and_trains(lockstep):
    rng = np.random.default_rng(11)
    x, y = _batch(rng, n=16)
    losses = [lockstep.train("semi_async", x, y, 0.05, b) for b in range(4)]
    assert losses[-1] < losses[0]
    lockstep.check_params()


def test_forward_only_and_load_reports(lockstep):
    x, y = _batch(np.random.default_rng(3))
    lockstep.train("sync", x, y, 0.05, 9)
    out = lockstep.tcp.forward_only(x)
    assert out.shape == (8, 4)
    assert torch.equal(out, lockstep.ref.forward_only(x))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(lockstep.jax.forward_only(x)),
                               **FWD_TOL)
    reports = lockstep.tcp.collect_load_reports()
    assert len(reports) == 2
    assert all(r["forward_count"] > 0 and r["backward_count"] > 0
               for r in reports)
    walls = lockstep.tcp.stage_walls()
    assert len(walls) == 2 and all(w > 0 for w in walls)


def test_health_check_heartbeat(lockstep):
    vitals = lockstep.tcp.health_check()
    assert [v["stage_id"] for v in vitals] == [0, 1]
    assert all(v["configured"] for v in vitals)
    assert all(v["rss_kb"] >= 0 for v in vitals)
    assert all(v["batch"] == lockstep.tcp._batch for v in vitals)
    assert len(lockstep.tcp.health_check()) == 2


def test_profiling_broadcast(lockstep):
    rng = np.random.default_rng(17)
    x, y = _batch(rng)
    lockstep.train("sync", x, y, 0.05, 5)
    tables = lockstep.tcp.collect_profiling()
    assert [t["stage_id"] for t in tables] == [0, 1]
    names = []
    for t in tables:
        assert t["layers"]
        assert all(r["calls"] >= 1 for r in t["layers"])
        names += [r["name"] for r in t["layers"]]
    assert names == [l.name for l in lockstep.jm.layers]
    t2 = lockstep.tcp.collect_profiling()
    assert t2[0]["layers"][0]["calls"] > tables[0]["layers"][0]["calls"]
    lockstep.tcp.clear_profiling()
    t3 = lockstep.tcp.collect_profiling()
    assert t3[0]["layers"][0]["calls"] == 1
    txt = format_profiling(t3)
    assert "stage" in txt and names[0] in txt and names[-1] in txt
    # profiling replays put everything back: the lockstep still holds
    lockstep.train("sync", x, y, 0.05, 6)
    lockstep.check_params()


def test_worker_error_reported_and_recoverable(lockstep):
    """A bad input surfaces as PipelineWorkerError with the remote
    traceback (PipelineError in one process), and every coordinator keeps
    training in lockstep afterwards."""
    rng = np.random.default_rng(13)
    bad_x = rng.normal(size=(8, 3, 5, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=8)]
    with pytest.raises(PipelineWorkerError) as ei:
        lockstep.tcp.train_batch_sync(bad_x, y, 0.05, 0)
    assert "Traceback" in ei.value.remote_traceback
    with pytest.raises(PipelineError):
        lockstep.ref.train_batch_sync(bad_x, y, 0.05, 0)
    with pytest.raises((JaxPipelineError, TypeError, ValueError)):
        lockstep.jax.train_batch_sync(bad_x, y, 0.05, jax.random.PRNGKey(0))
    x, y = _batch(rng)
    assert np.isfinite(lockstep.train("sync", x, y, 0.05, 1))
    lockstep.check_params()


def test_worker_without_card_or_cpu_flag_exits_nonzero():
    """No fallback: asked for the card on a host without one, the worker
    raises at start."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "-m", "dcnn_tpu_torch.parallel.worker", "--port",
         str(_free_ports(1)[0])], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "listening" not in out.stdout


def test_worker_cli_help():
    out = subprocess.run(
        [sys.executable, "-m", "dcnn_tpu_torch.parallel.worker", "--help"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0
    for flag in ("--port", "--compress", "--device", "--deterministic"):
        assert flag in out.stdout
    assert "RuntimeWarning" not in out.stderr


# -- the weight blob, by name ----------------------------------------------

@pytest.mark.parametrize("opt", [SGD(0.05, momentum=0.9), Adam(1e-3),
                                 SGD(0.05)])
def test_weight_blob_roundtrips_by_name(opt):
    """Params, layer state and optimizer state (Adam's step an int)
    round-trip by name through the blob, bfloat16 as its bits; split per
    stage and merged back they are the model's."""
    m = _port_model(_jax_model())
    params = {n: t.detach().clone() for n, t in m.named_parameters()}
    params["layers.0.w"] = params["layers.0.w"].to(torch.bfloat16)
    state = {"layers.9.running_mean": torch.arange(3.0)}
    ost = opt.init(params)
    for k, v in ost.items():
        if isinstance(v, dict):
            for t in v.values():
                t.add_(1.5)
        else:
            ost[k] = 7
    p, s, o = _unpack_weights(_pack_weights(params, state, ost))
    assert list(p) == list(params) and list(s) == list(state)
    for n in params:
        assert p[n].dtype == params[n].dtype
        assert torch.equal(p[n], params[n])
    assert torch.equal(s["layers.9.running_mean"], torch.arange(3.0))
    assert set(o) == set(ost)
    for k, v in ost.items():
        if isinstance(v, dict):
            assert all(torch.equal(o[k][n], v[n]) for n in v)
        else:
            assert o[k] == 7 and isinstance(o[k], int)
    assert _unpack_weights(_pack_weights(params, {}))[2] is None
    assert _unpack_weights(_pack_weights({}, {}, {}))[2] == {}
    parts = [(0, 4), (4, 8)]
    split = opt.split_state(ost, parts)
    blobs = [_unpack_weights(_pack_weights({}, {}, st))[2] for st in split]
    merged = opt.merge_state(blobs, parts)
    for k, v in ost.items():
        if isinstance(v, dict):
            assert list(merged[k]) == list(v)
            assert all(torch.equal(merged[k][n], v[n]) for n in v)
        else:
            assert merged[k] == v


def test_stage_reship_by_name_keeps_weights_and_momentum():
    """A worker's re-ship (``PipelineStage.from_config`` + ``set_weights``
    from a blob) holds the gathered weights and optimizer state exactly."""
    from dcnn_tpu_torch.parallel.pipeline import PipelineStage

    m = _port_model(_jax_model())
    opt = SGD(0.05, momentum=0.9)
    parts = [(0, 4), (4, 8)]
    stage_models = m.split(parts)
    sp = m.split_params(dict(m.named_parameters()), parts)
    st = PipelineStage.from_config(1, stage_models[1].get_config(),
                                   opt.get_config(), "cpu")
    ost = opt.init(sp[1])
    for t in ost["velocity"].values():
        t.normal_()
    st.set_weights(*_unpack_weights(_pack_weights(sp[1], {}, ost)))
    p, _, o = _unpack_weights(_pack_weights(st.params, st.state,
                                            st.opt_state))
    assert all(torch.equal(p[n], sp[1][n]) for n in sp[1])
    assert all(torch.equal(o["velocity"][n], ost["velocity"][n])
               for n in ost["velocity"])


# -- twins of the socket-free cases of tests/test_pipeline_failures.py -----

def _bare_coordinator(timeout=1.0):
    co = DistributedPipelineCoordinator.__new__(DistributedPipelineCoordinator)
    co.inbox = Inbox()
    co.timeout = timeout
    co._gen = 0
    co._deferred = collections.deque()
    return co


def test_health_join_defers_batch_messages():
    co = _bare_coordinator()
    co._health_nonce = 42
    co.inbox._q.put(("FORWARD_RESULT", {"mb_id": 0, "gen": 0}, "act", None))
    co.inbox._q.put(("HEALTH_ACK", {"stage_id": 0, "nonce": 42}, None, None))
    co.inbox._q.put(("HEALTH_ACK", {"stage_id": 1, "nonce": 42}, None, None))
    acks = co._join("HEALTH_ACK", 2, buffer_others=True)
    assert [m["stage_id"] for m, _ in acks] == [0, 1]
    co._health_nonce = None
    got = co._join("FORWARD_RESULT", 1)
    assert got[0][1] == "act"


def test_strict_join_still_rejects_protocol_errors():
    co = _bare_coordinator()
    co.inbox._q.put(("LOAD_REPORT", {"stage_id": 0}, None, None))
    with pytest.raises(RuntimeError, match="expected PARAMETERS_UPDATED"):
        co._join("PARAMETERS_UPDATED", 1)


def test_stale_profiling_reply_is_dropped():
    co = _bare_coordinator(timeout=0.2)
    co._profiling_nonce = 7
    co.inbox._q.put(("PROFILING_REPORT", {"stage_id": 0, "nonce": 3,
                                          "profile": {"stale": True}},
                     None, None))
    co.inbox._q.put(("PROFILING_REPORT", {"stage_id": 0, "nonce": 7,
                                          "profile": {"stale": False}},
                     None, None))
    got = co._join("PROFILING_REPORT", 1, buffer_others=True)
    assert got[0][0]["profile"] == {"stale": False}
    co._profiling_nonce = None
    co.inbox._q.put(("PROFILING_CLEARED", {"stage_id": 0, "nonce": 3},
                     None, None))
    with pytest.raises(TimeoutError):
        co._join("ANYTHING", 1)


def test_stale_generation_messages_are_fenced():
    co = _bare_coordinator(timeout=0.2)
    co._gen = 2
    co.inbox._q.put(("FORWARD_RESULT", {"mb_id": 0, "gen": 1}, "old", None))
    co.inbox._q.put(("ABORTED", {"gen": 2}, None, None))
    co.inbox._q.put(("FORWARD_RESULT", {"mb_id": 0, "gen": 2}, "new", None))
    assert co._join("FORWARD_RESULT", 1)[0][1] == "new"
    co.inbox._q.put(("ERROR_REPORT", {"stage_id": 1, "error": "boom"},
                     None, None))
    # an ERROR_REPORT aborts (a generation bump) before it raises
    co.chans, co.num_stages = [], 0
    co._lock, co._dead, co._reg = threading.Lock(), {}, get_registry()
    co.t, co._clock = PipelineTimeouts(drain_s=0.01), time.monotonic
    with pytest.raises(PipelineWorkerError, match="boom"):
        co._join("FORWARD_RESULT", 1)
    assert co.generation == 3


# -- twins of tests/test_protocol_fences.py --------------------------------

class RecordingChannel:
    def __init__(self):
        self.sent = []

    def send(self, cmd, meta=None, array=None, raw=None, **kw):
        self.sent.append((cmd, dict(meta or {})))


class FakeStage:
    def __init__(self):
        self.aborts = []
        self.load = self

    def abort(self, snap=None):
        self.aborts.append(snap)

    def report(self):
        return {"fwd_ms": 1.0}


def make_worker():
    w = StageWorker(port=0, device="cpu")
    w.coord = RecordingChannel()
    w.stage = FakeStage()
    return w


def test_stale_abort_does_not_regress_generation():
    w = make_worker()
    w._dispatch("ABORT", {"gen": 3}, None, None)
    assert w.gen == 3
    assert w.coord.sent[-1] == ("ABORTED", {"stage_id": -1, "gen": 3})
    n_acks, n_aborts = len(w.coord.sent), len(w.stage.aborts)
    w._dispatch("ABORT", {"gen": 2}, None, None)
    assert w.gen == 3
    assert len(w.coord.sent) == n_acks and len(w.stage.aborts) == n_aborts
    w._dispatch("ABORT", {"gen": 3}, None, None)
    assert w.gen == 3 and len(w.coord.sent) == n_acks
    w._dispatch("ABORT", {"gen": 4}, None, None)
    assert w.gen == 4
    assert w.coord.sent[-1][0] == "ABORTED"
    assert len(w.stage.aborts) == n_aborts + 1


def test_genless_abort_still_advances():
    w = make_worker()
    w.gen = 5
    w._dispatch("ABORT", {}, None, None)
    assert w.gen == 6


def test_stale_job_stays_fenced_after_stale_abort():
    w = make_worker()
    w._dispatch("ABORT", {"gen": 3}, None, None)
    w._dispatch("ABORT", {"gen": 1}, None, None)
    assert w.gen == 3
    w._dispatch("FORWARD_JOB", {"gen": 1, "mb_id": 0}, None, None)
    assert all(c != "FORWARD_RESULT" for c, _ in w.coord.sent)


def test_worker_echoes_load_report_nonce():
    w = make_worker()
    w._dispatch("LOAD_REPORT_REQUEST", {"nonce": 42}, None, None)
    cmd, meta = w.coord.sent[-1]
    assert cmd == "LOAD_REPORT" and meta["nonce"] == 42
    assert meta["report"] == {"fwd_ms": 1.0}


def test_unknown_command_raises():
    with pytest.raises(ValueError, match="unknown command"):
        make_worker()._dispatch("NOPE", {}, None, None)


class EchoStageChannel:
    def __init__(self, inbox, stage_id, report):
        self.inbox, self.stage_id, self.report = inbox, stage_id, report

    def send(self, cmd, meta=None, array=None, raw=None, **kw):
        assert cmd == "LOAD_REPORT_REQUEST"
        self.inbox.post("LOAD_REPORT",
                        {"stage_id": self.stage_id,
                         "nonce": (meta or {}).get("nonce"),
                         "report": self.report})


def make_coordinator(n_stages, reports):
    c = object.__new__(DistributedPipelineCoordinator)
    c.inbox = Inbox()
    c._deferred = collections.deque()
    c.chans = [EchoStageChannel(c.inbox, i, reports[i])
               for i in range(n_stages)]
    c.num_stages = n_stages
    c.timeout = 5.0
    c._gen = 0
    return c


def test_stale_load_report_is_fenced():
    fresh = [{"fwd_ms": 10.0}, {"fwd_ms": 20.0}]
    c = make_coordinator(2, fresh)
    c.inbox.post("LOAD_REPORT", {"stage_id": 0, "nonce": 12345,
                                 "report": {"fwd_ms": 999.0}})
    assert c.collect_load_reports() == fresh
    assert c._load_nonce is None


def test_nonceless_load_report_is_fenced_too():
    fresh = [{"fwd_ms": 10.0}]
    c = make_coordinator(1, fresh)
    c.inbox.post("LOAD_REPORT", {"stage_id": 0,
                                 "report": {"fwd_ms": 999.0}})
    assert c.collect_load_reports() == fresh


def test_package_exports_match_jax():
    """``dcnn_tpu_torch.parallel`` exports what ``dcnn_tpu.parallel``
    exports from the pipeline modules, and ``dcnn_tpu_torch.utils`` what
    ``dcnn_tpu.utils`` exports."""
    import dcnn_tpu.parallel as jax_parallel
    import dcnn_tpu.utils as jax_utils
    import dcnn_tpu_torch.parallel as parallel
    import dcnn_tpu_torch.utils as utils

    pipeline_names = {
        n for n in jax_parallel.__all__
        if getattr(getattr(jax_parallel, n), "__module__", "").split(".")[-1]
        in (
            "partitioner", "pipeline", "compiled_pipeline",
            "distributed_pipeline", "worker")}
    assert pipeline_names - {"shard_stacked"} <= set(parallel.__all__)
    for n in parallel.__all__:
        assert getattr(parallel, n) is not None
    assert set(utils.__all__) == set(jax_utils.__all__)
    doc = parallel.__doc__
    unported = doc.split("Not ported yet")[1] if "Not ported yet" in doc \
        else ""
    assert "TCP" not in unported and "comm" not in unported
    assert "Ported so far" not in utils.__doc__
