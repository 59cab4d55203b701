"""The port's trace merge and flight-bundle CLI
(``dcnn_tpu_torch/obs/trace.py``) and the flight triggers the fleet plane
reaches, held to the JAX package's ``tests/test_trace_dist.py`` on the
CPU. The tracer's own cases have their twins in
``tests/test_torch_obs.py`` and ``tests/test_torch_router.py``.

- **Merge**: shards whose clocks disagree align on the handshake offset
  (``--offset`` or the header's ``clock_offset_s``); writers' drops are
  summed; the Chrome file passes ``validate_chrome``. **Parity**: the
  same shards through both packages' ``merge_shards`` give equal Chrome
  JSON and equal summaries.
- **CLI**: ``python -m dcnn_tpu_torch.obs.trace merge|inspect`` in a
  subprocess, exit codes 0, 1 and 2.
- **Triggers**: the replica-death, canary-rollback and autoscale
  SLO-breach bundles, each read back by ``inspect_bundle`` (the first two
  through both packages' ``inspect_bundle``, equal but for paths, times
  and process identity).
- **Elastic**: a 3-peer fleet of the port loses a host; its one JSONL
  shard merges into a Chrome trace where the follower's restore and
  rebuild spans carry the leader's reconfiguration trace id.
- **Acceptance**: a kill-a-replica soak across three processes (the
  router here, two ``ReplicaServer`` children of the port, tracing on):
  one merged trace in which a request's ``trace_id`` spans two pids, and
  ``replica_death`` and ``healthz_degraded`` bundles carrying the 503
  reasons and correlated spans.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import dcnn_tpu.obs.flight as j_flight
import dcnn_tpu.obs as j_obs
import dcnn_tpu.obs.trace as j_trace
import dcnn_tpu.resilience.faults as j_faults
import dcnn_tpu.serve as j_serve
import dcnn_tpu.serve.soak as j_soak
import dcnn_tpu_torch.obs.flight as t_flight
import dcnn_tpu_torch.obs.trace as t_trace
import dcnn_tpu_torch.resilience.faults as t_faults
import dcnn_tpu_torch.serve as t_serve
import dcnn_tpu_torch.serve.soak as t_soak
from dcnn_tpu_torch.obs import configure, get_tracer
from dcnn_tpu_torch.obs.flight import FlightRecorder
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.obs.trace import (inspect_bundle, merge_shards,
                                      read_shard, validate_chrome)
from dcnn_tpu_torch.obs.tracer import Tracer
from dcnn_tpu_torch.resilience.faults import FaultPlan
from dcnn_tpu_torch.serve import (Autoscaler, AutoscalerConfig,
                                  LocalReplica, Router, TcpReplica)
from dcnn_tpu_torch.serve.autoscale import FleetSignals
from dcnn_tpu_torch.serve.soak import ManualClock, synthetic_engine_factory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tracer_on():
    t = configure(enabled=True)
    t.clear()
    yield t
    configure(enabled=False)
    t.clear()


@pytest.fixture
def tracers_fresh():
    """Both packages' process tracers off and empty, as a fresh process
    has them: a flight bundle holds the tracer's spans, so spans that an
    earlier test on the same worker left there would differ between the
    packages. Each tracer's enabled state is restored afterwards."""
    pairs = ((configure, get_tracer), (j_obs.configure, j_obs.get_tracer))
    was = [get().enabled for _, get in pairs]
    for conf, _ in pairs:
        conf(enabled=False).clear()
    yield
    for (conf, _), on in zip(pairs, was):
        conf(enabled=on)


def _write_shard(path, epoch, spans):
    fc = ManualClock(epoch)
    fc.__name__ = "fake"
    t = Tracer(clock=fc, enabled=True)
    for (name, t0, t1, track, attrs) in spans:
        t.record_span(name, t0, t1, track=track, **attrs)
    t.export_jsonl(path)
    return t


# ------------------------------------------------------------------ merge

def test_merge_aligns_clocks_and_validates(tmp_path):
    a, b = str(tmp_path / "router.jsonl"), str(tmp_path / "replica.jsonl")
    _write_shard(a, 0.0, [("serve.request", 1.0, 1.5, "router",
                           {"trace_id": "T1", "span_id": "S1"})])
    _write_shard(b, 100.0, [("serve.dispatch", 101.1, 101.3, "serve",
                             {"trace_id": "T1", "parent_id": "S1"})])
    out = str(tmp_path / "merged.json")
    summary = merge_shards([a, b], out, offsets={"replica.jsonl": 100.0})
    assert validate_chrome(out) == []
    assert summary["events"] == 2 and summary["trace_ids"] == 1
    with open(out) as f:
        doc = json.load(f)
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    req, dsp = spans["serve.request"], spans["serve.dispatch"]
    assert req["args"]["trace_id"] == dsp["args"]["trace_id"] == "T1"
    assert req["ts"] == 0.0
    assert abs(dsp["ts"] - 100_000.0) < 1e-6
    assert req["pid"] != dsp["pid"]
    assert len([e for e in doc["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"]) == 2
    with pytest.raises(ValueError, match="no shards"):
        merge_shards([], out)


def test_merge_reads_header_offset_and_reports_drops(tmp_path):
    p = str(tmp_path / "s.jsonl")
    t = _write_shard(p, 10.0, [("op", 10.0, 10.5, "x",
                                {"trace_id": "T", "span_id": "S"})])
    meta, _ = read_shard(p)
    assert meta["epoch_s"] == 10.0 and meta["clock"] == "fake"
    assert meta["format"] == "dcnn-trace-jsonl/1"
    t._dropped = 3
    t.export_jsonl(p)
    assert read_shard(p)[0]["dropped"] == 3
    out = str(tmp_path / "m.json")
    assert merge_shards([p], out)["events_dropped_by_writers"] == 3
    assert validate_chrome(out) == []
    # a writer that knows its offset puts it in the header; a flag wins
    with open(p) as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    head["shard"]["clock_offset_s"] = 4.0
    hp = str(tmp_path / "h.jsonl")
    with open(hp, "w") as f:
        f.write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    assert merge_shards([hp], out)["shards"][0]["offset_s"] == 4.0
    assert merge_shards([hp], out, offsets={"h.jsonl": 1.5})[
        "shards"][0]["offset_s"] == 1.5


def test_read_shard_gzip_headerless_and_malformed(tmp_path):
    t = Tracer(enabled=True)
    with t.span("a.b", track="x", k=1):
        pass
    gz = t.export_jsonl(str(tmp_path / "s.jsonl.gz"), gzip=True)
    meta, events = read_shard(gz)
    assert meta["pid"] == os.getpid() and [e["name"] for e in events] == [
        "a.b"]
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps({"name": "n", "ts_s": 0.0}) + "\n\n")
    assert read_shard(str(bare)) == ({}, [{"name": "n", "ts_s": 0.0}])
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    with pytest.raises(ValueError, match="bad JSONL"):
        read_shard(str(bad))
    bad.write_text(json.dumps({"neither": 1}) + "\n")
    with pytest.raises(ValueError, match="neither a shard"):
        read_shard(str(bad))


def _shards(tmp_path):
    """Three shards of the port's tracer: two processes' worth of nested
    spans and instants on real ``perf_counter`` clocks, and a fake-clock
    shard written with a drop count."""
    paths = []
    for name in ("router", "replica"):
        t = Tracer(enabled=True)
        t.process_name = name
        for i in range(3):
            with t.span("serve.request", track="router", i=i) as sp:
                with t.span("serve.dispatch", track="serve", rows=i + 1):
                    pass
                sp.set(outcome="ok")
            t.instant("serve.shed", track="router", i=i)
        paths.append(t.export_jsonl(str(tmp_path / f"{name}.jsonl")))
    t = _write_shard(str(tmp_path / "fake.jsonl"), 5.0, [
        ("op", 5.0, 5.25, "x", {"trace_id": "T", "span_id": "S"}),
        ("op2", 5.5, 6.0, None, {})])
    t._dropped = 2
    paths.append(t.export_jsonl(str(tmp_path / "fake.jsonl")))
    return paths


@pytest.mark.parametrize("kw", [{}, {"max_events": 5},
                                 {"offsets": {"fake.jsonl": 2.5}}])
def test_merge_parity_with_jax(tmp_path, kw):
    """The same shards through both packages' ``merge_shards``: equal
    Chrome JSON, byte for byte as parsed, and equal summaries."""
    paths = _shards(tmp_path)
    out_j, out_t = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    sj = j_trace.merge_shards(paths, out_j, **kw)
    st = merge_shards(paths, out_t, **kw)
    sj.pop("out"), st.pop("out")
    assert st == sj
    with open(out_j) as f, open(out_t) as g:
        assert json.load(g) == json.load(f)
    assert validate_chrome(out_t) == j_trace.validate_chrome(out_t) == []


# -------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run([sys.executable, "-m", "dcnn_tpu_torch.obs.trace",
                           *args], capture_output=True, text=True, cwd=REPO)


def test_merge_cli_subprocess_and_inspect(tmp_path, capsys):
    """The CLI in a subprocess (merge, usage, inspect), and its other exit
    paths through ``main`` in process."""
    shard = str(tmp_path / "s.jsonl")
    _write_shard(shard, 0.0, [("op", 0.0, 1.0, "x",
                               {"trace_id": "T", "span_id": "S"})])
    out = str(tmp_path / "m.json")
    r = _cli("merge", shard, "-o", out, "--json")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["events"] == 1
    assert validate_chrome(out) == []
    assert _cli().returncode == 2
    assert t_trace.main(["merge", shard, "-o", out, "--offset",
                         "s.jsonl=1.5"]) == 0
    assert "offset +1.5s" in capsys.readouterr().out
    assert t_trace.main(["merge", shard, "-o", out, "--offset",
                         "nope"]) == 1
    assert t_trace.main(["merge", str(tmp_path / "missing.jsonl"),
                         "-o", out]) == 1
    t = Tracer(enabled=True)
    with t.span("a.b", trace_marker=1):
        pass
    rec = FlightRecorder(str(tmp_path / "flight"), tracer=t,
                         registry=MetricsRegistry(), min_interval_s=0.0)
    bundle = rec.record("unit_test", reasons=["because"],
                        health={"status": "unhealthy",
                                "reasons": ["because"]})
    info = inspect_bundle(bundle)
    assert info["manifest"]["trigger"] == "unit_test"
    assert info["spans"] == 1 and info["trace_ids"] == 1
    assert info["healthz"] == {"status": "unhealthy",
                               "reasons": ["because"]}
    r = _cli("inspect", bundle)
    assert r.returncode == 0
    assert json.loads(r.stdout)["manifest"]["trigger"] == "unit_test"
    assert t_trace.main(["inspect", str(tmp_path / "nowhere")]) == 1
    assert merge_shards([os.path.join(bundle, "spans.jsonl")],
                        str(tmp_path / "bm.json"))["events"] == 1


def test_validate_chrome_flags_garbage(tmp_path):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "name": "a"},
                                   {"ph": "Q", "name": "b"},
                                   {"ph": "i", "name": "c", "pid": 1,
                                    "tid": 1, "ts": "x", "args": []}]}, f)
    problems = validate_chrome(p)
    assert any("missing pid" in q for q in problems)
    assert any("complete span without dur" in q for q in problems)
    assert any("unknown ph" in q for q in problems)
    assert any("non-numeric ts" in q for q in problems)
    assert any("args not a dict" in q for q in problems)
    assert problems == j_trace.validate_chrome(p)
    with open(p, "w") as f:
        f.write("not json")
    assert validate_chrome(p)[0].startswith("unreadable")
    with open(p, "w") as f:
        json.dump({"nope": []}, f)
    assert validate_chrome(p) == ["traceEvents missing or not a list"]


# --------------------------------------------------------------- triggers

def _bundle_view(info):
    """An ``inspect_bundle`` summary without what differs by run: paths,
    times and the writing process's identity."""
    info = dict(info)
    info.pop("path")
    man = dict(info.pop("manifest"))
    for k in ("t_wall", "t_mono", "host", "pid", "process"):
        man.pop(k, None)
    info["manifest"] = man
    return info


def _replica_death(serve, soak, flight, root):
    rec = flight.FlightRecorder(root, min_interval_s=0.0)
    f = soak.synthetic_engine_factory
    rep0 = serve.LocalReplica(f, 1, name="r0", start=False)
    rep1 = serve.LocalReplica(f, 1, name="r1", start=False)
    router = serve.Router([rep0, rep1], flight=rec, min_routable=1)
    rep1.kill()
    router.check_replicas()
    router.check_replicas()  # the same dead replica again: no new edge
    bundles = rec.bundles()
    assert [b["trigger"] for b in bundles] == ["replica_death"]
    router.shutdown()
    rep0.close()
    return bundles[0]["path"]


def test_replica_death_bundle_inspected_like_jax(tmp_path, tracers_fresh):
    want = j_trace.inspect_bundle(_replica_death(
        j_serve, j_soak, j_flight, str(tmp_path / "j")))
    path = _replica_death(t_serve, t_soak, t_flight, str(tmp_path / "t"))
    got = inspect_bundle(path)
    assert _bundle_view(got) == _bundle_view(want)
    with open(os.path.join(path, "extra.json")) as f:
        assert json.load(f)["replica"] == "r1"
    with open(os.path.join(path, "metrics.json")) as f:
        assert json.load(f)["serve_router_replica_deaths_total"] == 1


def _canary_rollback(serve, soak, flight, root):
    faults = t_faults if serve is t_serve else j_faults
    fc = soak.ManualClock()
    rec = flight.FlightRecorder(root, min_interval_s=0.0)
    plans = {f"r{i}": faults.FaultPlan() for i in range(4)}

    class Factory:
        def newest(self):
            return 2

        def __call__(self, version):
            return soak.SyntheticEngine(version)

    reps = [serve.LocalReplica(Factory(), 1, name=f"r{i}", clock=fc,
                               fault_plan=plans[f"r{i}"], start=False)
            for i in range(4)]
    router = serve.Router(reps, clock=fc, sleep=lambda s: fc.advance(s))
    mvm = serve.ModelVersionManager(
        router, Factory(), canary_fraction=0.25, observe_s=10.0,
        min_canary_requests=5, max_error_delta=0.02, clock=fc, flight=rec)
    res = mvm.poll()
    assert res["action"] == "canary"
    canary = res["canaries"][0]
    plans[canary].arm("serve.replica_infer", exc=faults.InjectedFault)
    futs = [router.submit(np.zeros(4, np.float32)) for _ in range(32)]
    for _ in range(6):
        for r in reps:
            r.step(force=True)
    assert all(f.exception(timeout=5) is None for f in futs)
    assert mvm.poll()["action"] == "rolled_back"
    cb = [b for b in rec.bundles() if b["trigger"] == "canary_rollback"]
    assert len(cb) == 1
    with open(os.path.join(cb[0]["path"], "config.json")) as f:
        cfg = json.load(f)
    assert cfg["version"] == 2 and canary in cfg["canaries"]
    router.shutdown()
    for r in reps:
        r.close()
    return cb[0]["path"]


def test_canary_rollback_bundle_inspected_like_jax(tmp_path,
                                                   tracers_fresh):
    want = j_trace.inspect_bundle(_canary_rollback(
        j_serve, j_soak, j_flight, str(tmp_path / "j")))
    got = inspect_bundle(_canary_rollback(
        t_serve, t_soak, t_flight, str(tmp_path / "t")))
    assert _bundle_view(got) == _bundle_view(want)
    assert got["manifest"]["trigger"] == "canary_rollback"


def test_autoscale_slo_breach_trigger(tmp_path, monkeypatch):
    """One ``autoscale_slo_breach`` bundle per breach episode, at its
    first breaching tick, with the breach's signals in ``extra.json``."""
    fc = ManualClock()
    rec = FlightRecorder(str(tmp_path / "fl"), min_interval_s=0.0)
    boot = LocalReplica(synthetic_engine_factory, 1, name="boot", clock=fc,
                        start=False)
    router = Router([boot], clock=fc, sleep=lambda s: fc.advance(s))
    made = [0]

    def factory(version):
        made[0] += 1
        return LocalReplica(synthetic_engine_factory, version,
                            name=f"as{made[0]}", clock=fc, start=False)

    scaler = Autoscaler(router, factory,
                        config=AutoscalerConfig(breach_ticks=1,
                                                up_cooldown_s=0.0),
                        clock=fc, flight=rec)
    signals = {"p99": 1000.0}

    def fake_collect(*, _commit=False):
        return FleetSignals(routable=1, utilization=0.5,
                            p99_ms=signals["p99"], shed_fraction=0.0)

    monkeypatch.setattr(scaler, "collect", fake_collect)
    fc.advance(1.0)
    scaler.tick()
    assert [b["trigger"] for b in rec.bundles()] == ["autoscale_slo_breach"]
    path = rec.bundles()[0]["path"]
    with open(os.path.join(path, "extra.json")) as f:
        assert json.load(f)["p99_ms"] == 1000.0
    info = inspect_bundle(path)
    assert info["manifest"]["reasons"] == [
        "p99 1000.0ms > slo 200.0ms"]
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["slo_p99_ms"] == 200.0
    fc.advance(1.0)
    scaler.tick()
    assert len(rec.bundles()) == 1
    signals["p99"] = 1.0
    fc.advance(1.0)
    scaler.tick()
    signals["p99"] = 1000.0
    fc.advance(1.0)
    scaler.tick()
    assert len(rec.bundles()) == 2
    router.shutdown()
    for r in router.replicas().values():
        r.close()


# ------------------------------------------------------- elastic correlation

def test_elastic_reconfiguration_merges_as_one_trace(tmp_path, tracer_on):
    """3 peers of the port, one crashed mid-epoch: the fleet's shard
    merges into a Chrome trace in which the follower's restore and
    rebuild spans carry the leader's ``elastic.reconfigure`` trace id."""
    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data.loader import ArrayDataLoader, one_hot
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import comm
    from dcnn_tpu_torch.parallel.elastic import ElasticController, PeerSpec
    from dcnn_tpu_torch.resilience.faults import InjectedCrash

    rng = np.random.default_rng(0)
    x = rng.normal(size=(48, 16)).astype(np.float32)
    y = one_hot(rng.integers(0, 4, 48), 4)
    socks = [comm.listen(0, host="127.0.0.1") for _ in range(3)]
    peers = [PeerSpec(i, "127.0.0.1", s.getsockname()[1])
             for i, s in enumerate(socks)]
    faults = {2: FaultPlan().arm("elastic.heartbeat", at=5,
                                 exc=InjectedCrash)}
    results = {}

    def runner(i):
        cfg = TrainingConfig(
            epochs=2, learning_rate=0.05, seed=3, snapshot_dir=None,
            elastic=True, elastic_microbatches=6, elastic_timeout_s=15.0,
            elastic_heartbeat_s=0.0, elastic_ckpt_steps=2,
            checkpoint_dir=str(tmp_path / "ckpt"), device_type="cpu")
        model = (SequentialBuilder("elastic_model").input((16,))
                 .dense(32).activation("relu").dense(4).build())
        ctl = ElasticController(
            model, SGD(0.05), "softmax_crossentropy",
            ArrayDataLoader(x, y, batch_size=12, seed=7), config=cfg,
            rank=i, peers=peers, listen_sock=socks[i],
            fault_plan=faults.get(i))
        try:
            results[i] = ctl.fit(epochs=2)
        except InjectedCrash:
            results[i] = "crashed"
        except Exception as e:  # surfaced to the asserts
            results[i] = e

    threads = [threading.Thread(target=runner, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "elastic fleet hung"
    assert results[2] == "crashed"
    for r in (0, 1):
        assert not isinstance(results[r], (str, Exception)), results[r]
    shard = tracer_on.export_jsonl(str(tmp_path / "fleet.jsonl"))
    out = str(tmp_path / "fleet.json")
    summary = merge_shards([shard], out)
    assert validate_chrome(out) == [] and summary["trace_ids"] > 1
    with open(out) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e["ph"] != "M"]
    recs = [e for e in evs if e["name"] == "elastic.reconfigure"
            and e["args"].get("rank") == 0 and e["args"].get("gen", 0) > 0]
    assert recs
    lead = recs[-1]["args"]["trace_id"]
    for name in ("elastic.restore", "elastic.rebuild"):
        assert [e for e in evs if e["name"] == name
                and e["args"].get("rank") == 1
                and e["args"].get("trace_id") == lead], name
    assert [e for e in evs if e["name"] == "elastic.step"
            and e["args"].get("trace_id") == lead]


# ------------------------------------------------------------- ACCEPTANCE

_CHILD = """\
import os, signal, sys, time
sys.path.insert(0, {repo!r})
from dcnn_tpu_torch.obs import configure
from dcnn_tpu_torch.serve.replica import LocalReplica, ReplicaServer
from dcnn_tpu_torch.serve.soak import synthetic_engine_factory

shard, name = sys.argv[1], sys.argv[2]
tracer = configure(enabled=True)
tracer.process_name = name
rep = LocalReplica(synthetic_engine_factory, 1, name=name, start=True)
srv = ReplicaServer(rep, port=0)
print(srv.port, flush=True)

def _flush(*_a):
    try:
        tracer.export_jsonl(shard)
    finally:
        os._exit(0)

signal.signal(signal.SIGTERM, _flush)
while True:
    time.sleep(0.05)
    tracer.export_jsonl(shard)
"""


def _spawn_replica_process(tmp_path, name):
    shard = str(tmp_path / f"{name}.jsonl")
    script = str(tmp_path / f"{name}_main.py")
    with open(script, "w") as f:
        f.write(_CHILD.format(repo=REPO))
    proc = subprocess.Popen([sys.executable, script, shard, name],
                            stdout=subprocess.PIPE, text=True, cwd=REPO)
    line = proc.stdout.readline().strip()
    assert line, "replica child died before binding"
    return proc, int(line), shard


def test_acceptance_kill_a_replica_merged_trace_and_flight(tmp_path,
                                                           tracer_on,
                                                           capsys):
    tracer_on.process_name = "router"
    rec = FlightRecorder(str(tmp_path / "flight"), min_interval_s=0.0,
                         tracer=tracer_on)
    procs, clients, router = [], [], None
    try:
        for name in ("repA", "repB"):
            procs.append(_spawn_replica_process(tmp_path, name))
        clients = [TcpReplica("127.0.0.1", port, name=name, timeout_s=30.0,
                              connect_timeout=60.0)
                   for name, (_p, port, _s) in zip(("repA", "repB"), procs)]
        router = Router(clients, min_routable=2, flight=rec)
        srv = router.start_telemetry(port=0)
        sample = np.zeros((4,), np.float32)
        for f in [router.submit(sample) for _ in range(24)]:
            np.testing.assert_array_equal(f.result(timeout=30),
                                          np.ones(4, np.float32))
        assert srv.health()[0] == 200
        procs[1][0].send_signal(signal.SIGTERM)
        procs[1][0].wait(timeout=30)
        deadline = time.monotonic() + 30.0
        code, body = 200, {}
        while time.monotonic() < deadline:
            code, body = srv.health()
            if code == 503:
                break
            time.sleep(0.05)
        assert code == 503, body
        assert any("routable" in r for r in body["reasons"])
        for f in [router.submit(sample) for _ in range(8)]:
            assert f.result(timeout=30) is not None
        assert router.outstanding() == 0

        shard_r = tracer_on.export_jsonl(str(tmp_path / "router.jsonl"))
        shards = [shard_r] + [s for _p, _port, s in procs]
        merged = str(tmp_path / "merged_trace.json")
        capsys.readouterr()
        assert t_trace.main(["merge", *shards, "-o", merged,
                             "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["events"] > 0
        assert validate_chrome(merged) == []
        req = {e["args"]["trace_id"] for e in read_shard(shard_r)[1]
               if e["name"] == "serve.request"}
        remote = set()
        for _p, _port, s in procs:
            for e in read_shard(s)[1]:
                if e["name"] in ("serve.dispatch", "serve.infer",
                                 "serve.queue"):
                    tid = (e.get("args") or {}).get("trace_id")
                    if tid:
                        remote.add(tid)
        shared = req & remote
        assert shared
        with open(merged) as f:
            doc = json.load(f)
        tid = next(iter(shared))
        assert len({e["pid"] for e in doc["traceEvents"]
                    if e["ph"] != "M"
                    and e["args"].get("trace_id") == tid}) >= 2

        triggers = {b["trigger"]: b for b in rec.bundles()}
        assert "replica_death" in triggers
        assert "healthz_degraded" in triggers
        hb = triggers["healthz_degraded"]["path"]
        info = inspect_bundle(hb)
        assert info["healthz"]["status"] == "unhealthy"
        assert any("routable" in r for r in info["healthz"]["reasons"])
        with open(os.path.join(hb, "metrics.json")) as f:
            assert json.load(f)["serve_router_replica_deaths_total"] >= 1
        bundle_tids = {(e.get("args") or {}).get("trace_id")
                       for e in read_shard(os.path.join(
                           hb, "spans.jsonl"))[1]
                       if e["name"] == "serve.request"}
        assert bundle_tids & remote
        assert t_trace.main(["inspect",
                             triggers["replica_death"]["path"]]) == 0
        assert json.loads(capsys.readouterr().out)["manifest"][
            "trigger"] == "replica_death"
    finally:
        if router is not None:
            try:
                router.shutdown(drain=False)
            except Exception:
                pass
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        for p, _port, _s in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
