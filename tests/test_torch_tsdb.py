"""The port's time-series store (``dcnn_tpu_torch/obs/tsdb.py``), the twin
of the JAX package's ``tests/test_tsdb.py`` on fake clocks: ring eviction,
the downsample tier, query ops, atomic persistence, the sampler's
lifecycle and fixed memory, flight bundles carrying the history, the
postmortem CLI, and the history format read across the two packages. No
test asserts a wall-clock bound."""

import json
import os
import threading

import pytest

from dcnn_tpu_torch.obs.flight import FlightRecorder
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.obs.tsdb import (TimeSeriesStore, TsdbSampler, load_history,
                               main as tsdb_main, render_series_key,
                               series_stats, sparkline, summarize_history)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_store(fc, **kw):
    kw.setdefault("retention", 8)
    kw.setdefault("downsample", 4)
    kw.setdefault("coarse_retention", 3)
    return TimeSeriesStore(clock=fc, **kw)


# ------------------------------------------------------------ ring buffers

def test_ring_eviction_fixed_memory():
    """Fine tier holds exactly `retention` points no matter how many are
    written — memory is fixed by (series x retention), not run length."""
    fc = FakeClock()
    store = make_store(fc, retention=8)
    for i in range(100):
        fc.advance(1.0)
        store.add("g", float(i))
    pts = store.range("g")
    assert len(pts) == 8
    assert [v for _, v in pts] == [float(i) for i in range(92, 100)]
    assert store.points() == 8


def test_downsample_tier_correctness():
    """Every `downsample` fine points flush one coarse (t, min, max,
    mean, count) entry; the coarse ring evicts at its own capacity."""
    fc = FakeClock()
    store = make_store(fc, retention=8, downsample=4, coarse_retention=3)
    for i in range(1, 21):                      # 20 points -> 5 buckets
        fc.advance(1.0)
        store.add("g", float(i))
    coarse = store.range("g", tier="coarse")
    assert len(coarse) == 3                     # capacity, oldest evicted
    # newest bucket covers points 17..20
    t, mn, mx, mean, n = coarse[-1]
    assert (t, mn, mx, mean, n) == (20.0, 17.0, 20.0, 18.5, 4)
    # a partial bucket is not flushed early
    fc.advance(1.0)
    store.add("g", 99.0)
    assert len(store.range("g", tier="coarse")) == 3


def test_labeled_series_keys_and_cardinality_bound():
    fc = FakeClock()
    store = make_store(fc, max_series=2)
    assert render_series_key("m", {"b": "2", "a": "1"}) == 'm{a="1",b="2"}'
    store.add("m", 1.0, labels={"replica": "r0"})
    store.add("m", 2.0, labels={"replica": "r1"})
    store.add("m", 3.0, labels={"replica": "r2"})  # past the bound
    assert len(store.series_names()) == 2
    assert store.dropped_series == 1
    # existing series still accept points past the bound
    store.add("m", 9.0, labels={"replica": "r0"})
    assert store.latest('m{replica="r0"}')[1] == 9.0


# ------------------------------------------------------------- query ops

def test_query_ops_delta_rate_over_time():
    fc = FakeClock()
    store = make_store(fc, retention=64)
    for i in range(10):
        fc.advance(1.0)
        store.add("c_total", 5.0 * (i + 1))    # +5/s counter
        store.add("g", float(i % 4))
    # window [5, 10]: six points, values 30..50 -> delta 25 over 5 s
    assert store.delta("c_total", 5.0) == pytest.approx(25.0)
    assert store.rate("c_total", 5.0) == pytest.approx(5.0)
    assert store.max_over_time("g", 4.0) == 3.0
    assert store.min_over_time("g", 4.0) == 0.0
    assert store.avg_over_time("g", 100.0) == pytest.approx(1.3)
    assert store.latest("g")[1] == 1.0
    # windows with too few points answer None, not garbage
    assert store.delta("c_total", 0.5) is None
    assert store.rate("nope", 5.0) is None


def test_quantile_over_time_from_bucket_deltas():
    """Windowed histogram quantile: only observations INSIDE the window
    count, so an old latency spike ages out of the p99."""
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    store = TimeSeriesStore(retention=64, clock=fc)
    h = reg.histogram("lat_seconds", start=1e-3, factor=2.0, buckets=12)
    sampler = TsdbSampler(store, registry=reg, clock=fc)
    # phase 1: slow traffic (~0.1 s)
    for _ in range(10):
        fc.advance(1.0)
        h.observe(0.1)
        sampler.sample_once()
    # phase 2: fast traffic (~2 ms)
    for _ in range(10):
        fc.advance(1.0)
        h.observe(0.002)
        sampler.sample_once()
    recent = store.quantile_over_time("lat_seconds", 0.99, 8.0)
    overall = store.quantile_over_time("lat_seconds", 0.99, 100.0)
    assert recent is not None and recent < 0.01     # spike aged out
    assert overall is not None and overall > 0.05   # still in long window
    assert store.quantile_over_time("lat_seconds", 0.5, 8.0) < 0.01
    with pytest.raises(ValueError):
        store.quantile_over_time("lat_seconds", 1.5, 8.0)
    assert store.quantile_over_time("absent", 0.9, 8.0) is None


def test_sample_registry_counters_gauges_histograms():
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    store = TimeSeriesStore(clock=fc)
    reg.counter("c_total").inc(3)
    reg.gauge("g").set(7.0)
    reg.histogram("h_seconds").observe(0.5)
    fc.advance(1.0)
    wrote = store.sample_registry(reg)
    assert wrote >= 4
    assert store.latest("c_total")[1] == 3.0
    assert store.latest("g")[1] == 7.0
    assert store.latest("h_seconds_count")[1] == 1.0
    assert store.latest("h_seconds_sum")[1] == 0.5
    assert any(k.startswith("h_seconds_bucket{le=")
               for k in store.series_names())


# ---------------------------------------------------------- sampler bounds

def test_sampler_disabled_zero_threads():
    """Not starting the sampler costs nothing: no threads, no points."""
    before = threading.active_count()
    store = TimeSeriesStore()
    TsdbSampler(store, registry=MetricsRegistry())
    assert threading.active_count() == before
    assert not [t for t in threading.enumerate()
                if "tsdb-sampler" in t.name]
    assert store.points() == 0


def test_sampler_thread_lifecycle():
    reg = MetricsRegistry()
    reg.gauge("g").set(1.0)
    sampler = TsdbSampler(TimeSeriesStore(), registry=reg,
                          interval_s=0.01)
    sampler.start()
    assert sampler.start() is sampler  # idempotent
    assert [t for t in threading.enumerate()
            if "tsdb-sampler" in t.name]
    sampler.stop()
    assert not [t for t in threading.enumerate()
                if "tsdb-sampler" in t.name]
    sampler.stop()  # idempotent


def test_fixed_memory_independent_of_run_length():
    """Total retained points are bounded by series x retention: 10x more
    samples do not grow the store."""
    fc = FakeClock()
    reg = MetricsRegistry(clock=fc)
    reg.counter("c_total")
    reg.gauge("g")
    store = TimeSeriesStore(retention=16, coarse_retention=4, clock=fc)
    # tick_clock too: with real perf_counter a slow pass on a loaded host
    # lands tsdb_sample_seconds in a NEW (lazily-exported) bucket mid-run,
    # which is one extra series — and this test counts retained points
    sampler = TsdbSampler(store, registry=reg, clock=fc, tick_clock=fc)
    reg.counter("c_total").inc()

    def run(n):
        for _ in range(n):
            fc.advance(1.0)
            reg.counter("c_total").inc()
            sampler.sample_once()
        return store.points()

    p1 = run(50)
    p2 = run(500)
    assert p1 == p2
    n_series = len(store.series_names())
    assert p2 <= n_series * 16


# ------------------------------------------------------------- persistence

def test_persist_load_round_trip_atomic(tmp_path):
    fc = FakeClock()
    store = make_store(fc, retention=32)
    for i in range(12):
        fc.advance(1.0)
        store.add("a_total", float(i))
        store.add("m", float(i * 2), labels={"replica": "r0"})
    path = str(tmp_path / "history.jsonl")
    store.persist(path)
    # atomic publish: no tmp siblings survive
    assert [n for n in os.listdir(tmp_path)] == ["history.jsonl"]
    meta, series = load_history(path)
    assert meta["schema"] == 1 and meta["retention"] == 32
    assert "wall_anchor" in meta
    assert set(series) == {"a_total", 'm{replica="r0"}'}
    assert series['m{replica="r0"}']["labels"] == {"replica": "r0"}
    pts = series["a_total"]["points"]
    assert [v for _, v in pts] == [float(i) for i in range(12)]
    summ = summarize_history(path)
    assert summ["series"] == 2 and summ["points"] == 24
    assert summ["span_s"] == pytest.approx(11.0)


def test_load_history_rejects_garbage(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"tsdb": {"schema": 1}}\nnot json\n')
    with pytest.raises(ValueError):
        load_history(str(p))
    p2 = tmp_path / "bad2.jsonl"
    p2.write_text('{"neither": 1}\n')
    with pytest.raises(ValueError):
        load_history(str(p2))


def test_series_stats_and_sparkline():
    assert series_stats([])["points"] == 0
    st = series_stats([(0.0, 1.0), (1.0, 3.0), (2.0, 2.0)])
    assert (st["min"], st["max"], st["last"]) == (1.0, 3.0, 2.0)
    assert st["mean"] == pytest.approx(2.0)
    s = sparkline([0.0, 1.0, 2.0, 3.0], width=4)
    assert len(s) == 4 and s[0] == " " and s[-1] == "@"
    assert sparkline([]) == ""
    assert len(sparkline(list(range(1000)), width=50)) == 50


# -------------------------------------------------- flight-bundle history

def _fired_store(fc):
    store = make_store(fc, retention=64)
    for i in range(10):
        fc.advance(1.0)
        store.add("p99_ms", 100.0 + i)
    return store


def test_flight_bundle_carries_history_and_inspect_summarizes(tmp_path):
    """Every bundle from a tsdb-attached recorder carries history.jsonl
    (the minutes BEFORE the trigger), which summarize_history reads."""
    fc = FakeClock()
    store = _fired_store(fc)
    reg = MetricsRegistry(clock=fc)
    fl = FlightRecorder(str(tmp_path), registry=reg, clock=fc,
                        min_interval_s=0.0).attach_tsdb(store)
    path = fl.record("watchdog_stall", reasons=["test"])
    assert path is not None
    files = sorted(os.listdir(path))
    assert "history.jsonl" in files
    _meta, series = load_history(os.path.join(path, "history.jsonl"))
    assert [v for _, v in series["p99_ms"]["points"]][-1] == 109.0
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert manifest["history_series"] == 1
    out = summarize_history(os.path.join(path, "history.jsonl"))
    assert out["series"] == 1
    assert out["points"] == 10
    # detach: the next bundle has no history file
    fl.attach_tsdb(None)
    fc.advance(100.0)
    path2 = fl.record("watchdog_stall", reasons=["again"])
    assert "history.jsonl" not in os.listdir(path2)


# -------------------------------------------------------------------- CLI

def _write_history(tmp_path):
    fc = FakeClock()
    store = _fired_store(fc)
    path = str(tmp_path / "history.jsonl")
    store.persist(path)
    return path


def test_cli_report(tmp_path, capsys):
    path = _write_history(tmp_path)
    assert tsdb_main(["report", path]) == 0
    out = capsys.readouterr().out
    assert "p99_ms" in out and "mean=" in out and "1 series" in out


def test_cli_export(tmp_path, capsys):
    path = _write_history(tmp_path)
    out_path = str(tmp_path / "out.json")
    assert tsdb_main(["export", path, "-o", out_path]) == 0
    doc = json.load(open(out_path))
    assert "p99_ms" in doc["series"]
    assert tsdb_main(["export", path]) == 0  # stdout variant
    assert "p99_ms" in capsys.readouterr().out


def test_cli_plot_and_errors(tmp_path, capsys):
    path = _write_history(tmp_path)
    assert tsdb_main(["plot", path, "p99_ms"]) == 0
    out = capsys.readouterr().out
    assert "|" in out and "p99_ms" in out
    assert tsdb_main(["plot", path, "absent"]) == 1
    assert tsdb_main(["report", str(tmp_path / "missing.jsonl")]) == 1
    assert tsdb_main([]) == 2


# ------------------------------------------------------------- validation

def test_constructor_validation():
    with pytest.raises(ValueError):
        TimeSeriesStore(retention=1)
    with pytest.raises(ValueError):
        TimeSeriesStore(downsample=0)
    with pytest.raises(ValueError):
        TimeSeriesStore(max_series=0)
    with pytest.raises(ValueError):
        TsdbSampler(TimeSeriesStore(), registry=MetricsRegistry(),
                    interval_s=0)
    with pytest.raises(ValueError):
        TimeSeriesStore().range("x", tier="weird")


# ------------------------------------------------- across the two packages

def test_history_format_read_by_both_packages(tmp_path):
    """A history the port persists loads in the JAX package's reader to the
    same series, and the other way round."""
    from dcnn_tpu.obs import tsdb as jtsdb

    fc = FakeClock()
    store = _fired_store(fc)
    store.add("depth", 3.0, labels={"replica": "r0"})
    mine = str(tmp_path / "port.jsonl")
    store.persist(mine)
    assert jtsdb.load_history(mine)[1] == load_history(mine)[1]

    jfc = FakeClock()
    jstore = jtsdb.TimeSeriesStore(retention=64, downsample=4,
                                   coarse_retention=3, clock=jfc)
    for i in range(10):
        jfc.advance(1.0)
        jstore.add("p99_ms", 100.0 + i)
    theirs = str(tmp_path / "jax.jsonl")
    jstore.persist(theirs)
    assert load_history(theirs)[1] == jtsdb.load_history(theirs)[1]
    assert load_history(theirs)[1]["p99_ms"] == load_history(mine)[1][
        "p99_ms"]


def test_sampler_text_mode_reads_serve_metrics_on_a_fake_clock():
    """``text_fn=ServeMetrics.prometheus``: the windowed gauges that exist
    only in the rendered text land in the store, at the sampler's clock,
    as in the JAX package's sampler."""
    from dcnn_tpu.obs import tsdb as jtsdb
    from dcnn_tpu.serve import ServeMetrics as JaxServeMetrics
    from dcnn_tpu_torch.serve import ServeMetrics

    stores = []
    for tsdb_mod, metrics_cls in ((None, ServeMetrics),
                                  (jtsdb, JaxServeMetrics)):
        fc = FakeClock()
        m = metrics_cls(clock=fc)
        store_cls = (tsdb_mod.TimeSeriesStore if tsdb_mod
                     else TimeSeriesStore)
        sampler_cls = tsdb_mod.TsdbSampler if tsdb_mod else TsdbSampler
        store = store_cls(clock=fc)
        sampler = sampler_cls(store, registry=m.registry,
                              text_fn=m.prometheus, clock=fc, tick_clock=fc)
        for i in range(3):
            m.record_submit(2)
            m.record_batch(2, 4)
            fc.advance(0.5)
            m.record_done(0.010 * (i + 1), 2)
            sampler.sample_once()
        stores.append(store)
    mine, theirs = stores
    assert mine.series_names() == theirs.series_names()
    assert "serve_latency_window_p99_ms" in mine.series_names()
    for k in mine.series_names():
        assert mine.range(k) == theirs.range(k), k
