"""The port's bench-history regression gate
(``dcnn_tpu_torch/obs/regress.py`` and its command line), the twin of the
JAX package's ``tests/test_regress.py``.

Every history goes through both packages' functions: the report dicts
must be equal and ``format_report`` must print the same text, character
for character. Contracts:

- each case of the JAX tests (improvement, tolerance, best-of-window,
  direction, the cache-warmth guard, absent metrics, window bounds, the
  autoscale and decode keys, the zero-best absolute slack) and the places
  a twin drifts most easily (the window filled newest-first past
  non-numeric values and guard mismatches, ``fallback`` only when
  ``path`` is None, ``ratio`` rounded or None, ``atol``'s sign per
  direction, the input checks);
- the committed ``BENCH_r01-r05.json`` given as explicit paths, and a
  planted 25% img/s drop on them: the same verdicts;
- the departure by design: the port reads only ``BENCH_TORCH_rNN.json``,
  so neither package's discovery (nor ``gate_current``) picks up the
  other's captures;
- the command line: ``--self-test`` passes, exit codes 0 / 1 / 2 as
  ``benchmarks/compare.py``'s, its output equal to ``compare.py``'s on the
  same files, and with no files it reads the port's captures only.
"""

import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from dcnn_tpu.obs import regress as jr
from dcnn_tpu_torch.obs import regress as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPARE = os.path.join(REPO, "benchmarks", "compare.py")
PORT_CLI = [sys.executable, "-m", "dcnn_tpu_torch.obs.regress"]
JAX_FILES = jr.find_bench_files(REPO)


def _kw(pkg, kw):
    """``kw`` for ``pkg``'s functions: ``metrics`` given as field dicts
    becomes that package's own ``MetricSpec`` objects."""
    kw = dict(kw)
    if "metrics" in kw:
        kw["metrics"] = [pkg.MetricSpec(**m) for m in kw["metrics"]]
    return kw


def both(history, **kw):
    """``compare`` through both packages on copies of the same history:
    equal reports, equal text; returns the port's report."""
    want = jr.compare(copy.deepcopy(history), **_kw(jr, kw))
    got = tr.compare(copy.deepcopy(history), **_kw(tr, kw))
    assert got == want
    assert tr.format_report(got) == jr.format_report(want)
    return got


def _hist(*values, extra=()):
    out = [{"value": v} for v in values]
    for i, d in enumerate(extra):
        out[i].update(d)
    return out


def _compile(*pairs):
    return [{"phases": {"compile_s": c, "compile_cache_hit": hit}}
            for c, hit in pairs]


def _autoscale_cap(availability=1.0, slo_min=0.2, reaction=1.0,
                   cooldown=5.0, **extra):
    return {"value": 100.0, "autoscale": {
        "availability": availability,
        "slo_violation_minutes": slo_min,
        "scale_up_reaction_s": reaction,
        "up_cooldown_s": cooldown, **extra}}


def _decode_cap(tps=5000.0, ttft=50.0, occ=0.8, slots=8, **extra):
    return {"value": 100.0, "decode": {
        "tokens_per_sec": tps,
        "ttft_p99_ms": ttft,
        "slot_occupancy": occ,
        "max_slots": slots, **extra}}


def _lost(n, stages=4):
    return {"resilience": {"pipeline": {"batches_lost": n,
                                        "stages": stages}}}


_X_UP = {"name": "x", "path": "x", "tolerance": 0.1, "atol": 5.0}
_X_DOWN = dict(_X_UP, higher_is_better=False)
SKIP_WINDOW = "skipped: no comparable prior capture"
SKIP_NEWEST = "skipped: metric absent from newest capture"

# id, history, compare's keywords, expectations: "ok", "regressions" (the
# exact list), "flagged" (each in the list), "verdicts" (metric -> prefix),
# "best", "ratio" and "window" (metric -> value)
CASES = [
    ("improvement", _hist(100.0, 110.0, 120.0), {},
     {"ok": True, "regressions": []}),
    ("in_tolerance_15pct", _hist(100.0, 120.0, 102.0), {}, {"ok": True}),
    ("past_tolerance_25pct", _hist(100.0, 120.0, 90.0), {},
     {"regressions": ["img_per_sec"], "verdicts": {"img_per_sec": "REGRESSED"},
      "best": {"img_per_sec": 120.0}}),
    ("baseline_is_window_best_not_mean", _hist(90.0, 100.0, 120.0, 90.0), {},
     {"ok": False}),
    ("lower_is_better_blowup", _compile((100.0, None), (160.0, None)), {},
     {"flagged": ["compile_s"]}),
    ("lower_is_better_within", _compile((100.0, None), (140.0, None)), {},
     {"ok": True}),
    ("cache_warmth_guard", _compile((3.0, True), (150.0, False)), {},
     {"ok": True, "verdicts": {"compile_s": "skipped"}}),
    ("missing_metric_and_empty_window", [{"value": 10.0}, {"mfu": 0.4}], {},
     {"ok": True, "verdicts": {"img_per_sec": "skipped",
                               "mfu_formula": "skipped",
                               "mfu_analytic": "skipped"}}),
    ("window_2_excludes_ancient", _hist(1000.0, 100.0, 105.0, 103.0),
     {"window": 2}, {"ok": True}),
    ("window_3_reaches_ancient", _hist(1000.0, 100.0, 105.0, 103.0),
     {"window": 3}, {"ok": False}),
    ("autoscale_absent_from_history",
     [{"value": 100.0}, {"value": 101.0}, _autoscale_cap()], {},
     {"ok": True, "verdicts": {"autoscale.availability": SKIP_WINDOW}}),
    ("autoscale_absent_from_newest", [_autoscale_cap(), {"value": 100.0}],
     {}, {"ok": True, "verdicts": {"autoscale.availability": SKIP_NEWEST}}),
    ("autoscale_availability_drop",
     [_autoscale_cap(availability=1.0), _autoscale_cap(availability=0.97)],
     {}, {"flagged": ["autoscale.availability"]}),
    ("autoscale_availability_within",
     [_autoscale_cap(availability=1.0), _autoscale_cap(availability=0.995)],
     {}, {"ok": True}),
    ("autoscale_reaction_other_cooldown",
     [_autoscale_cap(reaction=3.0, cooldown=5.0),
      _autoscale_cap(reaction=12.0, cooldown=15.0)], {},
     {"ok": True, "verdicts": {"autoscale.scale_up_reaction_s": SKIP_WINDOW}}),
    ("autoscale_reaction_same_cooldown",
     [_autoscale_cap(reaction=3.0, cooldown=5.0),
      _autoscale_cap(reaction=12.0, cooldown=5.0)], {},
     {"flagged": ["autoscale.scale_up_reaction_s"]}),
    ("autoscale_slo_improves",
     [_autoscale_cap(slo_min=0.2), _autoscale_cap(slo_min=0.1)], {},
     {"ok": True}),
    ("autoscale_slo_blowup",
     [_autoscale_cap(slo_min=0.2), _autoscale_cap(slo_min=2.0)], {},
     {"flagged": ["autoscale.slo_violation_minutes"]}),
    ("autoscale_zero_best_inside_slack",
     [_autoscale_cap(slo_min=0.0, reaction=0.0),
      _autoscale_cap(slo_min=0.75, reaction=4.0)], {},
     {"ok": True, "ratio": {"autoscale.slo_violation_minutes": None}}),
    ("autoscale_zero_best_past_slack",
     [_autoscale_cap(slo_min=0.0, reaction=0.0),
      _autoscale_cap(slo_min=3.0, reaction=30.0)], {},
     {"flagged": ["autoscale.slo_violation_minutes",
                  "autoscale.scale_up_reaction_s"]}),
    ("decode_absent_from_history",
     [{"value": 100.0}, {"value": 101.0}, _decode_cap()], {},
     {"ok": True, "verdicts": {"decode.tokens_per_sec": SKIP_WINDOW}}),
    ("decode_absent_from_newest", [_decode_cap(), {"value": 100.0}], {},
     {"ok": True, "verdicts": {"decode.tokens_per_sec": SKIP_NEWEST}}),
    ("decode_throughput_drop", [_decode_cap(tps=5000.0),
                                _decode_cap(tps=2000.0)], {},
     {"flagged": ["decode.tokens_per_sec"]}),
    ("decode_occupancy_drop", [_decode_cap(occ=0.8), _decode_cap(occ=0.4)],
     {}, {"flagged": ["decode.slot_occupancy"]}),
    ("decode_within", [_decode_cap(tps=5000.0, occ=0.8),
                       _decode_cap(tps=4500.0, occ=0.75)], {}, {"ok": True}),
    ("decode_ttft_inside_slack", [_decode_cap(ttft=5.0),
                                  _decode_cap(ttft=12.0)], {}, {"ok": True}),
    ("decode_ttft_blowup", [_decode_cap(ttft=50.0), _decode_cap(ttft=300.0)],
     {}, {"flagged": ["decode.ttft_p99_ms"]}),
    ("decode_guarded_on_slots", [_decode_cap(tps=8000.0, slots=16),
                                 _decode_cap(tps=5000.0, slots=8)], {},
     {"ok": True, "verdicts": {"decode.tokens_per_sec": SKIP_WINDOW}}),
    # the drift-prone details
    ("fallback_only_when_path_is_none",
     [{"mfu": 0.5}, {"mfu_formula": 0.3, "mfu": 0.9}], {},
     {"regressions": ["mfu_formula"], "window": {"mfu_formula": [0.5]}}),
    ("fallback_not_tried_for_non_numeric",
     [{"mfu": 0.5}, {"mfu_formula": "n/a", "mfu": 0.5}], {},
     {"ok": True, "verdicts": {"mfu_formula": SKIP_NEWEST}}),
    ("window_skips_non_numeric_values",
     [{"value": 100.0}, {"value": "n/a"}, {"value": None}, {"value": 76.0}],
     {"window": 1},
     {"regressions": ["img_per_sec"], "window": {"img_per_sec": [100.0]}}),
    ("window_skips_guard_mismatches",
     _compile((100.0, None), (50.0, True), (140.0, None)), {"window": 1},
     {"ok": True, "best": {"compile_s": 100.0},
      "window": {"compile_s": [100.0]}}),
    ("window_fills_newest_first", _hist(10.0, 50.0, 20.0, 30.0, 29.0),
     {"window": 2}, {"ok": True, "window": {"img_per_sec": [20.0, 30.0]},
                     "best": {"img_per_sec": 30.0}}),
    ("zero_tolerance_any_loss_flags", [_lost(0), _lost(1)], {},
     {"regressions": ["pipeline.batches_lost"],
      "ratio": {"pipeline.batches_lost": None}}),
    ("zero_tolerance_zero_stays_ok", [_lost(0), _lost(0)], {},
     {"ok": True, "ratio": {"pipeline.batches_lost": None}}),
    ("zero_tolerance_other_stage_count", [_lost(0, 4), _lost(3, 2)], {},
     {"ok": True, "verdicts": {"pipeline.batches_lost": SKIP_WINDOW}}),
    ("ratio_rounded_to_4_places", _hist(3.0, 2.0), {},
     {"regressions": ["img_per_sec"], "ratio": {"img_per_sec": 0.6667}}),
    ("atol_subtracted_higher_is_better_inside",
     [{"x": 100.0}, {"x": 86.0}], {"metrics": [_X_UP]}, {"ok": True}),
    ("atol_subtracted_higher_is_better_past",
     [{"x": 100.0}, {"x": 84.0}], {"metrics": [_X_UP]},
     {"regressions": ["x"]}),
    ("atol_added_lower_is_better_inside",
     [{"x": 100.0}, {"x": 114.0}], {"metrics": [_X_DOWN]}, {"ok": True}),
    ("atol_added_lower_is_better_past",
     [{"x": 100.0}, {"x": 116.0}], {"metrics": [_X_DOWN]},
     {"regressions": ["x"]}),
    ("default_tolerance_knob_tight", _hist(100.0, 88.0), {"tolerance": 0.1},
     {"regressions": ["img_per_sec"]}),
    ("default_tolerance_knob_loose", _hist(100.0, 88.0), {}, {"ok": True}),
    ("history_of_one", _hist(100.0), {},
     {"ok": True, "verdicts": {"img_per_sec": SKIP_WINDOW}}),
]


@pytest.mark.parametrize("history,kw,expect", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_compare_twin(history, kw, expect):
    report = both(history, **kw)
    rows = {r["metric"]: r for r in report["metrics"]}
    if "ok" in expect:
        assert report["ok"] is expect["ok"]
    if "regressions" in expect:
        assert report["regressions"] == expect["regressions"]
    for name in expect.get("flagged", ()):
        assert name in report["regressions"]
    for name, prefix in expect.get("verdicts", {}).items():
        assert rows[name]["verdict"].startswith(prefix), rows[name]
    for key in ("best", "ratio", "window"):
        for name, value in expect.get(key, {}).items():
            assert rows[name][key] == value, rows[name]


@pytest.mark.parametrize("history,kw", [
    ([], {}),
    (_hist(1.0, 2.0), {"window": 0}),
    (_hist(1.0, 2.0), {"window": -3}),
    (_hist(1.0, 2.0), {"tolerance": 1.5}),
    (_hist(1.0, 2.0), {"tolerance": 1.0}),
    (_hist(1.0, 2.0), {"tolerance": 0.0}),
    (_hist(1.0, 2.0), {"tolerance": -0.2}),
], ids=["empty", "window_0", "window_negative", "tolerance_1.5",
        "tolerance_1", "tolerance_0", "tolerance_negative"])
def test_compare_input_validation_twin(history, kw):
    with pytest.raises(ValueError) as want:
        jr.compare(history, **kw)
    with pytest.raises(ValueError) as got:
        tr.compare(history, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", [m.name for m in jr.DEFAULT_METRICS])
def test_default_metric_specs_are_the_jax_packages(name):
    want = {m.name: dataclasses.asdict(m) for m in jr.DEFAULT_METRICS}
    got = {m.name: dataclasses.asdict(m) for m in tr.DEFAULT_METRICS}
    assert [m.name for m in tr.DEFAULT_METRICS] == list(want)
    assert got[name] == want[name]


def test_knobs_and_spec_fields_are_the_jax_packages():
    assert (tr.DEFAULT_TOLERANCE, tr.DEFAULT_WINDOW) == (
        jr.DEFAULT_TOLERANCE, jr.DEFAULT_WINDOW)
    fields = [(f.name, f.default) for f in dataclasses.fields(tr.MetricSpec)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(jr.MetricSpec)]
    spec = tr.MetricSpec("a", "b")
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.name = "c"


@pytest.mark.parametrize("d,path", [
    ({"a": {"b": 3}}, "a.b"), ({"a": 1}, "a.b"), ({}, "a"),
    ({"a": {"b": None}}, "a.b"), (None, "a"), ([1, 2], "0"),
    ({"a": {"b": {"c": 0}}}, "a.b.c"), ({"a": {"b": [1]}}, "a.b"),
], ids=["nested", "through_a_leaf", "missing", "none_leaf", "not_a_dict",
        "list", "deep_zero", "list_leaf"])
def test_get_path_twin(d, path):
    assert tr.get_path(d, path) == jr.get_path(d, path)


@pytest.mark.parametrize("text", [
    json.dumps({"parsed": {"value": 5}}),
    json.dumps({"metric": "m", "value": 7}),
    json.dumps({"value": 7}),
    json.dumps({"parsed": [1], "metric": "m"}),
    json.dumps({"parsed": "x"}),
    json.dumps([{"metric": "m"}]),
    "{nope",
    "",
    None,
], ids=["wrapped", "bare_with_metric", "bare_without_metric",
        "parsed_not_a_dict_with_metric", "parsed_not_a_dict", "a_list",
        "junk", "empty", "missing_file"])
def test_load_capture_twin(tmp_path, text):
    path = tmp_path / "BENCH_TORCH_r01.json"
    if text is not None:
        path.write_text(text)
    got = tr.load_capture(str(path))
    assert got == jr.load_capture(str(path))
    if text is None or text in ("", "{nope"):
        assert got is None


# ------------------------------------------- the committed JAX captures

def _planted_dir(tmp_path):
    """The committed captures copied under their JAX names and a 25%
    img/s drop appended as the next one, as ``tests/test_regress.py``
    plants it."""
    assert len(JAX_FILES) == 5, JAX_FILES
    d = tmp_path / "jax_named"
    d.mkdir()
    for f in JAX_FILES:
        shutil.copy(f, d / os.path.basename(f))
    planted = copy.deepcopy(jr.load_capture(JAX_FILES[-1]))
    planted["value"] = round(planted["value"] * 0.75, 1)
    n = len(JAX_FILES) + 1
    (d / f"BENCH_r{n:02d}.json").write_text(
        json.dumps({"n": n, "parsed": planted}))
    return d


def _port_named(src_files, d):
    """The same captures under the port's file name, in order."""
    d.mkdir()
    for i, f in enumerate(src_files, start=1):
        shutil.copy(f, d / f"BENCH_TORCH_r{i:02d}.json")
    return tr.find_bench_files(str(d))


@pytest.mark.parametrize("kw", [{}, {"window": 1}, {"window": 2},
                                {"tolerance": 0.05}],
                         ids=["defaults", "window_1", "window_2",
                              "tolerance_0.05"])
def test_committed_captures_as_explicit_paths(kw):
    want = jr.compare_files(JAX_FILES, **kw)
    got = tr.compare_files(JAX_FILES, **kw)
    assert got == want
    assert tr.format_report(got) == jr.format_report(want)
    assert got["unparseable_files"] == [] and got["files"] == JAX_FILES
    if not kw:
        assert got["ok"], tr.format_report(got)


def test_planted_regression_on_committed_captures(tmp_path):
    files = jr.find_bench_files(str(_planted_dir(tmp_path)))
    want = jr.compare_files(files)
    got = tr.compare_files(files)
    assert got == want and not got["ok"]
    assert "img_per_sec" in got["regressions"]
    assert tr.format_report(got) == jr.format_report(want)
    # the same history under the port's name: the same verdicts
    port_files = _port_named(files, tmp_path / "port_named")
    assert len(port_files) == len(files)
    named = tr.compare_files(port_files)
    assert {k: v for k, v in named.items() if k != "files"} == {
        k: v for k, v in want.items() if k != "files"}


def test_unparseable_files_are_reported_twin(tmp_path):
    junk = tmp_path / "junk.json"
    junk.write_text("{nope")
    paths = [JAX_FILES[0], str(junk)] + JAX_FILES[1:]
    want = jr.compare_files(paths)
    got = tr.compare_files(paths)
    assert got == want and got["unparseable_files"] == [str(junk)]


def test_gate_current_twin(tmp_path):
    current = jr.load_capture(JAX_FILES[-1])
    want = jr.gate_current(copy.deepcopy(current), REPO)
    root = tmp_path / "port_named"
    port_files = _port_named(JAX_FILES, root)
    got = tr.gate_current(copy.deepcopy(current), str(root))
    assert got["baseline_files"] == port_files
    assert want["baseline_files"] == JAX_FILES
    assert {k: v for k, v in got.items() if k != "baseline_files"} == {
        k: v for k, v in want.items() if k != "baseline_files"}
    assert got["ok"]
    # a bad knob comes back as the same error, never raised
    assert tr.gate_current(current, str(root), window=0) == jr.gate_current(
        current, REPO, window=0) == {
            "error": "ValueError: window must be >= 1, got 0"}
    # no history: None
    missing = os.path.join(str(tmp_path), "nonexistent-dir")
    assert tr.gate_current({"value": 1.0}, missing) is None
    assert jr.gate_current({"value": 1.0}, missing) is None


def test_port_never_reads_the_jax_captures(tmp_path):
    """The departure by design: the port's discovery matches only
    ``BENCH_TORCH_rNN.json``, the JAX package's only ``BENCH_rNN.json``;
    each sees none of the other's files, in the repo root and in a mixed
    directory, and the port's gate over the root holds no JAX capture."""
    assert len(JAX_FILES) == 5
    port_root = tr.find_bench_files(REPO)
    assert all(re.fullmatch(r"BENCH_TORCH_r\d+\.json", os.path.basename(p))
               for p in port_root)
    assert not set(port_root) & set(JAX_FILES)
    current = jr.load_capture(JAX_FILES[-1])
    gated = tr.gate_current(current, REPO)
    if not port_root:  # no port capture committed: nothing to gate against
        assert port_root == [] and gated is None
    else:
        assert gated["baseline_files"] == port_root
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for i, f in enumerate(JAX_FILES, start=1):
        shutil.copy(f, mixed / os.path.basename(f))
        shutil.copy(f, mixed / f"BENCH_TORCH_r{i + 7:02d}.json")
    (mixed / "BENCH_TORCH_rx.json").write_text("{}")
    (mixed / "BENCH_TORCH_r3.json.bak").write_text("{}")
    port = tr.find_bench_files(str(mixed))
    assert [os.path.basename(p) for p in port] == [
        f"BENCH_TORCH_r{i:02d}.json" for i in range(8, 13)]
    assert [os.path.basename(p) for p in jr.find_bench_files(str(mixed))] \
        == [os.path.basename(f) for f in JAX_FILES]


def test_port_files_ordered_by_number_not_name(tmp_path):
    for n in (10, 2, 1, 33, 9):
        (tmp_path / f"BENCH_TORCH_r{n}.json").write_text("{}")
    assert [os.path.basename(p) for p in tr.find_bench_files(str(tmp_path))] \
        == [f"BENCH_TORCH_r{n}.json" for n in (1, 2, 9, 10, 33)]


# --------------------------------------------- the command line, in process

def _main(argv, capsys):
    rc = tr.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_main_exit_codes(tmp_path, capsys, monkeypatch):
    planted = jr.find_bench_files(str(_planted_dir(tmp_path)))
    assert _main(JAX_FILES, capsys)[0] == 0
    rc, out, _ = _main(["--json"] + planted, capsys)
    assert rc == 1 and "img_per_sec" in json.loads(out)["regressions"]
    assert _main(planted[:1], capsys)[0] == 2
    rc, _, err = _main(["--window", "0"] + JAX_FILES, capsys)
    assert rc == 2 and "window must be >= 1" in err
    # no files: the port's captures under the repo root, and only those
    empty = tmp_path / "empty"
    empty.mkdir()
    for f in JAX_FILES:
        shutil.copy(f, empty / os.path.basename(f))
    monkeypatch.setattr(tr, "_ROOT", str(empty))
    rc, _, err = _main([], capsys)
    assert rc == 2 and "no BENCH_TORCH_r*.json in" in err
    root = tmp_path / "port_named"
    _port_named(planted, root)
    monkeypatch.setattr(tr, "_ROOT", str(root))
    rc, out, _ = _main([], capsys)
    assert rc == 1 and "gating BENCH_TORCH_r06.json against 5 prior" in out


def test_self_test_in_process(capsys):
    rc, out, _ = _main(["--self-test"], capsys)
    assert rc == 0, out
    assert out.count("  PASS: ") == 7 and "FAIL" not in out
    assert out.rstrip().endswith("self-test: PASS")


# --------------------------------------------- the command line, as run

def _run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=REPO, **kw)


def test_cli_self_test_passes():
    rc = _run(PORT_CLI + ["--self-test"])
    assert rc.returncode == 0, rc.stdout + rc.stderr
    assert "self-test: PASS" in rc.stdout


def test_cli_planted_history_exits_one_as_compare_py(tmp_path):
    files = jr.find_bench_files(str(_planted_dir(tmp_path)))
    got = _run(PORT_CLI + ["--json"] + files)
    want = _run([sys.executable, COMPARE, "--json"] + files)
    assert got.returncode == want.returncode == 1, got.stdout + got.stderr
    assert "img_per_sec" in json.loads(got.stdout)["regressions"]
    assert got.stdout == want.stdout


def test_cli_committed_captures_text_as_compare_py():
    got = _run(PORT_CLI + JAX_FILES)
    want = _run([sys.executable, COMPARE] + JAX_FILES)
    assert got.returncode == want.returncode == 0, got.stdout + got.stderr
    assert "OK: no regressions" in got.stdout
    assert got.stdout == want.stdout


def test_cli_single_file_exits_two():
    rc = _run(PORT_CLI + JAX_FILES[:1])
    assert rc.returncode == 2, rc.stdout + rc.stderr
    assert "need >= 2 captures to compare, found 1" in rc.stderr


def test_cli_no_arguments_reads_only_port_captures():
    """With no files the command line gates the repo root's
    ``BENCH_TORCH_r*.json``; fewer than two there exits 2 and names the
    pattern, however many ``BENCH_r*.json`` the root holds."""
    rc = _run(PORT_CLI)
    if len(tr.find_bench_files(REPO)) < 2:
        assert rc.returncode == 2, rc.stdout + rc.stderr
        assert "BENCH_TORCH_r*.json" in rc.stderr
    else:
        assert rc.returncode in (0, 1), rc.stdout + rc.stderr
        assert "BENCH_r0" not in rc.stdout
