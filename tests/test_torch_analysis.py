"""The port's static-analysis suite (``dcnn_tpu_torch.analysis``) against
the JAX package's (``dcnn_tpu.analysis``), and the port clean under it.

- Parity: every fixture source of the JAX suite's language-agnostic tests
  (CC, AT, DL, PR, the CLI, PARSE and baseline fixtures of
  ``tests/test_analysis.py``, read from that file) goes through both suites,
  which must give the same finding keys and suppressions. Over both
  packages, ``dcnn_tpu/`` and ``dcnn_tpu_torch/``, the two suites' non-TS
  keys are equal too; so are MD01's. FC01 (only the port's own tests arm a
  port fault point) and GP01 (a receiver that resolves to a project class
  outside the tracer is not a span) are the two adaptations, each with a
  test of its own.
- Capture safety: a torch twin of every JAX TS fixture, the same hazard
  under a ``Session``, an ``autograd.Function`` or a ``custom_op`` root,
  with the same check ids and counts, and the negative cases: in-place
  tensor work (``copy_``, ``out=``, a slice store) and keyed session
  stores. The root set over the live port holds the six ``Session`` sites,
  the five ``autograd.Function`` subclasses and the custom ops.
- The live gates: zero unsuppressed findings over the port, the CLI
  exiting 0 with and without the three lints; the port's baseline holds
  only keys the JAX baseline accepts at the counterpart site.
- On the card, ``tests/test_torch_cuda.py`` (which imports no JAX) and
  ``chip_smoke.py`` phase 34 show the hazards the suite names behave as it
  says under ``core.graphs.Session``.

Each package is analysed once per module (fixtures); fixtures are parsed,
never imported.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from dcnn_tpu.analysis import all_checks as jax_checks
from dcnn_tpu.analysis import analyze_paths as jax_analyze
from dcnn_tpu.analysis.coverage import check_fault_coverage as jax_fc
from dcnn_tpu.analysis.coverage import check_metric_drift as jax_md
from dcnn_tpu.analysis.coverage import check_span_coverage as jax_gp
from dcnn_tpu_torch.analysis import (
    DEFAULT_BASELINE, Baseline, all_checks, analyze_paths, load_project,
    unsuppressed,
)
from dcnn_tpu_torch.analysis.__main__ import main as cli_main
from dcnn_tpu_torch.analysis.callgraph import CaptureGraph
from dcnn_tpu_torch.analysis.coverage import (
    check_fault_coverage, check_metric_drift, check_span_coverage,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "dcnn_tpu_torch")
JAX_PKG = os.path.join(ROOT, "dcnn_tpu")
JAX_TESTS = os.path.join(ROOT, "tests", "test_analysis.py")
DOC = os.path.join(ROOT, "docs", "observability.md")
SHARED = sorted(c for c in jax_checks() if not c.startswith("TS"))


def _keys(findings):
    return sorted((f.key, f.suppressed_by) for f in findings)


# -------------------------------------------------- JAX fixture sources --
# the tests of tests/test_analysis.py whose fixtures the two suites share
_SHARED_TESTS = ("test_cc", "test_at", "test_dl", "test_pr",
                 "test_protocol", "test_cli_only", "test_fault",
                 "test_metric", "test_cli_lint", "test_parse",
                 "test_cli_exit", "test_cli_write")


def _static(node, consts):
    """The string an expression of the JAX test file builds from literals,
    module constants, ``.replace`` and ``textwrap.dedent``; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr == "replace" and len(node.args) == 2:
            parts = [_static(a, consts)
                     for a in (node.func.value, *node.args)]
            if None not in parts:
                return parts[0].replace(parts[1], parts[2])
        if node.func.attr == "dedent" and len(node.args) == 1:
            s = _static(node.args[0], consts)
            return None if s is None else textwrap.dedent(s)
    return None


def _looks_like_code(s):
    return any(t in s for t in ("def ", "class ", "import ", " = "))


def _jax_fixtures():
    tree = ast.parse(open(JAX_TESTS, encoding="utf-8").read())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            s = _static(node.value, consts)
            if s is not None:
                consts[node.targets[0].id] = s
    cases = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith(_SHARED_TESTS)):
            continue
        seen = []
        doc = fn.body[0].value if isinstance(fn.body[0], ast.Expr) else None
        for node in ast.walk(fn):
            if node is doc:
                continue
            s = _static(node, consts)
            if s is None or not _looks_like_code(s):
                continue
            s = textwrap.dedent(s)
            if s not in seen:
                seen.append(s)
        cases += [(f"{fn.name}#{i}", s) for i, s in enumerate(seen)]
    return cases


FIXTURES = _jax_fixtures()


def test_fixture_extraction_covers_every_shared_family():
    names = {c.split("#")[0] for c, _ in FIXTURES}
    assert len(FIXTURES) >= 40
    for prefix in ("test_cc01", "test_cc02", "test_cc03", "test_at01",
                   "test_dl01", "test_dl02", "test_pr01", "test_pr02",
                   "test_fault_coverage", "test_metric_drift",
                   "test_parse_error", "test_cli_exit", "test_cli_write"):
        assert any(n.startswith(prefix) for n in names), prefix


def _both(tmp_path, files, checks=SHARED):
    """Each suite over the same files, under the same display paths."""
    out = []
    for suite, fn in (("jax", jax_analyze), ("port", analyze_paths)):
        root = tmp_path / suite / "pkg"
        for rel, src in files.items():
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / rel).write_text(src)
        out.append(fn([str(root)], checks=checks))
    return out


@pytest.mark.parametrize("src", [s for _, s in FIXTURES],
                         ids=[c for c, _ in FIXTURES])
def test_shared_fixture_parity(tmp_path, src):
    """Both suites give the same keys on the JAX suite's fixture text, as
    it stands and with every finding's line suppressed inline."""
    jax_f, port_f = _both(tmp_path / "plain", {"snippet.py": src})
    assert _keys(port_f) == _keys(jax_f)
    lines = src.splitlines()
    for f in port_f:
        if f.check_id != "PARSE" and f.line:
            lines[f.line - 1] += f"  # dcnn: disable={f.check_id}"
    jax_s, port_s = _both(tmp_path / "inline",
                          {"snippet.py": "\n".join(lines) + "\n"})
    assert _keys(port_s) == _keys(jax_s)
    # a file that does not parse has no lines to suppress on
    assert [f.check_id for f in unsuppressed(port_s)] == \
        [f.check_id for f in port_f if f.check_id == "PARSE"]


def test_every_check_id_registered():
    assert set(all_checks()) == set(jax_checks())
    assert {c: all_checks()[c].name for c in SHARED} == \
        {c: jax_checks()[c].name for c in SHARED}


def test_metric_drift_parity(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "prod.py").write_text(textwrap.dedent("""
        def emit(reg, p, name):
            reg.counter("demo_requests_total").inc()
            reg.gauge(f"demo_depth_{p}").set(1)
            reg.counter(name).inc()
            reg.counter(name).inc()  # dcnn: metric=demo_x_*_total
        """))
    doc = tmp_path / "observability.md"
    doc.write_text("`demo_requests_total` `demo_depth_<class>` "
                   "`demo_dead_total`\n")
    port = check_metric_drift(str(pkg), str(doc))
    assert _keys(port) == _keys(jax_md(str(pkg), str(doc)))
    assert {f.detail for f in port} == {"<unresolvable>", "demo_dead_total",
                                        "demo_x_*_total"}


# ----------------------------------------------------- the live packages --
def _cli_json(*args):
    r = subprocess.run([sys.executable, "-m", "dcnn_tpu_torch.analysis",
                        *args, "--json"], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    return r.returncode, json.loads(r.stdout)


@pytest.fixture(scope="module")
def port_report():
    """``python -m dcnn_tpu_torch.analysis --json``: the CLI as a user
    runs it, with its defaults (the port, its committed baseline)."""
    return _cli_json()


@pytest.fixture(scope="module")
def port_project():
    return load_project([PORT])


@pytest.fixture(scope="module")
def capture_graph(port_project):
    return CaptureGraph(port_project)


def test_live_port_zero_unsuppressed(port_report):
    """The acceptance gate: the port analysed with its committed baseline
    has no unsuppressed finding, and every suppression in it is inline
    (the baseline is empty: the JAX baseline's one entry has no
    counterpart finding in the port)."""
    rc, report = port_report
    live = [f for f in report["findings"] if f["suppressed_by"] is None]
    assert rc == 0 and report["unsuppressed"] == 0, live
    assert {f["suppressed_by"] for f in report["findings"]} <= {"inline"}
    assert report["checks"] == sorted(all_checks())


def test_live_port_lints_exit_zero(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    assert cli_main(["dcnn_tpu_torch", "--fault-coverage", "--metric-drift",
                     "--span-coverage"]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")


def test_shared_families_agree_over_the_port(port_report):
    """The JAX suite's non-TS keys over the port equal the port suite's
    (the port's run is the CLI's, so display paths match)."""
    _, report = port_report
    port = sorted((f["key"], f["suppressed_by"]) for f in report["findings"]
                  if not f["check_id"].startswith("TS"))
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jax_f = jax_analyze(["dcnn_tpu_torch"], checks=SHARED)
    finally:
        os.chdir(cwd)
    assert port == _keys(jax_f)


def test_shared_families_agree_over_the_jax_package():
    port = analyze_paths([JAX_PKG], checks=SHARED)
    jax_f = jax_analyze([JAX_PKG], checks=SHARED)
    assert _keys(port) == _keys(jax_f)
    # the one finding JAX's baseline accepts (CC02 at Inbox.attach) is a
    # finding of the port's suite too, at the same key
    jax_base = Baseline.load(os.path.join(JAX_PKG, "analysis",
                                          "baseline.json"))
    assert set(jax_base.entries) <= {f.key for f in port}


def test_metric_drift_agrees_over_both_packages(port_project):
    assert not check_metric_drift(PORT, DOC, project=port_project)
    assert _keys(check_metric_drift(PORT, DOC, project=port_project)) == \
        _keys(jax_md(PORT, DOC, project=port_project))
    assert _keys(check_metric_drift(JAX_PKG, DOC)) == \
        _keys(jax_md(JAX_PKG, DOC))


def test_baseline_entries_have_jax_counterparts():
    """Every entry of the port's baseline carries a reason and accepts a
    finding that the JAX baseline accepts at the counterpart site."""
    port = Baseline.load(DEFAULT_BASELINE)
    jax_keys = set(Baseline.load(os.path.join(
        JAX_PKG, "analysis", "baseline.json")).entries)
    assert os.path.isfile(DEFAULT_BASELINE)
    assert DEFAULT_BASELINE.startswith(os.path.join(PORT, "analysis"))
    for key, why in port.entries.items():
        assert why.strip(), key
        assert key.replace("::dcnn_tpu_torch/", "::dcnn_tpu/", 1) \
            in jax_keys, key


# ------------------------------------------------- the two adaptations --
def test_fc01_counts_only_the_ports_tests(tmp_path):
    """A point that only a JAX-package test arms is a finding of the port's
    FC01 and not of JAX's; a ``test_torch_*`` file arming it clears it."""
    pkg, tests = tmp_path / "pkg", tmp_path / "tests"
    pkg.mkdir()
    tests.mkdir()
    (pkg / "prod.py").write_text(textwrap.dedent("""
        from resilience import faults as _faults

        def save():
            _faults.trip("ckpt.demo_write")
        """))
    (tests / "test_x.py").write_text(
        'def test_armed(plan):\n    plan.arm("ckpt.demo_write")\n')
    assert not jax_fc(str(pkg), str(tests))
    assert [f.detail for f in check_fault_coverage(str(pkg), str(tests))] \
        == ["ckpt.demo_write"]
    (tests / "test_torch_x.py").write_text('P = "ckpt.demo_write"\n')
    assert not check_fault_coverage(str(pkg), str(tests))


def test_fc01_over_the_port(port_project):
    """Every fault point of the port is armed by a port test."""
    from dcnn_tpu_torch.analysis.coverage import collect_trip_points

    assert len(collect_trip_points(port_project)) >= 20
    assert not check_fault_coverage(PORT, os.path.join(ROOT, "tests"),
                                    project=port_project)


def test_gp01_resolves_the_receiver(tmp_path):
    """``TrainStep.begin(ts, lr)`` (on ``self``, or on an alias of a typed
    attribute) is not a span in the port's GP01; JAX's reports each as an
    unresolvable span name. A tracer's dynamic name stays a finding."""
    pkg = tmp_path / "pkg"
    (pkg / "obs").mkdir(parents=True)
    (pkg / "obs" / "goodput.py").write_text(
        'SPAN_BUCKETS = {"train.step": "compute"}\n')
    (pkg / "obs" / "tracer.py").write_text(textwrap.dedent("""
        class Tracer:
            def begin(self, name):
                return name
        """))
    (pkg / "step.py").write_text(textwrap.dedent("""
        from obs.tracer import Tracer

        class TrainStep:
            def begin(self, ts, lr):
                return ts

            def __call__(self, ts, lr):
                self.begin(ts, lr)

        class Batch:
            def __init__(self, step: TrainStep):
                self.step = step

            def __call__(self, ts, lr):
                step = self.step
                step.begin(ts, lr)

        def spans(tracer: Tracer, name):
            tracer.begin("train.step")
            tracer.begin(name)
        """))
    port = check_span_coverage(str(pkg))
    jax_f = jax_gp(str(pkg))
    assert [(f.symbol, f.detail) for f in port] == [("spans",
                                                     "<unresolvable>")]
    assert sorted(f.symbol for f in jax_f) == ["Batch.__call__",
                                               "TrainStep.__call__",
                                               "spans"]


def test_gp01_over_the_port(port_project):
    """The two live ``TrainStep.begin`` sites are findings of JAX's GP01
    and not of the port's."""
    assert not check_span_coverage(PORT, project=port_project)
    jax_f = jax_gp(PORT, project=port_project)
    assert sorted(f.symbol for f in jax_f) == ["BatchStep.__call__",
                                               "TrainStep.__call__"]


# ------------------------------------------------------------ plumbing --
def _cli(*args, cwd=ROOT):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return cli_main(list(args))
    finally:
        os.chdir(old)


def test_cli_exit_codes_json_and_baseline(tmp_path, capsys):
    """The JAX CLI's exit codes (0 clean, 1 findings, 2 usage), JSON shape
    and ``--write-baseline`` round trip, through the port's atomic
    write."""
    bad = tmp_path / "bad.py"
    bad.write_text("def save(p, t):\n"
                   "    with open(p, 'w') as f:\n"
                   "        f.write(t)\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert _cli(str(bad), "--no-baseline") == 1
    assert "AT01" in capsys.readouterr().out
    assert _cli(str(good), "--no-baseline") == 0
    capsys.readouterr()
    assert _cli(str(tmp_path), "--no-baseline", "--json") == 1
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"findings", "unsuppressed", "suppressed",
                           "wall_s", "checks"}
    assert report["unsuppressed"] == 1
    assert report["findings"][0]["key"].startswith(
        f"AT01::{tmp_path.name}/bad.py::save")
    assert _cli(str(bad), "--checks", "BOGUS") == 2
    assert _cli(str(tmp_path / "missing.py")) == 2
    assert _cli(str(bad), "--only", "bad.py",
                "--write-baseline", str(tmp_path / "x.json")) == 2
    assert _cli("--list-checks") == 0
    assert "TS06" in capsys.readouterr().out
    base = tmp_path / "baseline.json"
    assert _cli(str(bad), "--no-baseline", "--write-baseline",
                str(base)) == 0
    assert len(json.loads(base.read_text())["findings"]) == 1
    assert _cli(str(bad), "--baseline", str(base)) == 0


# ------------------------------------------------ capture safety (TS) --
def run_snippet(tmp_path, src, *, rel="snippet.py", checks=None,
                baseline=None, phase="p0"):
    """``src`` at <tmp>/<phase>/pkg/<rel>, the pkg root analysed: the same
    display path in every phase, as the JAX suite's tests do it."""
    root = tmp_path / phase / "pkg"
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return analyze_paths([str(root)], checks=checks, baseline=baseline)


def live(findings):
    return unsuppressed(findings)


def _quad(tmp_path, check_id, positive, clean, *, rel="snippet.py"):
    """The JAX suite's four-way contract: the positive fixture finds,
    inline and baseline suppression hold, the clean twin passes, and no
    other check claims the finding."""
    hits = live(run_snippet(tmp_path, positive, rel=rel))
    assert [f.check_id for f in hits].count(check_id) >= 1, \
        f"{check_id} positive fixture produced {hits}"
    hit = next(f for f in hits if f.check_id == check_id)
    lines = textwrap.dedent(positive).splitlines()
    lines[hit.line - 1] += f"  # dcnn: disable={check_id}"
    sup = run_snippet(tmp_path, "\n".join(lines) + "\n", rel=rel,
                      phase="inline")
    sup_hits = [f for f in sup if f.check_id == check_id]
    assert sup_hits and all(f.suppressed_by == "inline" for f in sup_hits)
    base = Baseline({f.key: "accepted for test" for f in hits})
    based = run_snippet(tmp_path, positive, rel=rel, phase="baseline",
                        baseline=base)
    based_hits = [f for f in based if f.check_id == check_id]
    assert based_hits and all(f.suppressed_by == "baseline"
                              for f in based_hits)
    assert not [f for f in live(run_snippet(tmp_path, clean, rel=rel,
                                            phase="clean"))
                if f.check_id == check_id]
    others = [c for c in all_checks() if c != check_id]
    assert not [f for f in live(run_snippet(tmp_path, positive, rel=rel,
                                            phase="attr", checks=others))
                if f.check_id == check_id]
    return hit


def _ids(findings):
    return sorted(f.check_id for f in live(findings))


def test_ts01_host_sync(tmp_path):
    hit = _quad(tmp_path, "TS01", """
        import numpy as np
        from dcnn_tpu_torch.core.graphs import Session

        def step(x):
            return np.asarray(x).sum()

        def build(x, pool):
            return Session("step", step, (x,), pool=pool)
        """, """
        import torch
        from dcnn_tpu_torch.core.graphs import Session

        def step(x):
            return torch.as_tensor(x).sum()

        def build(x, pool):
            return Session("step", step, (x,), pool=pool)
        """)
    assert hit.detail == "np.asarray"


def test_ts01_item_and_factory_entry(tmp_path):
    # the session factory idiom (a train step built around a closure)
    hits = live(run_snippet(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session

        def make_step(model, x, pool):
            def step(ts, x):
                loss = model(ts, x)
                host = loss.item()
                return host
            return Session("train_step", step, (x,), pool=pool)
        """))
    assert [(f.check_id, f.detail) for f in hits] == [("TS01", "item")]


def test_ts01_propagates_through_called_helper(tmp_path):
    hits = live(run_snippet(tmp_path, """
        import torch

        def helper(v):
            return v.cpu()

        class Step(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return helper(x)

            @staticmethod
            def backward(ctx, g):
                return g
        """))
    assert [(f.check_id, f.symbol) for f in hits] == [("TS01", "helper")]


@pytest.mark.parametrize("call,detail", [
    ("x.tolist()", "tolist"), ("x.numpy()", "numpy"),
    ('x.to("cpu")', "to-cpu"), ("x.to(device='cpu')", "to-cpu"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("torch.cuda.current_stream().synchronize()", "synchronize"),
])
def test_ts01_host_reads(tmp_path, call, detail):
    hits = live(run_snippet(tmp_path, f"""
        import torch
        from dcnn_tpu_torch.core.graphs import Session

        def step(x):
            y = {call}
            return x

        def build(x, pool):
            return Session("step", step, (x,), pool=pool)
        """))
    assert [(f.check_id, f.detail) for f in hits] == [("TS01", detail)]


def test_ts02_host_cast(tmp_path):
    _quad(tmp_path, "TS02", """
        import torch

        @torch.library.custom_op("demo::step", mutates_args=())
        def step(x: torch.Tensor) -> torch.Tensor:
            return float(x) * 2.0 * x
        """, """
        import torch

        @torch.library.custom_op("demo::step", mutates_args=())
        def step(x: torch.Tensor, scale: float) -> torch.Tensor:
            return float(x.shape[0]) * float(scale) * x.size(0) * x
        """)


def test_ts03_capture_print(tmp_path):
    _quad(tmp_path, "TS03", """
        from dcnn_tpu_torch.core.graphs import Session

        def build(x, pool):
            def step(x):
                print("loss", x)
                return x
            return Session("step", step, (x,), pool=pool)
        """, """
        from dcnn_tpu_torch.core.graphs import Session

        def build(x, pool):
            def step(x):
                return x
            s = Session("step", step, (x,), pool=pool)
            print("loss", s(x))
            return s
        """)


def test_ts04_global_rng(tmp_path):
    _quad(tmp_path, "TS04", """
        import numpy as np

        def pick(n):
            return np.random.randint(0, 10, size=n)
        """, """
        import numpy as np

        def pick(n, rng: np.random.Generator):
            return rng.integers(0, 10, size=n)
        """, rel="data/augment.py")


def test_ts04_torch_global_generator(tmp_path):
    hit = _quad(tmp_path, "TS04", """
        import torch

        def flip(x):
            return x.flip(-1) if torch.rand(()) < 0.5 else x
        """, """
        import torch

        def flip(x, gen: torch.Generator):
            return x.flip(-1) if torch.rand((), generator=gen) < 0.5 else x
        """, rel="data/augment.py")
    assert hit.detail == "torch.rand"
    hits = live(run_snippet(tmp_path, """
        import torch

        def noise(x, g):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            x.normal_()
            x.uniform_(0, 1, generator=g)
            return torch.randperm(8), torch.randn(3, generator=g)
        """, rel="data/workers.py", phase="torch"))
    assert sorted(f.detail for f in hits) == [
        ".normal_", "torch.cuda.manual_seed_all", "torch.manual_seed",
        "torch.randperm"]


def test_ts04_only_in_contract_modules(tmp_path):
    hits = live(run_snippet(tmp_path, """
        import numpy as np
        import torch

        def pick(n):
            return np.random.randint(0, 10, size=n), torch.rand(n)
        """, rel="util.py"))
    assert not [f for f in hits if f.check_id == "TS04"]


def test_ts05_capture_impure(tmp_path):
    _quad(tmp_path, "TS05", """
        from dcnn_tpu_torch.core.graphs import Session

        LOSSES = []

        def step(x):
            LOSSES.append(x)
            return x

        def build(x, pool):
            return Session("step", step, (x,), pool=pool)
        """, """
        from dcnn_tpu_torch.core.graphs import Session

        def step(x):
            losses = []
            losses.append(x)
            return x

        def build(x, pool):
            return Session("step", step, (x,), pool=pool)
        """)


def test_ts05_api_update_call_not_flagged(tmp_path):
    hits = live(run_snippet(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session

        def make(opt, x, pool):
            def step(ts, g):
                new_params, new_opt = opt.update(g, ts)
                return new_params, new_opt
            return Session("step", step, (x, x), pool=pool)
        """))
    assert not [f for f in hits if f.check_id == "TS05"]


def test_ts05_python_state_against_tensor_writes(tmp_path):
    """``self.<attr>``, closed-over containers, global and plain-key
    subscript writes are findings; in-place tensor work (``_`` methods,
    ``out=``, slice and ``...`` stores, on ``self`` too) is what the graph
    replays, and is not."""
    hits = live(run_snippet(tmp_path, """
        import torch
        from dcnn_tpu_torch.core.graphs import Session

        STATS = {}
        STEPS = 0

        class Engine:
            def __init__(self, x, pool):
                self.buf = torch.zeros_like(x)
                self.cache = {}
                self.session = Session("fwd", self._forward, (x,),
                                       pool=pool)

            def _forward(self, x):
                global STEPS
                self.calls = 1
                self.cache["last"] = x
                STATS["n"] = 1
                STEPS += 1
                self.buf.copy_(x)
                self.buf.add_(1.0)
                self.buf[:x.shape[0]] = x
                self.buf[..., 0] += 1
                torch.mul(x, 2, out=self.buf)
                y = torch.empty_like(x)
                y[0] = x[0]
                return y
        """))
    got = sorted((f.check_id, f.detail, f.line) for f in hits)
    assert [(c, d) for c, d, _ in got] == [
        ("TS05", "STATS"), ("TS05", "STEPS"), ("TS05", "self"),
        ("TS05", "self")]


def _ts06(tmp_path, src, phase):
    return {f.detail for f in live(run_snippet(tmp_path, src,
                                               checks=["TS06"],
                                               phase=phase))}


def test_ts06_session_per_call(tmp_path):
    hit = _quad(tmp_path, "TS06", """
        from dcnn_tpu_torch.core.graphs import Session

        def run(x, pool):
            return Session("s", lambda t: t * 2, (x,), pool=pool)(x)
        """, """
        from dcnn_tpu_torch.core.graphs import Session

        def _double(t):
            return t * 2

        class Runner:
            def __init__(self, pool):
                self.pool, self.sessions = pool, {}

            def __call__(self, x):
                key = (tuple(x.shape), x.dtype)
                if key not in self.sessions:
                    self.sessions[key] = Session("s", _double, (x,),
                                                 pool=self.pool)
                return self.sessions[key](x)
        """)
    assert hit.detail == "session-per-call"


def test_ts06_session_per_call_and_in_loop(tmp_path):
    details = _ts06(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session

        def f(x):
            return x + 1

        def run(xs, pool):
            out = []
            for x in xs:
                out.append(Session("s", f, (x,), pool=pool)(x))
            for x in xs:
                s = Session("s", f, (x,), pool=pool)
                out.append(s(x))
            return out
        """, "percall")
    assert details == {"session-per-call", "session-in-loop"}
    # the live idiom: a session a bucket, stored under its key in a loop
    assert not _ts06(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session

        def f(x):
            return x + 1

        def warm(sessions, buckets, pool, zeros):
            for b in buckets:
                sessions[(b, "parity")] = Session("s", f, (zeros(b),),
                                                  pool=pool)
        """, "keyed")


def test_ts06_per_call_lookup_keys(tmp_path):
    details = _ts06(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session, SessionCache

        def f(x, n):
            return x * n

        class Step:
            def __init__(self, pool):
                self.pool = pool
                self.sessions = SessionCache()

            def __call__(self, x, batch, bind):
                key = (tuple(x.shape), len(batch))
                s = self.sessions.lookup(
                    key, bind, lambda: Session("s", f, (x,), pool=self.pool))
                t = self.sessions.lookup(
                    (x.dtype, x.shape[0] * 2), bind,
                    lambda: Session("t", f, (x,), pool=self.pool))
                return s, t
        """, "churn")
    assert details == {"lookup-key:len(batch)", "lookup-key:x.shape[0] * 2"}
    # constants, names, dtypes and shape tuples are what a key is made of
    assert not _ts06(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session, SessionCache

        def f(x):
            return x

        class Step:
            def __init__(self, pool):
                self.pool = pool
                self.sessions = SessionCache()

            def __call__(self, x, y, flag, bind, inputs):
                key = (tuple(x.shape), x.dtype, tuple(y.shape), flag,
                       y is None, 4)
                a = self.sessions.lookup(
                    key, bind, lambda: Session("a", f, (x,), pool=self.pool))
                k2 = tuple((tuple(t.shape), t.dtype) for t in inputs)
                b = self.sessions.lookup(
                    k2, bind, lambda: Session("b", f, (x,), pool=self.pool))
                return a, b
        """, "churnclean")


def test_ts06_lookup_key_by_keyword(tmp_path):
    details = _ts06(tmp_path, """
        from dcnn_tpu_torch.core.graphs import Session

        def f(x):
            return x

        def drive(cache, x, items, bind, pool):
            return cache.lookup(key=(x.dtype, f"n{len(items)}"),
                                binding=bind,
                                capture=lambda: Session("s", f, (x,),
                                                        pool=pool))
        """, "kwname")
    assert details == {"lookup-key:f'n{len(items)}'"}


def test_capture_roots_reach_forwarded_lambdas_and_rules(tmp_path):
    """A forwarder's caller's lambda, a ``register_fake`` rule and a
    factory-made custom op are roots; a plain function is not."""
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "m.py").write_text(textwrap.dedent("""
        import torch
        from dcnn_tpu_torch.core.graphs import Session

        def _op(name):
            return torch.library.custom_op(f"demo::{name}", mutates_args=())

        @_op("double")
        def double(x: torch.Tensor) -> torch.Tensor:
            return x * 2

        @double.register_fake
        def _(x):
            return torch.empty_like(x)

        class Step:
            def capture(self, name, fn, example, pool):
                return Session(name, fn, example, pool=pool)

            def body(self, x):
                print(x)
                return x

            def build(self, x, pool):
                return self.capture("s", lambda t: self.body(t), (x,), pool)

        def plain(x):
            print(x)
        """))
    g = CaptureGraph(load_project([str(root)]))
    assert set(g.roots) == {("pkg/m.py", "double"), ("pkg/m.py", "_"),
                            ("pkg/m.py", "Step.build.<lambda>")}
    assert ("pkg/m.py", "Step.body") in g.captured
    assert ("pkg/m.py", "plain") not in g.captured
    hits = live(analyze_paths([str(root)]))
    assert [(f.check_id, f.symbol) for f in hits] == [("TS03", "Step.body")]


def test_live_capture_roots(capture_graph):
    """The root set over the live port: the six ``Session`` sites (two
    through forwarders, ``TrainStep.capture`` and ``_Compiled.__call__``),
    the five ``autograd.Function`` subclasses and the custom ops with
    their rules."""
    roots = capture_graph.roots
    sites = {
        "serve/engine.py": "InferenceEngine._capture",
        "serve/decode.py": "DecodeEngine._capture",
        "train/trainer.py": "EvalStep.__call__",
        "parallel/data_parallel.py": "ElasticGradStep.packed",
    }
    reasons = set(roots.values())
    for path, holder in sites.items():
        assert f"Session fn in dcnn_tpu_torch/{path}::{holder}" in reasons, \
            path
    # trainer.py's TrainStep.capture and compiled_pipeline.py's
    # _Compiled.__call__ build the session of whatever fn their callers pass
    assert capture_graph.forwarders == {
        ("dcnn_tpu_torch/train/trainer.py", "TrainStep.capture"): (1, "fn"),
        ("dcnn_tpu_torch/parallel/compiled_pipeline.py",
         "_Compiled.__call__"): (0, "fn")}
    through = {r for r in reasons if " through " in r}
    assert any("TrainStep.capture() in dcnn_tpu_torch/train/trainer.py"
               in r for r in through)
    assert any("TrainStep.capture() in dcnn_tpu_torch/data/device_dataset"
               in r for r in through)
    assert sum("_Compiled.__call__()" in r for r in through) == 3
    for key in [("serve/engine.py", "InferenceEngine._forward"),
                ("train/trainer.py", "EvalStep.run"),
                ("parallel/data_parallel.py", "ElasticGradStep._body"),
                ("serve/decode.py", "DecodeEngine._capture.<lambda>")]:
        assert ("dcnn_tpu_torch/" + key[0], key[1]) in roots, key
    for key in [("train/trainer.py", "TrainStep.body"),
                ("train/trainer.py", "TrainStep._probe"),
                ("data/device_dataset.py", "BatchStep.run"),
                ("parallel/compiled_pipeline.py", "ScheduledStep._run"),
                ("serve/decode.py", "DecodeEngine._step")]:
        assert ("dcnn_tpu_torch/" + key[0], key[1]) in capture_graph.captured
    autograd = {qn.split(".")[0] for (_, qn), r in roots.items()
                if r.startswith("autograd.Function")}
    assert autograd == {"AllToAll", "AllReduceSum", "HaloExchange",
                        "GatherDim", "_RingAttention"}
    assert sum(r.startswith("autograd.Function") for r in reasons) == 10
    ops = {qn for (p, qn), r in roots.items() if r.endswith("custom op")}
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "conv3x3_s1",
            "conv3x3_s1_pairs", "conv3x3_s1_bnrelu_in",
            "fused_scale_bias_relu", "conv_int8", "conv_int8_fused",
            "dense_int8"} <= ops
    src = open(os.path.join(PORT, "ops", "library.py")).read()
    assert sum(r == "@register_fake" for r in roots.values()) \
        == src.count(".register_fake\n")
    assert ("dcnn_tpu_torch/nn/sequential.py", "Sequential.forward") in roots
