"""The port's AOT cache (``dcnn_tpu_torch/aot/``), the port-side twins of
``tests/test_aot.py`` on the CPU.

What the port caches is its kernel libraries (``nvcc`` over
``ops/csrc/*.cu``) and its exported serving programs. Contracts pinned
here:

- keys are stable across processes, hold no addresses, and change with
  the inputs' specs, the precision mode and the config digest;
- an untrusted root is refused (a hit loads a shared library or unpickles
  a program), and an engine handed one runs uncached;
- commit and lookup round-trip through the checksum MANIFEST; a flipped
  bit is quarantined and built again; a stale version is a miss; keep-K
  GC keeps the most recently used;
- the ``aot.commit`` / ``aot.load`` fault points: a crash before a commit
  leaves no entry, a commit or load fault degrades to the uncached path
  (counted);
- a warm hit is bit for bit the cold build; engines hit across rebuilds
  and miss on other weights; an engine without a weights digest, or
  without a cache asked for, is uncached;
- the kernel build restores its libraries from the cache with ``nvcc``
  unreachable (a stand-in compiler and loader here, where there is no
  CUDA), and commits fresh builds;
- the CLI lists, collects and prewarms (library build stubbed);
- a fresh process loads the program and the libraries with no export, no
  trace and no compiler, and serves bit for bit what the first served.

No test reads ``AOT_CACHE`` or ``CUDA_HOME`` from the environment: both
are cleared or set here.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.aot import (ExecutableCache, TensorSpec, WarmCallable,
                                cache_key, maybe_warm, warm_or_compile)
from dcnn_tpu_torch.aot import warm as aot_warm
from dcnn_tpu_torch.aot.keys import backend_fingerprint, callable_id
from dcnn_tpu_torch.core.precision import get_precision_mode, set_precision
from dcnn_tpu_torch.nn import (SequentialBuilder, export_inference,
                               load_inference)
from dcnn_tpu_torch.obs.registry import MetricsRegistry
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.losses import softmax_cross_entropy
from dcnn_tpu_torch.resilience import FaultPlan
from dcnn_tpu_torch.resilience.faults import InjectedCrash
from dcnn_tpu_torch.serve.engine import InferenceEngine
from dcnn_tpu_torch.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_ambient_cache(monkeypatch):
    monkeypatch.delenv("AOT_CACHE", raising=False)
    monkeypatch.delenv("DCNN_COMPILE_CACHE", raising=False)
    # build roots a test enables are its own, not the process's atexit's
    monkeypatch.setattr(cc, "_SESSIONS", {})
    monkeypatch.setattr(aot_warm, "_CACHES", {})


def _model(seed=0):
    return (SequentialBuilder("aot_t").input((6,))
            .dense(16).activation("relu").dense(4).build()).init(
        generator=torch.Generator().manual_seed(seed), device="cpu").eval()


def _x(b=8, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, 6)).astype(np.float32))


SPEC = TensorSpec(("batch", 6), torch.float32)


def _warm(model, cache, cfg="cfg", reg=None):
    return warm_or_compile(
        lambda spec: export_inference(model, device="cpu"), SPEC,
        cache=cache, load=load_inference, what="serve", config=cfg,
        registry=reg)


# ------------------------------------------------------------------- keys

def test_cache_key_stable_and_sensitive():
    args = (SPEC,)
    k1, m1 = cache_key(args, config="cfg")
    assert cache_key(args, config="cfg")[0] == k1
    # a tensor keys as the spec of its shape and dtype does
    k4 = cache_key((torch.zeros(4, 6),), config="cfg")[0]
    assert k4 == cache_key((TensorSpec((4, 6), torch.float32),),
                           config="cfg")[0]
    assert k4 != k1
    assert cache_key(args, config="other")[0] != k1
    assert cache_key((TensorSpec(("batch", 6), torch.bfloat16),),
                     config="cfg")[0] != k1
    old = get_precision_mode()
    try:
        set_precision("bf16")
        assert cache_key(args, config="cfg")[0] != k1
    finally:
        set_precision(old)
    assert m1["config"] == "cfg" and m1["fingerprint"]["torch"]
    assert m1["avals"]["leaves"] == [[["batch", 6], "float32"]]


def test_callable_id_has_no_addresses():
    cid = callable_id(softmax_cross_entropy)
    assert "0x" not in cid and "softmax_cross_entropy" in cid
    cid2 = callable_id(functools.partial(softmax_cross_entropy))
    assert "partial" in cid2 and "0x" not in cid2


def test_callable_id_bound_method_folds_in_owner_config():
    """Two models whose layers differ key their bound ``forward``
    differently; two alike, alike."""
    a, b = _model(), (SequentialBuilder("aot_t").input((6,))
                      .dense(8).dense(4).build())
    ia, ib = callable_id(a.forward), callable_id(b.forward)
    assert ia != ib and "0x" not in ia
    assert callable_id(_model(1).forward) == ia


# ------------------------------------------------------- cache mechanics

def test_untrusted_root_refused(tmp_path):
    """A hit loads a library or unpickles a program, so a root another user
    could plant or swap is refused: world-writable without the sticky bit
    (the root or an ancestor), or foreign-owned. Sticky 1777 (``/tmp``) is
    trusted. Fresh roots are 0700. An engine given such a root runs
    uncached."""
    ww = tmp_path / "ww"
    ww.mkdir()
    os.chmod(ww, 0o777)
    with pytest.raises(ValueError, match="world-writable"):
        ExecutableCache(str(ww))
    with pytest.raises(ValueError, match="world-writable"):
        ExecutableCache(str(ww / "aot"))
    sticky = tmp_path / "sticky"
    sticky.mkdir()
    os.chmod(sticky, 0o1777)
    ExecutableCache(str(sticky / "aot"))
    if hasattr(os, "getuid") and os.getuid() == 0:
        foreign = tmp_path / "foreign"
        foreign.mkdir()
        os.chown(foreign, 12345, 12345)
        with pytest.raises(ValueError, match="owned by uid"):
            ExecutableCache(str(foreign))
    fresh = tmp_path / "fresh"
    ExecutableCache(str(fresh))
    assert (os.stat(fresh).st_mode & 0o777) == 0o700
    eng = InferenceEngine.from_model(_model(), fold=False, max_batch=2,
                                     device="cpu", aot_cache=str(ww / "r"))
    assert eng.aot is None and eng.aot_info == {}
    assert not (ww / "r" / "aot").exists() or not os.listdir(ww / "r" / "aot")


def test_commit_lookup_roundtrip_and_idempotence(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"), registry=MetricsRegistry())
    assert cache.commit("k" * 64, b"payload-bytes", {"what": "t"})
    assert cache.lookup("k" * 64) == b"payload-bytes"
    assert not cache.commit("k" * 64, b"payload-bytes", {"what": "t"})
    rows = cache.entries()
    assert len(rows) == 1 and rows[0]["what"] == "t"
    assert rows[0]["hits"] == 1


def test_bitflip_quarantined_and_rebuilt(tmp_path):
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "aot"), registry=reg)
    _, info = _warm(_model(), cache, reg=reg)
    assert info["committed"] and not info["hit"]
    key = info["key"]
    FaultPlan(seed=3).bit_flip(str(tmp_path / "aot" / key / "payload.bin"))
    with pytest.warns(UserWarning, match="quarantined"):
        _, info2 = _warm(_model(), cache, reg=reg)
    assert not info2["hit"] and info2["committed"] and info2["key"] == key
    assert reg.snapshot().get("aot_quarantined_total") == 1
    assert len([n for n in os.listdir(tmp_path / "aot")
                if n.startswith("corrupt-")]) == 1
    _, info3 = _warm(_model(), cache, reg=reg)
    assert info3["hit"]


def test_stale_version_entry_is_miss_not_crash(tmp_path):
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "aot"), registry=reg)
    _, info = _warm(_model(), cache, reg=reg)
    key = info["key"]
    mp = tmp_path / "aot" / key / "MANIFEST.json"
    m = json.loads(mp.read_text())
    m["material"]["fingerprint"]["torch"] = "0.0.0"
    mp.write_text(json.dumps(m))
    assert cache.lookup(key, fingerprint=backend_fingerprint()) is None
    assert reg.snapshot().get("aot_stale_total") == 1
    assert (tmp_path / "aot" / key / "payload.bin").exists()


def test_keep_k_gc_retains_most_recently_used(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"), keep=10)
    for i in range(5):
        assert cache.commit(f"key{i:061d}", f"p{i}".encode(), {"what": "t"})
    cache.lookup("key" + "0" * 61)
    assert cache.gc(keep=2) == 3
    kept = {r["key"] for r in cache.entries()}
    assert "key" + "0" * 61 in kept and len(kept) == 2


def test_gc_validates_keep(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    with pytest.raises(ValueError):
        cache.gc(keep=0)
    with pytest.raises(ValueError):
        ExecutableCache(str(tmp_path / "aot2"), keep=0)


# ------------------------------------------------------------ fault points

def test_commit_crash_leaves_no_entry(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    with FaultPlan().arm("aot.commit", exc=InjectedCrash):
        with pytest.raises(InjectedCrash):
            _warm(_model(), cache)
    assert cache.entries() == []
    _, info = _warm(_model(), cache)
    assert info["committed"]


def test_commit_fault_degrades_to_uncached_program(tmp_path):
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "aot"), registry=reg)
    with FaultPlan().arm("aot.commit"):
        prog, info = _warm(_model(), cache, reg=reg)
    assert not info["committed"] and cache.entries() == []
    assert reg.snapshot().get("aot_fallback_total") == 1
    assert torch.isfinite(prog(_x())).all()


def test_load_fault_degrades_to_rebuild(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    _, info = _warm(_model(), cache)
    assert info["committed"]
    with FaultPlan().arm("aot.load"):
        prog, info2 = _warm(_model(), cache)
    assert not info2["hit"]
    assert torch.isfinite(prog(_x())).all()


# ------------------------------------------------------------ warm dispatch

def test_warm_hit_is_bit_identical_to_compiled(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    prog_a, info_a = _warm(_model(), cache)
    prog_b, info_b = _warm(_model(), cache)
    assert not info_a["hit"] and info_b["hit"]
    x = _x()
    assert torch.equal(prog_a(x), prog_b(x))
    with torch.inference_mode():
        assert torch.equal(prog_a(x), _model()(x))


def test_warm_callable_dispatch_and_fallthrough(tmp_path):
    """One program per input signature; a signature whose export fails
    runs the model itself, counted as a fallback."""
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "aot"), registry=reg)
    model = _model()
    wc = WarmCallable(model, cache, what="serve", config="cfg", registry=reg)
    y = wc(_x(8))
    assert wc.last_info["committed"]
    wc(_x(4))
    assert len(wc._programs) == 2
    with torch.inference_mode():
        assert torch.equal(y, model(_x(8)))
    bad = WarmCallable(_model(), cache, what="serve", config="cfg2",
                       registry=reg)
    bad._compile = lambda spec: (_ for _ in ()).throw(RuntimeError("x"))
    assert torch.isfinite(bad(_x(2))).all()
    assert reg.snapshot().get("aot_fallback_total") == 1


def test_maybe_warm_is_passthrough_when_disabled():
    model = _model()
    assert maybe_warm(model, what="x") is model


def test_engine_buckets_hit_across_rebuilds(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    model = _model()
    eng1 = InferenceEngine.from_model(model, fold=False, max_batch=4,
                                      warmup=False, device="cpu",
                                      aot_cache=cache)
    assert all(s["aot_hit"] is False for s in eng1.compile_stats.values())
    eng2 = InferenceEngine.from_model(model, fold=False, max_batch=4,
                                      warmup=False, device="cpu",
                                      aot_cache=cache)
    assert all(s["aot_hit"] for s in eng2.compile_stats.values())
    x = _x(3)
    assert torch.equal(eng1.infer(x), eng2.infer(x))
    eng3 = InferenceEngine.from_model(_model(9), fold=False, max_batch=4,
                                      warmup=False, device="cpu",
                                      aot_cache=cache)
    assert not any(s["aot_hit"] for s in eng3.compile_stats.values())
    # the transform is key material too: int8 of the same weights misses
    eng4 = InferenceEngine.from_model(model, int8_calib=_x(8, 1),
                                      max_batch=4, warmup=False,
                                      device="cpu", aot_cache=cache)
    assert not eng4.aot_info["program"]["hit"] and eng4.batch_invariant


def test_engine_refuses_cache_without_weights_digest(tmp_path):
    cache = ExecutableCache(str(tmp_path / "aot"))
    model = _model()
    with pytest.warns(UserWarning, match="aot_config"):
        eng = InferenceEngine(model, model.input_shape, max_batch=2,
                              warmup=False, device="cpu", aot_cache=cache)
    assert eng.aot is None
    assert not any("aot_hit" in s for s in eng.compile_stats.values())
    assert cache.entries() == []


def test_engine_default_is_uncached():
    eng = InferenceEngine.from_model(_model(), fold=False, max_batch=2,
                                     warmup=False, device="cpu")
    assert eng.aot is None and eng.aot_info == {}
    assert not any("aot_hit" in s for s in eng.compile_stats.values())


# -------------------------------------------------------- kernel libraries

def _fake_toolchain(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (writes bytes naming its source to ``-o``) and
    loader (``ctypes.CDLL`` recording what it opened), the host having no
    CUDA; returns the list of opened paths."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv\n"
        "open(a[a.index('-o') + 1], 'wb').write(b'lib:' + "
        "a[-1].encode())\n")
    nvcc.chmod(0o755)
    opened = []

    class Lib:
        def __init__(self, path):
            opened.append(path)

    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels.ctypes, "CDLL", Lib)
    monkeypatch.setattr(_kernels, "_bind", lambda lib: None)
    monkeypatch.setattr(_kernels, "_libs", {})
    return opened


def test_kernel_build_commits_and_a_warm_build_needs_no_compiler(
        tmp_path, monkeypatch):
    """A cold build runs the compiler once a source and commits each
    library; a build in an empty directory then restores every library
    from the cache with ``nvcc`` unreachable (``_nvcc`` raising, no
    ``CUDA_HOME``), the bytes the cold build made; hits are counted."""
    opened = _fake_toolchain(tmp_path, monkeypatch)
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "root" / "aot"), registry=reg)
    monkeypatch.setenv("DCNN_COMPILE_CACHE", str(tmp_path / "cold"))
    _kernels.build(cache=cache)
    cold = {n: _kernels._lib_path(n).read_bytes() for n in _kernels.SOURCES}
    assert all(b.startswith(b"lib:") for b in cold.values())
    assert reg.snapshot().get("aot_commits_total") == len(_kernels.SOURCES)
    assert len(opened) == len(_kernels.SOURCES)

    def unreachable():
        raise AssertionError("the warm build asked for nvcc")

    monkeypatch.setattr(_kernels, "_nvcc", unreachable)
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setenv("DCNN_COMPILE_CACHE", str(tmp_path / "warm"))
    _kernels.build(cache=cache)
    warm = {n: _kernels._lib_path(n).read_bytes() for n in _kernels.SOURCES}
    assert warm == cold
    assert str(tmp_path / "warm") in opened[-1]
    assert reg.snapshot().get("aot_hits_total") == len(_kernels.SOURCES)
    # a library already in the directory is loaded as it is, and a cache
    # that holds it is not written again
    monkeypatch.setattr(_kernels, "_libs", {})
    _kernels.build(cache=cache)
    assert reg.snapshot().get("aot_commits_total") == len(_kernels.SOURCES)


def test_kernel_build_with_a_cache_that_fails_still_builds(tmp_path,
                                                           monkeypatch):
    """A load fault or a commit fault degrades to the plain build: every
    library is compiled and loaded, the commit fault counted."""
    opened = _fake_toolchain(tmp_path, monkeypatch)
    reg = MetricsRegistry()
    cache = ExecutableCache(str(tmp_path / "root" / "aot"), registry=reg)
    monkeypatch.setenv("DCNN_COMPILE_CACHE", str(tmp_path / "b"))
    with FaultPlan().arm("aot.load").arm("aot.commit"):
        _kernels.build(cache=cache)
    assert len(opened) == len(_kernels.SOURCES)
    assert cache.entries() == []
    assert reg.snapshot().get("aot_fallback_total") == len(_kernels.SOURCES)


# ------------------------------------------------------------------ CLI

def test_cli_list_gc_json(tmp_path, capsys):
    from dcnn_tpu_torch.aot.__main__ import main

    root = str(tmp_path)
    _warm(_model(), ExecutableCache(os.path.join(root, "aot")))
    assert main(["--dir", root, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report["entries"]) == 1
    row = report["entries"][0]
    assert row["what"] == "serve" and row["size"] > 0
    assert row["avals"].startswith("f32[")
    assert main(["--dir", root]) == 0
    assert "serve" in capsys.readouterr().out
    assert main(["--dir", root, "--gc", "--keep", "1", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["removed"] == 0
    assert main(["--dir", root, "--prewarm", "no-such-model"]) == 1
    assert "prewarm failed" in capsys.readouterr().err


def test_cli_prewarm_zoo_model(tmp_path, capsys, monkeypatch):
    """``--prewarm`` builds the kernel libraries into the cache (stubbed:
    no compiler here) and commits a zoo model's serving program; a second
    prewarm finds the program cached."""
    from dcnn_tpu_torch.aot.__main__ import main

    built = []
    monkeypatch.setattr(_kernels, "build",
                        lambda cache=None, **kw: built.append(cache))
    root = str(tmp_path)
    args = ["--dir", root, "--prewarm", "mnist_cnn", "--max-batch", "2",
            "--device", "cpu", "--json"]
    assert main(args) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["prewarm"]["buckets"] == [1, 2]
    assert report["prewarm"]["program"]["committed"]
    assert len(built) == 1 and built[0].root == os.path.join(root, "aot")
    assert main(args) == 0
    assert json.loads(capsys.readouterr().out)["prewarm"]["program"]["hit"]


# -------------------------------------------- the acceptance round trip

_SUBPROC = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    from dcnn_tpu_torch.aot import ExecutableCache
    from dcnn_tpu_torch.nn import SequentialBuilder
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.serve.engine import InferenceEngine

    cache_dir, out_path, warm = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    if warm:  # a warm start exports and traces nothing
        def refuse(*a, **k):
            raise AssertionError("the warm start traced")
        torch.export.export = refuse
    reg = MetricsRegistry()
    cache = ExecutableCache(cache_dir, registry=reg)
    model = (SequentialBuilder("aot_rt", "NHWC").input((8, 8, 3))
             .conv2d(4, 3, padding=1).batchnorm().activation("relu")
             .flatten().dense(5).build()).init(
        generator=torch.Generator().manual_seed(0), device="cpu")
    calib = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16, 8, 8, 3)).astype(np.float32))
    eng = InferenceEngine.from_model(model, int8_calib=calib, max_batch=4,
                                     device="cpu", aot_cache=cache,
                                     registry=reg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 8, 8, 3)).astype(np.float32))
    snap = reg.snapshot()
    json.dump({{
        "hit": eng.aot_info["program"]["hit"],
        "key": eng.aot_info["program"]["key"],
        "compile_total": int(snap.get("compile_total", 0)),
        "aot_hits_total": int(snap.get("aot_hits_total", 0)),
        "logits": eng.infer(x).numpy().tolist(),
    }}, open(out_path, "w"))
""")


def test_subprocess_round_trip_bit_identical_no_recompile(tmp_path):
    """Process A exports the int8 program and commits it; a fresh process
    B loads it with no export (``torch.export.export`` refused there) and
    no compile event, under the same key, and serves bit-identical
    logits."""
    cache_dir = str(tmp_path / "aot")
    script = _SUBPROC.format(repo=REPO)
    # DCNN_PRECISION too: importing bench.py (another test file, in the
    # same worker) sets it to bf16 for the processes started after it
    env = {k: v for k, v in os.environ.items()
           if k not in ("AOT_CACHE", "DCNN_COMPILE_CACHE", "PYTHONPATH",
                        "DCNN_PRECISION")}

    def run(tag, warm):
        out = str(tmp_path / f"{tag}.json")
        r = subprocess.run([sys.executable, "-c", script, cache_dir, out,
                            "1" if warm else "0"], capture_output=True,
                           text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        with open(out) as f:
            return json.load(f)

    a = run("a", False)
    b = run("b", True)
    assert not a["hit"] and b["hit"] and a["key"] == b["key"]
    assert a["compile_total"] > 0 and b["compile_total"] == 0
    assert b["aot_hits_total"] == 1
    np.testing.assert_array_equal(np.asarray(a["logits"]),
                                  np.asarray(b["logits"]))
