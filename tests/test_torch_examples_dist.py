"""The port's pipeline, resilience and tracing drivers
(``dcnn_tpu_torch.examples``) on the CPU, and what holds for every driver.

Every ``examples/*.py`` and ``*.sh`` of the JAX package has a counterpart
under ``dcnn_tpu_torch/examples/``; each counterpart imports in a fresh
interpreter with JAX, flax and ``dcnn_tpu`` blocked; each exits non-zero
where CUDA is asked for (``DEVICE_TYPE`` unset) and no card is visible.
The pipeline drivers run on the CPU in subprocesses, the TCP one through
``launch_pipeline.sh`` with its stage-worker processes, each with a
timeout of its own.
"""

import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_EXAMPLES = REPO / "dcnn_tpu_torch" / "examples"
JAX_EXAMPLES = REPO / "examples"
SMOKE_TIMEOUT_S = 300
FORBIDDEN = ("jax", "jaxlib", "flax", "dcnn_tpu")

DRIVERS = sorted(p.stem for p in JAX_EXAMPLES.glob("*.py")
                 if p.stem != "common")


def _env(tmp, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "DCNN_PRECISION", "DEVICE_TYPE")}
    # two threads a driver: the suite runs beside it on every core
    e.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
             SNAPSHOT_DIR=str(tmp / "snap"),
             TMPDIR=str(tmp), **env)
    return e


def run_driver(name, *args, tmp, timeout=SMOKE_TIMEOUT_S, **env):
    proc = subprocess.run(
        [sys.executable, "-m", f"dcnn_tpu_torch.examples.{name}", *args],
        cwd=REPO, env=_env(tmp, DEVICE_TYPE="cpu", **env),
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    return proc.stdout


def test_every_jax_example_has_a_counterpart():
    jax_side = {p.name for p in JAX_EXAMPLES.iterdir()
                if p.suffix in (".py", ".sh")}
    port_side = {p.name for p in PORT_EXAMPLES.iterdir()
                 if p.suffix in (".py", ".sh")}
    assert len(jax_side) == 23
    assert jax_side <= port_side, sorted(jax_side - port_side)
    assert port_side - jax_side == {"__init__.py"}


BLOCKER = (
    "import importlib.abc, sys\n"
    "class _Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
    "            raise ImportError(f'blocked: {name}')\n"
    "        return None\n"
    "sys.meta_path.insert(0, _Block())\n")


@pytest.fixture(scope="module")
def isolated_imports(tmp_path_factory):
    """Each driver imported in turn in one fresh interpreter with the JAX
    modules blocked; {driver: the forbidden modules loaded after it}."""
    code = BLOCKER + (
        "import importlib, json\n"
        f"out = {{}}\n"
        f"for name in {DRIVERS!r}:\n"
        "    importlib.import_module('dcnn_tpu_torch.examples.' + name)\n"
        "    out[name] = sorted(n for n in sys.modules\n"
        f"                       if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(out))\n")
    tmp = tmp_path_factory.mktemp("iso")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp,
                          env=_env(tmp), capture_output=True, text=True,
                          timeout=SMOKE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_imports_no_jax(isolated_imports, name):
    assert isolated_imports[name] == []


@pytest.fixture(scope="module")
def no_card_runs(tmp_path_factory):
    """Every driver and the launcher started at once with ``DEVICE_TYPE``
    unset on a machine without a card; {name: (return code, output)}."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    tmp = tmp_path_factory.mktemp("nocard")
    cmds = {name: [sys.executable, "-m", f"dcnn_tpu_torch.examples.{name}"]
            for name in DRIVERS}
    cmds["launch_pipeline.sh"] = ["bash",
                                  str(PORT_EXAMPLES / "launch_pipeline.sh"),
                                  "2"]
    procs = {name: subprocess.Popen(cmd, cwd=REPO, env=_env(tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=SMOKE_TIMEOUT_S)
            out[name] = (proc.returncode, text)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", DRIVERS + ["launch_pipeline.sh"])
def test_no_card_no_run(no_card_runs, name):
    rc, text = no_card_runs[name]
    assert rc != 0
    assert "torch.cuda.is_available() is False" in text


def _free_base_port(n):
    """A port p with p..p+n-1 free on localhost."""
    rng = random.Random(os.getpid())
    for _ in range(100):
        base = rng.randrange(20000, 40000)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


@pytest.mark.parametrize("schedule", ["sync", "semi_async"])
def test_pipeline_trainer(tmp_path, schedule):
    out = run_driver("pipeline_trainer", tmp=tmp_path, EPOCHS="1",
                     MODEL="cifar10_cnn_v1", SCHEDULE=schedule,
                     NUM_STAGES="2")
    assert "partitions: [(0, 4), (4, 9)]" in out
    assert "epoch 1: loss" in out and "stage 1: fwd" in out


def test_launch_pipeline_over_tcp(tmp_path):
    env = _env(tmp_path, DEVICE_TYPE="cpu", EPOCHS="1",
               BASE_PORT=str(_free_base_port(2)), PYTHON=sys.executable)
    proc = subprocess.run(
        ["bash", str(PORT_EXAMPLES / "launch_pipeline.sh"), "2", "sync"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=SMOKE_TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    assert "deployed 2 stages" in proc.stdout
    assert "epoch 1: loss" in proc.stdout
    assert proc.stdout.count("[worker] shutdown") == 2


def test_distributed_trainer_needs_workers(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "dcnn_tpu_torch.examples.distributed_trainer"],
        cwd=REPO, env=_env(tmp_path, DEVICE_TYPE="cpu", WORKERS=""),
        capture_output=True, text=True, timeout=SMOKE_TIMEOUT_S)
    assert proc.returncode != 0 and "WORKERS=" in proc.stderr


def test_resume_training(tmp_path):
    out = run_driver("resume_training", tmp=tmp_path,
                     CKPT_DIR=str(tmp_path / "ckpt"))
    assert "killed as planned" in out
    assert "OK: bit-exact resume after mid-epoch kill" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["crash", "ref"]


def test_trace_training(tmp_path):
    snap = REPO / "model_snapshots" / "mnist_cnn_model" / "arrays.msgpack"
    before = snap.read_bytes()
    out = run_driver("trace_training", str(tmp_path / "trace.json"),
                     tmp=tmp_path, TRACE_EPOCHS="1")
    assert "'train.epoch': 1" in out and (tmp_path / "trace.json").exists()
    # it trains mnist_cnn_model from the repo's root: the committed
    # snapshot of that name stays as it is
    assert snap.read_bytes() == before


def test_validate_chrome_trace_refuses_a_bad_file(tmp_path):
    from dcnn_tpu_torch.examples.trace_training import validate_chrome_trace

    p = tmp_path / "t.json"
    p.write_text('{"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, '
                 '"name": "a", "ts": 0, "dur": 1}]}')
    with pytest.raises(ValueError, match="no labeled train track"):
        validate_chrome_trace(str(p))
    p.write_text('{"traceEvents": []}')
    with pytest.raises(ValueError, match="empty"):
        validate_chrome_trace(str(p))
