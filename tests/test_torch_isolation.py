"""The port stands alone: ``dcnn_tpu_torch`` (and ``chip_smoke.py``, which
drives it on the GPU) import neither JAX nor anything of ``dcnn_tpu``, nor
``msgpack`` (the port's own codec writes and reads the checkpoint format,
so the port needs no msgpack installed), on the attention serving and
training paths, on the CNN serving path with the conv kernels' plain
versions, on the checkpoint path (save, async save, restore, resume,
serving a snapshot), and on the data feed (the native helpers, which build
and load the port's own library and never one under ``dcnn_tpu/native/``,
the resident dataset, ``PrefetchLoader`` with its spawned feed workers,
the transfer engine and the streaming feed), on int8 serving (quantization
of a CNN and of ``mha_classifier``, the int8 conv's plain version, a
quantized checkpoint), on continuous-batching decode of
``mha_decoder``, on the observability core: each of its modules
imported alone, and the tracer, the telemetry server scraped over HTTP,
the layer profiler, debug mode and ``hard_fence`` driven together, and on
the export and the AOT cache: the ``dcnn::`` ops, ``nn/export.py``,
``aot/*`` and ``utils/compile_cache.py`` each read alone, an engine over a
cached program, the CLI, and an artifact served by a process that builds
no model, and on pipeline parallelism: each ``parallel/`` module read and
imported alone, and the host-driven coordinator and both compiled
schedules driven on the CPU, and on the TCP pipeline: the wire codecs,
hardware info, framed channels, the coordinator and the stage worker, each
read and imported alone, a two-worker run on the CPU and the worker's
``python -m`` entry point, with ``ml_dtypes`` forbidden too, and on the
router tier: ``serve/replica.py``, ``serve/swap.py`` and
``serve/router.py`` each read and imported alone, and a router over a
local and a TCP replica hot-swapping a checkpointed model on the CPU, and
on data parallelism: ``core/mesh.py``, ``parallel/multihost.py``,
``parallel/data_parallel.py`` and ``parallel/elastic.py`` each read and
imported alone, a mesh step over a world of one, an elastic fleet of two
thread peers and an elastic ``Trainer.fit`` on the CPU, and on spatial
sharding and the trainer's telemetry plane: ``ops/spatial.py`` and
``obs/goodput.py``, ``obs/anomaly.py`` and ``obs/rules.py`` each read and
imported alone, a spatial mesh step and a fit serving ``/goodput``, and
on the fleet plane and autoscaling: ``obs/trace.py``, ``obs/fleet.py``,
``serve/autoscale.py``, ``parallel/autoscale.py`` and ``serve/soak.py``
each read and imported alone, then the soak, the aggregator over HTTP and
in-process targets, the trace CLI and a leased training segment driven on
the CPU with JAX, flax and the JAX package blocked at import, and on the
static-analysis suite: each module of ``dcnn_tpu_torch/analysis/`` read
alone (it keeps its own copy of ``dcnn_tpu.analysis``, which is plain
``ast``) and imported one by one, an analysis and the CLI's
``--write-baseline`` run with the same blocks, and on the bench
regression gate: ``obs/regress.py`` (standard library only, no torch)
loaded from its file alone and its self-test and command line run with
torch blocked too."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dcnn_tpu", "msgpack")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN  # "dcnn_tpu_torch" is its own top-level name


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_import_no_jax_or_reference():
    files = sorted((REPO / "dcnn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for line, mod in _imports(f) if _forbidden(mod)]
    assert not bad, bad


SERVE = (
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.serve import InferenceEngine\n"
    "m = create_model('mha_classifier').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "e = InferenceEngine.from_model(m, max_batch=2, device='cpu')\n"
    "assert e.infer(torch.zeros(32, 64)).shape == (10,)\n")
TRAIN = (
    "import numpy as np\n"
    "import dcnn_tpu_torch.data, dcnn_tpu_torch.optim, dcnn_tpu_torch.train\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.ops.losses import get_loss\n"
    "m = create_model('mha_classifier').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "opt = dcnn_tpu_torch.optim.Adam(1e-3)\n"
    "ts = dcnn_tpu_torch.train.create_train_state(m, opt)\n"
    "step = dcnn_tpu_torch.train.make_train_step("
    "m, get_loss('softmax_crossentropy'), opt)\n"
    "x, y = next(iter(dcnn_tpu_torch.data.ArrayDataLoader("
    "np.zeros((4, 32, 64), np.float32), np.eye(10, dtype=np.float32)[:4],"
    " batch_size=4)))\n"
    "loss, _ = step(ts, torch.from_numpy(x), torch.from_numpy(y), 1e-3)\n"
    "assert ts.step == 1 and bool(torch.isfinite(loss))\n")
CNN = (
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.ops.pallas import (conv3x3_s1, conv3x3_s1_pairs,\n"
    "    conv3x3_s1_bnrelu_in, fused_scale_bias_relu)\n"
    "from dcnn_tpu_torch.serve import InferenceEngine\n"
    "m = create_model('resnet18_tiny_imagenet', 'NHWC').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "e = InferenceEngine.from_model(m, fold=True, max_batch=1, device='cpu')\n"
    "assert e.infer(torch.zeros(64, 64, 3)).shape == (200,)\n"
    "x, w, s = torch.ones(1, 4, 4, 2), torch.ones(3, 3, 2, 2), torch.ones(2)\n"
    "for y in (conv3x3_s1(x, w), conv3x3_s1_pairs(x, w),\n"
    "          conv3x3_s1_bnrelu_in(x, w, s, s),\n"
    "          fused_scale_bias_relu(x, s, s)):\n"
    "    assert bool(torch.isfinite(y).all())\n")


CHECKPOINT = (
    "import tempfile, numpy as np\n"
    "from dcnn_tpu_torch.core import TrainingConfig\n"
    "from dcnn_tpu_torch.data import ArrayDataLoader\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.optim import Adam\n"
    "from dcnn_tpu_torch.serve import InferenceEngine\n"
    "from dcnn_tpu_torch.train import Trainer, create_train_state\n"
    "d = tempfile.mkdtemp()\n"
    "ld = ArrayDataLoader(np.zeros((8, 32, 64), np.float32),"
    " np.eye(10, dtype=np.float32)[np.arange(8) % 10], batch_size=4)\n"
    "for resume in ('never', 'auto'):\n"
    "    m = create_model('mha_classifier').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "    opt = Adam(1e-3)\n"
    "    tr = Trainer(m, opt, 'softmax_crossentropy', TrainingConfig("
    "device_type='cpu', epochs=2, progress_interval=0, snapshot_dir=d,"
    " checkpoint_dir=d + '/ck', checkpoint_every=1, resume=resume,"
    " nonfinite_policy='skip_step'))\n"
    "    ts = tr.fit(create_train_state(m, opt), ld, ld)\n"
    "assert ts.step == 4 and len(tr.history) == 2\n"
    "e = InferenceEngine.from_checkpoint(d + '/' + m.name, max_batch=2,"
    " device='cpu')\n"
    "assert e.infer(torch.zeros(32, 64)).shape == (10,)\n")


FEED = (
    "import numpy as np\n"
    "from dcnn_tpu_torch import native\n"
    "from dcnn_tpu_torch.core import TrainingConfig\n"
    "from dcnn_tpu_torch.data import (ArrayDataLoader, DeviceAugmentBuilder,"
    " DeviceDataset, PrefetchLoader, RegressionDataLoader,"
    " StreamingDeviceDataset, make_shard_step, train_streaming_epoch)\n"
    "from dcnn_tpu_torch.nn import SequentialBuilder\n"
    "from dcnn_tpu_torch.ops.losses import get_loss\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.train import Trainer, create_train_state\n"
    "assert native.available()\n"
    "a = np.arange(24, dtype=np.uint8).reshape(6, 4)\n"
    "assert (native.gather_rows(a, [5, 0]) == a[[5, 0]]).all()\n"
    "assert native.lz4_decompress(native.lz4_compress(b'ab' * 50), 100)"
    " == b'ab' * 50\n"
    "maps = open('/proc/self/maps').read()\n"
    "assert 'dcnn_tpu/native/' not in maps, 'the JAX package library loaded'\n"
    "assert str(native.lib_path()) in maps\n"
    "rng = np.random.default_rng(0)\n"
    "x = rng.integers(0, 256, (64, 6, 6, 1), dtype=np.uint8)\n"
    "y = rng.integers(0, 3, 64)\n"
    "m = (SequentialBuilder('f', data_format='NHWC').input((6, 6, 1))"
    ".flatten().dense(3).build()).init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "opt = SGD(0.1)\n"
    "tr = Trainer(m, opt, 'softmax_crossentropy', TrainingConfig("
    "device_type='cpu', progress_interval=0, snapshot_dir=None,"
    " steps_per_dispatch=2))\n"
    "aug = DeviceAugmentBuilder('NHWC').horizontal_flip().rotation().build()\n"
    "ds = DeviceDataset(x, y, 3, batch_size=8, augment=aug, device='cpu')\n"
    "ts = tr.fit(create_train_state(m, opt), ds, ds, epochs=1)\n"
    "ld = ArrayDataLoader(x, np.eye(3, dtype=np.float32)[y], batch_size=8)\n"
    "with PrefetchLoader(ld, stage_batches=2, feed_workers=2,"
    " device='cpu') as pf:\n"
    "    ts = tr.fit(ts, pf, epochs=1)\n"
    "sd = StreamingDeviceDataset(x, y, 3, batch_size=8, shard_batches=2)\n"
    "step = make_shard_step(m, get_loss('softmax_crossentropy'), opt,"
    " num_classes=3, batch_size=8, shard_batches=2)\n"
    "ts, loss = train_streaming_epoch(step, ts, sd, 0, 0.1)\n"
    "assert np.isfinite(loss) and ts.step == 24\n"
    "RegressionDataLoader(x.reshape(64, -1).astype(np.float32),"
    " y.astype(np.float32)).load_data()\n")


INT8_DECODE = (
    "import tempfile, numpy as np\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.nn import quantize_model\n"
    "from dcnn_tpu_torch.ops.conv import conv2d_int8\n"
    "from dcnn_tpu_torch.serve import (ContinuousBatcher, DecodeEngine,"
    " DynamicBatcher, InferenceEngine, decode_reference)\n"
    "from dcnn_tpu_torch.serve.traffic import open_loop\n"
    "from dcnn_tpu_torch.train import load_checkpoint, save_checkpoint\n"
    "g = torch.Generator().manual_seed(0)\n"
    "m = create_model('mnist_cnn', 'NHWC').init(generator=g, device='cpu')\n"
    "calib = np.random.default_rng(0).normal(size=(4, 28, 28, 1))"
    ".astype(np.float32)\n"
    "e = InferenceEngine.from_model(m, int8_calib=calib, max_batch=2,"
    " device='cpu')\n"
    "assert e.batch_invariant and e.infer(calib[0]).shape == (10,)\n"
    "b = DynamicBatcher(e, max_wait_ms=0.0)\n"
    "futs = open_loop(b, list(calib), 200.0, 0.02)\n"
    "b.drain(timeout=60)\n"
    "assert futs and all(f.result(0).shape == (10,) for _, f in futs)\n"
    "d = tempfile.mkdtemp()\n"
    "save_checkpoint(d, quantize_model(m, calib))\n"
    "assert load_checkpoint(d, device='cpu')[0].layers[0].w_q.dtype"
    " == torch.int8\n"
    "a = create_model('mha_classifier').init(generator=g, device='cpu')\n"
    "qa = quantize_model(a, np.zeros((2, 32, 64), np.float32))\n"
    "assert qa(torch.zeros(1, 32, 64)).shape == (1, 10)\n"
    "x = torch.ones(1, 3, 5, 5, dtype=torch.int8)\n"
    "assert conv2d_int8(x, x[:, :, :3, :3], padding=1).dtype"
    " == torch.int32\n"
    "dec = create_model('mha_decoder').init(generator=g, device='cpu')\n"
    "eng = DecodeEngine(dec, max_slots=2, page_size=8, max_pages_per_seq=2)\n"
    "cb = ContinuousBatcher(eng)\n"
    "f = cb.submit([1, 2, 3], max_new_tokens=4)\n"
    "cb.drain(timeout=60)\n"
    "assert (f.result(0) == decode_reference(eng, [1, 2, 3],"
    " max_new_tokens=4)).all()\n")


# a meta-path finder that refuses the forbidden names outright, so an
# import of one fails where it is made instead of loading quietly
BLOCKER = (
    "import importlib.abc, sys\n"
    "class _Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
    "            raise ImportError(f'blocked: {name}')\n"
    "        return None\n"
    "sys.meta_path.insert(0, _Block())\n")


def _run_isolated(body: str, blocked: bool = False) -> None:
    """Run ``body`` in a fresh interpreter after ``import dcnn_tpu_torch``
    and check that no module of JAX, flax, msgpack or the JAX package was
    loaded; with ``blocked``, importing one raises from the start."""
    code = (
        (BLOCKER if blocked else "") +
        "import sys, torch\n"
        "import dcnn_tpu_torch\n"
        + body +
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


def test_import_and_cpu_forward_leave_jax_out():
    _run_isolated(SERVE)


def test_import_and_cpu_train_step_leave_jax_out():
    _run_isolated(TRAIN)


def test_import_and_cpu_cnn_serving_and_conv_kernels_leave_jax_out():
    _run_isolated(CNN)


def test_checkpoint_path_leaves_jax_and_msgpack_out():
    _run_isolated(CHECKPOINT)


def test_data_feed_and_native_helpers_leave_jax_out():
    _run_isolated(FEED)


def test_int8_serving_and_decode_leave_jax_out():
    _run_isolated(INT8_DECODE)


# the observability core and its neighbours, each its own module
OBS_MODULES = (
    "dcnn_tpu_torch.utils.env", "dcnn_tpu_torch.obs.exposition",
    "dcnn_tpu_torch.obs.tracer", "dcnn_tpu_torch.obs.xla",
    "dcnn_tpu_torch.obs.flight", "dcnn_tpu_torch.obs.tsdb",
    "dcnn_tpu_torch.obs.server", "dcnn_tpu_torch.resilience.retry",
    "dcnn_tpu_torch.resilience.slowness", "dcnn_tpu_torch.core.fence",
    "dcnn_tpu_torch.core.debug", "dcnn_tpu_torch.train.profiling",
)
OBS = (
    "import numpy as np\n"
    "from dcnn_tpu_torch.core.debug import debug_mode\n"
    "from dcnn_tpu_torch.core.fence import hard_fence\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.obs import configure, get_tracer\n"
    "from dcnn_tpu_torch.obs.exposition import parse_prometheus_text\n"
    "from dcnn_tpu_torch.obs.tsdb import TimeSeriesStore, TsdbSampler\n"
    "from dcnn_tpu_torch.obs.xla import sample_hbm\n"
    "from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine\n"
    "from dcnn_tpu_torch.train.profiling import LayerProfiler\n"
    "import urllib.request\n"
    "configure(enabled=True)\n"
    "m = create_model('mha_classifier').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "e = InferenceEngine.from_model(m, max_batch=2, device='cpu')\n"
    "b = DynamicBatcher(e, start=False)\n"
    "srv = b.start_telemetry(port=0)\n"
    "f = b.submit(np.zeros((32, 64), np.float32))\n"
    "b.step()\n"
    "text = urllib.request.urlopen(srv.url + '/metrics').read().decode()\n"
    "assert parse_prometheus_text(text)['serve_samples_completed_total']"
    "['value'] == 1\n"
    "b.shutdown()\n"
    "assert get_tracer().span_counts()['serve.infer'] == 1\n"
    "p = LayerProfiler()\n"
    "p.profile_forward(m, torch.zeros(2, 32, 64))\n"
    "assert len(p.forward_us) == len(m.layers)\n"
    "with debug_mode():\n"
    "    hard_fence({'a': torch.ones(2)})\n"
    "assert sample_hbm() is None\n")


@pytest.mark.parametrize("module", OBS_MODULES)
def test_obs_core_module_imports_no_jax(module):
    """The source of each module of the observability core imports no
    JAX, flax, msgpack or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


def test_obs_core_modules_leave_jax_out_one_by_one():
    """The modules of the observability core imported one after another in
    a fresh interpreter: after each, no JAX, flax, msgpack or JAX-package
    module is loaded."""
    _run_isolated(
        "import importlib\n"
        f"for name in {OBS_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "    assert not bad, (name, bad)\n")


def test_obs_core_path_leaves_jax_out():
    _run_isolated(OBS)


# the served program as an artifact and the AOT cache
EXPORT_MODULES = (
    "dcnn_tpu_torch.ops.library", "dcnn_tpu_torch.nn.export",
    "dcnn_tpu_torch.aot", "dcnn_tpu_torch.aot.keys",
    "dcnn_tpu_torch.aot.cache", "dcnn_tpu_torch.aot.warm",
    "dcnn_tpu_torch.aot.__main__", "dcnn_tpu_torch.utils.compile_cache",
)


@pytest.mark.parametrize("module", EXPORT_MODULES)
def test_export_and_aot_module_imports_no_jax(module):
    """The source of each module of the export and the AOT cache imports
    no JAX, flax, msgpack or JAX-package module."""
    name = module.replace(".", "/")
    path = REPO / (name + "/__init__.py" if module == "dcnn_tpu_torch.aot"
                   else name + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


EXPORT = (
    "import tempfile\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.nn import export_inference, quantize_model\n"
    "from dcnn_tpu_torch.aot.__main__ import main\n"
    "d = tempfile.mkdtemp()\n"
    "m = create_model('mha_classifier').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "x = torch.zeros(2, 32, 64)\n"
    "q = quantize_model(m, torch.randn(4, 32, 64))\n"
    "open(d + '/m.pt2', 'wb').write(export_inference(q, device='cpu'))\n"
    "from dcnn_tpu_torch.serve import InferenceEngine\n"
    "e = InferenceEngine.from_model(m, max_batch=2, device='cpu',"
    " aot_cache=d)\n"
    "assert e.aot_info['program']['committed']\n"
    "assert main(['--dir', d, '--json']) == 0\n")
# a fresh process that only loads the artifact: no model is built, no
# checkpoint read, no layer class named
SERVE_ARTIFACT = (
    "import sys\n"
    "from dcnn_tpu_torch.serve import InferenceEngine\n"
    "from dcnn_tpu_torch.nn import sequential\n"
    "def refuse(*a, **k):\n"
    "    raise AssertionError('a model was built')\n"
    "sequential.Sequential.__init__ = refuse\n"
    "e = InferenceEngine.from_artifact(sys.argv[1], max_batch=2,"
    " device='cpu')\n"
    "assert e.batch_invariant and e.infer(torch.zeros(32, 64)).shape == (10,)\n")


def test_export_and_aot_cache_leave_jax_out():
    _run_isolated(EXPORT)


def test_artifact_serves_in_a_process_that_builds_no_model(tmp_path):
    """An int8 ``mha_classifier`` exported here is served by a fresh
    interpreter through ``from_artifact`` with ``Sequential`` unusable:
    loading builds no model and imports no JAX."""
    import torch

    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.nn import export_inference, quantize_model

    m = create_model("mha_classifier").init(
        generator=torch.Generator().manual_seed(0), device="cpu")
    path = tmp_path / "m.pt2"
    path.write_bytes(export_inference(
        quantize_model(m, torch.randn(4, 32, 64)), device="cpu"))
    code = ("import sys, torch\nimport dcnn_tpu_torch\n" + SERVE_ARTIFACT
            + "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\nassert not bad, bad\nprint('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


# pipeline parallelism: model splitting, the in-process coordinator and the
# compiled schedules
PIPELINE_MODULES = (
    "dcnn_tpu_torch.parallel", "dcnn_tpu_torch.parallel.partitioner",
    "dcnn_tpu_torch.parallel.pipeline",
    "dcnn_tpu_torch.parallel.compiled_pipeline",
)


@pytest.mark.parametrize("module", PIPELINE_MODULES)
def test_pipeline_module_imports_no_jax(module):
    """The source of each pipeline module imports no JAX, flax, msgpack or
    JAX-package module."""
    name = module.replace(".", "/")
    path = REPO / (name + "/__init__.py" if module == "dcnn_tpu_torch.parallel"
                   else name + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


PIPELINE = (
    "import importlib\n"
    f"for name in {PIPELINE_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.ops.losses import get_loss\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.parallel import (FlopBalancedPartitioner,\n"
    "    HeteroCompiledPipeline, InProcessPipelineCoordinator)\n"
    "from dcnn_tpu_torch.parallel.pipeline import train_pipeline_epoch\n"
    "g = torch.Generator().manual_seed(0)\n"
    "m = create_model('mnist_cnn').init(generator=g, device='cpu')\n"
    "x, y = torch.randn(8, 1, 28, 28), torch.eye(10)[torch.arange(8)]\n"
    "c = InProcessPipelineCoordinator(m, SGD(0.01), 'softmax_crossentropy',\n"
    "    2, FlopBalancedPartitioner(), devices=['cpu', 'cpu'],\n"
    "    num_microbatches=2)\n"
    "c.deploy_stages()\n"
    "for s in ('sync', 'semi_async'):\n"
    "    train_pipeline_epoch(c, [(x, y)], 0.01, schedule=s)\n"
    "p = HeteroCompiledPipeline(m, 2, 2, device='cpu')\n"
    "for make in (p.make_train_step, p.make_train_step_1f1b):\n"
    "    opt = SGD(0.01)\n"
    "    prm, st = dict(m.named_parameters()), dict(m.named_buffers())\n"
    "    make(get_loss('softmax_crossentropy'), opt)(prm, opt.init(prm), st,\n"
    "        x.reshape(2, 4, 1, 28, 28), y.reshape(2, 4, 10), 0, 0.01)\n")


def test_pipeline_modules_and_paths_leave_jax_out():
    _run_isolated(PIPELINE)


# the TCP pipeline: wire codecs, hardware info, channels, the coordinator
# and the stage worker; bf16 frames decode without ml_dtypes
TCP_MODULES = (
    "dcnn_tpu_torch.utils.compression", "dcnn_tpu_torch.utils.hardware",
    "dcnn_tpu_torch.parallel.comm",
    "dcnn_tpu_torch.parallel.distributed_pipeline",
    "dcnn_tpu_torch.parallel.worker",
)
TCP_FORBIDDEN = FORBIDDEN + ("ml_dtypes",)


@pytest.mark.parametrize("module", TCP_MODULES)
def test_tcp_module_imports_no_jax(module):
    """The source of each TCP-pipeline module imports no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if mod.split(".")[0] in TCP_FORBIDDEN]
    assert not bad, bad


TCP = (
    "import importlib, runpy, threading\n"
    f"for name in {TCP_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "from dcnn_tpu_torch.models import create_model\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.parallel import (DistributedPipelineCoordinator,\n"
    "    StageWorker, comm)\n"
    "from dcnn_tpu_torch.utils.compression import MetaCompressor\n"
    "from dcnn_tpu_torch.utils.hardware import HardwareInfo\n"
    "socks = [comm.listen(0, host='127.0.0.1') for _ in range(2)]\n"
    "ws = [StageWorker(0, listen_sock=s, device='cpu') for s in socks]\n"
    "for w in ws:\n"
    "    threading.Thread(target=w.serve, daemon=True).start()\n"
    "m = create_model('mnist_cnn').init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "co = DistributedPipelineCoordinator(m, SGD(0.01), "
    "'softmax_crossentropy',\n"
    "    [f'127.0.0.1:{s.getsockname()[1]}' for s in socks],\n"
    "    num_microbatches=2, compress='zlib', device='cpu')\n"
    "co.deploy_stages()\n"
    "x, y = torch.randn(4, 1, 28, 28), torch.eye(10)[torch.arange(4)]\n"
    "loss, _ = co.train_batch_semi_async(x, y, 0.01, 0)\n"
    "assert loss == loss and co.health_check()[1]['configured']\n"
    "co.shutdown()\n"
    "mc = MetaCompressor()\n"
    "b = torch.randn(3, 5).to(torch.bfloat16)\n"
    "assert torch.equal(mc.decompress_array(mc.compress_array(b)), b)\n"
    "assert HardwareInfo.collect()['default_backend'] in ('cpu', 'cuda')\n"
    "sys.argv = ['worker', '--help']\n"
    "try:\n"
    "    runpy.run_module('dcnn_tpu_torch.parallel.worker',"
    " run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    assert e.code == 0\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "assert not bad, bad\n")


def test_tcp_pipeline_modules_and_worker_entry_leave_jax_out():
    """The TCP modules imported one by one, a two-worker semi-async batch
    on the CPU, a bf16 frame, hardware info and the worker's ``--help``
    load no JAX, flax, msgpack, ml_dtypes or JAX-package module."""
    _run_isolated(TCP)


# the router tier: replicas in process and over TCP, versioned hot-swap
ROUTER_MODULES = ("dcnn_tpu_torch.serve.replica", "dcnn_tpu_torch.serve.swap",
                  "dcnn_tpu_torch.serve.router")


@pytest.mark.parametrize("module", ROUTER_MODULES)
def test_router_module_imports_no_jax(module):
    """The source of each router-tier module imports no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if mod.split(".")[0] in TCP_FORBIDDEN]
    assert not bad, bad


ROUTER = (
    "import importlib, tempfile\n"
    f"for name in {ROUTER_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "import numpy as np\n"
    "from dcnn_tpu_torch.nn import SequentialBuilder\n"
    "from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager\n"
    "from dcnn_tpu_torch.serve import (EngineFactory, LocalReplica,\n"
    "    ModelVersionManager, ReplicaServer, Router, TcpReplica)\n"
    "d = tempfile.mkdtemp()\n"
    "m = (SequentialBuilder('r', data_format='NHWC').input((6, 6, 1))"
    ".flatten().dense(3).build()).init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "mgr = CheckpointManager(d)\n"
    "mgr.save(1, m)\n"
    "f = EngineFactory(d, max_batch=2, device='cpu')\n"
    "local = LocalReplica(f, 1, name='local')\n"
    "backend = LocalReplica(f, 1, name='backend')\n"
    "srv = ReplicaServer(backend, port=0)\n"
    "tcp = TcpReplica('127.0.0.1', srv.port, name='tcp')\n"
    "r = Router([local, tcp])\n"
    "x = np.zeros((6, 6, 1), np.float32)\n"
    "assert all(r.submit(x).result(30).shape == (3,) for _ in range(4))\n"
    "mgr.save(2, m)\n"
    "mvm = ModelVersionManager(r, f, canary_fraction=1.0, observe_s=0.0,"
    " min_canary_requests=0)\n"
    "assert mvm.poll()['action'] == 'canary'\n"
    "assert mvm.poll()['action'] == 'promoted'\n"
    "assert r.submit(x, priority='high').result(30).shape == (3,)\n"
    "r.shutdown()\n"
    "tcp.close(); srv.close(); backend.close(); local.close(); mgr.close()\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "assert not bad, bad\n")


def test_router_tier_leaves_jax_out():
    """The router-tier modules imported one by one, then a router over a
    local and a TCP replica serving a checkpointed model on the CPU and
    promoting its next version, load no JAX, flax, msgpack, ml_dtypes or
    JAX-package module."""
    _run_isolated(ROUTER)


# data parallelism over processes and elastic peers
DP_MODULES = ("dcnn_tpu_torch.core.mesh", "dcnn_tpu_torch.parallel.multihost",
              "dcnn_tpu_torch.parallel.data_parallel",
              "dcnn_tpu_torch.parallel.elastic")


@pytest.mark.parametrize("module", DP_MODULES)
def test_data_parallel_module_imports_no_jax(module):
    """The source of each data-parallel module imports no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if mod.split(".")[0] in TCP_FORBIDDEN]
    assert not bad, bad


DATA_PARALLEL = (
    "import importlib, threading\n"
    f"for name in {DP_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "import numpy as np\n"
    "from dcnn_tpu_torch.core import TrainingConfig\n"
    "from dcnn_tpu_torch.core.mesh import make_mesh\n"
    "from dcnn_tpu_torch.data import ArrayDataLoader\n"
    "from dcnn_tpu_torch.nn import SequentialBuilder\n"
    "from dcnn_tpu_torch.ops.losses import get_loss\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.parallel import (comm, multihost,\n"
    "    make_data_parallel_train_step, replicate, shard_batch)\n"
    "from dcnn_tpu_torch.parallel.elastic import ElasticController, PeerSpec\n"
    "from dcnn_tpu_torch.train import Trainer, create_train_state\n"
    "def model():\n"
    "    return (SequentialBuilder('d').input((4,)).dense(4).batchnorm()"
    ".dense(2).build()).init(generator=torch.Generator().manual_seed(0),"
    " device='cpu')\n"
    "multihost.initialize(num_processes=1, backend='gloo')\n"
    "mesh = make_mesh()\n"
    "m, opt = model(), SGD(0.1)\n"
    "ts = replicate(create_train_state(m, opt), mesh)\n"
    "x, y = torch.ones(4, 4), torch.eye(2)[[0, 1, 0, 1]]\n"
    "step = make_data_parallel_train_step(m, get_loss('mse'), opt, mesh)\n"
    "assert torch.isfinite(step(ts, *shard_batch((x, y), mesh), 0.1)[0])\n"
    "multihost.shutdown()\n"
    "rows = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)\n"
    "ys = np.eye(2, dtype=np.float32)[[0, 1] * 4]\n"
    "socks = [comm.listen(0, host='127.0.0.1') for _ in range(2)]\n"
    "peers = [PeerSpec(i, '127.0.0.1', s.getsockname()[1])"
    " for i, s in enumerate(socks)]\n"
    "out = {}\n"
    "def run(i):\n"
    "    cfg = TrainingConfig(epochs=1, elastic=True, elastic_microbatches=2,"
    " elastic_heartbeat_s=0.0, device_type='cpu', seed=1)\n"
    "    mi = model()\n"
    "    c = ElasticController(mi, SGD(0.1), 'mse', ArrayDataLoader(rows, ys,"
    " batch_size=4), config=cfg, rank=i, peers=peers, listen_sock=socks[i])\n"
    "    out[i] = c.fit(create_train_state(mi, c.optimizer))\n"
    "ts_ = [threading.Thread(target=run, args=(i,)) for i in range(2)]\n"
    "[t.start() for t in ts_]; [t.join(60) for t in ts_]\n"
    "assert all(torch.equal(a, b) for a, b in zip("
    "out[0].model.parameters(), out[1].model.parameters()))\n"
    "cfg = TrainingConfig(epochs=1, elastic=True, elastic_rank=0,"
    " elastic_heartbeat_s=0.0, device_type='cpu')\n"
    "tr = Trainer(model(), SGD(0.1), 'mse', cfg)\n"
    "tr.fit(create_train_state(tr.model, tr.optimizer),"
    " ArrayDataLoader(rows, ys, batch_size=4))\n"
    "assert tr.history and tr.history[0]['world'] == 1\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "assert not bad, bad\n")


def test_data_parallel_and_elastic_leave_jax_out():
    """The mesh, multihost, data-parallel and elastic modules imported one
    by one, then a mesh step over a world of one, an elastic fleet of two
    thread peers and an elastic ``Trainer.fit`` on the CPU, load no JAX,
    flax, msgpack, ml_dtypes or JAX-package module."""
    _run_isolated(DATA_PARALLEL)


# sequence parallelism, the data-parallel device feed and the compiled
# pipeline's data axis
SEQ_MODULES = ("dcnn_tpu_torch.parallel.sequence",
               "dcnn_tpu_torch.data.device_dataset",
               "dcnn_tpu_torch.data.prefetch",
               "dcnn_tpu_torch.parallel.compiled_pipeline")


@pytest.mark.parametrize("module", SEQ_MODULES)
def test_sequence_and_dp_feed_module_imports_no_jax(module):
    """The source of each module of this path imports no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if mod.split(".")[0] in TCP_FORBIDDEN]
    assert not bad, bad


SEQUENCE_AND_DP_FEED = (
    "import importlib\n"
    f"for name in {SEQ_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "import numpy as np\n"
    "from dcnn_tpu_torch.core import TrainingConfig\n"
    "from dcnn_tpu_torch.core.mesh import make_mesh\n"
    "from dcnn_tpu_torch.data import (ArrayDataLoader, PrefetchLoader,\n"
    "    ShardedDeviceDataset)\n"
    "from dcnn_tpu_torch.nn import (Conv2DLayer, GroupNormLayer,\n"
    "    ResidualBlock, SequentialBuilder)\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.parallel import (multihost, SequentialStageStack,\n"
    "    make_compiled_pipeline_train_step, make_ring_attention,\n"
    "    make_ulysses_attention, make_zigzag_ring_attention, shard_sequence,\n"
    "    zigzag_shard)\n"
    "from dcnn_tpu_torch.train import Trainer, create_train_state\n"
    "multihost.initialize(num_processes=1, backend='gloo')\n"
    "seq = make_mesh((1,), ('seq',))\n"
    "g = torch.Generator().manual_seed(0)\n"
    "qkv = [torch.randn(1, 2, 16, 8, generator=g) for _ in range(3)]\n"
    "for f, shard in ((make_ring_attention(seq, causal=True), shard_sequence),"
    " (make_zigzag_ring_attention(seq), zigzag_shard),"
    " (make_ulysses_attention(seq), shard_sequence)):\n"
    "    loc = [t.requires_grad_(True) for t in shard(qkv, seq)]\n"
    "    f(*loc).sum().backward()\n"
    "    assert all(torch.isfinite(t.grad).all() for t in loc)\n"
    "data = make_mesh()\n"
    "rng = np.random.default_rng(0)\n"
    "x = rng.integers(0, 256, (32, 4, 4, 1), dtype=np.uint8)\n"
    "y = rng.integers(0, 2, 32)\n"
    "m = (SequentialBuilder('d', 'NHWC').input((4, 4, 1)).flatten()"
    ".dense(4).batchnorm().dense(2).build()).init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "tr = Trainer(m, SGD(0.1), 'softmax_crossentropy', TrainingConfig("
    "epochs=1, device_type='cpu', snapshot_dir=None))\n"
    "tr.fit(create_train_state(m, tr.optimizer), ShardedDeviceDataset("
    "x, y, 2, batch_size=8, mesh=data, device='cpu'))\n"
    "assert np.isfinite(tr.history[0]['train_loss'])\n"
    "ld = ArrayDataLoader(x, np.eye(2, dtype=np.float32)[y], batch_size=8)\n"
    "assert len(list(PrefetchLoader(ld, sharding=data, device='cpu'))) == 4\n"
    "stack = SequentialStageStack(ResidualBlock([Conv2DLayer(4, 3, 1, 1),"
    " GroupNormLayer(2)]), 2, (4, 4, 4))\n"
    "sp = stack.init(torch.Generator().manual_seed(0), device='cpu')\n"
    "opt = SGD(0.1)\n"
    "step = make_compiled_pipeline_train_step(stack.stage_fn,"
    " lambda a, b: ((a - b) ** 2).mean(), opt, 2, 2, mesh=data,"
    " data_axis='data')\n"
    "xs = torch.randn(2, 2, 4, 4, 4, generator=g)\n"
    "assert torch.isfinite(step(sp, opt.init(sp), xs, xs, 0.1)[2])\n"
    "multihost.shutdown()\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "assert not bad, bad\n")


def test_sequence_dp_feed_and_pipeline_data_axis_leave_jax_out():
    """The sequence, device-dataset, prefetch and compiled-pipeline modules
    imported one by one, then ring, zigzag and Ulysses attention forward
    and backward over a world of one, ``Trainer.fit`` over a
    ``ShardedDeviceDataset``, ``PrefetchLoader(sharding=)`` and a compiled
    pipeline step with ``data_axis=`` on the CPU, load no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    _run_isolated(SEQUENCE_AND_DP_FEED)


# spatial sharding and the trainer's telemetry plane
SPATIAL_TELEMETRY_MODULES = ("dcnn_tpu_torch.ops.spatial",
                             "dcnn_tpu_torch.obs.anomaly",
                             "dcnn_tpu_torch.obs.goodput",
                             "dcnn_tpu_torch.obs.rules")


@pytest.mark.parametrize("module", SPATIAL_TELEMETRY_MODULES)
def test_spatial_and_telemetry_module_imports_no_jax(module):
    """The source of each module imports no JAX, flax, msgpack, ml_dtypes
    or JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if mod.split(".")[0] in TCP_FORBIDDEN]
    assert not bad, bad


SPATIAL_AND_TELEMETRY = (
    "import importlib, json, urllib.request\n"
    f"for name in {SPATIAL_TELEMETRY_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{TCP_FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "import numpy as np\n"
    "from dcnn_tpu_torch.core import TrainingConfig\n"
    "from dcnn_tpu_torch.core.mesh import make_mesh\n"
    "from dcnn_tpu_torch.data import ArrayDataLoader\n"
    "from dcnn_tpu_torch.nn import SequentialBuilder\n"
    "from dcnn_tpu_torch.ops.losses import get_loss\n"
    "from dcnn_tpu_torch.optim import SGD\n"
    "from dcnn_tpu_torch.parallel import (multihost,\n"
    "    make_data_parallel_train_step, replicate, shard_batch)\n"
    "from dcnn_tpu_torch.train import Trainer, create_train_state\n"
    "def model():\n"
    "    return (SequentialBuilder('s').input((1, 8, 8)).conv2d(2, 3, 1, 1)"
    ".batchnorm().maxpool2d(2).flatten().dense(2).build()).init("
    "generator=torch.Generator().manual_seed(0), device='cpu')\n"
    "multihost.initialize(num_processes=1, backend='gloo')\n"
    "mesh = make_mesh((1, 1), ('data', 'sp'))\n"
    "m, opt = model(), SGD(0.1)\n"
    "ts = replicate(create_train_state(m, opt), mesh)\n"
    "x, y = torch.ones(4, 1, 8, 8), torch.eye(2)[[0, 1, 0, 1]]\n"
    "step = make_data_parallel_train_step(m, get_loss('mse'), opt, mesh,"
    " spatial_axis='sp')\n"
    "xs, ys = shard_batch((x, y), mesh, spatial_axis='sp')\n"
    "assert torch.isfinite(step(ts, xs, ys, 0.1)[0])\n"
    "multihost.shutdown()\n"
    "rows = np.random.default_rng(0).normal(size=(8, 1, 8, 8))"
    ".astype(np.float32)\n"
    "ys = np.eye(2, dtype=np.float32)[[0, 1] * 4]\n"
    "served = []\n"
    "class Loader(ArrayDataLoader):\n"
    "    def __iter__(self):\n"
    "        for i, b in enumerate(super().__iter__()):\n"
    "            if i == 1:\n"
    "                url = tr.telemetry.url + '/goodput'\n"
    "                served.append(json.loads(urllib.request.urlopen(url,"
    " timeout=10).read()))\n"
    "            yield b\n"
    "tr = Trainer(model(), SGD(0.1), 'mse', TrainingConfig(epochs=1,"
    " metrics_port=0, device_type='cpu', snapshot_dir=None,"
    " progress_interval=0))\n"
    "tr.fit(create_train_state(tr.model, tr.optimizer),"
    " Loader(rows, ys, batch_size=4))\n"
    "assert served and 'bottleneck' in served[0]\n")


def test_spatial_step_and_telemetry_plane_leave_jax_out():
    """The spatial op rule and the goodput, anomaly and rules modules
    imported one by one, then a spatial mesh step over a world of one and
    a ``Trainer.fit`` serving ``/goodput`` on the CPU, load no JAX, flax,
    msgpack, ml_dtypes or JAX-package module."""
    _run_isolated(SPATIAL_AND_TELEMETRY)


# the fleet plane and autoscaling
FLEET_MODULES = ("dcnn_tpu_torch.obs.trace", "dcnn_tpu_torch.obs.fleet",
                 "dcnn_tpu_torch.serve.autoscale",
                 "dcnn_tpu_torch.parallel.autoscale",
                 "dcnn_tpu_torch.serve.soak")


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_and_autoscale_module_imports_no_jax(module):
    """The source of each module imports no JAX, flax, msgpack or
    JAX-package module."""
    path = REPO / (module.replace(".", "/") + ".py")
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


FLEET = (
    "import importlib, json, os, tempfile, threading, urllib.request\n"
    f"for name in {FLEET_MODULES!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "import numpy as np\n"
    "from dcnn_tpu_torch.obs import FleetAggregator, HttpScraper, configure\n"
    "from dcnn_tpu_torch.obs.flight import FlightRecorder\n"
    "from dcnn_tpu_torch.obs.registry import MetricsRegistry\n"
    "from dcnn_tpu_torch.obs.trace import main as trace_main\n"
    "from dcnn_tpu_torch.parallel import LeasedElasticTrainer, TrainLease\n"
    "from dcnn_tpu_torch.serve import DeviceLeaseBroker, LocalReplica\n"
    "from dcnn_tpu_torch.serve.soak import (run_diurnal_soak,"
    " synthetic_engine_factory)\n"
    "report, scaler, router = run_diurnal_soak(seconds=30.0, period=30.0,"
    " kill_at=12.0, canary_at=18.0)\n"
    "assert report['silently_dropped'] == 0 and report['scale_ups'] >= 1\n"
    "assert report['history']['points'] > 0\n"
    "tracer = configure(enabled=True)\n"
    "rep = LocalReplica(synthetic_engine_factory, 1, name='r0', start=False)\n"
    "srv = rep.start_telemetry(port=0)\n"
    "f = rep.submit(np.zeros(4, np.float32))\n"
    "rep.step()\n"
    "assert (f.result(0) == 1).all()\n"
    "agg = FleetAggregator(registry=MetricsRegistry())\n"
    "agg.add_target('local', server=srv)\n"
    "agg.add_target('http', url=srv.url)\n"
    "agg.add_target('gone', url='http://127.0.0.1:9')\n"
    "agg.poll()\n"
    "fsrv = agg.serve()\n"
    "doc = json.loads(urllib.request.urlopen(fsrv.url + '/fleet',"
    " timeout=10).read())\n"
    "assert doc['series']['serve_samples_completed_total']['sum'] == 2\n"
    "assert 'gone' in agg.health_rollup()\n"
    "assert HttpScraper({'r0': srv.url})('r0')\n"
    "agg.close()\n"
    "rep.close()\n"
    "d = tempfile.mkdtemp()\n"
    "shard = tracer.export_jsonl(os.path.join(d, 's.jsonl'))\n"
    "assert trace_main(['merge', shard, '-o', os.path.join(d, 'm.json'),"
    " '--json']) == 0\n"
    "b = FlightRecorder(d, min_interval_s=0.0).record('unit', reasons=['r'])\n"
    "assert trace_main(['inspect', b]) == 0\n"
    "broker = DeviceLeaseBroker(2, registry=MetricsRegistry())\n"
    "lease = TrainLease(broker, initial=2, registry=MetricsRegistry())\n"
    "broker.register('serve', priority=1)\n"
    "class Ctl:\n"
    "    def preempt(self, reason=''):\n"
    "        pass\n"
    "    def fit(self, epochs, resume=True):\n"
    "        return 'done'\n"
    "t = LeasedElasticTrainer(lambda r, p, s: Ctl(), lease=lease,"
    " registry=MetricsRegistry())\n"
    "assert t.run_segment(1) == {0: 'done', 1: 'done'}\n")


def test_fleet_plane_and_autoscaling_leave_jax_out():
    """The five modules imported one by one, then the diurnal soak, a
    ``FleetAggregator`` over an in-process, an HTTP and a dead target
    serving ``/fleet``, the trace CLI's merge and inspect and a leased
    training segment, on the CPU with JAX, flax, msgpack and the JAX
    package blocked at import: nothing of them is loaded."""
    _run_isolated(FLEET, blocked=True)


# the static-analysis suite
ANALYSIS_MODULES = tuple(
    f"dcnn_tpu_torch.analysis.{m}" for m in (
        "core", "atomicity", "concurrency", "callgraph", "locks",
        "protocol", "coverage", "trace_safety", "retrace", "__main__",
        "__init__"))


@pytest.mark.parametrize("module", ANALYSIS_MODULES)
def test_analysis_module_imports_no_jax(module):
    """The source of each module of the port's suite imports no JAX,
    flax, msgpack or JAX-package module (``dcnn_tpu.analysis``, which is
    plain ``ast``, included)."""
    path = REPO / (module.replace(".", "/") + ".py")
    assert path.is_file(), path
    bad = [f"{line} imports {mod}" for line, mod in _imports(path)
           if _forbidden(mod)]
    assert not bad, bad


_IMPORTABLE = tuple(m for m in ANALYSIS_MODULES
                    if not m.endswith("__init__"))
ANALYSIS = (
    "import importlib, os, tempfile\n"
    f"for name in {_IMPORTABLE!r}:\n"
    "    importlib.import_module(name)\n"
    "    bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    f"{FORBIDDEN!r})\n"
    "    assert not bad, (name, bad)\n"
    "from dcnn_tpu_torch.analysis import analyze_paths, unsuppressed\n"
    "from dcnn_tpu_torch.analysis.__main__ import main\n"
    "d = tempfile.mkdtemp()\n"
    "open(os.path.join(d, 'm.py'), 'w').write('def f(x):\\n    print(x)\\n')\n"
    "assert not unsuppressed(analyze_paths([d]))\n"
    "base = os.path.join(d, 'b.json')\n"
    "assert main([d, '--no-baseline', '--write-baseline', base]) == 0\n"
    "assert main([d, '--list-checks']) == 0\n")


def test_analysis_suite_leaves_jax_out():
    """Each module of the suite imported one by one, an analysis and the
    CLI's ``--write-baseline`` (through the port's atomic write), with JAX,
    flax, msgpack and the JAX package blocked at import."""
    _run_isolated(ANALYSIS, blocked=True)



# the bench regression gate
REGRESS = REPO / "dcnn_tpu_torch" / "obs" / "regress.py"


def test_regress_module_imports_no_jax_and_no_torch():
    """``obs/regress.py`` imports no JAX, flax, msgpack or JAX-package
    module, and no torch either: it is standard library only."""
    bad = [f"{line} imports {mod}" for line, mod in _imports(REGRESS)
           if _forbidden(mod) or mod.split(".")[0] == "torch"]
    assert not bad, bad


def test_regress_gate_runs_alone_and_leaves_jax_out():
    """The module loaded from its file alone, with JAX, flax, msgpack, the
    JAX package and torch blocked at import, passes its self-test and
    gates the committed captures given as paths; then its command line
    through the package, with JAX blocked, passes its self-test."""
    blocked = FORBIDDEN + ("torch",)
    files = sorted(str(p) for p in REPO.glob("BENCH_r0*.json"))
    code = (
        "import importlib.abc, importlib.util, sys\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {blocked!r}:\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, _Block())\n"
        f"spec = importlib.util.spec_from_file_location('regress', "
        f"{str(REGRESS)!r})\n"
        "m = sys.modules['regress'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "assert m.self_test() == 0\n"
        f"assert m.main({files!r}) == 0\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{blocked!r})\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout
    _run_isolated("from dcnn_tpu_torch.obs.regress import main\n"
                  "assert main(['--self-test']) == 0\n", blocked=True)
