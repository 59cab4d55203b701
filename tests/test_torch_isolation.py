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
schedules driven on the CPU."""

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


def _run_isolated(body: str) -> None:
    """Run ``body`` in a fresh interpreter after ``import dcnn_tpu_torch``
    and check that no module of JAX, flax, msgpack or the JAX package was
    loaded."""
    code = (
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
