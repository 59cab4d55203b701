"""The port stands alone: ``dcnn_tpu_torch`` (and ``chip_smoke.py``, which
drives it on the GPU) import neither JAX nor anything of ``dcnn_tpu``, nor
``msgpack`` (the port's own codec writes and reads the checkpoint format,
so the port needs no msgpack installed), on the attention serving and
training paths, on the CNN serving path with the conv kernels' plain
versions, and on the checkpoint path (save, async save, restore, resume,
serving a snapshot)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
