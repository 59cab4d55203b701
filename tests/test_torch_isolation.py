"""The port stands alone: ``dcnn_tpu_torch`` (and ``chip_smoke.py``, which
drives it on the GPU) import neither JAX nor anything of ``dcnn_tpu``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dcnn_tpu")


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


def test_import_and_cpu_forward_leave_jax_out():
    code = (
        "import sys, torch\n"
        "import dcnn_tpu_torch\n"
        "from dcnn_tpu_torch.models import create_model\n"
        "from dcnn_tpu_torch.serve import InferenceEngine\n"
        "m = create_model('mha_classifier').init("
        "generator=torch.Generator().manual_seed(0), device='cpu')\n"
        "e = InferenceEngine.from_model(m, max_batch=2, device='cpu')\n"
        "assert e.infer(torch.zeros(32, 64)).shape == (10,)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout
