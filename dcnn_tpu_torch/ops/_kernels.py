"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, loaded with ``ctypes``. The
build happens at first use, from the sources in the checkout, into
``dcnn_tpu_torch/_build/`` (git-ignored). A library's file name carries a
hash of its source and flags, so a changed source is rebuilt and an
unchanged one is reused. All missing libraries are compiled at once, one
``nvcc`` process per source.

Each wrapper launches on PyTorch's current stream, raises when the C
function reports a CUDA error, and counts its launches in a plain integer
attribute (``flash_fwd.launches``), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "dcnn_flash_fwd"):
        lib.dcnn_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                       ctypes.c_float, i, p]
        lib.dcnn_flash_fwd.restype = i
    lib.dcnn_cuda_error_string.argtypes = [i]
    lib.dcnn_cuda_error_string.restype = ctypes.c_char_p


def build(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every source not built yet (all ``nvcc`` runs in parallel)
    and load every library. ``verbose`` adds ``-Xptxas -v`` to fresh builds
    and prints the compiler's report of registers, shared memory and
    spills. Returns {source name: library}."""
    with _lock:
        missing = [s for s in SOURCES if s not in _libs]
        procs = []
        for name in missing:
            src, out = CSRC / name, _lib_path(CSRC / name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(src)]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)  # a half-written library is never loaded
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in missing:
            lib = ctypes.CDLL(str(_lib_path(CSRC / name)))
            _bind(lib)
            _libs[name] = lib
        return dict(_libs)


FLASH_HEAD_DIMS = (16, 32, 64, 128)
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors q (B, H, Sq,
    D), k and v (B, H, Sk, D) of fp32 or bf16, D in {16, 32, 64, 128}.
    Returns (O like q, logsumexp (B, H, Sq) fp32). Raises on anything the
    kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_fwd: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_fwd: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in FLASH_DTYPES:
        raise TypeError(f"flash_fwd: dtype {q.dtype} not in {FLASH_DTYPES}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not in {FLASH_HEAD_DIMS}")
    if not (1 <= b * h <= 65535 and sq >= 1 and sk >= 1):
        raise ValueError(f"flash_fwd: need 1 <= B*H <= 65535 and non-empty "
                         f"sequences, got B*H={b * h}, Sq={sq}, Sk={sk}")
    lib = build()["flash_fwd.cu"]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnn_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b * h, sq, sk,
                                 d, int(causal), float(scale),
                                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.dcnn_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} ({msg})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0
