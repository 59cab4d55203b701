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
attribute (``flash_fwd.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches``, ``conv3x3_s1.launches``,
``conv3x3_s1_pairs.launches``, ``conv3x3_s1_bnrelu_in.launches``,
``fused_scale_bias_relu.launches``), so a run can show that its path went
through the kernel. :data:`COUNTED` lists them all.
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
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "conv3x3.cu", "fused.cu")
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
    for name, n_out in (("dcnn_flash_bwd_dq", 1), ("dcnn_flash_bwd_dkv", 2)):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [p] * (6 + n_out) + [i, i, i, i, i, ctypes.c_float,
                                               i, p]
            fn.restype = i
    if hasattr(lib, "dcnn_conv3x3"):
        lib.dcnn_conv3x3.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.dcnn_conv3x3.restype = i
    if hasattr(lib, "dcnn_scale_bias_relu"):
        lib.dcnn_scale_bias_relu.argtypes = [p] * 4 + [ctypes.c_longlong, i,
                                                      i, p]
        lib.dcnn_scale_bias_relu.restype = i
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


def _check_attention(fn: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *like_q: torch.Tensor) -> None:
    """What every flash kernel takes: contiguous CUDA tensors q (B, H, Sq,
    D), k and v (B, H, Sk, D), and ``like_q`` (dO) shaped as q, all of one
    dtype of FLASH_DTYPES, D in FLASH_HEAD_DIMS, 1 <= B*H <= 65535."""
    for name, t in (("q", q), ("k", k), ("v", v),
                    *(("dO", t) for t in like_q)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in FLASH_DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not in {FLASH_DTYPES}")
    if q.ndim != 4:
        raise ValueError(f"{fn}: q must be (B, H, Sq, D), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.ndim == 4 else -1
    if k.shape != (b, h, sk, d) or v.shape != k.shape or any(
            t.shape != q.shape for t in like_q):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree"
                         + "".join(f", dO {tuple(t.shape)}" for t in like_q))
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {d} not in {FLASH_HEAD_DIMS}")
    if not (1 <= b * h <= 65535 and sq >= 1 and sk >= 1):
        raise ValueError(f"{fn}: need 1 <= B*H <= 65535 and non-empty "
                         f"sequences, got B*H={b * h}, Sq={sq}, Sk={sk}")


def _check_rows(fn: str, q: torch.Tensor, **rows: torch.Tensor) -> None:
    """Per-row fp32 inputs (logsumexp, delta): contiguous (B, H, Sq) on q's
    device."""
    for name, t in rows.items():
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be contiguous fp32 {tuple(q.shape[:3])} "
                f"on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _raise_on(lib: ctypes.CDLL, fn: str, err: int) -> None:
    if err != 0:
        msg = lib.dcnn_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors q (B, H, Sq,
    D), k and v (B, H, Sk, D) of fp32 or bf16, D in {16, 32, 64, 128}.
    Returns (O like q, logsumexp (B, H, Sq) fp32). Raises on anything the
    kernel does not take."""
    _check_attention("flash_fwd", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lib = build()["flash_fwd.cu"]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnn_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b * h, sq, sk,
                                 d, int(causal), float(scale),
                                 int(q.dtype == torch.bfloat16), stream)
    _raise_on(lib, "flash_fwd", err)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 causal: bool, scale: float) -> torch.Tensor:
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``: q and the output
    cotangent ``do`` (B, H, Sq, D), k and v (B, H, Sk, D), contiguous CUDA
    tensors of fp32 or bf16; ``lse`` the forward's logsumexp and ``delta``
    = rowsum(dO * O), both (B, H, Sq) fp32. Returns dQ like q."""
    _check_attention("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse=lse, delta=delta)
    b, h, sq, d = q.shape
    lib = build()["flash_bwd.cu"]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnn_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, sq,
            k.shape[2], d, int(causal), float(scale),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(lib, "flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu`` on the inputs
    :func:`flash_bwd_dq` takes. Returns (dK like k, dV like v)."""
    _check_attention("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse=lse, delta=delta)
    b, h, sq, d = q.shape
    lib = build()["flash_bwd.cu"]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dcnn_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, sq, k.shape[2], d, int(causal), float(scale),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(lib, "flash_bwd_dkv", err)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


CONV_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(fn: str, ref: torch.Tensor, **tensors: torch.Tensor) -> None:
    """Contiguous tensors on ``ref``'s CUDA device, of the types the conv
    and elementwise kernels take."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not on "
                             f"{ref.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if ref.dtype not in CONV_DTYPES:
        raise TypeError(f"{fn}: dtype {ref.dtype} not in {CONV_DTYPES}")


def _check_conv(fn: str, x: torch.Tensor, w: torch.Tensor, taps: int,
                lanes_per_cout: int, out_dtype: torch.dtype) -> Tuple[int, ...]:
    """x (N, H, W, Cin) and weights (3, taps, Cin, lanes_per_cout * Cout)
    of x's dtype; returns (N, H, W, Cin, Cout)."""
    _check_cuda(fn, x, x=x, w=w)
    if w.dtype != x.dtype:
        raise TypeError(f"{fn}: w is {w.dtype}, x is {x.dtype}")
    if out_dtype not in CONV_DTYPES:
        raise TypeError(f"{fn}: out_dtype {out_dtype} not in {CONV_DTYPES}")
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"{fn}: need x (N, H, W, Cin) and 4-D weights, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    if (w.shape[:3] != (3, taps, cin) or w.shape[3] % lanes_per_cout
            or w.shape[3] == 0):
        raise ValueError(f"{fn}: weights {tuple(w.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    cout = w.shape[3] // lanes_per_cout
    if not (1 <= n <= 65535 and min(h, wd, cin) >= 1
            and x.numel() < 2 ** 31 and n * h * wd * cout < 2 ** 31):
        raise ValueError(f"{fn}: sizes out of range: x {tuple(x.shape)}, "
                         f"Cout {cout}")
    return n, h, wd, cin, cout


def _launch_conv(fn: str, x, w, scale, shift, out_dtype, *,
                 pairs: bool = False) -> torch.Tensor:
    """Launch ``csrc/conv3x3.cu``: with ``pairs`` on the fused weights
    (3, 4, Cin, 2·Cout), else on (3, 3, Cin, Cout) with the BN prologue
    where ``scale`` and ``shift`` are given."""
    n, h, wd, _, cout = _check_conv(fn, x, w, 4 if pairs else 3,
                                    2 if pairs else 1, out_dtype)
    if pairs and wd % 2:
        raise ValueError(f"{fn}: W={wd} must be even")
    lib = build()["conv3x3.cu"]
    out = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcnn_conv3x3(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(),
            *x.shape, cout, int(pairs), int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    _raise_on(lib, fn, err)
    return out


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, *,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the plain 3×3 stride-1 SAME conv of ``csrc/conv3x3.cu`` on
    contiguous CUDA tensors x (N, H, W, Cin) and w (3, 3, Cin, Cout) of one
    dtype of CONV_DTYPES. Returns (N, H, W, Cout) of ``out_dtype``."""
    out = _launch_conv("conv3x3_s1", x, w, None, None, out_dtype)
    conv3x3_s1.launches += 1
    return out


def conv3x3_s1_bnrelu_in(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, *,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the conv of ``csrc/conv3x3.cu`` with ``relu(x·scale+shift)``
    applied to the input at load; ``scale`` and ``shift`` contiguous fp32
    (Cin,) on x's device. Otherwise as :func:`conv3x3_s1`."""
    cin = x.shape[-1] if x.ndim == 4 else -1
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.shape != (cin,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"conv3x3_s1_bnrelu_in: {name} must be "
                             f"contiguous fp32 ({cin},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = _launch_conv("conv3x3_s1_bnrelu_in", x, w, scale, shift, out_dtype)
    conv3x3_s1_bnrelu_in.launches += 1
    return out


def conv3x3_s1_pairs(x: torch.Tensor, w2: torch.Tensor, *,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the output-column-pair conv of ``csrc/conv3x3.cu`` on
    contiguous CUDA tensors x (N, H, W, Cin), W even, and the fused weights
    w2 (3, 4, Cin, 2·Cout) of ``fuse_pair_weights``. Returns (N, H, W,
    Cout) of ``out_dtype``."""
    out = _launch_conv("conv3x3_s1_pairs", x, w2, None, None, out_dtype,
                       pairs=True)
    conv3x3_s1_pairs.launches += 1
    return out


def fused_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/fused.cu``: ``max(x·scale + bias, 0)`` over the last
    axis of a contiguous CUDA tensor x (..., C); scale and bias contiguous
    (C,) of x's dtype. Returns a tensor like x."""
    fn = "fused_scale_bias_relu"
    _check_cuda(fn, x, x=x, scale=scale, bias=bias)
    c = x.shape[-1] if x.ndim else 0
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != x.dtype or t.shape != (c,):
            raise ValueError(f"{fn}: {name} must be {x.dtype} ({c},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.numel() == 0 or c == 0 or c >= 2 ** 31:
        raise ValueError(f"{fn}: need a non-empty x with channels, got "
                         f"{tuple(x.shape)}")
    lib = build()["fused.cu"]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dcnn_scale_bias_relu(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel(), c, int(x.dtype == torch.bfloat16), stream)
    _raise_on(lib, fn, err)
    fused_scale_bias_relu.launches += 1
    return y


conv3x3_s1.launches = 0
conv3x3_s1_bnrelu_in.launches = 0
conv3x3_s1_pairs.launches = 0
fused_scale_bias_relu.launches = 0

# every launch-counted wrapper, for runs that reset and read the counts
COUNTED = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, conv3x3_s1,
           conv3x3_s1_pairs, conv3x3_s1_bnrelu_in, fused_scale_bias_relu)
