"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, loaded with ``ctypes``. The
build happens at first use, from the sources in the checkout, into the
build directory: ``dcnn_tpu_torch/_build/`` (git-ignored) unless
``AOT_CACHE`` or ``DCNN_COMPILE_CACHE`` places it
(:mod:`~dcnn_tpu_torch.utils.compile_cache`, which also checks the
directory once a process). A library's file name carries a hash of its
source and flags, so a changed source is rebuilt and an unchanged one is
reused. With the AOT cache on (:mod:`~dcnn_tpu_torch.aot`), a library
missing from the directory is restored from the cache before ``nvcc``
would run, and every library loaded is committed to it. All libraries
still missing are compiled at once, one ``nvcc`` process per source.

The 3×3 convs' tiling (:func:`conv_plan`), the flash forward's
(:func:`flash_plan`), the flash backward's (:func:`flash_bwd_plan`) and the
int8 conv's (:func:`conv_int8_plan`) are chosen here, in pure Python, and
passed to ``csrc/conv3x3_tc.cu``, ``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu`` and ``csrc/conv_int8.cu``, so the CPU tests reach
them; the conv's tile format (:data:`TILE_FORMAT`) is defined here alone
and reaches that source's build as ``-D`` flags. The headers in ``csrc/``
(``hopper.cuh``, ``flash.cuh``) are part of every library's hash.

Each wrapper launches on PyTorch's current stream, raises when the C
function reports a CUDA error, and counts its launches in a plain integer
attribute (``flash_fwd.launches``, ``flash_bwd_dq.launches``,
``flash_bwd_dkv.launches``, ``conv3x3_s1.launches``,
``conv3x3_s1_pairs.launches``, ``conv3x3_s1_bnrelu_in.launches``,
``fused_scale_bias_relu.launches``, ``conv_int8.launches``,
``conv_int8_fused.launches``, ``conv_int8_reduce.launches``), so a run can
show that its path went through the kernel. :data:`COUNTED` lists them
all.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "conv3x3_tc.cu", "fused.cu",
           "conv_int8.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# conv3x3_tc.cu's tile format: output pixels per tile (two 64-row wgmma
# slabs; a 256-pixel tile holds two such), bytes of one staged pixel row (a
# Cin chunk, the 128-byte swizzle's row), and the most halo rows, b (th+2)
# (tw+2), a plan may stage
TILE_FORMAT = {"CONV_TC_TILE_M": 128, "CONV_TC_ROW_BYTES": 128,
               "CONV_TC_MAX_HALO_ROWS": 400}
TILE_PIXELS = TILE_FORMAT["CONV_TC_TILE_M"]
ROW_BYTES = TILE_FORMAT["CONV_TC_ROW_BYTES"]
MAX_HALO_ROWS = TILE_FORMAT["CONV_TC_MAX_HALO_ROWS"]
# diagnostic builds of conv3x3_tc.cu, flash_fwd.cu and flash_bwd.cu with
# per-stage clock counters (-DCONV_TC_TRACE, -DFLASH_TRACE,
# -DFLASH_BWD_TRACE), built and launched only where asked for by name
# (ops/conv_tc_stages.py, ops/flash_stages.py)
CONV_TC_TRACE = "conv3x3_tc.cu+trace"
FLASH_TRACE = "flash_fwd.cu+trace"
FLASH_BWD_TRACE = "flash_bwd.cu+trace"
_TILE_DEFINES = tuple(f"-D{k}={v}" for k, v in TILE_FORMAT.items())
_DEFINES = {"conv3x3_tc.cu": _TILE_DEFINES,
            CONV_TC_TRACE: (*_TILE_DEFINES, "-DCONV_TC_TRACE"),
            FLASH_TRACE: ("-DFLASH_TRACE",),
            FLASH_BWD_TRACE: ("-DFLASH_BWD_TRACE",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def _source(name: str) -> Path:
    return CSRC / name.split("+")[0]


def _flags(name: str) -> Tuple[str, ...]:
    return (*NVCC_FLAGS, *_DEFINES.get(name, ()))


def build_root() -> Path:
    """The build directory (:func:`~dcnn_tpu_torch.utils.compile_cache.
    resolve_cache_root`); reading it checks nothing."""
    from ..utils.compile_cache import resolve_cache_root

    return Path(resolve_cache_root(str(BUILD_DIR)))


def _lib_path(name: str, root: Optional[Path] = None) -> Path:
    """The library of build ``name`` in ``root`` (the build directory by
    default): its file name hashes the source, every header of ``csrc/``
    (a source may include any) and the flags."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    stem = src.stem + name[len(src.name):].replace("+", "_")
    return (build_root() if root is None else Path(root)) / \
        f"lib{stem}-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "dcnn_flash_fwd"):
        lib.dcnn_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                       ctypes.c_float, i, i, i, i, i, i, p]
        lib.dcnn_flash_fwd.restype = i
    for name, n_out in (("dcnn_flash_bwd_dq", 1), ("dcnn_flash_bwd_dkv", 2)):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = [p] * (6 + n_out) + [i, i, i, i, i, ctypes.c_float,
                                               i, i, i, i, i, i, p]
            fn.restype = i
    if hasattr(lib, "dcnn_conv3x3_tc"):
        lib.dcnn_conv3x3_tc.argtypes = [p] * 7 + [i] * 15 + [p]
        lib.dcnn_conv3x3_tc.restype = i
    for name in ("dcnn_conv3x3_tc_trace", "dcnn_flash_fwd_trace",
                 "dcnn_flash_bwd_trace"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p]
            getattr(lib, name).restype = i
    if hasattr(lib, "dcnn_scale_bias_relu"):
        lib.dcnn_scale_bias_relu.argtypes = [p] * 4 + [ctypes.c_longlong, i,
                                                      i, p]
        lib.dcnn_scale_bias_relu.restype = i
    ll = ctypes.c_longlong
    if hasattr(lib, "dcnn_conv_int8"):
        lib.dcnn_conv_int8.argtypes = [p] * 7 + [i] * 13 + [ll] * 8 + [i] * 11 + [p]
        lib.dcnn_conv_int8.restype = i
    lib.dcnn_cuda_error_string.argtypes = [i]
    lib.dcnn_cuda_error_string.restype = ctypes.c_char_p


def build(verbose: bool = False, extra: Tuple[str, ...] = (),
          cache=None) -> Dict[str, ctypes.CDLL]:
    """Compile every source not built yet (all ``nvcc`` runs in parallel)
    and load every library. ``extra`` names diagnostic builds to add
    (:data:`CONV_TC_TRACE`); the wrappers never launch those. ``verbose``
    adds ``-Xptxas -v`` to fresh builds and prints the compiler's report of
    registers, shared memory and spills. ``cache``: the AOT cache to
    restore libraries from and commit them to (an ``ExecutableCache`` or a
    root directory; None follows ``AOT_CACHE``; False: none). A build whose
    libraries are all restored or present runs no compiler and asks for
    none. Returns {build name: library}."""
    with _lock:
        missing = [s for s in dict.fromkeys((*SOURCES, *extra))
                   if s not in _libs]
        if not missing:
            return dict(_libs)
        from ..aot import warm
        from ..utils.compile_cache import enable_compile_cache

        root = Path(enable_compile_cache(str(BUILD_DIR)))
        aot = warm.resolve(cache)
        procs = []
        for name in missing:
            out = _lib_path(name, root)
            if out.exists() or (aot is not None
                                and warm.restore_library(aot, name, out)):
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(name),
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(_source(name))]
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
            path = _lib_path(name, root)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _libs[name] = lib
            if aot is not None:
                warm.commit_library(aot, name, path)
        return dict(_libs)


# the head-dim classes the wgmma flash kernels are built for: a head dim d
# <= 256 runs as the smallest class >= d, columns d.. zero-filled by the
# copy; above 256 every kernel runs its wide mode (the class: the next
# multiple of FLASH_GROUP)
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
# columns of an output group of the backward's wide modes (flash_bwd.cu
# WideDq::kG, WideBwd::kG), one group a multiplying warpgroup
FLASH_GROUP = 128
FLASH_DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448      # a block's dynamic shared memory on sm_90
FLASH_MAX_STAGES = 4
# registers a multiplying thread of a flash kernel may give to its
# accumulators, S (and dP) fragments and A operands (flash_fwd.cu and
# flash_bwd.cu kRegBudget); where a class's accumulators would exceed it, a
# block produces its output in column groups (one group per block)
FLASH_BWD_REG_BUDGET = 176


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_head_class(d: int) -> int:
    """The class a head dim runs as: the smallest of :data:`FLASH_HEAD_DIMS`
    >= d, or above 256 the next multiple of :data:`FLASH_GROUP` (the wide
    backward kernels' column groups)."""
    if d < 1:
        raise ValueError(f"head dim {d} < 1")
    for c in FLASH_HEAD_DIMS:
        if d <= c:
            return c
    return _cdiv(d, FLASH_GROUP) * FLASH_GROUP


def flash_head_width(d: int, dtype: torch.dtype) -> int:
    """The head dim the kernels are given for d: d, or d padded with zero
    columns to whole 16-byte units where its rows are not (TMA copies rows
    of whole 16-byte units): a multiple of 4 in fp32, of 8 in bf16."""
    unit = 16 // (2 if dtype == torch.bfloat16 else 4)
    return _cdiv(d, unit) * unit


@dataclass(frozen=True)
class FlashPlan:
    """How ``csrc/flash_fwd.cu`` cuts one attention: blocks of ``q_rows``
    q rows (one multiplying warpgroup per 64) and one of ``groups`` groups
    of O's columns (each block recomputes S over the whole head dim), kv
    tiles of ``kv_tile`` keys in a ring of ``stages``, and the block's
    shared memory in bytes (``smem``), laid out as the kernel's ``Tile``
    lays it out: Q (and in fp32 its tf32 lo), then per stage K and the
    group's columns of V as they land (fp32: K's lo, V transposed as hi and
    lo), each row of the head-dim class in ``chunks`` 128-byte chunks.
    ``serial``: two stages do not fit beside a 64-row block, so one stage
    holds a tile at a time and a pass runs S, the softmax and P·V in turn
    (fp32 at class 256). ``slices``: 0 where a stage holds the contraction
    over the head dim whole; above 256 the wide mode (:class:`_WideFwd`)
    streams S's contraction through the ring in ``slices`` slices of one or
    two chunks, each kv tile as its slices and then one unit of the group's
    columns of V, O in ``groups`` groups of ``_WideFwd.group`` columns."""
    q_rows: int
    kv_tile: int
    stages: int
    smem: int
    chunks: int
    groups: int = 1
    serial: bool = False
    slices: int = 0

    def kv_tiles(self, q_tile: int, sq: int, sk: int, causal: bool) -> range:
        """The kv tiles the kernel visits for q tile ``q_tile``: every tile
        up to the last holding an allowed (q, k) pair for a real row
        (causal: key <= row + sk - sq)."""
        return _live_kv(q_tile, self.q_rows, self.kv_tile, sq, sk, causal)


def _live_kv(q_block: int, q_rows: int, kv_tile: int, sq: int, sk: int,
             causal: bool) -> range:
    n = _cdiv(sk, kv_tile)
    if causal:
        hi = min((q_block + 1) * q_rows, sq) - 1 + sk - sq
        n = 0 if hi < 0 else min(n, hi // kv_tile + 1)
    return range(n)


def flash_fwd_regs(padded: int, kv: int, f32: bool, groups: int) -> int:
    """Registers of a forward multiplying thread (flash_fwd.cu
    ``Tile::regs``): O's accumulator over the group's columns, S of a kv
    tile, and P as the A operand (tf32 hi and lo in fp32)."""
    return padded // groups // 2 + kv // 2 + (kv if f32 else kv // 4)


class _WideFwd:
    """``Wide<T, kSC>`` of flash_fwd.cu, the forward's layout above head dim 256:
    kv tiles of ``kv`` keys (bf16 64, fp32 32); O's columns in groups of
    ``group`` = 256, one a block; S's contraction in slices of
    ``slice_chunks`` 128-byte chunks (2 where the head dim's ``chunks``
    pair up, else 1). A slice unit holds Q's q_rows rows and K's kv keys of
    the slice (fp32: then their tf32 lo), a V unit the group's columns of
    V's kv keys (fp32: then V^T as tf32 hi and lo, a 128-byte row per column
    for each 32 keys); a stage holds the larger."""

    group = 256

    def __init__(self, es: int, chunks: int):
        self.f32 = es == 4
        self.slice_chunks = 1 if chunks % 2 else 2
        self.kv = 32 if self.f32 else 64
        vt = _cdiv(self.kv, 32) * self.group * ROW_BYTES
        self.v_unit = (self.group * es // ROW_BYTES * self.kv * ROW_BYTES
                       + (2 * vt if self.f32 else 0))

    def stage(self, q_rows: int) -> int:
        qk = ((2 if self.f32 else 1) * self.slice_chunks
              * (q_rows + self.kv) * ROW_BYTES)
        return max(qk, self.v_unit)

    def smem(self, q_rows: int, stages: int) -> int:
        return 1024 + stages * self.stage(q_rows) + 256

    def fit(self, q_rows: int) -> int:
        return min(FLASH_MAX_STAGES,
                   (SMEM_MAX - self.smem(q_rows, 0)) // self.stage(q_rows))


@functools.lru_cache(maxsize=1024)
def flash_plan(sq: int, sk: int, d: int, dtype: torch.dtype) -> FlashPlan:
    """The tiling of ``flash_fwd.cu`` for head dim d (run as its class,
    :func:`flash_head_class`): kv tiles of 128 keys in bf16, 64 in fp32, 32
    for fp32 at class 128 and 16 at class 256 (its tf32 splits and V^T take
    five tiles' room a stage); O's columns in the fewest groups whose
    registers (:func:`flash_fwd_regs`) stay within FLASH_BWD_REG_BUDGET and
    whose one stage fits beside 64 q rows (2 at class 256, else 1); 128 q rows a block (two multiplying
    warpgroups) above Sq 64 where two stages fit beside them, else 64; as
    many stages as shared memory holds, up to FLASH_MAX_STAGES and the
    number of kv tiles, and one stage with serial passes where two do not
    fit beside 64 rows. Head dims above 256 take the wide mode
    (:class:`_WideFwd`): 128 q rows a block above Sq 64 where two stages
    fit beside them, else 64, and as many stages as shared memory holds, up
    to FLASH_MAX_STAGES. The kernel refuses a plan whose tile, groups or
    shared memory differs from its own layout. Cached per shape."""
    dc = flash_head_class(d)
    es = 2 if dtype == torch.bfloat16 else 4
    f32 = es == 4
    chunks = _cdiv(dc * es, ROW_BYTES)
    if dc > FLASH_HEAD_DIMS[-1]:
        wide = _WideFwd(es, _cdiv(d * es, ROW_BYTES))
        q_rows = 64 if sq <= 64 or wide.fit(128) < 2 else 128
        stages = wide.fit(q_rows)
        slices = _cdiv(d * es, ROW_BYTES) // wide.slice_chunks
        return FlashPlan(q_rows, wide.kv, stages, wide.smem(q_rows, stages),
                         chunks, _cdiv(d, wide.group), False, slices)
    padded = chunks * (ROW_BYTES // es)   # D padded to whole chunks
    kv = ({128: 32, 256: 16}.get(dc, 64)) if f32 else 128
    kv_bytes = chunks * kv * ROW_BYTES    # one K tile as it lands

    def stage_bytes(groups: int) -> int:
        # K, the group's columns of V; fp32: K's lo, V^T's hi and lo (a
        # 128-byte row per column for each 32 keys)
        vt = _cdiv(kv, 32) * padded // groups * ROW_BYTES
        return (kv_bytes + kv_bytes // groups
                + (kv_bytes + 2 * vt if f32 else 0))

    def smem_of(q_rows: int, stages: int, stage: int) -> int:
        return (1024 + chunks * q_rows * ROW_BYTES * (2 if f32 else 1)
                + stages * stage + 256)

    # the fewest groups whose registers fit the budget and whose stage fits
    # beside 64 q rows (fp32 at class 256: 2, for shared memory)
    groups = 1
    while (flash_fwd_regs(padded, kv, f32, groups) > FLASH_BWD_REG_BUDGET
           or smem_of(64, 1, stage_bytes(groups)) > SMEM_MAX):
        groups *= 2
    stage = stage_bytes(groups)

    def smem(q_rows: int, stages: int) -> int:
        return smem_of(q_rows, stages, stage)

    def fit(q_rows: int) -> int:
        return min(FLASH_MAX_STAGES, (SMEM_MAX - smem(q_rows, 0)) // stage)

    serial = fit(64) < 2
    q_rows = 64 if sq <= 64 or fit(128) < 2 else 128
    stages = 1 if serial else max(1, min(fit(q_rows), _cdiv(sk, kv)))
    return FlashPlan(q_rows, kv, stages, smem(q_rows, stages), chunks,
                     groups, serial)


@dataclass(frozen=True)
class BwdKernelPlan:
    """How one kernel of ``csrc/flash_bwd.cu`` cuts its work: blocks of
    ``rows`` (q rows for dQ, keys for dK/dV; one multiplying warpgroup per
    64) and one of ``groups`` groups of the output's columns (each block
    recomputes S and dP over the whole head dim), the other side streamed
    in tiles of ``tile`` (keys for dQ, q rows for dK/dV) through a ring of
    ``stages``, the block's shared memory in bytes (``smem``), and
    ``regs``, the registers a multiplying thread gives to its accumulators,
    S and dP fragments and A operands at that tile. ``slices``: 0 where the
    kernel holds the contraction over the head dim whole; else the kernel
    runs its wide mode (dQ :class:`_WideDq`, dK/dV :class:`_WideBwd`):
    64-row blocks whose two multiplying warpgroups take two of ``groups``
    groups of FLASH_GROUP output columns, the contraction streamed through
    the ring in ``slices`` slices of one 128-byte chunk (dQ) or of one or
    two (dK/dV) for each streamed tile."""
    rows: int
    tile: int
    stages: int
    smem: int
    regs: int
    groups: int = 1
    slices: int = 0


class _WideBwd:
    """``WideBwd<T, kSC>`` of flash_bwd.cu, the dK/dV kernel's layout above
    head dim 256 and in fp32 above 128: blocks of 64 keys, each multiplying
    warpgroup one group of ``group`` = 128 of dK's and dV's columns (two a
    block); q tiles of ``tile`` rows (bf16 32, fp32 16, by the register
    budget); each q tile as its slices of ``slice_chunks`` 128-byte chunks
    (2 where the head dim's ``chunks`` pair up, else 1: Q's and dO's tile
    rows, after K's and V's 64 rows where those are not held for the block;
    fp32: then their tf32 lo) and one group unit a warpgroup (Q's and dO's
    group columns; fp32: then Q^T and dO^T as tf32 hi and lo); a stage
    holds the larger, beside its q tile's lse and delta; the two
    warpgroups' S^T and dP^T fragments are exchanged through shared memory.
    K and V are held where two stages fit beside them (bf16 up to 11
    chunks)."""

    group = FLASH_GROUP

    def __init__(self, es: int, chunks: int):
        self.f32 = es == 4
        self.chunks = chunks
        self.slice_chunks = 1 if chunks % 2 else 2
        self.tile = 16 if self.f32 else 32
        group_chunks = self.group * es // ROW_BYTES
        t_part = _cdiv(self.tile, 32) * self.group * ROW_BYTES
        self.group_unit = (2 * group_chunks * self.tile * ROW_BYTES
                           + (4 * t_part if self.f32 else 0))
        self.exchange = 2 * 64 * self.tile * 4
        # dK's and dV's group, S^T and dP^T, P^T and dS^T as A operands
        self.regs = self.group + self.tile + (
            2 * self.tile if self.f32 else self.tile // 2)

    def stage(self, held: bool) -> int:
        unit = ((2 if self.f32 else 1) * self.slice_chunks * 2
                * (self.tile + (0 if held else 64)) * ROW_BYTES)
        return max(unit, self.group_unit)

    def smem(self, held: bool, stages: int) -> int:
        kv = 2 * self.chunks * 64 * ROW_BYTES if held else 0
        return (1024 + kv + stages * (self.stage(held) + 8 * self.tile)
                + self.exchange + 256)

    @property
    def held(self) -> bool:
        return not self.f32 and self.smem(True, 2) <= SMEM_MAX

    def fit(self) -> int:
        return min(FLASH_MAX_STAGES, (SMEM_MAX - self.smem(self.held, 0))
                   // (self.stage(self.held) + 8 * self.tile))


class _WideDq:
    """``WideDq<T>`` of flash_bwd.cu, the dQ kernel's layout above head dim
    256 and in fp32 above 128 (the dK/dV wide mode turned around): blocks
    of 64 q rows, each multiplying warpgroup one group of ``group`` = 128
    of dQ's columns (two a block); kv tiles of ``tile`` keys, the largest
    power of two up to 128 whose registers (:meth:`regs_at`: dQ's group,
    the slice product, S and dP after the exchange, dS as A operand) stay
    within FLASH_BWD_REG_BUDGET (bf16 64, fp32 32); each kv tile as its
    slices of ``slice_chunks`` = 1 128-byte chunk of d (K's and V's tile
    rows, after Q's and dO's 64 rows where those are not held for the
    block; fp32: then their tf32 lo), and one group unit a warpgroup (K's
    group columns; fp32: then K_g^T as tf32 hi and lo, a 128-byte row per
    column for each 32 keys); a stage holds the larger; the two
    warpgroups' S and dP fragments are exchanged through shared memory. Q
    and dO are held where two stages fit beside them (bf16 up to 10
    chunks)."""

    group = FLASH_GROUP
    slice_chunks = 1

    def __init__(self, es: int, chunks: int):
        self.f32 = es == 4
        self.chunks = chunks
        self.tile = 128
        while self.tile > 16 and self.regs_at(self.tile) > FLASH_BWD_REG_BUDGET:
            self.tile //= 2
        self.regs = self.regs_at(self.tile)
        group_chunks = self.group * es // ROW_BYTES
        t_part = _cdiv(self.tile, 32) * self.group * ROW_BYTES
        self.group_unit = (group_chunks * self.tile * ROW_BYTES
                           + (2 * t_part if self.f32 else 0))
        self.exchange = 2 * 64 * self.tile * 4

    def regs_at(self, n: int) -> int:
        return self.group // 2 + n // 2 + n + (n if self.f32 else n // 4)

    def stage(self, held: bool) -> int:
        unit = ((2 if self.f32 else 1) * self.slice_chunks * 2
                * (self.tile + (0 if held else 64)) * ROW_BYTES)
        return max(unit, self.group_unit)

    def smem(self, held: bool, stages: int) -> int:
        qo = 2 * self.chunks * 64 * ROW_BYTES if held else 0
        return (1024 + qo + stages * self.stage(held) + self.exchange
                + 256)

    @property
    def held(self) -> bool:
        return not self.f32 and self.smem(True, 2) <= SMEM_MAX

    def fit(self) -> int:
        return min(FLASH_MAX_STAGES, (SMEM_MAX - self.smem(self.held, 0))
                   // self.stage(self.held))


class _BwdLayout:
    """``BwdTile`` of flash_bwd.cu for a head-dim class and element size."""

    def __init__(self, dc: int, es: int):
        self.f32 = es == 4
        self.chunks = _cdiv(dc * es, ROW_BYTES)
        self.padded = self.chunks * (ROW_BYTES // es)

    def regs(self, dq: bool, n: int, groups: int = 1) -> int:
        acc = (self.padded // 2 if dq else self.padded) // groups
        ops = (n if dq else 2 * n) if self.f32 else (n // 4 if dq else n // 2)
        return acc + n + ops

    def groups(self, dq: bool) -> int:
        """The fewest column groups with which a 16-row tile fits the
        register budget: 1 at every class up to 128, 2 for dK/dV at 256."""
        g = 1
        while self.regs(dq, 16, g) > FLASH_BWD_REG_BUDGET:
            g *= 2
        return g

    def reg_tile(self, dq: bool) -> int:
        n, g = 128, self.groups(dq)
        while n > 16 and self.regs(dq, n, g) > FLASH_BWD_REG_BUDGET:
            n //= 2
        return n

    def stage(self, dq: bool, n: int) -> int:
        if not self.f32:
            return 2 * self.chunks * n * ROW_BYTES
        # a transposed part of the group's columns
        t_bytes = _cdiv(n, 32) * self.padded // self.groups(dq) * ROW_BYTES
        return 4 * self.chunks * n * ROW_BYTES + (2 if dq else 4) * t_bytes

    def smem(self, dq: bool, rows: int, n: int, stages: int) -> int:
        fixed = 2 * (2 if self.f32 else 1) * self.chunks * rows * ROW_BYTES
        return (1024 + fixed + stages * self.stage(dq, n)
                + (0 if dq else stages * 8 * n) + 256)

    def tile(self, dq: bool) -> int:
        n = self.reg_tile(dq)
        while n >= 16:
            if self.smem(dq, 64, n, 2) <= SMEM_MAX:
                return n
            n //= 2
        return self.reg_tile(dq)


@dataclass(frozen=True)
class FlashBwdPlan:
    """The tiling of both kernels of ``csrc/flash_bwd.cu`` for one shape:
    ``dq`` and ``dkv`` (:class:`BwdKernelPlan`), each row of the head-dim
    class in ``chunks`` 128-byte chunks, ``padded`` columns in all."""
    dq: BwdKernelPlan
    dkv: BwdKernelPlan
    chunks: int
    padded: int

    def kv_tiles(self, q_block: int, sq: int, sk: int, causal: bool) -> range:
        """The kv tiles the dQ kernel visits for q block ``q_block``: every
        tile up to the last holding an allowed pair for a real row."""
        return _live_kv(q_block, self.dq.rows, self.dq.tile, sq, sk, causal)

    def q_tiles(self, kv_block: int, sq: int, sk: int, causal: bool) -> range:
        """The q tiles the dK/dV kernel visits for kv block ``kv_block``:
        every tile from the first whose last row may see the block's first
        key (causal: key <= row + sk - sq)."""
        n, lo = _cdiv(sq, self.dkv.tile), 0
        if causal:
            first = kv_block * self.dkv.rows - (sk - sq) - (self.dkv.tile - 1)
            lo = 0 if first <= 0 else min(n, _cdiv(first, self.dkv.tile))
        return range(lo, n)


@functools.lru_cache(maxsize=1024)
def flash_bwd_plan(sq: int, sk: int, d: int, dtype: torch.dtype
                   ) -> FlashBwdPlan:
    """The tiling of ``flash_bwd.cu`` for head dim d (run as its class,
    :func:`flash_head_class`). Each kernel produces its output in the
    fewest column groups with which a tile fits the register budget
    (:meth:`_BwdLayout.groups`) and streams tiles of the largest power of
    two up to 128 whose registers (:meth:`_BwdLayout.regs`) stay within
    FLASH_BWD_REG_BUDGET, halved further while two stages would not fit
    beside a 64-row block (kept where no tile would); blocks of 128 rows
    (two multiplying warpgroups) where its own side exceeds 256 and two
    stages fit, else 64 (below that a block's latency, not the card's
    throughput, sets the time, and smaller blocks are more of them); as
    many stages as shared memory holds, up to FLASH_MAX_STAGES and the
    number of streamed tiles. Where not one stage fits beside a 64-row
    block (fp32 above class 128, whose fixed operands alone, Q and dO or K
    and V as tf32 hi and lo: 4 x 64 rows x 1 KB, fill 256 KB) and above
    class 256 both kernels run their wide modes (:class:`_WideDq`,
    :class:`_WideBwd`; blocks of 64 rows, outputs in groups of FLASH_GROUP
    columns, as many stages as shared memory holds, up to
    FLASH_MAX_STAGES). The kernels refuse a plan that differs from their
    own layout. Cached per shape."""
    dc = flash_head_class(d)
    es = 2 if dtype == torch.bfloat16 else 4
    lay = _BwdLayout(dc, es)

    def part(dq: bool, own: int, other: int) -> BwdKernelPlan:
        if dc > FLASH_HEAD_DIMS[-1] or lay.smem(dq, 64, lay.tile(dq),
                                                1) > SMEM_MAX:
            wide = (_WideDq if dq else _WideBwd)(es, _cdiv(d * es, ROW_BYTES))
            stages = wide.fit()
            return BwdKernelPlan(
                64, wide.tile, stages, wide.smem(wide.held, stages),
                wide.regs, _cdiv(d, wide.group),
                wide.chunks // wide.slice_chunks)
        n = lay.tile(dq)
        per_stage = lay.smem(dq, 0, n, 1) - lay.smem(dq, 0, n, 0)

        def fit(rows: int) -> int:
            return min(FLASH_MAX_STAGES,
                       (SMEM_MAX - lay.smem(dq, rows, n, 0)) // per_stage)

        rows = 64 if own <= 256 or fit(128) < 2 else 128
        stages = max(1, min(fit(rows), _cdiv(other, n)))
        return BwdKernelPlan(rows, n, stages, lay.smem(dq, rows, n, stages),
                             lay.regs(dq, n, lay.groups(dq)), lay.groups(dq))

    return FlashBwdPlan(part(True, sq, sk), part(False, sk, sq), lay.chunks,
                        lay.padded)


def _check_attention(fn: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *like_q: torch.Tensor) -> None:
    """What every flash kernel takes: contiguous, 16-byte aligned CUDA
    tensors q (B, H, Sq, D), k and v (B, H, Sk, D), and ``like_q`` (dO)
    shaped as q, all of one dtype of FLASH_DTYPES; D >= 1 with rows of
    whole 16-byte units (:func:`flash_head_width`); B*H >= 1 and a grid of
    B*H x row tiles x column groups below 2^31 blocks."""
    for name, t in (("q", q), ("k", k), ("v", v),
                    *(("dO", t) for t in like_q)):
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
        if t.data_ptr() % 16:  # TMA copies from 16-byte aligned rows
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")
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
    if d < 1 or flash_head_width(d, q.dtype) != d:
        raise ValueError(f"{fn}: head dim {d} does not have rows of whole "
                         f"16-byte units")
    if not (b * h >= 1 and sq >= 1 and sk >= 1):
        raise ValueError(f"{fn}: need B*H >= 1 and non-empty sequences, got "
                         f"B*H={b * h}, Sq={sq}, Sk={sk}")
    _check_grid(fn, b * h, sq, sk, d)


def _check_grid(fn: str, bh: int, sq: int, sk: int, d: int) -> None:
    """The most blocks a flash kernel's 1-d grid takes for this shape, one
    per (batch*head, tile of 64 rows, group of 128 columns), below 2^31."""
    groups = _cdiv(flash_head_class(d), FLASH_GROUP)
    blocks = bh * _cdiv(max(sq, sk), 64) * groups
    if blocks >= 2 ** 31:
        raise ValueError(f"{fn}: the grid would overflow: B*H={bh} x "
                         f"{_cdiv(max(sq, sk), 64)} tiles of 64 rows x "
                         f"{groups} column groups = {blocks} blocks, the "
                         f"1-d grid takes fewer than 2^31")


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
    """Launch ``csrc/flash_fwd.cu`` on contiguous, 16-byte aligned CUDA
    tensors q (B, H, Sq, D), k and v (B, H, Sk, D) of fp32 or bf16, any D
    in whole 16-byte units, tiled by :func:`flash_plan` (above 256 the
    wide mode). Returns (O
    like q, logsumexp (B, H, Sq) fp32). Raises on anything the kernel does
    not take."""
    out = _launch_flash(q, k, v, causal, scale)
    flash_fwd.launches += 1
    return out


def _launch_flash(q, k, v, causal: bool, scale: float,
                  lib_name: str = "flash_fwd.cu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the build ``lib_name`` of ``csrc/flash_fwd.cu``; see
    :func:`flash_fwd`."""
    _check_attention("flash_fwd", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    plan = flash_plan(sq, sk, d, q.dtype)
    lib = build(extra=(lib_name,))[lib_name]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b * h, sq, sk, d, int(causal), float(scale),
                bf16)
        err = lib.dcnn_flash_fwd(*args, plan.q_rows, plan.kv_tile,
                                 plan.stages, plan.smem, plan.groups, stream)
    _raise_on(lib, "flash_fwd", err)
    return o, lse


flash_fwd.launches = 0


def _launch_flash_bwd(fn: str, q, k, v, do, lse, delta, outs, causal: bool,
                      scale: float, lib_name: str = "flash_bwd.cu") -> None:
    """Launch kernel ``fn`` (flash_bwd_dq or flash_bwd_dkv) of the build
    ``lib_name`` of ``csrc/flash_bwd.cu`` into ``outs``."""
    _check_attention(fn, q, k, v, do)
    _check_rows(fn, q, lse=lse, delta=delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    plan = flash_bwd_plan(sq, sk, d, q.dtype)
    part = plan.dq if fn == "flash_bwd_dq" else plan.dkv
    lib = build(extra=(lib_name,))[lib_name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                *(t.data_ptr() for t in outs), b * h, sq, sk, d, int(causal),
                float(scale), int(q.dtype == torch.bfloat16))
        err = getattr(lib, "dcnn_" + fn)(
            *args, part.rows, part.tile, part.stages, part.smem, part.groups,
            stream)
    _raise_on(lib, fn, err)


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 causal: bool, scale: float) -> torch.Tensor:
    """Launch the dQ kernel of ``csrc/flash_bwd.cu``: q and the output
    cotangent ``do`` (B, H, Sq, D), k and v (B, H, Sk, D), contiguous,
    16-byte aligned CUDA tensors of fp32 or bf16 (D as :func:`flash_fwd`
    takes it), tiled by :func:`flash_bwd_plan`; ``lse`` the forward's
    logsumexp and ``delta`` = rowsum(dO * O), both (B, H, Sq) fp32. Returns
    dQ like q. Above D 256, and above 128 in fp32, its wide mode runs
    (:func:`flash_bwd_plan`)."""
    dq = torch.empty_like(q)
    _launch_flash_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
                      causal, scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of ``csrc/flash_bwd.cu`` on the inputs
    :func:`flash_bwd_dq` takes (above D 256, and above 128 in fp32, its
    wide mode). Returns (dK like k, dV like v)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_flash_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv),
                      causal, scale)
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


CARD_SMS = 132         # H100 SXM; the wrappers pass the card's own count


@dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/conv3x3_tc.cu`` cuts one conv: output tiles of b images ×
    th rows × tw output columns (128·mw of them: mw 64-row slabs per
    multiplying warpgroup) by ``bn`` output channels, and K (``units`` =
    ``taps`` × ⌈Cin / chunk⌉ Cin chunks of 128 bytes) split in ``ksplit``
    ranges across blocks. The pairs form (``taps`` 12) counts its output
    columns in pairs of pixels and its channels in the 2·Cout lanes; its
    halo box is 2·tw + 2 input columns wide."""
    b: int
    th: int
    tw: int
    mw: int
    bn: int
    ksplit: int
    chunk: int         # channels per staged 128-byte row: 64 bf16, 32 fp32
    units: int
    tiles_m: int
    tiles_n: int
    halo_rows: int
    taps: int = 9      # 9, or 12 in the pairs form

    @property
    def step(self) -> int:
        """Input columns per output column: 1, or 2 in the pairs form."""
        return 2 if self.taps == 12 else 1

    def k_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Each split's units [u0, u1) as the kernel computes them (unit u
        is Cin chunk u // taps at tap u % taps)."""
        return tuple((k * self.units // self.ksplit,
                      (k + 1) * self.units // self.ksplit)
                     for k in range(self.ksplit))

    def describe(self) -> str:
        what = "pairs" if self.taps == 12 else "pixels"
        return (f"tile {self.b}x{self.th}x{self.tw} {what}, Cout tile "
                f"{self.bn}, {self.tiles_m}x{self.tiles_n} tiles, K split "
                f"{self.ksplit} of {self.units} units")


def _tiling(n: int, h: int, w: int, pixels: int, step: int = 1):
    """(tiles, b, th, tw, halo rows) of the power-of-two tile (tw, th) with
    b = pixels/(th·tw) images that stages the fewest halo rows in all
    (tiles × b (th+2)(step·tw+2)), wider first on a tie; w counts output
    columns, each ``step`` input columns wide. None where no tile keeps
    its halo within MAX_HALO_ROWS."""
    best = None
    for tw in (1 << i for i in range(9)):
        for th in (1 << i for i in range(9)):
            if tw * th > pixels:
                continue
            b = pixels // (tw * th)
            rows = b * (th + 2) * (step * tw + 2)
            if rows > MAX_HALO_ROWS:
                continue
            tiles = _cdiv(n, b) * _cdiv(h, th) * _cdiv(w, tw)
            key = (tiles * rows, -tw, -th)
            if best is None or key < best[0]:
                best = (key, (tiles, b, th, tw, rows))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=1024)
def conv_plan(n: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype, sms: int = CARD_SMS, *,
              prologue: bool = False, pairs: bool = False) -> ConvPlan:
    """The tiling of ``conv3x3_tc.cu`` for an (n, h, w, cin) -> cout conv
    (``prologue``: the BN-prologue conv; ``pairs``: the output-column-pair
    form, w even, whose output columns are the w/2 pairs and whose
    channels are the 2·cout lanes of the fused weights): tiles of 64
    channels up to 64, else 128; output tiles of 256 columns where they
    alone fill ``sms`` SMs (the bf16 conv without the prologue, whose
    warps would set the pace over a 256-pixel halo; no 256-pair tile keeps
    its halo within MAX_HALO_ROWS), else of 128 (see :func:`_tiling`); and
    where the tiles are fewer than ``sms``, K split in ⌊sms / tiles⌋
    ranges (at most one per unit), so the work items fill the card in one
    wave. Cached: a call reuses the plan of an earlier one with the same
    arguments."""
    chunk = ROW_BYTES // (2 if dtype == torch.bfloat16 else 4)
    step, taps = (2, 12) if pairs else (1, 9)
    wo, lanes = w // step, cout * step
    bn = 64 if lanes <= 64 else 128
    tiles_n = _cdiv(lanes, bn)
    mw = 1
    tiles_m, b, th, tw, rows = _tiling(n, h, wo, TILE_PIXELS, step)
    if dtype == torch.bfloat16 and not prologue and not pairs:
        big = _tiling(n, h, wo, 2 * TILE_PIXELS)
        if big[0] * tiles_n >= sms:
            mw, (tiles_m, b, th, tw, rows) = 2, big
    units = taps * _cdiv(cin, chunk)
    tiles = tiles_m * tiles_n
    ksplit = 1 if tiles >= sms else min(units, sms // tiles)
    return ConvPlan(b, th, tw, mw, bn, ksplit, chunk, units, tiles_m,
                    tiles_n, rows, taps)


_sms: Dict[int, int] = {}


def _card_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _copy_unit(x: torch.Tensor) -> int:
    """How the kernel stages x: 0 for TMA (a row of Cin and the base
    16-byte aligned), else the widest cp.async unit both allow (2: plain
    loads, bf16 with odd Cin)."""
    row = x.shape[3] * x.element_size()
    for unit in (16, 8, 4, 2):
        if row % unit == 0 and x.data_ptr() % unit == 0:
            return 0 if unit == 16 else unit
    raise ValueError(f"x of {x.dtype} is not {x.element_size()}-byte aligned")


def _launch_conv(fn: str, x, w, scale, shift, out_dtype,
                 lib_name: str = "conv3x3_tc.cu", pairs: bool = False
                 ) -> torch.Tensor:
    """Launch ``csrc/conv3x3_tc.cu`` (the build ``lib_name``) on x (N, H,
    W, Cin) and w (3, 3, Cin, Cout), with the BN prologue where ``scale``
    and ``shift`` are given; or, with ``pairs``, on W even and the fused
    weights w (3, 4, Cin, 2·Cout). The packed weights and, for a K split,
    the fp32 partial sums are scratch allocated here."""
    n, h, wd, cin, cout = _check_conv(fn, x, w, 4 if pairs else 3,
                                      2 if pairs else 1, out_dtype)
    if pairs and wd % 2:
        raise ValueError(f"{fn}: W={wd} must be even")
    sms = _card_sms(x.device)
    plan = conv_plan(n, h, wd, cin, cout, x.dtype, sms,
                     prologue=scale is not None, pairs=pairs)
    parts = 1 if x.dtype == torch.bfloat16 else 2  # fp32: tf32 hi and lo
    kp = plan.units // plan.taps * plan.chunk  # Cin padded to whole chunks
    wpack = torch.empty(plan.taps * parts * plan.tiles_n * plan.bn * kp,
                        dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.ksplit, n, h, wd, cout), dtype=torch.float32,
                      device=x.device) if plan.ksplit > 1 else None)
    lib = build(extra=(lib_name,))[lib_name]
    out = torch.empty((n, h, wd, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.dcnn_conv3x3_tc(
            x.data_ptr(), w.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), out.data_ptr(),
            wpack.data_ptr(), None if ws is None else ws.data_ptr(), n, h, wd,
            cin, cout, plan.b, plan.th, plan.tw, plan.bn, plan.ksplit,
            _copy_unit(x), int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(pairs), sms,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, fn, err)
    return out


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, *,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the plain 3×3 stride-1 SAME conv of ``csrc/conv3x3_tc.cu``
    on contiguous CUDA tensors x (N, H, W, Cin) and w (3, 3, Cin, Cout) of
    one dtype of CONV_DTYPES. Returns (N, H, W, Cout) of ``out_dtype``."""
    out = _launch_conv("conv3x3_s1", x, w, None, None, out_dtype)
    conv3x3_s1.launches += 1
    return out


def conv3x3_s1_bnrelu_in(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, *,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the conv of ``csrc/conv3x3_tc.cu`` with
    ``relu(x·scale+shift)`` applied to each staged input chunk; ``scale``
    and ``shift`` contiguous fp32 (Cin,) on x's device. Otherwise as
    :func:`conv3x3_s1`."""
    cin = x.shape[-1] if x.ndim == 4 else -1
    for name, t in (("scale", scale), ("shift", shift)):
        if (t.shape != (cin,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"conv3x3_s1_bnrelu_in: {name} must be "
                             f"contiguous fp32 ({cin},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = _launch_conv("conv3x3_s1_bnrelu_in", x, w, scale, shift,
                          out_dtype)
    conv3x3_s1_bnrelu_in.launches += 1
    return out


def conv3x3_s1_pairs(x: torch.Tensor, w2: torch.Tensor, *,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the output-column-pair form of ``csrc/conv3x3_tc.cu`` on
    contiguous CUDA tensors x (N, H, W, Cin), W even, and fused weights w2
    (3, 4, Cin, 2·Cout), read as given (all 12 taps and 2·Cout lanes; any
    w2, not only ``fuse_pair_weights``'). Returns (N, H, W, Cout) of
    ``out_dtype``."""
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


# conv_int8.cu's tiling: tiles of 128 output pixels (two 64-row wgmma
# slabs) by 64 or 128 output channels, K in chunks of 128 bytes (one
# 128-byte swizzled row a pixel and a channel), a ring of up to
# INT8_MAX_STAGES stages; the input types it takes (mode A int8, mode B
# fp32 and bf16) and their codes
INT8_TILE_M = 128
INT8_CHUNK = 128
INT8_MAX_STAGES = 4
# the most shared memory a halo buffer takes (the tile's input box,
# quantized once a slice of channels; the block holds two beside a ring
# of 4 stages: 2 x 48 KB + 4 x 32 KB at BN 128)
INT8_HALO_MAX = 49152
INT8_IN_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def int8_slice(c: int) -> int:
    """The channels of one K slice of conv_int8.cu for C input channels: C,
    or 128 where C is a larger multiple of 128 (a slice's taps then fill
    whole 128-byte chunks, one tap each)."""
    return INT8_CHUNK if c > INT8_CHUNK and c % INT8_CHUNK == 0 else c


def int8_halo_bytes(n: int, c: int, h: int, w: int, r: int, s: int, stride,
                    pad) -> int:
    """The largest halo box over the 128-pixel tiles of this conv, in bytes
    (int8, one slice of channels, :func:`int8_slice`): as the kernel's
    ``halo_box`` cuts it, the input rows a tile's output rows read (all of
    them where the tile spans images) of every image it spans, all
    columns."""
    (sh, sw), (ph, pw) = _int_pair(stride), _int_pair(pad)
    p = (h + 2 * ph - r) // sh + 1
    q = (w + 2 * pw - s) // sw + 1
    m, pq = n * p * q, p * q
    m0 = torch.arange(0, m, INT8_TILE_M, dtype=torch.int64)
    m1 = torch.clamp(m0 + INT8_TILE_M, max=m) - 1
    n0, n1 = m0 // pq, m1 // pq
    one = n0 == n1
    lo = torch.where(one, (m0 - n0 * pq) // q * sh - ph, torch.full_like(m0, -ph))
    hi = torch.where(one, (m1 - n1 * pq) // q * sh - ph + r - 1,
                     torch.full_like(m0, (p - 1) * sh - ph + r - 1))
    rows = torch.clamp(torch.clamp(hi, max=h - 1) - torch.clamp(lo, min=0) + 1,
                       min=0)
    return int(((n1 - n0 + 1) * rows).max()) * w * int8_slice(c)


def int8_cout_tile(o: int) -> int:
    """The output channels of one conv_int8.cu tile for O channels: 64 up
    to 64, else 128."""
    return 64 if o <= 64 else 128


def int8_smem(bn: int, stages: int, halo: int = 0) -> int:
    """Shared memory of a conv_int8.cu block in bytes (the kernel's
    ``smem_bytes``): 1024 of alignment slack, per stage a 128 x 128-byte A
    tile and a bn x 128-byte weight tile, two halo buffers of ``halo``
    bytes (one per copying warpgroup), 256 for the barriers."""
    return 1024 + stages * (INT8_TILE_M + bn) * INT8_CHUNK + 2 * halo + 256


@dataclass(frozen=True)
class ConvInt8Plan:
    """How ``csrc/conv_int8.cu`` cuts one conv: ``tiles_m`` tiles of 128
    output pixels by ``tiles_n`` tiles of ``bn`` output channels, K in
    ``chunks`` chunks of 128 bytes (slices of :func:`int8_slice` channels,
    each whole chunks) split in ``ksplit`` ranges across blocks, a ring of
    ``stages`` stages (``smem`` bytes a block), and how the A tile is
    copied: ``"vec"`` (16-byte units of 16 neighbouring channels:
    channels-last, C a multiple of 16) or ``"gather"`` (value by value
    through the strides), from x itself (``halo`` 0) or from the tile's
    halo, loaded and quantized once a slice into one of two ``halo``-byte
    buffers (float input and kernels of more than one tap whose boxes fit
    INT8_HALO_MAX)."""
    bn: int
    stages: int
    ksplit: int
    copy: str
    smem: int
    tiles_m: int
    tiles_n: int
    chunks: int
    halo: int = 0

    @property
    def works(self) -> int:
        return self.tiles_m * self.tiles_n * self.ksplit

    def k_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Each split's chunks [c0, c1) as the kernel computes them."""
        return tuple((k * self.chunks // self.ksplit,
                      (k + 1) * self.chunks // self.ksplit)
                     for k in range(self.ksplit))

    def describe(self) -> str:
        return (f"{self.tiles_m}x{self.tiles_n} tiles of 128x{self.bn}, K "
                f"split {self.ksplit} of {self.chunks} chunks, "
                f"{self.stages} stages, {self.copy} copies from "
                + (f"a {self.halo}-byte halo" if self.halo else "x"))


def _int_pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


@functools.lru_cache(maxsize=4096)
def conv_int8_plan(n: int, c: int, h: int, w: int, o: int, r: int, s: int,
                   stride, pad, in_dtype: torch.dtype, sms: int = CARD_SMS,
                   *, channels_last: bool = True,
                   ksplit: Optional[int] = None) -> ConvInt8Plan:
    """The tiling of ``conv_int8.cu`` for an (n, c, h, w) input, O output
    channels, an r x s kernel, ``stride`` and symmetric ``pad`` (ints or
    pairs) and input type ``in_dtype`` (int8: mode A; fp32, bf16: mode B):
    channel tiles of :func:`int8_cout_tile`; a ring as deep as shared
    memory holds, up to INT8_MAX_STAGES; where the tiles are fewer than
    ``sms``, K split in min(chunks, sms // tiles) ranges, so the work items
    fill the card in one wave and no range is empty (``ksplit`` forces a
    split, 1 none); 16-byte unit copies where ``channels_last`` (the
    caller's test: channel stride 1 and the other strides and the base
    16-byte aligned) and C % 16 == 0, else the gather; the halo copies for
    float input (mode B, whose values are quantized once a tile there
    rather than once a tap) where the kernel has more than one tap and the
    largest box (:func:`int8_halo_bytes`, rounded up to 1024) fits
    INT8_HALO_MAX (then a ring of 4, 2 stages for each copying
    warpgroup); int8 input is read straight from x, two stages in flight.
    Cached."""
    (sh, sw), (ph, pw) = _int_pair(stride), _int_pair(pad)
    if in_dtype not in INT8_IN_TYPES:
        raise TypeError(f"conv_int8_plan: input type {in_dtype} not in "
                        f"{tuple(INT8_IN_TYPES)}")
    p = (h + 2 * ph - r) // sh + 1
    q = (w + 2 * pw - s) // sw + 1
    if min(n, c, o, r, s, sh, sw, p, q) < 1 or min(ph, pw) < 0:
        raise ValueError(f"conv_int8_plan: empty or invalid conv: x ({n}, "
                         f"{c}, {h}, {w}), {o} channels, kernel {r}x{s}, "
                         f"stride {stride}, pad {pad}")
    bn = int8_cout_tile(o)
    tiles_m, tiles_n = _cdiv(n * p * q, INT8_TILE_M), _cdiv(o, bn)
    cs = int8_slice(c)
    chunks = c // cs * _cdiv(r * s * cs, INT8_CHUNK)
    halo = 0
    if r * s > 1 and in_dtype != torch.int8:
        halo = _cdiv(int8_halo_bytes(n, c, h, w, r, s, (sh, sw), (ph, pw)),
                     1024) * 1024
        halo = halo if halo <= INT8_HALO_MAX else 0
    per_stage = int8_smem(bn, 1) - int8_smem(bn, 0)
    stages = min(INT8_MAX_STAGES,
                 (SMEM_MAX - int8_smem(bn, 0, halo)) // per_stage)
    if halo and stages < 4:  # a half of 2 stages for each copying warpgroup
        halo = 0
        stages = min(INT8_MAX_STAGES, (SMEM_MAX - int8_smem(bn, 0)) // per_stage)
    tiles = tiles_m * tiles_n
    if ksplit is None:
        ksplit = 1 if tiles >= sms else min(chunks, sms // tiles)
    if not 1 <= ksplit <= chunks:
        raise ValueError(f"conv_int8_plan: K split {ksplit} outside 1.."
                         f"{chunks} chunks")
    copy = "vec" if channels_last and c % 16 == 0 else "gather"
    return ConvInt8Plan(bn, stages, ksplit, copy, int8_smem(bn, stages, halo),
                        tiles_m, tiles_n, chunks, halo)


def pack_int8_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW int8 weights as ``csrc/conv_int8.cu`` reads them: (Opad, Kp),
    row o in slices of cs = :func:`int8_slice` (Cin) input channels, each
    slice its (kh, kw, channel) taps in that order, zero-padded to whole
    INT8_CHUNK chunks (Kp their sum), and zero rows past O up to Opad
    (whole channel tiles, :func:`int8_cout_tile`), so the kernel's weight
    copies never leave the tensor. ``pack_int8_weight.calls`` counts the
    packs (not a kernel: PyTorch copies)."""
    pack_int8_weight.calls += 1
    o, c, r, s = w.shape
    cs = int8_slice(c)
    kslice = r * s * cs
    kpad = _cdiv(kslice, INT8_CHUNK) * INT8_CHUNK
    opad = _cdiv(o, int8_cout_tile(o)) * int8_cout_tile(o)
    wk = w.new_zeros((opad, c // cs, kpad))
    wk[:o, :, :kslice] = (w.reshape(o, c // cs, cs, r, s)
                          .permute(0, 1, 3, 4, 2).reshape(o, c // cs, kslice))
    return wk.reshape(opad, -1)


def _check_int8(fn: str, x: torch.Tensor, w: torch.Tensor, stride, padding,
                data_format: str, in_dtypes) -> Tuple[torch.Tensor, int, int]:
    """x (NCHW or NHWC, any strides) of ``in_dtypes`` and OIHW int8 w on
    one CUDA device; returns (x's logical NCHW view, P, Q)."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not on "
                             f"{x.device} (CUDA)")
    if x.dtype not in in_dtypes or x.ndim != 4:
        raise TypeError(f"{fn}: x must be a 4-D tensor of "
                        f"{tuple(in_dtypes)}, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if w.dtype != torch.int8 or w.ndim != 4:
        raise TypeError(f"{fn}: w must be a 4-D int8 tensor, got {w.dtype} "
                        f"{tuple(w.shape)}")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"{fn}: unsupported data_format {data_format!r}")
    # the logical (N, C, H, W) view and its strides, whatever the layout
    xl = x if data_format == "NCHW" else x.permute(0, 3, 1, 2)
    n, c, h, wd = xl.shape
    o, cw, r, s = w.shape
    (sh, sw), (ph, pw) = stride, padding
    if cw != c:
        raise ValueError(f"{fn}: w has {cw} input channels, x has {c}")
    if sh < 1 or sw < 1 or ph < 0 or pw < 0:
        raise ValueError(f"{fn}: bad stride {stride} or padding {padding}")
    p = (h + 2 * ph - r) // sh + 1
    q = (wd + 2 * pw - s) // sw + 1
    span = sum((d - 1) * abs(st) for d, st in zip(xl.shape, xl.stride()))
    if min(n, o, p, q) < 1 or n * p * q * o >= 2 ** 31 or span >= 2 ** 31:
        raise ValueError(f"{fn}: empty or oversized conv: output ({n}, {o}, "
                         f"{p}, {q}) for x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    return xl, p, q


@dataclass(frozen=True)
class _Int8Launch:
    """What a launch of conv_int8.cu takes besides its pointers, worked
    out (and every check made) once per signature of its arguments."""
    plan: ConvInt8Plan
    out_shape: Tuple[int, ...]
    out_dtype: torch.dtype
    ws_numel: int
    args: Tuple[int, ...]


_int8_launches: Dict[tuple, _Int8Launch] = {}


def _sig(t: Optional[torch.Tensor]):
    return None if t is None else (t.dtype, t.device, t.shape,
                                   t.is_contiguous())


def _int8_launch(fn: str, x: torch.Tensor, w: torch.Tensor, stride, padding,
                 data_format: str, xscale, scale, bias, packed: torch.Tensor,
                 ksplit: Optional[int]) -> _Int8Launch:
    """Check a launch's arguments and work out its plan and arguments."""
    if scale is not None:
        o = w.shape[0] if w.ndim == 4 else -1
        for name, t, shape in (("x_scale", xscale, None),
                               ("scale", scale, (o,)), ("bias", bias, (o,))):
            if t is None and name == "bias":
                continue
            if (t is None or t.dtype != torch.float32 or t.device != x.device
                    or not t.is_contiguous()
                    or (t.numel() != 1 if shape is None
                        else tuple(t.shape) != shape)):
                raise ValueError(
                    f"{fn}: {name} must be a contiguous fp32 "
                    f"{'one-element tensor' if shape is None else shape} on "
                    f"{x.device}, got {None if t is None else (t.dtype, tuple(t.shape), str(t.device))}")
    xl, p, q = _check_int8(fn, x, w, stride, padding, data_format,
                           (torch.int8,) if scale is None
                           else (torch.float32, torch.bfloat16))
    n, c, h, wd = xl.shape
    o, _, r, s = w.shape
    xs = xl.stride()
    es = x.element_size()
    aligned = (xs[1] == 1 and x.data_ptr() % 16 == 0
               and all(v * es % 16 == 0 for v in (xs[0], xs[2], xs[3])))
    sms = _card_sms(x.device)
    plan = conv_int8_plan(n, c, h, wd, o, r, s, stride, padding, x.dtype,
                          sms, channels_last=aligned, ksplit=ksplit)
    want = (plan.tiles_n * plan.bn, plan.chunks * INT8_CHUNK)
    if (packed.dtype != torch.int8 or tuple(packed.shape) != want
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"{fn}: packed weights must be contiguous int8 "
                         f"{want} on {x.device} (pack_int8_weight), got "
                         f"{packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    # y contiguous in data_format; its strides in (n, o, p, q) order
    ys = ((o * p * q, p * q, q, 1) if data_format == "NCHW"
          else (p * q * o, 1, q * o, o))
    ypair = int(ys[1] == 1 and all(v % 2 == 0 for v in (ys[0], ys[2], ys[3])))
    return _Int8Launch(
        plan, (n, o, p, q) if data_format == "NCHW" else (n, p, q, o),
        torch.int32 if scale is None else x.dtype,
        plan.ksplit * n * p * q * o if plan.ksplit > 1 else 0,
        (n, c, h, wd, o, p, q, r, s, *stride, *padding, *xs, *ys,
         packed.shape[1], packed.shape[0], INT8_IN_TYPES[x.dtype], plan.bn,
         plan.stages, plan.ksplit, int(plan.copy == "vec"), plan.halo,
         ypair, plan.smem, sms))


def _launch_int8(fn: str, x: torch.Tensor, w: torch.Tensor, stride,
                 padding, data_format: str, *, xscale=None, scale=None,
                 bias=None, packed: Optional[torch.Tensor] = None,
                 ksplit: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/conv_int8.cu`` (mode A without ``scale``, mode B with
    it), with its K-split reduce where the plan splits K. The packed
    weights are ``packed`` where given (as :func:`pack_int8_weight` makes
    them), else packed here; the split's int32 partial sums are scratch
    allocated here. The checks, the plan and the C arguments are worked
    out once per signature of the arguments (shapes, strides, types,
    devices, the base's alignment) and kept."""
    if packed is None:
        packed = pack_int8_weight(w)
    key = (scale is None, x.shape, x.stride(), x.dtype, x.device,
           x.data_ptr() % 16 == 0, _sig(w), stride, padding, data_format,
           ksplit, _sig(xscale), _sig(scale), _sig(bias), _sig(packed))
    spec = _int8_launches.get(key)
    if spec is None:
        spec = _int8_launch(fn, x, w, stride, padding, data_format, xscale,
                            scale, bias, packed, ksplit)
        if len(_int8_launches) > 4096:
            _int8_launches.clear()
        _int8_launches[key] = spec
    y = torch.empty(spec.out_shape, dtype=spec.out_dtype, device=x.device)
    ws = (torch.empty(spec.ws_numel, dtype=torch.int32, device=x.device)
          if spec.ws_numel else None)
    lib = _libs.get("conv_int8.cu") or build()["conv_int8.cu"]
    with torch.cuda.device(x.device):
        err = lib.dcnn_conv_int8(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if xscale is None else xscale.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), *spec.args,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, fn, err)
    if ws is not None:
        conv_int8_reduce.launches += 1
    return y


def conv_int8_reduce() -> int:
    """The launch count of ``conv_int8.cu``'s K-split reduce, which
    :func:`conv_int8` and :func:`conv_int8_fused` launch in the same C call
    right after a conv whose plan splits K (the int32 partial sums added in
    split order, through the conv's epilogue). Returns the count."""
    return conv_int8_reduce.launches


def conv_int8(x: torch.Tensor, w: torch.Tensor, *, stride: Tuple[int, int],
              padding: Tuple[int, int], data_format: str,
              packed: Optional[torch.Tensor] = None,
              ksplit: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/conv_int8.cu`` in mode A: int8 ``x`` (NCHW or NHWC,
    any strides) and OIHW int8 ``w`` on one CUDA device, symmetric
    ``padding``; returns the int32 conv, contiguous in ``data_format``.
    Tiled by :func:`conv_int8_plan` (``ksplit`` forces its K split); the
    weights packed here unless ``packed`` holds them already."""
    y = _launch_int8("conv_int8", x, w, stride, padding, data_format,
                     packed=packed, ksplit=ksplit)
    conv_int8.launches += 1
    return y


def conv_int8_fused(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor], *,
                    stride: Tuple[int, int], padding: Tuple[int, int],
                    data_format: str, packed: Optional[torch.Tensor] = None,
                    ksplit: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/conv_int8.cu`` in mode B, the int8 conv layer in one
    kernel: fp32 or bf16 ``x`` (NCHW or NHWC, any strides) quantized by
    ``x_scale`` (a one-element fp32 tensor on x's device) in the prologue,
    the exact int8 products with OIHW int8 ``w``, and ``acc · scale[o] +
    bias[o]`` (``scale`` = x_scale · w_scale, contiguous fp32 (O,); ``bias``
    the same or None) in the epilogue, cast to x's type. Returns the
    output contiguous in ``data_format``, bit for bit the unfused chain
    (quantize_symmetric, :func:`conv_int8`, the layer's dequantize)."""
    y = _launch_int8("conv_int8_fused", x, w, stride, padding, data_format,
                     xscale=x_scale, scale=scale, bias=bias, packed=packed,
                     ksplit=ksplit)
    conv_int8_fused.launches += 1
    return y


pack_int8_weight.calls = 0
conv_int8.launches = 0
conv_int8_fused.launches = 0
conv_int8_reduce.launches = 0
conv3x3_s1.launches = 0
conv3x3_s1_bnrelu_in.launches = 0
conv3x3_s1_pairs.launches = 0
fused_scale_bias_relu.launches = 0

# every launch-counted wrapper, for runs that reset and read the counts
COUNTED = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, conv3x3_s1,
           conv3x3_s1_pairs, conv3x3_s1_bnrelu_in, fused_scale_bias_relu,
           conv_int8, conv_int8_fused, conv_int8_reduce)
