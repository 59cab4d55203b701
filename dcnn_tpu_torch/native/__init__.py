"""Native (C++) host helpers with ctypes bindings (counterpart of
``dcnn_tpu/native/__init__.py``).

The host side of the input pipeline in C++ (``src/``, the port's own copy of
the JAX package's sources): chunk-parallel row gather (``gather.cpp``), CSV
parse, label-record decode and u8 -> f32 (``dataio.cpp``), byte shuffle
(``shuffle.cpp``) and the LZ4 block codec (``lz4codec.cpp``).

:func:`lib` builds the library at first use with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into ``dcnn_tpu_torch/_build/``
(git-ignored). The file name hashes the sources and the flags, so an edited
source is rebuilt and an unchanged one reused; a build is written to a
process-unique temporary name and renamed into place, so concurrent first
uses never load a half-written library. Where ``g++`` is missing or the
build fails, every function takes its numpy path, whose results are
identical (``gather_rows``, ``u8_to_f32``) or returns None so that the
caller takes its own numpy path (the decoders, the codecs), as in the JAX
package. :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cpp"))


def lib_path() -> Path:
    """The library's path: its name hashes every source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libdcnn_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None or not _sources():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *GXX_FLAGS, *map(str, _sources()), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(l: ctypes.CDLL) -> None:
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    l.dcnn_u8_to_f32.argtypes = [u8p, f32p, i64, ctypes.c_float]
    l.dcnn_u8_to_f32.restype = None
    l.dcnn_decode_label_records.argtypes = [u8p, i64, i64, i32, i32, i64,
                                            f32p, i32p]
    l.dcnn_decode_label_records.restype = ctypes.c_int
    l.dcnn_parse_label_csv.argtypes = [ctypes.c_char_p, i64, i32, i32,
                                       ctypes.c_float, i64, f32p, i32p]
    l.dcnn_parse_label_csv.restype = i64
    for fn in ("dcnn_lz4_compress", "dcnn_lz4_decompress"):
        getattr(l, fn).argtypes = [u8p, i64, u8p, i64]
        getattr(l, fn).restype = i64
    l.dcnn_lz4_compress_bound.argtypes = [i64]
    l.dcnn_lz4_compress_bound.restype = i64
    l.dcnn_lz4_compress_hc.argtypes = [u8p, i64, u8p, i64, i32]
    l.dcnn_lz4_compress_hc.restype = i64
    for fn in ("dcnn_byte_shuffle", "dcnn_byte_unshuffle"):
        getattr(l, fn).argtypes = [u8p, u8p, i64, i32]
        getattr(l, fn).restype = ctypes.c_int
    l.dcnn_gather_rows.argtypes = [u8p, i64p, u8p, i64, i64, i64]
    l.dcnn_gather_rows.restype = ctypes.c_int


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built (no ``g++``) or loaded."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = lib_path()
        if not out.exists() and not _build(out):
            _build_failed = True
            return None
        try:
            l = ctypes.CDLL(str(out))
            _bind(l)
        except (OSError, AttributeError):
            _build_failed = True
            return None
        _lib = l
        return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def available() -> bool:
    """True where the C++ library runs; False where the numpy paths do."""
    return lib() is not None


def gather_available() -> bool:
    return available()


def byte_shuffle(data: bytes, typesize: int,
                 inverse: bool = False) -> Optional[bytes]:
    """Blosc-style byte-plane (un)shuffle. None if the library is
    unavailable; raises on ``len(data) % typesize != 0``."""
    l = lib()
    if l is None:
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(len(data), np.uint8)
    fn = l.dcnn_byte_unshuffle if inverse else l.dcnn_byte_shuffle
    if fn(_u8ptr(src), _u8ptr(dst), src.size, typesize) != 0:
        raise ValueError(f"byte_shuffle: {len(data)} % typesize {typesize}")
    return dst.tobytes()


def lz4_compress(data: bytes, level: int = 0) -> Optional[bytes]:
    """LZ4 block-format compress. ``level`` 0: the greedy single-probe
    matcher; >= 1: the hash-chain search (the same block format). None if
    the library is unavailable."""
    l = lib()
    if l is None:
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(int(l.dcnn_lz4_compress_bound(len(data))), np.uint8)
    if level > 0:
        n = l.dcnn_lz4_compress_hc(_u8ptr(src), src.size, _u8ptr(dst),
                                   dst.size, level)
    else:
        n = l.dcnn_lz4_compress(_u8ptr(src), src.size, _u8ptr(dst), dst.size)
    if n < 0:
        raise ValueError("lz4 compress: destination bound overflow")
    return dst[:n].tobytes()


def lz4_decompress(data: bytes, raw_size: int) -> Optional[bytes]:
    """LZ4 block-format decompress into exactly ``raw_size`` bytes. None if
    the library is unavailable; raises on a malformed stream."""
    l = lib()
    if l is None:
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(raw_size, np.uint8)
    n = l.dcnn_lz4_decompress(_u8ptr(src), src.size, _u8ptr(dst), raw_size)
    if n != raw_size:
        raise ValueError(f"lz4 decompress: malformed stream (rc={n})")
    return dst.tobytes()


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Row gather ``src[idx]``: a chunk-parallel native memcpy where the
    library runs, numpy indexing otherwise; the bytes are the same either
    way. Indices must lie in ``[0, len(src))``: a negative one raises
    ``IndexError`` on both paths. ``out`` (C-contiguous, of ``src``'s dtype
    and the result's shape) receives the rows instead of a new array, e.g.
    a pinned staging buffer."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"gather_rows needs a 1-D index, got {idx.ndim}-D")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(
            f"gather_rows: index out of range [0, {src.shape[0]})")
    shape = (idx.size, *src.shape[1:])
    if out is not None and (out.shape != shape or out.dtype != src.dtype
                            or not out.flags.c_contiguous):
        raise ValueError(f"gather_rows: out must be a C-contiguous "
                         f"{src.dtype} array of shape {shape}, got "
                         f"{out.dtype} {out.shape}")
    l = lib()
    row_bytes = src.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if l is None or src.ndim == 0 or row_bytes == 0:
        if out is None:
            return src[idx]
        np.take(src, idx, axis=0, out=out)
        return out
    dst = np.empty(shape, src.dtype) if out is None else out
    rc = l.dcnn_gather_rows(
        _u8ptr(src), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8ptr(dst), idx.size, row_bytes, src.shape[0])
    if rc != 0:
        raise IndexError(f"gather_rows: index out of range for axis 0 of "
                         f"size {src.shape[0]}")
    return dst


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 -> float32 times ``scale`` (native where it runs)."""
    src = np.ascontiguousarray(src, np.uint8)
    l = lib()
    if l is None:
        return src.astype(np.float32) * np.float32(scale)
    dst = np.empty(src.shape, np.float32)
    l.dcnn_u8_to_f32(_u8ptr(src),
                     dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     src.size, scale)
    return dst


def decode_label_records(raw: np.ndarray, n: int, skip_bytes: int,
                         label_index: int, img_bytes: int):
    """Decode ``n`` ``[labels...][pixels...]`` records into (images f32
    scaled by 1/255, labels int32). None if the library is unavailable."""
    l = lib()
    if l is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    images = np.empty((n, img_bytes), np.float32)
    labels = np.empty((n,), np.int32)
    rc = l.dcnn_decode_label_records(
        _u8ptr(raw), raw.size, n, skip_bytes, label_index, img_bytes,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError("record buffer too small for requested decode")
    return images, labels


def parse_label_csv(path: str, pixels_per_row: int, skip_header: bool = True,
                    scale: float = 1.0 / 255.0):
    """Parse a ``label,pix...`` CSV into (pixels f32 times ``scale``, labels
    int32). None if the library is unavailable or the file holds anything
    but integer pixels (the caller's tolerant numpy path reads those)."""
    l = lib()
    if l is None:
        return None
    with open(path, "rb") as f:
        text = f.read()
    max_rows = text.count(b"\n") + 1  # an upper bound on the rows
    pixels = np.empty((max_rows, pixels_per_row), np.float32)
    labels = np.empty((max_rows,), np.int32)
    rows = l.dcnn_parse_label_csv(
        text, len(text), pixels_per_row, 1 if skip_header else 0, scale,
        max_rows, pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rows < 0:
        return None
    return pixels[:rows].copy(), labels[:rows].copy()
