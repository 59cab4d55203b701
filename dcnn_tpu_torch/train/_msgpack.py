"""The JAX package's checkpoint array format, read and written without
``msgpack`` or ``flax``.

``dcnn_tpu/train/checkpoint.py`` writes ``arrays.msgpack`` with
``flax.serialization.to_bytes``: the pytree becomes a state dict (tuples and
lists become ``{"0": ..., "1": ...}``, dict keys strings), arrays above
:data:`MAX_CHUNK_SIZE` bytes become flax's chunked form, and the result is
packed by ``msgpack`` with numpy arrays as ext type 1 (``packb((shape,
dtype name, C-order bytes))``) and numpy scalars as ext type 3. This module
writes and reads exactly that, in plain Python and numpy:

- :func:`packb` / :func:`unpackb`: the msgpack subset that appears there
  (maps, arrays, str, bin, int, float, bool, nil, ext), each value in the
  smallest form ``msgpack`` itself picks, so the bytes are the same;
- :func:`to_bytes` / :func:`from_bytes`: the state-dict conversion and the
  chunking, restored against a template of the same structure.

Dict keys are written in sorted order, as the JAX package's
``jax.tree_util.tree_map`` leaves them before ``to_bytes``. ``bfloat16``
arrays (numpy has no such type) are refused.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# -- msgpack --------------------------------------------------------------

def _int(n: int, out: List) -> None:
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        out.append(struct.pack("b" if n < 0 else "B", n))
    elif 0 <= n <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0 <= n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < 0:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < 0:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < 0:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: Tuple[int, int], codes: Tuple[int, int, int],
            out: List) -> None:
    """A header of a sized value: a fix form below ``fix[1]`` where there is
    one (``fix[0]`` | n), then 8-, 16- or 32-bit lengths (``codes``; None
    where the kind has no 8-bit form)."""
    if fix[1] and n < fix[1]:
        out.append(struct.pack("B", fix[0] | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of {n} elements or bytes is too "
                         f"large")


def _ext(code: int, parts: List, out: List) -> None:
    """An ext value whose data is the concatenation of ``parts``."""
    n = sum(len(p) for p in parts)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        out.append(struct.pack(">Bb", fix, code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise ValueError(f"a msgpack ext of {n} bytes is too large")
    out.extend(parts)


def _ndarray_parts(a: np.ndarray) -> List:
    """flax's ``_ndarray_to_bytes``, ``packb((shape, dtype name, C
    bytes))``, as pieces: the header, then a view of the array's bytes (no
    copy until the whole message is joined)."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if not a.flags.c_contiguous:
        a = a.copy(order="C")  # (np.ascontiguousarray would make 0-d 1-d)
    out: List = [b"\x93"]  # a fixarray of 3
    _pack(tuple(int(d) for d in a.shape), out)
    _pack(a.dtype.name, out)
    _sized(a.nbytes, (0, 0), (0xC4, 0xC5, 0xC6), out)
    out.append(memoryview(a.reshape(-1).view(np.uint8)))
    return out


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _ext(EXT_NDARRAY, _ndarray_parts(obj), out)
    elif isinstance(obj, np.generic):  # before float: np.float64 is one
        _ext(EXT_NPSCALAR, _ndarray_parts(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _sized(len(b), (0, 0), (0xC4, 0xC5, 0xC6), out)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _sized(len(obj), (0x90, 16), (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _sized(len(obj), (0x80, 16), (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the types above, numpy
    arrays and scalars as flax's ext types 1 and 3. The pieces are joined
    once, at the end."""
    out: List = []
    _pack(obj, out)
    return b"".join(out)


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise ValueError("a bfloat16 array: numpy has no bfloat16 type, so "
                         "this reader does not take it")
    return np.dtype(name)


def _array(data: memoryview) -> np.ndarray:
    shape, name, buf = unpackb(data, raw=True)
    a = np.frombuffer(buf, dtype=_dtype(name.decode()))
    return a.reshape(tuple(shape), order="C").copy()


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_or_bin(self, n: int, is_str: bool):
        b = self.take(n)
        if is_str and not self.raw:
            return bytes(b).decode("utf-8")
        # raw: an array's bytes stay a view until the array copies them
        return b if self.raw and not is_str else bytes(b)

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array(data)
        if code == EXT_NPSCALAR:
            return _array(data)[()]
        raise ValueError(f"msgpack ext type {code} is not used by the "
                         f"checkpoint format")

    def value(self) -> Any:
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_or_bin(t & 0x1F, True)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        length = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                  0xDB: ">I"}
        if t in length:
            return self.str_or_bin(self.unpack(length[t]), t >= 0xD9)
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[t]))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not used by the "
                         f"checkpoint format")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data, raw: bool = False) -> Any:
    """``msgpack.unpackb`` with flax's ext hook: ext 1 gives a (writable)
    numpy array, ext 3 a numpy scalar. ``raw``: str values as bytes, bin
    values as memoryviews of ``data``."""
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         f"the msgpack object")
    return out


# -- the flax state dict ---------------------------------------------------

def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict``: tuples and lists as ``{"0": ...}``, dicts
    with string keys (sorted), leaves as they are."""
    if isinstance(tree, (tuple, list)):
        return {str(i): _state_dict(x) for i, x in enumerate(tree)}
    if isinstance(tree, dict):
        keys = {str(k): k for k in tree}
        if len(keys) != len(tree):
            raise ValueError("dict keys do not have a unique string form")
        return {s: _state_dict(tree[keys[s]]) for s in sorted(keys)}
    return tree


def _chunk(a: np.ndarray) -> Dict[str, Any]:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _chunk_leaves(d: Any) -> Any:
    if isinstance(d, np.ndarray):
        return _chunk(d) if d.size * d.dtype.itemsize > MAX_CHUNK_SIZE else d
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    return d


def _unchunk_leaves(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            n = len(d["shape"])
            shape = tuple(d["shape"][str(i)] for i in range(n))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a pytree of dicts, tuples, lists
    and numpy arrays or scalars, dict keys sorted."""
    return packb(_chunk_leaves(_state_dict(tree)))


def restore(template: Any, state: Any, path: str = "") -> Any:
    """flax's ``from_state_dict``: ``state`` shaped by ``template``'s
    tuples, lists and dicts (a template dict's keys must all be present);
    leaves come from ``state``."""
    if isinstance(template, (tuple, list)):
        if not isinstance(state, dict) or len(state) != len(template):
            raise ValueError(f"at {path or '/'}: the template has "
                             f"{len(template)} entries, the file "
                             f"{len(state) if isinstance(state, dict) else state!r}")
        out = [restore(t, state[str(i)], f"{path}/{i}")
               for i, t in enumerate(template)]
        return tuple(out) if isinstance(template, tuple) else out
    if isinstance(template, dict):
        missing = {str(k) for k in template} - set(state)
        if missing:
            raise ValueError(f"at {path or '/'}: the file lacks keys "
                             f"{sorted(missing)}")
        return {k: restore(v, state[str(k)], f"{path}/{k}")
                for k, v in template.items()}
    return state


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict, chunked
    arrays joined, arrays as writable numpy arrays."""
    return _unchunk_leaves(unpackb(data))


def from_bytes(template: Any, data) -> Any:
    """``flax.serialization.from_bytes(template, data)``."""
    return restore(template, msgpack_restore(data))
