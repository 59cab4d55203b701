"""Tensor-payload compression for the framed wire (counterpart of
``dcnn_tpu/utils/compression.py``).

The codecs, their ids and the frame layout are the JAX package's, so a
frame the port writes is byte for byte the frame the JAX package writes
for the same array and codec, and either side decodes the other's:

- ``[1-byte codec id][u64 raw size][payload]`` (:class:`MetaCompressor`);
- a tensor's raw bytes are ``[u8 rank][u64 dims...][4-byte descr][data]``,
  the descr numpy's (``<f4``, ``|i1``, ...) cut to four bytes, or
  ``bf16`` for bfloat16.

Codecs: raw (id 0), zlib (1), zstd (2, where ``zstandard`` is installed),
LZ4 block format (3) and byte-shuffle + zstd (4) or + LZ4 (5), the native
ones on the port's own helpers (:mod:`dcnn_tpu_torch.native`). A codec
that is named and unavailable raises ``RuntimeError``; none degrades to
another.

Where the port departs from the JAX package: ``compress_array`` takes a
numpy array or a CPU torch tensor, and a bfloat16 one (a torch tensor, or
a numpy array of an extension dtype named ``bfloat16``) travels as its
16-bit patterns. ``decompress_array`` hands back a numpy array, or for a
``bf16`` frame a ``torch.bfloat16`` tensor over those bits; it never
imports ``ml_dtypes``. The array it returns is writable, so the receiver
can hand it to torch without a copy or a warning.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Protocol

import numpy as np
import torch

try:
    import zstandard as _zstd
except ImportError:  # the card's machine has no zstandard
    _zstd = None


class Compressor(Protocol):
    codec_id: int

    def compress(self, data: bytes) -> bytes: ...
    def decompress(self, data: bytes, raw_size: int) -> bytes: ...


def _native():
    from .. import native

    if not native.available():
        raise RuntimeError("native lz4/shuffle codec unavailable "
                           "(no toolchain)")
    return native


class RawCompressor:
    """Identity codec (id 0): framed, uncompressed."""

    codec_id = 0

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        return data


class ZlibCompressor:
    codec_id = 1

    def __init__(self, level: int = 6):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        return zlib.decompress(data)


class ZstdCompressor:
    codec_id = 2

    def __init__(self, level: int = 3):
        if _zstd is None:
            raise RuntimeError("zstandard not available")
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        return self._d.decompress(data, max_output_size=raw_size or 2**31)


class Lz4Compressor:
    """LZ4 block format through the native helpers. ``level`` 0: the
    greedy matcher; 1-13: the hash-chain search (same block format)."""

    codec_id = 3

    def __init__(self, level: int = 0):
        self._n = _native()
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        return self._n.lz4_compress(data, level=self.level)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        return self._n.lz4_decompress(data, raw_size)


def _check_typesize(typesize: int) -> int:
    if not 1 <= int(typesize) <= 255:
        raise ValueError(f"typesize must be 1..255 (1-byte payload "
                         f"header), got {typesize}")
    return int(typesize)


class ShuffleLz4Compressor:
    """Byte-plane shuffle + LZ4. Payload: ``[1-byte typesize][shuffled
    stream]``, LZ4 over the whole; a payload the typesize does not divide
    is shuffled with typesize 1."""

    codec_id = 5

    def __init__(self, typesize: int = 4, level: int = 0):
        self.typesize = _check_typesize(typesize)
        self._n = _native()
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        t = self.typesize if len(data) % self.typesize == 0 else 1
        return self._n.lz4_compress(
            bytes([t]) + self._n.byte_shuffle(data, t), level=self.level)

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        raw = self._n.lz4_decompress(data, raw_size + 1)
        return self._n.byte_shuffle(raw[1:], raw[0], inverse=True)


class ShuffleZstdCompressor:
    """Byte-plane shuffle + zstd, the layout of
    :class:`ShuffleLz4Compressor`."""

    codec_id = 4

    def __init__(self, typesize: int = 4, level: int = 3):
        self.typesize = _check_typesize(typesize)
        if _zstd is None:
            raise RuntimeError("zstandard not available")
        self._n = _native()
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        t = self.typesize if len(data) % self.typesize == 0 else 1
        return self._c.compress(bytes([t]) + self._n.byte_shuffle(data, t))

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        raw = self._d.decompress(data, max_output_size=(raw_size or 2**31) + 1)
        return self._n.byte_shuffle(raw[1:], raw[0], inverse=True)


# the native codecs register on their first frame: building them may run
# g++, and a MetaCompressor is made when the comm stack is imported
_LAZY = {Lz4Compressor.codec_id: Lz4Compressor,
         ShuffleZstdCompressor.codec_id: ShuffleZstdCompressor,
         ShuffleLz4Compressor.codec_id: ShuffleLz4Compressor}

_BF16 = b"bf16"


def array_header(shape, descr: bytes) -> bytes:
    """A tensor's framing before its data: rank, u64 dims, 4-byte descr."""
    return (struct.pack("<B", len(shape))
            + b"".join(struct.pack("<Q", int(d)) for d in shape)
            + struct.pack("<4s", descr))


def array_parts(arr) -> tuple:
    """``(header, data)`` of a numpy array or CPU torch tensor: its framing
    and a contiguous buffer of its bytes (bfloat16 as its bit patterns)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(f"compress_array takes a host tensor, got one "
                             f"on {arr.device}")
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return array_header(t.shape, _BF16), t.view(torch.int16).numpy()
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return array_header(arr.shape, _BF16), arr.view(np.uint16)
    descr = np.lib.format.dtype_to_descr(arr.dtype).encode()[:4].ljust(4)
    return array_header(arr.shape, descr), arr


class MetaCompressor:
    """Codec-id-framed dispatch: zstd by default where it is installed,
    else zlib; raw and zlib always registered."""

    _HEADER = struct.Struct("<BQ")

    def __init__(self, default: Optional[Compressor] = None):
        self.codecs: Dict[int, Compressor] = {}
        self.register(RawCompressor())
        zl = ZlibCompressor()
        self.register(zl)
        if _zstd is not None:
            zs = ZstdCompressor()
            self.register(zs)
            self.default = default or zs
        else:
            self.default = default or zl

    def register(self, codec: Compressor) -> None:
        self.codecs[codec.codec_id] = codec

    def compress(self, data: bytes, codec: Optional[Compressor] = None) -> bytes:
        c = codec or self.default
        return self._HEADER.pack(c.codec_id, len(data)) + c.compress(data)

    def _codec(self, codec_id: int) -> Compressor:
        if codec_id not in self.codecs and codec_id in _LAZY:
            try:
                self.register(_LAZY[codec_id]())
            except RuntimeError as err:
                raise ValueError(f"codec id {codec_id} known but unavailable "
                                 f"on this host: {err}") from err
        if codec_id not in self.codecs:
            raise ValueError(f"unknown codec id {codec_id}")
        return self.codecs[codec_id]

    def _decompress_view(self, blob):
        """The raw bytes of ``blob``: a view into it for the raw codec (no
        copy), else the codec's output."""
        codec_id, raw_size = self._HEADER.unpack_from(blob)
        body = memoryview(blob)[self._HEADER.size:]
        return self._codec(codec_id).decompress(body, raw_size)

    def decompress(self, blob: bytes) -> bytes:
        return bytes(self._decompress_view(blob))

    def compress_parts(self, arr, codec: Optional[Compressor] = None) -> list:
        """The buffers of :meth:`compress_array`'s frame, in order, without
        joining them: for the raw codec the array's own memory is the last
        one (a sender writes them one after another)."""
        c = codec or self.default
        header, data = array_parts(arr)
        if c.codec_id == RawCompressor.codec_id:
            return [self._HEADER.pack(c.codec_id, len(header) + data.nbytes),
                    header, memoryview(data.reshape(-1).view(np.uint8))]
        return [self.compress(header + data.tobytes(), c)]

    def compress_array(self, arr, codec: Optional[Compressor] = None) -> bytes:
        return b"".join(self.compress_parts(arr, codec))

    def decompress_array(self, blob):
        raw = self._decompress_view(blob)
        if memoryview(raw).readonly:
            raw = bytearray(raw)
        ndim = struct.unpack_from("<B", raw)[0]
        shape = struct.unpack_from(f"<{ndim}Q", raw, 1)
        off = 1 + 8 * ndim
        descr = bytes(raw[off:off + 4])
        bf16 = descr == _BF16
        dtype = np.dtype(np.int16 if bf16
                         else descr.decode().strip("\x00").strip())
        arr = np.frombuffer(memoryview(raw)[off + 4:], dtype=dtype)
        if not arr.flags.aligned:  # a frame's data sits at any offset
            arr = arr.copy()
        arr = arr.reshape(shape)
        return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


# name -> constructor of the selectable wire codecs: construction may
# probe the native toolchain or an optional wheel, so it happens at
# selection time
_CODEC_NAMES = {
    "raw": RawCompressor,
    "zlib": ZlibCompressor,
    "zstd": ZstdCompressor,
    "lz4": Lz4Compressor,
    "shuffle-lz4": ShuffleLz4Compressor,
    "shuffle-zstd": ShuffleZstdCompressor,
}


def resolve_codec(spec) -> Optional[Compressor]:
    """A wire-codec spec as a :class:`Compressor` (or None):

    - ``False``/``None``/``""``: :class:`RawCompressor`;
    - ``True``: the ``DCNN_WIRE_CODEC`` codec by name, else ``None`` (the
      :class:`MetaCompressor` default);
    - a name from ``{raw, zlib, zstd, lz4, shuffle-lz4, shuffle-zstd}``:
      that codec (``RuntimeError`` where its backend is missing);
    - a :class:`Compressor`: itself.

    Receivers never consult this: they dispatch on each frame's codec id.
    """
    if spec is None or spec is False or spec == "":
        return RawCompressor()
    if spec is True:
        import os
        name = os.environ.get("DCNN_WIRE_CODEC", "").strip().lower()
        if not name:
            return None
        spec = name
    if isinstance(spec, str):
        name = spec.strip().lower()
        if name not in _CODEC_NAMES:
            raise ValueError(f"unknown wire codec {spec!r} (choose from "
                             f"{sorted(_CODEC_NAMES)})")
        return _CODEC_NAMES[name]()
    return spec
