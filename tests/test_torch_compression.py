"""The port's wire codecs (``dcnn_tpu_torch/utils/compression.py``) and
hardware info (``utils/hardware.py``) held against the JAX package's on
the CPU: twins of ``tests/test_utils.py``'s compression and hardware cases
and of the codec half of ``tests/test_wire_parity.py``, and the wire
contract itself: for every dtype and every codec this host has, the
port's frame of an array is byte for byte the JAX package's frame of the
same array, and each side decodes the other's frames to the same values
(bfloat16: a ``torch.bfloat16`` tensor on the port's side, an
``ml_dtypes`` array with the same bits on the JAX side). Every comparison
is exact: the codecs are lossless."""

import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from dcnn_tpu.utils import compression as jax_comp
from dcnn_tpu_torch import native
from dcnn_tpu_torch.utils import compression as comp
from dcnn_tpu_torch.utils.compression import (
    Lz4Compressor, MetaCompressor, RawCompressor, ShuffleLz4Compressor,
    ShuffleZstdCompressor, ZlibCompressor, ZstdCompressor, resolve_codec,
)
from dcnn_tpu_torch.utils.hardware import HardwareInfo, get_memory_usage_kb

CODECS = ("raw", "zlib", "zstd", "lz4", "shuffle-lz4", "shuffle-zstd")


def _pair(name):
    """The port's and the JAX package's codec ``name``, or a skip where this
    host lacks its backend."""
    if "zstd" in name:
        pytest.importorskip("zstandard")
    try:
        return resolve_codec(name), jax_comp.resolve_codec(name)
    except RuntimeError as e:
        pytest.skip(f"{name} unavailable here: {e}")


def _arrays():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((4, 3, 5)).astype(np.float32)
    return {
        "float32": f32,
        "int8": rng.integers(-128, 128, (7, 9), dtype=np.int8),
        "uint8": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
        "bfloat16": f32.astype(ml_dtypes.bfloat16),
    }


def _port_input(a, as_torch):
    """The port's form of the JAX side's array: a CPU tensor (bfloat16 with
    the same bits) or the numpy array itself."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy()) if as_torch else a


def _bits(x):
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


# -- the wire contract ----------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8", "bfloat16"])
@pytest.mark.parametrize("as_torch", [False, True])
def test_frames_byte_identical_to_jax(codec, dtype, as_torch):
    mine, theirs = _pair(codec)
    a = _arrays()[dtype]
    want = jax_comp.MetaCompressor().compress_array(a, codec=theirs)
    got = MetaCompressor().compress_array(_port_input(a, as_torch),
                                          codec=mine)
    assert got == want


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "int8", "uint8", "bfloat16"])
def test_cross_decoding_both_ways(codec, dtype):
    mine, theirs = _pair(codec)
    a = _arrays()[dtype]
    # JAX frame -> port
    got = MetaCompressor().decompress_array(
        jax_comp.MetaCompressor().compress_array(a, codec=theirs))
    if dtype == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    else:
        assert got.dtype == a.dtype
    assert tuple(got.shape) == a.shape
    np.testing.assert_array_equal(_bits(got), _bits(a))
    # port frame -> JAX
    back = jax_comp.MetaCompressor().decompress_array(
        MetaCompressor().compress_array(_port_input(a, True), codec=mine))
    assert back.dtype == a.dtype and back.shape == a.shape
    np.testing.assert_array_equal(_bits(back), _bits(a))


def test_bf16_numpy_extension_array_tagged_bf16():
    """A numpy array of an extension dtype named bfloat16 (what the JAX
    side holds) travels as bf16 too; the port decodes it without
    ml_dtypes."""
    a = _arrays()["bfloat16"]
    blob = MetaCompressor().compress_array(a, codec=RawCompressor())
    assert blob == jax_comp.MetaCompressor().compress_array(
        a, codec=jax_comp.RawCompressor())
    assert b"bf16" in blob[:64]
    back = MetaCompressor().decompress_array(blob)
    np.testing.assert_array_equal(_bits(back), a.view(np.uint16))


def test_decoded_arrays_are_writable_and_aligned():
    """A received array can go to torch with no copy and no warning."""
    mc = MetaCompressor()
    for codec in (RawCompressor(), ZlibCompressor()):
        for a in (np.arange(12, dtype=np.float32).reshape(3, 4),
                  np.arange(5, dtype=np.int64)):
            back = mc.decompress_array(mc.compress_array(a, codec=codec))
            assert back.flags.writeable and back.flags.aligned
            np.testing.assert_array_equal(back, a)
    empty = mc.decompress_array(mc.compress_array(
        torch.zeros(0, 3, dtype=torch.bfloat16)))
    assert empty.shape == (0, 3) and empty.dtype == torch.bfloat16


def test_compress_array_takes_host_tensors_only():
    with pytest.raises(ValueError, match="host tensor"):
        MetaCompressor().compress_array(torch.empty(2, device="meta"))


def test_compress_parts_join_to_the_frame():
    """The raw frame's parts (the array's own memory last) join to the
    frame; a compressed frame is one part."""
    mc = MetaCompressor()
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    parts = mc.compress_parts(a, codec=RawCompressor())
    assert len(parts) == 3
    assert b"".join(parts) == mc.compress_array(a, codec=RawCompressor())
    assert len(mc.compress_parts(a, codec=ZlibCompressor())) == 1


# -- twins of tests/test_utils.py ------------------------------------------

def test_meta_compressor_roundtrip_all_codecs():
    mc = MetaCompressor()
    payload = bytes(range(256)) * 100
    for codec in mc.codecs.values():
        blob = mc.compress(payload, codec)
        assert blob[0] == codec.codec_id
        assert mc.decompress(blob) == payload
        assert blob == jax_comp.MetaCompressor().compress(
            payload, jax_comp.resolve_codec(
                {0: "raw", 1: "zlib", 2: "zstd"}[codec.codec_id]))


def test_meta_compressor_cross_codec_decompress():
    zl = MetaCompressor(default=ZlibCompressor())
    raw = MetaCompressor(default=RawCompressor())
    payload = b"activation bytes" * 512
    assert raw.decompress(zl.compress(payload)) == payload
    assert zl.decompress(raw.compress(payload)) == payload


def test_meta_compressor_unknown_codec():
    mc = MetaCompressor()
    blob = bytearray(mc.compress(b"x" * 64))
    blob[0] = 250
    with pytest.raises(ValueError, match="unknown codec"):
        mc.decompress(bytes(blob))


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
def test_array_framing_roundtrip(dtype):
    mc = MetaCompressor()
    arr = (np.arange(2 * 3 * 4) % 7).astype(dtype).reshape(2, 3, 4)
    back = mc.decompress_array(mc.compress_array(arr))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)


def test_hardware_info_collect_keys():
    """The JAX package's keys; ``default_backend`` is the port's device."""
    from dcnn_tpu.utils.hardware import HardwareInfo as JaxInfo

    info = HardwareInfo.collect()
    want = JaxInfo.collect()
    assert set(info) == set(want)
    assert set(info["host"]) == set(want["host"])
    assert info["host"]["cpu_count"] >= 1
    assert info["host"]["ram_total_kb"] > 0
    assert isinstance(info["devices"], list) and info["devices"]
    assert info["default_backend"] == ("cuda" if torch.cuda.is_available()
                                       else "cpu")
    assert {"id", "platform", "kind"} <= set(info["devices"][0])
    assert get_memory_usage_kb() > 0


def test_print_info(capsys):
    HardwareInfo.print_info()
    out = capsys.readouterr().out
    assert out.startswith("Host: ") and "Backend: " in out


# -- the codec half of tests/test_wire_parity.py ----------------------------

def test_resolve_codec_semantics(monkeypatch):
    assert isinstance(resolve_codec(False), RawCompressor)
    assert isinstance(resolve_codec(None), RawCompressor)
    assert isinstance(resolve_codec(""), RawCompressor)
    assert isinstance(resolve_codec("zlib"), ZlibCompressor)
    inst = ZlibCompressor()
    assert resolve_codec(inst) is inst
    with pytest.raises(ValueError, match="unknown wire codec"):
        resolve_codec("snappy")
    monkeypatch.delenv("DCNN_WIRE_CODEC", raising=False)
    assert resolve_codec(True) is None
    monkeypatch.setenv("DCNN_WIRE_CODEC", "zlib")
    assert isinstance(resolve_codec(True), ZlibCompressor)


def _shuffle_lz4_or_skip():
    try:
        return ShuffleLz4Compressor()
    except RuntimeError as e:
        pytest.skip(f"native shuffle/lz4 unavailable: {e}")


def test_shuffle_lz4_roundtrip_exact_and_compresses():
    codec = _shuffle_lz4_or_skip()
    assert codec.codec_id == 5
    mc = MetaCompressor()
    arr = np.tile(np.linspace(0.0, 1e-3, 1024, dtype=np.float32),
                  16).reshape(64, 256)
    blob = mc.compress_array(arr, codec=codec)
    assert len(blob) < arr.nbytes
    back = mc.decompress_array(blob)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    raw = bytes(range(251))  # typesize-indivisible: typesize 1
    assert mc.decompress(mc.compress(raw, codec=codec)) == raw


def test_unknown_codec_id_rejected():
    blob = struct.pack("<BQ", 250, 4) + b"abcd"
    with pytest.raises(ValueError, match="unknown codec id"):
        MetaCompressor().decompress(blob)


def test_lz4_plain_codec_roundtrip():
    try:
        codec = Lz4Compressor()
    except RuntimeError as e:
        pytest.skip(f"native lz4 unavailable: {e}")
    mc = MetaCompressor()
    arr = np.tile(np.arange(64, dtype=np.uint8), 512)
    blob = mc.compress_array(arr, codec=codec)
    assert len(blob) < arr.nbytes
    np.testing.assert_array_equal(mc.decompress_array(blob), arr)
    hc = mc.compress_array(arr, codec=Lz4Compressor(level=9))
    assert hc == jax_comp.MetaCompressor().compress_array(
        arr, codec=jax_comp.Lz4Compressor(level=9))
    np.testing.assert_array_equal(mc.decompress_array(hc), arr)


@pytest.mark.parametrize("bad", [0, 256])
def test_shuffle_typesize_bounds(bad):
    with pytest.raises(ValueError, match="typesize"):
        ShuffleLz4Compressor(typesize=bad)


# -- no fallback -----------------------------------------------------------

def test_without_zstandard_default_is_zlib_and_named_zstd_raises(monkeypatch):
    """The card's machine has no zstandard: the default falls back to zlib
    as the JAX package's does, and a codec named zstd raises."""
    monkeypatch.setattr(comp, "_zstd", None)
    mc = MetaCompressor()
    assert isinstance(mc.default, ZlibCompressor)
    assert 2 not in mc.codecs
    assert mc.compress(b"abc")[0] == ZlibCompressor.codec_id
    for name in ("zstd", "shuffle-zstd"):
        with pytest.raises(RuntimeError, match="zstandard"):
            resolve_codec(name)
    with pytest.raises(RuntimeError):
        ZstdCompressor()
    with pytest.raises(RuntimeError):
        ShuffleZstdCompressor()


def test_named_native_codec_without_toolchain_raises(monkeypatch):
    blob = MetaCompressor().compress_array(
        np.arange(64, dtype=np.float32), codec=_shuffle_lz4_or_skip())
    monkeypatch.setattr(native, "available", lambda: False)
    for name in ("lz4", "shuffle-lz4"):
        with pytest.raises(RuntimeError, match="unavailable"):
            resolve_codec(name)
    with pytest.raises(ValueError, match="known but unavailable"):
        MetaCompressor().decompress_array(blob)
