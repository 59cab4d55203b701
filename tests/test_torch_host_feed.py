"""The port's host feed held against the JAX package on the CPU, bit for bit:

- the native helpers (``dcnn_tpu_torch.native``, the port's own build of its
  own copy of the C++ sources) against ``dcnn_tpu.native`` and against the
  numpy fallback;
- the regression and UJI WiFi loaders on CSVs each test writes;
- the feed worker pool: ``shard_rng``, ``prepare_shard``,
  ``serial_shards``, ``host_shard_plan`` and the pool's shards (thread and
  process backends) against the JAX package's, and its failure paths;
- the transfer engine and ``PrefetchLoader`` on the CPU (plain copies):
  every batch equals the serial path's bytes, or its ``decode_host``;
- the wire decode (``decode_host``, ``default_decode_transform``).

Every wait on a thread or process has a timeout; no test bounds a wall
time.
"""

import csv
import threading

import numpy as np
import pytest
import torch

from dcnn_tpu import native as jax_native
from dcnn_tpu.data import ArrayDataLoader as JaxLoader
from dcnn_tpu.data import AugmentationBuilder as JaxAugBuilder
from dcnn_tpu.data import PrefetchLoader as JaxPrefetch
from dcnn_tpu.data import RegressionDataLoader as JaxRegression
from dcnn_tpu.data import UJIWiFiDataLoader as JaxWiFi
from dcnn_tpu.data import workers as jax_workers
from dcnn_tpu.data.wire import decode_host as jax_decode_host
from dcnn_tpu_torch import native
from dcnn_tpu_torch.data import (
    ArrayDataLoader, AugmentationBuilder, FeedWorkerPool, LocalSlots,
    MNISTDataLoader, PrefetchLoader, RegressionDataLoader, ShmSlots,
    TransferEngine, UJIWiFiDataLoader, chunk_bounds, decode_batch,
    decode_host, default_decode_transform, max_inflight, prepare_shard,
    serial_shards, shard_rng,
)
from dcnn_tpu_torch.data import transfer as transfer_mod
from dcnn_tpu_torch.data.transfer import union_seconds
from dcnn_tpu_torch.data.workers import host_shard_plan
from dcnn_tpu_torch.obs import get_registry
from dcnn_tpu_torch.resilience import faults

JOIN_S = 30.0  # the longest any test waits on a thread


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def no_native(monkeypatch):
    """The port's native module as on a host without g++."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)


# -- native helpers ----------------------------------------------------------

def test_native_builds_its_own_library():
    assert native.available()
    path = native.lib_path()
    assert path.parent.name == "_build" and path.exists()
    assert "dcnn_tpu_torch" in str(path)
    assert "dcnn_tpu/native" not in str(path)
    assert sorted(p.name for p in native._sources()) == [
        "dataio.cpp", "gather.cpp", "lz4codec.cpp", "shuffle.cpp"]


@pytest.mark.parametrize("shape", [(3, 17, 5), (1,), (0, 4), (64, 3, 8, 8)])
def test_u8_to_f32_equals_jax_native_and_fallback(shape, no_native):
    src = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    fallback = native.u8_to_f32(src)
    native._build_failed = False
    got = native.u8_to_f32(src)
    assert native.available()
    _eq(got, jax_native.u8_to_f32(src))
    _eq(got, fallback)
    _eq(got, decode_host(src))


@pytest.mark.parametrize("skip,label", [(1, 0), (2, 1)])
def test_decode_label_records_equals_jax(skip, label):
    rng = np.random.default_rng(2)
    n, img = 6, 3 * 32 * 32
    raw = rng.integers(0, 256, n * (skip + img), dtype=np.uint8)
    got = native.decode_label_records(raw, n, skip, label, img)
    want = jax_native.decode_label_records(raw, n, skip, label, img)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    with pytest.raises(ValueError):
        native.decode_label_records(raw[:10], n, skip, label, img)


def test_decoders_return_none_without_the_library(no_native, tmp_path):
    assert not native.available()
    assert native.decode_label_records(np.zeros(8, np.uint8), 1, 1, 0, 4) \
        is None
    p = tmp_path / "a.csv"
    p.write_text("label,p0\n1,2\n")
    assert native.parse_label_csv(str(p), 1) is None
    assert native.lz4_compress(b"abc") is None
    assert native.byte_shuffle(b"abcd", 2) is None


@pytest.mark.parametrize("scale", [1.0, 1.0 / 255.0])
def test_parse_label_csv_equals_jax_and_numpy(tmp_path, scale):
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.integers(0, 10, (9, 1)),
                           rng.integers(0, 256, (9, 12))], axis=1)
    p = tmp_path / "d.csv"
    np.savetxt(p, rows, fmt="%d", delimiter=",",
               header=",".join(["label"] + [f"p{i}" for i in range(12)]),
               comments="")
    got = native.parse_label_csv(str(p), 12, scale=scale)
    want = jax_native.parse_label_csv(str(p), 12, scale=scale)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    _eq(got[1], rows[:, 0].astype(np.int32))
    _eq(got[0], rows[:, 1:].astype(np.float32) * np.float32(scale))
    p.write_text("label,a,b\n1,0.5,2\n")  # fractional: the numpy path reads it
    assert native.parse_label_csv(str(p), 2) is None
    assert jax_native.parse_label_csv(str(p), 2) is None


def test_mnist_reader_parses_natively_and_equals_its_numpy_path(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.integers(0, 10, (5, 1)),
                           rng.integers(0, 256, (5, 784))], axis=1)
    p = tmp_path / "mnist.csv"
    np.savetxt(p, rows, fmt="%d", delimiter=",", header="label," + ",".join(
        f"p{i}" for i in range(784)), comments="")
    calls = []
    parse = native.parse_label_csv
    monkeypatch.setattr(native, "parse_label_csv",
                        lambda *a, **k: calls.append(a) or parse(*a, **k))
    a = MNISTDataLoader(str(p), batch_size=5)
    a.load_data()
    assert len(calls) == 1
    monkeypatch.setattr(native, "parse_label_csv", lambda *a, **k: None)
    b = MNISTDataLoader(str(p), batch_size=5)
    b.load_data()
    _eq(a._x, b._x)
    _eq(a._y, b._y)
    assert a._x.dtype == np.uint8


@pytest.mark.parametrize("level", [0, 1, 9])
def test_lz4_equals_jax_byte_for_byte(level):
    rng = np.random.default_rng(5)
    payloads = [b"", b"a", bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
                b"abcabcabd" * 700,
                np.linspace(0, 1, 3000, dtype=np.float32).tobytes()]
    for data in payloads:
        comp = native.lz4_compress(data, level)
        assert comp == jax_native.lz4_compress(data, level)
        assert native.lz4_decompress(comp, len(data)) == data
    with pytest.raises(ValueError, match="malformed"):
        native.lz4_decompress(b"\xff\xff\xff", 100)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_byte_shuffle_equals_jax(typesize):
    data = np.random.default_rng(6).integers(
        0, 256, 64 * typesize, dtype=np.uint8).tobytes()
    sh = native.byte_shuffle(data, typesize)
    assert sh == jax_native.byte_shuffle(data, typesize)
    assert native.byte_shuffle(sh, typesize, inverse=True) == data
    if typesize > 1:
        with pytest.raises(ValueError):
            native.byte_shuffle(data[:-1], typesize)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (50, 3, 4, 4)),
                                         (np.float32, (40, 7)),
                                         (np.int32, (30,))])
def test_gather_rows_equals_jax_fancy_index_and_fallback(dtype, shape,
                                                         monkeypatch):
    rng = np.random.default_rng(7)
    src = (rng.integers(0, 200, shape).astype(dtype))
    idx = rng.integers(0, shape[0], 23)
    got = native.gather_rows(src, idx)
    _eq(got, src[idx])
    _eq(got, jax_native.gather_rows(src, idx))
    out = np.empty_like(got)
    assert native.gather_rows(src, idx, out=out) is out
    _eq(out, src[idx])
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, shape[0]]))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1]))
    with pytest.raises(ValueError, match="out must be"):
        native.gather_rows(src, idx, out=np.empty((2,) + shape[1:], dtype))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    _eq(native.gather_rows(src, idx), got)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1]))


# -- regression and WiFi loaders ---------------------------------------------

def _batches(loader, epoch=1):
    loader.shuffle(epoch)
    return [(np.asarray(x), np.asarray(y)) for x, y in loader]


def _same_loaders(a, b):
    a.load_data()
    b.load_data()
    _eq(a._x, b._x)
    _eq(a._y, b._y)
    for attr in ("feature_means", "feature_stds", "target_means",
                 "target_stds"):
        va, vb = getattr(a, attr), getattr(b, attr)
        assert (va is None) == (vb is None)
        if va is not None:
            _eq(va, vb)
    for (xa, ya), (xb, yb) in zip(_batches(a), _batches(b)):
        _eq(xa, xb)
        _eq(ya, yb)
    assert a.num_features == b.num_features
    assert a.num_outputs == b.num_outputs


@pytest.mark.parametrize("nf,nt", [(False, True), (True, False),
                                   (True, True)])
def test_regression_loader_from_arrays_equals_jax(nf, nt):
    rng = np.random.default_rng(8)
    x = rng.normal(3, 2, (37, 5)).astype(np.float32)
    y = rng.normal(-1, 4, (37, 2)).astype(np.float32)
    kw = dict(normalize_features=nf, normalize_targets=nt, batch_size=8,
              seed=4)
    a = RegressionDataLoader(x, y, **kw)
    b = JaxRegression(x, y, **kw)
    _same_loaders(a, b)
    yb = next(iter(a))[1]
    _eq(a.denormalize_targets(yb), b.denormalize_targets(yb))
    _eq(a.denormalize_features(a._x), b.denormalize_features(b._x))


@pytest.mark.parametrize("header", [True, False])
def test_regression_loader_from_csv_equals_jax(tmp_path, header):
    rng = np.random.default_rng(9)
    data = rng.normal(0, 1, (21, 6)).round(4)
    p = tmp_path / "reg.csv"
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        if header:
            w.writerow([f"c{i}" for i in range(6)])
        for i, row in enumerate(data):
            cells = [str(v) for v in row]
            if i == 3:
                cells[1] = "nan"
            w.writerow(cells)
    kw = dict(csv_path=str(p), num_targets=2, normalize_features=True,
              batch_size=4, seed=1)
    _same_loaders(RegressionDataLoader(**kw), JaxRegression(**kw))
    with pytest.raises(ValueError, match="exactly one"):
        RegressionDataLoader()
    with pytest.raises(ValueError, match="trailing targets"):
        RegressionDataLoader(csv_path=str(p), num_targets=6).load_data()


def test_uji_wifi_loader_equals_jax(tmp_path):
    rng = np.random.default_rng(10)
    p = tmp_path / "uji.csv"
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([f"WAP{i:03d}" for i in range(8)] + ["LON", "LAT"])
        for i in range(19):
            rssi = rng.integers(-99, -20, 8).astype(str).tolist()
            rssi[i % 8] = "100"
            rssi[(i + 3) % 8] = "0"
            if i == 5:
                rssi[2] = "n/a"
            lon, lat = rng.normal(-7300, 50), rng.normal(4.86e6, 80)
            w.writerow(rssi + [f"{lon:.3f}", "bad" if i == 7 else f"{lat:.3f}"])
    a = UJIWiFiDataLoader(str(p), batch_size=4, seed=2)
    b = JaxWiFi(str(p), batch_size=4, seed=2)
    _same_loaders(a, b)
    assert float(a._x.min()) == 0.0  # 100, 0 and unparsable map to -100 dBm
    with pytest.raises(FileNotFoundError):
        UJIWiFiDataLoader(str(tmp_path / "missing.csv")).load_data()


# -- feed workers --------------------------------------------------------------

def _data(n=256, hw=8, c=3, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, hw, hw, c), dtype=np.uint8)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    return x, y


def _sels(n, rows, k, seed=1):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.permutation(n)[:rows]) for _ in range(k)]


def _aug(builder=AugmentationBuilder):
    return (builder("NHWC").horizontal_flip(p=0.5).random_crop(2, p=1.0)
            .brightness(0.2, p=0.5).build())


def _collect(pool, sels, epoch=0):
    out = []
    for ps in pool.shards(sels, epoch=epoch):
        out.append((ps.x.copy(), ps.y.copy()))
        ps.release()
    return out


def _jax_serial(x, y, sels, augmented, seed, epoch):
    aug = _aug(JaxAugBuilder) if augmented else None
    return [(a.copy(), b.copy()) for a, b, _ in jax_workers.serial_shards(
        x, y, sels, augment=aug, seed=seed, epoch=epoch)]


def _same_shards(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        _eq(gx, wx)
        _eq(gy, wy)


def test_shard_rng_equals_jax():
    for cell in [(7, 2, 5), (0, 0, 0), (2 ** 40, 3, 9)]:
        _eq(shard_rng(*cell).random(16), jax_workers.shard_rng(*cell)
            .random(16))


@pytest.mark.parametrize("augmented", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_prepare_shard_equals_jax(augmented, dtype):
    x, y = _data(n=64)
    x = x.astype(dtype)
    sel = _sels(64, 20, 1)[0]
    got = prepare_shard(x, y, sel, augment=_aug() if augmented else None,
                        rng=shard_rng(3, 1, 2))
    want = jax_workers.prepare_shard(
        x, y, sel, augment=_aug(JaxAugBuilder) if augmented else None,
        rng=jax_workers.shard_rng(3, 1, 2))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    # into slot views, as a worker writes
    ox, oy = np.empty_like(got[0]), np.empty_like(got[1])
    prepare_shard(x, y, sel, augment=_aug() if augmented else None,
                  rng=shard_rng(3, 1, 2), out_x=ox, out_y=oy)
    _eq(ox, want[0])
    _eq(oy, want[1])


@pytest.mark.parametrize("augmented", [False, True])
def test_serial_shards_equal_jax(augmented):
    x, y = _data()
    sels = _sels(len(x), 48, 4)
    got = [(a.copy(), b.copy()) for a, b, _ in serial_shards(
        x, y, sels, augment=_aug() if augmented else None, seed=7, epoch=3)]
    _same_shards(got, _jax_serial(x, y, sels, augmented, 7, 3))


@pytest.mark.parametrize("workers", [0, 1, 4])
@pytest.mark.parametrize("augmented", [False, True])
def test_thread_pool_shards_equal_jax_serial(workers, augmented):
    x, y = _data()
    sels = _sels(len(x), 64, 6)
    with FeedWorkerPool(x, y, 64, num_workers=workers,
                        augment=_aug() if augmented else None, seed=7,
                        backend="thread", poll_s=0.02) as pool:
        got = _collect(pool, sels, epoch=3)
    _same_shards(got, _jax_serial(x, y, sels, augmented, 7, 3))


def test_process_pool_spawned_shards_equal_jax_serial():
    """The default backend: spawned worker processes over shared memory."""
    x, y = _data(n=128)
    sels = _sels(len(x), 32, 4)
    with FeedWorkerPool(x, y, 32, num_workers=2, augment=_aug(), seed=5,
                        poll_s=0.05) as pool:
        got = _collect(pool, sels, epoch=1)
        got2 = _collect(pool, sels, epoch=1)  # the ring is reused
        assert pool.alive_workers() == 2
    _same_shards(got, _jax_serial(x, y, sels, True, 5, 1))
    _same_shards(got2, got)


def test_host_shard_plan_equals_jax():
    x, y = _data(n=64)
    for rank in range(2):
        got = host_shard_plan(ArrayDataLoader(x, y, batch_size=8, seed=3),
                              2, rank, 2, start_step=1)
        want = jax_workers.host_shard_plan(
            JaxLoader(x, y, batch_size=8, seed=3), 2, rank, 2, start_step=1)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            _eq(a, b)


def test_pool_epoch_changes_augment_draws():
    x, y = _data()
    sels = _sels(len(x), 32, 2)
    with FeedWorkerPool(x, y, 32, num_workers=2, augment=_aug(), seed=2,
                        backend="thread", poll_s=0.02) as pool:
        e0 = _collect(pool, sels, epoch=0)
        e1 = _collect(pool, sels, epoch=1)
    assert not all(np.array_equal(a, c) for (a, _), (c, _) in zip(e0, e1))


def test_backpressure_bounded_by_slots():
    x, y = _data()
    sels = _sels(len(x), 32, 4)
    pool = FeedWorkerPool(x, y, 32, num_workers=1, seed=0, backend="thread",
                          poll_s=0.02, num_slots=2)
    it = pool.shards(sels)
    ps0, ps1 = next(it), next(it)
    assert pool._free.qsize() == 0
    got = {}
    t = threading.Thread(target=lambda: got.setdefault("ps", next(it)),
                         daemon=True)
    t.start()
    t.join(0.3)
    assert t.is_alive(), "a third shard came without a free slot"
    ps0.release()
    t.join(JOIN_S)
    assert not t.is_alive() and got["ps"].idx == 2
    ps1.release()
    got["ps"].release()
    for ps in it:
        ps.release()
    assert pool._free.qsize() == 2
    pool.close()


def test_pool_rejects_oversized_shard_double_iter_and_slow_detect():
    x, y = _data()
    pool = FeedWorkerPool(x, y, 16, num_workers=1, backend="thread",
                          poll_s=0.02)
    with pytest.raises(ValueError, match="exceeds"):
        list(pool.shards([np.arange(32, dtype=np.int64)]))
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        list(pool.shards([np.arange(4, dtype=np.int64)]))
    # the gray-failure recycler is ported (tests/test_torch_slowness.py)
    slow = FeedWorkerPool(x, y, 16, num_workers=1, backend="thread",
                          slow_detect=True)
    assert slow.slow_detect
    slow.close()


def test_registry_instruments_settle():
    x, y = _data()
    reg = get_registry()
    shards0 = reg.counter("feed_shards_total").value
    with FeedWorkerPool(x, y, 32, num_workers=2, backend="thread",
                        poll_s=0.02) as pool:
        for ps in pool.shards(_sels(len(x), 32, 5)):
            ps.release()
    assert reg.counter("feed_shards_total").value == shards0 + 5
    assert reg.gauge("feed_queue_depth").value == 0
    assert reg.gauge("feed_workers_busy").value == 0


@pytest.mark.parametrize("exc,alive", [(faults.InjectedFault, 2),
                                       (faults.InjectedCrash, 1)])
def test_worker_error_or_crash_falls_back_inline_bit_identical(exc, alive):
    x, y = _data()
    sels = _sels(len(x), 64, 6)
    reg = get_registry()
    f0 = reg.counter("feed_worker_failures_total").value
    with faults.FaultPlan().arm("feed.prepare", at=2, times=1, exc=exc):
        with FeedWorkerPool(x, y, 64, num_workers=2, augment=_aug(), seed=7,
                            backend="thread", poll_s=0.02) as pool:
            got = _collect(pool, sels)
            assert pool.alive_workers() == alive
    assert reg.counter("feed_worker_failures_total").value > f0
    _same_shards(got, _jax_serial(x, y, sels, True, 7, 0))


def test_all_workers_dead_degrades_to_inline():
    x, y = _data()
    sels = _sels(len(x), 64, 5)
    with faults.FaultPlan().arm("feed.prepare", exc=faults.InjectedCrash):
        with FeedWorkerPool(x, y, 64, num_workers=2, seed=0,
                            backend="thread", poll_s=0.02) as pool:
            got = _collect(pool, sels)
            assert pool.alive_workers() == 0
    _same_shards(got, _jax_serial(x, y, sels, False, 0, 0))


def test_stall_rescue_settles_slot_and_respects_busy_workers():
    x, y = _data()
    pool = FeedWorkerPool(x, y, 32, num_workers=1, backend="thread",
                          poll_s=0.02)
    sel = np.arange(32, dtype=np.int64)
    try:
        sid = pool._free.get_nowait()
        inflight = {0: {"slot": sid, "sel": sel, "wid": None}}
        pool._busy.add(0)
        pool._rescue_stalled(inflight, {}, epoch=9)
        assert 0 in inflight
        pool._busy.clear()
        ready = {}
        pool._rescue_stalled(inflight, ready, epoch=9)
        assert inflight == {} and ready[0]["arrays"] is not None
        _eq(ready[0]["arrays"][0], x[sel])
        assert pool._poisoned == {(9, 0): sid}
        free0 = pool._free.qsize()
        pool._result_q.put(("done", 0, 9, 0, {"worker": 0}))
        pool._pump({}, {}, epoch=9)
        assert pool._free.qsize() == free0 + 1 and pool._poisoned == {}
    finally:
        pool.close()


def test_abandoned_epoch_reclaims_slots():
    x, y = _data()
    sels = _sels(len(x), 32, 6)
    with FeedWorkerPool(x, y, 32, num_workers=2, backend="thread",
                        poll_s=0.02, num_slots=3) as pool:
        it = pool.shards(sels)
        next(it).release()
        it.close()
        assert len(_collect(pool, sels)) == 6
        assert pool._free.qsize() == 3


def test_shm_and_local_slots_lifecycle():
    slots = ShmSlots(2, 8, (4, 4, 3), np.uint8, (), np.int32)
    spec = slots.spec()
    att = ShmSlots.attach(spec)
    v = slots.x_view(0, 8)
    v[...] = 7
    _eq(att.x_view(0, 8), v)
    yv = slots.y_view(1, 8)
    yv[...] = np.arange(8, dtype=np.int32)
    _eq(att.y_view(1, 8), yv)
    del v, yv
    att.close()
    slots.close()
    with pytest.raises(FileNotFoundError):
        ShmSlots.attach(spec)
    local = LocalSlots(1, 4, (2,), np.float32, (3,), np.float32)
    assert local.x_view(0, 4).shape == (4, 2)
    assert local.y_view(0, 4).shape == (4, 3)
    with pytest.raises(ValueError, match="num_slots"):
        LocalSlots(0, 4, (2,), np.float32, (), np.int32)


# -- transfer engine (CPU) ----------------------------------------------------

@pytest.mark.parametrize("n,c,want", [
    (12, 4, [(0, 3), (3, 6), (6, 9), (9, 12)]),
    (10, 4, [(0, 3), (3, 6), (6, 8), (8, 10)]),
    (3, 5, [(0, 1), (1, 2), (2, 3)]),
    (7, 3, [(0, 3), (3, 5), (5, 7)]),
    (0, 3, []),
])
def test_chunk_bounds(n, c, want):
    assert chunk_bounds(n, c) == want
    assert chunk_bounds(n, c) == transfer_mod.chunk_bounds(n, c)


def test_chunk_bounds_validation_and_interval_math():
    with pytest.raises(ValueError):
        chunk_bounds(-1, 2)
    with pytest.raises(ValueError):
        chunk_bounds(4, 0)
    spans = [{"put_start_t": 0.0, "put_end_t": 2.0},
             {"put_start_t": 1.0, "put_end_t": 3.0},
             {"put_start_t": 2.5, "put_end_t": 4.0},
             {"put_start_t": 5.0, "put_end_t": 6.0}]
    assert max_inflight(spans) == 2
    assert union_seconds([(s["put_start_t"], s["put_end_t"])
                          for s in spans]) == pytest.approx(5.0)


def _blob(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 3, 4, 4), dtype=np.uint8),
            rng.integers(0, 9, n).astype(np.int32))


@pytest.mark.parametrize("chunks,threads,mode", [(1, 1, "concat"),
                                                 (3, 2, "concat"),
                                                 (5, 3, "chunks")])
def test_put_shard_selection_matches_fancy_index(chunks, threads, mode):
    x, y = _blob(50, 1)
    sel = np.sort(np.random.default_rng(2).choice(50, 24, replace=False))
    with TransferEngine(num_chunks=chunks, num_threads=threads,
                        reassemble=mode, device="cpu") as eng:
        dx, dy, stats = eng.put_shard(x, y, sel)
    got = torch.cat(dx) if isinstance(dx, tuple) else dx
    _eq(got.numpy(), x[sel])
    _eq(dy.numpy(), y[sel])
    assert len(stats["chunks"]) == min(chunks, len(sel))
    assert stats["bytes"] == x[sel].nbytes and stats["events"] == []
    assert stats["inflight_max"] >= 1


def test_put_array_whole_and_empty_and_no_alias():
    x, _ = _blob()
    with TransferEngine(num_chunks=4, reassemble="concat",
                        device="cpu") as eng:
        d = eng.put_array(x)
        _eq(d.numpy(), x)
        x[0] = 0  # the engine copied: the tensor keeps the old bytes
        assert not np.array_equal(d.numpy(), x)
        empty = np.empty((0, 5, 2), np.uint8)
        assert tuple(eng.put_array(empty).shape) == (0, 5, 2)
        dx, dy, stats = eng.put_shard(empty, np.empty(0, np.int32))
    assert tuple(dx.shape) == (0, 5, 2) and tuple(dy.shape) == (0,)
    assert stats["bytes"] == 0


def test_put_shard_without_selection_ships_whole_array_in_ragged_chunks():
    x, y = _blob(17, 3)
    with TransferEngine(num_chunks=4, device="cpu") as eng:
        dx, dy, stats = eng.put_shard(x, y)
    _eq(torch.cat(dx).numpy(), x)
    _eq(dy.numpy(), y)
    assert [c["rows"] for c in stats["chunks"]] == [5, 4, 4, 4]


def test_engine_validation_close_and_error_propagation(monkeypatch):
    for kw, msg in [({"num_chunks": 0}, "num_chunks"),
                    ({"num_threads": 0}, "num_threads"),
                    ({"reassemble": "x"}, "reassemble")]:
        with pytest.raises(ValueError, match=msg):
            TransferEngine(device="cpu", **kw)
    x, y = _blob()
    eng = TransferEngine(num_chunks=3, device="cpu")
    with pytest.raises(IndexError):
        eng.put_shard(x, y, np.array([0, 1, 99]))

    def boom(*a, **k):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(native, "gather_rows", boom)
    with pytest.raises(RuntimeError, match="gather failed"):
        eng.put_shard(x, None, np.arange(6))
    eng.close()
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.put_array(x)


def test_transfers_overlap_at_least_two_in_flight(monkeypatch):
    """Two copies in flight at once: each chunk's copy waits at a barrier
    only the other thread's copy can open."""
    barrier = threading.Barrier(2, timeout=JOIN_S)
    copy = TransferEngine._copy

    def meet(self, host, pinned):
        barrier.wait()
        return copy(self, host, pinned)

    monkeypatch.setattr(TransferEngine, "_copy", meet)
    x, y = _blob(40)
    with TransferEngine(num_chunks=2, num_threads=2, device="cpu") as eng:
        dx, _, stats = eng.put_shard(x, None)
    assert stats["inflight_max"] == 2
    assert max_inflight(stats["chunks"]) == 2
    _eq(torch.cat(dx).numpy(), x)


# -- PrefetchLoader (CPU) -----------------------------------------------------

def _u8_loader(n=40, bs=8, seed=3, **kw):
    x, y = _blob(n, seed)
    return ArrayDataLoader(x, np.eye(9, dtype=np.float32)[y], batch_size=bs,
                           seed=seed, **kw)


def _want(loader, epoch):
    loader.shuffle(epoch)
    return [(decode_host(x, loader.scale), y) for x, y in loader]


@pytest.mark.parametrize("stage", [1, 2])
def test_prefetch_yields_the_serial_batches_decoded(stage):
    ld = _u8_loader()
    with PrefetchLoader(_u8_loader(), depth=2, stage_batches=stage,
                        device="cpu") as pf:
        assert len(pf) == len(ld) and pf.batch_size == 8
        assert pf.wire_dtype == np.uint8 and pf.num_samples == 40
        for epoch in (0, 1):
            pf.shuffle(epoch)
            got = list(pf)
            want = _want(ld, epoch)
            flat = [(bx, by) for gx, gy in got
                    for bx, by in (zip(gx, gy) if stage > 1 else [(gx, gy)])]
            assert len(flat) == len(want)
            for (gx, gy), (wx, wy) in zip(flat, want):
                _eq(gx.numpy(), wx)
                _eq(gy.numpy(), wy)


def test_prefetch_auto_decode_equals_the_jax_prefetch():
    ld, jld = _u8_loader(), JaxLoader(*_blob(40, 3), batch_size=8, seed=3)
    jld._y = np.eye(9, dtype=np.float32)[jld._y]
    got = list(PrefetchLoader(ld, device="cpu"))
    want = list(JaxPrefetch(jld))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        _eq(gx.numpy(), np.asarray(wx))
        _eq(gy.numpy(), np.asarray(wy))


def test_prefetch_hooks_ragged_tail_and_early_break():
    ld = _u8_loader(n=20, drop_last=False, shuffle=False)
    seen = []
    pf = PrefetchLoader(ld, stage_batches=3, device="cpu",
                        transform=lambda x, y: (seen.append(1) or x, y),
                        device_transform=lambda x, y: (x.float() * 2, y))
    got = list(pf)
    assert [tuple(c[0].shape[:2]) for c in got] == [(2, 8), (1, 4)]
    assert len(seen) == 3
    _eq(got[1][0][0].numpy(), ld._x[16:].astype(np.float32) * 2)
    for _ in range(3):  # an early break leaves no producer behind
        for i, _b in enumerate(PrefetchLoader(_u8_loader(), depth=1,
                                              device="cpu")):
            if i == 1:
                break
    producers = [t for t in threading.enumerate()
                 if t.name == "prefetch-producer"]
    for t in producers:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in producers)


def test_prefetch_propagates_producer_error():
    class Boom(ArrayDataLoader):
        def __iter__(self):
            yield from list(super().__iter__())[:1]
            raise RuntimeError("producer failed")

    x, y = _blob()
    pf = PrefetchLoader(Boom(x, y, batch_size=4), device="cpu")
    with pytest.raises(RuntimeError, match="producer failed"):
        list(pf)


def test_prefetch_with_engine_and_pool_bit_identical():
    ld = _u8_loader(n=48)
    ld.shuffle(2)
    plain = list(PrefetchLoader(ld, stage_batches=2, device="cpu"))
    with TransferEngine(num_chunks=3, reassemble="concat",
                        device="cpu") as eng:
        pf = PrefetchLoader(ld, stage_batches=2, transfer_engine=eng)
        assert pf.device == torch.device("cpu")
        with_engine = list(pf)
    pool = FeedWorkerPool(ld._x, ld._y, 16, num_workers=2, backend="thread",
                          poll_s=0.02, seed=ld.seed)
    with pool:
        pooled = list(PrefetchLoader(ld, stage_batches=2, worker_pool=pool,
                                     device="cpu"))
    for other in (with_engine, pooled):
        assert len(other) == len(plain) == 3
        for (ax, ay), (bx, by) in zip(plain, other):
            _eq(ax.numpy(), bx.numpy())
            _eq(ay.numpy(), by.numpy())


def test_prefetch_feed_workers_spawned_equal_serial_and_close():
    """``feed_workers=2``: the loader's own pool of spawned processes."""
    ld = _u8_loader(n=48)
    ld.shuffle(1)
    plain = list(PrefetchLoader(ld, stage_batches=3, device="cpu"))
    with PrefetchLoader(ld, stage_batches=3, feed_workers=2,
                        device="cpu") as pf:
        pooled = list(pf)
        pool = pf._pool
        assert pool.alive_workers() == 2
    assert pf._pool is None and pool._closed
    pf.close()  # idempotent
    for (ax, ay), (bx, by) in zip(plain, pooled):
        _eq(ax.numpy(), bx.numpy())
        _eq(ay.numpy(), by.numpy())


def test_prefetch_pooled_worker_augment_equals_jax():
    """With a worker augmentation the chunks are the JAX package's: the
    same plan, shard draws and re-quantization (thread pools in both)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(64, 8, 8, 1), dtype=np.uint8)
    y = rng.integers(0, 4, size=64).astype(np.int32)

    def run(loader_cls, prefetch_cls, pool_cls, builder, **kw):
        ld = loader_cls(x, y, batch_size=8, seed=2)
        ld.shuffle(1)
        aug = builder("NHWC").horizontal_flip(p=0.5).random_crop(1).build()
        with pool_cls(x, y, 16, num_workers=3, augment=aug, seed=2,
                      backend="thread", poll_s=0.02) as pool:
            return [(np.asarray(a).copy(), np.asarray(b).copy()) for a, b in
                    prefetch_cls(ld, stage_batches=2, worker_pool=pool, **kw)]

    got = run(ArrayDataLoader, PrefetchLoader, FeedWorkerPool,
              AugmentationBuilder, device="cpu")
    want = run(JaxLoader, JaxPrefetch, jax_workers.FeedWorkerPool,
               JaxAugBuilder)
    _same_shards(got, want)


def test_prefetch_refusals():
    x = np.zeros((16, 4), np.float32)
    y = np.zeros((16, 2), np.float32)
    ld = ArrayDataLoader(x, y, batch_size=4, shuffle=False,
                         augmentation=lambda b, r: b)
    with pytest.raises(TypeError, match="Mesh"):
        PrefetchLoader(ld, sharding=object(), device="cpu")
    with pytest.raises(ValueError, match="transform"):
        PrefetchLoader(ld, feed_workers=2, transform=lambda a, b: (a, b),
                       device="cpu")
    pf = PrefetchLoader(ld, feed_workers=2, device="cpu")
    with pytest.raises(ValueError, match="worker_augment"):
        list(pf)
    pf.close()
    for kw in ({"depth": 0}, {"stage_batches": 0}, {"feed_workers": -1}):
        with pytest.raises(ValueError):
            PrefetchLoader(ld, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PrefetchLoader(ld)


# -- wire decode ----------------------------------------------------------------

def test_wire_decode_host_and_transform_equal_jax():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _eq(decode_host(x), jax_decode_host(x))
    _eq(decode_host(x, 0.5), jax_decode_host(x, 0.5))
    f = np.linspace(0, 1, 7, dtype=np.float32)
    assert decode_host(f) is f
    # the multiply by float32(1/255), not the division
    _eq(decode_host(x), x.astype(np.float32) * np.float32(1 / 255))
    _eq(decode_batch(torch.from_numpy(x)).numpy(), decode_host(x))
    t = default_decode_transform(1 / 255)
    assert t is default_decode_transform(1 / 255)
    dx, dy = t(torch.from_numpy(x), "labels")
    _eq(dx.numpy(), decode_host(x))
    assert dy == "labels"
    ft = torch.from_numpy(f)
    assert decode_batch(ft) is ft
