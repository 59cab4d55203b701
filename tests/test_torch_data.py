"""The port's loader, wire decode and training config held against the JAX
package: the same (seed, epoch) must give the same batches, the decode the
same floats, and the environment the same config."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core import config as jax_config
from dcnn_tpu.data import loader as jax_loader
from dcnn_tpu.data import wire as jax_wire
from dcnn_tpu_torch.core import config
from dcnn_tpu_torch.data import loader, wire


def _data(n=50, dtype=np.float32):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(n, 3, 4)).astype(dtype)
    return x, loader.one_hot(rng.integers(0, 10, n), 10)


def _epochs(mod, x, y, n_epochs=2, **kw):
    ld = mod.ArrayDataLoader(x, y, **kw)
    out = []
    for epoch in range(1, n_epochs + 1):
        ld.shuffle(epoch)
        out.append([(bx.copy(), by.copy()) for bx, by in ld])
    return ld, out


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_match_jax_for_two_epochs(drop_last, shuffle):
    x, y = _data()
    kw = dict(batch_size=8, shuffle=shuffle, drop_last=drop_last, seed=7)
    ld, got = _epochs(loader, x, y, **kw)
    jld, want = _epochs(jax_loader, x, y, **kw)
    assert len(ld) == len(jld) == (6 if drop_last else 7)
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == len(ld)
        for (gx, gy), (wx, wy) in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    if shuffle:  # a new epoch is a new order
        assert not np.array_equal(got[0][0][0], got[1][0][0])


def test_uint8_augmentation_requantises_like_jax():
    """The hook continues the epoch's generator after the permutation; on a
    uint8 loader it runs in float32 and the result is clipped, rounded and
    cast back to uint8."""
    x, y = _data(dtype=np.uint8)

    def aug(xb, rng):
        return xb * 1.3 + rng.normal(0, 20, size=xb.shape)

    kw = dict(batch_size=16, seed=3, augmentation=aug)
    ld, got = _epochs(loader, x, y, **kw)
    _, want = _epochs(jax_loader, x, y, **kw)
    assert ld.wire_dtype == np.uint8 and ld.scale == 1.0 / 255.0
    for g_epoch, w_epoch in zip(got, want):
        for (gx, _), (wx, _) in zip(g_epoch, w_epoch):
            assert gx.dtype == np.uint8
            np.testing.assert_array_equal(gx, wx)


def test_shard_batch_indices_match_jax():
    x, y = _data()
    ld = loader.ArrayDataLoader(x, y, batch_size=8, seed=1)
    jld = jax_loader.ArrayDataLoader(x, y, batch_size=8, seed=1)
    for rank in range(4):
        for a, b in zip(ld.shard_batch_indices(rank, 4),
                        jld.shard_batch_indices(rank, 4)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_decode_matches_jax(dtype):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16).astype(dtype)
    got = wire.decode_batch(torch.from_numpy(x), wire.WIRE_SCALE_U8)
    want = np.asarray(jax_wire.decode_batch(jnp.asarray(x),
                                            jax_wire.WIRE_SCALE_U8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # bit-identical
    ld = loader.ArrayDataLoader(x, np.zeros((16, 1)))
    assert wire.wire_scale(ld) == jax_wire.wire_scale(
        jax_loader.ArrayDataLoader(x, np.zeros((16, 1))))
    assert wire.wire_scale(object()) == wire.WIRE_SCALE_U8


def test_training_config_fields_match_jax():
    """Same fields and defaults as the JAX config, except the device."""
    got = dataclasses.asdict(config.TrainingConfig())
    want = dataclasses.asdict(jax_config.TrainingConfig())
    assert got.pop("device_type") == "cuda" and want.pop("device_type") == "tpu"
    got["profiler"] = got["profiler"].value
    want["profiler"] = want["profiler"].value
    assert got == want
    assert [p.value for p in config.ProfilerType] == \
        [p.value for p in jax_config.ProfilerType]


def test_load_from_env_reads_the_same_variables(monkeypatch):
    env = {"EPOCHS": "3", "BATCH_SIZE": "16", "LEARNING_RATE": "0.05",
           "LR_DECAY_FACTOR": "0.5", "NUM_MICROBATCHES": "2",
           "DEVICE_TYPE": "cpu", "PROFILER_TYPE": "Cumulative", "SEED": "9",
           "SNAPSHOT_DIR": "snaps", "SCHEDULER_STEP": "batch",
           "CKPT_ASYNC": "off", "STALL_TIMEOUT_S": "2.5", "ELASTIC": "yes",
           "METRICS_PORT": "0", "AOT_CACHE": "/cache", "DCNN_DEBUG": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = config.TrainingConfig.load_from_env().to_dict()
    want = jax_config.TrainingConfig.load_from_env().to_dict()
    assert got == want
    assert got["epochs"] == 3 and got["profiler"] == "cumulative"
    monkeypatch.setenv("ELASTIC", "maybe")
    with pytest.raises(ValueError, match="not a boolean"):
        config.TrainingConfig.load_from_env()
