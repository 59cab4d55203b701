"""The port's device feed held against the JAX package on the CPU.

- The nine device augmentations: each op's apply, fed the JAX op's own
  draws (the JAX package's key splits, re-drawn here), gives the JAX op's
  output bit for bit in fp32, but for ``contrast``, whose per-image mean
  XLA sums in another order (within 4 ulp of the data scale), and
  ``rotation`` (within 1e-5: the bilinear weights in another order).
- The resident epoch and eval, ``make_multi_step``, the shard step, and
  ``Trainer.fit`` over a ``DeviceDataset`` (with and without augmentation),
  over ``PrefetchLoader(stage_batches=K)`` with ``steps_per_dispatch=K``,
  over ``PrefetchLoader(feed_workers=N)`` and through
  ``train_streaming_epoch``: given the JAX package's batch order (and its
  augmentation draws), losses and params at ``test_torch_train.py``'s TOL
  (atol 1e-5, rtol 1e-4).
- The port's own invariants: the resident epoch equals the port's per-step
  loop bit for bit; resident eval equals the host eval of the same split
  bit for bit; one key gives one run.
- The refusals: the data-parallel names, ``nonfinite_policy`` with the fast
  paths, a chunked trainer fed unchunked batches.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.data import ArrayDataLoader as JaxLoader
from dcnn_tpu.data import DeviceDataset as JaxDeviceDataset
from dcnn_tpu.data import PrefetchLoader as JaxPrefetch
from dcnn_tpu.data import StreamingDeviceDataset as JaxStreaming
from dcnn_tpu.data import augment_device as jad
from dcnn_tpu.data import device_dataset as jdd
from dcnn_tpu.data import streaming as jstream
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.ops.losses import get_loss as jax_get_loss
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import WarmupCosineAnnealing as JaxWarmupCosine
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.core.keys import fold_in, split
from dcnn_tpu_torch.data import (
    ArrayDataLoader, AugmentationBuilder, DeviceAugment,
    DeviceAugmentBuilder, DeviceDataset, PrefetchLoader,
    ShardedDeviceDataset, StreamingDeviceDataset, TransferEngine,
    make_resident_epoch, make_resident_epoch_dp, make_resident_eval,
    make_shard_step, resident_epoch_dp, stage_sharded, train_streaming_epoch,
)
from dcnn_tpu_torch.data import augment_device as pad
from dcnn_tpu_torch.data import device_dataset as pdd
from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, Adam, WarmupCosineAnnealing
from dcnn_tpu_torch.resilience import faults
from dcnn_tpu_torch.train import (
    Trainer, create_train_state, evaluate_classification, make_multi_step,
    make_train_step,
)

TOL = dict(atol=1e-5, rtol=1e-4)
LOSS = "softmax_crossentropy"
EPS32 = float(np.finfo(np.float32).eps)


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _close_trees(got, want, **tol):
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, **tol)


def _jax_cnn(hw=8):
    return (JaxBuilder(name="dd_cnn", data_format="NHWC").input((hw, hw, 1))
            .conv2d(8, 3, padding=1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(16).activation("relu").dense(4)
            .build())


def _blobs(n=96, hw=8, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    base = (y[:, None, None, None] * (200 // n_classes) + 20).astype(
        np.float32)
    x = np.clip(base + rng.normal(0, 10, size=(n, hw, hw, 1)), 0, 255)
    return x.astype(np.uint8), y.astype(np.int64)


def _pair(seed=0):
    """The narrow CNN in JAX (params, state) and carried to the port."""
    jm = _jax_cnn()
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = from_jax(jm.get_config(), _numpy(params), _numpy(state),
                  device="cpu")
    return jm, params, state, tm


def _jax_perm(rng, n, k, b):
    """The batch order ``make_resident_epoch`` draws from ``rng``."""
    kperm, _ = jax.random.split(rng)
    reps = -(-k * b // n)
    perm = np.concatenate([np.asarray(jax.random.permutation(
        jax.random.fold_in(kperm, r), n)) for r in range(reps)])
    return perm[:k * b].reshape(k, b)


# -- device augmentation --------------------------------------------------------

def _jax_draws(name, key, x, kw):
    """The JAX op's draws from ``key``: its own splits, in its order."""
    n = x.shape[0]
    u = lambda k: jax.random.uniform(k, (n,))  # noqa: E731
    ha, wa = (2, 3) if kw.get("data_format") == "NCHW" else (1, 2)
    if name in ("brightness", "contrast"):
        km, ks = jax.random.split(key)
        lo, hi = ((-kw["delta"], kw["delta"]) if name == "brightness"
                  else (kw["lower"], kw["upper"]))
        return u(km) < kw["p"], jax.random.uniform(ks, (n,), x.dtype, lo, hi)
    if name == "gaussian_noise":
        km, kn = jax.random.split(key)
        return u(km) < kw["p"], jax.random.normal(kn, x.shape, x.dtype)
    if name in ("horizontal_flip", "vertical_flip"):
        return (u(key) < kw["p"],)
    if name == "cutout":
        km, ky, kx = jax.random.split(key, 3)
        return (u(km) < kw["p"], jax.random.randint(ky, (n,), 0, x.shape[ha]),
                jax.random.randint(kx, (n,), 0, x.shape[wa]))
    if name == "random_crop":
        km, ky, kx = jax.random.split(key, 3)
        hi = 2 * kw["padding"] + 1
        return (u(km) < kw["p"], jax.random.randint(ky, (n,), 0, hi),
                jax.random.randint(kx, (n,), 0, hi))
    if name == "rotation":
        km, ka = jax.random.split(key)
        return (u(km) < kw["p"], jax.random.uniform(
            ka, (n,), jnp.float32, -kw["max_degrees"], kw["max_degrees"]))
    return ()


def _ops(fmt):
    return [("brightness", dict(delta=0.2, p=0.5)),
            ("contrast", dict(lower=0.8, upper=1.2, p=0.5)),
            ("cutout", dict(size=4, p=0.7, data_format=fmt)),
            ("gaussian_noise", dict(std=0.05, p=0.5)),
            ("horizontal_flip", dict(p=0.5, data_format=fmt)),
            ("vertical_flip", dict(p=0.5, data_format=fmt)),
            ("normalization", dict(mean=[0.1, 0.2, 0.3], std=[0.5, 0.6, 0.7],
                                   data_format=fmt)),
            ("random_crop", dict(padding=3, p=0.8, data_format=fmt)),
            ("rotation", dict(max_degrees=30.0, p=0.8, data_format=fmt))]


def _torch_draws(draws):
    return tuple(torch.from_numpy(np.array(a)) for a in draws)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("which", range(9))
def test_device_op_apply_equals_jax_given_its_draws(fmt, which):
    name, kw = _ops(fmt)[which]
    rng = np.random.default_rng(which)
    shape = (6, 3, 12, 10) if fmt == "NCHW" else (6, 12, 10, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(3 + which)
    want = np.asarray(getattr(jad, name)(**kw)(jnp.asarray(x), key))
    op = getattr(pad, name)(**kw)
    got = op.apply(torch.from_numpy(x),
                   _torch_draws(_jax_draws(name, key, jnp.asarray(x), kw)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    if name == "contrast":
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * EPS32 * float(np.abs(x).max()))
    elif name == "rotation":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_device_ops_draw_on_the_batch_device_and_are_keyed(fmt):
    x = torch.rand((5, 3, 9, 9) if fmt == "NCHW" else (5, 9, 9, 3),
                   generator=torch.Generator().manual_seed(0))
    aug = (DeviceAugmentBuilder(fmt).brightness().contrast().cutout(3)
           .gaussian_noise().horizontal_flip().vertical_flip()
           .random_crop(2).rotation(20.0).build())
    a, b = aug(x, 11), aug(x, 11)
    assert torch.equal(a, b) and a.shape == x.shape
    assert not torch.equal(a, aug(x, 12))
    # op i draws from fold_in(key, i): the pipeline is its ops in turn
    y = x
    for i, op in enumerate(aug.ops):
        y = op(y, fold_in(11, i))
    assert torch.equal(a, y)
    for op in aug.ops:
        for d in op.draw(x, torch.Generator().manual_seed(1)):
            assert d.device == x.device
    # p = 0 leaves the batch as it is; p = 1 flips every sample
    off = DeviceAugment([pad.horizontal_flip(0.0, fmt),
                         pad.random_crop(2, 0.0, fmt),
                         pad.rotation(15.0, 0.0, fmt)])
    assert torch.equal(off(x, 3), x)
    wa = 3 if fmt == "NCHW" else 2
    assert torch.equal(pad.horizontal_flip(1.0, fmt)(x, 4),
                       torch.flip(x, (wa,)))


def test_device_normalization_equals_host_and_crop_cutout_shapes():
    from dcnn_tpu_torch.data.augment import Normalization

    x = np.random.default_rng(1).uniform(0, 1, (4, 3, 6, 6)).astype(
        np.float32)
    dev = pad.normalization([0.4, 0.5, 0.6], [0.2, 0.3, 0.4], "NCHW")
    host = Normalization([0.4, 0.5, 0.6], [0.2, 0.3, 0.4], "NCHW")
    np.testing.assert_allclose(dev(torch.from_numpy(x), 0).numpy(),
                               host(x.copy(), np.random.default_rng(0)),
                               rtol=1e-6, atol=1e-6)
    ones = torch.ones(3, 8, 8, 1)
    cut = pad.cutout(4, 1.0, "NHWC")(ones, 5)
    assert ((cut == 0).sum(dim=(1, 2, 3)) > 0).all()
    img = torch.arange(64, dtype=torch.float32).reshape(1, 1, 8, 8)
    shifted = pad.RandomCrop(2, 1.0, "NCHW").apply(
        img, (torch.tensor([True]), torch.tensor([0]), torch.tensor([4])))
    # offset (0, 4): rows start 2 above the image, columns 2 to the right
    assert torch.equal(shifted[0, 0, 2:, :6], img[0, 0, :6, 2:])
    assert (shifted[0, 0, :2] == 0).all()


def test_device_rotation_small_angle_and_layouts_agree():
    x = torch.rand(3, 2, 10, 10, generator=torch.Generator().manual_seed(2))
    draws = (torch.tensor([True, True, False]),
             torch.tensor([0.0, 90.0, 45.0]))
    nchw = pad.Rotation(90.0, 1.0, "NCHW").apply(x, draws)
    nhwc = pad.Rotation(90.0, 1.0, "NHWC").apply(
        x.permute(0, 2, 3, 1).contiguous(), draws)
    assert torch.equal(nchw, nhwc.permute(0, 3, 1, 2))
    torch.testing.assert_close(nchw[0], x[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(nchw[2], x[2], rtol=0, atol=0)
    # +90 degrees: output (y, x) samples input (x, W-1-y), a clockwise turn
    torch.testing.assert_close(nchw[1], torch.rot90(x[1], -1, (1, 2)),
                               rtol=0, atol=1e-5)


# -- the resident dataset ---------------------------------------------------------

def test_stage_geometry_one_hot_and_validation():
    x, y = _blobs(n=50)
    ds = DeviceDataset(x, y, 4, batch_size=16, device="cpu")
    assert ds.steps_per_epoch == len(ds) == 3 and ds.num_samples == 50
    assert ds.x.dtype == torch.uint8 and ds.y.dtype == torch.int32
    assert ds.hbm_bytes == x.nbytes + 50 * 4
    assert ds.scale == pytest.approx(1 / 255) and ds.stage_seconds >= 0
    np.testing.assert_array_equal(ds.x.numpy(), x)
    oh = DeviceDataset(x, np.eye(4)[y], 4, batch_size=4, device="cpu")
    np.testing.assert_array_equal(oh.y.numpy(), y)
    with pytest.raises(ValueError, match="mismatch"):
        DeviceDataset(x, y[:-1], 4, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        DeviceDataset(x, y, 4, batch_size=51, device="cpu")
    ld = ArrayDataLoader(x, np.eye(4, dtype=np.float32)[y], batch_size=8,
                         augmentation=AugmentationBuilder().build())
    with pytest.warns(UserWarning, match="DeviceAugmentBuilder"):
        fl = DeviceDataset.from_loader(ld, 4, device="cpu")
    assert fl.batch_size == 8
    np.testing.assert_array_equal(fl.y.numpy(), y)
    with TransferEngine(num_chunks=3, reassemble="concat",
                        device="cpu") as eng:
        staged = DeviceDataset(x, y, 4, batch_size=8, transfer_engine=eng,
                               device="cpu")
    np.testing.assert_array_equal(staged.x.numpy(), x)


@pytest.mark.parametrize("steps,lr", [(None, 0.05), (10, "vector")])
def test_resident_epoch_matches_jax_given_its_order(steps, lr):
    """``steps=10 > n // B`` tiles a second permutation; the lr vector
    carries a per-batch schedule."""
    x, y = _blobs(n=40 if steps is None else 32)
    jm, params, state, tm = _pair(3)
    k = steps or len(x) // 8
    lrs = np.linspace(0.05, 0.01, k).astype(np.float32)
    lr_j = jnp.asarray(lrs) if lr == "vector" else lr
    lr_p = lrs if lr == "vector" else lr
    jopt, opt = JaxSGD(0.05, momentum=0.9), SGD(0.05, momentum=0.9)
    ts_j = jax_trainer.TrainState(params, state, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    ts_j, want = jdd.make_resident_epoch(
        jm, jax_get_loss(LOSS), jopt, num_classes=4, batch_size=8,
        steps=steps)(ts_j, jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
                     rng, lr_j)
    ds = DeviceDataset(x, y, 4, batch_size=8, device="cpu")
    ts = create_train_state(tm, opt)
    ts, got = make_resident_epoch(tm, get_loss(LOSS), opt, num_classes=4,
                                  batch_size=8, steps=steps)(
        ts, ds.x, ds.y, 1, lr_p, order=_jax_perm(rng, len(x), k, 8))
    assert ts.step == k
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)
    _close_trees(state_to_jax(tm), _numpy(ts_j.state), **TOL)


def test_resident_epoch_microbatched_matches_jax():
    x, y = _blobs(n=32)
    jm, params, state, tm = _pair(4)
    jopt, opt = JaxSGD(0.05), SGD(0.05)
    ts_j = jax_trainer.TrainState(params, state, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(11)
    ts_j, want = jdd.make_resident_epoch(
        jm, jax_get_loss(LOSS), jopt, num_classes=4, batch_size=16,
        num_microbatches=4)(ts_j, jnp.asarray(x),
                            jnp.asarray(y.astype(np.int32)), rng, 0.05)
    ds = DeviceDataset(x, y, 4, batch_size=16, device="cpu")
    ts, got = make_resident_epoch(tm, get_loss(LOSS), opt, num_classes=4,
                                  batch_size=16, num_microbatches=4)(
        create_train_state(tm, opt), ds.x, ds.y, 0, 0.05,
        order=_jax_perm(rng, 32, 2, 16))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)


def test_resident_epoch_equals_the_ports_step_loop_bit_for_bit():
    x, y = _blobs(n=40)
    _, _, _, tm = _pair(5)
    ref = from_jax(tm.get_config(), to_jax(tm), state_to_jax(tm),
                   device="cpu")
    opt = Adam(2e-3)
    ds = DeviceDataset(x, y, 4, batch_size=8, device="cpu")
    epoch = make_resident_epoch(tm, get_loss(LOSS), opt, num_classes=4,
                                batch_size=8)
    ts, mean = epoch(create_train_state(tm, opt), ds.x, ds.y, 9, 2e-3)
    # the permutation the epoch drew from its key, replayed on the host
    idx = pdd.permutation(split(9)[0], 40, 40, torch.device("cpu"))
    idx = idx.reshape(5, 8).numpy()
    ts_r = create_train_state(ref, opt)
    step = make_train_step(ref, get_loss(LOSS), opt)
    losses = []
    for i in range(5):
        xb = torch.from_numpy(x[idx[i]]).float() * (1 / 255)
        yb = torch.from_numpy(np.eye(4, dtype=np.float32)[y[idx[i]]])
        losses.append(step(ts_r, xb, yb, 2e-3)[0])
    assert float(mean) == float(torch.stack(losses).mean())
    for a, b in zip(tm.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)
    # one key, one run; another key, another order
    again = from_jax(ref.get_config(), to_jax(ref), state_to_jax(ref),
                     device="cpu")
    _, m1 = epoch(create_train_state(tm, opt), ds.x, ds.y, 9, 2e-3)
    e2 = make_resident_epoch(again, get_loss(LOSS), opt, num_classes=4,
                             batch_size=8)
    assert float(m1) == float(e2(create_train_state(again, opt), ds.x, ds.y,
                                 9, 2e-3)[1])


def test_resident_epoch_rejects_sub_batch_split_and_bad_order():
    x, y = _blobs(n=4)
    _, _, _, tm = _pair()
    ep = make_resident_epoch(tm, get_loss(LOSS), SGD(0.05), num_classes=4,
                             batch_size=8)
    ts = create_train_state(tm, SGD(0.05))
    with pytest.raises(ValueError, match="at least one batch"):
        ep(ts, torch.from_numpy(x), torch.from_numpy(y), 1, 0.05)
    x, y = _blobs(n=16)
    with pytest.raises(ValueError, match="order must be"):
        ep(ts, torch.from_numpy(x), torch.from_numpy(y), 1, 0.05,
           order=np.zeros((2, 4), np.int64))
    with pytest.raises(ValueError, match="lr vector"):
        ep(ts, torch.from_numpy(x), torch.from_numpy(y), 1, [0.1, 0.2, 0.3])


@pytest.mark.parametrize("loss", ["softmax_crossentropy", "mse"])
def test_resident_eval_equals_jax_and_the_host_eval(loss):
    """Full batches and an exact remainder (37 = 4 x 8 + 5): equal to the
    JAX package's resident eval at TOL, and to the port's host eval of the
    same batches bit for bit."""
    x, y = _blobs(n=37, seed=2)
    jm, params, state, tm = _pair(6)
    want = jax_trainer.evaluate_classification(
        jm, params, state, jax_get_loss(loss),
        JaxDeviceDataset(x, y, 4, batch_size=8))
    ds = DeviceDataset(x, y, 4, batch_size=8, device="cpu")
    got = evaluate_classification(tm, get_loss(loss), ds)
    np.testing.assert_allclose(got, want, **TOL)
    host = ArrayDataLoader(x, np.eye(4, dtype=np.float32)[y], batch_size=8,
                           shuffle=False, drop_last=False)
    assert got == evaluate_classification(tm, get_loss(loss), host)
    loss_sum, correct, n = make_resident_eval(
        tm, get_loss(loss), num_classes=4, batch_size=8)(ds.x, ds.y,
                                                         ds.scale)
    assert n == 37 and loss_sum.dtype == torch.float64
    assert int(correct) / 37 == got[1]


class _JaxDraws:
    """A device augmentation that applies the port's ops to the JAX
    package's draws for the same step: the JAX trainer's key derivation,
    the calls counted in step order."""

    def __init__(self, jax_aug, port_ops, seed, steps):
        self.jax_aug, self.ops = jax_aug, port_ops
        self.seed, self.steps, self.calls = seed, steps, 0

    def __call__(self, xb, key):
        epoch, i = divmod(self.calls, self.steps)
        epoch += 1
        self.calls += 1
        rng = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)
        _, kstep = jax.random.split(jax.random.fold_in(rng, epoch))
        aug_key = jax.random.fold_in(jax.random.fold_in(kstep, i), 0x0A6)
        for j, ((name, kw), op) in enumerate(zip(self.jax_aug, self.ops)):
            draws = _jax_draws(name, jax.random.fold_in(aug_key, j),
                               jnp.asarray(xb.numpy()), kw)
            xb = op.apply(xb, _torch_draws(draws))
        return xb


@pytest.mark.parametrize("augmented", [False, True])
def test_trainer_fit_resident_matches_jax(augmented, monkeypatch):
    """``Trainer.fit`` over a ``DeviceDataset`` (3 epochs, SGD with
    momentum, a per-batch warmup-cosine schedule, resident validation)
    against the JAX trainer, the port given the JAX epochs' permutations
    and, augmented, their draws. (SGD, not Adam: the conv bias before the
    BN has an exactly-zero gradient in exact arithmetic, which Adam turns
    into full-size steps of either sign from rounding noise.)"""
    x, y = _blobs(n=64, seed=4)
    xv, yv = _blobs(n=24, seed=9)
    jm, params, state, tm = _pair(8)
    recipe = [("horizontal_flip", dict(p=0.5, data_format="NHWC")),
              ("random_crop", dict(padding=1, p=1.0, data_format="NHWC"))]
    jaug = (jad.DeviceAugmentBuilder("NHWC").horizontal_flip(0.5)
            .random_crop(1).build()) if augmented else None
    sched = dict(warmup_steps=3, total_steps=12, start_lr=1e-3)
    kw = dict(learning_rate=0.05, snapshot_dir=None, progress_interval=0,
              scheduler_step="batch", seed=5)
    jopt = JaxSGD(0.05, momentum=0.9)
    jt = jax_trainer.Trainer(jm, jopt, LOSS, JaxConfig(**kw),
                             JaxWarmupCosine(0.05, **sched))
    ts_j = jt.fit(jax_trainer.TrainState(params, state, jopt.init(params),
                                         jnp.zeros((), jnp.int32)),
                  JaxDeviceDataset(x, y, 4, batch_size=16, augment=jaug),
                  JaxDeviceDataset(xv, yv, 4, batch_size=16), epochs=3)

    perms = [torch.from_numpy(_jax_perm(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(5), e), e), 64, 4, 16)
        .reshape(-1)) for e in (1, 2, 3)]
    monkeypatch.setattr(pdd, "permutation", lambda *a: perms.pop(0))
    aug = (_JaxDraws(recipe, [pad.HorizontalFlip(0.5, "NHWC"),
                              pad.RandomCrop(1, 1.0, "NHWC")], 5, 4)
           if augmented else None)
    opt = SGD(0.05, momentum=0.9)
    tt = Trainer(tm, opt, LOSS, TrainingConfig(device_type="cpu", **kw),
                 WarmupCosineAnnealing(0.05, **sched))
    tt.fit(create_train_state(tm, opt),
           DeviceDataset(x, y, 4, batch_size=16, augment=aug, device="cpu"),
           DeviceDataset(xv, yv, 4, batch_size=16, device="cpu"), epochs=3)
    assert perms == [] and (aug is None or aug.calls == 12)
    assert sorted(tt.history[0]) == sorted(jt.history[0])
    for got, want in zip(tt.history, jt.history):
        assert np.isnan(got["train_acc"]) and np.isnan(want["train_acc"])
        for k in ("train_loss", "val_loss", "val_acc"):
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)


def test_trainer_fit_resident_trains_and_snapshots(tmp_path):
    from dcnn_tpu_torch.train import load_checkpoint

    x, y = _blobs(n=128, seed=1)
    xv, yv = _blobs(n=40, seed=9)
    _, _, _, tm = _pair(0)
    opt = Adam(2e-3)
    tr = Trainer(tm, opt, LOSS, TrainingConfig(
        device_type="cpu", learning_rate=2e-3, progress_interval=0,
        snapshot_dir=str(tmp_path)))
    tr.fit(create_train_state(tm, opt),
           DeviceDataset(x, y, 4, batch_size=16, device="cpu"),
           DeviceDataset(xv, yv, 4, batch_size=16, device="cpu"), epochs=8)
    assert max(h["val_acc"] for h in tr.history) >= 0.9
    assert tr.history[-1]["train_loss"] < tr.history[0]["train_loss"]
    meta = load_checkpoint(str(tmp_path / tm.name), device="cpu")[-1]
    assert isinstance(meta["val_acc"], float)


def test_multi_step_matches_jax():
    """K=3 steps of the narrow CNN in one call, a [K] lr vector."""
    x, y = _blobs(n=24)
    jm, params, state, tm = _pair(9)
    xs = (x.astype(np.float32) / 255).reshape(3, 8, 8, 8, 1)
    ys = np.eye(4, dtype=np.float32)[y].reshape(3, 8, 4)
    lrs = np.array([0.05, 0.03, 0.01], np.float32)
    jopt, opt = JaxSGD(0.05, momentum=0.9), SGD(0.05, momentum=0.9)
    ts_j = jax_trainer.TrainState(params, state, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    ts_j, want = jax_trainer.make_multi_step(jm, jax_get_loss(LOSS), jopt)(
        ts_j, jnp.asarray(xs), jnp.asarray(ys), jax.random.PRNGKey(0),
        jnp.asarray(lrs))
    ts, got = make_multi_step(tm, get_loss(LOSS), opt)(
        create_train_state(tm, opt), torch.from_numpy(xs),
        torch.from_numpy(ys), 0, torch.from_numpy(lrs))
    assert ts.step == 3 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)


def _fit_pair(port_loader, jax_loader, epochs=2, spd=1, sched=True):
    """Both trainers from the same weights: SGD with momentum (see
    test_trainer_fit_resident_matches_jax for why not Adam)."""
    jm, params, state, tm = _pair(10)
    kw = dict(learning_rate=0.05, snapshot_dir=None, progress_interval=0,
              scheduler_step="batch", steps_per_dispatch=spd)
    sk = dict(warmup_steps=2, total_steps=8, start_lr=1e-3)
    jopt = JaxSGD(0.05, momentum=0.9)
    jt = jax_trainer.Trainer(jm, jopt, LOSS, JaxConfig(**kw),
                             JaxWarmupCosine(0.05, **sk) if sched else None)
    ts_j = jt.fit(jax_trainer.TrainState(params, state, jopt.init(params),
                                         jnp.zeros((), jnp.int32)),
                  jax_loader, epochs=epochs)
    opt = SGD(0.05, momentum=0.9)
    tt = Trainer(tm, opt, LOSS, TrainingConfig(device_type="cpu", **kw),
                 WarmupCosineAnnealing(0.05, **sk) if sched else None)
    ts = tt.fit(create_train_state(tm, opt), port_loader, epochs=epochs)
    assert sorted(tt.history[0]) == sorted(jt.history[0])
    for got, want in zip(tt.history, jt.history):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   **TOL)
        assert np.isnan(got["train_acc"]) == np.isnan(want["train_acc"])
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)
    return tt, ts


def test_trainer_fit_chunked_prefetch_matches_jax():
    """``PrefetchLoader(stage_batches=2)`` with ``steps_per_dispatch=2``:
    uint8 batches decoded after the copy, 2 steps per chunk, the per-batch
    lrs as vectors."""
    x, y = _blobs(n=64, seed=3)
    oh = np.eye(4, dtype=np.float32)[y]
    with PrefetchLoader(ArrayDataLoader(x, oh, batch_size=16, seed=2),
                        stage_batches=2, device="cpu") as pf:
        tt, ts = _fit_pair(pf, JaxPrefetch(JaxLoader(x, oh, batch_size=16,
                                                     seed=2),
                                           stage_batches=2), spd=2)
    assert ts.step == 8 and np.isnan(tt.history[0]["train_acc"])


@pytest.mark.parametrize("decoupled", [True, False])
def test_chunked_epoch_equals_the_per_step_epoch_bit_for_bit(decoupled):
    """Two epochs of the narrow CNN chunked (``PrefetchLoader(
    stage_batches=2)``, ``steps_per_dispatch=2``, the per-batch lrs as a
    vector) and per step (the lr a float), Adam with weight decay (AdamW's
    decoupled form and the L2 form) under a per-batch warmup-cosine
    schedule: params and running statistics bit for bit. The per-step path
    used to take ``wd·lr`` in double where the vector's product is fp32,
    an ulp apart at some lrs; a large decay makes that visible here."""
    x, y = _blobs(n=64, seed=3)
    oh = np.eye(4, dtype=np.float32)[y]
    runs = []
    for spd in (1, 2):
        tm = _pair(10)[3]
        opt = Adam(0.03, weight_decay=0.9, decouple_weight_decay=decoupled)
        ld = ArrayDataLoader(x, oh, batch_size=8, seed=1)
        if spd > 1:
            ld = PrefetchLoader(ld, stage_batches=spd, device="cpu")
        tr = Trainer(tm, opt, LOSS, TrainingConfig(
            device_type="cpu", learning_rate=0.03, snapshot_dir=None,
            progress_interval=0, scheduler_step="batch",
            steps_per_dispatch=spd),
            WarmupCosineAnnealing(0.03, warmup_steps=2, total_steps=16))
        ts = tr.fit(create_train_state(tm, opt), ld, epochs=2)
        runs.append((tr, ts, [t.clone() for t in tm.state_dict().values()]))
    (a, ts_a, sa), (b, ts_b, sb) = runs
    assert ts_a.step == ts_b.step == 16
    assert all(torch.equal(u, v) for u, v in zip(sa, sb))
    for p, q in zip(a.history, b.history):
        # the chunk's mean loss is summed in fp32, the per-step one in double
        assert q["train_loss"] == pytest.approx(p["train_loss"], rel=1e-6)


def test_trainer_fit_feed_workers_matches_jax():
    """``PrefetchLoader(feed_workers=2)`` (the port's spawned workers)
    through the per-step loop against the JAX package's pooled loader."""
    x, y = _blobs(n=48, seed=6)
    oh = np.eye(4, dtype=np.float32)[y]
    with PrefetchLoader(ArrayDataLoader(x, oh, batch_size=8, seed=1),
                        feed_workers=2, device="cpu") as pf, \
            JaxPrefetch(JaxLoader(x, oh, batch_size=8, seed=1),
                        feed_workers=2) as jpf:
        _fit_pair(pf, jpf, epochs=1, sched=False)


def _shard_pair(seed=12):
    jm, params, state, tm = _pair(seed)
    jopt, opt = JaxSGD(0.05), SGD(0.05)
    ts_j = jax_trainer.TrainState(params, state, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    return jm, jopt, ts_j, tm, opt


def test_shard_step_matches_jax_given_its_order(monkeypatch):
    x, y = _blobs(n=24)
    jm, jopt, ts_j, tm, opt = _shard_pair()
    rng = jax.random.PRNGKey(7)
    ts_j, want = jstream.make_shard_step(
        jm, jax_get_loss(LOSS), jopt, num_classes=4, batch_size=8,
        shard_batches=3)(ts_j, jnp.asarray(x),
                         jnp.asarray(y.astype(np.int32)), rng, 0.05)
    perm = np.asarray(jax.random.permutation(jax.random.split(rng)[0], 24))
    monkeypatch.setattr(pdd, "permutation",
                        lambda *a: torch.from_numpy(perm))
    step = make_shard_step(tm, get_loss(LOSS), opt, num_classes=4,
                           batch_size=8, shard_batches=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int32))
    ts, got = step(create_train_state(tm, opt), xt.chunk(3), yt, 1, 0.05)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)
    with pytest.raises(ValueError, match="exactly 3x8"):
        step(ts, xt[:16], yt, 1, 0.05)


@pytest.mark.parametrize("workers", [0, 2])
def test_train_streaming_epoch_matches_jax(workers, monkeypatch):
    """Two epochs of 2 shards of 2 batches: the same host shard plan
    (numpy's), the JAX shard permutations handed to the port; with
    ``workers=2`` the port's shards come from its worker pool (threads)."""
    x, y = _blobs(n=72, seed=5)
    jm, jopt, ts_j, tm, opt = _shard_pair(13)
    jds = JaxStreaming(x, y, 4, batch_size=8, shard_batches=2, seed=3)
    jstep = jstream.make_shard_step(jm, jax_get_loss(LOSS), jopt,
                                    num_classes=4, batch_size=8,
                                    shard_batches=2)
    want, perms = [], []
    for e in range(2):
        key = jax.random.PRNGKey(20 + e)
        ts_j, loss = jstream.train_streaming_epoch(jstep, ts_j, jds, key,
                                                   0.05)
        want.append(loss)
        perms += [torch.from_numpy(np.array(jax.random.permutation(
            jax.random.split(jax.random.fold_in(key, i))[0], 16)))
            for i in range(jds.num_shards)]
    monkeypatch.setattr(pdd, "permutation", lambda *a: perms.pop(0))
    ds = StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=2,
                                seed=3)
    step = make_shard_step(tm, get_loss(LOSS), opt, num_classes=4,
                           batch_size=8, shard_batches=2)
    ts = create_train_state(tm, opt)
    from dcnn_tpu_torch.data import FeedWorkerPool
    pool = (FeedWorkerPool(ds.x, ds.y, 16, num_workers=workers,
                           backend="thread", poll_s=0.02)
            if workers else None)
    got, timeline = [], []
    for e in range(2):
        ts, loss = train_streaming_epoch(step, ts, ds, e, 0.05,
                                         worker_pool=pool, epoch=e,
                                         timeline=timeline)
        got.append(loss)
    if pool is not None:
        pool.close()
    assert perms == [] and ts.step == 2 * ds.steps_per_epoch == 16
    assert len(timeline) == 2 * ds.num_shards
    np.testing.assert_allclose(got, want, **TOL)
    _close_trees(to_jax(tm), _numpy(ts_j.params), **TOL)
    assert all(("prep" in t) == bool(workers) for t in timeline)
    assert all(t["bytes"] == 16 * 64 for t in timeline)


def test_streaming_shards_bit_identical_across_feeds():
    """The shards the step receives are the serial shards' bytes whatever
    carries them: the default engine, one monolithic copy, the pool."""
    x, y = _blobs(n=64, seed=7)
    _, _, _, tm = _pair(1)
    seen = {}

    def recorder(name):
        def step(ts, sx, sy, key, lr):
            sx = torch.cat(sx) if isinstance(sx, tuple) else sx
            seen.setdefault(name, []).append((sx.numpy().copy(),
                                              sy.numpy().copy()))
            return ts, torch.zeros(())
        return step

    ts = create_train_state(tm, SGD(0.1))
    feeds = {
        "default": {},
        "mono": {"engine": TransferEngine(num_chunks=1, num_threads=1,
                                          reassemble="concat",
                                          device="cpu")},
        "pool": {"workers": 2},
    }
    for name, kw in feeds.items():
        ds = StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=2,
                                    seed=4)
        train_streaming_epoch(recorder(name), ts, ds, 0, 0.1, **kw)
    feeds["mono"]["engine"].close()
    ref = StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=2,
                                 seed=4)
    want = list(ref.shards())
    for name in feeds:
        assert len(seen[name]) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(seen[name], want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_streaming_geometry_and_failures():
    x, y = _blobs(n=40)
    with pytest.raises(ValueError, match="smaller than one shard"):
        StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=8)
    with pytest.raises(ValueError, match="mismatch"):
        StreamingDeviceDataset(x, y[:-1], 4, batch_size=8)
    ds = StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=2)
    assert ds.num_shards == 2 and ds.steps_per_epoch == 4
    _, _, _, tm = _pair(2)
    step = make_shard_step(tm, get_loss(LOSS), SGD(0.05), num_classes=4,
                           batch_size=8, shard_batches=2)
    ts = create_train_state(tm, SGD(0.05))
    with faults.FaultPlan().arm("stream.produce", at=1):
        with pytest.raises(faults.InjectedFault):
            train_streaming_epoch(step, ts, ds, 0, 0.05)
    unfenced = TransferEngine(fence=False, device="cpu")
    with pytest.raises(ValueError, match="fenced"):
        train_streaming_epoch(step, ts, ds, 0, 0.05, engine=unfenced,
                              workers=2)
    unfenced.close()

    def dies(*a):
        raise RuntimeError("step failed")

    before = {t for t in threading.enumerate() if t.name == "stream-feed"}
    with pytest.raises(RuntimeError, match="step failed"):
        train_streaming_epoch(dies, ts, ds, 0, 0.05)
    feeders = [t for t in threading.enumerate()
               if t.name == "stream-feed" and t not in before]
    for t in feeders:
        t.join(30.0)
    assert not any(t.is_alive() for t in feeders)


def test_streaming_worker_crash_mid_epoch_completes():
    x, y = _blobs(n=64, seed=8)
    ds = StreamingDeviceDataset(x, y, 4, batch_size=8, shard_batches=2,
                                seed=1)
    want = list(StreamingDeviceDataset(x, y, 4, batch_size=8,
                                       shard_batches=2, seed=1).shards())
    from dcnn_tpu_torch.data import FeedWorkerPool
    got = []

    def record(ts, sx, sy, key, lr):
        got.append(torch.cat(sx).numpy().copy())
        return ts, torch.zeros(())

    _, _, _, tm = _pair(3)
    with faults.FaultPlan().arm("feed.prepare", at=1, times=1,
                                exc=faults.InjectedCrash):
        with FeedWorkerPool(ds.x, ds.y, 16, num_workers=2, backend="thread",
                            poll_s=0.02) as pool:
            train_streaming_epoch(record, create_train_state(tm, SGD(0.1)),
                                  ds, 0, 0.1, worker_pool=pool)
            assert pool.alive_workers() == 1
    assert len(got) == 4
    for g, (wx, _) in zip(got, want):
        np.testing.assert_array_equal(g, wx)


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("fn", [ShardedDeviceDataset, make_resident_epoch_dp,
                                resident_epoch_dp, stage_sharded])
def test_data_parallel_names_raise(fn):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        fn(np.zeros((4, 2)), np.zeros(4), 2, batch_size=2, mesh=None)


def test_guard_refuses_the_fast_paths():
    _, _, _, tm = _pair()
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        Trainer(tm, SGD(0.1), LOSS, TrainingConfig(
            device_type="cpu", nonfinite_policy="skip_step",
            steps_per_dispatch=2))
    tr = Trainer(tm, SGD(0.1), LOSS, TrainingConfig(
        device_type="cpu", nonfinite_policy="skip_step"))
    x, y = _blobs(n=16)
    with pytest.raises(ValueError, match="resident datasets"):
        tr.train_epoch(create_train_state(tm, SGD(0.1)),
                       DeviceDataset(x, y, 4, batch_size=8, device="cpu"))


def test_chunked_trainer_needs_chunks():
    _, _, _, tm = _pair()
    tr = Trainer(tm, SGD(0.1), LOSS, TrainingConfig(
        device_type="cpu", steps_per_dispatch=2, progress_interval=0))
    x, y = _blobs(n=16)
    with pytest.raises(ValueError, match=r"\[K, B, \.\.\.\] chunks"):
        tr.train_epoch(create_train_state(tm, SGD(0.1)), ArrayDataLoader(
            x, np.eye(4, dtype=np.float32)[y], batch_size=8))
