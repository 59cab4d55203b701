"""The port's data-parallel device feed, ``PrefetchLoader(sharding=)`` and
the compiled pipeline's data axis held against the JAX package on the CPU
(twins of ``tests/test_device_dataset.py``'s resident DP cases and
``test_stage_sharded_global_shuffle_debiases_sorted_data``,
``tests/test_prefetch.py::test_prefetch_sharded_placement`` and
``tests/test_compiled_pipeline.py::test_compiled_pipeline_data_parallel_composition``).

The module spawns gloo worlds of 2 and 4 ranks once each
(``tests/test_torch_data_parallel.py``'s ``spawn_world``) and every case
runs in them; the JAX side runs on the same number of the conftest's CPU
devices. Weights come from the JAX package (``interop.from_jax``), batches
from numpy with a seed, and each rank's epoch is handed the JAX package's
per-device batch order (``fold_in(perm_key, device)``'s permutation of its
shard), as the single-device twins are.

Tolerances: losses and params at ``test_torch_train.py``'s ``atol 1e-5,
rtol 1e-4``; the pipeline's loss ``rtol 1e-6``, outputs ``rtol 1e-5, atol
1e-6`` and params ``rtol 1e-5, atol 1e-6`` (the JAX test's own).
Replicated params are bit-identical across the port's ranks.
"""

import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.core.mesh import DATA_AXIS, STAGE_AXIS
from dcnn_tpu.core.mesh import make_mesh as jax_make_mesh
from dcnn_tpu.data import DeviceDataset as JaxDeviceDataset
from dcnn_tpu.data import ShardedDeviceDataset as JaxSharded
from dcnn_tpu.data import device_dataset as jdd
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.layers import Conv2DLayer as JaxConv
from dcnn_tpu.nn.layers import GroupNormLayer as JaxGN
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.ops.losses import softmax_cross_entropy as jax_ce
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import Adam as JaxAdam
from dcnn_tpu.parallel import compiled_pipeline as jcp
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.interop import tree_from_flat
from dcnn_tpu_torch.nn.layers import Conv2DLayer, GroupNormLayer
from dcnn_tpu_torch.nn.residual import ResidualBlock
from dcnn_tpu_torch.optim import SGD
from dcnn_tpu_torch.parallel import (
    SequentialStageStack, make_compiled_pipeline_train_step,
)
from test_torch_data_parallel import spawn_world

TOL = dict(atol=1e-5, rtol=1e-4)
PIPE_STAGES = {2: 4, 4: 2}  # the JAX ("data", "stage") mesh fits 8 devices
PIPE_MB = 4                 # microbatches of 4 rows (the JAX test's)
PIPE_LR = 0.05


def _small_model():
    return (JaxBuilder(name="dd_cnn", data_format="NHWC").input((8, 8, 1))
            .conv2d(8, 3, padding=1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(16).activation("relu").dense(4)
            .build())


def _blob_data(n=96, hw=8, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    base = (y[:, None, None, None] * (200 // n_classes) + 20).astype(
        np.float32)
    x = np.clip(base + rng.normal(0, 10, size=(n, hw, hw, 1)), 0, 255)
    return x.astype(np.uint8), y.astype(np.int64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_orders(key, d, n_local, local_batch):
    """Each device's [steps, local batch] order that JAX's
    ``make_resident_epoch_dp`` draws from ``key``."""
    kperm, _ = jax.random.split(key)
    k = n_local // local_batch
    return [np.asarray(jax.random.permutation(
        jax.random.fold_in(kperm, dev), n_local))[:k * local_batch]
        .reshape(k, local_batch) for dev in range(d)]


def _fit_key(seed, epoch):
    """The key JAX's ``Trainer.fit`` hands an epoch."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return jax.random.fold_in(rng, epoch)


def _block():
    return ResidualBlock(layers=[Conv2DLayer(4, 3, 1, 1, name="c0"),
                                 GroupNormLayer(2, name="g0")],
                         shortcut=[], activation="relu")


def _jax_block():
    return JaxResidual(layers=[JaxConv(4, 3, 1, 1, name="c0"),
                               JaxGN(2, name="g0")],
                       shortcut=[], activation="relu")


def _mse(pred, tgt):
    return ((pred - tgt) ** 2).mean()


def _jax_stack(stacked, s):
    per_stage = [tree_from_flat({"layers": [_block().get_config()]}, {
        f"layers.0.{n}": np.asarray(t[i]) for n, t in stacked.items()})[0]
        for i in range(s)]
    return jcp.stack_stage_params(per_stage)


WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.data import (
        ArrayDataLoader, DeviceDataset, PrefetchLoader, ShardedDeviceDataset,
        make_resident_epoch_dp, stage_sharded)
    from dcnn_tpu_torch.data import device_dataset as pdd
    from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
    from dcnn_tpu_torch.nn.layers import Conv2DLayer, GroupNormLayer
    from dcnn_tpu_torch.nn.residual import ResidualBlock
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD, Adam
    from dcnn_tpu_torch.parallel import (
        SequentialStageStack, make_compiled_pipeline_forward,
        make_compiled_pipeline_train_step, multihost)
    from dcnn_tpu_torch.train import (
        Trainer, create_train_state, evaluate_classification)

    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    multihost.initialize(f"127.0.0.1:{{port}}", world, rank,
                         backend="gloo", timeout_s=60)
    spec = pickle.load(open(os.path.join(d, "spec.pkl"), "rb"))
    mesh = make_mesh((world,), ("data",))
    ce = get_loss("softmax_crossentropy")
    out = {{}}

    def model_of(case):
        return from_jax(case["config"], case["params"], case["state"],
                        device="cpu")

    def hand_orders(orders):
        # the JAX draws for this rank, one an epoch, in epoch order
        queue = [torch.from_numpy(o.reshape(-1)) for o in orders]
        pdd.permutation = lambda *a: queue.pop(0)
        return queue

    def error(fn):
        try:
            fn()
        except (ValueError, TypeError) as e:
            return f"{{type(e).__name__}}: {{e}}"
        return None

    # one DP step against the manual pmean (SGD, no shuffle, k = 1)
    case = spec["one_step"]
    model, opt = model_of(case), SGD(0.05)
    ts = create_train_state(model, opt)
    epoch = make_resident_epoch_dp(model, ce, opt, num_classes=4,
                                   batch_size=case["batch"], mesh=mesh)
    xs, ys = stage_sharded(case["x"], case["y"], mesh,
                           global_shuffle_seed=None, device="cpu")
    ts, loss = epoch(ts, xs, ys, 7, 0.05, order=case["orders"][rank])
    out["one_step"] = {{"loss": float(loss), "params": to_jax(model),
                       "state": state_to_jax(model)}}

    # training to convergence (Adam, the global shuffle on)
    case = spec["converge"]
    model, opt = model_of(case), Adam(2e-3)
    ts = create_train_state(model, opt)
    epoch = make_resident_epoch_dp(model, ce, opt, num_classes=4,
                                   batch_size=32, mesh=mesh)
    xs, ys = stage_sharded(case["x"], case["y"], mesh, device="cpu")
    losses = []
    for e, orders in enumerate(case["orders"]):
        ts, loss = epoch(ts, xs, ys, e, 2e-3, order=orders[rank])
        losses.append(float(loss))
    acc = evaluate_classification(model, ce, DeviceDataset(
        case["x"], case["y"], 4, batch_size=32, device="cpu"))[1]
    out["converge"] = {{"losses": losses, "acc": acc,
                       "params": to_jax(model)}}

    # Trainer.fit over a ShardedDeviceDataset, the JAX draws handed over
    case = spec["fit"]
    model, opt = model_of(case), Adam(2e-3)
    queue = hand_orders([o[rank] for o in case["orders"]])
    trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        learning_rate=2e-3, snapshot_dir=None, device_type="cpu",
        progress_interval=0))
    train_ds = ShardedDeviceDataset(case["x"], case["y"], 4, batch_size=32,
                                    mesh=mesh, device="cpu")
    val_ds = DeviceDataset(case["xv"], case["yv"], 4, batch_size=32,
                           device="cpu")
    ts = trainer.fit(create_train_state(model, opt), train_ds, val_ds,
                     epochs=case["epochs"])
    out["fit"] = {{
        "history": trainer.history, "len": len(train_ds),
        "left": len(queue), "params": to_jax(model),
        "local_samples": train_ds.local_samples,
        "num_samples": train_ds.num_samples,
        "val_error": error(lambda: evaluate_classification(
            model, ce, train_ds)),
        "length_error": error(lambda: ShardedDeviceDataset(
            case["x"], case["y"][:-5], 4, batch_size=32, mesh=mesh,
            device="cpu"))}}

    # the refusals: a global batch D does not divide, a shard below one
    # local batch
    case = spec["bad_batch"]
    model, opt = model_of(case), SGD(0.1)
    bad = error(lambda: make_resident_epoch_dp(
        model, ce, opt, num_classes=4, batch_size=2 * world + 1, mesh=mesh))
    epoch = make_resident_epoch_dp(model, ce, opt, num_classes=4,
                                   batch_size=32, mesh=mesh)
    xs, ys = stage_sharded(case["x"], case["y"], mesh, device="cpu")
    small = error(lambda: epoch(create_train_state(model, opt), xs, ys, 1,
                                0.1))
    out["bad_batch"] = {{"batch": bad, "shard": small,
                        "dataset": error(lambda: ShardedDeviceDataset(
                            case["x"], case["y"], 4,
                            batch_size=2 * world + 1, mesh=mesh,
                            device="cpu"))}}

    # the global shuffle of a class-sorted split
    case = spec["shuffle"]
    ys = [stage_sharded(case["x"], case["y"], mesh, device="cpu")[1]
          .numpy() for _ in range(2)]
    out["shuffle"] = {{"y": ys[0], "again": ys[1]}}

    # PrefetchLoader(sharding=mesh): this rank's rows of the global batch
    case = spec["prefetch"]
    got = {{}}
    for k in (1, 2):
        ld = ArrayDataLoader(case["x"], case["y"], batch_size=8,
                             shuffle=False)
        ld.load_data()
        x, y = next(iter(PrefetchLoader(ld, depth=2, sharding=mesh,
                                        stage_batches=k, device="cpu")))
        got[k] = (x.numpy(), y.numpy(), str(x.device))
    out["prefetch"] = got

    # the compiled pipeline's data axis: this rank's slice of every
    # microbatch
    case = spec["pipeline"]
    s, m = case["stages"], case["microbatches"]
    stack = SequentialStageStack(ResidualBlock(
        layers=[Conv2DLayer(4, 3, 1, 1, name="c0"),
                GroupNormLayer(2, name="g0")],
        shortcut=[], activation="relu"), s, (4, 8, 8))
    stack.init(torch.Generator().manual_seed(0), device="cpu")
    params = {{n: torch.from_numpy(a).requires_grad_(True)
               for n, a in case["params"].items()}}
    per = case["x"].shape[1] // world
    rows = slice(rank * per, (rank + 1) * per)
    mb_x = torch.from_numpy(np.ascontiguousarray(case["x"][:, rows]))
    mb_y = torch.from_numpy(np.ascontiguousarray(case["y"][:, rows]))
    fwd = make_compiled_pipeline_forward(stack.stage_fn, s, m, mesh=mesh,
                                         data_axis="data")
    fwd_out = fwd(params, mb_x).numpy()
    opt = SGD(case["lr"])
    step = make_compiled_pipeline_train_step(
        stack.stage_fn, lambda p, t: ((p - t) ** 2).mean(), opt, s, m,
        mesh=mesh, data_axis="data")
    new, _, loss, outs = step(params, opt.init(params), mb_x, mb_y,
                              case["lr"])
    out["pipeline"] = {{"loss": float(loss), "outs": outs.numpy(),
                       "fwd": fwd_out,
                       "params": {{n: t.detach().numpy()
                                   for n, t in new.items()}},
                       "no_mesh": error(lambda: make_compiled_pipeline_train_step(
                           stack.stage_fn, None, opt, s, m,
                           data_axis="data")),
                       "bad_axis": error(lambda: make_compiled_pipeline_train_step(
                           stack.stage_fn, None, opt, s, m, mesh=mesh,
                           data_axis="seq"))}}

    with open(os.path.join(d, f"out{{rank}}.pkl"), "wb") as f:
        pickle.dump(out, f)
    multihost.barrier("done", timeout_ms=60_000)
    print(f"rank {{rank}} OK", flush=True)
    multihost.shutdown()
""")


def _model_case(seed=0):
    jm = _small_model()
    params, state = jm.init(jax.random.PRNGKey(seed))
    return {"config": jm.get_config(), "params": _np(params),
            "state": _np(state)}


def _spec(world):
    d = world
    x1, y1 = _blob_data(n=8 * d, hw=8)
    xc, yc = _blob_data(n=256, hw=8, seed=3)
    xv, yv = _blob_data(n=64, hw=8, seed=9)
    xb, yb = _blob_data(n=16)
    s = PIPE_STAGES[world]
    stack = SequentialStageStack(_block(), s, (4, 8, 8))
    params = stack.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    pipe_x = rng.normal(size=(PIPE_MB, 4, 4, 8, 8)).astype(np.float32)
    pipe_y = rng.normal(size=(PIPE_MB, 4, 4, 8, 8)).astype(np.float32)
    # the per-device orders JAX draws (shards of the trimmed, shuffled
    # split: the permutation is numpy's, the same on both sides)
    n_loc = 256 // d
    return {
        "one_step": {**_model_case(), "x": x1, "y": y1, "batch": 8 * d,
                     "orders": _jax_orders(jax.random.PRNGKey(7), d, 8, 8)},
        "converge": {**_model_case(), "x": xc, "y": yc,
                     "orders": [_jax_orders(jax.random.PRNGKey(e), d, n_loc,
                                            32 // d) for e in range(15)]},
        "fit": {**_model_case(), "x": xc, "y": yc, "xv": xv, "yv": yv,
                "epochs": 12,
                "orders": [_jax_orders(_fit_key(JaxConfig().seed, e), d,
                                       n_loc, 32 // d)
                           for e in range(1, 13)]},
        "bad_batch": {**_model_case(), "x": xb, "y": yb},
        "shuffle": {"x": np.zeros((32, 4, 4, 1), np.uint8),
                    "y": np.repeat(np.arange(4), 8)},
        "prefetch": {"x": np.arange(16 * 4, dtype=np.float32).reshape(16, 4),
                     "y": np.eye(2, dtype=np.float32)[np.arange(16) % 2]},
        "pipeline": {"params": {n: t.detach().numpy()
                                for n, t in params.items()},
                     "x": pipe_x, "y": pipe_y, "stages": s,
                     "microbatches": PIPE_MB, "lr": PIPE_LR},
    }


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"dpfeed{n}")
    spec = _spec(n)
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    spawn_world(WORKER, n, d)
    outs = [pickle.load(open(d / f"out{r}.pkl", "rb")) for r in range(n)]
    return n, spec, outs


def _close(got, want, **tol):
    la, lb = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(la) == len(lb) and la
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _replicas_equal(outs, name, key="params"):
    for o in outs[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(outs[0][name][key]),
                        jax.tree_util.tree_leaves(o[name][key])):
            np.testing.assert_array_equal(a, b)


def _jax_mesh(d):
    return jax_make_mesh((d,), (DATA_AXIS,), devices=jax.devices()[:d])


# -- the resident DP epoch ----------------------------------------------------

def test_resident_dp_one_step_matches_jax_and_manual_pmean(world):
    """One DP resident step (SGD, no augmentation, no global shuffle, the
    JAX per-device order) against JAX's ``make_resident_epoch_dp`` over
    the same number of devices and against the per-shard gradients
    averaged by hand: loss, params and the averaged BN statistics."""
    d, spec, outs = world
    case = spec["one_step"]
    model = _small_model()
    opt = JaxSGD(0.05)
    ts0 = jax_trainer.TrainState(case["params"], case["state"],
                                 opt.init(case["params"]),
                                 jnp.zeros((), jnp.int32))
    epoch = jdd.make_resident_epoch_dp(model, jax_ce, opt, num_classes=4,
                                       batch_size=case["batch"],
                                       mesh=_jax_mesh(d))
    xs, ys = jdd.stage_sharded(case["x"], case["y"], _jax_mesh(d),
                               global_shuffle_seed=None)
    ts1, loss1 = epoch(ts0, xs, ys, jax.random.PRNGKey(7), 0.05)

    # by hand: each device's gradient on its order's rows, averaged
    _, kstep = jax.random.split(jax.random.PRNGKey(7))
    grads, losses, states = [], [], []

    def fwd(params, state, xb, yb, r):
        logits, new_state = model.apply(params, state, xb, training=True,
                                        rng=r)
        return jax_ce(logits.astype(jnp.float32), yb), new_state

    for dev in range(d):
        bidx = case["orders"][dev][0]
        shard = slice(dev * 8, (dev + 1) * 8)
        xb = jnp.asarray(case["x"][shard][bidx].astype(np.float32) / 255.0)
        yb = jax.nn.one_hot(case["y"][shard][bidx], 4)
        r = jax.random.fold_in(jax.random.fold_in(kstep, 0), dev)
        (lv, st), g = jax.value_and_grad(fwd, has_aux=True)(
            case["params"], case["state"], xb, yb, r)
        grads.append(g)
        losses.append(float(lv))
        states.append(st)
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / d, *grads)
    manual, _ = opt.update(mean, opt.init(case["params"]), case["params"],
                           0.05)
    mean_state = jax.tree_util.tree_map(lambda *s: sum(s) / d, *states)

    for o in outs:
        got = o["one_step"]
        assert got["loss"] == pytest.approx(float(loss1), abs=1e-5, rel=1e-4)
        assert got["loss"] == pytest.approx(np.mean(losses), abs=1e-5, rel=1e-4)
        _close(got["params"], _np(ts1.params), **TOL)
        _close(got["params"], _np(manual), **TOL)
        _close(got["state"], _np(ts1.state), **TOL)
        _close(got["state"], _np(mean_state), **TOL)
    _replicas_equal(outs, "one_step")


def test_resident_dp_trains_to_convergence(world):
    """15 DP epochs (Adam, global batch 32, the global shuffle) given JAX's
    orders: the loss halves and the split is learned, as in the JAX test,
    and the epoch losses follow JAX's run over the same devices."""
    d, spec, outs = world
    case = spec["converge"]
    model = _small_model()
    opt = JaxAdam(2e-3)
    ts = jax_trainer.TrainState(case["params"], case["state"],
                                opt.init(case["params"]),
                                jnp.zeros((), jnp.int32))
    epoch = jdd.make_resident_epoch_dp(model, jax_ce, opt, num_classes=4,
                                       batch_size=32, mesh=_jax_mesh(d))
    xs, ys = jdd.stage_sharded(case["x"], case["y"], _jax_mesh(d))
    jax_losses = []
    for e in range(15):
        ts, loss = epoch(ts, xs, ys, jax.random.PRNGKey(e), 2e-3)
        jax_losses.append(float(loss))
    for o in outs:
        got = o["converge"]
        assert got["losses"][-1] < 0.5 * got["losses"][0]
        assert got["acc"] > 0.9
        np.testing.assert_allclose(got["losses"], jax_losses, **TOL)
    _replicas_equal(outs, "converge")


def test_trainer_fit_sharded_dataset_end_to_end(world):
    """``Trainer.fit`` over a ``ShardedDeviceDataset`` (12 epochs, Adam,
    replicated validation) against the JAX trainer over the same devices,
    given its draws: every epoch's train loss; the JAX test's own checks,
    and its guards. (Validation is held to the JAX test's bound, not to
    JAX's numbers: Adam turns the exactly-zero gradient of the conv bias
    before the BN into steps of ±lr from either side's rounding noise,
    which the training forward's batch statistics cancel but the running
    mean that validation reads does not.)"""
    d, spec, outs = world
    case = spec["fit"]
    jt = jax_trainer.Trainer(_small_model(), JaxAdam(2e-3),
                             "softmax_crossentropy",
                             config=JaxConfig(learning_rate=2e-3,
                                              snapshot_dir=None))
    jopt = jt.optimizer
    ts = jax_trainer.TrainState(case["params"], case["state"],
                                jopt.init(case["params"]),
                                jnp.zeros((), jnp.int32))
    train = JaxSharded(case["x"], case["y"], 4, batch_size=32,
                       mesh=_jax_mesh(d))
    jt.fit(ts, train, JaxDeviceDataset(case["xv"], case["yv"], 4,
                                       batch_size=32), epochs=12)
    for o in outs:
        got = o["fit"]
        assert got["len"] == len(train) == 8 and got["left"] == 0
        assert got["local_samples"] * d == got["num_samples"] == 256
        hist = got["history"]
        assert hist[-1]["val_acc"] >= 0.9
        assert hist[-1]["train_loss"] < hist[0]["train_loss"]
        for a, b in zip(hist, jt.history):
            assert np.isnan(a["train_acc"]) and np.isnan(b["train_acc"])
            np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                       **TOL)
        assert got["val_error"].startswith("TypeError") \
            and "replicated" in got["val_error"]
        assert got["length_error"].startswith("ValueError") \
            and "length mismatch" in got["length_error"]
    _replicas_equal(outs, "fit")


def test_resident_dp_rejects_bad_batch(world):
    """A global batch the data axis does not divide, and a shard smaller
    than one local batch, are refused (the JAX test's messages)."""
    d, _, outs = world
    with pytest.raises(ValueError, match="data size"):
        jdd.make_resident_epoch_dp(_small_model(), jax_ce, JaxSGD(0.1),
                                   num_classes=4, batch_size=2 * d + 1,
                                   mesh=_jax_mesh(d))
    for o in outs:
        got = o["bad_batch"]
        assert got["batch"].startswith("ValueError") \
            and "data size" in got["batch"]
        assert got["dataset"].startswith("ValueError") \
            and "data size" in got["dataset"]
        assert got["shard"].startswith("ValueError") \
            and "local batch" in got["shard"]


def test_stage_sharded_global_shuffle_debiases_sorted_data(world):
    """A class-sorted split spreads classes over every shard, each rank's
    labels equal the JAX package's shard bit for bit, and the permutation
    is deterministic."""
    d, spec, outs = world
    case = spec["shuffle"]
    _, ys = jdd.stage_sharded(case["x"], case["y"], _jax_mesh(d))
    want = np.asarray(ys).reshape(d, -1)
    for r, o in enumerate(outs):
        got = o["shuffle"]
        assert len(np.unique(got["y"])) > 1
        np.testing.assert_array_equal(got["y"], want[r])
        np.testing.assert_array_equal(got["again"], got["y"])


# -- PrefetchLoader(sharding=) ------------------------------------------------

def test_prefetch_sharded_placement(world):
    """Each rank holds B/n rows of the global batch (the JAX test's
    placement: its rows of ``NamedSharding(mesh, P("data"))``), on its
    device; a staged [K, B, ...] chunk shards its batch dim."""
    d, spec, outs = world
    case = spec["prefetch"]
    from dcnn_tpu.data import ArrayDataLoader as JaxLoader
    from dcnn_tpu.data import PrefetchLoader as JaxPrefetch
    from jax.sharding import NamedSharding, PartitionSpec as P

    ld = JaxLoader(case["x"], case["y"], batch_size=8, shuffle=False)
    ld.load_data()
    sharding = NamedSharding(_jax_mesh(d), P("data"))
    jx, jy = next(iter(JaxPrefetch(ld, depth=2, sharding=sharding)))
    shards = sorted(jx.addressable_shards, key=lambda s: s.index[0].start)
    assert len(shards) == d
    per = 8 // d
    for r, o in enumerate(outs):
        x, y, dev = o["prefetch"][1]
        assert x.shape == (per, 4) and dev == "cpu"
        np.testing.assert_array_equal(x, np.asarray(shards[r].data))
        np.testing.assert_array_equal(y, case["y"][r * per:(r + 1) * per])
        xs, ys, _ = o["prefetch"][2]
        assert xs.shape == (2, per, 4)
        for k in range(2):
            rows = slice(8 * k + r * per, 8 * k + (r + 1) * per)
            np.testing.assert_array_equal(xs[k], case["x"][rows])
            np.testing.assert_array_equal(ys[k], case["y"][rows])


# -- the compiled pipeline's data axis ----------------------------------------

def test_compiled_pipeline_data_parallel_composition(world):
    """DP×PP: each rank runs every stage on its slice of the microbatches,
    the gradients averaged over the data axis, against JAX's ("data",
    "stage") mesh run (data size = the world, the stages filling 8
    devices) and its stage-only run, and the port's pipeline-only run on
    the whole batch: loss 1e-6, outputs and params 1e-5 / 1e-6."""
    d, spec, outs = world
    case = spec["pipeline"]
    s, m = case["stages"], case["microbatches"]
    stack = SequentialStageStack(_block(), s, (4, 8, 8))
    stack.init(torch.Generator().manual_seed(0), device="cpu")
    start = {n: torch.from_numpy(a) for n, a in case["params"].items()}

    # the port's pipeline-only run
    params = {n: t.clone().requires_grad_(True) for n, t in start.items()}
    opt = SGD(PIPE_LR)
    step = make_compiled_pipeline_train_step(stack.stage_fn, _mse, opt, s, m)
    new, _, loss, outs_pp = step(params, opt.init(params),
                                 torch.from_numpy(case["x"]),
                                 torch.from_numpy(case["y"]), PIPE_LR)
    port_pp = (float(loss), outs_pp.numpy(),
               {n: t.detach().numpy() for n, t in new.items()})

    # JAX: the 2-D mesh and the stage-only mesh
    from jax.sharding import Mesh

    jstack = jcp.SequentialStageStack(_jax_block(), s, (4, 8, 8))
    jstack.init(jax.random.PRNGKey(0))
    devs = np.array(jax.devices()[:d * s]).reshape(d, s)
    runs = {}
    for name, mesh, dax in (
            ("pp", Mesh(np.array(jax.devices()[:s]), (STAGE_AXIS,)), None),
            ("dpxpp", Mesh(devs, ("data", STAGE_AXIS)), "data")):
        jopt = JaxSGD(PIPE_LR)
        jstep = jcp.make_compiled_pipeline_train_step(
            jstack.stage_fn, lambda p, t: jnp.mean((p - t) ** 2), jopt, s, m,
            mesh, data_axis=dax)
        p = jcp.shard_stacked(_jax_stack(case["params"], s), mesh)
        new_p, _, jl, jo = jstep(p, jopt.init(p), jnp.asarray(case["x"]),
                                 jnp.asarray(case["y"]),
                                 jnp.float32(PIPE_LR))
        runs[name] = (float(jl), np.asarray(jo), new_p)

    per = case["x"].shape[1] // d
    want_params = _jax_stack(port_pp[2], s)
    for r, o in enumerate(outs):
        got = o["pipeline"]
        rows = slice(r * per, (r + 1) * per)
        for ref_loss in (runs["pp"][0], runs["dpxpp"][0], port_pp[0]):
            np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-6)
        for ref_outs in (runs["pp"][1], runs["dpxpp"][1], port_pp[1]):
            np.testing.assert_allclose(got["outs"], ref_outs[:, rows],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["fwd"], port_pp[1][:, rows],
                                   rtol=1e-5, atol=1e-6)
        for n, a in got["params"].items():
            np.testing.assert_allclose(a, port_pp[2][n], rtol=1e-5,
                                       atol=1e-6)
        mine = _jax_stack(got["params"], s)
        for ref in (runs["pp"][2], runs["dpxpp"][2], want_params):
            for a, b in zip(jax.tree_util.tree_leaves(mine),
                            jax.tree_util.tree_leaves(ref)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)
        assert "needs the mesh" in got["no_mesh"]
        assert "not in mesh axes" in got["bad_axis"]
    _replicas_equal(outs, "pipeline")
