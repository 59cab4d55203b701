"""The port's training path held against the JAX package on the CPU.

Models are initialised in JAX and carried across with ``interop.from_jax``;
the same numpy batches go through both packages' train steps and trainers.
On the CPU the JAX attention layer runs its blockwise path and the port the
flash kernels' plain versions (forward and backward), so the two agree to
rounding:

- loss, logits and gradients: 1e-5 absolute plus 1e-4 relative (fp32; two
  attention blocks and a dense head summed in another order);
- Adam state and params after two steps, elementwise where the RMS
  gradient is at least ``GRAD_FLOOR``. Below it a gradient is rounding
  noise: the key bias of an attention layer has an exactly-zero gradient
  in exact arithmetic (it shifts a row of scores by a constant), and
  Adam's m/sqrt(v) turns noise of either sign into a full-size step. Such
  elements are held to Adam's step bound instead.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.data import ArrayDataLoader as JaxLoader
from dcnn_tpu.models.zoo import create_mha_classifier as jax_mha_classifier
from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.ops.losses import get_loss as jax_get_loss
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import Adam as JaxAdam
from dcnn_tpu.optim import WarmupCosineAnnealing as JaxWarmupCosine
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import ArrayDataLoader
from dcnn_tpu_torch.interop import (
    from_jax, grads_to_jax, opt_state_from_jax, opt_state_to_jax, to_jax,
)
from dcnn_tpu_torch.models import create_mha_classifier
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, Adam, WarmupCosineAnnealing
from dcnn_tpu_torch.train import (
    TrainState, Trainer, create_train_state, evaluate_classification,
    make_train_step, train_classification_model, train_regression_model,
)

TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_FLOOR = 1e-6
LOSS = "softmax_crossentropy"


def _narrow_jax():
    """mha_classifier's structure at E=32, 2 heads, S=16."""
    def block(name):
        return JaxResidual(layers=[JaxMHA(num_heads=2, impl="flash",
                                          name=f"{name}_mha")],
                           shortcut=[], activation="relu", name=name)
    return (JaxBuilder("narrow").input((16, 32)).add_layer(block("a0"))
            .add_layer(block("a1")).flatten("flatten").dense(10, True, "head")
            .build())


MODELS = {"narrow": _narrow_jax, "full": jax_mha_classifier}


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def marker_task(n, s, e, seed=0):
    """Class = position of a marked token (``tests/test_attention.py``)."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.1, (n, s, e)).astype(np.float32)
    x[np.arange(n), y_idx * (s // 10), :8] += 2.5
    return x, np.eye(10, dtype=np.float32)[y_idx]


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_trees_close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


def _assert_adam_params_close(got, want, v, steps, lr, b1=0.9, b2=0.999):
    """Params after ``steps`` Adam steps: elementwise where the RMS gradient
    (from the reference's second moment ``v``) is at least GRAD_FLOOR, to
    Adam's step bound below it (see the module docstring)."""
    bound = 2 * steps * lr * (1 - b1) / math.sqrt(1 - b2)
    for a, b, vv in zip(_leaves(got), _leaves(want), _leaves(v)):
        rms = np.sqrt(vv / (1 - b2 ** steps))
        real = rms >= GRAD_FLOOR
        np.testing.assert_allclose(a[real], b[real], atol=1e-6, rtol=1e-5)
        assert np.all(np.abs(a - b)[~real] <= bound)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_train_step_matches_jax(which):
    """One step: loss, logits and every gradient; two steps: Adam's m, v, t
    and the params."""
    jm = MODELS[which]()
    jopt = JaxAdam(1e-3)
    ts_j = jax_trainer.create_train_state(jm, jopt, jax.random.PRNGKey(1))
    p0 = _numpy(ts_j.params)
    x, y = marker_task(8, *jm.input_shape, seed=2)
    x2, y2 = marker_task(8, *jm.input_shape, seed=3)
    jloss = jax_get_loss(LOSS)

    def forward_loss(params):
        logits, _ = jm.apply(params, ts_j.state, jnp.asarray(x), training=True)
        return jloss(logits, jnp.asarray(y))

    want_grads = _numpy(jax.grad(forward_loss)(ts_j.params))
    jstep = jax_trainer.make_train_step(jm, jloss, jopt, jit=False)
    rng = jax.random.PRNGKey(0)
    ts_j, want_loss, want_logits = jstep(ts_j, jnp.asarray(x), jnp.asarray(y),
                                         rng, 1e-3)
    ts_j, _, _ = jstep(ts_j, jnp.asarray(x2), jnp.asarray(y2), rng, 1e-3)

    tm = from_jax(jm.get_config(), p0, device="cpu")
    opt = Adam(1e-3)
    ts = create_train_state(tm, opt)
    step = make_train_step(tm, get_loss(LOSS), opt)
    loss, logits = step(ts, torch.from_numpy(x), torch.from_numpy(y), 1e-3)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    _assert_trees_close(grads_to_jax(tm), want_grads, **TOL)
    step(ts, torch.from_numpy(x2), torch.from_numpy(y2), 1e-3)
    assert ts.step == 2

    state = opt_state_to_jax(tm, ts.opt_state)
    want_state = _numpy(ts_j.opt_state)
    assert int(state["t"]) == int(want_state["t"]) == 2
    _assert_trees_close(state["m"], want_state["m"], atol=1e-6, rtol=1e-4)
    _assert_trees_close(state["v"], want_state["v"], atol=1e-10, rtol=1e-4)
    _assert_adam_params_close(to_jax(tm), _numpy(ts_j.params),
                              want_state["v"], steps=2, lr=1e-3)


def test_microbatched_step_matches_jax():
    """Two microbatches: gradients and loss are the mean of the pieces', as
    the JAX scan computes them; SGD makes the params comparable directly."""
    jm = _narrow_jax()
    jopt = JaxSGD(0.1, momentum=0.9)
    ts_j = jax_trainer.create_train_state(jm, jopt, jax.random.PRNGKey(4))
    p0 = _numpy(ts_j.params)
    x, y = marker_task(8, 16, 32, seed=5)
    jstep = jax_trainer.make_train_step(jm, jax_get_loss(LOSS), jopt,
                                        num_microbatches=2, jit=False)
    ts_j, want_loss, want_logits = jstep(ts_j, jnp.asarray(x), jnp.asarray(y),
                                         jax.random.PRNGKey(0), 0.1)
    tm = from_jax(jm.get_config(), p0, device="cpu")
    opt = SGD(0.1, momentum=0.9)
    ts = create_train_state(tm, opt)
    loss, logits = make_train_step(tm, get_loss(LOSS), opt, 2)(
        ts, torch.from_numpy(x), torch.from_numpy(y), 0.1)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    _assert_trees_close(to_jax(tm), _numpy(ts_j.params), **TOL)
    _assert_trees_close(opt_state_to_jax(tm, ts.opt_state)["velocity"],
                        _numpy(ts_j.opt_state["velocity"]), **TOL)


def test_microbatches_that_do_not_divide_train_whole_with_a_warning():
    tm = from_jax(_narrow_jax().get_config(),
                  _numpy(_narrow_jax().init(jax.random.PRNGKey(0))[0]),
                  device="cpu")
    x, y = marker_task(6, 16, 32)
    opt = SGD(0.1)
    ts = create_train_state(tm, opt)
    ref = from_jax(tm.get_config(), to_jax(tm), device="cpu")
    with pytest.warns(UserWarning, match="not divisible"):
        loss, _ = make_train_step(tm, get_loss(LOSS), opt, 4)(
            ts, torch.from_numpy(x), torch.from_numpy(y), 0.1)
    ts_ref = create_train_state(ref, opt)
    want, _ = make_train_step(ref, get_loss(LOSS), opt)(
        ts_ref, torch.from_numpy(x), torch.from_numpy(y), 0.1)
    assert loss.item() == want.item()
    _assert_trees_close(to_jax(tm), to_jax(ref), atol=0, rtol=0)


def test_opt_state_carries_both_ways():
    """A JAX Adam state comes across and goes back bit-identical, and the
    port steps from it as JAX does."""
    jm = _narrow_jax()
    params, _ = jm.init(jax.random.PRNGKey(6))
    jopt = JaxAdam(1e-2)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    new_p, st = jopt.update(grads, jopt.init(params), params, 1e-2)
    st = _numpy(st)
    tm = from_jax(jm.get_config(), _numpy(new_p), device="cpu")
    ported = opt_state_from_jax(tm, st)
    back = opt_state_to_jax(tm, ported)
    assert int(back["t"]) == 1
    _assert_trees_close(back["m"], st["m"], atol=0, rtol=0)
    _assert_trees_close(back["v"], st["v"], atol=0, rtol=0)
    _assert_trees_close(to_jax(tm), _numpy(new_p), atol=0, rtol=0)


def _fit_both(epochs=2):
    """The narrow model through both packages' ``Trainer.fit``: SGD with
    momentum, a per-batch warmup-cosine schedule and a val loader."""
    jm = _narrow_jax()
    jopt = JaxSGD(0.05, momentum=0.9)
    ts_j = jax_trainer.create_train_state(jm, jopt, jax.random.PRNGKey(7))
    p0 = _numpy(ts_j.params)
    x, y = marker_task(64, 16, 32, seed=8)
    xv, yv = marker_task(24, 16, 32, seed=9)
    sched_kw = dict(warmup_steps=3, total_steps=8, start_lr=0.01)
    kw = dict(epochs=epochs, batch_size=16, learning_rate=0.05,
              snapshot_dir=None, progress_interval=2, scheduler_step="batch")

    jt = jax_trainer.Trainer(jm, jopt, LOSS, JaxConfig(**kw),
                             JaxWarmupCosine(0.05, **sched_kw))
    ts_j = jt.fit(ts_j, JaxLoader(x, y, batch_size=16, seed=3),
                  JaxLoader(xv, yv, batch_size=8, shuffle=False,
                            drop_last=False))

    tm = from_jax(jm.get_config(), p0, device="cpu")
    opt = SGD(0.05, momentum=0.9)
    tt = Trainer(tm, opt, LOSS, TrainingConfig(device_type="cpu", **kw),
                 WarmupCosineAnnealing(0.05, **sched_kw))
    ts = tt.fit(create_train_state(tm, opt),
                ArrayDataLoader(x, y, batch_size=16, seed=3),
                ArrayDataLoader(xv, yv, batch_size=8, shuffle=False,
                                drop_last=False))
    return jt, ts_j, tt, ts


def test_trainer_fit_matches_jax(capsys):
    jt, ts_j, tt, ts = _fit_both()
    assert len(tt.history) == len(jt.history) == 2
    assert sorted(tt.history[0]) == sorted(jt.history[0])
    for got, want in zip(tt.history, jt.history):
        for key in ("train_loss", "val_loss", "train_acc", "val_acc"):
            np.testing.assert_allclose(got[key], want[key], **TOL,
                                       err_msg=key)
        assert got["lr"] == want["lr"] and got["epoch"] == want["epoch"]
    assert tt.lr == jt.lr and tt.history[0]["lr"] != tt.history[1]["lr"]
    assert ts.step == int(ts_j.step) == 8
    _assert_trees_close(to_jax(tt.model), _numpy(ts_j.params), **TOL)
    out = capsys.readouterr().out
    assert "epoch 1 batch 2: loss" in out and "epoch 2/2: train loss" in out


def test_evaluate_classification_matches_jax():
    jm = _narrow_jax()
    params, state = jm.init(jax.random.PRNGKey(10))
    x, y = marker_task(20, 16, 32, seed=11)
    want = jax_trainer.evaluate_classification(
        jm, params, state, jax_get_loss(LOSS),
        JaxLoader(x, y, batch_size=8, shuffle=False, drop_last=False))
    tm = from_jax(jm.get_config(), _numpy(params), device="cpu")
    got = evaluate_classification(
        tm, get_loss(LOSS),
        ArrayDataLoader(x, y, batch_size=8, shuffle=False, drop_last=False))
    np.testing.assert_allclose(got, want, **TOL)


def test_train_regression_model_matches_jax():
    """The regression loop on a dense model: SGD, MSE, lr decay, val loss."""
    jm = (JaxBuilder("reg").input((6,)).dense(16, True, "h")
          .activation("tanh").dense(2, True, "out").build())
    key = jax.random.PRNGKey(12)
    p0 = _numpy(jm.init(key)[0])  # what train_regression_model initialises
    rng = np.random.default_rng(13)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = np.stack([x[:, 0] * 2 - x[:, 1], x[:, 2] ** 2], -1).astype(np.float32)
    kw = dict(epochs=3, batch_size=10, learning_rate=0.05,
              lr_decay_factor=0.5, snapshot_dir=None)
    _, want = jax_trainer.train_regression_model(
        jm, JaxSGD(0.05), "mse", JaxLoader(x, y, batch_size=10, seed=1),
        JaxLoader(x[:20], y[:20], batch_size=10, shuffle=False),
        config=JaxConfig(**kw), key=key)
    tm = from_jax(jm.get_config(), p0, device="cpu")
    _, got = train_regression_model(
        tm, SGD(0.05), "mse", ArrayDataLoader(x, y, batch_size=10, seed=1),
        ArrayDataLoader(x[:20], y[:20], batch_size=10, shuffle=False),
        config=TrainingConfig(device_type="cpu", **kw))
    assert [h["lr"] for h in got] == [h["lr"] for h in want] \
        == [0.05, 0.025, 0.0125]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], **TOL)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], **TOL)
    assert got[-1]["train_loss"] < got[0]["train_loss"]


def test_mha_classifier_trains_on_the_marker_task():
    """Full-width ``mha_classifier`` through ``train_classification_model``
    on the CPU: above 90% train accuracy in 6 epochs, as the JAX package's
    end-to-end test asks, and no kernel launch on CPU tensors."""
    x, y = marker_task(256, 32, 64, seed=0)
    before = (_kernels.flash_fwd.launches, _kernels.flash_bwd_dq.launches,
              _kernels.flash_bwd_dkv.launches)
    _, trainer = train_classification_model(
        create_mha_classifier(), Adam(1e-3), LOSS,
        ArrayDataLoader(x, y, batch_size=32, shuffle=True),
        config=TrainingConfig(epochs=6, progress_interval=0, snapshot_dir=None,
                              device_type="cpu"),
        generator=torch.Generator().manual_seed(0))
    assert trainer.history[-1]["train_acc"] > 0.9, trainer.history[-1]
    assert (_kernels.flash_fwd.launches, _kernels.flash_bwd_dq.launches,
            _kernels.flash_bwd_dkv.launches) == before


# the fields still refused, with the ROADMAP.md Queue 1 item that ports each
UNPORTED = {"elastic": (True, 6), "metrics_port": (0, 7)}
# ported since: checkpoints, resume, the step guard and the watchdog; the
# chunked epoch (steps_per_dispatch) and the feed workers' config field;
# the flight recorder, the layer profiler, debug mode and slow_detect (read
# by elastic training only, as in the JAX package); the AOT cache of the
# kernel libraries (aot_cache_dir)
PORTED = {"checkpoint_dir": "ckpt", "resume": "auto",
          "nonfinite_policy": "skip_step", "stall_timeout_s": 5.0,
          "steps_per_dispatch": 4, "feed_workers": 2, "flight_dir": "flight",
          "profiler": "normal", "debug": True, "slow_detect": True,
          "aot_cache_dir": "aot"}


@pytest.mark.parametrize("field", sorted(UNPORTED))
def test_unported_config_features_raise(field):
    value, item = UNPORTED[field]
    tm = create_mha_classifier().init(device="cpu")
    cfg = TrainingConfig(device_type="cpu", **{field: value})
    with pytest.raises(NotImplementedError,
                       match=f"TrainingConfig.{field}.*Queue 1 item {item}"):
        Trainer(tm, Adam(), LOSS, cfg)


@pytest.mark.parametrize("field", sorted(PORTED))
def test_ported_config_features_construct(field, tmp_path):
    """The fault-tolerance, feed and observability fields no longer raise:
    a Trainer builds with each (a checkpoint manager where checkpoint_dir
    is set, a chunked step where steps_per_dispatch is, a layer profiler
    where profiler is; flight_dir configures the process-global recorder
    and debug the process-global debug mode, both put back here)."""
    from dcnn_tpu_torch.core import ProfilerType, debug
    from dcnn_tpu_torch.obs import get_flight_recorder

    tm = create_mha_classifier().init(device="cpu")
    value = PORTED[field]
    if field in ("checkpoint_dir", "flight_dir", "aot_cache_dir"):
        value = str(tmp_path / value)
    elif field == "profiler":
        value = ProfilerType(value)
    rec = get_flight_recorder()
    old_dir = rec.directory
    try:
        tr = Trainer(tm, Adam(), LOSS,
                     TrainingConfig(device_type="cpu", **{field: value}))
        assert (tr.checkpoints is not None) == (field == "checkpoint_dir")
        assert (tr.guard is not None) == (field == "nonfinite_policy")
        assert (tr.multi_step is not None) == (field == "steps_per_dispatch")
        assert (tr.profiler is not None) == (field == "profiler")
        assert debug.debug_nans() == (field == "debug")
        assert (rec.directory == value) == (field == "flight_dir")
    finally:
        debug.disable_debug_mode()
        rec.directory = old_dir


def test_best_val_snapshot_and_resident_data_raise(tmp_path):
    """``snapshot_dir`` with a val loader writes the best-val snapshot
    (the checkpoint format is ported); a data-parallel resident dataset
    still raises (a single-device one trains: tests/test_torch_device_feed.py)."""
    tm = create_mha_classifier().init(device="cpu")
    x, y = marker_task(8, 32, 64)
    ld = ArrayDataLoader(x, y, batch_size=4)
    ts = create_train_state(tm, Adam())
    tr = Trainer(tm, Adam(), LOSS, TrainingConfig(
        device_type="cpu", snapshot_dir=str(tmp_path), epochs=1,
        progress_interval=0))
    tr.fit(ts, ld, ld)
    snap = tmp_path / tm.name
    assert sorted(os.listdir(snap)) == ["arrays.msgpack", "model.json"]

    from dcnn_tpu_torch.data import ShardedDeviceDataset

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tr.train_epoch(ts, ShardedDeviceDataset(x, y, 10, batch_size=4,
                                                mesh=None))


def test_trainer_refuses_a_model_on_another_device():
    tm = create_mha_classifier().init(device="cpu")
    tr = Trainer(tm, Adam(), LOSS, TrainingConfig(device_type="cpu"))
    x, y = marker_task(8, 32, 64)
    tr.device = torch.device("meta")
    with pytest.raises(ValueError, match="build it there"):
        tr.train_epoch(TrainState(tm, None), ArrayDataLoader(x, y,
                                                             batch_size=4))


def test_trainer_on_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    tm = create_mha_classifier().init(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tm, Adam(), LOSS, TrainingConfig())
