"""The compiled-session layer on the CPU: what the CUDA graphs of
``dcnn_tpu_torch/core/graphs.py`` rest on, held where a CPU can hold it.

- The optimizers take their host scalars (lr, Adam's bias corrections) as
  0-d fp32 tensors; over 20 steps they are bit-equal to the float path
  they replace (its code is kept here as the reference), for a float and a
  tensor lr, and through the fill / apply / advance split a graph runs.
  Adam's ``t`` stays a host int, across ``interop`` and in a checkpoint the
  JAX package reads.
- A generator reseeded on the host draws what a fresh ``generator(key)``
  draws: dropout masks and every op of ``DeviceAugment``.
- ``make_train_step(jit=True)`` (the plain call on the CPU) equals
  ``jit=False`` bit for bit, guarded or not, and both equal the JAX step
  within ``tests/test_torch_train.py``'s tolerance.
- The launch-delta bookkeeping, on fake counted wrappers, and the host
  counters that a session replays the same way (``count_host``).
- ``graphs.debug_eager``, which sends a step to the eager debug path, sees
  autograd's anomaly mode, ``debug.checked``'s hooks and hooks set on a
  submodule or globally, and nothing else.
- ``graphs.SessionCache``, the one rule of the repeated steps (train step,
  resident batch body, compiled pipeline): eager at a key's first call and
  on the debug paths, then one capture a key, precision mode and binding.
- ``Trainer._restore`` copies a checkpoint into the live state's tensors
  (which a captured step keeps writing); training on from a rollback or a
  resume equals the uninterrupted run bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.ops.losses import get_loss as jax_get_loss
from dcnn_tpu.optim import Adam as JaxAdam
from dcnn_tpu.train import load_checkpoint as jax_load
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.core import TrainingConfig, graphs
from dcnn_tpu_torch.core.keys import fold_in, generator, generators, reseed
from dcnn_tpu_torch.data import SyntheticClassificationLoader
from dcnn_tpu_torch.data import augment_device as ad
from dcnn_tpu_torch.interop import from_jax, opt_state_to_jax
from dcnn_tpu_torch.nn import DropoutLayer, SequentialBuilder
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, Adam, AdamW
from dcnn_tpu_torch.train import (
    Trainer, create_train_state, make_train_step, save_checkpoint,
)

LOSS = "softmax_crossentropy"
TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py's, fp32


# -- the optimizers' host scalars as 0-d tensors -------------------------------

def _float_update(opt, grads, st, params, lr):
    """The optimizers' update as it was with the lr and the bias
    corrections as Python floats: the reference the tensor path is held
    to bit for bit."""
    lr = float(np.float32(lr))

    def times_lr(c):
        return float(np.float32(c) * np.float32(lr))

    with torch.no_grad():
        if isinstance(opt, SGD):
            for n, p in params.items():
                if opt.momentum > 0.0:
                    v = st["velocity"][n]
                    v.copy_(opt.momentum * v - lr * grads[n])
                    p.add_(v)
                else:
                    p.sub_(lr * grads[n])
            return
        b1, b2, eps, wd = opt.beta1, opt.beta2, opt.epsilon, opt.weight_decay
        t = int(st["t"]) + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        for n, p in params.items():
            g = grads[n]
            m, v = st["m"][n], st["v"][n]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            update = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd > 0.0:
                if opt.decouple_weight_decay:
                    p.sub_(times_lr(wd) * p)
                else:
                    update = update + times_lr(wd) * p
            p.sub_(update)
        st["t"] = t


OPTIMIZERS = {
    "sgd": lambda: SGD(0.05),
    "sgd_momentum": lambda: SGD(0.05, momentum=0.9),
    "adam": lambda: Adam(1e-3),
    "adam_l2": lambda: Adam(1e-3, weight_decay=1e-2),
    "adamw": lambda: AdamW(1e-3, weight_decay=1e-4),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_tensor_scalars_equal_the_float_path(name):
    """20 steps, a new lr every step (11 of them the warmup-cosine lrs at
    which a double ``wd·lr`` rounded differently): ``update`` with a float
    lr, with a 0-d tensor lr, and the graph's split (scalars made once,
    filled, applied, advanced) all equal the float path bit for bit."""
    rng = np.random.default_rng(3)
    shapes = {"w": (7, 5), "b": (5,), "k": (3, 3, 2, 4)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(20)]
    lrs = 1e-3 * (0.5 + 0.5 * np.cos(np.linspace(0.0, 3.0, 20)))
    runs = {}
    for how in ("reference", "float", "tensor", "split"):
        opt = OPTIMIZERS[name]()
        params = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
        st = opt.init(params)
        scalars = opt.scalars("cpu")
        for g, lr in zip(grads, lrs):
            if how == "reference":
                _float_update(opt, g, st, params, lr)
            elif how == "float":
                opt.update(g, st, params, float(lr))
            elif how == "tensor":
                opt.update(g, st, params, torch.tensor(lr, dtype=torch.float32))
            else:
                opt.fill_scalars(scalars, st, float(lr))
                opt.apply(g, st, params, scalars)
                opt.advance(st)
        runs[how] = (params, st)
    want_p, want_st = runs.pop("reference")
    for how, (params, st) in runs.items():
        for n in params:
            assert torch.equal(params[n], want_p[n]), (how, n)
        for k, v in want_st.items():
            if k == "t":
                assert type(st["t"]) is int and st["t"] == v == 20, how
            else:
                for n in v:
                    assert torch.equal(st[k][n], v[n]), (how, k, n)


def _narrow_jax():
    """mha_classifier's structure at E=32, 2 heads, S=16."""
    def block(name):
        return JaxResidual(layers=[JaxMHA(num_heads=2, impl="flash",
                                          name=f"{name}_mha")],
                           shortcut=[], activation="relu", name=name)
    return (JaxBuilder("narrow").input((16, 32)).add_layer(block("a0"))
            .add_layer(block("a1")).flatten("flatten").dense(10, True, "head")
            .build())


def _marker(n, seed):
    """Class = position of a marked token (``tests/test_attention.py``)."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.1, (n, 16, 32)).astype(np.float32)
    x[np.arange(n), y_idx, :8] += 2.5
    return x, np.eye(10, dtype=np.float32)[y_idx]


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def test_adam_step_count_stays_a_host_int_across_packages(tmp_path):
    """Three Adam steps through the step function: ``t`` is a Python int in
    the state, an int32 scalar in ``interop``'s JAX layout, and 3 in the
    state the JAX package's ``load_checkpoint`` reads from the port's
    checkpoint."""
    jm = _narrow_jax()
    params, _ = jm.init(jax.random.PRNGKey(2))
    tm = from_jax(jm.get_config(), _numpy(params), device="cpu")
    opt = Adam(1e-3)
    ts = create_train_state(tm, opt)
    step = make_train_step(tm, get_loss(LOSS), opt)
    x, y = _marker(8, 4)
    for _ in range(3):
        step(ts, torch.from_numpy(x), torch.from_numpy(y), 1e-3)
    assert type(ts.opt_state["t"]) is int and ts.opt_state["t"] == 3
    t = opt_state_to_jax(tm, ts.opt_state)["t"]
    assert t.dtype == np.int32 and t.shape == () and int(t) == 3
    save_checkpoint(str(tmp_path), tm, ts.opt_state, opt, {"epoch": 1})
    _, _, _, jax_state, jopt, _ = jax_load(str(tmp_path))
    assert int(jax_state["t"]) == 3 and jopt.get_config()["type"] == "adam"


# -- generators reseeded on the host -------------------------------------------

def _ops(fmt):
    return [ad.Brightness(0.2, 0.5), ad.Contrast(0.8, 1.2, 0.5),
            ad.Cutout(3, 0.5, fmt), ad.GaussianNoise(0.05, 0.5),
            ad.HorizontalFlip(0.5, fmt), ad.VerticalFlip(0.5, fmt),
            ad.Normalization([0.1, 0.2, 0.3], [0.5, 0.6, 0.7], fmt),
            ad.RandomCrop(2, 0.7, fmt), ad.Rotation(15.0, 0.5, fmt)]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("i", range(9))
def test_reseeded_generator_draws_each_augmentation_as_a_fresh_one(fmt, i):
    """Op ``i`` of a ``DeviceAugment`` run from one generator reseeded with
    ``fold_in(key, i)`` for three keys in turn equals the op run from a
    fresh ``generator(fold_in(key, i))`` each time."""
    shape = (6, 3, 8, 8) if fmt == "NCHW" else (6, 8, 8, 3)
    x = torch.from_numpy(np.random.default_rng(i).random(shape)
                         .astype(np.float32))
    op = _ops(fmt)[i]
    g, = generators(1, "cpu")
    for key in (3, 4, 3):
        k = fold_in(key, i)
        reseed([g], [k])
        assert torch.equal(op.run(x, g), op(x, k))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_reseeded_generators_draw_the_whole_pipeline_and_dropout(fmt):
    """A ``DeviceAugment`` of all nine ops from a fixed set of generators
    reseeded with ``aug.keys(key)`` equals ``aug(batch, key)``; a dropout
    mask from a generator reseeded with a key equals the mask of a fresh
    ``generator(key)``."""
    shape = (6, 3, 8, 8) if fmt == "NCHW" else (6, 8, 8, 3)
    x = torch.from_numpy(np.random.default_rng(1).random(shape)
                         .astype(np.float32))
    aug = ad.DeviceAugment(_ops(fmt))
    gens = generators(len(aug.ops), "cpu")
    drop = DropoutLayer(0.3).train()
    g, = generators(1, "cpu")
    for key in (11, 12, 11):
        reseed(gens, aug.keys(key))
        assert torch.equal(aug.run(x, gens), aug(x, key))
        reseed([g], [key])
        assert torch.equal(drop(x, generator=g),
                           drop(x, generator=generator(key, "cpu")))
    with pytest.raises(ValueError, match="generators"):
        aug.run(x, gens[:-1])
    with pytest.raises(ValueError, match="keys"):
        reseed(gens, [1])


# -- make_train_step(jit=True) on the CPU ----------------------------------------

@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guarded"])
def test_jit_step_equals_eager_and_the_jax_step(guard):
    """Three Adam steps of the narrow attention classifier: ``jit=True``
    (on the CPU the plain call) equals ``jit=False`` bit for bit in loss,
    logits, params and state, guarded or not; the first step's loss and
    logits and the state after two equal the JAX step's within TOL."""
    jm = _narrow_jax()
    jopt = JaxAdam(1e-3)
    ts_j = jax_trainer.create_train_state(jm, jopt, jax.random.PRNGKey(1))
    p0 = _numpy(ts_j.params)
    batches = [_marker(8, s) for s in (2, 3, 4)]
    jstep = jax_trainer.make_train_step(jm, jax_get_loss(LOSS), jopt,
                                        jit=False)
    want = []
    for x, y in batches[:2]:
        ts_j, loss, logits = jstep(ts_j, jnp.asarray(x), jnp.asarray(y),
                                   jax.random.PRNGKey(0), 1e-3)
        want.append((float(loss), np.asarray(logits)))
    out = {}
    for jit in (True, False):
        tm = from_jax(jm.get_config(), p0, device="cpu")
        opt = Adam(1e-3)
        ts = create_train_state(tm, opt)
        step = make_train_step(tm, get_loss(LOSS), opt, guard=guard, jit=jit)
        res = []
        for x, y in batches:
            r = step(ts, torch.from_numpy(x), torch.from_numpy(y), 1e-3)
            if guard:
                assert r[2] is False
            res.append((r[0], r[1]))
        if jit:
            np.testing.assert_allclose(res[0][0].item(), want[0][0], **TOL)
            np.testing.assert_allclose(res[0][1].numpy(), want[0][1], **TOL)
            np.testing.assert_allclose(res[1][0].item(), want[1][0], **TOL)
        out[jit] = (res, [p.detach().clone() for p in tm.parameters()],
                    ts.opt_state, ts.step)
    (rj, pj, sj, nj), (re, pe, se, ne) = out[True], out[False]
    assert nj == ne == 3 and sj["t"] == se["t"] == 3
    for (lj, oj), (le, oe) in zip(rj, re):
        assert torch.equal(lj, le) and torch.equal(oj, oe)
    for a, b in zip(pj, pe):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        for n in sj[k]:
            assert torch.equal(sj[k][n], se[k][n])


# -- the launch-delta bookkeeping ------------------------------------------------

def test_launch_deltas_are_taken_back_at_capture_and_added_per_replay(
        monkeypatch):
    """Three fake counted wrappers: what they count while a capture runs
    (``capture_tally``), on this thread or another (autograd runs a
    captured backward on its own thread), is the capture's delta (only
    the ones that moved) and is subtracted back, while a replay of another
    graph in the meantime stays counted and out of the delta; each replay
    adds the delta. On the CPU a session is the plain call and counts
    nothing itself."""
    import threading

    def fake(name):
        def f():
            _kernels._count(f)
        f.__name__, f.launches = name, 5
        return f

    a, b, c = fake("a"), fake("b"), fake("c")
    monkeypatch.setattr(_kernels, "COUNTED", (a, b, c))

    def counts():
        return tuple(w.launches for w in _kernels.COUNTED)

    with _kernels.capture_tally() as delta:
        a()  # what a captured function launches, here and on another thread
        for target in (a, c, lambda: graphs.add_launches({b: 1})):
            other = threading.Thread(target=target)  # the last: a replay
            other.start()
            other.join()
    assert delta == {a: 2, c: 1}
    assert graphs.take_back(delta) is delta
    assert counts() == (5, 6, 5)
    for _ in range(3):
        graphs.add_launches(delta)
    assert counts() == (11, 6, 8)
    pool = graphs.GraphPool("cpu")
    assert pool.bytes() == 0 and pool.handle is None
    pool.release([])  # nothing to give back on the CPU
    s = graphs.Session("plain", lambda x: (a(), x + 1)[1], (torch.zeros(2),),
                       pool=pool)
    assert s.graph is None and s.launches == {}
    assert torch.equal(s(torch.ones(2)), torch.full((2,), 2.0))
    assert a.launches == 12


def test_host_counts_are_held_at_capture_and_added_per_replay():
    """``count_host`` (the spatial step's halo counts): what captured code
    counts, on this thread or another, is held for the session instead of
    counted, and each replay adds it; outside a capture it counts at
    once. The halo counters of ``parallel/data_parallel.py`` count through
    it."""
    import threading

    from dcnn_tpu_torch.parallel import data_parallel

    table = {"exchanges": 0, "bytes": 0}
    graphs.count_host(table, "bytes", 3)
    assert table == {"exchanges": 0, "bytes": 3}
    with graphs.host_tally() as held:
        graphs.count_host(table, "exchanges")
        other = threading.Thread(
            target=lambda: graphs.count_host(table, "bytes", 8))
        other.start()
        other.join()
    assert table == {"exchanges": 0, "bytes": 3}
    assert held == [(table, "exchanges", 1), (table, "bytes", 8)]
    for _ in range(4):
        graphs.add_host(held)
    assert table == {"exchanges": 4, "bytes": 35}
    graphs.count_host(table, "exchanges")
    assert table["exchanges"] == 5
    src = open(data_parallel.__file__).read()
    assert 'count_host(HALO, "exchanges")' in src
    assert 'HALO["exchanges"] +=' not in src


# -- the restored state trains on ------------------------------------------------

def _cnn(name):
    return (SequentialBuilder(name).input((1, 8, 8))
            .conv2d(2, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(4).build())


def _loader():
    ld = SyntheticClassificationLoader(32, (1, 8, 8), 4, batch_size=8, seed=2)
    ld.load_data()
    return ld


def _fit(name, d, epochs, resume="never"):
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-3,
                         snapshot_dir=None, checkpoint_dir=d,
                         checkpoint_every=1, checkpoint_async=False,
                         resume=resume, progress_interval=0, seed=5)
    model, opt = _cnn(name), Adam(1e-3)
    tr = Trainer(model, opt, LOSS, config=cfg)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(0),
                            device="cpu")
    held = [id(t) for k in ("m", "v") for t in ts.opt_state[k].values()]
    return tr, tr.fit(ts, _loader(), epochs=epochs), held


def _state(model, ts):
    return ([t.detach().clone() for t in model.parameters()]
            + [t.clone() for t in model.buffers()]
            + [t.clone() for k in ("m", "v") for t in ts.opt_state[k].values()]
            + [ts.opt_state["t"], ts.step])


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


@pytest.mark.parametrize("how", ["rollback", "resume"])
def test_restore_copies_into_the_live_state_and_trains_on(tmp_path, how):
    """Epoch 1 checkpointed, then restored: by a rollback after epoch 2
    had trained (``_restore`` on the live state), or by ``resume="auto"``
    in a new trainer. Either way the optimizer state keeps its tensors
    (the ones a captured step writes), now holding the checkpoint's
    moments, and epoch 2 trained from there equals the uninterrupted
    run's epoch 2 bit for bit."""
    ref_tr, ref_ts, _ = _fit("ref", str(tmp_path / "ref"), 2)
    want = _state(ref_tr.model, ref_ts)
    d = str(tmp_path / "run")
    tr, ts, held = _fit("run", d, 1)
    loader = _loader()
    if how == "rollback":
        loader.shuffle(2)
        tr.train_epoch(ts, loader, 2)  # trained on, then rolled back
        tr._restore(ts)
        assert ts.step == 4 and ts.opt_state["t"] == 4
        loader.shuffle(2)
        tr.train_epoch(ts, loader, 2)
    else:
        tr, ts, held = _fit("run", d, 2, resume="auto")
        assert [h["epoch"] for h in tr.history] == [1, 2]
    assert [id(t) for k in ("m", "v") for t in ts.opt_state[k].values()] \
        == held
    _assert_same(_state(tr.model, ts), want)


@pytest.mark.parametrize("how", ["plain", "anomaly", "checked", "submodule",
                                 "global"])
def test_debug_eager_sees_anomaly_mode_and_hooks(how):
    """``debug_eager`` holds under autograd's anomaly mode (debug mode's
    ``checks=True``), inside ``checked`` and with a hook on a submodule or
    on every module, and stops holding once they are gone."""
    from dcnn_tpu_torch.core import debug

    model = _cnn("eager_probe")
    seen = []
    if how == "anomaly":
        with debug.debug_mode(nans=False, checks=True):
            seen.append(graphs.debug_eager(model))
    elif how == "checked":
        debug.checked(lambda m: seen.append(graphs.debug_eager(m)))(model)
    elif how == "submodule":
        leaf = list(model.modules())[-1]
        h = leaf.register_full_backward_hook(lambda *a: None)
        seen.append(graphs.debug_eager(model))
        h.remove()
    elif how == "global":
        h = torch.nn.modules.module.register_module_forward_hook(
            lambda *a: None)
        seen.append(graphs.debug_eager(model))
        h.remove()
    assert seen == ([] if how == "plain" else [True])
    assert not graphs.debug_eager(model)


def test_session_cache_warms_keys_by_precision_mode_and_binding():
    """A key's first call runs eagerly (None), the next captures, later
    ones reuse the capture; a new precision mode is a new key with its own
    warm-up; a moved binding captures again; the debug paths run eagerly
    without warming or capturing anything."""
    from dcnn_tpu_torch.core import debug, set_precision

    cache = graphs.SessionCache()
    made = []

    def look(bind=(1,), key=("k",)):
        return cache.lookup(key, bind,
                            lambda: made.append(bind) or len(made))

    with debug.debug_mode(nans=False, checks=True):
        assert look() is None
    assert not cache.warm and not made
    assert [look(), look(), look()] == [None, 1, 1]
    set_precision("bf16")
    try:
        assert [look(), look()] == [None, 2]
    finally:
        set_precision("parity")
    assert look() == 1
    assert look(bind=(2,)) == 3 and look(bind=(2,)) == 3
    assert made == [(1,), (1,), (2,)]
    assert sorted(k[-1] for k in cache) == ["bf16", "parity"]
    assert cache.latest() == 2
    model = _cnn("cache_probe")
    debug.checked(lambda m: made.append(cache.lookup(
        ("k",), (2,), lambda: 0, m)))(model)
    assert made[-1] is None and look(bind=(2,)) == 3
