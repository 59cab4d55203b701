"""The port's model splitting and in-process pipeline held against the JAX
package on the CPU: the layer metadata, ``Sequential.split`` /
``split_params`` / ``summary``, the partitioners, the optimizers'
``split_state`` / ``merge_state``, and ``InProcessPipelineCoordinator``
under both schedules with its failure paths (twins of
``tests/test_pipeline.py``, ``test_sequential.py::test_split_partitions``
and the in-process cases of ``test_pipeline_failures.py``).

Models are initialised in JAX and carried across with ``interop.from_jax``
(and ``pipeline_from_jax`` for a JAX pipeline's stages), so both packages
start from the same weights; inputs come from a numpy seed. Tolerances,
none looser than the JAX package's own test of the same property:

- the metadata, summaries and partitions are equal;
- forward outputs: 1e-4 relative, 1e-5 absolute (``test_pipeline.py``);
  the split chain against the whole model 1e-5 / 1e-6
  (``test_sequential.py``);
- a pipelined step against the unsplit microbatched step and against the
  JAX pipeline: loss 1e-4 / 1e-5, params 1e-3 / 1e-5
  (``test_pipeline.py``); BN running statistics 1e-5 absolute;
- a batch after a failed one against a coordinator that never failed:
  1e-5 / 1e-6 (``test_pipeline_failures.py``).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.models import zoo as jax_zoo
from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.obs import configure as jax_configure
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import Adam as JaxAdam
from dcnn_tpu.parallel import InProcessPipelineCoordinator as JaxCoord
from dcnn_tpu.parallel import partitioner as jax_part
from dcnn_tpu.parallel.pipeline import train_pipeline_epoch as jax_epoch
from dcnn_tpu_torch.interop import (
    from_jax, opt_state_to_jax, pipeline_from_jax, pipeline_to_jax,
    state_to_jax, to_jax,
)
from dcnn_tpu_torch.models import zoo
from dcnn_tpu_torch.nn import Sequential
from dcnn_tpu_torch.nn.sequential import merge_named
from dcnn_tpu_torch.obs import configure
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, Adam
from dcnn_tpu_torch.parallel import (
    FlopBalancedPartitioner, InProcessPipelineCoordinator, NaivePartitioner,
    PipelineError,
)
from dcnn_tpu_torch.parallel import pipeline as pl
from dcnn_tpu_torch.parallel.partitioner import MeasuredPartitioner
from dcnn_tpu_torch.parallel.pipeline import (
    format_profiling, split_microbatches, train_pipeline_epoch,
)
from dcnn_tpu_torch.train import create_train_state, make_train_step

KEY = jax.random.PRNGKey(0)
LOSS = "softmax_crossentropy"
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
ZOO = sorted(n for n in zoo.MODEL_ZOO if n != "mha_decoder")


def _pipe_jax():
    return (JaxBuilder("pipe_model").input((1, 8, 8))
            .conv2d(4, 3, 1, 1).activation("relu")
            .conv2d(8, 3, 2, 1).activation("relu")
            .flatten().dense(16).activation("relu").dense(10).build())


def _bn_jax():
    """Batchnorm in both halves of a 2-stage split (8 layers -> 4 + 4)."""
    return (JaxBuilder("fail_model").input((1, 8, 8))
            .conv2d(4, 3, 1, 1).batchnorm().activation("relu")
            .conv2d(4, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(10).build())


def _mha_jax():
    """mha_classifier's structure, narrow: E=16, 2 heads, S=8."""
    def block(name):
        return JaxResidual(layers=[JaxMHA(num_heads=2, impl="flash",
                                          name=f"{name}_mha")],
                           shortcut=[], activation="relu", name=name)
    return (JaxBuilder("narrow_mha").input((8, 16)).add_layer(block("a0"))
            .add_layer(block("a1")).flatten("flatten")
            .dense(10, True, "head").build())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jm, key=KEY):
    """The JAX model's weights from ``key`` in a port model on the CPU."""
    p, s = jm.init(key)
    return from_jax(jm.get_config(), _np(p), _np(s), device="cpu")


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, **tol)


def _batch(n=8, shape=(1, 8, 8), classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _coord(jm, num_stages=2, num_microbatches=2, opt=None, **kw):
    coord = InProcessPipelineCoordinator(
        _port(jm), opt or SGD(0.05), LOSS, num_stages=num_stages,
        num_microbatches=num_microbatches, devices=["cpu"] * num_stages,
        **kw)
    coord.deploy_stages()
    return coord


def _jax_coord(jm, num_stages=2, num_microbatches=2, opt=None, **kw):
    coord = JaxCoord(jm, opt or JaxSGD(0.05), LOSS, num_stages=num_stages,
                     num_microbatches=num_microbatches, **kw)
    coord.deploy_stages(KEY)
    return coord


# ------------------------------------------------------- metadata, split

@pytest.mark.parametrize("name", ZOO)
def test_metadata_and_summary_match_jax(name):
    """Every zoo model, both layouts: per-layer input shapes, forward and
    backward complexity, parameter counts and the summary table equal the
    JAX package's."""
    for fmt in ("NCHW", "NHWC"):
        tm, jm = zoo.MODEL_ZOO[name](fmt), jax_zoo.MODEL_ZOO[name](fmt)
        shapes = tm.layer_shapes()
        assert shapes == [tuple(s) for s in jm.layer_shapes()]
        assert [l.forward_complexity(s) for l, s in zip(tm.layers, shapes)] \
            == [l.forward_complexity(s) for l, s in zip(jm.layers, shapes)]
        assert [l.backward_complexity(s) for l, s in zip(tm.layers, shapes)] \
            == [l.backward_complexity(s) for l, s in zip(jm.layers, shapes)]
        assert tm.forward_complexity() == jm.forward_complexity()
        assert tm.param_count() == jm.param_count()
        assert tm.summary() == jm.summary()
    # a counted parameter is a parameter the port creates
    tm.init(generator=torch.Generator().manual_seed(0), device="cpu")
    assert tm.param_count() == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("name", ZOO)
def test_partitions_match_jax(name):
    """Naive, FLOP-balanced and measured partitions equal the JAX
    package's at 2, 3, 4 and 8 stages."""
    tm, jm = zoo.MODEL_ZOO[name](), jax_zoo.MODEL_ZOO[name]()
    rng = np.random.default_rng(7)
    for s in (2, 3, 4, 8):
        if s > len(tm):
            with pytest.raises(ValueError):
                FlopBalancedPartitioner().get_partitions(tm, s)
            continue
        for mine, theirs in ((NaivePartitioner(), jax_part.NaivePartitioner()),
                             (FlopBalancedPartitioner(),
                              jax_part.FlopBalancedPartitioner())):
            assert mine.get_partitions(tm, s) == theirs.get_partitions(jm, s)
        parts = NaivePartitioner().get_partitions(tm, s)
        walls = [float(w) for w in rng.uniform(0.0, 5.0, s)]
        walls[0] = 0.0  # a stage without a report keeps its FLOP costs
        assert (MeasuredPartitioner(parts, walls).get_partitions(tm, s)
                == jax_part.MeasuredPartitioner(parts, walls)
                .get_partitions(jm, s))


def test_split_partitions():
    """``split`` gives stage models over the model's own layer modules with
    their input shapes; the chained stages compute the whole model, and
    the JAX model too."""
    jm = jax_zoo.create_mnist_trainer()
    model = _port(jm)
    n = len(model)
    parts = [(0, 5), (5, n)]
    stages = model.split(parts)
    assert len(stages[0]) == 5 and len(stages[1]) == n - 5
    assert stages[0].input_shape == (1, 28, 28)
    assert stages[1].input_shape == stages[0].output_shape()
    assert all(a is b for a, b in zip(
        [l for s in stages for l in s.layers], model.layers))
    sp = model.split_params(dict(model.named_parameters()), parts)
    for stage, named in zip(stages, sp):
        assert named == dict(stage.named_parameters())
    assert merge_named(sp, parts) == dict(model.named_parameters())

    x = np.random.default_rng(3).normal(size=(2, 1, 28, 28)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        full = model(torch.tensor(x))
        h = torch.tensor(x)
        for stage in stages:
            h = stage(h)
    np.testing.assert_allclose(h.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)
    p, s = jm.init(KEY)
    ref, _ = jm.apply(p, s, jnp.asarray(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), **FWD_TOL)
    with pytest.raises(ValueError):
        model.split([(0, 0)])


def test_naive_partitioner_even_split():
    model = zoo.create_mnist_trainer()
    parts = NaivePartitioner().get_partitions(model, 3)
    assert parts[0][0] == 0 and parts[-1][1] == len(model)
    sizes = [e - s for s, e in parts]
    assert max(sizes) - min(sizes) <= 1
    for (s1, e1), (s2, e2) in zip(parts, parts[1:]):
        assert e1 == s2


def test_flop_balanced_partitioner_balances_cost():
    model = zoo.create_mnist_trainer()
    naive = NaivePartitioner().get_partitions(model, 2)
    flop = FlopBalancedPartitioner().get_partitions(model, 2)
    costs = [l.forward_complexity(s) + l.backward_complexity(s)
             for l, s in zip(model.layers, model.layer_shapes())]

    def imbalance(parts):
        stage_costs = [sum(costs[s:e]) for s, e in parts]
        return max(stage_costs) / max(min(stage_costs), 1)

    assert flop[0][0] == 0 and flop[-1][1] == len(model)
    assert imbalance(flop) <= imbalance(naive) + 1e-9


def test_split_microbatches():
    mbs = split_microbatches(torch.arange(10), 3)
    assert [len(m) for m in mbs] == [3, 3, 4]  # remainder in the last
    np.testing.assert_array_equal(torch.cat(mbs).numpy(), np.arange(10))
    with pytest.raises(ValueError):
        split_microbatches(torch.arange(2), 3)


@pytest.mark.parametrize("kind", ["sgd_momentum", "adam"])
def test_optimizer_split_merge_state(kind):
    """``split_state`` cuts a state after two steps as the JAX package's
    cuts it (per stage, through ``interop.opt_state_to_jax``); whole-run
    leaves are replicated; ``merge_state`` gives the state back."""
    jm = _pipe_jax()
    model = _port(jm)
    opt, jopt = ((SGD(0.05, momentum=0.9), JaxSGD(0.05, momentum=0.9))
                 if kind == "sgd_momentum" else (Adam(1e-3), JaxAdam(1e-3)))
    ts = create_train_state(model, opt)
    step = make_train_step(model, get_loss(LOSS), opt)
    for seed in (1, 2):
        x, y = _batch(seed=seed)
        step(ts, torch.tensor(x), torch.tensor(y), 0.05)
    parts = FlopBalancedPartitioner().get_partitions(model, 3)
    pieces = opt.split_state(ts.opt_state, parts)
    theirs = jopt.split_state(opt_state_to_jax(model, ts.opt_state), parts)
    for stage, mine, want in zip(model.split(parts), pieces, theirs):
        got = opt_state_to_jax(stage, mine)
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "t":
                assert int(got[k]) == int(want[k]) == 2
            else:
                for a, b in zip(_leaves(got[k]), _leaves(want[k])):
                    np.testing.assert_array_equal(a, b)
    merged = opt.merge_state(pieces, parts)
    assert sorted(merged) == sorted(ts.opt_state)
    for k, v in ts.opt_state.items():
        if isinstance(v, dict):
            assert list(merged[k]) == list(v)
            assert all(merged[k][n] is v[n] for n in v)
        else:
            assert merged[k] == v


# ------------------------------------------------------------ the pipeline

def test_pipeline_forward_matches_single_device():
    jm = _pipe_jax()
    coord = _coord(jm, num_stages=3)
    x = np.random.default_rng(1).normal(size=(4, 1, 8, 8)).astype(np.float32)
    model = _port(jm).eval()
    with torch.no_grad():
        ref = model(torch.tensor(x))
    out = coord.forward_only(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD_TOL)
    jref = _jax_coord(jm, num_stages=3).forward_only(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), **FWD_TOL)


@pytest.mark.parametrize("schedule", ["sync", "semi_async"])
def test_pipeline_training_matches_single_device_microbatched(schedule):
    """Pipeline training with N microbatches equals the unsplit step with
    N-way gradient accumulation, and the JAX pipeline."""
    jm = _pipe_jax()
    nmb = 2
    coord = _coord(jm, num_microbatches=nmb)
    jcoord = _jax_coord(jm, num_microbatches=nmb)
    ref_model = _port(jm)
    opt = SGD(0.05)
    ts = create_train_state(ref_model, opt)
    step = make_train_step(ref_model, get_loss(LOSS), opt,
                           num_microbatches=nmb)
    x, y = _batch()
    fn = (coord.train_batch_sync if schedule == "sync"
          else coord.train_batch_semi_async)
    jfn = (jcoord.train_batch_sync if schedule == "sync"
           else jcoord.train_batch_semi_async)
    for _ in range(3):
        loss, logits = fn(x, y, lr=0.05)
        ref_loss, ref_logits = step(ts, torch.tensor(x), torch.tensor(y),
                                    0.05)
        jloss, jlogits = jfn(x, y, lr=0.05)
        np.testing.assert_allclose(loss, float(ref_loss), **LOSS_TOL)
        np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **FWD_TOL)
    got, _ = coord.gathered_params()
    want = dict(ref_model.named_parameters())
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].detach().numpy(),
                                   **PARAM_TOL)
    jparams, _ = jcoord.gathered_params()
    _close(to_jax(_gathered_model(jm, coord)), _np(jparams), **PARAM_TOL)


def _gathered_model(jm, coord) -> Sequential:
    """A port model holding the coordinator's gathered weights."""
    model = _port(jm)
    p, s = coord.gathered_params()
    model.load_state_dict({**p, **s})
    return model


def test_pipeline_bn_stats_and_epoch_match_jax():
    """BN running statistics after pipelined batches (moved once a
    microbatch, in microbatch order) and ``train_pipeline_epoch``'s loss
    and accuracy equal the JAX package's; so do the stages' weights and
    optimizer states through ``pipeline_to_jax``."""
    jm = _bn_jax()
    coord = _coord(jm, opt=SGD(0.05, momentum=0.9))
    jcoord = _jax_coord(jm, opt=JaxSGD(0.05, momentum=0.9))
    batches = [_batch(seed=s) for s in (0, 1)]
    got = train_pipeline_epoch(coord, batches, 0.05, schedule="sync")
    want = jax_epoch(jcoord, batches, 0.05, schedule="sync")
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    assert got[1] == want[1]
    _, state = coord.gathered_params()
    _, jstate = jcoord.gathered_params()
    _close(state_to_jax(_gathered_model(jm, coord)), _np(jstate), atol=1e-5,
           rtol=0)
    for (p, s, o), js in zip(pipeline_to_jax(coord), jcoord.stages):
        _close(p, _np(js.params), **PARAM_TOL)
        _close(s, _np(js.state), atol=1e-5, rtol=0)
        _close(o["velocity"], _np(js.opt_state["velocity"]), **PARAM_TOL)


def test_pipeline_from_jax_continues_a_jax_pipeline():
    """A JAX pipeline's stages after a batch (params, BN state, Adam's
    moments and step) carried onto the port's coordinator come back bit
    for bit, and the next batch agrees."""
    jm = _bn_jax()
    jcoord = _jax_coord(jm, opt=JaxAdam(1e-3))
    x, y = _batch()
    jcoord.train_batch_semi_async(x, y, 1e-3)
    coord = _coord(_bn_jax(), opt=Adam(1e-3))
    trees = [(_np(s.params), _np(s.state), _np(s.opt_state))
             for s in jcoord.stages]
    pipeline_from_jax(coord, *zip(*trees))
    for (p, s, o), (jp, js, jo) in zip(pipeline_to_jax(coord), trees):
        _close(p, jp, rtol=0, atol=0)
        _close(s, js, rtol=0, atol=0)
        assert int(o["t"]) == int(jo["t"]) == 1
        _close(o["m"], jo["m"], rtol=0, atol=0)
    x2, y2 = _batch(seed=5)
    loss, _ = coord.train_batch_semi_async(x2, y2, 1e-3)
    jloss, _ = jcoord.train_batch_semi_async(x2, y2, 1e-3)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)


@pytest.mark.parametrize("schedule", ["sync", "semi_async"])
def test_mha_pipeline_matches_jax(schedule):
    """The slice's attention path, narrow: two residual MHA blocks split
    FLOP-balanced over 2 stages, so each holds one (the flash kernels'
    plain versions here, the JAX blockwise path there)."""
    jm = _mha_jax()
    part = FlopBalancedPartitioner()
    coord = _coord(jm, partitioner=part)
    assert coord.partitions == jax_part.FlopBalancedPartitioner() \
        .get_partitions(jm, 2) == [(0, 1), (1, 4)]
    jcoord = _jax_coord(jm, partitioner=jax_part.FlopBalancedPartitioner())
    x, y = _batch(shape=(8, 16))
    fn = getattr(coord, f"train_batch_{schedule}")
    jfn = getattr(jcoord, f"train_batch_{schedule}")
    for _ in range(2):
        np.testing.assert_allclose(fn(x, y, 0.05)[0], jfn(x, y, 0.05)[0],
                                   **LOSS_TOL)
    jparams, _ = jcoord.gathered_params()
    _close(to_jax(_gathered_model(jm, coord)), _np(jparams), **PARAM_TOL)


def test_pipeline_stages_on_listed_devices():
    """Each stage lives on its listed device and the chained schedule
    trains; ``track_load=True`` times every call."""
    coord = _coord(_pipe_jax(), num_stages=4, track_load=True)
    for stage in coord.stages:
        assert all(p.device.type == "cpu" for p in stage.params.values())
    x, y = _batch(4)
    loss, logits = coord.train_batch_semi_async(x, y, 0.01)
    assert np.isfinite(loss)
    assert logits.shape == (4, 10)
    reports = coord.collect_load_reports()
    assert len(reports) == 4 and reports[0]["forward_count"] > 0


def test_microbatch_cache_isolation():
    """Interleaved forwards of many microbatch ids keep their graphs
    apart; a backward consumes its own entry."""
    coord = _coord(_pipe_jax(), num_microbatches=4)
    stage = coord.stages[0]
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 1, 8, 8)).astype(np.float32) for _ in range(4)]
    outs = [stage.forward(i, xs[i]) for i in range(4)]
    assert len(stage._cache) == 4
    g = torch.ones_like(outs[2])
    stage.backward(2, g)
    assert 2 not in stage._cache and len(stage._cache) == 3
    with pytest.raises(PipelineError):
        stage.backward(2, g)


def test_in_process_profiling_collection():
    coord = _coord(_pipe_jax())
    empty = coord.collect_profiling()
    assert all(t["layers"] == [] for t in empty)
    assert "no microbatch" in format_profiling(empty)
    x, y = _batch(4)
    coord.train_batch_sync(x, y, 0.01, 2)
    tables = coord.collect_profiling()
    names = [r["name"] for t in tables for r in t["layers"]]
    assert names == [l.name for l in coord.model.layers]
    assert all(r["fwd_us"] > 0 and r["bwd_us"] > 0
               for t in tables for r in t["layers"])
    coord.clear_profiling()
    assert coord.collect_profiling()[0]["layers"][0]["calls"] == 1


def test_pipeline_spans_match_jax():
    """``pipe.batch`` on the ``pipeline`` track and ``pipe.fwd`` /
    ``pipe.bwd`` on ``stage<i>``, with the JAX package's names, tracks,
    attributes and counts."""
    x, y = _batch()
    mine, theirs = configure(enabled=True), jax_configure(enabled=True)
    try:
        coord, jcoord = _coord(_pipe_jax()), _jax_coord(_pipe_jax())
        for t in (mine, theirs):
            t.clear()
        coord.train_batch_sync(x, y, 0.05)
        coord.train_batch_semi_async(x, y, 0.05)
        jcoord.train_batch_sync(x, y, 0.05)
        jcoord.train_batch_semi_async(x, y, 0.05)

        def shapes(t):
            return sorted((e["name"], e["track"], tuple(sorted(
                k for k in e["args"] if k not in ("trace_id", "span_id",
                                                  "parent_id"))),
                           e["args"].get("schedule"), e["args"].get("mb"))
                          for e in t.events() if e["name"].startswith("pipe."))

        assert shapes(mine) == shapes(theirs)
        assert mine.span_counts()["pipe.fwd"] == 8
    finally:
        for t, c in ((mine, configure), (theirs, jax_configure)):
            c(enabled=False)
            t.clear()


# ---------------------------------------------------------- failure paths

def _fail_coord(**kw):
    return _coord(_bn_jax(), **kw)


@pytest.mark.parametrize("schedule", ["sync", "semi_async"])
def test_stage_failure_aborts_and_recovers(schedule):
    """A stage raising mid-schedule surfaces as ``PipelineError`` with its
    context, leaves no cached graphs or partial gradients and puts back the
    BN statistics; the next batch trains as on a coordinator that never
    failed."""
    coord, ref = _fail_coord(), _fail_coord()
    x, y = _batch()
    fn = getattr(coord, f"train_batch_{schedule}")
    ref_fn = getattr(ref, f"train_batch_{schedule}")
    victim = coord.stages[1]
    orig = victim._bwd

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    victim._bwd = boom
    with pytest.raises(PipelineError) as ei:
        fn(x, y, lr=0.05)
    assert ei.value.stage_id == 1 and ei.value.phase == "backward"
    victim._bwd = orig
    for s, r in zip(coord.stages, ref.stages):
        assert s._cache == {} and s._grad_count == 0
        assert all(p.grad is None for p in s.model.parameters())
        for n, b in s.state.items():
            assert torch.equal(b, r.state[n])
    loss_after, _ = fn(x, y, lr=0.05)
    loss_ref, _ = ref_fn(x, y, lr=0.05)
    np.testing.assert_allclose(loss_after, loss_ref, rtol=1e-5, atol=1e-6)


def test_abort_batch_puts_back_bn_stats():
    """The snapshot is a copy: completed forwards move the statistics in
    place, and ``abort_batch`` with the batch-start snapshots puts them
    back; without snapshots they stay moved."""
    coord = _fail_coord()
    x, _ = _batch()
    before = [{n: b.clone() for n, b in s.state.items()}
              for s in coord.stages]
    snaps = [s.snapshot_state() for s in coord.stages]
    h = coord.stages[0].forward(0, x)
    coord.stages[1].forward(0, h)
    assert not all(torch.equal(b, before[0][n])
                   for n, b in coord.stages[0].state.items())
    assert all(s.batch_open() for s in coord.stages)
    coord.abort_batch(snaps)
    for s, want in zip(coord.stages, before):
        assert not s.batch_open()
        for n, b in s.state.items():
            assert torch.equal(b, want[n])
    coord.stages[0].forward(0, x)
    coord.abort_batch()
    assert not torch.equal(coord.stages[0].state["layers.1.running_mean"],
                           before[0]["layers.1.running_mean"])


def test_forward_failure_context():
    coord = _fail_coord()
    x, y = _batch()

    def bad(*a, **k):
        raise ValueError("bad input")

    coord.stages[0]._fwd = bad
    with pytest.raises(PipelineError) as ei:
        coord.train_batch_sync(x, y, lr=0.05)
    assert ei.value.stage_id == 0 and ei.value.phase == "forward"


def test_unknown_microbatch_is_pipeline_error():
    coord = _fail_coord()
    with pytest.raises(PipelineError) as ei:
        coord.stages[0].backward(99, torch.zeros((4, 10)))
    assert ei.value.mb_id == 99


def test_join_and_timeout(monkeypatch):
    coord = _fail_coord()
    x, y = _batch()
    coord.train_batch_sync(x, y, lr=0.05)
    assert coord.join() is True
    assert coord.join(timeout=30.0) is True

    def slow_fence(tree):
        import time
        time.sleep(1.0)

    monkeypatch.setattr(pl, "hard_fence", slow_fence)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert coord.join(timeout=0.05) is False
    assert any("timed out" in str(m.message) for m in w)
    coord.close()


def test_sampled_load_tracking():
    coord = _fail_coord(track_load="sample")
    x, y = _batch(32)
    for _ in range(10):  # SAMPLE_EVERY=8: each stage samples at least twice
        coord.train_batch_sync(x, y, lr=0.05)
    reports = coord.collect_load_reports()
    assert len(reports) == 2
    for r in reports:
        assert r["forward_count"] >= 2 and r["backward_count"] >= 2
        assert r["avg_forward_ms"] > 0.0 and r["avg_backward_ms"] > 0.0
    assert coord.stages[0]._fwd_calls > coord.stages[0].load.forward_count


def test_track_load_validation():
    with pytest.raises(ValueError):
        _fail_coord(track_load="always")
