"""The port's compiled pipeline held against the JAX package on the CPU
(twins of ``tests/test_compiled_pipeline.py``, less the data-parallel
composition, which needs a mesh): the homogeneous engine over a
``SequentialStageStack``, and ``HeteroCompiledPipeline``'s GPipe and 1F1B
steps against the host-driven coordinator and against the JAX engines
from one initialisation (``interop.compiled_from_jax``).

On the CPU a step is its eager run (the card replays it as one CUDA graph,
held bit for bit to the eager run in ``tests/test_torch_cuda.py``).
Tolerances, none looser than the JAX package's own:

- forward outputs and the homogeneous step's params: 1e-4 relative, 1e-5
  absolute; the homogeneous loss 1e-5 relative;
- a compiled step against the host-driven coordinator, and against the
  JAX engine: loss 1e-5 absolute, logits, params and BN statistics 2e-5;
- 1F1B against GPipe: loss 1e-6, the rest 2e-5;
- the bf16 wire: the loss within 0.05 of the fp32 wire's, and the returned
  loss within 1e-4 of the loss of the returned logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core.mesh import STAGE_AXIS, make_mesh
from dcnn_tpu.nn import Conv2DLayer as JaxConv
from dcnn_tpu.nn import GroupNormLayer as JaxGN
from dcnn_tpu.nn import ResidualBlock as JaxResidual
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.ops.losses import softmax_cross_entropy as jax_sce
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.parallel import compiled_pipeline as jcp
from dcnn_tpu_torch.interop import (
    compiled_from_jax, compiled_to_jax, tree_from_flat,
)
from dcnn_tpu_torch.nn import (
    ActivationLayer, BatchNormLayer, Conv2DLayer, GroupNormLayer,
    ResidualBlock, SequentialBuilder,
)
from dcnn_tpu_torch.obs import configure
from dcnn_tpu_torch.ops.losses import softmax_cross_entropy
from dcnn_tpu_torch.optim import SGD, Adam
from dcnn_tpu_torch.parallel import (
    FlopBalancedPartitioner, HeteroCompiledPipeline,
    InProcessPipelineCoordinator, SequentialStageStack,
    make_compiled_pipeline_forward, make_compiled_pipeline_train_step,
)
from dcnn_tpu_torch.parallel.compiled_pipeline import (
    gpipe_schedule, one_f_one_b_schedule,
)

KEY = jax.random.PRNGKey(0)
S = 4       # stages of the homogeneous stack
MB = 6      # its microbatches
TOL = dict(atol=2e-5, rtol=2e-5)
LR = 0.05


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


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


def _jax_stack(stacked, block_cfg):
    """The port's stacked block params as the JAX package's stacked
    tree."""
    per_stage = [tree_from_flat({"layers": [block_cfg]}, {
        f"layers.0.{n}": t[i].detach().numpy() for n, t in stacked.items()})[0]
        for i in range(S)]
    return jcp.stack_stage_params(per_stage)


# ------------------------------------------------------------- homogeneous

def test_compiled_forward_matches_sequential_chain():
    """Each microbatch through the stacked stages equals the stage chain,
    and the JAX block's chain on the same params."""
    stack = SequentialStageStack(_block(), S, (4, 8, 8))
    params = stack.init(_gen(), device="cpu")
    mbs = torch.tensor(np.random.default_rng(1).normal(
        size=(MB, 2, 4, 8, 8)).astype(np.float32))
    out = make_compiled_pipeline_forward(stack.stage_fn, S, MB)(params, mbs)
    jstack = jcp.SequentialStageStack(_jax_block(), S, (4, 8, 8))
    jstack.init(KEY)
    jparams = _jax_stack(params, stack.block.get_config())
    for i in range(MB):
        h = mbs[i]
        jh = jnp.asarray(mbs[i].numpy())
        for s in range(S):
            h = stack.stage_fn({n: t[s] for n, t in params.items()}, h)
            jh = jstack.stage_fn(jax.tree_util.tree_map(lambda a: a[s],
                                                        jparams), jh)
        np.testing.assert_allclose(out[i].numpy(), h.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(jh),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        make_compiled_pipeline_forward(stack.stage_fn, S, MB)(params, mbs[:2])


@pytest.mark.parametrize("remat", [True, False])
def test_compiled_train_step_matches_unpipelined_grads(remat):
    """One step's loss and updated params equal the unpipelined mean loss's
    gradient step and the JAX compiled step's from the same params."""
    stack = SequentialStageStack(_block(), S, (4, 8, 8))
    params = stack.init(_gen(), device="cpu")
    start = {n: t.detach().clone() for n, t in params.items()}
    rng = np.random.default_rng(0)
    mb_x = rng.normal(size=(MB, 2, 4, 8, 8)).astype(np.float32)
    mb_y = rng.normal(size=(MB, 2, 4, 8, 8)).astype(np.float32)
    opt = SGD(LR)
    step = make_compiled_pipeline_train_step(stack.stage_fn, _mse, opt, S, MB,
                                             remat=remat)
    new, _, loss, outs = step(params, opt.init(params), torch.tensor(mb_x),
                              torch.tensor(mb_y), LR)

    ref = {n: t.clone().requires_grad_(True) for n, t in start.items()}
    losses = []
    for i in range(MB):
        h = torch.tensor(mb_x[i])
        for s in range(S):
            h = stack.stage_fn({n: t[s] for n, t in ref.items()}, h)
        losses.append(_mse(h, torch.tensor(mb_y[i])))
    ref_loss = torch.stack(losses).mean()
    grads = torch.autograd.grad(ref_loss, list(ref.values()))
    np.testing.assert_allclose(float(loss), ref_loss.item(), rtol=1e-5)
    for (n, t), g in zip(ref.items(), grads):
        np.testing.assert_allclose(new[n].detach().numpy(),
                                   (t - LR * g).detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
    if not remat:
        return
    mesh = make_mesh((S,), (STAGE_AXIS,), devices=jax.devices()[:S])
    jstack = jcp.SequentialStageStack(_jax_block(), S, (4, 8, 8))
    jstack.init(KEY)
    jp = jcp.shard_stacked(_jax_stack(start, stack.block.get_config()), mesh)
    jopt = JaxSGD(LR)
    jstep = jcp.make_compiled_pipeline_train_step(
        jstack.stage_fn, lambda p, t: jnp.mean((p - t) ** 2), jopt, S, MB,
        mesh)
    jnew, _, jloss, jouts = jstep(jp, jopt.init(jp), jnp.asarray(mb_x),
                                  jnp.asarray(mb_y), jnp.float32(LR))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), rtol=1e-4,
                               atol=1e-5)
    want = _jax_stack(new, stack.block.get_config())
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(jnew)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_stage_stack_rejects_shape_changing_block():
    with pytest.raises(ValueError):
        SequentialStageStack(Conv2DLayer(8, 3, 2, 1), S, (4, 8, 8))


def test_stage_stack_rejects_stateful_block():
    with pytest.raises(ValueError):
        SequentialStageStack(BatchNormLayer(), S, (4, 8, 8)).init(
            device="cpu")
    with pytest.raises(RuntimeError):
        SequentialStageStack(_block(), S, (4, 8, 8)).stage_fn({}, None)


# ----------------------------------------------------------- heterogeneous

def _hetero(builder=SequentialBuilder):
    """Heterogeneous on purpose: a conv stem with BN, a downsampling pool,
    a dense head; the stages differ in params, activation shape and
    state."""
    return (builder("hetero_pipe").input((3, 8, 8))
            .conv2d(4, 3, 1, 1).batchnorm().activation("relu")
            .maxpool2d(2)
            .conv2d(8, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(16).activation("relu").dense(5).build())


def _gn_stack(S, builder=SequentialBuilder):
    b = (builder("gn_stack").input((3, 8, 8))
         .conv2d(8, 3, 1, 1).groupnorm(4).activation("relu"))
    for _ in range(max(S - 2, 1)):
        b = b.conv2d(8, 3, 1, 1).groupnorm(4).activation("relu")
    return b.flatten().dense(10).build()


def _data(n, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 8, 8)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _pipe(model, s, m, seed=0, **kw):
    pipe = HeteroCompiledPipeline(model, s, m, device="cpu", **kw)
    params, state = pipe.init(_gen(seed))
    return pipe, params, state


def _copy_weights(src, dst) -> None:
    dst.load_state_dict(src.state_dict())


def _run(pipe, params, state, opt, maker, x, y, steps=1, rng=9):
    M = pipe.num_microbatches
    step = getattr(pipe, maker)(softmax_cross_entropy, opt)
    ost = opt.init(params)
    mb_x = torch.tensor(x.reshape(M, -1, *x.shape[1:]))
    mb_y = torch.tensor(y.reshape(M, -1, y.shape[-1]))
    out = []
    for _ in range(steps):
        params, ost, state, loss, logits = step(params, ost, state, mb_x,
                                                mb_y, rng, LR)
        out.append(float(loss))
    return out, logits, params, state, step


def _assert_named_close(a, b, **tol):
    assert list(a) == list(b)
    for n in a:
        np.testing.assert_allclose(a[n].detach().numpy(),
                                   b[n].detach().numpy(), **tol)


def test_hetero_matches_host_driven_and_jax():
    """One compiled GPipe step and one 1F1B step equal the host-driven
    sync step from the same weights (loss, params, BN statistics), and the
    JAX package's GPipe and 1F1B steps from the JAX engine's own
    initialisation carried across (momentum SGD, as the JAX test): loss,
    logits, and every stage's updated params and BN statistics."""
    s_, m_ = 2, 2
    x, y = _data(8, 5)
    mesh = make_mesh((s_,), (STAGE_AXIS,), devices=jax.devices()[:s_])
    jpipe = jcp.HeteroCompiledPipeline(_hetero(JaxBuilder), s_, m_, mesh)
    results = {}
    for maker in ("make_train_step", "make_train_step_1f1b"):
        jfp, jfs = jpipe.init(jax.random.PRNGKey(3))  # a JAX step donates
        jps, jss = jpipe.unpack_params(jfp, jfs)
        pipe = HeteroCompiledPipeline(_hetero(), s_, m_, device="cpu")
        params, state = compiled_from_jax(pipe, jps, jss)
        got = compiled_to_jax(pipe, params, state)
        for mine, theirs in zip(got, (jps, jss)):
            for a, b in zip(jax.tree_util.tree_leaves(mine),
                            jax.tree_util.tree_leaves(theirs)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if maker == "make_train_step":  # the host-driven twin, same weights
            ref_model = _hetero()
            ref_model.init(generator=_gen(), device="cpu")
            _copy_weights(pipe.model, ref_model)
        losses, logits, params, state, _ = _run(
            pipe, params, state, SGD(LR, momentum=0.9), maker, x, y)
        results[maker] = (losses[0], logits, compiled_to_jax(pipe, params,
                                                             state))
        jopt = JaxSGD(LR, momentum=0.9)
        jstep = getattr(jpipe, maker)(jax_sce, jopt)
        jfp2, _, jfs2, jloss, jlogits = jstep(
            jfp, jopt.init(jfp), jfs, jnp.asarray(x.reshape(m_, 4, 3, 8, 8)),
            jnp.asarray(y.reshape(m_, 4, 5)), jax.random.PRNGKey(9),
            jnp.float32(LR))
        assert abs(losses[0] - float(jloss)) < 1e-5
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        # the updated params and BN statistics, stage by stage
        for mine, theirs in zip(results[maker][2],
                                jpipe.unpack_params(jfp2, jfs2)):
            mine_l = jax.tree_util.tree_leaves(mine)
            theirs_l = jax.tree_util.tree_leaves(theirs)
            assert len(mine_l) == len(theirs_l) > 0
            for a, b in zip(mine_l, theirs_l):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           **TOL)

    coord = InProcessPipelineCoordinator(
        ref_model, SGD(LR, momentum=0.9), "softmax_crossentropy",
        num_stages=s_, num_microbatches=m_, devices=["cpu"] * s_)
    coord.deploy_stages()
    ref_loss, ref_logits = coord.train_batch_sync(x, y, LR, 9)
    for maker, (loss, logits, (ps, ss)) in results.items():
        assert abs(loss - ref_loss) < 1e-5
        np.testing.assert_allclose(logits.reshape(8, 5).numpy(),
                                   ref_logits.numpy(), **TOL)
        for sid, stage in enumerate(coord.stages):
            for got, want in ((ps[sid], stage.params),
                              (ss[sid], stage.state)):
                want = tree_from_flat(stage.model.get_config(), {
                    n: t.detach().numpy() for n, t in want.items()})
                for a, b in zip(jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(want)):
                    np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("maker", ["make_train_step", "make_train_step_1f1b"])
def test_step_trains_the_params_of_a_later_init(maker):
    """A step made before ``pipe.init`` runs again binds the new params:
    its next step equals the first step of a fresh pipeline from that
    initialisation."""
    x, y = _data(8, 5)
    pipe, params, state = _pipe(_hetero(), 2, 2)
    opt = SGD(LR, momentum=0.9)
    step = getattr(pipe, maker)(softmax_cross_entropy, opt)
    mb_x = torch.tensor(x.reshape(2, 4, 3, 8, 8))
    mb_y = torch.tensor(y.reshape(2, 4, 5))
    step(params, opt.init(params), state, mb_x, mb_y, 9, LR)
    params, state = pipe.init(_gen(1))
    *_, loss, logits = step(params, opt.init(params), state, mb_x, mb_y, 9,
                            LR)
    fresh, fparams, fstate = _pipe(_hetero(), 2, 2, seed=1)
    want, want_logits, fparams, fstate, _ = _run(
        fresh, fparams, fstate, SGD(LR, momentum=0.9), maker, x, y)
    assert float(loss) == want[0]
    assert torch.equal(logits, want_logits)
    _assert_named_close(params, fparams, atol=0, rtol=0)
    _assert_named_close(state, fstate, atol=0, rtol=0)


def test_hetero_multi_step_loss_decreases():
    x, y = _data(8, 5, seed=1)
    pipe, params, state = _pipe(_hetero(), 2, 2)
    losses, *_ = _run(pipe, params, state, Adam(0.01), "make_train_step",
                      x, y, steps=8, rng=None)
    assert losses[-1] < losses[0]


def test_hetero_runs_a_residual_cnn():
    """A narrow ResNet (stem, BN residual blocks with a projection
    shortcut, pooled dense head) over 4 FLOP-balanced stages: ResNet-18's
    structure at a CPU size (ResNet-18 itself trains on the card)."""
    def block(c, stride, name):
        return ResidualBlock(
            layers=[Conv2DLayer(c, 3, stride, 1, use_bias=False),
                    BatchNormLayer(), ActivationLayer("relu"),
                    Conv2DLayer(c, 3, 1, 1, use_bias=False),
                    BatchNormLayer()],
            shortcut=([Conv2DLayer(c, 1, stride, 0, use_bias=False),
                       BatchNormLayer()] if stride > 1 else []),
            activation="relu", name=name)

    model = (SequentialBuilder("narrow_resnet").input((3, 16, 16))
             .conv2d(8, 3, 1, 1, False).batchnorm().activation("relu")
             .add_layer(block(8, 1, "b1")).add_layer(block(16, 2, "b2"))
             .add_layer(block(16, 1, "b3")).avgpool2d(8).flatten()
             .dense(10).build())
    M = 4
    pipe, params, state = _pipe(model, 4, M,
                                partitioner=FlopBalancedPartitioner())
    rng = np.random.default_rng(0)
    mb_x = torch.tensor(rng.normal(size=(M, 2, 3, 16, 16)).astype(np.float32))
    mb_y = torch.tensor(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (M, 2))])
    opt = SGD(0.01)
    step = pipe.make_train_step(softmax_cross_entropy, opt)
    _, _, _, loss, logits = step(params, opt.init(params), state, mb_x, mb_y,
                                 1, 0.01)
    assert np.isfinite(float(loss)) and logits.shape == (M, 2, 10)


@pytest.mark.parametrize("maker", ["make_train_step", "make_train_step_1f1b"])
def test_hetero_bf16_wire(maker):
    """The bf16 wire: the first loss tracks the fp32 wire's, training
    converges, the returned loss is the loss of the returned logits, and
    every boundary hands on a tensor of ``boundary_elems`` bf16
    elements."""
    x, y = _data(8, 5)
    mb_y = torch.tensor(y.reshape(2, 4, 5))
    losses = {}
    for wire in (torch.float32, torch.bfloat16):
        pipe, params, state = _pipe(_hetero(), 2, 2, wire_dtype=wire)
        sent = []
        for sm in pipe.stage_models[:-1]:
            sm.register_forward_hook(lambda m, i, o: sent.append(o))
        losses[wire], logits, *_ = _run(pipe, params, state, SGD(LR),
                                        maker, x, y, steps=4)
        relosses = [float(softmax_cross_entropy(logits[i], mb_y[i]))
                    for i in range(2)]
        assert abs(np.mean(relosses) - losses[wire][-1]) < 1e-4
        assert sent and all(t.numel() == pipe.boundary_elems(4)[0]
                            for t in sent)
    assert abs(losses[torch.bfloat16][0] - losses[torch.float32][0]) < 0.05
    assert losses[torch.bfloat16][-1] < losses[torch.bfloat16][0]


def test_boundaries_match_jax():
    """Stage input and output shapes and each boundary's width equal the
    JAX engine's for three stages of three widths."""
    def model(builder):
        return (builder("wire_exact").input((3, 8, 8))
                .conv2d(4, 3, 1, 1).activation("relu").maxpool2d(2)
                .conv2d(8, 3, 1, 1).activation("relu")
                .flatten().dense(16).activation("relu").dense(5).build())

    mesh = make_mesh((3,), (STAGE_AXIS,), devices=jax.devices()[:3])
    jpipe = jcp.HeteroCompiledPipeline(model(JaxBuilder), 3, 3, mesh)
    pipe = HeteroCompiledPipeline(model(SequentialBuilder), 3, 3,
                                  device="cpu")
    assert pipe.partitions == jpipe.partitions
    assert pipe.in_shapes == jpipe.in_shapes
    assert pipe.out_shapes == jpipe.out_shapes
    assert pipe.boundary_elems(2) == jpipe.boundary_elems(2)
    assert len(set(pipe.boundary_elems(2))) > 1


@pytest.mark.parametrize("S_M", [(2, 4), (4, 8), (8, 8)])
def test_1f1b_matches_gpipe_and_host_driven(S_M):
    s_, m_ = S_M
    mb = 2
    x, y = _data(m_ * mb, 10, seed=5)
    ref = _gn_stack(s_)
    ref.init(generator=_gen(), device="cpu")
    losses = {}
    for maker in ("make_train_step", "make_train_step_1f1b"):
        pipe, params, state = _pipe(_gn_stack(s_), s_, m_)
        _copy_weights(ref, pipe.model)
        losses[maker], *_ = _run(pipe, params, state, SGD(LR), maker, x, y)
    coord = InProcessPipelineCoordinator(
        ref, SGD(LR), "softmax_crossentropy", num_stages=s_,
        num_microbatches=m_, devices=["cpu"] * s_)
    coord.deploy_stages()
    ref_loss, _ = coord.train_batch_sync(x, y, LR, 9)
    assert abs(losses["make_train_step_1f1b"][0]
               - losses["make_train_step"][0]) < 1e-5
    assert abs(losses["make_train_step_1f1b"][0] - ref_loss) < 1e-5


def test_1f1b_full_parity_with_bn_state():
    x, y = _data(8, 5)
    out = {}
    for maker in ("make_train_step", "make_train_step_1f1b"):
        pipe, params, state = _pipe(_hetero(), 2, 2, seed=3)
        loss, logits, params, state, _ = _run(
            pipe, params, state, SGD(LR, momentum=0.9), maker, x, y)
        out[maker] = (loss[0], logits, params, state)
    l_g, logits_g, p_g, s_g = out["make_train_step"]
    l_f, logits_f, p_f, s_f = out["make_train_step_1f1b"]
    assert abs(l_g - l_f) < 1e-6
    np.testing.assert_allclose(logits_f.numpy(), logits_g.numpy(), **TOL)
    _assert_named_close(p_f, p_g, **TOL)
    _assert_named_close(s_f, s_g, **TOL)


@pytest.mark.parametrize("S_M", [(2, 4), (4, 8), (8, 8), (4, 2)])
def test_schedules_and_1f1b_memory_law(S_M):
    """Both schedules run each stage's forward and backward of each
    microbatch once, after what they need; GPipe holds M stage graphs a
    stage, 1F1B at most S (``min(S - s, M)`` at stage s), in the run's own
    bookkeeping too."""
    s_, m_ = S_M
    for sched in (gpipe_schedule(s_, m_), one_f_one_b_schedule(s_, m_)):
        assert sorted(sched) == sorted(
            (op, s, m) for op in "FB" for s in range(s_) for m in range(m_))
        done = set()
        for op, s, m in sched:
            if op == "F":
                assert s == 0 or ("F", s - 1, m) in done
            else:
                assert ("F", s, m) in done
                assert s == s_ - 1 or ("B", s + 1, m) in done
            done.add((op, s, m))
    if (s_, m_) != (4, 8):
        return
    x, y = _data(m_ * 2, 10)
    for maker, want in (("make_train_step", [m_] * s_),
                        ("make_train_step_1f1b",
                         [min(s_ - s, m_) for s in range(s_)])):
        pipe, params, state = _pipe(_gn_stack(s_), s_, m_)
        *_, step = _run(pipe, params, state, SGD(LR), maker, x, y)
        assert step.peak_stash == want


def test_host_and_compiled_equal_under_dropout():
    """With dropout, one seed gives the host-driven engine (both
    schedules) and both compiled schedules the same masks: losses and
    params agree."""
    def model():
        return (SequentialBuilder("drop").input((3, 8, 8))
                .conv2d(4, 3, 1, 1).activation("relu").dropout(0.5)
                .flatten().dense(16).activation("relu").dropout(0.3)
                .dense(5).build())

    x, y = _data(8, 5)
    ref = model()
    ref.init(generator=_gen(), device="cpu")
    results = []
    for sched in ("sync", "semi_async"):
        m = model()
        m.init(generator=_gen(), device="cpu")
        _copy_weights(ref, m)
        coord = InProcessPipelineCoordinator(
            m, SGD(LR), "softmax_crossentropy", num_stages=2,
            num_microbatches=2, devices=["cpu"] * 2)
        coord.deploy_stages()
        loss, _ = getattr(coord, f"train_batch_{sched}")(x, y, LR, 11)
        results.append((loss, coord.gathered_params()[0]))
    for maker in ("make_train_step", "make_train_step_1f1b"):
        pipe, params, state = _pipe(model(), 2, 2)
        _copy_weights(ref, pipe.model)
        losses, _, params, *_ = _run(pipe, params, state, SGD(LR), maker,
                                     x, y, rng=11)
        results.append((losses[0], params))
    # another seed draws other masks
    pipe, params, state = _pipe(model(), 2, 2)
    _copy_weights(ref, pipe.model)
    other, *_ = _run(pipe, params, state, SGD(LR), "make_train_step", x, y,
                     rng=12)
    assert abs(other[0] - results[0][0]) > 1e-4
    for loss, params in results[1:]:
        assert abs(loss - results[0][0]) < 1e-5
        _assert_named_close(params, results[0][1], **TOL)


def test_compiled_step_span():
    mine = configure(enabled=True)
    mine.clear()
    try:
        x, y = _data(8, 5)
        pipe, params, state = _pipe(_hetero(), 2, 2)
        _run(pipe, params, state, SGD(LR), "make_train_step_1f1b", x, y)
        evs = [e for e in mine.events() if e["name"].startswith("pipe.")]
        assert [(e["name"], e["track"]) for e in evs] == [
            ("pipe.compiled.step", "pipeline")]
        assert {k: evs[0]["args"][k] for k in
                ("schedule", "stages", "microbatches")} == {
            "schedule": "1f1b", "stages": 2, "microbatches": 2}
    finally:
        configure(enabled=False)
        mine.clear()
