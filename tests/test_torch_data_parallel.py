"""The port's mesh and data-parallel step held against the JAX package on
the CPU (counterparts of ``tests/test_parallel_sharding.py``'s mesh and
data-parallel cases, and of ``make_train_step(reduce_axis=)``).

The port's ranks are processes: each test module spawns gloo worlds of 2
and 4 ranks once (``python -c`` workers over an ephemeral port, a timeout
on every wait) and the tests read what rank 0 wrote. The JAX side runs on
the 8 virtual CPU devices the conftest makes. The same weights (made by
the JAX package from a seed, carried across by ``interop.from_jax``) and
the same numpy batches go through both.

Tolerances, fp32: losses ``rtol 1e-5``; params ``rtol 1e-4, atol 1e-6``
(the JAX test's own); batchnorm running statistics ``rtol 1e-5, atol
1e-6``. Replicated params are bit-identical across the port's ranks.

The JAX test's ``make_mesh((4, 2), ("data", "stage"))`` over 8 devices is
``make_mesh((2, 2), ("data", "stage"))`` over a world of 4 here (one rank
a process; 8 processes would double the spawn for no new path).
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from dcnn_tpu.core.compat import shard_map
from dcnn_tpu.core.mesh import make_mesh as jax_make_mesh
from dcnn_tpu.nn import SequentialBuilder
from dcnn_tpu.ops.losses import softmax_cross_entropy
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.parallel import make_data_parallel_train_step as jax_dp_step
from dcnn_tpu.parallel import replicate as jax_replicate
from dcnn_tpu.parallel import shard_batch as jax_shard_batch
from dcnn_tpu.train import make_train_step as jax_make_train_step
from dcnn_tpu.train.trainer import TrainState as JaxTrainState
from dcnn_tpu.train.trainer import create_train_state as jax_create

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
LR = 0.1
STEPS = 2
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def conv_model():
    """``tests/test_parallel_sharding.py``'s model."""
    return (SequentialBuilder("dp_model").input((1, 8, 8))
            .conv2d(4, 3, 1, 1).activation("relu").maxpool2d(2)
            .flatten().dense(10).build())


def bn_model():
    return (SequentialBuilder("dp_bn_model").input((3, 8, 8))
            .conv2d(4, 3, 1, 1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(8).batchnorm().dense(10).build())


def _data(shape, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=n)]
    return x, y


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# every case a world runs: (name, mode, model fn, batch rows, data seed)
# mode "dp": make_data_parallel_train_step; "reduce": make_train_step(
# reduce_axis="data") inside `with mesh:`
CASES = {
    2: [("conv", "dp", conv_model, 16, 0), ("bn", "dp", bn_model, 16, 1),
        ("bn_reduce", "reduce", bn_model, 16, 2)],
    4: [("conv", "dp", conv_model, 16, 0), ("bn", "dp", bn_model, 16, 1)],
}

WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    from dcnn_tpu_torch.core.mesh import make_mesh, single_device_mesh
    from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (
        make_data_parallel_train_step, multihost, replicate, shard_batch)
    from dcnn_tpu_torch.train import create_train_state, make_train_step

    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    multihost.initialize(f"127.0.0.1:{{port}}", world, rank,
                         backend="gloo", timeout_s=60)
    spec = pickle.load(open(os.path.join(d, "spec.pkl"), "rb"))
    out = {{"world": multihost.process_count()}}

    # mesh shapes (tests/test_parallel_sharding.py::test_make_mesh_shapes)
    mesh = make_mesh()
    out["mesh_size"] = int(mesh.devices.size)
    out["mesh_shape"] = mesh.shape
    half = make_mesh((world // 2, 2), ("data", "stage"))
    out["mesh2_shape"] = half.shape
    errors = []
    for bad in (((world + 1, 1), ("data", "stage")), ((world,), ("a", "b"))):
        try:
            make_mesh(*bad)
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors
    try:
        single_device_mesh()
    except ValueError as e:
        out["single_error"] = str(e)

    loss = get_loss("softmax_crossentropy")
    for name, case in spec["cases"].items():
        model = from_jax(case["config"], case["params"], case["state"],
                         device="cpu")
        opt = SGD(case["lr"])
        ts = create_train_state(model, opt)
        if rank:  # replicate must overwrite a rank's divergent copy
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        replicate(ts, mesh)
        x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
        xs, ys = shard_batch((x, y), mesh)
        losses = []
        if case["mode"] == "dp":
            step = make_data_parallel_train_step(model, loss, opt, mesh)
            for _ in range(case["steps"]):
                lv, logits = step(ts, xs, ys, case["lr"])
                losses.append(float(lv))
        else:
            step = make_train_step(model, loss, opt, reduce_axis="data")
            with mesh:
                for _ in range(case["steps"]):
                    lv, logits = step(ts, xs, ys, case["lr"])
                    losses.append(float(lv))
        out[name] = {{"losses": losses, "params": to_jax(model),
                     "state": state_to_jax(model),
                     "logits_rows": int(logits.shape[0])}}
    with open(os.path.join(d, f"out{{rank}}.pkl"), "wb") as f:
        pickle.dump(out, f)
    multihost.barrier("done", timeout_ms=60_000)
    print(f"rank {{rank}} OK", flush=True)
    multihost.shutdown()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(script: str, world: int, d, timeout: float = 120.0):
    """``world`` ranks of ``script`` over gloo; every rank must exit 0 and
    print ``rank R OK``."""
    port = free_port()
    # not DCNN_PRECISION: a test that imported bench.py set it to bf16 in
    # this process, and the ranks compute at the port's default (parity)
    env = {k: v for k, v in os.environ.items() if k != "DCNN_PRECISION"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script.format(repo=REPO), str(r), str(world),
         str(port), str(d)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True, cwd=REPO)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"rank {r} OK" in out, out
    return outs


def _world(world, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"dp{world}")
    cases = {}
    for name, mode, fn, n, seed in CASES[world]:
        model = fn()
        params, state = model.init(KEY)
        x, y = _data(model.input_shape, n, seed)
        cases[name] = {"config": model.get_config(), "params": _np(params),
                       "state": _np(state), "x": x, "y": y, "lr": LR,
                       "steps": STEPS, "mode": mode}
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump({"cases": cases}, f)
    spawn_world(WORKER, world, d)
    outs = [pickle.load(open(d / f"out{r}.pkl", "rb")) for r in range(world)]
    return cases, outs


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _jax_runs(fn, case, world):
    """(losses, params, state) of the JAX mesh data-parallel step over
    ``world`` devices, and of the single-device step, from the case's
    weights and batch."""
    model = fn()
    opt = JaxSGD(LR)
    ts0 = jax_create(model, opt, KEY)
    x, y = jnp.asarray(case["x"]), jnp.asarray(case["y"])
    # the single-device run first: the mesh step donates its state
    step_ref = jax_make_train_step(model, softmax_cross_entropy, opt,
                                   donate=False)
    ref = ts0
    ref_losses = []
    for _ in range(STEPS):
        ref, lv, _ = step_ref(ref, x, y, KEY, LR)
        ref_losses.append(float(lv))
    ref = _np(ref.params), _np(ref.state)
    mesh = jax_make_mesh((world,), ("data",), devices=jax.devices()[:world])
    step_dp = jax_dp_step(model, softmax_cross_entropy, opt, mesh)
    ts = JaxTrainState(*(jax_replicate(t, mesh) for t in
                         (ts0.params, ts0.state, ts0.opt_state, ts0.step)))
    xs, ys = jax_shard_batch((x, y), mesh)
    dp_losses = []
    for _ in range(STEPS):
        ts, lv, _ = step_dp(ts, xs, ys, KEY, LR)
        dp_losses.append(float(lv))
    return ((dp_losses, _np(ts.params), _np(ts.state)),
            (ref_losses, *ref))


def _close(a_tree, b_tree, **tol):
    la, lb = jax.tree_util.tree_leaves(a_tree), jax.tree_util.tree_leaves(
        b_tree)
    assert len(la) == len(lb) and la
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _replicas_equal(outs, name):
    for o in outs[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(outs[0][name]["params"]),
                        jax.tree_util.tree_leaves(o[name]["params"])):
            np.testing.assert_array_equal(a, b)
        assert o[name]["losses"] == outs[0][name]["losses"]


def test_make_mesh_shapes(world2, world4):
    """Twin of ``test_make_mesh_shapes``: the default mesh covers the
    world, a 2-D mesh reports its axis sizes by name, a shape that does not
    cover the world and a rank mismatch raise ``ValueError``."""
    for world, (_cases, outs) in ((2, world2), (4, world4)):
        for o in outs:
            assert o["world"] == world
            assert o["mesh_size"] == world
            assert o["mesh_shape"] == {"data": world}
            assert o["mesh2_shape"] == {"data": world // 2, "stage": 2}
            assert "does not cover" in o["mesh_errors"][0]
            assert "rank mismatch" in o["mesh_errors"][1]
            assert "world of 1" in o["single_error"]
    jm = jax_make_mesh((4, 2), ("data", "stage"))
    assert dict(jm.shape) == {"data": 4, "stage": 2}


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_matches_single_device(world, world2, world4):
    """Twin of ``test_data_parallel_step_matches_single_device``: the
    port's step over a gloo world of 2 and of 4 against the JAX mesh step
    and the JAX single-device step (loss rtol 1e-5; params rtol 1e-4,
    atol 1e-6), replicas bit-identical, logits local to the shard."""
    cases, outs = world2 if world == 2 else world4
    case, got = cases["conv"], outs[0]["conv"]
    (dp_l, dp_p, _), (ref_l, ref_p, _) = _jax_runs(conv_model, case, world)
    np.testing.assert_allclose(got["losses"], dp_l, **LOSS_TOL)
    np.testing.assert_allclose(got["losses"], ref_l, **LOSS_TOL)
    _close(got["params"], dp_p, **PARAM_TOL)
    _close(got["params"], ref_p, **PARAM_TOL)
    assert got["logits_rows"] == 16 // world
    _replicas_equal(outs, "conv")


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_global_batchnorm(world, world2, world4):
    """On a model with batchnorm the mesh step's statistics are the global
    batch's (JAX: GSPMD reduces across the sharded axis; the port: the
    per-rank sums all-reduced under autograd), so params and running
    statistics match the JAX mesh step and the single-device step."""
    cases, outs = world2 if world == 2 else world4
    case, got = cases["bn"], outs[0]["bn"]
    (dp_l, dp_p, dp_s), (ref_l, ref_p, ref_s) = _jax_runs(bn_model, case,
                                                           world)
    np.testing.assert_allclose(got["losses"], dp_l, **LOSS_TOL)
    np.testing.assert_allclose(got["losses"], ref_l, **LOSS_TOL)
    _close(got["params"], dp_p, **PARAM_TOL)
    _close(got["params"], ref_p, **PARAM_TOL)
    _close(got["state"], dp_s, **STAT_TOL)
    _close(got["state"], ref_s, **STAT_TOL)
    _replicas_equal(outs, "bn")


def test_reduce_axis_matches_jax_shard_map(world2):
    """``make_train_step(reduce_axis="data")`` on 2 ranks against the JAX
    step with ``reduce_axis="data"`` inside ``shard_map`` over 2 devices:
    per-shard statistics, then gradients, loss and the updated statistics
    averaged over the axis."""
    cases, outs = world2
    case, got = cases["bn_reduce"], outs[0]["bn_reduce"]
    model = bn_model()
    opt = JaxSGD(LR)
    ts = jax_create(model, opt, KEY)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("data",))
    body = jax_make_train_step(model, softmax_cross_entropy, opt, jit=False,
                               reduce_axis="data")
    f = jax.jit(shard_map(
        lambda t, x, y: body(t, x, y, KEY, LR)[:2], mesh=mesh,
        in_specs=(P(), P("data"), P("data")), out_specs=(P(), P()),
        check_vma=False))
    losses = []
    for _ in range(STEPS):
        ts, lv = f(ts, jnp.asarray(case["x"]), jnp.asarray(case["y"]))
        losses.append(float(lv))
    np.testing.assert_allclose(got["losses"], losses, **LOSS_TOL)
    _close(got["params"], _np(ts.params), **PARAM_TOL)
    _close(got["state"], _np(ts.state), **STAT_TOL)
    _replicas_equal(outs, "bn_reduce")
    # per-shard statistics differ from the global batch's
    (_dl, _dp, dp_s), _ = _jax_runs(bn_model, case, 2)
    assert not all(np.allclose(a, b, **STAT_TOL) for a, b in zip(
        jax.tree_util.tree_leaves(got["state"]),
        jax.tree_util.tree_leaves(dp_s)))


def test_reduce_axis_needs_an_active_mesh():
    """An axis name resolves against the mesh active at the call; outside
    ``with mesh:`` the step refuses rather than reduce over nothing."""
    from dcnn_tpu_torch.parallel.data_parallel import MeshReduce

    with pytest.raises(ValueError, match="no mesh is active"):
        MeshReduce("data").group()
