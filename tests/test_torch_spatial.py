"""The port's spatial (dim-2) sharding held against the JAX package on the
CPU: ``shard_batch(spatial_axis=)`` and ``make_data_parallel_train_step(
spatial_axis=)`` (``dcnn_tpu_torch/parallel/data_parallel.py``, the ops'
rule in ``dcnn_tpu_torch/ops/spatial.py``).

The port's ranks are processes: the module spawns gloo worlds of 1, 2 and
4 ranks once (``spawn_world`` of ``tests/test_torch_data_parallel.py``)
and the tests read what the ranks wrote. The JAX side runs
``make_data_parallel_train_step(spatial_axis="sp")`` on the virtual CPU
devices the conftest makes, GSPMD inserting its halos. The same weights
(made by the JAX package from a seed, carried across by
``interop.from_jax``) and the same numpy batches go through both.

Tolerances: fp32 against JAX's spatial step, ``rtol 1e-4, atol 1e-5``
(loss, logits, params and batchnorm statistics after 2 AdamW steps); fp64
against the port's single-process step on the whole batch, ``1e-10`` of
each tensor's largest |value| (loss, the first step's gradients, params
and statistics after 2 steps), which a wrong ``1/S``, a halo row off by
one or a statistic over the wrong group breaks by orders of magnitude.
The world of 1 (mesh (1, 1)) is bit for bit the plain mesh step.
"""

import os
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcnn_tpu.core.mesh import make_mesh as jax_make_mesh
from dcnn_tpu.nn import SequentialBuilder
from dcnn_tpu.ops.losses import softmax_cross_entropy
from dcnn_tpu.optim import AdamW as JaxAdamW
from dcnn_tpu.parallel import make_data_parallel_train_step as jax_dp_step
from dcnn_tpu.parallel import replicate as jax_replicate
from dcnn_tpu.parallel import shard_batch as jax_shard_batch
from dcnn_tpu.train.trainer import TrainState as JaxTrainState
from dcnn_tpu.train.trainer import create_train_state as jax_create

from test_torch_data_parallel import spawn_world

KEY = jax.random.PRNGKey(0)
LR = 1e-3
STEPS = 2
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = 1e-10


def res_model(data_format="NCHW", bias=True):
    """A small ResNet: conv, BN, a 2x2 maxpool, a stride-2 basic block
    with projection, an average pool down to one row, flatten, dense.
    ``bias=False``: the same block with bias-free convs (ResNet's own
    form), for the fp32 gate against JAX under AdamW: a bias that feeds a
    batchnorm has a zero gradient in exact arithmetic, which Adam turns
    into steps of O(lr) in the sign of each package's rounding noise."""
    from dcnn_tpu.nn.layers import (ActivationLayer, BatchNormLayer,
                                    Conv2DLayer)

    shape = (3, 16, 16) if data_format == "NCHW" else (16, 16, 3)
    df = data_format
    b = (SequentialBuilder("sp_res", df).input(shape)
         .conv2d(8, 3, 1, 1, bias).batchnorm().activation("relu")
         .maxpool2d(2))
    if bias:
        b = b.basic_residual_block(8, 16, 2)
    else:
        b = b.residual(
            [Conv2DLayer(16, 3, 2, 1, False, 8, df, name="conv0"),
             BatchNormLayer(16, 1e-5, 0.1, True, df, name="bn0"),
             ActivationLayer("relu", name="relu0"),
             Conv2DLayer(16, 3, 1, 1, False, 16, df, name="conv1"),
             BatchNormLayer(16, 1e-5, 0.1, True, df, name="bn1")],
            [Conv2DLayer(16, 1, 2, 0, False, 8, df, name="proj"),
             BatchNormLayer(16, 1e-5, 0.1, True, df, name="proj_bn")])
    return b.avgpool2d(4, 1, 0).flatten().dense(10).build()


def gn_model():
    """Group norm, dropout and a padded 3x3 stride-2 max pool (-inf
    halos) on the sharded map."""
    return (SequentialBuilder("sp_gn").input((3, 16, 16))
            .conv2d(8, 3, 1, 1).groupnorm(2).activation("relu")
            .dropout(0.25).maxpool2d(3, 2, 1).conv2d(8, 3, 1, 1)
            .flatten().dense(10).build())


def mixed_model():
    """A residual block whose main branch gathers (a 7x7 conv's halo of 3
    exceeds 2 local rows at sp 4) while its identity shortcut stays
    sharded: the block must gather the shortcut too."""
    from dcnn_tpu.nn.layers import Conv2DLayer

    return (SequentialBuilder("sp_mixed").input((2, 8, 8))
            .conv2d(4, 3, 1, 1).activation("relu")
            .residual([Conv2DLayer(4, 7, 1, 3, True, 4)])
            .conv2d(4, 3, 1, 1).flatten().dense(10).build())


def halo_model():
    """``tests/test_parallel_sharding.py::test_spatial_sharding_conv_halo``'s
    model."""
    return (SequentialBuilder("sp_model").input((3, 16, 16))
            .conv2d(4, 3, 1, 1).activation("relu")
            .conv2d(4, 3, 1, 1).build())


MODELS = {"res": res_model, "res_nhwc": lambda: res_model("NHWC"),
          "res_nb": lambda: res_model(bias=False),
          "res_nb_nhwc": lambda: res_model("NHWC", bias=False),
          "gn": gn_model, "mixed": mixed_model, "halo": halo_model}

# (name, model, mesh (data, sp), dtype, mode, batch rows, data seed)
# mode "step": the spatial step (fp32 vs JAX, fp64 vs one process);
# "forward": an eval forward under the spatial context, gathered;
# "world1": the (1, 1) spatial step vs the plain mesh step, both jit=False
CASES = {
    1: [("world1", "res", (1, 1), "float32", "world1", 8, 0)],
    2: [("res_12", "res_nb", (1, 2), "float32", "step", 8, 0),
        ("res_12_f64", "res", (1, 2), "float64", "step", 8, 0),
        ("nhwc_12", "res_nb_nhwc", (1, 2), "float32", "step", 8, 1),
        ("nhwc_12_f64", "res_nhwc", (1, 2), "float64", "step", 8, 1),
        ("gn_12_f64", "gn", (1, 2), "float64", "step", 4, 2)],
    4: [("res_22", "res_nb", (2, 2), "float32", "step", 8, 0),
        ("res_22_f64", "res", (2, 2), "float64", "step", 8, 0),
        ("res_14", "res_nb", (1, 4), "float32", "step", 8, 0),
        ("res_14_f64", "res", (1, 4), "float64", "step", 8, 0),
        ("gn_14_f64", "gn", (1, 4), "float64", "step", 4, 2),
        ("mixed_14_f64", "mixed", (1, 4), "float64", "step", 4, 3),
        ("halo_14", "halo", (1, 4), "float32", "forward", 2, 4)],
}

WORKER = textwrap.dedent("""
    import copy, os, pickle, sys
    sys.path.insert(0, {repo!r})
    import numpy as np, torch
    from dcnn_tpu_torch.core import set_precision
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
    from dcnn_tpu_torch.ops import spatial
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import AdamW
    from dcnn_tpu_torch.parallel import (
        make_data_parallel_train_step, multihost, replicate, shard_batch)
    from dcnn_tpu_torch.parallel.data_parallel import (
        HALO, GatherDim, HaloExchange, SpatialContext)
    from dcnn_tpu_torch.train import create_train_state, make_train_step

    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    multihost.initialize(f"127.0.0.1:{{port}}", world, rank,
                         backend="gloo", timeout_s=60)
    spec = pickle.load(open(os.path.join(d, "spec.pkl"), "rb"))
    loss = get_loss("softmax_crossentropy")
    out = {{}}

    def named(model, grads=False):
        if grads:
            return {{n: p.grad.detach().numpy().copy()
                    for n, p in model.named_parameters()}}
        t = {{n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}}
        t.update({{n: b.numpy().copy() for n, b in model.named_buffers()}})
        return t

    def build(case):
        model = from_jax(case["config"], case["params"], case["state"],
                         device="cpu")
        return model.double() if case["dtype"] == "float64" else model

    def run(model, step, x, y, steps, seed):
        ts = create_train_state(model, AdamW(case["lr"], weight_decay=1e-4))
        losses, grads, logits = [], None, None
        for i in range(steps):
            gen = torch.Generator().manual_seed(seed + i)
            lv, lg = step(ts, x, y, case["lr"], gen)
            losses.append(float(lv))
            if i == 0:
                grads = named(model, grads=True)
                logits = lg.detach().numpy().copy()
        return losses, grads, logits

    meshes = {{}}
    for name, case in spec["cases"].items():
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "sp"))
        mesh = meshes[shape]
        set_precision("fp64" if case["dtype"] == "float64" else "parity")
        dt = torch.float64 if case["dtype"] == "float64" else torch.float32
        x = torch.from_numpy(case["x"]).to(dt)
        y = torch.from_numpy(case["y"]).to(dt)
        model = build(case)
        res = {{}}
        if case["mode"] == "forward":
            model.eval()
            xs = shard_batch(x, mesh, spatial_axis="sp")
            ctx = SpatialContext(mesh.get_group("sp"),
                                 mesh.get_group(("data", "sp")))
            with torch.no_grad(), spatial.activate(ctx):
                res["out"] = spatial.gather(model(xs)).numpy()
            res["local_rows"] = int(xs.shape[2])
        else:
            opt = AdamW(case["lr"], weight_decay=1e-4)
            ts = create_train_state(model, opt)
            if rank:  # replicate must overwrite a rank's divergent copy
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)
            replicate(ts, mesh)
            xs, ys = shard_batch((x, y), mesh, spatial_axis="sp")
            h0 = HALO["bytes"]
            sp = make_data_parallel_train_step(
                model, loss, opt, mesh, spatial_axis="sp", jit=False)
            seed = 7 + mesh.coordinate("data")
            res["losses"], res["grads"], res["logits"] = run(
                model, sp, xs, ys, case["steps"], seed)
            res["final"] = named(model)
            res["params"], res["state"] = to_jax(model), state_to_jax(model)
            res["halo_bytes"] = HALO["bytes"] - h0
            res["local_rows"] = int(xs.shape[2])
            if case["mode"] == "world1":
                ref = build(case)
                plain = make_data_parallel_train_step(
                    ref, loss, AdamW(case["lr"], weight_decay=1e-4), mesh,
                    jit=False)
                r = run(ref, plain, x, y, case["steps"], 7)
                res["ref"] = {{"losses": r[0], "grads": r[1],
                              "logits": r[2], "final": named(ref)}}
            elif case["dtype"] == "float64" and rank == 0:
                ref = build(case)
                plain = make_train_step(
                    ref, loss, AdamW(case["lr"], weight_decay=1e-4),
                    jit=False)
                r = run(ref, plain, x, y, case["steps"], 7)
                res["ref"] = {{"losses": r[0], "grads": r[1],
                              "logits": r[2], "final": named(ref)}}
        out[name] = res

    # the exchanges alone, on the widest mesh of the world
    mesh = meshes[max(meshes, key=lambda s: s[1])]
    group = mesh.get_group("sp")
    j, n = mesh.coordinate("sp"), mesh.shape["sp"]
    if n > 1:
        x = (torch.arange(2 * 3 * 4, dtype=torch.float64).reshape(1, 2, 3, 4)
             + 100 * j).requires_grad_()
        hx = HaloExchange.apply(x, 2, -5.0, group)
        w = torch.arange(hx.numel(), dtype=torch.float64).reshape(hx.shape)
        (hx * w).sum().backward()
        out["halo"] = {{"y": hx.detach().numpy(), "g": x.grad.numpy(),
                       "rank": j, "size": n}}
        x.grad = None
        gx = GatherDim.apply(x, 2, group)
        (gx * (j + 1)).sum().backward()
        out["gather"] = {{"y": gx.detach().numpy(), "g": x.grad.numpy()}}
    with open(os.path.join(d, f"out{{rank}}.pkl"), "wb") as f:
        pickle.dump(out, f)
    multihost.barrier("done", timeout_ms=60_000)
    print(f"rank {{rank}} OK", flush=True)
    multihost.shutdown()
""")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(shape, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=n)]
    return x, y


def _world(world, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"sp{world}")
    cases = {}
    for name, mk, mesh, dtype, mode, n, seed in CASES[world]:
        model = MODELS[mk]()
        params, state = model.init(KEY)
        x, y = _data(model.input_shape, n, seed)
        cases[name] = {"model": mk, "config": model.get_config(),
                       "params": _np(params), "state": _np(state), "x": x,
                       "y": y, "lr": LR, "steps": STEPS, "mesh": mesh,
                       "dtype": dtype, "mode": mode}
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump({"cases": cases}, f)
    spawn_world(WORKER, world, d)
    outs = [pickle.load(open(d / f"out{r}.pkl", "rb")) for r in range(world)]
    return cases, outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _world(w, tmp_path_factory) for w in (1, 2, 4)}


def _case(worlds, name):
    for w, (cases, outs) in worlds.items():
        if name in cases:
            return cases[name], outs
    raise KeyError(name)


def _jax_spatial(case):
    """(losses, logits of the first step, params, state) of JAX's spatial
    mesh step from the case's weights and batch."""
    model = MODELS[case["model"]]()
    opt = JaxAdamW(LR, weight_decay=1e-4)
    ts0 = jax_create(model, opt, KEY)
    d, s = case["mesh"]
    mesh = jax_make_mesh((d, s), ("data", "sp"),
                         devices=jax.devices()[:d * s])
    step = jax_dp_step(model, softmax_cross_entropy, opt, mesh,
                       spatial_axis="sp")
    ts = JaxTrainState(*(jax_replicate(t, mesh) for t in
                         (ts0.params, ts0.state, ts0.opt_state, ts0.step)))
    xs, ys = jax_shard_batch((jnp.asarray(case["x"]), jnp.asarray(case["y"])),
                             mesh, spatial_axis="sp")
    losses, first = [], None
    for _ in range(STEPS):
        ts, lv, logits = step(ts, xs, ys, KEY, LR)
        losses.append(float(lv))
        if first is None:
            first = np.asarray(logits)
    return losses, first, _np(ts.params), _np(ts.state)


def _close(a_tree, b_tree, **tol):
    la, lb = jax.tree_util.tree_leaves(a_tree), jax.tree_util.tree_leaves(
        b_tree)
    assert len(la) == len(lb) and la
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _port_logits(outs, name, mesh):
    """The global batch's logits: data row ``i``'s from its sp rank 0
    (rank ``i·S``); every sp rank of a row holds the same."""
    d, s = mesh
    for i in range(d):
        for j in range(1, s):
            np.testing.assert_array_equal(outs[i * s][name]["logits"],
                                          outs[i * s + j][name]["logits"])
    return np.concatenate([outs[i * s][name]["logits"] for i in range(d)])


def _bn_fed_biases(config, prefix="layers"):
    """Names of the conv biases that feed a batchnorm directly: their
    gradient is zero in exact arithmetic, rounding noise in fp64."""
    names = []
    layers = config["layers"]
    for i, cfg in enumerate(layers):
        if cfg["type"] == "residual_block":
            for key in ("layers", "shortcut"):
                names += _bn_fed_biases({"layers": cfg[key]},
                                        f"{prefix}.{i}.{key}")
        elif (cfg["type"] == "conv2d" and cfg.get("use_bias")
              and i + 1 < len(layers)
              and layers[i + 1]["type"] == "batchnorm"):
            names.append(f"{prefix}.{i}.b")
    return names


def _rel64(got, want, zero=()):
    """Largest |got - want| over each tensor's largest |want| (over the
    model's largest for the names in ``zero``), worst tensor first."""
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = []
    for n in want:
        scale = top if n in zero else (float(np.abs(want[n]).max()) or 1.0)
        worst.append((float(np.abs(got[n] - want[n]).max()) / scale, n))
    return max(worst)


@pytest.mark.parametrize("name", ["res_12", "res_22", "res_14", "nhwc_12"])
def test_spatial_step_matches_jax(name, worlds):
    """fp32: the port's spatial step against JAX's
    ``make_data_parallel_train_step(spatial_axis="sp")`` on the same
    weights and batch: losses, the first step's logits, params and
    batchnorm statistics after 2 AdamW steps; replicas bit-identical."""
    case, outs = _case(worlds, name)
    losses, logits, params, state = _jax_spatial(case)
    got = outs[0][name]
    np.testing.assert_allclose(got["losses"], losses, **JAX_TOL)
    np.testing.assert_allclose(_port_logits(outs, name, case["mesh"]),
                               logits, **JAX_TOL)
    _close(got["params"], params, **JAX_TOL)
    _close(got["state"], state, **JAX_TOL)
    for o in outs[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(o[name]["params"])):
            np.testing.assert_array_equal(a, b)
        assert o[name]["losses"] == got["losses"]


@pytest.mark.parametrize("name", ["res_12_f64", "res_22_f64", "res_14_f64",
                                  "nhwc_12_f64", "gn_12_f64", "gn_14_f64",
                                  "mixed_14_f64"])
def test_spatial_step_fp64_matches_single_process(name, worlds):
    """fp64: the spatial step against the port's single-process step on
    the whole batch, within 1e-10 of each tensor's largest |value|: the
    loss, the first step's gradients, params and statistics after 2 steps
    (a conv bias that feeds a batchnorm, whose gradient is zero in exact
    arithmetic and whose Adam steps follow its rounding noise, of the
    model's largest). At data size 1 the dropout masks are the single process's (the
    ranks draw the whole map's mask and keep their rows)."""
    case, outs = _case(worlds, name)
    got, ref = outs[0][name], outs[0][name]["ref"]
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= F64_TOL * abs(b), (got["losses"], ref["losses"])
    zero = _bn_fed_biases(case["config"])
    rel, at = _rel64(got["grads"], ref["grads"], zero)
    assert rel <= F64_TOL, f"gradient {at}: {rel:.3e}"
    rel, at = _rel64(got["final"], ref["final"], zero)
    assert rel <= F64_TOL, f"{at} after {STEPS} steps: {rel:.3e}"
    d, s = case["mesh"]
    logits = _port_logits(outs, name, case["mesh"])
    rel, _ = _rel64({"l": logits}, {"l": ref["logits"]})
    assert rel <= F64_TOL
    assert got["local_rows"] == case["x"].shape[2] // s


def test_world1_spatial_step_is_the_plain_mesh_step(worlds):
    """Mesh (1, 1): the spatial step (an sp axis of one shards nothing)
    equals ``make_data_parallel_train_step`` without ``spatial_axis`` bit
    for bit: losses, gradients, logits, params and statistics."""
    _case_, outs = _case(worlds, "world1")
    got = outs[0]["world1"]
    ref = got["ref"]
    assert got["losses"] == ref["losses"]
    assert got["halo_bytes"] == 0
    for k in ("grads", "final"):
        for n in ref[k]:
            np.testing.assert_array_equal(got[k][n], ref[k][n])
    np.testing.assert_array_equal(got["logits"], ref["logits"])


def test_spatial_sharding_conv_halo_sp4(worlds):
    """Twin of ``test_spatial_sharding_conv_halo`` at sp 4: H of 16 rows
    sharded 4 ways (4 rows a rank), two 3x3 convs exchanging one halo row
    a side, the gathered output against the JAX model's unsharded forward
    and its GSPMD-sharded one (rtol 1e-4, atol 1e-5)."""
    case, outs = _case(worlds, "halo_14")
    model = halo_model()
    params, state = model.init(KEY)
    x = jnp.asarray(case["x"])
    ref, _ = model.apply(params, state, x)
    mesh = jax_make_mesh((4,), ("sp",), devices=jax.devices()[:4])
    from jax.sharding import NamedSharding, PartitionSpec as P
    xs = jax.device_put(x, NamedSharding(mesh, P(None, None, "sp", None)))
    sharded = jax.jit(lambda p, s, v: model.apply(p, s, v)[0])(
        jax_replicate(params, mesh), jax_replicate(state, mesh), xs)
    for r, o in enumerate(outs):
        assert o["halo_14"]["local_rows"] == 4
        np.testing.assert_allclose(o["halo_14"]["out"], np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["halo_14"]["out"], np.asarray(sharded),
                                   rtol=1e-4, atol=1e-5)


def test_halo_exchange_rows_and_backward(worlds):
    """``HaloExchange`` at sp 4 with h=2: a rank's rows framed by the
    previous rank's last two and the next rank's first two, the fill past
    the global edges; its backward adds the neighbours' halo gradients to
    the rows they came from."""
    _cases, outs = worlds[4]
    xs = [(np.arange(24, dtype=np.float64).reshape(1, 2, 3, 4) + 100 * j)
          for j in range(4)]
    w = np.arange(2 * 7 * 4, dtype=np.float64).reshape(1, 2, 7, 4)
    for o in outs:
        j = o["halo"]["rank"]
        top = xs[j - 1][:, :, -2:] if j > 0 else np.full((1, 2, 2, 4), -5.0)
        bot = xs[j + 1][:, :, :2] if j < 3 else np.full((1, 2, 2, 4), -5.0)
        np.testing.assert_array_equal(
            o["halo"]["y"], np.concatenate([top, xs[j], bot], axis=2))
        # every rank's output weighted by w: row t of rank j feeds its own
        # output row t+2, the previous rank's row 5+t-... (its bottom halo)
        g = w[:, :, 2:5].copy()
        if j > 0:  # my first two rows are the previous rank's bottom halo
            g[:, :, :2] += w[:, :, 5:7]
        if j < 3:  # my last two rows are the next rank's top halo
            g[:, :, 1:3] += w[:, :, 0:2]
        np.testing.assert_array_equal(o["halo"]["g"], g)


def test_gather_dim_and_its_transpose(worlds):
    """``GatherDim`` at sp 4: the ranks' rows in rank order; its backward
    sums the cotangent over the axis (rank j's loss is (j+1)·Σ) and keeps
    the rank's rows: 1+2+3+4 = 10 everywhere."""
    _cases, outs = worlds[4]
    whole = np.concatenate(
        [np.arange(24, dtype=np.float64).reshape(1, 2, 3, 4) + 100 * j
         for j in range(4)], axis=2)
    for o in outs:
        np.testing.assert_array_equal(o["gather"]["y"], whole)
        np.testing.assert_array_equal(o["gather"]["g"],
                                      np.full((1, 2, 3, 4), 10.0))


def test_spatial_halo_bytes_counted(worlds):
    """The halo exchanges are counted (``HALO``): a sharded step sends
    bytes, and a rank of a wider axis sends no more than a narrower one's
    rank at the same batch (its halos are as wide, its rows fewer)."""
    c2, o2 = _case(worlds, "res_12")
    c4, o4 = _case(worlds, "res_14")
    b2, b4 = o2[0]["res_12"]["halo_bytes"], o4[1]["res_14"]["halo_bytes"]
    assert b2 > 0 and b4 > 0
    # an interior rank of 4 talks to two neighbours, an edge rank of 2 to
    # one; the rows a halo carries are the same
    assert b4 <= 2 * b2


class _FakeMesh:
    """``shape`` and ``coordinate`` of a (data, sp) mesh at one rank."""

    def __init__(self, shape, coord):
        self.shape = dict(zip(("data", "sp"), shape))
        self._coord = dict(zip(("data", "sp"), coord))

    def coordinate(self, axis):
        return self._coord[axis]


@pytest.mark.parametrize("shape,coord,dim", [
    ((1, 2), (0, 1), 2), ((2, 2), (1, 0), 2), ((1, 4), (0, 3), 2),
    ((2, 2), (0, 1), 3)])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_shard_batch_spatial_slices(shape, coord, dim, kind):
    """``shard_batch(spatial_axis=)``: rank (i, j) takes batch rows ``i``
    and dim-``spatial_dim`` slice ``j``, contiguously; the 2-D labels are
    cut along the batch only, as JAX's spec shards only arrays that have
    the dim."""
    import torch

    from dcnn_tpu_torch.parallel import shard_batch

    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 8, 8)).astype(np.float32)
    y = rng.normal(size=(4, 10)).astype(np.float32)
    if kind == "torch":
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    mesh = _FakeMesh(shape, coord)
    xs, ys = shard_batch((x, y), mesh, spatial_axis="sp", spatial_dim=dim)
    (d, s), (i, j) = shape, coord
    b, e = 4 // d, 8 // s
    want = np.asarray(x)[i * b:(i + 1) * b]
    want = want[:, :, j * e:(j + 1) * e] if dim == 2 \
        else want[:, :, :, j * e:(j + 1) * e]
    np.testing.assert_array_equal(np.asarray(xs), want)
    np.testing.assert_array_equal(np.asarray(ys),
                                  np.asarray(y)[i * b:(i + 1) * b])


def test_shard_batch_spatial_indivisible_raises():
    from dcnn_tpu_torch.parallel import shard_batch

    with pytest.raises(ValueError, match="not divisible by the 3-way 'sp'"):
        shard_batch(np.zeros((2, 1, 8, 8)), _FakeMesh((1, 3), (0, 0)),
                    spatial_axis="sp")
    with pytest.raises(ValueError, match="not divisible by the 2-way 'data'"):
        shard_batch(np.zeros((3, 1, 8, 8)), _FakeMesh((2, 1), (0, 0)),
                    spatial_axis="sp")


def test_spatial_axis_needs_4d_input():
    """A model whose input is not 4-D raises ``ValueError``, as JAX's
    ``make_data_parallel_train_step(spatial_axis=)`` does."""
    from dcnn_tpu_torch.nn import SequentialBuilder as PortBuilder
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import make_data_parallel_train_step

    m = PortBuilder("m").input((8,)).dense(4).build()
    with pytest.raises(ValueError, match="4-D image input"):
        make_data_parallel_train_step(m, get_loss("softmax_crossentropy"),
                                      SGD(0.1), mesh=None,
                                      spatial_axis="sp")
    jm = SequentialBuilder("m").input((8,)).dense(4).build()
    with pytest.raises(ValueError, match="4-D image input"):
        jax_dp_step(jm, softmax_cross_entropy, JaxAdamW(LR),
                    jax_make_mesh((1, 1), ("data", "sp"),
                                  devices=jax.devices()[:1]),
                    spatial_axis="sp")


@pytest.mark.parametrize("rows,k,s,p,local", [
    (8, 3, 1, 1, True), (8, 3, 2, 1, True), (8, 1, 2, 0, True),
    (8, 2, 2, 0, True), (4, 3, 2, 1, True), (1, 3, 1, 1, True),
    (3, 3, 2, 1, False),   # odd local rows under stride 2
    (2, 7, 1, 3, False),   # the halo exceeds a neighbour's rows
    (2, 4, 1, 0, False),   # avgpool(4, 1, 0) over 2 of 4 rows
    (8, 3, 1, 0, False)])  # a valid conv: the output does not split
def test_local_window_rule(rows, k, s, p, local):
    """Which window ops run on their local rows and which gather
    (``ops/spatial.py``'s rule), at ResNet-18's geometries."""
    from dcnn_tpu_torch.ops.spatial import local_window

    assert local_window(rows, k, s, p) is local


def test_ops_unchanged_outside_a_context():
    """Outside a spatial context every op is the plain one, bit for bit
    (a residual model's forward, train mode, against the same ops
    called directly)."""
    import torch

    from dcnn_tpu_torch.ops import spatial
    from dcnn_tpu_torch.ops.conv import conv2d
    from dcnn_tpu_torch.ops.pool import avg_pool2d, max_pool2d

    assert spatial.current() is None and spatial.context() is None
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=g)
    w = torch.randn(4, 3, 3, 3, generator=g)
    import torch.nn.functional as F
    assert torch.equal(conv2d(x, w, padding=1), F.conv2d(x, w, padding=1))
    assert torch.equal(max_pool2d(x, 2), F.max_pool2d(x, 2))
    assert torch.equal(avg_pool2d(x, 3, 1, 1),
                       F.avg_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 1))
