"""The port's public names against the JAX package's.

Every module of ``dcnn_tpu`` is read by AST (its ``__all__`` where it has
one, else its top-level public defs, classes and assignments), so the walk
imports no JAX; the port's module of the same dotted path must have each
name. ``EXCLUDED`` lists what the port leaves out by design, one reason a
name; ``EXCLUDED_MODULES`` the modules it does not port. Twin tests hold
``LayerFactory.create`` and ``apply_activation`` to JAX's outputs on the
same numpy inputs.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import LayerFactory as JaxLayerFactory
from dcnn_tpu.nn import Sequential as JaxSequential
from dcnn_tpu.ops.activations import apply_activation as jax_apply_activation
from dcnn_tpu_torch.interop import from_jax
from dcnn_tpu_torch.nn import LayerFactory, Sequential
from dcnn_tpu_torch.ops import apply_activation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "dcnn_tpu")

EXCLUDED = {
    "dcnn_tpu.core.precision.precision_keyed_jit":
        "JAX-only: a jit cache keyed on the precision mode; the port's "
        "graphs key their sessions on it (core/graphs.py)",
    "dcnn_tpu.core.precision.get_precision":
        "JAX-only: returns a lax.Precision for dot/conv calls",
    "dcnn_tpu.data.device_dataset.make_batch_scan_body":
        "JAX-only: the body of a lax.scan over batches; the port's resident "
        "epoch replays one graph a batch",
    "dcnn_tpu.data.augment_device.DeviceBatchFn":
        "JAX-only: the type of a jitted batch transform",
    "dcnn_tpu.data.workers.put_may_alias":
        "JAX-only: jax.device_put's may_alias probe",
    "dcnn_tpu.aot.keys.train_step_key_material":
        "no serializable compiled train step in the port (ROADMAP item 8)",
    "dcnn_tpu.aot.keys.decode_step_key_material":
        "no serializable compiled decode step in the port (ROADMAP item 8)",
    "dcnn_tpu.aot.keys.optimizer_id":
        "keys only the train-step material above (ROADMAP item 8)",
    "dcnn_tpu.nn.layer.Params":
        "JAX pytree alias: the port's params live on the nn.Module",
    "dcnn_tpu.nn.layer.State":
        "JAX pytree alias: the port's state is the module's buffers",
    "dcnn_tpu.nn.sequential.Params":
        "JAX pytree alias: the port's params live on the nn.Module",
    "dcnn_tpu.nn.sequential.State":
        "JAX pytree alias: the port's state is the module's buffers",
    "dcnn_tpu.nn.layers.Conv2DGeometryMixin":
        "the port's int8 conv shares geometry through _QuantizedLayer",
    "dcnn_tpu.nn.layers.DenseGeometryMixin":
        "the port's int8 dense shares geometry through _QuantizedLayer",
    "dcnn_tpu.nn.attention_layer.MHAGeometryMixin":
        "the port's int8 attention shares geometry through _QuantizedLayer",
    "dcnn_tpu.analysis.callgraph.JIT_WRAPPERS":
        "JAX-only: the trace roots; the port's capture roots are "
        "callgraph.SESSION_TAILS, autograd.Function and custom ops",
    "dcnn_tpu.analysis.callgraph.traced_functions":
        "JAX-only: the set under jax.jit; the port's is "
        "callgraph.captured_functions",
    "dcnn_tpu.analysis.retrace.JIT_TAILS":
        "JAX-only: jit wrapper names; TS06 in the port watches "
        "callgraph.SESSION_TAILS and SessionCache.lookup keys",
    "dcnn_tpu.analysis.trace_safety.HOST_SYNC_FUNCS":
        "JAX-only: jax.device_get / jax.block_until_ready; the port's host "
        "reads are methods (trace_safety.HOST_SYNC_ATTRS)",
}

EXCLUDED_MODULES = {
    "dcnn_tpu.core.compat": "JAX-only: version shims for jax APIs",
}


def _public(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__" and isinstance(node.value,
                                                    (ast.List, ast.Tuple)):
                    return {ast.literal_eval(e) for e in node.value.elts}
                names.add(t.id)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
            mod = rel.replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[:-len(".__init__")]
            out.append((mod, os.path.join(dirpath, f)))
    return sorted(out)


def _excluded_module(mod):
    return any(mod == m or mod.startswith(m + ".") for m in EXCLUDED_MODULES)


MODULES = [(m, p) for m, p in _jax_modules() if not _excluded_module(m)]


def test_walk_finds_the_package():
    mods = dict(_jax_modules())
    assert len(MODULES) > 80
    assert "dcnn_tpu.models" in mods and "dcnn_tpu.data.download" in mods
    assert {"create_mnist_trainer", "MODEL_ZOO"} <= _public(
        mods["dcnn_tpu.models"])


@pytest.mark.parametrize("mod,path", MODULES, ids=[m for m, _ in MODULES])
def test_port_has_every_public_name(mod, path):
    port = importlib.import_module(mod.replace("dcnn_tpu", "dcnn_tpu_torch",
                                               1))
    missing = sorted(n for n in _public(path)
                     if f"{mod}.{n}" not in EXCLUDED and not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_every_exclusion_is_real_and_reasoned():
    mods = dict(_jax_modules())
    for key, why in EXCLUDED.items():
        mod, name = key.rsplit(".", 1)
        assert why.strip(), key
        assert name in _public(mods[mod]), f"{key} is not a JAX public name"
        port = importlib.import_module(mod.replace("dcnn_tpu",
                                                   "dcnn_tpu_torch", 1))
        assert not hasattr(port, name), f"{key} is ported: drop the exclusion"
    for mod, why in EXCLUDED_MODULES.items():
        assert why.strip() and mod in mods, mod


LAYER_CFGS = [
    {"type": "dense", "name": "d", "out_features": 7, "use_bias": True},
    {"type": "conv2d", "name": "c", "out_channels": 4, "kernel_size": [3, 3],
     "stride": [1, 1], "padding": [1, 1], "use_bias": True,
     "data_format": "NCHW"},
    {"type": "activation", "name": "a", "activation": "elu"},
]
LAYER_INPUTS = {"dense": (5, 12), "conv2d": (2, 3, 6, 6),
                "activation": (4, 9)}


@pytest.mark.parametrize("cfg", LAYER_CFGS, ids=lambda c: c["type"])
def test_layer_factory_create_matches_jax(cfg):
    jl = JaxLayerFactory.create(dict(cfg))
    tl = LayerFactory.create(dict(cfg))
    assert type(tl).__name__ == type(jl).__name__
    assert tl.type_name == jl.type_name
    assert set(LayerFactory.registered()) >= {"dense", "conv2d",
                                              "activation"}
    shape = LAYER_INPUTS[cfg["type"]]
    jm = JaxSequential([jl], name="one", input_shape=shape[1:])
    params, state = jm.init(jax.random.PRNGKey(3), shape[1:])
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(jm.apply(params, state, jnp.asarray(x),
                               training=False)[0])
    pnp = jax.tree_util.tree_map(np.asarray, params)
    tm = from_jax(jm.get_config(), pnp, device="cpu")
    assert isinstance(tm, Sequential)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_factory_refuses_unknown_type():
    with pytest.raises(ValueError):
        LayerFactory.create({"type": "no_such_layer"})


@pytest.mark.parametrize("name,kw", [
    ("relu", {}), ("leaky_relu", {"negative_slope": 0.2}),
    ("ELU", {"alpha": 0.5}), ("sigmoid", {}), ("tanh", {}),
    ("softmax", {"axis": 0}), ("linear", {}), ("none", {}), (None, {})])
def test_apply_activation_matches_jax(name, kw):
    x = np.random.default_rng(5).normal(size=(6, 11)).astype(np.float32) * 3
    want = np.asarray(jax_apply_activation(name, jnp.asarray(x), **kw))
    got = apply_activation(name, torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_apply_activation_refuses_unknown_name():
    with pytest.raises(ValueError, match="unknown activation"):
        apply_activation("swishy", torch.zeros(2))
    with pytest.raises(ValueError, match="unknown activation"):
        jax_apply_activation("swishy", jnp.zeros(2))


def test_device_registry_without_a_card():
    from dcnn_tpu_torch.core import (DeviceManager, default_device,
                                     device_count, local_devices)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_cuda.py")
    dm = DeviceManager()
    assert [d.id for d in dm.all()] == ["CPU:0"]
    assert dm.cpu().device == torch.device("cpu")
    assert dm.get("CPU:0").platform == "cpu"
    assert not dm.cpu().is_accelerator
    assert dm.accelerators() == [] and local_devices() == []
    assert device_count() == 0
    with pytest.raises(KeyError):
        dm.get("CUDA:0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dm.default()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()


def test_small_public_names():
    import dcnn_tpu
    import dcnn_tpu_torch
    from dcnn_tpu import native as jax_native
    from dcnn_tpu.parallel import SEQ_AXIS as JAX_SEQ_AXIS
    from dcnn_tpu_torch import native
    from dcnn_tpu_torch.parallel import SEQ_AXIS
    from dcnn_tpu_torch.parallel.partitioner import Partition  # noqa: F401

    assert dcnn_tpu_torch.__version__ == dcnn_tpu.__version__
    assert SEQ_AXIS == JAX_SEQ_AXIS
    assert isinstance(native.lz4_available(), bool)
    assert native.lz4_available() == (native.lib() is not None)
    assert callable(jax_native.lz4_available)
