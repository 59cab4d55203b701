"""The port's model path held against the JAX package.

The JAX model is initialised in JAX; its config dict and params (as numpy)
go through ``dcnn_tpu_torch.interop.from_jax``; the same numpy inputs go
through both. On the CPU the JAX layer's ``impl="flash"`` takes its
blockwise path and the port's takes the flash kernel's plain version. fp32
tolerance 1e-4 on logits: two attention blocks and a 2048-wide dense head
summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.models.zoo import create_mha_classifier as jax_mha_classifier
from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu_torch.core import precision, resolve_device
from dcnn_tpu_torch.interop import from_jax
from dcnn_tpu_torch.models import (
    MHADecoder, create_mha_classifier, create_model,
)
from dcnn_tpu_torch.nn import (
    FlattenLayer, MultiHeadAttentionLayer, Sequential, SequentialBuilder,
)
from dcnn_tpu_torch.nn.initializers import kaiming_uniform
from dcnn_tpu_torch.serve import InferenceEngine

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_model_and_params(model, seed=0):
    params, state = model.init(jax.random.PRNGKey(seed), model.input_shape)
    return params, state, jax.tree_util.tree_map(np.asarray, params)


def _narrow_jax(impl="flash", causal=False):
    """mha_classifier's structure at E=32, 2 heads, S=16."""
    def block(name):
        return JaxResidual(layers=[JaxMHA(num_heads=2, impl=impl,
                                          causal=causal, name=f"{name}_mha")],
                           shortcut=[], activation="relu", name=name)
    return (JaxBuilder("narrow").input((16, 32)).add_layer(block("a0"))
            .add_layer(block("a1")).flatten("flatten").dense(10, True, "head")
            .build())


def _both(jm, params, state, pnp, x):
    yj = np.asarray(jm.apply(params, state, jnp.asarray(x), training=False)[0])
    tm = from_jax(jm.get_config(), pnp, device="cpu")
    with torch.no_grad():
        yt = tm(torch.from_numpy(x)).numpy()
    return yj, yt


def test_mha_classifier_matches_jax():
    jm = jax_mha_classifier()
    params, state, pnp = _jax_model_and_params(jm)
    x = np.random.default_rng(0).normal(size=(4, 32, 64)).astype(np.float32)
    yj, yt = _both(jm, params, state, pnp, x)
    assert yt.shape == (4, 10)
    np.testing.assert_allclose(yt, yj, **TOL)


@pytest.mark.parametrize("impl,causal", [("flash", False), ("flash", True),
                                         ("blockwise", False),
                                         ("naive", True)])
def test_narrow_variant_matches_jax(impl, causal):
    jm = _narrow_jax(impl, causal)
    params, state, pnp = _jax_model_and_params(jm, seed=1)
    x = np.random.default_rng(1).normal(size=(3, 16, 32)).astype(np.float32)
    yj, yt = _both(jm, params, state, pnp, x)
    np.testing.assert_allclose(yt, yj, **TOL)


def test_config_round_trip_with_jax():
    """An unbuilt model's config equals the JAX one; a JAX config rebuilds
    in the port and gives the same config back."""
    jm = jax_mha_classifier()
    assert create_mha_classifier().get_config() == jm.get_config()
    jm.init(jax.random.PRNGKey(0), jm.input_shape)
    cfg = jm.get_config()
    assert Sequential.from_config(cfg).get_config() == cfg


def test_from_jax_checks_names_and_shapes():
    jm = _narrow_jax()
    _, _, pnp = _jax_model_and_params(jm)
    bad = list(pnp)
    bad[3] = {"w": pnp[3]["w"][:, :-1], "b": pnp[3]["b"]}
    with pytest.raises(RuntimeError, match="size mismatch"):
        from_jax(jm.get_config(), tuple(bad), device="cpu")
    with pytest.raises(ValueError, match="param entries"):
        from_jax(jm.get_config(), pnp[:3], device="cpu")
    cfg = jm.get_config()
    cfg["layers"][2] = {"type": "no_such_layer", "name": "p"}
    with pytest.raises(ValueError,
                       match="unknown layer type 'no_such_layer'"):
        from_jax(cfg, pnp, device="cpu")


def test_mha_weights_transposed_dense_not():
    """JAX MHA weights are (in, out) for x @ w, the port's (out, in) for
    F.linear; dense weights are (out, in) in both."""
    jm = _narrow_jax()
    _, _, pnp = _jax_model_and_params(jm)
    tm = from_jax(jm.get_config(), pnp, device="cpu")
    mha = tm[0].layers[0]
    np.testing.assert_array_equal(mha.wq.detach().numpy(),
                                  pnp[0]["main"][0]["wq"].T)
    np.testing.assert_array_equal(mha.bo.detach().numpy(),
                                  pnp[0]["main"][0]["bo"])
    np.testing.assert_array_equal(tm[3].w.detach().numpy(), pnp[3]["w"])


def test_flatten_is_row_major():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    out = FlattenLayer()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, x.reshape(2, 12))
    assert FlattenLayer().output_shape((3, 4)) == (12,)


def test_init_from_generator_is_deterministic():
    def build(seed):
        return create_mha_classifier().init(
            generator=torch.Generator().manual_seed(seed), device="cpu")

    a, b, c = build(0), build(0), build(1)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        assert not torch.equal(pa, pc), n
    w = a[3].w
    assert w.shape == (10, 2048) and w.abs().max() <= 2048 ** -0.5
    t = kaiming_uniform((1000,), 16, generator=torch.Generator().manual_seed(0))
    assert t.dtype == torch.float32 and t.abs().max() <= 0.25


def test_builder_shape_inference():
    m = (SequentialBuilder("b").input((8, 16))
         .residual([MultiHeadAttentionLayer(num_heads=4)])
         .flatten().activation("tanh").dense(3).build())
    assert m.output_shape() == (3,)
    assert [l.name for l in m.layers] == ["residual_block_0", "flatten_1",
                                          "activation_2", "dense_3"]
    m.init(device="cpu")
    assert m(torch.zeros(2, 8, 16)).shape == (2, 3)
    with pytest.raises(ValueError, match="not divisible"):
        MultiHeadAttentionLayer(num_heads=3).init((8, 16))


def test_zoo_names():
    assert isinstance(create_model("mha_classifier"), Sequential)
    assert isinstance(create_model("resnet18_tiny_imagenet", "NHWC"),
                      Sequential)
    assert isinstance(create_model("mha_decoder"), MHADecoder)
    with pytest.raises(ValueError, match="unknown model"):
        create_model("no_such_model")


def test_precision_modes():
    """parity turns TF32 off for matmuls and cuDNN; bf16 computes the
    forward in bfloat16 (here on the CPU's plain path)."""
    saved = precision.get_precision_mode()
    try:
        precision.set_precision("fast")
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        precision.set_precision("parity")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError, match="unknown precision"):
            precision.set_precision("int4")
        jm = _narrow_jax()
        _, _, pnp = _jax_model_and_params(jm)
        tm = from_jax(jm.get_config(), pnp, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).normal(
            size=(2, 16, 32)).astype(np.float32))
        with torch.no_grad():
            ref = tm(x)
            precision.set_precision("bf16")
            y = tm(x)
        assert y.dtype == torch.bfloat16
        assert tm[3].w.dtype == torch.float32  # master params stay fp32
        torch.testing.assert_close(y.float(), ref, atol=5e-2, rtol=5e-2)
    finally:
        precision.set_precision(saved)


@pytest.mark.parametrize("entry", ["resolve_device", "init", "from_jax",
                                   "engine"])
def test_cuda_without_gpu_raises(entry):
    """The entry points run on CUDA unless asked for the CPU, and raise
    rather than carry on on the CPU when there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid choice here")
    jm = _narrow_jax()
    _, _, pnp = _jax_model_and_params(jm)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "resolve_device":
            resolve_device(None)
        elif entry == "init":
            create_mha_classifier().init(device=None)
        elif entry == "from_jax":
            from_jax(jm.get_config(), pnp, device="cuda")
        else:
            InferenceEngine.from_model(
                from_jax(jm.get_config(), pnp, device="cpu"), max_batch=2)
