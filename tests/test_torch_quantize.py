"""The port's int8 post-training quantization of a model
(``dcnn_tpu_torch/nn/quantize.py``), held against the JAX package on the
CPU: the model half of the twins of ``tests/test_quantize.py`` (the op
half is ``tests/test_torch_quant_ops.py``), the two packages side by side
on the same inputs and weights.

Tolerances: ``quantize_model`` gives the same layer types, configs and
int8 weights, the same weight scales bit for bit, every activation scale
within ``ACT_ULP`` units in the last place (an activation scale is the
absmax of a float activation each package computes in its own summation
order: 2 ulp measured, at the attention core's output) and every folded
bias within ``BIAS_ULP`` (XLA contracts the fold's ``b·s + shift`` into a
fused multiply-add, PyTorch rounds the product first: 3 ulp measured);
the int8 models' logits agree within ``LOGIT_TOL`` of the logit scale,
with the same top-1; the int8 model tracks the float model with
logit cosine above 0.98 (``tests/test_quantize.py``'s bar).

The weights are drawn by the port (``torch.Generator`` seeds, batchnorm
statistics from numpy seeds) and carried to the JAX package with
``interop.to_jax``: JAX's own eager ``init`` costs seconds a model.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn import MultiHeadAttentionLayer as JaxMHA
from dcnn_tpu.nn import quantize_model as jax_quantize_model
from dcnn_tpu.nn.residual import ResidualBlock as JaxResidual
from dcnn_tpu.ops import conv2d_int8 as jax_conv2d_int8
from dcnn_tpu.ops import quant as jquant
from dcnn_tpu.train import load_checkpoint as jax_load_checkpoint
from dcnn_tpu.train import save_checkpoint as jax_save_checkpoint
from dcnn_tpu_torch.interop import state_to_jax, to_jax
from dcnn_tpu_torch.nn import (
    DenseLayer, FlattenLayer, QuantConv2DLayer, QuantDenseLayer,
    QuantMultiHeadAttentionLayer, Sequential, StatelessLayer, is_int8,
    quantize_model,
)
from dcnn_tpu_torch.ops import quant
from dcnn_tpu_torch.ops.conv import conv2d_int8
from dcnn_tpu_torch.train import load_checkpoint, save_checkpoint

ACT_ULP = 4
BIAS_ULP = 4
LOGIT_TOL = 1e-5   # max |port - JAX| over max |JAX logit|
COSINE_MIN = 0.98


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(jm, seed=0):
    """(JAX model, params, state, port model) with the same weights; the
    batchnorm gamma, beta and running statistics drawn at random, so that
    a fold is not the identity."""
    port = Sequential.from_config(jm.get_config()).init(
        generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in list(port.named_parameters()) + list(
                port.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
            elif leaf in ("beta", "running_mean"):
                t.copy_(torch.from_numpy(rng.normal(0.0, 0.1, t.shape)))
    return jm, to_jax(port), state_to_jax(port), port


def narrow_cnn():
    return (JaxBuilder(name="qcbn", data_format="NHWC").input((8, 8, 3))
            .conv2d(16, 3, padding=1).batchnorm().activation("relu")
            .conv2d(8, 3, padding=1, use_bias=False).batchnorm()
            .activation("relu").maxpool2d(2).flatten().dense(10).build())


def narrow_resnet():
    return (JaxBuilder(name="qres", data_format="NHWC").input((8, 8, 3))
            .conv2d(8, 3, 1, 1).batchnorm().activation("relu")
            .basic_residual_block(8, 8, 1, "block1")
            .basic_residual_block(8, 16, 2, "block2")
            .avgpool2d(4).flatten().dense(10).build())


def narrow_mha():
    def block(name):
        return JaxResidual(layers=[JaxMHA(num_heads=2, name=f"{name}_mha")],
                           shortcut=[], activation="relu", name=name)
    return (JaxBuilder("qmha").input((8, 16)).add_layer(block("attn0"))
            .add_layer(block("attn1")).flatten().dense(10, True, "head")
            .build())


def _calib(shape, seed, n=32):
    return np.random.default_rng(seed).normal(size=(n, *shape)).astype(
        np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def _assert_same_quantization(qp_jax, qm_port):
    leaves_j = jax.tree_util.tree_leaves_with_path(_np_tree(qp_jax))
    leaves_t = jax.tree_util.tree_leaves_with_path(to_jax(qm_port))
    assert [p for p, _ in leaves_j] == [p for p, _ in leaves_t]
    for (path, a), (_, b) in zip(leaves_j, leaves_t):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        else:
            key = getattr(path[-1], "key", "")
            tol = (BIAS_ULP if key[:1] == "b" else
                   ACT_ULP if key in ("x_scale", "o_scale") else 0)
            assert _ulps(a, b) <= tol, (path, a, b)


def _assert_same_config(port_cfg, jax_cfg):
    """Equal configs, but for a geometry field the JAX layer infers at its
    own ``init`` (never run here), such as an attention layer's
    ``embed_dim`` added without a shape: None there, the inferred value in
    the port."""
    if isinstance(jax_cfg, dict):
        assert set(port_cfg) == set(jax_cfg)
        for k in jax_cfg:
            if jax_cfg[k] is not None:
                _assert_same_config(port_cfg[k], jax_cfg[k])
    elif isinstance(jax_cfg, list):
        assert len(port_cfg) == len(jax_cfg)
        for a, b in zip(port_cfg, jax_cfg):
            _assert_same_config(a, b)
    else:
        assert port_cfg == jax_cfg


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


# ---------------------------------------------------------------- transform

def _int32_accumulators_match(jax_qm, qp, port_qm, seed):
    """Each int8 conv/dense layer's int32 accumulator, given the same int8
    input, equals JAX's."""
    rng = np.random.default_rng(seed)
    jl = [(l, p) for l, p in zip(jax_qm.layers, qp)
          if l.type_name in ("quant_conv2d", "quant_dense")]
    tl = [l for l in port_qm.layers
          if isinstance(l, (QuantConv2DLayer, QuantDenseLayer))]
    assert len(jl) == len(tl) > 0
    for (jlayer, p), tlayer in zip(jl, tl):
        w = np.asarray(p["w_q"])
        if jlayer.type_name == "quant_conv2d":
            x = rng.integers(-127, 128, (2, 7, 7, w.shape[1]), dtype=np.int8)
            want = jax_conv2d_int8(jnp.asarray(x), jnp.asarray(w),
                                   stride=jlayer.stride,
                                   padding=jlayer.padding,
                                   data_format="NHWC")
            got = conv2d_int8(torch.from_numpy(x), tlayer.w_q,
                              stride=tlayer.stride, padding=tlayer.padding,
                              data_format="NHWC")
        else:
            x = rng.integers(-127, 128, (3, w.shape[1]), dtype=np.int8)
            want = jquant.dense_int8(jnp.asarray(x), jnp.asarray(w))
            got = quant.dense_int8(torch.from_numpy(x), tlayer.w_q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _check_against_jax(jm, params, state, port, calib, x, **kw):
    jqm, jqp, jqs = jax_quantize_model(jm, params, state, jnp.asarray(calib),
                                       **kw)
    qm = quantize_model(port, calib, **kw)
    _assert_same_config(qm.get_config()["layers"], jqm.get_config()["layers"])
    _assert_same_quantization(jqp, qm)
    want = np.asarray(jax.jit(lambda p, s, v: jqm.apply(
        p, s, v, training=False)[0])(jqp, jqs, jnp.asarray(x)))
    got = _logits(qm, x)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    port.eval()
    assert _cosine(_logits(port, x), got) > COSINE_MIN
    return jqm, jqp, qm


def test_quantize_conv_bn_dense_model_matches_jax():
    jm, params, state, port = _pair(narrow_cnn())
    x = _calib(jm.input_shape, 7, 16)
    jqm, jqp, qm = _check_against_jax(jm, params, state, port,
                                      _calib(jm.input_shape, 3), x)
    assert sum(isinstance(l, (QuantConv2DLayer, QuantDenseLayer))
               for l in qm.layers) == 3
    # the bias-less second conv carries the folded BN shift as its bias
    assert qm.layers[2].b is not None and qm.layers[2].w_q.dtype == torch.int8
    _int32_accumulators_match(jqm, jqp, qm, 1)
    assert is_int8(qm) and not is_int8(port)


def test_quantize_residual_recursion_matches_jax():
    jm, params, state, port = _pair(narrow_resnet(), seed=1)
    _, _, qm = _check_against_jax(jm, params, state, port,
                                  _calib(jm.input_shape, 4),
                                  _calib(jm.input_shape, 7, 8))

    def count(layers):
        return sum(isinstance(l, (QuantConv2DLayer, QuantDenseLayer))
                   + (count(l.layers) + count(l.shortcut)
                      if hasattr(l, "shortcut") else 0) for l in layers)
    assert count(qm.layers) == 7  # stem, 2 + 2 block convs, 1 shortcut, head


def test_quantize_without_fold_matches_jax():
    jm = (JaxBuilder(name="nofold", data_format="NHWC").input((6, 6, 1))
          .conv2d(4, 3, padding=1).activation("relu").flatten().dense(10)
          .build())
    jm, params, state, port = _pair(jm, seed=2)
    _check_against_jax(jm, params, state, port, _calib((6, 6, 1), 5, 16),
                       _calib((6, 6, 1), 7, 16), fold_bn=False)


def test_quantize_act_quantile_plumbs_through():
    jm = (JaxBuilder(name="qq", data_format="NHWC").input((6, 6, 1))
          .conv2d(4, 3, padding=1).activation("relu").flatten().dense(10)
          .build())
    jm, params, state, port = _pair(jm, seed=3)
    calib = _calib((6, 6, 1), 10, 16)
    calib[0, 0, 0, 0] = 1e4  # poison one calibration sample
    q_max = quantize_model(port, calib)
    q_q = quantize_model(port, calib, act_quantile=0.99)
    assert float(q_q.layers[0].x_scale) < float(q_max.layers[0].x_scale) / 10
    _check_against_jax(jm, params, state, port, calib,
                       _calib((6, 6, 1), 7, 16), act_quantile=0.99)


def test_quantize_mha_classifier_matches_jax():
    jm, params, state, port = _pair(narrow_mha(), seed=4)
    _, _, qm = _check_against_jax(jm, params, state, port,
                                  _calib((8, 16), 11, 16),
                                  _calib((8, 16), 7, 16))
    qmha = [l for l in qm.modules()
            if isinstance(l, QuantMultiHeadAttentionLayer)]
    assert len(qmha) == 2
    assert qmha[0].wq_q.dtype == torch.int8 and qmha[0].impl == "flash"
    assert float(qmha[0].x_scale) > 0 and float(qmha[0].o_scale) > 0
    # zero-template init (the checkpoint restoration path) + config round trip
    qm2 = Sequential.from_config(qm.get_config()).init(device="cpu")
    t = [l for l in qm2.modules()
         if isinstance(l, QuantMultiHeadAttentionLayer)][0]
    assert t.wo_q.shape == qmha[0].wo_q.shape and not t.wo_q.any()


def test_quantized_model_refuses_training():
    _, _, _, port = _pair(narrow_cnn(), seed=5)
    calib = np.ones((4, 8, 8, 3), np.float32)
    qm = quantize_model(port, calib)
    assert not qm.training
    qm.train()
    with pytest.raises(ValueError, match="inference-only"):
        qm(torch.from_numpy(calib))
    # init is a deterministic zero template, never random weights
    qm2 = Sequential.from_config(qm.get_config()).init(device="cpu")
    assert qm2.layers[0].w_q.dtype == torch.int8
    assert not qm2.layers[0].w_q.any()
    assert qm2.layers[0].w_q.shape == qm.layers[0].w_q.shape
    assert not any(p.requires_grad for p in qm2.parameters())


def test_quantize_does_not_mutate_original():
    jm = (JaxBuilder(name="orig_q", data_format="NHWC").input((8, 8, 3))
          .conv2d(4, 3, padding=1, use_bias=False).batchnorm()
          .flatten().dense(10).build())
    _, _, _, port = _pair(jm, seed=6)
    port.train()
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    quantize_model(port, np.ones((4, 8, 8, 3), np.float32))
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n
    assert port.layers[0].b is None and port.training


def test_quantize_passes_through_unregistered_custom_layer():
    class DoubleLayer(StatelessLayer):
        type_name = "test_unregistered_double"

        def forward(self, x):
            return x * 2.0

    model = Sequential([FlattenLayer(), DoubleLayer(), DenseLayer(10)],
                       name="custom_q", input_shape=(4, 4, 1))
    model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    qm = quantize_model(model, _calib((4, 4, 1), 11, 16))
    assert isinstance(qm.layers[1], DoubleLayer)
    assert qm.layers[1] is not model.layers[1]
    assert isinstance(qm.layers[2], QuantDenseLayer)
    x = _calib((4, 4, 1), 12, 4)
    assert _cosine(_logits(model.eval(), x), _logits(qm, x)) > 0.99


def test_quantized_config_and_checkpoint_roundtrip(tmp_path):
    jm = (JaxBuilder(name="ckpt", data_format="NHWC").input((8, 8, 3))
          .conv2d(8, 3, padding=1, stride=2).batchnorm()
          .activation("relu").flatten().dense(10).build())
    _, _, _, port = _pair(jm, seed=7)
    qm = quantize_model(port, _calib((8, 8, 3), 6, 8))
    qm2 = Sequential.from_config(qm.get_config())
    assert [l.type_name for l in qm2.layers] == \
        [l.type_name for l in qm.layers]
    assert qm2.layers[0].stride == qm.layers[0].stride
    path = str(tmp_path / "q")
    save_checkpoint(path, qm)
    loaded, _, _, _ = load_checkpoint(path, device="cpu")
    assert loaded.layers[0].w_q.dtype == torch.int8
    for (n, a), (_, b) in zip(qm.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a, b), n
    x = _calib((8, 8, 3), 9, 4)
    np.testing.assert_array_equal(_logits(loaded.eval(), x), _logits(qm, x))


def test_quantized_checkpoint_crosses_packages_both_ways(tmp_path):
    """A quantized model saved by the JAX package loads in the port with
    identical arrays, and the other way round."""
    jm, params, state, port = _pair(narrow_resnet(), seed=8)
    calib = _calib(jm.input_shape, 2, 8)
    jqm, jqp, jqs = jax_quantize_model(jm, params, state, jnp.asarray(calib))
    jax_save_checkpoint(str(tmp_path / "from_jax"), jqm, jqp, jqs)
    loaded, _, _, _ = load_checkpoint(str(tmp_path / "from_jax"),
                                      device="cpu")
    assert is_int8(loaded)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(_np_tree(jqp)),
            jax.tree_util.tree_leaves_with_path(to_jax(loaded))):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    qm = quantize_model(port, calib)
    save_checkpoint(str(tmp_path / "from_port"), qm)
    _, jp2, _, _, _, _ = jax_load_checkpoint(str(tmp_path / "from_port"))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(to_jax(qm)),
            jax.tree_util.tree_leaves_with_path(_np_tree(jp2))):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    assert os.path.exists(str(tmp_path / "from_port" / "model.json"))
