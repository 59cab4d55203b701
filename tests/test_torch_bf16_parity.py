"""The port in bf16 mode held against the JAX package in bf16 mode.

The narrow MHA model of ``tests/test_torch_model.py`` (flash, blockwise and
naive attention, causal and not) and the narrow residual CNN of
``tests/test_torch_cnn.py`` (eval mode, NHWC and NCHW) run under
``set_precision("bf16")`` in both packages from the same weights
(``interop.from_jax``) and the same numpy inputs.

Tolerance: the logits agree to within two bf16 ulps of the logit scale
(max |diff| <= 2^-7 max |logit|). The port rounds where the JAX package
rounds: in bf16 mode x·W (and a conv) is rounded to bf16 and the bias added
after, rounded again, in the dense and conv layers and the attention
projections. What remains (measured on the CPU): the flash and blockwise
MHA logits equal the JAX logits bit for bit; the naive causal MHA differs in
40% of them and the CNN in 4% (both layouts), by at most one ulp of the
scale (3.9e-3 at 0.77; 1.6e-2 at 3.3). Before the bias add was split, the
MHA models differed in 43-60% and the CNN in 22%. The rest comes from the
order of sums (the naive path's softmax and P·V, the CNN's convs and
norms) and the last bit of fp32 ``exp``, not from the bias.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core import precision as jax_precision
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu_torch.core import precision
from dcnn_tpu_torch.interop import from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
model_tests = importlib.import_module("test_torch_model")
cnn_tests = importlib.import_module("test_torch_cnn")

ULPS_OF_SCALE = 2 ** -7  # two bf16 ulps (2^-8 each) of the largest logit


def _in_bf16(run_jax, run_torch):
    """Both runs under bf16 mode, as fp32 numpy; each package's mode is
    restored after."""
    saved_j, saved_t = (jax_precision.get_precision_mode(),
                        precision.get_precision_mode())
    jax_precision.set_precision("bf16")
    precision.set_precision("bf16")
    try:
        want = np.asarray(run_jax()).astype(np.float32)
        with torch.no_grad():
            got = run_torch()
        assert got.dtype == torch.bfloat16
        return got.float().numpy(), want
    finally:
        jax_precision.set_precision(saved_j)
        precision.set_precision(saved_t)


def _within_scale(got, want):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ULPS_OF_SCALE * scale, (err, scale)


@pytest.mark.parametrize("impl,causal", [("flash", False), ("flash", True),
                                         ("blockwise", False),
                                         ("blockwise", True),
                                         ("naive", True)])
def test_narrow_mha_bf16_matches_jax_bf16(impl, causal):
    jm = model_tests._narrow_jax(impl, causal)
    params, state, pnp = model_tests._jax_model_and_params(jm, seed=1)
    x = np.random.default_rng(1).normal(size=(3, 16, 32)).astype(np.float32)
    tm = from_jax(jm.get_config(), pnp, device="cpu")
    got, want = _in_bf16(
        lambda: jm.apply(params, state, jnp.asarray(x), training=False)[0],
        lambda: tm(torch.from_numpy(x)))
    assert got.shape == (3, 10)
    _within_scale(got, want)


@pytest.mark.parametrize("df", ["NHWC", "NCHW"])
def test_narrow_cnn_bf16_matches_jax_bf16(df):
    jm, pnp, snp, x = cnn_tests._narrow(df)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").eval()
    got, want = _in_bf16(lambda: cnn_tests._jax_apply(jm, pnp, snp, x)[0],
                         lambda: tm(torch.from_numpy(x)))
    _within_scale(got, want)


def test_dense_bf16_rounds_the_bias_add_apart_in_jax():
    """One dense layer: the JAX package's bf16 output is round(round(x·W) +
    b), with x·W accumulated in fp32 from bf16 operands; the port rounds
    the same two times, and equals it bit for bit."""
    jm = JaxBuilder("dense").input((64,)).dense(32, True, "fc").build()
    params, state = jm.init(jax.random.PRNGKey(0), jm.input_shape)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    x = np.random.default_rng(0).normal(size=(16, 64)).astype(np.float32)
    tm = from_jax(jm.get_config(), pnp, device="cpu")
    got, want = _in_bf16(
        lambda: jm.apply(params, state, jnp.asarray(x), training=False)[0],
        lambda: tm(torch.from_numpy(x)))
    xb = torch.from_numpy(x).bfloat16().float()
    w = torch.from_numpy(np.array(pnp[0]["w"])).bfloat16().float()
    b = torch.from_numpy(np.array(pnp[0]["b"])).bfloat16()
    prod = xb @ w.T  # fp32 sums of bf16 products
    np.testing.assert_array_equal(want, (prod.bfloat16() + b).float().numpy())
    np.testing.assert_array_equal(got, (prod.bfloat16() + b).float().numpy())
    assert (got == want).all()


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _one_ulp_of_jax(got: np.ndarray, want: np.ndarray) -> float:
    """Every output within one bf16 ulp of the JAX output; returns the share
    that differs at all."""
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    return float((got != want).mean())


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_biased_conv_bf16_rounds_the_bias_add_apart(df):
    """A biased 3x3 conv (stride 2, padding 1) in bf16 mode: the port's
    output is exactly round(round(conv) + b) of its own conv, and within one
    bf16 ulp of the JAX op's (its conv sums in another order on the CPU).
    Measured on the CPU: no output differs from JAX's in either layout."""
    from dcnn_tpu.ops import conv as jax_conv
    from dcnn_tpu_torch.ops import conv as conv_ops
    rng = np.random.default_rng(3)
    shape = (4, 16, 12, 12) if df == "NCHW" else (4, 12, 12, 16)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(0, 0.1, size=(24, 16, 3, 3)).astype(np.float32)
    b = rng.normal(0, 0.5, size=(24,)).astype(np.float32)
    kw = dict(stride=2, padding=1, data_format=df)
    tx, tw, tb = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    got, want = _in_bf16(
        lambda: jax_conv.conv2d(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (x, w, b)), **kw),
        lambda: conv_ops.conv2d(tx, tw, tb, **kw))
    prod = conv_ops.conv2d(tx, tw, None, **kw)
    assert prod.dtype == torch.bfloat16
    bias = tb.view(1, -1, 1, 1) if df == "NCHW" else tb
    np.testing.assert_array_equal(got, (prod + bias).float().numpy())
    assert _one_ulp_of_jax(got, want) < 0.05


def test_mha_projection_bf16_rounds_the_bias_add_apart():
    """The q projection of a MultiHeadAttentionLayer in bf16 mode: exactly
    round(round(x·W) + b) of its own product, and within one bf16 ulp of the
    JAX layer's ``_project``. Measured: equal to JAX's in every output."""
    from dcnn_tpu.nn.attention_layer import (
        MultiHeadAttentionLayer as JaxMHA,
    )
    from dcnn_tpu_torch.nn import MultiHeadAttentionLayer
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 16, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(32, 32)).astype(np.float32)  # (in, out)
    b = rng.normal(0, 0.5, size=(32,)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a).bfloat16()
                  for a in (x, np.ascontiguousarray(w.T), b))
    got, want = _in_bf16(
        lambda: JaxMHA(4)._project(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (x, w, b))),
        lambda: MultiHeadAttentionLayer._project(tx, tw, tb))
    prod = tx.float() @ tw.float().T  # fp32 sums of bf16 products
    np.testing.assert_array_equal(
        got, (prod.bfloat16() + tb).float().numpy())
    assert _one_ulp_of_jax(got, want) < 0.05
