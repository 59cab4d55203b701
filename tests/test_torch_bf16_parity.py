"""The port in bf16 mode held against the JAX package in bf16 mode.

The narrow MHA model of ``tests/test_torch_model.py`` (flash, blockwise and
naive attention, causal and not) and the narrow residual CNN of
``tests/test_torch_cnn.py`` (eval mode, NHWC and NCHW) run under
``set_precision("bf16")`` in both packages from the same weights
(``interop.from_jax``) and the same numpy inputs.

Tolerance: the logits agree to within two bf16 ulps of the logit scale
(max |diff| <= 2^-7 max |logit|). What the test found: they differ by at
most one ulp of that scale, in 40-60% of the MHA logits and about a fifth
of the CNN's. The cause is where the two packages round: in bf16 mode the
JAX dense layer rounds x·W to bf16 and then adds the bias in bf16 (two
roundings), while the port's ``F.linear`` adds the bias before its one
rounding; a single dense layer alone differs so in a quarter of its
outputs (``ROADMAP.md`` Queue 3).
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
    """The cause of the differences above, on one dense layer: the JAX
    package's bf16 output is round(round(x·W) + b), the port's round(x·W +
    b), with x·W accumulated in fp32 from bf16 operands in both."""
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
    np.testing.assert_array_equal(got, (prod + b.float()).bfloat16().float()
                                  .numpy())
    assert (got != want).any()
