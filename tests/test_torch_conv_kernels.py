"""The plain versions of the port's conv and scale/bias/ReLU kernels held
against the Pallas kernels of ``dcnn_tpu/ops/pallas`` in interpret mode, at
the shapes of ``tests/test_pallas_kernels.py`` and a few more.

The same numpy inputs go through both. Tolerances: fp32 outputs 2e-5
(the same 9 or 12 products summed in another order, as the JAX tests hold
the Pallas kernels to XLA); bf16 outputs 1e-2 relative (the fp32 sum is
rounded once to bf16's 8-bit mantissa, and a sum at a rounding boundary may
land one ulp apart). The scale/bias/ReLU epilogue 1e-6 in fp32: XLA may
contract the product and the sum into one FMA, PyTorch rounds each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.ops.pallas import conv as jconv
from dcnn_tpu.ops.pallas import fused_scale_bias_relu as jax_fused
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.pallas import (
    conv3x3_s1, conv3x3_s1_bnrelu_in, conv3x3_s1_pairs, fuse_pair_weights,
    fused_scale_bias_relu,
)
from dcnn_tpu_torch.ops.pallas.conv import bnrelu_reference, conv3x3_reference

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, n, h, w, cin, cout, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    sc = rng.normal(size=(cin,)).astype(np.float32)
    sh = rng.normal(size=(cin,)).astype(np.float32)
    return x, wt, sc, sh


def _both(arrs, dtype):
    """(jax arrays, torch CPU tensors) of ``dtype`` from numpy."""
    return ([jnp.asarray(a, JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs])


def _close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def _no_launch(fn):
    """Run ``fn`` and check that the CPU path launched no kernel."""
    before = [k.launches for k in _kernels.COUNTED]
    out = fn()
    assert [k.launches for k in _kernels.COUNTED] == before
    return out


@pytest.mark.parametrize("n,h,w,cin,cout,bt,dtype", [
    (4, 8, 8, 8, 16, 1, "float32"), (4, 6, 10, 4, 8, 2, "float32"),
    (2, 5, 5, 3, 4, 1, "float32"), (2, 7, 9, 8, 8, 1, "bfloat16"),
    (2, 5, 5, 3, 4, 1, "bfloat16"),
])
def test_conv3x3_plain_matches_pallas(n, h, w, cin, cout, bt, dtype):
    x, wt, _, _ = _inputs(0, n, h, w, cin, cout)
    (jx, jw), (tx, tw) = _both((x, wt), dtype)
    want = jconv.conv3x3_s1(jx, jw, batch_tile=bt)
    got = _no_launch(lambda: conv3x3_s1(tx, tw, batch_tile=bt))
    assert got.dtype == TORCH[dtype] and got.shape == (n, h, w, cout)
    _close(got, want, dtype)


def test_conv3x3_out_dtype():
    x, wt, _, _ = _inputs(1, 2, 6, 6, 4, 8)
    (jx, jw), (tx, tw) = _both((x, wt), "bfloat16")
    want = jconv.conv3x3_s1(jx, jw, out_dtype=jnp.float32)
    got = conv3x3_s1(tx, tw, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # bf16 products are exact in fp32, so only the summation order differs
    _close(got, want, "float32")


@pytest.mark.parametrize("n,h,w,cin,cout,dtype", [
    (3, 7, 9, 8, 8, "float32"), (3, 7, 9, 8, 8, "bfloat16"),
    (2, 5, 5, 3, 4, "bfloat16"),
])
def test_conv3x3_bnrelu_plain_matches_pallas(n, h, w, cin, cout, dtype):
    x, wt, sc, sh = _inputs(2, n, h, w, cin, cout)
    (jx, jw), (tx, tw) = _both((x, wt), dtype)
    # scale and shift stay fp32, as the Pallas kernel reads them
    want = jconv.conv3x3_s1_bnrelu_in(jx, jw, jnp.asarray(sc), jnp.asarray(sh))
    got = _no_launch(lambda: conv3x3_s1_bnrelu_in(
        tx, tw, torch.from_numpy(sc), torch.from_numpy(sh)))
    assert got.dtype == TORCH[dtype]
    _close(got, want, dtype)


def test_bnrelu_rounds_before_products_and_pads_with_zero():
    """Under bf16 the activated input is rounded to bf16 before the
    products, and the halo is 0, not relu(shift): with x = 0 and shift > 0
    every real cell is relu(shift) and a corner output sees 4 of 9 taps."""
    n, h, w, cin, cout = 1, 4, 4, 2, 3
    x = torch.zeros((n, h, w, cin), dtype=torch.bfloat16)
    wt = torch.ones((3, 3, cin, cout), dtype=torch.bfloat16)
    sc = torch.ones(cin)
    sh = torch.tensor([0.3, 1.7])
    got = conv3x3_s1_bnrelu_in(x, wt, sc, sh, out_dtype=torch.float32)
    cell = float(sh.to(torch.bfloat16).float().sum())  # rounded, summed over cin
    assert cell != float(sh.sum())                      # the rounding shows
    assert got[0, 0, 0, 0].item() == pytest.approx(4 * cell, rel=1e-6)
    assert got[0, 1, 1, 0].item() == pytest.approx(9 * cell, rel=1e-6)
    # and it equals the conv of the rounded prologue, padded after it
    act = bnrelu_reference(x, sc, sh)
    assert act.dtype == torch.bfloat16
    torch.testing.assert_close(got, conv3x3_reference(act, wt,
                                                      out_dtype=torch.float32))
    jx = jnp.zeros((n, h, w, cin), jnp.bfloat16)
    want = jconv.conv3x3_s1_bnrelu_in(
        jx, jnp.ones((3, 3, cin, cout), jnp.bfloat16), jnp.ones(cin),
        jnp.asarray(sh.numpy()), out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("n,h,w,cin,cout,bt,th,dtype", [
    (2, 8, 8, 8, 16, 1, 4, "float32"), (4, 8, 10, 4, 8, 2, 8, "float32"),
    (2, 6, 6, 8, 8, 1, 2, "float32"), (2, 8, 10, 8, 16, 1, None, "bfloat16"),
])
def test_conv3x3_pairs_plain_matches_pallas(n, h, w, cin, cout, bt, th, dtype):
    x, wt, _, _ = _inputs(3, n, h, w, cin, cout)
    (jx, jw), (tx, tw) = _both((x, wt), dtype)
    want = jconv.conv3x3_s1_pairs(jx, jw, batch_tile=bt, h_tile=th)
    got = _no_launch(lambda: conv3x3_s1_pairs(tx, tw, batch_tile=bt,
                                              h_tile=th))
    assert got.shape == (n, h, w, cout)
    _close(got, want, dtype)
    # the pairs formulation is the same conv
    _close(got, conv3x3_reference(tx, tw), dtype)


def test_fuse_pair_weights_matches_jax():
    w1 = np.random.default_rng(4).normal(size=(3, 3, 5, 6)).astype(np.float32)
    got = fuse_pair_weights(torch.from_numpy(w1))
    assert got.shape == (3, 4, 5, 12)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jconv.fuse_pair_weights(w1)))


@pytest.mark.parametrize("call", [
    lambda x: conv3x3_s1(x, torch.zeros(5, 5, 8, 8)),               # not 3x3
    lambda x: conv3x3_s1(x, torch.zeros(3, 3, 4, 8)),               # cin
    lambda x: conv3x3_s1(x, torch.zeros(3, 3, 8, 8), batch_tile=3),  # 4 % 3
    lambda x: conv3x3_s1_bnrelu_in(x, torch.zeros(5, 5, 8, 4),
                                   torch.zeros(8), torch.zeros(8)),
    lambda x: conv3x3_s1_bnrelu_in(x, torch.zeros(3, 3, 2, 4),
                                   torch.zeros(8), torch.zeros(8)),
    lambda x: conv3x3_s1_pairs(x[:, :, :7], torch.zeros(3, 3, 8, 8)),  # odd W
    lambda x: conv3x3_s1_pairs(x, torch.zeros(3, 3, 8, 8), h_tile=3),
    lambda x: conv3x3_s1_pairs(x, torch.zeros(3, 3, 8, 8), batch_tile=3),
])
def test_conv3x3_shape_validation(call):
    """The JAX functions' ValueErrors, on the same bad shapes."""
    with pytest.raises(ValueError):
        call(torch.zeros(4, 8, 8, 8))


def test_h_tile_message_matches_jax():
    with pytest.raises(ValueError, match="h_tile 3 must divide H 8"):
        conv3x3_s1_pairs(torch.zeros(1, 8, 8, 2), torch.zeros(3, 3, 2, 2),
                         h_tile=3)
    with pytest.raises(ValueError, match="h_tile 3 must divide H 8"):
        jconv.conv3x3_s1_pairs(jnp.zeros((1, 8, 8, 2)),
                               jnp.zeros((3, 3, 2, 2)), h_tile=3)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 8, 8, 16), "float32"), ((3, 700), "float32"),
    ((2, 5, 5, 3), "float32"), ((4, 8, 8, 16), "bfloat16"),
])
def test_fused_scale_bias_relu_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    sc = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    (jx, js, jb), (tx, ts, tb) = _both((x, sc, b), dtype)
    want = jax_fused(jx, js, jb)
    got = _no_launch(lambda: fused_scale_bias_relu(tx, ts, tb))
    assert got.dtype == TORCH[dtype] and got.shape == shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        _close(got, want, dtype)


def test_fused_scale_bias_relu_rejects_bad_channels():
    with pytest.raises(ValueError, match="must be"):
        fused_scale_bias_relu(torch.zeros(2, 4), torch.zeros(3),
                              torch.zeros(4))
