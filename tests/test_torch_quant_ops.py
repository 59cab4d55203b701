"""The port's int8 ops (``dcnn_tpu_torch/ops/quant.py``,
``ops/conv.py::conv2d_int8``, ``ops/elementwise.py``) against the JAX
package's on the CPU, on the same inputs made from numpy seeds: the op
half of the twins of ``tests/test_quantize.py`` (the model half is
``tests/test_torch_quantize.py``).

``quantize_symmetric``, ``channel_scales``, ``quantize_weight`` and
``tensor_scale`` (absmax, and the port's own quantile, which has no 2^24
limit) are bit-equal to JAX; ``conv2d_int8`` and ``dense_int8`` are exact
integer sums, equal to JAX's at every conv geometry of the zoo, in both
layouts, with C_in = 3 among them; the elementwise op set agrees with
JAX's to fp32 rounding (rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.ops import conv2d_int8 as jax_conv2d_int8
from dcnn_tpu.ops import elementwise as jew
from dcnn_tpu.ops import quant as jquant
from dcnn_tpu_torch.ops import elementwise as ew
from dcnn_tpu_torch.ops import quant
from dcnn_tpu_torch.ops.conv import conv2d_int8


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max(initial=0))


def test_quantize_symmetric_and_scales_bit_equal_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 32)) * 3.0).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties round half to even
    s = quant.tensor_scale(torch.from_numpy(x))
    js = jquant.tensor_scale(jnp.asarray(x))
    assert s.dtype == torch.float32 and s.shape == ()
    assert _ulps(s.numpy(), js) == 0
    x_q = quant.quantize_symmetric(torch.from_numpy(x), s)
    assert x_q.dtype == torch.int8
    np.testing.assert_array_equal(
        x_q.numpy(), np.asarray(jquant.quantize_symmetric(jnp.asarray(x), js)))
    np.testing.assert_array_equal(
        quant.quantize_symmetric(torch.tensor([0.5, 1.5, -2.5, 300.0]),
                                 torch.tensor(1.0)).numpy(), [0, 2, -2, 127])
    # |x - s q| <= s/2 everywhere in range
    err = np.abs(x - s.numpy() * x_q.numpy().astype(np.float32))
    assert err.max() <= float(s) / 2 + 1e-7
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    jw_q, jw_s = jquant.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    assert _ulps(w_s.numpy(), jw_s) == 0


@pytest.mark.parametrize("n,q", [(4096, 0.999), (1000, 0.5), (7, 0.9999),
                                 (2 ** 24 + 3, 0.9999)],
                         ids=["4096", "1000", "7", "above_2^24"])
def test_tensor_scale_quantile_equals_jnp_quantile(n, q):
    """The port's own quantile (torch.quantile refuses more than 2^24
    elements) equals jnp.quantile's linear interpolation bit for bit. Above
    2^24 elements, where n - 1 is no longer exact in fp32, the input is an
    evenly spaced ramp: both sides sort it, and sorting a random one costs
    ten seconds here."""
    x = (np.random.default_rng(n).normal(size=n).astype(np.float32)
         if n <= 2 ** 24 else np.linspace(0.0, 5.0, n, dtype=np.float32))
    got = quant.tensor_scale(torch.from_numpy(x), quantile=q)
    want = jquant.tensor_scale(jnp.asarray(x), quantile=q)
    assert _ulps(got.numpy(), want) == 0, (float(got), float(want))


def test_tensor_scale_quantile_rejects_outlier():
    rng = np.random.default_rng(8)
    bulk = rng.normal(size=4095).astype(np.float32)
    x = torch.from_numpy(np.concatenate([bulk, [1000.0]]).astype(np.float32))
    s_max = quant.tensor_scale(x)
    s_q = quant.tensor_scale(x, quantile=0.999)
    assert float(s_q) < float(s_max) / 50
    errs = {}
    for name, s in (("max", s_max), ("q", s_q)):
        xq = quant.quantize_symmetric(torch.from_numpy(bulk), s)
        errs[name] = np.abs(bulk - s.numpy() * xq.numpy()).mean()
    assert errs["q"] < errs["max"] / 20, errs


def test_channel_scales_zero_channel_guard():
    w = torch.zeros(4, 3, 3, 3)
    assert torch.all(quant.channel_scales(w) > 0)
    w_q, _ = quant.quantize_weight(w)
    assert not w_q.any()


# every conv geometry of the zoo's CNNs: (kernel, stride, padding)
GEOMETRIES = [(1, 1, 0), (1, 2, 0), (3, 1, 0), (3, 1, 1), (3, 2, 1),
              (5, 1, 0), (7, 2, 3)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", GEOMETRIES,
                         ids=[f"k{k}s{s}p{p}" for k, s, p in GEOMETRIES])
@pytest.mark.parametrize("cin", [3, 16])
def test_conv2d_int8_equals_jax(k, stride, pad, layout, cin):
    rng = np.random.default_rng(k * 100 + stride * 10 + pad + cin)
    x = rng.integers(-127, 128, (2, cin, 11, 9), dtype=np.int8)
    w = rng.integers(-127, 128, (5, cin, k, k), dtype=np.int8)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    got = conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                      stride=stride, padding=pad, data_format=layout)
    want = jax_conv2d_int8(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           padding=pad, data_format=layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv2d_int8_largest_site_is_exact():
    """K = 3*3*512: sums up to 4608 * 127^2, past fp32's 2^24; the plain
    version sums in float64 and stays exact."""
    x = np.full((1, 512, 3, 3), 127, np.int8)
    w = np.full((2, 512, 3, 3), -127, np.int8)
    got = conv2d_int8(torch.from_numpy(x), torch.from_numpy(w), padding=0)
    assert int(got[0, 0, 0, 0]) == -4608 * 127 * 127


def test_conv2d_int8_rejects_float():
    with pytest.raises(TypeError, match="int8 operands"):
        conv2d_int8(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3,
                                                         dtype=torch.int8))


@pytest.mark.parametrize("m,k,n", [(8, 16, 5), (1, 27, 3), (33, 64, 64)])
def test_dense_int8_equals_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    got = quant.dense_int8(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jquant.dense_int8(jnp.asarray(x),
                                                  jnp.asarray(w))))
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ w.astype(np.int64).T)
    with pytest.raises(TypeError):
        quant.dense_int8(torch.from_numpy(x).float(), torch.from_numpy(w))


def test_elementwise_suite_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32) + 3.0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, args in (("add", 2), ("sub", 2), ("mul", 2), ("div", 2),
                       ("min", 2), ("max", 2), ("equal", 2), ("greater", 2),
                       ("sqrt", -1), ("rsqrt", -1), ("rcp", 1), ("abs", 1),
                       ("copy", 1), ("zero", 1), ("transpose_2d", 1),
                       ("sum", 1), ("norm_squared", 1), ("dot_product", 2),
                       ("sum_squared_diff", 2)):
        targs = (ta, tb)[:args] if args > 0 else (tb,)
        jargs = (ja, jb)[:args] if args > 0 else (jb,)
        np.testing.assert_allclose(getattr(ew, name)(*targs).numpy(),
                                   np.asarray(getattr(jew, name)(*jargs)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name, extra in (("fmadd", (ta,)), ("fmsub", (ta,)), ("fnmadd", (ta,))):
        np.testing.assert_allclose(
            getattr(ew, name)(ta, tb, *extra).numpy(),
            np.asarray(getattr(jew, name)(ja, jb, ja)), rtol=1e-5,
            err_msg=name)
    np.testing.assert_allclose(ew.axpy(2.5, ta, tb).numpy(),
                               np.asarray(jew.axpy(2.5, ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(ew.clamp(ta, -0.5, 0.5).numpy(),
                               np.asarray(jew.clamp(ja, -0.5, 0.5)))
    np.testing.assert_allclose(ew.mul_add_scalar(ta, 2.0, 1.0).numpy(),
                               np.asarray(jew.mul_add_scalar(ja, 2.0, 1.0)))
    np.testing.assert_allclose(ew.sub_mul_scalar(ta, 2.0, 3.0).numpy(),
                               np.asarray(jew.sub_mul_scalar(ja, 2.0, 3.0)))
    assert torch.equal(ew.set_scalar(ta, 7.0), torch.full((4, 5), 7.0))
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    tx = torch.from_numpy(x)
    for name in ("nchw_to_cnhw", "nchw_to_nhwc"):
        np.testing.assert_array_equal(getattr(ew, name)(tx).numpy(),
                                      np.asarray(getattr(jew, name)(x)))
    assert torch.equal(ew.cnhw_to_nchw(ew.nchw_to_cnhw(tx)), tx)
    assert torch.equal(ew.nhwc_to_nchw(ew.nchw_to_nhwc(tx)), tx)
    g = torch.Generator().manual_seed(0)
    u = ew.fill_random_uniform(g, (1000,), -2.0, 3.0)
    assert u.min() >= -2.0 and u.max() < 3.0
    n = ew.fill_random_normal(g, (4000,), mean=1.0, std=2.0)
    assert abs(float(n.mean()) - 1.0) < 0.2 and abs(float(n.std()) - 2.0) < 0.2
