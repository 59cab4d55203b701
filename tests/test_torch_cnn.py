"""The port's CNN path held against the JAX package: the conv, norm and
pool ops, the zoo configs, a narrow residual model (eval, train-mode BN,
folded, served), and the torch-generated golden values of
``tests/fixtures/torch_golden.npz``.

The same numpy inputs and weights go through both packages, on the CPU.
Tolerances (fp32): ops and single layers 1e-5 (the same arithmetic summed
in another order; the pools are exact); whole models 1e-5 of the largest
logit (a few convs deep, each summed in another order by XLA's and
PyTorch's CPU convolutions); the golden values as
``tests/test_layer_values.py`` holds the JAX layers to them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.models.zoo import MODEL_ZOO as JAX_ZOO
from dcnn_tpu.models.zoo import create_model as jax_create_model
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.fold import fold_batchnorm as jax_fold
from dcnn_tpu.ops import conv as jconv
from dcnn_tpu.ops import norm as jnorm
from dcnn_tpu.ops import pool as jpool
from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
from dcnn_tpu_torch.models import create_model
from dcnn_tpu_torch.nn import (
    AvgPool2DLayer, BatchNormLayer, Conv2DLayer, DenseLayer, FlattenLayer,
    MaxPool2DLayer, Sequential, SequentialBuilder, fold_batchnorm,
)
from dcnn_tpu_torch.ops import conv, norm, pool
from dcnn_tpu_torch.serve import InferenceEngine

TOL = dict(atol=1e-5, rtol=1e-5)
LAYOUTS = ("NCHW", "NHWC")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _img(rng, n, c, h, w, df):
    x = rng.normal(size=(n, c, h, w)).astype(np.float32)
    return x if df == "NCHW" else x.transpose(0, 2, 3, 1).copy()


# -- ops ----------------------------------------------------------------

@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("k,stride,pad,bias", [(3, 1, 1, True), (5, 2, 1, False),
                                               (1, 2, 0, True), (3, 2, (0, 2), True)])
def test_conv2d_matches_jax(df, k, stride, pad, bias):
    rng = np.random.default_rng(0)
    x = _img(rng, 2, 3, 9, 11, df)
    w = rng.normal(size=(4, 3, k, k)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32) if bias else None
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                        None if b is None else jnp.asarray(b), stride=stride,
                        padding=pad, data_format=df)
    got = conv.conv2d(_t(x), _t(w), None if b is None else _t(b),
                      stride=stride, padding=pad, data_format=df)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hw = (9, 11)
    assert conv.conv2d_output_shape(hw, (k, k), stride, pad) == \
        jconv.conv2d_output_shape(hw, (k, k), stride, pad)


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(df, training):
    """Both modes, with the running stats they return; the input's mean is
    far from the pivot (running_mean) to exercise the one-pass sums."""
    rng = np.random.default_rng(1)
    x = _img(rng, 4, 5, 6, 7, df) * 3.0 + 2.0
    g, b = rng.uniform(0.5, 1.5, 5), rng.normal(size=5)
    rm, rv = rng.normal(size=5), rng.uniform(0.5, 2.0, 5)
    args = [a.astype(np.float32) for a in (g, b, rm, rv)]
    want = jnorm.batch_norm(jnp.asarray(x), *map(jnp.asarray, args),
                            training=training, momentum=0.1, eps=1e-5,
                            data_format=df)
    got = norm.batch_norm(_t(x), *map(_t, args), training=training,
                          momentum=0.1, eps=1e-5, data_format=df)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_matches_jax(df, affine):
    rng = np.random.default_rng(2)
    x = _img(rng, 2, 6, 4, 5, df)
    g = rng.normal(size=6).astype(np.float32) if affine else None
    b = rng.normal(size=6).astype(np.float32) if affine else None
    want = jnorm.group_norm(jnp.asarray(x), None if g is None else jnp.asarray(g),
                            None if b is None else jnp.asarray(b), 3,
                            data_format=df)
    got = norm.group_norm(_t(x), None if g is None else _t(g),
                          None if b is None else _t(b), 3, data_format=df)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        norm.group_norm(_t(x), None, None, 4, data_format=df)


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("k,stride,pad", [(2, None, 0), (3, 2, 1), (2, 1, 1),
                                          (3, 2, 2), (4, 1, 0)])
def test_pools_match_jax(df, k, stride, pad):
    """Max and average pooling, padding beyond half a window included."""
    rng = np.random.default_rng(3)
    x = _img(rng, 2, 3, 8, 9, df)
    for jfn, tfn, kw in ((jpool.max_pool2d, pool.max_pool2d, {}),
                         (jpool.avg_pool2d, pool.avg_pool2d, {}),
                         (jpool.avg_pool2d, pool.avg_pool2d,
                          {"count_include_pad": False})):
        want = jfn(jnp.asarray(x), k, stride, pad, data_format=df, **kw)
        got = tfn(_t(x), k, stride, pad, data_format=df, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        pool.global_avg_pool2d(_t(x), data_format=df).numpy(),
        np.asarray(jpool.global_avg_pool2d(jnp.asarray(x), data_format=df)),
        **TOL)
    assert pool.pool_output_shape((8, 9), k, stride, pad) == \
        jpool.pool_output_shape((8, 9), k, stride, pad)


# -- zoo configs -----------------------------------------------------------

CNN_NAMES = sorted(n for n in JAX_ZOO if not n.startswith("mha_"))


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("name", CNN_NAMES)
def test_zoo_config_matches_jax(name, df):
    """Every CNN of the JAX zoo, in both layouts: the same config, so the
    same layers, names, widths and flags; the port's config rebuilds
    itself."""
    cfg = create_model(name, df).get_config()
    assert cfg == jax_create_model(name, df).get_config()
    assert Sequential.from_config(cfg).get_config() == cfg


# -- a narrow residual model ------------------------------------------------

def _narrow_jax(df):
    """Every layer type of the CNN zoo at 16×16: a BN stem, maxpool, basic
    blocks (one with a stride-2 projection), bottleneck blocks (eps 1e-3;
    one with a projection), groupnorm, avgpool, dense and log-softmax."""
    shape = (3, 16, 16) if df == "NCHW" else (16, 16, 3)
    return (JaxBuilder("narrow_cnn", df).input(shape)
            .conv2d(8, 3, 1, 1, False, "stem").batchnorm(1e-3, 0.1, True, "stem_bn")
            .activation("relu", "stem_relu").maxpool2d(2, 2, 0, "pool")
            .basic_residual_block(8, 8, 1, "b1")
            .basic_residual_block(8, 16, 2, "b2")
            .bottleneck_residual_block(16, 4, 16, 1, "bt1")
            .bottleneck_residual_block(16, 4, 32, 2, "bt2")
            .groupnorm(4, name="gn")
            .avgpool2d(2, 1, 0, "avg").flatten("flatten")
            .dense(10, True, "fc").log_softmax("out").build())


def _randomize(tree, rng):
    """Random gamma/beta and running stats (var > 0): with the initial
    0/1/1/0 a broken fold or BN would not show."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_randomize(t, rng) for t in tree)
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, tuple, list)):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v)
        if k in ("gamma", "running_var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("beta", "running_mean"):
            v = rng.normal(0, 0.2, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _narrow(df, seed=0):
    jm = _narrow_jax(df)
    params, state = jm.init(jax.random.PRNGKey(seed), jm.input_shape)
    rng = np.random.default_rng(seed)
    pnp = _randomize(jax.tree_util.tree_map(np.asarray, params), rng)
    snp = _randomize(jax.tree_util.tree_map(np.asarray, state), rng)
    x = _img(rng, 5, 3, 16, 16, df)
    return jm, pnp, snp, x


def _jax_apply(jm, pnp, snp, x, training=False):
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    y, new_state = jm.apply(tree(pnp), tree(snp), jnp.asarray(x),
                            training=training)
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, new_state)


def _close_logits(got, want):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("df", LAYOUTS)
def test_narrow_model_eval_matches_jax(df):
    jm, pnp, snp, x = _narrow(df)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").eval()
    assert tm.get_config() == jm.get_config()
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    _close_logits(got, _jax_apply(jm, pnp, snp, x)[0])
    # the carry is exact both ways
    for a, b in zip(jax.tree_util.tree_leaves(to_jax(tm)),
                    jax.tree_util.tree_leaves(pnp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(state_to_jax(tm)),
                    jax.tree_util.tree_leaves(snp)):
        np.testing.assert_array_equal(a, b)
    assert (jax.tree_util.tree_structure(state_to_jax(tm))
            == jax.tree_util.tree_structure(snp))


@pytest.mark.parametrize("df", LAYOUTS)
def test_narrow_model_train_mode_bn_matches_jax(df):
    """Train mode: batch statistics normalize, and every running buffer
    moves as the JAX state does."""
    jm, pnp, snp, x = _narrow(df, seed=1)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").train()
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    want, new_state = _jax_apply(jm, pnp, snp, x, training=True)
    _close_logits(got, want)
    for a, b in zip(jax.tree_util.tree_leaves(state_to_jax(tm)),
                    jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("df", LAYOUTS)
def test_narrow_model_folded_and_served_match_jax(df):
    """fold_batchnorm against the JAX fold, and InferenceEngine (which
    folds) against JAX ``apply``; the original model is left untouched."""
    jm, pnp, snp, x = _narrow(df, seed=2)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    fm = fold_batchnorm(tm)
    jfm, jfp, jfs = jax_fold(jm, pnp, snp)
    assert fm.get_config() == jfm.get_config()
    # every BN of this model follows a conv
    assert not any(isinstance(m, BatchNormLayer) for m in fm.modules())
    with torch.no_grad():
        got = fm(_t(x)).numpy()
    want = np.asarray(jfm.apply(jfp, jfs, jnp.asarray(x), training=False)[0])
    _close_logits(got, want)
    _close_logits(got, _jax_apply(jm, pnp, snp, x)[0])
    for a, b in zip(jax.tree_util.tree_leaves(to_jax(fm)),
                    jax.tree_util.tree_leaves(jfp)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)

    engine = InferenceEngine.from_model(tm, max_batch=4, device="cpu")
    served = engine.infer(_t(x)).numpy()   # 5 rows: buckets 4 + 1
    _close_logits(served, _jax_apply(jm, pnp, snp, x)[0])
    assert engine.infer(_t(x[0])).shape == (10,)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_fold_keeps_bn_after_other_layers_and_adds_bias():
    m = (SequentialBuilder("f", "NHWC").input((6, 6, 2))
         .conv2d(3, 3, 1, 1, False, "c").batchnorm(name="bn_c")
         .maxpool2d(2).batchnorm(name="bn_p").flatten().dense(4, False, "d")
         .batchnorm(name="bn_d").build())
    m.init(generator=torch.Generator().manual_seed(0), device="cpu")
    for bn in (m[1], m[3], m[6]):
        with torch.no_grad():
            bn.running_mean.uniform_(-1, 1)
            bn.running_var.uniform_(0.5, 2)
            bn.gamma.uniform_(0.5, 1.5)
    m.eval()
    f = fold_batchnorm(m)
    assert [l.name for l in f.layers] == ["c", "maxpool2d_2", "bn_p",
                                          "flatten_4", "d"]
    assert f[0].use_bias and f[4].use_bias and f[0].b is not None
    x = torch.randn(3, 6, 6, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(f(x), m(x), atol=1e-5, rtol=1e-5)
    assert m[1].running_mean is not f[2].running_mean  # no shared modules


def test_flatten_is_hwc_under_nhwc():
    """A logical NHWC tensor flattens in H, W, C order, as the JAX layer
    flattens it, also when it arrives channels-last in memory."""
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    strided = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    np.testing.assert_array_equal(FlattenLayer()(strided).numpy(),
                                  x.reshape(2, -1))


# -- golden values ------------------------------------------------------------

_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(_GOLDEN)


def _layer(layer, shape, **weights):
    layer.init(shape, generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for name, a in weights.items():
            getattr(layer, name).copy_(_t(a))
    return layer


def test_golden_conv_dense_pools(golden):
    """Forward values of the fixture, as ``tests/test_layer_values.py``
    replays them through the JAX layers."""
    g = golden
    cases = [
        (_layer(Conv2DLayer(8, 5, stride=2, padding=1, in_channels=3),
                (3, 12, 12), w=g["conv.w"], b=g["conv.b"]), "conv", 1e-4, 1e-5),
        (_layer(DenseLayer(5, in_features=7), (7,), w=g["dense.w"],
                b=g["dense.b"]), "dense", 1e-4, 1e-5),
        (MaxPool2DLayer(3, 2, 0), "maxpool", 1e-5, 1e-6),
        (AvgPool2DLayer(2, 2, 1), "avgpool", 1e-5, 1e-6),
    ]
    for layer, key, rtol, atol in cases:
        with torch.no_grad():
            y = layer(_t(g[f"{key}.x"])).numpy()
        np.testing.assert_allclose(y, g[f"{key}.y"], rtol=rtol, atol=atol,
                                   err_msg=key)


def test_golden_batchnorm_train_step(golden):
    g = golden
    bn = _layer(BatchNormLayer(num_features=6), (6, 5, 5), gamma=g["bn.gamma"],
                beta=g["bn.beta"], running_mean=g["bn.running_mean0"],
                running_var=g["bn.running_var0"]).train()
    with torch.no_grad():
        y = bn(_t(g["bn.x"])).numpy()
    np.testing.assert_allclose(y, g["bn.y"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), g["bn.running_mean1"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), g["bn.running_var1"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("df", LAYOUTS)
def test_dense_batchnorm_matches_jax(df):
    """BN over a flat (N, F) input, train and eval."""
    from dcnn_tpu.nn.layers import BatchNormLayer as JaxBN

    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 5)).astype(np.float32) + 1.0
    jl = JaxBN(5, data_format=df)
    p, s = jl.init(jax.random.PRNGKey(0), (5,))
    tl = _layer(BatchNormLayer(5, data_format=df), (5,))
    for training in (True, False):
        tl.train(training)
        y, s = jl.apply(p, s, jnp.asarray(x), training=training)
        with torch.no_grad():
            got = tl(_t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(y), **TOL)
        np.testing.assert_allclose(tl.running_var.numpy(),
                                   np.asarray(s["running_var"]), **TOL)
