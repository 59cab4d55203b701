"""Training the CNN zoo: the port held against the JAX package on the CPU.

- The BN training gate: one ``make_train_step`` of the narrow residual CNN
  of ``tests/test_torch_cnn.py`` (stem conv + BN, basic and bottleneck
  blocks, groupnorm, pools, dense) in NCHW and NHWC, from the same weights,
  running statistics and batch in both packages: logits, loss, every
  gradient, the BN running statistics after the step, and the params
  after one SGD (momentum) and one AdamW update.
- The golden gradients of ``tests/fixtures/torch_golden.npz`` (conv, BN,
  pools, dense) through autograd, and the explicit conv gradient functions
  against the fixture and the JAX ones.
- Dropout: the JAX layer's output under its own keep mask, identity in
  eval mode and at rate 0, the keep fraction and scale, and ``Trainer.fit``
  drawing the same masks from one seed.

Tolerances (fp32): logits and loss 1e-5 of the largest logit; gradients
1e-5 absolute plus 1e-4 relative (convs and norms summed in another order
by XLA's and PyTorch's CPU kernels; a bias before a BN has a gradient that
is zero in exact arithmetic, so only its absolute bound matters); running
statistics 1e-5 relative; SGD params 1e-6 absolute plus 1e-5 relative.
AdamW's first step moves a param by lr·g/(|g| + eps) (eps 1e-8), about lr
whatever the size of g, so it turns rounding noise in a near-zero gradient
into a full-size step: params are held to 1e-6 absolute plus 1e-5 relative
where |g| >= ADAM_FLOOR (1e-4; there the step's sensitivity to g, lr·eps/
|g|², is below 1e-2, so a gradient within its tolerance moves the param by
under 1e-7), and to Adam's step bound (2 lr) below it. The golden values as
``tests/test_layer_values.py`` holds the JAX layers to them.
"""

import functools
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn.layers import DropoutLayer as JaxDropout
from dcnn_tpu.ops import conv as jconv
from dcnn_tpu.ops.losses import get_loss as jax_get_loss
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.optim import AdamW as JaxAdamW
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import ArrayDataLoader
from dcnn_tpu_torch.interop import (
    from_jax, grads_to_jax, state_to_jax, to_jax,
)
from dcnn_tpu_torch.nn import (
    AvgPool2DLayer, BatchNormLayer, Conv2DLayer, DenseLayer, DropoutLayer,
    MaxPool2DLayer, SequentialBuilder,
)
from dcnn_tpu_torch.nn.layers import apply_dropout_mask
from dcnn_tpu_torch.ops import conv
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, AdamW
from dcnn_tpu_torch.train import (
    Trainer, batch_generator, create_train_state, make_train_step,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
cnn_tests = importlib.import_module("test_torch_cnn")

LOSS = "softmax_crossentropy"
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
ADAM_FLOOR = 1e-4
LR = 1e-2
OPTIMIZERS = {"sgd": (lambda: JaxSGD(LR, momentum=0.9),
                      lambda: SGD(LR, momentum=0.9)),
              "adamw": (lambda: JaxAdamW(LR, weight_decay=0.01),
                        lambda: AdamW(LR, weight_decay=0.01))}


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _trees_close(got, want, **tol):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


@functools.lru_cache(maxsize=None)
def _jax_step(df):
    """The JAX side of the gate for one layout, once: the narrow model, its
    weights, running statistics and batch; every gradient of the training
    loss; and per optimizer the (loss, logits, state, params) of one
    step."""
    jm, pnp, snp, x = cnn_tests._narrow(df)
    y = np.eye(10, dtype=np.float32)[np.random.default_rng(5).integers(
        0, 10, len(x))]
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jloss = jax_get_loss(LOSS)

    def forward_loss(params):
        logits, _ = jm.apply(params, tree(snp), jnp.asarray(x), training=True)
        return jloss(logits, jnp.asarray(y))

    grads = host(jax.jit(jax.grad(forward_loss))(tree(pnp)))
    steps = {}
    for name, (make_jopt, _) in OPTIMIZERS.items():
        jopt = make_jopt()
        ts_j = jax_trainer.TrainState(params=tree(pnp), state=tree(snp),
                                      opt_state=jopt.init(tree(pnp)),
                                      step=jnp.zeros((), jnp.int32))
        jstep = jax_trainer.make_train_step(jm, jloss, jopt, donate=False)
        ts_j, loss, logits = jstep(ts_j, jnp.asarray(x), jnp.asarray(y),
                                   jax.random.PRNGKey(0), LR)
        steps[name] = (float(loss), np.asarray(logits), host(ts_j.state),
                       host(ts_j.params))
    return jm, pnp, snp, x, y, grads, steps


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("df", cnn_tests.LAYOUTS)
def test_bn_train_step_matches_jax(df, opt_name):
    """The BN training gate (module docstring)."""
    jm, pnp, snp, x, y, want_grads, steps = _jax_step(df)
    want_loss, want_logits, want_state, want_p = steps[opt_name]
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu")
    opt = OPTIMIZERS[opt_name][1]()
    ts = create_train_state(tm, opt)
    loss, logits = make_train_step(tm, get_loss(LOSS), opt)(
        ts, torch.from_numpy(x), torch.from_numpy(y), LR)
    scale = float(np.abs(want_logits).max())
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(loss.item(), want_loss, atol=1e-5 * scale,
                               rtol=0)
    _trees_close(grads_to_jax(tm), want_grads, **GRAD_TOL)
    _trees_close(state_to_jax(tm), want_state, atol=1e-7, rtol=1e-5)
    got_p = to_jax(tm)
    if opt_name == "sgd":
        _trees_close(got_p, want_p, atol=1e-6, rtol=1e-5)
        return
    for a, b, g in zip(_leaves(got_p), _leaves(want_p), _leaves(want_grads)):
        real = np.abs(g) >= ADAM_FLOOR
        np.testing.assert_allclose(a[real], b[real], atol=1e-6, rtol=1e-5)
        assert np.all(np.abs(a - b)[~real] <= 2 * LR)


@pytest.mark.parametrize("df", cnn_tests.LAYOUTS)
def test_bn_running_stats_update_in_train_and_freeze_in_eval(df):
    """A train step moves every BN layer's running statistics as the JAX
    step does (above); an eval forward leaves them as they were."""
    jm, pnp, snp, x = cnn_tests._narrow(df)
    tm = from_jax(jm.get_config(), pnp, snp, device="cpu").eval()
    before = [a.copy() for a in _leaves(state_to_jax(tm))]
    with torch.no_grad():
        tm(torch.from_numpy(x))
    for a, b in zip(_leaves(state_to_jax(tm)), before):
        np.testing.assert_array_equal(a, b)
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert all((a != b).any() for a, b in
               zip(_leaves(state_to_jax(tm)), before))


# -- golden gradients ----------------------------------------------------


def _vjp(layer, shape, x, dy, **weights):
    """Forward ``x`` through ``layer`` (weights copied in) and back-propagate
    ``dy``: (y, dx, {name: grad})."""
    layer = cnn_tests._layer(layer, shape, **weights)
    xt = cnn_tests._t(x).requires_grad_()
    y = layer(xt)
    y.backward(cnn_tests._t(dy))
    return (y.detach().numpy(), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.fixture(scope="module")
def golden():
    return np.load(cnn_tests._GOLDEN)


def test_golden_conv_and_dense_gradients(golden):
    g = golden
    _, dx, dp = _vjp(Conv2DLayer(8, 5, stride=2, padding=1, in_channels=3),
                     (3, 12, 12), g["conv.x"], g["conv.dy"], w=g["conv.w"],
                     b=g["conv.b"])
    np.testing.assert_allclose(dx, g["conv.dx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dp["w"], g["conv.dw"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dp["b"], g["conv.db"], rtol=1e-4, atol=1e-4)
    _, dx, dp = _vjp(DenseLayer(5, in_features=7), (7,), g["dense.x"],
                     g["dense.dy"], w=g["dense.w"], b=g["dense.b"])
    np.testing.assert_allclose(dx, g["dense.dx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dp["w"], g["dense.dw"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dp["b"], g["dense.db"], rtol=1e-4, atol=1e-5)


def test_golden_batchnorm_and_pool_gradients(golden):
    g = golden
    _, dx, dp = _vjp(BatchNormLayer(num_features=6).train(), (6, 5, 5),
                     g["bn.x"], g["bn.dy"], gamma=g["bn.gamma"],
                     beta=g["bn.beta"], running_mean=g["bn.running_mean0"],
                     running_var=g["bn.running_var0"])
    np.testing.assert_allclose(dx, g["bn.dx"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dp["gamma"], g["bn.dgamma"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(dp["beta"], g["bn.dbeta"], rtol=1e-3,
                               atol=1e-4)
    for layer, key in ((MaxPool2DLayer(3, 2, 0), "maxpool"),
                       (AvgPool2DLayer(2, 2, 1), "avgpool")):
        _, dx, _ = _vjp(layer, g[f"{key}.x"].shape[1:], g[f"{key}.x"],
                        g[f"{key}.dy"])
        np.testing.assert_allclose(dx, g[f"{key}.dx"], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_golden_conv_gradient_functions(golden):
    """The three explicit gradient functions on the fixture's conv."""
    g = golden
    kw = dict(stride=2, padding=1)
    dy = cnn_tests._t(g["conv.dy"])
    dw = conv.conv2d_weight_grad(cnn_tests._t(g["conv.x"]), dy, (5, 5), **kw)
    dx = conv.conv2d_input_grad(cnn_tests._t(g["conv.w"]), dy,
                                g["conv.x"].shape, **kw)
    db = conv.conv2d_bias_grad(dy)
    np.testing.assert_allclose(dx.numpy(), g["conv.dx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), g["conv.dw"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), g["conv.db"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("df", cnn_tests.LAYOUTS)
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (5, 2, 1), (1, 2, 0),
                                          (3, 2, (0, 2))])
def test_conv_gradient_functions_match_jax(df, k, stride, pad):
    rng = np.random.default_rng(7)
    x = cnn_tests._img(rng, 2, 3, 9, 11, df)
    w = rng.normal(size=(4, 3, k, k)).astype(np.float32)
    kw = dict(stride=stride, padding=pad, data_format=df)
    y_shape = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                      **kw)).shape
    dy = rng.normal(size=y_shape).astype(np.float32)
    want = (jconv.conv2d_weight_grad(jnp.asarray(x), jnp.asarray(dy), (k, k),
                                     **kw),
            jconv.conv2d_input_grad(jnp.asarray(w), jnp.asarray(dy), x.shape,
                                    **kw),
            jconv.conv2d_bias_grad(jnp.asarray(dy), data_format=df))
    got = (conv.conv2d_weight_grad(cnn_tests._t(x), cnn_tests._t(dy), (k, k),
                                   **kw),
           conv.conv2d_input_grad(cnn_tests._t(w), cnn_tests._t(dy), x.shape,
                                  **kw),
           conv.conv2d_bias_grad(cnn_tests._t(dy), data_format=df))
    for name, a, b in zip(("dw", "dx", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# -- dropout -------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_jax_under_its_mask(rate):
    """The JAX layer's training output equals the port's under the same
    keep mask (JAX's ``bernoulli`` draw, handed over), bit for bit."""
    x = np.random.default_rng(8).normal(size=(4, 3, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxDropout(rate).forward(jnp.asarray(x), training=True,
                                               rng=key))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    got = apply_dropout_mask(torch.from_numpy(x), torch.from_numpy(keep), rate)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_identity_in_eval_and_at_rate_zero():
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    assert DropoutLayer(0.5).eval()(x, generator=gen) is x
    assert DropoutLayer(0.0).train()(x, generator=gen) is x
    with pytest.raises(ValueError, match="needs a generator"):
        DropoutLayer(0.5).train()(x)


def test_dropout_keep_fraction_and_scale():
    """Rate 0.3 over 200k ones: the kept share is 0.7 within 0.005 (about
    five standard deviations), every kept value is exactly 1/0.7, the rest
    0, and one generator state gives one mask."""
    x = torch.ones(200_000)
    layer = DropoutLayer(0.3).train()
    y = layer(x, generator=torch.Generator().manual_seed(2))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    again = layer(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(y, again)


def test_dropout_builder_config_and_interop():
    """``.dropout(rate)`` builds the layer; its config is the JAX one's;
    from_jax/to_jax carry a model holding it (it has no params)."""
    jm = (JaxBuilder("d").input((12,)).dense(8, True, "fc").dropout(0.25)
          .dense(3, True, "out").build())
    tm = (SequentialBuilder("d").input((12,)).dense(8, True, "fc")
          .dropout(0.25).dense(3, True, "out").build())
    assert tm.get_config() == jm.get_config()
    params, state = jm.init(jax.random.PRNGKey(0), jm.input_shape)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    tm = from_jax(jm.get_config(), pnp, device="cpu").eval()
    _trees_close(to_jax(tm), pnp, atol=0, rtol=0)
    x = np.random.default_rng(9).normal(size=(4, 12)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(params, state, jnp.asarray(x),
                               training=False)[0])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def _fit_with_dropout(seed):
    torch.manual_seed(123)  # the same weights in every run
    model = (SequentialBuilder("d").input((16,)).dense(32, True, "fc")
             .activation("relu").dropout(0.5).dense(4, True, "out").build())
    model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(10)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    cfg = TrainingConfig(epochs=2, batch_size=16, device_type="cpu",
                         learning_rate=1e-2, progress_interval=0)
    opt = SGD(1e-2)
    trainer = Trainer(model, opt, LOSS, cfg)
    ts = create_train_state(model, opt)
    trainer.fit(ts, ArrayDataLoader(x, y, batch_size=16, seed=3), seed=seed)
    return [p.detach().clone() for p in model.parameters()]


def test_trainer_fit_dropout_follows_the_seed():
    """Two ``Trainer.fit`` runs with one seed end bit-identical; another
    seed draws other masks and ends elsewhere."""
    a, b, c = (_fit_with_dropout(s) for s in (7, 7, 8))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert any(not torch.equal(p, q) for p, q in zip(a, c))


def test_batch_generators_differ_by_batch_epoch_and_seed():
    draws = {key: torch.rand(4, generator=batch_generator(*key, "cpu"))
             for key in ((0, 1, 0), (0, 1, 1), (0, 2, 0), (1, 1, 0))}
    assert torch.equal(draws[(0, 1, 0)],
                       torch.rand(4, generator=batch_generator(0, 1, 0, "cpu")))
    vals = list(draws.values())
    assert all(not torch.equal(p, q) for i, p in enumerate(vals)
               for q in vals[i + 1:])
