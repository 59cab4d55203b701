"""The port's losses and metrics held against the JAX package.

The same numpy predictions and targets go through each loss, its ``*_grad``
twin and the metrics of both packages. fp32 tolerance 1e-6: the same
formula reduced in another order. Under bf16 predictions both packages
upcast at the loss boundary, so the loss values agree as closely; the
gradient twins round their fp32 result to bf16, where one rounding flip is
2^-8 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.ops import losses as jax_losses
from dcnn_tpu.ops import metrics as jax_metrics
from dcnn_tpu_torch.ops import losses, metrics

TOL = dict(atol=1e-6, rtol=1e-6)
BF16_GRAD_TOL = dict(atol=1e-3, rtol=2 ** -8)


def _inputs(name, seed=0, n=6, c=5):
    """(pred, target) numpy arrays in the domain each loss expects."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    if name in ("mse", "mae", "huber"):
        return 2 * x, rng.normal(size=(n, c)).astype(np.float32)
    t = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    if name == "crossentropy":
        e = np.exp(x)
        return (e / e.sum(-1, keepdims=True)).astype(np.float32), t
    if name == "logsoftmax_crossentropy":
        return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32), t
    return x, t


def test_registry_names_match():
    assert sorted(losses.LOSSES) == sorted(jax_losses.LOSSES)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.get_loss("hinge")


@pytest.mark.parametrize("name", sorted(jax_losses.LOSSES))
def test_loss_and_grad_match_jax(name):
    pred, tgt = _inputs(name)
    want = float(jax_losses.get_loss(name)(jnp.asarray(pred), jnp.asarray(tgt)))
    got = losses.get_loss(name)(torch.from_numpy(pred), torch.from_numpy(tgt))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), want, **TOL)
    want_g = np.asarray(jax_losses.get_loss_grad(name)(jnp.asarray(pred),
                                                       jnp.asarray(tgt)))
    got_g = losses.get_loss_grad(name)(torch.from_numpy(pred),
                                       torch.from_numpy(tgt))
    assert got_g.dtype == torch.float32 and got_g.shape == pred.shape
    np.testing.assert_allclose(got_g.numpy(), want_g, **TOL)


@pytest.mark.parametrize("name", sorted(jax_losses.LOSSES))
def test_bf16_predictions_upcast_like_jax(name):
    """bf16 predictions: the loss is computed and returned in fp32, the
    gradient twin computed in fp32 and returned in bf16, in both packages."""
    pred, tgt = _inputs(name, seed=1)
    pj = jnp.asarray(pred).astype(jnp.bfloat16)
    pt = torch.from_numpy(pred).to(torch.bfloat16)
    want = jax_losses.get_loss(name)(pj, jnp.asarray(tgt))
    got = losses.get_loss(name)(pt, torch.from_numpy(tgt))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    want_g = jax_losses.get_loss_grad(name)(pj, jnp.asarray(tgt))
    got_g = losses.get_loss_grad(name)(pt, torch.from_numpy(tgt))
    assert want_g.dtype == jnp.bfloat16 and got_g.dtype == torch.bfloat16
    np.testing.assert_allclose(got_g.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               **BF16_GRAD_TOL)


def test_upcast_logits_keeps_fp64():
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        assert losses.upcast_logits(torch.zeros(2, dtype=dt)).dtype \
            == torch.float32
    assert losses.upcast_logits(torch.zeros(2, dtype=torch.float64)).dtype \
        == torch.float64
    assert losses.softmax_cross_entropy(
        torch.zeros(2, 3, dtype=torch.float64),
        torch.eye(3)[:2].double()).dtype == torch.float64


def test_softmax_ce_autograd_equals_grad_twin():
    """The trainer differentiates the loss value; its gradient is the
    twin's ``(softmax - target) / batch``."""
    pred, tgt = _inputs("softmax_crossentropy", seed=2)
    x = torch.from_numpy(pred).requires_grad_()
    losses.softmax_cross_entropy(x, torch.from_numpy(tgt)).backward()
    torch.testing.assert_close(
        x.grad, losses.softmax_cross_entropy_grad(torch.from_numpy(pred),
                                                  torch.from_numpy(tgt)),
        atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("one_hot", [True, False])
def test_metrics_match_jax(one_hot):
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(40, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 40)
    labels[:10] = pred[:10].argmax(-1)  # some right answers
    tgt = np.eye(7, dtype=np.float32)[labels] if one_hot else labels
    want_n = int(jax_metrics.correct_count(jnp.asarray(pred), jnp.asarray(tgt)))
    want_a = float(jax_metrics.accuracy(jnp.asarray(pred), jnp.asarray(tgt)))
    pt, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    assert int(metrics.correct_count(pt, tt)) == want_n >= 10
    np.testing.assert_allclose(float(metrics.accuracy(pt, tt)), want_a,
                               rtol=1e-7)
