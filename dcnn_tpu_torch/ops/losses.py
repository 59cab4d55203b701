"""Loss functions, value and explicit gradient (counterpart of
``dcnn_tpu/ops/losses.py``), with the reference's reductions:

- targets are one-hot (classification) or dense (regression);
- classification losses are the mean over the batch, regression losses the
  mean over all elements;
- each loss has a ``*_grad`` twin with the scaling the reference's gradient
  kernels apply (softmax-CE: ``(softmax - target) / batch``), for callers
  that seed a backward pass by hand. The trainer differentiates the loss
  value with autograd instead.

Loss math runs in fp32 whatever the prediction dtype (fp64 stays fp64):
under the bf16 precision mode the model emits bf16 logits, and a bf16
logsumexp costs accuracy. The gradient twins compute in fp32 and return
the prediction's dtype.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch


def _f32(a) -> torch.Tensor:
    """Upcast to at least fp32; fp64 stays fp64, integers stay as they are."""
    a = torch.as_tensor(a)
    if a.is_floating_point() and a.dtype != torch.float64:
        return a.float()
    return a


def upcast_logits(logits: torch.Tensor) -> torch.Tensor:
    """Model outputs -> loss/metric dtype: fp32 for fp32/bf16 activations,
    fp64 kept. The cast every trainer and eval path applies."""
    return _f32(logits)


def _loss_fp32(fn):
    @functools.wraps(fn)
    def wrapped(pred, targets, *args, **kw):
        return fn(_f32(pred), _f32(targets), *args, **kw)
    return wrapped


def _grad_fp32(fn):
    @functools.wraps(fn)
    def wrapped(pred, targets, *args, **kw):
        out = fn(_f32(pred), _f32(targets), *args, **kw)
        return out.to(torch.as_tensor(pred).dtype)
    return wrapped


# ---------------- classification ----------------

@_loss_fp32
def cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                  eps: float = 1e-15) -> torch.Tensor:
    """CE over probability inputs, clamped to [eps, 1 - eps]."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return (-(targets * torch.log(p)).sum(-1)).mean()


@_grad_fp32
def cross_entropy_grad(probs: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """``(pred - target) / batch``: the fused softmax-CE shortcut of the
    reference's kernel (the softmax jacobian folded in), not ∂loss/∂probs."""
    return (probs - targets) / probs.shape[0]


@_loss_fp32
def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Stable fused softmax + CE over logits: logsumexp(x) - x[target],
    mean over the batch."""
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return (targets * (lse - logits)).sum(-1).mean()


@_grad_fp32
def softmax_cross_entropy_grad(logits: torch.Tensor,
                               targets: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(logits, dim=-1) - targets) / logits.shape[0]


@_loss_fp32
def log_softmax_cross_entropy(log_probs: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """CE over log-probability inputs."""
    return (-(targets * log_probs).sum(-1)).mean()


@_grad_fp32
def log_softmax_cross_entropy_grad(log_probs: torch.Tensor,
                                   targets: torch.Tensor) -> torch.Tensor:
    """``(exp(logp) - t) / batch``: the gradient at the logits feeding the
    log-softmax (jacobian folded in, as the reference's kernel does)."""
    return (torch.exp(log_probs) - targets) / log_probs.shape[0]


# ---------------- regression ----------------

@_loss_fp32
def mse_loss(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - targets).mean()


@_grad_fp32
def mse_grad(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return 2.0 * (pred - targets) / pred.numel()


@_loss_fp32
def mae_loss(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - targets).mean()


@_grad_fp32
def mae_grad(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.sign(pred - targets) / pred.numel()


@_loss_fp32
def huber_loss(pred: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """Huber with delta 1.0 by default."""
    d = pred - targets
    a = torch.abs(d)
    quad = 0.5 * torch.square(d)
    lin = delta * (a - 0.5 * delta)
    return torch.where(a <= delta, quad, lin).mean()


@_grad_fp32
def huber_grad(pred: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    d = pred - targets
    g = torch.where(torch.abs(d) <= delta, d, delta * torch.sign(d))
    return g / pred.numel()


# ---------------- registry ----------------

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

LOSSES: Dict[str, Tuple[LossFn, LossFn]] = {
    "crossentropy": (cross_entropy, cross_entropy_grad),
    "softmax_crossentropy": (softmax_cross_entropy, softmax_cross_entropy_grad),
    "logsoftmax_crossentropy": (log_softmax_cross_entropy,
                                log_softmax_cross_entropy_grad),
    "mse": (mse_loss, mse_grad),
    "mae": (mae_loss, mae_grad),
    "huber": (huber_loss, huber_grad),
}


def get_loss(name: str) -> LossFn:
    try:
        return LOSSES[name.lower()][0]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(LOSSES)}") from None


def get_loss_grad(name: str) -> LossFn:
    return LOSSES[name.lower()][1]
