"""Debug mode: numeric sanitizers for training runs (counterpart of
``dcnn_tpu/core/debug.py``).

The JAX package flips ``jax_debug_nans`` and wraps steps in ``checkify``.
The port's counterparts:

- :func:`enable_debug_mode` / :func:`disable_debug_mode` /
  :func:`debug_mode` set a process-wide flag. While it is set, the train
  step (``train/trainer.py``) checks its loss and gradients with
  ``torch.isfinite`` after the backward and raises ``FloatingPointError``
  naming the step, before the optimizer or a step guard sees them.
  ``checks=True`` also turns on ``torch.autograd.set_detect_anomaly``,
  which names the backward op that produced a NaN.
- :func:`checked` wraps a step function: forward hooks on the model's
  layers raise ``FloatingPointError`` naming the first layer whose output
  is not finite.

``DCNN_DEBUG=1`` turns the mode on when ``dcnn_tpu_torch`` is imported;
``TrainingConfig(debug=True)`` does so when a trainer is built. The checks
read values on the host, so every step waits for the card while the mode
is on: a debug run, not the fast path. On CUDA the step's captured graphs
go on with the mode (two graphs around the read); with ``checks=True``, or
under :func:`checked`, the train and eval steps run eagerly instead
(:func:`~dcnn_tpu_torch.core.graphs.debug_eager`), since a replay would run
neither anomaly mode's reads nor the hooks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_FLAGS = {"nans": False, "checks": False}


def enable_debug_mode(nans: bool = True, checks: bool = False) -> None:
    """Process-global numeric sanitizer."""
    _FLAGS["nans"] = bool(nans)
    if checks:
        _FLAGS["checks"] = True
        torch.autograd.set_detect_anomaly(True)


def disable_debug_mode() -> None:
    _FLAGS["nans"] = _FLAGS["checks"] = False
    torch.autograd.set_detect_anomaly(False)


def debug_nans() -> bool:
    """Whether the non-finite checks are on."""
    return _FLAGS["nans"]


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = False):
    """Scoped debug mode; restores the previous flags on exit."""
    prev = dict(_FLAGS)
    try:
        enable_debug_mode(nans=nans, checks=checks)
        yield
    finally:
        _FLAGS.update(prev)
        torch.autograd.set_detect_anomaly(prev["checks"])


def check_finite(step: int, loss: torch.Tensor, grad_norm_sq: torch.Tensor
                 ) -> None:
    """Raise ``FloatingPointError`` naming ``step`` when the loss or the
    gradients' squared norm is not finite (one read of the host)."""
    if not bool(torch.isfinite(loss).all() & torch.isfinite(grad_norm_sq)):
        raise FloatingPointError(
            f"debug mode: non-finite loss or gradient at train step {step} "
            f"(loss {float(loss)})")


def _find_model(args) -> Optional[torch.nn.Module]:
    for a in args:
        if isinstance(a, torch.nn.Module):
            return a
        m = getattr(a, "model", None)
        if isinstance(m, torch.nn.Module):
            return m
    return None


def checked(step_fn: Callable, model: Optional[torch.nn.Module] = None
            ) -> Callable:
    """Wrap a step function so that the first layer whose forward output
    holds a NaN or an Inf raises ``FloatingPointError`` naming it, instead
    of training on corrupted numbers. ``model`` defaults to the first
    ``nn.Module`` among the call's arguments, or the ``.model`` of one
    (a ``TrainState``); its top-level ``layers`` are hooked for the call.

    ``step = checked(make_train_step(model, loss, opt))``
    """

    def hook(layer, _inputs, out):
        if isinstance(out, torch.Tensor) and out.is_floating_point() \
                and not bool(torch.isfinite(out).all()):
            raise FloatingPointError(
                f"checked: non-finite output of layer "
                f"{getattr(layer, 'name', type(layer).__name__)!r}")

    def wrapper(*args, **kwargs):
        m = model if model is not None else _find_model(args)
        if m is None:
            raise ValueError("checked: no model among the arguments; pass "
                             "model=")
        layers = getattr(m, "layers", None) or [m]
        handles = [l.register_forward_hook(hook) for l in layers]
        try:
            return step_fn(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()

    return wrapper
