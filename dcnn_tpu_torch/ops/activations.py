"""Activation functions (counterpart of ``dcnn_tpu/ops/activations.py``).

The string registry lets JSON model configs name activations the same way
in both packages. Defaults: LeakyReLU slope 0.01, ELU alpha 1.0.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    safe = torch.clamp_max(x, 0.0)  # avoid overflow in exp for large positives
    return torch.where(x > 0, x, alpha * (torch.exp(safe) - 1.0))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS: Dict[str, Callable] = {
    "relu": relu,
    "leaky_relu": leaky_relu,
    "elu": elu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "softmax": softmax,
    "linear": linear,
    "none": linear,
}
