"""Concrete layers (counterpart of ``dcnn_tpu/nn/layers.py``).

This slice ports ``dense``, ``flatten`` and ``activation``; the other
registered types of the JAX package are listed in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import cast_to_compute
from ..ops import activations as act_ops
from . import initializers as init
from .factory import register_layer
from .layer import ParameterizedLayer, Shape, StatelessLayer


@register_layer("dense")
class DenseLayer(ParameterizedLayer):
    """Fully-connected layer ``y = x·Wᵀ + b``. ``w`` is stored (out, in),
    the JAX layer's layout too, so its weights carry over untransposed."""

    def __init__(self, out_features: int, use_bias: bool = True,
                 in_features: Optional[int] = None, name: Optional[str] = None):
        super().__init__(name)
        self.out_features = int(out_features)
        self.use_bias = bool(use_bias)
        self.in_features = in_features
        self.register_parameter("w", None)
        self.register_parameter("b", None)

    def _fan_in(self, input_shape: Shape) -> int:
        if len(input_shape) != 1:
            raise ValueError(f"{self.name}: dense expects flat input, got "
                             f"{input_shape}; add a Flatten layer first")
        fan_in = input_shape[0]
        if self.in_features is not None and self.in_features != fan_in:
            raise ValueError(f"{self.name}: expected {self.in_features} "
                             f"features, got {fan_in}")
        return fan_in

    def init(self, input_shape, *, generator=None, device=None):
        fan_in = self._fan_in(input_shape)
        self.in_features = fan_in
        self.w = nn.Parameter(init.kaiming_uniform(
            (self.out_features, fan_in), fan_in, generator=generator,
            device=device))
        if self.use_bias:
            self.b = nn.Parameter(init.kaiming_uniform(
                (self.out_features,), fan_in, generator=generator,
                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast_to_compute(self.w), cast_to_compute(self.b))

    def output_shape(self, input_shape):
        return (self.out_features,)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "out_features": self.out_features, "use_bias": self.use_bias,
                "in_features": self.in_features}


@register_layer("flatten")
class FlattenLayer(StatelessLayer):
    """Flatten per-sample dims, row-major: (B, S, E) -> (B, S·E)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def output_shape(self, input_shape):
        n = 1
        for d in input_shape:
            n *= d
        return (n,)


@register_layer("activation")
class ActivationLayer(StatelessLayer):
    """Standalone activation from the ``ACTIVATIONS`` registry."""

    def __init__(self, activation: str = "relu", negative_slope: float = 0.01,
                 alpha: float = 1.0, name: Optional[str] = None):
        super().__init__(name)
        self.activation = activation.lower()
        self.negative_slope = float(negative_slope)
        self.alpha = float(alpha)
        if self.activation not in act_ops.ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")

    def forward(self, x):
        if self.activation == "leaky_relu":
            return act_ops.leaky_relu(x, self.negative_slope)
        if self.activation == "elu":
            return act_ops.elu(x, self.alpha)
        return act_ops.ACTIVATIONS[self.activation](x)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "activation": self.activation,
                "negative_slope": self.negative_slope, "alpha": self.alpha}
