"""Fluent model builder with shape inference (counterpart of
``dcnn_tpu/nn/builder.py``). This slice carries the shorthands the
attention classifier needs: ``dense``, ``flatten``, ``activation`` and
``residual``; the conv/norm/pool ones come with their layers (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .layer import Layer
from .layers import ActivationLayer, DenseLayer, FlattenLayer
from .residual import ResidualBlock
from .sequential import Sequential


class SequentialBuilder:
    def __init__(self, name: str = "sequential"):
        self.model = Sequential(name=name)
        self._shape: Optional[Tuple[int, ...]] = None

    def input(self, shape: Sequence[int]) -> "SequentialBuilder":
        """Per-sample input shape, e.g. (S, E) or (features,)."""
        self._shape = tuple(int(d) for d in shape)
        self.model.input_shape = self._shape
        return self

    @property
    def current_shape(self) -> Tuple[int, ...]:
        if self._shape is None:
            raise RuntimeError("call .input(shape) first")
        return self._shape

    def add_layer(self, layer: Layer) -> "SequentialBuilder":
        shape = self.current_shape
        self.model.add(layer)
        self._shape = layer.output_shape(shape)
        return self

    def dense(self, out_features: int, use_bias: bool = True,
              name: str = "") -> "SequentialBuilder":
        return self.add_layer(DenseLayer(
            out_features, use_bias, in_features=self.current_shape[0],
            name=name or f"dense_{len(self.model)}"))

    def activation(self, activation_name: str, name: str = "") -> "SequentialBuilder":
        return self.add_layer(ActivationLayer(
            activation_name, name=name or f"activation_{len(self.model)}"))

    def flatten(self, name: str = "") -> "SequentialBuilder":
        return self.add_layer(FlattenLayer(name=name or f"flatten_{len(self.model)}"))

    def residual(self, layers: Sequence[Layer], shortcut: Sequence[Layer] = (),
                 activation: str = "relu", name: str = "") -> "SequentialBuilder":
        return self.add_layer(ResidualBlock(
            layers, shortcut, activation,
            name=name or f"residual_block_{len(self.model)}"))

    def build(self) -> Sequential:
        if self._shape is None:
            raise RuntimeError("Input shape must be set before building model. "
                               "Use .input().")
        return self.model
