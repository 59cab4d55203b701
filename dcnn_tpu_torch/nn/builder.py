"""Fluent model builder with shape inference (counterpart of
``dcnn_tpu/nn/builder.py``): chainable ``.input().conv2d().batchnorm()…``
calls that track the per-sample shape, and the residual-block helpers
``basic_residual_block`` (two 3×3 conv+BN with a ReLU between; a 1×1
projection shortcut when the stride or the width changes) and
``bottleneck_residual_block`` (1×1→3×3→1×1 conv+BN, biasless, BN eps 1e-3,
as the reference).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .layer import Layer
from .layers import (
    ActivationLayer, AvgPool2DLayer, BatchNormLayer, Conv2DLayer, DenseLayer,
    DropoutLayer, FlattenLayer, GroupNormLayer, LogSoftmaxLayer, MaxPool2DLayer,
)
from .residual import ResidualBlock
from .sequential import Sequential


class SequentialBuilder:
    def __init__(self, name: str = "sequential", data_format: str = "NCHW"):
        self.model = Sequential(name=name)
        self.data_format = data_format
        self._shape: Optional[Tuple[int, ...]] = None

    def input(self, shape: Sequence[int]) -> "SequentialBuilder":
        """Per-sample input shape: (C, H, W) under NCHW, (H, W, C) under
        NHWC, (S, E) or (features,)."""
        self._shape = tuple(int(d) for d in shape)
        self.model.input_shape = self._shape
        return self

    @property
    def current_shape(self) -> Tuple[int, ...]:
        if self._shape is None:
            raise RuntimeError("call .input(shape) first")
        return self._shape

    def _channels(self) -> int:
        shape = self.current_shape
        return shape[0] if self.data_format == "NCHW" else shape[-1]

    def add_layer(self, layer: Layer) -> "SequentialBuilder":
        shape = self.current_shape
        self.model.add(layer)
        self._shape = layer.output_shape(shape)
        return self

    def conv2d(self, out_channels: int, kernel_size, stride=1, padding=0,
               use_bias: bool = True, name: str = "") -> "SequentialBuilder":
        return self.add_layer(Conv2DLayer(
            out_channels, kernel_size, stride, padding, use_bias,
            in_channels=self._channels(), data_format=self.data_format,
            name=name or f"conv2d_{len(self.model)}"))

    def dense(self, out_features: int, use_bias: bool = True,
              name: str = "") -> "SequentialBuilder":
        return self.add_layer(DenseLayer(
            out_features, use_bias, in_features=self.current_shape[0],
            name=name or f"dense_{len(self.model)}"))

    def batchnorm(self, epsilon: float = 1e-5, momentum: float = 0.1,
                  affine: bool = True, name: str = "") -> "SequentialBuilder":
        shape = self.current_shape
        return self.add_layer(BatchNormLayer(
            num_features=self._channels() if len(shape) == 3 else shape[0],
            epsilon=epsilon, momentum=momentum, affine=affine,
            data_format=self.data_format,
            name=name or f"batchnorm_{len(self.model)}"))

    def groupnorm(self, num_groups: int, epsilon: float = 1e-5,
                  affine: bool = True, name: str = "") -> "SequentialBuilder":
        return self.add_layer(GroupNormLayer(
            num_groups, num_channels=self._channels(), epsilon=epsilon,
            affine=affine, data_format=self.data_format,
            name=name or f"groupnorm_{len(self.model)}"))

    def activation(self, activation_name: str, name: str = "") -> "SequentialBuilder":
        return self.add_layer(ActivationLayer(
            activation_name, name=name or f"activation_{len(self.model)}"))

    def maxpool2d(self, kernel_size, stride=None, padding=0,
                  name: str = "") -> "SequentialBuilder":
        return self.add_layer(MaxPool2DLayer(
            kernel_size, stride, padding, data_format=self.data_format,
            name=name or f"maxpool2d_{len(self.model)}"))

    def avgpool2d(self, kernel_size, stride=None, padding=0,
                  name: str = "") -> "SequentialBuilder":
        return self.add_layer(AvgPool2DLayer(
            kernel_size, stride, padding, data_format=self.data_format,
            name=name or f"avgpool2d_{len(self.model)}"))

    def dropout(self, rate: float, name: str = "") -> "SequentialBuilder":
        return self.add_layer(DropoutLayer(
            rate, name=name or f"dropout_{len(self.model)}"))

    def flatten(self, name: str = "") -> "SequentialBuilder":
        return self.add_layer(FlattenLayer(name=name or f"flatten_{len(self.model)}"))

    def log_softmax(self, name: str = "") -> "SequentialBuilder":
        return self.add_layer(LogSoftmaxLayer(
            name=name or f"log_softmax_{len(self.model)}"))

    def residual(self, layers: Sequence[Layer], shortcut: Sequence[Layer] = (),
                 activation: str = "relu", name: str = "") -> "SequentialBuilder":
        return self.add_layer(ResidualBlock(
            layers, shortcut, activation,
            name=name or f"residual_block_{len(self.model)}"))

    def basic_residual_block(self, in_channels: int, out_channels: int,
                             stride: int = 1, name: str = "") -> "SequentialBuilder":
        df = self.data_format
        main = [
            Conv2DLayer(out_channels, 3, stride, 1, True, in_channels, df, name="conv0"),
            BatchNormLayer(out_channels, 1e-5, 0.1, True, df, name="bn0"),
            ActivationLayer("relu", name="relu0"),
            Conv2DLayer(out_channels, 3, 1, 1, True, out_channels, df, name="conv1"),
            BatchNormLayer(out_channels, 1e-5, 0.1, True, df, name="bn1"),
        ]
        shortcut = []
        if stride != 1 or in_channels != out_channels:
            shortcut = [
                Conv2DLayer(out_channels, 1, stride, 0, False, in_channels, df, name="proj"),
                BatchNormLayer(out_channels, 1e-5, 0.1, True, df, name="proj_bn"),
            ]
        return self.residual(main, shortcut, "relu",
                             name=name or f"basic_residual_block_{len(self.model)}")

    def bottleneck_residual_block(self, in_channels: int, mid_channels: int,
                                  out_channels: int, stride: int = 1,
                                  name: str = "") -> "SequentialBuilder":
        df = self.data_format
        main = [
            Conv2DLayer(mid_channels, 1, 1, 0, False, in_channels, df, name="conv0"),
            BatchNormLayer(mid_channels, 1e-3, 0.1, True, df, name="bn0"),
            ActivationLayer("relu", name="relu0"),
            Conv2DLayer(mid_channels, 3, stride, 1, False, mid_channels, df, name="conv1"),
            BatchNormLayer(mid_channels, 1e-3, 0.1, True, df, name="bn1"),
            ActivationLayer("relu", name="relu1"),
            Conv2DLayer(out_channels, 1, 1, 0, False, mid_channels, df, name="conv2"),
            BatchNormLayer(out_channels, 1e-3, 0.1, True, df, name="bn2"),
        ]
        shortcut = []
        if stride != 1 or in_channels != out_channels:
            shortcut = [
                Conv2DLayer(out_channels, 1, stride, 0, False, in_channels, df, name="proj"),
                BatchNormLayer(out_channels, 1e-3, 0.1, True, df, name="proj_bn"),
            ]
        return self.residual(main, shortcut, "relu",
                             name=name or f"bottleneck_residual_block_{len(self.model)}")

    def build(self) -> Sequential:
        if self._shape is None:
            raise RuntimeError("Input shape must be set before building model. "
                               "Use .input().")
        return self.model
