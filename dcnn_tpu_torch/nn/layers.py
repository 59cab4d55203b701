"""Concrete layers (counterpart of ``dcnn_tpu/nn/layers.py``).

All of them: ``conv2d``, ``dense``, ``batchnorm``, ``groupnorm``,
``maxpool2d``, ``avgpool2d``, ``flatten``, ``activation``, ``dropout`` and
``log_softmax``.

Image layers take a ``data_format``. Under ``"NHWC"`` every layer takes and
returns a logical (N, H, W, C) tensor, as the JAX layers do, so that
``flatten`` lays features out in H, W, C order; the ops hand ``F.conv2d``
and the pools channels-last views. Conv weights are OIHW in both layouts.
Batchnorm keeps its running statistics as buffers and takes its mode from
``module.training``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import cast_to_compute
from ..ops import activations as act_ops
from ..ops import conv as conv_ops
from ..ops import norm as norm_ops
from ..ops import pool as pool_ops
from . import initializers as init
from .factory import register_layer
from .layer import ParameterizedLayer, Shape, StatelessLayer


def _numel(shape: Shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x·Wᵀ + b``. In bf16 the product is rounded to bf16 first and the
    bias added after, rounded again, as the JAX layers compute
    ``matmul(x, W.T) + b``; in fp32 the bias goes into the product's call
    (one kernel fewer; the two agree to the last bit)."""
    if b is not None and x.dtype == torch.bfloat16:
        return F.linear(x, w) + b
    return F.linear(x, w, b)


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
        return linear(x, cast_to_compute(self.w), cast_to_compute(self.b))

    def output_shape(self, input_shape):
        return (self.out_features,)

    def forward_complexity(self, input_shape):
        return 2 * input_shape[0] * self.out_features

    def param_count(self, input_shape):
        return (input_shape[0] * self.out_features
                + (self.out_features if self.use_bias else 0))

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "out_features": self.out_features, "use_bias": self.use_bias,
                "in_features": self.in_features}


def apply_dropout_mask(x: torch.Tensor, keep: torch.Tensor,
                       rate: float) -> torch.Tensor:
    """Inverted dropout under a given boolean keep mask: ``x / (1 - rate)``
    where kept, 0 elsewhere, in x's dtype (the JAX layer's
    ``where(mask, x / keep, 0)``)."""
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


@register_layer("dropout")
class DropoutLayer(StatelessLayer):
    """Inverted dropout. In training mode with ``rate > 0`` each element is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the
    keep mask is drawn from the ``generator`` the caller passes (a
    ``torch.Generator`` on x's device: the trainer gives one per batch),
    never from the global generator, and a training call without one
    raises, as the JAX layer does without its rng key. Identity in eval
    mode or at rate 0. The two packages draw different bits from one seed
    (``apply_dropout_mask`` takes a mask made elsewhere)."""

    draws = True  # Sequential passes its generator on

    def __init__(self, rate: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError(f"{self.name}: dropout in training mode needs a "
                             f"generator")
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < 1.0 - self.rate
        return apply_dropout_mask(x, keep, self.rate)

    def forward_complexity(self, input_shape):
        return 2 * _numel(input_shape)

    def get_config(self):
        return {"type": self.type_name, "name": self.name, "rate": self.rate}


@register_layer("flatten")
class FlattenLayer(StatelessLayer):
    """Flatten per-sample dims, row-major: (B, S, E) -> (B, S·E); a
    logical NHWC image in H, W, C order."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def output_shape(self, input_shape):
        return (_numel(input_shape),)


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

    def forward_complexity(self, input_shape):
        return _numel(input_shape)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "activation": self.activation,
                "negative_slope": self.negative_slope, "alpha": self.alpha}


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _feature_axis(data_format: str) -> int:
    """Channel axis of a per-sample (C, H, W) or (H, W, C) shape."""
    return 0 if data_format == "NCHW" else 2


@register_layer("conv2d")
class Conv2DLayer(ParameterizedLayer):
    """2-D convolution; ``w`` is OIHW (out, in, kh, kw) in both layouts."""

    def __init__(self, out_channels: int, kernel_size, stride=1, padding=0,
                 use_bias: bool = True, in_channels: Optional[int] = None,
                 data_format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.out_channels = int(out_channels)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.use_bias = bool(use_bias)
        self.in_channels = in_channels
        self.data_format = data_format
        self.register_parameter("w", None)
        self.register_parameter("b", None)

    def _cin(self, input_shape: Shape) -> int:
        cin = input_shape[_feature_axis(self.data_format)]
        if self.in_channels is not None and self.in_channels != cin:
            raise ValueError(f"{self.name}: expected {self.in_channels} input "
                             f"channels, got {cin}")
        return cin

    def init(self, input_shape, *, generator=None, device=None):
        cin = self._cin(input_shape)
        self.in_channels = cin
        fan_in = init.conv_fan_in(cin, self.kernel_size)
        self.w = nn.Parameter(init.kaiming_uniform(
            (self.out_channels, cin, *self.kernel_size), fan_in,
            generator=generator, device=device))
        if self.use_bias:
            self.b = nn.Parameter(init.kaiming_uniform(
                (self.out_channels,), fan_in, generator=generator,
                device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_ops.conv2d(x, cast_to_compute(self.w),
                               cast_to_compute(self.b), stride=self.stride,
                               padding=self.padding,
                               data_format=self.data_format)

    def output_shape(self, input_shape):
        if self.data_format == "NCHW":
            _, h, w = input_shape
        else:
            h, w, _ = input_shape
        oh, ow = conv_ops.conv2d_output_shape((h, w), self.kernel_size,
                                              self.stride, self.padding)
        if self.data_format == "NCHW":
            return (self.out_channels, oh, ow)
        return (oh, ow, self.out_channels)

    def forward_complexity(self, input_shape):
        cin = input_shape[_feature_axis(self.data_format)]
        out = self.output_shape(input_shape)
        oh, ow = out[1:] if self.data_format == "NCHW" else out[:2]
        return (2 * self.out_channels * cin * self.kernel_size[0]
                * self.kernel_size[1] * oh * ow)

    def param_count(self, input_shape):
        cin = input_shape[_feature_axis(self.data_format)]
        n = self.out_channels * cin * self.kernel_size[0] * self.kernel_size[1]
        return n + (self.out_channels if self.use_bias else 0)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "out_channels": self.out_channels,
                "kernel_size": list(self.kernel_size),
                "stride": list(self.stride), "padding": list(self.padding),
                "use_bias": self.use_bias, "in_channels": self.in_channels,
                "data_format": self.data_format}


@register_layer("batchnorm")
class BatchNormLayer(ParameterizedLayer):
    """BatchNorm (eps 1e-5, momentum 0.1 by default) over the channels of an
    image, or over the features of a flat (N, F) input ("dense BN").
    ``gamma`` and ``beta`` are parameters when ``affine``; ``running_mean``
    and ``running_var`` are buffers. In training mode the batch statistics
    normalize and the running buffers are updated in place; in eval mode
    the running statistics normalize."""

    def __init__(self, num_features: Optional[int] = None,
                 epsilon: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, data_format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.num_features = num_features
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.affine = bool(affine)
        self.data_format = data_format
        self.register_parameter("gamma", None)
        self.register_parameter("beta", None)
        self.register_buffer("running_mean", None)
        self.register_buffer("running_var", None)

    def _features(self, input_shape: Shape) -> int:
        if len(input_shape) == 3:
            return input_shape[_feature_axis(self.data_format)]
        return input_shape[0]

    def init(self, input_shape, *, generator=None, device=None):
        c = self._features(input_shape)
        if self.num_features is not None and self.num_features != c:
            raise ValueError(f"{self.name}: expected {self.num_features} "
                             f"features, got {c}")
        self.num_features = c
        if self.affine:
            self.gamma = nn.Parameter(init.ones((c,), device=device))
            self.beta = nn.Parameter(init.zeros((c,), device=device))
        self.running_mean = init.zeros((c,), device=device)
        self.running_var = init.ones((c,), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.running_mean.shape[0]
        gamma = (cast_to_compute(self.gamma) if self.affine
                 else torch.ones((c,), dtype=x.dtype, device=x.device))
        beta = (cast_to_compute(self.beta) if self.affine
                else torch.zeros_like(gamma))
        nchw = self.data_format == "NCHW"
        # dense BN: the features are the channels of an (N, F, 1, 1) or
        # (N, 1, 1, F) image
        xi = x if x.ndim != 2 else (x[:, :, None, None] if nchw
                                    else x[:, None, None, :])
        y, new_mean, new_var = norm_ops.batch_norm(
            xi, gamma, beta, self.running_mean, self.running_var,
            training=self.training, momentum=self.momentum, eps=self.epsilon,
            data_format=self.data_format)
        if self.training:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y.reshape(x.shape)

    def forward_complexity(self, input_shape):
        return 8 * _numel(input_shape)  # mean, var, normalize, affine

    def param_count(self, input_shape):
        return 2 * self._features(input_shape) if self.affine else 0

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "num_features": self.num_features, "epsilon": self.epsilon,
                "momentum": self.momentum, "affine": self.affine,
                "data_format": self.data_format}


@register_layer("groupnorm")
class GroupNormLayer(ParameterizedLayer):
    """GroupNorm (eps 1e-5); ``gamma`` and ``beta`` when ``affine``."""

    def __init__(self, num_groups: int, num_channels: Optional[int] = None,
                 epsilon: float = 1e-5, affine: bool = True,
                 data_format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.num_groups = int(num_groups)
        self.num_channels = num_channels
        self.epsilon = float(epsilon)
        self.affine = bool(affine)
        self.data_format = data_format
        self.register_parameter("gamma", None)
        self.register_parameter("beta", None)

    def init(self, input_shape, *, generator=None, device=None):
        c = input_shape[_feature_axis(self.data_format)]
        if self.num_channels is not None and self.num_channels != c:
            raise ValueError(f"{self.name}: expected {self.num_channels} "
                             f"channels, got {c}")
        self.num_channels = c
        if self.affine:
            self.gamma = nn.Parameter(init.ones((c,), device=device))
            self.beta = nn.Parameter(init.zeros((c,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_ops.group_norm(
            x, cast_to_compute(self.gamma), cast_to_compute(self.beta),
            self.num_groups, eps=self.epsilon, data_format=self.data_format)

    def forward_complexity(self, input_shape):
        return 8 * _numel(input_shape)

    def param_count(self, input_shape):
        return (2 * input_shape[_feature_axis(self.data_format)]
                if self.affine else 0)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "num_groups": self.num_groups,
                "num_channels": self.num_channels, "epsilon": self.epsilon,
                "affine": self.affine, "data_format": self.data_format}


class _Pool2DLayer(StatelessLayer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride) if stride is not None else self.kernel_size
        self.padding = _pair(padding)
        self.data_format = data_format

    def output_shape(self, input_shape):
        if self.data_format == "NCHW":
            c, h, w = input_shape
        else:
            h, w, c = input_shape
        oh, ow = pool_ops.pool_output_shape((h, w), self.kernel_size,
                                            self.stride, self.padding)
        return (c, oh, ow) if self.data_format == "NCHW" else (oh, ow, c)

    def forward_complexity(self, input_shape):
        return (_numel(self.output_shape(input_shape)) * self.kernel_size[0]
                * self.kernel_size[1])

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "kernel_size": list(self.kernel_size),
                "stride": list(self.stride), "padding": list(self.padding),
                "data_format": self.data_format}


@register_layer("maxpool2d")
class MaxPool2DLayer(_Pool2DLayer):
    """Max pooling; padding acts as −inf."""

    def forward(self, x):
        return pool_ops.max_pool2d(x, self.kernel_size, self.stride,
                                   self.padding, data_format=self.data_format)


@register_layer("avgpool2d")
class AvgPool2DLayer(_Pool2DLayer):
    """Average pooling; a window divides by its full size, padding
    included."""

    def forward(self, x):
        return pool_ops.avg_pool2d(x, self.kernel_size, self.stride,
                                   self.padding, data_format=self.data_format)


@register_layer("log_softmax")
class LogSoftmaxLayer(StatelessLayer):
    """Log-softmax over the last axis."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)
