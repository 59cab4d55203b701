"""Post-training int8 quantization of the inference graph (counterpart of
``dcnn_tpu/nn/quantize.py``).

The recipe is the JAX package's static w8a8 PTQ:

- weights: symmetric int8 per output channel, from the folded weights
  (:func:`~dcnn_tpu_torch.ops.quant.quantize_weight`);
- activations: symmetric int8 per tensor, with a static scale calibrated
  on a representative batch: each quantized layer records the absmax (or
  the ``act_quantile`` of ``|x|``) of its own input during a float pass in
  eval mode;
- everything between the linear layers (pooling, activations, residual
  adds, the attention core's softmax) stays float: each int32 accumulator
  is dequantized per channel right after its conv or GEMM, in the JAX
  order (``scale = x_scale · w_scale`` rounded once, then
  ``y_i32 · scale + b``, then the cast to the input's dtype). On the card
  a conv layer is one launch of the fused int8 conv
  (:func:`~dcnn_tpu_torch.ops.quant.quant_conv2d`: quantize, products and
  dequantize in one kernel, bit for bit this chain), from weights packed
  once per layer and device (:meth:`QuantConv2DLayer.kernel_operands`).

:func:`quantize_model` walks the model as ``fold_batchnorm`` does (into
every residual block's main and shortcut paths) and returns a new model;
the original is left untouched. The quantized layers are registered under
the JAX names (``quant_conv2d``, ``quant_dense``,
``quant_multi_head_attention``), so their configs and checkpoints cross
between the packages. Their tensors are parameters that take no gradient;
a quantized layer starts in eval mode, and a forward in training mode
raises, as the JAX layer does with ``training=True``.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.precision import cast_to_compute
from ..ops import library
from ..ops import quant as quant_ops
from .attention_layer import MultiHeadAttentionLayer
from .factory import register_layer
from .layer import ParameterizedLayer
from .layers import Conv2DLayer, DenseLayer, _pair
from .residual import ResidualBlock
from .sequential import Sequential


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _version(t: torch.Tensor) -> int:
    """``t``'s in-place version counter (an inference tensor keeps none)."""
    return -1 if t.is_inference() else t._version


class _QuantizedLayer(ParameterizedLayer):
    """Shared plumbing. ``init`` makes a ZERO template of the right shapes
    and dtypes (what a checkpoint load fills in); zero weights make an
    unfilled quantized layer loudly useless rather than silently random."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.train(False)

    def _check_mode(self) -> None:
        if self.training:
            raise ValueError(f"{self.name}: the PTQ graph is inference-only")

    def _template(self, w_shape, out_ch, device) -> None:
        self.set_quantized(torch.zeros(w_shape, dtype=torch.int8,
                                       device=device),
                           torch.ones((out_ch,), device=device),
                           torch.ones((), device=device),
                           torch.zeros((out_ch,), device=device)
                           if self.use_bias else None)

    def set_quantized(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                      x_scale: torch.Tensor,
                      b: Optional[torch.Tensor]) -> None:
        """Install int8 weights, their per-channel scales, the calibrated
        input scale and the float bias (None without one)."""
        self.w_q = _frozen(w_q)
        self.w_scale = _frozen(w_scale.float())
        self.x_scale = _frozen(x_scale.float().to(w_q.device))
        self.b = None if b is None else _frozen(b.float())

    def _dequant(self, y_i32: torch.Tensor, x_dtype: torch.dtype,
                 channel_axis: int) -> torch.Tensor:
        """int32 accumulator -> float: ``y · (x_scale · w_scale) + b``,
        cast to the activation dtype."""
        shape = [1] * y_i32.ndim
        shape[channel_axis] = -1
        y = y_i32.float() * (self.x_scale * self.w_scale).reshape(shape)
        if self.b is not None:
            y = y + self.b.reshape(shape)
        return y.to(x_dtype)


@register_layer("quant_conv2d")
class QuantConv2DLayer(_QuantizedLayer):
    """int8 convolution made by PTQ of a (folded) ``Conv2DLayer``: ``w_q``
    int8 OIHW, ``w_scale`` (O,), ``x_scale`` scalar, optional ``b`` (O,).
    Geometry and config are the conv layer's."""

    _cin = Conv2DLayer._cin
    output_shape = Conv2DLayer.output_shape
    forward_complexity = Conv2DLayer.forward_complexity
    param_count = Conv2DLayer.param_count
    get_config = Conv2DLayer.get_config

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
        self._operands: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._operands_key = None
        self.packs = 0
        for n in ("w_q", "w_scale", "x_scale", "b"):
            self.register_parameter(n, None)

    def init(self, input_shape, *, generator=None, device=None):
        cin = self._cin(input_shape)
        self.in_channels = cin
        self._template((self.out_channels, cin, *self.kernel_size),
                       self.out_channels, device)

    def set_quantized(self, w_q, w_scale, x_scale, b) -> None:
        super().set_quantized(w_q, w_scale, x_scale, b)
        self._operands_key = None

    def kernel_operands(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused kernel's operands, (packed weights, ``x_scale ·
        w_scale`` in fp32), made once and kept (not parameters: the
        state_dict is unchanged); made again when ``w_q``, ``w_scale`` or
        ``x_scale`` is another tensor, on another device or written in
        place (a ``load_state_dict``, a ``.to()``). ``packs`` counts how
        often they were made. Under ``torch.export`` the operands made
        before the trace are used as they are (a traced weight has no
        storage to key on), and become constants of the program
        (:func:`~dcnn_tpu_torch.nn.export.export_inference` makes them
        first)."""
        if torch.compiler.is_exporting():
            if self._operands is None:
                raise RuntimeError(
                    f"{self.name}: the int8 conv's packed weights must be "
                    f"made before the trace (export_inference does it)")
            return self._operands
        key = tuple((t.data_ptr(), t.device, _version(t))
                    for t in (self.w_q, self.w_scale, self.x_scale))
        if key != self._operands_key:
            with torch.no_grad():
                self._operands = (library.pack_int8_weight(self.w_q),
                                  (self.x_scale * self.w_scale).float())
            self._operands_key = key
            self.packs += 1
        return self._operands

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_mode()
        return quant_ops.quant_conv2d(
            x, self.x_scale, self.w_q, self.w_scale, self.b,
            stride=self.stride, padding=self.padding,
            data_format=self.data_format, packed=self.kernel_operands())


@register_layer("quant_dense")
class QuantDenseLayer(_QuantizedLayer):
    """int8 GEMM made by PTQ of a ``DenseLayer``: ``w_q`` int8 (out, in),
    ``w_scale`` (out,), ``x_scale`` scalar, optional ``b`` (out,)."""

    _fan_in = DenseLayer._fan_in
    output_shape = DenseLayer.output_shape
    forward_complexity = DenseLayer.forward_complexity
    param_count = DenseLayer.param_count
    get_config = DenseLayer.get_config

    def __init__(self, out_features: int, use_bias: bool = True,
                 in_features: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.out_features = int(out_features)
        self.use_bias = bool(use_bias)
        self.in_features = in_features
        for n in ("w_q", "w_scale", "x_scale", "b"):
            self.register_parameter(n, None)

    def init(self, input_shape, *, generator=None, device=None):
        fan_in = self._fan_in(input_shape)
        self.in_features = fan_in
        self._template((self.out_features, fan_in), self.out_features,
                       device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_mode()
        x_q = quant_ops.quantize_symmetric(x, self.x_scale)
        y = quant_ops.dense_int8(x_q, self.w_q)
        return self._dequant(y, x.dtype, y.ndim - 1)


_TAGS = "qkvo"


@register_layer("quant_multi_head_attention")
class QuantMultiHeadAttentionLayer(_QuantizedLayer):
    """int8 PTQ twin of ``MultiHeadAttentionLayer``: the four (E, E)
    projections run w8a8; the attention core (scores, softmax, · V) stays
    float through the layer's own ``impl`` (the flash kernel by default).

    Parameters: per projection p in q, k, v, o: ``wp_q`` int8 (E_out, E_in),
    ``wp_s`` (E,) and, with a bias, ``bp``; ``x_scale`` (the input, shared
    by q, k and v) and ``o_scale`` (the core's output, the out projection's
    input)."""

    _embed = MultiHeadAttentionLayer._embed
    _attend = MultiHeadAttentionLayer._attend
    output_shape = MultiHeadAttentionLayer.output_shape
    forward_complexity = MultiHeadAttentionLayer.forward_complexity
    param_count = MultiHeadAttentionLayer.param_count
    get_config = MultiHeadAttentionLayer.get_config

    def __init__(self, num_heads: int, embed_dim: Optional[int] = None,
                 causal: bool = False, impl: str = "flash",
                 use_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        if impl not in ("flash", "blockwise", "naive"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads = int(num_heads)
        self.embed_dim = embed_dim
        self.causal = bool(causal)
        self.impl = impl
        self.use_bias = bool(use_bias)
        for n in ("x_scale", "o_scale"):
            self.register_parameter(n, None)
        for t in _TAGS:
            for n in (f"w{t}_q", f"w{t}_s", f"b{t}"):
                self.register_parameter(n, None)

    def init(self, input_shape, *, generator=None, device=None):
        e = self._embed(input_shape)
        self.embed_dim = e
        self.x_scale = _frozen(torch.ones((), device=device))
        self.o_scale = _frozen(torch.ones((), device=device))
        for t in _TAGS:
            setattr(self, f"w{t}_q", _frozen(torch.zeros(
                (e, e), dtype=torch.int8, device=device)))
            setattr(self, f"w{t}_s", _frozen(torch.ones((e,), device=device)))
            if self.use_bias:
                setattr(self, f"b{t}", _frozen(torch.zeros((e,),
                                                           device=device)))

    def _proj_int8(self, tag: str, x_q: torch.Tensor, s_in: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
        y = quant_ops.dense_int8(x_q, getattr(self, f"w{tag}_q"))
        y = y.float() * (s_in * getattr(self, f"w{tag}_s"))
        b = getattr(self, f"b{tag}")
        if b is not None:
            y = y + b
        return y.to(out_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_mode()
        x_q = quant_ops.quantize_symmetric(x, self.x_scale)
        q, k, v = (self._proj_int8(t, x_q, self.x_scale, x.dtype)
                   for t in "qkv")
        o = self._attend(q, k, v)
        o_q = quant_ops.quantize_symmetric(o, self.o_scale)
        return self._proj_int8("o", o_q, self.o_scale, x.dtype)


def _config_of(layer) -> dict:
    cfg = layer.get_config()
    cfg.pop("type")
    return cfg


def _quantize_linear(layer, x: torch.Tensor, qcls, act_quantile):
    """The int8 twin of one conv or dense layer, from its float weights
    and the calibration activation feeding it."""
    w_q, w_scale = quant_ops.quantize_weight(layer.w.detach())
    ql = qcls(**_config_of(layer))
    ql.set_quantized(w_q, w_scale,
                     quant_ops.tensor_scale(x, quantile=act_quantile),
                     None if layer.b is None else layer.b.detach())
    return ql


def _quantize_mha(layer: MultiHeadAttentionLayer, x: torch.Tensor,
                  act_quantile):
    """The int8 twin of one attention layer, and the float layer's output
    (so the walk goes on without running the core twice). The core's
    scale is calibrated on the float layer's own projections and core."""
    ql = QuantMultiHeadAttentionLayer(**_config_of(layer))
    dev = layer.wq.device
    ql.x_scale = _frozen(quant_ops.tensor_scale(
        x, quantile=act_quantile).to(dev))
    for t in _TAGS:
        w_q, w_s = quant_ops.quantize_weight(getattr(layer, f"w{t}").detach())
        setattr(ql, f"w{t}_q", _frozen(w_q))
        setattr(ql, f"w{t}_s", _frozen(w_s))
        b = getattr(layer, f"b{t}")
        if b is not None:
            setattr(ql, f"b{t}", _frozen(b.detach().float()))
    o = layer._attend(*(layer._project(x, getattr(layer, f"w{t}"),
                                       getattr(layer, f"b{t}"))
                        for t in "qkv"))
    ql.o_scale = _frozen(quant_ops.tensor_scale(
        o, quantile=act_quantile).to(dev))
    return ql, layer._project(o, layer.wo, layer.bo)


def _quantize_list(layers: Sequence[nn.Module], x: torch.Tensor,
                   act_quantile) -> Tuple[List[nn.Module], torch.Tensor]:
    """Walk one layer list: int8 twins for conv, dense and attention
    layers (each with the scale of its own input), recursion into residual
    blocks, copies of everything else, while ``x`` advances through the
    float layers in eval mode, so every scale is measured on the tensor
    the quantized layer will see."""
    out: List[nn.Module] = []
    for layer in layers:
        advanced = None
        if isinstance(layer, Conv2DLayer):
            out.append(_quantize_linear(layer, x, QuantConv2DLayer,
                                        act_quantile))
        elif isinstance(layer, DenseLayer):
            out.append(_quantize_linear(layer, x, QuantDenseLayer,
                                        act_quantile))
        elif isinstance(layer, MultiHeadAttentionLayer):
            ql, advanced = _quantize_mha(layer, x, act_quantile)
            out.append(ql)
        elif isinstance(layer, ResidualBlock):
            main, _ = _quantize_list(layer.layers, x, act_quantile)
            short, _ = _quantize_list(layer.shortcut, x, act_quantile)
            out.append(ResidualBlock(main, short, activation=layer.activation,
                                     name=layer.name))
        else:  # a copy, so the quantized model shares no module
            out.append(copy.deepcopy(layer))
        x = advanced if advanced is not None else layer(x)
    return out, x


def quantize_model(model: Sequential, calib_x: Any, *, fold_bn: bool = True,
                   act_quantile: Optional[float] = None) -> Sequential:
    """The int8 PTQ twin of ``model``, a new model in eval mode on the
    model's device.

    ``calib_x`` is a representative input batch (array or tensor) in the
    preprocessing the eval path uses; activation scales are the absmax over
    it, or the ``act_quantile`` of ``|x|`` (e.g. 0.9999), which one stray
    outlier cannot stretch. ``fold_bn`` (default) first folds every
    conv/dense -> batchnorm pair, so the per-channel weight scales absorb
    BN's."""
    from .fold import fold_batchnorm

    float_model = (fold_batchnorm(model) if fold_bn
                   else copy.deepcopy(model).eval())
    dev = next(float_model.parameters()).device
    # the activations the layers will see: cast as Sequential.forward casts
    x = cast_to_compute(torch.as_tensor(calib_x, dtype=torch.float32).to(dev))
    with torch.no_grad():
        layers, _ = _quantize_list(list(float_model.layers), x, act_quantile)
    return Sequential(layers, name=f"{model.name}_int8",
                      input_shape=model.input_shape).eval()


_QUANT_TYPES = (QuantConv2DLayer, QuantDenseLayer,
                QuantMultiHeadAttentionLayer)
_FLOAT_TYPES = (Conv2DLayer, DenseLayer, MultiHeadAttentionLayer)


def is_int8(model: nn.Module) -> bool:
    """True when every conv, dense and attention layer of ``model`` is an
    int8 twin (at least one): every conv and GEMM of the graph is then an
    exact integer sum, so no sample's result depends on how many rows
    share its batch."""
    mods = list(model.modules())
    return (any(isinstance(m, _QUANT_TYPES) for m in mods)
            and not any(isinstance(m, _FLOAT_TYPES) for m in mods))
