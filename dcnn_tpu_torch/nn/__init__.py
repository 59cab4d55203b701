from .attention_layer import MultiHeadAttentionLayer
from .builder import SequentialBuilder
from .export import InferenceProgram, export_inference, load_inference
from .factory import layer_from_config, register_layer
from .fold import fold_batchnorm
from .layer import Layer, ParameterizedLayer, StatelessLayer
from .layers import (
    ActivationLayer, AvgPool2DLayer, BatchNormLayer, Conv2DLayer, DenseLayer,
    DropoutLayer, FlattenLayer, GroupNormLayer, LogSoftmaxLayer, MaxPool2DLayer,
)
from .quantize import (
    QuantConv2DLayer, QuantDenseLayer, QuantMultiHeadAttentionLayer,
    is_int8, quantize_model,
)
from .residual import ResidualBlock
from .sequential import Sequential

__all__ = ["MultiHeadAttentionLayer", "SequentialBuilder", "layer_from_config",
           "InferenceProgram", "export_inference", "load_inference",
           "register_layer", "fold_batchnorm", "Layer", "ParameterizedLayer",
           "StatelessLayer", "ActivationLayer", "AvgPool2DLayer",
           "BatchNormLayer", "Conv2DLayer", "DenseLayer", "DropoutLayer",
           "FlattenLayer",
           "GroupNormLayer", "LogSoftmaxLayer", "MaxPool2DLayer",
           "QuantConv2DLayer", "QuantDenseLayer",
           "QuantMultiHeadAttentionLayer", "is_int8", "quantize_model",
           "ResidualBlock", "Sequential"]
