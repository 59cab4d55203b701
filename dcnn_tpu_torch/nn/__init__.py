from .attention_layer import MultiHeadAttentionLayer
from .builder import SequentialBuilder
from .factory import layer_from_config, register_layer
from .layer import Layer, ParameterizedLayer, StatelessLayer
from .layers import ActivationLayer, DenseLayer, FlattenLayer
from .residual import ResidualBlock
from .sequential import Sequential

__all__ = ["MultiHeadAttentionLayer", "SequentialBuilder", "layer_from_config",
           "register_layer", "Layer", "ParameterizedLayer", "StatelessLayer",
           "ActivationLayer", "DenseLayer", "FlattenLayer", "ResidualBlock",
           "Sequential"]
