from . import elementwise, quant
from .activations import (
    ACTIVATIONS, apply_activation, elu, leaky_relu, linear, relu, sigmoid,
    softmax, tanh,
)
from .attention import (
    attention, blockwise_attention, flash_attention, flash_backward_reference,
    flash_forward_reference,
)
from .conv import conv2d, conv2d_input_grad, conv2d_int8, conv2d_weight_grad
from .losses import (
    LOSSES, cross_entropy, huber_loss, log_softmax_cross_entropy, mae_loss,
    mse_loss, softmax_cross_entropy,
)
from .metrics import accuracy, correct_count
from .norm import batch_norm, group_norm
from .pool import avg_pool2d, max_pool2d

__all__ = ["elementwise", "quant",
           "relu", "leaky_relu", "elu", "sigmoid", "tanh", "softmax", "linear",
           "ACTIVATIONS", "apply_activation",
           "conv2d", "conv2d_input_grad", "conv2d_int8", "conv2d_weight_grad",
           "max_pool2d", "avg_pool2d", "batch_norm", "group_norm",
           "attention", "blockwise_attention",
           "flash_attention", "flash_backward_reference",
           "flash_forward_reference",
           "cross_entropy", "softmax_cross_entropy",
           "log_softmax_cross_entropy", "mse_loss", "mae_loss", "huber_loss",
           "LOSSES", "accuracy", "correct_count"]
