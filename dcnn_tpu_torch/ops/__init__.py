from . import elementwise, quant
from .activations import ACTIVATIONS
from .attention import (
    attention, blockwise_attention, flash_attention, flash_backward_reference,
    flash_forward_reference,
)
from .losses import (
    LOSSES, cross_entropy, huber_loss, log_softmax_cross_entropy, mae_loss,
    mse_loss, softmax_cross_entropy,
)
from .metrics import accuracy, correct_count

__all__ = ["elementwise", "quant", "ACTIVATIONS", "attention", "blockwise_attention",
           "flash_attention", "flash_backward_reference",
           "flash_forward_reference",
           "cross_entropy", "softmax_cross_entropy",
           "log_softmax_cross_entropy", "mse_loss", "mae_loss", "huber_loss",
           "LOSSES", "accuracy", "correct_count"]
