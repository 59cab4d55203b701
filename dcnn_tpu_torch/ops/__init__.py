from .activations import ACTIVATIONS
from .attention import (
    attention, blockwise_attention, flash_attention, flash_forward_reference,
)

__all__ = ["ACTIVATIONS", "attention", "blockwise_attention",
           "flash_attention", "flash_forward_reference"]
