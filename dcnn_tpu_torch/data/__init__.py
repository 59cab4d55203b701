"""Host data loading and the uint8 wire decode (counterpart of
``dcnn_tpu/data``; this slice ports the array loader)."""

from .loader import ArrayDataLoader, BaseDataLoader, one_hot
from .wire import WIRE_SCALE_U8, decode_batch, wire_scale

__all__ = ["BaseDataLoader", "ArrayDataLoader", "one_hot",
           "WIRE_SCALE_U8", "decode_batch", "wire_scale"]
