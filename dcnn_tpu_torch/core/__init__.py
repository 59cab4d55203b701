from .device import resolve_device
from .precision import (
    cast_to_compute, get_compute_dtype, get_precision_mode, set_precision,
)

__all__ = ["resolve_device", "cast_to_compute", "get_compute_dtype",
           "get_precision_mode", "set_precision"]
