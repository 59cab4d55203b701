from .config import ProfilerType, TrainingConfig
from .device import resolve_device
from .fence import hard_fence
from .precision import (
    cast_to_compute, get_compute_dtype, get_precision_mode, set_precision,
)

__all__ = ["ProfilerType", "TrainingConfig", "hard_fence", "resolve_device",
           "cast_to_compute", "get_compute_dtype", "get_precision_mode",
           "set_precision"]
