from .config import ProfilerType, TrainingConfig
from .device import (
    DeviceInfo, DeviceManager, default_device, device_count, local_devices,
    resolve_device,
)
from .fence import hard_fence
from .mesh import make_mesh, mesh_axes
from .precision import (
    cast_to_compute, get_compute_dtype, get_precision_mode, set_precision,
)

__all__ = ["ProfilerType", "TrainingConfig", "hard_fence", "make_mesh",
           "mesh_axes", "resolve_device", "DeviceInfo", "DeviceManager",
           "default_device", "device_count", "local_devices",
           "cast_to_compute", "get_compute_dtype", "get_precision_mode",
           "set_precision"]
