"""Device selection and the device registry (counterpart of
``dcnn_tpu/core/device.py``).

The port's entry points run on the GPU unless the caller asks for the CPU.
Asking for CUDA on a machine without one is an error, never a silent move
to the CPU. So :meth:`DeviceManager.default` and :func:`default_device` are
the first CUDA device and raise without one, where the JAX package falls
back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_NO_CUDA = ("CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises ``RuntimeError`` when CUDA is asked
    for and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclass(frozen=True)
class DeviceInfo:
    """One device the registry found."""

    id: str           # "CUDA:0", "CPU:0"
    platform: str     # "cuda" | "cpu"
    index: int
    device: torch.device

    @property
    def is_accelerator(self) -> bool:
        return self.platform != "cpu"


class DeviceManager:
    """Process-wide device registry: every visible CUDA device, then the
    host CPU as ``CPU:0``. Placement is ``tensor.to(info.device)``; there
    is no allocation API."""

    _instance: Optional["DeviceManager"] = None

    def __init__(self) -> None:
        self._devices: List[DeviceInfo] = [
            DeviceInfo(f"CUDA:{i}", "cuda", i, torch.device("cuda", i))
            for i in range(device_count())]
        self._devices.append(DeviceInfo("CPU:0", "cpu", 0,
                                        torch.device("cpu")))

    @classmethod
    def instance(cls) -> "DeviceManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def all(self) -> List[DeviceInfo]:
        return list(self._devices)

    def accelerators(self) -> List[DeviceInfo]:
        return [d for d in self._devices if d.is_accelerator]

    def cpu(self, index: int = 0) -> DeviceInfo:
        cpus = [d for d in self._devices if d.platform == "cpu"]
        return cpus[index]

    def get(self, device_id: str) -> DeviceInfo:
        for d in self._devices:
            if d.id == device_id:
                return d
        raise KeyError(f"unknown device id {device_id!r}")

    def default(self) -> DeviceInfo:
        """The first CUDA device; ``RuntimeError`` without one."""
        accs = self.accelerators()
        if not accs:
            raise RuntimeError(_NO_CUDA)
        return accs[0]


def local_devices() -> List[torch.device]:
    """The CUDA devices of this process (none without a card)."""
    return [torch.device("cuda", i) for i in range(device_count())]


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    """The first CUDA device; ``RuntimeError`` without one."""
    return DeviceManager.instance().default().device
