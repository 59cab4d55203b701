"""Hardware and device dump (counterpart of
``examples/hardware_info_example.py``): the host, the devices the registry
found, the process's memory, and a small compute check on each device.

    python -m dcnn_tpu_torch.examples.hardware_info_example
"""

import torch

from ..core.device import DeviceManager
from ..utils.hardware import HardwareInfo, get_memory_usage_kb
from .common import env_device


def main() -> dict:
    env_device()
    HardwareInfo.print_info()
    print(f"\nprocess RSS: {get_memory_usage_kb() / 1024:.1f} MiB")

    dm = DeviceManager.instance()
    default = dm.default() if dm.accelerators() else dm.cpu()
    print(f"\nDeviceManager: {len(dm.all())} device(s); "
          f"default = {default.id}")
    checks = {}
    for info in dm.all():
        y = torch.arange(8.0, device=info.device) * 2.0
        checks[info.id] = float(y.sum()) == 56.0
        print(f"  {info.id} ({info.platform}): compute check "
              f"{'OK' if checks[info.id] else 'FAILED'}")
    if not all(checks.values()):
        raise SystemExit(f"compute check failed: {checks}")
    return checks


if __name__ == "__main__":
    main()
