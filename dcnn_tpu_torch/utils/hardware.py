"""Hardware introspection (counterpart of ``dcnn_tpu/utils/hardware.py``):
host CPU and memory from ``/proc``, the process's RSS, and the CUDA cards
torch sees with their memory (``torch.cuda.mem_get_info``). The keys are
the JAX package's; ``default_backend`` is ``"cuda"`` or ``"cpu"``."""

from __future__ import annotations

import os
import platform
from typing import Any, Dict, List


def _proc_meminfo() -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        with open("/proc/meminfo", "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0].endswith(":"):
                    out[parts[0][:-1]] = int(parts[1])  # kB
    except OSError:
        pass
    return out


def get_memory_usage_kb() -> int:
    """Process RSS in kB (0 where ``/proc/self/status`` is missing)."""
    try:
        with open("/proc/self/status", "r", encoding="utf-8") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def _devices() -> List[Dict[str, Any]]:
    import torch

    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": platform.processor()
                 or platform.machine()}]
    out: List[Dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        info: Dict[str, Any] = {"id": i, "platform": "cuda",
                                "kind": torch.cuda.get_device_name(i)}
        try:
            free, total = torch.cuda.mem_get_info(i)
            info["hbm_bytes_limit"] = total
            info["hbm_bytes_in_use"] = total - free
        except RuntimeError:
            pass
        out.append(info)
    return out


class HardwareInfo:
    @staticmethod
    def collect() -> Dict[str, Any]:
        import torch

        mem = _proc_meminfo()
        return {
            "host": {
                "machine": platform.machine(),
                "system": platform.system(),
                "cpu_count": os.cpu_count(),
                "ram_total_kb": mem.get("MemTotal", 0),
                "ram_available_kb": mem.get("MemAvailable", 0),
                "process_rss_kb": get_memory_usage_kb(),
            },
            "devices": _devices(),
            "default_backend": "cuda" if torch.cuda.is_available() else "cpu",
        }

    @staticmethod
    def print_info() -> None:
        info = HardwareInfo.collect()
        h = info["host"]
        print(f"Host: {h['system']}/{h['machine']}, {h['cpu_count']} CPUs, "
              f"RAM {h['ram_total_kb'] / 1048576:.1f} GiB "
              f"(avail {h['ram_available_kb'] / 1048576:.1f} GiB), "
              f"RSS {h['process_rss_kb'] / 1024:.0f} MiB")
        print(f"Backend: {info['default_backend']}")
        for d in info["devices"]:
            line = f"  device {d['platform']}:{d['id']} ({d['kind']})"
            if d.get("hbm_bytes_limit"):
                used = (d.get("hbm_bytes_in_use") or 0) / 2**30
                lim = d["hbm_bytes_limit"] / 2**30
                line += f" HBM {used:.2f}/{lim:.1f} GiB"
            print(line)
