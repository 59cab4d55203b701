"""Card-vs-host op comparison (counterpart of
``examples/backend_comparison.py``): the same matmul and
``ops.conv.conv2d`` case on the default device (the card) and on the host
CPU, timed with ``common.time_callable`` and checked against each other.

    python -m dcnn_tpu_torch.examples.backend_comparison            # card vs CPU
    DEVICE_TYPE=cpu python -m dcnn_tpu_torch.examples.backend_comparison   # CPU only

Env: SIZE (the matmul's side, default 1024), DEVICE_TYPE.
"""

import os

import numpy as np
import torch

from ..ops import conv as conv_ops
from .common import env_device, time_callable


def main() -> dict:
    default_dev = env_device()
    rng = np.random.default_rng(0)
    devices = {default_dev.type: default_dev}
    if default_dev.type != "cpu":
        devices["cpu"] = torch.device("cpu")

    m = int(os.environ.get("SIZE", "1024"))
    a = rng.standard_normal((m, m), np.float32)
    b = rng.standard_normal((m, m), np.float32)
    x = rng.standard_normal((8, 64, 32, 32), np.float32)
    w = (rng.standard_normal((64, 64, 3, 3), np.float32) / 24.0)

    cases = {
        f"matmul_{m}x{m}": (lambda aa, bb: aa @ bb, (a, b), 2.0 * m ** 3),
        "conv_64x32x32": (lambda xx, ww: conv_ops.conv2d(
            xx, ww, stride=1, padding=1), (x, w),
            2.0 * 8 * 64 * 64 * 9 * 32 * 32),
    }

    print(f"{'case':<18} " + "".join(f"{n:>14}" for n in devices)
          + "   agreement")
    rows = {}
    with torch.inference_mode():
        for cname, (fn, args, flops) in cases.items():
            outs, cols, rates = {}, [], {}
            for dname, dev in devices.items():
                dargs = tuple(torch.from_numpy(v).to(dev) for v in args)
                outs[dname] = fn(*dargs).cpu().numpy()
                dt = time_callable(lambda f=fn, d=dargs: f(*d), steps=5)
                rates[dname] = flops / dt / 1e9
                cols.append(f"{rates[dname]:>11.1f} GF")
            vals = list(outs.values())
            err = (np.max(np.abs(vals[0] - vals[-1]))
                   / max(1.0, np.max(np.abs(vals[-1]))))
            print(f"{cname:<18} " + "".join(f"{c:>14}" for c in cols)
                  + f"   max rel err {err:.2e}")
            rows[cname] = {"gflops": rates, "max_rel_err": float(err)}
    return rows


if __name__ == "__main__":
    main()
