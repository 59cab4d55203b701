"""Where the time of ``csrc/flash_fwd.cu`` goes, by phase of its steady
passes.

    python3 -m dcnn_tpu_torch.ops.flash_stages   # on a machine with an H100

Launches the diagnostic build :data:`_kernels.FLASH_TRACE` (the source built
with ``-DFLASH_TRACE``: clock64 counters for one thread of each multiplying
warpgroup, see ``struct PassClock`` in the source) through
:func:`_kernels._launch_flash`, runs each case twice and prints the mean SM
clock cycles per steady pass (one kv tile: S of this tile and P·V of the
previous one issued, the softmax between) of each warpgroup: waiting for
the tile (``wait_tile``), for its turn to issue (``wait_turn``), issuing
(``issue``), waiting for S (``wait_s``), the softmax, waiting for P·V
(``wait_pv``), and O's rescale with P's conversion (``to_operand``). The
counters cost a few percent of the kernel's time. The public wrapper never
launches that build.

Exits 1 without a GPU.
"""

from __future__ import annotations

import sys

NAMES = ("wait_tile", "wait_turn", "issue", "wait_s", "softmax", "wait_pv",
         "to_operand")
CASES = [  # B, H, Sq, Sk, D, causal, dtype name
    (4, 8, 4096, 4096, 64, True, "bfloat16"),   # chip_smoke.py's long context
    (4, 8, 4096, 4096, 128, True, "bfloat16"),
    (2, 4, 1000, 1000, 64, True, "float32"),    # its causal ragged case
]


def stage_counts() -> None:
    import numpy as np
    import torch

    from dcnn_tpu_torch.ops import _kernels

    lib = _kernels.build(extra=(_kernels.FLASH_TRACE,))[_kernels.FLASH_TRACE]
    counts = np.zeros((2, 8), dtype=np.uint64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, sq, sk, d, causal, dtn in CASES:
        dt = getattr(torch, dtn)
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)
                   for s in (sq, sk, sk))
        for _ in range(2):  # the second run's counts
            lib.dcnn_flash_fwd_trace(counts.ctypes.data)
            _kernels._launch_flash(q, k, v, causal, d ** -0.5,
                                   lib_name=_kernels.FLASH_TRACE)
            torch.cuda.synchronize()
        lib.dcnn_flash_fwd_trace(counts.ctypes.data)
        plan = _kernels.flash_plan(sq, sk, d, dt)
        for wg in range(plan.q_rows // 64):
            c = counts[wg].astype(np.float64)
            passes = max(c[7], 1.0)
            print(f"flash_fwd B={b} H={h} Sq={sq} Sk={sk} D={d} causal={causal}"
                  f" {dtn} [{plan}] warpgroup {wg}: cycles per steady pass "
                  + ", ".join(f"{n}={x / passes:.0f}" for n, x in zip(NAMES, c))
                  + f" over {passes:.0f} passes", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("flash_stages: needs a GPU", file=sys.stderr)
        sys.exit(1)
    stage_counts()


if __name__ == "__main__":
    main()
