"""Where the time of ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` goes,
by phase of their steady passes.

    python3 -m dcnn_tpu_torch.ops.flash_stages   # on a machine with an H100

Launches the diagnostic build :data:`_kernels.FLASH_TRACE` (the source built
with ``-DFLASH_TRACE``: clock64 counters for one thread of each multiplying
warpgroup, see ``struct PassClock`` in ``csrc/flash.cuh``) through
:func:`_kernels._launch_flash`, runs each case twice and prints the mean SM
clock cycles per steady pass (one kv tile: S of this tile and P·V of the
previous one issued, the softmax between) of each warpgroup: waiting for
the tile (``wait_tile``), for its turn to issue (``wait_turn``), issuing
(``issue``), waiting for S (``wait_s``), the softmax, waiting for P·V
(``wait_pv``), and O's rescale with P's conversion (``to_operand``). The
counters cost a few percent of the kernel's time. The public wrapper never
launches that build.

Then the same for the backward's diagnostic build
:data:`_kernels.FLASH_BWD_TRACE` (``-DFLASH_BWD_TRACE``), launched through
:func:`_kernels._launch_flash_bwd`: per live pass of the dQ and the dK/dV
kernel (one streamed tile), waiting for the tile, issuing (S and dP; then
dQ, or dV and dK), waiting for S and dP (``wait_sdp``), building P, dS and
their A operands (``p_ds``), waiting for the accumulating products
(``wait_acc``) and the release.

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


BWD_NAMES = ("wait_tile", "issue", "wait_sdp", "p_ds", "wait_acc",
             "release")


def bwd_stage_counts() -> None:
    import numpy as np
    import torch

    from dcnn_tpu_torch.ops import _kernels

    name = _kernels.FLASH_BWD_TRACE
    lib = _kernels.build(extra=(name,))[name]
    counts = np.zeros((2, 2, 8), dtype=np.uint64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, sq, sk, d, causal, dtn in CASES + [(32, 4, 32, 32, 16, False,
                                                  "float32")]:
        dt = getattr(torch, dtn)
        q, k, v, g = (torch.randn(b, h, s, d, device="cuda",
                                  generator=gen).to(dt) for s in (sq, sk, sk, sq))
        o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
        delta = (g.float() * o.float()).sum(-1)
        plan = _kernels.flash_bwd_plan(sq, sk, d, dt)
        for kern, fn, outs in ((0, "flash_bwd_dq", (torch.empty_like(q),)),
                               (1, "flash_bwd_dkv", (torch.empty_like(k),
                                                     torch.empty_like(v)))):
            for _ in range(2):  # the second run's counts
                lib.dcnn_flash_bwd_trace(counts.ctypes.data)
                _kernels._launch_flash_bwd(fn, q, k, v, g, lse, delta, outs,
                                           causal, d ** -0.5, lib_name=name)
                torch.cuda.synchronize()
            lib.dcnn_flash_bwd_trace(counts.ctypes.data)
            part = plan.dq if kern == 0 else plan.dkv
            for wg in range(part.rows // 64):
                c = counts[kern, wg].astype(np.float64)
                passes = max(c[7], 1.0)
                print(f"{fn} B={b} H={h} Sq={sq} Sk={sk} D={d} causal={causal}"
                      f" {dtn} [{part}] warpgroup {wg}: cycles per live pass "
                      + ", ".join(f"{n}={x / passes:.0f}"
                                  for n, x in zip(BWD_NAMES, c))
                      + f" over {passes:.0f} passes", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("flash_stages: needs a GPU", file=sys.stderr)
        sys.exit(1)
    stage_counts()
    bwd_stage_counts()


if __name__ == "__main__":
    main()
