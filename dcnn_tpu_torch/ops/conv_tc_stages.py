"""Where the time of ``csrc/conv3x3_tc.cu`` goes, by stage, and where its
register spills sit.

    python3 -m dcnn_tpu_torch.ops.conv_tc_stages   # on a machine with an H100

Stage counts: launches the diagnostic build :data:`_kernels.CONV_TC_TRACE`
(the source built with ``-DCONV_TC_TRACE``: clock64 counters for one
thread of each role, see ``struct Clock`` in the source) through
:func:`_kernels._launch_conv`, runs each case twice and prints the mean SM
clock cycles per work item (one output tile and one K range) over the
first 132 blocks: the multiplying warps waiting for a halo tile
(``wait_halo``) or a weight stage (``wait_w``), issuing and finishing their
products (``mma``), loading A (``load_a``, which includes ``wait_halo``),
the epilogue, the whole loop (``total``); the BN prologue's warps waiting
for (or, by cp.async, making) a copy (``pro_wait``) and applying it
(``prologue``). The pairs form (``pairs``) runs the same counters over its
12-tap units. The counters cost a few percent of the kernel's time. The
public wrappers never launch that build.

Spills: disassembles the library the wrappers launch (``cuobjdump -sass``)
and, for each instantiation of ``conv_tc_kernel``, counts its local-memory
stores and loads (``STL``, ``LDL``) by where they sit in its control-flow
graph: in the unit loop (the innermost loop holding tensor-core products,
``HGMMA``), or elsewhere in the code of the copying warpgroup (after
``setmaxnreg.dec``) or of the multiplying ones (after ``setmaxnreg.inc``).

Exits 1 without a GPU.
"""

from __future__ import annotations

import bisect
import re
import shutil
import subprocess
import sys

NAMES = ("wait_halo", "wait_w", "mma", "epilogue", "total", "pro_wait",
         "prologue", "load_a")
CASES = [  # kind, (N, H, W, Cin, Cout), dtype name
    ("conv", (256, 64, 64, 64, 64), "bfloat16"),
    ("bn", (256, 64, 64, 64, 64), "bfloat16"),
    ("conv", (256, 32, 32, 128, 128), "bfloat16"),
    ("conv", (256, 8, 8, 512, 512), "bfloat16"),
    ("bn", (256, 8, 8, 512, 512), "bfloat16"),
    ("conv", (32, 64, 64, 3, 32), "bfloat16"),
    ("conv", (32, 4, 4, 512, 512), "bfloat16"),
    ("conv", (32, 32, 32, 64, 64), "float32"),
    ("conv", (32, 4, 4, 512, 512), "float32"),
    # the pairs form (fused weights, 12 taps): the bench shape and layer1
    ("pairs", (256, 64, 64, 64, 64), "bfloat16"),
    ("pairs", (32, 32, 32, 64, 64), "bfloat16"),
    ("pairs", (32, 32, 32, 64, 64), "float32"),
]


def stage_counts() -> None:
    import numpy as np
    import torch

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.pallas.conv import fuse_pair_weights

    lib = _kernels.build(extra=(_kernels.CONV_TC_TRACE,))[
        _kernels.CONV_TC_TRACE]
    counts = np.zeros((1024, 8), dtype=np.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _kernels._card_sms(torch.device("cuda"))
    for kind, (n, h, w, cin, cout), dtn in CASES:
        dt = getattr(torch, dtn)
        x = torch.randn(n, h, w, cin, device="cuda", generator=gen).to(dt)
        wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
              * 0.05).to(dt)
        sc = torch.rand(cin, device="cuda", generator=gen) + 0.5
        sh = torch.randn(cin, device="cuda", generator=gen) * 0.1
        bn, pairs = kind == "bn", kind == "pairs"
        if pairs:
            wt = fuse_pair_weights(wt)
        for _ in range(2):  # the second run's counts
            lib.dcnn_conv3x3_tc_trace(counts.ctypes.data)
            _kernels._launch_conv("conv_tc_stages", x, wt, sc if bn else None,
                                  sh if bn else None, dt,
                                  lib_name=_kernels.CONV_TC_TRACE,
                                  pairs=pairs)
            torch.cuda.synchronize()
        lib.dcnn_conv3x3_tc_trace(counts.ctypes.data)
        plan = _kernels.conv_plan(n, h, w, cin, cout, dt, sms, prologue=bn,
                                  pairs=pairs)
        works = plan.tiles_m * plan.tiles_n * plan.ksplit
        per = counts[:min(sms, works)].mean(0) / max(1.0, works / sms)
        print(f"{kind} {(n, h, w, cin, cout)} {dtn} [{plan.describe()}]: "
              f"cycles per work item "
              + ", ".join(f"{k}={v:.0f}" for k, v in zip(NAMES, per)),
              flush=True)


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"(0x[0-9a-f]+)\s*$")


def _functions(sass: str):
    """{function name: [(address, instruction)]} of cuobjdump's output."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
        elif cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(insn: str) -> str:
    parts = insn.split()
    return parts[1] if parts[0].startswith("@") and len(parts) > 1 else parts[0]


def _cfg(insns):
    """Basic blocks of one function: (starts, {block: successors}), blocks
    indexed by their first instruction."""
    at = {a: k for k, (a, _) in enumerate(insns)}
    starts = {0}
    for k, (a, i) in enumerate(insns):
        op = _opcode(i).split(".")[0]
        if op in ("BRA", "EXIT", "RET", "BRX", "JMX", "JMP"):
            starts.add(k + 1)
            m = _TARGET.search(i)
            if op == "BRA" and m and int(m.group(1), 16) in at:
                starts.add(at[int(m.group(1), 16)])
    starts = sorted(s for s in starts if s < len(insns))
    succ = {}
    for b, s0 in enumerate(starts):
        s1 = starts[b + 1] if b + 1 < len(starts) else len(insns)
        last = insns[s1 - 1][1]
        op = _opcode(last).split(".")[0]
        always = not last.startswith("@") or last.startswith("@PT ")
        out = set()
        m = _TARGET.search(last)
        if op == "BRA" and m and int(m.group(1), 16) in at:
            out.add(starts.index(at[int(m.group(1), 16)]))
        if not (always and op in ("BRA", "EXIT", "RET", "BRX", "JMX", "JMP")):
            if b + 1 < len(starts):
                out.add(b + 1)
        succ[b] = out
    return starts, succ


def _reach(succ, roots):
    seen, todo = set(roots), list(roots)
    while todo:
        for n in succ[todo.pop()]:
            if n not in seen:
                seen.add(n)
                todo.append(n)
    return seen


def _innermost_loop(succ, marked):
    """The smallest natural loop (a back edge to a block that dominates its
    source, with every block reaching the source without passing the
    head) that holds a block of ``marked``; None where there is none."""
    nodes = sorted(_reach(succ, [0]))
    pred = {n: set() for n in nodes}
    for n in nodes:
        for m in succ[n]:
            pred[m].add(n)
    dom = {n: set(nodes) for n in nodes}
    dom[0] = {0}
    changed = True
    while changed:
        changed = False
        for n in nodes[1:]:
            new = set.intersection(*(dom[p] for p in pred[n])) | {n} \
                if pred[n] else {n}
            if new != dom[n]:
                dom[n], changed = new, True
    best = None
    for n in nodes:
        for h in succ[n]:
            if h in dom[n]:  # a back edge n -> h
                body, todo = {h, n}, [n] if n != h else []
                while todo:
                    for p in pred[todo.pop()]:
                        if p not in body:
                            body.add(p)
                            todo.append(p)
                if body & marked and (best is None or len(body) < len(best)):
                    best = body
    return best


def spills() -> None:
    """Where each instantiation's local-memory stores and loads sit: in the
    code after ``setmaxnreg.dec`` (the copying warpgroup, 40 registers) or
    after ``setmaxnreg.inc`` (the multiplying warpgroups), and how many in
    the unit loop (the innermost loop that holds an ``HGMMA``)."""
    from dcnn_tpu_torch.ops import _kernels

    _kernels.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_kernels._lib_path(
        "conv3x3_tc.cu"))], capture_output=True, text=True, check=True).stdout
    funcs = _functions(sass)
    names = list(funcs)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True
                               ).stdout.splitlines()
    for insns, name in zip(funcs.values(), names):
        if "conv_tc_kernel" not in name or not insns:
            continue
        starts, succ = _cfg(insns)

        def block(k):
            return bisect.bisect_right(starts, k) - 1

        def blocks_of(pattern):
            return {block(k) for k, (_, i) in enumerate(insns)
                    if re.search(pattern, i)}

        copying = _reach(succ, blocks_of(r"USETMAXREG\.DEALLOC"))
        multiplying = _reach(succ, blocks_of(r"USETMAXREG\.TRY_?ALLOC"))
        loop = _innermost_loop(succ, blocks_of(r"\bHGMMA\b")) or set()
        count = {"STL": {}, "LDL": {}}
        for k, (a, i) in enumerate(insns):
            op = _opcode(i).split(".")[0]
            if op not in count:
                continue
            b = block(k)
            where = ("unit loop" if b in loop else
                     "copying" if b in copying and b not in multiplying else
                     "multiplying" if b in multiplying and b not in copying
                     else "shared or before setmaxnreg")
            count[op][where] = count[op].get(where, 0) + 1
        print(f"spills {name}: {len(insns)} instructions, unit loop of "
              f"{len(loop)} blocks; STL {count['STL']}, LDL {count['LDL']}",
              flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("conv_tc_stages: needs a GPU", file=sys.stderr)
        sys.exit(1)
    from dcnn_tpu_torch.core import set_precision

    set_precision("parity")
    stage_counts()
    spills()


if __name__ == "__main__":
    main()
