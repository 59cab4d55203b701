"""Device times of the port's kernels at a few fixed shapes, for comparing
two checkouts on one card in one call.

    python3 -m dcnn_tpu_torch.ops.kernel_times [ROOT] [TAG]

imports ``dcnn_tpu_torch`` from the checkout at ROOT (default: the one this
file is in), builds its kernels and prints one line tagged TAG: the 3×3
conv, BN-prologue conv and (Cout ≤ 64) pairs conv at the JAX conv bench's
shapes (bf16, B=256) and ResNet-18 sites (B=32), and the flash forward,
dQ and dK/dV kernels at the shapes of ``chip_smoke.py``'s FLASH_CASES. Each
time is the mean of a CUDA graph of calls, between CUDA events; the pairs
conv's fused weights are made before the timed calls. Run parent, change,
change, parent in one call: two calls may land on two cards.

Exits 1 without a GPU.
"""

from __future__ import annotations

import os
import sys

CONVS = [  # N, H, W, Cin, Cout, dtype name, calls a graph
    (256, 64, 64, 64, 64, "bfloat16", 5), (256, 32, 32, 128, 128, "bfloat16", 5),
    (256, 8, 8, 512, 512, "bfloat16", 5), (32, 32, 32, 64, 64, "float32", 20),
    (32, 16, 16, 128, 128, "float32", 20), (32, 4, 4, 512, 512, "float32", 20),
    (32, 32, 32, 64, 64, "bfloat16", 20)]
FLASH = [  # B, H, Sq, Sk, D, dtype name, causal, calls a graph: chip_smoke.py's FLASH_CASES
    (4, 8, 4096, 4096, 64, "bfloat16", True, 5), (32, 4, 32, 32, 16, "float32", False, 50),
    (2, 4, 1000, 1000, 64, "float32", True, 50), (2, 3, 77, 300, 128, "float32", True, 50),
    (1, 2, 200, 10, 32, "float32", True, 50), (1, 2, 100, 165, 32, "float32", True, 50),
    (1, 2, 300, 429, 64, "bfloat16", True, 50), (1, 2, 300, 365, 64, "float32", True, 50),
    (1, 2, 100, 133, 128, "float32", True, 50)]


def graph_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else here
    tag = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("dcnn_tpu_torch")]:
        del sys.modules[name]  # the package of ROOT, not of this file
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a GPU", file=sys.stderr)
        sys.exit(1)
    from dcnn_tpu_torch.core import set_precision
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.pallas.conv import fuse_pair_weights

    if not _kernels.__file__.startswith(root):
        sys.exit(f"kernel_times: imported {_kernels.__file__}, not from {root}")
    set_precision("parity")
    _kernels.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for n, h, w, cin, cout, dtn, reps in CONVS:
        dt = getattr(torch, dtn)
        x = torch.randn(n, h, w, cin, device="cuda", generator=gen).to(dt)
        wt = (torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
              * 0.05).to(dt)
        sc = torch.rand(cin, device="cuda", generator=gen) + 0.5
        sh = torch.randn(cin, device="cuda", generator=gen) * 0.1
        conv = graph_ms(lambda: _kernels.conv3x3_s1(x, wt, out_dtype=dt), reps)
        bn = graph_ms(lambda: _kernels.conv3x3_s1_bnrelu_in(
            x, wt, sc, sh, out_dtype=dt), reps)
        line = (f"{n}x{h}x{w}x{cin}->{cout} {dtn} conv {conv:.6f} "
                f"bn-in {bn:.6f}")
        if cout <= 64:
            w2 = fuse_pair_weights(wt)
            pairs = graph_ms(lambda: _kernels.conv3x3_s1_pairs(
                x, w2, out_dtype=dt), reps)
            line += f" pairs {pairs:.6f}"
        out.append(line)
    for b, h, sq, sk, d, dtn, causal, reps in FLASH:
        dt = getattr(torch, dtn)
        q, k, v, g = (torch.randn(b, h, s, d, device="cuda",
                                  generator=gen).to(dt) for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        ms = graph_ms(lambda: _kernels.flash_fwd(q, k, v, causal=causal,
                                                 scale=scale), reps)
        o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale)
        delta = (g.float() * o.float()).sum(-1)
        dq = graph_ms(lambda: _kernels.flash_bwd_dq(
            q, k, v, g, lse, delta, causal=causal, scale=scale), reps)
        dkv = graph_ms(lambda: _kernels.flash_bwd_dkv(
            q, k, v, g, lse, delta, causal=causal, scale=scale), reps)
        out.append(f"flash B{b} H{h} Sq{sq} Sk{sk} D{d} {dtn} causal={causal} {ms:.6f}"
                   f" dq {dq:.6f} dkv {dkv:.6f}")
    print(f"{tag} ms: " + " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
