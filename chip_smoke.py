#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dcnn_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile every CUDA kernel from ``dcnn_tpu_torch/ops/csrc`` with
   ``nvcc -Xptxas -v`` (registers, shared memory and spills are printed);
3. flash kernels: hold each kernel (the flash forward, the dQ and the dK/dV
   backward kernels) against its plain PyTorch version on the card at the
   model's shape and at harder ones, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and the card's bound for the work;
   each case prints its plan (flash_plan, flash_bwd_plan), and the
   long-context backward is also replayed from a CUDA graph; the cases
   include head-dim class 256 (B2 H8 S2048 D256 bf16 causal timed against
   SDPA and its bound; fp32 and bf16, causal and not, a ragged D) and the
   sliced kernels: the fp32 backward at D 192 and 256, and D 320, 512 and
   1000 in both types, causal and not (B2 H8 S2048 D512 bf16 causal timed
   against SDPA and its bound);
4. conv kernels: the same for the 3x3 implicit-GEMM convs (plain, BN
   prologue and output-column pairs, all on the tensor cores) and the
   fused scale/bias/ReLU, at the shapes of
   ``benchmarks/bench_pallas_conv.py::_shapes`` (bf16, B=256) and at ragged
   shapes (fp32 and bf16); the library call is ``F.conv2d``; each conv
   case prints its plan (tile, Cout tile, K split, how the halo is
   staged);
5. model sites: one B=32 batch through the unfolded NHWC
   ``resnet18_tiny_imagenet`` on CUDA; at every 3x3 stride-1 conv (the
   pairs kernel: those in layer1), every BN -> ReLU and every bn0 ->
   relu0 -> conv1 chain the four kernels (through their public functions)
   are held to the model's own tensors, the launch counters show one
   launch per site, and every site is timed in fp32 and bf16 (then the
   sums per kernel and type); at the last layer4 site the tensor-core
   kernels are also timed as eager calls, beside their graph time;
6. serve: build ``mha_classifier`` at its full width (S=32, E=64, 4 heads)
   from JAX-layout numpy weights made from a seed, through
   ``interop.from_jax``; serve threaded single and small-batch requests
   through ``DynamicBatcher`` over ``InferenceEngine`` on CUDA; check every
   answer against the same model on the CPU (plain path), and check from
   the launch counters that the serving path ran the forward kernel;
7. train: the same model and weights, trained for 2 epochs (16 Adam steps)
   on a synthetic marker task through ``Trainer.fit`` on CUDA and on the
   CPU; the CUDA run checkpoints every epoch, is crashed by a FaultPlan in
   epoch 2 and resumed with ``resume="auto"``; check that the loss falls,
   that every epoch's loss and the final params track the CPU run, and
   from the launch counters that every resumed step ran the forward, dQ
   and dK/dV kernels twice each;
8. serve cnn: full-width ``resnet18_tiny_imagenet`` (NHWC, random BN
   statistics) served through ``DynamicBatcher`` over
   ``InferenceEngine.from_model(..., fold=True)`` on CUDA, every answer held
   to the unfolded model on the CPU (relative to the logit scale), in two
   rounds on a dispatcher that warmed its buckets and a control round on
   one that did not;
9. train cnn: ``train_classification_model`` on full-width
   ``resnet18_tiny_imagenet`` (NCHW) with the Tiny-ImageNet trainer's
   recipe (AdamW under WarmupCosineAnnealing, softmax cross-entropy, B=32,
   the synthetic loader with ``random_crop(4).horizontal_flip(0.5)``), 8
   steps on CUDA and on the CPU from the same weights: per-step losses,
   final params and BN running statistics against the CPU run; prints the
   warm steps' train samples/s and the top device ops of one profiled
   step;
10. checkpoint: the same recipe on full-width ``resnet18_tiny_imagenet``
   with ``checkpoint_dir`` (async saves every epoch) and a best-val
   ``snapshot_dir``: the newest checkpoint restored onto the card equals
   the arrays at save time bit for bit; a run crashed by a FaultPlan in
   epoch 3 and resumed with ``resume="auto"`` tracks the uninterrupted
   one; the cost of an async and a blocking save, the bytes and the
   restore time; ``InferenceEngine.from_checkpoint`` of the best-val
   snapshot serves 32 requests through DynamicBatcher against the CPU;
   ``model_snapshots/mnist_cnn_model`` on the card against the CPU.

Then it prints ``{"kernels": [...]}`` on a line of its own and, last,
``{"ok": true, "device": {...}}``. Times come from CUDA events around CUDA
graph replays of many calls, so host overhead is not in them.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,     # fp32 outside the tensor cores (TF32 off)
              "bfloat16": 989e12,   # bf16 tensor cores, dense
              "tfloat32": 495e12}   # TF32 tensor cores, dense
TOL = {"float32": 1e-4,  # same math, another summation order
       "bfloat16": 2e-2}  # output rounded to bf16 (8 significant bits)
# backward kernels: max |kernel - plain| over max |plain| per gradient.
# fp32: the same math summed in another order. bf16: both round dS and P
# to bf16 before their products and the result to bf16, so one-ulp
# rounding flips (2^-8 relative) of those operands and of the output add up
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_TOL = 1e-4          # logits, fp32, cuBLAS against the CPU's GEMMs
# train phase, CUDA against CPU over 16 Adam steps: per-epoch mean loss,
# relative; params whose RMS gradient (from the CPU run's Adam second
# moment) is at least GRAD_FLOOR, absolute. Below GRAD_FLOOR a gradient
# is rounding noise (the key bias gets an exactly-zero gradient in exact
# arithmetic: a per-row shift of the scores), and Adam's m/sqrt(v) turns
# noise into full-size steps of either sign; such params are held only
# to Adam's step bound, 2 * steps * lr * (1 - b1) / sqrt(1 - b2).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
GRAD_FLOOR = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    return card


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed between two CUDA events."""
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


def eager_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` in ms over ``reps`` calls issued one
    after another from the host, synchronised once at the end: where the
    host's work per call (checks, planning, allocation, the launch) takes
    longer than the kernel, this is above the graph time of device_ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def allowed_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through: the work this input needs
    (the causal diagonal is offset by sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def flash_bound(b, h, sq, sk, d, causal, dtype_name):
    """Least time the card could take: the larger of bytes moved (q, k, v
    read once; O and the fp32 logsumexp written once) over HBM bandwidth
    and the two products' FLOPs over the peak rate for the input type. An
    fp32-accurate product is fastest on this card as three TF32
    tensor-core products, so fp32 counts 3 FLOPs each at the TF32 peak (as
    conv_bound does)."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = esize * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    flops = 4 * b * h * allowed_pairs(sq, sk, causal) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / PEAK_FLOPS["tfloat32"] if dtype_name == "float32"
             else flops / PEAK_FLOPS[dtype_name])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_bwd_bound(b, h, sq, sk, d, causal, dtype_name, kernel):
    """Least time for one backward kernel: bytes (each input read once:
    q, k, v, dO, fp32 lse and delta; each output written once: dQ, or dK
    and dV) over HBM bandwidth, against FLOPs over the peak rate for the
    input type. Per allowed (q, k) pair dQ does 3 products (S, dP, dS·K),
    6·D FLOPs; dK/dV 4 (S, dP, Pᵀ·dO, dSᵀ·Q), 8·D FLOPs. fp32 counts three
    TF32 products at the TF32 peak, as flash_bound does."""
    esize = 4 if dtype_name == "float32" else 2
    rows = esize * b * h * d
    if kernel == "dq":
        nbytes = rows * (3 * sq + 2 * sk) + 8 * b * h * sq
        flops = 6 * d * b * h * allowed_pairs(sq, sk, causal)
    else:
        nbytes = rows * (2 * sq + 4 * sk) + 8 * b * h * sq
        flops = 8 * d * b * h * allowed_pairs(sq, sk, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / PEAK_FLOPS["tfloat32"] if dtype_name == "float32"
             else flops / PEAK_FLOPS[dtype_name])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


FLASH_CASES = [  # name, B, H, Sq, Sk, D, causal, dtype name, timing reps
    ("model shape", 32, 4, 32, 32, 16, False, "float32", 200),
    ("causal ragged", 2, 4, 1000, 1000, 64, True, "float32", 20),
    ("causal sq<sk", 2, 3, 77, 300, 128, True, "float32", 50),
    ("long context", 4, 8, 4096, 4096, 64, True, "bfloat16", 5),
    ("fully masked rows", 1, 2, 200, 10, 32, True, "float32", 50),
    # diagonal offset 65: the last key the first 64-row q tile may see is
    # the first key of the third kv tile, the edge of the backward
    # kernels' bands
    ("band edge", 1, 2, 100, 165, 32, True, "float32", 50),
    # offset = kv tile + 1 at the forward's tiles: the first q tile's last
    # row sees exactly the first key of a kv tile (bf16: 128 rows, 128
    # keys; fp32: 128 rows, 64 keys; fp32 at D 128: 64 rows, 32 keys)
    ("band edge, 128-key tiles", 1, 2, 300, 429, 64, True, "bfloat16", 50),
    ("band edge, 64-key tiles", 1, 2, 300, 365, 64, True, "float32", 50),
    ("band edge, 32-key tiles", 1, 2, 100, 133, 128, True, "float32", 50),
    # head-dim class 256: O's (and dK's, dV's) columns in two groups, the
    # fp32 forward in serial passes of 16-key tiles; causal and not, a
    # ragged D; the fp32 backward at 128 < D <= 256 runs the sliced kernels
    ("d256 long context", 2, 8, 2048, 2048, 256, True, "bfloat16", 5),
    ("d256 ragged", 1, 2, 200, 333, 200, False, "bfloat16", 50),
    ("d256 fp32", 1, 2, 300, 300, 256, False, "float32", 20),
    ("d256 fp32 causal", 1, 2, 150, 330, 256, True, "float32", 20),
    ("d192 fp32 causal", 1, 2, 150, 330, 192, True, "float32", 20),
    # above 256 every kernel is the sliced one: S (and dP) summed over
    # slices of 128 columns, the outputs in groups of 128; both types,
    # causal and not, one ragged shape each
    ("d512 long context", 2, 8, 2048, 2048, 512, True, "bfloat16", 3),
    ("d320 bf16", 1, 2, 300, 300, 320, False, "bfloat16", 10),
    ("d320 bf16 causal", 1, 2, 150, 330, 320, True, "bfloat16", 10),
    ("d320 fp32", 1, 2, 200, 333, 320, False, "float32", 10),
    ("d320 fp32 causal", 1, 2, 300, 300, 320, True, "float32", 10),
    ("d512 bf16", 1, 2, 200, 333, 512, False, "bfloat16", 10),
    ("d512 bf16 causal", 1, 2, 300, 300, 512, True, "bfloat16", 10),
    ("d512 fp32", 1, 2, 300, 300, 512, False, "float32", 10),
    ("d512 fp32 causal", 1, 2, 150, 330, 512, True, "float32", 10),
    ("d1000 bf16", 1, 2, 300, 300, 1000, False, "bfloat16", 10),
    ("d1000 bf16 causal", 1, 2, 200, 333, 1000, True, "bfloat16", 10),
    ("d1000 fp32", 1, 2, 150, 330, 1000, False, "float32", 10),
    ("d1000 fp32 causal", 1, 2, 300, 300, 1000, True, "float32", 10),
]


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.attention import flash_forward_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for name, b, h, sq, sk, d, causal, dtn, reps in FLASH_CASES:
        dt = getattr(torch, dtn)
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        scale = d ** -0.5

        o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal,
                                                 scale=scale)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (math.isfinite(err) and err <= TOL[dtn]
                and lse_err <= TOL[dtn]):
            fail(f"flash_fwd {name}: max |O err| {err:.3e}, max |lse err| "
                 f"{lse_err:.3e} > tolerance {TOL[dtn]:g}")
        if name == "fully masked rows":
            masked = sq - sk  # rows with no key at or before their diagonal
            if o[:, :, :masked].abs().max().item() != 0.0:
                fail("flash_fwd: fully-masked rows are not 0")

        # the library yardstick: SDPA with the same (bottom-right) causal
        # mask; it has no answer for fully-masked rows (it gives NaN)
        lib_ms = lib_err = None
        if not causal or sq <= sk:
            mask = causal_lower_right(sq, sk) if causal and sq != sk else None

            def lib():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None, scale=scale)

            lib_err = (lib().float() - o_ref.float()).abs().max().item()
            lib_ms = device_ms(lib, reps)
        kern_ms = device_ms(
            lambda: _kernels.flash_fwd(q, k, v, causal=causal, scale=scale),
            reps)
        plain_ms = device_ms(
            lambda: flash_forward_reference(q, k, v, causal=causal,
                                            scale=scale), max(2, reps // 10))
        bound_ms, bound_by, nbytes, flops = flash_bound(b, h, sq, sk, d,
                                                        causal, dtn)
        plan = _kernels.flash_plan(sq, sk, d, dt)
        r = {"case": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
             "plan": str(plan),
             "causal": causal, "dtype": dtn, "max_abs_err": err,
             "lse_max_abs_err": lse_err, "tolerance": TOL[dtn],
             "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "library_max_abs_err": lib_err, "bound_ms": bound_ms,
             "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        results.append(r)
        print(f"flash_fwd [{name}] B={b} H={h} Sq={sq} Sk={sk} D={d} "
              f"causal={causal} {dtn}: max_abs_err={err:.3e} "
              f"(lse {lse_err:.3e}, tol {TOL[dtn]:g}) kernel_ms={kern_ms:.6f}"
              f" plain_ms={plain_ms:.6f} library_ms={lib_ms} "
              f"bound_ms={bound_ms:.6f} ({bound_by}); {plan}", flush=True)
    return results


def phase_bwd_kernels():
    """dQ and dK/dV kernels against ``flash_backward_reference`` on the
    same inputs (O and logsumexp from the forward kernel, a random
    cotangent), at the cases of the forward, each printing its
    flash_bwd_plan; times both kernels, the plain version, SDPA's backward
    through autograd and the bound. At the long-context case both kernels
    are also captured in a CUDA graph once, whose replay must give the
    eager gradients bit for bit."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.attention import flash_backward_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {"dq": [], "dkv": []}
    for name, b, h, sq, sk, d, causal, dtn, reps in FLASH_CASES:
        dt = getattr(torch, dtn)
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)
                   for s in (sq, sk, sk))
        g = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dt)
        scale = d ** -0.5
        o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale)
        delta = (g.float() * o.float()).sum(-1)

        def dq_kernel():
            return _kernels.flash_bwd_dq(q, k, v, g, lse, delta,
                                         causal=causal, scale=scale)

        def dkv_kernel():
            return _kernels.flash_bwd_dkv(q, k, v, g, lse, delta,
                                          causal=causal, scale=scale)

        def plain():
            return flash_backward_reference(q, k, v, o, lse, g,
                                            causal=causal, scale=scale)

        dq = dq_kernel()
        dk, dv = dkv_kernel()
        torch.cuda.synchronize()
        if name == "long context":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side), torch.cuda.graph(graph):
                captured = (dq_kernel(), *dkv_kernel())
            torch.cuda.current_stream().wait_stream(side)
            for t in captured:
                t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b)
                       for a, b in zip(captured, (dq, dk, dv))):
                fail("flash backward: a CUDA-graph replay differs from the "
                     "eager launches")
            del graph, captured
        ref = plain()
        torch.cuda.synchronize()
        errs = {}
        for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            rel = err / top if top > 0 else err
            if not (math.isfinite(err) and rel <= BWD_TOL[dtn]):
                fail(f"flash backward {name}: {gname} max |err| {err:.3e} "
                     f"is {rel:.3e} of max |{gname}| {top:.3e} > "
                     f"{BWD_TOL[dtn]:g}")
            errs[gname] = (err, rel)
        if name == "fully masked rows":
            masked = sq - sk  # rows with no key at or before their diagonal
            if dq[:, :, :masked].abs().max().item() != 0.0:
                fail("flash_bwd_dq: fully-masked rows of dQ are not 0")

        # the library yardstick: SDPA's backward (all of dQ, dK, dV) with
        # the same bottom-right causal mask; none for fully-masked rows,
        # where SDPA gives NaN. Autograd runs a backward on its forward's
        # stream, so forward and backward are captured together and the
        # forward's own time is taken off
        lib_ms = None
        if not causal or sq <= sk:
            mask = causal_lower_right(sq, sk) if causal and sq != sk else None
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qa, ka, va, attn_mask=mask,
                    is_causal=causal and mask is None, scale=scale)

            lib_ms = (device_ms(lambda: torch.autograd.grad(
                sdpa(), (qa, ka, va), g), reps)
                - device_ms(sdpa, reps))
        plain_ms = device_ms(plain, max(2, reps // 10))
        plan = _kernels.flash_bwd_plan(sq, sk, d, dt)
        for kname, fn, gnames in (("dq", dq_kernel, ("dq",)),
                                  ("dkv", dkv_kernel, ("dk", "dv"))):
            bound_ms, bound_by, nbytes, flops = flash_bwd_bound(
                b, h, sq, sk, d, causal, dtn, kname)
            err = max(errs[n][0] for n in gnames)
            rel = max(errs[n][1] for n in gnames)
            kern_ms = device_ms(fn, reps)
            part = getattr(plan, kname)
            results[kname].append({
                "case": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
                "plan": str(part),
                "causal": causal, "dtype": dtn, "max_abs_err": err,
                "max_rel_err": rel, "tolerance": BWD_TOL[dtn],
                "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                "flops": flops})
            print(f"flash_bwd_{kname} [{name}] B={b} H={h} Sq={sq} Sk={sk} "
                  f"D={d} causal={causal} {dtn}: max_abs_err={err:.3e} "
                  f"(rel {rel:.3e}, tol {BWD_TOL[dtn]:g}) kernel_ms="
                  f"{kern_ms:.6f} plain_ms(dq+dk+dv)={plain_ms:.6f} "
                  f"library_ms(sdpa bwd)={lib_ms} bound_ms={bound_ms:.6f} "
                  f"({bound_by}); {part}", flush=True)
    return results


def jax_layout(cfg, rng):
    """(params, state) in the JAX package's pytree layout, as numpy: the
    weights as ``model.init`` draws them there (Kaiming-uniform, bound
    1/sqrt(fan_in)), drawn from ``rng`` instead of a jax.random key;
    batchnorm's gamma, beta, running mean and running variance (> 0) drawn
    at random, since with their initial 1/0/0/1 a broken fold or BN would
    not show. Shapes follow the port's layers built from ``cfg``."""
    import numpy as np

    from dcnn_tpu_torch.nn import Sequential

    def u(shape, fan_in):
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    def f32(a):
        return a.astype(np.float32)

    def layer(l, shape):
        ty, p, s = l.type_name, {}, {}
        if ty == "multi_head_attention":
            e = shape[1]
            p = {n: u((e, e), e) for n in ("wq", "wk", "wv", "wo")}
            p.update({n: u((e,), e) for n in ("bq", "bk", "bv", "bo")})
        elif ty == "residual_block":
            main, short = layers(l.layers, shape), layers(l.shortcut, shape)
            p = {"main": main[0], "shortcut": short[0]}
            s = {"main": main[1], "shortcut": short[1]}
        elif ty == "dense":
            p = {"w": u((l.out_features, shape[0]), shape[0])}
            if l.use_bias:
                p["b"] = u((l.out_features,), shape[0])
        elif ty == "conv2d":
            cin = shape[0 if l.data_format == "NCHW" else 2]
            fan_in = cin * l.kernel_size[0] * l.kernel_size[1]
            p = {"w": u((l.out_channels, cin, *l.kernel_size), fan_in)}
            if l.use_bias:
                p["b"] = u((l.out_channels,), fan_in)
        elif ty == "batchnorm":
            c = l.num_features
            if l.affine:
                p = {"gamma": f32(rng.uniform(0.5, 1.5, c)),
                     "beta": f32(rng.normal(0.0, 0.1, c))}
            s = {"running_mean": f32(rng.normal(0.0, 0.1, c)),
                 "running_var": f32(rng.uniform(0.5, 1.5, c))}
        elif ty not in ("flatten", "activation", "maxpool2d", "avgpool2d"):
            raise ValueError(f"no params rule for {ty}")
        return p, s, l.output_shape(shape)

    def layers(ls, shape):
        params, state = [], []
        for l in ls:
            p, s, shape = layer(l, shape)
            params.append(p)
            state.append(s)
        return tuple(params), tuple(state)

    return layers(Sequential.from_config(cfg).layers,
                  tuple(cfg["input_shape"]))


def reset_launches() -> None:
    from dcnn_tpu_torch.ops import _kernels

    for fn in _kernels.COUNTED:
        fn.launches = 0


def launches() -> dict:
    from dcnn_tpu_torch.ops import _kernels

    return {fn.__name__: fn.launches for fn in _kernels.COUNTED}


def model_params():
    """``mha_classifier``'s config and JAX-layout weights from ``SEED``."""
    import numpy as np

    from dcnn_tpu_torch.models import create_model

    rng = np.random.default_rng(SEED)
    cfg = create_model("mha_classifier").get_config()
    return cfg, jax_layout(cfg, rng)[0], rng


def phase_serve(card: str):
    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine

    cfg, params, rng = model_params()
    n_single, batches = 64, (2, 3, 5, 8)
    pool = rng.normal(size=(n_single + sum(batches), *cfg["input_shape"])
                      ).astype(np.float32)
    with torch.no_grad():
        ref = from_jax(cfg, params, device="cpu")(torch.from_numpy(pool)).numpy()

    model = from_jax(cfg, params, device="cuda")
    reset_launches()  # the serving path starts here
    engine = InferenceEngine.from_model(model, max_batch=32, device="cuda")
    # the engine warms its buckets, then the dispatcher on its own thread
    batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
    warm_launches = _kernels.flash_fwd.launches
    futs = {}

    def submit_singles(lo, hi):
        for i in range(lo, hi):
            futs[i] = batcher.submit(pool[i])

    threads = [threading.Thread(target=submit_singles, args=(lo, lo + 16))
               for lo in range(0, n_single, 16)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    off = n_single
    for n in batches:
        futs[(off, n)] = batcher.submit(pool[off:off + n])
        off += n
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            fail("a submitter thread did not finish")
    batcher.drain(timeout=120)
    wall = time.perf_counter() - t0
    counts = launches()  # the serving path ends here
    launches_fwd = counts["flash_fwd"]
    snap = batcher.metrics.snapshot()
    if counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]:
        fail(f"serving launched backward kernels: {counts}")

    worst = 0.0
    for key, f in futs.items():
        y = f.result(timeout=0)
        lo, n = (key, None) if isinstance(key, int) else key
        want = ref[lo] if n is None else ref[lo:lo + n]
        if y.shape != want.shape or not np.all(np.isfinite(y)):
            fail(f"request {key}: got shape {y.shape}, finite="
                 f"{bool(np.all(np.isfinite(y)))}")
        worst = max(worst, float(np.abs(y - want).max()))
    if worst > SERVE_TOL:
        fail(f"served logits differ from the CPU plain path by {worst:.3e} "
             f"> {SERVE_TOL:g}")
    n_batches = snap["batches"]
    served_launches = launches_fwd - warm_launches
    if warm_launches < 4 * len(engine.bucket_sizes):
        fail(f"warm-up (engine and dispatcher) launched flash_fwd "
             f"{warm_launches} times for {len(engine.bucket_sizes)} buckets")
    if n_batches < 1 or served_launches < 2 * n_batches:
        fail(f"flash_fwd launched {served_launches} times for {n_batches} "
             f"dispatched batches (2 attention layers each)")
    requests = len(futs)
    print(f"serve: {requests} requests ({snap['requests_completed']} samples)"
          f" in {n_batches} batches, occupancy {snap['batch_occupancy']}, "
          f"max |logit err| vs CPU {worst:.3e} (tol {SERVE_TOL:g}); "
          f"flash_fwd launches {launches_fwd} ({warm_launches} warm-up, "
          f"{served_launches} serving); throughput "
          f"{snap['throughput_rps']} samples/s, p50 {snap['p50_ms']} ms, "
          f"p99 {snap['p99_ms']} ms, wall {wall:.3f} s on {card}",
          flush=True)
    return {"launches": launches_fwd, "warm_launches": warm_launches,
            "served_launches": served_launches, "batches": n_batches,
            "requests": requests, "max_abs_err": worst, **snap}


def marker_task(rng, n=256, s=32, e=64):
    """Class = position of a marked token (``tests/test_attention.py``'s
    training task): x (n, s, e) float32, one-hot y (n, 10)."""
    import numpy as np

    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.1, (n, s, e)).astype(np.float32)
    x[np.arange(n), y_idx * 3, :8] += 2.5
    return x, np.eye(10, dtype=np.float32)[y_idx]


# the bands of RMS gradient (lower edges) over which a param comparison
# reports its elements and largest difference
ADAM_BANDS = (0.0, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4)


def adam_param_diff(p_gpu, p_cpu, v_cpu, steps, lr, b1, b2, what,
                    atol=TRAIN_PARAM_ATOL):
    """Final params of a CUDA run against the CPU run of the same Adam
    training: Adam's RMS gradient per element, from the CPU run's second
    moment ``v_cpu``, decides which tolerance holds (see GRAD_FLOOR); fails
    when either is exceeded. Returns (max |diff| where the RMS gradient >=
    GRAD_FLOOR (held to ``atol``), max |diff| below it, elements below,
    elements, [elements, max |diff|] per ADAM_BANDS band, the step
    bound)."""
    import numpy as np

    bc2 = 1.0 - b2 ** steps
    step_bound = 2 * steps * lr * (1 - b1) / math.sqrt(1 - b2)
    flat = []

    def walk(a, b, v):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], v[key])
        elif isinstance(a, (tuple, list)):
            for ai, bi, vi in zip(a, b, v):
                walk(ai, bi, vi)
        else:
            flat.append((np.asarray(a), np.asarray(b), np.asarray(v)))

    walk(p_gpu, p_cpu, v_cpu)
    worst = worst_noise = 0.0
    n_noise = n_all = 0
    edges = (*ADAM_BANDS, math.inf)
    bins = [[0, 0.0] for _ in edges[1:]]  # elements, max |diff| per band
    for a, b, v in flat:
        diff = np.abs(a - b)
        if not np.all(np.isfinite(a)):
            fail(f"{what}: non-finite params on CUDA")
        rms = np.sqrt(v / bc2)
        for i, (lo, hi) in enumerate(zip(edges, edges[1:])):
            band = (rms >= lo) & (rms < hi)
            if band.any():
                bins[i][0] += int(band.sum())
                bins[i][1] = max(bins[i][1], float(diff[band].max()))
        noise = rms < GRAD_FLOOR
        n_noise += int(noise.sum())
        n_all += diff.size
        if (~noise).any():
            worst = max(worst, float(diff[~noise].max()))
        if noise.any():
            worst_noise = max(worst_noise, float(diff[noise].max()))
    if worst > atol or worst_noise > step_bound:
        fail(f"{what}: final params differ from the CPU run by {worst:.3e} "
             f"(tol {atol:g}) where the RMS gradient >= "
             f"{GRAD_FLOOR:g}, {worst_noise:.3e} (bound {step_bound:.3e}) "
             f"on the {n_noise} of {n_all} elements below it")
    return worst, worst_noise, n_noise, n_all, bins, step_bound


def phase_train(card: str):
    """16 Adam steps of full-width ``mha_classifier`` through
    ``Trainer.fit`` on CUDA and on the CPU, from the same weights and
    batches. The CUDA run checkpoints every epoch (``checkpoint_dir``,
    async saves), is crashed by a FaultPlan in epoch 2 and resumed with
    ``resume="auto"``; the launch counters are read over the resumed
    epoch alone."""
    import tempfile

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax, opt_state_to_jax, to_jax
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.resilience import FaultPlan, InjectedCrash
    from dcnn_tpu_torch.train import Trainer, create_train_state

    cfg, params, rng = model_params()
    x, y = marker_task(rng)
    epochs, batch = 2, 32
    per_epoch = len(x) // batch
    runs = {}
    ckpt = tempfile.TemporaryDirectory(prefix="chip_smoke_mha_", dir=ROOT)

    def run(dev, **kw):
        model = from_jax(cfg, params, device=dev)
        opt = Adam(1e-3)
        ts = create_train_state(model, opt)
        loader = ArrayDataLoader(x, y, batch_size=batch, shuffle=True,
                                 seed=SEED)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=epochs, batch_size=batch, snapshot_dir=None,
            progress_interval=0, device_type=dev, **kw))
        return trainer, ts, loader, model

    with ckpt:
        kw = dict(checkpoint_dir=ckpt.name, checkpoint_every=1)
        trainer, ts, loader, _ = run("cuda", **kw)
        crash = FaultPlan().arm("train.nonfinite_input", at=per_epoch + 2,
                                exc=InjectedCrash)
        try:
            with crash:
                trainer.fit(ts, loader)
        except InjectedCrash:
            pass
        else:
            fail("train: the armed crash in epoch 2 did not fire")
        trainer.checkpoints.close()
        trainer, ts, loader, model = run("cuda", resume="auto", **kw)
        reset_launches()  # the resumed training path starts here
        ts = trainer.fit(ts, loader)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launches().items()  # the path ends
                  if k.startswith("flash_")}
        trainer.checkpoints.close()
    runs["cuda"] = (trainer.history, to_jax(model),
                    opt_state_to_jax(model, ts.opt_state), ts.step)
    trainer, ts, loader, model = run("cpu")
    ts = trainer.fit(ts, loader)
    runs["cpu"] = (trainer.history, to_jax(model),
                   opt_state_to_jax(model, ts.opt_state), ts.step)

    hist, p_gpu, _, steps = runs["cuda"]
    hist_cpu, p_cpu, st_cpu, _ = runs["cpu"]
    if steps != epochs * per_epoch or len(hist) != epochs:
        fail(f"train: {steps} steps in {len(hist)} epochs after the resume, "
             f"expected {epochs * per_epoch} in {epochs}")
    resumed = (epochs - 1) * per_epoch  # epoch 2, run after the resume
    per_step = {k: v / resumed for k, v in counts.items()}
    if any(v != 2 * resumed for v in counts.values()):
        fail(f"train: launches {counts} over the {resumed} resumed steps; "
             f"expected 2 of each kernel per step (two attention layers)")
    losses = [h["train_loss"] for h in hist]
    loss_rel = max(abs(a["train_loss"] - b["train_loss"])
                   / abs(b["train_loss"]) for a, b in zip(hist, hist_cpu))
    if not all(math.isfinite(v) for v in losses) or loss_rel > TRAIN_LOSS_RTOL:
        fail(f"train: CUDA losses {losses} vs CPU "
             f"{[h['train_loss'] for h in hist_cpu]} (rel {loss_rel:.3e} > "
             f"{TRAIN_LOSS_RTOL:g})")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")

    opt = Adam(1e-3)
    worst, worst_noise, n_noise, n_all, bins, step_bound = adam_param_diff(
        p_gpu, p_cpu, st_cpu["v"], steps, opt.learning_rate, opt.beta1,
        opt.beta2, "train")
    edges = ADAM_BANDS
    secs = [h["seconds"] for h in hist]
    sps = [len(x) / t for t in secs]
    print(f"train: {steps} steps of B={batch} in {epochs} epochs, losses "
          f"{losses} (CPU {[h['train_loss'] for h in hist_cpu]}, max rel "
          f"diff {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:g}); final params vs "
          f"CPU: max |diff| {worst:.3e} (tol {TRAIN_PARAM_ATOL:g}) where the "
          f"RMS gradient >= {GRAD_FLOOR:g}, {worst_noise:.3e} (bound "
          f"{step_bound:.3e}) on {n_noise} of {n_all} elements below it "
          f"(by RMS-gradient band [lo, hi): elements, max |diff|: "
          f"{[(lo, n, d) for lo, (n, d) in zip(edges, bins)]}); "
          f"crashed in epoch 2 and resumed from epoch 1's checkpoint: "
          f"launches over the resumed epoch {counts} ({per_step} per step); "
          f"samples/s per epoch {sps} (epoch 1 from the first run, with "
          f"first-call set-up) on {card}", flush=True)
    return {"launches": counts, "steps": steps, "losses": losses,
            "cpu_losses": [h["train_loss"] for h in hist_cpu],
            "loss_max_rel_diff": loss_rel, "param_max_abs_diff": worst,
            "noise_param_max_abs_diff": worst_noise,
            "noise_elements": n_noise, "elements": n_all,
            "diff_by_rms_band": [(lo, n, d) for lo, (n, d) in zip(edges, bins)],
            "samples_per_s": sps}


CONV_TOL = {"float32": 1e-4,   # the same products summed in another order
            "bfloat16": 2e-2}  # output rounded to bf16 (8 significant bits)
CNN_SERVE_RTOL = 1e-4  # max |served - CPU| over max |CPU logit|, fp32
# bench_pallas_conv.py::_shapes, (B, H, W, Cin, Cout), bf16 as that bench
# runs them; layer1 sits at 64x64 there, though the model max-pools it to 32
BENCH_SHAPES = [(256, 64, 64, 64, 64), (256, 32, 32, 128, 128),
                (256, 16, 16, 256, 256), (256, 8, 8, 512, 512)]
# tests/test_pallas_kernels.py's conv shapes, and an odd W
RAGGED_SHAPES = [(4, 8, 8, 8, 16), (4, 6, 10, 4, 8), (2, 5, 5, 3, 4),
                 (3, 7, 9, 8, 8)]
CONV_KERNELS = ("conv3x3_s1", "conv3x3_s1_pairs", "conv3x3_s1_bnrelu_in",
                "fused_scale_bias_relu")
# launches on the model-site path of resnet18_tiny_imagenet: the plain conv
# at its 14 3x3 stride-1 convs (the stem, conv1 of the 8 basic blocks,
# conv0 of the 5 blocks whose conv0 has stride 1), the pairs conv at the 4
# of them in layer1 (W=32, Cout 64), the BN-prologue conv at the 8
# bn0 -> relu0 -> conv1 chains, and scale/bias/ReLU at the 9 BN -> ReLU
# pairs (the stem's bn1/relu1 and each block's bn0/relu0)
SITE_LAUNCHES = {"conv3x3_s1": 14, "conv3x3_s1_pairs": 4,
                 "conv3x3_s1_bnrelu_in": 8, "fused_scale_bias_relu": 9}


def conv_bound(n, h, w, cin, cout, dtype_name, bn):
    """Least time for one 3x3 conv: x, the weights (and fp32 scale and
    shift) read once and the output written once, over HBM bandwidth,
    against 2 N H W 9 Cin Cout FLOPs over the peak rate for the input
    type, whatever the formulation (the pairs kernel's extra third of
    products counts against it, not in its bound). An fp32-accurate
    product is fastest on this card as three TF32 tensor-core products
    (hi*hi + hi*lo + lo*hi), so fp32 counts 3 FLOPs each at the TF32 peak,
    above the 67 TFLOP/s of the CUDA cores."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = es * (n * h * w * (cin + cout) + 9 * cin * cout) + 8 * cin * bn
    flops = 2 * n * h * w * 9 * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / PEAK_FLOPS["tfloat32"] if dtype_name == "float32"
             else flops / PEAK_FLOPS[dtype_name])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def fused_bound(numel, c, dtype_name):
    """x read and y written once, scale and bias once; 3 operations per
    element."""
    es = 4 if dtype_name == "float32" else 2
    nbytes, flops = es * (2 * numel + 2 * c), 3 * numel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def conv_case(kind, label, x, w, sc, sh, reps):
    """Hold one conv or scale/bias/ReLU kernel against its plain version on
    the same inputs (kernel and plain launched directly, so the launch
    counters of a path do not see them), and time the kernel, the plain
    version and, for the convs, ``F.conv2d`` on the same shape, dtype and
    layout (channels-last; for the BN variant without its prologue). For
    ``fused_scale_bias_relu`` x is (..., C) and ``sc``, ``sh`` are the
    scale and bias in x's dtype."""
    import torch
    import torch.nn.functional as F

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.pallas import conv as pconv
    from dcnn_tpu_torch.ops.pallas import fused as pfused

    dtn = str(x.dtype).replace("torch.", "")
    k_reps, p_reps, l_reps = reps
    lib = None
    if kind == "fused_scale_bias_relu":
        def kern():
            return _kernels.fused_scale_bias_relu(x, sc, sh)

        def plain():
            return pfused.scale_bias_relu_reference(x, sc, sh)
        bound = fused_bound(x.numel(), x.shape[-1], dtn)
        shape = {"shape": list(x.shape)}
    else:
        n, h, wd, cin = x.shape
        cout = w.shape[3]
        x_cl = x.permute(0, 3, 1, 2)  # NHWC memory as a channels-last NCHW view
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def lib():
            return F.conv2d(x_cl, w_cl, padding=1)
        if kind == "conv3x3_s1":
            def kern():
                return _kernels.conv3x3_s1(x, w, out_dtype=x.dtype)

            def plain():
                return pconv.conv3x3_reference(x, w)
        elif kind == "conv3x3_s1_bnrelu_in":
            def kern():
                return _kernels.conv3x3_s1_bnrelu_in(x, w, sc, sh,
                                                     out_dtype=x.dtype)

            def plain():
                return pconv.conv3x3_reference(
                    pconv.bnrelu_reference(x, sc, sh), w)
        else:
            w2 = pconv.fuse_pair_weights(w)

            def kern():
                return _kernels.conv3x3_s1_pairs(x, w2, out_dtype=x.dtype)

            def plain():
                return pconv.conv3x3_pairs_reference(x, w2)
        bound = conv_bound(n, h, wd, cin, cout, dtn,
                           kind == "conv3x3_s1_bnrelu_in")
        shape = {"B": n, "H": h, "W": wd, "Cin": cin, "Cout": cout}
        unit = _kernels._copy_unit(x)  # the tensor-core kernel's tiling
        shape["plan"] = (_kernels.conv_plan(
            n, h, wd, cin, cout, x.dtype, _kernels._card_sms(x.device),
            prologue=kind == "conv3x3_s1_bnrelu_in",
            pairs=kind == "conv3x3_s1_pairs").describe()
            + ", halo by " + (f"cp.async {unit} B" if unit else "TMA"))

    got = kern()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    rel = err / top if top > 0 else err
    if not (math.isfinite(err) and rel <= CONV_TOL[dtn]):
        fail(f"{kind} [{label}] {shape} {dtn}: max |err| {err:.3e} is "
             f"{rel:.3e} of max |plain| {top:.3e} > {CONV_TOL[dtn]:g}")
    lib_ms = lib_rel = None
    if lib is not None:
        if kind != "conv3x3_s1_bnrelu_in":  # the same function as plain
            lib_rel = ((lib().permute(0, 2, 3, 1).float() - want.float())
                       .abs().max().item() / max(top, 1e-30))
        lib_ms = device_ms(lib, l_reps)
    kern_ms = device_ms(kern, k_reps)
    plain_ms = device_ms(plain, p_reps)
    bound_ms, bound_by, nbytes, flops = bound
    print(f"{kind} [{label}] {shape} {dtn}: max_abs_err={err:.3e} (rel "
          f"{rel:.3e}, tol {CONV_TOL[dtn]:g}) kernel_ms={kern_ms:.6f} "
          f"plain_ms={plain_ms:.6f} library_ms={lib_ms} "
          f"bound_ms={bound_ms:.3e} ({bound_by}); kernel at "
          f"{100 * bound_ms / kern_ms:.1f}% of bound", flush=True)
    return {"case": label, **shape, "dtype": dtn, "max_abs_err": err,
            "max_rel_err": rel, "tolerance": CONV_TOL[dtn], "ms": kern_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_rel_err": lib_rel, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops}


def phase_conv_kernels():
    """Rows 4-7 against their plain versions at the JAX bench's shapes
    (bf16) and at the ragged test shapes (fp32 and bf16)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dt)

    results = {k: [] for k in CONV_KERNELS}
    cases = ([("bench", s, torch.bfloat16, (3, 2, 5)) for s in BENCH_SHAPES]
             + [("ragged", s, dt, (50, 10, 50)) for s in RAGGED_SHAPES
                for dt in (torch.float32, torch.bfloat16)])
    for group, (n, h, w, cin, cout), dt, reps in cases:
        x, wt = randn(n, h, w, cin, dt=dt), randn(3, 3, cin, cout, dt=dt,
                                                  scale=0.05)
        sc = torch.rand(cin, device="cuda", generator=gen) + 0.5
        sh = randn(cin, scale=0.1)
        label = f"{group} {n}x{h}x{w}x{cin}->{cout}"
        for kind in ("conv3x3_s1", "conv3x3_s1_bnrelu_in"):
            results[kind].append(conv_case(kind, label, x, wt, sc, sh, reps))
        # as the bench races the pairs variant: narrow Cout, even W
        if w % 2 == 0 and (group == "ragged" or cout < 128):
            results["conv3x3_s1_pairs"].append(
                conv_case("conv3x3_s1_pairs", label, x, wt, sc, sh, reps))
        results["fused_scale_bias_relu"].append(conv_case(
            "fused_scale_bias_relu", label, x, None, sc.to(dt), sh.to(dt),
            reps))
    for dt in (torch.float32, torch.bfloat16):  # ragged rows, wide C
        x = randn(3, 700, dt=dt)
        results["fused_scale_bias_relu"].append(conv_case(
            "fused_scale_bias_relu", "ragged 3x700", x, None,
            randn(700, dt=dt), randn(700, dt=dt), (50, 10, 50)))
    return results


def resnet18(device, rng):
    """Full-width ``resnet18_tiny_imagenet`` (64x64x3, NHWC) in eval mode
    from JAX-layout params and random BN state made from ``rng``."""
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.models import create_model

    cfg = create_model("resnet18_tiny_imagenet", "NHWC").get_config()
    params, state = jax_layout(cfg, rng)
    return cfg, params, state, from_jax(cfg, params, state,
                                        device=device).eval()


def phase_model_sites(card):
    """Run one B=32 batch through the unfolded NHWC ResNet-18 on CUDA and
    hold the four kernels to the model's own tensors at every site of
    SITE_LAUNCHES. The launch counters are reset just before the kernels
    run and read just after: one launch per site. Then every site is
    timed in fp32 and bf16 against its plain version, its library call and
    its bound."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.pallas import (
        conv3x3_s1, conv3x3_s1_bnrelu_in, conv3x3_s1_pairs,
        fused_scale_bias_relu,
    )

    rng = np.random.default_rng(SEED + 3)
    _, _, _, model = resnet18("cuda", rng)
    x = torch.from_numpy(rng.normal(size=(32, 64, 64, 3)).astype(np.float32)
                         ).cuda()
    blocks = [l for l in model.layers if l.type_name == "residual_block"]
    seen = {}

    def keep(key, take_input=False):
        return lambda module, inputs, out: seen.__setitem__(
            key, (inputs[0] if take_input else out).contiguous())

    hooks = [model[0].register_forward_hook(keep("stem y")),
             model[2].register_forward_hook(keep("stem a"))]
    for blk in blocks:
        hooks.append(blk.layers[0].register_forward_hook(
            keep((blk.name, "x"), take_input=True)))
        for j, tag in ((0, "y0"), (2, "a0"), (3, "y1")):
            hooks.append(blk.layers[j].register_forward_hook(
                keep((blk.name, tag))))
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    if not bool(torch.isfinite(logits).all()):
        fail("model sites: non-finite logits")

    def hwio(conv):
        return conv.w.detach().permute(2, 3, 1, 0).contiguous()

    def scale_shift(bn):  # eval-mode BN as relu's per-channel affine input
        sc = bn.gamma / torch.sqrt(bn.running_var + bn.epsilon)
        return sc.contiguous(), (bn.beta - bn.running_mean * sc).contiguous()

    # (kernel, site, (x, w HWIO, scale, shift), conv bias, model's tensor)
    sites = [("conv3x3_s1", "stem conv", (x, hwio(model[0]), None, None),
              None, seen["stem y"]),
             ("fused_scale_bias_relu", "stem bn1+relu1",
              (seen["stem y"], None, *scale_shift(model[1])), None,
              seen["stem a"])]
    with torch.no_grad():
        for blk in blocks:
            conv0, bn0, _, conv1 = blk.layers[:4]
            xin, y0, a0, y1 = (seen[(blk.name, t)]
                               for t in ("x", "y0", "a0", "y1"))
            s0, t0 = scale_shift(bn0)
            w0, w1 = hwio(conv0), hwio(conv1)
            pairs = blk.name.startswith("layer1_")  # W=32, Cout 64
            if tuple(conv0.stride) == (1, 1):
                sites.append(("conv3x3_s1", f"{blk.name} conv0",
                              (xin, w0, None, None), conv0.b, y0))
                if pairs:
                    sites.append(("conv3x3_s1_pairs", f"{blk.name} conv0",
                                  (xin, w0, None, None), conv0.b, y0))
            sites += [
                ("fused_scale_bias_relu", f"{blk.name} bn0+relu0",
                 (y0, None, s0, t0), None, a0),
                ("conv3x3_s1", f"{blk.name} conv1", (a0, w1, None, None),
                 conv1.b, y1),
                ("conv3x3_s1_bnrelu_in", f"{blk.name} bn0+relu0+conv1",
                 (y0, w1, s0, t0), conv1.b, y1)]
            if pairs:
                sites.append(("conv3x3_s1_pairs", f"{blk.name} conv1",
                              (a0, w1, None, None), conv1.b, y1))
    call = {"conv3x3_s1": lambda i, w, sc, sh: conv3x3_s1(i, w),
            "conv3x3_s1_pairs": lambda i, w, sc, sh: conv3x3_s1_pairs(i, w),
            "conv3x3_s1_bnrelu_in": conv3x3_s1_bnrelu_in,
            "fused_scale_bias_relu": lambda i, w, sc, sh:
                fused_scale_bias_relu(i, sc, sh)}
    got = []
    with torch.no_grad():
        reset_launches()  # the kernels' path starts here
        for kind, _, args, bias, _ in sites:
            y = call[kind](*args)
            got.append(y if bias is None else y + bias)
        torch.cuda.synchronize()
        counts = launches()  # the kernels' path ends here
    for k, want in SITE_LAUNCHES.items():
        n_sites = sum(site[0] == k for site in sites)
        if counts[k] != want or n_sites != want:
            fail(f"model sites: {k} launched {counts[k]} times at {n_sites}"
                 f" sites, expected {want} (one per site); all counts "
                 f"{counts}")
    worst = {k: 0.0 for k in CONV_KERNELS}
    for (kind, name, _, _, want), y in zip(sites, got):
        rel = ((y - want).abs().max() / want.abs().max()).item()
        if not (math.isfinite(rel) and rel <= CONV_TOL["float32"]):
            fail(f"model sites: {kind} at {name} differs from the model's "
                 f"tensor by {rel:.3e} of its max > {CONV_TOL['float32']:g}")
        worst[kind] = max(worst[kind], rel)
    print(f"model sites: resnet18_tiny_imagenet B=32 NHWC fp32, {len(sites)}"
          f" kernel outputs held to the model's own tensors, worst relative "
          f"error per kernel {worst} (tol {CONV_TOL['float32']:g}); launches "
          f"{ {k: counts[k] for k in CONV_KERNELS} } on {card}", flush=True)

    results = {k: [] for k in CONV_KERNELS}  # every site, timed on its own
    for dt in (torch.float32, torch.bfloat16):
        for kind, name, (inp, w, sc, sh), _, _ in sites:
            if kind == "fused_scale_bias_relu":  # scale, bias in x's type
                sc, sh = sc.to(dt), sh.to(dt)
            r = conv_case(kind, f"model {name}", inp.to(dt),
                          None if w is None else w.to(dt), sc, sh,
                          (20, 5, 20))
            results[kind].append({**r, "site": name})
    # eager calls through the public functions at the last layer4 site of
    # each tensor-core kernel, beside its graph time: the host's share
    for kind in ("conv3x3_s1", "conv3x3_s1_bnrelu_in"):
        name, (inp, w, sc, sh) = [(s[1], s[2]) for s in sites
                                  if s[0] == kind][-1]
        n, h, wd, cin = inp.shape
        for r in results[kind]:
            if r["site"] != name:
                continue
            dt = getattr(torch, r["dtype"])
            xi, wi = inp.to(dt), w.to(dt)
            with torch.no_grad():
                r["eager_ms"] = eager_ms(lambda: call[kind](xi, wi, sc, sh),
                                         200)
            plan = _kernels.conv_plan.__wrapped__  # the plan without its cache
            t0 = time.perf_counter()
            for _ in range(200):
                plan(n, h, wd, cin, w.shape[3], dt,
                     prologue=kind == "conv3x3_s1_bnrelu_in")
            r["plan_uncached_ms"] = (time.perf_counter() - t0) * 1e3 / 200
            print(f"model sites eager: {kind} at {name} {r['dtype']}: "
                  f"{r['eager_ms']:.6f} ms per eager call, "
                  f"{r['ms']:.6f} ms per call in a CUDA graph; its plan "
                  f"takes {r['plan_uncached_ms']:.6f} ms uncached on {card}",
                  flush=True)
    for dtn in ("float32", "bfloat16"):
        sums = {}
        for kind in CONV_KERNELS:
            rs = [r for r in results[kind] if r["dtype"] == dtn]
            sums[kind] = {k: round(sum(r[k] or 0.0 for r in rs), 6)
                          for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"model sites {dtn}: sums over the sites (kernel, plain, "
              f"F.conv2d, bound ms) {sums} on {card}", flush=True)
    return counts, worst, results


def phase_serve_cnn(card):
    """Full-width resnet18_tiny_imagenet (NHWC, random BN statistics)
    served through DynamicBatcher over InferenceEngine.from_model(...,
    fold=True) on CUDA, every answer held to the unfolded model on the
    CPU."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine

    rng = np.random.default_rng(SEED + 4)
    cfg, params, state, _ = resnet18("cpu", rng)
    n_single, batches = 48, (2, 3, 5, 8, 16)
    pool = rng.normal(size=(n_single + sum(batches), *cfg["input_shape"])
                      ).astype(np.float32)
    cpu_model = from_jax(cfg, params, state, device="cpu").eval()
    with torch.no_grad():
        ref = cpu_model(torch.from_numpy(pool)).numpy()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    scale = float(np.abs(ref).max())

    model = from_jax(cfg, params, state, device="cuda")
    reset_launches()  # the serving path starts here
    t0 = time.perf_counter()
    engine = InferenceEngine.from_model(model, fold=True, max_batch=32,
                                        device="cuda")
    warm_s = time.perf_counter() - t0
    # the dispatcher warms every bucket on its own thread before it serves
    batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
    dispatcher_warm_s = sum(batcher.warmup_s.values())

    def serve_round(server):
        """Threaded singles and small batches; waits for every answer."""
        futs = {}

        def submit_singles(lo, hi):
            for i in range(lo, hi):
                futs[i] = server.submit(pool[i])

        threads = [threading.Thread(target=submit_singles, args=(lo, lo + 12))
                   for lo in range(0, n_single, 12)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        off = n_single
        for n in batches:
            futs[(off, n)] = server.submit(pool[off:off + n])
            off += n
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                fail("serve cnn: a submitter thread did not finish")
        out = {key: f.result(timeout=300) for key, f in futs.items()}
        return out, time.perf_counter() - t0, server.metrics.snapshot()

    # round 1 is the dispatcher's first requests, round 2 the same again;
    # the control round runs on a new dispatcher that skips its warm-up,
    # so it shows what that warm-up saves (cuDNN's per-thread plans)
    answers, wall, snap = serve_round(batcher)
    batcher.metrics.reset()
    answers2, wall2, snap2 = serve_round(batcher)
    batcher.drain(timeout=300)
    cold = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256,
                          warm=False)
    answers3, wall3, snap3 = serve_round(cold)
    cold.drain(timeout=300)
    counts = launches()  # the serving path ends here
    worst = 0.0
    for key in answers:
        lo, n = (key, None) if isinstance(key, int) else key
        want = ref[lo] if n is None else ref[lo:lo + n]
        for y in (answers[key], answers2[key], answers3[key]):
            if y.shape != want.shape or not np.all(np.isfinite(y)):
                fail(f"serve cnn: request {key}: got shape {y.shape}, "
                     f"finite={bool(np.all(np.isfinite(y)))}")
            worst = max(worst, float(np.abs(y - want).max()))
    rel = worst / scale

    # where a B=32 batch's time goes: host wall of eager batches (launch to
    # sync), device time of the same batch replayed as a CUDA graph, and
    # the profiler's device time by kernel for one eager batch
    x32 = torch.from_numpy(pool[:32]).cuda()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_padded(x32)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[2]
    graph_ms = device_ms(lambda: engine.run_padded(x32), 5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.run_padded(x32)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the kernels themselves; an operator's entry repeats its kernels' time
    events = sorted((e for e in prof.key_averages()
                     if getattr(e, "device_type", None) == DeviceType.CUDA),
                    key=dev_us, reverse=True)
    prof_us = sum(dev_us(e) for e in events)
    top = [(e.key[:60], e.count, round(dev_us(e), 1)) for e in events[:6]]
    print(f"serve cnn: one B=32 batch: host wall {wall_ms:.3f} ms (median "
          f"of 5 eager batches {[round(w, 3) for w in walls]}), device "
          f"{graph_ms:.3f} ms (CUDA graph replay), so the card is busy "
          f"{100 * graph_ms / wall_ms:.1f}% of an eager batch; profiler: "
          f"{prof_us / 1e3:.3f} ms of device time, top kernels (name, "
          f"calls, us) {top}", flush=True)
    if rel > CNN_SERVE_RTOL:
        fail(f"serve cnn: folded CUDA logits differ from the unfolded CPU "
             f"model by {worst:.3e}, {rel:.3e} of max |logit| {scale:.3e} "
             f"> {CNN_SERVE_RTOL:g}")
    print(f"serve cnn: resnet18_tiny_imagenet NHWC ({n_params} params, BN "
          f"folded) {len(answers)} requests ({snap['requests_completed']} "
          f"samples) per round; max |logit err| vs unfolded CPU "
          f"{worst:.3e} = {rel:.3e} of the logit scale {scale:.3e} (tol "
          f"{CNN_SERVE_RTOL:g}); round 1: {snap['batches']} batches, "
          f"occupancy {snap['batch_occupancy']}, throughput "
          f"{snap['throughput_rps']} samples/s, p50 {snap['p50_ms']} ms, p99 "
          f"{snap['p99_ms']} ms, wall {wall:.3f} s; round 2: "
          f"{snap2['batches']} batches, throughput "
          f"{snap2['throughput_rps']} samples/s, p50 {snap2['p50_ms']} ms, "
          f"p99 {snap2['p99_ms']} ms, wall {wall2:.3f} s; control round on "
          f"a dispatcher that did not warm: {snap3['batches']} batches, "
          f"throughput {snap3['throughput_rps']} samples/s, p50 "
          f"{snap3['p50_ms']} ms, p99 {snap3['p99_ms']} ms, wall "
          f"{wall3:.3f} s; warm-up of {len(engine.bucket_sizes)} buckets "
          f"{warm_s:.3f} s building the engine, {dispatcher_warm_s:.3f} s "
          f"on the dispatcher; kernel launches {counts} (the platform conv "
          f"serves, as in the JAX package) on {card}", flush=True)
    return {"requests": len(answers), "params": n_params,
            "max_abs_err": worst, "round2": snap2, "cold_round": snap3,
            "dispatcher_warmup_s": dispatcher_warm_s,
            "max_rel_err": rel, "logit_scale": scale, "warmup_s": warm_s,
            "batch32_wall_ms": wall_ms, "batch32_device_ms": graph_ms,
            "batch32_profiled_device_ms": prof_us / 1e3, "launches": counts,
            **snap}


# train cnn phase: full-width resnet18_tiny_imagenet, B=32, AdamW under a
# per-batch warmup-cosine lr, on CUDA and on the CPU from the same weights
# and augmented batches.
# - The first step, alone, in fp64 on both devices: loss, logits, every
#   gradient, the BN running statistics and the params after the update
#   within CNN_F64_TOL (of the logit scale, of each tensor's largest value):
#   the port's arithmetic on the card, cuDNN's double convs, to rounding.
#   fp64's rounding (1.1e-16) times the conditioning the fp32 gradients
#   show below (9.3e-2 from rounding of 6e-8: about 1.5e6) is about 2e-10
#   (measured on the card: 1.5e-10), well inside 1e-8.
# - The same step in fp32, the path users run: loss and logits within
#   CNN_STEP_TOL of the logit scale, BN statistics within CNN_STEP_TOL of
#   their scale. Its gradients are ill-conditioned at this initialisation
#   (BN's backward subtracts nearly equal sums): measured on an H100 80GB
#   HBM3 (700 W), the CPU's own fp32 gradients are up to 9.3e-2 of a
#   tensor's largest value from the fp64 ones, the card's cuDNN ones up to
#   9.3e-2 too (4.6e-2 where the CPU's are 1e-2). So each device's fp32
#   gradients are held to the fp64 gradients: the card's worst tensor no
#   further than CNN_GRAD_FACTOR times the CPU's worst. A conv bias that
#   feeds a batchnorm has a gradient that is zero in exact arithmetic (the
#   batch mean takes the bias out): in fp32 it is rounding noise, held below
#   CNN_NOISE_TOL of the model's largest gradient (measured: 5.5e-7).
# - The 8 steps of train_classification_model, run twice on each device:
#   in fp64 (precision mode "fp64") the per-step losses, the final params
#   and the BN running statistics within CNN_F64_RUN_TOL (relative; params
#   of each tensor's largest value): 8 steps amplify fp32's first-step
#   differences of ~1e-6 to ~3e-3 (a factor ~2e3), so fp64's ~2e-10 stay
#   below 1e-6 (measured: 3.1e-10). In fp32, the run users make and the one
#   timed: AdamW's
#   first steps move every param by about lr whatever its gradient, so an
#   element whose gradient is rounding noise steps by +lr on one device and
#   -lr on the other, and the runs drift apart chaotically. Measured: the
#   same 8 fp32 steps on the CPU with 3 threads instead of 8 differ from the
#   8-thread run by 6.9e-4 relative in their losses, 6.8e-3 in their params
#   and 3.6e-2 of a BN statistic's scale; the H100 from the CPU by 2.9e-3
#   in its losses and 1.9e-1 in its BN statistics. So the fp32 run
#   is held to CNN_LOSS_RTOL, every param to Adam's step bound
#   2·steps·lr·(1-b1)/sqrt(1-b2), and the BN statistics to CNN_STATS_RTOL
#   of their scale.
CNN_TRAIN_SAMPLES, CNN_TRAIN_BATCH, CNN_TRAIN_LR = 256, 32, 1e-3
CNN_F64_TOL = 1e-8
CNN_STEP_TOL = 1e-4
CNN_GRAD_FACTOR = 2.0
CNN_NOISE_TOL = 1e-3
CNN_F64_RUN_TOL = 1e-6
CNN_LOSS_RTOL = 1e-2
CNN_STATS_RTOL = 5e-1
CNN_PARAMS = 11_258_088


def phase_train_cnn(card):
    """``train_classification_model`` on full-width
    ``resnet18_tiny_imagenet`` (NCHW, 64x64x3, 200 classes) with the
    Tiny-ImageNet trainer's recipe: AdamW (weight decay 1e-4) under
    ``WarmupCosineAnnealing`` (stepped per batch here: 2 warm-up steps of
    8), softmax cross-entropy, B=32, ``SyntheticClassificationLoader(256,
    (3, 64, 64), 200)`` with ``random_crop(4).horizontal_flip(0.5)`` on the
    loader's hook; on CUDA and on the CPU from the same JAX-layout weights
    (``interop.from_jax``). First one step alone (loss, logits, every
    gradient, BN statistics, params), then the 8 steps (per-step losses,
    final params, BN statistics), each against the CPU at the tolerances
    above; prints the warm steps' samples/s and the top device ops of one
    more step from ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcnn_tpu_torch.core import TrainingConfig, set_precision
    from dcnn_tpu_torch.data import (
        AugmentationBuilder, SyntheticClassificationLoader, decode_batch,
        wire_scale,
    )
    from dcnn_tpu_torch.interop import (
        from_jax, opt_state_to_jax, state_to_jax, to_jax,
    )
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import AdamW, WarmupCosineAnnealing
    from dcnn_tpu_torch.train import (
        batch_generator, create_train_state, make_train_step,
        train_classification_model,
    )

    cfg = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
    params, state = jax_layout(cfg, np.random.default_rng(SEED + 7))
    steps = CNN_TRAIN_SAMPLES // CNN_TRAIN_BATCH
    ce = get_loss("softmax_crossentropy")

    def loader():
        return SyntheticClassificationLoader(
            CNN_TRAIN_SAMPLES, (3, 64, 64), 200, batch_size=CNN_TRAIN_BATCH,
            seed=SEED, augmentation=AugmentationBuilder("NCHW")
            .random_crop(4).horizontal_flip(0.5).build())

    def optimizer():
        return AdamW(CNN_TRAIN_LR, weight_decay=1e-4)

    # the first step alone, on the loader's first batch, in fp64 and fp32
    x, y = next(iter(loader()))

    def first_step(dev, dtype):
        model = from_jax(cfg, params, state, device=dev).to(dtype)
        opt = optimizer()
        loss, logits = make_train_step(model, ce, opt)(
            create_train_state(model, opt), torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(y).to(dev, dtype), CNN_TRAIN_LR)

        def host(t):
            return t.detach().double().cpu().numpy()

        return (float(loss), host(logits),
                {n: host(p.grad) for n, p in model.named_parameters()},
                [host(b) for b in model.buffers()],
                [host(p) for p in model.parameters()], model)

    def rel(a, b):
        return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)

    f64 = {dev: first_step(dev, torch.float64) for dev in ("cuda", "cpu")}
    f32 = {dev: first_step(dev, torch.float32) for dev in ("cuda", "cpu")}
    model = f32["cpu"][5]
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != CNN_PARAMS:
        fail(f"train cnn: {n_params} params, expected {CNN_PARAMS}")
    noise = bias_before_bn(model)
    (lg, og, gg, bg, pg, _), (lc, oc, gc, bc, pc, _) = f64["cuda"], f64["cpu"]
    g_top = max(float(np.abs(g).max()) for g in gc.values())
    scale = float(np.abs(oc).max())
    f64_err = max([abs(lg - lc) / scale, rel(og, oc)]
                  + [float(np.abs(gg[n] - gc[n]).max())
                     / (g_top if n in noise else float(np.abs(gc[n]).max()))
                     for n in gc]
                  + [rel(a, b) for a, b in zip(bg + pg, bc + pc)])
    if not f64_err <= CNN_F64_TOL:
        fail(f"train cnn: first step in fp64, card vs CPU: {f64_err:.3e} > "
             f"{CNN_F64_TOL:g}")
    truth = gc
    (lg, og, gg, bg, _, _), (lc, oc, gc, bc, _, _) = f32["cuda"], f32["cpu"]
    scale = float(np.abs(oc).max())
    step_loss, step_logits = abs(lg - lc) / scale, rel(og, oc)
    step_stats = max(rel(a, b) for a, b in zip(bg, bc))

    def worst(g):
        return max((rel(g[n], truth[n]), n) for n in truth if n not in noise)

    card_grad, cpu_grad = worst(gg), worst(gc)
    step_noise = max(float(np.abs(g[n]).max()) / g_top
                     for g in (gg, gc) for n in noise)
    if not (math.isfinite(lg) and max(step_loss, step_logits, step_stats)
            <= CNN_STEP_TOL and step_noise <= CNN_NOISE_TOL
            and card_grad[0] <= CNN_GRAD_FACTOR * cpu_grad[0]):
        fail(f"train cnn: first step in fp32, card vs CPU: loss "
             f"{step_loss:.3e}, logits {step_logits:.3e} of the logit scale, "
             f"BN statistics {step_stats:.3e} (tol {CNN_STEP_TOL:g}); "
             f"gradients vs fp64: card {card_grad}, CPU {cpu_grad} (factor "
             f"{CNN_GRAD_FACTOR:g}); the {len(noise)} conv biases before a "
             f"BN at {step_noise:.3e} of the largest gradient (tol "
             f"{CNN_NOISE_TOL:g})")

    # the 8 steps through the trainer, in fp64 and in fp32 (timed)
    def train8(dev):
        model = from_jax(cfg, params, state, device=dev)
        ldr, opt = loader(), optimizer()
        sched = WarmupCosineAnnealing(CNN_TRAIN_LR, warmup_steps=2,
                                      total_steps=steps)
        config = TrainingConfig(
            epochs=1, batch_size=CNN_TRAIN_BATCH, learning_rate=CNN_TRAIN_LR,
            scheduler_step="batch", snapshot_dir=None, progress_interval=0,
            device_type=dev)
        losses, stamps = [], []

        def loss_fn(logits, y):
            loss = ce(logits, y)
            losses.append(loss.detach())
            stamps.append(time.perf_counter())  # the step before has synced
            return loss

        ts, trainer = train_classification_model(
            model, opt, loss_fn, ldr, config=config, scheduler=sched)
        return dict(model=model, ts=ts, trainer=trainer, opt=opt, loader=ldr,
                    losses=[float(v) for v in losses], stamps=stamps,
                    params=to_jax(model), state=state_to_jax(model),
                    v=opt_state_to_jax(model, ts.opt_state)["v"])

    set_precision("fp64")
    try:
        d64 = {dev: train8(dev) for dev in ("cuda", "cpu")}
    finally:
        set_precision("parity")
    run64 = max([abs(a - b) / abs(b) for a, b in zip(d64["cuda"]["losses"],
                                                      d64["cpu"]["losses"])]
                + [rel(a, b) for k in ("params", "state")
                   for a, b in zip(_leaves(d64["cuda"][k]),
                                   _leaves(d64["cpu"][k]))])
    if not run64 <= CNN_F64_RUN_TOL:
        fail(f"train cnn: {steps} steps in fp64, card vs CPU: losses, params "
             f"and BN statistics differ by {run64:.3e} > {CNN_F64_RUN_TOL:g}")
    reset_launches()  # the fp32 training path starts here
    gpu = train8("cuda")
    torch.cuda.synchronize()
    counts = launches()  # the path ends
    cpu = train8("cpu")
    if gpu["ts"].step != steps or len(gpu["losses"]) != steps:
        fail(f"train cnn: {gpu['ts'].step} steps, expected {steps}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(gpu["losses"], cpu["losses"]))
    if not (all(math.isfinite(v) for v in gpu["losses"])
            and loss_rel <= CNN_LOSS_RTOL):
        fail(f"train cnn: CUDA losses {gpu['losses']} vs CPU "
             f"{cpu['losses']} (rel {loss_rel:.3e} > {CNN_LOSS_RTOL:g})")
    worst, worst_noise, n_noise, n_all, bins, step_bound = adam_param_diff(
        gpu["params"], cpu["params"], cpu["v"], steps, CNN_TRAIN_LR,
        gpu["opt"].beta1, gpu["opt"].beta2, "train cnn",
        atol=2 * steps * CNN_TRAIN_LR * (1 - gpu["opt"].beta1)
        / math.sqrt(1 - gpu["opt"].beta2))
    stats_rel = max(rel(a, b) for a, b in zip(_leaves(gpu["state"]),
                                              _leaves(cpu["state"])))
    if not stats_rel <= CNN_STATS_RTOL:
        fail(f"train cnn: BN running statistics differ from the CPU run by "
             f"{stats_rel:.3e} of their scale (tol {CNN_STATS_RTOL:g})")
    if any(np.array_equal(a, b)
           for a, b in zip(_leaves(gpu["state"]), _leaves(state))):
        fail("train cnn: the BN running statistics did not move")
    # warm steps: from the third loss to the last, one step each
    warm = gpu["stamps"][2:]
    warm_sps = CNN_TRAIN_BATCH * (len(warm) - 1) / (warm[-1] - warm[0])
    epoch_s = gpu["trainer"].history[0]["seconds"]

    # one more step, profiled: the top device ops of a train step
    model, opt = gpu["model"], gpu["opt"]
    xb = decode_batch(torch.as_tensor(x).cuda(), wire_scale(gpu["loader"]))
    yb = torch.as_tensor(y).cuda()
    step = make_train_step(model, ce, opt)
    gen = batch_generator(SEED, 99, 0, torch.device("cuda"))
    step(gpu["ts"], xb, yb, CNN_TRAIN_LR, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(gpu["ts"], xb, yb, CNN_TRAIN_LR, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    # device time from the kernels alone (an aten op's self device time is
    # its kernels' again); host time from the ops' self CPU time
    events = prof.key_averages()
    kernels = [e for e in events if dev_us(e) > 0
               and getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted((e for e in events
                   if getattr(e, "device_type", None) == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"train cnn: profiled step: wall {wall_ms:.3f} ms (profiler on), "
          f"{len(kernels)} kernels {busy_ms:.3f} ms of device time "
          f"({100 * busy_ms / wall_ms:.1f}% busy); top kernels:", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / 1e3:10.4f} ms  x{e.count:<5d} {e.key[:90]}",
              flush=True)
    print("train cnn: top host ops by self CPU time:", flush=True)
    for e in host[:10]:
        print(f"  {e.self_cpu_time_total / 1e3:10.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    print(f"train cnn: resnet18_tiny_imagenet ({n_params} params, NCHW), "
          f"first step in fp64, card vs CPU: max {f64_err:.3e} (tol "
          f"{CNN_F64_TOL:g}); in fp32: loss {step_loss:.3e}, logits "
          f"{step_logits:.3e} of the logit scale, BN statistics "
          f"{step_stats:.3e} (tol {CNN_STEP_TOL:g}), gradients vs fp64: card "
          f"{card_grad[0]:.3e} ({card_grad[1]}), CPU {cpu_grad[0]:.3e} "
          f"({cpu_grad[1]}), the {len(noise)} conv biases before a BN at "
          f"{step_noise:.3e} of the largest gradient (tol "
          f"{CNN_NOISE_TOL:g}); {steps} steps in fp64, card vs CPU: max "
          f"{run64:.3e} (tol {CNN_F64_RUN_TOL:g}); in fp32 {steps} steps through "
          f"train_classification_model: losses {gpu['losses']} (CPU "
          f"{cpu['losses']}, max rel diff {loss_rel:.3e}, tol "
          f"{CNN_LOSS_RTOL:g}); final params vs CPU max |diff| {worst:.3e}, "
          f"{worst_noise:.3e} on {n_noise} of {n_all} elements with RMS "
          f"gradient < {GRAD_FLOOR:g} (bound {step_bound:.3e}; by "
          f"RMS-gradient band [lo, hi): elements, max |diff|: "
          f"{[(lo, n, d) for lo, (n, d) in zip(ADAM_BANDS, bins)]}); BN "
          f"running statistics max rel diff {stats_rel:.3e} (tol "
          f"{CNN_STATS_RTOL:g}); launches {counts} (the platform conv "
          f"trains, as in the JAX package); train samples/s of the warm "
          f"steps {warm_sps:.1f}, epoch of {steps} steps {epoch_s:.3f} s "
          f"(first steps included) on {card}", flush=True)


CKPT_TRAIN_SAMPLES, CKPT_VAL_SAMPLES, CKPT_EPOCHS = 128, 64, 3
CKPT_REQUESTS = 32


def phase_checkpoint(card):
    """Checkpoints on full-width ``resnet18_tiny_imagenet`` (NCHW) with the
    train cnn phase's recipe (AdamW under WarmupCosineAnnealing stepped per
    batch, B=32, the synthetic loader with ``random_crop(4)
    .horizontal_flip(0.5)``), epochs of 128 train and 64 val samples, every
    epoch checkpointed with async saves, and a best-val snapshot, on CUDA:

    - restore: run A trains 3 epochs; its newest checkpoint, reloaded onto
      the card, equals bit for bit the arrays captured on the card when
      each save was called (params, BN statistics, Adam's m, v and t);
    - resume: run B is crashed by a FaultPlan in epoch 3 and resumed with
      ``resume="auto"`` (a new scheduler stepped to the checkpoint's global
      step: schedulers are not in the checkpoint, as in the JAX package);
      its history and final params track run A at the train cnn phase's
      tolerances, and whether they are bit-equal is printed;
    - cost: the training thread's time in an async save, the copies' time
      on the card, a blocking save, the bytes written and the restore;
    - serving: ``InferenceEngine.from_checkpoint(best-val snapshot,
      fold=True)`` on CUDA answers 32 requests through DynamicBatcher, each
      held to the unfolded model loaded from the same snapshot on the CPU;
    - the committed snapshot ``model_snapshots/mnist_cnn_model`` served on
      the card against the port's CPU engine on a seeded batch."""
    import json as _json
    import tempfile

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import (
        AugmentationBuilder, SyntheticClassificationLoader,
    )
    from dcnn_tpu_torch.interop import (
        from_jax, opt_state_to_jax, state_to_jax, to_jax,
    )
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.optim import AdamW, WarmupCosineAnnealing
    from dcnn_tpu_torch.resilience import (
        CheckpointManager, FaultPlan, InjectedCrash, list_steps,
        restore_latest,
    )
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine
    from dcnn_tpu_torch.train import Trainer, create_train_state, load_checkpoint

    cfg = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
    params, state = jax_layout(cfg, np.random.default_rng(SEED + 11))
    per_epoch = CKPT_TRAIN_SAMPLES // CNN_TRAIN_BATCH
    total = CKPT_EPOCHS * per_epoch

    def loaders():
        aug = (AugmentationBuilder("NCHW").random_crop(4)
               .horizontal_flip(0.5).build())
        return (SyntheticClassificationLoader(
                    CKPT_TRAIN_SAMPLES, (3, 64, 64), 200,
                    batch_size=CNN_TRAIN_BATCH, seed=SEED, augmentation=aug),
                SyntheticClassificationLoader(
                    CKPT_VAL_SAMPLES, (3, 64, 64), 200,
                    batch_size=CNN_TRAIN_BATCH, seed=SEED + 1, shuffle=False))

    def trainer_for(root, **kw):
        model = from_jax(cfg, params, state, device="cuda")
        opt = AdamW(CNN_TRAIN_LR, weight_decay=1e-4)
        sched = WarmupCosineAnnealing(CNN_TRAIN_LR, warmup_steps=2,
                                      total_steps=total)
        config = TrainingConfig(
            epochs=CKPT_EPOCHS, batch_size=CNN_TRAIN_BATCH,
            learning_rate=CNN_TRAIN_LR, scheduler_step="batch",
            snapshot_dir=os.path.join(root, "snap"),
            checkpoint_dir=os.path.join(root, "ckpt"), checkpoint_every=1,
            checkpoint_async=True, progress_interval=0, device_type="cuda",
            **kw)
        trainer = Trainer(model, opt, "softmax_crossentropy", config, sched)
        return trainer, create_train_state(model, opt), sched

    def on_card(model, opt_state):
        return {"params": {n: p.detach().clone()
                           for n, p in model.named_parameters()},
                "buffers": {n: b.detach().clone()
                            for n, b in model.named_buffers()},
                "m": {n: t.clone() for n, t in opt_state["m"].items()},
                "v": {n: t.clone() for n, t in opt_state["v"].items()},
                "t": int(opt_state["t"])}

    def equal(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return a.device == b.device and torch.equal(a, b)
        return a == b

    def rel(a, b):
        return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_", dir=ROOT)
    with tmp:
        # run A: 3 epochs, the arrays captured on the card at each save
        a_dir = os.path.join(tmp.name, "a")
        tr_a, ts_a, _ = trainer_for(a_dir)
        saved, async_costs, called, committed = {}, [], [], {}
        real_save_async = tr_a.checkpoints.save_async

        def save_async(step, model, opt_state=None, optimizer=None,
                       metadata=None):
            saved[step] = on_card(model, opt_state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            called.append(t0)
            fut = real_save_async(step, model, opt_state, optimizer,
                                  metadata)
            t_call = time.perf_counter() - t0
            torch.cuda.synchronize()  # the copies queued on the stream
            async_costs.append((t_call, time.perf_counter() - t0))
            fut.add_done_callback(
                lambda f, s=step: committed.setdefault(s, time.perf_counter()))
            return fut

        tr_a.checkpoints.save_async = save_async
        ts_a = tr_a.fit(ts_a, *loaders())
        torch.cuda.synchronize()
        tr_a.checkpoints.close()
        if sorted(saved) != list(range(1, CKPT_EPOCHS + 1)):
            fail(f"checkpoint: saves at epochs {sorted(saved)}, expected "
                 f"1..{CKPT_EPOCHS}")
        ckpt_a = os.path.join(a_dir, "ckpt")
        t0 = time.perf_counter()
        r = restore_latest(ckpt_a, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if r is None or r.step != CKPT_EPOCHS:
            fail(f"checkpoint: restore_latest gave "
                 f"{None if r is None else r.step}, expected {CKPT_EPOCHS}")
        got = on_card(r.model, r.opt_state)
        if not equal(got, saved[CKPT_EPOCHS]):
            fail("checkpoint: the restored arrays differ from those on the "
                 "card at save time")
        n_params = sum(p.numel() for p in r.model.parameters())
        if n_params != CNN_PARAMS:
            fail(f"checkpoint: {n_params} params, expected {CNN_PARAMS}")
        files = {n: os.path.getsize(os.path.join(r.path, n))
                 for n in sorted(os.listdir(r.path))}
        state_bytes = sum(t.numel() * t.element_size() for part in (
            "params", "buffers", "m", "v") for t in saved[CKPT_EPOCHS][
            part].values())
        if r.metadata["global_step"] != total or len(
                r.metadata["history"]) != CKPT_EPOCHS:
            fail(f"checkpoint: metadata {r.metadata}")
        del r, got

        # a blocking save of run A's final state, for its cost
        with CheckpointManager(os.path.join(tmp.name, "blocking"),
                               keep=1) as mgr:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(CKPT_EPOCHS, tr_a.model, ts_a.opt_state, tr_a.optimizer,
                     {"epoch": CKPT_EPOCHS})
            blocking_s = time.perf_counter() - t0

        # run B: crashed in epoch 3, then resumed
        b_dir = os.path.join(tmp.name, "b")
        tr_b, ts_b, _ = trainer_for(b_dir)
        crash = FaultPlan().arm("train.nonfinite_input",
                                at=(CKPT_EPOCHS - 1) * per_epoch + 1,
                                exc=InjectedCrash)
        try:
            with crash:
                tr_b.fit(ts_b, *loaders())
        except InjectedCrash:
            pass
        else:
            fail("checkpoint: the armed crash in epoch 3 did not fire")
        tr_b.checkpoints.close()
        ckpt_b = os.path.join(b_dir, "ckpt")
        last = max(list_steps(ckpt_b))
        with open(os.path.join(ckpt_b, f"ckpt-{last:08d}",
                               "MANIFEST.json")) as f:
            done = _json.load(f)["metadata"]["global_step"]
        if last != CKPT_EPOCHS - 1 or done != last * per_epoch:
            fail(f"checkpoint: the crashed run left checkpoint {last} at "
                 f"step {done}, expected {CKPT_EPOCHS - 1} at "
                 f"{(CKPT_EPOCHS - 1) * per_epoch}")
        tr_r, ts_r, sched_r = trainer_for(b_dir, resume="auto")
        for _ in range(done):
            sched_r.step()
        ts_r = tr_r.fit(ts_r, *loaders())
        torch.cuda.synchronize()
        tr_r.checkpoints.close()
        if ts_r.step != total or [h["epoch"] for h in tr_r.history] != list(
                range(1, CKPT_EPOCHS + 1)):
            fail(f"checkpoint: the resumed run ended at step {ts_r.step} "
                 f"with epochs {[h['epoch'] for h in tr_r.history]}")
        hist_a = [h["train_loss"] for h in tr_a.history]
        hist_r = [h["train_loss"] for h in tr_r.history]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(hist_r, hist_a))
        if not (all(math.isfinite(v) for v in hist_r)
                and loss_rel <= CNN_LOSS_RTOL):
            fail(f"checkpoint: resumed losses {hist_r} vs run A {hist_a} "
                 f"(rel {loss_rel:.3e} > {CNN_LOSS_RTOL:g})")
        opt = tr_a.optimizer
        p_a, p_r = to_jax(tr_a.model), to_jax(tr_r.model)
        worst, worst_noise, n_noise, n_all, _, step_bound = adam_param_diff(
            p_r, p_a, opt_state_to_jax(tr_a.model, ts_a.opt_state)["v"],
            total, CNN_TRAIN_LR, opt.beta1, opt.beta2, "checkpoint resume",
            atol=2 * total * CNN_TRAIN_LR * (1 - opt.beta1)
            / math.sqrt(1 - opt.beta2))
        s_a, s_r = state_to_jax(tr_a.model), state_to_jax(tr_r.model)
        stats_rel = max(rel(x, y) for x, y in zip(_leaves(s_r), _leaves(s_a)))
        if not stats_rel <= CNN_STATS_RTOL:
            fail(f"checkpoint: resumed BN statistics differ from run A by "
                 f"{stats_rel:.3e} (tol {CNN_STATS_RTOL:g})")
        bit_equal = hist_r == hist_a and all(
            np.array_equal(x, y) for x, y in zip(_leaves(p_r) + _leaves(s_r),
                                                 _leaves(p_a) + _leaves(s_a)))

        # serving from run A's best-val snapshot
        snap = os.path.join(a_dir, "snap", tr_a.model.name)
        cpu_model, _, _, snap_md = load_checkpoint(snap, device="cpu")
        pool = np.random.default_rng(SEED + 12).normal(
            size=(CKPT_REQUESTS, 3, 64, 64)).astype(np.float32)
        with torch.no_grad():
            ref = cpu_model.eval()(torch.from_numpy(pool)).numpy()
        scale = float(np.abs(ref).max())
        reset_launches()  # the serving path starts here
        engine = InferenceEngine.from_checkpoint(snap, fold=True,
                                                 max_batch=32, device="cuda")
        batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
        futs = [batcher.submit(pool[i]) for i in range(CKPT_REQUESTS)]
        answers = [f.result(timeout=300) for f in futs]
        batcher.drain(timeout=300)
        serve_counts = launches()  # the serving path ends here
        serve_rel = 0.0
        for y, want in zip(answers, ref):
            y = np.asarray(y)
            if y.shape != want.shape or not np.all(np.isfinite(y)):
                fail(f"checkpoint serve: an answer of shape {y.shape}, "
                     f"finite={bool(np.all(np.isfinite(y)))}")
            serve_rel = max(serve_rel, float(np.abs(y - want).max()) / scale)
        if serve_rel > CNN_SERVE_RTOL:
            fail(f"checkpoint serve: answers differ from the CPU's unfolded "
                 f"model by {serve_rel:.3e} of the logit scale (tol "
                 f"{CNN_SERVE_RTOL:g})")

    # the committed snapshot, on the card and on the CPU
    mnist_snap = os.path.join(ROOT, "model_snapshots", "mnist_cnn_model")
    xm = np.random.default_rng(SEED + 13).uniform(
        0, 1, size=(32, 1, 28, 28)).astype(np.float32)
    got_m = InferenceEngine.from_checkpoint(
        mnist_snap, fold=True, max_batch=32, device="cuda").infer(
        torch.from_numpy(xm)).cpu().numpy()
    want_m = InferenceEngine.from_checkpoint(
        mnist_snap, fold=True, max_batch=32, device="cpu").infer(
        torch.from_numpy(xm)).numpy()
    mnist_rel = rel(got_m, want_m)
    if not (mnist_rel <= SERVE_TOL
            and (got_m.argmax(-1) == want_m.argmax(-1)).all()):
        fail(f"checkpoint: model_snapshots/mnist_cnn_model on the card vs "
             f"the CPU: {mnist_rel:.3e} of the logit scale (tol "
             f"{SERVE_TOL:g}), top-1 equal "
             f"{bool((got_m.argmax(-1) == want_m.argmax(-1)).all())}")

    async_host = [c[0] * 1e3 for c in async_costs]
    async_copy = [c[1] * 1e3 for c in async_costs]
    # each async save from its call to its commit on the saver thread, and
    # whether the next save was called before it committed
    commit_ms = [(committed[k + 1] - called[k]) * 1e3
                 for k in range(len(called))]
    overlap = [called[k + 1] < committed[k + 1]
               for k in range(len(called) - 1)]
    print(f"checkpoint cost: resnet18_tiny_imagenet state {state_bytes} bytes "
          f"(params, BN statistics, Adam m and v) copied per save; async save "
          f"on the training thread {async_host} ms (call), {async_copy} ms "
          f"(call and its copies on the card), committed by the saver "
          f"thread {commit_ms} ms after the call, the next save called "
          f"before the last one committed {overlap}; blocking save "
          f"{blocking_s * 1e3:.3f} ms; written per checkpoint {files} "
          f"({sum(files.values())} bytes); restore_latest onto the card "
          f"(verify, read, parse, build) {restore_s * 1e3:.3f} ms on {card}",
          flush=True)
    print(f"checkpoint: run A {CKPT_EPOCHS} epochs of {per_epoch} steps, "
          f"losses {hist_a}; newest checkpoint restored onto the card equals "
          f"the arrays at save time bit for bit; run B crashed in epoch "
          f"{CKPT_EPOCHS}, resumed from checkpoint {last} (step {done}): "
          f"losses {hist_r} (max rel diff {loss_rel:.3e}, tol "
          f"{CNN_LOSS_RTOL:g}), params max |diff| {worst:.3e} and "
          f"{worst_noise:.3e} on the {n_noise} of {n_all} elements with RMS "
          f"gradient < {GRAD_FLOOR:g} (bound {step_bound:.3e}), BN "
          f"statistics {stats_rel:.3e} (tol {CNN_STATS_RTOL:g}); bit-equal "
          f"to run A: {bit_equal}; served the best-val snapshot (epoch "
          f"{snap_md['epoch']}, val_acc {snap_md['val_acc']}) folded, "
          f"{CKPT_REQUESTS} requests through DynamicBatcher: max |diff| "
          f"{serve_rel:.3e} of the logit scale vs the unfolded CPU model (tol "
          f"{CNN_SERVE_RTOL:g}), launches {serve_counts}; "
          f"model_snapshots/mnist_cnn_model card vs CPU {mnist_rel:.3e} (tol "
          f"{SERVE_TOL:g}), top-1 equal", flush=True)
    return {"async_call_ms": async_host, "async_copy_ms": async_copy,
            "async_commit_ms": commit_ms, "async_overlap": overlap,
            "blocking_ms": blocking_s * 1e3, "restore_ms": restore_s * 1e3,
            "bytes_written": sum(files.values()), "state_bytes": state_bytes,
            "bit_equal": bit_equal}


def bias_before_bn(model):
    """Names (as ``named_parameters`` gives them) of the conv biases that
    feed a batchnorm directly: their gradient is zero in exact arithmetic,
    since the batch mean takes the bias out."""
    names = set()

    def walk(layers, prefix):
        for i, l in enumerate(layers):
            if l.type_name == "residual_block":
                walk(l.layers, f"{prefix}{i}.layers.")
                walk(l.shortcut, f"{prefix}{i}.shortcut.")
            elif (l.type_name == "conv2d" and l.use_bias
                  and i + 1 < len(layers)
                  and layers[i + 1].type_name == "batchnorm"):
                names.add(f"{prefix}{i}.b")

    walk(model.layers, "layers.")
    return names


def _leaves(tree):
    """The arrays of a nested tuple/dict pytree, in order."""
    import numpy as np

    if isinstance(tree, dict):
        return [a for k in tree for a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _leaves(t)]
    return [np.asarray(tree)]


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "dcnn_tpu_torch")):
        fail(f"no dcnn_tpu_torch package in {ROOT}: run this script from a "
             f"checkout of the repo, which builds the kernels from its sources")
    card = phase_device()
    sys.path.insert(0, ROOT)
    import torch

    from dcnn_tpu_torch.core import set_precision
    from dcnn_tpu_torch.ops import _kernels

    set_precision("parity")
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    print(f"build: {sorted(_kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fwd_cases = phase_kernels()
    bwd_cases = phase_bwd_kernels()
    conv_cases = phase_conv_kernels()
    site_counts, site_worst, site_cases = phase_model_sites(card)
    serve = phase_serve(card)
    train = phase_train(card)
    serve_cnn = phase_serve_cnn(card)
    phase_train_cnn(card)
    phase_checkpoint(card)

    def row(name, source, replaces, cases, by_path):
        model_case = cases[0]  # the model's shape: B=32, H=4, S=32, D=16
        long = next(c for c in cases if c["case"] == "long context")
        d256 = next(c for c in cases if c["case"] == "d256 long context")
        d512 = next(c for c in cases if c["case"] == "d512 long context")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": model_case["ms"], "plain_ms": model_case["plain_ms"],
                "bound_ms": model_case["bound_ms"],
                "bound_by": model_case["bound_by"],
                "library_ms": model_case["library_ms"],
                "long_context": {k: long[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                "d256_long_context": {k: d256[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                "d512_long_context": {k: d512[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                "cases": cases}

    def site_row(name, source, replaces):
        """Rows 4-7: times summed over the model's sites in fp32, each
        site timed on its own; the race and the bf16 sites are in
        ``cases``."""
        sites = [c for c in site_cases[name] if c["dtype"] == "float32"]
        total = {k: sum(c[k] for c in sites)
                 for k in ("ms", "plain_ms", "bound_ms")}
        lib = (None if name == "fused_scale_bias_relu"
               else sum(c["library_ms"] for c in sites))
        by = max(sites, key=lambda c: c["bound_ms"])["bound_by"]
        cases = conv_cases[name] + site_cases[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": site_counts[name],
                "launches_by_path": {"model_sites": site_counts[name],
                                     "serve_cnn": serve_cnn["launches"][name]},
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "max_rel_err_at_model_sites": site_worst[name],
                "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"], "bound_by": by,
                "library_ms": lib, "cases": cases}

    tl = train["launches"]
    tc_src = "dcnn_tpu_torch/ops/csrc/conv3x3_tc.cu"
    kernels = [
        row("flash_fwd", "dcnn_tpu_torch/ops/csrc/flash_fwd.cu",
            "dcnn_tpu/ops/attention.py:297", fwd_cases,
            {"serve": serve["launches"], "train": tl["flash_fwd"]}),
        row("flash_bwd_dq", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:460", bwd_cases["dq"],
            {"serve": 0, "train": tl["flash_bwd_dq"]}),
        row("flash_bwd_dkv", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:478", bwd_cases["dkv"],
            {"serve": 0, "train": tl["flash_bwd_dkv"]}),
        site_row("conv3x3_s1", tc_src, "dcnn_tpu/ops/pallas/conv.py:82"),
        site_row("conv3x3_s1_pairs", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:173"),
        site_row("conv3x3_s1_bnrelu_in", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:209"),
        site_row("fused_scale_bias_relu", "dcnn_tpu_torch/ops/csrc/fused.cu",
                 "dcnn_tpu/ops/pallas/fused.py:49"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
