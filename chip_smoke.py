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
   wide modes (the forward above D 256, the dQ and dK/dV kernels above 256
   and in fp32 above 128, all on wgmma): the fp32 backward at D 192 and 256
   (B2 H8 S2048 D256 fp32 causal timed against SDPA and its bound), and D
   320, 512 and 1000 in both types, causal and not (B2 H8 S2048 D512 bf16
   causal timed against SDPA and its bound); each case names the kernel
   that ran it (the class kernel or its wide mode); then
   ``MultiHeadAttentionLayer(impl="flash")`` at E=1024, forward and
   backward on the card against the same layer on the CPU: 2 heads (D
   512) in bf16 mode and 4 heads (D 256) at parity precision, the launch
   counters and plans showing the wide modes ran;
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
   ``model_snapshots/mnist_cnn_model`` on the card against the CPU;
11. train feed: the device-side data feed on full-width
   ``resnet18_tiny_imagenet`` with the Tiny-ImageNet trainer's RESIDENT
   recipe (``phase_train_feed``): the 1,228,800,000-byte Tiny-ImageNet
   train split staged and a resident epoch of 32 steps run with nothing
   inside it waiting for the card, resident against the per-step loop,
   ``Trainer.fit`` over a resident split (resident eval equal to the host
   eval), the chunked path through ``PrefetchLoader(stage_batches=4,
   feed_workers=2)`` held to the per-step path with cuDNN deterministic
   (bit-equal, else its rel, printed; and ``mha_classifier`` chunked, the
   flash kernels counted there), the full-split resident epoch again with
   the tracer on and still nothing waiting for the card, streaming shards bit-identical to ``serial_shards``
   through the transfer engine and a 2-process worker pool, and per feed
   the warm samples/s, the card's busy share, launches and copies per step
   and host-to-device bytes per step, with the card's name and power
   limit. The native host helpers (``dcnn_tpu_torch/native``) build with
   ``g++`` beside the kernels;
12. serve int8: full-width ``resnet18_tiny_imagenet`` (NHWC, random
   weights and BN statistics) and ``mha_classifier``, each quantized once
   on the CPU with a 64-sample calibration batch and served on the card
   through ``InferenceEngine.from_model(..., int8_calib=...)`` behind
   ``DynamicBatcher`` with 80 open-loop requests (``serve/traffic.py``):
   p50/p99, the launch counters over that path (``conv_int8_fused`` 21 a
   batch plus the K-split reduces, mode A ``conv_int8`` 0, the weights
   packed once a layer; the flash forward 2 a batch on the attention
   classifier), the engine's quantized params equal to the one
   quantization, logits bit-identical at every batch 1..32 and near the
   CPU int8 engine; ``conv_int8.cu`` in both modes (A: int8 -> int32
   against its plain version; B, the fused layer: against the unfused
   chain on the card) bit for bit at the 21 conv sites at B=32 and B=256
   (hooked inputs; B=32 also in bf16) and at ragged shapes (NCHW, NHWC,
   bf16), each split-K site also against the same site unsplit; each
   timed (A, B, the unfused chain of separate launches, the plain versions) beside both
   bounds and bf16 ``F.conv2d`` of the same shape as context; the CUDA
   kernels of one B=32 and one B=256 int8 engine batch counted by
   ``torch.profiler``, fused and as the unfused chain; the int8 engine's B=32
   and B=256 batch (fused and chain) beside the folded fp32 and bf16
   engines';
13. decode: full-width ``mha_decoder`` through ``DecodeEngine(max_slots=8,
   page_size=8, max_pages_per_seq=8)`` and a threaded
   ``ContinuousBatcher``: 32 staggered sequences whose tokens must equal
   ``decode_reference`` on the card and on the CPU (a divergence prints
   the logit margin), a page-starved engine that must preempt and still
   match; tokens/s, TTFT p50/p99, slot occupancy, the pool's pages and
   bytes and each lattice point's step time;
14. obs: the observability core (``phase_obs``): ``mha_classifier``
   trained with the tracer on, ``profiler=NORMAL``, ``flight_dir`` and
   ``debug=True`` (bit-equal to the plain run, the flash kernels
   launched, the LayerProfiler table, the JAX trainer's span names, a NaN
   batch writing one ``nonfinite_guard`` bundle and raising under debug
   mode); int8 ``resnet18_tiny_imagenet`` behind
   ``DynamicBatcher.start_telemetry`` scraped over HTTP while it serves
   (``conv_int8_fused`` launched, the card's memory gauges, ``/healthz``
   503 after drain, logits equal to the untraced engine's); decode with the
   tracer on (a ``decode.step`` span a step); the tracer's cost on the mha
   train step and the int8 B=32 batch; the LayerProfiler table of one
   ResNet-18 NCHW fp32 B=32 profiled step;
15. export: the served program as an artifact and the AOT cache
   (``phase_export``): int8 ``resnet18_tiny_imagenet`` and fp32
   ``mha_classifier`` exported on the card (``nn/export.py``; the kernels
   are ``dcnn::`` custom ops) and served through
   ``InferenceEngine.from_artifact`` behind ``DynamicBatcher``, held to
   engines over the live models at every bucket (logits bit for bit; the
   same launches a replay: ``conv_int8_fused`` at the 21 sites, the flash
   forward twice; ``pack_int8_weight`` never); a cold and a warm start
   through a temporary AOT cache, each in a process of its own that first
   serves the artifact file with building a model and reading a checkpoint
   refused, then starts an engine with ``from_model(aot_cache=)``: the cold
   one commits the libraries ``main`` built and the exported program, the
   warm one, with ``nvcc`` and ``CUDA_HOME`` unreachable and an empty build
   directory, restores every library and loads the program, tracing
   nothing; a flipped byte of a cached program quarantined and exported
   again. The checkpoint phase gates that no async save from the third on
   pins new host memory.
16. pipeline: model splitting and the host-driven pipeline
   (``phase_pipeline``): full-width ``mha_classifier`` (B=64, M=4, 2
   FLOP-balanced stages, an attention block in each) and
   ``resnet18_tiny_imagenet`` (NCHW, B=128, M=8, 4 stages) trained through
   ``train_pipeline_epoch`` under the sync and semi-async schedules, each
   stage on its own CUDA stream, held to the unsplit
   ``make_train_step(num_microbatches=M)`` on the card (cuDNN
   deterministic) and, for ``mha_classifier``, to the same pipeline on the
   CPU; the flash launch counters show rows 1-3 ran once a stage holding
   attention and microbatch; samples/s and each stage's load report;
17. compiled pipeline (``phase_compiled_pipeline``):
   ``HeteroCompiledPipeline`` over the same ResNet-18 (S=4, M=8, B=128),
   GPipe and 1F1B, fp32 and bf16 wire, each step one CUDA graph held bit
   for bit to its eager twin, fp32 within 2e-5 of the host-driven
   coordinator, 1F1B's peak device memory below GPipe's; one homogeneous
   ``SequentialStageStack``. The pipeline phases' launches, samples/s,
   load reports and memory print as ``{"pipeline": {...}}`` on a line
   before the kernels line.

Compiled sessions (CUDA graphs, ``dcnn_tpu_torch/core/graphs.py``): in
serve, serve cnn, serve int8 and decode every bucket or lattice point is a
captured graph whose replay is held to the eager call of the same input
bit for bit (logits; tokens, logits and pool writes for decode); in train,
train cnn and train feed (per-step, chunked, resident) the replayed runs
to their eager twins (losses, params, BN statistics, optimizer state;
cuDNN deterministic where convs train); in checkpoint a resumed run, in
obs a guarded epoch with a NaN batch, likewise. Those phases print the
launches a batch or step adds to the counters (a replay adds its
capture's count), eager against replayed host wall for the same work, the
card's busy share of each and each graph pool's bytes ("... graphs: ..."
lines).

Then it prints ``{"kernels": [...]}`` (rows 1-8, row 8 ``conv_int8_fused``
with mode A ``conv_int8`` inside it; each row's ``launches_by_path`` has
the obs phase's launches under ``"obs"``, the export phase's under
``"export"`` and the pipeline phase's under ``"pipeline"`` where they
launch the row) on
a line of its own and, last,
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
              "tfloat32": 495e12,   # TF32 tensor cores, dense
              "int8": 1979e12}      # int8 tensor cores, dense (ops/s)
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


def replay_vs_eager(replayed, eager, calls: int) -> dict:
    """The same work (a batch or a step a call, each ending in the host's
    read of its result, as a caller makes it) replayed from CUDA graphs and
    run eagerly: host wall ms a call over ``calls`` calls, in the order
    eager, replayed, replayed, eager (both runs of each kept), then each
    profiled over ``calls`` calls (``profiled``: the card's busy ms and
    share a call, and the kernels CUPTI saw a call), and the launch
    counters' advance over one more replayed call."""
    import torch

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    def many(fn):
        return lambda: [fn() for _ in range(calls)]

    e1, r1, r2, e2 = (wall(f) for f in (eager, replayed, replayed, eager))
    pe, pr = profiled(many(eager), calls), profiled(many(replayed), calls)
    before = launches()
    replayed()
    counted = {k: v - before[k] for k, v in launches().items()
               if v != before[k]}
    return {"eager_ms": [e1, e2], "replayed_ms": [r1, r2],
            "counted_launches_per_call": counted,
            "eager_busy_ms": pe["busy_ms"], "replayed_busy_ms": pr["busy_ms"],
            "eager_busy_share": pe["busy_share"],
            "replayed_busy_share": pr["busy_share"],
            "eager_cupti_kernels": pe["launches_per_step"],
            "replayed_cupti_kernels": pr["launches_per_step"]}


def check_engine_graphs(engine, what: str, rng) -> dict:
    """Every bucket of ``engine`` is a captured graph whose replay equals
    the eager forward of the same random input bit for bit (fatal
    otherwise). Returns the launches a replayed batch adds to the counters
    (its capture's delta) by bucket, checked against the counters, and the
    pool's bytes."""
    import numpy as np
    import torch
    from dcnn_tpu_torch.core import get_precision_mode

    per_batch = {}
    for b in engine.bucket_sizes:
        s = engine.sessions.get((b, get_precision_mode()))
        if s is None or s.graph is None:
            fail(f"{what}: bucket {b} was not captured as a CUDA graph")
        x = torch.from_numpy(rng.normal(size=(b, *engine.input_shape))
                             .astype(np.float32)).cuda()
        before = launches()
        got = engine.run_padded(x)
        moved = {k: v - before[k] for k, v in launches().items()
                 if v != before[k]}
        if moved != s.launch_names():
            fail(f"{what}: bucket {b}'s replay moved the counters by "
                 f"{moved}, its capture counted {s.launch_names()}")
        if not torch.equal(got, engine._forward(x)):
            fail(f"{what}: bucket {b}'s replay differs from the eager "
                 f"forward of the same input")
        per_batch[b] = moved
    return {"buckets_bit_equal": len(per_batch),
            "launches_per_batch": per_batch,
            "pool_bytes": engine.graphs.bytes()}


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
    # ragged D; the fp32 backward at 128 < D <= 256 runs both backward
    # kernels' wide modes
    ("d256 long context", 2, 8, 2048, 2048, 256, True, "bfloat16", 5),
    ("d256 fp32 long context", 2, 8, 2048, 2048, 256, True, "float32", 3),
    ("d256 ragged", 1, 2, 200, 333, 200, False, "bfloat16", 50),
    ("d256 fp32", 1, 2, 300, 300, 256, False, "float32", 20),
    ("d256 fp32 causal", 1, 2, 150, 330, 256, True, "float32", 20),
    ("d192 fp32 causal", 1, 2, 150, 330, 192, True, "float32", 20),
    # above 256 every kernel runs its wide mode (S and dP, or S^T and dP^T,
    # summed over slices streamed through the ring, the outputs in column
    # groups); both types, causal and not, one ragged shape each
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
             "plan": str(plan), "kernel": ("flash_fwd_wide_kernel"
                                           if plan.slices else
                                           "flash_fwd_kernel"),
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
                "plan": str(part), "kernel": (f"flash_bwd_{kname}_wide_kernel"
                                              if part.slices else
                                              f"flash_bwd_{kname}_kernel"),
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


def phase_wide_layer():
    """``MultiHeadAttentionLayer(impl="flash", causal=True)`` at E=1024
    (B=2, S=256), forward and backward on the card and on the CPU from the
    same weights and inputs: 2 heads (D 512) in bf16 mode and 4 heads (D
    256) at parity precision (fp32). The card's run launches the forward,
    dQ and dK/dV kernels once each (the counts are set to 0 just before
    and read just after), and their plans are the wide modes (the forward
    at D 512; dQ and dK/dV at both). Output, input gradient and
    every parameter gradient within TOL of the CPU's, relative to its
    largest value (the key bias's, 0 in exact arithmetic, to the other
    parameter gradients'). Returns the summed launches of both runs."""
    import copy

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import cast_to_compute, set_precision
    from dcnn_tpu_torch.nn import MultiHeadAttentionLayer
    from dcnn_tpu_torch.ops import _kernels

    b, s, e = 2, 256, 1024
    rng = np.random.default_rng(SEED + 12)
    total = {}
    for heads, mode, dtn in ((2, "bf16", "bfloat16"), (4, "parity", "float32")):
        d, dt = e // heads, getattr(torch, dtn)
        fwd, bwd = (_kernels.flash_plan(s, s, d, dt),
                    _kernels.flash_bwd_plan(s, s, d, dt))
        if not (bwd.dkv.slices and bwd.dq.slices and bwd.dq.rows == 64
                and bwd.dq.stages >= 2 and (fwd.slices or d <= 256)):
            fail(f"wide layer D {d} {dtn}: not the wide plans: {fwd}, {bwd}")
        x = rng.normal(size=(b, s, e)).astype(np.float32)
        w = rng.normal(size=(b, s, e)).astype(np.float32)
        set_precision(mode)
        try:
            layer = MultiHeadAttentionLayer(num_heads=heads, causal=True)
            layer.init((s, e), generator=torch.Generator().manual_seed(SEED))
            runs = {}
            for dev in ("cpu", "cuda"):
                lay = copy.deepcopy(layer).to(dev)
                xt = cast_to_compute(torch.from_numpy(x)).to(dev)
                xt.requires_grad_()
                if dev == "cuda":
                    reset_launches()
                y = lay(xt)
                (y.float() * torch.from_numpy(w).to(dev)).sum().backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = {k: v for k, v in launches().items()
                              if k.startswith("flash")}
                runs[dev] = {"out": y.detach().float().cpu(),
                             "dx": xt.grad.float().cpu(),
                             **{n: p.grad.float().cpu()
                                for n, p in lay.named_parameters()}}
        finally:
            set_precision("parity")
        if counts != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
            fail(f"wide layer D {d} {dtn}: launches {counts}, want one each")
        # the key bias's gradient is 0 in exact arithmetic (a per-row shift
        # of the scores), so its own largest value is rounding noise: it is
        # held on the scale of the other parameter gradients
        ref = runs["cpu"]
        params = [n for n in ref if n not in ("out", "dx", "bk")]
        param_top = max(ref[n].abs().max().item() for n in params)
        errs = {}
        for name, want in ref.items():
            top = param_top if name == "bk" else want.abs().max().item()
            rel = ((runs["cuda"][name] - want).abs().max().item()
                   / (top if top > 0 else 1.0))
            if not (math.isfinite(rel) and rel <= TOL[dtn]):
                fail(f"wide layer D {d} {dtn}: {name} on the card against the "
                     f"CPU {rel:.3e} of its largest value > {TOL[dtn]:g}")
            errs[name] = float(f"{rel:.3e}")
        worst = max(errs.values())
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        print(f"wide layer: MultiHeadAttentionLayer E={e} heads={heads} D={d} "
              f"{mode} B={b} S={s} causal: output and {len(ref) - 1} "
              f"gradients within {worst:.3e} of the CPU (tol {TOL[dtn]:g}; "
              f"{errs}); launches {counts}; {fwd}; dkv {bwd.dkv}; dq {bwd.dq}",
              flush=True)
    return total


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
    graphs = check_engine_graphs(engine, "serve", rng)
    x32 = torch.from_numpy(pool[:32]).cuda()
    graphs["b32"] = replay_vs_eager(lambda: engine.run_padded(x32).cpu(),
                                    lambda: engine._forward(x32).cpu(), 20)
    print(f"serve graphs: every bucket's replay equals its eager forward "
          f"bit for bit; {json.dumps(graphs)} on {card}", flush=True)
    return {"launches": launches_fwd, "warm_launches": warm_launches,
            "served_launches": served_launches, "batches": n_batches,
            "requests": requests, "max_abs_err": worst, "graphs": graphs,
            **snap}


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

    def run(dev, jit=True, **kw):
        model = from_jax(cfg, params, device=dev)
        opt = Adam(1e-3)
        ts = create_train_state(model, opt)
        loader = ArrayDataLoader(x, y, batch_size=batch, shuffle=True,
                                 seed=SEED)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=epochs, batch_size=batch, snapshot_dir=None,
            progress_interval=0, device_type=dev, **kw))
        if not jit:  # the eager twin
            trainer.train_step = eager_step(trainer)
        return trainer, ts, loader, model

    # crashed in epoch 2, resumed; the graph run, then its eager twin
    for jit in (True, False):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mha_",
                                         dir=ROOT) as ckpt:
            kw = dict(checkpoint_dir=ckpt, checkpoint_every=1)
            trainer, ts, loader, _ = run("cuda", jit, **kw)
            crash = FaultPlan().arm("train.nonfinite_input",
                                    at=per_epoch + 2, exc=InjectedCrash)
            try:
                with crash:
                    trainer.fit(ts, loader)
            except InjectedCrash:
                pass
            else:
                fail("train: the armed crash in epoch 2 did not fire")
            trainer.checkpoints.close()
            trainer, ts, loader, model = run("cuda", jit, resume="auto",
                                             **kw)
            reset_launches()  # the resumed training path starts here
            ts = trainer.fit(ts, loader)
            torch.cuda.synchronize()
            if jit:
                counts = {k: v for k, v in launches().items()  # path ends
                          if k.startswith("flash_")}
            trainer.checkpoints.close()
        runs["cuda" if jit else "eager"] = (
            trainer.history, to_jax(model),
            opt_state_to_jax(model, ts.opt_state), ts.step)
    twin = same_run(runs["cuda"], runs["eager"])
    if twin:
        fail(f"train: the resumed run's graph replays differ from its eager "
             f"twin: {twin}")
    walls = step_walls(from_jax(cfg, params, device="cuda"), Adam(1e-3),
                       torch.from_numpy(x[:batch]).cuda(),
                       torch.from_numpy(y[:batch]).cuda(), 1e-3, 20)
    print(f"train graphs: the crashed and resumed run (checkpoints, 16 "
          f"steps) bit-equal to its eager twin (losses, params, Adam state); "
          f"one B={batch} step replayed vs eager: {json.dumps(walls)} on "
          f"{card}", flush=True)
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
            "samples_per_s": sps, "graphs": walls}


def eager_step(trainer):
    """``trainer``'s train step with ``jit=False``: the eager twin a
    replayed run is held to."""
    from dcnn_tpu_torch.train import make_train_step

    return make_train_step(trainer.model, trainer.loss_fn, trainer.optimizer,
                           trainer.config.num_microbatches,
                           guard=trainer.guard is not None, jit=False)


def same_run(a, b) -> str:
    """'' where two runs' (history, params, optimizer state, steps) are
    equal bit for bit (losses as floats, arrays exactly), else what
    differs."""
    import numpy as np

    (ha, pa, sa, na), (hb, pb, sb, nb) = a, b
    if na != nb:
        return f"steps {na} vs {nb}"
    la, lb = ([h["train_loss"] for h in h_] for h_ in (ha, hb))
    if la != lb:
        return f"losses {la} vs {lb}"
    for what, u, v in (("params", pa, pb), ("optimizer state", sa, sb)):
        for i, (c, d) in enumerate(zip(_leaves(u), _leaves(v))):
            if not np.array_equal(c, d):
                return (f"{what} leaf {i}: max |diff| "
                        f"{float(np.abs(c - d).max()):.3e}")
    return ""


def step_walls(model, opt, x, y, lr, calls, gen=False) -> dict:
    """``replay_vs_eager`` over train steps of ``model`` on one batch:
    ``make_train_step`` with and without ``jit`` (the graph's eager first
    call and capture made first), the loss read each step, a fresh
    generator a step where ``gen``."""
    import torch

    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.train import create_train_state, make_train_step

    ts = create_train_state(model, opt)
    ce = get_loss("softmax_crossentropy")
    graph = make_train_step(model, ce, opt)
    eager = make_train_step(model, ce, opt, jit=False)

    def run(step):
        g = (torch.Generator(device="cuda").manual_seed(ts.step) if gen
             else None)
        return float(step(ts, x, y, lr, g)[0])

    run(graph)
    run(graph)
    out = replay_vs_eager(lambda: run(graph), lambda: run(eager), calls)
    out["pool_bytes"] = graph.pool.bytes()
    return out


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
        engine._forward(x32)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[2]
    graph_ms = device_ms(lambda: engine._forward(x32), 5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine._forward(x32)
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
          f"{CNN_SERVE_RTOL:g}); round 1 (replayed graphs): {snap['batches']} batches, "
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
    graphs = check_engine_graphs(engine, "serve cnn", rng)
    graphs["b32"] = replay_vs_eager(lambda: engine.run_padded(x32).cpu(),
                                    lambda: engine._forward(x32).cpu(), 20)
    print(f"serve cnn graphs: every bucket's replay equals its eager "
          f"forward bit for bit; {json.dumps(graphs)} on {card}",
          flush=True)
    return {"requests": len(answers), "params": n_params, "graphs": graphs,
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
        Trainer, batch_generator, create_train_state, make_train_step,
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

    # the 8 steps through the trainer (train_classification_model's
    # Trainer.fit), in fp64 and in fp32 (timed); jit=False: the eager twin
    def train8(dev, jit=True):
        model = from_jax(cfg, params, state, device=dev)
        ldr, opt = loader(), optimizer()
        sched = WarmupCosineAnnealing(CNN_TRAIN_LR, warmup_steps=2,
                                      total_steps=steps)
        config = TrainingConfig(
            epochs=1, batch_size=CNN_TRAIN_BATCH, learning_rate=CNN_TRAIN_LR,
            scheduler_step="batch", snapshot_dir=None, progress_interval=0,
            device_type=dev)
        losses, stamps = [], []
        trainer = Trainer(model, opt, ce, config, sched)
        step = trainer.train_step if jit else eager_step(trainer)

        def recorded(*a):
            out = step(*a)
            losses.append(out[0])
            stamps.append(time.perf_counter())  # the step before has synced
            return out

        trainer.train_step = recorded
        ts = trainer.fit(create_train_state(model, opt), ldr)
        trainer.train_step = step
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
    # replays against the eager twin, cuDNN deterministic
    torch.backends.cudnn.deterministic = True
    try:
        twins = [train8("cuda", jit) for jit in (True, False)]
    finally:
        torch.backends.cudnn.deterministic = False
    twin = same_run(*([t["trainer"].history, t["params"], t["state"],
                       t["ts"].step] for t in twins))
    if twin or [float(v) for v in twins[0]["losses"]] != [
            float(v) for v in twins[1]["losses"]]:
        fail(f"train cnn: {steps} replayed steps differ from the eager twin "
             f"(cuDNN deterministic): {twin or 'per-step losses'}")
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

    # one more step, eager and profiled: the top device ops of a train step
    model, opt = gpu["model"], gpu["opt"]
    xb = decode_batch(torch.as_tensor(x).cuda(), wire_scale(gpu["loader"]))
    yb = torch.as_tensor(y).cuda()
    step = make_train_step(model, ce, opt, jit=False)
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
    walls = step_walls(from_jax(cfg, params, state, device="cuda"),
                       optimizer(), xb, yb, CNN_TRAIN_LR, 10)
    print(f"train cnn graphs: {steps} steps through the trainer replayed "
          f"from the step's graph bit-equal to its eager twin (losses, "
          f"params, BN statistics; cuDNN deterministic); one B=32 step "
          f"replayed vs eager: {json.dumps(walls)}; the graph pool "
          f"{twins[0]['trainer'].train_step.pool.bytes()} B on {card}",
          flush=True)
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
    import shutil
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
        pinned = []  # pinned host buffers made so far, after each save
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
            pinned.append(tr_a.checkpoints.pinned.allocations)
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
        # the resume replayed from the step's graph and its eager twin,
        # each from a copy of the crashed run's directory, cuDNN
        # deterministic
        twins, twin_profile = [], {}
        torch.backends.cudnn.deterministic = True
        try:
            for jit in (True, False):
                d = os.path.join(tmp.name, f"b_jit{int(jit)}")
                shutil.copytree(b_dir, d)
                tr_t, ts_t, sched_t = trainer_for(d, resume="auto")
                if not jit:
                    tr_t.train_step = eager_step(tr_t)
                for _ in range(done):
                    sched_t.step()
                out = []
                twin_profile["replayed" if jit else "eager"] = {
                    k: round(v, 4) for k, v in profiled(
                        lambda: out.append(tr_t.fit(ts_t, *loaders())),
                        per_epoch).items()}
                ts_t = out[0]
                torch.cuda.synchronize()
                tr_t.checkpoints.close()
                if jit:
                    twin_profile["launches_per_step"] = {
                        k: v for _, ss in tr_t.train_step._sessions.values()
                        for sess in ss
                        for k, v in sess.launch_names().items()}
                twins.append((tr_t.history, (to_jax(tr_t.model),
                                             state_to_jax(tr_t.model)),
                              opt_state_to_jax(tr_t.model, ts_t.opt_state),
                              ts_t.step))
        finally:
            torch.backends.cudnn.deterministic = False
        twin = same_run(*twins)
        if twin:
            fail(f"checkpoint: the resumed run replayed from graphs differs "
                 f"from its eager twin (cuDNN deterministic): {twin}")
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
    # two snapshots in flight reuse their pinned sets: from the third save
    # on, no save pins new host memory
    if len(pinned) > 2 and any(n != pinned[1] for n in pinned[2:]):
        fail(f"checkpoint: pinned host buffers made by each async save "
             f"{pinned}: the third and later saves pinned new memory")
    # each async save from its call to its commit on the saver thread, and
    # whether the next save was called before it committed
    commit_ms = [(committed[k + 1] - called[k]) * 1e3
                 for k in range(len(called))]
    overlap = [called[k + 1] < committed[k + 1]
               for k in range(len(called) - 1)]
    print(f"checkpoint cost: resnet18_tiny_imagenet state {state_bytes} bytes "
          f"(params, BN statistics, Adam m and v) copied per save; async save "
          f"on the training thread {async_host} ms (call), {async_copy} ms "
          f"(call and its copies on the card), pinned buffers made after "
          f"each save "
          f"{pinned} (none from the third on), committed by the saver "
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
          f"to run A: {bit_equal}; the resume from the crashed run's "
          f"checkpoint replayed from graphs bit-equal to its eager twin "
          f"(losses, params, BN statistics, AdamW state; cuDNN "
          f"deterministic), the resumed epoch (its {per_epoch} steps, "
          f"eval and save) profiled per step "
          f"{json.dumps(twin_profile)}; served the best-val snapshot (epoch "
          f"{snap_md['epoch']}, val_acc {snap_md['val_acc']}) folded, "
          f"{CKPT_REQUESTS} requests through DynamicBatcher: max |diff| "
          f"{serve_rel:.3e} of the logit scale vs the unfolded CPU model (tol "
          f"{CNN_SERVE_RTOL:g}), launches {serve_counts}; "
          f"model_snapshots/mnist_cnn_model card vs CPU {mnist_rel:.3e} (tol "
          f"{SERVE_TOL:g}), top-1 equal", flush=True)
    return {"async_call_ms": async_host, "async_copy_ms": async_copy,
            "pinned_after_each_save": pinned,
            "async_commit_ms": commit_ms, "async_overlap": overlap,
            "blocking_ms": blocking_s * 1e3, "restore_ms": restore_s * 1e3,
            "bytes_written": sum(files.values()), "state_bytes": state_bytes,
            "bit_equal": bit_equal}


FEED_BATCH, FEED_LR, FEED_CLASSES = 32, 1e-3, 200
FEED_SPLIT = 100_000          # Tiny-ImageNet's train split, 1,228,800,000 B
FEED_TRAIN, FEED_VAL = 256, 256
FEED_RESIDENT_STEPS = 32
FEED_STREAM, FEED_SHARD_BATCHES = 2048, 8
FEED_CHUNK = 4                # stage_batches and steps_per_dispatch
FEED_PROFILE_STEPS = 4
FEED_KEYS = {"epoch", "train_loss", "train_acc", "val_loss", "val_acc",
             "seconds", "lr"}


def _dev_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def profiled(fn, steps: int) -> dict:
    """``fn()`` once under ``torch.profiler``, synchronised at its end: per
    train step its wall (profiler on), the card's busy time (the kernels'
    and copies' device time), the card's busy share, kernel launches and
    copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and _dev_us(e) > 0]
    busy_ms = sum(_dev_us(e) for e in dev) / 1e3
    copies = sum(e.count for e in dev if e.key.startswith(("Memcpy",
                                                            "Memset")))
    return {"wall_ms": wall_ms / steps, "busy_ms": busy_ms / steps,
            "busy_share": busy_ms / wall_ms,
            "launches_per_step": (sum(e.count for e in dev) - copies) / steps,
            "copies_per_step": copies / steps}


def phase_train_feed(card):
    """The device-side data feed on full-width ``resnet18_tiny_imagenet``
    (NCHW, fp32 parity precision) with the Tiny-ImageNet trainer's RESIDENT
    recipe: B=32, AdamW(1e-3, weight decay 1e-4) under
    ``WarmupCosineAnnealing`` stepped per batch,
    ``DeviceAugmentBuilder("NCHW").random_crop(4).horizontal_flip(0.5)``.
    Synthetic uint8 images and labels from ``SEED``:

    - resident, full split: 100,000 x 3x64x64 uint8 (1,228,800,000 bytes)
      and 400,000 bytes of int32 labels staged through reused pinned
      buffers (the staging wall printed); a resident epoch of 32 steps,
      warm, with nothing inside it waiting for the card
      (``torch.cuda.set_sync_debug_mode("error")``), its samples/s; the
      same epoch again with the tracer on, inside a
      ``train.resident_epoch`` span, still under that mode;
    - resident against the per-step loop: 4 steps over one batch order,
      augmentation off, cuDNN deterministic: bit-equal, else at the train
      cnn phase's loss tolerance (the printout says which);
    - ``Trainer.fit`` over a ``DeviceDataset`` of 256 train (augmented) and
      256 val samples, 2 epochs: a finite history with the JAX keys, train
      accuracy NaN; resident eval equal to the host eval of the same split;
    - chunked: ``PrefetchLoader(stage_batches=4, feed_workers=2)`` with
      ``steps_per_dispatch=4`` over 256 samples, timed; then again against
      ``PrefetchLoader(depth=2)`` per step from the same weights, both
      with cuDNN deterministic (bit-equal, else its rel, printed; gated at
      the train cnn tolerance), beside the timed runs' rel; ``mha_classifier`` on the marker task
      through ``PrefetchLoader(stage_batches=4)``, ``steps_per_dispatch=4``,
      the flash kernels counted over that run, its losses against the
      per-step run's;
    - streaming: ``StreamingDeviceDataset`` of 2,048 samples in shards of 8
      batches, through the default transfer engine and through a
      2-process worker pool: every shard the step receives bit-identical to
      ``serial_shards``; then a training epoch through the engine;
    - per feed (host loader with host augmentation, ``PrefetchLoader``,
      chunked, resident, streaming): warm samples/s (the second epoch of
      two, or the timed epoch), the card's busy share, kernel launches and
      copies per step from one profiled window (4 steps; the chunked feed
      one more 8-step epoch through its loader, its workers up), and the
      host-to-device bytes per step the feed ships (counted from the
      arrays it copies). The phase's wall is printed by part."""
    import numpy as np
    import torch

    from dcnn_tpu_torch import native
    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import (
        ArrayDataLoader, AugmentationBuilder, DeviceAugmentBuilder,
        DeviceDataset, FeedWorkerPool, PrefetchLoader,
        StreamingDeviceDataset, decode_batch, make_resident_epoch,
        make_shard_step, serial_shards, train_streaming_epoch,
    )
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import Adam, AdamW, WarmupCosineAnnealing
    from dcnn_tpu_torch.train import (
        Trainer, create_train_state, evaluate_classification,
        make_multi_step, make_train_step,
    )

    t_phase = time.perf_counter()
    parts, t_mark = {}, [t_phase]

    def mark(name):
        now = time.perf_counter()
        parts[name] = round(now - t_mark[0], 1)
        t_mark[0] = now
    cfg = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
    params, state = jax_layout(cfg, np.random.default_rng(SEED + 21))
    ce = get_loss("softmax_crossentropy")
    rng = np.random.default_rng(SEED + 22)
    x = rng.integers(0, 256, (FEED_STREAM, 3, 64, 64), dtype=np.uint8)
    y = rng.integers(0, FEED_CLASSES, FEED_STREAM)
    oh = np.eye(FEED_CLASSES, dtype=np.float32)[y]
    tr_x, tr_y, tr_oh = x[:FEED_TRAIN], y[:FEED_TRAIN], oh[:FEED_TRAIN]
    va = slice(FEED_TRAIN, FEED_TRAIN + FEED_VAL)
    batch_h2d = tr_x[:FEED_BATCH].nbytes + tr_oh[:FEED_BATCH].nbytes
    feeds = {}

    def device_aug():
        return (DeviceAugmentBuilder("NCHW").random_crop(4)
                .horizontal_flip(0.5).build())

    def host_aug():
        return (AugmentationBuilder("NCHW").random_crop(4)
                .horizontal_flip(0.5).build())

    def model_opt():
        model = from_jax(cfg, params, state, device="cuda")
        return model, AdamW(FEED_LR, weight_decay=1e-4)

    def fit(loader, val=None, spd=1, epochs=2, jit=True):
        model, opt = model_opt()
        steps = len(loader)
        trainer = Trainer(model, opt, ce, TrainingConfig(
            epochs=epochs, batch_size=FEED_BATCH, learning_rate=FEED_LR,
            scheduler_step="batch", snapshot_dir=None, progress_interval=0,
            device_type="cuda", steps_per_dispatch=spd),
            WarmupCosineAnnealing(FEED_LR, warmup_steps=2,
                                  total_steps=epochs * steps))
        if not jit:  # the eager twin
            trainer.train_step = eager_step(trainer)
            if spd > 1:
                trainer.multi_step = make_multi_step(model, ce, opt,
                                                     jit=False)
        ts = trainer.fit(create_train_state(model, opt), loader, val)
        torch.cuda.synchronize()
        return trainer, ts, model

    def fit_few(ldr, spd=1):
        """One epoch of ``ldr`` through a Trainer built, and run for one
        epoch (its steps' eager first calls and captures), beforehand, so
        that the window holds the feed and the replayed steps alone."""
        model, opt = model_opt()
        trainer = Trainer(model, opt, ce, TrainingConfig(
            epochs=1, batch_size=FEED_BATCH, learning_rate=FEED_LR,
            snapshot_dir=None, progress_interval=0, device_type="cuda",
            steps_per_dispatch=spd))
        ts = create_train_state(model, opt)
        trainer.fit(ts, ldr)
        return lambda: trainer.fit(ts, ldr)

    def loader(n=FEED_TRAIN, **kw):
        return ArrayDataLoader(x[:n], oh[:n], batch_size=FEED_BATCH,
                               seed=SEED, **kw)

    def warm_sps(trainer, n=FEED_TRAIN):
        return n / trainer.history[-1]["seconds"]

    def finite(history):
        return all(math.isfinite(h["train_loss"]) for h in history)

    # host loader with host augmentation (the train cnn phase's path) and
    # PrefetchLoader
    trainer, _, _ = fit(loader(augmentation=host_aug()))
    feeds["host"] = {"samples_per_s": warm_sps(trainer),
                     "h2d_bytes_per_step": batch_h2d}
    with PrefetchLoader(loader(), depth=2) as pf:
        plain, _, _ = fit(pf)
    feeds["prefetch"] = {"samples_per_s": warm_sps(plain),
                         "h2d_bytes_per_step": batch_h2d}
    mark("host and prefetch")
    # chunked through a 2-process pool; one more epoch through the same
    # loader (its workers up) is the profiled window
    with PrefetchLoader(loader(), depth=2, stage_batches=FEED_CHUNK,
                        feed_workers=2) as pf:
        chunked, ts_c, _ = fit(pf, spd=FEED_CHUNK)
        workers_alive = pf._pool.alive_workers()
        chunk_profile = profiled(fit_few(pf, FEED_CHUNK),
                                 FEED_TRAIN // FEED_BATCH)
    mark("chunked")

    def rel_losses(a, b):
        return max(abs(p["train_loss"] - q["train_loss"])
                   / abs(q["train_loss"])
                   for p, q in zip(a.history, b.history))

    # the timed runs above leave cuDNN free to pick non-deterministic
    # algorithms (atomics in the conv backward), so their losses part by
    # rounding that 32 steps amplify; the chunked step is held to the
    # per-step one with cuDNN deterministic, both runs again
    nondet_rel = rel_losses(chunked, plain)
    torch.backends.cudnn.deterministic = True
    try:
        with PrefetchLoader(loader(), depth=2) as pf:
            det_plain, _, m_plain = fit(pf)
        with PrefetchLoader(loader(), depth=2, stage_batches=FEED_CHUNK,
                            feed_workers=2) as pf:
            det_chunk, ts_d, m_chunk = fit(pf, spd=FEED_CHUNK)
        # each against its eager twin: bit for bit
        for spd, graphed, m_graphed in ((1, det_plain, m_plain),
                                        (FEED_CHUNK, det_chunk, m_chunk)):
            kw = ({"stage_batches": spd, "feed_workers": 2} if spd > 1
                  else {})
            with PrefetchLoader(loader(), depth=2, **kw) as pf:
                eager, _, m_eager = fit(pf, spd=spd, jit=False)
            if [h["train_loss"] for h in eager.history] != [
                    h["train_loss"] for h in graphed.history] or not all(
                    torch.equal(a, b) for a, b in zip(
                        m_eager.state_dict().values(),
                        m_graphed.state_dict().values())):
                fail(f"train feed: the {'chunked' if spd > 1 else 'per-step'}"
                     f" path replayed from graphs differs from its eager "
                     f"twin (cuDNN deterministic): losses "
                     f"{[h['train_loss'] for h in graphed.history]} vs "
                     f"{[h['train_loss'] for h in eager.history]}")
            del m_eager
    finally:
        torch.backends.cudnn.deterministic = False
    chunk_rel = rel_losses(det_chunk, det_plain)
    # params and running statistics; the reported losses are summed in
    # fp32 a chunk and in double a step, so they differ in the last bits
    chunk_bit_equal = all(torch.equal(a, b) for a, b in zip(
        m_chunk.state_dict().values(), m_plain.state_dict().values()))
    del m_plain, m_chunk
    print(f"train feed: chunked vs per-step ResNet-18 with cuDNN "
          f"deterministic: params and running statistics "
          + ("bit-equal" if chunk_bit_equal else "differ")
          + f", losses rel {chunk_rel:.3e} "
          f"({[h['train_loss'] for h in det_chunk.history]} vs "
          f"{[h['train_loss'] for h in det_plain.history]}); the timed "
          f"runs, cuDNN free: rel {nondet_rel:.3e}", flush=True)
    mark("chunked vs per-step")
    if not (finite(chunked.history) and finite(det_chunk.history)
            and chunk_rel <= CNN_LOSS_RTOL
            and ts_c.step == ts_d.step == 2 * FEED_TRAIN // FEED_BATCH
            and workers_alive == 2
            and math.isnan(chunked.history[0]["train_acc"])):
        fail(f"train feed: chunked ResNet-18 losses "
             f"{[h['train_loss'] for h in det_chunk.history]} vs per-step "
             f"{[h['train_loss'] for h in det_plain.history]} with cuDNN "
             f"deterministic (rel {chunk_rel:.3e}, tol {CNN_LOSS_RTOL:g}), "
             f"{ts_c.step} and {ts_d.step} steps, {workers_alive} workers "
             f"alive")
    feeds["chunked"] = {"samples_per_s": warm_sps(chunked),
                        "h2d_bytes_per_step": batch_h2d,
                        "profile": chunk_profile}

    # Trainer.fit over a resident split, and resident eval vs host eval
    train_ds = DeviceDataset(tr_x, tr_y, FEED_CLASSES, batch_size=FEED_BATCH,
                             augment=device_aug())
    val_ds = DeviceDataset(x[va], y[va], FEED_CLASSES, batch_size=FEED_BATCH)
    resident, _, model = fit(train_ds, val_ds)
    if not (len(resident.history) == 2 and finite(resident.history)
            and all(set(h) == FEED_KEYS for h in resident.history)
            and all(math.isnan(h["train_acc"]) for h in resident.history)
            and all(math.isfinite(h["val_loss"]) for h in resident.history)):
        fail(f"train feed: resident Trainer.fit history {resident.history}")
    torch.backends.cudnn.deterministic = True
    try:
        ev_res = evaluate_classification(model, ce, val_ds)
        ev_host = evaluate_classification(model, ce, ArrayDataLoader(
            x[va], oh[va], batch_size=FEED_BATCH, shuffle=False,
            drop_last=False))
    finally:
        torch.backends.cudnn.deterministic = False
    if ev_res != ev_host:
        fail(f"train feed: resident eval {ev_res} != host eval {ev_host}")
    mark("resident fit")
    feeds["resident"] = {"samples_per_s_512": round(warm_sps(resident), 1),
                         "h2d_bytes_per_step": 4}  # its lr, from a vector

    # resident against the per-step loop, one batch order, cuDNN
    # deterministic
    order = np.random.default_rng(SEED + 23).permutation(FEED_TRAIN)[
        :4 * FEED_BATCH].reshape(4, FEED_BATCH)
    torch.backends.cudnn.deterministic = True
    try:
        m_a, opt_a = model_opt()
        ts_a, mean_a = make_resident_epoch(
            m_a, ce, opt_a, num_classes=FEED_CLASSES, batch_size=FEED_BATCH)(
            create_train_state(m_a, opt_a), train_ds.x, train_ds.y, 0,
            FEED_LR, order=order)
        # the resident epoch's eager twin, augmented, against its replays
        twins = []
        for jit in (True, False):
            m_t, opt_t = model_opt()
            ts_t, mean_t = make_resident_epoch(
                m_t, ce, opt_t, num_classes=FEED_CLASSES,
                batch_size=FEED_BATCH, augment=device_aug(), steps=6,
                jit=jit)(create_train_state(m_t, opt_t), train_ds.x,
                         train_ds.y, 5, FEED_LR)
            twins.append((float(mean_t), m_t.state_dict(), ts_t.opt_state))
        if twins[0][0] != twins[1][0] or not all(
                torch.equal(a, b) for a, b in zip(
                    [*twins[0][1].values(), *twins[0][2]["m"].values(),
                     *twins[0][2]["v"].values()],
                    [*twins[1][1].values(), *twins[1][2]["m"].values(),
                     *twins[1][2]["v"].values()])):
            fail(f"train feed: the resident epoch replayed from its body's "
                 f"graph differs from its eager twin (cuDNN deterministic): "
                 f"mean loss {twins[0][0]} vs {twins[1][0]}")
        del twins
        m_b, opt_b = model_opt()
        ts_b = create_train_state(m_b, opt_b)
        step = make_train_step(m_b, ce, opt_b)
        losses_b = torch.stack([step(
            ts_b, decode_batch(torch.from_numpy(tr_x[i]).cuda()),
            torch.from_numpy(tr_oh[i]).cuda(), FEED_LR)[0] for i in order])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    mean_b = float(losses_b.mean())
    bit_equal = (float(mean_a) == mean_b and all(
        torch.equal(a, b) for a, b in zip(m_a.state_dict().values(),
                                          m_b.state_dict().values())))
    loop_rel = abs(float(mean_a) - mean_b) / abs(mean_b)
    if not (bit_equal or loop_rel <= CNN_LOSS_RTOL):
        fail(f"train feed: resident epoch mean loss {float(mean_a)} vs the "
             f"per-step loop's {mean_b} (rel {loop_rel:.3e}, tol "
             f"{CNN_LOSS_RTOL:g})")
    mark("resident vs loop")
    # replayed against eager host wall: a resident epoch of 4 steps and a
    # chunk of 4 steps, the mean loss read each call
    graph_walls = {}
    for jit_name, mk in (("resident", lambda jit, m, o: make_resident_epoch(
            m, ce, o, num_classes=FEED_CLASSES, batch_size=FEED_BATCH,
            augment=device_aug(), steps=FEED_CHUNK, jit=jit)),
                         ("chunked", lambda jit, m, o: make_multi_step(
                             m, ce, o, jit=jit))):
        fns = []
        for jit in (True, False):
            m_w, opt_w = model_opt()
            ts_w, fn = create_train_state(m_w, opt_w), mk(jit, m_w, opt_w)
            if jit_name == "resident":
                fns.append(lambda fn=fn, ts_w=ts_w: float(fn(
                    ts_w, train_ds.x, train_ds.y, 9, FEED_LR)[1]))
            else:
                xs = decode_batch(torch.from_numpy(tr_x[:FEED_CHUNK * FEED_BATCH])
                                  .cuda()).reshape(FEED_CHUNK, FEED_BATCH,
                                                   3, 64, 64)
                ys = torch.from_numpy(tr_oh[:FEED_CHUNK * FEED_BATCH]).cuda(
                    ).reshape(FEED_CHUNK, FEED_BATCH, -1)
                fns.append(lambda fn=fn, ts_w=ts_w, xs=xs, ys=ys: float(
                    fn(ts_w, xs, ys, 9, FEED_LR)[1]))
            fns[-1]()  # the graph's eager first step and capture
        graph_walls[jit_name] = replay_vs_eager(fns[0], fns[1], 1)
        graph_walls[jit_name]["steps_per_call"] = FEED_CHUNK
    print(f"train feed graphs: per-step and chunked ResNet-18 runs and the "
          f"augmented resident epoch bit-equal to their eager twins (cuDNN "
          f"deterministic); replayed vs eager, a call of {FEED_CHUNK} "
          f"steps: {json.dumps(graph_walls)} on {card}", flush=True)
    mark("replayed vs eager")
    del train_ds, val_ds, m_a, m_b, ts_a, ts_b

    # resident, the full split: staged through reused pinned buffers
    big_x = np.frombuffer(np.random.default_rng(SEED + 24).bytes(
        FEED_SPLIT * 3 * 64 * 64), np.uint8).reshape(FEED_SPLIT, 3, 64, 64)
    big_y = np.random.default_rng(SEED + 25).integers(0, FEED_CLASSES,
                                                      FEED_SPLIT)
    aug = device_aug()
    big = DeviceDataset(big_x, big_y, FEED_CLASSES, batch_size=FEED_BATCH,
                        augment=aug)
    staged_bytes, stage_s = big.hbm_bytes, big.stage_seconds
    model, opt = model_opt()
    ts = create_train_state(model, opt)
    sched = WarmupCosineAnnealing(FEED_LR, warmup_steps=2,
                                  total_steps=FEED_RESIDENT_STEPS)
    lrs = [sched.step(None) for _ in range(FEED_RESIDENT_STEPS)]
    epoch = make_resident_epoch(model, ce, opt, num_classes=FEED_CLASSES,
                                batch_size=FEED_BATCH, augment=aug,
                                scale=big.scale, steps=FEED_RESIDENT_STEPS)
    # two steps over a given order: the body's eager first call and its
    # capture, before the timed epoch (which replays alone)
    ts, warm = epoch(ts, big.x, big.y, 1, FEED_LR,
                     order=np.arange(2 * FEED_BATCH).reshape(2, FEED_BATCH))
    float(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # nothing inside may wait
    try:
        ts, mean = epoch(ts, big.x, big.y, 2, np.asarray(lrs, np.float32))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mean = float(mean)
    resident_s = time.perf_counter() - t0
    if not math.isfinite(mean) or ts.step != FEED_RESIDENT_STEPS + 2:
        fail(f"train feed: full-split resident epoch mean loss {mean}, "
             f"{ts.step} steps")
    # the same epoch again with the tracer on, inside the trainer's span:
    # the span adds no synchronisation (the obs phase reports it)
    from dcnn_tpu_torch.obs import configure

    tracer = configure(enabled=True)
    tracer.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with tracer.span("train.resident_epoch", track="train", epoch=3):
            ts, traced_mean = epoch(ts, big.x, big.y, 3,
                                    np.asarray(lrs, np.float32))
    finally:
        torch.cuda.set_sync_debug_mode("default")
        configure(enabled=False)
    traced = {"mean_loss": float(traced_mean), "spans": tracer.span_counts()}
    tracer.clear()
    if not (math.isfinite(traced["mean_loss"])
            and traced["spans"] == {"train.resident_epoch": 1}):
        fail(f"train feed: traced resident epoch {traced}")
    feeds["resident"]["samples_per_s"] = (FEED_RESIDENT_STEPS * FEED_BATCH
                                          / resident_s)
    feeds["resident"]["profile"] = profiled(
        lambda: float(epoch(ts, big.x, big.y, 3, FEED_LR, order=np.arange(
            FEED_PROFILE_STEPS * FEED_BATCH).reshape(
                FEED_PROFILE_STEPS, FEED_BATCH))[1]), FEED_PROFILE_STEPS)
    feeds["resident"]["pool_bytes"] = epoch.step.pool.bytes()
    del big, big_x, epoch
    torch.cuda.empty_cache()
    mark("resident full split")

    # streaming: shards bit-identical to serial_shards through the engine
    # and the pool, then a training epoch through the engine
    shard_rows = FEED_BATCH * FEED_SHARD_BATCHES
    pool = FeedWorkerPool(x, y.astype(np.int32), shard_rows, num_workers=2,
                          seed=SEED)
    stream = {}
    try:
        for name, kw in (("engine", {}), ("pool", {"worker_pool": pool})):
            ds = StreamingDeviceDataset(x, y, FEED_CLASSES,
                                        batch_size=FEED_BATCH,
                                        shard_batches=FEED_SHARD_BATCHES,
                                        seed=SEED)
            ref = StreamingDeviceDataset(x, y, FEED_CLASSES,
                                         batch_size=FEED_BATCH,
                                         shard_batches=FEED_SHARD_BATCHES,
                                         seed=SEED)
            want = list(serial_shards(ref.x, ref.y,
                                      list(ref.shard_selections())))
            got = []

            def record(ts_, sx, sy, key, lr):
                sx = torch.cat(sx) if isinstance(sx, tuple) else sx
                got.append((sx.cpu().numpy(), sy.cpu().numpy()))
                return ts_, torch.zeros((), device="cuda")

            model, opt = model_opt()
            ts = create_train_state(model, opt)
            train_streaming_epoch(record, ts, ds, 0, FEED_LR, **kw)
            same = len(got) == len(want) == FEED_STREAM // shard_rows and all(
                np.array_equal(gx, wx) and np.array_equal(gy, wy)
                for (gx, gy), (wx, wy, _) in zip(got, want))
            if not same:
                fail(f"train feed: streaming shards through the {name} "
                     f"differ from serial_shards")
            if name != "engine":
                continue
            step = make_shard_step(model, ce, opt, num_classes=FEED_CLASSES,
                                   batch_size=FEED_BATCH,
                                   shard_batches=FEED_SHARD_BATCHES,
                                   augment=device_aug())
            timeline = []
            t0 = time.perf_counter()
            ts, loss = train_streaming_epoch(step, ts, ds, 1, FEED_LR,
                                             timeline=timeline, **kw)
            wall = time.perf_counter() - t0
            if not math.isfinite(loss) or ts.step != FEED_STREAM // FEED_BATCH:
                fail(f"train feed: streaming epoch through the {name}: loss "
                     f"{loss}, {ts.step} steps")
            stream[name] = {
                "samples_per_s": FEED_STREAM / wall,
                "h2d_bytes_per_step": sum(t["bytes"] for t in timeline)
                / (FEED_STREAM // FEED_BATCH) + 4 * FEED_BATCH,
                "queue_wait_s": sum(t["queue_wait_s"] for t in timeline),
                "h2d_gbps": [round(t["h2d_gbps"], 3) for t in timeline
                             if t["h2d_gbps"]]}
        alive = pool.alive_workers()
    finally:
        pool.close()
    if alive != 2:
        fail(f"train feed: {alive} of 2 streaming workers alive")
    feeds["streaming"] = stream["engine"]
    mark("streaming")

    # one profiled window of 4 steps through the other feeds
    few = FEED_PROFILE_STEPS * FEED_BATCH
    feeds["host"]["profile"] = profiled(
        fit_few(loader(few, augmentation=host_aug())), FEED_PROFILE_STEPS)
    with PrefetchLoader(loader(few), depth=2) as pf:
        feeds["prefetch"]["profile"] = profiled(fit_few(pf),
                                                FEED_PROFILE_STEPS)
    model, opt = model_opt()
    step = make_shard_step(model, ce, opt, num_classes=FEED_CLASSES,
                           batch_size=FEED_BATCH,
                           shard_batches=FEED_PROFILE_STEPS,
                           augment=device_aug())
    few_ds = StreamingDeviceDataset(x[:few], y[:few], FEED_CLASSES,
                                    batch_size=FEED_BATCH,
                                    shard_batches=FEED_PROFILE_STEPS)
    few_ts = create_train_state(model, opt)
    train_streaming_epoch(step, few_ts, few_ds, 0, FEED_LR)  # the captures
    feeds["streaming"]["profile"] = profiled(
        lambda: train_streaming_epoch(step, few_ts, few_ds, 0, FEED_LR),
        FEED_PROFILE_STEPS)

    mark("profiles")
    # mha_classifier through the chunked path: the flash kernels run there
    m_cfg, m_params, m_rng = model_params()
    m_x, m_y = marker_task(m_rng)

    def mha_fit(spd):
        model = from_jax(m_cfg, m_params, device="cuda")
        opt = Adam(1e-3)
        ldr = ArrayDataLoader(m_x, m_y, batch_size=FEED_BATCH, seed=SEED)
        if spd > 1:
            ldr = PrefetchLoader(ldr, stage_batches=spd)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=2, batch_size=FEED_BATCH, snapshot_dir=None,
            progress_interval=0, device_type="cuda", steps_per_dispatch=spd))
        ts = trainer.fit(create_train_state(model, opt), ldr)
        return trainer, ts

    mha_plain, _ = mha_fit(1)
    reset_launches()  # the chunked mha path starts here
    mha_chunked, ts = mha_fit(FEED_CHUNK)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items()  # the path ends
              if k.startswith("flash_")}
    mha_steps = 2 * len(m_x) // FEED_BATCH
    mha_rel = max(abs(a["train_loss"] - b["train_loss"])
                  / abs(b["train_loss"])
                  for a, b in zip(mha_chunked.history, mha_plain.history))
    if not (ts.step == mha_steps and mha_rel <= TRAIN_LOSS_RTOL
            and all(v == 2 * mha_steps for v in counts.values())
            and len(counts) == 3):
        fail(f"train feed: chunked mha_classifier: {ts.step} steps, losses "
             f"{[h['train_loss'] for h in mha_chunked.history]} vs per-step "
             f"{[h['train_loss'] for h in mha_plain.history]} (rel "
             f"{mha_rel:.3e}, tol {TRAIN_LOSS_RTOL:g}), launches {counts} "
             f"(expected {2 * mha_steps} each)")

    mark("mha chunked")
    for f in feeds.values():
        f["samples_per_s"] = round(f["samples_per_s"], 1)
        if "profile" in f:
            f["profile"] = {k: round(v, 4) for k, v in f["profile"].items()}
    helpers = "C++" if native.available() else "numpy"
    print(f"train feed: native helpers {helpers} "
          f"({native.lib_path().name}); full split {staged_bytes} device "
          f"bytes staged in {stage_s:.3f} s "
          f"({staged_bytes / stage_s / 1e9:.2f} GB/s); resident epoch "
          f"of {FEED_RESIDENT_STEPS} steps {resident_s:.3f} s, no host sync "
          f"inside; resident vs per-step loop over 4 steps: "
          f"{'bit-equal' if bit_equal else f'rel {loop_rel:.3e}'}; resident "
          f"eval == host eval {ev_res}; chunked ResNet-18 vs per-step "
          f"(cuDNN deterministic) params "
          f"{'bit-equal' if chunk_bit_equal else 'differ'}, losses rel "
          f"{chunk_rel:.3e}; "
          f"chunked mha_classifier vs per-step rel "
          f"{mha_rel:.3e}, launches {counts}; streaming shards bit-identical "
          f"to serial_shards through the engine and a 2-process pool; phase "
          f"wall {time.perf_counter() - t_phase:.1f} s (by part: {parts}) on "
          f"{card}", flush=True)
    print("train feed: " + json.dumps({"card": card, "feeds": feeds}),
          flush=True)
    return {"launches": counts, "feeds": feeds, "traced_resident": traced}


# serve int8 phase: full-width resnet18_tiny_imagenet (NHWC) and
# mha_classifier quantized once on the CPU, served on the card
INT8_CALIB = 64           # calibration images
INT8_CONVS = 21           # resnet18_tiny_imagenet's convs, one launch each
INT8_REQUESTS = 80        # open-loop single requests per int8 model
INT8_RPS = 400.0          # offered rate: 80 requests over 0.2 s
# card against CPU int8 logits, over the CPU's max |logit|: both run the
# same int8 sums exactly; the float glue between them (the avg pool's sum)
# may round differently, and a one-ulp change there can move an activation
# across a rounding boundary of the next quantization
INT8_CPU_RTOL = 1e-3
# (N, Cin, H, W, Cout, k, stride, pad): K tails (Cin 3, 17, 40), ragged M
# and N edges, strided, odd sizes
INT8_RAGGED = [(3, 3, 13, 11, 70, 3, 1, 1), (2, 17, 9, 9, 33, 3, 2, 1),
               (5, 40, 7, 5, 9, 1, 2, 0), (1, 16, 28, 28, 8, 5, 1, 0),
               (2, 64, 12, 12, 130, 7, 2, 3), (4, 96, 6, 6, 64, 1, 1, 0)]


def int8_bound(n, cin, h, w, cout, k, stride, pad, in_bytes=1,
               out_bytes=4):
    """Least time for one int8 conv: x (``in_bytes`` a value: 1 for mode
    A's int8, 4 or 2 for mode B's float input), the int8 weights read once
    and the output (``out_bytes`` a value: mode A's int32, mode B's x type)
    written once over HBM bandwidth, against 2 M Cout K operations over the
    int8 tensor-core peak."""
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    m, kk = n * p * q, cin * k * k
    nbytes = in_bytes * n * h * w * cin + cout * kk + out_bytes * m * cout
    ops = 2 * m * cout * kk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["int8"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def int8_chain(x, x_scale, w_q, w_scale, b, stride, pad, layout):
    """The int8 conv layer unfused, as separate launches on the card:
    quantize_symmetric (torch), conv2d_int8 (mode A, weights packed in the
    call), the dequantize (torch), each its own launches."""
    from dcnn_tpu_torch.ops import quant
    from dcnn_tpu_torch.ops.conv import conv2d_int8

    y = conv2d_int8(quant.quantize_symmetric(x, x_scale), w_q, stride=stride,
                    padding=pad, data_format=layout)
    shape = [1] * 4
    shape[1 if layout == "NCHW" else 3] = -1
    y = y.float() * (x_scale * w_scale).reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y.to(x.dtype)


def int8_case(label, x, x_scale, w_q, w_scale, b, stride, pad, layout, reps,
              context=True):
    """Hold ``conv_int8.cu`` at one conv: mode A (int8 -> int32) against
    its plain version (a float64 conv cast to int32) and mode B (the fused
    layer: float x quantized in the prologue, dequantized with the bias in
    the epilogue) against the unfused chain on the card
    (quant_conv2d_reference), both bit for bit, and, where the plan splits
    K, mode B split against unsplit bit for bit; time mode A's kernel, mode
    B's, the unfused chain (int8_chain, what the fused mode replaces)
    and the plain versions, and bf16 ``F.conv2d`` of the same shape as
    context (a float conv, another function). No PyTorch call computes
    either int8 function: library_ms is None."""
    import torch
    import torch.nn.functional as F

    from dcnn_tpu_torch.ops import _kernels, quant
    from dcnn_tpu_torch.ops.conv import conv2d_int8_reference

    x_q = quant.quantize_symmetric(x, x_scale)
    wk = _kernels.pack_int8_weight(w_q)
    scale = (x_scale * w_scale).float()
    geo = dict(stride=(stride, stride), padding=(pad, pad),
               data_format=layout)

    def mode_a(split=None):
        return _kernels.conv_int8(x_q, w_q, packed=wk, ksplit=split, **geo)

    def mode_b(split=None):
        return _kernels.conv_int8_fused(x, x_scale, w_q, scale, b,
                                        packed=wk, ksplit=split, **geo)

    def plain_a():
        return conv2d_int8_reference(x_q, w_q, stride=stride, padding=pad,
                                     data_format=layout)

    def plain_b():
        return quant.quant_conv2d_reference(x, x_scale, w_q, w_scale, b,
                                            stride=stride, padding=pad,
                                            data_format=layout)

    def chain():
        return int8_chain(x, x_scale, w_q, w_scale, b, stride, pad, layout)

    got_a, want_a, got_b, want_b = mode_a(), plain_a(), mode_b(), plain_b()
    torch.cuda.synchronize()
    for mode, got, want in (("A", got_a, want_a), ("B", got_b, want_b)):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        if got.dtype != want.dtype or bad:
            fail(f"conv_int8 [{label}] mode {mode}: {bad} of {want.numel()}"
                 f" outputs differ from the plain version ({got.dtype} "
                 f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")
    xl = x if layout == "NCHW" else x.permute(0, 3, 1, 2)
    n, cin, h, w = xl.shape
    cout, _, k, _ = w_q.shape
    es = x.element_size()
    plan = _kernels.conv_int8_plan(
        n, cin, h, w, cout, k, k, stride, pad, x.dtype,
        _kernels._card_sms(x.device),
        channels_last=layout == "NHWC" and cin % 16 == 0)
    split_equal = None
    if plan.ksplit > 1:
        unsplit = mode_b(1)
        split_equal = bool(torch.equal(unsplit, got_b))
        if not split_equal:
            fail(f"conv_int8 [{label}]: K split {plan.ksplit} differs from "
                 f"the unsplit kernel")
    if reps is None:  # held, not timed
        print(f"conv_int8 [{label}] {str(x.dtype)[6:]} {layout}: A and B "
              f"bit-equal{'' if split_equal is None else ', split = unsplit'}",
              flush=True)
        return {"case": label, "dtype": str(x.dtype)[6:], "max_abs_err": 0.0,
                "ksplit": plan.ksplit, "split_equal": split_equal}
    k_reps, p_reps = reps
    ms_a, ms_b = device_ms(mode_a, k_reps), device_ms(mode_b, k_reps)
    chain_ms = device_ms(chain, k_reps)
    plain_a_ms, plain_b_ms = device_ms(plain_a, p_reps), device_ms(
        plain_b, p_reps)
    ctx = None
    if context:
        mf = torch.channels_last if layout == "NHWC" else None
        xf = xl.to(torch.bfloat16)
        wf = w_q.to(torch.bfloat16)
        if mf:
            wf = wf.contiguous(memory_format=mf)
        ctx = device_ms(lambda: F.conv2d(xf, wf, stride=stride, padding=pad),
                        k_reps)
    bound_a, by_a, bytes_a, ops = int8_bound(n, cin, h, w, cout, k, stride,
                                             pad)
    bound_b, by_b, bytes_b, _ = int8_bound(n, cin, h, w, cout, k, stride,
                                           pad, es, es)
    print(f"conv_int8 [{label}] N{n} Cin{cin} {h}x{w} -> Cout{cout} k{k} "
          f"s{stride} p{pad} {layout} {str(x.dtype)[6:]}: A and B bit-equal"
          f"{'' if split_equal is None else f', K split {plan.ksplit} = unsplit'}"
          f"; A {ms_a:.6f} ms ({100 * bound_a / ms_a:.1f}% of "
          f"{bound_a:.3e}, {by_a}); B {ms_b:.6f} ms ({100 * bound_b / ms_b:.1f}"
          f"% of {bound_b:.3e}, {by_b}); unfused chain {chain_ms:.6f} ms; "
          f"plain A {plain_a_ms:.6f} B {plain_b_ms:.6f} ms; bf16 F.conv2d "
          f"(context) {ctx}; plan {plan.describe()}", flush=True)
    return {"case": label, "N": n, "Cin": cin, "H": h, "W": w, "Cout": cout,
            "k": k, "stride": stride, "pad": pad, "layout": layout,
            "dtype": str(x.dtype)[6:], "max_abs_err": 0.0, "ms": ms_b,
            "plain_ms": plain_b_ms, "bound_ms": bound_b, "bound_by": by_b,
            "library_ms": None, "bytes": bytes_b, "ops": ops,
            "mode_a": {"ms": ms_a, "plain_ms": plain_a_ms,
                       "bound_ms": bound_a, "bound_by": by_a,
                       "bytes": bytes_a},
            "chain_ms": chain_ms, "bf16_conv2d_ms_other_function": ctx,
            "ksplit": plan.ksplit, "split_equal": split_equal}


def int8_sites(qmodel, x, label, reps, dtype=None):
    """The int8 model's conv inputs at batch ``x`` (hooked), each site
    held and timed by int8_case (``dtype``: the inputs cast to it and
    held, not timed)."""
    import torch

    from dcnn_tpu_torch.nn import QuantConv2DLayer

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in qmodel.modules() if isinstance(m, QuantConv2DLayer)]
    with torch.inference_mode():
        qmodel(x)
    for h in hooks:
        h.remove()
    if len(seen) != INT8_CONVS:
        fail(f"serve int8: {len(seen)} conv sites in the int8 model, not "
             f"{INT8_CONVS}")
    cases = []
    for i, (mod, xin) in enumerate(seen):
        (s, _), (p, _) = mod.stride, mod.padding  # square in the zoo
        if dtype is not None:
            xin = xin.to(dtype)
        cases.append(int8_case(f"{label} site {i} {mod.name}", xin,
                               mod.x_scale, mod.w_q, mod.w_scale, mod.b, s,
                               p, mod.data_format,
                               reps if dtype is None else None))
    del seen
    return cases


def serve_open_loop(engine, pool, what):
    """INT8_REQUESTS single requests from ``pool`` offered open loop
    (serve/traffic.py) through a DynamicBatcher; returns ({index: logits},
    metrics snapshot, batcher warm-up buckets)."""
    from dcnn_tpu_torch.serve import DynamicBatcher
    from dcnn_tpu_torch.serve.traffic import open_loop

    batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
    warm = len(batcher.warmup_s)
    futs = open_loop(batcher, list(pool), INT8_RPS,
                     INT8_REQUESTS / INT8_RPS)
    batcher.drain(timeout=300)
    snap = batcher.metrics.snapshot()
    if len(futs) != INT8_REQUESTS or snap["requests_shed"]:
        fail(f"serve int8 {what}: {len(futs)} requests accepted, "
             f"{snap['requests_shed']} shed, of {INT8_REQUESTS} offered")
    return ({i: f.result(timeout=0) for i, f in futs}, snap, warm)


def check_buckets(engine, pool, what):
    """Logits of every n in 1..max_batch equal the full batch's rows bit
    for bit; returns the full batch's logits (host)."""
    import torch

    ref = engine.infer(pool[:engine.max_batch]).cpu()
    for n in range(1, engine.max_batch + 1):
        got = engine.infer(pool[:n]).cpu()
        if not torch.equal(got, ref[:n]):
            fail(f"serve int8 {what}: a batch of {n} (bucket "
                 f"{engine.bucket_for(n)}) differs from the same rows at "
                 f"bucket {engine.max_batch} by "
                 f"{float((got - ref[:n]).abs().max()):.3e}")
    return ref


def phase_serve_int8(card):
    """int8 PTQ serving on the card: full-width resnet18_tiny_imagenet
    (NHWC, random weights and BN statistics from a seed, carried by
    interop) and mha_classifier, each quantized once on the CPU with a
    64-sample calibration batch and served through
    InferenceEngine.from_model(..., int8_calib=...) behind DynamicBatcher
    (open-loop traffic); the launch counters over that path; logits
    bit-identical at every bucket 1..32 and near the CPU int8 engine;
    conv_int8.cu's two modes held bit for bit against their plain
    versions at the 21 conv sites at B=32 and B=256 and at ragged shapes,
    split K against unsplit, each timed beside the unfused chain; the CUDA
    kernels a batch, profiled; the int8 engine's batch time beside the
    folded fp32 and bf16 engines'."""
    import copy

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import get_precision_mode, set_precision
    from dcnn_tpu_torch.interop import to_jax
    from dcnn_tpu_torch.nn import QuantConv2DLayer, quantize_model
    from dcnn_tpu_torch.ops import quant
    from dcnn_tpu_torch.serve import InferenceEngine

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    cfg, params, state, float_cpu = resnet18("cpu", rng)
    calib = rng.normal(size=(INT8_CALIB, *cfg["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(INT8_REQUESTS, *cfg["input_shape"])).astype(
        np.float32)
    t0 = time.perf_counter()
    qmodel = quantize_model(float_cpu, calib)  # once, on the CPU
    quant_s = time.perf_counter() - t0
    cpu_engine = InferenceEngine.from_model(copy.deepcopy(qmodel), fold=False,
                                            max_batch=32, device="cpu")

    reset_launches()  # the int8 serving path starts here
    engine = InferenceEngine.from_model(float_cpu, int8_calib=calib,
                                        max_batch=32, device="cuda")
    answers, snap, warm = serve_open_loop(engine, pool, "resnet18")
    counts = launches()  # and ends here
    # each bucket runs twice at construction (the FLOP-counted first call,
    # then the warm-up), once on the dispatcher, then the served batches
    dispatched = 2 * len(engine.bucket_sizes) + warm + snap["batches"]
    if (counts["conv_int8_fused"] != INT8_CONVS * dispatched
            or counts["conv_int8"]):
        fail(f"serve int8: conv_int8_fused launched "
             f"{counts['conv_int8_fused']} times for {dispatched} batches "
             f"({INT8_CONVS} convs each), mode A conv_int8 "
             f"{counts['conv_int8']} times (0 on the served path)")
    packs = sum(m.packs for m in engine._apply.modules()
                if isinstance(m, QuantConv2DLayer))
    if packs != INT8_CONVS:
        fail(f"serve int8: {packs} weight packs over {dispatched} batches, "
             f"not one per conv layer ({INT8_CONVS})")
    if not engine.batch_invariant:
        fail("serve int8: the int8 engine is not batch_invariant")
    mine, once = _leaves(to_jax(engine._apply)), _leaves(to_jax(qmodel))
    if len(mine) != len(once) or any(
            a.dtype != b.dtype or not np.array_equal(a, b)
            for a, b in zip(mine, once)):
        fail("serve int8: the engine's quantized params differ from the "
             "one quantization on the CPU")
    ref = check_buckets(engine, pool, "resnet18")
    cpu_ref = cpu_engine.infer(pool[:32])
    scale = float(cpu_ref.abs().max())
    err = float((ref - cpu_ref).abs().max())
    rows_equal = int((ref == cpu_ref).all(dim=1).sum())
    own = engine.infer(pool).cpu().numpy()
    served_err = max(float(np.abs(y - own[i]).max())
                     for i, y in answers.items())
    if err > INT8_CPU_RTOL * scale or served_err != 0.0:
        fail(f"serve int8: card logits differ from the CPU int8 engine by "
             f"{err:.3e} ({err / scale:.3e} of the logit scale {scale:.3e}, "
             f"tol {INT8_CPU_RTOL:g}) or served answers from the engine's "
             f"own by {served_err:.3e}")
    print(f"serve int8: resnet18_tiny_imagenet NHWC quantized once on the "
          f"CPU ({INT8_CALIB} calibration images, {quant_s:.2f} s); "
          f"{len(answers)} open-loop requests at {INT8_RPS:g}/s through "
          f"DynamicBatcher: {snap['batches']} batches, occupancy "
          f"{snap['batch_occupancy']}, p50 {snap['p50_ms']} ms, p99 "
          f"{snap['p99_ms']} ms, throughput {snap['throughput_rps']} "
          f"samples/s; conv_int8_fused launches "
          f"{counts['conv_int8_fused']} = {INT8_CONVS} x {dispatched} "
          f"batches (2 x {len(engine.bucket_sizes)} engine first call and "
          f"warm-up, {warm} "
          f"dispatcher warm-up, {snap['batches']} served), K-split reduces "
          f"{counts['conv_int8_reduce']} "
          f"({(counts['conv_int8_fused'] + counts['conv_int8_reduce']) / dispatched:.2f}"
          f" conv launches a batch), mode A 0, weights packed {packs} times "
          f"(once a layer); logits bit-identical at every batch 1..32; vs the CPU "
          f"int8 engine max |err| {err:.3e} ({err / scale:.3e} of "
          f"{scale:.3e}), {rows_equal}/32 rows bit-equal; on {card}",
          flush=True)
    graphs = check_engine_graphs(engine, "serve int8", rng)
    x32 = torch.from_numpy(pool[:32]).cuda()
    graphs["b32"] = replay_vs_eager(lambda: engine.run_padded(x32).cpu(),
                                    lambda: engine._forward(x32).cpu(), 20)
    print(f"serve int8 graphs: resnet18 every bucket's replay equals its "
          f"eager forward bit for bit; {json.dumps(graphs)} on {card}",
          flush=True)

    # both modes against their plain versions at every site (B=32 and
    # B=256, fp32; B=32 also in bf16) and at ragged shapes
    qcard = copy.deepcopy(qmodel).to("cuda")
    x256 = torch.from_numpy(rng.normal(size=(256, *cfg["input_shape"]))
                            .astype(np.float32)).cuda()
    sites32 = int8_sites(qcard, x32, "B32", (20, 3))
    sites256 = int8_sites(qcard, x256, "B256", (5, 2))
    held = int8_sites(qcard, x32, "B32 bf16", None, torch.bfloat16)
    ragged = []
    for i, (n, cin, h, w, cout, k, s, p) in enumerate(INT8_RAGGED):
        g = np.random.default_rng(SEED + 20 + i)
        x = torch.from_numpy(g.normal(size=(n, cin, h, w)).astype(
            np.float32)).cuda()
        wq = torch.from_numpy(g.integers(-127, 128, (cout, cin, k, k),
                                         dtype=np.int8)).cuda()
        ws = torch.from_numpy(g.uniform(1e-3, 1e-2, cout).astype(
            np.float32)).cuda()
        b = torch.from_numpy(g.normal(size=cout).astype(np.float32)).cuda()
        xs = quant.tensor_scale(x).cuda()
        for layout, dt in (("NCHW", torch.float32), ("NHWC", torch.float32),
                           ("NHWC", torch.bfloat16)):
            xl = x if layout == "NCHW" else x.permute(0, 2, 3, 1).contiguous()
            ragged.append(int8_case(f"ragged {i}", xl.to(dt), xs, wq, ws,
                                    b if i % 2 == 0 else None, s, p, layout,
                                    (20, 5), context=False))
    for label, sites in (("B32", sites32), ("B256", sites256)):
        tot = {k: sum(c[k] for c in sites)
               for k in ("ms", "chain_ms", "plain_ms", "bound_ms")}
        tot_a = {k: sum(c["mode_a"][k] for c in sites)
                 for k in ("ms", "plain_ms", "bound_ms")}
        ctx = sum(c["bf16_conv2d_ms_other_function"] for c in sites)
        print(f"conv_int8 {label} over the {INT8_CONVS} sites: B (fused) "
              f"{tot['ms']:.6f} ms, bound {tot['bound_ms']:.6f} "
              f"({100 * tot['bound_ms'] / tot['ms']:.1f}%); A "
              f"{tot_a['ms']:.6f} ms, bound {tot_a['bound_ms']:.6f} "
              f"({100 * tot_a['bound_ms'] / tot_a['ms']:.1f}%); unfused chain "
              f"{tot['chain_ms']:.6f} ms; plain B {tot['plain_ms']:.6f}, A "
              f"{tot_a['plain_ms']:.6f} ms; bf16 F.conv2d (context) "
              f"{ctx:.6f} ms; split sites "
              f"{sum(c['ksplit'] > 1 for c in sites)}, all bit-equal to "
              f"unsplit; on {card}", flush=True)

    # CUDA kernels launched per int8 engine batch, profiled, on this path
    # (one fused launch a conv) and unfused (int8_chain a conv), eager;
    # then the same batch replayed from the engine's graph (the counters'
    # delta beside what CUPTI saw)
    chain_fwd = lambda mod, x: int8_chain(  # noqa: E731
        x, mod.x_scale, mod.w_q, mod.w_scale, mod.b, mod.stride[0],
        mod.padding[0], mod.data_format)
    engines = {"int8": InferenceEngine.from_model(
        copy.deepcopy(qmodel), fold=False, max_batch=256, device="cuda",
        warmup=False)}
    # one folded float engine, in parity mode and in bf16 mode: a graph
    # a (bucket, mode), each captured at its first use
    engines["fp32"] = engines["bf16"] = InferenceEngine.from_model(
        float_cpu, fold=True, max_batch=256, device="cuda", warmup=False)
    set_precision("bf16")
    try:
        for x in (x32, x256):
            engines["bf16"].run_padded(x)
    finally:
        set_precision("parity")
    profile = {}
    fused_fwd = QuantConv2DLayer.forward
    for path in ("int8", "int8 unfused chain"):
        if path != "int8":
            QuantConv2DLayer.forward = chain_fwd
        try:
            for b, x in ((32, x32), (256, x256)):
                engines["int8"]._forward(x)
                profile[f"{path} B{b}"] = profiled(
                    lambda: engines["int8"]._forward(x), 1)
        finally:
            QuantConv2DLayer.forward = fused_fwd
    for b, x in ((32, x32), (256, x256)):
        engines["int8"].run_padded(x)
        profile[f"int8 replayed B{b}"] = profiled(
            lambda: engines["int8"].run_padded(x), 1)
        profile[f"int8 replayed B{b}"]["counted_launches"] = sum(
            engines["int8"].sessions[(b, get_precision_mode())]
            .launch_names().values())
    print("serve int8: profiled CUDA kernels a batch (torch.profiler, one "
          "batch each; launches exclude copies): " + json.dumps(
              {k: {"launches": v["launches_per_step"],
                   "copies": v["copies_per_step"],
                   "device_busy_ms": v["busy_ms"], "wall_ms": v["wall_ms"]}
               for k, v in profile.items()}), flush=True)

    # the int8 engine's batch time (fused, and the unfused chain) beside the
    # folded fp32 and bf16 engines': eager forwards, and the captured
    # engines replayed
    timing = {}
    for name in ("int8", "int8 unfused chain", "fp32", "bf16"):
        eng = engines[name.split()[0]]
        set_precision("bf16" if name == "bf16" else "parity")
        if name == "int8 unfused chain":
            QuantConv2DLayer.forward = chain_fwd
        try:
            for b, x in ((32, x32), (256, x256)):
                reps = 10 if b == 32 else 5
                timing[f"{name} B{b}"] = eager_ms(
                    lambda: eng._forward(x), reps)
                if name != "int8 unfused chain":
                    timing[f"{name} replayed B{b}"] = eager_ms(
                        lambda: eng.run_padded(x), reps)
        finally:
            set_precision("parity")
            QuantConv2DLayer.forward = fused_fwd
    for b in (32, 256):
        for how in ("", " replayed"):
            timing[f"int8{how} B{b} samples/s"] = b / timing[
                f"int8{how} B{b}"] * 1e3
    print(f"serve int8: batch wall ms (host-issued, synchronised; eager "
          f"forwards, and replayed from the engines' graphs; the folded "
          f"fp32 engine in parity mode, TF32 off, and in bf16 mode) "
          f"{json.dumps(timing)}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)

    mha = phase_serve_int8_mha(card)
    return {"launches": counts, "requests": len(answers), **snap,
            "graphs": graphs,
            "max_abs_err_vs_cpu": err, "logit_scale": scale,
            "rows_bit_equal_vs_cpu": rows_equal, "sites_b32": sites32,
            "sites_b256": sites256, "held": held, "ragged": ragged,
            "timing_ms": timing, "profile": profile, "mha": mha}


def phase_serve_int8_mha(card):
    """int8 mha_classifier (full width, S=32, E=64, 4 heads) quantized
    once on the CPU and served on the card: its float core runs the flash
    forward kernel, two launches a batch (one per attention layer)."""
    import copy

    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.nn import quantize_model
    from dcnn_tpu_torch.serve import InferenceEngine

    cfg, params, rng = model_params()
    float_cpu = from_jax(cfg, params, device="cpu")
    calib = rng.normal(size=(INT8_CALIB, *cfg["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(INT8_REQUESTS, *cfg["input_shape"])).astype(
        np.float32)
    qmodel = quantize_model(float_cpu, calib)
    cpu_engine = InferenceEngine.from_model(qmodel, fold=False, max_batch=32,
                                            device="cpu")
    reset_launches()  # the int8 attention serving path starts here
    engine = InferenceEngine.from_model(float_cpu, int8_calib=calib,
                                        max_batch=32, device="cuda")
    answers, snap, warm = serve_open_loop(engine, pool, "mha_classifier")
    counts = launches()  # and ends here
    dispatched = 2 * len(engine.bucket_sizes) + warm + snap["batches"]
    if (counts["flash_fwd"] != 2 * dispatched or counts["conv_int8"]
            or counts["conv_int8_fused"]):
        fail(f"serve int8 mha_classifier: flash_fwd launched "
             f"{counts['flash_fwd']} times for {dispatched} batches (2 "
             f"attention layers each); launches {counts}")
    ref = check_buckets(engine, pool, "mha_classifier")
    cpu_ref = cpu_engine.infer(pool[:32])
    scale = float(cpu_ref.abs().max())
    err = float((ref - cpu_ref).abs().max())
    own = engine.infer(pool).cpu().numpy()
    served_err = max(float(np.abs(y - own[i]).max())
                     for i, y in answers.items())
    if err > INT8_CPU_RTOL * scale or served_err != 0.0:
        fail(f"serve int8 mha_classifier: card logits differ from the CPU "
             f"int8 engine by {err:.3e} ({err / scale:.3e} of {scale:.3e}, "
             f"tol {INT8_CPU_RTOL:g}) or served answers from the engine's "
             f"own by {served_err:.3e}")
    graphs = check_engine_graphs(engine, "serve int8 mha_classifier", rng)
    x32 = torch.from_numpy(pool[:32]).cuda()
    ms32 = eager_ms(lambda: engine.run_padded(x32), 20)
    eager32 = eager_ms(lambda: engine._forward(x32), 20)
    fp32 = InferenceEngine.from_model(copy.deepcopy(float_cpu), max_batch=32,
                                      device="cuda", warmup=False)
    fp32_ms32 = eager_ms(lambda: fp32.run_padded(x32), 20)
    print(f"serve int8: mha_classifier quantized once on the CPU; "
          f"{len(answers)} open-loop requests: {snap['batches']} batches, "
          f"p50 {snap['p50_ms']} ms, p99 {snap['p99_ms']} ms; flash_fwd "
          f"launches {counts['flash_fwd']} = 2 x {dispatched} batches; "
          f"logits bit-identical at every batch 1..32; vs the CPU int8 "
          f"engine max |err| {err:.3e} ({err / scale:.3e} of {scale:.3e}); "
          f"B=32 batch wall (replayed) {ms32:.3f} ms int8 (eager "
          f"{eager32:.3f}), {fp32_ms32:.3f} ms fp32; every bucket's replay "
          f"equals its eager forward bit for bit, launches a batch "
          f"{graphs['launches_per_batch']}, pool {graphs['pool_bytes']} B; "
          f"on {card}", flush=True)
    return {"launches": counts, "requests": len(answers), **snap,
            "max_abs_err_vs_cpu": err, "b32_ms": ms32, "b32_eager_ms": eager32,
            "fp32_b32_ms": fp32_ms32, "graphs": graphs}


# decode phase: full-width mha_decoder (V=64, E=64, 4 heads, 2 layers,
# max_seq_len 64) behind ContinuousBatcher on the card
DECODE_SEQS = 32
DECODE_SLOTS, DECODE_PAGE, DECODE_PAGES = 8, 8, 8
DECODE_STARVED_PAGES = 20      # 19 usable pages for up to 64 demanded
DECODE_STAGGER_S = 0.002       # between two submissions


def decoder_params(cfg, rng):
    """The JAX decoder's params dict as numpy, Kaiming-uniform as its
    ``init`` draws them (bound 1/sqrt(E)), from ``rng``; the head bias
    drawn too, so that it is not all zero."""
    import numpy as np

    e, v = cfg["embed_dim"], cfg["vocab_size"]

    def u(*shape):
        return rng.uniform(-e ** -0.5, e ** -0.5, size=shape).astype(
            np.float32)

    blocks = [{**{n: u(e, e) for n in ("wq", "wk", "wv", "wo")},
               **{n: u(e) for n in ("bq", "bk", "bv", "bo")}}
              for _ in range(cfg["num_layers"])]
    return {"embed": u(v, e), "head_w": u(e, v), "head_b": u(v),
            "blocks": blocks}


def decode_traffic(rng, max_context):
    """DECODE_SEQS (prompt, max_new_tokens): prompts of 1-24 tokens,
    8-40 new tokens, prompt + new within the context."""
    out = []
    for _ in range(DECODE_SEQS):
        plen = int(rng.integers(1, 25))
        new = int(min(rng.integers(8, 41), max_context - plen))
        out.append((rng.integers(0, 64, plen).tolist(), new))
    return out


def first_divergence(model, prompt, got, want):
    """Where two greedy continuations first differ, and the logit margin
    between the two tokens there under the CPU model's full forward."""
    import torch

    n = min(len(got), len(want))
    i = next((j for j in range(n) if got[j] != want[j]), n)
    if i == len(want):
        return i, float("nan")
    with torch.no_grad():
        logits = model(torch.tensor([list(prompt) + list(want[:i])]))[0, -1]
    return i, float(logits[int(want[i])] - logits[int(got[i])])


def phase_decode(card):
    """Continuous-batching greedy decode of mha_decoder on the card:
    DecodeEngine(max_slots=8, page_size=8, max_pages_per_seq=8) behind a
    threaded ContinuousBatcher answering 32 staggered sequences; every
    sequence's tokens held to decode_reference on the card and on the
    CPU; a page-starved engine that must preempt and still match; tokens/s,
    TTFT, slot occupancy, each lattice point's step time and the pool."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import get_precision_mode
    from dcnn_tpu_torch.interop import decoder_from_jax
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.serve import (
        ContinuousBatcher, DecodeEngine, DecodeMetrics, decode_reference,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    cfg = create_model("mha_decoder").get_config()
    params = decoder_params(cfg, rng)
    cpu_model = decoder_from_jax(cfg, params, device="cpu")
    geometry = dict(max_slots=DECODE_SLOTS, page_size=DECODE_PAGE,
                    max_pages_per_seq=DECODE_PAGES)
    cpu_engine = DecodeEngine(cpu_model, warmup=False, **geometry)
    traffic = decode_traffic(rng, cpu_engine.max_context)
    cpu_ref = [decode_reference(cpu_engine, p, max_new_tokens=n)
               for p, n in traffic]

    model = decoder_from_jax(cfg, params, device="cuda")
    t0 = time.perf_counter()
    engine = DecodeEngine(model, **geometry)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_ref = [decode_reference(engine, p, max_new_tokens=n)
                for p, n in traffic]
    ref_s = time.perf_counter() - t0

    def check(what, outs):
        for i, ((p, _), got) in enumerate(zip(traffic, outs)):
            for name, want in (("the card's", card_ref[i]),
                               ("the CPU's", cpu_ref[i])):
                if not np.array_equal(got, want):
                    at, margin = first_divergence(cpu_model, p, got, want)
                    fail(f"decode: {what} sequence {i} (prompt {p}) differs "
                         f"from {name} decode_reference at token {at}: "
                         f"{got.tolist()} vs {want.tolist()}; logit margin "
                         f"there {margin:.3e}")

    check("card decode_reference", card_ref)
    metrics = DecodeMetrics()
    batcher = ContinuousBatcher(engine, queue_capacity=64, metrics=metrics)
    t0 = time.perf_counter()
    futs = []
    for p, n in traffic:
        futs.append(batcher.submit(p, max_new_tokens=n))
        time.sleep(DECODE_STAGGER_S)
    batcher.drain(timeout=300)
    wall = time.perf_counter() - t0
    snap = metrics.snapshot()
    check("continuous", [f.result(timeout=0) for f in futs])
    if snap["completions"] != DECODE_SEQS:
        fail(f"decode: {snap['completions']} of {DECODE_SEQS} completed")

    starved = DecodeEngine(model, num_pages=DECODE_STARVED_PAGES,
                           warmup=False, **geometry)
    smetrics = DecodeMetrics()
    sb = ContinuousBatcher(starved, start=False, queue_capacity=64,
                           metrics=smetrics)
    sfuts = [sb.submit(p, max_new_tokens=n) for p, n in traffic]
    sb.drain()
    ssnap = smetrics.snapshot()
    check("starved", [f.result(timeout=0) for f in sfuts])
    if ssnap["evictions"] < 1:
        fail(f"decode: the starved pool ({DECODE_STARVED_PAGES} pages) "
             f"never preempted")

    # each lattice point's step as the batcher issues it (host arrays in,
    # next tokens read back), on the engine's pool (its graphs' own; put
    # back afterwards): replayed, and eager
    step_ms, eager_step_ms = {}, {}
    pk, pv = engine.pool.k, engine.pool.v
    saved = pk.clone(), pv.clone()

    def on_card(*arrays):
        return [torch.from_numpy(a).to("cuda", torch.long) for a in arrays]

    for b, mp in sorted(engine.compile_stats):
        toks = np.zeros(b, np.int32)
        pos = np.arange(b, dtype=np.int32) % (mp * DECODE_PAGE)
        table = np.tile(np.arange(1, mp + 1, dtype=np.int32), (b, 1))
        step_ms[f"{b}x{mp}"] = eager_ms(
            lambda: engine.run_step(toks, pos, table, pk, pv)[0].cpu(), 20)
        eager_step_ms[f"{b}x{mp}"] = eager_ms(
            lambda: engine._step(*on_card(toks, pos, table), pk,
                                 pv)[0].cpu(), 20)
    # every lattice point replayed against the eager step on a copy of the
    # pool, random K/V in it: next tokens, logits and the pool after the
    # step's writes bit for bit
    g = np.random.default_rng(SEED + 12)
    pk.normal_()
    pv.normal_()
    for b, mp in sorted(engine.compile_stats):
        if engine.sessions[(b, mp, get_precision_mode())].graph is None:
            fail(f"decode: lattice point {b}x{mp} was not captured")
        pos = np.full(b, -1, np.int64)
        table = np.zeros((b, mp), np.int64)
        for r in range(b - (b > 1)):  # one row inactive where b > 1
            pos[r] = g.integers(0, mp * DECODE_PAGE)
            table[r, :pos[r] // DECODE_PAGE + 1] = g.choice(
                np.arange(1, engine.pool.num_pages),
                pos[r] // DECODE_PAGE + 1, replace=False)
        toks = g.integers(0, cfg["vocab_size"], b)
        ck, cv = pk.clone(), pv.clone()
        nxt, logits, _, _ = engine.run_step(toks, pos, table, pk, pv)
        want_nxt, want_logits = engine._step(*on_card(toks, pos, table),
                                             ck, cv)
        if not (torch.equal(nxt, want_nxt) and torch.equal(logits, want_logits)
                and torch.equal(pk, ck) and torch.equal(pv, cv)):
            fail(f"decode: lattice point {b}x{mp}'s replay differs from the "
                 f"eager step (tokens, logits or pool writes)")
    del ck, cv
    b, mp = engine.max_slots, engine.max_pages_per_seq
    toks = np.zeros(b, np.int32)
    pos = np.arange(b, dtype=np.int32) % (mp * DECODE_PAGE)
    table = np.tile(np.arange(1, mp + 1, dtype=np.int32), (b, 1))
    graphs = replay_vs_eager(
        lambda: engine.run_step(toks, pos, table, pk, pv)[0].cpu(),
        lambda: engine._step(*on_card(toks, pos, table), pk, pv)[0].cpu(),
        20)
    graphs["pool_bytes"] = engine.graphs.bytes()
    pk.copy_(saved[0])
    pv.copy_(saved[1])
    del saved
    print(f"decode graphs: every lattice point's replay equals the eager "
          f"step bit for bit (tokens, logits, pool writes); step ms "
          f"replayed {json.dumps(step_ms)}, eager "
          f"{json.dumps(eager_step_ms)}; at {b}x{mp} "
          f"{json.dumps(graphs)} on {card}", flush=True)
    pool = engine.pool.snapshot()
    print(f"decode: mha_decoder (V=64, E=64, 4 heads, 2 layers) "
          f"{DECODE_SEQS} sequences (prompts 1-24, 8-40 new tokens) "
          f"submitted {DECODE_STAGGER_S * 1e3:g} ms apart: tokens equal "
          f"decode_reference on the card and on the CPU; {snap['tokens']} "
          f"tokens + {snap['prefill_tokens']} prefill in {snap['steps']} "
          f"steps, wall {wall:.3f} s, {snap['tokens'] / wall:.1f} tokens/s "
          f"(metrics {snap['tokens_per_sec']}), TTFT p50 "
          f"{snap['ttft_p50_ms']} ms p99 {snap['ttft_p99_ms']} ms, mean slot "
          f"occupancy {snap['slot_occupancy']}; starved pool "
          f"({DECODE_STARVED_PAGES} pages): {ssnap['evictions']} evictions, "
          f"tokens equal; pool {pool['num_pages']} pages x "
          f"{pool['page_bytes']} B = {pool['pool_bytes']} B; engine built "
          f"and {len(engine.compile_stats)} lattice points warmed in "
          f"{build_s:.3f} s; card references {ref_s:.2f} s; step ms "
          f"(replayed, host to host) by batch x pages {json.dumps(step_ms)};"
          f" phase wall "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return {**snap, "wall_s": wall, "starved_evictions": ssnap["evictions"],
            "step_ms": step_ms, "eager_step_ms": eager_step_ms,
            "graphs": graphs, "pool": pool}


# obs phase: the observability core on the card's paths
# (name, track, attribute keys) of the spans of Trainer.fit's host loop with
# a val loader; tests/test_torch_obs.py pins the JAX trainer's to these
OBS_TRAIN_SPANS = {
    ("train.epoch", "train", ("epoch", "span_id", "trace_id")),
    ("train.step", "train",
     ("batch", "epoch", "parent_id", "span_id", "trace_id")),
    ("train.eval", "train", ("epoch", "span_id", "trace_id")),
}
OBS_COST_REPS = 50        # calls a timing, tracer on and off
OBS_COST_ROUNDS = 5       # alternating rounds of each
OBS_PROFILE_SAMPLES = 64  # the ResNet-18 profiled epoch: two B=32 steps


def _http(url):
    """(status, body bytes) of a GET, 4xx/5xx included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def tracer_cost(fn, reps=OBS_COST_REPS):
    """Host wall ms a call of ``fn`` (which waits for its result), with the
    process-global tracer on and off, ``OBS_COST_ROUNDS`` alternating rounds
    each: (median on, median off, every round on, every round off)."""
    import statistics

    from dcnn_tpu_torch.obs import configure

    times = {True: [], False: []}
    fn()
    for _ in range(OBS_COST_ROUNDS):
        for on in (True, False):
            tracer = configure(enabled=on)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[on].append((time.perf_counter() - t0) * 1e3 / reps)
            tracer.clear()
    configure(enabled=False)
    return (statistics.median(times[True]), statistics.median(times[False]),
            [round(t, 4) for t in times[True]],
            [round(t, 4) for t in times[False]])


def phase_obs(card, traced_resident):
    """The observability core (``dcnn_tpu_torch.obs``, ``train/profiling``,
    ``core/debug``) on the card's paths:

    (a) ``mha_classifier`` trained with the train phase's recipe (B=32,
        Adam(1e-3), the marker task, 16 steps, a 64-sample val loader) with
        the tracer on, ``profiler=NORMAL``, ``flight_dir`` and
        ``debug=True``: losses and params bit-equal to the same run with
        all four off (else within the train phase's tolerance, and the
        printout says which), the flash kernels launched, the
        ``LayerProfiler`` table with every layer's forward and backward
        non-zero, the spans' names, tracks and keys those the CPU test pins
        for the JAX trainer, no flight bundle; then one NaN-poisoned batch
        under policy ``skip_step`` writes exactly one ``nonfinite_guard``
        bundle, and under ``debug=True`` raises ``FloatingPointError``;
    (b) int8 ``resnet18_tiny_imagenet`` served as the serve int8 phase
        serves it (80 open-loop requests at 400/s) behind
        ``DynamicBatcher.start_telemetry(port=0)``, ``/metrics``,
        ``/healthz`` and ``/snapshot`` scraped over HTTP while the requests
        run: the text parses, the card's memory gauges are non-zero,
        ``/healthz`` 200 and 503 after ``drain()``, ``/snapshot`` with
        serve, engine and tsdb, ``conv_int8_fused`` launched, logits
        bit-identical to the same engine with the tracer off;
    (c) the train feed phase's traced resident epoch (``traced_resident``,
        run there under ``set_sync_debug_mode("error")``);
    (d) ``mha_decoder``'s 32 staggered sequences with the tracer on: one
        ``decode.step`` span a step, tokens equal to the untraced
        ``decode_reference``, ``DecodeMetrics.prometheus()`` parses.

    Prints the tracer's cost (the mha train step and the int8 B=32 batch,
    tracer on and off) and the ``LayerProfiler`` table of one ResNet-18
    NCHW fp32 B=32 profiled step (the train cnn recipe, one epoch), each
    beside the card's name and power limit."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import ProfilerType, TrainingConfig, debug
    from dcnn_tpu_torch.data import (
        ArrayDataLoader, AugmentationBuilder, SyntheticClassificationLoader,
    )
    from dcnn_tpu_torch.interop import (
        decoder_from_jax, from_jax, opt_state_to_jax, to_jax,
    )
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.obs import configure, get_flight_recorder, get_tracer
    from dcnn_tpu_torch.obs.exposition import parse_prometheus_text
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import Adam, AdamW
    from dcnn_tpu_torch.resilience import FaultPlan
    from dcnn_tpu_torch.serve import (
        ContinuousBatcher, DecodeEngine, DecodeMetrics, DynamicBatcher,
        InferenceEngine, decode_reference,
    )
    from dcnn_tpu_torch.serve.traffic import open_loop
    from dcnn_tpu_torch.train import (
        Trainer, create_train_state, make_train_step,
    )

    t_phase = time.perf_counter()
    tracer = get_tracer()
    rec = get_flight_recorder()
    flight_before = rec.directory

    # (a) traced, profiled, debug-mode mha_classifier training
    cfg, params, rng = model_params()
    x, y = marker_task(rng)
    xv, yv = marker_task(np.random.default_rng(SEED + 30), n=64)
    batch = 32

    def mha_fit(epochs=2, jit=True, **kw):
        model = from_jax(cfg, params, device="cuda")
        opt = Adam(1e-3)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=epochs, batch_size=batch, snapshot_dir=None,
            progress_interval=0, device_type="cuda", **kw))
        if not jit:  # the eager twin
            trainer.train_step = eager_step(trainer)
        ts = trainer.fit(create_train_state(model, opt),
                         ArrayDataLoader(x, y, batch_size=batch, shuffle=True,
                                         seed=SEED),
                         ArrayDataLoader(xv, yv, batch_size=batch,
                                         shuffle=False))
        torch.cuda.synchronize()
        return trainer, ts, model

    plain, _, m_plain = mha_fit()
    flight = tempfile.TemporaryDirectory(prefix="chip_smoke_flight_",
                                         dir=ROOT)
    try:
        configure(enabled=True)
        tracer.clear()
        reset_launches()  # the traced training path starts here
        try:
            traced, ts_t, m_traced = mha_fit(
                profiler=ProfilerType.NORMAL, flight_dir=flight.name,
                debug=True)
            counts = launches()  # and ends here
        finally:
            configure(enabled=False)
            debug.disable_debug_mode()
        events = tracer.events()
        tracer.clear()
        a_counts = {k: counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                           "flash_bwd_dkv")}
        steps = ts_t.step
        la = [(h["train_loss"], h["val_loss"]) for h in plain.history]
        lb = [(h["train_loss"], h["val_loss"]) for h in traced.history]
        bit_equal = la == lb and all(
            torch.equal(p, q) for p, q in zip(m_plain.state_dict().values(),
                                              m_traced.state_dict().values()))
        loss_rel = max(abs(b[0] - a[0]) / abs(a[0]) for a, b in zip(la, lb))
        if not (bit_equal or loss_rel <= TRAIN_LOSS_RTOL):
            fail(f"obs: traced, profiled, debug-mode mha_classifier losses "
                 f"{lb} vs plain {la} (rel {loss_rel:.3e}, tol "
                 f"{TRAIN_LOSS_RTOL:g})")
        if steps != 16 or any(v < 2 * steps for v in a_counts.values()):
            fail(f"obs: traced mha training: {steps} steps, flash launches "
                 f"{a_counts} (at least 2 of each a step)")
        prof = traced.profiler
        names = [l.name for l in m_traced.layers]
        if not all(prof.forward_us.get(n, 0) > 0
                   and prof.backward_us.get(n, 0) > 0 for n in names):
            fail(f"obs: LayerProfiler missed a layer: forward "
                 f"{dict(prof.forward_us)}, backward {dict(prof.backward_us)}")
        shapes = {(e["name"], e["track"], tuple(sorted(e["args"])))
                  for e in events}
        n_spans = {n: sum(e["name"] == n for e in events)
                   for n in ("train.epoch", "train.step", "train.eval")}
        if shapes != OBS_TRAIN_SPANS or n_spans != {
                "train.epoch": 2, "train.step": steps, "train.eval": 2}:
            fail(f"obs: traced training spans {sorted(shapes)} "
                 f"({n_spans}), expected {sorted(OBS_TRAIN_SPANS)}")
        if rec.bundles():
            fail(f"obs: a clean run wrote flight bundles {rec.bundles()}")
        print(f"obs (a): mha_classifier {steps} steps of B={batch} with the "
              f"tracer on, profiler=NORMAL, flight_dir and debug=True: "
              f"losses and params "
              + ("bit-equal to" if bit_equal
                 else f"within {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL:g}) of")
              + f" the plain run ({lb}); flash launches {a_counts} (the "
              f"profiled passes and the eval included); spans {n_spans}; "
              f"LayerProfiler table of epoch 2 on {card}:\n"
              f"{prof.summary()}", flush=True)

        # one NaN batch: one nonfinite_guard bundle; under debug, raises
        def nan_fit(**kw):
            plan = FaultPlan().arm("train.nonfinite_input", at=3, times=1)
            with plan, warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return mha_fit(epochs=1, nonfinite_policy="skip_step",
                               flight_dir=flight.name, **kw)

        skipped, _, _ = nan_fit()
        bundles = rec.bundles()
        if ([b["trigger"] for b in bundles] != ["nonfinite_guard"]
                or skipped.guard.total_skipped != 1):
            fail(f"obs: a NaN batch under skip_step wrote bundles "
                 f"{bundles}, skipped {skipped.guard.total_skipped} steps")
        bundle_files = sorted(os.listdir(bundles[0]["path"]))
        # the guarded NaN epoch replayed from the step's two graphs and its
        # eager twin, each profiled
        twins, guard_profile = [], {}
        for jit in (True, False):
            got = []
            guard_profile["replayed" if jit else "eager"] = {
                k: round(v, 4) for k, v in profiled(
                    lambda: got.append(nan_fit(jit=jit)), 8).items()}
            t_, ts_, m_ = got[0]
            twins.append((t_.history, to_jax(m_),
                          opt_state_to_jax(m_, ts_.opt_state), ts_.step))
            if jit:
                guard_profile["launches_per_step"] = {
                    k: v for _, ss in t_.train_step._sessions.values()
                    for sess in ss for k, v in sess.launch_names().items()}
        twin = same_run(*twins)
        if twin or twins[0][3] != 7:
            fail(f"obs: the guarded NaN epoch replayed from graphs differs "
                 f"from its eager twin: {twin or twins[0][3]} steps")
        try:
            nan_fit(debug=True)
        except FloatingPointError as e:
            raised = str(e)
        else:
            fail("obs: a NaN batch under debug=True did not raise "
                 "FloatingPointError")
        finally:
            debug.disable_debug_mode()
        print(f"obs (a): a NaN batch under policy skip_step: one "
              f"nonfinite_guard bundle ({bundle_files}; reasons "
              f"{bundles[0]['reasons']}), the guarded epoch (two graphs "
              f"a step around the host's read) bit-equal to its eager twin, "
              f"profiled a step {json.dumps(guard_profile)}; under "
              f"debug=True: FloatingPointError({raised!r})", flush=True)
    finally:
        rec.directory = flight_before
        flight.cleanup()

    # the tracer's cost on the mha train step
    model = from_jax(cfg, params, device="cuda")
    opt = Adam(1e-3)
    ts = create_train_state(model, opt)
    step = make_train_step(model, get_loss("softmax_crossentropy"), opt)
    xb, yb = torch.from_numpy(x[:batch]).cuda(), torch.from_numpy(
        y[:batch]).cuda()

    def train_step():
        with tracer.span("train.step", track="train", epoch=0, batch=0):
            float(step(ts, xb, yb, 1e-3)[0])

    train_step()  # the eager first step
    train_step()  # the capture; the timed calls replay

    step_on, step_off, step_rounds_on, step_rounds_off = tracer_cost(
        train_step)

    # (b) int8 ResNet-18 behind start_telemetry, scraped while it serves
    rng = np.random.default_rng(SEED + 10)
    cfg_r, _, _, float_cpu = resnet18("cpu", rng)
    calib = rng.normal(size=(INT8_CALIB, *cfg_r["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(INT8_REQUESTS, *cfg_r["input_shape"])).astype(
        np.float32)
    configure(enabled=True)
    tracer.clear()
    reset_launches()  # the telemetry-served int8 path starts here
    engine = InferenceEngine.from_model(float_cpu, int8_calib=calib,
                                        max_batch=32, device="cuda")
    batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
    cadence = os.environ.get("DCNN_TSDB_INTERVAL")
    os.environ["DCNN_TSDB_INTERVAL"] = "0.05"  # samples within the traffic
    try:
        srv = batcher.start_telemetry(port=0)
        live, done = [], threading.Event()

        def scrape():
            while not done.is_set():
                live.append({p: _http(srv.url + p)
                             for p in ("/metrics", "/healthz", "/snapshot")})

        scraper = threading.Thread(target=scrape, name="obs-scraper")
        scraper.start()
        futs = open_loop(batcher, list(pool), INT8_RPS,
                         INT8_REQUESTS / INT8_RPS)
        done.set()
        scraper.join()
        answers = {i: f.result(timeout=300) for i, f in futs}
        final = {p: _http(srv.url + p) for p in ("/metrics", "/snapshot")}
        batcher.drain(timeout=300)
        drained = _http(srv.url + "/healthz")
        b_counts = launches()  # the served path ends here
    finally:
        batcher.shutdown()
        configure(enabled=False)
        if cadence is None:
            os.environ.pop("DCNN_TSDB_INTERVAL", None)
        else:
            os.environ["DCNN_TSDB_INTERVAL"] = cadence
    serve_spans = tracer.span_counts()
    tracer.clear()
    if not live:
        fail("obs: no scrape completed while the requests ran")
    fams = parse_prometheus_text(final["/metrics"][1].decode())
    live_fams = parse_prometheus_text(live[-1]["/metrics"][1].decode())
    snap = json.loads(final["/snapshot"][1])
    codes = {p: live[-1][p][0] for p in live[-1]}
    if not (codes == {"/metrics": 200, "/healthz": 200, "/snapshot": 200}
            and drained[0] == 503
            and fams["hbm_bytes_in_use"]["value"] > 0
            and fams["hbm_peak_bytes"]["value"] > 0
            and live_fams["hbm_bytes_in_use"]["value"] > 0
            and {"serve", "engine", "tsdb"} <= set(snap)
            and snap["tsdb"]["samples"] > 0
            and fams["serve_samples_completed_total"]["value"]
            == len(answers) == INT8_REQUESTS
            and b_counts["conv_int8_fused"] > 0):
        fail(f"obs: telemetry over the int8 engine: live codes {codes}, "
             f"after drain {drained[0]}, hbm "
             f"{fams.get('hbm_bytes_in_use')}, snapshot keys "
             f"{sorted(snap)}, completed "
             f"{fams.get('serve_samples_completed_total')}, "
             f"{len(answers)} answers, conv_int8_fused "
             f"{b_counts['conv_int8_fused']}")
    plain_logits = engine.infer(pool).cpu().numpy()  # tracer off
    if any(not np.array_equal(y, plain_logits[i]) for i, y in
           answers.items()):
        fail("obs: traced served int8 logits differ from the same engine's "
             "with the tracer off")
    x32 = torch.from_numpy(pool[:32]).cuda()

    def int8_batch():
        with tracer.span("serve.dispatch", track="serve", requests=32,
                         rows=32):
            with tracer.span("serve.infer", track="serve", bucket=32,
                             rows=32):
                engine.run_padded(x32).float().cpu()

    int8_on, int8_off, int8_rounds_on, int8_rounds_off = tracer_cost(
        int8_batch)
    print(f"obs (b): int8 resnet18_tiny_imagenet, {len(answers)} open-loop "
          f"requests at {INT8_RPS:g}/s behind start_telemetry(port=0): "
          f"{len(live)} scrapes of /metrics /healthz /snapshot while they "
          f"ran (codes {codes}), /healthz {drained[0]} after drain; "
          f"hbm_bytes_in_use {fams['hbm_bytes_in_use']['value']:.0f}, "
          f"hbm_peak_bytes {fams['hbm_peak_bytes']['value']:.0f}, "
          f"hbm_bytes_limit {fams['hbm_bytes_limit']['value']:.0f}; "
          f"/snapshot blocks {sorted(snap)}; tsdb {snap['tsdb']}; "
          f"conv_int8_fused launches {b_counts['conv_int8_fused']}; spans "
          f"{serve_spans}; logits bit-identical to the untraced engine's; "
          f"on {card}", flush=True)
    print(f"obs: tracer cost on {card}: mha_classifier train step (B=32, "
          f"loss read) {step_on:.4f} ms traced, {step_off:.4f} ms not "
          f"(rounds {step_rounds_on} and {step_rounds_off}); int8 resnet18 "
          f"B=32 batch (logits read) {int8_on:.4f} ms traced, "
          f"{int8_off:.4f} ms not (rounds {int8_rounds_on} and "
          f"{int8_rounds_off}); medians of {OBS_COST_ROUNDS} alternating "
          f"rounds of {OBS_COST_REPS} calls", flush=True)

    # (c) from the train feed phase
    print(f"obs (c): the train feed phase's full-split resident epoch again "
          f"with the tracer on, under set_sync_debug_mode('error'): mean "
          f"loss {traced_resident['mean_loss']}, spans "
          f"{traced_resident['spans']}, no synchronisation", flush=True)

    # (d) decode with the tracer on
    rng = np.random.default_rng(SEED + 11)
    cfg_d = create_model("mha_decoder").get_config()
    params_d = decoder_params(cfg_d, rng)
    dec = decoder_from_jax(cfg_d, params_d, device="cuda")
    d_engine = DecodeEngine(dec, max_slots=DECODE_SLOTS, page_size=DECODE_PAGE,
                            max_pages_per_seq=DECODE_PAGES)
    traffic = decode_traffic(rng, d_engine.max_context)
    want = [decode_reference(d_engine, p, max_new_tokens=n)
            for p, n in traffic]
    metrics = DecodeMetrics()
    configure(enabled=True)
    tracer.clear()
    try:
        cb = ContinuousBatcher(d_engine, queue_capacity=64, metrics=metrics)
        futs = []
        for p, n in traffic:
            futs.append(cb.submit(p, max_new_tokens=n))
            time.sleep(DECODE_STAGGER_S)
        cb.drain(timeout=300)
    finally:
        configure(enabled=False)
    d_spans = tracer.span_counts().get("decode.step", 0)
    tracer.clear()
    dsnap = metrics.snapshot()
    dfams = parse_prometheus_text(metrics.prometheus())
    same = all(np.array_equal(f.result(timeout=0), w)
               for f, w in zip(futs, want))
    if not (same and d_spans == dsnap["steps"] > 0
            and dfams["decode_tokens_total"]["value"] == dsnap["tokens"]):
        fail(f"obs: traced decode: tokens equal to the untraced reference "
             f"{same}, decode.step spans {d_spans} for {dsnap['steps']} "
             f"steps, decode_tokens_total "
             f"{dfams.get('decode_tokens_total')} vs {dsnap['tokens']}")
    print(f"obs (d): mha_decoder {DECODE_SEQS} sequences with the tracer "
          f"on: {d_spans} decode.step spans for {dsnap['steps']} steps, "
          f"tokens equal the untraced decode_reference, "
          f"DecodeMetrics.prometheus() parses ({len(dfams)} families); on "
          f"{card}", flush=True)

    # the per-layer account of a ResNet-18 training step
    cfg_c = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
    params_c, state_c = jax_layout(cfg_c, np.random.default_rng(SEED + 7))
    model = from_jax(cfg_c, params_c, state_c, device="cuda")
    opt = AdamW(CNN_TRAIN_LR, weight_decay=1e-4)
    ldr = SyntheticClassificationLoader(
        OBS_PROFILE_SAMPLES, (3, 64, 64), 200, batch_size=CNN_TRAIN_BATCH,
        seed=SEED, augmentation=AugmentationBuilder("NCHW").random_crop(4)
        .horizontal_flip(0.5).build())
    trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        epochs=1, batch_size=CNN_TRAIN_BATCH, learning_rate=CNN_TRAIN_LR,
        snapshot_dir=None, progress_interval=0, device_type="cuda",
        profiler=ProfilerType.NORMAL))
    trainer.fit(create_train_state(model, opt), ldr)
    prof = trainer.profiler
    table = {n: [round(prof.forward_us[n], 1), round(prof.backward_us[n], 1)]
             for n in prof.forward_us}
    if not all(f > 0 and b > 0 for f, b in table.values()):
        fail(f"obs: the ResNet-18 LayerProfiler table has an empty layer: "
             f"{table}")
    print(f"obs: LayerProfiler, one profiled step of resnet18_tiny_imagenet "
          f"NCHW fp32 B={CNN_TRAIN_BATCH} (the train cnn recipe, one epoch; "
          f"CUDA events per layer, forward and backward) on {card}:\n"
          f"{prof.summary()}\nobs: " + json.dumps({"card": card,
                                                   "resnet18_layers_us":
                                                   table}), flush=True)
    print(f"obs: phase wall {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return {**a_counts, "conv_int8_fused": b_counts["conv_int8_fused"],
            "step_ms": (step_on, step_off), "int8_ms": (int8_on, int8_off)}


# export phase: the served program as an artifact and the AOT cache
EXPORT_SEED = SEED + 16


def export_models():
    """The export phase's models on the CPU, from its seed: full-width
    NHWC resnet18_tiny_imagenet (JAX-layout weights and random BN
    statistics, carried by interop), its INT8_CALIB-sample calibration
    batch, INT8_REQUESTS requests, and mha_classifier (fp32) with as many
    requests of its shape."""
    import numpy as np

    from dcnn_tpu_torch.interop import from_jax

    rng = np.random.default_rng(EXPORT_SEED)
    cfg, _, _, resnet = resnet18("cpu", rng)
    calib = rng.normal(size=(INT8_CALIB, *cfg["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(INT8_REQUESTS, *cfg["input_shape"])).astype(
        np.float32)
    mcfg, mparams, mrng = model_params()
    mha = from_jax(mcfg, mparams, device="cpu").eval()
    mpool = mrng.normal(size=(INT8_REQUESTS, *mcfg["input_shape"])).astype(
        np.float32)
    return resnet, calib, pool, mha, mpool


def export_start(cache_root: str, out: str, artifact: str,
                 inputs: str) -> None:
    """Two starts in a process of its own, ``nvcc`` refused throughout (a
    cold process finds the libraries main built in the build directory
    and commits them to the cache; a warm one restores them into an empty
    build directory):

    A. the int8 resnet18_tiny_imagenet artifact file ``artifact`` served
       by InferenceEngine.from_artifact (its libraries through the cache
       at ``cache_root``) on the batch in ``inputs``, with building a
       model and reading a checkpoint refused: the artifact needs neither;
       this is also the process's first ``torch.export.load``;
    B. InferenceEngine.from_model(resnet18, int8_calib=..., aot_cache=
       cache_root): a cold process calibrates, exports and commits the
       program; a warm one (``out`` ending in "warm.json") loads it, with
       ``torch.export.export`` refused.

    Writes to ``out`` each start's seconds (the engine's construction: its
    libraries, its program, its graphs; B's program load or export and
    its captures within it), B's hit and the aot counters, and the logits
    of A and B beside it as .npy."""
    import numpy as np
    import torch

    import importlib

    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.serve import InferenceEngine

    sequential = importlib.import_module("dcnn_tpu_torch.nn.sequential")
    checkpoint = importlib.import_module("dcnn_tpu_torch.train.checkpoint")

    def refused(*a, **k):
        raise AssertionError("this start must not run nvcc, trace, build "
                             "a model or read a checkpoint")

    _kernels._nvcc = refused
    if out.endswith("warm.json"):
        torch.export.export = refused
    reg = MetricsRegistry()
    x = np.load(inputs)

    def timed(make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = make()
        torch.cuda.synchronize()
        return engine, time.perf_counter() - t0

    init, load = sequential.Sequential.__init__, checkpoint.load_checkpoint
    sequential.Sequential.__init__ = checkpoint.load_checkpoint = refused
    art, art_s = timed(lambda: InferenceEngine.from_artifact(
        artifact, max_batch=32, aot_cache=cache_root, registry=reg))
    np.save(out[:-5] + "-artifact.npy", art.infer(x).cpu().numpy())
    sequential.Sequential.__init__, checkpoint.load_checkpoint = init, load

    resnet, calib, _, _, _ = export_models()
    engine, start_s = timed(lambda: InferenceEngine.from_model(
        resnet, int8_calib=calib, max_batch=32, device="cuda",
        aot_cache=cache_root, registry=reg))
    np.save(out[:-5] + ".npy", engine.infer(x).cpu().numpy())
    snap = reg.snapshot()
    info = engine.aot_info["program"]
    with open(out, "w") as f:
        json.dump({"artifact_start_s": art_s, "start_s": start_s,
                   "program_load_s": info.get("load_s"),
                   "program_compile_s": info.get("compile_s"),
                   "capture_s": sum(st["capture_s"] for st in
                                    engine.compile_stats.values()),
                   "program_hit": info["hit"],
                   "counters": {k: v for k, v in snap.items()
                                if k.startswith(("aot_", "compile_"))}}, f)


def _no_nvcc_path() -> str:
    """PATH without the directories that hold an ``nvcc``."""
    return os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))


def phase_export(card):
    """The served program as an artifact (nn/export.py, ops/library.py)
    and the AOT cache (aot/, utils/compile_cache.py) on the card:
    - int8 resnet18_tiny_imagenet (NHWC, quantized once on the CPU with
      INT8_CALIB samples) and fp32 mha_classifier exported on the card to
      files, served through InferenceEngine.from_artifact behind
      DynamicBatcher (open-loop requests), against engines over the live
      models at every bucket: int8 bit for bit, each replay launching
      conv_int8_fused at the 21 sites and pack_int8_weight never; the
      mha_classifier program's two flash forwards a replay, its logits
      equal to the live engine's (or within 1e-5 relative, printed);
    - a cold and a warm engine start through a temporary cache root, each
      in a process of its own (export_start): the cold one commits the
      libraries main built (no nvcc) and the exported program, the warm
      one restores every library into an empty build directory with nvcc
      and CUDA_HOME unreachable, loads the program, exports nothing, and
      serves the cold start's logits bit for bit;
    - one byte of a cached program (mha_classifier's) flipped:
      quarantined and exported again, serving the same logits."""
    import copy
    import tempfile
    import warnings

    import numpy as np
    import torch

    from dcnn_tpu_torch.aot import get_cache
    from dcnn_tpu_torch.nn import export_inference, quantize_model
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.serve import InferenceEngine

    resnet, calib, pool, mha, mpool = export_models()
    qmodel = quantize_model(resnet, calib)  # once, on the CPU
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_export_", dir=ROOT)
    with tmp:
        for name, model, requests, per_batch in (
                ("resnet18", qmodel, pool, {"conv_int8_fused": INT8_CONVS}),
                ("mha_classifier", mha, mpool, {"flash_fwd": 2})):
            live = InferenceEngine.from_model(copy.deepcopy(model),
                                              fold=False, max_batch=32,
                                              device="cuda")
            t0 = time.perf_counter()
            blob = export_inference(copy.deepcopy(model), device="cuda")
            export_s = time.perf_counter() - t0
            path = os.path.join(tmp.name, f"{name}.pt2")
            with open(path, "wb") as f:
                f.write(blob)
            packs = _kernels.pack_int8_weight.calls
            reset_launches()  # the artifact's serving path starts here
            t0 = time.perf_counter()
            art = InferenceEngine.from_artifact(path, max_batch=32)
            load_s = time.perf_counter() - t0
            answers, snap, warm = serve_open_loop(art, requests,
                                                  f"export {name}")
            counts = launches()  # and ends here
            dispatched = 2 * len(art.bucket_sizes) + warm + snap["batches"]
            for k, n in per_batch.items():
                if counts[k] != n * dispatched:
                    fail(f"export {name}: {k} launched {counts[k]} times "
                         f"for {dispatched} batches ({n} each)")
            if counts["conv_int8"] or (name == "mha_classifier" and
                                       counts["conv_int8_fused"]):
                fail(f"export {name}: launches {counts}")
            if _kernels.pack_int8_weight.calls != packs:
                fail(f"export {name}: the artifact packed weights "
                     f"{_kernels.pack_int8_weight.calls - packs} times")
            own = art.infer(requests).cpu().numpy()
            served_err = max(float(np.abs(y - own[i]).max())
                             for i, y in answers.items())
            worst = 0.0
            per_replay = {}
            for b in art.bucket_sizes:
                x = torch.from_numpy(requests[:b]).cuda()
                moved = []
                for eng in (live, art):
                    before = launches()
                    y = eng.run_padded(x).cpu()
                    moved.append(({k: v - before[k] for k, v in
                                   launches().items() if v != before[k]}, y))
                (lm, ly), (am, ay) = moved
                rel = float((ay - ly).abs().max()) / float(ly.abs().max())
                worst = max(worst, rel)
                if lm != am or (name == "resnet18" and not torch.equal(ay, ly)) \
                        or rel > 1e-5:
                    fail(f"export {name}: bucket {b}: the artifact's replay "
                         f"launched {am} (live {lm}), logits {rel:.3e} "
                         f"relative from the live engine's")
                per_replay[b] = am
            # a float engine sums in another order at another bucket
            if served_err > (0.0 if art.batch_invariant
                             else 1e-5 * float(np.abs(own).max())):
                fail(f"export {name}: served answers differ from the "
                     f"artifact engine's own by {served_err:.3e}")
            print(f"export: {name} exported on the card in {export_s:.2f} s "
                  f"({len(blob)} bytes), loaded by from_artifact in "
                  f"{load_s:.2f} s (graphs captured at every bucket); "
                  f"{len(answers)} open-loop requests through DynamicBatcher: "
                  f"{snap['batches']} batches, p50 {snap['p50_ms']} ms, p99 "
                  f"{snap['p99_ms']} ms; launches {counts} over "
                  f"{dispatched} batches, pack_int8_weight 0; served answers "
                  f"against the engine's own max |diff| {served_err:.3e}; "
                  f"every bucket "
                  f"against the live engine: launches a replay equal "
                  f"({per_replay[32]} at 32), logits "
                  f"{'bit-identical' if worst == 0.0 else f'max rel {worst:.3e}'}"
                  f"; on {card}", flush=True)
            out[name] = {"launches": counts, "export_s": export_s,
                         "load_s": load_s, "bytes": len(blob),
                         "max_rel_vs_live": worst, **snap,
                         "logits32": art.infer(requests[:32]).cpu().numpy()}

        # cold and warm starts through the AOT cache, each its own process
        croot = os.path.join(tmp.name, "cache")
        inputs = os.path.join(tmp.name, "pool32.npy")
        np.save(inputs, pool[:32])
        artifact_logits = out["resnet18"].pop("logits32")
        out["mha_classifier"].pop("logits32")
        env = {k: v for k, v in os.environ.items()
               if k not in ("AOT_CACHE", "DCNN_COMPILE_CACHE")}
        warm_env = dict(env, PATH=_no_nvcc_path(),
                        CUDA_HOME=os.path.join(tmp.name, "no-cuda"),
                        DCNN_COMPILE_CACHE=os.path.join(tmp.name, "build"))
        starts = {}
        for tag, e in (("cold", env), ("warm", warm_env)):
            res = os.path.join(tmp.name, f"{tag}.json")
            r = subprocess.run(
                [sys.executable, "-c",
                 f"import sys; sys.path.insert(0, {ROOT!r}); "
                 f"import chip_smoke; chip_smoke.export_start("
                 f"{croot!r}, {res!r}, "
                 f"{os.path.join(tmp.name, 'resnet18.pt2')!r}, {inputs!r})"],
                env=e, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                fail(f"export: the {tag} start failed:\n{r.stderr[-3000:]}")
            with open(res) as f:
                starts[tag] = json.load(f)
            for part in ("", "-artifact"):
                got = np.load(res[:-5] + part + ".npy")
                if not np.array_equal(got, artifact_logits):
                    fail(f"export: the {tag} process's "
                         f"{'artifact' if part else 'engine'} logits differ "
                         f"from the artifact engine's here")
        cold, warm_ = starts["cold"], starts["warm"]
        libs = len(_kernels.SOURCES)
        wc = warm_["counters"]
        if (cold["program_hit"] or not warm_["program_hit"]
                or wc.get("aot_hits_total") != libs + 1
                or wc.get("aot_commits_total", 0)
                or wc.get("compile_total", 0)
                or cold["counters"].get("aot_commits_total") != libs + 1):
            fail(f"export: cold start {cold['counters']} (program hit "
                 f"{cold['program_hit']}), warm start {wc} (program hit "
                 f"{warm_['program_hit']}): the warm start must hit every "
                 f"library and the program and build nothing")
        built = sorted(p for p in os.listdir(warm_env["DCNN_COMPILE_CACHE"])
                       if p.endswith(".so"))
        if built != sorted(_kernels._lib_path(n).name
                           for n in _kernels.SOURCES):
            fail(f"export: the warm start's build directory holds {built}")

        # a flipped byte in a cached program (mha_classifier's, committed
        # here): quarantined and exported again
        reg = MetricsRegistry()
        cache = get_cache(croot, registry=reg)

        def mha_engine():
            return InferenceEngine.from_model(
                copy.deepcopy(mha), fold=False, max_batch=32, device="cuda",
                aot_cache=cache, registry=reg, warmup=False)

        first = mha_engine()
        x32 = torch.from_numpy(mpool[:32]).cuda()
        want = first.run_padded(x32).cpu()
        key = first.aot_info["program"]["key"]
        payload = os.path.join(cache.root, key, "payload.bin")
        with open(payload, "r+b") as f:
            f.seek(len(f.read()) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0x40]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = mha_engine()
        info = again.aot_info["program"]
        q = reg.snapshot().get("aot_quarantined_total", 0)
        if (info["hit"] or not info["committed"] or info["key"] != key
                or q != 1
                or not any("quarantined" in str(w.message) for w in caught)):
            fail(f"export: a flipped byte of the cached program: hit "
                 f"{info['hit']}, committed {info['committed']}, "
                 f"quarantined {q}")
        if not torch.equal(again.run_padded(x32).cpu(), want):
            fail("export: the program exported again after the quarantine "
                 "serves other logits")
    print(f"export: engine start through the AOT cache, int8 "
          f"resnet18_tiny_imagenet, max_batch 32, each in a process of "
          f"its own after that process served the int8 artifact file with "
          f"building a model and reading a checkpoint refused (the "
          f"process's first torch.export.load: cold "
          f"{cold['artifact_start_s']:.3f} s, warm "
          f"{warm_['artifact_start_s']:.3f} s): cold {cold['start_s']:.3f} "
          f"s (calibration and export {cold['program_compile_s']} s, "
          f"captures {cold['capture_s']:.3f} s; counters "
          f"{json.dumps(cold['counters'])}), warm {warm_['start_s']:.3f} s "
          f"with nvcc and CUDA_HOME unreachable and an empty build "
          f"directory (program load {warm_['program_load_s']} s, captures "
          f"{warm_['capture_s']:.3f} s; counters {json.dumps(wc)}), "
          f"the artifact's and both engines' logits bit-identical to the "
          f"artifact engine's here; a flipped byte of a cached program "
          f"quarantined and exported again; on {card}", flush=True)
    out["starts"] = {k: {n: v[n] for n in v if n != "logits"}
                     for k, v in starts.items()}
    return out


# pipeline phases: mha_classifier and resnet18_tiny_imagenet split into
# stages, trained host-driven (sync, semi-async) and compiled (GPipe,
# 1F1B as one graph each)
PIPE_LR = 0.01            # SGD: params compare without Adam's noise floor
PIPE_MHA = dict(batch=64, micro=4, stages=2)
PIPE_CNN = dict(batch=128, micro=8, stages=4)
PIPE_BATCHES = 4          # the first is every engine's warm-up
PIPE_TIMED = 4            # warm steps a timed window (a compiled or unsplit
PIPE_HOST_TIMED = 2       # step), warm batches a window of the host-driven
PIPE_WINDOWS = 5          # windows an engine; a rate is their median
PIPE_PARAM_TOL = TRAIN_PARAM_ATOL  # max |diff|, any param or BN statistic
COMPILED_TOL = 2e-5       # compiled vs host-driven, the JAX package's test
PIPE_ENGINES = ("sync", "semi_async")


def pipe_batches(x, y, batch):
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(PIPE_BATCHES)]


def named_host(model) -> dict:
    """Every param and buffer of ``model``, on the host."""
    return {n: t.detach().cpu().double().numpy()
            for n, t in list(model.named_parameters())
            + list(model.named_buffers())}


def window_rates(run, samples: int) -> dict:
    """samples/s of ``run()`` (one window of ``samples`` samples, ending in
    a host read) over ``PIPE_WINDOWS`` windows on the card: the median,
    the slowest and fastest window, and the spread, (max - min) / median.
    Two engines' rates differ by more than noise only where the gap
    exceeds both spreads."""
    import torch

    rates = []
    for _ in range(PIPE_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        rates.append(samples / (time.perf_counter() - t0))
    rates.sort()
    med = rates[len(rates) // 2]
    return {"median": med, "min": rates[0], "max": rates[-1],
            "spread": (rates[-1] - rates[0]) / med}


def rate_text(r: dict) -> str:
    return (f"{r['median']:.1f} samples/s (median of {PIPE_WINDOWS} "
            f"windows, {r['min']:.1f}-{r['max']:.1f}, spread "
            f"{100 * r['spread']:.1f}%)")


def max_named_diff(a: dict, b: dict) -> float:
    import numpy as np

    if list(a) != list(b):
        fail(f"pipeline: named tensors differ: {sorted(set(a) ^ set(b))}")
    return max(float(np.abs(a[n] - b[n]).max()) for n in a)


def unsplit_run(model, batches, micro, lr):
    """``make_train_step(num_microbatches=micro)`` over ``batches``: the
    per-batch losses, the final params and buffers, and the
    :func:`window_rates` of windows of ``PIPE_TIMED`` more steps on the
    last batch (replays: the first call ran eagerly, the second
    captured)."""
    import torch

    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.train import create_train_state, make_train_step

    opt = SGD(lr)
    ts = create_train_state(model, opt)
    step = make_train_step(model, get_loss("softmax_crossentropy"), opt,
                           num_microbatches=micro)
    dev = next(model.parameters()).device
    losses = []
    for x, y in batches:
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses.append(float(step(ts, x, y, lr)[0]))
    named = named_host(model)

    def window():
        for _ in range(PIPE_TIMED):
            float(step(ts, x, y, lr)[0])

    return losses, named, window_rates(window, PIPE_TIMED * len(x))


def pipeline_run(model, batches, spec, schedule, device):
    """``train_pipeline_epoch`` over ``batches`` through an
    ``InProcessPipelineCoordinator`` (FLOP-balanced): the first batch as
    an epoch of its own (the warm-up), then the rest as one epoch.
    Returns both epochs' mean losses, the gathered params and buffers
    under the full model's names, the :func:`window_rates` of further
    epochs of ``PIPE_HOST_TIMED`` batches (the last batch again; on the
    card), the launches each of the first two epochs added to the
    counters and the coordinator."""
    import torch

    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (
        FlopBalancedPartitioner, InProcessPipelineCoordinator,
    )
    from dcnn_tpu_torch.parallel.pipeline import train_pipeline_epoch

    coord = InProcessPipelineCoordinator(
        model, SGD(PIPE_LR), "softmax_crossentropy",
        num_stages=spec["stages"], partitioner=FlopBalancedPartitioner(),
        devices=[device] * spec["stages"], num_microbatches=spec["micro"])
    coord.deploy_stages()
    losses, counts, sps = [], [], None
    for epoch in (batches[:1], batches[1:]):
        reset_launches()
        losses.append(train_pipeline_epoch(coord, epoch, PIPE_LR, rng=SEED,
                                           schedule=schedule)[0])
        counts.append({k: v for k, v in launches().items() if v})
    p, s = coord.gathered_params()
    named = {n: t.double().numpy() for n, t in {**p, **s}.items()}
    if device == "cuda":
        sps = window_rates(
            lambda: train_pipeline_epoch(
                coord, batches[-1:] * PIPE_HOST_TIMED, PIPE_LR, rng=SEED,
                schedule=schedule),
            PIPE_HOST_TIMED * len(batches[0][0]))
    return losses, named, sps, counts, coord


def load_reports(coord, batch) -> list:
    """Each stage's ``collect_load_reports()`` over two more semi-async
    batches with every call fenced and timed (``track_load=True``)."""
    from dcnn_tpu_torch.parallel.pipeline import train_pipeline_epoch

    for s in coord.stages:
        s.track_load = True
        s.load.clear()
    train_pipeline_epoch(coord, [batch, batch], PIPE_LR, rng=SEED + 1)
    return coord.collect_load_reports()


def epoch_means(losses, batches):
    """The unsplit run's per-batch losses as the pipeline epochs' means:
    the first batch, then the mean of the rest."""
    return [losses[0], sum(losses[1:]) / (len(batches) - 1)]


def phase_pipeline(card):
    """Model splitting and the host-driven pipeline on the card:
    full-width ``mha_classifier`` (B=64, M=4, 2 FLOP-balanced stages, an
    attention block in each) and ``resnet18_tiny_imagenet`` (NCHW, B=128,
    M=8, 4 FLOP-balanced stages), each trained over 4 batches (SGD)
    through ``train_pipeline_epoch`` under the sync and semi-async
    schedules, every stage on its own CUDA stream. Gates: losses and
    params (BN statistics too) against the unsplit
    ``make_train_step(num_microbatches=M)`` on the card (cuDNN
    deterministic), and for ``mha_classifier`` against the same pipeline
    on the CPU; the flash launch counters show rows 1-3 on the path (per
    batch: one forward, one dQ and one dK/dV a stage holding attention and
    microbatch). Prints samples/s of every engine and the stages' load
    reports with the card's name and power limit."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.models import create_model

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"launches": {}, "samples_per_s": {}, "load_reports": {}}
    try:
        # mha_classifier
        cfg, params, rng = model_params()
        spec = PIPE_MHA
        x, y = marker_task(rng, n=spec["batch"] * PIPE_BATCHES)
        batches = pipe_batches(x, y, spec["batch"])
        ref_losses, ref_named, sps = unsplit_run(
            from_jax(cfg, params, device="cuda"), batches, spec["micro"],
            PIPE_LR)
        out["samples_per_s"]["mha_unsplit"] = sps
        for schedule in PIPE_ENGINES:
            losses, named, sps, counts, coord = pipeline_run(
                from_jax(cfg, params, device="cuda"), batches, spec,
                schedule, "cuda")
            if coord.partitions != [(0, 1), (1, 4)]:
                fail(f"pipeline: mha partitions {coord.partitions}, "
                     f"expected an attention block in each of 2 stages")
            cpu_losses, cpu_named, _, _, _ = pipeline_run(
                from_jax(cfg, params, device="cpu"), batches, spec,
                schedule, "cpu")
            for i, (n_batches, c) in enumerate(zip((1, PIPE_BATCHES - 1),
                                                   counts)):
                want = {k: 2 * spec["micro"] * n_batches
                        for k in ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")}
                if c != want:
                    fail(f"pipeline: mha {schedule} epoch {i} launches {c}, "
                         f"expected {want}")
            out["launches"][f"mha_{schedule}"] = {
                k: sum(c.get(k, 0) for c in counts)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            ref = epoch_means(ref_losses, batches)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            rel_cpu = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, cpu_losses))
            d_ref = max_named_diff(named, ref_named)
            d_cpu = max_named_diff(named, cpu_named)
            if not (all(math.isfinite(v) for v in losses)
                    and rel <= TRAIN_LOSS_RTOL and rel_cpu <= TRAIN_LOSS_RTOL
                    and d_ref <= PIPE_PARAM_TOL and d_cpu <= PIPE_PARAM_TOL):
                fail(f"pipeline: mha {schedule} losses {losses} vs unsplit "
                     f"{ref} (rel {rel:.3e}) and CPU {cpu_losses} (rel "
                     f"{rel_cpu:.3e}), tol {TRAIN_LOSS_RTOL:g}; params max "
                     f"|diff| {d_ref:.3e} vs unsplit, {d_cpu:.3e} vs CPU, "
                     f"tol {PIPE_PARAM_TOL:g}")
            out["samples_per_s"][f"mha_{schedule}"] = sps
            print(f"pipeline: mha_classifier B={spec['batch']} "
                  f"M={spec['micro']} {schedule}, stages {coord.partitions}: "
                  f"epoch losses {losses} (unsplit {ref}, rel {rel:.3e}; "
                  f"CPU pipeline {cpu_losses}, rel {rel_cpu:.3e}); params "
                  f"max |diff| {d_ref:.3e} vs unsplit, {d_cpu:.3e} vs CPU; "
                  f"launches {counts} (the warm-up epoch, then the other "
                  f"batches); {rate_text(sps)} on {card}", flush=True)
        out["load_reports"]["mha"] = load_reports(coord, batches[0])

        # resnet18_tiny_imagenet
        spec = PIPE_CNN
        cfg = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
        params, state = jax_layout(cfg, np.random.default_rng(SEED + 17))
        rng = np.random.default_rng(SEED + 18)
        n = spec["batch"] * PIPE_BATCHES
        x = rng.normal(size=(n, 3, 64, 64)).astype(np.float32)
        y = np.eye(200, dtype=np.float32)[rng.integers(0, 200, n)]
        batches = pipe_batches(x, y, spec["batch"])
        ref_losses, ref_named, sps = unsplit_run(
            from_jax(cfg, params, state, device="cuda"), batches,
            spec["micro"], PIPE_LR)
        out["samples_per_s"]["resnet18_unsplit"] = sps
        ref = epoch_means(ref_losses, batches)
        for schedule in PIPE_ENGINES:
            losses, named, sps, counts, coord = pipeline_run(
                from_jax(cfg, params, state, device="cuda"), batches, spec,
                schedule, "cuda")
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            d_ref = max_named_diff(named, ref_named)
            if not (all(math.isfinite(v) for v in losses)
                    and rel <= TRAIN_LOSS_RTOL and d_ref <= PIPE_PARAM_TOL):
                fail(f"pipeline: resnet18 {schedule} losses {losses} vs "
                     f"unsplit {ref} (rel {rel:.3e}, tol "
                     f"{TRAIN_LOSS_RTOL:g}); params and BN statistics max "
                     f"|diff| {d_ref:.3e} (tol {PIPE_PARAM_TOL:g})")
            out["samples_per_s"][f"resnet18_{schedule}"] = sps
            print(f"pipeline: resnet18_tiny_imagenet B={spec['batch']} "
                  f"M={spec['micro']} {schedule}, stages {coord.partitions}: "
                  f"epoch losses {losses} (unsplit {ref}, rel {rel:.3e}); "
                  f"params and BN statistics max |diff| {d_ref:.3e} vs "
                  f"unsplit (cuDNN deterministic); {rate_text(sps)} on "
                  f"{card}", flush=True)
        out["load_reports"]["resnet18"] = load_reports(coord, batches[0])
        out["resnet18"] = dict(cfg=cfg, params=params, state=state,
                               batches=batches)
        print(f"pipeline: load reports (track_load=True, ms per call) "
              f"{json.dumps(out['load_reports'])}; samples/s "
              f"{json.dumps(out['samples_per_s'])} on {card}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def compiled_run(model, batches, spec, schedule, wire, jit):
    """``HeteroCompiledPipeline`` (FLOP-balanced) steps over ``batches``
    (SGD): per-step losses, final params and buffers, peak device bytes
    of the first step above what was allocated before it, the step, and,
    where ``jit``, the :func:`window_rates` of windows of ``PIPE_TIMED``
    more replayed steps on the last batch after them (the first step ran
    eagerly, the second captured; None without ``jit``)."""
    import torch

    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (
        FlopBalancedPartitioner, HeteroCompiledPipeline,
    )

    pipe = HeteroCompiledPipeline(model, spec["stages"], spec["micro"],
                                  device="cuda",
                                  partitioner=FlopBalancedPartitioner(),
                                  wire_dtype=wire)
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    opt = SGD(PIPE_LR)
    ost = opt.init(params)
    make = (pipe.make_train_step if schedule == "gpipe"
            else pipe.make_train_step_1f1b)
    step = make(get_loss("softmax_crossentropy"), opt, jit=jit)
    m = spec["micro"]

    def mb(x, y):
        return (torch.from_numpy(x.reshape(m, -1, *x.shape[1:])).cuda(),
                torch.from_numpy(y.reshape(m, -1, y.shape[-1])).cuda())

    losses, peak = [], None
    for i, (x, y) in enumerate(batches):
        xs, ys = mb(x, y)
        if i == 0:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        params, ost, state, loss, _ = step(params, ost, state, xs, ys, SEED,
                                           PIPE_LR)
        losses.append(float(loss))
        if i == 0:
            peak = torch.cuda.max_memory_allocated() - base
    named = named_host(model)
    if not jit:
        return losses, named, peak, step, None

    def window():
        for _ in range(PIPE_TIMED):
            float(step(params, ost, state, xs, ys, SEED, PIPE_LR)[3])

    return (losses, named, peak, step,
            window_rates(window, PIPE_TIMED * len(batches[0][0])))


def phase_compiled_pipeline(card, resnet):
    """The compiled pipeline on the card: ``HeteroCompiledPipeline`` over
    full-width ``resnet18_tiny_imagenet`` (NCHW, S=4 FLOP-balanced, M=8,
    B=128, SGD), GPipe and 1F1B, fp32 and bf16 wire, each step one CUDA
    graph (the first step eager, the second captured); and one
    homogeneous ``SequentialStageStack`` (GroupNorm residual blocks).
    Gates, cuDNN deterministic: every replayed run bit for bit its eager
    twin (losses, params, BN statistics); fp32 losses, params and BN
    statistics within 2e-5 of the host-driven sync coordinator over the
    same batches; 1F1B's peak device memory in the eager step below
    GPipe's. Prints samples/s (replayed, the loss read each step), peak
    bytes and graph pool bytes with the card's name and power limit."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.nn import (
        Conv2DLayer, GroupNormLayer, ResidualBlock,
    )
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (
        SequentialStageStack, make_compiled_pipeline_train_step,
    )

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    spec = PIPE_CNN
    cfg, params, state = resnet["cfg"], resnet["params"], resnet["state"]
    batches = resnet["batches"][:3]
    out = {"samples_per_s": {}, "peak_bytes": {}, "pool_bytes": {}}
    try:
        host, host_named, _, _, coord = pipeline_run(
            from_jax(cfg, params, state, device="cuda"), batches, spec,
            "sync", "cuda")
        for schedule in ("gpipe", "1f1b"):
            for wire in (torch.float32, torch.bfloat16):
                tag = f"{schedule}_{str(wire).split('.')[-1]}"
                g_losses, g_named, _, g_step, sps = compiled_run(
                    from_jax(cfg, params, state, device="cuda"), batches,
                    spec, schedule, wire, True)
                e_losses, e_named, peak, _, _ = compiled_run(
                    from_jax(cfg, params, state, device="cuda"), batches,
                    spec, schedule, wire, False)
                if g_step.session() is None:
                    fail(f"compiled pipeline: {tag} captured no graph")
                if g_losses != e_losses or max_named_diff(g_named,
                                                          e_named) != 0.0:
                    fail(f"compiled pipeline: {tag} replays differ from the "
                         f"eager twin: losses {g_losses} vs {e_losses}, "
                         f"max |diff| {max_named_diff(g_named, e_named):.3e}")
                line = (f"compiled pipeline: resnet18_tiny_imagenet {tag} "
                        f"S={spec['stages']} M={spec['micro']} "
                        f"B={spec['batch']}: 3 steps (eager, captured, "
                        f"replayed) bit-equal to the eager twin, losses "
                        f"{g_losses}; peak {peak} B above the params in the "
                        f"eager step; graph pool "
                        f"{g_step.compiled.pool.bytes()} B; "
                        f"peak stash {g_step.peak_stash}")
                if wire is torch.float32:
                    # the host-driven run's epochs: the first batch, then
                    # the mean of the other two
                    mine = [g_losses[0], sum(g_losses[1:]) / 2]
                    d_loss = max(abs(a - b) for a, b in zip(mine, host))
                    # assert_allclose(atol=rtol=COMPILED_TOL): the worst
                    # |diff| - rtol * |want| must be <= atol
                    over = max(float((np.abs(g_named[n] - host_named[n])
                                      - COMPILED_TOL
                                      * np.abs(host_named[n])).max())
                               for n in host_named)
                    worst = max_named_diff(g_named, host_named)
                    if d_loss > COMPILED_TOL or over > COMPILED_TOL:
                        fail(f"compiled pipeline: {tag} vs the host-driven "
                             f"sync schedule: losses {mine} vs {host} "
                             f"(|diff| {d_loss:.3e}), params and BN "
                             f"statistics max |diff| {worst:.3e} (atol and "
                             f"rtol {COMPILED_TOL:g})")
                    out["peak_bytes"][schedule] = peak
                    line += (f"; vs the host-driven sync schedule: losses "
                             f"|diff| {d_loss:.3e}, params and BN "
                             f"statistics max |diff| {worst:.3e} (atol and "
                             f"rtol {COMPILED_TOL:g})")
                out["samples_per_s"][tag] = sps
                out["pool_bytes"][tag] = g_step.compiled.pool.bytes()
                print(f"{line}; {rate_text(sps)} replayed on {card}",
                      flush=True)
        if not out["peak_bytes"]["1f1b"] < out["peak_bytes"]["gpipe"]:
            fail(f"compiled pipeline: 1F1B's peak {out['peak_bytes']} is not "
                 f"below GPipe's")

        # the homogeneous stack: GroupNorm residual blocks, shape-preserving
        def stack_run(jit):
            block = ResidualBlock(
                layers=[Conv2DLayer(64, 3, 1, 1), GroupNormLayer(8)],
                activation="relu")
            stack = SequentialStageStack(block, 4, (64, 16, 16))
            sp = stack.init(torch.Generator().manual_seed(SEED),
                            device="cuda")
            opt = SGD(PIPE_LR)
            ost = opt.init(sp)
            step = make_compiled_pipeline_train_step(
                stack.stage_fn, lambda a, b: ((a - b) ** 2).mean(), opt, 4,
                8, jit=jit)
            rng = np.random.default_rng(SEED + 19)
            xs = torch.from_numpy(rng.normal(size=(8, 16, 64, 16, 16))
                                  .astype(np.float32)).cuda()
            ys = torch.from_numpy(rng.normal(size=(8, 16, 64, 16, 16))
                                  .astype(np.float32)).cuda()
            losses = [float(step(sp, ost, xs, ys, PIPE_LR)[2])
                      for _ in range(3)]
            return losses, {n: t.detach().cpu().numpy()
                            for n, t in sp.items()}

        (gl, gp), (el, ep) = stack_run(True), stack_run(False)
        if gl != el or any(not np.array_equal(gp[n], ep[n]) for n in gp):
            fail(f"compiled pipeline: the homogeneous stack's replays differ "
                 f"from its eager twin: {gl} vs {el}")
        print(f"compiled pipeline: SequentialStageStack (4 GroupNorm residual "
              f"blocks, 64x16x16, M=8, mb=16, remat) 3 steps bit-equal to the "
              f"eager twin, losses {gl}; peak bytes {out['peak_bytes']}; "
              f"samples/s {json.dumps(out['samples_per_s'])} on {card}",
              flush=True)
    finally:
        torch.backends.cudnn.deterministic = det
    return out


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


def int8_row(serve_int8, obs_launches, export_launches):
    """Row 8, conv_int8.cu: its fused mode (B, the one the int8 serving
    path launches; with its K-split reduces) with launches on that path
    and times summed over the 21 conv sites of resnet18_tiny_imagenet at
    B=32 (and, under "b256", at B=256), each site timed on its own; mode A
    (int8 -> int32, 0 launches on the served path) under "mode_a"; the
    unfused chain under "chain_ms"; no library call computes either
    function. ``obs_launches``: the obs phase's telemetry-served path;
    ``export_launches``: the export phase's artifact-served path."""
    def total(sites):
        out = {k: sum(c[k] for c in sites)
               for k in ("ms", "plain_ms", "bound_ms", "chain_ms")}
        out["bound_by"] = max(sites, key=lambda c: c["bound_ms"])["bound_by"]
        out["mode_a"] = {k: sum(c["mode_a"][k] for c in sites)
                         for k in ("ms", "plain_ms", "bound_ms")}
        out["mode_a"]["bound_by"] = max(
            sites, key=lambda c: c["mode_a"]["bound_ms"])["mode_a"]["bound_by"]
        return out

    cases = (serve_int8["sites_b32"] + serve_int8["sites_b256"]
             + serve_int8["held"] + serve_int8["ragged"])
    counts = serve_int8["launches"]
    b32 = total(serve_int8["sites_b32"])
    mode_a = b32.pop("mode_a")
    return {"name": "conv_int8_fused", "route": "cuda",
            "source": "dcnn_tpu_torch/ops/csrc/conv_int8.cu",
            "replaces": "dcnn_tpu/ops/conv.py:77", "launches":
            counts["conv_int8_fused"] + obs_launches + export_launches,
            "launches_by_path": {"serve_int8": counts["conv_int8_fused"],
                                 "obs": obs_launches,
                                 "export": export_launches},
            "splitk_reduce_launches": counts["conv_int8_reduce"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **b32, "library_ms": None,
            "mode_a": {"name": "conv_int8", "launches": counts["conv_int8"],
                       **mode_a, "library_ms": None},
            "b256": total(serve_int8["sites_b256"]), "cases": cases}


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
    from dcnn_tpu_torch import native

    t0 = time.perf_counter()
    # the host helpers (g++) build in a thread beside the kernels (nvcc)
    helpers = threading.Thread(target=native.lib, name="native-build")
    helpers.start()
    _kernels.build(verbose=True)
    helpers.join()
    if not native.available():
        fail("the native host helpers did not build with g++ "
             f"({native.lib_path()})")
    print(f"build: {sorted(_kernels.SOURCES)} and {native.lib_path().name} "
          f"(native helpers: C++) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    seconds = {"build": round(time.perf_counter() - t0, 1)}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    fwd_cases = timed("flash", phase_kernels)
    bwd_cases = timed("flash backward", phase_bwd_kernels)
    wide = timed("wide layer", phase_wide_layer)
    conv_cases = timed("conv", phase_conv_kernels)
    site_counts, site_worst, site_cases = timed("model sites",
                                                phase_model_sites, card)
    serve = timed("serve", phase_serve, card)
    train = timed("train", phase_train, card)
    serve_cnn = timed("serve cnn", phase_serve_cnn, card)
    timed("train cnn", phase_train_cnn, card)
    timed("checkpoint", phase_checkpoint, card)
    feed = timed("train feed", phase_train_feed, card)
    serve_int8 = timed("serve int8", phase_serve_int8, card)
    timed("decode", phase_decode, card)
    obs = timed("obs", phase_obs, card, feed["traced_resident"])
    export = timed("export", phase_export, card)
    pipe = timed("pipeline", phase_pipeline, card)
    compiled = timed("compiled pipeline", phase_compiled_pipeline, card,
                     pipe.pop("resnet18"))
    print(f"phase seconds: {json.dumps(seconds)}, total "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)

    def row(name, source, replaces, cases, by_path):
        model_case = cases[0]  # the model's shape: B=32, H=4, S=32, D=16
        long = next(c for c in cases if c["case"] == "long context")
        d256 = next(c for c in cases if c["case"] == "d256 long context")
        d512 = next(c for c in cases if c["case"] == "d512 long context")
        d256f = next(c for c in cases if c["case"] == "d256 fp32 long context")
        keys = ("kernel", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "kernels": sorted({c["kernel"] for c in cases}),
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": model_case["ms"], "plain_ms": model_case["plain_ms"],
                "bound_ms": model_case["bound_ms"],
                "bound_by": model_case["bound_by"],
                "library_ms": model_case["library_ms"],
                "long_context": {k: long[k] for k in keys},
                "d256_long_context": {k: d256[k] for k in keys},
                "d512_long_context": {k: d512[k] for k in keys},
                "d256_fp32_long_context": {k: d256f[k] for k in keys},
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

    tl, fl = train["launches"], feed["launches"]
    pl = {k: sum(run[k] for run in pipe["launches"].values())
          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tc_src = "dcnn_tpu_torch/ops/csrc/conv3x3_tc.cu"
    kernels = [
        row("flash_fwd", "dcnn_tpu_torch/ops/csrc/flash_fwd.cu",
            "dcnn_tpu/ops/attention.py:297", fwd_cases,
            {"serve": serve["launches"], "train": tl["flash_fwd"],
             "train_feed": fl["flash_fwd"],
             "serve_int8": serve_int8["mha"]["launches"]["flash_fwd"],
             "wide_layer": wide["flash_fwd"], "obs": obs["flash_fwd"],
             "export": export["mha_classifier"]["launches"]["flash_fwd"],
             "pipeline": pl["flash_fwd"]}),
        row("flash_bwd_dq", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:460", bwd_cases["dq"],
            {"serve": 0, "train": tl["flash_bwd_dq"],
             "train_feed": fl["flash_bwd_dq"],
             "wide_layer": wide["flash_bwd_dq"], "obs": obs["flash_bwd_dq"],
             "pipeline": pl["flash_bwd_dq"]}),
        row("flash_bwd_dkv", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:478", bwd_cases["dkv"],
            {"serve": 0, "train": tl["flash_bwd_dkv"],
             "train_feed": fl["flash_bwd_dkv"],
             "wide_layer": wide["flash_bwd_dkv"],
             "obs": obs["flash_bwd_dkv"], "pipeline": pl["flash_bwd_dkv"]}),
        site_row("conv3x3_s1", tc_src, "dcnn_tpu/ops/pallas/conv.py:82"),
        site_row("conv3x3_s1_pairs", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:173"),
        site_row("conv3x3_s1_bnrelu_in", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:209"),
        site_row("fused_scale_bias_relu", "dcnn_tpu_torch/ops/csrc/fused.cu",
                 "dcnn_tpu/ops/pallas/fused.py:49"),
        int8_row(serve_int8, obs["conv_int8_fused"],
                 export["resnet18"]["launches"]["conv_int8_fused"]),
    ]
    print(json.dumps({"pipeline": {
        "launches": pipe["launches"], "samples_per_s": {
            **pipe["samples_per_s"],
            **{f"resnet18_compiled_{k}": v
               for k, v in compiled["samples_per_s"].items()}},
        "load_reports": pipe["load_reports"],
        "peak_bytes": compiled["peak_bytes"],
        "pool_bytes": compiled["pool_bytes"]}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
