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
   ``SequentialStageStack``;
18. tcp pipeline (``phase_tcp_pipeline``): the same ``mha_classifier`` over
   2 stage-worker processes (``python -m dcnn_tpu_torch.parallel.worker``
   on the card, each its own CUDA context, loading the kernels built here)
   under the sync (shuffle-lz4 frames) and semi-async (raw) schedules, and
   the ResNet-18 over 4, through ``DistributedPipelineCoordinator``, held
   to phase 16's in-process runs (losses, params, BN statistics); the
   workers' shutdown lines count the flash kernels in their processes; a
   worker SIGKILLed between two batches and respawned on its port, the run
   recovering from its checkpoint with no batch lost, its params within
   rtol 2e-4 / atol 2e-5 of the uninterrupted run. The pipeline phases'
   launches, samples/s, load reports, memory and the TCP runs' rates,
   wire bytes a batch, worker start seconds and recovery print as
   ``{"pipeline": {...}}`` (``tcp_*`` keys) on a line before the kernels
   line;
19. router (``phase_router``): int8 ``resnet18_tiny_imagenet`` committed
   by ``CheckpointManager`` as v1..v4 and loaded by one ``EngineFactory``
   into 2 ``LocalReplica``s behind a ``Router``, under open-loop traffic
   (singles and batches of 2-8, 20% high, 60% normal, 20% low): a replica
   killed mid-load, restarted and rejoined; v2 canaried by
   ``ModelVersionManager`` and promoted; v3's canary armed with an
   injected fault, rolled back and quarantined; a torn v4 skipped. Every
   admitted request resolves, every result bit for bit one version's
   reference engine, sheds typed (low first), ``conv_int8_fused`` 21 a
   replayed batch, each retired engine's graph pool at 0 B;
20. router tcp (``phase_router_tcp``): ``mha_classifier`` behind 2
   ``ReplicaServer`` processes (``python chip_smoke.py --replica-server``,
   each its own CUDA context) and their ``TcpReplica``s: one SIGKILLed
   mid-load (seen through the connection's close; detection and recovery
   seconds), a remote swap to v2 on the survivor; every result within
   ``SERVE_TOL`` of one version's CPU reference, the survivor's flash
   forward counted in its shutdown line. Both phases print ``{"router":
   ..., "router_tcp": ...}`` on a line before the kernels line;
21. data parallel (``phase_data_parallel``, ``phase_elastic``): full-width
   ``resnet18_tiny_imagenet`` (NCHW, B=32, AdamW, cuDNN deterministic):
   (a) ``make_data_parallel_train_step`` in a world of 1 over NCCL in this
   process, eager and replayed (the NCCL all-reduces inside the CUDA
   graph), each bit for bit ``make_train_step`` over 4 steps, and the
   replayed step timed; (b) a world of 2 over gloo in two peer processes on
   the card (``python chip_smoke.py --elastic-peer RANK ...``; global-batch
   BN across them, the collectives staged through the host), held to the
   single-process step: the first step's loss and gradients in fp64
   (``DP_F64_TOL``, the check of the numbers), the fp32 losses, params and
   BN statistics (sanity bounds, ``DP_*``);
22. elastic (``phase_elastic``): the same two processes each run
   ``Trainer.fit`` with ``TrainingConfig(elastic=True, elastic_peers=...,
   elastic_rank=...)`` on 256 uint8 rows, global batch 64, K=4,
   checkpoints every 2 steps, 2 epochs; peer 1 is SIGKILLed after step 5:
   the survivor reconfigures once to world 1, every step's global batch
   is 64 rows, worlds {1, 2}, step 8 reached, each step's loss held to a
   solo (world 1, K=4) run here (params and BN statistics to sanity
   bounds). Before that run the two train 4 steps in fp64 with SGD, peer
   1 crashing after step 3 and the survivor restoring step 2's checkpoint,
   held to the elastic semantics computed by hand here at world 2 and
   then 1 (``ELASTIC_F64_TOL``: param changes, averaged BN statistics,
   losses); prints the step
   walls at world 2 and 1, the exchange's seconds a step (copy out, TCP,
   the leader's sum, copy in) and bytes, detection and reconfiguration
   seconds, samples/s;
23. elastic mha (``phase_elastic_mha``): a 2-peer fleet of
   ``mha_classifier`` as threads of this process, uninterrupted and with
   the leader crashed at a heartbeat; the survivor within the JAX test's
   ``RTOL, ATOL`` of the uninterrupted run, the flash kernels counted in
   every peer's replayed grad steps. The three print ``{"data_parallel":
   ...}`` on a line before the kernels line;
24. sequence parallel (a) (``phase_sequence``): ring (causal and not),
   zigzag and Ulysses (causal and not) over a ``"seq"`` axis of one NCCL
   rank in this process at B4 H8 S4096 D64, forward and backward, held to
   ``flash_attention`` on the whole sequence in bf16 and to the kernels'
   plain versions in fp32 (``SEQ_TOL``); each call's flash launches equal
   the schedule's live block pairs (ring 1, zigzag 3, Ulysses 1, of the
   forward, dQ and dK/dV each); fwd+bwd walls;
26 (a), 27. dp feed (``phase_dp_feed``), world 1 over NCCL: the DP
   resident epoch (``make_resident_epoch_dp``) on phase 21's ResNet-18
   setup bit for bit the single-device resident epoch given one order,
   replayed; ``Trainer.fit`` over a ``ShardedDeviceDataset``;
   ``PrefetchLoader(sharding=mesh)`` bit for bit ``shard_batch``'s; the
   compiled pipeline's ``data_axis="data"`` step (4 GroupNorm residual
   blocks at 64x32x32, M=8, B=32), eager and replayed with the all-reduce
   in the graph, bit for bit the step without a data axis;
25, 26 (b). sequence peers (``phase_seq_peers``; two processes ``python
   chip_smoke.py --seq-peer RANK ...`` over gloo, started before phase 24
   and set going after phase 27): the sequence paths at world 2 in bf16
   and fp32 (``SEQ_TOL``), each rank held to its slice of the whole
   sequence's run, its launches
   a call ring r+1 causal and 2 not, zigzag 5, Ulysses 1, with fwd+bwd
   walls and the bytes staged through the host; then ``Trainer.fit`` over
   a ``ShardedDeviceDataset`` (one epoch), the ranks' params bit for bit
   equal, and one fp64 SGD step of the DP epoch within ``DPR_F64_TOL`` of
   the per-shard gradients averaged by hand. Phases 24-27 print
   ``{"sequence": ...}`` on a line before the kernels line.
28. spatial (``phase_spatial``, ``spatial_world2`` in the sequence peers,
   ``check_spatial_world2``): ``make_data_parallel_train_step(
   spatial_axis="sp")`` on phase 21's full-width ResNet-18 setup. (a) A
   (data 1, sp 1) mesh over NCCL here: eager and replayed (one graph) bit
   for bit the mesh step without ``spatial_axis``. (b) A (data 1, sp 2)
   mesh over gloo in the two peers (H 64 -> 32 rows a rank, halos
   exchanged at every 3x3 conv): the ranks bit-equal, the fp64 step's
   loss, gradients and BN statistics within ``SP_F64_TOL`` of one
   process's, the fp32 steps at the data-parallel sanity bounds; step
   wall, halo and staged bytes a step and each rank's peak memory beside
   one process's.
29. telemetry (``phase_telemetry``): ``Trainer.fit`` of full-width
   ResNet-18 over ``PrefetchLoader(feed_workers=2)`` with
   ``metrics_port=0``: ``/metrics``, ``/healthz``, ``/snapshot`` and
   ``/goodput`` scraped mid-fit, the goodput buckets summing to the
   window's wall; a pause of the loader brings the verdict to healthy,
   then ``feed.slow_worker`` armed for the last epoch flips it to
   feed-bound with exactly one flight bundle and one profiler capture;
   samples/s with the plane on and off. Phases 28-29 print under
   ``{"data_parallel": {"spatial": ..., "telemetry": ...}}``.
30-32. fleet, autoscale and lease (``phase_fleet``, ``phase_autoscale``,
   ``phase_lease``; see their docstrings), under ``{"fleet_plane": ...}``.
33. examples (``phase_examples``): the example drivers of
   ``dcnn_tpu_torch/examples`` as a user starts them: the long-context
   trainer at its defaults (flash kernels, fresh-data accuracy >= 0.9),
   the committed snapshot evaluated (unfolded, folded, int8, each within
   a sample of the CPU's) and served int8 (``conv_int8_fused`` launched,
   each site bit for bit its plain version), digits28 trained to its 0.99
   gate, the other drivers in processes of their own; under
   ``{"examples": ...}``.
34. analysis (``phase_analysis``): the port's static-analysis suite
   (``dcnn_tpu_torch.analysis``) names TS01, TS03 and TS05 in a capture
   fixture and nothing in its clean functions, and ``core.graphs.Session``
   shows each claim on the card: ``CaptureError`` for the host read, a
   ``print`` and an ``append`` run once at capture and never at a replay,
   ``count_host`` counts every replay, the clean function replays bit for
   bit; under ``{"analysis": ...}``.
35. regress (``phase_regress``): the port's bench regression gate
   (``python3 -m dcnn_tpu_torch.obs.regress``) as a user runs it, each in
   a process of its own: ``--self-test`` exits 0 and prints ``self-test:
   PASS``, and a planted history of ``BENCH_TORCH_rNN.json`` captures (the
   last 25% below the window's best img/s) exits 1 with ``img_per_sec``
   flagged; under ``{"regress": ...}``, with the exit codes and seconds.

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
``"export"``, the pipeline phase's under ``"pipeline"``, the TCP
workers' under ``"tcp_pipeline"``, the router phase's replicas' under
``"router"``, the router tcp phase's surviving replica server's under
``"router_tcp"``, the elastic mha phase's under ``"elastic_mha"`` and
the sequence paths' (both worlds) under ``"sequence"`` where they launch
the row) on
a line of its own and, last,
``{"ok": true, "device": {...}}``. Times come from CUDA events around CUDA
graph replays of many calls, so host overhead is not in them.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
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
    # the long-context example driver's attention (phase 33)
    ("examples long context", 32, 2, 2048, 2048, 64, True, "float32", 3),
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


def window_rates(run, samples: int, windows: int = PIPE_WINDOWS) -> dict:
    """samples/s of ``run()`` (one window of ``samples`` samples, ending in
    a host read) over ``windows`` windows on the card: the median, the
    slowest and fastest window, and the spread, (max - min) / median.
    Two engines' rates differ by more than noise only where the gap
    exceeds both spreads."""
    import torch

    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        rates.append(samples / (time.perf_counter() - t0))
    rates.sort()
    med = rates[len(rates) // 2]
    return {"median": med, "min": rates[0], "max": rates[-1],
            "spread": (rates[-1] - rates[0]) / med, "windows": windows}


def rate_text(r: dict) -> str:
    return (f"{r['median']:.1f} samples/s (median of {r['windows']} "
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
    # what phase_tcp_pipeline is held to
    refs = out["tcp_refs"] = {"rates": out["samples_per_s"]}
    try:
        # mha_classifier
        cfg, params, rng = model_params()
        spec = PIPE_MHA
        x, y = marker_task(rng, n=spec["batch"] * PIPE_BATCHES)
        batches = pipe_batches(x, y, spec["batch"])
        refs["mha"] = (cfg, params, batches)
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
            refs[f"mha_{schedule}"] = (losses, named)
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
            refs[f"resnet18_{schedule}"] = (losses, named)
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


# the TCP pipeline: stage workers as processes on the card
TCP_CODECS = {"sync": "shuffle-lz4", "semi_async": "raw"}
TCP_WINDOWS = 3           # timed windows of PIPE_HOST_TIMED batches a run
TCP_HEARTBEAT_S = 1.0
TCP_RECOVERY_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pipeline_recovery.py
TCP_KILL_AFTER = 3        # batches trained before the SIGKILL
TCP_CKPT_EVERY = 2


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class ChildProcess:
    """A child process on the card (``python ARGV...``, from the root of
    the repo), its stdout read line by line by a thread: each line that
    parses as a JSON object is kept, with the seconds from spawn at which
    it came. ``what`` names it in a failure, beside its last lines."""

    def __init__(self, what, argv, stdin=False):
        self.what = what
        self.lines, self.json, self.at = [], [], []
        self.new = threading.Condition()
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT,
            stdin=subprocess.PIPE if stdin else None,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            line = line.rstrip()
            obj = None
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                except ValueError:
                    pass  # a log line, not one of the child's results
            with self.new:
                self.lines.append(line)
                if isinstance(obj, dict):
                    self.json.append(obj)
                    self.at.append(time.perf_counter() - self._t0)
                self.new.notify_all()
        with self.new:
            self.new.notify_all()

    def _fail(self, why):
        fail(f"{self.what} {why} (exit code {self.proc.poll()}):\n"
             + "\n".join(self.lines[-40:]))

    def seconds_to(self, key):
        """Seconds from spawn to its first JSON line with ``key``, or None."""
        return next((t for t, j in zip(self.at, self.json) if key in j),
                    None)

    def _ended(self):
        return self.proc.poll() is not None and not self._reader.is_alive()

    def _first(self, key):
        with self.new:
            return next((j for j in self.json if key in j), None)

    def wait_for(self, key, timeout=300.0, partners=()) -> dict:
        """The first JSON line with ``key``; fails if the process ends or
        the time runs out first, or as soon as one of ``partners`` (peers
        of one world, which this one may be waiting on) ends without its
        own ``key`` line."""
        deadline = time.perf_counter() + timeout
        while True:
            for p in partners:
                if p is not self and p._ended() and p._first(key) is None:
                    p._fail(f"exited before its {key!r} line")
            with self.new:
                got = self._first(key)
                if got is not None:
                    return got
                left = deadline - time.perf_counter()
                if left <= 0 or self._ended():
                    break
                self.new.wait(min(left, 1.0))
        self._fail(f"printed no {key!r} line")

    def finish(self, key=None, timeout=120.0):
        """Its stdin closed (where it has one), the exit after it, which
        must be 0; then its last JSON line with ``key`` where one is
        named, which it must have printed."""
        if self.proc.stdin is not None:
            self.proc.stdin.close()
        rc = self.proc.wait(timeout=timeout)
        self._reader.join(timeout=10)
        if rc != 0:
            self._fail("exited non-zero")
        if key is not None:
            got = [j for j in self.json if key in j]
            if not got:
                self._fail(f"exited without its {key!r} line")
            return got[-1]

    def kill(self):
        self.proc.kill()
        self.proc.wait()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


class TcpWorker(ChildProcess):
    """One ``python -m dcnn_tpu_torch.parallel.worker`` process on the card
    (cuDNN deterministic): ``start_s`` is the time from spawn to its
    listening line, ``result()`` its shutdown line."""

    def __init__(self, port: int, codec: str):
        self.port = port
        self.addr = f"127.0.0.1:{port}"
        super().__init__(
            f"tcp pipeline: worker :{port}",
            ["-m", "dcnn_tpu_torch.parallel.worker", "--port", str(port),
             "--host", "127.0.0.1", "--compress", codec, "--deterministic"])

    @property
    def start_s(self):
        return self.seconds_to("listening")

    def result(self, timeout=60.0) -> dict:
        """The shutdown line, after the process exited 0."""
        return self.finish("shutdown", timeout)


def tcp_coordinator(model, workers, spec, codec, **kw):
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (
        DistributedPipelineCoordinator, FlopBalancedPartitioner,
        PipelineTimeouts,
    )

    coord = DistributedPipelineCoordinator(
        model, SGD(PIPE_LR), "softmax_crossentropy",
        [w.addr for w in workers], FlopBalancedPartitioner(), spec["micro"],
        track_load="sample", compress=codec, device="cuda",
        timeouts=PipelineTimeouts(batch_s=300.0, heartbeat_s=TCP_HEARTBEAT_S,
                                  connect_s=120.0, respawn_s=120.0), **kw)
    coord.deploy_stages()
    return coord


def wire_sent() -> int:
    from dcnn_tpu_torch.obs import get_registry

    return int(get_registry().counter("comm_bytes_sent_total").value)


def wire_received() -> int:
    from dcnn_tpu_torch.obs import get_registry

    return int(get_registry().counter("comm_bytes_received_total").value)


def tcp_run(model, workers, batches, spec, schedule, codec, ref):
    """``train_pipeline_epoch`` over ``batches`` (the first as an epoch of
    its own, as :func:`pipeline_run`) through a
    ``DistributedPipelineCoordinator`` over ``workers``, held to the
    in-process run ``ref`` (epoch losses, named params and buffers); then
    the load reports and :func:`window_rates` of ``TCP_WINDOWS`` windows of
    ``PIPE_HOST_TIMED`` batches; the workers shut down. Returns the
    record, the named params after the epochs and the number of batches
    each worker trained."""
    import numpy as np

    from dcnn_tpu_torch.parallel.pipeline import train_pipeline_epoch

    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()

    sent0 = wire_sent()
    coord = tcp_coordinator(model, workers, spec, codec)
    deploy = wire_sent() - sent0
    lap("deploy")
    losses = []
    for i, epoch in enumerate((batches[:1], batches[1:])):
        losses.append(train_pipeline_epoch(coord, epoch, PIPE_LR, rng=SEED,
                                           schedule=schedule)[0])
        lap(f"epoch{i}")
    received0 = wire_received()
    p, st = coord.gathered_params()
    gather = wire_received() - received0
    lap("gather")
    named = {n: t.double().numpy() for n, t in {**p, **st}.items()}
    ref_losses, ref_named = ref
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    d = max_named_diff(named, ref_named)
    sps = window_rates(
        lambda: train_pipeline_epoch(coord, batches[-1:] * PIPE_HOST_TIMED,
                                     PIPE_LR, rng=SEED, schedule=schedule),
        PIPE_HOST_TIMED * len(batches[0][0]), TCP_WINDOWS)
    lap("windows")
    reports = coord.collect_load_reports()
    partitions = coord.partitions
    coord_sent = wire_sent() - sent0
    coord.shutdown()
    lines = [w.result() for w in workers]
    lap("shutdown")
    n_batches = len(batches) + TCP_WINDOWS * PIPE_HOST_TIMED
    # every frame of every process but the weights' deploy and gather
    sent = coord_sent + sum(l["wire_bytes"]["sent"] for l in lines)
    per_batch = (sent - deploy - gather) / n_batches
    rec = {"losses": losses, "ref_losses": ref_losses, "rel": rel,
           "max_param_diff": d, "samples_per_s": sps,
           "wire_bytes_per_batch": per_batch, "load_reports": reports,
           "partitions": partitions, "codec": codec, "seconds": seconds,
           "workers": [{"launches": {k: v for k, v in l["launches"].items()
                                     if v},
                        "device": l["device"]} for l in lines]}
    if not (all(math.isfinite(v) for v in losses) and rel <= TRAIN_LOSS_RTOL
            and d <= PIPE_PARAM_TOL):
        fail(f"tcp pipeline: {schedule} ({codec}) losses {losses} vs the "
             f"in-process pipeline's {ref_losses} (rel {rel:.3e}, tol "
             f"{TRAIN_LOSS_RTOL:g}); params max |diff| {d:.3e} (tol "
             f"{PIPE_PARAM_TOL:g})")
    return rec, named, n_batches


def phase_tcp_pipeline(card, refs, resnet):
    """The TCP pipeline on the card: stage workers as processes of their own
    (``python -m dcnn_tpu_torch.parallel.worker --deterministic``), each
    with its CUDA context, loading the kernels this process built, and
    ``DistributedPipelineCoordinator`` here (cuDNN deterministic, as
    :func:`phase_pipeline`). (1) ``mha_classifier`` B=64 M=4 over 2
    workers (an attention block in each), sync over shuffle-lz4 frames and
    semi-async over raw ones; (2) ``resnet18_tiny_imagenet`` NCHW B=128 M=8
    over 4 workers, sync, raw; each over ``PIPE_BATCHES`` batches, held to
    the in-process pipeline's losses and params (BN statistics too) within
    ``TRAIN_LOSS_RTOL`` and ``PIPE_PARAM_TOL``; every mha worker's
    shutdown line must count the flash forward, dQ and dK/dV M times a
    batch it trained. (3) The sync mha run with ``checkpoint_dir``: one
    worker SIGKILLed between batches ``TCP_KILL_AFTER`` and
    ``TCP_KILL_AFTER + 1``, respawned on its port; the run must recover
    with no batch lost and end on the uninterrupted run's params within
    the JAX package's recovery tolerance. Prints samples/s beside the
    in-process rate, bytes on the wire a batch, load reports and worker
    start seconds, with the card's name and power limit."""
    import tempfile

    import numpy as np
    import torch

    from dcnn_tpu_torch.core.keys import fold_in
    from dcnn_tpu_torch.interop import from_jax

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg, params, batches = refs["mha"]
    spec = PIPE_MHA
    ports = iter(free_ports(10))
    fleets = {
        "mha_sync": [TcpWorker(next(ports), TCP_CODECS["sync"])
                     for _ in range(2)],
        "mha_semi_async": [TcpWorker(next(ports), TCP_CODECS["semi_async"])
                           for _ in range(2)],
        "resnet18_sync": [TcpWorker(next(ports), "raw") for _ in range(4)],
        "kill": [TcpWorker(next(ports), "raw") for _ in range(2)],
    }
    out = {"samples_per_s": {}, "wire_bytes_per_batch": {},
           "load_reports": {}, "launches": {}, "worker_start_s": {},
           "seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        out["seconds"][name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    try:
        mha_named = {}
        for schedule in PIPE_ENGINES:
            fleet = fleets[f"mha_{schedule}"]
            rec, named, n = tcp_run(
                from_jax(cfg, params, device="cuda"), fleet, batches, spec,
                schedule, TCP_CODECS[schedule], refs[f"mha_{schedule}"])
            mha_named[schedule] = named
            if rec["partitions"] != [(0, 1), (1, 4)]:
                fail(f"tcp pipeline: mha partitions {rec['partitions']}")
            want = {k: spec["micro"] * n
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            for i, w in enumerate(rec["workers"]):
                got = {k: w["launches"].get(k, 0) for k in want}
                if got != want:
                    fail(f"tcp pipeline: mha {schedule} worker {i} launched "
                         f"{w['launches']}, expected {want} ({n} batches)")
            out["launches"][f"mha_{schedule}"] = {
                k: sum(w["launches"].get(k, 0) for w in rec["workers"])
                for k in want}
            tag = f"mha_{schedule}"
            out["samples_per_s"][tag] = rec["samples_per_s"]
            out["wire_bytes_per_batch"][f"{tag}_{rec['codec']}"] = \
                rec["wire_bytes_per_batch"]
            out["load_reports"][tag] = rec["load_reports"]
            print(f"tcp pipeline: mha_classifier B={spec['batch']} "
                  f"M={spec['micro']} {schedule} over 2 worker processes "
                  f"({rec['codec']} frames), stages {rec['partitions']}: "
                  f"epoch losses {rec['losses']} (in-process "
                  f"{rec['ref_losses']}, rel {rec['rel']:.3e}); params max "
                  f"|diff| {rec['max_param_diff']:.3e} vs in-process; "
                  f"worker launches {[w['launches'] for w in rec['workers']]}"
                  f" over {n} batches; {rate_text(rec['samples_per_s'])} "
                  f"(in-process host-driven: "
                  f"{rate_text(refs['rates'][tag])}); "
                  f"{rec['wire_bytes_per_batch']:.0f} wire bytes a batch; "
                  f"seconds {rec['seconds']}; on {card}", flush=True)
            lap(tag)

        # resnet18_tiny_imagenet over 4 workers
        spec = PIPE_CNN
        rec, _, n = tcp_run(
            from_jax(resnet["cfg"], resnet["params"], resnet["state"],
                     device="cuda"),
            fleets["resnet18_sync"], resnet["batches"], spec, "sync", "raw",
            refs["resnet18_sync"])
        out["samples_per_s"]["resnet18_sync"] = rec["samples_per_s"]
        out["wire_bytes_per_batch"]["resnet18_sync_raw"] = \
            rec["wire_bytes_per_batch"]
        out["load_reports"]["resnet18_sync"] = rec["load_reports"]
        print(f"tcp pipeline: resnet18_tiny_imagenet B={spec['batch']} "
              f"M={spec['micro']} sync over 4 worker processes (raw frames), "
              f"stages {rec['partitions']}: epoch losses {rec['losses']} "
              f"(in-process {rec['ref_losses']}, rel {rec['rel']:.3e}); "
              f"params and BN statistics max |diff| "
              f"{rec['max_param_diff']:.3e} vs in-process; "
              f"{rate_text(rec['samples_per_s'])} (in-process host-driven: "
              f"{rate_text(refs['rates']['resnet18_sync'])}); "
              f"{rec['wire_bytes_per_batch']:.0f} wire bytes a batch; "
              f"seconds {rec['seconds']}; on {card}", flush=True)
        lap("resnet18_sync")

        # a real kill: SIGKILL stage 1 between two batches, respawn it
        spec = PIPE_MHA
        fleet = fleets["kill"]
        keys = [fold_in(SEED, 0)] + [fold_in(SEED, i)
                                     for i in range(len(batches) - 1)]
        with tempfile.TemporaryDirectory() as ck:
            coord = tcp_coordinator(from_jax(cfg, params, device="cuda"),
                                    fleet, spec, "raw", checkpoint_dir=ck,
                                    checkpoint_every=TCP_CKPT_EVERY)
            for i, (x, y) in enumerate(batches):
                if i == TCP_KILL_AFTER:
                    fleet[1].kill()
                    time.sleep(TCP_HEARTBEAT_S)
                    fleet[1] = TcpWorker(fleet[1].port, "raw")
                coord.train_batch_sync(x, y, PIPE_LR, keys[i])
            p, st = coord.gathered_params()
            stats = dict(coord.stats)
            coord.shutdown()
        named = {n: t.double().numpy() for n, t in {**p, **st}.items()}
        ref = mha_named["sync"]
        worst = max(float((np.abs(named[k] - ref[k])
                           - TCP_RECOVERY_TOL["rtol"] * np.abs(ref[k])).max())
                    for k in ref)
        diff = max_named_diff(named, ref)
        lines = [w.result() for w in fleet]
        out["launches"]["kill"] = {
            k: sum(l["launches"][k] for l in lines)
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        out["recovery"] = {k: stats[k] for k in (
            "recoveries", "respawns", "replayed_batches", "batches_lost",
            "detection_s", "recovery_s")}
        if (stats["recoveries"] != 1 or stats["batches_lost"] != 0
                or worst > TCP_RECOVERY_TOL["atol"]):
            fail(f"tcp pipeline: the killed run {out['recovery']}, params max "
                 f"|diff| {diff:.3e} vs the uninterrupted run (rtol "
                 f"{TCP_RECOVERY_TOL['rtol']:g}, atol "
                 f"{TCP_RECOVERY_TOL['atol']:g})")
        print(f"tcp pipeline: mha_classifier sync, worker of stage 1 "
              f"SIGKILLed after batch {TCP_KILL_AFTER} and respawned on its "
              f"port (checkpoint every {TCP_CKPT_EVERY} batches): "
              f"{json.dumps(out['recovery'])}; params max |diff| {diff:.3e} "
              f"vs the uninterrupted TCP run; on {card}", flush=True)
        lap("kill")
        out["worker_start_s"] = {k: [w.start_s for w in f]
                                 for k, f in fleets.items()}
        print(f"tcp pipeline: seconds {json.dumps(out['seconds'])} (each "
              f"run's from the last's end: its workers' start, deploy, "
              f"batches, gathers, shutdown); worker start seconds "
              f"{json.dumps(out['worker_start_s'])}; wire bytes a batch "
              f"{json.dumps(out['wire_bytes_per_batch'])}; load reports "
              f"(track_load='sample', ms a call) "
              f"{json.dumps(out['load_reports'])} on {card}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = det
        for f in fleets.values():
            for w in f:
                w.close()
    return out


# router phases: the serving tier in front of several replicas
ROUTER_RPS = 400.0          # offered requests/s, open loop, for as long as
#                             the phase's events take
ROUTER_POOL = 64            # distinct samples the requests draw rows from
ROUTER_QUEUE = 16           # rows a replica queues: low (0.6 of the fleet's
#                             32) sheds first when a replica is out
ROUTER_MIX = (("high", 0.2), ("normal", 0.6), ("low", 0.2))
ROUTER_OBSERVE_S = 1.0      # a canary's clean window before it promotes
ROUTER_MIN_CANARY = 20      # completions the canary needs to be judged
ROUTER_NOISE = 0.02         # std of the noise a new version adds to params


class OpenLoopMix:
    """Open-loop mixed traffic through ``Router.submit`` on a thread of its
    own: request k goes at k / ``rps`` seconds (late ones at once, never
    waiting on an answer), a single sample half the time, else a batch of
    2-8 rows, all drawn from ``pool``; its priority class drawn 20% high,
    60% normal, 20% low. ``rps`` may be a rate schedule, ``f(t) -> rps``
    over seconds since the start (``serve.traffic.diurnal``): the gap after
    an arrival at t is then 1 / f(t). A shed must be a
    ``RouterShedError``; anything else raised at submit is recorded and
    fails the phase. Each shed is also counted under its regime
    (:func:`shed_regime`) in ``shed_by``."""

    def __init__(self, router, pool, rps, seed):
        import numpy as np

        self.router, self.pool, self.rps = router, pool, rps
        self.rng = np.random.default_rng(seed)
        self.sent = []      # (row indices, single, priority, future)
        self.offered = {p: 0 for p, _ in ROUTER_MIX}
        self.shed = {p: 0 for p, _ in ROUTER_MIX}
        self.shed_by = {r: {p: 0 for p, _ in ROUTER_MIX}
                        for r in ("class", "fleet", "unknown")}
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="router-open-loop")

    def start(self) -> "OpenLoopMix":
        self._thread.start()
        return self

    def _run(self):
        from dcnn_tpu_torch.serve import RouterShedError

        names = [p for p, _ in ROUTER_MIX]
        probs = [w for _, w in ROUTER_MIX]
        t0, k, t_rel = time.perf_counter(), 0, 0.0
        while not self._stop.is_set():
            if callable(self.rps):
                wait = t0 + t_rel - time.perf_counter()
                t_rel += 1.0 / self.rps(t_rel)
            else:
                wait = t0 + k / self.rps - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            k += 1
            prio = names[self.rng.choice(3, p=probs)]
            single = bool(self.rng.random() < 0.5)
            n = 1 if single else int(self.rng.integers(2, 9))
            idx = self.rng.integers(0, len(self.pool), n)
            x = self.pool[idx[0]] if single else self.pool[idx]
            self.offered[prio] += 1
            try:
                fut = self.router.submit(x, priority=prio)
            except RouterShedError as e:
                self.shed[prio] += 1
                self.shed_by[shed_regime(e)][prio] += 1
                continue
            except Exception as e:  # noqa: BLE001 (recorded, fails the phase)
                self.errors.append(f"{type(e).__name__}: {e}")
                continue
            self.sent.append((idx, single, prio, fut))

    def stop(self):
        self._stop.set()
        self._thread.join()


def version_of(traffic, refs, what, exact, tol=0.0):
    """Hold every resolved request to the reference logits of exactly one
    version (``refs``: {version: logits of every pool row}): bit for bit
    when ``exact``, else within ``tol``; all of a request's rows the same
    version. Returns ({version: requests}, typed failures)."""
    import numpy as np

    served, failed = {v: 0 for v in refs}, 0
    for idx, single, prio, fut in traffic.sent:
        if not fut.done():
            fail(f"{what}: an admitted {prio} request never resolved")
        if fut.exception() is not None:
            failed += 1
            continue
        y = np.asarray(fut.result())
        rows = y[None] if single else y
        hits = [v for v, ref in refs.items() if rows.shape == ref[idx].shape
                and (np.array_equal(rows, ref[idx]) if exact
                     else float(np.abs(rows - ref[idx]).max()) <= tol)]
        if len(hits) != 1:
            errs = {v: float(np.abs(rows - ref[idx]).max())
                    for v, ref in refs.items()}
            fail(f"{what}: a {prio} request of {len(idx)} row(s) matches "
                 f"{len(hits)} versions' references (max |diff| by version "
                 f"{errs}, {'bit for bit' if exact else f'tol {tol:g}'})")
        served[hits[0]] += 1
    return served, failed


SHED_LIMIT = re.compile(r"outstanding (\d+) \+ (\d+) over class limit \S+ "
                        r"\(fleet capacity (\d+)\)")


def shed_regime(err) -> str:
    """The regime that shed a request, read from the router's message:
    ``"class"`` when the fleet had room for its rows (outstanding + rows
    within the whole capacity) and only its class's share refused them,
    the regime where the priorities tell the classes apart; ``"fleet"``
    when they fit at no priority (outstanding + rows over the capacity, as
    right after a replica's death takes its capacity away while its rows
    are readmitted, or every replica's own queue full), which sheds every
    class alike; ``"unknown"`` for a message of neither form."""
    msg = str(err)
    m = SHED_LIMIT.search(msg)
    if m:
        out, n, cap = map(int, m.groups())
        return "class" if out + n <= cap else "fleet"
    return "fleet" if "every routable replica shed" in msg else "unknown"


def shed_shares(traffic, what, regime=None):
    """Per class shed / offered; low's share must be at least normal's,
    normal's at least high's. With ``regime``, only the sheds of that
    regime (:func:`shed_regime`) count, and a shed of no known regime
    fails."""
    shed = traffic.shed if regime is None else traffic.shed_by[regime]
    share = {p: shed[p] / max(traffic.offered[p], 1) for p, _ in ROUTER_MIX}
    if traffic.errors:
        fail(f"{what}: submit raised other than RouterShedError: "
             f"{traffic.errors[:3]}")
    if regime is not None and any(traffic.shed_by["unknown"].values()):
        fail(f"{what}: sheds of no known regime {traffic.shed_by}")
    if not share["low"] >= share["normal"] >= share["high"]:
        fail(f"{what}: shed shares {share} are not low >= normal >= high")
    return share


def pool_blocks(pool):
    """(size, state) of every block in ``pool``'s segments."""
    import torch

    handle = tuple(pool.handle)
    return [(b["size"], b["state"]) for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == handle
            for b in s["blocks"]]


def counting_replica_class():
    """``LocalReplica`` counting the bucket warm-ups of every batcher it
    makes (each warms every bucket on its dispatcher: one replay each),
    for the launch gates."""
    from dcnn_tpu_torch.serve import LocalReplica

    class CountingReplica(LocalReplica):
        warmups = 0

        def _make_batcher(self, engine):
            b = super()._make_batcher(engine)
            self.warmups += len(b.warmup_s)
            return b

    return CountingReplica


def perturbed(model, rng):
    """A copy of ``model`` with N(0, ROUTER_NOISE) added to every param:
    the next checkpoint version, visibly another model."""
    import copy

    import torch

    out = copy.deepcopy(model)
    with torch.no_grad():
        for p in out.parameters():
            p.add_(torch.from_numpy(rng.normal(
                0.0, ROUTER_NOISE, tuple(p.shape)).astype("float32")))
    return out


def commit_into(staging, root, step):
    """Publish ``staging``'s committed ``ckpt-<step>`` under ``root`` as a
    training run commits: written under a temporary name, then renamed."""
    import shutil

    name = f"ckpt-{step:08d}"
    tmp = os.path.join(root, f"tmp-{name}")
    shutil.copytree(os.path.join(staging, name), tmp)
    os.rename(tmp, os.path.join(root, name))
    return os.path.join(root, name)


def phase_router(card):
    """The router tier in process on the card: int8
    ``resnet18_tiny_imagenet`` (NHWC, BN folded, random weights and BN
    statistics from a seed in the JAX layout) committed by
    ``CheckpointManager`` as v1..v4 (each the last plus noise) and loaded
    by one ``EngineFactory`` (64-sample calibration batch, max_batch 32)
    into 2 ``LocalReplica``s behind a ``Router`` with its default shares,
    under open-loop mixed traffic (:class:`OpenLoopMix`). Events, in
    order: replica r1 killed mid-load, restarted and rejoined on a
    ``check_replicas`` sweep; ``ModelVersionManager(canary_fraction=0.5)``
    finds v2, canaries it on one replica, serves mixed versions and
    promotes it; v3's canary armed with an ``InjectedFault`` at
    ``serve.replica_infer`` rolls back and is quarantined; a torn v4 (one
    bit flipped) is skipped by ``newest_valid_version``. Gates: every
    admitted request resolves and the ledger ends empty; every result bit
    for bit the reference engine of exactly one version; every shed a
    ``RouterShedError`` with low's share >= normal's >= high's;
    ``conv_int8_fused`` 21 launches a replayed batch; the retired engine's
    graph pool at 0 B after each swap and ``memory_reserved`` over v1 ->
    v2 -> rollback within one engine's pool."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.resilience.checkpoint import (
        CheckpointManager, list_steps,
    )
    from dcnn_tpu_torch.resilience.faults import FaultPlan, InjectedFault
    from dcnn_tpu_torch.serve import (
        EngineFactory, ModelVersionManager, Router, newest_valid_version,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 30)
    cfg, _, _, v1 = resnet18("cpu", rng)
    models = {1: v1}
    for v in (2, 3, 4):
        models[v] = perturbed(models[v - 1], rng)
    calib = rng.normal(size=(INT8_CALIB, *cfg["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(ROUTER_POOL, *cfg["input_shape"])).astype(
        np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_router_", dir=ROOT)
    staging, root = os.path.join(tmp.name, "staging"), os.path.join(
        tmp.name, "serve")
    os.makedirs(root)
    mgr = CheckpointManager(staging, keep=10)
    for v, m in models.items():
        mgr.save(v, m)
    mgr.close()
    reg = MetricsRegistry()

    class CountingFactory(EngineFactory):
        built = 0

        def __call__(self, version):
            eng = super().__call__(version)
            self.built += 1
            return eng

    # the reference: one engine a version, from the very same commits
    refs = {}
    ref_factory = EngineFactory(staging, max_batch=32, int8_calib=calib,
                                device="cuda")
    for v in (1, 2, 3):
        eng = ref_factory(v)
        refs[v] = torch.cat([eng.infer(pool[i:i + 32]) for i in
                             range(0, ROUTER_POOL, 32)]).cpu().numpy()
        eng._release()
        del eng
    if any(np.array_equal(refs[a], refs[b]) for a, b in ((1, 2), (2, 3))):
        fail("router: two versions' reference logits are equal")
    commit_into(staging, root, 1)
    out = {"swap_s": [], "pool_bytes_after_swap": []}
    torch.cuda.synchronize()
    reset_launches()  # the router path starts here
    factory = CountingFactory(root, max_batch=32, int8_calib=calib,
                              device="cuda", registry=reg)
    Replica = counting_replica_class()
    plans = {n: FaultPlan() for n in ("r0", "r1")}
    reps = [Replica(factory, 1, name=n, queue_capacity=ROUTER_QUEUE,
                    fault_plan=plans[n]) for n in ("r0", "r1")]
    router = Router(reps)
    pool_bytes = reps[0]._engine.graphs.bytes()
    reserved = {"v1": torch.cuda.memory_reserved()}
    mvm = ModelVersionManager(router, factory, canary_fraction=0.5,
                              observe_s=ROUTER_OBSERVE_S,
                              min_canary_requests=ROUTER_MIN_CANARY)
    traffic = OpenLoopMix(router, pool, ROUTER_RPS, SEED + 31).start()

    def poll(want, timeout=60.0, stop=("rolled_back", "swap_failed")):
        """Poll the manager until it answers ``want``; every engine a
        swap retired must have given its graph pool back."""
        t0 = time.perf_counter()
        while True:
            before = {r.name: r._engine for r in reps}
            pools = {n: e.graphs for n, e in before.items()}
            t = time.perf_counter()
            res = mvm.poll()
            dt = time.perf_counter() - t
            for r in reps:
                if r._engine is not before[r.name]:
                    out["swap_s"].append(round(dt, 3))
                    left = pools[r.name].bytes()
                    out["pool_bytes_after_swap"].append(left)
                    if left:
                        fail(f"router: {r.name}'s retired engine still "
                             f"holds {left} B of graph pool after a swap "
                             f"(blocks {pool_blocks(pools[r.name])})")
            del before
            if res["action"] == want:
                return res
            if res["action"] in stop or time.perf_counter() - t0 > timeout:
                fail(f"router: waiting for {want!r}, the version manager "
                     f"answered {res}")
            time.sleep(0.05)

    try:
        time.sleep(0.5)
        reps[1].kill()  # mid-load: its queue fails typed and re-admits
        ejected = router.check_replicas()
        time.sleep(0.3)
        reps[1].restart()
        rejoined = router.check_replicas()
        if rejoined.get("r1") != "rejoined":
            fail(f"router: r1 did not rejoin after its restart: "
                 f"{ejected} then {rejoined}")
        time.sleep(0.3)
        commit_into(staging, root, 2)
        res = poll("canary")
        if len(res["canaries"]) != 1:
            fail(f"router: v2's canary is {res}, not one replica of two")
        time.sleep(0.2)
        res = poll("promoted")
        if {r.version for r in reps} != {2}:
            fail(f"router: after the promotion replicas serve "
                 f"{[r.version for r in reps]}")
        reserved["v2"] = torch.cuda.memory_reserved()
        commit_into(staging, root, 3)
        res = poll("canary")
        for name in res["canaries"]:
            plans[name].arm("serve.replica_infer", exc=InjectedFault)
        res = poll("rolled_back", stop=("promoted", "swap_failed"))
        for p in plans.values():
            p.disarm("serve.replica_infer")
        if mvm.quarantined != {3} or {r.version for r in reps} != {2}:
            fail(f"router: after the rollback quarantined "
                 f"{mvm.quarantined}, replicas on "
                 f"{[r.version for r in reps]}")
        reserved["rollback"] = torch.cuda.memory_reserved()
        torn = commit_into(staging, root, 4)
        FaultPlan(seed=SEED).bit_flip(os.path.join(torn, "arrays.msgpack"))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            idle = mvm.poll()
            skipped = reg.snapshot().get(
                "serve_swap_versions_skipped_total", 0)
            newest = newest_valid_version(root, registry=MetricsRegistry())
        if (idle["action"] != "none" or not skipped
                or not any("torn/corrupt" in str(w.message) for w in caught)
                or newest[0] != 3 or sorted(list_steps(root)) != [1, 2, 3, 4]):
            fail(f"router: the torn v4 was not skipped to v3 ({idle}, "
                 f"skipped {skipped}, steps {sorted(list_steps(root))})")
        time.sleep(0.3)
    finally:
        traffic.stop()
    router.drain(timeout=120)
    counts = launches()  # and ends here
    if router.outstanding():
        fail(f"router: {router.outstanding()} rows left in the accepted "
             f"ledger after drain")
    served, failed = version_of(traffic, refs, "router", exact=True)
    shares = shed_shares(traffic, "router")
    snaps = [r.metrics.snapshot() for r in reps]
    batches = sum(s["batches"] for s in snaps)
    warm = sum(r.warmups for r in reps)
    dispatched = (2 * len(reps[0]._engine.bucket_sizes) * factory.built
                  + warm + batches)
    if counts["conv_int8_fused"] != INT8_CONVS * dispatched \
            or counts["conv_int8"]:
        fail(f"router: conv_int8_fused launched {counts['conv_int8_fused']} "
             f"times for {dispatched} batches ({INT8_CONVS} convs each), "
             f"mode A {counts['conv_int8']}")
    grew = {k: v - reserved["v1"] for k, v in reserved.items()}
    if max(grew.values()) > pool_bytes:
        fail(f"router: memory_reserved grew {grew} B over v1, more than one "
             f"engine's pool ({pool_bytes} B)")
    rsnap = router.metrics.snapshot()
    regs = router.metrics.registry.snapshot()
    for r in reps:
        r.close()
    tmp.cleanup()
    out.update({
        "requests": len(traffic.sent), "offered": traffic.offered,
        "shed": traffic.shed, "shed_share": shares, "failed": failed,
        "served_by_version": served, "launches": counts,
        "dispatched": dispatched, "engines_built": factory.built,
        "pool_bytes": pool_bytes, "reserved_growth": grew,
        "readmits": regs.get("serve_router_readmits_total", 0),
        "deaths": regs.get("serve_router_replica_deaths_total", 0),
        "rejoins": regs.get("serve_router_rejoins_total", 0),
        "promotions": regs.get("serve_router_promotions_total", 0),
        "rollbacks": regs.get("serve_router_rollbacks_total", 0),
        "skipped_versions": skipped,
        "latency_ms": {p: {"p50": rsnap[p]["p50_ms"], "p99": rsnap[p]["p99_ms"]}
                       for p, _ in ROUTER_MIX},
        "throughput_rps": rsnap["total"]["throughput_rps"],
        "phase_s": round(time.perf_counter() - t_phase, 1)})
    if not (out["deaths"] >= 1 and out["rejoins"] >= 1
            and out["promotions"] == 1 and out["rollbacks"] == 1
            and served[1] and served[2]):
        fail(f"router: events incomplete: {json.dumps(out)}")
    print(f"router: int8 resnet18_tiny_imagenet, 2 LocalReplicas behind a "
          f"Router, {len(traffic.sent)} admitted requests of "
          f"{sum(traffic.offered.values())} offered at {ROUTER_RPS:g}/s; "
          f"{json.dumps(out)}; every result bit for bit one version's "
          f"reference, ledger empty, conv_int8_fused "
          f"{counts['conv_int8_fused']} = {INT8_CONVS} x {dispatched} "
          f"batches; on {card}", flush=True)
    return out


class ReplicaChild(ChildProcess):
    """One ``python chip_smoke.py --replica-server ...`` process on the
    card (its own CUDA context, loading the kernels this process built).
    Closing its stdin asks it to drain and print its shutdown line."""

    def __init__(self, port, root, version, name, calib=None,
                 metrics_port=None, trace=None):
        self.port, self.name = port, name
        extra = [] if calib is None else ["--calib", calib]
        if metrics_port is not None:
            extra += ["--metrics-port", str(metrics_port)]
        if trace is not None:
            extra += ["--trace", trace]
        super().__init__(
            f"replica server {name}",
            [os.path.join(ROOT, "chip_smoke.py"), "--replica-server",
             "--root", root, "--version", str(version), "--port", str(port),
             "--name", name, "--queue-capacity", str(ROUTER_QUEUE), *extra],
            stdin=True)

    def wait(self, timeout=180.0):
        self.wait_for("listening", timeout)

    def result(self, timeout=120.0) -> dict:
        """Close its stdin; its shutdown line after it exited 0."""
        return self.finish("shutdown", timeout)


def replica_server_main(argv) -> None:
    """``python chip_smoke.py --replica-server --root DIR --version V
    --port P [--name N] [--queue-capacity Q] [--max-batch B] [--calib
    FILE.npy] [--metrics-port M] [--trace SHARD]``: a ``ReplicaServer``
    over a ``LocalReplica`` whose ``EngineFactory`` loads ``DIR``'s
    commits on the card (int8 from the calibration batch in ``FILE.npy``
    where given, so every process quantizes from the very same array);
    with ``--metrics-port`` the replica's telemetry server on port M, and
    with ``--trace`` the tracer on, its JSONL shard rewritten at SHARD
    every 0.25 s (so a SIGKILL leaves the last one) and at shutdown.
    Prints ``{"listening": P, ...}`` when it serves; when its stdin closes
    it drains and prints ``{"shutdown": true, "launches": ...,
    "dispatched": ...}``, the launch counters of this process and the
    batches they cover."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --replica-server")
    ap.add_argument("--root", required=True)
    ap.add_argument("--version", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--name", default="replica")
    ap.add_argument("--queue-capacity", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--calib", default=None)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import set_precision
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.serve import EngineFactory, ReplicaServer

    set_precision("parity")
    _kernels.build()  # the libraries the parent built, from the build dir
    stop_flush = threading.Event()
    if args.trace is not None:
        from dcnn_tpu_torch.obs import configure

        tracer = configure(enabled=True)
        tracer.process_name = args.name

        def flush():
            while not stop_flush.wait(0.25):
                tracer.export_jsonl(args.trace)

        threading.Thread(target=flush, daemon=True,
                         name="trace-shard").start()
    kw = {} if args.calib is None else {"int8_calib": np.load(args.calib)}
    factory = EngineFactory(args.root, max_batch=args.max_batch,
                            device="cuda", **kw)
    buckets = []

    def make(version):
        eng = factory(version)
        buckets.append(len(eng.bucket_sizes))
        return eng

    replica = counting_replica_class()(
        make, args.version, name=args.name,
        queue_capacity=args.queue_capacity)
    metrics = (None if args.metrics_port is None
               else replica.start_telemetry(port=args.metrics_port).port)
    server = ReplicaServer(replica, port=args.port, host="127.0.0.1",
                           own_replica=True)
    print(json.dumps({"listening": server.port, "pid": os.getpid(),
                      "metrics": metrics,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    sys.stdin.read()  # until the parent closes it
    server.close()  # drains and closes the replica
    if args.trace is not None:
        stop_flush.set()
        tracer.export_jsonl(args.trace)
    snap = replica.metrics.snapshot()
    print(json.dumps({
        "shutdown": True, "name": args.name, "version": replica.version,
        "launches": launches(), "engines": len(buckets),
        "warmups": replica.warmups, "batches": snap["batches"],
        "dispatched": 2 * sum(buckets) + replica.warmups + snap["batches"]}),
        flush=True)
    sys.stdout.flush()
    os._exit(0)


def phase_router_tcp(card):
    """The router tier over TCP on the card: full-width ``mha_classifier``
    (S=32, E=64, 4 heads, fp32; JAX-layout weights from ``SEED``, v2 = v1
    plus noise, both committed by ``CheckpointManager``) served by 2
    ``ReplicaServer`` child processes (:class:`ReplicaChild`), with a
    ``TcpReplica`` each and the ``Router`` here, under the open-loop mix.
    One child is SIGKILLed mid-load: its death must be seen through the
    connection's close (the last-heard timeout is 30 s), its accepted work
    re-admitted to the survivor; then a remote swap to v2 on the survivor.
    Gates: every admitted request resolves; every result within
    ``SERVE_TOL`` of the CPU reference of exactly one version; the
    survivor's shutdown line counts the flash forward twice a replayed
    batch. Prints detection and recovery seconds."""
    import tempfile

    import numpy as np

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager
    from dcnn_tpu_torch.serve import InferenceEngine, Router, TcpReplica

    t_phase = time.perf_counter()
    cfg, params, rng = model_params()
    models = {1: from_jax(cfg, params, device="cpu")}
    rng = np.random.default_rng(SEED + 40)
    models[2] = perturbed(models[1], rng)
    pool = rng.normal(size=(ROUTER_POOL, *cfg["input_shape"])).astype(
        np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_router_tcp_",
                                      dir=ROOT)
    mgr = CheckpointManager(tmp.name, keep=10)
    refs = {}
    for v, m in models.items():
        path = mgr.save(v, m)
        refs[v] = InferenceEngine.from_checkpoint(
            path, max_batch=32, device="cpu").infer(pool).numpy()
    mgr.close()
    children = [ReplicaChild(p, tmp.name, 1, f"tcp{i}")
                for i, p in enumerate(free_ports(2))]
    clients, router, traffic = [], None, None
    out = {}
    try:
        t0 = time.perf_counter()
        for c in children:
            c.wait()
        out["child_start_s"] = round(time.perf_counter() - t0, 1)
        clients = [TcpReplica("127.0.0.1", c.port, name=c.name,
                              timeout_s=30.0, connect_timeout=60.0)
                   for c in children]
        router = Router(clients)
        traffic = OpenLoopMix(router, pool, ROUTER_RPS, SEED + 41).start()
        time.sleep(1.0)
        pending = [f for _, _, _, f in list(traffic.sent) if not f.done()]
        t_kill = time.perf_counter()
        children[1].kill()  # SIGKILL, mid-load
        while not clients[1].is_dead():
            if time.perf_counter() - t_kill > 10.0:
                fail("router tcp: the killed replica's client did not see "
                     "it die within 10 s")
            time.sleep(0.001)
        out["detection_s"] = round(time.perf_counter() - t_kill, 4)
        reason = clients[1].health()
        if "connection closed" not in reason:
            fail(f"router tcp: death seen as {reason!r}, not through the "
                 f"connection's close")
        while not all(f.done() for f in pending):
            if time.perf_counter() - t_kill > 60.0:
                fail("router tcp: requests in flight at the kill did not "
                     "resolve within 60 s")
            time.sleep(0.001)
        out["recovery_s"] = round(time.perf_counter() - t_kill, 4)
        out["in_flight_at_kill"] = len(pending)
        report = router.check_replicas()
        if "ejected" not in report.get("tcp1", "") and \
                router.replica_stats()["tcp1"]["state"] != "dead":
            fail(f"router tcp: the dead replica was not ejected: {report}")
        time.sleep(0.5)
        t = time.perf_counter()
        router.swap_replica("tcp0", 2)
        out["swap_s"] = round(time.perf_counter() - t, 3)
        clients[0].ping()  # its pong carries the remote version
        t = time.perf_counter()
        while clients[0].version != 2 and time.perf_counter() - t < 10.0:
            time.sleep(0.01)
        if clients[0].version != 2:
            fail(f"router tcp: the survivor serves {clients[0].version} "
                 f"after its remote swap to 2")
        time.sleep(1.0)
    finally:
        if traffic is not None:
            traffic.stop()
        try:
            if router is not None:
                router.drain(timeout=120)
        finally:
            for c in clients:
                c.close()
            line = None
            if children[0].proc.poll() is None:
                line = children[0].result()
            for c in children:
                c.close()
            tmp.cleanup()
    if line is None:
        fail("router tcp: the surviving replica server died")
    served, failed = version_of(traffic, refs, "router tcp", exact=False,
                                tol=SERVE_TOL)
    shares = shed_shares(traffic, "router tcp")
    fwd = line["launches"]["flash_fwd"]
    if fwd != 2 * line["dispatched"] or not line["batches"] \
            or line["version"] != 2:
        fail(f"router tcp: the survivor's flash_fwd launches {fwd} for "
             f"{line['dispatched']} batches (2 attention layers each); "
             f"{line}")
    rsnap = router.metrics.snapshot()
    regs = router.metrics.registry.snapshot()
    out.update({
        "requests": len(traffic.sent), "offered": traffic.offered,
        "shed": traffic.shed, "shed_share": shares, "failed": failed,
        "served_by_version": served, "survivor": line,
        "readmits": regs.get("serve_router_readmits_total", 0),
        "latency_ms": {p: {"p50": rsnap[p]["p50_ms"], "p99": rsnap[p]["p99_ms"]}
                       for p, _ in ROUTER_MIX},
        "throughput_rps": rsnap["total"]["throughput_rps"],
        "phase_s": round(time.perf_counter() - t_phase, 1)})
    if not (served[1] and served[2]):
        fail(f"router tcp: not both versions served: {json.dumps(out)}")
    print(f"router tcp: mha_classifier fp32 over 2 ReplicaServer processes, "
          f"one SIGKILLed mid-load (seen through the connection's close "
          f"after {out['detection_s']} s, its {len(pending)} in-flight "
          f"requests resolved after {out['recovery_s']} s), the survivor "
          f"swapped to v2 remotely in {out['swap_s']} s; {json.dumps(out)}; "
          f"every result within {SERVE_TOL:g} of one version's CPU "
          f"reference, the survivor's flash_fwd {fwd} = 2 x "
          f"{line['dispatched']} batches; on {card}", flush=True)
    return out


# -- phases 21-23: data parallelism over processes and elastic peers -------

DP_SEED = SEED + 20
DP_BATCH = 32             # the mesh step's global batch
DP_STEPS = 4
DP_LR = 1e-3              # AdamW, weight decay 1e-4 (the Tiny-ImageNet recipe)
DP_TIMED = 10             # replayed world-1 steps timed
# world 2 over gloo (global-batch BN, two ranks of 16 rows) against one
# process on the 32 rows, a new batch a step: the same sums in another
# order. ResNet-18's fp32 gradients are ill-conditioned at this
# initialisation (BN's backward subtracts nearly equal sums; the train cnn
# phase measures fp32 up to 9.3e-2 of a tensor's largest value from fp64),
# so the first step's gradients are held in fp64: within DP_F64_TOL of
# each tensor's largest |g| (a conv bias that feeds a BN, whose gradient
# is zero in exact arithmetic, of the model's largest), which a wrong 1/W
# scale or a wrong global-BN backward would break: that is the check of
# the numbers. In fp32 the losses are held within DP_LOSS_RTOL, and, as
# sanity bounds only, every param within Adam's step bound
# 2·steps·lr·(1-b1)/sqrt(1-b2) (as in train cnn; the worst param where
# Adam's RMS gradient is at least GRAD_FLOOR is printed, and the worst
# outside the conv biases that feed a BN) and the BN statistics within
# DP_STATS_RTOL of their scale (a conv bias that feeds a BN moves by
# Adam's noise, and the BN's running mean with it).
DP_LOSS_RTOL = 1e-3
DP_F64_TOL = 1e-8
DP_STATS_RTOL = 5e-2
ELASTIC_ROWS, ELASTIC_BATCH, ELASTIC_K, ELASTIC_EPOCHS = 256, 64, 4, 2
ELASTIC_CKPT_STEPS = 2
ELASTIC_KILL_AFTER = 5    # steps peer 1 trains before its SIGKILL
# The elastic numbers are checked in fp64: before the killed fp32 run the
# two peers train ELASTIC64_ROWS rows (one epoch of ELASTIC64_ROWS /
# ELASTIC_BATCH steps, K=ELASTIC_K, checkpoints every ELASTIC_CKPT_STEPS,
# plain SGD so that a step's param change is lr times the exchanged mean
# gradient) in fp64; peer 1 crashes (InjectedCrash, its sockets closed) at
# the heartbeat after step ELASTIC64_CRASH_AFTER, and the survivor
# restores the last checkpoint and finishes at world 1. That run is held
# to elastic_reference, the elastic semantics by hand in fp64 in this
# process, at world 2 up to the checkpoint and at world 1 after it: the
# mean gradient over the K microbatches, the running statistics threaded
# through each host's microbatches and averaged weighted by their count,
# the mean loss. The leader sums in fp32 (as the JAX package's does),
# which bounds the agreement near fp32's 6e-8 of a tensor's largest term:
# ELASTIC_F64_TOL of each tensor's largest change (a conv bias that feeds
# a BN, whose gradient is zero in exact arithmetic, of the model's
# largest), of each statistic's scale, and of each step's loss. A wrong
# 1/K, weighting, row or restore, or a stale mean, is off by O(1) there.
ELASTIC64_ROWS, ELASTIC64_LR, ELASTIC64_CRASH_AFTER = 256, 1e-2, 3
ELASTIC_F64_TOL = 1e-5
# The killed fp32 run (Adam) against a solo (world 1, K=4) run of the same
# weights and rows: the first step's loss within ELASTIC_LOSS1_RTOL (the
# same params; only the loss sum is reassociated). After it the fp32
# runs part (fp32 gradients are 1.5e-2 off fp64 here, see DP_F64_TOL, and
# Adam turns noise in a small gradient into steps of +-lr), so the later
# losses, the params and the BN statistics get sanity bounds only, the
# fp64 run above being the check of the numbers: losses ELASTIC_LOSS_RTOL
# (set from the 3.5e-3 read on the card, a restore of the wrong step or
# of the initial weights is off by 0.1-0.5), params Adam's step bound,
# and BN statistics ELASTIC_STATS_RTOL of their scale, as they depend on
# the world (threaded through 2 microbatches a host and averaged, a step
# moves them by 1 - 0.9^2 of the way to the batch statistics, against
# 1 - 0.9^4 in a row).
ELASTIC_LOSS1_RTOL = 1e-5
ELASTIC_LOSS_RTOL = 2e-2
ELASTIC_STATS_RTOL = 1.0
ELASTIC_MHA_ROWS, ELASTIC_MHA_BATCH, ELASTIC_MHA_K = 256, 32, 2
ELASTIC_MHA_KILL_AT = 6   # the leader's heartbeat that crashes
ELASTIC_RTOL, ELASTIC_ATOL = 2e-4, 2e-5  # tests/test_elastic.py


def dp_setup():
    """Full-width ``resnet18_tiny_imagenet`` (NCHW) config and JAX-layout
    weights from ``DP_SEED``, and ``ELASTIC_ROWS`` synthetic uint8 rows
    with one-hot labels of its 200 classes: the same in every process."""
    import numpy as np

    from dcnn_tpu_torch.models import create_model

    cfg = create_model("resnet18_tiny_imagenet", "NCHW").get_config()
    params, state = jax_layout(cfg, np.random.default_rng(DP_SEED))
    rng = np.random.default_rng(DP_SEED + 1)
    x = rng.integers(0, 256, (ELASTIC_ROWS, 3, 64, 64), dtype=np.uint8)
    y = np.eye(200, dtype=np.float32)[rng.integers(0, 200, ELASTIC_ROWS)]
    return cfg, params, state, x, y


def deterministic_cudnn():
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def host_named(model, grads=False) -> dict:
    """A model's params (or their ``.grad``) and buffers as numpy, by
    name."""
    import numpy as np

    def host(t):
        return np.array(t.detach().cpu())  # a copy, also of a CPU tensor

    if grads:
        return {n: host(p.grad) for n, p in model.named_parameters()}
    out = {n: host(p) for n, p in model.named_parameters()}
    out.update({n: host(b) for n, b in model.named_buffers()})
    return out


def dp_run(kind, setup, mesh=None, timed=0, steps=DP_STEPS, dtype=None):
    """``DP_STEPS`` AdamW steps of the setup's model on the card, step
    ``i`` on the ``i``-th ``DP_BATCH`` rows (cycling): ``kind`` "plain"
    (``make_train_step``, eager), "dp_eager" / "dp"
    (``make_data_parallel_train_step`` over ``mesh``, eager / ``jit=True``)
    on this rank's shard, "sp_eager" / "sp" the same with
    ``spatial_axis="sp"`` (the shard's dim-2 slice too). Then ``timed``
    more steps timed one by one.
    Returns losses, params and buffers, the first step's gradients, Adam's
    v, the step and its walls in ms. ``steps`` and ``dtype`` (fp32 by
    default; the model and the batches cast to it) change the run."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.data import decode_batch
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import AdamW
    from dcnn_tpu_torch.parallel import (make_data_parallel_train_step,
                                         shard_batch)
    from dcnn_tpu_torch.train import create_train_state, make_train_step

    cfg, params, state, x, y = setup
    ce = get_loss("softmax_crossentropy")
    dtype = dtype or torch.float32
    model = from_jax(cfg, params, state, device="cuda").to(dtype)
    opt = AdamW(DP_LR, weight_decay=1e-4)
    ts = create_train_state(model, opt)
    xs = decode_batch(torch.from_numpy(x).cuda(), 1.0 / 255.0).to(dtype)
    ys = torch.from_numpy(y).cuda().to(dtype)
    batches = [(xs[i:i + DP_BATCH], ys[i:i + DP_BATCH])
               for i in range(0, len(x), DP_BATCH)]
    if kind == "plain":
        step = make_train_step(model, ce, opt, jit=False)
    else:
        spatial = "sp" if kind.startswith("sp") else None
        step = make_data_parallel_train_step(model, ce, opt, mesh,
                                             spatial_axis=spatial,
                                             jit=kind in ("dp", "sp"))
        batches = [shard_batch(b, mesh, spatial_axis=spatial)
                   for b in batches]
    losses, walls, grads = [], [], None
    for i in range(steps + timed):
        xb, yb = batches[i % len(batches)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = step(ts, xb, yb, DP_LR)
        lv = float(loss)
        walls.append((time.perf_counter() - t) * 1e3)
        if i < steps:
            losses.append(lv)
        if i == 0:
            grads = host_named(model, grads=True)
        if i == steps - 1:
            final = host_named(model)
            v = {n: np.array(t_.detach().cpu())
                 for n, t_ in ts.opt_state["v"].items()}
    return {"losses": losses, "final": final, "grads": grads, "v": v,
            "step": step, "walls_ms": walls}


def split_named(model_cfg_names, tree):
    """(params, buffers) of a ``host_named`` dict."""
    params = {n: a for n, a in tree.items() if n in model_cfg_names}
    bufs = {n: a for n, a in tree.items() if n not in model_cfg_names}
    return params, bufs


def stats_rel(a: dict, b: dict) -> float:
    """Largest |a - b| of any BN statistic over that statistic's scale."""
    import numpy as np

    return max(float(np.abs(a[n] - b[n]).max())
               / (float(np.abs(b[n]).max()) or 1.0) for n in b)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def start_elastic_peers():
    """The two peer processes of phases 21 (b) and 22, started first so
    that they import torch while phase 21 (a) runs here."""
    import tempfile

    d = tempfile.mkdtemp(prefix="dcnn_elastic_")
    store, p0, p1, q0, q1 = free_ports(5)
    args = ["--store", str(store), "--peers", f"127.0.0.1:{p0},127.0.0.1:{p1}",
            "--peers64", f"127.0.0.1:{q0},127.0.0.1:{q1}", "--dir", d]
    return d, [ChildProcess(f"elastic peer {r}",
                            [os.path.join(ROOT, "chip_smoke.py"),
                             "--elastic-peer", str(r), *args])
               for r in (0, 1)]


def elastic64_rows(setup):
    """The fp64 run's rows: the first ``ELASTIC64_ROWS``, decoded."""
    import numpy as np

    _cfg, _p, _s, x, y = setup
    return ((x[:ELASTIC64_ROWS] / 255.0).astype(np.float64),
            y[:ELASTIC64_ROWS].astype(np.float64))


def elastic_reference(setup, worlds):
    """The elastic fp64 run by hand (see ELASTIC_F64_TOL) on the card: the
    loader's epoch-1 batches of ``elastic64_rows``, step ``i`` at world
    ``worlds[i]``; host ``h`` of a world ``w`` takes microbatches
    ``h·K/w .. (h+1)·K/w - 1``,
    threading the running statistics through them from the step's start;
    the gradient is the sum of their mean gradients over K, the statistics
    the hosts' mean weighted by microbatch count, the loss the
    microbatches' mean; then SGD. Returns (the final params and buffers by
    name, the losses a step)."""
    import torch

    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops.losses import get_loss

    cfg, params, state, _, _ = setup
    x, y = elastic64_rows(setup)
    model = from_jax(cfg, params, state, device="cuda").double().train()
    ce = get_loss("softmax_crossentropy")
    loader = ArrayDataLoader(x, y, batch_size=ELASTIC_BATCH, seed=SEED)
    loader.shuffle(1)
    k, rows = ELASTIC_K, ELASTIC_BATCH // ELASTIC_K
    ps = list(model.parameters())
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    losses = []
    for idx, world in zip(loader.batch_indices(), worlds):
        start = [b.clone() for b in bufs]
        grad = [torch.zeros_like(p) for p in ps]
        mean = [torch.zeros_like(b) for b in bufs]
        loss = 0.0
        for h in range(world):
            with torch.no_grad():
                for b, b0 in zip(bufs, start):
                    b.copy_(b0)
            lo, hi = h * k // world, (h + 1) * k // world
            for m in range(lo, hi):
                sel = idx[m * rows:(m + 1) * rows]
                lm = ce(model(torch.from_numpy(x[sel]).cuda()),
                        torch.from_numpy(y[sel]).cuda())
                for g, gm in zip(grad, torch.autograd.grad(lm, ps)):
                    g += gm
                loss += lm.item()
            for s_, b in zip(mean, bufs):
                s_ += (hi - lo) * b.detach()
        with torch.no_grad():
            for p, g in zip(ps, grad):
                p -= ELASTIC64_LR * (g / k)
            for b, s_ in zip(bufs, mean):
                b.copy_(s_ / k)
        losses.append(loss / k)
    return host_named(model), losses


def elastic_peer_main(argv) -> None:
    """``python chip_smoke.py --elastic-peer RANK --store PORT --peers
    H:P,H:P --peers64 H:P,H:P --dir DIR``: one rank of a world of 2 on the
    card.

    (b) ``make_data_parallel_train_step`` over a gloo world of 2 (the
    store on rank 0's ``PORT``; global-batch BN across the two ranks), the
    first ``DP_BATCH`` rows sharded, ``DP_STEPS`` steps, results to
    ``DIR/dp<RANK>.pt``; then the elastic fits, ``Trainer.fit`` with
    ``TrainingConfig(elastic=True, elastic_peers=..., elastic_rank=RANK)``:
    the fp64 one over ``--peers64`` (see ELASTIC_F64_TOL; rank 0 writes
    ``DIR/elastic64.pt``), then the fp32 one on the ``ELASTIC_ROWS`` rows,
    checkpoints in ``DIR/ckpt``. Rank 1 prints ``{"at_step": ...}`` at the
    heartbeat of step ``ELASTIC_KILL_AFTER`` and waits there to be
    SIGKILLed; rank 0 finishes, writes ``DIR/elastic0.pt`` and prints
    ``{"elastic": ...}``.
    """
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --elastic-peer")
    ap.add_argument("rank", type=int)
    ap.add_argument("--store", type=int, required=True)
    ap.add_argument("--peers", required=True)
    ap.add_argument("--peers64", required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from dcnn_tpu_torch.core import TrainingConfig, set_precision
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.optim import SGD, AdamW
    from dcnn_tpu_torch.parallel import multihost
    from dcnn_tpu_torch.parallel.data_parallel import HOST_STAGING
    from dcnn_tpu_torch.resilience import faults
    from dcnn_tpu_torch.train import Trainer, create_train_state

    set_precision("parity")
    _kernels.build()  # the libraries the parent built, from the build dir
    deterministic_cudnn()
    rank = args.rank
    setup = dp_setup()
    multihost.initialize(f"127.0.0.1:{args.store}", 2, rank,
                         backend="gloo", timeout_s=300)
    mesh = make_mesh()
    run = dp_run("dp", setup, mesh, timed=DP_TIMED)
    n_steps = DP_STEPS + DP_TIMED
    staging = {k: v / n_steps for k, v in HOST_STAGING.items()}
    run64 = dp_run("dp", setup, mesh, steps=1, dtype=torch.float64)
    torch.save({"losses": run["losses"], "final": run["final"],
                "grads": run["grads"], "loss64": run64["losses"][0],
                "grads64": run64["grads"]},
               os.path.join(args.dir, f"dp{rank}.pt"))
    print(json.dumps({"dp": {"rank": rank, "losses": run["losses"],
                             "walls_ms": run["walls_ms"],
                             "staging_per_step": staging,
                             "graphs": run["step"].pool is not None}}),
          flush=True)
    multihost.barrier("dp done", timeout_ms=300_000)
    multihost.shutdown()

    cfg, params, state, x, y = setup
    class CrashAfter(faults.FaultPlan):
        """Peer 1's death in the fp64 run: at the heartbeat after step
        ELASTIC64_CRASH_AFTER."""

        def _check(self, point, context):
            if point == "elastic.heartbeat" \
                    and context.get("step") == ELASTIC64_CRASH_AFTER:
                raise faults.InjectedCrash(point, 0, **context)

    model = from_jax(cfg, params, state, device="cuda").double()
    opt = SGD(ELASTIC64_LR)
    trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        epochs=1, batch_size=ELASTIC_BATCH, learning_rate=ELASTIC64_LR,
        seed=SEED, snapshot_dir=None, elastic=True,
        elastic_peers=args.peers64, elastic_rank=rank,
        elastic_microbatches=ELASTIC_K, elastic_ckpt_steps=ELASTIC_CKPT_STEPS,
        checkpoint_dir=os.path.join(args.dir, "ckpt64"),
        elastic_heartbeat_s=1.0, elastic_timeout_s=60.0))
    if rank == 1:
        faults.install(CrashAfter())
    try:
        trainer.fit(create_train_state(model, opt), ArrayDataLoader(
            *elastic64_rows(setup), batch_size=ELASTIC_BATCH, seed=SEED))
    except faults.InjectedCrash:
        if rank != 1:
            raise
    faults.clear()
    if rank == 0:
        ctl = trainer.elastic
        torch.save({"final": host_named(model), "step_log": ctl.step_log,
                    "reconfigures": ctl.stats["reconfigures"]},
                   os.path.join(args.dir, "elastic64.pt"))

    model = from_jax(cfg, params, state, device="cuda")
    opt = AdamW(DP_LR, weight_decay=1e-4)
    tcfg = TrainingConfig(
        epochs=ELASTIC_EPOCHS, batch_size=ELASTIC_BATCH,
        learning_rate=DP_LR, seed=SEED, snapshot_dir=None, elastic=True,
        elastic_peers=args.peers, elastic_rank=rank,
        elastic_microbatches=ELASTIC_K, elastic_ckpt_steps=ELASTIC_CKPT_STEPS,
        checkpoint_dir=os.path.join(args.dir, "ckpt"),
        elastic_heartbeat_s=1.0, elastic_timeout_s=60.0)
    trainer = Trainer(model, opt, "softmax_crossentropy", tcfg)

    class StopBeforeStep(faults.FaultPlan):
        """At the heartbeat that starts step ELASTIC_KILL_AFTER + 1: print
        this peer's exchange so far and wait for the SIGKILL."""

        def _check(self, point, context):
            if point == "elastic.heartbeat" \
                    and context.get("step") == ELASTIC_KILL_AFTER:
                ctl = trainer.elastic
                print(json.dumps({"at_step": ELASTIC_KILL_AFTER,
                                  "exchange": ctl.stats["exchange"],
                                  "step_log": ctl.step_log}), flush=True)
                time.sleep(600)

    if rank == 1:
        faults.install(StopBeforeStep())
    loader = ArrayDataLoader(x, y, batch_size=ELASTIC_BATCH, seed=SEED)
    trainer.fit(create_train_state(model, opt), loader)
    ctl = trainer.elastic
    torch.save(host_named(model), os.path.join(args.dir, f"elastic{rank}.pt"))
    print(json.dumps({"elastic": {
        "rank": rank, "stats": ctl.stats, "step_log": ctl.step_log,
        "history": trainer.history, "gen": ctl.gen, "world": ctl.world}}),
        flush=True)
    sys.stdout.flush()
    os._exit(0)


def phase_data_parallel(card):
    """Phase 21 (a): ``make_data_parallel_train_step`` in a world of 1 over
    NCCL in this process, on full-width ``resnet18_tiny_imagenet`` (NCHW,
    B=32, AdamW, cuDNN deterministic): eager and replayed (the whole step,
    the NCCL all-reduces of the BN sums, gradients and loss inside one CUDA
    graph), each bit for bit ``make_train_step`` over ``DP_STEPS`` steps;
    then ``DP_TIMED`` replayed steps timed. Returns the plain run (the
    reference of (b)) and what it prints."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost

    deterministic_cudnn()
    setup = dp_setup()
    multihost.initialize(num_processes=1, backend="nccl")
    try:
        mesh = make_mesh()
        runs = {k: dp_run(k, setup, mesh, timed=DP_TIMED if k == "dp" else 0)
                for k in ("plain", "dp_eager", "dp")}
    finally:
        multihost.shutdown()
    ref = runs["plain"]
    ref64 = dp_run("plain", setup, steps=1, dtype=torch.float64)
    ref["loss64"], ref["grads64"] = ref64["losses"][0], ref64["grads"]
    ref["final64"] = ref64["final"]  # the spatial phase's (b) too
    for k in ("dp_eager", "dp"):
        r = runs[k]
        if r["losses"] != ref["losses"]:
            fail(f"data parallel: world 1 {k} losses {r['losses']} != "
                 f"make_train_step's {ref['losses']}")
        bad = [n for n in ref["final"]
               if not np.array_equal(r["final"][n], ref["final"][n])]
        if bad:
            fail(f"data parallel: world 1 {k} differs from make_train_step "
                 f"in {len(bad)} tensors ({bad[:4]})")
    sessions = runs["dp"]["step"]._sessions.latest()
    if not sessions or sessions[0].graph is None:
        fail("data parallel: the NCCL world-1 step never replayed a graph")
    warm = runs["dp"]["walls_ms"][DP_STEPS:]
    out = {"world1_nccl": {
        "bit_equal": ["dp_eager", "dp"], "losses": ref["losses"],
        "graph_launches": sessions[0].launch_names(),
        "step_ms_median": median(warm), "step_ms": warm,
        "eager_step_ms_median": median(runs["dp_eager"]["walls_ms"][1:]),
        "samples_per_s": DP_BATCH / (median(warm) / 1e3)}}
    print(f"data parallel (a): resnet18_tiny_imagenet NCHW B={DP_BATCH}, "
          f"world 1 over NCCL: eager and replayed steps bit for bit "
          f"make_train_step over {DP_STEPS} steps; replayed step "
          f"{median(warm):.2f} ms median ({out['world1_nccl']['samples_per_s']:.0f} "
          f"samples/s), eager {out['world1_nccl']['eager_step_ms_median']:.2f}"
          f" ms; on {card}", flush=True)
    return ref, out


def phase_elastic(card, directory, peers, dp_ref, dp_out):
    """Phase 21 (b) and 22, from the two peer processes: (b) the mesh step
    at world 2 over gloo held to the single-process step ``dp_ref``; then
    the elastic fit, peer 1 SIGKILLed before its step
    ``ELASTIC_KILL_AFTER + 1``: the survivor reconfigures once to world 1,
    every step's global batch is ``ELASTIC_BATCH`` rows, it reaches step
    8, and its params match a solo (world 1, K=4) run of the same weights
    and rows, run here."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.optim import AdamW
    from dcnn_tpu_torch.train import Trainer, create_train_state

    try:
        dps = [p.wait_for("dp") for p in peers]
        got = [torch.load(os.path.join(directory, f"dp{r}.pt"),
                          weights_only=False) for r in (0, 1)]
        names = set(dp_ref["grads"])
        for n in got[0]["final"]:
            if not np.array_equal(got[0]["final"][n], got[1]["final"][n]):
                fail(f"data parallel (b): ranks differ in {n}")
        rel_loss = max(abs(a - b) / abs(b) for a, b in
                       zip(got[0]["losses"], dp_ref["losses"]))
        if rel_loss > DP_LOSS_RTOL:
            fail(f"data parallel (b): losses {got[0]['losses']} vs "
                 f"{dp_ref['losses']} (rel {rel_loss:.3e} > {DP_LOSS_RTOL})")
        zero = bias_before_bn(dp_ref["step"].model)

        def grad_rels(a, b):
            top = max(float(np.abs(g).max()) for g in b.values())
            return sorted(((float(np.abs(a[n] - b[n]).max())
                            / (top if n in zero
                               else float(np.abs(b[n]).max()) or 1.0), n)
                           for n in b), reverse=True)

        rels64 = grad_rels(got[0]["grads64"], dp_ref["grads64"])
        loss64 = abs(got[0]["loss64"] - dp_ref["loss64"]) / abs(
            dp_ref["loss64"])
        if max(rels64[0][0], loss64) > DP_F64_TOL:
            fail(f"data parallel (b): the first step in fp64, world 2 vs one "
                 f"process: loss {loss64:.3e}, gradients (rel, name) "
                 f"{rels64[:6]} (tol {DP_F64_TOL:g})")
        grad32 = grad_rels(got[0]["grads"], dp_ref["grads"])[0]
        p_got, b_got = split_named(names, got[0]["final"])
        p_ref, b_ref = split_named(names, dp_ref["final"])
        bound = 2 * DP_STEPS * DP_LR * 0.1 / math.sqrt(1 - 0.999)
        worst, noise, n_noise, n_all, _bins, bound = adam_param_diff(
            p_got, p_ref, dp_ref["v"], DP_STEPS, DP_LR, 0.9, 0.999,
            "data parallel (b)", atol=bound)
        worst_rest = max((float(np.abs(p_got[n] - p_ref[n]).max()), n)
                         for n in p_ref if n not in zero)
        bn_rel = stats_rel(b_got, b_ref)
        if bn_rel > DP_STATS_RTOL:
            fail(f"data parallel (b): BN statistics differ by {bn_rel:.3e} "
                 f"of their scale (> {DP_STATS_RTOL})")
        w2 = [median(d["dp"]["walls_ms"][1:]) for d in dps]
        dp_out["world2_gloo"] = {
            "loss_rel": rel_loss, "fp64_loss_rel": loss64,
            "fp64_grad_rel": rels64[0], "fp32_grad_rel": grad32,
            "param_max_diff": worst, "param_noise_max_diff": noise,
            "param_max_diff_not_bias_before_bn": worst_rest,
            "noise_elements": n_noise, "elements": n_all,
            "adam_step_bound": bound, "bn_stats_rel": bn_rel,
            "step_ms_median": w2,
            "staging_per_step": [d["dp"]["staging_per_step"] for d in dps],
            "graphs": [d["dp"]["graphs"] for d in dps]}
        print(f"data parallel (b): world 2 over gloo (2 processes on the "
              f"card, global-batch BN) against one process: the first step "
              f"in fp64 within {max(rels64[0][0], loss64):.2e} (loss and "
              f"gradients; fp32 gradients {grad32[0]:.2e}, {grad32[1]}); "
              f"fp32 losses within {rel_loss:.2e}, params {worst:.2e} where "
              f"Adam's RMS gradient >= {GRAD_FLOOR:g} ({worst_rest[0]:.2e} "
              f"outside the conv biases before a BN, in {worst_rest[1]}; "
              f"{noise:.2e} below; bound {bound:.2e}), BN statistics "
              f"{bn_rel:.2e}; step "
              f"{w2[0]:.1f} ms median (eager; staged through the host a "
              f"step: {dps[0]['dp']['staging_per_step']}); on {card}",
              flush=True)

        at = peers[1].wait_for("at_step")
        t_kill = time.time()
        peers[1].kill()
        res = peers[0].wait_for("elastic")["elastic"]
        peers[0].finish()
    finally:
        for p in peers:
            p.close()
    f64 = phase_elastic64(directory)
    log = res["step_log"]
    stats = res["stats"]
    if stats["reconfigures"] != 1 or res["world"] != 1:
        fail(f"elastic: survivor reconfigured {stats['reconfigures']} times "
             f"to world {res['world']} (expected once, to 1)")
    if {e["global_rows"] for e in log} != {ELASTIC_BATCH}:
        fail(f"elastic: global rows {sorted({e['global_rows'] for e in log})}")
    if {e["world"] for e in log} != {1, 2}:
        fail(f"elastic: worlds {sorted({e['world'] for e in log})}")
    steps = ELASTIC_EPOCHS * ELASTIC_ROWS // ELASTIC_BATCH
    if log[-1]["gs"] != steps:
        fail(f"elastic: the run ended at step {log[-1]['gs']}, not {steps}")

    # the solo reference: world 1, K=4, the same weights and rows
    cfg, params, state, x, y = dp_setup()
    model = from_jax(cfg, params, state, device="cuda")
    opt = AdamW(DP_LR, weight_decay=1e-4)
    trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        epochs=ELASTIC_EPOCHS, batch_size=ELASTIC_BATCH, learning_rate=DP_LR,
        seed=SEED, snapshot_dir=None, elastic=True, elastic_rank=0,
        elastic_microbatches=ELASTIC_K, elastic_heartbeat_s=0.0))
    ts = create_train_state(model, opt)
    trainer.fit(ts, ArrayDataLoader(x, y, batch_size=ELASTIC_BATCH, seed=SEED))
    solo = host_named(model)
    # each step's loss against the solo run's step of the same number (a
    # step re-run after the restore, too)
    solo_loss = {e["gs"]: e["loss"] for e in trainer.elastic.step_log}
    loss_rels = [(abs(e["loss"] - solo_loss[e["gs"]]) / abs(solo_loss[e["gs"]]),
                  e["gs"]) for e in log]
    for rel, gs in loss_rels:
        tol = ELASTIC_LOSS1_RTOL if gs == 1 else ELASTIC_LOSS_RTOL
        if rel > tol:
            fail(f"elastic: step {gs}'s loss differs from the solo run's by "
                 f"{rel:.3e} of it (> {tol:g}); losses "
                 f"{[(e['gs'], e['loss']) for e in log]}, solo {solo_loss}")
    names = {n for n, _ in model.named_parameters()}
    v = {n: t.detach().cpu().numpy() for n, t in ts.opt_state["v"].items()}
    got = torch.load(os.path.join(directory, "elastic0.pt"),
                     weights_only=False)
    p_got, b_got = split_named(names, got)
    p_ref, b_ref = split_named(names, solo)
    bound = 2 * steps * DP_LR * 0.1 / math.sqrt(1 - 0.999)
    worst, noise, n_noise, n_all, _bins, bound = adam_param_diff(
        p_got, p_ref, v, steps, DP_LR, 0.9, 0.999, "elastic", atol=bound)
    zero = bias_before_bn(model)
    worst_rest = max((float(np.abs(p_got[n] - p_ref[n]).max()), n)
                     for n in p_ref if n not in zero)
    bn_rel = stats_rel(b_got, b_ref)
    if bn_rel > ELASTIC_STATS_RTOL:
        fail(f"elastic: BN statistics differ from the solo run by "
             f"{bn_rel:.3e} of their scale (> {ELASTIC_STATS_RTOL})")
    def per_step(entries):
        """Medians over the warm world-2 steps (after a count's eager
        first call and its capture) of each exchange figure a step."""
        warm = [e["exchange"] for e in entries
                if e["world"] == 2 and "exchange" in e][2:]
        return {k: median([w.get(k, 0.0) for w in warm])
                for k in ("d2h_s", "net_s", "sum_s", "h2d_s", "bytes")}

    # warm walls: the steps after a count's eager first call and capture
    w2 = [e["seconds"] for e in log if e["world"] == 2][2:]
    w1 = [e["seconds"] for e in log if e["world"] == 1][2:]
    solo_w = [e["seconds"] for e in trainer.elastic.step_log][2:]
    out = {
        "step_s_world2": median(w2), "step_s_world1": median(w1),
        "step_s_solo": median(solo_w),
        "samples_per_s_world2": ELASTIC_BATCH / median(w2),
        "samples_per_s_world1": ELASTIC_BATCH / median(w1),
        "exchange_leader_per_step": per_step(log),
        "exchange_follower_per_step": per_step(at["step_log"]),
        "exchange_totals": {"leader": stats["exchange"],
                            "follower": at["exchange"]},
        "leader_save_s": [e["save_s"] for e in log if "save_s" in e],
        "detection_s": stats["reconfigure_at"][0] - t_kill,
        "silence_before_detection_s": stats["detection_s"],
        "reconfigure_s": stats["reconfigure_s"],
        "restore_s": stats["restore_s"], "steps_lost": stats["steps_lost"],
        "steps_rerun": len(log) - len({e["gs"] for e in log}),
        "loss_rel_step1": max(r for r, gs in loss_rels if gs == 1),
        "loss_rel_max": max(loss_rels),
        "param_max_diff": worst, "param_noise_max_diff": noise,
        "param_max_diff_not_bias_before_bn": worst_rest,
        "noise_elements": n_noise, "elements": n_all,
        "adam_step_bound": bound, "bn_stats_rel": bn_rel,
        "fp64": f64,
        "worlds": sorted({e["world"] for e in log}), "steps": log[-1]["gs"]}
    print(f"elastic: resnet18_tiny_imagenet, {ELASTIC_ROWS} uint8 rows, "
          f"global batch {ELASTIC_BATCH}, K={ELASTIC_K}, 2 peer processes "
          f"over TCP, peer 1 SIGKILLed after step {ELASTIC_KILL_AFTER}: "
          f"detected {out['detection_s']:.3f} s after the kill, "
          f"reconfigured in {stats['reconfigure_s'][0]:.3f} s (restore "
          f"{stats['restore_s'][-1]:.3f} s, {out['steps_rerun']} steps "
          f"re-run), world 2 -> 1, step {log[-1]['gs']}; in fp64 (peer 1 "
          f"crashed after step {ELASTIC64_CRASH_AFTER}, worlds "
          f"{f64['worlds']}) against the elastic semantics by hand: param "
          f"changes within "
          f"{f64['param_rel'][0]:.2e} ({f64['param_rel'][1]}), BN "
          f"statistics {f64['stats_rel'][0]:.2e}, losses "
          f"{f64['loss_rel']:.2e} (tol {ELASTIC_F64_TOL:g}); in fp32 "
          f"against the solo run: step 1's loss within "
          f"{out['loss_rel_step1']:.2e}, every step's {max(loss_rels)[0]:.2e}"
          f" (step {max(loss_rels)[1]}), params {worst:.2e} where Adam's "
          f"RMS gradient >= {GRAD_FLOOR:g} ({worst_rest[0]:.2e} outside the "
          f"conv biases before a BN, in {worst_rest[1]}; {noise:.2e} below; "
          f"bound {bound:.2e}), BN statistics {bn_rel:.2e} of their scale; "
          f"a warm step "
          f"{median(w2):.3f} s at world 2 ({out['samples_per_s_world2']:.0f}"
          f" samples/s), {median(w1):.3f} s at world 1 "
          f"({out['samples_per_s_world1']:.0f} samples/s; solo "
          f"{median(solo_w):.3f} s); the exchange a warm step (medians), "
          f"leader {json.dumps(out['exchange_leader_per_step'])}, follower "
          f"{json.dumps(out['exchange_follower_per_step'])} (its wait "
          f"includes the leader's checkpoint saves, "
          f"{json.dumps(out['leader_save_s'])} s); on {card}", flush=True)
    return out


def phase_elastic64(directory):
    """The fp64 elastic run (the survivor's ``elastic64.pt`` in
    ``directory``) against :func:`elastic_reference` at world 2 up to the
    checkpoint before the crash and at world 1 after it: each tensor's
    change from the initial weights, each BN statistic and each step's
    loss within ``ELASTIC_F64_TOL`` (see there)."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax

    setup = dp_setup()
    got = torch.load(os.path.join(directory, "elastic64.pt"),
                     weights_only=False)
    n_steps = ELASTIC64_ROWS // ELASTIC_BATCH
    ckpt = ELASTIC64_CRASH_AFTER // ELASTIC_CKPT_STEPS * ELASTIC_CKPT_STEPS
    worlds = [2] * ckpt + [1] * (n_steps - ckpt)
    last = {e["gs"]: e for e in got["step_log"]}  # a re-run step's last run
    kept = [last[gs] for gs in sorted(last)]
    if got["reconfigures"] != 1 or [e["world"] for e in kept] != worlds:
        fail(f"elastic fp64: {got['reconfigures']} reconfigurations, steps "
             f"{[(e['gs'], e['world']) for e in got['step_log']]} (expected "
             f"one, and worlds {worlds} by step)")
    ref, ref_losses = elastic_reference(setup, worlds)
    cfg, params, state, _, _ = setup
    init_model = from_jax(cfg, params, state, device="cpu").double()
    init = host_named(init_model)
    names = {n for n, _ in init_model.named_parameters()}
    zero = bias_before_bn(init_model)
    p_got, b_got = split_named(names, got["final"])
    p_ref, b_ref = split_named(names, ref)
    d_ref = {n: p_ref[n] - init[n] for n in p_ref}
    top = max(float(np.abs(d).max()) for d in d_ref.values())
    param_rel = max((float(np.abs(p_got[n] - p_ref[n]).max())
                     / (top if n in zero else float(np.abs(d_ref[n]).max())),
                     n) for n in p_ref)
    stats = max((float(np.abs(b_got[n] - b_ref[n]).max())
                 / float(np.abs(b_ref[n]).max()), n) for n in b_ref)
    losses = [e["loss"] for e in kept]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if max(param_rel[0], stats[0], loss_rel) > ELASTIC_F64_TOL:
        fail(f"elastic fp64: the run against the elastic semantics by hand: "
             f"param changes {param_rel}, BN statistics {stats}, losses "
             f"{losses} vs {ref_losses} ({loss_rel:.3e}); tol "
             f"{ELASTIC_F64_TOL:g}")
    return {"param_rel": param_rel, "stats_rel": stats, "loss_rel": loss_rel,
            "losses": losses, "worlds": worlds,
            "steps_run": len(got["step_log"])}


def phase_elastic_mha(card):
    """Phase 23: a 2-peer elastic fleet of full-width ``mha_classifier``
    (S=32, E=64, 4 heads; JAX-layout weights from ``SEED``), the peers
    threads of this process over loopback, SGD on the marker task: one run
    uninterrupted, one whose leader crashes at a heartbeat (``FaultPlan`` +
    ``InjectedCrash``) and whose survivor takes over. Gates: replicas bit
    for bit, the survivor's params within the JAX test's ``RTOL, ATOL``
    of the uninterrupted run's, and the flash kernels (rows 1-3) launched
    by every peer's grad-step graphs. Returns the counters' launches."""
    import tempfile

    import numpy as np

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import comm
    from dcnn_tpu_torch.parallel.elastic import ElasticController, PeerSpec
    from dcnn_tpu_torch.resilience import FaultPlan
    from dcnn_tpu_torch.resilience.faults import InjectedCrash
    from dcnn_tpu_torch.train import create_train_state

    cfg, params, _rng = model_params()
    x, y = marker_task(np.random.default_rng(SEED + 21), n=ELASTIC_MHA_ROWS)

    def fleet(crash_leader):
        socks = [comm.listen(0, host="127.0.0.1") for _ in range(2)]
        peers = [PeerSpec(i, "127.0.0.1", s.getsockname()[1])
                 for i, s in enumerate(socks)]
        ctls, results = {}, {}
        d = tempfile.mkdtemp(prefix="dcnn_elastic_mha_")

        def runner(i):
            plan = (FaultPlan().arm("elastic.heartbeat",
                                    at=ELASTIC_MHA_KILL_AT, exc=InjectedCrash)
                    if crash_leader and i == 0 else None)
            model = from_jax(cfg, params, device="cuda")
            opt = SGD(0.05)
            tcfg = TrainingConfig(
                epochs=2, learning_rate=0.05, seed=SEED, snapshot_dir=None,
                elastic=True, elastic_microbatches=ELASTIC_MHA_K,
                elastic_timeout_s=30.0, elastic_heartbeat_s=0.0,
                elastic_ckpt_steps=2, checkpoint_dir=d)
            try:
                ctl = ElasticController(
                    model, opt, "softmax_crossentropy",
                    ArrayDataLoader(x, y, batch_size=ELASTIC_MHA_BATCH,
                                    seed=SEED), config=tcfg, rank=i,
                    peers=peers, listen_sock=socks[i], fault_plan=plan)
                ctls[i] = ctl
                ctl.fit(create_train_state(model, opt))
                results[i] = host_named(model)
            except InjectedCrash:
                results[i] = "crashed"
            except BaseException as e:  # reported by the main thread
                results[i] = e

        threads = [threading.Thread(target=runner, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            fail("elastic mha: the fleet hung")
        per_peer = {}
        for i, ctl in ctls.items():
            counts = {}
            for g in ctl._grad_steps.values():
                for k, n in g.launches.items():
                    counts[k] = counts.get(k, 0) + n
            per_peer[i] = counts
        return ctls, results, per_peer

    reset_launches()
    t0 = time.perf_counter()
    ctls, base, base_counts = fleet(False)
    ctls_k, crash, crash_counts = fleet(True)
    counts = launches()
    wall = time.perf_counter() - t0
    for name, res in (("uninterrupted", base), ("crashed", crash)):
        for i, r in res.items():
            if isinstance(r, BaseException):
                fail(f"elastic mha: {name} peer {i} raised "
                     f"{type(r).__name__}: {r}")
    if crash[0] != "crashed" or ctls_k[1].world != 1 or ctls_k[1].gen != 1:
        fail(f"elastic mha: the leader's crash did not leave peer 1 leading "
             f"world 1 (result {crash[0]!r}, world {ctls_k[1].world})")
    for n in base[0]:
        if not np.array_equal(base[0][n], base[1][n]):
            fail(f"elastic mha: uninterrupted replicas differ in {n}")
    worst = 0.0
    for n in base[0]:
        a, b = crash[1][n], base[0][n]
        if not np.allclose(a, b, rtol=ELASTIC_RTOL, atol=ELASTIC_ATOL):
            fail(f"elastic mha: survivor's {n} differs from the "
                 f"uninterrupted run beyond rtol {ELASTIC_RTOL}, atol "
                 f"{ELASTIC_ATOL} (max {float(np.abs(a - b).max()):.3e})")
        worst = max(worst, float(np.abs(a - b).max()))
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    for what, per in (("uninterrupted", base_counts), ("crashed", crash_counts)):
        for i, c in per.items():
            if any(c.get(k, 0) <= 0 for k in flash):
                fail(f"elastic mha: {what} peer {i}'s grad-step graphs "
                     f"launched {c} (every flash kernel expected)")
    out = {"launches": {k: counts[k] for k in flash},
           "per_peer_replayed": {"uninterrupted": base_counts,
                                 "crashed": crash_counts},
           "survivor_max_diff": worst, "phase_s": wall,
           "reconfigure_s": ctls_k[1].stats["reconfigure_s"],
           "steps_lost": ctls_k[1].stats["steps_lost"]}
    print(f"elastic mha: mha_classifier, 2 thread peers on the card, the "
          f"leader crashed at heartbeat {ELASTIC_MHA_KILL_AT}: survivor "
          f"within {worst:.2e} of the uninterrupted run (rtol "
          f"{ELASTIC_RTOL}, atol {ELASTIC_ATOL}); flash launches "
          f"{out['launches']}, by each peer's replayed grad steps "
          f"{json.dumps(out['per_peer_replayed'])}; on {card}", flush=True)
    return out


# sequence parallelism, the DP resident feed and the compiled pipeline's
# data axis

SEQ_SEED = SEED + 21
SEQ_SHAPE = (4, 8, 4096, 64)  # B, H, S, D: FLASH_CASES' "long context"
SEQ_PATHS = (("ring", False), ("ring", True), ("zigzag", True),
             ("ulysses", False), ("ulysses", True))
# A path's output and dQ/dK/dV against the whole sequence's, as max |diff|
# over that tensor's largest |value| (as BWD_TOL's gates). bf16, against
# flash_attention on the whole sequence: the flash gates' BWD_TOL; each
# live block's O leaves the forward kernel rounded to bf16 before the fp32
# merge (zigzag merges 2 blocks a chunk, the ring at world 2 up to 2), and
# each pair's dQ, dK and dV leave the backward kernels rounded to bf16
# before the fp32 sums, a few bf16 units (2^-8) where whole-sequence flash
# rounds once. fp32, against the plain versions (flash_forward_reference,
# flash_backward_reference) on the card: TOL's fp32, the same sums in
# another order. A wrong mask, merge or return of dK/dV is off by O(1).
SEQ_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SEQ_TIMED = 5             # fwd+bwd calls timed a path
SEQ_PLAIN_BLOCK = 256     # the plain backward's tiles (the whole sequence)
# the fp64 one-step SGD run of the DP epoch; a power of two, exact in the
# fp32 scalar the optimizer keeps its lr in
DPR_F64_LR = 2.0 ** -7
DPR_F64_TOL = DP_F64_TOL  # of each tensor's largest change (see DP_F64_TOL)
STACK_SHAPE = (64, 32, 32)  # resnet18_tiny_imagenet's layer1: 64 ch, 32x32
STACK_STAGES, STACK_M, STACK_BATCH, STACK_STEPS = 4, 8, 32, 3


def seq_inputs(dtype):
    """q, k, v and dO at SEQ_SHAPE on the card, from SEQ_SEED (the same in
    every process)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEQ_SEED)
    return [torch.from_numpy(rng.standard_normal(SEQ_SHAPE, np.float32))
            .cuda().to(dtype) for _ in range(4)]


def seq_whole(q, k, v, do, causal, dtype_name):
    """The whole sequence's [out, dq, dk, dv]: bf16 through
    ``flash_attention`` (the kernels), fp32 through the kernels' plain
    versions, both on the card."""
    from dcnn_tpu_torch.ops.attention import (
        flash_attention, flash_backward_reference, flash_forward_reference)

    scale = q.shape[-1] ** -0.5
    if dtype_name == "float32":
        o, lse = flash_forward_reference(q, k, v, causal=causal, scale=scale,
                                         block_kv=SEQ_PLAIN_BLOCK)
        return [o, *flash_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale,
            block_q=SEQ_PLAIN_BLOCK, block_kv=SEQ_PLAIN_BLOCK)]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, scale=scale)
    out.backward(do)
    return [out.detach()] + [t.grad for t in leaves]


def seq_paths(mesh, dtype_names, label):
    """Every SEQ_PATHS path over ``mesh``'s ``"seq"`` axis, each dtype:
    this rank's shard (``shard_sequence``; ``zigzag_shard`` for zigzag)
    forward and backward (dO this rank's slice), held to this rank's slice
    of the whole sequence's run (SEQ_TOL); the flash launches of the
    path's call equal to its schedule's live block pairs for the forward,
    dQ and dK/dV each; then SEQ_TIMED calls timed (wall, synchronised),
    with the host-staged bytes a call. Returns, by "dtype kind[_causal]":
    errors, each reference tensor's largest |value|, launches a call, wall
    ms, staged bytes; and "launches", the
    flash launches of every path call here (not the references')."""
    import torch

    from dcnn_tpu_torch.parallel import sequence
    from dcnn_tpu_torch.parallel.data_parallel import HOST_STAGING

    n, r = mesh.shape["seq"], mesh.coordinate("seq")
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    total = dict.fromkeys(flash, 0)
    out = {}
    for dtype_name in dtype_names:
        q, k, v, do = seq_inputs(getattr(torch, dtype_name))
        for kind, causal in SEQ_PATHS:
            name = f"{dtype_name} {kind}{'_causal' if causal else ''}"
            if kind == "zigzag":
                f = sequence.make_zigzag_ring_attention(mesh)
                shard = sequence.zigzag_shard
                live = sequence.live_pairs(n, r, causal=True, zigzag=True)
            else:
                f = (sequence.make_ring_attention if kind == "ring" else
                     sequence.make_ulysses_attention)(mesh, causal=causal)
                shard = sequence.shard_sequence
                live = 1 if kind == "ulysses" else sequence.live_pairs(
                    n, r, causal=causal, zigzag=False)
            local = shard([q, k, v, do], mesh)
            want = shard(seq_whole(q, k, v, do, causal, dtype_name), mesh)

            def call():
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in local[:3]]
                o = f(*leaves)
                o.backward(local[3])
                return [o.detach()] + [t.grad for t in leaves]

            walls, staged = [], []
            for i in range(1 + SEQ_TIMED):
                before, b0 = launches(), HOST_STAGING["bytes"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                staged.append(HOST_STAGING["bytes"] - b0)
                counts = {k_: launches()[k_] - before[k_] for k_ in flash}
                for k_ in flash:
                    total[k_] += counts[k_]
                if counts != dict.fromkeys(flash, live):
                    fail(f"{label}: {name} launched {counts}, not the "
                         f"schedule's {live} live block pairs each")
                if i == 0:
                    errs, tops = {}, {}
                    for t, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                        err = (a.float() - b.float()).abs().max().item()
                        tops[t] = b.float().abs().max().item()
                        errs[t] = err / tops[t] if tops[t] > 0 else err
                    bad = {t: e for t, e in errs.items()
                           if not e <= SEQ_TOL[dtype_name]}
                    if bad:
                        fail(f"{label}: {name} differs from the whole "
                             f"sequence's run: {bad} (gate "
                             f"{SEQ_TOL[dtype_name]:g} of each tensor's "
                             f"largest |value|)")
            out[name] = {"errors": errs, "largest": tops,
                         "launches_per_call": live,
                         "wall_ms_median": median(walls[1:]),
                         "wall_ms": walls[1:],
                         "staged_bytes_per_call": staged[-1]}
        del q, k, v, do
    out["launches"] = total
    return out


def seq_whole_ms(dtype_name="bfloat16"):
    """Wall ms of one whole-sequence ``flash_attention`` forward and
    backward at SEQ_SHAPE on this card, median of SEQ_TIMED, per
    causality."""
    import torch

    from dcnn_tpu_torch.ops.attention import flash_attention

    q, k, v, do = seq_inputs(getattr(torch, dtype_name))
    out = {}
    for causal in (False, True):
        walls = []
        for _ in range(1 + SEQ_TIMED):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flash_attention(*leaves, causal=causal).backward(do)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["causal" if causal else "full"] = median(walls[1:])
    return out


def seq_text(res, dtype_name):
    return "; ".join(
        f"{name.split(' ')[1]} {r['wall_ms_median']:.3f} ms "
        f"(launches {r['launches_per_call']}x3, err "
        f"{max(r['errors'].values()):.2e}, staged "
        f"{r['staged_bytes_per_call']} B)"
        for name, r in res.items()
        if name != "launches" and name.startswith(dtype_name))


def phase_sequence(card):
    """Phase 24, sequence parallel (a): ring (causal and not), zigzag and
    Ulysses (causal and not) over a ``"seq"`` axis of one NCCL rank in
    this process, at SEQ_SHAPE in bf16 (against ``flash_attention`` on the
    whole sequence) and fp32 (against the kernels' plain versions), each
    forward and backward; launches per call: ring 1, zigzag 3, Ulysses 1,
    of the forward, dQ and dK/dV each (see ``seq_paths``)."""
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost

    multihost.initialize(num_processes=1, backend="nccl")
    try:
        res = seq_paths(make_mesh((1,), ("seq",)), ("bfloat16", "float32"),
                        "sequence parallel (a)")
    finally:
        multihost.shutdown()
    whole = seq_whole_ms()
    res["whole_flash_ms"] = whole
    b, h, s, d = SEQ_SHAPE
    print(f"sequence parallel (a): world 1 over NCCL, B{b} H{h} S{s} D{d}, "
          f"forward+backward held to the whole sequence (bf16 "
          f"{SEQ_TOL['bfloat16']:g}, fp32 {SEQ_TOL['float32']:g} of each "
          f"tensor's largest); bf16: {seq_text(res, 'bfloat16')}; fp32: "
          f"{seq_text(res, 'float32')}; whole-sequence flash fwd+bwd bf16 "
          f"{whole['full']:.3f} ms, causal {whole['causal']:.3f} ms; on "
          f"{card}", flush=True)
    return res


def start_seq_peers():
    """The two processes of phases 25 and 26 (b), started before phase 24
    so that they import torch while it runs; they wait for the parent's
    go (``phase_seq_peers``) before they touch the card's work."""
    import tempfile

    d = tempfile.mkdtemp(prefix="dcnn_seq_")
    (store,) = free_ports(1)
    return d, [ChildProcess(f"sequence peer {r}",
                            [os.path.join(ROOT, "chip_smoke.py"),
                             "--seq-peer", str(r), "--store", str(store),
                             "--dir", d], stdin=True)
               for r in (0, 1)]


def dpr_orders(n_local, local_batch, world):
    """Each rank's one-step order for the fp64 DP run: ``local_batch`` of
    its ``n_local`` rows, from SEED + 23 (the same in every process)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    return [rng.permutation(n_local)[:local_batch][None]
            for _ in range(world)]


def dpr_by_hand(setup, orders, world):
    """The fp64 DP step by hand on the card (JAX's
    ``make_resident_epoch_dp`` semantics): each shard's rows (shard ``s``
    is rows ``s·N/W ..``, its order applied) through the model from the
    start, per-shard batch statistics; the mean of the shards' gradients,
    an SGD step; the shards' updated running statistics averaged; the
    mean loss. Returns (params and buffers by name, loss)."""
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops.losses import get_loss

    cfg, params, state, x, y = setup
    model = from_jax(cfg, params, state, device="cuda").double().train()
    ce = get_loss("softmax_crossentropy")
    ps = list(model.parameters())
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    start = [b.clone() for b in bufs]
    grad = [torch.zeros_like(p) for p in ps]
    mean = [torch.zeros_like(b) for b in bufs]
    per = len(x) // world
    loss = 0.0
    for s in range(world):
        with torch.no_grad():
            for b, b0 in zip(bufs, start):
                b.copy_(b0)
        rows = s * per + orders[s][0]
        xb = torch.from_numpy(x[rows]).cuda().double() * (1.0 / 255.0)
        lm = ce(model(xb), torch.from_numpy(y[rows]).cuda())
        for g, gm in zip(grad, torch.autograd.grad(lm, ps)):
            g += gm
        for m_, b in zip(mean, bufs):
            m_ += b.detach()
        loss += lm.item()
    with torch.no_grad():
        for p, g in zip(ps, grad):
            p -= DPR_F64_LR * (g / world)
        for b, m_ in zip(bufs, mean):
            b.copy_(m_ / world)
    return host_named(model), loss / world


def dpr_f64_rel(got, want, start, model):
    """(worst, name) of the fp64 DP step against the hand one: a param's
    change over the hand change's largest (a conv bias that feeds a BN,
    whose change is zero in exact arithmetic, over the model's largest),
    a buffer's |diff| over its largest |value|."""
    import numpy as np

    names = {n for n, _ in model.named_parameters()}
    zero = bias_before_bn(model)
    top = max(float(np.abs(want[n] - start[n]).max()) for n in names)
    worst = (-1.0, "")
    for n in want:
        if n in names:
            scale = (top if n in zero
                     else float(np.abs(want[n] - start[n]).max()) or top)
        else:
            scale = float(np.abs(want[n]).max()) or 1.0
        rel = float(np.abs(got[n] - want[n]).max()) / scale
        worst = max(worst, (rel, n))
    return worst


def dp_resident_world2(mesh, rank, directory):
    """Phase 26 (b), in a peer: the DP resident epoch over a gloo world of
    2 on the card. fp32: ``Trainer.fit`` over a ``ShardedDeviceDataset``
    (the data-parallel phase's setup: full-width NCHW ResNet-18, AdamW,
    256 uint8 rows, global B=32, one epoch of 8 steps), the params and
    buffers to ``DIR/dpres<RANK>.pt`` for the parent to compare. fp64:
    one SGD step of ``make_resident_epoch_dp`` given ``dpr_orders``; rank
    0 holds it to ``dpr_by_hand``."""
    import torch

    from dcnn_tpu_torch.core import TrainingConfig, set_precision
    from dcnn_tpu_torch.data import (
        ShardedDeviceDataset, make_resident_epoch_dp, stage_sharded)
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD, AdamW
    from dcnn_tpu_torch.parallel.data_parallel import HOST_STAGING
    from dcnn_tpu_torch.train import Trainer, create_train_state

    setup = dp_setup()
    cfg, params, state, x, y = setup
    model = from_jax(cfg, params, state, device="cuda")
    opt = AdamW(DP_LR, weight_decay=1e-4)
    trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        epochs=1, batch_size=DP_BATCH, learning_rate=DP_LR, seed=SEED,
        snapshot_dir=None, progress_interval=0))
    ds = ShardedDeviceDataset(x, y, 200, batch_size=DP_BATCH, mesh=mesh)
    b0 = HOST_STAGING["bytes"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(create_train_state(model, opt), ds)
    wall = time.perf_counter() - t0
    torch.save(host_named(model), os.path.join(directory,
                                                f"dpres{rank}.pt"))
    out = {"rank": rank, "epoch_s": wall, "steps": ds.steps_per_epoch,
           "train_loss": trainer.history[0]["train_loss"],
           "staged_bytes_per_step":
               (HOST_STAGING["bytes"] - b0) / ds.steps_per_epoch,
           "local_samples": ds.local_samples}

    set_precision("fp64")
    try:
        model = from_jax(cfg, params, state, device="cuda").double()
        start = host_named(model)
        opt = SGD(DPR_F64_LR)
        epoch = make_resident_epoch_dp(
            model, get_loss("softmax_crossentropy"), opt, num_classes=200,
            batch_size=DP_BATCH, mesh=mesh)
        xs, ys = stage_sharded(x, y, mesh, global_shuffle_seed=None)
        orders = dpr_orders(xs.shape[0], DP_BATCH // 2, 2)
        _, loss = epoch(create_train_state(model, opt), xs, ys, SEED,
                        DPR_F64_LR, order=orders[rank])
        out["loss64"] = float(loss)
        if rank == 0:
            want, want_loss = dpr_by_hand(setup, orders, 2)
            rel, name = dpr_f64_rel(host_named(model), want, start, model)
            loss_rel = abs(float(loss) - want_loss) / abs(want_loss)
            out["f64"] = {"worst": rel, "at": name, "loss_rel": loss_rel}
            if not (rel <= DPR_F64_TOL and loss_rel <= DPR_F64_TOL):
                fail(f"dp resident (b): the fp64 DP step differs from the "
                     f"per-shard gradients averaged by hand: {rel:.3e} at "
                     f"{name}, loss {loss_rel:.3e} (gate {DPR_F64_TOL:g})")
    finally:
        set_precision("parity")
    return out


def seq_peer_main(argv) -> None:
    """``python chip_smoke.py --seq-peer RANK --store PORT --dir DIR``: one
    rank of a gloo world of 2 on the card (the store on rank 0's PORT):
    phase 25 (``seq_paths`` over a ``"seq"`` axis of 2, bf16 and fp32;
    prints
    ``{"seq": ...}``), then phase 26 (b) (``dp_resident_world2`` over a
    ``"data"`` axis of 2; prints ``{"dp_resident": ...}``), then phase 28
    (b) (``spatial_world2`` over a (data 1, sp 2) mesh; prints
    ``{"spatial": ...}``)."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --seq-peer")
    ap.add_argument("rank", type=int)
    ap.add_argument("--store", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    from dcnn_tpu_torch.core import set_precision
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.parallel import multihost

    set_precision("parity")
    _kernels.build()  # the libraries the parent built, from the build dir
    deterministic_cudnn()
    # the parent's own phases run first: wait for its word, so that the
    # two workloads never share the card
    print(json.dumps({"ready": args.rank}), flush=True)
    if sys.stdin.readline().strip() != "go":
        fail("sequence peer: the parent closed its pipe without a go")
    multihost.initialize(f"127.0.0.1:{args.store}", 2, args.rank,
                         backend="gloo", timeout_s=300)
    seq = seq_paths(make_mesh((2,), ("seq",)), ("bfloat16", "float32"),
                    f"sequence parallel (b) rank {args.rank}")
    print(json.dumps({"seq": {"rank": args.rank, **seq}}), flush=True)
    dpr = dp_resident_world2(make_mesh((2,), ("data",)), args.rank,
                             args.dir)
    print(json.dumps({"dp_resident": dpr}), flush=True)
    sp = spatial_world2(make_mesh((1, 2), ("data", "sp")), args.rank,
                        args.dir)
    print(json.dumps({"spatial": sp}), flush=True)
    multihost.barrier("seq peer done", timeout_ms=300_000)
    multihost.shutdown()


def phase_seq_peers(card, directory, peers, seq_a):
    """Phases 25, 26 (b) and 28 (b) from the two peer processes (28 (b)'s
    lines returned for ``check_spatial_world2``): the sequence
    paths at world 2 (each rank's launches per call: causal ring r+1,
    ring 2, zigzag 5, Ulysses 1), and the DP resident epoch at world 2:
    the ranks' params and buffers bit for bit equal after the fp32 epoch,
    the fp64 step within DPR_F64_TOL of the hand one (rank 0). Returns
    both results."""
    import numpy as np
    import torch

    def each(key):
        """Both peers' ``key`` values; fails as soon as one ends without."""
        return [p.wait_for(key, 300, partners=peers)[key] for p in peers]

    try:
        each("ready")
        for p in peers:
            p.proc.stdin.write("go\n")
            p.proc.stdin.flush()
        seqs = each("seq")
        dprs = each("dp_resident")
        sps = each("spatial")
        for p in peers:
            p.finish(timeout=120)
    finally:
        for p in peers:
            p.close()
    got = [torch.load(os.path.join(directory, f"dpres{r}.pt"),
                      weights_only=False) for r in (0, 1)]
    bad = [n for n in got[0] if not np.array_equal(got[0][n], got[1][n])]
    if bad:
        fail(f"dp resident (b): the ranks differ after the epoch in "
             f"{len(bad)} tensors ({bad[:4]})")
    if "f64" not in dprs[0]:
        fail("dp resident (b): rank 0 printed no fp64 check")
    b, h, s, d = SEQ_SHAPE
    for r, res in enumerate(seqs):
        print(f"sequence parallel (b): world 2 over gloo (two processes on "
              f"one card: a protocol's cost, not scaling), rank {r}, B{b} "
              f"H{h} S{s} D{d}, held to the whole sequence (bf16 "
              f"{SEQ_TOL['bfloat16']:g}, fp32 {SEQ_TOL['float32']:g} of each "
              f"tensor's largest); bf16: {seq_text(res, 'bfloat16')}; fp32: "
              f"{seq_text(res, 'float32')}; whole-"
              f"sequence flash fwd+bwd {seq_a['whole_flash_ms']['full']:.3f}"
              f" ms, causal {seq_a['whole_flash_ms']['causal']:.3f} ms "
              f"(phase 24); on {card}", flush=True)
    f64 = dprs[0]["f64"]
    print(f"dp resident (b): world 2 over gloo, Trainer.fit over a "
          f"ShardedDeviceDataset (resnet18_tiny_imagenet NCHW, AdamW, "
          f"global B={DP_BATCH}, {dprs[0]['steps']} steps): the ranks' "
          f"params and buffers bit for bit equal; epoch "
          f"{dprs[0]['epoch_s']:.2f} s / {dprs[1]['epoch_s']:.2f} s, "
          f"{dprs[0]['staged_bytes_per_step']:.0f} B staged through the "
          f"host a step; fp64 one SGD step vs the per-shard gradients "
          f"averaged by hand: {f64['worst']:.3e} at {f64['at']}, loss "
          f"{f64['loss_rel']:.3e} (gate {DPR_F64_TOL:g}); on {card}",
          flush=True)
    return seqs, dprs, sps


def phase_dp_feed(card):
    """Phases 26 (a) and 27, world 1 over NCCL in this process, cuDNN
    deterministic. (a) The DP resident epoch (``make_resident_epoch_dp``)
    on the data-parallel phase's setup (full-width NCHW ResNet-18, AdamW,
    256 uint8 rows, B=32, 8 steps) given one order, bit for bit the
    single-device resident epoch given it (losses, params, buffers), its
    steps replayed as CUDA graphs; then ``Trainer.fit`` over a
    ``ShardedDeviceDataset`` (2 epochs, finite losses, graphs replayed);
    ``PrefetchLoader(sharding=mesh)`` yields ``shard_batch``'s batches bit
    for bit. 27: the compiled pipeline's ``data_axis="data"`` step on a
    ``SequentialStageStack`` of 4 GroupNorm residual blocks at ResNet-18's
    layer1 (64x32x32), M=8, B=32: eager and replayed (the all-reduce in
    the graph), bit for bit the step without a data axis."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.data import (
        ArrayDataLoader, PrefetchLoader, ShardedDeviceDataset,
        make_resident_epoch, make_resident_epoch_dp, resident_epoch_dp,
        stage_sharded)
    from dcnn_tpu_torch.data.transfer import stage_array
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.nn import Conv2DLayer, GroupNormLayer, ResidualBlock
    from dcnn_tpu_torch.ops.losses import get_loss
    from dcnn_tpu_torch.optim import SGD, AdamW
    from dcnn_tpu_torch.parallel import (
        SequentialStageStack, make_compiled_pipeline_train_step, multihost,
        shard_batch)
    from dcnn_tpu_torch.train import Trainer, create_train_state

    deterministic_cudnn()
    setup = dp_setup()
    cfg, params, state, x, y = setup
    ce = get_loss("softmax_crossentropy")
    order = np.random.default_rng(SEED + 22).permutation(len(x)).reshape(
        -1, DP_BATCH)
    out = {}
    multihost.initialize(num_processes=1, backend="nccl")
    try:
        mesh = make_mesh()
        runs = {}
        for kind in ("single", "dp"):
            model = from_jax(cfg, params, state, device="cuda")
            opt = AdamW(DP_LR, weight_decay=1e-4)
            if kind == "single":
                epoch = make_resident_epoch(model, ce, opt, num_classes=200,
                                            batch_size=DP_BATCH)
                xs = stage_array(x, torch.device("cuda"))
                ys = stage_array(y.argmax(-1).astype(np.int32),
                                 torch.device("cuda"))
            else:
                epoch = make_resident_epoch_dp(model, ce, opt,
                                               num_classes=200,
                                               batch_size=DP_BATCH, mesh=mesh)
                xs, ys = stage_sharded(x, y, mesh, global_shuffle_seed=None)
            ts = create_train_state(model, opt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss = epoch(ts, xs, ys, SEED, DP_LR, order=order)
            lv = float(loss)
            runs[kind] = (lv, host_named(model),
                          (time.perf_counter() - t0) * 1e3 / len(order),
                          epoch.body._sessions.latest())
        (l1, n1, ms1, _), (l2, n2, ms2, sess) = runs["single"], runs["dp"]
        bad = [n for n in n1 if not np.array_equal(n1[n], n2[n])]
        if l1 != l2 or bad:
            fail(f"dp resident (a): the DP epoch at world 1 differs from the "
                 f"single-device resident epoch: loss {l2} vs {l1}, "
                 f"{len(bad)} tensors ({bad[:4]})")
        if sess is None or sess.graph is None:
            fail("dp resident (a): the NCCL world-1 epoch replayed no graph")

        model = from_jax(cfg, params, state, device="cuda")
        opt = AdamW(DP_LR, weight_decay=1e-4)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=2, batch_size=DP_BATCH, learning_rate=DP_LR, seed=SEED,
            snapshot_dir=None, progress_interval=0))
        ds = ShardedDeviceDataset(x, y, 200, batch_size=DP_BATCH, mesh=mesh)
        trainer.fit(create_train_state(model, opt), ds)
        fit_losses = [h_["train_loss"] for h_ in trainer.history]
        fit_sess = resident_epoch_dp(model, trainer.loss_fn, opt,
                                     ds).body._sessions.latest()
        if not all(np.isfinite(fit_losses)) or fit_sess is None \
                or fit_sess.graph is None:
            fail(f"dp resident (a): Trainer.fit over a ShardedDeviceDataset: "
                 f"losses {fit_losses}, graph replayed "
                 f"{fit_sess is not None}")

        loader = ArrayDataLoader(x[:128], y[:128], batch_size=DP_BATCH,
                                 shuffle=False)
        loader.load_data()
        plain = [shard_batch(b, mesh) for b in PrefetchLoader(loader)]
        sharded = list(PrefetchLoader(loader, sharding=mesh))
        if len(plain) != len(sharded) or not all(
                torch.equal(a, b) for pa, pb in zip(plain, sharded)
                for a, b in zip(pa, pb)):
            fail("dp resident (a): PrefetchLoader(sharding=mesh) batches "
                 "differ from shard_batch's")
        out["resident"] = {"bit_equal": True, "loss": l1,
                           "step_ms_single": ms1, "step_ms_dp": ms2,
                           "fit_losses": fit_losses,
                           "graph_launches": sess.launch_names(),
                           "prefetch_batches": len(sharded)}
        print(f"dp resident (a): world 1 over NCCL, resnet18_tiny_imagenet "
              f"NCHW B={DP_BATCH}, {len(order)} steps: the DP resident epoch "
              f"bit for bit the single-device one given the same order "
              f"(loss {l1}); host wall a step, the first two (warm-up, "
              f"capture) included: single {ms1:.2f} ms, DP {ms2:.2f} ms; "
              f"Trainer.fit over a ShardedDeviceDataset, 2 epochs: losses "
              f"{fit_losses}, replayed; PrefetchLoader(sharding=mesh): "
              f"{len(sharded)} batches bit for bit shard_batch's; on {card}",
              flush=True)

        def stack_run(jit, data_axis):
            block = ResidualBlock(
                layers=[Conv2DLayer(STACK_SHAPE[0], 3, 1, 1),
                        GroupNormLayer(8)], activation="relu")
            stack = SequentialStageStack(block, STACK_STAGES, STACK_SHAPE)
            sp = stack.init(torch.Generator().manual_seed(SEED),
                            device="cuda")
            opt = SGD(PIPE_LR)
            ost = opt.init(sp)
            step = make_compiled_pipeline_train_step(
                stack.stage_fn, lambda a, b: ((a - b) ** 2).mean(), opt,
                STACK_STAGES, STACK_M, jit=jit, mesh=mesh,
                data_axis=data_axis)
            rng = np.random.default_rng(SEED + 24)
            shape = (STACK_M, STACK_BATCH // STACK_M, *STACK_SHAPE)
            xs = torch.from_numpy(rng.normal(size=shape)
                                  .astype(np.float32)).cuda()
            ys = torch.from_numpy(rng.normal(size=shape)
                                  .astype(np.float32)).cuda()
            walls, losses = [], []
            for _ in range(STACK_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(sp, ost, xs, ys, PIPE_LR)[2]))
                walls.append((time.perf_counter() - t0) * 1e3)
            return (losses, {n: t.detach().cpu().numpy()
                             for n, t in sp.items()}, step, walls)

        ref = stack_run(False, None)
        stack = {}
        for jit in (False, True):
            for dax in ((None, "data") if jit else ("data",)):
                tag = f"{'replayed' if jit else 'eager'} data_axis={dax}"
                losses, named, step, walls = stack_run(jit, dax)
                if losses != ref[0] or any(
                        not np.array_equal(named[n], ref[1][n])
                        for n in named):
                    fail(f"compiled pipeline data axis: {tag} differs from "
                         f"the eager step without a data axis: {losses} vs "
                         f"{ref[0]}")
                if jit and step.compiled.session() is None:
                    fail(f"compiled pipeline data axis: {tag} captured no "
                         f"graph")
                stack[tag] = walls[-1]
        out["pipeline_data_axis"] = {"bit_equal": sorted(stack),
                                     "losses": ref[0], "last_step_ms": stack}
        print(f"compiled pipeline data axis: SequentialStageStack "
              f"({STACK_STAGES} GroupNorm residual blocks, "
              f"{'x'.join(map(str, STACK_SHAPE))},"
              f" M={STACK_M}, B={STACK_BATCH}) with data_axis='data' over "
              f"NCCL world 1, eager and replayed (the all-reduce in the "
              f"graph): {STACK_STEPS} steps bit for bit the step without a "
              f"data axis, losses {ref[0]}; last step ms {json.dumps(stack)}"
              f"; on {card}", flush=True)
    finally:
        multihost.shutdown()
    return out


# spatial (dim-2) sharding of the mesh step: (a) world 1 over NCCL here,
# (b) world 2 over gloo in the sequence peers. (b)'s fp64 step is the check
# of the numbers: its loss, gradients and BN statistics within SP_F64_TOL
# of each tensor's largest |value| of the single-process fp64 step (a conv
# bias that feeds a BN, whose gradient is zero in exact arithmetic, of the
# model's largest), which a wrong 1/S, a halo row off by one or a statistic
# over the wrong group misses by orders of magnitude. Its fp32 steps get
# the data-parallel phase's sanity bounds (DP_LOSS_RTOL, Adam's step
# bound, DP_STATS_RTOL), not a correctness gate: fp32 ResNet-18 gradients
# are ill-conditioned at this initialisation (see DP_F64_TOL).
SP_TIMED = 6              # more eager world-2 steps, timed
SP_F64_TOL = 1e-10
# the trainer's telemetry plane: full-width ResNet-18 through Trainer.fit
# over a PrefetchLoader fed by 2 feed workers (threads, so that the
# process's FaultPlan reaches them), plane off (3 epochs) and on (5
# epochs: the tracer on, /metrics /healthz /snapshot /goodput scraped in
# epoch 2, the loader paused in epoch 4, feed.slow_worker armed for epoch
# 5). B=128 (a ~50 ms step), so
# that the host's jitter (a GC pass, the sampler's GIL) stays well inside
# the anomaly band's 50% floor; the slow workers' 0.5 s a shard then make
# the feed ~80% of the wall. The goodput window and the sampler's cadence
# are shortened (the JAX package's env knobs) so that an epoch spans
# several windows, a pass every quarter window. The episode starts from
# healthy: from compute-bound, the window's open tail (a slow shard's
# spans land only when it is done) can hold the verdict between the two
# states for the 2 passes the dwell confirms, a flip of its own. The pause
# (the loader yields nothing: unattributed time) flips compute-bound to
# healthy, and its capture closes on the fast steps after it, before the
# arming; from healthy the slow feed has one flip to make.
TELEM_BATCH = 128
TELEM_STEPS = 32          # steps an epoch
TELEM_WINDOW_S = "2.0"    # DCNN_GOODPUT_WINDOW
TELEM_INTERVAL_S = "0.5"  # DCNN_TSDB_INTERVAL
TELEM_SLOW_S = 0.5        # a feed worker's extra seconds a shard, armed
TELEM_PAUSE_MAX_S = 20.0  # the pause's limit: the verdict healthy by then


def phase_spatial(card):
    """Phase 28 (a): ``make_data_parallel_train_step(spatial_axis="sp")``
    over a (data 1, sp 1) mesh in a world of 1 over NCCL, on phase 21's
    full-width ``resnet18_tiny_imagenet`` setup (NCHW, B=32, AdamW, cuDNN
    deterministic): eager and replayed (one CUDA graph), each bit for bit
    the mesh step without ``spatial_axis`` over ``DP_STEPS`` steps; then
    the single process's peak memory of ``make_train_step`` at B=32
    (above what was allocated before it), the reference of (b)'s."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost

    deterministic_cudnn()
    setup = dp_setup()
    multihost.initialize(num_processes=1, backend="nccl")
    try:
        mesh = make_mesh((1, 1), ("data", "sp"))
        runs = {k: dp_run(k, setup, mesh, timed=DP_TIMED if k == "sp" else 0)
                for k in ("dp", "sp_eager", "sp")}
    finally:
        multihost.shutdown()
    ref = runs["dp"]
    for k in ("sp_eager", "sp"):
        r = runs[k]
        bad = [n for n in ref["final"]
               if not np.array_equal(r["final"][n], ref["final"][n])]
        if r["losses"] != ref["losses"] or bad:
            fail(f"spatial (a): world 1 {k} differs from the mesh step "
                 f"without spatial_axis: losses {r['losses']} vs "
                 f"{ref['losses']}, {len(bad)} tensors ({bad[:4]})")
    sessions = runs["sp"]["step"]._sessions.latest()
    if not sessions or sessions[0].graph is None:
        fail("spatial (a): the NCCL world-1 spatial step never replayed a "
             "graph")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain = dp_run("plain", setup, steps=2)
    peak = torch.cuda.max_memory_allocated() - base
    warm = runs["sp"]["walls_ms"][DP_STEPS:]
    out = {"bit_equal": ["sp_eager", "sp"], "losses": ref["losses"],
           "graph_launches": sessions[0].launch_names(),
           "step_ms_median": median(warm),
           "eager_step_ms_median": median(runs["sp_eager"]["walls_ms"][1:]),
           "single_process_peak_bytes": peak,
           "single_process_step_ms_median": median(plain["walls_ms"][1:])}
    print(f"spatial (a): resnet18_tiny_imagenet NCHW B={DP_BATCH}, mesh "
          f"(data 1, sp 1) over NCCL: eager and replayed spatial steps bit "
          f"for bit the mesh step without spatial_axis over {DP_STEPS} "
          f"steps, one graph; replayed {median(warm):.2f} ms median, eager "
          f"{out['eager_step_ms_median']:.2f} ms; one process's eager step "
          f"peaks {peak / 2**20:.0f} MiB above its start; on {card}",
          flush=True)
    return out


def spatial_world2(mesh, rank, directory):
    """Phase 28 (b), in a peer: the spatial mesh step over a (data 1, sp
    2) mesh of the gloo world of 2 on the card (H of 64 rows, 32 a rank),
    phase 21's setup: one fp64 AdamW step, then ``DP_STEPS + SP_TIMED``
    fp32 steps, timed, this rank's peak memory above its start and the
    halo and host-staged bytes a step; the runs to ``DIR/sp<RANK>.pt`` for
    the parent to compare."""
    import torch

    from dcnn_tpu_torch.parallel.data_parallel import HALO, HOST_STAGING

    setup = dp_setup()
    run64 = dp_run("sp_eager", setup, mesh, steps=1, dtype=torch.float64)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h0, s0 = HALO["bytes"], HOST_STAGING["bytes"]
    run = dp_run("sp_eager", setup, mesh, timed=SP_TIMED)
    steps = DP_STEPS + SP_TIMED
    peak = torch.cuda.max_memory_allocated() - base
    torch.save({"losses": run["losses"], "final": run["final"],
                "grads": run["grads"], "loss64": run64["losses"][0],
                "grads64": run64["grads"], "final64": run64["final"]},
               os.path.join(directory, f"sp{rank}.pt"))
    return {"rank": rank, "walls_ms": run["walls_ms"],
            "halo_bytes_per_step": (HALO["bytes"] - h0) / steps,
            "staged_bytes_per_step": (HOST_STAGING["bytes"] - s0) / steps,
            "peak_bytes": peak}


def check_spatial_world2(card, directory, sps, dp_ref, sp_a):
    """Phase 28 (b) in the parent: the two ranks' params and buffers bit
    for bit equal; the fp64 step's loss, gradients and BN statistics held
    to phase 21's single-process fp64 step within ``SP_F64_TOL``; the
    fp32 steps to its fp32 run at the sanity bounds; the step wall, the
    halo and staged bytes a step and each rank's peak memory printed
    beside the single process's (phase 28 (a))."""
    import numpy as np
    import torch

    got = [torch.load(os.path.join(directory, f"sp{r}.pt"),
                      weights_only=False) for r in (0, 1)]
    for k in ("final", "final64"):
        bad = [n for n in got[0][k]
               if not np.array_equal(got[0][k][n], got[1][k][n])]
        if bad:
            fail(f"spatial (b): the ranks differ in {k} ({bad[:4]})")
    zero = bias_before_bn(dp_ref["step"].model)
    names = set(dp_ref["grads"])

    def rels(a, b, scale_zero):
        top = max(float(np.abs(v).max()) for v in b.values())
        return sorted(((float(np.abs(a[n] - b[n]).max())
                        / (top if n in scale_zero
                           else float(np.abs(b[n]).max()) or 1.0), n)
                       for n in b), reverse=True)

    g64 = rels(got[0]["grads64"], dp_ref["grads64"], zero)
    _p64, b64_got = split_named(names, got[0]["final64"])
    _p64r, b64_ref = split_named(names, dp_ref["final64"])
    s64 = rels(b64_got, b64_ref, ())
    loss64 = abs(got[0]["loss64"] - dp_ref["loss64"]) / abs(dp_ref["loss64"])
    worst64 = max(g64[0][0], s64[0][0], loss64)
    if worst64 > SP_F64_TOL:
        fail(f"spatial (b): the fp64 step at sp 2 vs one process: loss "
             f"{loss64:.3e}, gradients {g64[:4]}, BN statistics {s64[:4]} "
             f"(tol {SP_F64_TOL:g} of each tensor's largest)")
    rel_loss = max(abs(a - b) / abs(b) for a, b in
                   zip(got[0]["losses"], dp_ref["losses"]))
    if rel_loss > DP_LOSS_RTOL:
        fail(f"spatial (b): fp32 losses {got[0]['losses']} vs "
             f"{dp_ref['losses']} (rel {rel_loss:.3e} > {DP_LOSS_RTOL})")
    p_got, b_got = split_named(names, got[0]["final"])
    p_ref, b_ref = split_named(names, dp_ref["final"])
    bound = 2 * DP_STEPS * DP_LR * 0.1 / math.sqrt(1 - 0.999)
    worst, noise, _n_noise, _n_all, _bins, bound = adam_param_diff(
        p_got, p_ref, dp_ref["v"], DP_STEPS, DP_LR, 0.9, 0.999,
        "spatial (b)", atol=bound)
    bn_rel = stats_rel(b_got, b_ref)
    if bn_rel > DP_STATS_RTOL:
        fail(f"spatial (b): fp32 BN statistics differ by {bn_rel:.3e} of "
             f"their scale (> {DP_STATS_RTOL})")
    walls = [median(s["walls_ms"][1:]) for s in sps]
    out = {"fp64_loss_rel": loss64, "fp64_grad_rel": g64[0],
           "fp64_bn_stats_rel": s64[0], "fp32_loss_rel": rel_loss,
           "fp32_param_max_diff": worst, "fp32_param_noise_max_diff": noise,
           "adam_step_bound": bound, "fp32_bn_stats_rel": bn_rel,
           "step_ms_median": walls,
           "halo_bytes_per_step": [s["halo_bytes_per_step"] for s in sps],
           "staged_bytes_per_step": [s["staged_bytes_per_step"]
                                     for s in sps],
           "peak_bytes": [s["peak_bytes"] for s in sps],
           "single_process_peak_bytes": sp_a["single_process_peak_bytes"],
           "single_process_step_ms_median":
               sp_a["single_process_step_ms_median"]}
    mib = [b / 2**20 for b in out["peak_bytes"]]
    print(f"spatial (b): resnet18_tiny_imagenet NCHW B={DP_BATCH}, mesh "
          f"(data 1, sp 2) over gloo (two processes on one card: the "
          f"protocol's cost, not scaling), H 64 -> 32 rows a rank: the fp64 "
          f"step within {worst64:.2e} of one process's (loss {loss64:.2e}, "
          f"gradients {g64[0][0]:.2e} at {g64[0][1]}, BN statistics "
          f"{s64[0][0]:.2e}; gate {SP_F64_TOL:g}); fp32 losses within "
          f"{rel_loss:.2e}, params {worst:.2e} (Adam bound {bound:.2e}), BN "
          f"statistics {bn_rel:.2e}; eager step {walls[0]:.1f} / "
          f"{walls[1]:.1f} ms median (one process "
          f"{out['single_process_step_ms_median']:.1f} ms); "
          f"halo {out['halo_bytes_per_step'][0]:.0f} / "
          f"{out['halo_bytes_per_step'][1]:.0f} B sent a step, "
          f"{out['staged_bytes_per_step'][0]:.0f} B staged through the host "
          f"a step (rank 0); peak memory above start {mib[0]:.0f} / "
          f"{mib[1]:.0f} MiB a rank vs "
          f"{sp_a['single_process_peak_bytes'] / 2**20:.0f} MiB for one "
          f"process; on {card}", flush=True)
    return out


def phase_telemetry(card):
    """Phase 29: the trainer's telemetry plane on full-width
    ``resnet18_tiny_imagenet`` (NCHW, B=128, AdamW, synthetic uint8 rows)
    through ``Trainer.fit`` over a ``PrefetchLoader`` fed by 2 feed
    workers. First one ``try_trace`` capture of two steps alone, its start
    and its stop and export timed.
    Then the fit with the plane off (3 epochs), then on
    (``metrics_port=0``, the tracer on, 5 epochs): ``/metrics``,
    ``/healthz``, ``/snapshot`` and ``/goodput`` scraped mid-epoch 2 (from
    the loader, between two steps: an event, not a sleep), the window's
    buckets and unattributed residue summing to its wall; mid-epoch 4 the
    loader pauses until the verdict reads healthy (no capture open when
    it starts), and that flip's capture closes on the epoch's remaining
    steps; ``FaultPlan.slow("feed.slow_worker")`` armed for epoch 5 from
    healthy, no capture open: the verdict flips to feed-bound (scraped
    once it has) and the episode writes exactly one flight bundle and one
    profiler capture (the flight recorder's per-trigger cooldown set to 0
    for the phase, so that the count is the anomaly monitor's own).
    Samples/s of the faster of epochs 2-3 with the plane on and off; no
    speed gate."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import (ArrayDataLoader, FeedWorkerPool,
                                     PrefetchLoader)
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.obs import configure, configure_flight
    from dcnn_tpu_torch.optim import AdamW
    from dcnn_tpu_torch.resilience import faults
    from dcnn_tpu_torch.train import Trainer, create_train_state
    from dcnn_tpu_torch.train.profiling import try_trace

    cfg, params, state, _x, _y = dp_setup()
    rng = np.random.default_rng(SEED + 22)
    n = TELEM_STEPS * TELEM_BATCH
    x = rng.integers(0, 256, (n, 3, 64, 64), dtype=np.uint8)
    y = np.eye(200, dtype=np.float32)[rng.integers(0, 200, n)]
    d = tempfile.mkdtemp(prefix="dcnn_telemetry_")
    flight_dir, prof_dir = os.path.join(d, "flight"), os.path.join(d, "prof")
    os.makedirs(prof_dir)

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()

    def summed(doc):
        led = doc["ledger"]
        total = sum(led["buckets"].values()) + led["unattributed_s"]
        if not abs(total - led["wall_s"]) <= 1e-9 * max(led["wall_s"], 1e-9):
            fail(f"telemetry: the goodput buckets sum to {total} s, the "
                 f"window's wall is {led['wall_s']} s ({led})")
        return led

    class Driven(PrefetchLoader):
        """The fit's loader: in epoch 2 (plane on) it scrapes the four
        endpoints between two steps; in epoch 4 it pauses until the
        verdict reads healthy; at epoch 5 it arms the slow feed and
        scrapes ``/goodput`` once the verdict has flipped."""

        def __init__(self, *a, trainer_ref=None, **kw):
            super().__init__(*a, **kw)
            self.epoch, self.trainer_ref, self.seen = 0, trainer_ref, {}

        def pause(self, tr):
            # no step, no span: the window fills with unattributed time
            # until compute falls out of its band and the dwell confirms
            clf, t = tr._goodput.classifier, time.perf_counter()
            state = clf.state
            while clf.state != "healthy" \
                    and time.perf_counter() - t < TELEM_PAUSE_MAX_S:
                time.sleep(0.05)
            self.seen["pause"] = {"from": state, "to": clf.state,
                                  "seconds": time.perf_counter() - t}

        def __iter__(self):
            self.epoch += 1
            tr = self.trainer_ref[0] if self.trainer_ref else None
            if tr is not None and self.epoch == 5:
                self.seen["before"] = (
                    sorted(os.listdir(flight_dir))
                    if os.path.isdir(flight_dir) else [],
                    sorted(os.listdir(prof_dir)))
                self.seen["at_arming"] = {
                    "state": tr._goodput.classifier.state,
                    "quiet": tr._goodput.anomaly.quiet_for(0.0)}
                faults.install(faults.FaultPlan().slow(
                    "feed.slow_worker", delay_s=TELEM_SLOW_S))
                self.seen["armed_at"] = time.perf_counter()
            for i, b in enumerate(super().__iter__()):
                if tr is not None and self.epoch == 2 \
                        and i == TELEM_STEPS // 2:
                    url = tr.telemetry.url
                    self.seen["scrape"] = {
                        e: get(url + e) for e in ("/metrics", "/healthz",
                                                  "/snapshot", "/goodput")}
                # the pause once no capture is open: its flip's capture
                # then closes on this epoch's remaining steps
                if tr is not None and self.epoch == 4 \
                        and i >= TELEM_STEPS // 2 \
                        and "pause" not in self.seen \
                        and tr._goodput.anomaly.quiet_for(0.0):
                    self.pause(tr)
                if tr is not None and self.epoch == 5 \
                        and "flipped" not in self.seen \
                        and tr._goodput.classifier.state == "feed_bound":
                    self.seen["flipped"] = (
                        time.perf_counter() - self.seen["armed_at"],
                        json.loads(get(tr.telemetry.url + "/goodput")[1]))
                yield b

    def fit(plane):
        model = from_jax(cfg, params, state, device="cuda")
        opt = AdamW(DP_LR, weight_decay=1e-4)
        ref = []
        pool = FeedWorkerPool(x, y, TELEM_BATCH, num_workers=2,
                              backend="thread", seed=SEED)
        loader = Driven(ArrayDataLoader(x, y, batch_size=TELEM_BATCH,
                                        seed=SEED),
                        depth=2, feed_workers=2, worker_pool=pool,
                        trainer_ref=ref if plane else None)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=5 if plane else 3, batch_size=TELEM_BATCH,
            learning_rate=DP_LR, seed=SEED, snapshot_dir=None,
            progress_interval=0, feed_workers=2,
            metrics_port=0 if plane else -1))
        ref.append(trainer)
        try:
            trainer.fit(create_train_state(model, opt), loader)
        finally:
            faults.clear()
            pool.close()
        return trainer, loader.seen

    # one capture alone, around two replayed train steps: its start (in a
    # fresh process CUPTI's set-up; in the whole script the train cnn
    # phase has profiled already), then its stop and trace export
    model = from_jax(cfg, params, state, device="cuda")
    opt = AdamW(DP_LR, weight_decay=1e-4)
    cold = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
        epochs=1, batch_size=TELEM_BATCH, snapshot_dir=None,
        progress_interval=0))
    ts0 = create_train_state(model, opt)
    xb = torch.from_numpy(x[:TELEM_BATCH]).cuda().float() / 255.0
    yb = torch.from_numpy(y[:TELEM_BATCH]).cuda()
    for _ in range(2):  # eager, then captured: the replayed step profiled
        cold.train_step(ts0, xb, yb, DP_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cm = try_trace(os.path.join(d, "cold"))
    cm.__enter__()
    t1 = time.perf_counter()
    for _ in range(2):
        float(cold.train_step(ts0, xb, yb, DP_LR)[0])
    t2 = time.perf_counter()
    cm.__exit__(None, None, None)
    capture_s = {"start": t1 - t0, "two_steps": t2 - t1,
                 "stop_and_export": time.perf_counter() - t2}
    del cold, model, ts0

    off, _ = fit(False)
    env = {"DCNN_GOODPUT_WINDOW": TELEM_WINDOW_S,
           "DCNN_TSDB_INTERVAL": TELEM_INTERVAL_S,
           "DCNN_ANOMALY_XPROF": prof_dir}
    saved_env = {k: os.environ.get(k) for k in env}
    rec = configure_flight(flight_dir)
    cooldown = rec.min_interval_s
    rec.min_interval_s = 0.0
    os.environ.update(env)
    tracer = configure(enabled=True)
    tracer.clear()  # the windows read this fit's spans alone
    try:
        on, seen = fit(True)
    finally:
        configure(enabled=False)
        tracer.clear()
        rec.min_interval_s = cooldown
        rec.directory = None
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if on.telemetry is not None:
        fail("telemetry: the server outlived fit()")
    scrape = seen.get("scrape")
    if not scrape or any(code != 200 for code, _ in scrape.values()):
        codes = scrape and {e: c for e, (c, _) in scrape.items()}
        fail(f"telemetry: mid-fit scrape {codes}")
    health = json.loads(scrape["/healthz"][1])
    if health["status"] != "ok" or "alerts" not in health["checks"]:
        fail(f"telemetry: /healthz {health}")
    if b"goodput_fraction" not in scrape["/metrics"][1]:
        fail("telemetry: /metrics carries no goodput_fraction")
    mid = summed(json.loads(scrape["/goodput"][1]))
    if seen.get("at_arming") != {"state": "healthy", "quiet": True}:
        fail(f"telemetry: the slow feed was armed at {seen.get('at_arming')}"
             f" (the pause: {seen.get('pause')}), not from healthy with no "
             f"capture open")
    if "flipped" not in seen:
        fail("telemetry: the verdict never flipped to feed_bound under the "
             "slow feed workers")
    flip_s, flip_doc = seen["flipped"]
    slow = summed(flip_doc)
    before_b, before_p = seen["before"]
    bundles = [b for b in sorted(os.listdir(flight_dir))
               if b not in before_b and not b.startswith("tmp-")]
    profiles = [p for p in sorted(os.listdir(prof_dir)) if p not in before_p]
    reasons = []
    for b in bundles:
        with open(os.path.join(flight_dir, b, "extra.json")) as f:
            reasons.append(json.load(f).get("detail"))
    if len(bundles) != 1 or len(profiles) != 1 or not os.path.isfile(
            os.path.join(prof_dir, profiles[0], "trace.json")):
        fail(f"telemetry: the slow-feed episode wrote {len(bundles)} flight "
             f"bundles ({reasons}) and {len(profiles)} profiler captures "
             f"({profiles}); one of each expected")
    if not str(reasons[0].get("transition", "")).endswith("->feed_bound"):
        fail(f"telemetry: the episode's bundle is {reasons[0]}, not the "
             f"flip to feed_bound")
    rows = TELEM_STEPS * TELEM_BATCH
    sps = {"off": max(rows / h["seconds"] for h in off.history[1:3]),
           "on": max(rows / h["seconds"] for h in on.history[1:3]),
           "slow_epoch": rows / on.history[4]["seconds"]}
    out = {"samples_per_s": sps, "mid_epoch_window": mid,
           "flip_after_s": flip_s, "slow_window": slow,
           "bundle": reasons[0], "profile": profiles[0],
           "pause": seen["pause"], "captures_before_arming": len(before_b),
           "first_capture_s": capture_s}
    print(f"telemetry: resnet18_tiny_imagenet NCHW B={TELEM_BATCH} through "
          f"Trainer.fit over PrefetchLoader(feed_workers=2): /metrics "
          f"/healthz /snapshot /goodput answered mid-fit; window "
          f"{mid['wall_s']:.2f} s = buckets + unattributed (goodput "
          f"{mid['goodput_fraction']:.3f}, verdict {mid['verdict']}, "
          f"mfu_live {mid['mfu_live']}); a pause of "
          f"{seen['pause']['seconds']:.2f} s took the verdict from "
          f"{seen['pause']['from']} to healthy; feed.slow_worker "
          f"({TELEM_SLOW_S} s a shard) armed for epoch 5: feed_bound "
          f"{flip_s:.2f} s later (feed_stall "
          f"{slow['buckets']['feed_stall']:.2f} of {slow['wall_s']:.2f} s), "
          f"1 flight bundle ({reasons[0]}) and 1 profiler capture "
          f"({len(before_b)} captures before arming); samples/s plane off "
          f"{sps['off']:.0f}, on {sps['on']:.0f} (no gate), slow epoch "
          f"{sps['slow_epoch']:.0f}; a profiler capture alone: start "
          f"{capture_s['start']:.2f} s, two steps {capture_s['two_steps']:.3f}"
          f" s, stop and export {capture_s['stop_and_export']:.2f} s; on "
          f"{card}", flush=True)
    return out


# -- phases 30-32: the fleet plane and autoscaling -------------------------

FLEET_TARGETS = ("loc0", "loc1", "tcp0", "tcp1")
FLEET_SETTLE_S = 1.0      # traffic before a poll, and after the rejoin
AUTOSCALE_QUEUE = 256     # rows a replica queues: a stall of the shared
#                           host (an engine build, a swap, a pool's
#                           release) must not shed trough traffic
AUTOSCALE_MEASURE_S = 3.0  # one replica's sustained rate, offered flat out
AUTOSCALE_PERIOD_S = 30.0  # one diurnal day: trough, peak at 15 s, trough
AUTOSCALE_TICK_S = 0.5
AUTOSCALE_KILL_AT = 12.0  # the newest replica the autoscaler built dies
AUTOSCALE_CANARY_AT = 18.0  # v2 committed; ModelVersionManager canaries it
AUTOSCALE_TAIL_S = 30.0   # the trough after the day, for the scale-downs
AUTOSCALE_WINDOW = 512    # a replica's latency window: an overload ages out
#                           of its p99 within seconds of trough traffic
LEASE_EPOCHS = 4          # the fixed-world run's epochs; the leased run's
LEASE_SEG1_EPOCHS = 2     # first segment trains to epoch 2 at world 2 -> 1
FLAT_OUT_RPS = 1e6        # an open loop that never waits: a spike


def dispatched(replicas, engines_built, buckets):
    """Batches an engine ran on the card over ``replicas``: two calls a
    bucket at each engine's construction (the eager first call and the
    capture), each batcher's warm replays, and the served batches."""
    return (2 * buckets * engines_built + sum(r.warmups for r in replicas)
            + sum(r.metrics.snapshot()["batches"] for r in replicas))


def phase_fleet(card):
    """Phase 30: a ``FleetAggregator`` over 2 in-process ``LocalReplica``s
    of full-width ``mha_classifier`` (fp32, S=32, E=64, 4 heads; read
    through their ``TelemetryServer``s, no socket) and 2 ``ReplicaServer``
    processes (:class:`ReplicaChild` with a telemetry port, scraped over
    HTTP by ``HttpScraper``), a ``RuleEngine`` over its store (one
    ``fleet_target_up`` alert a target), behind a ``Router`` under the
    open-loop mix, the tracer on in every process. One poll merges the
    four targets into ``replica``, ``sum`` and ``max`` series; ``/fleet``,
    ``/alerts`` and ``/healthz`` answer. tcp1 is SIGKILLed: its
    ``fleet_target_up`` reads 0, the roll-up and ``/healthz`` degrade, its
    alert fires and the router records a ``replica_death`` bundle; a
    standby process rejoins as tcp1 and the alert resolves. The shards
    merge through ``python -m dcnn_tpu_torch.obs.trace merge`` into one
    Chrome trace that ``validate_chrome`` accepts, with a request's
    ``trace_id`` under two or more pids; ``inspect_bundle`` reads the
    bundle. Gates: every served result within ``SERVE_TOL`` of the CPU
    reference; the sheds of the class regime ordered low >= normal >= high
    by share (the kill's burst, while the readmitted rows stand over the
    three survivors' capacity, sheds every class alike: counted apart as
    the fleet regime); ``flash_fwd`` twice a dispatched batch here and in
    each surviving process. Prints the seconds a scrape, in process and over
    HTTP, and a poll's wall time."""
    import tempfile

    import numpy as np

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.obs import configure, get_tracer
    from dcnn_tpu_torch.obs.fleet import FleetAggregator
    from dcnn_tpu_torch.obs.flight import FlightRecorder
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.obs.rules import RuleEngine
    from dcnn_tpu_torch.obs.trace import (inspect_bundle, read_shard,
                                          validate_chrome)
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager
    from dcnn_tpu_torch.serve import (EngineFactory, InferenceEngine, Router,
                                      TcpReplica)

    t_phase = time.perf_counter()
    cfg, params, _ = model_params()
    rng = np.random.default_rng(SEED + 50)
    pool = rng.normal(size=(ROUTER_POOL, *cfg["input_shape"])).astype(
        np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_", dir=ROOT)
    root = os.path.join(tmp.name, "serve")
    mgr = CheckpointManager(root, keep=2)
    path = mgr.save(1, from_jax(cfg, params, device="cpu"))
    mgr.close()
    refs = {1: InferenceEngine.from_checkpoint(
        path, max_batch=32, device="cpu").infer(pool).numpy()}

    def shard(name):
        return os.path.join(tmp.name, f"{name}.jsonl")

    # tcp1's standby starts with the others and takes its place after the
    # kill, so the rejoin waits for no process start
    ports = free_ports(6)
    children = {
        key: ReplicaChild(ports[2 * i], root, 1, name,
                          metrics_port=ports[2 * i + 1], trace=shard(key))
        for i, (key, name) in enumerate((("tcp0", "tcp0"), ("tcp1", "tcp1"),
                                         ("standby", "tcp1")))}
    was = get_tracer().enabled
    tracer = configure(enabled=True)
    tracer.clear()
    tracer.process_name = "router"
    rec = FlightRecorder(os.path.join(tmp.name, "flight"),
                         min_interval_s=0.0, tracer=tracer)
    freg = MetricsRegistry()
    agg = FleetAggregator(registry=freg)
    rules = RuleEngine(agg.store, registry=freg)
    for name in FLEET_TARGETS:
        rules.add_alert(name=f"target_down_{name}",
                        series=f'fleet_target_up{{replica="{name}"}}',
                        op="<", threshold=1.0, for_s=0.0, window_s=60.0,
                        description=f"{name} unreachable")
    agg.rules = rules
    Replica = counting_replica_class()
    reset_launches()  # the fleet path starts here
    factory = EngineFactory(root, max_batch=32, device="cuda")
    locs = [Replica(factory, 1, name=n, queue_capacity=ROUTER_QUEUE)
            for n in FLEET_TARGETS[:2]]
    clients, router, traffic, lines = [], None, None, {}
    out = {"scrape_s": {"in_process": [], "http": []}, "poll_s": []}

    def poll():
        t = time.perf_counter()
        res = agg.poll()
        out["poll_s"].append(time.perf_counter() - t)
        for name, r in res.items():
            kind = "in_process" if name.startswith("loc") else "http"
            if r["fetched"]:
                out["scrape_s"][kind].append(r["dur_s"])
        return res

    try:
        for loc in locs:
            agg.add_target(loc.name, server=loc.start_telemetry(port=0))
        for name in ("tcp0", "tcp1"):
            line = children[name].wait_for("listening", 180.0)
            agg.add_target(name, url=f"http://127.0.0.1:{line['metrics']}")
            clients.append(TcpReplica("127.0.0.1", children[name].port,
                                      name=name, timeout_s=30.0,
                                      connect_timeout=60.0))
        router = Router([*locs, *clients], flight=rec)
        fsrv = agg.serve()
        traffic = OpenLoopMix(router, pool, ROUTER_RPS, SEED + 51).start()
        time.sleep(FLEET_SETTLE_S)
        res = poll()
        down = [n for n in FLEET_TARGETS if res[n]["values"] is None]
        if down:
            fail(f"fleet: targets {down} unread by the first poll: {res}")
        m = "serve_samples_completed_total"
        per = {n: res[n]["values"][m] for n in FLEET_TARGETS}
        got = {n: agg.store.latest(f'{m}{{replica="{n}"}}')[1]
               for n in FLEET_TARGETS}
        fsum = agg.store.latest(f'{m}{{fleet="sum"}}')[1]
        fmax = agg.store.latest(f'{m}{{fleet="max"}}')[1]
        if got != per or fsum != sum(per.values()) \
                or fmax != max(per.values()) or not all(per.values()):
            fail(f"fleet: merged {m} {got}, sum {fsum}, max {fmax} against "
                 f"the four scrapes {per}")
        codes = {r: _http(fsrv.url + r)[0]
                 for r in ("/fleet", "/alerts", "/healthz")}
        if set(codes.values()) != {200}:
            fail(f"fleet: the fleet routes answered {codes} with every "
                 f"target up")
        out["merged"] = {"per_replica": per, "sum": fsum, "max": fmax}

        children["tcp1"].kill()  # SIGKILL, mid-load
        t_kill = time.perf_counter()
        while not clients[1].is_dead():
            if time.perf_counter() - t_kill > 10.0:
                fail("fleet: the killed replica's client did not see it die "
                     "within 10 s")
            time.sleep(0.001)
        router.check_replicas()
        res = poll()
        up = agg.store.latest('fleet_target_up{replica="tcp1"}')[1]
        rollup = agg.health_rollup() or ""
        code, health = _http(fsrv.url + "/healthz")
        health, alerts = (json.loads(health),
                          json.loads(_http(fsrv.url + "/alerts")[1]))
        if (res["tcp1"]["fetched"] or up != 0.0 or "tcp1" not in rollup
                or code != 503 or alerts.get("firing") != ["target_down_tcp1"]
                or not any("target_down_tcp1" in r
                           for r in health["reasons"])):
            fail(f"fleet: after tcp1's kill up={up}, roll-up {rollup!r}, "
                 f"/healthz {code} {health}, alerts {alerts}")
        out["after_kill"] = {"target_up": up, "rollup": rollup,
                             "healthz": code, "firing": alerts["firing"]}

        line = children["standby"].wait_for("listening", 180.0)
        router.remove_replica("tcp1")
        clients[1].close()
        clients[1] = TcpReplica("127.0.0.1", children["standby"].port,
                                name="tcp1", timeout_s=30.0,
                                connect_timeout=60.0)
        router.add_replica(clients[1])
        agg.remove_target("tcp1")
        agg.add_target("tcp1", url=f"http://127.0.0.1:{line['metrics']}")
        time.sleep(FLEET_SETTLE_S)
        poll()
        code, _ = _http(fsrv.url + "/healthz")
        state = {a["name"]: a for a in rules.alerts()}["target_down_tcp1"]
        if (code != 200 or state["state"] != "inactive"
                or state["resolved_total"] != 1 or agg.health_rollup()):
            fail(f"fleet: after the rejoin /healthz {code}, tcp1's alert "
                 f"{state}, roll-up {agg.health_rollup()!r}")
        out["after_rejoin"] = {"healthz": code, "alert": state["state"]}
    finally:
        if traffic is not None:
            traffic.stop()
        try:
            if router is not None:
                router.drain(timeout=120)
        finally:
            agg.close()
            for c in clients:
                c.close()
            for name in ("tcp0", "standby"):
                if children[name].proc.poll() is None:
                    lines[name] = children[name].result()
            for c in children.values():
                c.close()
    counts = launches()  # and ends here
    snaps = [loc.metrics.snapshot() for loc in locs]
    local = dispatched(locs, 2, len(locs[0]._engine.bucket_sizes))
    for loc in locs:
        loc.close()
    shards = [tracer.export_jsonl(shard("router"))]
    shards += [p for p in map(shard, children) if os.path.exists(p)]
    configure(enabled=was)
    merged = os.path.join(tmp.name, "merged.json")
    cli = subprocess.run(
        [sys.executable, "-m", "dcnn_tpu_torch.obs.trace", "merge", *shards,
         "-o", merged, "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    if cli.returncode != 0:
        fail(f"fleet: the trace merge CLI exited {cli.returncode}: "
             f"{cli.stderr[-2000:]}")
    summary = json.loads(cli.stdout)
    problems = validate_chrome(merged)
    with open(merged) as f:
        doc = json.load(f)
    pids = {}
    for e in doc["traceEvents"]:
        tid = e.get("args", {}).get("trace_id") if e["ph"] != "M" else None
        if tid:
            pids.setdefault(tid, set()).add(e["pid"])
    spanning = sum(1 for p in pids.values() if len(p) >= 2)
    if problems or not spanning:
        fail(f"fleet: merged trace problems {problems[:5]}, traces under "
             f"two or more pids {spanning}")
    deaths = [b for b in rec.bundles() if b["trigger"] == "replica_death"]
    info = inspect_bundle(deaths[0]["path"]) if deaths else {}
    if (len(deaths) != 1 or info["manifest"]["trigger"] != "replica_death"
            or not info.get("spans")):
        fail(f"fleet: replica_death bundles {deaths}, inspected {info}")
    served, failed = version_of(traffic, refs, "fleet", exact=False,
                                tol=SERVE_TOL)
    shares = shed_shares(traffic, "fleet", regime="class")
    if counts["flash_fwd"] != 2 * local or not all(s["batches"]
                                                   for s in snaps):
        fail(f"fleet: flash_fwd launched {counts['flash_fwd']} times here "
             f"for {local} batches of the two local replicas (2 attention "
             f"layers each); batches {[s['batches'] for s in snaps]}")
    for name, line in lines.items():
        fwd = line["launches"]["flash_fwd"]
        if fwd != 2 * line["dispatched"] or not line["batches"]:
            fail(f"fleet: {name}'s flash_fwd {fwd} for {line['dispatched']} "
                 f"batches; {line}")
    if set(lines) != {"tcp0", "standby"}:
        fail(f"fleet: surviving processes' shutdown lines {sorted(lines)}")
    tmp.cleanup()
    sc = out.pop("scrape_s")
    polls = out.pop("poll_s")
    out.update({
        "requests": len(traffic.sent), "offered": traffic.offered,
        "shed": traffic.shed, "shed_by_regime": traffic.shed_by,
        "shed_share_class": shares, "failed": failed,
        "served_by_version": served,
        "scrape_s_in_process_mean": sum(sc["in_process"])
        / len(sc["in_process"]),
        "scrape_s_http_mean": sum(sc["http"]) / len(sc["http"]),
        "scrape_s_http_max": max(sc["http"]),
        "poll_s": polls, "trace_merge": {
            k: summary[k] for k in ("events", "trace_ids",
                                    "events_dropped_by_writers")},
        "shards": len(shards), "traces_across_pids": spanning,
        "bundle": {k: info[k] for k in ("spans", "trace_ids")},
        "launches": {"here": counts["flash_fwd"],
                     "tcp0": lines["tcp0"]["launches"]["flash_fwd"],
                     "tcp1_rejoined":
                         lines["standby"]["launches"]["flash_fwd"]},
        "phase_s": round(time.perf_counter() - t_phase, 1)})
    print(f"fleet: FleetAggregator over 2 in-process and 2 HTTP "
          f"mha_classifier replicas behind a Router ({len(traffic.sent)} "
          f"requests at {ROUTER_RPS:g}/s), tcp1 SIGKILLed and rejoined; "
          f"{json.dumps(out)}; every result within {SERVE_TOL:g} of the CPU "
          f"reference, flash_fwd 2 x batches in every surviving process; "
          f"on {card}", flush=True)
    return out


def phase_autoscale(card):
    """Phase 31: an ``Autoscaler`` reading through its ``FleetAggregator``
    over a ``Router`` of ``LocalReplica``s of int8
    ``resnet18_tiny_imagenet`` (full width, one ``EngineFactory`` as in
    phase 19, every bucket a CUDA graph), ``min_replicas=1``,
    ``max_replicas=4``, ticked every ``AUTOSCALE_TICK_S`` here. One
    replica's sustained request rate is measured first, on a replica of
    its own (the open-loop mix offered flat out for
    ``AUTOSCALE_MEASURE_S``); then one diurnal day of ``AUTOSCALE_PERIOD_S``
    in real time, peak twice that rate, trough a tenth of the peak, and
    the trough held up to ``AUTOSCALE_TAIL_S`` more until the fleet is
    back to one replica. Faults as ``run_diurnal_soak`` injects them: the
    newest replica the autoscaler built killed mid-load, and v2 canaried
    through ``ModelVersionManager`` (which may promote it). Gates: every
    admitted request resolved, 99% of them completed; at least one
    scale-up and one scale-down, every scale-down a ``decommission``;
    every result bit for bit its version's reference engine; every
    retired engine's graph pool at 0 B; no scale-up whose build or capture
    failed (``autoscale_scale_up_failures_total`` 0, no tick's
    ``last_error``); ``conv_int8_fused`` 21 a dispatched batch; each
    reaction at most ``up_cooldown_s`` plus a tick plus the slowest
    spin-up. The day's turns and injections are ``serve/soak.py``'s
    ``SoakInjections``. Prints each scale-up's spin-up (engine build,
    captures, warm replays), ``sample_hbm`` after it, the reaction and
    SLO-violation seconds, p99 and the fleet size over time."""
    import tempfile

    import numpy as np
    import torch

    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.obs.xla import sample_hbm
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager
    from dcnn_tpu_torch.serve import (Autoscaler, AutoscalerConfig,
                                      EngineFactory, ModelVersionManager,
                                      Router, ServeMetrics, diurnal)
    from dcnn_tpu_torch.serve.soak import SoakInjections

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 60)
    cfg, _, _, v1 = resnet18("cpu", rng)
    models = {1: v1, 2: perturbed(v1, rng)}
    calib = rng.normal(size=(INT8_CALIB, *cfg["input_shape"])).astype(
        np.float32)
    pool = rng.normal(size=(ROUTER_POOL, *cfg["input_shape"])).astype(
        np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_autoscale_",
                                      dir=ROOT)
    staging, root = (os.path.join(tmp.name, d) for d in ("staging", "serve"))
    os.makedirs(root)
    mgr = CheckpointManager(staging, keep=4)
    for v, m in models.items():
        mgr.save(v, m)
    mgr.close()
    refs = {}
    ref_factory = EngineFactory(staging, max_batch=32, int8_calib=calib,
                                device="cuda")
    for v in (1, 2):
        eng = ref_factory(v)
        refs[v] = torch.cat([eng.infer(pool[i:i + 32]) for i in
                             range(0, ROUTER_POOL, 32)]).cpu().numpy()
        eng._release()
        del eng
    commit_into(staging, root, 1)
    reg = MetricsRegistry()

    class CountingFactory(EngineFactory):
        engines = []

        def __call__(self, version):
            eng = super().__call__(version)
            self.engines.append(eng)
            return eng

    torch.cuda.synchronize()
    reset_launches()  # the autoscale path starts here
    factory = CountingFactory(root, max_batch=32, int8_calib=calib,
                              device="cuda", registry=reg)
    Replica = counting_replica_class()
    made, spinups = [], []

    def make_replica(version):
        t = time.perf_counter()
        rep = Replica(factory, 1 if version is None else version,
                      name=f"as{len(made)}", queue_capacity=AUTOSCALE_QUEUE,
                      metrics=ServeMetrics(window=AUTOSCALE_WINDOW))
        spinups.append(round(time.perf_counter() - t, 4))
        made.append(rep)
        return rep

    # one replica's sustained rate, on a replica of its own: its latency
    # window then holds no overload when the day starts
    router = Router([make_replica(1)])
    measure = OpenLoopMix(router, pool, FLAT_OUT_RPS, SEED + 61).start()
    t0 = time.perf_counter()
    time.sleep(AUTOSCALE_MEASURE_S)
    measure.stop()
    router.drain(timeout=60)
    wall = time.perf_counter() - t0
    done = sum(1 for *_, f in measure.sent if f.exception() is None)
    one_rps = done / wall
    made[0].close()
    router = Router([make_replica(1)])
    boot = made[1]
    # replicas share one card and one GIL, so a control action stalls them
    # all: the SLO (p99 250 ms, 1% shed) is a peak's overload, not a stall
    scfg = AutoscalerConfig(
        slo_p99_ms=250.0, max_shed_fraction=0.01, high_utilization=0.7,
        low_utilization=0.2, min_replicas=1, max_replicas=4,
        up_cooldown_s=2.0, down_cooldown_s=4.0, breach_ticks=1,
        idle_ticks=3, drain_timeout_s=10.0)
    scaler = Autoscaler(router, make_replica, config=scfg)
    mvm = ModelVersionManager(router, factory, canary_fraction=0.25,
                              observe_s=2.0, min_canary_requests=20)
    torch.cuda.synchronize()
    alloc_before = torch.cuda.memory_allocated()
    peak = 2.0 * one_rps
    curve = diurnal(peak, peak / 10.0, AUTOSCALE_PERIOD_S)
    day = OpenLoopMix(router, pool, lambda t: curve(
        min(t, AUTOSCALE_PERIOD_S)), SEED + 62)
    turns, hbm, promoted = [], [], []

    def kill_newest():
        stats, owned = router.replica_stats(), scaler.owned_replicas()
        newest = [r for r in reversed(made) if r.name in owned
                  and stats.get(r.name, {}).get("state") == "up"]
        if not newest:
            return None  # none of the autoscaler's yet: the next turn
        newest[0].kill()  # preemption mid-load
        return newest[0].name

    def canary_v2():
        commit_into(staging, root, 2)
        res = mvm.poll()
        if res["action"] != "canary":
            fail(f"autoscale: v2's canary answered {res}")
        return res["canaries"]

    inject = SoakInjections(router, scaler, tick_dt=AUTOSCALE_TICK_S,
                            kill_at=AUTOSCALE_KILL_AT,
                            canary_at=AUTOSCALE_CANARY_AT, kill=kill_newest,
                            canary=canary_v2)
    t_day = time.perf_counter()
    day.start()
    try:
        while True:
            t = time.perf_counter() - t_day
            sizes = inject.fleet_sizes
            if t >= AUTOSCALE_PERIOD_S + AUTOSCALE_TAIL_S or (
                    t >= AUTOSCALE_PERIOD_S and sizes[-1][1] == 1
                    and any(o["action"] == "down" for o in turns)):
                break
            if "canary" in inject.events:
                res = mvm.poll()
                if res["action"] in ("rolled_back", "swap_failed"):
                    fail(f"autoscale: the version manager answered {res}")
                if res["action"] == "promoted":
                    promoted.append(round(t, 2))
            out = inject.turn(t)
            # a scale-up whose build or capture raised is the autoscaler's
            # "factory failures" turn (or an error beside an "up" of
            # step_up > 1): the phase fails on it, never serves around it
            if out["action"] == "error" or scaler.last_error:
                fail(f"autoscale: a tick failed: {out}, last error "
                     f"{scaler.last_error}")
            turns.append(out)
            if out["action"] == "up":
                s = sample_hbm(reg)
                hbm.append(None if s is None else int(s["hbm_bytes_in_use"]))
            # a tick from this one's start: a slow turn (a spin-up) is
            # not followed by a burst of turns catching up
            time.sleep(max(0.0, t_day + t + AUTOSCALE_TICK_S
                           - time.perf_counter()))
    finally:
        day.stop()
    router.drain(timeout=120)
    counts = launches()  # and ends here
    torch.cuda.synchronize()
    alloc_after = torch.cuda.memory_allocated()
    live = {id(r._engine) for r in router.replicas().values()
            if not r.is_dead()}
    live_pools = {n: r._engine.graphs.bytes()
                  for n, r in router.replicas().items() if not r.is_dead()}
    retired = [e for e in factory.engines if id(e) not in live]
    left = {e.name: e.graphs.bytes() for e in retired if e.graphs.bytes()}
    if left:
        fail(f"autoscale: retired engines still hold graph pool bytes "
             f"{left}")
    if router.outstanding():
        fail(f"autoscale: {router.outstanding()} rows left in the ledger")
    accepted = len(day.sent)
    served, failed = version_of(day, refs, "autoscale", exact=True)
    if day.errors:
        fail(f"autoscale: submit raised {day.errors[:3]}")
    completed = accepted - failed
    regs = router.metrics.registry.snapshot()
    ups, downs = (regs["autoscale_scale_ups_total"],
                  regs["autoscale_scale_downs_total"])
    decoms = regs.get("serve_router_decommissions_total", 0)
    up_failures = regs.get("autoscale_scale_up_failures_total", 0)
    drains = [o["drain"] for o in turns if o["action"] == "down"]
    sizes = [(round(t, 2), n) for t, n in inject.fleet_sizes]
    events = {k: (v, round(t, 2)) for k, (v, t) in inject.events.items()}
    if promoted:
        events["promoted"] = promoted[0]
    if up_failures:
        fail(f"autoscale: {up_failures} scale-up(s) failed to build or "
             f"capture")
    if not (completed >= 0.99 * accepted and ups >= 1 and downs >= 1
            and decoms == downs == len(drains)):
        fail(f"autoscale: {completed} of {accepted} admitted completed, "
             f"{ups} scale-ups, {downs} scale-downs, {decoms} "
             f"decommissions, drains {drains}; fleet sizes {sizes}; the "
             f"last turns {[{k: v for k, v in o.items() if k != 'drain'}
                            for o in turns[-6:]]}")
    n_disp = dispatched(made, len(factory.engines),
                        len(boot._engine.bucket_sizes))
    if counts["conv_int8_fused"] != INT8_CONVS * n_disp or counts["conv_int8"]:
        fail(f"autoscale: conv_int8_fused launched "
             f"{counts['conv_int8_fused']} times for {n_disp} batches "
             f"({INT8_CONVS} convs each), mode A {counts['conv_int8']}")
    reaction = regs["autoscale_scale_up_reaction_seconds"]
    up_spinups = spinups[2:]  # after the measured replica and the boot one
    bound = scfg.up_cooldown_s + AUTOSCALE_TICK_S + max(up_spinups)
    if reaction["count"] and reaction["max"] > bound:
        fail(f"autoscale: a scale-up reacted in {reaction['max']:.3f} s, "
             f"over up_cooldown_s + a tick + the slowest spin-up "
             f"({bound:.3f} s)")
    rsnap = router.metrics.snapshot()
    for r in made:
        r.close()
    if any(e.graphs.bytes() for e in factory.engines):
        fail("autoscale: a closed replica's engine kept its graph pool")
    tmp.cleanup()
    out = {
        "one_replica_rps": round(one_rps, 1),
        "measure_shed": sum(measure.shed.values()),
        "peak_rps": round(peak, 1), "trough_rps": round(peak / 10.0, 1),
        "accepted": accepted, "completed": completed, "failed": failed,
        "availability": completed / accepted,
        "offered": sum(day.offered.values()),
        "shed": sum(day.shed.values()), "served_by_version": served,
        "scale_ups": ups, "scale_up_failures": up_failures,
        "scale_downs": downs, "decommissions": decoms, "drains": drains,
        "spinup_s": up_spinups,
        "autoscale_spinup_seconds": regs["autoscale_spinup_seconds"],
        "hbm_bytes_after_up": hbm,
        "reaction_s": reaction, "reaction_bound_s": round(bound, 4),
        "slo_violation_s": regs["autoscale_slo_violation_seconds_total"],
        "latency_ms": {p: {"p50": rsnap[p]["p50_ms"], "p99": rsnap[p]["p99_ms"]}
                       for p, _ in ROUTER_MIX},
        "fleet_sizes": sizes, "events": events,
        # idle turns the down-guard held (PERF.md section 7: a trough
        # scale-up pins the fleet until traffic falls below its watermark)
        "down_guard_holds": sum(1 for o in turns
                                if o.get("reason") == "traffic needs fleet"),
        # each turn's answer, counted over the day and over the tail
        "turn_tally": {part: dict(collections.Counter(
            f"{o['action']}: {o['reason']}" if "reason" in o
            else o["action"] for o, (t, _) in zip(turns, inject.fleet_sizes)
            if (t >= AUTOSCALE_PERIOD_S) == (part == "tail")))
            for part in ("day", "tail")},
        "engines_built": len(factory.engines),
        "retired_engines": len(retired), "live_pool_bytes": live_pools,
        "allocated_before": alloc_before, "allocated_after": alloc_after,
        "launches": counts["conv_int8_fused"], "dispatched": n_disp,
        "phase_s": round(time.perf_counter() - t_phase, 1)}
    print(f"autoscale: int8 resnet18_tiny_imagenet, Autoscaler 1-4 "
          f"LocalReplicas through its FleetAggregator, one replica "
          f"{one_rps:.1f} requests/s, a {AUTOSCALE_PERIOD_S:g} s day at peak "
          f"{peak:.1f}/s; {json.dumps(out)}; every result bit for bit its "
          f"version's reference, retired pools 0 B, conv_int8_fused "
          f"{counts['conv_int8_fused']} = {INT8_CONVS} x {n_disp} batches; "
          f"on {card}", flush=True)
    return out


def phase_lease(card):
    """Phase 32: a ``DeviceLeaseBroker(devices=3)`` as three lease slots on
    the one card. Training holds 2: a ``LeasedElasticTrainer`` of 2
    ``ElasticController`` threads of full-width ``mha_classifier`` (phase
    23's topology and marker task, SGD). Serving holds 1: an ``Autoscaler``
    over fp32 ``mha_classifier`` ``LocalReplica``s. A spike (the open-loop
    mix flat out) makes the autoscaler ask for a lease; the broker revokes
    one from training, rank 1 is preempted and the world trains on at 1;
    the spike ends, the scale-down returns the lease and the next segment
    regrows to 2 from the newest commit. Gates: the final params within
    the JAX test's ``RTOL, ATOL = 2e-4, 2e-5`` of an uninterrupted
    fixed-world run on the card; ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` launched on the leased path; no failed scale-up.
    Prints the seconds from the revocation to the surrender, each
    segment's wall and world."""
    import functools
    import tempfile

    import numpy as np

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.optim import SGD
    from dcnn_tpu_torch.parallel import (ElasticController,
                                         LeasedElasticTrainer, TrainLease)
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager
    from dcnn_tpu_torch.serve import (Autoscaler, AutoscalerConfig,
                                      DeviceLeaseBroker, EngineFactory,
                                      Router)
    from dcnn_tpu_torch.train import create_train_state

    t_phase = time.perf_counter()
    cfg, params, _ = model_params()
    x, y = marker_task(np.random.default_rng(SEED + 70), n=ELASTIC_MHA_ROWS)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lease_", dir=ROOT)
    root = os.path.join(tmp.name, "serve")
    mgr = CheckpointManager(root, keep=2)
    mgr.save(1, from_jax(cfg, params, device="cpu"))
    mgr.close()
    pool = np.random.default_rng(SEED + 71).normal(
        size=(ROUTER_POOL, *cfg["input_shape"])).astype(np.float32)

    def controllers(ckpt, seen):
        def make(rank, peers, sock):
            model, opt = from_jax(cfg, params, device="cuda"), SGD(0.05)
            ctl = ElasticController(
                model, opt, "softmax_crossentropy",
                ArrayDataLoader(x, y, batch_size=ELASTIC_MHA_BATCH,
                                seed=SEED),
                config=TrainingConfig(
                    epochs=LEASE_EPOCHS, learning_rate=0.05, seed=SEED,
                    snapshot_dir=None, elastic=True,
                    elastic_microbatches=ELASTIC_MHA_K,
                    elastic_timeout_s=30.0, elastic_heartbeat_s=0.0,
                    elastic_ckpt_steps=2, elastic_min_world=1,
                    checkpoint_dir=ckpt),
                rank=rank, peers=peers, listen_sock=sock)
            ctl.fit = functools.partial(ctl.fit,
                                        create_train_state(model, opt))
            seen[rank] = ctl
            return ctl
        return make

    def params_of(results):
        for rank, r in sorted(results.items()):
            if isinstance(r, BaseException):
                fail(f"lease: rank {rank} raised {type(r).__name__}: {r}")
        return {r: host_named(ts.model) for r, ts in results.items()
                if not isinstance(ts, str)}

    base_ctls = {}
    t = time.perf_counter()
    base = params_of(LeasedElasticTrainer(
        controllers(os.path.join(tmp.name, "base"), base_ctls),
        registry=MetricsRegistry()).run_segment(
            LEASE_EPOCHS, target_world=2, resume=True))
    base_s = time.perf_counter() - t

    reg = MetricsRegistry()
    broker = DeviceLeaseBroker(3, registry=reg)
    lease = TrainLease(broker, initial=2, min_hold=1, registry=reg)
    broker.register("serve", priority=1, held=1)
    stamps = {}
    surrender = lease.surrender

    def stamped_surrender(n=1):
        stamps.setdefault("surrender", time.perf_counter())
        surrender(n)
    lease.surrender = stamped_surrender
    reset_launches()  # the leased path starts here
    factory = EngineFactory(root, max_batch=32, device="cuda")
    Replica = counting_replica_class()
    made = []

    def make_replica(version):
        made.append(Replica(factory, 1 if version is None else version,
                            name=f"lease{len(made)}",
                            queue_capacity=ROUTER_QUEUE))
        return made[-1]

    router = Router([make_replica(1)])
    scaler = Autoscaler(router, make_replica, broker=broker, tenant="serve",
                        # the spike's shed is the breach; a p99 its
                        # queueing left in the window must not pin it
                        config=AutoscalerConfig(
                            slo_p99_ms=1000.0, up_cooldown_s=0.0,
                            down_cooldown_s=0.0, breach_ticks=1,
                            idle_ticks=1, min_replicas=1, max_replicas=2,
                            drain_timeout_s=10.0))
    seen = {}
    trainer = LeasedElasticTrainer(
        controllers(os.path.join(tmp.name, "leased"), seen), lease=lease,
        min_world=1, registry=reg)
    seg1, walls, turns = {}, [], []

    def checked_tick():
        # a scale-up whose build or capture raised fails the phase
        out = scaler.tick()
        turns.append({k: v for k, v in out.items() if k != "drain"})
        if out["action"] == "error" or scaler.last_error:
            fail(f"lease: a tick failed: {turns[-1]}, last error "
                 f"{scaler.last_error}")
        return out

    def segment1():
        t = time.perf_counter()
        seg1.update(trainer.run_segment(LEASE_SEG1_EPOCHS, target_world=2,
                                        resume=True))
        walls.append(time.perf_counter() - t)

    th = threading.Thread(target=segment1, daemon=True, name="lease-seg1")
    th.start()
    deadline = time.perf_counter() + 120.0
    while not (seen.get(0) is not None and len(seen[0].step_log) >= 2):
        if time.perf_counter() > deadline or not th.is_alive():
            fail("lease: the training world made no progress")
        time.sleep(0.01)
    spike = OpenLoopMix(router, pool, FLAT_OUT_RPS, SEED + 72).start()
    try:
        deadline = time.perf_counter() + 60.0
        while True:
            time.sleep(0.2)
            out = checked_tick()
            if out["action"] == "blocked" and "revoked" not in stamps:
                stamps["revoked"] = time.perf_counter()
            if out["action"] == "up":
                break
            if time.perf_counter() > deadline:
                fail(f"lease: the serving scale-up never got a lease: "
                     f"{turns[-5:]}")
    finally:
        spike.stop()
    th.join(timeout=300)
    if th.is_alive():
        fail("lease: the first segment hung")
    ctl0 = seen[0]
    if (seg1.get(1) != "preempted" or ctl0.world != 1
            or ctl0.stats["reconfigures"] < 1
            or "revoked" not in stamps or "surrender" not in stamps):
        fail(f"lease: the revocation did not shrink the world to 1: "
             f"{ {r: type(v).__name__ for r, v in seg1.items()} }, world "
             f"{ctl0.world}, stamps {sorted(stamps)}")
    # the spike is over: the next idle turns scale down, returning the lease
    deadline = time.perf_counter() + 30.0
    while True:
        time.sleep(0.2)
        out = checked_tick()
        if out["action"] == "down":
            break
        if time.perf_counter() > deadline:
            fail(f"lease: no scale-down after the spike: {turns[-5:]}")
    if broker.free() != 1 or out["drain"]["swept"]:
        fail(f"lease: the scale-down left {broker.free()} lease(s) free, "
             f"drain {out['drain']}")
    t = time.perf_counter()
    seg2 = params_of(trainer.run_segment(LEASE_EPOCHS, target_world=2,
                                         resume=True))
    walls.append(time.perf_counter() - t)
    counts = launches()  # and ends here
    up_failures = router.metrics.registry.snapshot().get(
        "autoscale_scale_up_failures_total", 0)
    if up_failures:
        fail(f"lease: {up_failures} scale-up(s) failed to build or capture")
    worlds = [s["world"] for s in trainer.segments]
    if worlds != [2, 2] or sorted(seg2) != [0, 1]:
        fail(f"lease: segments {trainer.segments}")
    for n in seg2[0]:
        if not np.array_equal(seg2[0][n], seg2[1][n]):
            fail(f"lease: the regrown replicas differ in {n}")
    worst = 0.0
    for n, b in base[0].items():
        a = seg2[0][n]
        if not np.allclose(a, b, rtol=ELASTIC_RTOL, atol=ELASTIC_ATOL):
            fail(f"lease: {n} differs from the fixed-world run beyond rtol "
                 f"{ELASTIC_RTOL}, atol {ELASTIC_ATOL} (max "
                 f"{float(np.abs(a - b).max()):.3e})")
        worst = max(worst, float(np.abs(a - b).max()))
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if any(counts[k] <= 0 for k in flash):
        fail(f"lease: flash launches on the leased path {counts}")
    router.drain(timeout=60)
    for r in made:
        r.close()
    tmp.cleanup()
    out = {"launches": {k: counts[k] for k in flash},
           "revocation_to_surrender_s": round(
               stamps["surrender"] - stamps["revoked"], 4),
           "segment_s": [round(w, 3) for w in walls],
           "fixed_world_s": round(base_s, 3),
           "segments": trainer.segments,
           "seg1_worlds": [2, ctl0.world],
           "reconfigure_s": ctl0.stats["reconfigure_s"],
           "lease": {k: v for k, v in reg.snapshot().items()
                     if k.startswith(("lease_", "train_"))},
           "turns": turns, "spike_requests": len(spike.sent),
           "spike_shed": sum(spike.shed.values()),
           "max_diff": worst,
           "phase_s": round(time.perf_counter() - t_phase, 1)}
    print(f"lease: 3 lease slots on one card, training 2 elastic "
          f"mha_classifier peers, serving 1; a spike revoked one (world 2 -> "
          f"1 mid-segment), the scale-down returned it, the next segment "
          f"regrew to 2; {json.dumps(out)}; final params within "
          f"{worst:.2e} of the fixed-world run (rtol {ELASTIC_RTOL}, atol "
          f"{ELASTIC_ATOL}); on {card}", flush=True)
    return out


# phase 33: the example drivers (dcnn_tpu_torch/examples)
EX_TIMEOUT_S = 110         # each driver run in a subprocess
EX_PROCS = 6               # subprocess drivers at a time
EX_TEST_ROWS = 359         # the digits28 test split
LONG_CONTEXT_MIN_ACC = 0.9
EX_INT8_REPS = (200, 10)   # kernel, plain: device_ms reps at a snapshot site
# drivers whose data is real: none may fall back to synthetic data
EX_REAL_DATA = {"evaluate_snapshot", "serve_snapshot", "accuracy_gates",
                "resume_training", "trace_training", "dataset_visual_check"}
# (driver, argv, env) run as subprocesses at their smallest documented
# sizes; the pipeline over TCP through its launcher
EX_SUBPROCESS = [
    ("mnist_cnn_trainer", [], {"EPOCHS": "1"}),
    ("cifar10_cnn_trainer", [], {"EPOCHS": "1"}),
    ("cifar10_resnet9", [], {"EPOCHS": "1"}),
    ("cifar100_cnn_trainer", [], {"EPOCHS": "1"}),
    ("tiny_imagenet_trainer", [], {"EPOCHS": "1", "MODEL": "resnet18"}),
    ("uji_ips_trainer", [], {"EPOCHS": "1"}),
    ("resume_training", [], {}),
    ("trace_training", [], {"TRACE_EPOCHS": "1"}),
    ("serve_router", ["--seconds", "0.5"], {}),
    ("serve_decode", [], {}),
    ("serve_autoscale", ["--seconds", "60"], {}),
    ("pipeline_trainer", [], {"EPOCHS": "1", "MODEL": "mha_classifier"}),
    ("launch_pipeline.sh", ["2", "sync"], {"EPOCHS": "1"}),
    ("hardware_info_example", [], {}),
    ("backend_comparison", [], {}),
    ("dataset_visual_check", [], {}),
]


class _Tee:
    """A text stream writing to ``stream`` and keeping a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_example(name, argv=(), env=None):
    """``dcnn_tpu_torch.examples.<name>`` in this process: loaded through
    runpy, its ``main`` called with ``sys.argv`` and the environment set
    for the call (both put back after), its stdout copied. Returns (what
    main returned, the stdout). A driver's SystemExit fails the phase."""
    import contextlib
    import runpy

    saved_env, saved_argv = dict(os.environ), sys.argv
    os.environ.update(env or {})
    sys.argv = [name, *argv]
    tee = _Tee(sys.stdout)
    try:
        ns = runpy.run_module(f"dcnn_tpu_torch.examples.{name}",
                              run_name="dcnn_example")
        with contextlib.redirect_stdout(tee):
            out = ns["main"]()
    except SystemExit as e:
        fail(f"examples: {name} exited: {e}")
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        sys.argv = saved_argv
    return out, tee.text()


def consecutive_free_ports(n):
    """A port p with p..p+n-1 free on localhost."""
    import random
    import socket

    rng = random.Random(os.getpid())
    for _ in range(200):
        base = rng.randrange(20000, 40000)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("examples: no free ports")


def example_subprocess(name, argv, env, tmp):
    """One driver in a process of its own on the card from the repo's
    root; (return code, seconds, stdout, stderr's tail)."""
    e = {k: v for k, v in os.environ.items() if k != "DCNN_PRECISION"}
    e.update(PYTHONPATH=ROOT, DEVICE_TYPE="cuda", TMPDIR=tmp,
             SNAPSHOT_DIR=os.path.join(tmp, "snap", name),
             RESULTS_DIR=os.path.join(tmp, "results"), **env)
    if name.endswith(".sh"):
        e.update(BASE_PORT=str(consecutive_free_ports(2)),
                 PYTHON=sys.executable)
        cmd = ["bash", os.path.join(ROOT, "dcnn_tpu_torch", "examples", name),
               *argv]
    else:
        cmd = [sys.executable, "-m", f"dcnn_tpu_torch.examples.{name}",
               *argv]
    t = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=e, capture_output=True,
                              text=True, timeout=EX_TIMEOUT_S)
    except subprocess.TimeoutExpired as err:
        return (124, time.perf_counter() - t, err.stdout or "",
                str(err.stderr or "")[-2000:])
    return (proc.returncode, time.perf_counter() - t, proc.stdout,
            proc.stderr[-2000:])


def snapshot_int8_sites(qmodel, x):
    """Row 8 at the int8 snapshot's conv sites, fed the model's own
    activations of the eval batch ``x`` (hooked): each site held bit for
    bit in both modes and timed by int8_case."""
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
    if len(seen) != 3:
        fail(f"examples: {len(seen)} int8 conv sites in the snapshot, not 3")
    cases = []
    for mod, xin in seen:
        (s, _), (p, _) = mod.stride, mod.padding
        cases.append(int8_case(f"snapshot {mod.name} B={xin.shape[0]}", xin,
                               mod.x_scale, mod.w_q, mod.w_scale, mod.b, s,
                               p, mod.data_format, EX_INT8_REPS,
                               context=False))
    return cases


def phase_examples(card):
    """Phase 33: the example drivers (``dcnn_tpu_torch/examples``), each as
    a user starts it, on the card. In this process (``run_example``:
    through runpy, so the launch counters see them; counted from 0 around
    each): ``long_context_trainer`` at its defaults (B32, S2048, E128, H2:
    D 64, fp32, 60 steps x 8 epochs, the flash kernels, with
    ``blockwise_attention`` counted: it must not run), ``evaluate_snapshot``
    on ``model_snapshots/mnist_cnn_model`` and the digits28 test split (and
    again with ``DEVICE_TYPE=cpu`` for the CPU's top-1), ``serve_snapshot``
    with ``INT8=1`` and ``accuracy_gates digits28`` (40 epochs to its 0.99
    gate). After them ``EX_SUBPROCESS``'s drivers run as processes of
    their own, ``EX_PROCS`` at a time, each within ``EX_TIMEOUT_S``: no
    time of the in-process drivers is taken beside them.
    Gates: (a) int8 and (b) unfolded and folded top-1 on the card within 1
    of the 359 samples of the CPU's, the driver's fold and int8 gates
    held; (c) ``conv_int8_fused`` launched by evaluate_snapshot and by
    serve_snapshot, each snapshot site bit for bit its plain version; (d)
    the flash forward, dQ and dK/dV launched by long_context_trainer, no
    blockwise call, its final fresh-data accuracy at least
    ``LONG_CONTEXT_MIN_ACC``; (e) digits28 passes its gate; (f) no
    real-data driver fell back to synthetic data; every subprocess exits
    0."""
    import concurrent.futures
    import importlib
    import tempfile

    import numpy as np
    import torch

    from dcnn_tpu_torch.data import MNISTDataLoader, decode_host
    from dcnn_tpu_torch.data.digits28 import ensure_digits28_csvs
    from dcnn_tpu_torch.examples.common import SYNTHETIC_MARK

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_examples_",
                                      dir=ROOT)
    env = {"DEVICE_TYPE": "cuda", "SNAPSHOT_DIR": os.path.join(tmp.name,
                                                               "snap"),
           "RESULTS_DIR": os.path.join(tmp.name, "results")}
    stdout = {}

    # (d) the long-context trainer alone first: its step times are the
    # card's without the subprocess drivers beside it
    layer_mod = importlib.import_module("dcnn_tpu_torch.nn.attention_layer")
    ops_mod = importlib.import_module("dcnn_tpu_torch.ops.attention")
    blockwise = {"calls": 0}
    original = ops_mod.blockwise_attention

    def counted_blockwise(*a, **k):
        blockwise["calls"] += 1
        return original(*a, **k)

    layer_mod.blockwise_attention = ops_mod.blockwise_attention = \
        counted_blockwise
    reset_launches()
    try:
        lc, stdout["long_context_trainer"] = run_example(
            "long_context_trainer", env=env)
    finally:
        layer_mod.blockwise_attention = ops_mod.blockwise_attention = \
            original
    lc_counts = launches()
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if any(lc_counts[k] <= 0 for k in flash) or blockwise["calls"]:
        fail(f"examples (d): long_context_trainer launches "
             f"{ {k: lc_counts[k] for k in flash} }, blockwise calls "
             f"{blockwise['calls']}")
    if lc["final_acc"] < LONG_CONTEXT_MIN_ACC:
        fail(f"examples (d): long_context_trainer's fresh-data accuracy "
             f"{lc['final_acc']} < {LONG_CONTEXT_MIN_ACC}: "
             f"{json.dumps(lc['epochs'])}")
    last = lc["epochs"][-1]
    print(f"examples (d): long_context_trainer B32 H2 S2048 D64 fp32, 8 "
          f"epochs of 60 steps: fresh-data accuracy "
          f"{[e['acc'] for e in lc['epochs']]}, {last['ms_per_step']:.3f} "
          f"ms/step = {last['tokens_per_s']:.0f} tokens/s (last epoch); "
          f"launches { {k: lc_counts[k] for k in flash} }, blockwise 0; "
          f"on {card}", flush=True)

    # (a)-(c) the snapshot on the card and on the CPU, and (e), before the
    # subprocess drivers start: their timings are the card's alone
    reset_launches()
    ev, stdout["evaluate_snapshot"] = run_example("evaluate_snapshot",
                                                  env=env)
    ev_counts = launches()
    ev_cpu, _ = run_example("evaluate_snapshot",
                            env={**env, "DEVICE_TYPE": "cpu"})
    for kind in ("unfolded", "folded", "int8"):
        diff = abs(ev[kind]["top1"] - ev_cpu[kind]["top1"])
        if diff * EX_TEST_ROWS > 1 + 1e-9:
            fail(f"examples (a/b): {kind} top-1 {ev[kind]['top1']} on "
                 f"the card, {ev_cpu[kind]['top1']} on the CPU")
    if ev_counts["conv_int8_fused"] <= 0:
        fail(f"examples (c): evaluate_snapshot launched no "
             f"conv_int8_fused: {ev_counts}")
    d = ensure_digits28_csvs(ROOT)
    val = MNISTDataLoader(os.path.join(d, "test.csv"), batch_size=256,
                          shuffle=False, drop_last=False)
    val.load_data()
    x = torch.from_numpy(decode_host(np.asarray(next(iter(val))[0]),
                                     val.scale)).cuda()
    sites = snapshot_int8_sites(ev["models"]["int8"], x)

    reset_launches()
    served, stdout["serve_snapshot"] = run_example(
        "serve_snapshot", env={**env, "INT8": "1", "SERVE_LOADS": "300",
                               "SERVE_SECONDS": "1.0"})
    sv_counts = launches()
    if sv_counts["conv_int8_fused"] <= 0:
        fail(f"examples (c): serve_snapshot INT8=1 launched no "
             f"conv_int8_fused: {sv_counts}")

    # (e) digits28 to its gate
    gates, stdout["accuracy_gates"] = run_example(
        "accuracy_gates", ["digits28"], env=env)
    g = gates[0]
    if not g["passed"]:
        fail(f"examples (e): digits28 reached {g['val_acc']} < "
             f"{g['target']}")

    # the other drivers, EX_PROCS processes at a time
    with concurrent.futures.ThreadPoolExecutor(max_workers=EX_PROCS) as pool:
        futures = {name: pool.submit(example_subprocess, name, argv, extra,
                                     tmp.name)
                   for name, argv, extra in EX_SUBPROCESS}
        results = {name: f.result() for name, f in futures.items()}
    walls, failed = {}, []
    for name, (rc, secs, out, err) in results.items():
        walls[name] = round(secs, 1)
        stdout[name] = out
        tail = (out.strip().splitlines() or [""])[-1][:200]
        print(f"examples: {name} exited {rc} after {secs:.1f} s: {tail}",
              flush=True)
        if rc != 0:
            failed.append(name)
            print(f"examples: {name}'s output ends: {out[-1500:]} {err}",
                  flush=True)
    if failed:
        fail(f"examples: {failed} exited non-zero")
    # (f) real data only
    synthetic = sorted(n for n, text in stdout.items()
                       if n in EX_REAL_DATA and SYNTHETIC_MARK in text)
    if synthetic:
        fail(f"examples (f): {synthetic} fell back to synthetic data")
    tmp.cleanup()
    launches_on_path = {k: lc_counts[k] for k in flash}
    launches_on_path["conv_int8_fused"] = (ev_counts["conv_int8_fused"]
                                           + sv_counts["conv_int8_fused"])
    out = {
        "launches": launches_on_path,
        "long_context": {"final_acc": lc["final_acc"],
                         "acc_by_epoch": [e["acc"] for e in lc["epochs"]],
                         "ms_per_step": [round(e["ms_per_step"], 3)
                                         for e in lc["epochs"]],
                         "tokens_per_s": [round(e["tokens_per_s"])
                                          for e in lc["epochs"]],
                         "launches": {k: lc_counts[k] for k in flash}},
        "evaluate_snapshot": {
            dev: {k: {m: r[k][m] for m in r[k]} for k in
                  ("unfolded", "folded", "int8")}
            for dev, r in (("card", ev), ("cpu", ev_cpu))},
        "evaluate_launches": ev_counts["conv_int8_fused"],
        "serve_snapshot_int8": {"points": served["points"],
                                "conv_int8_fused": sv_counts[
                                    "conv_int8_fused"]},
        "digits28": {k: g[k] for k in ("val_acc", "target", "passed",
                                       "epochs", "wall_clock_s",
                                       "seconds_to_target")},
        "subprocess_s": walls,
        "phase_s": round(time.perf_counter() - t_phase, 1)}
    print(f"examples: {json.dumps(out)}; on {card}", flush=True)
    out["int8_sites"] = sites
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


def int8_row(serve_int8, obs_launches, export_launches, router_launches,
             autoscale_launches, examples):
    """Row 8, conv_int8.cu: its fused mode (B, the one the int8 serving
    path launches; with its K-split reduces) with launches on that path
    and times summed over the 21 conv sites of resnet18_tiny_imagenet at
    B=32 (and, under "b256", at B=256), each site timed on its own; mode A
    (int8 -> int32, 0 launches on the served path) under "mode_a"; the
    unfused chain under "chain_ms"; no library call computes either
    function. ``obs_launches``: the obs phase's telemetry-served path;
    ``export_launches``: the export phase's artifact-served path;
    ``router_launches``: the router phase's replicas;
    ``autoscale_launches``: the autoscale phase's replicas; ``examples``:
    phase 33's launches (evaluate_snapshot and serve_snapshot) and its
    snapshot sites, each held and timed at the eval batch ("examples")."""
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
             + serve_int8["held"] + serve_int8["ragged"]
             + examples["int8_sites"])
    counts = serve_int8["launches"]
    b32 = total(serve_int8["sites_b32"])
    mode_a = b32.pop("mode_a")
    return {"name": "conv_int8_fused", "route": "cuda",
            "source": "dcnn_tpu_torch/ops/csrc/conv_int8.cu",
            "replaces": "dcnn_tpu/ops/conv.py:77", "launches":
            counts["conv_int8_fused"] + obs_launches + export_launches
            + router_launches + autoscale_launches
            + examples["launches"]["conv_int8_fused"],
            "launches_by_path": {"serve_int8": counts["conv_int8_fused"],
                                 "obs": obs_launches,
                                 "export": export_launches,
                                 "router": router_launches,
                                 "autoscale": autoscale_launches,
                                 "examples": examples["launches"][
                                     "conv_int8_fused"]},
            "splitk_reduce_launches": counts["conv_int8_reduce"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **b32, "library_ms": None,
            "mode_a": {"name": "conv_int8", "launches": counts["conv_int8"],
                       **mode_a, "library_ms": None},
            "b256": total(serve_int8["sites_b256"]),
            "examples": total(examples["int8_sites"]), "cases": cases}


def _leaves(tree):
    """The arrays of a nested tuple/dict pytree, in order."""
    import numpy as np

    if isinstance(tree, dict):
        return [a for k in tree for a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _leaves(t)]
    return [np.asarray(tree)]


# phase 34: the static-analysis suite's claims about capture, on the card.
# One fixture module: a function for each hazard the suite names, one it
# counts through count_host, and a clean one, each captured by a Session
# built in sessions() (which makes them capture roots)
ANALYSIS_FIXTURE = """\
import io

import torch

from dcnn_tpu_torch.core.graphs import Session, count_host

SINK = io.StringIO()
CALLS = []
HOST = {"n": 0}


def host_sync(x):
    return x * x.sum().item()


def printer(x):
    print("step", file=SINK)
    return x * 2


def impure(x):
    CALLS.append(1)
    return x + 1


def counted(x):
    count_host(HOST, "n")
    return x - 1


def clean(x):
    return torch.relu(x) * 2 + torch.tanh(x)


def sessions(pool, x):
    return {
        "host_sync": lambda: Session("host_sync", host_sync, (x,), pool=pool),
        "printer": lambda: Session("printer", printer, (x,), pool=pool),
        "impure": lambda: Session("impure", impure, (x,), pool=pool),
        "counted": lambda: Session("counted", counted, (x,), pool=pool),
        "clean": lambda: Session("clean", clean, (x,), pool=pool),
    }


def effects():
    return {"printer": SINK.getvalue().count("step"),
            "impure": len(CALLS), "counted": HOST["n"]}


def reset():
    SINK.seek(0)
    SINK.truncate()
    CALLS.clear()
    HOST["n"] = 0
"""
# the port's suite over the fixture: unsuppressed check ids by function
ANALYSIS_EXPECTED = {"host_sync": ["TS01"], "printer": ["TS03"],
                     "impure": ["TS05"], "counted": [], "clean": [],
                     "sessions": [], "effects": [], "reset": []}
ANALYSIS_REPLAYS = 10


def phase_analysis(card):
    """Phase 34: the port's static-analysis suite
    (``dcnn_tpu_torch.analysis``) over :data:`ANALYSIS_FIXTURE` reports
    exactly :data:`ANALYSIS_EXPECTED` (TS01 for a host read, TS03 for a
    ``print``, TS05 for a closed-over ``append``, nothing for a function
    that counts through ``count_host`` or for a clean one). Then
    ``core.graphs.Session`` captures each on the card, after one eager
    call and its effects reset: the TS01 function raises ``CaptureError``
    (and the card works on after it); the TS03 and TS05 functions' Python
    side effects count 1 after the capture and still 1 after
    :data:`ANALYSIS_REPLAYS` replays, while ``count_host`` counts 0 at the
    capture and one a replay; the clean function's replays equal its eager
    call bit for bit. Host-light: no kernel of the port runs here."""
    import importlib.util
    import shutil
    import tempfile

    import torch

    from dcnn_tpu_torch.analysis import analyze_paths, unsuppressed
    from dcnn_tpu_torch.core.graphs import CaptureError, GraphPool

    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="dcnn-analysis-")
    try:
        path = os.path.join(d, "capture_fixture.py")
        with open(path, "w") as f:
            f.write(ANALYSIS_FIXTURE)
        found = {name: [] for name in ANALYSIS_EXPECTED}
        for f in unsuppressed(analyze_paths([d])):
            found.setdefault(f.symbol.split(".")[0], []).append(f.check_id)
        found = {k: sorted(v) for k, v in found.items()}
        if found != ANALYSIS_EXPECTED:
            fail(f"analysis: the suite reports {found} over the capture "
                 f"fixture, expected {ANALYSIS_EXPECTED}")
        t_lint = time.perf_counter() - t0
        spec = importlib.util.spec_from_file_location("capture_fixture", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    dev = torch.device("cuda")
    pool = GraphPool(dev)
    x = (torch.arange(1024, dtype=torch.float32, device=dev)
         .reshape(32, 32) / 64.0 - 8.0)
    build = mod.sessions(pool, x)
    made, after_capture, after_replays = [], {}, {}
    for name in ("printer", "impure", "counted"):
        getattr(mod, name)(x)  # the eager call a capture follows
        torch.cuda.synchronize()
        mod.reset()
        s = build[name]()
        made.append(s)
        after_capture[name] = mod.effects()[name]
        want = getattr(mod, name)(x)  # eager again: its effects undone
        mod.reset()
        for i in range(ANALYSIS_REPLAYS):
            got = s(x)
            if not torch.equal(got, want):
                fail(f"analysis: {name} replay {i} differs from its eager "
                     f"call")
        torch.cuda.synchronize()
        after_replays[name] = (after_capture[name]
                               + mod.effects()[name])
    want = {"printer": 1, "impure": 1, "counted": 0}
    if after_capture != want:
        fail(f"analysis: effects after capture {after_capture}, expected "
             f"{want}")
    want = {"printer": 1, "impure": 1, "counted": ANALYSIS_REPLAYS}
    if after_replays != want:
        fail(f"analysis: effects after {ANALYSIS_REPLAYS} replays "
             f"{after_replays}, expected {want}")
    eager = mod.clean(x)
    torch.cuda.synchronize()
    clean = build["clean"]()
    made.append(clean)
    for i in range(ANALYSIS_REPLAYS):
        if not torch.equal(clean(x), eager):
            fail(f"analysis: clean replay {i} is not its eager call bit for "
                 f"bit")
    mod.host_sync(x)
    torch.cuda.synchronize()
    try:
        made.append(build["host_sync"]())
        fail("analysis: capturing the TS01 fixture (.item()) raised no "
             "CaptureError")
    except CaptureError as e:
        raised = str(e).splitlines()[0]
    torch.cuda.synchronize()
    if not torch.equal(clean(x), eager) or not torch.isfinite(
            (x + 1).sum()).item():
        fail("analysis: the card misbehaves after the failed capture")
    pool.release(made)
    out = {"findings": found, "after_capture": after_capture,
           "after_replays": after_replays, "replays": ANALYSIS_REPLAYS,
           "capture_error": raised, "lint_s": round(t_lint, 3),
           "phase_s": round(time.perf_counter() - t0, 2)}
    print(f"analysis: the suite names TS01/TS03/TS05 in the capture fixture "
          f"and nothing in the clean and count_host functions; on the card "
          f"the TS01 function raised CaptureError ({raised}), print and "
          f"append ran once at capture and not in {ANALYSIS_REPLAYS} "
          f"replays, count_host counted each replay, the clean function "
          f"replayed bit for bit; {json.dumps(out)}; on {card}", flush=True)
    return out


# phase 35: a planted img/s history, oldest first; the last capture is 25%
# below the best of the four before it
REGRESS_PLANTED = (1000.0, 1100.0, 1200.0, 1250.0, 1300.0, 975.0)


def phase_regress(card):
    """Phase 35: the port's bench regression gate
    (``dcnn_tpu_torch.obs.regress``) through its command line, each run a
    process of its own with this machine's Python: ``--self-test`` exits 0
    and prints ``self-test: PASS``; :data:`REGRESS_PLANTED`, written as
    ``BENCH_TORCH_rNN.json`` captures to a temp dir, exits 1 with exactly
    ``img_per_sec`` among ``--json``'s regressions. Host-only: no kernel of
    the port runs here."""
    import shutil
    import subprocess
    import tempfile

    cmd = [sys.executable, "-m", "dcnn_tpu_torch.obs.regress"]
    t0 = time.perf_counter()
    st = subprocess.run(cmd + ["--self-test"], cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    self_s = time.perf_counter() - t0
    if st.returncode != 0 or "self-test: PASS" not in st.stdout:
        fail(f"regress: --self-test exited {st.returncode}: "
             f"{st.stdout[-1500:]}{st.stderr[-1500:]}")
    d = tempfile.mkdtemp(prefix="dcnn-regress-")
    try:
        files = []
        for n, value in enumerate(REGRESS_PLANTED, start=1):
            files.append(os.path.join(d, f"BENCH_TORCH_r{n:02d}.json"))
            with open(files[-1], "w") as f:
                json.dump({"n": n, "parsed": {"metric": "m",
                                              "value": value}}, f)
        t = time.perf_counter()
        planted = subprocess.run(cmd + ["--json"] + files, cwd=ROOT,
                                 capture_output=True, text=True, timeout=120)
        planted_s = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if planted.returncode != 1:
        fail(f"regress: the planted history exited {planted.returncode}, "
             f"expected 1: {planted.stdout[-1500:]}{planted.stderr[-1500:]}")
    regressions = json.loads(planted.stdout)["regressions"]
    if regressions != ["img_per_sec"]:
        fail(f"regress: the planted history flagged {regressions}, expected "
             f"['img_per_sec']")
    out = {"self_test_rc": st.returncode, "self_test_s": round(self_s, 2),
           "planted_rc": planted.returncode, "planted_s": round(planted_s, 2),
           "planted_regressions": regressions,
           "phase_s": round(time.perf_counter() - t0, 2)}
    print(json.dumps({"regress": out}), flush=True)
    print(f"regress: --self-test passed and the planted 25% img/s drop "
          f"exited 1 with img_per_sec flagged; on {card}", flush=True)
    return out


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
        # as each phase ends, so a run that fails later still shows them
        print(f"phase {name}: {seconds[name]} s, {time.perf_counter() - t0:.1f}"
              f" s since the build began", flush=True)
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
    resnet = pipe.pop("resnet18")
    compiled = timed("compiled pipeline", phase_compiled_pipeline, card,
                     resnet)
    tcp = timed("tcp pipeline", phase_tcp_pipeline, card,
                pipe.pop("tcp_refs"), resnet)
    router = timed("router", phase_router, card)
    router_tcp = timed("router tcp", phase_router_tcp, card)
    elastic_dir, elastic_peers = start_elastic_peers()
    dp_ref, dp = timed("data parallel", phase_data_parallel, card)
    dp["elastic"] = timed("elastic", phase_elastic, card, elastic_dir,
                          elastic_peers, dp_ref, dp)
    dp["elastic_mha"] = timed("elastic mha", phase_elastic_mha, card)
    seq_dir, seq_peers = start_seq_peers()
    seq = timed("sequence", phase_sequence, card)
    dp["resident"] = timed("dp feed", phase_dp_feed, card)
    dp["spatial"] = timed("spatial", phase_spatial, card)
    seq["world2"], dp["resident"]["world2"], sp_lines = timed(
        "sequence peers", phase_seq_peers, card, seq_dir, seq_peers, seq)
    dp["spatial"]["world2"] = check_spatial_world2(
        card, seq_dir, sp_lines, dp_ref, dp["spatial"])
    dp["telemetry"] = timed("telemetry", phase_telemetry, card)
    fleet = {"fleet": timed("fleet", phase_fleet, card),
             "autoscale": timed("autoscale", phase_autoscale, card),
             "lease": timed("lease", phase_lease, card)}
    examples = timed("examples", phase_examples, card)
    analysis = timed("analysis", phase_analysis, card)
    timed("regress", phase_regress, card)
    print(f"phase seconds: {json.dumps(seconds)}, total "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)

    def row(name, source, replaces, cases, by_path):
        model_case = cases[0]  # the model's shape: B=32, H=4, S=32, D=16
        long = next(c for c in cases if c["case"] == "long context")
        d256 = next(c for c in cases if c["case"] == "d256 long context")
        d512 = next(c for c in cases if c["case"] == "d512 long context")
        d256f = next(c for c in cases if c["case"] == "d256 fp32 long context")
        ex_long = next(c for c in cases
                       if c["case"] == "examples long context")
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
                "examples_long_context": {k: ex_long[k] for k in keys},
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
    # counted in the worker processes, from their shutdown lines
    tp = {k: sum(run[k] for run in tcp["launches"].values())
          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    em = dp["elastic_mha"]["launches"]
    # the sequence paths' launches: world 1 here, world 2 in both peers
    sq = {k: seq["launches"][k] + sum(r["launches"][k]
                                      for r in seq["world2"])
          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # the fleet phase's flash forwards: here and in the surviving children
    fp = sum(fleet["fleet"]["launches"].values())
    ll = fleet["lease"]["launches"]
    xl = examples["launches"]
    tc_src = "dcnn_tpu_torch/ops/csrc/conv3x3_tc.cu"
    kernels = [
        row("flash_fwd", "dcnn_tpu_torch/ops/csrc/flash_fwd.cu",
            "dcnn_tpu/ops/attention.py:297", fwd_cases,
            {"serve": serve["launches"], "train": tl["flash_fwd"],
             "train_feed": fl["flash_fwd"],
             "serve_int8": serve_int8["mha"]["launches"]["flash_fwd"],
             "wide_layer": wide["flash_fwd"], "obs": obs["flash_fwd"],
             "export": export["mha_classifier"]["launches"]["flash_fwd"],
             "pipeline": pl["flash_fwd"], "tcp_pipeline": tp["flash_fwd"],
             "router_tcp": router_tcp["survivor"]["launches"]["flash_fwd"],
             "elastic_mha": em["flash_fwd"],
             "sequence": sq["flash_fwd"], "fleet": fp,
             "lease": ll["flash_fwd"], "examples": xl["flash_fwd"]}),
        row("flash_bwd_dq", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:460", bwd_cases["dq"],
            {"serve": 0, "train": tl["flash_bwd_dq"],
             "train_feed": fl["flash_bwd_dq"],
             "wide_layer": wide["flash_bwd_dq"], "obs": obs["flash_bwd_dq"],
             "pipeline": pl["flash_bwd_dq"],
             "tcp_pipeline": tp["flash_bwd_dq"],
             "elastic_mha": em["flash_bwd_dq"],
             "sequence": sq["flash_bwd_dq"], "lease": ll["flash_bwd_dq"],
             "examples": xl["flash_bwd_dq"]}),
        row("flash_bwd_dkv", "dcnn_tpu_torch/ops/csrc/flash_bwd.cu",
            "dcnn_tpu/ops/attention.py:478", bwd_cases["dkv"],
            {"serve": 0, "train": tl["flash_bwd_dkv"],
             "train_feed": fl["flash_bwd_dkv"],
             "wide_layer": wide["flash_bwd_dkv"],
             "obs": obs["flash_bwd_dkv"], "pipeline": pl["flash_bwd_dkv"],
             "tcp_pipeline": tp["flash_bwd_dkv"],
             "elastic_mha": em["flash_bwd_dkv"],
             "sequence": sq["flash_bwd_dkv"],
             "lease": ll["flash_bwd_dkv"], "examples": xl["flash_bwd_dkv"]}),
        site_row("conv3x3_s1", tc_src, "dcnn_tpu/ops/pallas/conv.py:82"),
        site_row("conv3x3_s1_pairs", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:173"),
        site_row("conv3x3_s1_bnrelu_in", tc_src,
                 "dcnn_tpu/ops/pallas/conv.py:209"),
        site_row("fused_scale_bias_relu", "dcnn_tpu_torch/ops/csrc/fused.cu",
                 "dcnn_tpu/ops/pallas/fused.py:49"),
        int8_row(serve_int8, obs["conv_int8_fused"],
                 export["resnet18"]["launches"]["conv_int8_fused"],
                 router["launches"]["conv_int8_fused"],
                 fleet["autoscale"]["launches"], examples),
    ]
    print(json.dumps({"pipeline": {
        "launches": pipe["launches"], "samples_per_s": {
            **pipe["samples_per_s"],
            **{f"resnet18_compiled_{k}": v
               for k, v in compiled["samples_per_s"].items()}},
        "load_reports": pipe["load_reports"],
        "peak_bytes": compiled["peak_bytes"],
        "pool_bytes": compiled["pool_bytes"],
        "tcp_samples_per_s": tcp["samples_per_s"],
        "tcp_wire_bytes_per_batch": tcp["wire_bytes_per_batch"],
        "tcp_load_reports": tcp["load_reports"],
        "tcp_launches": tcp["launches"],
        "tcp_worker_start_s": tcp["worker_start_s"],
        "tcp_recovery": tcp["recovery"]}}), flush=True)
    print(json.dumps({"router": router, "router_tcp": router_tcp}),
          flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(json.dumps({"sequence": seq}), flush=True)
    print(json.dumps({"fleet_plane": fleet}), flush=True)
    print(json.dumps({"examples": {k: v for k, v in examples.items()
                                   if k != "int8_sites"}}), flush=True)
    print(json.dumps({"analysis": analysis}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replica-server"]:
        replica_server_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--elastic-peer"]:
        elastic_peer_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--seq-peer"]:
        seq_peer_main(sys.argv[2:])
    else:
        main()
