#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dcnn_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile every CUDA kernel from ``dcnn_tpu_torch/ops/csrc`` with
   ``nvcc -Xptxas -v`` (registers, shared memory and spills are printed);
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the serving shape and at harder ones, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and the card's bound for the work;
4. serve: build ``mha_classifier`` at its full width (S=32, E=64, 4 heads)
   from JAX-layout numpy weights made from a seed, through
   ``interop.from_jax``; serve threaded single and small-batch requests
   through ``DynamicBatcher`` over ``InferenceEngine`` on CUDA; check every
   answer against the same model on the CPU (plain path), and check from
   the launch counters that the serving path ran the kernel.

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
              "bfloat16": 989e12}   # bf16 tensor cores, dense
TOL = {"float32": 1e-4,  # same math, another summation order
       "bfloat16": 2e-2}  # output rounded to bf16 (8 significant bits)
SERVE_TOL = 1e-4          # logits, fp32, cuBLAS against the CPU's GEMMs


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


def allowed_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through: the work this input needs
    (the causal diagonal is offset by sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(max(i + sk - sq + 1, 0), sk) for i in range(sq))


def flash_bound(b, h, sq, sk, d, causal, dtype_name):
    """Least time the card could take: the larger of bytes moved (q, k, v
    read once; O and the fp32 logsumexp written once) over HBM bandwidth
    and the two products' FLOPs over the peak rate for the input type."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = esize * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    flops = 4 * b * h * allowed_pairs(sq, sk, causal) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.ops.attention import flash_forward_reference

    cases = [  # name, B, H, Sq, Sk, D, causal, dtype, timing reps
        ("serving shape", 32, 4, 32, 32, 16, False, torch.float32, 200),
        ("causal ragged", 2, 4, 1000, 1000, 64, True, torch.float32, 20),
        ("causal sq<sk", 2, 3, 77, 300, 128, True, torch.float32, 50),
        ("long context", 4, 8, 4096, 4096, 64, True, torch.bfloat16, 5),
        ("fully masked rows", 1, 2, 200, 10, 32, True, torch.float32, 50),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for name, b, h, sq, sk, d, causal, dt, reps in cases:
        dtn = str(dt).replace("torch.", "")
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
        r = {"case": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
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
              f"bound_ms={bound_ms:.6f} ({bound_by})", flush=True)
    print("kernels: " + json.dumps([{"name": "flash_fwd", "ok": True,
                                     "cases": len(results)}]), flush=True)
    return results


def jax_layout_params(cfg, rng):
    """Params in the JAX package's pytree layout, as numpy: what
    ``model.init`` gives there (Kaiming-uniform, bound 1/sqrt(fan_in)),
    drawn from ``rng`` instead of a jax.random key."""
    import numpy as np

    def u(shape, fan_in):
        bound = fan_in ** -0.5
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    def layer(lc, shape):
        ty = lc["type"]
        if ty == "multi_head_attention":
            e = shape[1]
            p = {n: u((e, e), e) for n in ("wq", "wk", "wv", "wo")}
            p.update({n: u((e,), e) for n in ("bq", "bk", "bv", "bo")})
            return p, shape
        if ty == "residual_block":
            main, s = [], shape
            for c in lc["layers"]:
                p, s = layer(c, s)
                main.append(p)
            return {"main": tuple(main), "shortcut": ()}, s
        if ty == "flatten":
            return {}, (int(np.prod(shape)),)
        if ty == "dense":
            n = lc["out_features"]
            return {"w": u((n, shape[0]), shape[0]),
                    "b": u((n,), shape[0])}, (n,)
        raise ValueError(f"no params rule for {ty}")

    shape, params = tuple(cfg["input_shape"]), []
    for lc in cfg["layers"]:
        p, shape = layer(lc, shape)
        params.append(p)
    return tuple(params)


def phase_serve(card: str):
    import numpy as np
    import torch

    from dcnn_tpu_torch.interop import from_jax
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.ops import _kernels
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine

    rng = np.random.default_rng(SEED)
    cfg = create_model("mha_classifier").get_config()
    params = jax_layout_params(cfg, rng)
    n_single, batches = 64, (2, 3, 5, 8)
    pool = rng.normal(size=(n_single + sum(batches), *cfg["input_shape"])
                      ).astype(np.float32)
    with torch.no_grad():
        ref = from_jax(cfg, params, device="cpu")(torch.from_numpy(pool)).numpy()

    model = from_jax(cfg, params, device="cuda")
    _kernels.flash_fwd.launches = 0  # the main path starts here
    engine = InferenceEngine.from_model(model, max_batch=32, device="cuda")
    warm_launches = _kernels.flash_fwd.launches
    batcher = DynamicBatcher(engine, max_wait_ms=2.0, queue_capacity=256)
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
    launches = _kernels.flash_fwd.launches  # the main path ends here
    snap = batcher.metrics.snapshot()

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
    served_launches = launches - warm_launches
    if warm_launches < 2 * len(engine.bucket_sizes):
        fail(f"warm-up launched flash_fwd {warm_launches} times for "
             f"{len(engine.bucket_sizes)} buckets")
    if n_batches < 1 or served_launches < 2 * n_batches:
        fail(f"flash_fwd launched {served_launches} times for {n_batches} "
             f"dispatched batches (2 attention layers each)")
    requests = len(futs)
    print(f"serve: {requests} requests ({snap['requests_completed']} samples)"
          f" in {n_batches} batches, occupancy {snap['batch_occupancy']}, "
          f"max |logit err| vs CPU {worst:.3e} (tol {SERVE_TOL:g}); "
          f"flash_fwd launches {launches} ({warm_launches} warm-up, "
          f"{served_launches} serving); throughput "
          f"{snap['throughput_rps']} samples/s, p50 {snap['p50_ms']} ms, "
          f"p99 {snap['p99_ms']} ms, wall {wall:.3f} s on {card}",
          flush=True)
    return {"launches": launches, "warm_launches": warm_launches,
            "served_launches": served_launches, "batches": n_batches,
            "requests": requests, "max_abs_err": worst, **snap}


def main() -> None:
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
    cases = phase_kernels()
    serve = phase_serve(card)

    model_case = cases[0]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dcnn_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "dcnn_tpu/ops/attention.py:297",
        "launches": serve["launches"],
        "max_abs_err": model_case["max_abs_err"],
        "ms": model_case["ms"], "plain_ms": model_case["plain_ms"],
        "bound_ms": model_case["bound_ms"],
        "bound_by": model_case["bound_by"],
        "library_ms": model_case["library_ms"],
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
