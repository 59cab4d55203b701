#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dcnn_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compile every CUDA kernel from ``dcnn_tpu_torch/ops/csrc`` with
   ``nvcc -Xptxas -v`` (registers, shared memory and spills are printed);
3. kernels: hold each kernel (the flash forward, the dQ and the dK/dV
   backward kernels) against its plain PyTorch version on the card at the
   model's shape and at harder ones, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick the port never calls) and the card's bound for the work;
4. serve: build ``mha_classifier`` at its full width (S=32, E=64, 4 heads)
   from JAX-layout numpy weights made from a seed, through
   ``interop.from_jax``; serve threaded single and small-batch requests
   through ``DynamicBatcher`` over ``InferenceEngine`` on CUDA; check every
   answer against the same model on the CPU (plain path), and check from
   the launch counters that the serving path ran the forward kernel;
5. train: the same model and weights, trained for 2 epochs (16 Adam steps)
   on a synthetic marker task through ``Trainer.fit`` on CUDA and on the
   CPU; check that the loss falls, that every epoch's loss and the final
   params track the CPU run, and from the launch counters that every step
   ran the forward, dQ and dK/dV kernels twice each.

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


def flash_bwd_bound(b, h, sq, sk, d, causal, dtype_name, kernel):
    """Least time for one backward kernel: bytes (each input read once:
    q, k, v, dO, fp32 lse and delta; each output written once: dQ, or dK
    and dV) over HBM bandwidth, against FLOPs over the peak rate for the
    input type. Per allowed (q, k) pair dQ does 3 products (S, dP, dS·K),
    6·D FLOPs; dK/dV 4 (S, dP, Pᵀ·dO, dSᵀ·Q), 8·D FLOPs."""
    esize = 4 if dtype_name == "float32" else 2
    rows = esize * b * h * d
    if kernel == "dq":
        nbytes = rows * (3 * sq + 2 * sk) + 8 * b * h * sq
        flops = 6 * d * b * h * allowed_pairs(sq, sk, causal)
    else:
        nbytes = rows * (2 * sq + 4 * sk) + 8 * b * h * sq
        flops = 8 * d * b * h * allowed_pairs(sq, sk, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


FLASH_CASES = [  # name, B, H, Sq, Sk, D, causal, dtype name, timing reps
    ("model shape", 32, 4, 32, 32, 16, False, "float32", 200),
    ("causal ragged", 2, 4, 1000, 1000, 64, True, "float32", 20),
    ("causal sq<sk", 2, 3, 77, 300, 128, True, "float32", 50),
    ("long context", 4, 8, 4096, 4096, 64, True, "bfloat16", 5),
    ("fully masked rows", 1, 2, 200, 10, 32, True, "float32", 50),
    # diagonal offset 65: the last key the first 64-row q tile may see is
    # the first key of the third kv tile, the edge of the kernels' bands
    ("band edge", 1, 2, 100, 165, 32, True, "float32", 50),
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
    return results


def phase_bwd_kernels():
    """dQ and dK/dV kernels against ``flash_backward_reference`` on the
    same inputs (O and logsumexp from the forward kernel, a random
    cotangent), at the cases of the forward; times both kernels, the plain
    version, SDPA's backward through autograd and the bound."""
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
        for kname, fn, gnames in (("dq", dq_kernel, ("dq",)),
                                  ("dkv", dkv_kernel, ("dk", "dv"))):
            bound_ms, bound_by, nbytes, flops = flash_bwd_bound(
                b, h, sq, sk, d, causal, dtn, kname)
            err = max(errs[n][0] for n in gnames)
            rel = max(errs[n][1] for n in gnames)
            kern_ms = device_ms(fn, reps)
            results[kname].append({
                "case": name, "B": b, "H": h, "Sq": sq, "Sk": sk, "D": d,
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
                  f"({bound_by})", flush=True)
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


def reset_launches() -> None:
    from dcnn_tpu_torch.ops import _kernels

    for fn in (_kernels.flash_fwd, _kernels.flash_bwd_dq,
               _kernels.flash_bwd_dkv):
        fn.launches = 0


def launches() -> dict:
    from dcnn_tpu_torch.ops import _kernels

    return {"flash_fwd": _kernels.flash_fwd.launches,
            "flash_bwd_dq": _kernels.flash_bwd_dq.launches,
            "flash_bwd_dkv": _kernels.flash_bwd_dkv.launches}


def model_params():
    """``mha_classifier``'s config and JAX-layout weights from ``SEED``."""
    import numpy as np

    from dcnn_tpu_torch.models import create_model

    rng = np.random.default_rng(SEED)
    cfg = create_model("mha_classifier").get_config()
    return cfg, jax_layout_params(cfg, rng), rng


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


def phase_train(card: str):
    """16 Adam steps of full-width ``mha_classifier`` through
    ``Trainer.fit`` on CUDA and on the CPU, from the same weights and
    batches."""
    import numpy as np
    import torch

    from dcnn_tpu_torch.core import TrainingConfig
    from dcnn_tpu_torch.data import ArrayDataLoader
    from dcnn_tpu_torch.interop import from_jax, opt_state_to_jax, to_jax
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.train import Trainer, create_train_state

    cfg, params, rng = model_params()
    x, y = marker_task(rng)
    epochs, batch = 2, 32
    runs = {}
    for dev in ("cuda", "cpu"):
        model = from_jax(cfg, params, device=dev)
        opt = Adam(1e-3)
        ts = create_train_state(model, opt)
        loader = ArrayDataLoader(x, y, batch_size=batch, shuffle=True,
                                 seed=SEED)
        trainer = Trainer(model, opt, "softmax_crossentropy", TrainingConfig(
            epochs=epochs, batch_size=batch, snapshot_dir=None,
            progress_interval=0, device_type=dev))
        if dev == "cuda":
            reset_launches()  # the training path starts here
            ts = trainer.fit(ts, loader)
            torch.cuda.synchronize()
            counts = launches()  # the training path ends here
        else:
            ts = trainer.fit(ts, loader)
        runs[dev] = (trainer.history, to_jax(model),
                     opt_state_to_jax(model, ts.opt_state), ts.step)

    hist, p_gpu, _, steps = runs["cuda"]
    hist_cpu, p_cpu, st_cpu, _ = runs["cpu"]
    if steps != epochs * len(x) // batch:
        fail(f"train: {steps} steps, expected {epochs * len(x) // batch}")
    per_step = {k: v / steps for k, v in counts.items()}
    if any(v != 2 * steps for v in counts.values()):
        fail(f"train: launches {counts} over {steps} steps; expected 2 of "
             f"each kernel per step (two attention layers)")
    losses = [h["train_loss"] for h in hist]
    loss_rel = max(abs(a["train_loss"] - b["train_loss"])
                   / abs(b["train_loss"]) for a, b in zip(hist, hist_cpu))
    if not all(math.isfinite(v) for v in losses) or loss_rel > TRAIN_LOSS_RTOL:
        fail(f"train: CUDA losses {losses} vs CPU "
             f"{[h['train_loss'] for h in hist_cpu]} (rel {loss_rel:.3e} > "
             f"{TRAIN_LOSS_RTOL:g})")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")

    # final params: Adam's RMS gradient per element from the CPU run's
    # second moment decides which tolerance holds (see GRAD_FLOOR)
    opt = Adam(1e-3)
    bc2 = 1.0 - opt.beta2 ** steps
    step_bound = 2 * steps * opt.learning_rate * (1 - opt.beta1) \
        / math.sqrt(1 - opt.beta2)
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

    walk(p_gpu, p_cpu, st_cpu["v"])
    worst = worst_noise = 0.0
    n_noise = n_all = 0
    edges = (0.0, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, math.inf)
    bins = [[0, 0.0] for _ in edges[1:]]  # elements, max |diff| per band
    for a, b, v in flat:
        diff = np.abs(a - b)
        if not np.all(np.isfinite(a)):
            fail("train: non-finite params on CUDA")
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
    if worst > TRAIN_PARAM_ATOL or worst_noise > step_bound:
        fail(f"train: final params differ from the CPU run by {worst:.3e} "
             f"(tol {TRAIN_PARAM_ATOL:g}) where the RMS gradient >= "
             f"{GRAD_FLOOR:g}, {worst_noise:.3e} (bound {step_bound:.3e}) "
             f"on the {n_noise} of {n_all} elements below it")
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
          f"launches {counts} ({per_step} per step); samples/s per epoch "
          f"{sps} (epoch 1 includes first-call set-up) on {card}",
          flush=True)
    return {"launches": counts, "steps": steps, "losses": losses,
            "cpu_losses": [h["train_loss"] for h in hist_cpu],
            "loss_max_rel_diff": loss_rel, "param_max_abs_diff": worst,
            "noise_param_max_abs_diff": worst_noise,
            "noise_elements": n_noise, "elements": n_all,
            "diff_by_rms_band": [(lo, n, d) for lo, (n, d) in zip(edges, bins)],
            "samples_per_s": sps}


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
    fwd_cases = phase_kernels()
    bwd_cases = phase_bwd_kernels()
    serve = phase_serve(card)
    train = phase_train(card)

    def row(name, source, replaces, cases, by_path):
        model_case = cases[0]  # the model's shape: B=32, H=4, S=32, D=16
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": model_case["ms"], "plain_ms": model_case["plain_ms"],
                "bound_ms": model_case["bound_ms"],
                "bound_by": model_case["bound_by"],
                "library_ms": model_case["library_ms"], "cases": cases}

    tl = train["launches"]
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
