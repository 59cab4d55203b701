"""Continuous-batching decode driver (counterpart of
``examples/serve_decode.py``): greedy autoregressive decode over a tiny
``MHADecoder`` through a ``DecodeEngine`` (its paged decode step built per
batch and page bucket, so admission builds nothing), a ``KVPagePool`` of
fixed pages and a ``ContinuousBatcher`` that admits sequences into free
slots between steps.

It checks the determinism contract: every sequence's continuously batched
output equals the same sequence decoded alone (``decode_reference``,
batch of one, the same engine), whatever shared its steps. Then it prints
slot occupancy and generated tokens/s for continuous against sequential
batch-of-one decode on the same prompts, and the ``DecodeMetrics``
exposition. Untrained weights: greedy argmax over a fixed model is as
deterministic as over a trained one.

Usage:
    python -m dcnn_tpu_torch.examples.serve_decode

Env: ``DECODE_SLOTS`` (default 4), ``DECODE_SEQS`` (12),
``DECODE_MAX_NEW`` (10), ``DEVICE_TYPE``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .common import env_device


def main() -> dict:
    dev = env_device()
    print(f"=== serve_decode === (device {dev})")
    from ..models import MHADecoder
    from ..serve import ContinuousBatcher, DecodeEngine, decode_reference

    max_slots = int(os.environ.get("DECODE_SLOTS", "4"))
    n_seqs = int(os.environ.get("DECODE_SEQS", "12"))
    max_new = int(os.environ.get("DECODE_MAX_NEW", "10"))

    model = MHADecoder(vocab_size=32, embed_dim=32, num_heads=2,
                       num_layers=2, max_seq_len=64)
    model.init(generator=torch.Generator().manual_seed(0), device=dev)
    print(f"model: {model.name} (vocab 32, E 32, 2 heads, 2 layers)")

    t0 = time.perf_counter()
    engine = DecodeEngine(model, max_slots=max_slots, page_size=8,
                          max_pages_per_seq=4, name="example")
    print(f"engine: {engine}")
    print(f"  {len(engine.compile_stats)} (batch, pages) sessions "
          f"built in {time.perf_counter() - t0:.2f}s — admission "
          f"builds nothing more")

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.vocab_size,
                            size=int(rng.integers(2, 10))).tolist()
               for _ in range(n_seqs)]

    # sequential batch-of-one through the same sessions
    t0 = time.perf_counter()
    reference = [decode_reference(engine, p, max_new_tokens=max_new)
                 for p in prompts]
    naive_wall = time.perf_counter() - t0

    # continuous batching: every sequence submitted up front
    with ContinuousBatcher(engine, queue_capacity=n_seqs) as batcher:
        t0 = time.perf_counter()
        futs = [batcher.submit(p, max_new_tokens=max_new) for p in prompts]
        results = [f.result(timeout=30) for f in futs]
        cont_wall = time.perf_counter() - t0
        snap = batcher.metrics.snapshot()
        prom = batcher.metrics.prometheus()

    for i, (got, want) in enumerate(zip(results, reference)):
        if not np.array_equal(got, want):
            raise SystemExit(f"sequence {i}: continuous {got} != "
                             f"batch-of-one {want}")
    print(f"\nbit-identity: {n_seqs}/{n_seqs} sequences identical to "
          f"batch-of-one decode  [OK]")

    tokens = sum(len(r) for r in results)
    print(f"\n{'':>24}  {'continuous':>12}  {'batch-of-one':>12}")
    print(f"{'wall (s)':>24}  {cont_wall:>12.3f}  {naive_wall:>12.3f}")
    print(f"{'tokens/s':>24}  {tokens / cont_wall:>12.1f}  "
          f"{tokens / naive_wall:>12.1f}")
    print(f"{'slot occupancy':>24}  {snap['slot_occupancy']:>12.3f}  "
          f"{1 / max_slots:>12.3f}")
    print(f"\nsteps={snap['steps']} admissions={snap['admissions']} "
          f"evictions={snap['evictions']} "
          f"pages_in_use={snap['pages_in_use']}")
    print("\n/metrics tail (decode_* series):")
    for line in prom.splitlines():
        if line.startswith("decode_") and "_bucket" not in line:
            print(f"  {line}")
    return {"sequences": n_seqs, "tokens": tokens,
            "tokens_per_s": tokens / cont_wall,
            "slot_occupancy": snap["slot_occupancy"]}


if __name__ == "__main__":
    main()
