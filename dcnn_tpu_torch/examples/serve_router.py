"""Router-tier driver (counterpart of ``examples/serve_router.py``): N
replicas, a replica killed mid-traffic and restarted, and a versioned
hot-swap canaried and promoted.

A ``Router`` over N ``LocalReplica``s built by an ``EngineFactory`` from a
``CheckpointManager`` root walks three stories: steady open-loop traffic
through priority-class admission; a replica killed mid-soak (every
accepted request still completes, re-admitted to the survivors: the
printed ledger shows zero silent drops) and restarted, rejoining on the
next sweep; and a "finetuned" v2 committed beside v1, canaried onto part
of the fleet by the ``ModelVersionManager`` and promoted on clean metrics.

Self-contained: a small CNN, two checkpoint versions in a temp dir,
synthetic traffic.

Usage:
    python -m dcnn_tpu_torch.examples.serve_router [--replicas N] [--metrics-port P] [--seconds S]

``--metrics-port P`` serves the router's ``/metrics``, ``/healthz`` (a
live fleet sweep) and ``/snapshot``; ``P=0`` picks an ephemeral port.
"""

from __future__ import annotations

import argparse
import copy
import tempfile
import threading
import time

import numpy as np
import torch

from ..nn import SequentialBuilder
from ..resilience.checkpoint import CheckpointManager
from ..serve import (EngineFactory, LocalReplica, ModelVersionManager, Router,
                     open_loop)
from .common import device_of, setup


def build_versions(root: str):
    """Commit two model versions (v1, and a perturbed "finetuned" v2)."""
    model = (SequentialBuilder(name="router_demo", data_format="NHWC")
             .input((28, 28, 1))
             .conv2d(8, 3, padding=1).batchnorm().activation("relu")
             .maxpool2d(2).flatten().dense(10)
             .build())
    model.init(generator=torch.Generator().manual_seed(0), device="cpu")
    mgr = CheckpointManager(root, keep=4)
    mgr.save(1, model)
    v2 = copy.deepcopy(model)
    with torch.no_grad():
        for p in v2.parameters():
            p.mul_(1.01)
    mgr.save(2, v2)
    mgr.close()
    return model


def traffic(router, pool, rps, seconds, label):
    futs = open_loop(router, pool, rps, seconds)
    deadline = time.monotonic() + 30
    while router.outstanding() and time.monotonic() < deadline:
        time.sleep(0.01)
    done = sum(1 for _, f in futs if f.done() and f.exception() is None)
    failed = sum(1 for _, f in futs if f.done() and f.exception())
    t = router.metrics.snapshot()
    n = t["normal"]
    print(f"  {label:<28} accepted={len(futs):>5} completed={done:>5} "
          f"typed_failures={failed:>3} silent_drops="
          f"{len(futs) - done - failed}  p50="
          f"{n['p50_ms'] and round(n['p50_ms'], 2)}ms p99="
          f"{n['p99_ms'] and round(n['p99_ms'], 2)}ms "
          f"shed={t['total']['shed_fraction']:.3f}")
    return futs


def main(argv=None) -> dict:
    cfg = setup("serve_router")
    dev = device_of(cfg.device_type)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="traffic window per phase")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as root:
        build_versions(root)
        factory = EngineFactory(root, max_batch=16, device=dev)
        print(f"\n-- fleet: {args.replicas} replicas on version "
              f"{factory.newest() - 1} (v2 committed but not yet rolled "
              f"out)")
        replicas = [
            LocalReplica(factory, 1, name=f"replica-{i}",
                         queue_capacity=128, max_wait_ms=1.0)
            for i in range(args.replicas)]
        router = Router(replicas)
        mvm = ModelVersionManager(router, factory, canary_fraction=0.34,
                                  observe_s=0.5, min_canary_requests=20)
        srv = None
        if args.metrics_port is not None:
            srv = router.start_telemetry(port=args.metrics_port)
            print(f"router telemetry: {srv.url}/metrics|healthz|snapshot")

        rng = np.random.default_rng(5)
        pool = rng.normal(size=(64, 28, 28, 1)).astype(np.float32)
        rate = 400.0
        try:
            print("\n-- phase 1: steady traffic")
            traffic(router, pool, rate, args.seconds, "steady")

            print("\n-- phase 2: kill replica-0 mid-soak, then restart")
            killer = threading.Timer(args.seconds / 2, replicas[0].kill)
            killer.daemon = True
            killer.start()
            futs = traffic(router, pool, rate, args.seconds, "kill mid-soak")
            killer.join()
            router.check_replicas()
            if not all(f.done() for _, f in futs):
                raise SystemExit("silent drop: an accepted request never "
                                 "resolved")
            replicas[0].restart()
            report = router.check_replicas()
            print(f"  sweep after restart: {report}")

            print("\n-- phase 3: canary rollout of v2")
            res = mvm.poll()
            print(f"  poll -> {res['action']} canaries={res.get('canaries')}")
            traffic(router, pool, rate, args.seconds, "mixed-version")
            time.sleep(0.6)  # past observe_s
            res = mvm.poll()
            versions = {n: s["version"]
                        for n, s in router.replica_stats().items()}
            print(f"  poll -> {res['action']}; fleet versions: {versions}")
            if res["action"] != "promoted" or set(versions.values()) != {2}:
                raise SystemExit(f"v2 was not promoted: {res}, {versions}")

            print("\n-- router metrics (totals)")
            t = router.metrics.snapshot()["total"]
            print(f"  completed={t['completed']} shed={t['shed']} "
                  f"failed={t['failed']}")
            snap = router.metrics.registry.snapshot()
            print(f"  deaths={snap['serve_router_replica_deaths_total']} "
                  f"rejoins={snap['serve_router_rejoins_total']} "
                  f"swaps={snap['serve_router_swaps_total']} "
                  f"promotions={snap['serve_router_promotions_total']}")
        finally:
            router.shutdown(drain=True, timeout=30)
            if srv is not None:
                srv.stop()
            for r in replicas:
                r.close()
        print("\nOK: kill survived with zero silent drops, restart "
              "rejoined, v2 canaried and promoted.")
    return {"completed": t["completed"], "versions": versions}


if __name__ == "__main__":
    main()
