"""Autoscaler driver (counterpart of ``examples/serve_autoscale.py``): the
fleet following a diurnal traffic curve.

1. **Diurnal soak**: the shared soak driver
   (``serve.soak.run_diurnal_soak``) offers a 10x peak-to-trough
   sinusoidal load through the router while the autoscaler scrapes every
   replica's exposition and grows or shrinks the fleet against the SLO; a
   replica preemption and a canary swap are injected mid-load. It prints
   each resize against the offered rate, then the report (availability,
   SLO-violation minutes, scale-up reaction).
2. **Device leases**: a 4-device pool shared by the serving tenant and a
   training tenant through ``DeviceLeaseBroker``: a spike makes the
   autoscaler revoke a device from training (which surrenders it as
   ``parallel.autoscale.TrainLease`` does once the elastic world has
   reshaped), and the quiet tail hands it back.

Virtual time throughout: the soak replicas are numpy-backed
(``SyntheticEngine``), so a four-minute soak costs about a second and
repeats run to run. ``DEVICE_TYPE`` is still checked (default cuda).

Usage:
    python -m dcnn_tpu_torch.examples.serve_autoscale [--seconds S] [--peak R] [--trough R]
"""

from __future__ import annotations

import argparse

from ..obs.exposition import render_scalar
from ..obs.registry import MetricsRegistry
from ..serve import (
    Autoscaler, AutoscalerConfig, DeviceLeaseBroker, Router, RouterMetrics,
)
from ..serve.soak import (
    ManualClock, make_soak_replica_factory, run_diurnal_soak,
)
from ..serve.traffic import diurnal
from .common import env_device


def soak_demo(seconds: float, peak: float, trough: float) -> dict:
    print(f"\n--- diurnal soak: {peak:g} rps peak / {trough:g} rps trough "
          f"({peak / trough:g}x), {seconds:g}s virtual ---")
    rate = diurnal(peak, trough, period_s=seconds)
    last = [1]

    def on_tick(t, fleet):
        if fleet != last[0]:
            arrow = "grew" if fleet > last[0] else "shrank"
            print(f"  t={t:6.1f}s  offered {rate(t):6.1f} rps  "
                  f"fleet {arrow} {last[0]} -> {fleet}")
            last[0] = fleet

    report, scaler, router = run_diurnal_soak(
        seconds=seconds, period=seconds, peak=peak, trough=trough,
        on_tick=on_tick)
    try:
        print(f"  accepted={report['accepted']} "
              f"completed={report['completed']} "
              f"typed_failures={report['typed_failures']} "
              f"silently_dropped={report['silently_dropped']}")
        print(f"  availability={report['availability']:.6f}  "
              f"slo_violation_minutes={report['slo_violation_minutes']:.3f}")
        print(f"  scale_ups={report['scale_ups']} "
              f"scale_downs={report['scale_downs']} "
              f"peak_fleet={report['peak_fleet']} "
              f"final_fleet={report['final_fleet']}")
        if report["reaction_max_s"] is not None:
            print(f"  worst scale-up reaction: "
                  f"{report['reaction_max_s']:.1f}s "
                  f"(cooldown budget {scaler.cfg.up_cooldown_s:g}s)")
    finally:
        _close(router)
    return report


def _close(router) -> None:
    router.shutdown(drain=False)
    for rep in router.replicas().values():
        rep.close()


def lease_demo() -> None:
    print("\n--- device leases: serving vs training on a 4-device pool ---")
    reg = MetricsRegistry()
    broker = DeviceLeaseBroker(4, registry=reg)

    # the training tenant: holds 3 devices, surrenders on revocation the
    # way parallel.autoscale.TrainLease does after the elastic reshape
    def on_revoke(k: int) -> None:
        print(f"  training asked to surrender {k} device(s) "
              f"(elastic world reshapes, then releases)")
        broker.release("train", k)

    broker.register("train", priority=0, held=3, on_revoke=on_revoke)
    broker.register("serve", priority=1, held=1)
    print(f"  bootstrap: {broker!r}")

    fc = ManualClock()
    factory = make_soak_replica_factory(fc, prefix="lease")
    router = Router([factory(1)], clock=fc,
                    sleep=lambda s: fc.advance(s),
                    metrics=RouterMetrics(clock=fc))
    scaler = Autoscaler(
        router, factory,
        config=AutoscalerConfig(up_cooldown_s=0.0, down_cooldown_s=0.0,
                                breach_ticks=1, idle_ticks=1,
                                max_replicas=2),
        broker=broker, tenant="serve", clock=fc,
        scrape=lambda n, r: None)
    # a breach without traffic: the scrape returns a loaded exposition
    breach = "\n".join(
        render_scalar("serve_queue_depth", "gauge", 30.0)
        + render_scalar("serve_latency_window_p99_ms", "gauge", 900.0)
        + render_scalar("serve_shed_fraction", "gauge", 0.0)) + "\n"
    scaler.scrape = lambda n, r: breach
    out = scaler.tick()   # spike: wants a 2nd replica, pool is empty
    print(f"  spike tick: action={out['action']} "
          f"({scaler.blocked_reason or 'ok'})")
    fc.advance(1.0)
    out = scaler.tick()   # training surrendered: the lease is free now
    print(f"  retry tick: action={out['action']}  {broker!r}")
    idle = "\n".join(
        render_scalar("serve_queue_depth", "gauge", 0.0)
        + render_scalar("serve_latency_window_p99_ms", "gauge", 1.0)
        + render_scalar("serve_shed_fraction", "gauge", 0.0)) + "\n"
    scaler.scrape = lambda n, r: idle
    fc.advance(1.0)
    out = scaler.tick()   # load receded: drain-then-remove, lease back
    got = broker.request("train", 1)
    print(f"  quiet tick: action={out['action']}  training re-grew "
          f"+{got}  {broker!r}")
    _close(router)


def main(argv=None) -> dict:
    env_device()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=240.0,
                    help="virtual soak length = diurnal period")
    ap.add_argument("--peak", type=float, default=200.0)
    ap.add_argument("--trough", type=float, default=20.0)
    args = ap.parse_args(argv)
    print("=== serve_autoscale: telemetry-driven fleet sizing ===")
    report = soak_demo(args.seconds, args.peak, args.trough)
    lease_demo()
    print("\ndone")
    return report


if __name__ == "__main__":
    main()
