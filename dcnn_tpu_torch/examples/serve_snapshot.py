"""Online serving driver (counterpart of ``examples/serve_snapshot.py``):
the committed digits28 snapshot behind the dynamic batcher, under open-loop
traffic.

``InferenceEngine`` (a CUDA graph a batch bucket on the card) behind a
``DynamicBatcher`` (bounded queue, batching window, load shedding); for
each offered load the latency, throughput, occupancy and shed table, and
the top-1 of everything served on the digits28 test split: batching must
not change answers (a served top-1 under 0.98 fails the run).

Usage:
    python -m dcnn_tpu_torch.examples.serve_snapshot [snapshot_dir] [--metrics-port N]

``--metrics-port N`` (or ``METRICS_PORT``) serves ``/metrics``,
``/healthz`` and ``/snapshot`` for the whole run (``N=0``: an ephemeral
port, printed). Env: ``INT8=1`` serves the int8 PTQ graph (calibrated on
the train split); ``SERVE_LOADS`` offered rps, comma-separated (default
"100,300,900"); ``SERVE_SECONDS`` a load's window (default 2.0);
``SERVE_MAX_BATCH`` (16), ``SERVE_WAIT_MS`` (2.0), ``SERVE_QUEUE`` (4x the
max batch).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..data import MNISTDataLoader, decode_host
from ..data.digits28 import ensure_digits28_csvs
from ..serve import DynamicBatcher, InferenceEngine, ServeMetrics
from ..serve import open_loop as run_open_loop
from ..train import load_checkpoint
from .common import ROOT, device_of, setup

SERVED_TOP1_GATE = 0.98


def main(argv=None) -> dict:
    cfg = setup("serve_snapshot")
    dev = device_of(cfg.device_type)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot_dir", nargs="?", default=os.path.join(
        ROOT, "model_snapshots", "mnist_cnn_model"))
    ap.add_argument("--metrics-port", type=int,
                    default=int(os.environ.get("METRICS_PORT", "-1")),
                    help="expose /metrics /healthz /snapshot over HTTP "
                         "(0 = ephemeral; default off)")
    args = ap.parse_args(argv)
    csv_dir = ensure_digits28_csvs(ROOT)

    model, _, _, meta = load_checkpoint(args.snapshot_dir, device=dev)
    fmt = ("NCHW" if model.input_shape[0] <= model.input_shape[-1]
           else "NHWC")
    val = MNISTDataLoader(os.path.join(csv_dir, "test.csv"), data_format=fmt,
                          batch_size=256, shuffle=False, drop_last=False)
    val.load_data()
    xs, ys = [], []
    for xb, yb in val:
        # the wire carries uint8; the engine takes model-domain float32
        xs.append(decode_host(np.asarray(xb), val.scale))
        ys.append(np.asarray(yb))
    samples = np.concatenate(xs)
    labels = np.concatenate(ys).argmax(-1)

    max_batch = int(os.environ.get("SERVE_MAX_BATCH", "16"))
    wait_ms = float(os.environ.get("SERVE_WAIT_MS", "2.0"))
    qcap = int(os.environ.get("SERVE_QUEUE", str(4 * max_batch)))
    int8 = os.environ.get("INT8", "0") == "1"
    calib = None
    if int8:
        # calibrated on the train split, never the one reported
        cal = MNISTDataLoader(os.path.join(csv_dir, "train.csv"),
                              data_format=fmt, batch_size=512,
                              shuffle=False, drop_last=False)
        cal.load_data()
        calib = decode_host(np.asarray(next(iter(cal))[0]), cal.scale)
    t0 = time.perf_counter()
    engine = InferenceEngine.from_model(model, int8_calib=calib,
                                        max_batch=max_batch, device=dev)
    print(f"engine: {engine} (metadata {meta})")
    print(f"  sessions built and warm in {time.perf_counter() - t0:.2f}s: "
          + ", ".join(f"b{b}={st['compile_s']:.2f}s"
                      for b, st in engine.compile_stats.items()))

    loads = [float(v) for v in
             os.environ.get("SERVE_LOADS", "100,300,900").split(",")]
    seconds = float(os.environ.get("SERVE_SECONDS", "2.0"))

    telemetry = None
    if args.metrics_port >= 0:
        # the points' ServeMetrics pool their instruments into the
        # process-global registry the server scrapes
        from ..obs import TelemetryServer, get_registry

        telemetry = TelemetryServer(registry=get_registry(),
                                    port=args.metrics_port).start()
        print(f"telemetry: {telemetry.url}/metrics /healthz /snapshot")

    print(f"\nopen-loop traffic: {seconds:.1f}s per point, max_wait "
          f"{wait_ms:g} ms, queue {qcap} samples "
          f"({'int8' if int8 else 'folded float'} graph)")
    hdr = (f"{'offered rps':>12} {'achieved rps':>13} {'p50 ms':>8} "
           f"{'p95 ms':>8} {'p99 ms':>8} {'occupancy':>10} {'shed':>7} "
           f"{'top-1':>7}")
    print(hdr)
    print("-" * len(hdr))
    points = []
    try:
        for rps in loads:
            if telemetry is not None:
                from ..obs import get_registry
                metrics = ServeMetrics(registry=get_registry())
            else:
                metrics = ServeMetrics()
            batcher = DynamicBatcher(engine, max_wait_ms=wait_ms,
                                     queue_capacity=qcap, metrics=metrics)
            futs = run_open_loop(batcher, samples, rps, seconds)
            batcher.drain(timeout=120)
            s = metrics.snapshot()
            hits = sum(int(np.asarray(f.result()).argmax() == labels[i])
                       for i, f in futs)
            acc = hits / len(futs) if futs else float("nan")
            print(f"{rps:>12.0f} {s['throughput_rps']:>13.1f} "
                  f"{s['p50_ms']:>8.2f} {s['p95_ms']:>8.2f} "
                  f"{s['p99_ms']:>8.2f} {s['batch_occupancy']:>10.2f} "
                  f"{s['shed_fraction']:>6.1%} {acc:>7.4f}")
            points.append({"offered_rps": rps, "served": len(futs),
                           "top1": acc, **{k: s[k] for k in (
                               "throughput_rps", "p50_ms", "p99_ms",
                               "batch_occupancy", "shed_fraction")}})
            if acc == acc and acc < SERVED_TOP1_GATE:
                raise SystemExit(f"served accuracy {acc} below gate at "
                                 f"{rps} rps")
    finally:
        if telemetry is not None:
            telemetry.stop()
    return {"int8": int8, "points": points}


if __name__ == "__main__":
    main()
