"""Standalone pipeline stage worker process (counterpart of
``examples/network_worker.py``): run one a stage; a
``DistributedPipelineCoordinator`` (``distributed_trainer``) connects,
ships the stage's config and weights, and drives training.

Usage:
    python -m dcnn_tpu_torch.examples.network_worker --port 9601
    WORKER_PORT=9601 python -m dcnn_tpu_torch.examples.network_worker

Flags: --port, --compress (activation compression on the wire), --device
(cuda|cpu; default ``DEVICE_TYPE``, else cuda).
"""

import argparse
import os

from ..utils.env import get_env
from .common import device_of


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dcnn_tpu_torch pipeline "
                                             "stage worker")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("WORKER_PORT", "9601")))
    ap.add_argument("--compress", action="store_true",
                    default=os.environ.get("WORKER_COMPRESS", "") == "1")
    ap.add_argument("--device", default=get_env("DEVICE_TYPE", "cuda"))
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from ..parallel.worker import run_worker

    print(f"[worker] listening on :{args.port} on {dev} "
          f"(compress={'on' if args.compress else 'off'})", flush=True)
    run_worker(args.port, compress=args.compress, device=dev)
    print("[worker] shutdown", flush=True)


if __name__ == "__main__":
    main()
