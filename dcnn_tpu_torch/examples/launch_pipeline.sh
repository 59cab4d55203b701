#!/usr/bin/env bash
# Multi-worker pipeline launch (counterpart of examples/launch_pipeline.sh):
# N stage workers and the coordinator on one machine, over TCP. On a real
# deployment run each worker on its own host.
#
# Usage: dcnn_tpu_torch/examples/launch_pipeline.sh [num_workers] [schedule] [model]
# Env: BASE_PORT (9601), DEVICE_TYPE (cuda; cpu on request), EPOCHS (2).
set -euo pipefail
cd "$(dirname "$0")/../.."

N=${1:-2}
SCHEDULE=${2:-semi_async}
MODEL=${3:-cifar10_cnn_v1}
BASE_PORT=${BASE_PORT:-9601}
DEVICE=${DEVICE_TYPE:-cuda}
PYTHON=${PYTHON:-python3}

PIDS=()
WORKERS=""
for i in $(seq 0 $((N - 1))); do
  PORT=$((BASE_PORT + i))
  $PYTHON -m dcnn_tpu_torch.examples.network_worker --port "$PORT" \
    --device "$DEVICE" &
  PIDS+=($!)
  WORKERS+="${WORKERS:+,}127.0.0.1:$PORT"
done
trap 'kill "${PIDS[@]}" 2>/dev/null || true' EXIT

DEVICE_TYPE=$DEVICE WORKERS=$WORKERS SCHEDULE=$SCHEDULE MODEL=$MODEL \
  EPOCHS=${EPOCHS:-2} $PYTHON -m dcnn_tpu_torch.examples.distributed_trainer
