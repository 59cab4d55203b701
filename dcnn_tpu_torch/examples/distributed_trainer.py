"""Multi-process pipeline coordinator (counterpart of
``examples/distributed_trainer.py``): owns the whole model, deploys one
stage to each ``network_worker`` process over TCP, and trains on synthetic
data under the sync or semi-async schedule.

Env: WORKERS (comma-separated host:port, one stage a worker; required),
SCHEDULE=sync|semi_async, MODEL (zoo name, default cifar10_cnn_v1),
NUM_MICROBATCHES, plus the TrainingConfig variables (DEVICE_TYPE, EPOCHS,
...). ``launch_pipeline.sh`` starts the workers and this coordinator.

    WORKERS=127.0.0.1:9601,127.0.0.1:9602 python -m dcnn_tpu_torch.examples.distributed_trainer
"""

import sys

import torch

from ..core.keys import fold_in
from ..data import SyntheticClassificationLoader
from ..models import create_model
from ..ops.metrics import correct_count
from ..optim import Adam
from ..parallel import (DistributedPipelineCoordinator,
                        FlopBalancedPartitioner)
from ..utils.env import get_env
from .common import device_of, setup


def main() -> list:
    cfg = setup("distributed_trainer")
    dev = device_of(cfg.device_type)
    workers = [w for w in get_env("WORKERS", "").split(",") if w]
    if not workers:
        sys.exit("WORKERS=host:port,host:port,... is required")
    schedule = get_env("SCHEDULE", "semi_async")
    model_name = get_env("MODEL", "cifar10_cnn_v1")

    model = create_model(model_name)
    num_classes = model.output_shape()[0]
    loader = SyntheticClassificationLoader(
        1024, model.input_shape, num_classes,
        batch_size=cfg.batch_size, seed=cfg.seed)

    coord = DistributedPipelineCoordinator(
        model, Adam(cfg.learning_rate), "softmax_crossentropy",
        workers=workers, partitioner=FlopBalancedPartitioner(),
        num_microbatches=cfg.num_microbatches or 4, track_load=True,
        device=dev)
    coord.deploy_stages(torch.Generator().manual_seed(cfg.seed))
    print(f"deployed {len(workers)} stages to {workers}, schedule={schedule}")

    fn = (coord.train_batch_semi_async if schedule == "semi_async"
          else coord.train_batch_sync)
    history = []
    try:
        for epoch in range(1, cfg.epochs + 1):
            loader.shuffle(epoch)
            tot_loss = tot_correct = tot_n = 0
            for bi, (x, y) in enumerate(loader):
                loss, logits = fn(x, y, cfg.learning_rate,
                                  fold_in(fold_in(cfg.seed, epoch), bi))
                tot_loss += loss * x.shape[0]
                tot_correct += int(correct_count(
                    logits, torch.as_tensor(y).to(logits.device)))
                tot_n += x.shape[0]
            print(f"epoch {epoch}: loss {tot_loss / tot_n:.4f} "
                  f"acc {tot_correct / tot_n:.4f}")
            for sid, rep in enumerate(coord.collect_load_reports()):
                print(f"  stage {sid}: fwd {rep['avg_forward_ms']:.2f}ms "
                      f"bwd {rep['avg_backward_ms']:.2f}ms")
            history.append({"epoch": epoch, "loss": tot_loss / tot_n,
                            "acc": tot_correct / tot_n})
    finally:
        coord.shutdown()
    return history


if __name__ == "__main__":
    main()
