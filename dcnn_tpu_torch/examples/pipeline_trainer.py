"""Pipeline-parallel trainer in one process (counterpart of
``examples/pipeline_trainer.py``): the model split into stages by a
FLOP-balanced partitioner, the stages on the process's CUDA devices
(round robin; on one card, streams of that card) or on the CPU, and
trained on synthetic data under the sync (GPipe) or semi-async schedule,
with per-stage load reports.

Env: NUM_STAGES (default 2), SCHEDULE=sync|semi_async, NUM_MICROBATCHES,
MODEL (zoo name, default resnet9_cifar10), PIPELINE_PROFILE=1 (per-layer
tables), plus the TrainingConfig variables (DEVICE_TYPE, EPOCHS, ...).

    python -m dcnn_tpu_torch.examples.pipeline_trainer
"""

import torch

from ..core.device import device_count
from ..core.keys import fold_in
from ..data import SyntheticClassificationLoader
from ..models import create_model
from ..optim import Adam
from ..parallel import FlopBalancedPartitioner, InProcessPipelineCoordinator
from ..parallel.pipeline import train_pipeline_epoch
from ..utils.env import get_env
from .common import device_of, setup


def main() -> list:
    cfg = setup("pipeline_trainer")
    dev = device_of(cfg.device_type)
    num_stages = get_env("NUM_STAGES", 2)
    schedule = get_env("SCHEDULE", "semi_async")
    model_name = get_env("MODEL", "resnet9_cifar10")

    model = create_model(model_name)
    shape = model.input_shape
    num_classes = model.output_shape()[0]

    train_loader = SyntheticClassificationLoader(
        1024, shape, num_classes, batch_size=cfg.batch_size, seed=cfg.seed)

    if dev.type == "cuda":
        n = device_count()
        devices = [f"cuda:{i % n}" for i in range(num_stages)]
    else:
        devices = ["cpu"] * num_stages
    coord = InProcessPipelineCoordinator(
        model, Adam(cfg.learning_rate), "softmax_crossentropy",
        num_stages=num_stages, partitioner=FlopBalancedPartitioner(),
        devices=devices, num_microbatches=cfg.num_microbatches or 4,
        track_load=True)
    coord.deploy_stages(torch.Generator().manual_seed(cfg.seed))
    print(f"partitions: {coord.partitions} over devices {devices} "
          f"schedule={schedule}")

    history = []
    for epoch in range(1, cfg.epochs + 1):
        train_loader.shuffle(epoch)
        loss, acc = train_pipeline_epoch(coord, train_loader,
                                         cfg.learning_rate,
                                         fold_in(cfg.seed, epoch), schedule)
        print(f"epoch {epoch}: loss {loss:.4f} acc {acc:.4f}")
        for sid, rep in enumerate(coord.collect_load_reports()):
            print(f"  stage {sid}: fwd {rep['avg_forward_ms']:.2f}ms "
                  f"bwd {rep['avg_backward_ms']:.2f}ms")
        if get_env("PIPELINE_PROFILE", 0):
            # each stage's per-layer table
            from ..parallel.pipeline import format_profiling
            print(format_profiling(coord.collect_profiling()))
            coord.clear_profiling()
        history.append({"epoch": epoch, "loss": loss, "acc": acc})
    return history


if __name__ == "__main__":
    main()
