"""Training (counterpart of ``dcnn_tpu/train``): the single-device
trainer over host loaders, resident datasets and staged chunks,
checkpoints in the JAX package's format, and per-layer profiling."""

from .checkpoint import load_checkpoint, save_checkpoint
from .profiling import LayerProfiler
from .trainer import (
    TrainState, Trainer, batch_generator, create_train_state,
    evaluate_classification,
    evaluate_regression, make_eval_step, make_multi_step, make_train_step,
    train_classification_model, train_regression_model,
)

__all__ = ["LayerProfiler", "TrainState", "Trainer", "batch_generator",
           "create_train_state",
           "evaluate_classification", "evaluate_regression",
           "load_checkpoint", "make_eval_step", "make_multi_step",
           "make_train_step", "save_checkpoint",
           "train_classification_model", "train_regression_model"]
