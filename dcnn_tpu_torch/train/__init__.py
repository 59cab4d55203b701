"""Training (counterpart of ``dcnn_tpu/train``; this slice ports the
single-device trainer over host loaders)."""

from .trainer import (
    TrainState, Trainer, batch_generator, create_train_state,
    evaluate_classification,
    evaluate_regression, make_eval_step, make_train_step,
    train_classification_model, train_regression_model,
)

__all__ = ["TrainState", "Trainer", "batch_generator", "create_train_state",
           "evaluate_classification", "evaluate_regression",
           "make_eval_step", "make_train_step",
           "train_classification_model", "train_regression_model"]
