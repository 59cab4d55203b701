"""Optimizers and learning-rate schedulers (counterpart of
``dcnn_tpu/optim``)."""

from .optimizers import SGD, Adam, AdamW, Optimizer, OptimizerFactory
from .schedulers import (
    CosineAnnealingLR, CosineAnnealingWarmRestarts, ExponentialLR,
    LinearWarmup, MultiStepLR, OneCycleLR, PolynomialLR, ReduceLROnPlateau,
    SchedulerFactory, StepLR, WarmupCosineAnnealing,
)

__all__ = [
    "Optimizer", "SGD", "Adam", "AdamW", "OptimizerFactory",
    "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
    "CosineAnnealingWarmRestarts", "LinearWarmup", "WarmupCosineAnnealing",
    "ReduceLROnPlateau", "PolynomialLR", "OneCycleLR", "SchedulerFactory",
]
