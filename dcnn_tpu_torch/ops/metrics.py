"""Accuracy metrics (counterpart of ``dcnn_tpu/ops/metrics.py``): one
argmax-compare-reduce that stays on the tensor's device."""

from __future__ import annotations

import torch


def correct_count(predictions: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Number of rows where argmax(pred) == argmax(target). Targets may be
    one-hot (rank 2) or integer class labels (rank 1)."""
    pred_cls = torch.argmax(predictions, dim=-1)
    target_cls = targets if targets.ndim == 1 else torch.argmax(targets, dim=-1)
    return (pred_cls == target_cls).sum()


def accuracy(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return correct_count(predictions, targets) / predictions.shape[0]
