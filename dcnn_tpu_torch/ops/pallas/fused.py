"""Fused per-channel scale/bias/ReLU (counterpart of
``dcnn_tpu/ops/pallas/fused.py``): ``y = max(x·scale + bias, 0)``, the
BN-inference epilogue, with scale and bias broadcast over the last axis.

On CUDA tensors it launches the hand-written Hopper kernel in
``ops/csrc/fused.cu`` (or raises); on CPU tensors it runs the plain
version, the same composition in x's type, through the op
``dcnn::fused_scale_bias_relu`` (:mod:`~dcnn_tpu_torch.ops.library`).
There is no other route. x may have any leading shape and any number of
rows and channels.
"""

from __future__ import annotations

import torch

from .. import library


def scale_bias_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``max(x·scale + bias, 0)`` in x's type."""
    return torch.clamp_min(x * scale + bias, 0.0).to(x.dtype)


def fused_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``max(x·scale + bias, 0)`` over the last (channel) axis. ``x``:
    (..., C); ``scale`` and ``bias``: (C,)."""
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_scale_bias_relu: scale {tuple(scale.shape)} "
                         f"and bias {tuple(bias.shape)} must be ({c},)")
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"fused_scale_bias_relu: no implementation for "
                           f"{x.device}")
    return library.fused_scale_bias_relu(x, scale, bias)
