"""Normalization (counterpart of ``dcnn_tpu/ops/norm.py``).

``batch_norm`` keeps the JAX package's formula rather than
``F.batch_norm``'s: statistics in fp32 (fp64 for fp64 inputs), one-pass
sums taken over ``x − running_mean``, the variance clamped at 0, an
unbiased batch variance into the running buffer, and
``running = (1 − momentum)·running + momentum·batch``. ``group_norm`` stays
two-pass, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               training: bool, momentum: float = 0.1, eps: float = 1e-5,
               data_format: str = "NCHW"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y, new_running_mean, new_running_var). Training mode
    normalizes with the batch statistics over every axis but the channel
    axis (1 under NCHW, 3 under NHWC) and returns updated running stats;
    eval mode uses the running stats and returns them unchanged."""
    c_axis = 1 if data_format == "NCHW" else 3
    reduce_axes = tuple(i for i in range(x.ndim) if i != c_axis)
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    stat_dt = _stat_dtype(x)
    xf = x.to(stat_dt)
    if training:
        # sums pivoted on running_mean, an input independent of x, so that
        # E[x²] − mean² does not cancel when |mean| >> std
        n = x.numel() // x.shape[c_axis]
        pivot = running_mean.to(stat_dt)
        xs = xf - pivot.reshape(shape)
        s1 = xs.sum(reduce_axes)
        s2 = (xs * xs).sum(reduce_axes)
        mean_c = s1 / n
        var = torch.clamp_min(s2 / n - mean_c * mean_c, 0.0)
        mean = mean_c + pivot
        unbiased = var * (n / max(n - 1, 1))
        new_mean = ((1 - momentum) * running_mean
                    + momentum * mean).to(running_mean.dtype)
        new_var = ((1 - momentum) * running_var
                   + momentum * unbiased).to(running_var.dtype)
    else:
        mean, var = running_mean.to(stat_dt), running_var.to(stat_dt)
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    y = (xf - mean.reshape(shape)) * inv.reshape(shape)
    y = y * gamma.to(stat_dt).reshape(shape) + beta.to(stat_dt).reshape(shape)
    return y.to(x.dtype), new_mean, new_var


def group_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor], num_groups: int, *,
               eps: float = 1e-5, data_format: str = "NCHW") -> torch.Tensor:
    """Per-sample, per-group normalization over (C/G, H, W), two-pass."""
    if data_format == "NHWC":
        y = group_norm(x.permute(0, 3, 1, 2), gamma, beta, num_groups,
                       eps=eps, data_format="NCHW")
        return y.permute(0, 2, 3, 1)
    n, c, h, w = x.shape
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    stat_dt = _stat_dtype(x)
    xg = x.to(stat_dt).reshape(n, num_groups, c // num_groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    if gamma is not None:
        y = y * gamma.to(stat_dt).reshape(1, c, 1, 1)
    if beta is not None:
        y = y + beta.to(stat_dt).reshape(1, c, 1, 1)
    return y.to(x.dtype)
