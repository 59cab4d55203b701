"""Normalization (counterpart of ``dcnn_tpu/ops/norm.py``).

``batch_norm`` keeps the JAX package's formula rather than
``F.batch_norm``'s: statistics in fp32 (fp64 for fp64 inputs), one-pass
sums taken over ``x − running_mean``, the variance clamped at 0, an
unbiased batch variance into the running buffer, and
``running = (1 − momentum)·running + momentum·batch``. ``group_norm`` stays
two-pass, as there.

Inside :func:`reduce_batch_stats` a training ``batch_norm`` hands its
per-channel sums and row count to a reducer before it uses them: the
mesh data-parallel step's all-reduce, so that the statistics are the
global batch's, as GSPMD makes them in the JAX package. Under a spatial
context (:mod:`.spatial`) on a sharded activation, the sums and count
go over the context's (data, sp) plane instead, and ``group_norm``'s
per-sample sums (both passes) over its sp axis.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch

from . import spatial as _spatial

_REDUCER = threading.local()


@contextlib.contextmanager
def reduce_batch_stats(reducer: Callable):
    """While active on this thread, a training ``batch_norm`` replaces its
    one-pass sums ``(s1, s2, n)`` (per-channel sums of ``x − pivot`` and
    of its square, and the rows a channel counts) by ``reducer(s1, s2,
    n)``."""
    prev = getattr(_REDUCER, "fn", None)
    _REDUCER.fn = reducer
    try:
        yield
    finally:
        _REDUCER.fn = prev


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
        sp = _spatial.current()
        reducer = getattr(_REDUCER, "fn", None)
        if sp is not None:
            s1, s2, n = sp.batch_stats(s1, s2, n)
        elif reducer is not None:
            s1, s2, n = reducer(s1, s2, n)
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
    sp = _spatial.current()
    if sp is None:
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    else:  # dim 2 sharded: both passes' sums over the sp axis
        count = (c // num_groups) * h * w * sp.size
        mean = sp.axis_sum(xg.sum(dim=(2, 3, 4), keepdim=True)) / count
        d = xg - mean
        var = sp.axis_sum((d * d).sum(dim=(2, 3, 4), keepdim=True)) / count
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    if gamma is not None:
        y = y * gamma.to(stat_dt).reshape(1, c, 1, 1)
    if beta is not None:
        y = y + beta.to(stat_dt).reshape(1, c, 1, 1)
    return y.to(x.dtype)
