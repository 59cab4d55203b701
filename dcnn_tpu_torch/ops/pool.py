"""Pooling (counterpart of ``dcnn_tpu/ops/pool.py``).

The JAX package pads a window explicitly (``lax.reduce_window``): −inf for
max pooling, 0 for average pooling. ``F.max_pool2d`` and ``F.avg_pool2d``
take at most half a window of padding, so the pad is applied here with
``F.pad`` and the pools run unpadded, which gives the same result for any
padding. A ``stride`` of ``None`` is the kernel size.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _pool(x: torch.Tensor, kernel, stride, padding, data_format: str, fn,
          pad_value: float) -> torch.Tensor:
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph), value=pad_value)
    y = fn(x, (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def max_pool2d(x: torch.Tensor, kernel: IntOrPair,
               stride: Optional[IntOrPair] = None, padding: IntOrPair = 0, *,
               data_format: str = "NCHW") -> torch.Tensor:
    """Max pool; padded cells are −inf, so they never win."""
    return _pool(x, kernel, stride, padding, data_format, F.max_pool2d,
                 -float("inf"))


def avg_pool2d(x: torch.Tensor, kernel: IntOrPair,
               stride: Optional[IntOrPair] = None, padding: IntOrPair = 0, *,
               data_format: str = "NCHW",
               count_include_pad: bool = True) -> torch.Tensor:
    """Average pool. By default a window is divided by its full size,
    padded cells included (the reference's semantics)."""
    summed_mean = _pool(x, kernel, stride, padding, data_format,
                        F.avg_pool2d, 0.0)
    if count_include_pad:
        return summed_mean
    # (sum / k²) / (real cells / k²): the window's mean over real cells
    share = _pool(torch.ones_like(x), kernel, stride, padding, data_format,
                  F.avg_pool2d, 0.0)
    return summed_mean / share


def global_avg_pool2d(x: torch.Tensor, *,
                      data_format: str = "NCHW") -> torch.Tensor:
    dims = (2, 3) if data_format == "NCHW" else (1, 2)
    return x.mean(dim=dims, keepdim=True)


def pool_output_shape(input_hw: Tuple[int, int], kernel: IntOrPair,
                      stride: Optional[IntOrPair] = None,
                      padding: IntOrPair = 0) -> Tuple[int, int]:
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    return ((input_hw[0] + 2 * ph - kh) // sh + 1,
            (input_hw[1] + 2 * pw - kw) // sw + 1)
