"""Elementwise and reduction op set (counterpart of
``dcnn_tpu/ops/elementwise.py``), name for name: add, sub, mul, div, the
fused multiply-adds, the scalar variants, set/axpy/sqrt/rsqrt/rcp/abs/min/
max/scalar_max/clamp/equal/greater/copy/zero, the reductions (sum,
dot_product, sum_squared_diff, norm_squared), the random fills, transpose_2d
and the layout moves. Each is one PyTorch expression in the input's dtype;
none carries a kernel of its own. The random fills draw from a
``torch.Generator`` where the JAX ones take a key, so the two packages give
different numbers from one seed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


# -- binary elementwise --
def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def mul(a, b):
    return a * b


def div(a, b):
    return a / b


# -- fused multiply-add family: a*b + c, a*b - c, c - a*b --
def fmadd(a, b, c):
    return a * b + c


def fmsub(a, b, c):
    return a * b - c


def fnmadd(a, b, c):
    return c - a * b


# -- scalar variants --
def add_scalar(a, s):
    return a + s


def sub_scalar(a, s):
    return a - s


def mul_scalar(a, s):
    return a * s


def div_scalar(a, s):
    return a / s


def set_scalar(a, s):
    return torch.full_like(a, s)


def mul_add_scalar(a, mul_s, add_s):
    return a * mul_s + add_s


def sub_mul_scalar(a, sub_s, mul_s):
    return (a - sub_s) * mul_s


def axpy(alpha, x, y):
    return alpha * x + y


# -- unary --
def sqrt(a):
    return torch.sqrt(a)


def rsqrt(a):
    return torch.rsqrt(a)


def rcp(a):
    return 1.0 / a


def abs(a):  # noqa: A001 - name for name with the JAX package
    return torch.abs(a)


def copy(a):
    return torch.as_tensor(a).clone()


def zero(a):
    return torch.zeros_like(a)


# -- comparisons and clamps --
def min(a, b):  # noqa: A001
    return torch.minimum(a, b)


def max(a, b):  # noqa: A001
    return torch.maximum(a, b)


def scalar_max(a, s):
    return torch.clamp_min(a, s)


def clamp(a, lo, hi):
    return torch.clamp(a, lo, hi)


def equal(a, b):
    return (a == b).to(a.dtype)


def greater(a, b):
    return (a > b).to(a.dtype)


# -- reductions --
def sum(a):  # noqa: A001
    return torch.sum(a)


def dot_product(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def sum_squared_diff(a, b):
    d = a - b
    return torch.sum(d * d)


def norm_squared(a):
    return torch.sum(a * a)


# -- random fills, from an explicit generator --
def fill_random_uniform(generator: Optional[torch.Generator],
                        shape: Sequence[int], lo, hi,
                        dtype: torch.dtype = torch.float32):
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return u * (hi - lo) + lo


def fill_random_normal(generator: Optional[torch.Generator],
                       shape: Sequence[int], mean=0.0, std=1.0,
                       dtype: torch.dtype = torch.float32):
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    dtype=dtype)


# -- layout moves --
def transpose_2d(a):
    return torch.swapaxes(a, -1, -2)


def nchw_to_cnhw(a):
    """(N, C, H, W) -> (C, N, H, W)."""
    return a.permute(1, 0, 2, 3)


def cnhw_to_nchw(a):
    return a.permute(1, 0, 2, 3)


def nchw_to_nhwc(a):
    return a.permute(0, 2, 3, 1)


def nhwc_to_nchw(a):
    return a.permute(0, 3, 1, 2)
