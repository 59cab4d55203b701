"""Symmetric int8 quantization (counterpart of ``dcnn_tpu/ops/quant.py``).

Symmetric scales only, no zero points. Weights are quantized per output
channel (the leading axis of OIHW conv and (out, in) dense weights),
activations per tensor with a static calibrated scale. Every function
rounds as the JAX one does, so the two packages give the same int8 values
from the same float inputs.

:func:`dense_int8` is int8 × int8 → int32. On a CUDA tensor it is
``torch._int_mm`` (cuBLASLt's int8 GEMM), padded with zero rows and
columns where its shape rules refuse a shape (padding adds exact zeros);
on a CPU tensor it is the plain version, a float64 product cast to int32,
exact because every partial sum is an integer below 2^53.

:func:`quant_conv2d` is the whole int8 conv layer: quantize the float input,
the exact int8 conv, dequantize with the bias, in the JAX order
(``dcnn_tpu/nn/quantize.py`` ``QuantConv2DLayer.apply``). On a CUDA tensor
it is one launch of ``csrc/conv_int8.cu``'s fused mode (two where K is
split), bit for bit the chain; on a CPU tensor the chain itself,
:func:`quant_conv2d_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import library
from .conv import _pair, conv2d_int8_reference

# int8 symmetric range; -128 is left out so that the range is symmetric
QMAX = 127.0


def quantize_symmetric(x: torch.Tensor, scale) -> torch.Tensor:
    """``round(x / scale)`` clipped to [-127, 127], as int8. The division
    is in fp32 and the rounding half to even, as ``jnp.round`` rounds.
    ``scale`` broadcasts against ``x``."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def channel_scales(w: torch.Tensor, *, floor: float = 1e-8) -> torch.Tensor:
    """Per-output-channel scales ``max(|w|, floor) / 127`` over every axis
    but the leading one; ``floor`` keeps an all-zero channel's scale
    above 0."""
    absmax = torch.amax(w.float().abs(), dim=tuple(range(1, w.ndim)))
    return torch.clamp_min(absmax, floor) / QMAX


def quantile_linear(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a.ravel(), q)`` with its default linear
    interpolation, computed as JAX computes it in fp32: the sorted values
    at ``floor`` and ``ceil`` of ``q · (n − 1)``, weighted by the
    fractional part. ``torch.quantile`` refuses inputs above 2^24
    elements; this has no such limit."""
    v = torch.sort(a.reshape(-1).float()).values
    n = v.numel()
    qn = torch.tensor(q, dtype=torch.float32) * (
        torch.tensor(n, dtype=torch.float32) - 1)
    low, high = torch.floor(qn), torch.ceil(qn)
    hw = qn - low
    lw = 1 - hw
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    return v[lo].cpu() * lw + v[hi].cpu() * hw


def tensor_scale(x: torch.Tensor, *, floor: float = 1e-8,
                 quantile: Optional[float] = None) -> torch.Tensor:
    """Per-tensor scale from a calibration sample: ``max(|x|)`` (default)
    or the ``quantile`` of ``|x|``, floored, over 127. A 0-d fp32 tensor
    on the CPU."""
    a = x.float().abs()
    amax = a.max().cpu() if quantile is None else quantile_linear(a, quantile)
    return torch.clamp_min(amax, floor) / QMAX


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_q int8, per-leading-channel fp32 scales)."""
    s = channel_scales(w)
    return quantize_symmetric(w, s.reshape((-1,) + (1,) * (w.ndim - 1))), s


def dense_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x_q · w_qᵀ`` in float64, cast to int32 (exact: each
    sum is at most K · 127² in magnitude)."""
    return torch.matmul(x_q.double(), w_q.double().t()).to(torch.int32)


# torch._int_mm's shape rules on CUDA: more than 16 rows, and K and N
# multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _int_mm_padded(x2: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x2 (M, K) · w_q (N, K)ᵀ`` through ``torch._int_mm`` on CUDA, with
    zero rows and columns added where its shape rules need them and cut
    off again."""
    m, k = x2.shape
    n = w_q.shape[0]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        x2 = F.pad(x2, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w_q = F.pad(w_q, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(x2.contiguous(), w_q.contiguous().t())
    return y[:m, :n] if (mp, np_) != (m, n) else y


def dense_int8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 × int8 → int32: ``y = x_q · w_qᵀ`` with ``w_q`` stored (out, in)
    like the dense layer, over the last axis of ``x_q`` (any leading
    shape)."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"dense_int8 expects int8 operands, got "
                        f"{x_q.dtype}/{w_q.dtype}")
    if x_q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"dense_int8: no implementation for {x_q.device}")
    return library.dense_int8(x_q, w_q)


def quant_conv2d_reference(x: torch.Tensor, x_scale: torch.Tensor,
                           w_q: torch.Tensor, w_scale: torch.Tensor,
                           b: Optional[torch.Tensor], *, stride=1, padding=0,
                           data_format: str = "NCHW") -> torch.Tensor:
    """Plain version of :func:`quant_conv2d`, the JAX layer's chain:
    ``quantize_symmetric`` of x, the int8 conv (float64, exact), then
    ``y · (x_scale · w_scale) + b`` with the scale product rounded once,
    cast to x's dtype."""
    x_q = quantize_symmetric(x, x_scale)
    y = conv2d_int8_reference(x_q, w_q, stride=stride, padding=padding,
                              data_format=data_format)
    shape = [1] * 4
    shape[1 if data_format == "NCHW" else 3] = -1
    y = y.float() * (x_scale * w_scale).reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y.to(x.dtype)


def quant_conv2d(x: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                 w_scale: torch.Tensor, b: Optional[torch.Tensor], *,
                 stride=1, padding=0, data_format: str = "NCHW",
                 packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The int8 conv layer on float ``x`` (NCHW or NHWC): per-tensor input
    scale ``x_scale`` (fp32, one element), OIHW int8 ``w_q`` with fp32
    per-channel ``w_scale``, fp32 bias ``b`` or None; returns x's dtype.
    ``packed``: the kernel's operands made once by the caller,
    (``_kernels.pack_int8_weight(w_q)``, ``x_scale · w_scale`` in fp32);
    made here where None. The plain version needs neither."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"quant_conv2d: no implementation for {x.device}")
    if packed is None:  # the plain version needs no packed weights
        packed = (library.pack_int8_weight(w_q) if x.device.type == "cuda"
                  else None, (x_scale * w_scale).float())
    wk, scale = packed
    return library.conv_int8_fused(x, x_scale, w_q, scale, b,
                                   list(_pair(stride)), list(_pair(padding)),
                                   data_format, wk)
