"""2-D convolution (counterpart of ``dcnn_tpu/ops/conv.py``).

Weights are OIHW whatever the activation layout, as in the JAX package;
activations are NCHW or NHWC. An NHWC tensor is a logical (N, H, W, C)
tensor: it is handed to ``F.conv2d`` as an NCHW view with channels-last
strides (no copy when it is contiguous) and comes back as a logical NHWC
tensor. ``F.conv2d`` is the platform conv, as ``lax.conv_general_dilated``
is the JAX package's; the hand-written 3×3 kernels live in
:mod:`.pallas.conv`. The explicit gradient functions are autograd's
vector-Jacobian products of :func:`conv2d`, as the JAX ones are
``jax.vjp`` of theirs.

:func:`conv2d_int8` is int8 × int8 → int32 with the same geometry. No
PyTorch call computes it (``F.conv2d`` on int8 wraps in int8 on the CPU
and is not implemented on CUDA), so on a CUDA tensor it launches the
hand-written kernel ``csrc/conv_int8.cu`` (or raises), and on a CPU tensor
it runs the plain version, ``F.conv2d`` in float64 cast to int32, exact
because every partial sum is an integer below 2^53.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import library

IntOrPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride: IntOrPair = 1, padding: IntOrPair = 0,
           data_format: str = "NCHW") -> torch.Tensor:
    """Forward conv. ``w`` is OIHW; ``padding`` is symmetric int(s), not a
    string. In bf16 the conv is rounded to bf16 first and the bias added
    after, rounded again, as the JAX op adds ``b`` after ``lax.conv``; in
    fp32 the bias goes into the conv's call (one kernel fewer)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    apart = b is not None and x.dtype == torch.bfloat16
    y = F.conv2d(x, w, None if apart else b, stride=_pair(stride),
                 padding=_pair(padding))
    if apart:
        y = y + b.view(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d_int8_reference(x_q: torch.Tensor, w_q: torch.Tensor, *,
                          stride: IntOrPair = 1, padding: IntOrPair = 0,
                          data_format: str = "NCHW") -> torch.Tensor:
    """Plain version of :func:`conv2d_int8`: the conv in float64, cast
    to int32."""
    y = conv2d(x_q.double(), w_q.double(), stride=stride, padding=padding,
               data_format=data_format)
    return y.to(torch.int32)


def conv2d_int8(x_q: torch.Tensor, w_q: torch.Tensor, *,
                stride: IntOrPair = 1, padding: IntOrPair = 0,
                data_format: str = "NCHW") -> torch.Tensor:
    """int8 × int8 → int32 convolution: :func:`conv2d`'s geometry (OIHW
    weights, symmetric int padding, NCHW or NHWC), no bias; the caller
    owns the scales."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"conv2d_int8 expects int8 operands, got "
                        f"{x_q.dtype}/{w_q.dtype}")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    if x_q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"conv2d_int8: no implementation for "
                           f"{x_q.device}")
    return library.conv_int8(x_q, w_q, list(_pair(stride)),
                             list(_pair(padding)), data_format, None)


def _vjp(fn, primal: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        p = primal.detach().requires_grad_()
        (g,) = torch.autograd.grad(fn(p), p, grad_out)
    return g


def conv2d_weight_grad(x: torch.Tensor, grad_out: torch.Tensor,
                       kernel_hw: Tuple[int, int], *,
                       stride: IntOrPair = 1, padding: IntOrPair = 0,
                       data_format: str = "NCHW") -> torch.Tensor:
    """dL/dW (OIHW) of :func:`conv2d` for input ``x`` and output cotangent
    ``grad_out``."""
    c = 1 if data_format == "NCHW" else 3
    w0 = x.new_zeros((grad_out.shape[c], x.shape[c], *kernel_hw))
    return _vjp(lambda w: conv2d(x, w, stride=stride, padding=padding,
                                 data_format=data_format), w0, grad_out)


def conv2d_input_grad(w: torch.Tensor, grad_out: torch.Tensor,
                      input_shape: Sequence[int], *,
                      stride: IntOrPair = 1, padding: IntOrPair = 0,
                      data_format: str = "NCHW") -> torch.Tensor:
    """dL/dX (``input_shape``, in ``data_format``) of :func:`conv2d` for
    weights ``w`` and output cotangent ``grad_out``."""
    x0 = w.new_zeros(tuple(input_shape))
    return _vjp(lambda x: conv2d(x, w, stride=stride, padding=padding,
                                 data_format=data_format), x0, grad_out)


def conv2d_bias_grad(grad_out: torch.Tensor, *,
                     data_format: str = "NCHW") -> torch.Tensor:
    """dL/db: ``grad_out`` summed over N, H and W."""
    return grad_out.sum(dim=(0, 2, 3) if data_format == "NCHW" else (0, 1, 2))


def conv2d_output_shape(input_hw: Tuple[int, int], kernel_hw: Tuple[int, int],
                        stride: IntOrPair = 1, padding: IntOrPair = 0
                        ) -> Tuple[int, int]:
    """Spatial output size: ``(in + 2·pad − kernel) // stride + 1``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    return ((input_hw[0] + 2 * ph - kernel_hw[0]) // sh + 1,
            (input_hw[1] + 2 * pw - kernel_hw[1]) // sw + 1)
