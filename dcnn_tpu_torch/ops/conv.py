"""2-D convolution (counterpart of ``dcnn_tpu/ops/conv.py``).

Weights are OIHW whatever the activation layout, as in the JAX package;
activations are NCHW or NHWC. An NHWC tensor is a logical (N, H, W, C)
tensor: it is handed to ``F.conv2d`` as an NCHW view with channels-last
strides (no copy when it is contiguous) and comes back as a logical NHWC
tensor. ``F.conv2d`` is the platform conv, as ``lax.conv_general_dilated``
is the JAX package's; the hand-written 3×3 kernels live in
:mod:`.pallas.conv`. ``conv2d_int8`` and the explicit gradient functions
come in later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

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
    string."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    y = F.conv2d(x, w, b, stride=_pair(stride), padding=_pair(padding))
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d_output_shape(input_hw: Tuple[int, int], kernel_hw: Tuple[int, int],
                        stride: IntOrPair = 1, padding: IntOrPair = 0
                        ) -> Tuple[int, int]:
    """Spatial output size: ``(in + 2·pad − kernel) // stride + 1``."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    return ((input_hw[0] + 2 * ph - kernel_hw[0]) // sh + 1,
            (input_hw[1] + 2 * pw - kernel_hw[1]) // sw + 1)
