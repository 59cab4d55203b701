"""Parameter initializers (counterpart of ``dcnn_tpu/nn/initializers.py``).

Weights and biases use ``Uniform(-bound, bound)`` with
``bound = 1/sqrt(fan_in)``; norm layers start at gamma 1, beta 0. Random
numbers come from the caller's ``torch.Generator`` (a CPU generator; the
result is moved to ``device``).
The JAX package draws from ``jax.random`` keys, so the two packages give
different weights from the same seed; to hold them against each other,
carry the weights across with :func:`dcnn_tpu_torch.interop.from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..core.precision import default_param_dtype


def kaiming_uniform(shape: Sequence[int], fan_in: int, *,
                    generator: Optional[torch.Generator] = None,
                    device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    bound = 1.0 / math.sqrt(float(fan_in))
    t = torch.empty(tuple(shape), dtype=dtype or default_param_dtype())
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device) if device is not None else t


def conv_fan_in(in_channels: int, kernel_hw: Tuple[int, int]) -> int:
    return in_channels * kernel_hw[0] * kernel_hw[1]


def zeros(shape: Sequence[int], *, device: Optional[torch.device] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype or default_param_dtype(),
                       device=device)


def ones(shape: Sequence[int], *, device: Optional[torch.device] = None,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype or default_param_dtype(),
                      device=device)
