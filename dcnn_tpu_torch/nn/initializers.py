"""Parameter initializers (counterpart of ``dcnn_tpu/nn/initializers.py``).

Weights and biases use ``Uniform(-bound, bound)`` with
``bound = 1/sqrt(fan_in)``. Random numbers come from the caller's
``torch.Generator`` (a CPU generator; the result is moved to ``device``).
The JAX package draws from ``jax.random`` keys, so the two packages give
different weights from the same seed; to hold them against each other,
carry the weights across with :func:`dcnn_tpu_torch.interop.from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
