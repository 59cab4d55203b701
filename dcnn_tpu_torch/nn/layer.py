"""Layer base classes (counterpart of ``dcnn_tpu/nn/layer.py``).

A layer is an ``nn.Module`` that owns its parameters. Construction takes the
geometry only; :meth:`Layer.init` creates the parameters for a per-sample
input shape (no batch dim: ``(S, E)`` for sequence layers, ``(features,)``
after Flatten), as the JAX layer's ``init(key, input_shape)`` does.
``get_config`` gives the same JSON dict as the JAX layer, so a config from
either package builds the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Shape = Tuple[int, ...]


class Layer(nn.Module):
    """Base layer; subclasses define init/forward/output_shape."""

    # registry key; subclasses get theirs from ``register_layer``
    type_name: str = "layer"

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or self.type_name

    def init(self, input_shape: Shape, *,
             generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> None:
        """Create this layer's parameters for ``input_shape`` on ``device``,
        drawing from ``generator``. Stateless layers have none."""
        del input_shape, generator, device

    def output_shape(self, input_shape: Shape) -> Shape:
        return tuple(input_shape)

    def forward_complexity(self, input_shape: Shape) -> int:
        """Per-sample forward FLOP estimate for ``input_shape``; drives the
        FLOP-balanced partitioner. The integers are the JAX layer's."""
        del input_shape
        return 0

    def backward_complexity(self, input_shape: Shape) -> int:
        """Backward ≈ 2× forward (two GEMMs against one)."""
        return 2 * self.forward_complexity(input_shape)

    def param_count(self, input_shape: Shape) -> int:
        """Trainable parameters this layer holds for ``input_shape``."""
        del input_shape
        return 0

    def get_config(self) -> Dict[str, Any]:
        return {"type": self.type_name, "name": self.name}

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "Layer":
        return cls(**{k: v for k, v in cfg.items() if k != "type"})

    def extra_repr(self) -> str:
        cfg = {k: v for k, v in self.get_config().items()
               if k not in ("type", "layers", "shortcut")}
        return ", ".join(f"{k}={v}" for k, v in cfg.items())


class ParameterizedLayer(Layer):
    """Marker base for layers owning trainable parameters."""


class StatelessLayer(Layer):
    """Marker base for layers with no parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
