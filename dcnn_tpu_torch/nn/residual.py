"""Residual block (counterpart of ``dcnn_tpu/nn/residual.py``):
``out = act(main(x) + shortcut(x))``, with an empty shortcut the identity.
Configs nest their layer configs as in the JAX package."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ..ops import activations as act_ops
from .factory import layer_from_config, register_layer
from .layer import Layer


@register_layer("residual_block")
class ResidualBlock(Layer):
    def __init__(self, layers: Sequence[Layer], shortcut: Sequence[Layer] = (),
                 activation: str = "relu", name: Optional[str] = None):
        super().__init__(name)
        self.layers = nn.ModuleList(layers)
        self.shortcut = nn.ModuleList(shortcut)
        self.activation = activation.lower()
        if self.activation not in act_ops.ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")

    def init(self, input_shape, *, generator=None, device=None):
        shape = tuple(input_shape)
        for layer in self.layers:
            layer.init(shape, generator=generator, device=device)
            shape = layer.output_shape(shape)
        sshape = tuple(input_shape)
        for layer in self.shortcut:
            layer.init(sshape, generator=generator, device=device)
            sshape = layer.output_shape(sshape)
        if sshape != shape:
            raise ValueError(f"{self.name}: main path output {shape} != "
                             f"shortcut output {sshape}")

    draws = True  # may hold dropout: takes the model's generator

    def forward(self, x, generator=None):
        def run(layers, h):
            for layer in layers:
                h = (layer(h, generator=generator)
                     if getattr(layer, "draws", False) else layer(h))
            return h

        h = run(self.layers, x)
        s = run(self.shortcut, x)
        return act_ops.ACTIVATIONS[self.activation](h + s)

    def output_shape(self, input_shape):
        shape = tuple(input_shape)
        for layer in self.layers:
            shape = layer.output_shape(shape)
        return shape

    def _sum(self, metric: str, input_shape) -> int:
        """``metric`` summed over the main path's and the shortcut's
        layers, each at the shape it receives."""
        total = 0
        for layers in (self.layers, self.shortcut):
            shape = tuple(input_shape)
            for layer in layers:
                total += getattr(layer, metric)(shape)
                shape = layer.output_shape(shape)
        return total

    def forward_complexity(self, input_shape):
        n = 1
        for d in self.output_shape(input_shape):
            n *= d
        return self._sum("forward_complexity", input_shape) + 2 * n  # add, act

    def param_count(self, input_shape):
        return self._sum("param_count", input_shape)

    def get_config(self) -> Dict[str, Any]:
        return {
            "type": self.type_name, "name": self.name,
            "activation": self.activation,
            "layers": [l.get_config() for l in self.layers],
            "shortcut": [l.get_config() for l in self.shortcut],
        }

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "ResidualBlock":
        return cls(
            layers=[layer_from_config(c) for c in cfg["layers"]],
            shortcut=[layer_from_config(c) for c in cfg.get("shortcut", [])],
            activation=cfg.get("activation", "relu"),
            name=cfg.get("name"),
        )
