"""Sequential model container (counterpart of ``dcnn_tpu/nn/sequential.py``).

An ``nn.Module`` over an ordered ``nn.ModuleList`` of layers. ``init``
creates every layer's parameters for the per-sample input shape, on the
GPU unless the caller passes ``device="cpu"``. ``get_config`` /
``from_config`` speak the JAX package's JSON.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.precision import cast_to_compute
from .factory import layer_from_config
from .layer import Layer, Shape


class Sequential(nn.Module):
    def __init__(self, layers=(), name: str = "sequential",
                 input_shape: Optional[Shape] = None):
        super().__init__()
        self.name = name
        self.layers = nn.ModuleList()
        self.input_shape = (tuple(input_shape) if input_shape is not None
                            else None)
        for l in layers:
            self.add(l)

    def add(self, layer: Layer) -> "Sequential":
        base = layer.name
        names = {l.name for l in self.layers}
        if base in names:
            i = 1
            while f"{base}_{i}" in names:
                i += 1
            layer.name = f"{base}_{i}"
        self.layers.append(layer)
        return self

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, idx):
        return self.layers[idx]

    def init(self, input_shape: Optional[Shape] = None, *,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> "Sequential":
        """Create every layer's parameters. ``input_shape`` is per-sample;
        ``device`` defaults to CUDA and raises when no GPU is present."""
        shape = tuple(input_shape) if input_shape is not None else self.input_shape
        if shape is None:
            raise ValueError("input_shape required (not set at construction)")
        self.input_shape = shape
        dev = resolve_device(device)
        for layer in self.layers:
            layer.init(shape, generator=generator, device=dev)
            shape = layer.output_shape(shape)
        return self

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Chain the layers. Under the ``bf16`` precision mode the input is
        cast to bfloat16 here and each layer casts its params at use. The
        layers that draw random numbers (dropout, and the residual blocks
        that may hold it) take ``generator``, in order."""
        h = cast_to_compute(x)
        for layer in self.layers:
            h = (layer(h, generator=generator) if getattr(layer, "draws", False)
                 else layer(h))
        return h

    def output_shape(self, input_shape: Optional[Shape] = None) -> Shape:
        shape = tuple(input_shape) if input_shape is not None else self.input_shape
        if shape is None:
            raise ValueError("input_shape unknown")
        for layer in self.layers:
            shape = layer.output_shape(shape)
        return shape

    def get_config(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "input_shape": list(self.input_shape) if self.input_shape else None,
            "layers": [l.get_config() for l in self.layers],
        }

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "Sequential":
        model = cls(name=cfg.get("name", "sequential"),
                    input_shape=tuple(cfg["input_shape"])
                    if cfg.get("input_shape") else None)
        for lc in cfg["layers"]:
            model.add(layer_from_config(lc))
        return model
