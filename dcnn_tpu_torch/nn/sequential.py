"""Sequential model container (counterpart of ``dcnn_tpu/nn/sequential.py``).

An ``nn.Module`` over an ordered ``nn.ModuleList`` of layers. ``init``
creates every layer's parameters for the per-sample input shape, on the
GPU unless the caller passes ``device="cpu"``. ``get_config`` /
``from_config`` speak the JAX package's JSON.

The pipeline split: :meth:`Sequential.split` cuts the model into stage
models by ``[start, end)`` layer ranges (a ``Partitioner``'s output) over
the same layer modules, as the JAX package's stages share its layer
objects; :meth:`Sequential.split_params` cuts a ``named_parameters`` /
``named_buffers`` / ``state_dict`` mapping alongside, renaming
``layers.<i>.…`` to the stage's own ``layers.<i - start>.…``, and
:func:`merge_named` puts per-stage mappings back together.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.precision import cast_to_compute
from .factory import layer_from_config
from .layer import Layer, Shape

Partition = Tuple[int, int]  # [start, end) layer range


def _layer_index(name: str) -> Tuple[int, str]:
    """``"layers.<i>.<rest>"`` -> ``(i, rest)``."""
    head, i, rest = name.split(".", 2)
    if head != "layers":
        raise ValueError(f"{name!r} is not a Sequential layer's name")
    return int(i), rest


def split_named(named: Mapping[str, Any], partitions: Sequence[Partition]
                ) -> List[Dict[str, Any]]:
    """Cut a mapping under a Sequential's names (``layers.<i>.…``) into one
    mapping per ``[start, end)`` range, each under the stage model's own
    names (``layers.<i - start>.…``), in the input's order."""
    out: List[Dict[str, Any]] = [{} for _ in partitions]
    for name, value in named.items():
        i, rest = _layer_index(name)
        for si, (start, end) in enumerate(partitions):
            if start <= i < end:
                out[si][f"layers.{i - start}.{rest}"] = value
                break
    return out


def merge_named(per_stage: Sequence[Mapping[str, Any]],
                partitions: Sequence[Partition]) -> Dict[str, Any]:
    """The inverse of :func:`split_named`: one mapping under the full
    model's names from the stages' mappings, given in partition order."""
    merged: Dict[str, Any] = {}
    for named, (start, _) in zip(per_stage, partitions):
        for name, value in named.items():
            i, rest = _layer_index(name)
            merged[f"layers.{start + i}.{rest}"] = value
    return merged


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

    def layer_shapes(self, input_shape: Optional[Shape] = None
                     ) -> List[Shape]:
        """Per-layer *input* shapes; index i is what layer i receives."""
        shape = (tuple(input_shape) if input_shape is not None
                 else self.input_shape)
        if shape is None:
            raise ValueError("input_shape unknown")
        shapes = []
        for layer in self.layers:
            shapes.append(shape)
            shape = layer.output_shape(shape)
        return shapes

    def forward_complexity(self, input_shape: Optional[Shape] = None) -> int:
        return sum(layer.forward_complexity(shape) for layer, shape
                   in zip(self.layers, self.layer_shapes(input_shape)))

    def param_count(self, input_shape: Optional[Shape] = None) -> int:
        return sum(layer.param_count(shape) for layer, shape
                   in zip(self.layers, self.layer_shapes(input_shape)))

    def split(self, partitions: Sequence[Partition]) -> List["Sequential"]:
        """Stage models by ``[start, end)`` layer ranges, over this model's
        own layer modules (a stage trains the model's parameters). Each
        stage's ``input_shape`` is what its first layer receives, so it can
        be initialised or configured on its own."""
        stages = []
        shapes = self.layer_shapes() if self.input_shape is not None else None
        for si, (start, end) in enumerate(partitions):
            if not (0 <= start < end <= len(self.layers)):
                raise ValueError(f"bad partition range ({start}, {end})")
            stage = Sequential(name=f"{self.name}_stage{si}")
            stage.layers = self.layers[start:end]
            if shapes is not None:
                stage.input_shape = shapes[start]
            stages.append(stage)
        return stages

    def split_params(self, params: Mapping[str, Any],
                     partitions: Sequence[Partition]) -> List[Dict[str, Any]]:
        """Cut ``params`` (``named_parameters``, ``named_buffers`` or a
        ``state_dict``, under this model's names) alongside :meth:`split`,
        each piece under its stage model's names."""
        return split_named(params, partitions)

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

    def summary(self, input_shape: Optional[Shape] = None) -> str:
        """Printable architecture table, the JAX package's to the
        character: per layer its output shape, parameters and forward
        MFLOPs."""
        shapes = self.layer_shapes(input_shape)
        lines = [f"Sequential '{self.name}'",
                 f"{'#':>3} {'layer':<24} {'output shape':<20} {'params':>12} {'MFLOPs':>10}"]
        total_p = 0
        for i, (layer, shape) in enumerate(zip(self.layers, shapes)):
            out = layer.output_shape(shape)
            p = layer.param_count(shape)
            fl = layer.forward_complexity(shape) / 1e6
            total_p += p
            lines.append(f"{i:>3} {layer.name:<24} {str(out):<20} {p:>12,} {fl:>10.2f}")
        lines.append(f"total params: {total_p:,}")
        return "\n".join(lines)
