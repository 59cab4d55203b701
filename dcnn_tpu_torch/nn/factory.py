"""String-keyed layer registry + JSON config materialisation (counterpart of
``dcnn_tpu/nn/factory.py``). The keys are the JAX package's, so a
``get_config()`` dict from either package rebuilds in the other."""

from __future__ import annotations

from typing import Any, Callable, Dict, Type

from .layer import Layer

_REGISTRY: Dict[str, Type[Layer]] = {}


def register_layer(type_name: str) -> Callable[[Type[Layer]], Type[Layer]]:
    def deco(cls: Type[Layer]) -> Type[Layer]:
        cls.type_name = type_name
        _REGISTRY[type_name] = cls
        return cls
    return deco


def layer_from_config(cfg: Dict[str, Any]) -> Layer:
    ty = cfg.get("type")
    if ty not in _REGISTRY:
        raise ValueError(f"unknown layer type {ty!r}; registered in the port: "
                         f"{sorted(_REGISTRY)} (see ROADMAP.md for the rest)")
    return _REGISTRY[ty].from_config(cfg)


class LayerFactory:
    """Class-style façade over the registry."""

    @staticmethod
    def create(cfg: Dict[str, Any]) -> Layer:
        return layer_from_config(cfg)

    @staticmethod
    def registered() -> Dict[str, Type[Layer]]:
        return dict(_REGISTRY)
