"""The uint8 feed-wire decode (counterpart of ``dcnn_tpu/data/wire.py``).

Image loaders ship pixels as uint8, 4x fewer bytes across the host-to-device
copy than float32, and the consumer decodes after the copy:

    decoded = x.float() * scale        # scale = loader.scale

The multiply form is the contract, not ``x / 255`` (division can differ
from the multiply by 1 ulp): it is what the resident and streaming feeds'
device decode and the native ``u8_to_f32`` compute, so every feed path
lands on the same float32 pixels. The decode is the identity for non-uint8
input, so tabular and regression batches pass through unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["WIRE_SCALE_U8", "decode_batch", "decode_fn", "decode_host",
           "default_decode_transform", "wire_scale"]

# the uint8 pixel decode multiplier
WIRE_SCALE_U8 = 1.0 / 255.0


def wire_scale(loader, default: float = WIRE_SCALE_U8) -> float:
    """The decode multiplier for ``loader``'s batches: its ``scale`` when it
    publishes one, ``default`` otherwise."""
    return float(getattr(loader, "scale", default))


def decode_batch(x: torch.Tensor, scale: float = WIRE_SCALE_U8) -> torch.Tensor:
    """Decode one wire batch, already on its device, to model domain: uint8
    becomes ``float32 * scale``; anything else is returned as it is."""
    if x.dtype == torch.uint8:
        return x.float() * float(scale)
    return x


@functools.lru_cache(maxsize=16)
def decode_fn(scale: float):
    """The ``x -> decode_batch(x, scale)`` callable, one per scale."""
    def dec(x: torch.Tensor) -> torch.Tensor:
        return decode_batch(x, scale)
    return dec


@functools.lru_cache(maxsize=16)
def default_decode_transform(scale: float):
    """The ``(x, y) -> (decoded_x, y)`` device transform a
    ``PrefetchLoader`` installs when its inner loader ships uint8 and the
    caller gave no ``device_transform``; labels pass through untouched."""
    dec = decode_fn(float(scale))

    def transform(x, y):
        return dec(x), y
    return transform


def decode_host(x: np.ndarray, scale: float = WIRE_SCALE_U8) -> np.ndarray:
    """The numpy decode every wire path is held to bit for bit: uint8
    becomes ``float32 * float32(scale)``; anything else is returned as it
    is."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) * np.float32(scale)
    return x
