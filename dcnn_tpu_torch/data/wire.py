"""The uint8 feed-wire decode (counterpart of ``dcnn_tpu/data/wire.py``).

Image loaders ship pixels as uint8, 4x fewer bytes across the host-to-device
copy than float32, and the consumer decodes after the copy:

    decoded = x.float() * scale        # scale = loader.scale

The multiply form is the contract, not ``x / 255`` (division can differ
from the multiply by 1 ulp). The decode is the identity for non-uint8
input, so tabular and regression batches pass through unchanged.
"""

from __future__ import annotations

import torch

__all__ = ["WIRE_SCALE_U8", "decode_batch", "wire_scale"]

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
