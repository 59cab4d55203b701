"""Matmul precision policy (counterpart of ``dcnn_tpu/core/precision.py``).

Modes, selected by ``set_precision`` or the ``DCNN_PRECISION`` env var:

- ``"parity"`` (default, alias ``"highest"``): full fp32 products. TF32 is
  turned off for both cuBLAS matmuls and cuDNN convolutions (PyTorch leaves
  it on for cuDNN by default), so results match the JAX reference's
  ``Precision.HIGHEST`` to ~1e-5.
- ``"fast"`` (alias ``"default"``): TF32 allowed for matmuls and convs, the
  counterpart of the TPU's bf16-pass ``Precision.DEFAULT``.
- ``"bf16"``: activations and params are cast to bfloat16 at point of use
  (:func:`cast_to_compute`); master params stay fp32.
- ``"fp64"``: params are created in float64 and every op computes in double
  (numerics auditing only; the CUDA kernels take fp32 and bf16 and raise on
  float64).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_MODES = ("parity", "highest", "fast", "default", "bf16", "fp64")

_current = os.environ.get("DCNN_PRECISION", "parity").lower()
if _current not in _MODES:
    _current = "parity"


def _sync_backend(mode: str) -> None:
    tf32 = mode in ("fast", "default")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


_sync_backend(_current)


def set_precision(mode: str) -> None:
    global _current
    mode = mode.lower()
    if mode not in _MODES:
        raise ValueError(f"unknown precision mode {mode!r}; known: {sorted(_MODES)}")
    _sync_backend(mode)
    _current = mode


def get_precision_mode() -> str:
    return _current


def get_compute_dtype() -> Optional[torch.dtype]:
    """Activation/param compute dtype for the current mode, or None when the
    mode computes in the storage dtype (parity/fast)."""
    if _current == "bf16":
        return torch.bfloat16
    if _current == "fp64":
        return torch.float64
    return None


def default_param_dtype() -> torch.dtype:
    """Param storage dtype: float64 under fp64, float32 otherwise (bf16
    keeps fp32 master params and casts at point of use)."""
    return torch.float64 if _current == "fp64" else torch.float32


def cast_to_compute(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Cast a floating tensor to the compute dtype (no-op unless the mode
    sets one). Used on activations and on params at point of use."""
    cdt = get_compute_dtype()
    if cdt is None or t is None or not t.is_floating_point() or t.dtype == cdt:
        return t
    return t.to(cdt)
