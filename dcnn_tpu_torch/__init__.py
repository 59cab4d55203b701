"""dcnn_tpu_torch: the PyTorch/CUDA port of ``dcnn_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module layout and names, in PyTorch's idiom:
layers are ``nn.Module``s, entry points take an explicit ``device`` (CUDA
unless the caller asks for the CPU) and random init draws from a
``torch.Generator``. Every Pallas kernel on a ported path is a CUDA kernel
written by hand for ``sm_90a`` (``ops/csrc/``), with a plain PyTorch version
beside it that the CPU path and the tests use.

This package imports neither ``jax`` nor anything of ``dcnn_tpu``; the
weights of a JAX model come across as numpy through :mod:`.interop`.
``DCNN_DEBUG=1`` turns debug mode (:mod:`.core.debug`) on at import.
"""

from .utils.env import get_env as _get_env

if _get_env("DCNN_DEBUG", False):
    # debug mode for the whole process (core/debug.py)
    from .core.debug import enable_debug_mode as _edm

    _edm()

from . import (core, data, interop, models, nn, obs, ops, optim, resilience,
               serve, train, utils)

__all__ = ["core", "data", "interop", "models", "nn", "obs", "ops", "optim",
           "resilience", "serve", "train", "utils"]
