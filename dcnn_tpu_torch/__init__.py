"""dcnn_tpu_torch: the PyTorch/CUDA port of ``dcnn_tpu`` for NVIDIA Hopper.

It keeps the JAX package's module layout and names, in PyTorch's idiom:
layers are ``nn.Module``s, entry points take an explicit ``device`` (CUDA
unless the caller asks for the CPU) and random init draws from a
``torch.Generator``. Every Pallas kernel on a ported path is a CUDA kernel
written by hand for ``sm_90a`` (``ops/csrc/``), with a plain PyTorch version
beside it that the CPU path and the tests use.

This package imports neither ``jax`` nor anything of ``dcnn_tpu``; the
weights of a JAX model come across as numpy through :mod:`.interop`.
"""

from . import core, interop, models, nn, ops, serve

__all__ = ["core", "interop", "models", "nn", "ops", "serve"]
