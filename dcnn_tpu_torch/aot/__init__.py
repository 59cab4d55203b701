"""The port's ahead-of-time cache (counterpart of ``dcnn_tpu/aot``).

The JAX package caches serialized XLA executables. The port has no such
executable; what it compiles, and caches, is:

- its kernel libraries (``nvcc`` over ``ops/csrc/*.cu``), restored into
  the build directory before ``_kernels.build`` would run the compiler, so
  a warm start needs no toolchain;
- exported serving programs (:mod:`~dcnn_tpu_torch.nn.export`), loaded by
  ``InferenceEngine.from_model(aot_cache=...)`` in place of building,
  folding, calibrating and tracing the model.

CUDA graphs cannot be serialized and are captured again in every process.

Pieces (each module's docstring has its contract):

- :mod:`~dcnn_tpu_torch.aot.keys`: keys over (torch and CUDA versions, the
  card, input specs, precision mode, a digest of the closed-over config);
- :mod:`~dcnn_tpu_torch.aot.cache`: :class:`ExecutableCache`, with its
  trusted-root check, checksum MANIFEST, atomic commits, cross-process
  locking, keep-K LRU GC and corrupt-entry quarantine;
- :mod:`~dcnn_tpu_torch.aot.warm`: :func:`warm_or_compile`, the library
  restore and commit, :class:`WarmCallable`, :func:`maybe_warm`.

Wired into ``_kernels.build``, ``InferenceEngine`` (``aot_cache=``,
``aot_config=``), ``DecodeEngine(aot_cache=)`` and
``TrainingConfig.aot_cache_dir`` (the last two: the kernel libraries). CLI:
``python -m dcnn_tpu_torch.aot`` (list / ``--gc`` / ``--prewarm``). The
cache is off unless ``AOT_CACHE`` (or an explicit directory) is set.
"""

from .cache import ExecutableCache
from .keys import (TensorSpec, backend_fingerprint, cache_key, digest,
                   digest_arrays)
from .warm import (WarmCallable, aot_dir, enabled_root, get_cache,
                   maybe_warm, warm_or_compile)

__all__ = [
    "ExecutableCache", "WarmCallable", "warm_or_compile", "maybe_warm",
    "get_cache", "enabled_root", "aot_dir", "cache_key", "digest",
    "digest_arrays", "backend_fingerprint", "TensorSpec",
]
