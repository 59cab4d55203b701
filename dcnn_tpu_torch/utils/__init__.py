"""Utilities (counterpart of ``dcnn_tpu/utils``). Ported so far:
:mod:`.env`, the ``.env`` file and typed environment lookup, and
:mod:`.compile_cache`, the kernel build directory as a persistent compile
cache."""

from .env import get_env, load_env_file

__all__ = ["get_env", "load_env_file"]
