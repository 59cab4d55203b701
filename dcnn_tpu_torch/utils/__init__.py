"""Utilities (counterpart of ``dcnn_tpu/utils``): :mod:`.env`, the ``.env``
file and typed environment lookup; :mod:`.compile_cache`, the kernel build
directory as a persistent compile cache; :mod:`.compression`, the wire
codecs and tensor framing; :mod:`.hardware`, host and card introspection."""

from .compile_cache import enable_compile_cache
from .env import get_env, load_env_file

__all__ = ["get_env", "load_env_file", "enable_compile_cache"]
