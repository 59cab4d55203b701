"""``.env`` file and typed environment lookup (counterpart of
``dcnn_tpu/utils/env.py``).

The example trainers are configured through environment variables, which
:func:`load_env_file` can load from a ``.env`` file; :func:`get_env` reads
one with the type of its default.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Type, TypeVar

T = TypeVar("T")

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def load_env_file(path: str = "./.env", *, override: bool = False) -> bool:
    """Parse ``KEY=VALUE`` lines into ``os.environ``.

    '#' comments, blank lines and surrounding whitespace are ignored;
    values may be quoted. Returns False if the file does not exist.
    """
    if not os.path.isfile(path):
        return False
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
                value = value[1:-1]
            if override or key not in os.environ:
                os.environ[key] = value
    return True


def get_env(name: str, default: T, cast: Optional[Callable[[str], T]] = None) -> T:
    """Typed environment lookup: the default's type decides the parse;
    booleans accept 1/true/yes/on and 0/false/no/off (any case)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is not None:
        return cast(raw)
    ty: Type = type(default)
    if ty is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True  # type: ignore[return-value]
        if low in _FALSE:
            return False  # type: ignore[return-value]
        raise ValueError(f"env {name}={raw!r} is not a boolean")
    try:
        if ty is int:
            return int(raw)  # type: ignore[return-value]
        if ty is float:
            return float(raw)  # type: ignore[return-value]
    except ValueError as e:
        raise ValueError(f"env {name}={raw!r}: expected {ty.__name__}") from e
    return raw  # type: ignore[return-value]
