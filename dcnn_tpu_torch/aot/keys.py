"""Cache keys for the port's compiled artifacts (counterpart of
``dcnn_tpu/aot/keys.py``).

The port compiles two kinds of things a later process can reuse: a kernel
library (``nvcc`` over ``ops/csrc/*.cu``) and an exported serving program
(:func:`~dcnn_tpu_torch.nn.export.export_inference`). An entry is
reusable only when everything that shaped it matches: torch and the CUDA
runtime, the card (name, capability, count), the inputs' shapes and
dtypes (a symbolic dimension by its name), the precision mode (its casts
are traced into a program), and a digest of the configuration the
artifact closes over: a program's model structure, weights and transform;
a library's name, which hashes its source, headers and flags. The key is a
SHA-256 over the canonical JSON of all of those, so deriving it traces
and builds nothing, and needs no compiler.

The ``config`` digest is a contract: a call site folds in every value that
can change the artifact (the engine folds the model's config, its weights
and the transform). Under-keying serves a stale artifact silently; when in
doubt, fold it in.

The JAX module's ``train_step_key_material`` and
``decode_step_key_material`` key compiled train and decode steps; the port
compiles neither (its steps are CUDA graphs, captured again in every
process), so they have no counterpart here.
"""

from __future__ import annotations

import functools
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

# bump when the key layout itself changes: old entries become misses, not
# load errors
KEY_SCHEMA = 1

# the fingerprint fields an entry's MANIFEST must agree on to be loaded
STALE_FIELDS = ("torch", "cuda", "device_name", "capability")


@dataclass(frozen=True)
class TensorSpec:
    """An input's shape and dtype without data, the counterpart of
    ``jax.ShapeDtypeStruct``; a dimension may be a name (symbolic)."""
    shape: Tuple[Union[int, str], ...]
    dtype: Any


def backend_fingerprint(toolchain: bool = False) -> Dict[str, Any]:
    """The runtime and card an artifact is valid for: torch and the CUDA
    runtime it was built for, the card's name, compute capability and
    count ("cpu", None and 0 without one). ``toolchain`` adds ``nvcc
    --version`` (None without a compiler), which a build records in its
    MANIFEST; it is not part of a key, since a warm start has no compiler
    to ask."""
    import torch

    cuda = torch.cuda.is_available()
    fp: Dict[str, Any] = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "capability": ("%d.%d" % torch.cuda.get_device_capability(0)
                       if cuda else None),
        "device_count": torch.cuda.device_count() if cuda else 0,
    }
    if toolchain:
        from ..utils.compile_cache import nvcc_version

        fp["nvcc"] = nvcc_version()
    return fp


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def aval_signature(args: Sequence[Any]) -> Dict[str, Any]:
    """Structure and per-leaf ``(shape, dtype)`` of a call's arguments:
    tensors and :class:`TensorSpec` describe the same artifact, so both
    give the same signature. Other leaves count by type and value."""
    import torch
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(tuple(args))
    sig = []
    for leaf in leaves:
        if isinstance(leaf, (torch.Tensor, TensorSpec)):
            sig.append([list(leaf.shape), _dtype_name(leaf.dtype)])
        else:
            sig.append([[], f"{type(leaf).__name__}={leaf!r}"])
    return {"treedef": str(spec), "leaves": sig}


def _precision_mode() -> str:
    try:
        from ..core.precision import get_precision_mode
        return get_precision_mode()
    except Exception:
        return "unknown"


def callable_id(fn: Any) -> str:
    """Process-stable identity of a callable: ``module.qualname`` (plus
    the frozen arguments of a ``functools.partial``), never ``repr``,
    whose ``0x…`` address would change the key every process. A bound
    method adds the digest of its instance's ``get_config()`` where it has
    one, since two instances of one class may compute different
    programs."""
    if isinstance(fn, functools.partial):
        inner = callable_id(fn.func)
        return (f"partial({inner}, args={fn.args!r}, "
                f"kw={sorted((fn.keywords or {}).items())!r})")
    mod = getattr(fn, "__module__", None) or type(fn).__module__
    qn = getattr(fn, "__qualname__", None) or type(fn).__qualname__
    base = f"{mod}.{qn}"
    owner = getattr(fn, "__self__", None)
    if owner is not None and not isinstance(owner, type):
        get_config = getattr(owner, "get_config", None)
        if callable(get_config):
            try:
                return f"{base}<{digest(get_config())}>"
            except Exception:
                pass
    return base


def digest(obj: Any) -> str:
    """Stable SHA-256 of any JSON-able structure (other leaves by
    ``repr``, which is stable for the repo's config objects)."""
    blob = json.dumps(obj, sort_keys=True, default=repr,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _leaf_bytes(leaf: Any) -> Tuple[str, bytes]:
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        head = str((tuple(t.shape), _dtype_name(t.dtype)))
        return head, t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(leaf))
    return str((a.shape, str(a.dtype))), a.tobytes()


def digest_arrays(tree: Any) -> str:
    """SHA-256 over every leaf's shape, dtype and bytes in pytree order
    (tensors, numpy arrays; a dict's leaves in its key order): the weights
    digest a program's key needs, since an exported program carries the
    weights it was traced with."""
    from torch.utils import _pytree

    h = hashlib.sha256()
    for leaf in _pytree.tree_leaves(tree):
        head, data = _leaf_bytes(leaf)
        h.update(head.encode("utf-8"))
        h.update(data)
    return h.hexdigest()


def cache_key(args: Sequence[Any], *, config: Optional[Any] = None,
              extra: Optional[Dict[str, Any]] = None,
              fingerprint: Optional[Dict[str, Any]] = None
              ) -> Tuple[str, Dict[str, Any]]:
    """``(key_hex, material)`` of one artifact. ``material`` is the
    component dict before hashing; it goes into the entry's MANIFEST, so a
    reader (or the CLI) can see why two keys differ."""
    material = {
        "schema": KEY_SCHEMA,
        "fingerprint": fingerprint if fingerprint is not None
        else backend_fingerprint(),
        "avals": aval_signature(args),
        "precision": _precision_mode(),
        "config": config if isinstance(config, str) else digest(config),
        "extra": extra or {},
    }
    return digest(material), material


_SHORT = {"float32": "f32", "float64": "f64", "bfloat16": "bf16",
          "float16": "f16", "int32": "i32", "int64": "i64", "uint8": "u8",
          "int8": "i8", "bool": "pred"}


def short_avals(material: Dict[str, Any], limit: int = 4) -> str:
    """A short summary of the avals for listings: ``f32[b,64,64,3],
    f32[8,200], …(+7)``."""
    leaves = material.get("avals", {}).get("leaves", [])
    parts = []
    for shape, dtype in leaves[:limit]:
        parts.append(f"{_SHORT.get(dtype, dtype)}"
                     f"[{','.join(str(d) for d in shape)}]")
    if len(leaves) > limit:
        parts.append(f"…(+{len(leaves) - limit})")
    return ", ".join(parts)
