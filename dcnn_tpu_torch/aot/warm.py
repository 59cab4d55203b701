"""Warm starts from the persistent cache (counterpart of
``dcnn_tpu/aot/warm.py``).

In the port, "compile" means two things, and the cache holds both:

- **a kernel library**: ``nvcc`` over a source of ``ops/csrc/``.
  :func:`restore_library` puts a cached library into the build directory
  before ``_kernels.build`` would run ``nvcc``, and
  :func:`commit_library` commits a library the build directory holds
  (fresh or not). A warm start therefore runs no compiler and needs none.
- **an exported program**: :func:`warm_or_compile` returns a loaded
  artifact: a hit loads the cached bytes; a miss compiles them (exports),
  loads them back (so a cold start serves exactly what a warm start will)
  and commits them.

CUDA graphs cannot be serialized: every process captures its own, from the
loaded program or the live model.

A load fault (an unreadable entry, bytes that do not load) or a commit
fault degrades to the uncached path and is counted
(``aot_fallback_total``; a checksum mismatch ``aot_quarantined_total``).
It never hides a kernel and never runs the CPU in place of the card: the
uncached path builds the same kernels and traces the same model.

:func:`get_cache` and :func:`maybe_warm` are the environment-gated
plumbing. The root follows ``utils.compile_cache.resolve_cache_root``
(``AOT_CACHE`` > ``DCNN_COMPILE_CACHE`` > default), with the entries under
``<root>/aot``. The cache is off unless ``AOT_CACHE`` is set or a call site
passes a directory.

Hits, misses, load seconds, commits and fallbacks go through
``obs.xla.record_aot`` (``aot_hits_total`` …), builds and exports through
``obs.xla.record_compile``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from ..resilience.faults import InjectedCrash
from .cache import ExecutableCache
from .keys import TensorSpec, backend_fingerprint, cache_key, short_avals

_CACHES: Dict[str, ExecutableCache] = {}  # one instance (and sweep) per dir


def enabled_root(explicit: Optional[str] = None) -> Optional[str]:
    """The cache root when the cache is enabled, else ``None``. Explicit
    beats ``AOT_CACHE``; ``DCNN_COMPILE_CACHE`` alone does not enable it
    (it only places the kernel builds), but once enabled both share one
    root (``utils.compile_cache``)."""
    if explicit:
        return str(explicit)
    return os.environ.get("AOT_CACHE", "").strip() or None


def aot_dir(root: str) -> str:
    """Entries live under ``<root>/aot``, beside (never among) the kernel
    builds at the root itself."""
    return os.path.join(root, "aot")


def get_cache(explicit: Optional[str] = None, *,
              keep: Optional[int] = None,
              registry=None) -> Optional[ExecutableCache]:
    """The process-shared :class:`ExecutableCache` of the resolved root,
    or ``None`` when the cache is disabled. Raises ``ValueError`` on an
    untrusted root."""
    root = enabled_root(explicit)
    if root is None:
        return None
    d = os.path.abspath(aot_dir(root))
    cache = _CACHES.get(d)
    if cache is None:
        cache = ExecutableCache(d, keep=keep, registry=registry)
        _CACHES[d] = cache
    return cache


def resolve(aot_cache: Any, *, registry=None) -> Optional[ExecutableCache]:
    """A call site's ``aot_cache=`` argument as a cache: ``None`` follows
    ``AOT_CACHE``, ``False`` is off, a directory or an
    :class:`ExecutableCache` is used as given. A root that cannot be used
    (untrusted, unwritable) gives ``None``: the call site runs uncached."""
    if aot_cache is False:
        return None
    if isinstance(aot_cache, ExecutableCache):
        return aot_cache
    try:
        return get_cache(str(aot_cache) if aot_cache else None,
                         registry=registry)
    except (OSError, ValueError):
        return None


def _record(event: str, seconds: float = 0.0, registry=None) -> None:
    from ..obs.xla import record_aot

    record_aot(event, seconds, registry=registry)


def _lookup(cache: ExecutableCache, key: str,
            fp: Dict[str, Any]) -> Optional[bytes]:
    try:
        return cache.lookup(key, fingerprint=fp)
    except InjectedCrash:
        raise
    except Exception:
        return None  # an unreadable cache is a miss; the build still works


# -- kernel libraries ---------------------------------------------------------

def library_key(name: str, path: Path,
                fingerprint: Optional[Dict[str, Any]] = None
                ) -> Tuple[str, Dict[str, Any]]:
    """The key of build ``name``'s library: its file name (which hashes the
    source, every header and the flags) and the backend fingerprint."""
    return cache_key((), config=Path(path).name,
                     extra={"what": "kernel_library", "build": name},
                     fingerprint=fingerprint)


def restore_library(cache: ExecutableCache, name: str, path: Path, *,
                    registry=None) -> bool:
    """Write build ``name``'s cached library to ``path`` (atomically) and
    return True; False on a miss. Counted as a hit (with its seconds) or a
    miss (on the cache's registry unless ``registry``)."""
    registry = registry if registry is not None else cache.registry
    fp = backend_fingerprint()
    key, _ = library_key(name, path, fp)
    t0 = time.perf_counter()
    payload = _lookup(cache, key, fp)
    if payload is None:
        _record("miss", registry=registry)
        return False
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)
    _record("hit", time.perf_counter() - t0, registry=registry)
    return True


def commit_library(cache: ExecutableCache, name: str, path: Path, *,
                   registry=None) -> bool:
    """Commit the library at ``path`` as build ``name``'s entry, unless the
    cache holds it already; True if committed. A commit fault is counted
    as a fallback and changes nothing else."""
    registry = registry if registry is not None else cache.registry
    fp = backend_fingerprint()
    key, material = library_key(name, path, fp)
    try:
        if cache.has(key):
            return False
        from ..utils.compile_cache import nvcc_version

        return cache.commit(key, Path(path).read_bytes(), meta={
            "what": "library", "avals": Path(path).name,
            "material": material, "nvcc": nvcc_version()})
    except InjectedCrash:
        raise
    except Exception:
        _record("fallback", registry=registry)
        return False


# -- exported programs --------------------------------------------------------

def warm_or_compile(compile_fn: Callable[..., bytes], *args: Any,
                    cache: ExecutableCache,
                    load: Callable[[bytes], Any],
                    what: str = "", config: Optional[Any] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    registry=None) -> Tuple[Any, Dict[str, Any]]:
    """Return ``(load(payload), info)`` for the artifact that
    ``compile_fn(*args)`` makes (its bytes), ``args`` being the call's
    tensors or :class:`~dcnn_tpu_torch.aot.keys.TensorSpec` specs.

    ``config`` must digest everything the artifact closes over (model
    structure, weights, transform); ``load`` turns bytes into the object
    served. A hit loads the cached bytes; bytes that do not load are
    quarantined and compiled again. A miss compiles, loads the bytes back
    and commits them; a commit fault is counted and the loaded artifact
    served all the same. Events are counted on ``registry`` (the cache's
    by default). ``info`` carries ``key``, ``hit``, ``load_s`` or
    ``compile_s``, and ``committed``."""
    from ..obs.xla import record_compile

    registry = registry if registry is not None else cache.registry
    fp = backend_fingerprint()
    key, material = cache_key(args, config=config, extra=extra,
                              fingerprint=fp)
    info: Dict[str, Any] = {"key": key, "hit": False, "committed": False}
    payload = _lookup(cache, key, fp)
    if payload is not None:
        t0 = time.perf_counter()
        try:
            obj = load(payload)
        except InjectedCrash:
            raise
        except Exception as e:
            cache.quarantine(key, f"load failed: {type(e).__name__}")
        else:
            dt = time.perf_counter() - t0
            _record("hit", dt, registry=registry)
            info.update({"hit": True, "load_s": round(dt, 4)})
            return obj, info

    _record("miss", registry=registry)
    t0 = time.perf_counter()
    payload = compile_fn(*args)
    compile_s = time.perf_counter() - t0
    record_compile(compile_s, what=what, registry=registry)
    info["compile_s"] = round(compile_s, 4)
    obj = load(payload)
    try:
        info["committed"] = cache.commit(key, payload, meta={
            "what": what, "avals": short_avals(material),
            "material": material})
    except InjectedCrash:
        raise
    except Exception:
        _record("fallback", registry=registry)
    return obj, info


class WarmCallable:
    """A model served from an exported program per input signature.

    The first call at each signature (shape and dtype of ``x``) runs
    :func:`warm_or_compile` over an export of ``model`` pinned to that
    shape, and later calls run the loaded program. Any failure on the warm
    path (an export that fails, a cache directory that vanished) falls
    back for that signature to the model itself, counted as a fallback:
    the wrapper can slow down, never break. Errors of the program's own
    run propagate."""

    def __init__(self, model: Any, cache: ExecutableCache, *,
                 what: str = "", config: Optional[Any] = None,
                 extra: Optional[Dict[str, Any]] = None, registry=None):
        self._model = model
        self._cache = cache
        self._what = what
        self._config = config
        self._extra = extra
        self._registry = registry
        self._programs: Dict[Any, Any] = {}     # signature -> callable
        self.last_info: Optional[Dict[str, Any]] = None
        self.__wrapped__ = model

    def _compile(self, spec: TensorSpec) -> bytes:
        from ..nn.export import export_inference

        return export_inference(self._model, batch_size=spec.shape[0],
                                input_dtype=spec.dtype,
                                device=self._device())

    def _device(self):
        p = next(iter(self._model.parameters()), None)
        return "cpu" if p is None else p.device

    def __call__(self, x):
        from ..nn.export import load_inference

        sig = (tuple(x.shape), x.dtype, x.device.type)
        fn = self._programs.get(sig)
        if fn is None:
            try:
                fn, self.last_info = warm_or_compile(
                    self._compile, TensorSpec(tuple(x.shape), x.dtype),
                    cache=self._cache, load=load_inference, what=self._what,
                    config=self._config,
                    extra={**(self._extra or {}), "device": x.device.type},
                    registry=self._registry)
            except InjectedCrash:
                raise
            except Exception:
                _record("fallback", registry=self._registry)
                fn = self._model
            self._programs[sig] = fn
        return fn(x)

    def __repr__(self) -> str:
        return (f"WarmCallable({self._what or 'export'}, "
                f"signatures={len(self._programs)}, "
                f"cache={self._cache.root!r})")


def maybe_warm(model: Any, *, what: str = "", config: Optional[Any] = None,
               extra: Optional[Dict[str, Any]] = None,
               cache_dir: Optional[str] = None, registry=None) -> Any:
    """``model`` in a :class:`WarmCallable` when the cache is enabled
    (``AOT_CACHE`` or an explicit ``cache_dir``), else ``model`` itself."""
    try:
        cache = get_cache(cache_dir, registry=registry)
    except Exception:
        return model
    if cache is None:
        return model
    return WarmCallable(model, cache, what=what, config=config, extra=extra,
                        registry=registry)
