"""Compiled sessions as CUDA graphs: the port's counterpart of
``jax.jit(f).lower(spec).compile()``.

A :class:`Session` captures ``fn(*static_inputs)`` once into a
``torch.cuda.CUDAGraph``; each call then copies the caller's inputs into the
static input buffers, replays, and hands the outputs out as fresh tensors
(the next replay overwrites the static outputs, and the JAX package's
sessions return fresh arrays). The sessions of one engine, trainer or epoch
share a :class:`GraphPool`: one memory pool (``graph_pool_handle()``), one
capture stream and one lock. The lock is held over every copy-in, replay and
copy-out, because a batcher's dispatcher and a caller of ``infer`` may
replay at once, and the sessions of one pool reuse each other's
intermediate memory, so two of them must never run together.

Capture runs the Python of ``fn`` but launches nothing, while the kernel
wrappers of :mod:`~dcnn_tpu_torch.ops._kernels` count a launch per call.
A session takes back what was counted while it captured (:func:`take_back`
of ``_kernels.capture_tally``, which other graphs' replays meanwhile stay
out of) and adds it at every replay (:func:`add_launches`), so the
counters count what ran on the card. Host counters of work the graph does
go through :func:`count_host`, which a session replays the same way.

On a CPU device a session is the plain call of ``fn`` on the caller's
inputs. On CUDA it is the graph or an exception: a capture that fails (a
host read inside ``fn``, say) raises :class:`CaptureError` naming the
function, and nothing falls back to eager. The caller runs ``fn`` once
eagerly before capture (kernel builds, packed weights, cuDNN plans and
lazily filled caches happen there, never inside a graph). Capture uses
``capture_begin``/``capture_end`` on the pool's stream rather than the
``torch.cuda.graph`` context, whose entry synchronises the card and empties
the allocator's cache; so a capture waits for nothing on the card. Captures
of the process take one lock, which :meth:`GraphPool.release` (the graphs
of a retired engine destroyed and their memory given back) takes too.

Generators that ``fn`` draws from are registered with the graph
(``CUDAGraph.register_generator_state``): the caller reseeds them on the
host (``manual_seed``, or ``set_state``) before each call, and a replay
draws exactly what a fresh generator of that seed draws.

A step function that is called over and over (a train step, a resident
batch body, a compiled pipeline schedule) keeps its sessions in a
:class:`SessionCache`, which holds the one rule of when such a step runs
eagerly, when it captures and which graph it replays.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..ops import _kernels
from .precision import get_precision_mode


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the function did not run."""


# held over every capture of the process and over a pool's release: a
# release destroys graphs and empties the allocator's cache, which may
# synchronise the device, and no capture may be in flight meanwhile
_CAPTURE_LOCK = threading.Lock()


def take_back(delta: Dict[Any, int]) -> Dict[Any, int]:
    """Subtract ``delta`` ({wrapper: launches}, what was counted while a
    capture ran) from the wrappers' counters; returns it."""
    with _kernels.COUNT_LOCK:
        for w, d in delta.items():
            w.launches -= d
    return delta


def add_launches(delta: Dict[Any, int]) -> None:
    """Count ``delta`` ({wrapper: launches}) on the wrappers."""
    with _kernels.COUNT_LOCK:
        for w, d in delta.items():
            w.launches += d


# host counters of work a graph does (the bytes a halo exchange sends,
# say): what captured code counts is kept for its session, which adds it at
# every replay, as the wrappers' launches are; one capture at a time
_HOST_LOCK = threading.Lock()
_host_tally: Optional[list] = None


def count_host(table: Dict[str, int], key: str, n: int = 1) -> None:
    """Add ``n`` to ``table[key]``: now, or, while a capture runs, at each
    replay of the graph it captures (the counted work runs then)."""
    with _HOST_LOCK:
        if _host_tally is not None:
            # the capture's record, which its session replays
            _host_tally.append((table, key, n))  # dcnn: disable=TS05
        else:
            table[key] += n


def add_host(counts) -> None:
    """Apply ``counts`` (``[(table, key, n)]``, a capture's
    :class:`host_tally`)."""
    with _HOST_LOCK:
        for table, key, n in counts:
            table[key] += n


class host_tally:
    """``with host_tally() as counts:`` collects in ``counts`` what
    :func:`count_host` counts inside the block, from any thread, instead
    of counting it."""

    def __init__(self):
        self.counts: list = []

    def __enter__(self) -> list:
        global _host_tally
        with _HOST_LOCK:
            _host_tally = self.counts
        return self.counts

    def __exit__(self, *exc) -> None:
        global _host_tally
        with _HOST_LOCK:
            _host_tally = None


_HOOK_DICTS = ("_forward_hooks", "_forward_pre_hooks", "_backward_hooks",
               "_backward_pre_hooks")


def debug_eager(model: Optional[torch.nn.Module] = None) -> bool:
    """Whether a step over ``model`` must run eagerly: autograd's anomaly
    mode is on (its NaN check reads the card, which a capture refuses), or
    ``model`` (where there is one) or one of its modules carries hooks, or
    global module hooks are set (a replay would run none of them:
    ``debug.checked``'s checks, say, would stop without a sign). These are
    the debug paths, as the JAX package re-runs a step un-jitted under
    ``jax_debug_nans``."""
    if torch.is_anomaly_enabled():
        return True
    glob = torch.nn.modules.module
    if any(getattr(glob, f"_global{d}", None) for d in _HOOK_DICTS):
        return True
    return model is not None and any(getattr(m, d, None)
                                     for m in model.modules()
                                     for d in _HOOK_DICTS)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(o) for o in out)
    return out


class GraphPool:
    """The memory pool, capture stream and lock that the sessions of one
    engine, trainer or epoch share, on ``device``. Capture the largest
    shape first: the smaller ones then fit in what it freed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.lock = threading.RLock()
        self.cuda = self.device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def bytes(self) -> int:
        """Device bytes the pool's segments hold (0 on the CPU)."""
        if not self.cuda:
            return 0
        pool = tuple(self.handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def release(self, sessions) -> None:
        """Destroy ``sessions`` (captured in this pool; none may replay
        again) and give the pool's segments back to the device: once no
        graph captured into a pool lives and no tensor of it is held, the
        allocator frees its segments at ``torch.cuda.empty_cache``. Runs
        under the pool's lock and the process's capture lock, so it waits
        for any capture in flight in any pool. Nothing happens on the
        CPU."""
        if not self.cuda:
            return
        with self.lock, _CAPTURE_LOCK:
            for s in sessions:
                if s.graph is not None:
                    s.graph.reset()
                s.graph = s.inputs = s.outputs = None
            # cuBLAS keeps a workspace per (handle, stream), made at its
            # first use on that stream: one first used inside a capture
            # lies in that graph's pool and would hold a segment of it
            # forever. Drop them all (the next call on a stream makes its
            # own again; a captured graph keeps the address it baked in,
            # inside its own pool), then free the segments.
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()


class Session:
    """``fn`` over inputs shaped like ``example``, captured in ``pool``.

    ``Session(name, fn, example, pool=..., generators=...)`` captures at
    once on CUDA (the caller has run ``fn`` eagerly first); ``session(*xs)``
    copies ``xs`` in, replays and returns fresh outputs. :meth:`replay`
    leaves the outputs in the static buffers for a caller that holds
    ``pool.lock`` and reads them before the next replay. ``launches`` maps
    each counted wrapper to its launches a replay."""

    def __init__(self, name: str, fn: Callable, example: Sequence[torch.Tensor],
                 *, pool: GraphPool,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        self.fn = fn
        self.pool = pool
        self.graph = None
        self.launches: Dict[Any, int] = {}
        self.host_counts: list = []
        if not pool.cuda:
            return
        with pool.lock:
            self.inputs = tuple(torch.empty_like(x) for x in example)
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            tally, host = _kernels.capture_tally(), host_tally()
            try:
                with _CAPTURE_LOCK, tally, host, torch.cuda.stream(pool.stream):
                    graph.capture_begin(pool=pool.handle,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(*self.inputs)
                    except BaseException:
                        # the capture is invalid; end it, report fn's error
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            except Exception as e:
                raise CaptureError(
                    f"CUDA graph capture of {name} failed (it ran nothing, "
                    f"and runs nothing eagerly instead): "
                    f"{type(e).__name__}: {e}") from e
            finally:
                self.launches = take_back(tally.counts)
                self.host_counts = host.counts
            self.outputs = out
            self.graph = graph
            # the graph is all a replay needs: keep no state fn closes over
            self.fn = None

    def replay(self, *xs):
        """Copy ``xs`` in and replay; returns the static outputs (the plain
        call's outputs on the CPU). Hold ``pool.lock`` until they are
        read."""
        if self.graph is None:
            return self.fn(*xs)
        for s, x in zip(self.inputs, xs):
            s.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        if self.host_counts:
            add_host(self.host_counts)
        return self.outputs

    def __call__(self, *xs):
        if self.graph is None:
            return self.fn(*xs)
        with self.pool.lock:
            return _clone(self.replay(*xs))

    def launch_names(self) -> Dict[str, int]:
        """``launches`` by wrapper name."""
        return {w.__name__: d for w, d in self.launches.items()}


class SessionCache(dict):
    """The sessions of one step function, ``{key: (binding, sessions)}``.

    :meth:`lookup` returns None where the step must run eagerly: while
    :func:`debug_eager` holds, and at a key's first call (a real call that
    is also its warm-up). Later calls get the sessions captured for
    ``binding`` (the addresses of the tensors the step reads and writes in
    place), captured anew where the binding moved. A key is the caller's
    (input shapes and dtypes, flags) and the precision mode, which decides
    what the step computes."""

    def __init__(self):
        super().__init__()
        self.warm: set = set()

    def lookup(self, key: tuple, binding: tuple, capture: Callable[[], Any],
               model: Optional[torch.nn.Module] = None):
        """The sessions for ``key`` bound to ``binding`` (``capture()``
        makes them), or None: run eagerly. Hold the pool's lock."""
        if debug_eager(model):
            return None
        key = (*key, get_precision_mode())
        if key not in self.warm:
            self.warm.add(key)
            return None
        got = self.get(key)
        if got is None or got[0] != binding:
            got = self[key] = (binding, capture())
        return got[1]

    def latest(self):
        """The sessions of the newest key (None before a capture)."""
        return next(reversed(self.values()))[1] if self else None
