"""Per-layer profiling (counterpart of ``dcnn_tpu/train/profiling.py``).

:class:`LayerProfiler` runs a model layer by layer outside the train step
and times each layer's forward and backward: with CUDA events on the card
(one event pair a layer, read after one synchronisation at the end of the
pass, so no layer waits for the host), with ``time.perf_counter`` on the
CPU. As in the JAX package an untimed warm pass runs first for every
(direction, model, shape, dtype, training, precision) key, so the timed
pass measures steady state (kernel builds, allocator growth and cuDNN plans
fall in the warm pass). ``NORMAL`` mode clears the tables every profiled
batch, ``CUMULATIVE`` accumulates them. Profiling leaves the model as it
found it: its buffers (batchnorm running statistics) are put back after
every pass and no parameter's ``.grad`` is touched.

:func:`trace` and :func:`try_trace` capture a ``torch.profiler`` trace,
one capture a process, exported as a Chrome trace (``trace.json``) where
the JAX package writes an xprof capture; the capture is recorded as a
``profiler.xprof`` span on the shared tracer.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from ..core.config import ProfilerType
from ..core.precision import cast_to_compute, get_precision_mode
from ..nn.sequential import Sequential


class _Timer:
    """Per-layer intervals of one pass: CUDA event pairs on the card,
    ``perf_counter`` stamps elsewhere; read once, after the pass."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[tuple] = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, name: str, t0) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, t0, ev))
        else:
            self.marks.append((name, t0, time.perf_counter()))

    def read_us(self) -> List[tuple]:
        """``(name, microseconds)`` of every interval, in order."""
        if self.cuda:
            torch.cuda.synchronize()
            return [(n, a.elapsed_time(b) * 1e3) for n, a, b in self.marks]
        return [(n, (b - a) * 1e6) for n, a, b in self.marks]


def _call(layer, h, generator):
    return (layer(h, generator=generator) if getattr(layer, "draws", False)
            else layer(h))


@contextlib.contextmanager
def _preserved(model: Sequential, training: bool):
    """Run with ``model`` in train or eval mode; afterwards its buffers
    (running statistics a training forward moves in place) and its mode
    are what they were."""
    saved = [(b, b.detach().clone()) for b in model.buffers()]
    was_training = model.training
    model.train(training)
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in saved:
                b.copy_(s)
        model.train(was_training)


class LayerProfiler:
    def __init__(self, mode: ProfilerType = ProfilerType.NORMAL):
        self.mode = mode
        self.forward_us: Dict[str, float] = defaultdict(float)
        self.backward_us: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # (direction, model, shape, dtype, training, precision mode) keys
        # already warmed; holding the model (not id()) pins it against
        # id reuse
        self._warmed: set = set()

    def clear(self) -> None:
        self.forward_us.clear()
        self.backward_us.clear()
        self.counts.clear()

    def maybe_clear_per_batch(self) -> None:
        if self.mode == ProfilerType.NORMAL:
            self.clear()

    def _warm_once(self, key, run) -> None:
        if key not in self._warmed:
            run(record=False)
            self._warmed.add(key)

    def profile_forward(self, model: Sequential, x: torch.Tensor, *,
                        training: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """Run ``model`` layer by layer on ``x`` (under the precision
        policy of ``Sequential.forward``), timing each layer; returns the
        output. Dropout layers draw from ``generator``."""
        def run(record: bool):
            timer = _Timer(x.device)
            with torch.no_grad(), _preserved(model, training):
                h = cast_to_compute(x)
                for layer in model.layers:
                    t0 = timer.start()
                    h = _call(layer, h, generator)
                    timer.stop(layer.name, t0)
            if record:
                for name, us in timer.read_us():
                    self.forward_us[name] += us
                    self.counts[name] += 1
            return h

        self._warm_once(("fwd", model, tuple(x.shape), str(x.dtype),
                         training, get_precision_mode()), run)
        return run(record=True)

    def profile_backward(self, model: Sequential, x: torch.Tensor,
                         grad_out: torch.Tensor, *, training: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[torch.Tensor]:
        """Per-layer backward timing, last layer first: each layer's
        interval is its forward from the saved input and the vector-Jacobian
        product of ``grad_out`` through it (``torch.autograd.grad``, the
        JAX profiler's per-layer ``vjp``). Returns the gradient with respect
        to the model's input (``None`` for a non-float input)."""
        with torch.no_grad(), _preserved(model, training):
            h = cast_to_compute(x)
            inputs = []
            for layer in model.layers:
                inputs.append(h)
                h = _call(layer, h, generator)
        out_dtype = h.dtype

        def run(record: bool):
            timer = _Timer(x.device)
            g = grad_out.to(out_dtype)
            with _preserved(model, training):
                for i in reversed(range(len(model.layers))):
                    layer = model.layers[i]
                    xin = inputs[i].detach()
                    wrt = [p for p in layer.parameters() if p.requires_grad]
                    if xin.is_floating_point():
                        xin.requires_grad_(True)
                        wrt = [xin] + wrt
                    t0 = timer.start()
                    with torch.enable_grad():
                        y = _call(layer, xin, generator)
                        grads = (torch.autograd.grad(y, wrt, g,
                                                     allow_unused=True)
                                 if wrt else ())
                    timer.stop(layer.name, t0)
                    g = grads[0] if xin.requires_grad else None
                    if g is None:
                        break
            if record:
                for name, us in timer.read_us():
                    self.backward_us[name] += us
            return g

        self._warm_once(("bwd", model, tuple(x.shape), str(x.dtype),
                         training, get_precision_mode()), run)
        return run(record=True)

    def summary(self) -> str:
        """Printable table: forward and backward µs and calls per layer."""
        names = list(self.forward_us.keys())
        for n in self.backward_us:
            if n not in names:
                names.append(n)
        lines = [f"{'layer':<28} {'fwd µs':>12} {'bwd µs':>12} {'calls':>7}"]
        tf = tb = 0.0
        for n in names:
            f, b = self.forward_us.get(n, 0.0), self.backward_us.get(n, 0.0)
            tf += f
            tb += b
            lines.append(f"{n:<28} {f:>12.1f} {b:>12.1f} "
                         f"{self.counts.get(n, 0):>7}")
        lines.append(f"{'TOTAL':<28} {tf:>12.1f} {tb:>12.1f}")
        return "\n".join(lines)


_trace_lock = threading.Lock()
_trace_active = False
_trace_seq = itertools.count()


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dcnn_tpu_torch_trace")


def _try_claim() -> bool:
    """Test-and-set the one-capture-per-process flag."""
    global _trace_active
    with _trace_lock:
        if _trace_active:
            return False
        _trace_active = True
        return True


@contextlib.contextmanager
def _owned_capture(log_dir: str):
    """The capture body; assumes the claim is held and releases it on
    exit."""
    global _trace_active
    try:
        path = os.path.join(
            log_dir, f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                     f"-{next(_trace_seq):03d}")
        os.makedirs(path, exist_ok=True)
        from ..obs import get_tracer

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with get_tracer().span("profiler.xprof", track="profiler",
                               log_dir=path):
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            try:
                yield path
            finally:
                prof.stop()
                prof.export_chrome_trace(os.path.join(path, "trace.json"))
    finally:
        with _trace_lock:
            _trace_active = False


def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` capture as a context manager, exported as a
    Chrome trace (``<subdir>/trace.json``). ``log_dir`` (default
    ``<tmp>/dcnn_tpu_torch_trace``) is the parent: every call captures into
    its own timestamped subdir (``<YYYYmmdd-HHMMSS>-<pid>-<seq>``, yielded
    to the caller). Nested use raises ``RuntimeError``: one capture a
    process. The capture is also a ``profiler.xprof`` span on the shared
    tracer."""
    if not _try_claim():
        raise RuntimeError(
            "profiling.trace() does not nest: a profiler capture is "
            "already active in this process; finish it before starting "
            "another")
    return _owned_capture(log_dir or _default_log_dir())


def try_trace(log_dir: Optional[str] = None):
    """Non-raising :func:`trace`: the capture context manager, or ``None``
    when a capture is already active (counted on
    ``profiler_trace_busy_total``). A non-None return holds the capture
    slot, so the caller must enter and exit it."""
    if _try_claim():
        return _owned_capture(log_dir or _default_log_dir())
    from ..obs import get_registry
    get_registry().counter(
        "profiler_trace_busy_total",
        "try_trace() calls that found a capture already active").inc()
    return None
