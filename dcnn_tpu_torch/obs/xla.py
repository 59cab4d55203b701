"""Cost accounting, compile events and device-memory watermarks
(counterpart of ``dcnn_tpu/obs/xla.py``, mapped onto the card).

- :func:`executable_cost` / :func:`jit_cost`: ``{flops, bytes_accessed,
  bytes_per_flop}`` of one call, FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops the call
  dispatches. ``bytes_accessed`` and ``bytes_per_flop`` are ``None``: the
  JAX package reads them from XLA's post-fusion cost analysis, and eager
  PyTorch has no compiled program to ask; the hand-written kernels, bound
  through ``ctypes``, are invisible to the FLOP counter too, so their work
  is missing from ``flops``.
- :func:`record_compile` / :func:`record_aot`: the ``compile_total`` /
  ``compile_seconds_total`` and ``aot_*_total`` counters under the JAX
  package's names. The port compiles no executable; its "compile" is the
  kernel build and warm-up a first call pays (``serve/engine.py``'s
  ``compile_stats``).
- :func:`sample_hbm`: device-memory gauges from
  ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` and
  ``.peak``) and ``torch.cuda.mem_get_info`` (the limit). None of these
  waits for the card. With no card it returns ``None``, as the JAX
  package does on a backend without memory stats.
- :func:`analytic_mfu`: achieved FLOP/s over a peak;
  :func:`peak_tflops`: the peak of an H100 for a step's dtype (the dense
  figures of ``PERF.md``'s "Device" row), ``None`` for any other card.

``torch`` is imported inside the functions, so the ``obs`` package stays
standard-library only at import time.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .registry import MetricsRegistry, get_registry

# tri-state support latch: None = unprobed, True/False after the first
# attempt, so per-dispatch sampling stays free without a card
_HBM_SUPPORTED: Optional[bool] = None


def executable_cost(counted: Any) -> Optional[Dict[str, float]]:
    """Cost of a call a ``FlopCounterMode`` has watched (the port's stand-in
    for a compiled executable): ``{"flops", "bytes_accessed",
    "bytes_per_flop"}`` with the last two ``None`` (module docstring), or
    ``None`` when nothing was counted."""
    try:
        flops = counted.get_total_flops()
    except Exception:
        return None
    if not flops or flops <= 0:
        return None
    return {"flops": float(flops), "bytes_accessed": None,
            "bytes_per_flop": None}


def jit_cost(fn: Any, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and
    inference mode and return :func:`executable_cost` of it. On any failure
    the answer is ``None``, not an exception: cost telemetry must never
    break the measurement it describes."""
    try:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with torch.inference_mode(), counter:
            fn(*args, **kwargs)
    except Exception:
        return None
    return executable_cost(counter)


def record_compile(seconds: float, *, what: str = "",
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Count one compile event: ``compile_total`` += 1,
    ``compile_seconds_total`` += ``seconds`` (and, when ``what`` is given,
    the per-site ``compile_<what>_seconds_total`` twin)."""
    reg = registry if registry is not None else get_registry()
    reg.counter("compile_total", "XLA executables compiled").inc()
    reg.counter("compile_seconds_total",
                "wall seconds spent compiling").inc(max(seconds, 0.0))
    if what:
        reg.counter(f"compile_{what}_seconds_total",
                    f"wall seconds compiling {what} executables").inc(
            max(seconds, 0.0))


def record_aot(event: str, seconds: float = 0.0, *,
               registry: Optional[MetricsRegistry] = None) -> None:
    """Account one executable-cache event: ``hit`` (+ deserialize
    seconds), ``miss``, ``commit``, ``quarantined``, ``stale`` or
    ``fallback``, under the JAX package's counter names."""
    reg = registry if registry is not None else get_registry()
    names = {
        "hit": ("aot_hits_total", "AOT executable cache hits"),
        "miss": ("aot_misses_total", "AOT executable cache misses"),
        "commit": ("aot_commits_total", "AOT executables committed"),
        "quarantined": ("aot_quarantined_total",
                        "corrupt AOT entries quarantined"),
        "stale": ("aot_stale_total",
                  "stale-version AOT entries skipped"),
        "fallback": ("aot_fallback_total",
                     "AOT serialize/deserialize fallbacks to plain "
                     "compilation"),
    }
    name, help_ = names.get(event, (f"aot_{event}_total",
                                    f"AOT cache {event} events"))
    reg.counter(name, help_).inc()  # dcnn: metric=aot_*_total
    if event == "hit" and seconds > 0:
        reg.counter("aot_deserialize_seconds_total",
                    "wall seconds deserializing cached AOT "
                    "executables").inc(seconds)


def analytic_mfu(flops_per_sample: Optional[float],
                 samples_per_sec: Optional[float],
                 peak_tflops: Optional[float]) -> Optional[float]:
    """MFU from measured FLOPs: achieved FLOP/s over the card's peak.
    ``None`` whenever an input is unknown: absent beats fabricated."""
    if not flops_per_sample or not samples_per_sec or not peak_tflops:
        return None
    return (flops_per_sample * samples_per_sec) / (peak_tflops * 1e12)


# an H100 SXM's dense peak, TFLOP/s, by the step's compute type: fp32 on
# the CUDA cores, TF32 / bf16 / fp16 on the tensor cores
H100_PEAK_TFLOPS: Dict[str, float] = {
    "float32": 67.0, "tf32": 495.0, "bfloat16": 989.0, "float16": 989.0}


def peak_tflops(dtype: str, device_name: Optional[str] = None,
                tf32: bool = False) -> Optional[float]:
    """The card's dense peak for a step computing in ``dtype`` (a torch
    dtype's name: ``"float32"``, ``"bfloat16"``, ...; fp32 with ``tf32``
    on the tensor cores), when ``device_name`` (default: card 0's) is an
    H100; else ``None``, so that ``mfu_live`` stays absent rather than
    wrong."""
    if device_name is None:
        try:
            import torch

            if not torch.cuda.is_available():
                return None
            device_name = torch.cuda.get_device_name(0)
        except Exception:
            return None
    if "H100" not in str(device_name):
        return None
    key = "tf32" if dtype == "float32" and tf32 else dtype
    return H100_PEAK_TFLOPS.get(key)


def sample_hbm(registry: Optional[MetricsRegistry] = None,
               devices=None) -> Optional[Dict[str, float]]:
    """Sample device memory into the HBM gauges; returns the sample dict,
    or ``None`` without a card.

    - ``hbm_bytes_in_use`` / ``hbm_bytes_limit``: the caching allocator's
      live bytes and the cards' capacity, summed over ``devices`` (every
      visible card by default);
    - ``hbm_peak_bytes``: a monotone high-water mark, the largest
      per-card allocator peak any sample of this process has seen.
    """
    global _HBM_SUPPORTED
    if _HBM_SUPPORTED is False:
        return None
    try:
        import torch

        if not torch.cuda.is_available():
            _HBM_SUPPORTED = False
            return None
        devs = (list(devices) if devices is not None
                else range(torch.cuda.device_count()))
        in_use = limit = peak = 0.0
        for d in devs:
            stats = torch.cuda.memory_stats(d)
            cur = float(stats.get("allocated_bytes.all.current", 0))
            in_use += cur
            peak = max(peak, float(stats.get("allocated_bytes.all.peak",
                                             cur)))
            limit += float(torch.cuda.mem_get_info(d)[1])
    except Exception:
        _HBM_SUPPORTED = False
        return None
    _HBM_SUPPORTED = True
    reg = registry if registry is not None else get_registry()
    reg.gauge("hbm_bytes_in_use",
              "device memory in use, summed over devices").set(in_use)
    if limit:
        reg.gauge("hbm_bytes_limit",
                  "device memory capacity, summed over devices").set(limit)
    g = reg.gauge("hbm_peak_bytes",
                  "high-water per-device memory this process")
    if peak > g.value:
        g.set(peak)
    return {"hbm_bytes_in_use": in_use, "hbm_bytes_limit": limit or None,
            "hbm_peak_bytes": max(peak, g.value)}
