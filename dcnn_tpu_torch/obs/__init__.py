"""Observability (counterpart of ``dcnn_tpu/obs``): one metrics registry
and one span tracer for the whole port, and the surfaces that export them.

- :mod:`.registry`: thread-safe Counter / Gauge / Histogram, O(1)
  recorders, ``snapshot()`` and Prometheus ``prometheus()`` export;
  :func:`get_registry` is the process-global instance.
- :mod:`.exposition`: the one Prometheus text renderer (byte for byte the
  JAX package's) and its inverse, ``parse_prometheus_text``.
- :mod:`.tracer`: span tracing over a bounded ring buffer, JSONL and
  Chrome-trace export, trace/span/parent ids with ``inject`` and
  ``activate``; :func:`get_tracer` is the process-global instance, a
  no-op until :func:`configure` or ``DCNN_TRACE=1`` enables it. Spans
  stamp host clocks and never wait for the card.
- :mod:`.server`: :class:`TelemetryServer`, ``/metrics``, ``/healthz``
  and ``/snapshot`` over HTTP, with its health-check adapters.
- :mod:`.flight`: :class:`FlightRecorder`, atomic keep-K postmortem
  bundles on degradation edges, off until ``DCNN_FLIGHT_DIR`` or
  :func:`configure_flight`.
- :mod:`.tsdb`: :class:`TimeSeriesStore` and :class:`TsdbSampler`
  (resolved lazily, so ``python -m dcnn_tpu_torch.obs.tsdb`` runs clean).
- :mod:`.rules`: :class:`RuleEngine`, recording and alert rules with
  hold windows over a store, :func:`rules_check` for ``/healthz``
  (resolved lazily).
- :mod:`.goodput`: the wall-time attribution ledger, the bottleneck
  classifier and :class:`~.goodput.GoodputMonitor` (``/goodput``);
  :mod:`.anomaly`: the step-time band and its one capture an episode.
  The trainer wires both with the rules behind
  ``TrainingConfig.metrics_port``.
- :mod:`.xla`: FLOP counts, compile counters and the card's memory
  gauges (``sample_hbm``).
- :mod:`.fleet`: :class:`FleetAggregator` (N telemetry surfaces merged
  into labeled fleet series, ``/fleet``, ``/alerts`` and a roll-up
  ``/healthz``) and :class:`HttpScraper` (resolved lazily).
- :mod:`.trace`: ``python -m dcnn_tpu_torch.obs.trace merge|inspect``,
  the per-process JSONL shards merged into one Chrome trace, and flight
  bundles summarized.
- :mod:`.regress`: the bench-history regression gate over the port's own
  ``BENCH_TORCH_r*.json`` captures, ``python -m
  dcnn_tpu_torch.obs.regress`` (``--self-test`` runs its fixtures).

Standard library only at import time.
"""

from .flight import FlightRecorder, configure_flight, get_flight_recorder
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry)
from .server import (TelemetryServer, checkpoint_check, elastic_check,
                     pipeline_check, watchdog_check)
from .tracer import Tracer, configure, get_tracer

_LAZY = {
    "TimeSeriesStore": "tsdb", "TsdbSampler": "tsdb",
    "RuleEngine": "rules", "AlertRule": "rules",
    "RecordingRule": "rules", "rules_check": "rules",
    "FleetAggregator": "fleet", "HttpScraper": "fleet",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "Tracer", "configure", "get_tracer",
    "TelemetryServer", "watchdog_check", "checkpoint_check",
    "elastic_check", "pipeline_check",
    "FlightRecorder", "get_flight_recorder", "configure_flight",
    "TimeSeriesStore", "TsdbSampler",
    "RuleEngine", "AlertRule", "RecordingRule", "rules_check",
    "FleetAggregator", "HttpScraper",
]
