"""Observability (counterpart of ``dcnn_tpu/obs``). Ported so far: the
metrics registry (:mod:`.registry`), whose process-global instance
(:func:`get_registry`) the checkpoints, the step guard and the stall
watchdog count into. The span tracer, the Prometheus exposition and the
telemetry server are not ported yet (``ROADMAP.md``)."""

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]
