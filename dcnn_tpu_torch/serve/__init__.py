from .batcher import (
    DrainingError, DynamicBatcher, QueueFullError, ShutdownError,
)
from .engine import InferenceEngine, serve_buckets
from .metrics import ServeMetrics

__all__ = ["DrainingError", "DynamicBatcher", "QueueFullError",
           "ShutdownError", "InferenceEngine", "serve_buckets",
           "ServeMetrics"]
