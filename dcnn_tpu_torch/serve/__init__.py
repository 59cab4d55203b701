from .batcher import (
    DrainingError, DynamicBatcher, QueueFullError, ShutdownError,
)
from .decode import ContinuousBatcher, DecodeEngine, decode_reference
from .engine import InferenceEngine, serve_buckets
from .kvcache import KVPagePool, OutOfPagesError, suggest_num_pages
from .metrics import DecodeMetrics, ServeMetrics

__all__ = ["DrainingError", "DynamicBatcher", "QueueFullError",
           "ShutdownError", "ContinuousBatcher", "DecodeEngine",
           "decode_reference", "InferenceEngine", "serve_buckets",
           "KVPagePool", "OutOfPagesError", "suggest_num_pages",
           "DecodeMetrics", "ServeMetrics"]
