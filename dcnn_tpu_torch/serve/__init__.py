from .batcher import (
    DrainingError, DynamicBatcher, QueueFullError, ShutdownError,
)
from .decode import ContinuousBatcher, DecodeEngine, decode_reference
from .engine import InferenceEngine, serve_buckets
from .kvcache import KVPagePool, OutOfPagesError, suggest_num_pages
from .metrics import DecodeMetrics, PRIORITIES, RouterMetrics, ServeMetrics
from .replica import (
    LocalReplica, ReplicaDeadError, ReplicaError, ReplicaServer, SwapError,
    TcpReplica,
)
from .router import NoReplicasError, Router, RouterShedError
from .swap import EngineFactory, ModelVersionManager, newest_valid_version
from .traffic import diurnal, open_loop, spike, step
from .autoscale import (
    Autoscaler, AutoscalerConfig, DeviceLeaseBroker, HttpScraper,
    autoscale_check,
)

__all__ = ["DrainingError", "DynamicBatcher", "QueueFullError",
           "ShutdownError", "ContinuousBatcher", "DecodeEngine",
           "decode_reference", "InferenceEngine", "serve_buckets",
           "KVPagePool", "OutOfPagesError", "suggest_num_pages",
           "DecodeMetrics", "PRIORITIES", "RouterMetrics", "ServeMetrics",
           "LocalReplica", "TcpReplica", "ReplicaServer", "ReplicaError",
           "ReplicaDeadError", "SwapError", "Router", "RouterShedError",
           "NoReplicasError", "EngineFactory", "ModelVersionManager",
           "newest_valid_version", "open_loop", "diurnal", "spike", "step",
           "Autoscaler", "AutoscalerConfig", "DeviceLeaseBroker",
           "HttpScraper", "autoscale_check"]
