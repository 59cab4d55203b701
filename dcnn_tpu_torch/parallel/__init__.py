"""Parallelism (counterpart of ``dcnn_tpu/parallel/``): the partitioners,
the in-process pipeline (stages, the sync and semi-async schedules, the
coordinator), the compiled pipeline (a whole GPipe or 1F1B step as one
CUDA graph) and the TCP pipeline: framed channels (``comm``), stage-worker
processes (``worker``, ``python -m dcnn_tpu_torch.parallel.worker``) and
the self-healing ``DistributedPipelineCoordinator``.

Not ported yet (ROADMAP.md Queue 1): data, sequence, multihost and
elastic parallelism with ``core/mesh.py`` (item 6), which the JAX
package's ``shard_stacked`` needs.
"""

from .compiled_pipeline import (
    HeteroCompiledPipeline, SequentialStageStack,
    make_compiled_pipeline_forward, make_compiled_pipeline_train_step,
    stack_stage_params,
)
from .partitioner import FlopBalancedPartitioner, NaivePartitioner, Partitioner
from .pipeline import (
    InProcessPipelineCoordinator, PipelineError, PipelineStage,
    train_pipeline_batch_sync,
)
from .distributed_pipeline import (
    DistributedPipelineCoordinator, PipelineCollapsedError,
    PipelineTimeouts, PipelineWorkerError, StageLostError,
)


def __getattr__(name: str):
    # the worker module loads on first use, so that
    # ``python -m dcnn_tpu_torch.parallel.worker`` runs it fresh
    if name in ("StageWorker", "run_worker"):
        from . import worker
        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Partitioner", "NaivePartitioner", "FlopBalancedPartitioner",
    "PipelineStage", "InProcessPipelineCoordinator", "PipelineError",
    "train_pipeline_batch_sync",
    "HeteroCompiledPipeline", "SequentialStageStack",
    "make_compiled_pipeline_forward", "make_compiled_pipeline_train_step",
    "stack_stage_params",
    "DistributedPipelineCoordinator", "PipelineWorkerError",
    "StageLostError", "PipelineCollapsedError", "PipelineTimeouts",
    "StageWorker", "run_worker",
]
