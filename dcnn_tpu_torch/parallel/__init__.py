"""Parallelism (counterpart of ``dcnn_tpu/parallel/``): the partitioners,
the in-process pipeline (stages, the sync and semi-async schedules, the
coordinator) and the compiled pipeline (a whole GPipe or 1F1B step as one
CUDA graph).

Not ported yet (ROADMAP.md Queue 1): the TCP pipeline (``comm``,
``worker``, ``distributed_pipeline``; item 4), and data, sequence,
multihost and elastic parallelism with ``core/mesh.py`` (item 6), which
the JAX package's ``shard_stacked`` needs.
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

__all__ = [
    "Partitioner", "NaivePartitioner", "FlopBalancedPartitioner",
    "PipelineStage", "InProcessPipelineCoordinator", "PipelineError",
    "train_pipeline_batch_sync",
    "HeteroCompiledPipeline", "SequentialStageStack",
    "make_compiled_pipeline_forward", "make_compiled_pipeline_train_step",
    "stack_stage_params",
]
