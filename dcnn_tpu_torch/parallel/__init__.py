"""Parallelism (counterpart of ``dcnn_tpu/parallel/``): the partitioners,
the in-process pipeline (stages, the sync and semi-async schedules, the
coordinator), the compiled pipeline (a whole GPipe or 1F1B step as one
CUDA graph) and the TCP pipeline: framed channels (``comm``), stage-worker
processes (``worker``, ``python -m dcnn_tpu_torch.parallel.worker``) and
the self-healing ``DistributedPipelineCoordinator``; data parallelism
over a mesh of processes (``data_parallel``, ``multihost``, with
``core/mesh.py``; the compiled pipeline's ``data_axis=``), elastic data
parallelism over TCP peers (``elastic``), sequence parallelism over a
mesh's ``"seq"`` axis (``sequence``: ring, zigzag and Ulysses attention on
the flash kernels), the elastic world's side of the device leases it
shares with the serving autoscaler (``autoscale``: ``TrainLease``,
``LeasedElasticTrainer``) and spatial sharding of the mesh step
(``shard_batch(spatial_axis=)``, ``make_data_parallel_train_step(
spatial_axis=)``: dim 2 over a second mesh axis, the halos exchanged by
``data_parallel``'s ``HaloExchange`` at each conv and pool).
"""

from .compiled_pipeline import (
    HeteroCompiledPipeline, SequentialStageStack,
    make_compiled_pipeline_forward, make_compiled_pipeline_train_step,
    shard_stacked, stack_stage_params,
)
from .partitioner import FlopBalancedPartitioner, NaivePartitioner, Partitioner
from .pipeline import (
    InProcessPipelineCoordinator, PipelineError, PipelineStage,
    train_pipeline_batch_sync,
)
from .data_parallel import (
    make_data_parallel_train_step, make_elastic_apply_step,
    make_elastic_grad_step, replicate, shard_batch,
)
from .elastic import (
    ElasticController, EvictedError, Membership, PeerSpec,
    PreemptedError, WorldCollapsedError, elastic_fit, microbatch_span,
    parse_peers,
)
from .multihost import PeerLostError
from .autoscale import LeasedElasticTrainer, TrainLease
from ..core.mesh import SEQ_AXIS
from .sequence import (
    make_ring_attention, make_ulysses_attention, make_zigzag_ring_attention,
    shard_sequence, zigzag_permutation, zigzag_shard,
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
    "make_data_parallel_train_step", "shard_batch", "replicate",
    "make_elastic_grad_step", "make_elastic_apply_step",
    "ElasticController", "Membership", "PeerSpec", "PeerLostError",
    "EvictedError", "PreemptedError", "WorldCollapsedError",
    "microbatch_span", "parse_peers", "elastic_fit",
    "LeasedElasticTrainer", "TrainLease",
    "PipelineStage", "InProcessPipelineCoordinator", "PipelineError",
    "train_pipeline_batch_sync",
    "HeteroCompiledPipeline", "SequentialStageStack",
    "make_compiled_pipeline_forward", "make_compiled_pipeline_train_step",
    "stack_stage_params", "shard_stacked",
    "SEQ_AXIS", "make_ring_attention", "make_ulysses_attention",
    "make_zigzag_ring_attention", "shard_sequence", "zigzag_permutation",
    "zigzag_shard",
    "DistributedPipelineCoordinator", "PipelineWorkerError",
    "StageLostError", "PipelineCollapsedError", "PipelineTimeouts",
    "StageWorker", "run_worker",
]
