"""Training configuration (counterpart of ``dcnn_tpu/core/config.py``).

``TrainingConfig`` has the JAX package's fields and defaults, except that
``device_type`` is ``"cuda"`` (default) or ``"cpu"``. ``load_from_env``
reads the same environment variables (EPOCHS, BATCH_SIZE, LR_DECAY_*,
NUM_MICROBATCHES, DEVICE_TYPE, PROFILER_TYPE, ...) through
:func:`~dcnn_tpu_torch.utils.env.get_env`, which this module re-exports.
Every field is ported: ``metrics_port`` serves the trainer's telemetry
plane (``train/trainer.py``; the elastic fit serves its own).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from enum import Enum
from typing import Optional

from ..utils.env import get_env


class ProfilerType(Enum):
    """Per-layer profiling mode."""

    NONE = "none"
    NORMAL = "normal"          # cleared every batch
    CUMULATIVE = "cumulative"  # accumulated across the epoch


@dataclass
class TrainingConfig:
    epochs: int = 10
    batch_size: int = 64
    learning_rate: float = 1e-3
    lr_decay_factor: float = 1.0      # multiplicative per-epoch decay (train.hpp:282-288)
    lr_decay_interval: int = 1
    num_microbatches: int = 1
    device_type: str = "cuda"         # "cuda" | "cpu"
    profiler: ProfilerType = ProfilerType.NONE
    seed: int = 42
    snapshot_dir: Optional[str] = "model_snapshots"
    progress_interval: int = 100      # batches between progress prints (train.hpp:149-162)
    dtype: str = "float32"            # "float32" parity mode | "bfloat16" fast mode
    debug: bool = False               # numeric sanitizers (reference ENABLE_DEBUG
                                      # ASan build, CMakeLists.txt:22; core/debug.py)
    scheduler_step: str = "epoch"     # "epoch" (reference cadence, train.hpp:282-288)
                                      # | "batch" (what OneCycleLR/WarmupCosine are
                                      # usually sized for: total_steps = epochs*batches)
    steps_per_dispatch: int = 1       # >1: expect [K,B,...] chunks (PrefetchLoader
                                      # stage_batches=K) and run K train steps per
                                      # device dispatch (train.make_multi_step) —
                                      # the remote/tunnelled-TPU fast path
    feed_workers: int = 0             # >0: parallel host input pipeline — a
                                      # FeedWorkerPool of this many worker
                                      # processes does gather/augment/collate
                                      # into shared-memory slots for the
                                      # prefetch/streaming feeds
                                      # (data/workers.py; docs/performance.md)

    # -- fault tolerance (dcnn_tpu/resilience; docs/reliability.md) --
    checkpoint_dir: Optional[str] = None  # root for periodic atomic checkpoints
                                      # (CheckpointManager; separate from the
                                      # best-val snapshot_dir)
    checkpoint_every: int = 0         # epochs between periodic checkpoints
                                      # (0 = off; needs checkpoint_dir)
    checkpoint_keep: int = 3          # keep-last-K retention
    checkpoint_async: bool = True     # background saver thread: the step loop
                                      # pays only the device_get snapshot
    resume: str = "never"             # "auto": restore the newest valid
                                      # checkpoint from checkpoint_dir at
                                      # fit() and continue | "never"
    nonfinite_policy: str = "off"     # "off" (exact pre-guard graph) | "raise"
                                      # | "skip_step" | "rollback" — see
                                      # resilience.StepGuard
    rollback_after: int = 3           # consecutive bad steps before a
                                      # "rollback" policy restores the last
                                      # checkpoint
    stall_timeout_s: float = 0.0      # >0: StallWatchdog flags a hung
                                      # step/data fetch on the obs registry

    # -- elastic data-parallel training (dcnn_tpu/parallel/elastic.py;
    #    docs/reliability.md §"Elastic training") --
    elastic: bool = False             # fit() runs the elastic DP controller:
                                      # generation-stamped membership over
                                      # the peer mesh, survives host loss
                                      # mid-epoch via checkpoint-restore +
                                      # batch-plan reshard
    elastic_peers: str = ""           # "host:port,host:port,..." — one per
                                      # host, rank = position (empty: solo)
    elastic_rank: int = -1            # this host's rank (-1: PROCESS_ID env)
    elastic_microbatches: int = 0     # global grad-accumulation grid K,
                                      # fixed for the run; batch_size/K rows
                                      # per microbatch (0: initial world
                                      # size). The grid is re-partitioned —
                                      # never re-gridded — across survivors,
                                      # holding the global batch constant
    elastic_heartbeat_s: float = 1.0  # background beat period (0: beats
                                      # only ride the step loop)
    elastic_timeout_s: float = 30.0   # peer silence before it is declared
                                      # dead; also the frame-wait deadline
    elastic_ckpt_steps: int = 0       # mid-epoch checkpoint cadence in
                                      # optimizer steps (0: epoch boundaries
                                      # only — a loss re-runs the epoch)
    elastic_min_world: int = 1        # fewer survivors than this aborts
                                      # (WorldCollapsedError) instead of
                                      # limping on
    elastic_compress: str = ""        # frame codec for the grad-exchange
                                      # mesh: "" = raw, or a name from
                                      # utils/compression.resolve_codec
                                      # ("lz4", "shuffle-lz4", "zstd",
                                      # "shuffle-zstd", "zlib"). Per-frame
                                      # codec ids keep mixed fleets interop

    # -- gray-failure (fail-slow) detection (resilience/slowness.py;
    #    docs/reliability.md §11). slow_detect gates the training-side
    #    mitigations (elastic straggler eviction, feed-worker recycle);
    #    the thresholds seed the shared SlownessConfig, with DCNN_SLOW_*
    #    env overrides layered on top by SlownessConfig.from_env --
    slow_detect: bool = False         # convict-and-mitigate on sustained
                                      # relative slowness (off = observe
                                      # nothing; fail-stop paths unchanged)
    slow_dwell_s: float = 1.0         # sustained outlier-hood before convict
    slow_ratio: float = 2.0           # conviction floor: EWMA > ratio*median
    slow_mad_k: float = 4.0           # MAD multiplier of the outlier test
    slow_min_samples: int = 3         # samples before a component is scored

    # -- AOT executable cache (dcnn_tpu/aot; docs/performance.md) --
    aot_cache_dir: Optional[str] = None  # cache ROOT: warm-start the
                                      # train/multi step from persisted
                                      # executables under <root>/aot and
                                      # commit fresh compiles there
                                      # (shareable across processes and
                                      # hosts). None: AOT_CACHE env, else
                                      # off.

    # -- external telemetry (obs/server.py, obs/goodput.py, obs/rules.py)
    metrics_port: int = -1            # >=0: serve /metrics + /healthz +
                                      # /snapshot + /goodput over HTTP for
                                      # the whole fit() (0 = ephemeral
                                      # port; -1 = off). healthz wires the
                                      # stall watchdog, checkpoint health
                                      # and the alert rules automatically
    flight_dir: Optional[str] = None  # failure flight recorder root
                                      # (obs/flight.py): degradation edges
                                      # (healthz 503, watchdog stall,
                                      # non-finite guard) dump atomic
                                      # keep-K postmortem bundles here.
                                      # Configures the process-global
                                      # recorder; None: DCNN_FLIGHT_DIR
                                      # env, else off

    @classmethod
    def load_from_env(cls) -> "TrainingConfig":
        """The config from environment variables, defaults for the rest."""
        base = cls()
        return cls(
            epochs=get_env("EPOCHS", base.epochs),
            batch_size=get_env("BATCH_SIZE", base.batch_size),
            learning_rate=get_env("LEARNING_RATE", base.learning_rate),
            lr_decay_factor=get_env("LR_DECAY_FACTOR", base.lr_decay_factor),
            lr_decay_interval=get_env("LR_DECAY_INTERVAL", base.lr_decay_interval),
            num_microbatches=get_env("NUM_MICROBATCHES", base.num_microbatches),
            device_type=get_env("DEVICE_TYPE", base.device_type),
            profiler=ProfilerType(get_env("PROFILER_TYPE", base.profiler.value).lower()),
            seed=get_env("SEED", base.seed),
            snapshot_dir=get_env("SNAPSHOT_DIR", base.snapshot_dir or "model_snapshots"),
            progress_interval=get_env("PROGRESS_INTERVAL", base.progress_interval),
            dtype=get_env("DTYPE", base.dtype),
            debug=get_env("DCNN_DEBUG", base.debug),
            scheduler_step=get_env("SCHEDULER_STEP", base.scheduler_step),
            steps_per_dispatch=get_env("STEPS_PER_DISPATCH",
                                       base.steps_per_dispatch),
            feed_workers=get_env("FEED_WORKERS", base.feed_workers),
            checkpoint_dir=get_env("CKPT_DIR", base.checkpoint_dir or "") or None,
            checkpoint_every=get_env("CKPT_EVERY", base.checkpoint_every),
            checkpoint_keep=get_env("CKPT_KEEP", base.checkpoint_keep),
            checkpoint_async=get_env("CKPT_ASYNC", base.checkpoint_async),
            resume=get_env("CKPT_RESUME", base.resume),
            nonfinite_policy=get_env("NONFINITE_POLICY", base.nonfinite_policy),
            rollback_after=get_env("ROLLBACK_AFTER", base.rollback_after),
            stall_timeout_s=get_env("STALL_TIMEOUT_S", base.stall_timeout_s),
            elastic=get_env("ELASTIC", base.elastic),
            elastic_peers=get_env("ELASTIC_PEERS", base.elastic_peers),
            elastic_rank=get_env("ELASTIC_RANK", base.elastic_rank),
            elastic_microbatches=get_env("ELASTIC_MICROBATCHES",
                                         base.elastic_microbatches),
            elastic_heartbeat_s=get_env("ELASTIC_HEARTBEAT_S",
                                        base.elastic_heartbeat_s),
            elastic_timeout_s=get_env("ELASTIC_TIMEOUT_S",
                                      base.elastic_timeout_s),
            elastic_ckpt_steps=get_env("ELASTIC_CKPT_STEPS",
                                       base.elastic_ckpt_steps),
            elastic_min_world=get_env("ELASTIC_MIN_WORLD",
                                      base.elastic_min_world),
            elastic_compress=get_env("ELASTIC_COMPRESS",
                                     base.elastic_compress),
            slow_detect=get_env("DCNN_SLOW_DETECT", base.slow_detect),
            slow_dwell_s=get_env("DCNN_SLOW_DWELL_S", base.slow_dwell_s),
            slow_ratio=get_env("DCNN_SLOW_RATIO", base.slow_ratio),
            slow_mad_k=get_env("DCNN_SLOW_MAD_K", base.slow_mad_k),
            slow_min_samples=get_env("DCNN_SLOW_MIN_SAMPLES",
                                     base.slow_min_samples),
            aot_cache_dir=get_env("AOT_CACHE",
                                  base.aot_cache_dir or "") or None,
            metrics_port=get_env("METRICS_PORT", base.metrics_port),
            flight_dir=get_env("DCNN_FLIGHT_DIR",
                               base.flight_dir or "") or None,
        )

    def to_dict(self) -> dict:
        d = asdict(self)
        d["profiler"] = self.profiler.value
        return d
