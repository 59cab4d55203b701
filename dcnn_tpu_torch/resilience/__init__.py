"""Fault tolerance (counterpart of ``dcnn_tpu/resilience``): atomic commits
(:mod:`.atomic`), checkpoints with retention, async saves and verified
restore (:mod:`.checkpoint`), seeded fault injection and delay hooks
(:mod:`.faults`), the non-finite step guard and stall watchdog
(:mod:`.guards`), bounded backoff (:mod:`.retry`) and gray-failure
detection (:mod:`.slowness`)."""

from .atomic import (
    commit_dir, fsync_path, sha256_file, stage_dir, sweep_stale_tmp,
    write_file_atomic,
)
from .checkpoint import (
    CheckpointManager, RestoredCheckpoint, list_steps, restore_latest,
    verify_dir,
)
from .faults import FaultPlan, InjectedCrash, InjectedFault
from .guards import NonFiniteError, StallWatchdog, StepGuard, global_norm_sq
from .retry import backoff_delays, retriable, retry_call
from .slowness import SlownessConfig, SlownessDetector

__all__ = ["CheckpointManager", "FaultPlan", "InjectedCrash", "InjectedFault",
           "NonFiniteError", "RestoredCheckpoint", "SlownessConfig",
           "SlownessDetector", "StallWatchdog", "StepGuard",
           "backoff_delays", "commit_dir", "fsync_path", "global_norm_sq",
           "list_steps", "restore_latest", "retriable", "retry_call",
           "sha256_file", "stage_dir",
           "sweep_stale_tmp", "verify_dir", "write_file_atomic"]
