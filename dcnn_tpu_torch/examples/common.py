"""Shared plumbing of the example drivers (counterpart of
``examples/common.py``): load the env, print the hardware and the config,
pick the input pipeline, fall back to synthetic data where a dataset is
absent, and time a callable on the device."""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import torch

from ..core.config import TrainingConfig
from ..core.device import resolve_device
from ..data import SyntheticClassificationLoader
from ..utils.env import get_env, load_env_file
from ..utils.hardware import HardwareInfo

# the repository's root: the committed snapshot and data/ live there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# what every fallback to synthetic data prints
SYNTHETIC_MARK = "using synthetic"


def device_of(device_type: str) -> torch.device:
    """``resolve_device`` for a driver: CUDA asked for with no card exits
    non-zero with its message."""
    try:
        return resolve_device(device_type)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"DEVICE_TYPE={device_type}: {e}") from None


def env_device() -> torch.device:
    """The device of a driver that builds no ``TrainingConfig``:
    ``DEVICE_TYPE`` read as ``TrainingConfig.load_from_env`` reads it."""
    return device_of(get_env("DEVICE_TYPE", TrainingConfig.device_type))


def setup(name: str) -> TrainingConfig:
    load_env_file(os.environ.get("ENV_FILE", "./.env"))
    cfg = TrainingConfig.load_from_env()
    print(f"=== {name} ===")
    HardwareInfo.print_info()
    print(f"config: {cfg.to_dict()}")
    device_of(cfg.device_type)
    return cfg


def with_prefetch(loader, cfg: TrainingConfig):
    """The train loader behind the prefetching input pipeline: batch prep
    and the host-to-device copy overlapped, K-batch chunks when
    ``cfg.steps_per_dispatch > 1`` (the Trainer's multi-step path), and a
    worker pool of ``cfg.feed_workers`` processes when that is > 0."""
    from ..data import PrefetchLoader

    return PrefetchLoader(loader, depth=2,
                          stage_batches=max(cfg.steps_per_dispatch, 1),
                          feed_workers=max(cfg.feed_workers, 0),
                          device=cfg.device_type)


def prepare_input(train_loader, val_loader, num_classes, cfg,
                  device_augment=None):
    """``RESIDENT=1`` stages both splits on the device (``DeviceDataset``:
    an epoch is one resident loop, ``device_augment`` the on-device
    recipe, since a host loader's numpy hooks do not transfer); otherwise
    the train loader goes behind :func:`with_prefetch`."""
    if get_env("RESIDENT", "0") == "1":
        from ..data import DeviceDataset

        train = DeviceDataset.from_loader(train_loader, num_classes,
                                          augment=device_augment,
                                          device=cfg.device_type)
        val = DeviceDataset.from_loader(val_loader, num_classes,
                                        device=cfg.device_type)
        print(f"input: device-resident ({train.hbm_bytes / 1e6:.0f} MB "
              f"train + {val.hbm_bytes / 1e6:.0f} MB val staged)")
        return train, val
    return with_prefetch(train_loader, cfg), val_loader


def loader_or_synthetic(make_real, image_shape, num_classes, cfg,
                        n_train=2048, n_val=512):
    """The real dataset where its files exist, else synthetic data, so
    every trainer runs end to end anywhere. It swaps data, never the
    device."""
    try:
        return make_real()
    except (FileNotFoundError, OSError, TypeError) as e:
        print(f"dataset unavailable ({e}); using synthetic data")
        train = SyntheticClassificationLoader(
            n_train, image_shape, num_classes, batch_size=cfg.batch_size,
            seed=cfg.seed)
        val = SyntheticClassificationLoader(
            n_val, image_shape, num_classes, batch_size=cfg.batch_size,
            seed=cfg.seed + 1)
        return train, val


def _sync(out: Any) -> None:
    """Wait for the work behind ``out`` (a tensor, or tensors in a tuple or
    list) where it lies on a card."""
    ts = out if isinstance(out, (tuple, list)) else (out,)
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


def time_callable(fn: Callable[[], Any], steps: int = 10, reps: int = 3,
                  warmup: int = 2) -> float:
    """Best-of-``reps`` seconds a call over ``steps`` calls of ``fn``, each
    rep ending when the device has finished (``fn`` returns the tensors it
    produced); ``warmup`` calls first."""
    out = None
    for _ in range(warmup):
        out = fn()
    _sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best / steps
