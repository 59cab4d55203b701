"""Data-loader base (counterpart of ``dcnn_tpu/data/loader.py``), numpy only.

Loaders produce numpy batches on the host; the trainer copies each batch to
the device and decodes it there (:mod:`.wire`). Batch membership and order
come from :meth:`BaseDataLoader.batch_indices` and depend only on
(seed, epoch), so a port loader and a JAX loader with the same seed give
the same batches. The augmentation hook runs per batch at iteration time,
continuing the epoch's generator after the shuffle permutation. Host
augmentation on a uint8 loader runs in float32 0..255 and re-quantizes
(clip, round half to even, cast), so the wire stays uint8.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np


def one_hot(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """One-hot targets."""
    out = np.zeros((len(labels), num_classes), dtype)
    out[np.arange(len(labels)), np.asarray(labels, np.int64)] = 1
    return out


class BaseDataLoader:
    """Iterable over (x, y) batches with shuffle + augmentation hook."""

    def __init__(self, batch_size: int = 64, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 augmentation: Optional[Callable[[np.ndarray, np.random.Generator],
                                                 np.ndarray]] = None):
        self.batch_size = int(batch_size)
        self._shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.augmentation = augmentation
        self._epoch = 0
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None

    # subclasses populate _x/_y in load_data()
    def load_data(self) -> None:
        raise NotImplementedError

    def _ensure_loaded(self):
        if self._x is None:
            self.load_data()
        if self._x is None or self._y is None:
            raise RuntimeError("load_data() did not populate data")

    def __len__(self) -> int:
        self._ensure_loaded()
        n = len(self._x)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        self._ensure_loaded()
        return len(self._x)

    @property
    def wire_dtype(self) -> np.dtype:
        """Dtype of the batches this loader ships across the host-to-device
        copy: uint8 for image loaders (the consumer decodes), float32 for
        tabular and regression data."""
        self._ensure_loaded()
        return self._x.dtype

    @property
    def scale(self) -> float:
        """Decode multiplier the consumer applies after the copy:
        ``decoded = x.float() * scale``. 1/255 for uint8 pixels, 1.0 for
        data already in model domain. The multiply form (not ``x / 255``)
        is the contract."""
        self._ensure_loaded()
        return 1.0 / 255.0 if self._x.dtype == np.uint8 else 1.0

    def shuffle(self, epoch: int) -> None:
        """Reshuffle ordering for a new epoch."""
        self._epoch = epoch

    def epoch_rng(self) -> np.random.Generator:
        """The epoch's generator: the shuffle permutation draws first,
        then (in ``__iter__``) the augmentation hook continues the same
        stream — one seed fully determines an epoch."""
        return np.random.default_rng(self.seed + self._epoch)

    def batch_indices(self, rng: Optional[np.random.Generator] = None
                      ) -> Iterator[np.ndarray]:
        """Per-batch row-index arrays for the current epoch, in iteration
        order: the definition of batch membership and order. ``rng`` lets
        ``__iter__`` pass its own generator (the augmentation hook continues
        that stream after the permutation)."""
        self._ensure_loaded()
        n = len(self._x)
        if rng is None:
            rng = self.epoch_rng()
        idx = rng.permutation(n) if self._shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield idx[start:start + self.batch_size]

    def shard_batch_indices(self, rank: int, world_size: int,
                            rng: Optional[np.random.Generator] = None
                            ) -> Iterator[np.ndarray]:
        """One host's view of :meth:`batch_indices` in a ``world_size``-way
        data-parallel group: for every global batch, the contiguous
        ``batch_size / world_size`` slice belonging to ``rank``. Membership
        and order depend only on (seed, epoch), never on the world size,
        so the union of the slices is the same global batch sequence."""
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        if self.batch_size % world_size:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"world_size {world_size}: the global batch could not be "
                f"kept constant across hosts")
        if not self.drop_last:
            raise ValueError(
                "shard_batch_indices requires drop_last=True: a ragged "
                "tail batch cannot be split into equal host shares, so "
                "the fixed-global-batch contract would silently break "
                "on the last step of every epoch")
        per = self.batch_size // world_size
        for idx in self.batch_indices(rng):
            yield idx[rank * per:(rank + 1) * per]

    def rows(self, sel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Gather raw ``(x, y)`` rows by index."""
        self._ensure_loaded()
        return self._x[sel], self._y[sel]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._ensure_loaded()
        rng = self.epoch_rng()
        requantize = self.augmentation is not None \
            and self._x.dtype == np.uint8
        for take in self.batch_indices(rng):
            xb = self._x[take]
            yb = self._y[take]
            if self.augmentation is not None:
                if requantize:
                    # uint8 wire: augment in float32 0..255 domain, then
                    # clip + round-to-nearest back to exact uint8
                    xf = self.augmentation(xb.astype(np.float32), rng)
                    np.clip(xf, 0.0, 255.0, out=xf)
                    np.rint(xf, out=xf)
                    xb = xf.astype(np.uint8)
                else:
                    xb = self.augmentation(xb.copy(), rng)
            yield xb, yb


class ArrayDataLoader(BaseDataLoader):
    """Loader over in-memory arrays (test/synthetic backend)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, **kw):
        super().__init__(**kw)
        self._x = np.asarray(x)
        self._y = np.asarray(y)

    def load_data(self) -> None:
        pass
