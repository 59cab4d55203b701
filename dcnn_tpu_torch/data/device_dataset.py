"""Device-resident dataset: stage once, train epochs with no steady-state
host-to-device copy (counterpart of ``dcnn_tpu/data/device_dataset.py``).

The split is staged into device memory once as uint8 (Tiny-ImageNet's train
split, 100,000 x 3x64x64, is 1.2 GB, 1.5% of an H100's 80 GB), labels as
int32, and everything the host loader does per batch happens on the card:

- shuffle: a permutation drawn on the device from the epoch's key;
- batching: the permutation reshaped to [steps, B]; each step gathers its
  B rows from the resident uint8 tensor;
- decode: cast to the compute dtype and multiply by the scale (1/255);
- augmentation: the ops of :mod:`.augment_device`;
- labels: int32, one-hot per batch on the device.

An epoch is one Python loop of train steps that never waits for the card:
the permutation, the draws and the lr vector are device tensors, and the
losses stay on the card until the caller reads their mean once (the JAX
package's ``float(mean_loss)`` after its one-dispatch epoch). On CUDA each
step replays one CUDA graph of its whole body (:class:`BatchStep`), the
counterpart of the JAX package's one ``lax.scan`` inside one jit. Validation
runs full batches and one exact remainder batch, so any mean-reducing loss
is exact.

Random draws follow int keys (:mod:`dcnn_tpu_torch.core.keys`): an epoch's
key splits into a permutation key and a step key, step ``i`` draws with
``fold_in(step_key, i)`` and its augmentation with ``fold_in(that,
0x0A6)``, the JAX package's derivation. The resident epoch takes an
explicit batch order too (``order=``, [steps, B] indices), so a test can
hand it the JAX package's permutation.

The data-parallel variants (``ShardedDeviceDataset``,
``make_resident_epoch_dp``, ``resident_epoch_dp``, ``stage_sharded``) are
not ported yet and raise (``ROADMAP.md`` Queue 1 item 6).
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.graphs import SessionCache
from ..core.keys import (
    fold_in, generator, generators, reseed, split, to_device,
)
from ..core.precision import get_compute_dtype, get_precision_mode
from .augment_device import DeviceAugment
from .transfer import stage_array

AUGMENT_KEY = 0x0A6  # fold_in offset of a step's augmentation key
_DP_MSG = ("data-parallel resident datasets are not ported to "
           "dcnn_tpu_torch yet (ROADMAP.md Queue 1 item 6, Parallel)")


class DeviceDataset:
    """A classification split staged into device memory once.

    Args:
      x: [N, ...] images, uint8 (4x smaller than fp32 on the card) or
        float, already in the model's data format.
      y: [N] integer labels (one-hot is collapsed).
      num_classes: one-hot width.
      batch_size: per-step batch; an epoch runs ``N // batch_size`` steps.
      augment: an optional :class:`~.augment_device.DeviceAugment`, applied
        after the decode.
      scale: decode multiplier (1/255 for uint8, 1 for float by default).
      transfer_engine: an optional :class:`~.transfer.TransferEngine` for
        the one-time staging copy; by default the split goes through two
        reused pinned buffers of 64 MiB (:func:`~.transfer.stage_array`).
      device: where to stage (CUDA unless ``"cpu"``).

    ``stage_seconds`` is the staging's wall time, the copy landed.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, num_classes: int, *,
                 batch_size: int, augment: Optional[Callable] = None,
                 scale: Optional[float] = None, transfer_engine=None,
                 device=None):
        x = np.asarray(x)
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(axis=-1)
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch: {len(x)} vs {len(y)}")
        if batch_size > len(x):
            raise ValueError(f"batch_size {batch_size} > dataset {len(x)}")
        self.device = resolve_device(device)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        self.augment = augment
        self.scale = float(scale if scale is not None
                           else (1.0 / 255.0 if x.dtype == np.uint8 else 1.0))
        self.num_samples = len(x)
        self.sample_shape = x.shape[1:]
        t0 = time.perf_counter()
        self.x = (transfer_engine.put_array(x) if transfer_engine is not None
                  else stage_array(x, self.device))
        self.y = stage_array(y.astype(np.int32), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds = time.perf_counter() - t0

    @property
    def steps_per_epoch(self) -> int:
        return self.num_samples // self.batch_size

    def __len__(self) -> int:
        """Batches per epoch, as a loader's length (schedulers size their
        per-batch cycles with it)."""
        return self.steps_per_epoch

    @property
    def hbm_bytes(self) -> int:
        """Device bytes the split holds (the JAX package's name)."""
        return (self.x.numel() * self.x.element_size()
                + self.y.numel() * self.y.element_size())

    @classmethod
    def from_loader(cls, loader, num_classes: int, *, batch_size=None,
                    augment=None, device=None) -> "DeviceDataset":
        """Stage a host loader's arrays. Its numpy ``augmentation`` hook
        cannot run on the card and is not carried over: rebuild the recipe
        with ``DeviceAugmentBuilder`` and pass ``augment=`` (a warning says
        so where one would be dropped)."""
        loader._ensure_loaded()
        if getattr(loader, "augmentation", None) is not None and augment is None:
            warnings.warn(
                "from_loader: the host loader's numpy augmentation hook does "
                "not transfer to the device; rebuild it with "
                "DeviceAugmentBuilder and pass augment=, or training will "
                "run unaugmented", stacklevel=2)
        return cls(loader._x, loader._y, num_classes,
                   batch_size=batch_size or loader.batch_size,
                   augment=augment, device=device)


def _decode(x: torch.Tensor, scale: float, cdt) -> torch.Tensor:
    """``x`` in the compute dtype times ``scale`` rounded to it, as the JAX
    package's ``x.astype(cdt) * asarray(scale, cdt)``."""
    cdt = cdt or torch.float32
    return x.to(cdt) * float(torch.tensor(scale, dtype=cdt))


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[:, None] == classes).float()


class BatchStep:
    """The gather -> decode -> augment -> one-hot -> train-step body shared
    by the resident and the streaming feeds: ``body(ts, x_all, y_all,
    batch_indices, key, lr) -> loss`` (a device scalar). ``step`` is a
    :func:`~dcnn_tpu_torch.train.make_train_step` step; the step's dropout
    draws from ``generator(key)``, augmentation op ``i`` from
    ``fold_in(fold_in(key, 0x0A6), i)``, through a fixed set of generators
    reseeded on the host each call.

    With the step's ``jit`` on CUDA the whole body is one CUDA graph, its
    input the batch indices (a shape's first call eager, its warm-up; the
    next captured in the step's pool), bound to the addresses of
    ``x_all``, ``y_all`` and the train state's tensors (others capture
    again). There ``augment`` must be a
    :class:`~.augment_device.DeviceAugment`, whose draws come from the
    reseeded generators: any other callable is refused, since a graph
    would replay the draws it made at capture. On the CPU, or with
    ``jit=False``, another callable is called with its key. While
    :func:`~dcnn_tpu_torch.core.graphs.debug_eager` holds, the body runs
    eagerly."""

    def __init__(self, step, *, num_classes, scale, cdt, augment):
        self.step = step
        self.num_classes, self.scale, self.cdt = num_classes, scale, cdt
        self.augment = augment
        self._routed = isinstance(augment, DeviceAugment)
        self.gens = None  # on the data's device, at the first call
        self._aug_key = None
        self._sessions = SessionCache()

    def run(self, ts, x_all, y_all, bidx):
        """The body on the card, drawing from :attr:`gens`."""
        xb = _decode(x_all[bidx], self.scale, self.cdt)
        if self._routed:
            xb = self.augment.run(xb, self.gens[1:])
        elif self.augment is not None:
            xb = self.augment(xb, self._aug_key)
        yb = _one_hot(y_all[bidx], self.num_classes)
        loss, _ = self.step.body(ts, xb, yb, self.gens[0])
        return loss

    def _session(self, ts, x_all, y_all, bidx):
        key = (tuple(bidx.shape), tuple(x_all.shape), x_all.dtype,
               tuple(y_all.shape))
        bind = (x_all.data_ptr(), y_all.data_ptr(), *self.step.binding(ts))
        return self._sessions.lookup(
            key, bind, lambda: self.step.capture(
                "batch_step", lambda b: self.run(ts, x_all, y_all, b),
                (bidx,), self.gens), self.step.model)

    def __call__(self, ts, x_all, y_all, bidx, key: int, lr):
        step = self.step
        if self.gens is None:
            self.gens = generators(
                1 + (len(self.augment.ops) if self._routed else 0),
                x_all.device)
        self._aug_key = fold_in(key, AUGMENT_KEY)
        reseed(self.gens, [key] + (self.augment.keys(self._aug_key)
                                   if self._routed else []))
        step.model.train()
        step.begin(ts, lr)
        if step.pool is not None and self.augment is not None \
                and not self._routed:
            raise TypeError(
                f"a captured batch step needs a DeviceAugment, got "
                f"{type(self.augment).__name__}: a CUDA graph would replay "
                f"the draws of its capture; build it with "
                f"DeviceAugmentBuilder, or pass jit=False")
        if step.pool is None:
            loss = self.run(ts, x_all, y_all, bidx)
        else:
            with step.pool.lock:
                session = self._session(ts, x_all, y_all, bidx)
                if session is None:
                    loss = self.run(ts, x_all, y_all, bidx)
                else:
                    loss = session(bidx)
                    for p, g in session.grads:
                        p.grad = g
        step.end(ts)
        return loss


def lr_per_step(lr, k: int, device):
    """A scalar lr for every step, or a [k] vector on the device."""
    if isinstance(lr, torch.Tensor) or np.ndim(lr) > 0:
        lrs = (lr.to(device, torch.float32) if isinstance(lr, torch.Tensor)
               else to_device(np.asarray(lr, np.float32), device))
        if lrs.shape != (k,):
            raise ValueError(f"lr vector of shape {tuple(lrs.shape)} for "
                             f"{k} steps")
        return list(lrs.unbind(0))
    return [float(lr)] * k


def permutation(key: int, n: int, need: int, device) -> torch.Tensor:
    """``need`` indices of ``range(n)``: whole permutations drawn on the
    device from ``fold_in(key, r)``, tiled where ``need > n``."""
    reps = -(-need // n)
    return torch.cat([torch.randperm(n, generator=generator(fold_in(key, r),
                                                            device),
                                     device=device)
                      for r in range(reps)])[:need]


def make_resident_epoch(model, loss_fn: Callable, optimizer, *,
                        num_classes: int, batch_size: int,
                        augment: Optional[Callable] = None,
                        scale: float = 1.0 / 255.0,
                        steps: Optional[int] = None,
                        num_microbatches: int = 1, jit: bool = True):
    """Build the resident epoch: ``epoch(ts, x_all, y_all, key, lr,
    order=None) -> (ts, mean_loss)``, ``mean_loss`` a device scalar.

    It shuffles on the device, then runs a full train step (gather ->
    decode -> augment -> one-hot -> forward, backward, update) per batch,
    each step as the host loop's (per-batch BN statistics and optimizer
    updates, a per-step key). ``lr`` is a scalar or a [steps] vector (a
    per-batch schedule stays exact). ``steps`` beyond ``n // batch_size``
    tile further permutations. ``order`` ([steps, B] indices into the
    split) replaces the drawn permutation.

    With ``jit`` on CUDA each step replays one graph of the whole body
    (:class:`BatchStep`), the permutation drawn once an epoch outside it;
    neither the replays nor the capture wait for the card."""
    from ..train.trainer import make_train_step

    step = make_train_step(model, loss_fn, optimizer, num_microbatches,
                           jit=jit)
    body = BatchStep(step, num_classes=num_classes, scale=scale,
                     cdt=get_compute_dtype(), augment=augment)

    def epoch(ts, x_all, y_all, key: int, lr, order=None):
        n, dev = x_all.shape[0], x_all.device
        if n < batch_size:
            raise ValueError(
                f"resident epoch needs at least one batch: split has {n} "
                f"samples < batch_size {batch_size}")
        kperm, kstep = split(key)
        if order is None:
            k = steps if steps is not None else n // batch_size
            idx = permutation(kperm, n, k * batch_size, dev).reshape(
                k, batch_size)
        else:
            idx = (order.to(dev) if isinstance(order, torch.Tensor)
                   else to_device(np.asarray(order, np.int64), dev))
            if idx.ndim != 2 or idx.shape[1] != batch_size:
                raise ValueError(f"order must be [steps, {batch_size}], got "
                                 f"{tuple(idx.shape)}")
            k = idx.shape[0]
        lrs = lr_per_step(lr, k, dev)
        losses = torch.stack([body(ts, x_all, y_all, idx[i],
                                   fold_in(kstep, i), lrs[i])
                              for i in range(k)])
        return ts, losses.mean()

    epoch.step, epoch.body = step, body
    return epoch


def make_resident_eval(model, loss_fn: Callable, *, num_classes: int,
                       batch_size: int):
    """Build the whole-split eval: ``evaluate(x_all, y_all, scale) ->
    (loss_sum, correct, n)`` over ``n // B`` full batches and one exact
    remainder batch (no padding rows, so ``loss_sum / n`` is exact for any
    mean-reducing loss). ``loss_sum`` accumulates ``loss * rows`` in
    float64 on the device, the sum a host loop forms in Python floats, so
    it equals the host eval of the same batches; ``correct`` is an int64
    device scalar. Each batch runs through
    :func:`~dcnn_tpu_torch.train.make_eval_step`'s step, on CUDA one graph
    for the full batches and one for the remainder."""
    from ..train.trainer import make_eval_step

    cdt = get_compute_dtype()
    step = make_eval_step(model, loss_fn)

    @torch.no_grad()
    def evaluate(x_all, y_all, scale: float = 1.0 / 255.0):
        n = x_all.shape[0]
        loss_sum = torch.zeros((), dtype=torch.float64, device=x_all.device)
        correct = torch.zeros((), dtype=torch.int64, device=x_all.device)
        for lo in range(0, n, batch_size):
            xb = _decode(x_all[lo:lo + batch_size], scale, cdt)
            yb = y_all[lo:lo + batch_size]
            loss, right = step(xb, _one_hot(yb, num_classes))
            loss_sum += loss.double() * yb.shape[0]
            correct += right
        return loss_sum, correct, n

    return evaluate


@functools.lru_cache(maxsize=32)
def _resident_epoch_cached(model, loss_fn, optimizer, num_classes, batch_size,
                           augment, scale, num_microbatches, _mode):
    return make_resident_epoch(model, loss_fn, optimizer,
                               num_classes=num_classes, batch_size=batch_size,
                               augment=augment, scale=scale,
                               num_microbatches=num_microbatches)


@functools.lru_cache(maxsize=32)
def _resident_eval_cached(model, loss_fn, num_classes, batch_size, _mode):
    return make_resident_eval(model, loss_fn, num_classes=num_classes,
                              batch_size=batch_size)


def resident_epoch(model, loss_fn, optimizer, dataset: DeviceDataset,
                   num_microbatches: int = 1):
    """The epoch function for a (model, loss, optimizer, dataset geometry,
    precision mode), built once and reused (keyed on the objects'
    identity, as in the JAX package)."""
    return _resident_epoch_cached(model, loss_fn, optimizer,
                                  dataset.num_classes, dataset.batch_size,
                                  dataset.augment, dataset.scale,
                                  num_microbatches, get_precision_mode())


def resident_eval(model, loss_fn, dataset: DeviceDataset):
    """The whole-split eval function (see :func:`make_resident_eval`)."""
    return _resident_eval_cached(model, loss_fn, dataset.num_classes,
                                 dataset.batch_size, get_precision_mode())


class ShardedDeviceDataset:
    """Not ported yet: a split sharded over several cards."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ShardedDeviceDataset: {_DP_MSG}")


def make_resident_epoch_dp(*args, **kwargs):
    raise NotImplementedError(f"make_resident_epoch_dp: {_DP_MSG}")


def resident_epoch_dp(*args, **kwargs):
    raise NotImplementedError(f"resident_epoch_dp: {_DP_MSG}")


def stage_sharded(*args, **kwargs):
    raise NotImplementedError(f"stage_sharded: {_DP_MSG}")
