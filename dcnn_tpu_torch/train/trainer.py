"""Training loops (counterpart of ``dcnn_tpu/train/trainer.py``).

- :class:`TrainState`: the model (which holds the params), the optimizer
  state and the step count. The JAX package keeps params in an immutable
  pytree and returns a new state from every step; here the step updates
  the model's parameters and the optimizer state in place.
- :func:`make_train_step`: forward, :func:`upcast_logits`, loss, backward
  (autograd; the attention core's gradient comes from the flash backward
  kernels on CUDA) and the optimizer update, with optional microbatch
  gradient accumulation.
- :class:`Trainer`: the epoch loop over host loaders: per-batch or
  per-epoch scheduler stepping, multiplicative lr decay, validation,
  progress prints and a ``history`` of dicts with the JAX package's keys.

Runs on ``config.device_type`` (CUDA unless ``"cpu"``); asking for CUDA
without a GPU raises. What the config asks for that this package has not
ported yet raises ``NotImplementedError`` naming the field; nothing is
skipped silently.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..core.config import ProfilerType, TrainingConfig
from ..core.device import DeviceLike, resolve_device
from ..data.wire import decode_batch, wire_scale
from ..nn.sequential import Sequential
from ..ops.losses import get_loss, upcast_logits
from ..ops.metrics import correct_count
from ..optim.optimizers import Optimizer
from ..optim.schedulers import Scheduler

# (field, asks for it) of every TrainingConfig feature not ported yet
_UNPORTED = (
    ("elastic", lambda c: c.elastic),
    ("checkpoint_dir", lambda c: c.checkpoint_dir),
    ("resume", lambda c: c.resume != "never"),
    ("nonfinite_policy", lambda c: c.nonfinite_policy != "off"),
    ("stall_timeout_s", lambda c: c.stall_timeout_s > 0),
    ("slow_detect", lambda c: c.slow_detect),
    ("metrics_port", lambda c: c.metrics_port >= 0),
    ("flight_dir", lambda c: c.flight_dir),
    ("aot_cache_dir", lambda c: c.aot_cache_dir),
    ("profiler", lambda c: c.profiler != ProfilerType.NONE),
    ("steps_per_dispatch", lambda c: c.steps_per_dispatch > 1),
    ("feed_workers", lambda c: c.feed_workers > 0),
    ("debug", lambda c: c.debug),
)


def _refuse_unported(config: TrainingConfig) -> None:
    for field, asked in _UNPORTED:
        if asked(config):
            raise NotImplementedError(
                f"TrainingConfig.{field}={getattr(config, field)!r}: this "
                f"feature is not ported to dcnn_tpu_torch yet (ROADMAP.md)")


def _refuse_resident(loader) -> None:
    if type(loader).__name__ in ("DeviceDataset", "ShardedDeviceDataset"):
        raise NotImplementedError(
            f"{type(loader).__name__}: device-resident datasets are not "
            f"ported to dcnn_tpu_torch yet; pass a host loader "
            f"(ArrayDataLoader)")


def _model_device(model: Sequential) -> torch.device:
    return next(model.parameters()).device


@dataclass
class TrainState:
    """Everything that changes during training. ``model`` holds the params;
    ``opt_state`` is the optimizer's (``velocity``; ``m``, ``v``, ``t``)."""

    model: Sequential
    opt_state: Any
    step: int = 0


def create_train_state(model: Sequential, optimizer: Optimizer,
                       generator: Optional[torch.Generator] = None,
                       input_shape=None, device: DeviceLike = None
                       ) -> TrainState:
    """Initialise the model's params from ``generator`` on ``device`` (CUDA
    unless ``"cpu"``) when it has none yet or a generator is given, and the
    optimizer state for them."""
    if generator is not None or next(model.parameters(), None) is None:
        model.init(input_shape, generator=generator, device=device)
    return TrainState(model, optimizer.init(dict(model.named_parameters())))


def make_train_step(model: Sequential, loss_fn: Callable,
                    optimizer: Optimizer, num_microbatches: int = 1):
    """Returns ``step(ts, x, y, lr) -> (loss, logits)``, which updates
    ``ts`` in place. ``x`` and ``y`` are tensors on the model's device.

    With ``num_microbatches > 1`` the batch is split on the leading axis,
    the gradients of the pieces are summed and divided by their number
    (the loss likewise). A batch that does not divide evenly is trained
    whole, with a warning, as in the JAX package. The gradients stay in
    each parameter's ``.grad`` until the next step."""
    n_mb = int(num_microbatches)

    def forward_loss(x, y):
        logits = upcast_logits(model(x))
        loss = loss_fn(logits, y)
        loss.backward()
        return loss.detach(), logits.detach()

    def step(ts: TrainState, x: torch.Tensor, y: torch.Tensor, lr: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        params = dict(model.named_parameters())
        model.train()
        for p in params.values():
            p.grad = None
        if n_mb > 1 and x.shape[0] % n_mb != 0:
            warnings.warn(
                f"batch size {x.shape[0]} not divisible by num_microbatches="
                f"{n_mb}: training this batch unmicrobatched "
                f"(different BN statistics semantics)", stacklevel=2)
        if n_mb == 1 or x.shape[0] % n_mb != 0:
            loss, logits = forward_loss(x, y)
        else:
            losses, outs = [], []
            for xi, yi in zip(x.chunk(n_mb), y.chunk(n_mb)):
                li, oi = forward_loss(xi, yi)  # .grad sums over the pieces
                losses.append(li)
                outs.append(oi)
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(n_mb)
            loss = sum(losses) / n_mb
            logits = torch.cat(outs).reshape(x.shape[0], -1)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        ts.opt_state = optimizer.update(grads, ts.opt_state, params, lr)
        ts.step += 1
        return loss, logits

    return step


def make_eval_step(model: Sequential, loss_fn: Callable):
    """``eval_step(x, y) -> (loss, correct)`` without gradients."""

    @torch.no_grad()
    def eval_step(x, y):
        model.eval()
        logits = upcast_logits(model(x))
        return loss_fn(logits, y), correct_count(logits, y)

    return eval_step


def _batch(x, y, device: torch.device, scale: float):
    """One host batch onto ``device``, pixels decoded after the copy."""
    return (decode_batch(torch.as_tensor(x).to(device), scale),
            torch.as_tensor(y).to(device))


def evaluate_classification(model: Sequential, loss_fn: Callable, loader,
                            eval_step=None) -> Tuple[float, float]:
    """(mean loss, accuracy) over a host loader, on the model's device."""
    _refuse_resident(loader)
    eval_step = eval_step if eval_step is not None else make_eval_step(
        model, loss_fn)
    dev, scale = _model_device(model), wire_scale(loader)
    total_loss, total_correct, total_n = 0.0, 0, 0
    for x, y in loader:
        xb, yb = _batch(x, y, dev, scale)
        loss, correct = eval_step(xb, yb)
        total_loss += float(loss) * x.shape[0]
        total_correct += int(correct)
        total_n += x.shape[0]
    if total_n == 0:
        return 0.0, 0.0
    return total_loss / total_n, total_correct / total_n


class Trainer:
    """The epoch loop: per-epoch train and validate, lr decay or
    scheduler, progress prints. The params live in ``ts.model``; the model
    must already be on ``config.device_type``."""

    def __init__(self, model: Sequential, optimizer: Optimizer,
                 loss: Callable | str, config: Optional[TrainingConfig] = None,
                 scheduler: Optional[Scheduler] = None):
        self.config = config or TrainingConfig()
        _refuse_unported(self.config)
        self.device = resolve_device(self.config.device_type)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = get_loss(loss) if isinstance(loss, str) else loss
        self.scheduler = scheduler
        self._global_step = 0
        self.train_step = make_train_step(model, self.loss_fn, optimizer,
                                          self.config.num_microbatches)
        self.eval_step = make_eval_step(model, self.loss_fn)
        self.lr = self.config.learning_rate
        self.history: list = []

    def _check_device(self, ts: TrainState) -> None:
        dev = _model_device(ts.model)
        if dev.type != self.device.type:
            raise ValueError(f"model is on {dev}, but the config asks for "
                             f"{self.device}; build it there")

    def train_epoch(self, ts: TrainState, loader, epoch: int = 0
                    ) -> Tuple[TrainState, float, float]:
        """One pass over a host loader. Returns (ts, mean loss, accuracy)."""
        _refuse_resident(loader)
        self._check_device(ts)
        total_loss, total_correct, total_n = 0.0, 0, 0
        t0 = time.perf_counter()
        scale = wire_scale(loader)
        for bi, (x, y) in enumerate(loader):
            xb, yb = _batch(x, y, self.device, scale)
            self._global_step += 1
            loss, logits = self.train_step(ts, xb, yb, self.lr)
            total_loss += float(loss) * x.shape[0]
            total_correct += int(correct_count(logits, yb))
            total_n += x.shape[0]
            if (self.scheduler is not None
                    and self.config.scheduler_step == "batch"):
                # per-batch cadence; the metric is the running train loss
                self.lr = self.scheduler.step(total_loss / max(total_n, 1))
            if (self.config.progress_interval
                    and (bi + 1) % self.config.progress_interval == 0):
                dt = time.perf_counter() - t0
                n = max(total_n, 1)
                print(f"  epoch {epoch} batch {bi + 1}: loss "
                      f"{total_loss / n:.4f} acc {total_correct / n:.4f} "
                      f"({total_n / dt:.1f} samples/s)", flush=True)
        n = max(total_n, 1)
        return ts, total_loss / n, total_correct / n

    def fit(self, ts: TrainState, train_loader, val_loader=None,
            epochs: Optional[int] = None, seed: Optional[int] = None
            ) -> TrainState:
        """Train for ``epochs`` (default ``config.epochs``). ``seed`` is
        accepted for the JAX signature; the port's layers draw no random
        numbers while training."""
        del seed
        cfg = self.config
        if cfg.snapshot_dir and val_loader is not None:
            raise NotImplementedError(
                f"TrainingConfig.snapshot_dir={cfg.snapshot_dir!r} with a "
                f"val_loader asks for a best-val snapshot: the checkpoint "
                f"format is not ported to dcnn_tpu_torch yet; pass "
                f"snapshot_dir=None")
        epochs = epochs or cfg.epochs
        for epoch in range(1, epochs + 1):
            if hasattr(train_loader, "shuffle"):
                train_loader.shuffle(epoch)
            t0 = time.perf_counter()
            ts, train_loss, train_acc = self.train_epoch(ts, train_loader,
                                                         epoch)
            dt = time.perf_counter() - t0
            val_loss = val_acc = None
            if val_loader is not None:
                val_loss, val_acc = evaluate_classification(
                    self.model, self.loss_fn, val_loader,
                    eval_step=self.eval_step)
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "train_acc": train_acc, "val_loss": val_loss,
                                 "val_acc": val_acc, "seconds": dt,
                                 "lr": self.lr})
            msg = (f"epoch {epoch}/{epochs}: train loss {train_loss:.4f} "
                   f"acc {train_acc:.4f}")
            if val_acc is not None:
                msg += f" | val loss {val_loss:.4f} acc {val_acc:.4f}"
            print(msg + f" | {dt:.1f}s lr {self.lr:.2e}", flush=True)
            # scheduler wins; else multiplicative decay. Per-batch
            # schedulers already stepped inside train_epoch.
            if self.scheduler is not None and cfg.scheduler_step == "epoch":
                self.lr = self.scheduler.step(
                    val_loss if val_loss is not None else train_loss)
            elif (cfg.lr_decay_factor != 1.0
                  and epoch % cfg.lr_decay_interval == 0):
                self.lr *= cfg.lr_decay_factor
        return ts


@torch.no_grad()
def evaluate_regression(model: Sequential, loss_fn: Callable,
                        loader) -> float:
    """Mean loss over a regression loader, on the model's device."""
    dev = _model_device(model)
    model.eval()
    total_loss, total_n = 0.0, 0
    for x, y in loader:
        pred = model(torch.as_tensor(x).to(dev))
        total_loss += float(loss_fn(pred, torch.as_tensor(y).to(dev))) \
            * x.shape[0]
        total_n += x.shape[0]
    return total_loss / max(total_n, 1)


def train_regression_model(model: Sequential, optimizer: Optimizer,
                           loss: Callable | str, train_loader,
                           val_loader=None,
                           config: Optional[TrainingConfig] = None,
                           scheduler: Optional[Scheduler] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[TrainState, list]:
    """Regression twin of the classification loop. Returns (ts, history)."""
    config = config or TrainingConfig()
    dev = resolve_device(config.device_type)
    loss_fn = get_loss(loss) if isinstance(loss, str) else loss
    ts = create_train_state(model, optimizer, generator, device=dev)
    step = make_train_step(model, loss_fn, optimizer, config.num_microbatches)
    lr = config.learning_rate
    history = []
    for epoch in range(1, config.epochs + 1):
        if hasattr(train_loader, "shuffle"):
            train_loader.shuffle(epoch)
        total_loss, total_n = 0.0, 0
        for x, y in train_loader:
            loss_v, _ = step(ts, torch.as_tensor(x).to(dev),
                             torch.as_tensor(y).to(dev), lr)
            total_loss += float(loss_v) * x.shape[0]
            total_n += x.shape[0]
        train_loss = total_loss / max(total_n, 1)
        val_loss = (evaluate_regression(model, loss_fn, val_loader)
                    if val_loader is not None else None)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "lr": lr})
        msg = f"epoch {epoch}/{config.epochs}: train loss {train_loss:.6f}"
        if val_loss is not None:
            msg += f" | val loss {val_loss:.6f}"
        print(msg, flush=True)
        if scheduler is not None:
            lr = scheduler.step(val_loss if val_loss is not None else train_loss)
        elif (config.lr_decay_factor != 1.0
              and epoch % config.lr_decay_interval == 0):
            lr *= config.lr_decay_factor
    return ts, history


def train_classification_model(model: Sequential, optimizer: Optimizer,
                               loss: Callable | str, train_loader,
                               val_loader=None,
                               config: Optional[TrainingConfig] = None,
                               scheduler: Optional[Scheduler] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[TrainState, Trainer]:
    """Function-style entry: build a :class:`Trainer`, initialise the train
    state on the config's device, fit. Returns (ts, trainer)."""
    config = config or TrainingConfig()
    trainer = Trainer(model, optimizer, loss, config, scheduler)
    ts = create_train_state(model, optimizer, generator, device=trainer.device)
    ts = trainer.fit(ts, train_loader, val_loader)
    return ts, trainer
