"""Training loops (counterpart of ``dcnn_tpu/train/trainer.py``).

- :class:`TrainState`: the model (which holds the params), the optimizer
  state and the step count. The JAX package keeps params in an immutable
  pytree and returns a new state from every step; here the step updates
  the model's parameters and the optimizer state in place.
- :func:`make_train_step`: forward, :func:`upcast_logits`, loss, backward
  (autograd; the attention core's gradient comes from the flash backward
  kernels on CUDA) and the optimizer update, with optional microbatch
  gradient accumulation; dropout draws from the step's generator. With
  ``guard=True`` a non-finite loss or gradient skips the update and puts
  the batchnorm statistics back (``resilience/guards.py``).
- :func:`make_multi_step`: K train steps over a [K, B, ...] chunk with
  one read of their mean loss, the JAX package's one-dispatch chunk.
- :class:`Trainer`: the epoch loop over host loaders: per-batch or
  per-epoch scheduler stepping, multiplicative lr decay, validation,
  progress prints and a ``history`` of dicts with the JAX package's keys;
  the best-val snapshot (``snapshot_dir``), periodic checkpoints
  (``checkpoint_dir``) and ``resume="auto"``, the non-finite guard's
  policies and the stall watchdog. Each batch's random draws come from a
  generator seeded by (seed, epoch, batch) (:func:`batch_generator`), the
  JAX trainer's ``fold_in(fold_in(key, epoch), batch)``: one seed gives the
  same masks run after run, so a resumed run replays the uninterrupted one.
  Two fast paths read the losses once per epoch or chunk and report train
  accuracy as NaN, as in the JAX package: a ``DeviceDataset`` trains
  through the resident epoch (``data/device_dataset.py``), and
  ``steps_per_dispatch = K > 1`` through :func:`make_multi_step` over the
  [K, B, ...] chunks of ``PrefetchLoader(stage_batches=K)``; their keys
  are ``fold_in(fold_in(seed, epoch), epoch)`` and ``fold_in(fold_in(seed,
  epoch), chunk)`` (:mod:`dcnn_tpu_torch.core.keys`).

Observability, as in the JAX trainer: ``train.epoch``, ``train.step``,
``train.chunk``, ``train.resident_epoch`` and ``train.eval`` spans (track
``train``; each step's, chunk's and epoch's span ends after its loss is
read on the host, which the loop does anyway, so a span adds no wait for
the card), per-epoch rollups on the process-global registry
(``train_epochs_total``, ``train_epoch_seconds``, the memory gauges, ...),
``flight_dir`` configuring the process-global flight recorder (the step
guard's and the watchdog's bundles), ``profiler`` running one
:class:`~dcnn_tpu_torch.train.profiling.LayerProfiler` forward and backward
per epoch outside the step (buffers put back, so the run's numbers do not
move), and ``debug`` turning on :mod:`~dcnn_tpu_torch.core.debug`'s
non-finite checks. ``slow_detect`` is read by elastic training only, as in
the JAX package, so a plain fit accepts it and does nothing.

Runs on ``config.device_type`` (CUDA unless ``"cpu"``); asking for CUDA
without a GPU raises. What the config asks for that this package has not
ported yet raises ``NotImplementedError`` naming the field; nothing is
skipped silently.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

import numpy as np

from ..core import debug as _debug
from ..core.config import ProfilerType, TrainingConfig
from ..core.device import DeviceLike, resolve_device
from ..core.graphs import GraphPool, Session, SessionCache, debug_eager
from ..core.keys import fold_in, generator, to_device
from ..core.precision import get_precision_mode
from ..data.device_dataset import (
    DeviceDataset, lr_per_step, resident_epoch, resident_eval,
)
from ..data.wire import decode_batch, wire_scale
from ..nn.sequential import Sequential
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..obs.xla import sample_hbm
from ..ops import _kernels
from ..ops.losses import get_loss, upcast_logits
from ..ops.metrics import correct_count
from ..optim.optimizers import Optimizer
from ..optim.schedulers import Scheduler
from ..resilience import faults as _faults
from ..resilience.checkpoint import CheckpointManager
from ..resilience.guards import StallWatchdog, StepGuard, global_norm_sq
from .checkpoint import save_checkpoint
from .profiling import LayerProfiler

# (field, asks for it, the ROADMAP.md Queue 1 item that ports it) of every
# TrainingConfig feature not ported yet
_UNPORTED = (
    ("elastic", lambda c: c.elastic, 6),
    ("metrics_port", lambda c: c.metrics_port >= 0, 7),
)


def _refuse_unported(config: TrainingConfig) -> None:
    for field, asked, item in _UNPORTED:
        if asked(config):
            raise NotImplementedError(
                f"TrainingConfig.{field}={getattr(config, field)!r}: this "
                f"feature is not ported to dcnn_tpu_torch yet (ROADMAP.md "
                f"Queue 1 item {item})")


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


def batch_generator(seed: int, epoch: int, batch: int,
                    device: torch.device) -> torch.Generator:
    """The generator of one batch's random draws (dropout masks) on
    ``device``, seeded from (seed, epoch, batch) through numpy's
    ``SeedSequence``."""
    state = np.random.SeedSequence([seed, epoch, batch]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> 1))


def _tensors(tree):
    """The tensors of a state tree (dicts of tensors, ints), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    return []


class TrainStep:
    """The train step :func:`make_train_step` returns; see there. Its
    parts, for callers that compose it into a larger graph (the resident
    and streaming feeds' batch body): :meth:`begin` (the optimizer's host
    scalars), :meth:`body` (forward, backward and update, all on the card),
    :meth:`end` (the host's step counts), :meth:`binding` (the addresses a
    captured graph of the step writes) and :attr:`pool`."""

    def __init__(self, model: Sequential, loss_fn: Callable,
                 optimizer: Optimizer, num_microbatches: int = 1,
                 guard: bool = False, jit: bool = True,
                 pool: Optional[GraphPool] = None):
        self.model, self.loss_fn, self.optimizer = model, loss_fn, optimizer
        self.n_mb = int(num_microbatches)
        self.guard = bool(guard)
        self.jit = bool(jit)
        self.pool = pool if jit else None
        # on the params' device, at the first call (a Trainer is built
        # before its params)
        self.device = self.scalars = self.generator = None
        self._sessions = SessionCache()

    def _place(self) -> None:
        if self.device is None:
            self.device = _model_device(self.model)
            self.scalars = self.optimizer.scalars(self.device)
            self.generator = torch.Generator(device=self.device)
            if self.jit and self.pool is None \
                    and self.device.type == "cuda":
                self.pool = GraphPool(self.device)
            if self.pool is not None and not self.pool.cuda:
                self.pool = None

    # -- the device work (capturable: nothing here reads the card) --
    def _forward_backward(self, x, y, generator):
        model = self.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        n_mb = self.n_mb
        if n_mb > 1 and x.shape[0] % n_mb != 0:
            warnings.warn(
                f"batch size {x.shape[0]} not divisible by num_microbatches="
                f"{n_mb}: training this batch unmicrobatched "
                f"(different BN statistics semantics)", stacklevel=4)

        def forward_loss(xi, yi):
            logits = upcast_logits(model(xi, generator=generator))
            loss = self.loss_fn(logits, yi)
            loss.backward()
            return loss.detach(), logits.detach()

        if n_mb == 1 or x.shape[0] % n_mb != 0:
            loss, logits = forward_loss(x, y)
        else:
            losses, outs = [], []
            for xi, yi in zip(x.chunk(n_mb), y.chunk(n_mb)):
                li, oi = forward_loss(xi, yi)  # .grad sums
                losses.append(li)
                outs.append(oi)
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(n_mb)
            loss = sum(losses) / n_mb
            logits = torch.cat(outs).reshape(x.shape[0], -1)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        return loss, logits, grads

    def _update(self, ts: TrainState, grads) -> None:
        self.optimizer.apply(grads, ts.opt_state,
                             dict(self.model.named_parameters()),
                             self.scalars)

    def body(self, ts: TrainState, x, y, generator=None):
        """Forward, backward and update, reading :attr:`scalars` (filled
        by :meth:`begin`); ``(loss, logits)`` on the card."""
        loss, logits, grads = self._forward_backward(x, y, generator)
        self._update(ts, grads)
        return loss, logits

    def _probe(self, ts: TrainState, x, y, generator):
        """The first of the guarded (or debug-mode) step's two parts:
        the buffers' copy (guard only), forward and backward, Σ‖g‖² and
        whether the loss and it are finite."""
        saved = ([b.detach().clone() for b in self.model.buffers()]
                 if self.guard else [])
        loss, logits, grads = self._forward_backward(x, y, generator)
        gnorm = global_norm_sq(grads.values())
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        return loss, logits, gnorm, ok, saved, grads

    # -- the host's part --
    def begin(self, ts: TrainState, lr) -> None:
        """Write the step's lr and the optimizer's scalars for the step
        after ``ts``'s (fills on the card, no wait)."""
        self._place()
        self.optimizer.fill_scalars(self.scalars, ts.opt_state, lr)

    def end(self, ts: TrainState) -> None:
        """Count a step that updated: the optimizer's ``t``, ``ts.step``."""
        self.optimizer.advance(ts.opt_state)
        ts.step += 1

    def binding(self, ts: TrainState) -> tuple:
        """The addresses of every tensor a step writes in place (params,
        buffers, optimizer state): a graph captured for other addresses
        would update tensors ``ts`` no longer holds."""
        return tuple(t.data_ptr() for t in (*self.model.parameters(),
                                            *self.model.buffers(),
                                            *_tensors(ts.opt_state)))

    def capture(self, name: str, fn: Callable, example, generators):
        """A session of ``fn`` in this step's pool, the params' gradients
        it writes kept on it (``grads``, put back on ``.grad`` after each
        replay)."""
        s = Session(name, fn, example, pool=self.pool, generators=generators)
        s.grads = [(p, p.grad) for p in self.model.parameters()]
        return s

    def _capture(self, ts, x, y, gen, split):
        gens = () if gen is None else (gen,)
        if split:
            first = self.capture("train_step.probe",
                                 lambda xs, ys: self._probe(ts, xs, ys, gen),
                                 (x, y), gens)
            grads = first.outputs[-1]
            second = self.capture("train_step.update",
                                  lambda: self._update(ts, grads), (), ())
            return first, second
        return (self.capture(
            "train_step", lambda xs, ys: self.body(ts, xs, ys, gen),
            (x, y), gens),)

    def _sessions_for(self, ts, x, y, gen, split):
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               gen is None, split)
        return self._sessions.lookup(
            key, self.binding(ts),
            lambda: self._capture(ts, x, y, gen, split), self.model)

    def __call__(self, ts: TrainState, x: torch.Tensor, y: torch.Tensor, lr,
                 generator: Optional[torch.Generator] = None):
        self.begin(ts, lr)
        self.model.train()
        gen = None
        if generator is not None:  # its state, drawn from by the step
            self.generator.set_state(generator.get_state())
            gen = self.generator
        split = self.guard or _debug.debug_nans()
        lock = (self.pool.lock if self.pool is not None
                else contextlib.nullcontext())
        with lock:
            sessions = (self._sessions_for(ts, x, y, gen, split)
                        if self.pool is not None else None)
            if not split:
                if sessions is None:
                    loss, logits = self.body(ts, x, y, gen)
                else:
                    loss, logits = sessions[0](x, y)
                bad = False
            else:
                if sessions is None:
                    loss, logits, gnorm, ok, saved, grads = self._probe(
                        ts, x, y, gen)
                else:
                    loss, logits, gnorm, ok, saved, _ = sessions[0].replay(
                        x, y)
                    loss, logits = loss.clone(), logits.clone()
                if _debug.debug_nans():
                    _debug.check_finite(ts.step + 1, loss, gnorm)
                bad = self.guard and not bool(ok)
                if bad:  # the statistics the forward moved, put back
                    with torch.no_grad():
                        for b, s in zip(self.model.buffers(), saved):
                            b.copy_(s)
                elif sessions is None:
                    self._update(ts, grads)
                else:
                    sessions[1].replay()
            if sessions is not None:
                for p, g in sessions[0].grads:
                    p.grad = g
        if generator is not None:
            generator.set_state(self.generator.get_state())
        if not bad:
            self.end(ts)
        return (loss, logits, bad) if self.guard else (loss, logits)


def make_train_step(model: Sequential, loss_fn: Callable,
                    optimizer: Optimizer, num_microbatches: int = 1,
                    guard: bool = False, jit: bool = True,
                    pool: Optional[GraphPool] = None) -> TrainStep:
    """Returns ``step(ts, x, y, lr, generator=None) -> (loss, logits)``,
    which updates ``ts`` in place. ``x`` and ``y`` are tensors on the
    model's device; ``generator`` (on that device) feeds the model's dropout
    layers, whose training forward raises without one, and advances as if
    the step had drawn from it.

    With ``num_microbatches > 1`` the batch is split on the leading axis,
    the gradients of the pieces are summed and divided by their number
    (the loss likewise). A batch that does not divide evenly is trained
    whole, with a warning, as in the JAX package. The gradients stay in
    each parameter's ``.grad`` until the next step.

    ``jit=True`` (the JAX signature's ``jit``): on CUDA the first call of
    each batch shape (and precision mode) runs eagerly, as a real step
    that is also its warm-up; the next captures ``zero grads -> forward -> backward ->
    update`` as a CUDA graph (:mod:`~dcnn_tpu_torch.core.graphs`, in
    ``pool``, a new one by default: a :class:`Trainer` gives its step and
    chunk graphs one) and every call after it replays, bit for
    bit the eager step. A capture that fails raises; nothing falls back to
    eager. A graph is bound to the addresses it writes (params, buffers,
    the optimizer state's tensors, :meth:`TrainStep.binding`): a call with
    others captures again. ``jit=False``, and any call on the CPU, runs
    eagerly.

    ``guard=True``: the step returns ``(loss, logits, bad)`` with ``bad =
    not (isfinite(loss) and isfinite(Σ‖g‖²))``, read on the host after the
    backward and before the optimizer runs. A bad step updates nothing:
    params, optimizer state and ``ts.step`` are untouched, and the
    batchnorm running statistics, which the training forward has already
    moved in place, are put back from a copy taken before it. Without the
    guard the step is exactly the unguarded one (no copy, no probe).

    While debug mode is on (:mod:`~dcnn_tpu_torch.core.debug`), a
    non-finite loss or gradient raises ``FloatingPointError`` naming the
    step, after the backward and before the guard or the optimizer.

    With the guard or debug mode the host reads the card between backward
    and update, so the step is two graphs split at that read. While
    autograd's anomaly mode is on (debug mode's ``checks=True``) or the
    model carries hooks (:func:`~dcnn_tpu_torch.core.debug.checked`'s),
    every call runs eagerly (:func:`~dcnn_tpu_torch.core.graphs.debug_eager`):
    a replay would run neither their host reads nor the hooks."""
    return TrainStep(model, loss_fn, optimizer, num_microbatches, guard, jit,
                     pool)


def make_multi_step(model: Sequential, loss_fn: Callable, optimizer: Optimizer,
                    num_microbatches: int = 1, jit: bool = True,
                    pool: Optional[GraphPool] = None):
    """Returns ``multi_step(ts, xs, ys, key, lr) -> (ts, mean_loss)``: one
    full train step per leading index of ``xs`` ([K, B, ...]) and ``ys``
    ([K, B, classes]), step ``i`` drawing from ``generator(fold_in(key,
    i))``, the same K steps as K calls of :func:`make_train_step`, whose
    graph (``jit=True``, on CUDA) it replays K times, each step's loss
    copied out. ``mean_loss`` stays on the device (a chunk is read once,
    as the JAX package reads its one-dispatch chunk); ``lr`` is a scalar or
    a [K] vector (per-batch schedules stay exact)."""
    step = make_train_step(model, loss_fn, optimizer, num_microbatches,
                           jit=jit, pool=pool)

    def multi_step(ts: TrainState, xs, ys, key: int, lr):
        k = xs.shape[0]
        lrs = lr_per_step(lr, k, xs.device)
        losses = torch.stack([
            step(ts, xs[i], ys[i], lrs[i],
                 generator(fold_in(key, i), xs.device))[0]
            for i in range(k)])
        return ts, losses.mean()

    return multi_step


class EvalStep:
    """The eval step :func:`make_eval_step` returns: on CUDA one graph a
    shape of ``(x, y)`` (a warm eager call, the capture, then replays), in
    ``pool`` (a new one by default); eager on the CPU, and while
    :func:`~dcnn_tpu_torch.core.graphs.debug_eager` holds."""

    def __init__(self, model: Sequential, loss_fn: Callable,
                 pool: Optional[GraphPool] = None):
        self.model, self.loss_fn = model, loss_fn
        self.pool = pool  # else on the params' device, at the first call
        self.sessions: dict = {}
        self._bind = None

    @torch.no_grad()
    def run(self, x, y):
        logits = upcast_logits(self.model(x))
        return self.loss_fn(logits, y), correct_count(logits, y)

    def __call__(self, x, y):
        self.model.eval()
        if self.pool is None and x.device.type == "cuda":
            self.pool = GraphPool(x.device)
        if self.pool is None or not self.pool.cuda \
                or debug_eager(self.model):
            return self.run(x, y)
        # a graph reads the params and buffers at their capture addresses
        bind = tuple(t.data_ptr() for t in (*self.model.parameters(),
                                             *self.model.buffers()))
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               get_precision_mode())
        with self.pool.lock:
            if bind != self._bind:
                self.sessions.clear()
                self._bind = bind
            s = self.sessions.get(key)
            if s is None:
                self.run(x, y)  # the warm-up
                s = self.sessions[key] = Session("eval_step", self.run,
                                                 (x, y), pool=self.pool)
            return s(x, y)


def make_eval_step(model: Sequential, loss_fn: Callable,
                   pool: Optional[GraphPool] = None) -> EvalStep:
    """``eval_step(x, y) -> (loss, correct)`` without gradients; on CUDA
    a graph per shape (:class:`EvalStep`) in ``pool``."""
    return EvalStep(model, loss_fn, pool)


def _batch(x, y, device: torch.device, scale: float):
    """One host batch onto ``device``, pixels decoded after the copy."""
    return (decode_batch(torch.as_tensor(x).to(device), scale),
            torch.as_tensor(y).to(device))


def evaluate_classification(model: Sequential, loss_fn: Callable, loader,
                            eval_step=None) -> Tuple[float, float]:
    """(mean loss, accuracy) over a host loader, on the model's device; over
    a ``DeviceDataset``, the whole-split resident eval (full batches and an
    exact remainder)."""
    if isinstance(loader, DeviceDataset):
        ev = resident_eval(model, loss_fn, loader)
        loss_sum, correct, n = ev(loader.x, loader.y, scale=loader.scale)
        return float(loss_sum) / n, int(correct) / n
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


def _copy_into(dst, src):
    """``src``'s values in ``dst``'s tensors, copied in place where the two
    match in structure, shape, type and device, so that the train step's
    graphs, which write ``dst``'s addresses, go on training the restored
    state; else ``src`` itself (the graphs then capture again)."""
    if isinstance(dst, dict) and isinstance(src, dict) \
            and dst.keys() == src.keys():
        for k in src:
            dst[k] = _copy_into(dst[k], src[k])
        return dst
    if (isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor)
            and dst.shape == src.shape and dst.dtype == src.dtype
            and dst.device == src.device):
        with torch.no_grad():
            dst.copy_(src)
        return dst
    return src


class Trainer:
    """The epoch loop: per-epoch train and validate, lr decay or
    scheduler, progress prints, the best-val snapshot, periodic
    checkpoints and resume, the non-finite guard and the stall watchdog.
    The params live in ``ts.model``; the model must already be on
    ``config.device_type``."""

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
        cfg = self.config
        if cfg.debug:
            # process-global, as the JAX trainer's jax_debug_nans
            _debug.enable_debug_mode()
        self.profiler = (LayerProfiler(cfg.profiler)
                         if cfg.profiler != ProfilerType.NONE else None)
        if cfg.flight_dir:
            # the process-global recorder, so the step guard and the
            # watchdog dump their bundles there (DCNN_FLIGHT_DIR's meaning)
            from ..obs.flight import configure_flight
            configure_flight(cfg.flight_dir)
        # the non-finite step guard (resilience/guards.py): "off" keeps the
        # unguarded step, with no copy and no probe
        self.guard = None
        if cfg.nonfinite_policy != "off":
            if cfg.steps_per_dispatch > 1:
                raise ValueError(
                    "nonfinite_policy guards the per-batch step loop; with "
                    "steps_per_dispatch > 1 losses never reach the host "
                    "per-step — use steps_per_dispatch=1 or policy 'off'")
            if cfg.nonfinite_policy == "rollback" and not cfg.checkpoint_dir:
                raise ValueError(
                    "nonfinite_policy='rollback' needs checkpoint_dir set "
                    "(and checkpoint_every > 0) so there is a checkpoint "
                    "to roll back to — a rollback that can only abort is "
                    "a delayed crash, not a recovery policy")
            self.guard = StepGuard(cfg.nonfinite_policy,
                                   rollback_after=cfg.rollback_after)
        # periodic atomic checkpoints and resume (resilience/checkpoint.py)
        self.checkpoints = (CheckpointManager(cfg.checkpoint_dir,
                                              keep=cfg.checkpoint_keep)
                            if cfg.checkpoint_dir else None)
        self.watchdog = None  # per fit(), when stall_timeout_s > 0
        # one memory pool for the step's and the chunk's graphs, and one for
        # the eval's: the gradients a step leaves on .grad live in its pool,
        # where a graph captured before it may hold scratch, and an eval
        # replayed between two steps would overwrite them
        self.graphs = GraphPool(self.device)
        self.eval_graphs = GraphPool(self.device)
        self.train_step = make_train_step(model, self.loss_fn, optimizer,
                                          self.config.num_microbatches,
                                          guard=self.guard is not None,
                                          pool=self.graphs)
        self.multi_step = (make_multi_step(model, self.loss_fn, optimizer,
                                           cfg.num_microbatches,
                                           pool=self.graphs)
                           if cfg.steps_per_dispatch > 1 else None)
        self.eval_step = make_eval_step(model, self.loss_fn,
                                        self.eval_graphs)
        self.lr = self.config.learning_rate
        self.history: list = []
        self._wire_aot()

    def _wire_aot(self) -> None:
        """Restore the kernel libraries from the AOT cache
        (:mod:`~dcnn_tpu_torch.aot`; ``TrainingConfig.aot_cache_dir``,
        else ``AOT_CACHE``) and commit fresh builds to it, so a warm start
        runs no ``nvcc``. That is all the cache holds for training: the
        port has no compiled step executable (the JAX package's cached
        one), and the step's CUDA graphs cannot be serialized, so they
        are captured again in every process. Off on the CPU, where no
        kernel is built."""
        if self.device.type != "cuda":
            return
        from ..aot.warm import resolve

        cache = resolve(self.config.aot_cache_dir or None)
        if cache is not None:
            _kernels.build(cache=cache)

    def _restore(self, ts: TrainState):
        """Load the newest valid checkpoint into the model and ``ts`` (on
        the config's device); returns it, or None where there is none."""
        restored = self.checkpoints.restore_latest(device=self.device)
        if restored is not None:
            self.model.load_state_dict(restored.model.state_dict())
            ts.opt_state = _copy_into(ts.opt_state, restored.opt_state)
            ts.step = int(restored.metadata.get("global_step", 0))
        return restored

    def _rollback(self, ts: TrainState) -> None:
        """The 'rollback' guard policy: restore the training state from the
        newest valid checkpoint (the run's state may already be poisoned;
        one skipped step was not enough)."""
        self.checkpoints.wait()  # queued async saves land first
        restored = self._restore(ts)
        if restored is None:
            raise RuntimeError(
                f"rollback requested but no valid checkpoint under "
                f"{self.checkpoints.directory}")
        print(f"  guard rollback: restored checkpoint step {restored.step} "
              f"from {restored.path}", flush=True)

    def _check_device(self, ts: TrainState) -> None:
        dev = _model_device(ts.model)
        if dev.type != self.device.type:
            raise ValueError(f"model is on {dev}, but the config asks for "
                             f"{self.device}; build it there")

    def train_epoch(self, ts: TrainState, loader, epoch: int = 0,
                    seed: Optional[int] = None
                    ) -> Tuple[TrainState, float, float]:
        """One pass over a host loader, batch ``bi`` drawing from
        :func:`batch_generator` (``seed`` (default ``config.seed``), epoch,
        bi). A ``DeviceDataset`` runs the resident epoch, and
        ``steps_per_dispatch > 1`` the chunked one (train accuracy NaN on
        both). Returns (ts, mean loss, accuracy)."""
        seed = self.config.seed if seed is None else seed
        self._check_device(ts)
        if isinstance(loader, DeviceDataset):
            if self.guard is not None:
                raise ValueError(
                    "nonfinite_policy guards the per-batch step loop; "
                    "resident datasets run whole epochs in one dispatch "
                    "(losses never reach the host per-step) — use a host "
                    "loader or policy 'off'")
            return self._train_epoch_resident(ts, loader, epoch, seed)
        if self.multi_step is not None:
            return self._train_epoch_chunked(ts, loader, epoch, seed)
        tracer = get_tracer()
        total_loss, total_correct, total_n = 0.0, 0, 0
        t0 = time.perf_counter()
        scale = wire_scale(loader)
        for bi, (x, y) in enumerate(loader):
            xb, yb = _batch(x, y, self.device, scale)
            self._global_step += 1
            if self.watchdog is not None:
                self.watchdog.beat()
            if _faults.active() is not None:
                # an armed "train.nonfinite_input" poisons this batch (the
                # guard's path end to end); armed as an InjectedCrash it
                # kills the run here (the mid-epoch crash resume restarts
                # from)
                try:
                    _faults.trip("train.nonfinite_input",
                                 step=self._global_step)
                except _faults.InjectedCrash:
                    raise
                except _faults.InjectedFault:
                    xb = torch.full_like(xb, float("nan"))
            gen = batch_generator(seed, epoch, bi, self.device)
            # the loss and accuracy reads inside the span wait for the
            # step, so step spans tile the epoch's wall
            with tracer.span("train.step", track="train", epoch=epoch,
                             batch=bi):
                if self.guard is not None:
                    loss, logits, bad = self.train_step(ts, xb, yb, self.lr,
                                                        gen)
                    action = self.guard.observe(self._global_step, bad,
                                                float(loss))
                    if action == "rollback":
                        self._rollback(ts)
                        continue
                    if action == "skipped":
                        continue  # a NaN loss must not poison the mean
                else:
                    loss, logits = self.train_step(ts, xb, yb, self.lr, gen)
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

    def _batch_lrs(self, k: int, metric):
        """The per-batch schedule's lrs of the next ``k`` steps as a [k]
        vector on the device, the scheduler stepped ``k`` times with one
        metric evaluation (``metric`` at the first step, None after); else
        the current scalar lr."""
        if self.scheduler is None or self.config.scheduler_step != "batch":
            return self.lr
        lrs = []
        for si in range(k):
            lrs.append(self.lr)
            self.lr = self.scheduler.step(metric if si == 0 else None)
        return to_device(np.asarray(lrs, np.float32), self.device)

    def _train_epoch_resident(self, ts: TrainState, ds: DeviceDataset,
                              epoch: int, seed: int
                              ) -> Tuple[TrainState, float, float]:
        """The resident epoch (``data/device_dataset.py``): shuffle, gather,
        decode, augment and every step on the device, the losses read once.
        Train accuracy is NaN (validation measures it). A per-batch
        schedule ships as a [steps] lr vector; a metric-driven one sees the
        previous epoch's mean train loss, once per epoch."""
        if ds.device.type != self.device.type:
            raise ValueError(f"the dataset is staged on {ds.device}, the "
                             f"config asks for {self.device}")
        epoch_fn = resident_epoch(self.model, self.loss_fn, self.optimizer,
                                  ds, self.config.num_microbatches)
        metric = self.history[-1]["train_loss"] if self.history else None
        lr_arg = self._batch_lrs(ds.steps_per_epoch, metric)
        if self.watchdog is not None:
            self.watchdog.beat()
        key = fold_in(fold_in(seed, epoch), epoch)
        # the epoch is issued without a wait; the loss read inside the
        # span waits for it, so the span is the epoch's wall
        with get_tracer().span("train.resident_epoch", track="train",
                               epoch=epoch):
            ts, mean_loss = epoch_fn(ts, ds.x, ds.y, key, lr_arg)
            mean_loss = float(mean_loss)
        self._global_step += ds.steps_per_epoch
        return ts, mean_loss, float("nan")

    def _train_epoch_chunked(self, ts: TrainState, loader, epoch: int,
                             seed: int) -> Tuple[TrainState, float, float]:
        """K train steps per chunk over [K, B, ...] chunks, each chunk's
        mean loss read once. Train accuracy is NaN. A per-batch schedule's
        K lrs ship as a vector (a metric-driven scheduler sees the running
        loss before the chunk, once per chunk)."""
        sample_ndim = len(self.model.input_shape)
        total_loss, total_n = 0.0, 0
        t0 = time.perf_counter()
        scale = wire_scale(loader)
        epoch_key = fold_in(seed, epoch)
        for ci, (xs, ys) in enumerate(loader):
            if self.watchdog is not None:
                self.watchdog.beat()
            xs, ys = _batch(xs, ys, self.device, scale)
            if xs.ndim != sample_ndim + 2:
                raise ValueError(
                    f"steps_per_dispatch={self.config.steps_per_dispatch} "
                    f"needs [K, B, ...] chunks (got shape {tuple(xs.shape)});"
                    f" wrap the loader in PrefetchLoader(stage_batches=K)")
            metric = (total_loss / total_n) if total_n > 0 else None
            lr_arg = self._batch_lrs(xs.shape[0], metric)
            with get_tracer().span("train.chunk", track="train",
                                   epoch=epoch, chunk=ci,
                                   steps=int(xs.shape[0])):
                ts, mean_loss = self.multi_step(ts, xs, ys,
                                                fold_in(epoch_key, ci),
                                                lr_arg)
                n = xs.shape[0] * xs.shape[1]
                total_loss += float(mean_loss) * n
            total_n += n
            self._global_step += xs.shape[0]
            if self.config.progress_interval and (ci + 1) % max(
                    self.config.progress_interval // max(xs.shape[0], 1),
                    1) == 0:
                dt = time.perf_counter() - t0
                print(f"  epoch {epoch} chunk {ci + 1}: loss "
                      f"{total_loss / total_n:.4f} "
                      f"({total_n / dt:.1f} samples/s)", flush=True)
        return ts, total_loss / max(total_n, 1), float("nan")

    def fit(self, ts: TrainState, train_loader, val_loader=None,
            epochs: Optional[int] = None, seed: Optional[int] = None
            ) -> TrainState:
        """Train for ``epochs`` (default ``config.epochs``); the random draws
        of every batch follow from ``seed`` (default ``config.seed``).

        ``resume="auto"`` with ``checkpoint_dir``: restore the newest valid
        checkpoint and continue at its epoch + 1 with its lr, history,
        global step and best validation accuracy (a scheduler's own state
        is not in the checkpoint, as in the JAX package). Saves queued by
        ``checkpoint_async`` have landed when this returns."""
        cfg = self.config
        epochs = epochs or cfg.epochs
        best_val, start_epoch = -1.0, 1
        if self.checkpoints is not None and cfg.resume == "auto":
            restored = self._restore(ts)
            if restored is not None:
                md = restored.metadata
                start_epoch = restored.step + 1
                self.lr = md.get("lr", self.lr)
                self.history = md.get("history", self.history) or []
                self._global_step = int(md.get("global_step", 0))
                best_val = md.get("best_val", -1.0)
                print(f"resumed from checkpoint step {restored.step} "
                      f"({restored.path}); continuing at epoch {start_epoch}",
                      flush=True)
        if cfg.stall_timeout_s > 0:
            self.watchdog = StallWatchdog(cfg.stall_timeout_s).start()
        try:
            return self._fit_loop(ts, train_loader, val_loader, epochs,
                                  start_epoch, seed, best_val)
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
                self.watchdog = None
            if self.checkpoints is not None:
                # an abandoned queue would lose the newest checkpoint; a
                # saver-thread failure surfaces here
                self.checkpoints.wait()

    @staticmethod
    def _epoch_samples(loader) -> Optional[int]:
        """Samples an epoch consumes, for the throughput gauge; None (the
        gauge skipped) when the loader tells nothing."""
        spe = getattr(loader, "steps_per_epoch", None)
        bs = getattr(loader, "batch_size", None)
        if spe and bs:
            return int(spe) * int(bs)
        n = getattr(loader, "num_samples", None)
        if n:
            return int(n)
        x = getattr(loader, "x", None)
        if x is not None and hasattr(x, "shape"):
            return int(x.shape[0])
        return None

    def _profile_epoch(self, ts: TrainState, loader, epoch: int,
                       seed: Optional[int]) -> None:
        """One profiled layer-by-layer forward and backward of the first
        batch, outside the step, and the profiler's table printed. A
        resident split profiles its first batch decoded (augmentation
        excluded, as it runs inside the step there); a chunked loader its
        first chunk's first batch. The profiler puts the model's buffers
        back and touches no gradient, so training is unchanged."""
        self.profiler.maybe_clear_per_batch()
        if isinstance(loader, DeviceDataset):
            b = loader.batch_size
            x = decode_batch(loader.x[:b], loader.scale)
            y = torch.nn.functional.one_hot(
                loader.y[:b].long(), loader.num_classes).float()
        else:
            x, y = next(iter(loader))
            if self.multi_step is not None:
                x, y = x[0], y[0]
            x, y = _batch(x, y, self.device, wire_scale(loader))
        gen = generator(fold_in(self.config.seed if seed is None else seed,
                                epoch), self.device)
        logits = self.profiler.profile_forward(self.model, x, training=True,
                                               generator=gen)
        out = upcast_logits(logits).detach().requires_grad_(True)
        with torch.enable_grad():
            grad, = torch.autograd.grad(self.loss_fn(out, y), out)
        self.profiler.profile_backward(self.model, x, grad, generator=gen)
        print(self.profiler.summary(), flush=True)

    def _fit_loop(self, ts: TrainState, train_loader, val_loader,
                  epochs: int, start_epoch: int, seed: Optional[int],
                  best_val: float) -> TrainState:
        cfg = self.config
        tracer, reg = get_tracer(), get_registry()
        for epoch in range(start_epoch, epochs + 1):
            if self.watchdog is not None:
                self.watchdog.beat()
            if hasattr(train_loader, "shuffle"):
                train_loader.shuffle(epoch)
            t0 = time.perf_counter()
            with tracer.span("train.epoch", track="train", epoch=epoch):
                ts, train_loss, train_acc = self.train_epoch(
                    ts, train_loader, epoch, seed)
            dt = time.perf_counter() - t0
            # per-epoch rollups, live whether or not tracing is on
            n_epoch = self._epoch_samples(train_loader)
            reg.counter("train_epochs_total", "completed epochs").inc()
            if n_epoch:
                reg.counter("train_samples_total",
                            "samples trained on").inc(n_epoch)
                reg.gauge("train_throughput_ips",
                          "last epoch samples/sec").set(n_epoch / dt)
            reg.histogram("train_epoch_seconds",
                          "wall per epoch").observe(dt)
            sample_hbm(reg)  # a latched no-op without a card
            reg.gauge("train_lr", "current learning rate").set(
                float(self.lr))
            reg.gauge("train_loss", "last epoch mean train loss").set(
                float(train_loss))
            if self.profiler is not None:
                self._profile_epoch(ts, train_loader, epoch, seed)
            val_loss = val_acc = None
            if val_loader is not None:
                with tracer.span("train.eval", track="train", epoch=epoch):
                    val_loss, val_acc = evaluate_classification(
                        self.model, self.loss_fn, val_loader,
                        eval_step=self.eval_step)
                reg.gauge("train_val_acc", "last validation accuracy").set(
                    float(val_acc))
                # the best-val snapshot (the JAX trainer's)
                if cfg.snapshot_dir and val_acc > best_val:
                    best_val = val_acc
                    save_checkpoint(
                        os.path.join(cfg.snapshot_dir, self.model.name),
                        self.model, ts.opt_state, self.optimizer,
                        {"epoch": epoch, "val_acc": val_acc,
                         "val_loss": val_loss})
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
            # the periodic checkpoint, after the lr schedule so that the
            # saved lr is the one epoch + 1 trains with
            if (self.checkpoints is not None and cfg.checkpoint_every
                    and epoch % cfg.checkpoint_every == 0):
                md = {"epoch": epoch, "lr": float(self.lr),
                      "history": self.history, "best_val": best_val,
                      "global_step": self._global_step}
                # an earlier async save that failed fails the run now
                self.checkpoints.check()
                save = (self.checkpoints.save_async if cfg.checkpoint_async
                        else self.checkpoints.save)
                save(epoch, self.model, ts.opt_state, self.optimizer, md)
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
        for bi, (x, y) in enumerate(train_loader):
            loss_v, _ = step(ts, torch.as_tensor(x).to(dev),
                             torch.as_tensor(y).to(dev), lr,
                             batch_generator(config.seed, epoch, bi, dev))
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
