"""Pipeline parallelism in one process: stages, schedules and the
in-process coordinator (counterpart of ``dcnn_tpu/parallel/pipeline.py``).

A ``Sequential`` is split into layer-range partitions; each
:class:`PipelineStage` holds its partition's model, weights and optimizer
state on one device, and microbatch activations and gradients go from
stage to stage. The schedules are **sync** (GPipe: all forwards, then all
backwards, then one update) and **semi-async** (each microbatch's backward
starts as soon as its forward has left the last stage), and both give the
numbers of the unsplit step with the same microbatches
(``make_train_step(num_microbatches=M)``).

How the port maps the JAX stage:

- A stage's forward keeps the microbatch's autograd graph (its input leaf
  and output) until that microbatch's backward, which runs
  ``torch.autograd.backward`` from the upstream gradient. The JAX stage
  keeps ``(x, state, rng)`` and recomputes the forward; here a recompute
  would move the batchnorm statistics, which the port updates in place,
  a second time. The running statistics move once a microbatch, in
  microbatch order, as the JAX package's do.
- Gradients accumulate in each parameter's ``.grad`` over the batch's
  microbatches and the update scales them by ``1 / count``.
- The initial gradient is the autograd of the loss value with respect to
  the last stage's output, never the fused ``*_grad`` helpers: the last
  stage's backward runs through its final layer itself, so a fused
  softmax gradient would apply the softmax's Jacobian twice.
- On CUDA every stage owns a stream (``stage.stream``; ``None`` runs the
  stage on the caller's current stream): a stage's work is queued on its
  stream after an event of the stage that produced its input
  (``stage.done``), the single-card counterpart of the JAX package's
  per-device asynchronous dispatch, so microbatch i + 1's forward on one
  stage overlaps microbatch i's backward on another. Every tensor used on
  a stream other than the one that allocated it is kept alive for that
  stream with ``record_stream``. Losses stay device scalars until the
  schedule is queued; the batch reads them once, at its end.
- ``snapshot_state`` clones the buffers (the JAX package holds immutable
  arrays; the port's are written in place), so ``abort_batch`` puts back
  the statistics a failed batch's completed forwards moved.

Dropout: microbatch i of a batch drawn with key ``rng`` (an int key,
:mod:`dcnn_tpu_torch.core.keys`) runs stage s's forward on a generator
seeded ``fold_in(fold_in(rng, i), s)`` (:func:`stage_key`), the key the
compiled engine (``compiled_pipeline.py``) uses too. The draws are
PyTorch's, not ``jax.random``'s.

Spans, as in the JAX package: ``pipe.batch`` (track ``pipeline``; attrs
``schedule``, ``microbatches``), ``pipe.fwd`` and ``pipe.bwd`` (track
``stage<i>``; attrs ``stage``, ``mb``, ``fenced``).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.fence import hard_fence
from ..core.keys import fold_in
from ..nn.sequential import Partition, Sequential, merge_named
from ..obs.tracer import get_tracer
from ..ops.losses import get_loss
from ..ops.metrics import correct_count
from ..optim.optimizers import Optimizer, OptimizerFactory
from .partitioner import NaivePartitioner, Partitioner


def stage_key(rng: int, mb: int, stage: int) -> int:
    """The key of stage ``stage``'s draws for microbatch ``mb`` of a batch
    drawn with ``rng``."""
    return fold_in(fold_in(rng, mb), stage)


class PipelineError(RuntimeError):
    """A stage failed mid-schedule. Names the stage, the phase and the
    microbatch; the coordinator aborts the batch (caches, partial
    gradients, batchnorm statistics) before it re-raises."""

    def __init__(self, stage_id: int, phase: str, mb_id: int,
                 cause: BaseException):
        super().__init__(f"stage {stage_id} failed in {phase} (microbatch "
                         f"{mb_id}): {cause!r}")
        self.stage_id = stage_id
        self.phase = phase
        self.mb_id = mb_id


class StageLoadTracker:
    """Per-stage forward and backward wall-clock telemetry."""

    def __init__(self) -> None:
        self.forward_ms = 0.0
        self.backward_ms = 0.0
        self.forward_count = 0
        self.backward_count = 0

    def report(self) -> Dict[str, float]:
        return {
            "avg_forward_ms": self.forward_ms / max(self.forward_count, 1),
            "avg_backward_ms": self.backward_ms / max(self.backward_count, 1),
            "forward_count": self.forward_count,
            "backward_count": self.backward_count,
        }

    def clear(self) -> None:
        self.__init__()


_UNSET = object()


def _to_device(tree, device: torch.device):
    """A copy of an optimizer state (dicts of tensors, ints) on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


class PipelineStage:
    """One stage: a partition's model, weights, optimizer state and
    stream on one device (CUDA unless ``device="cpu"``).

    ``track_load``: ``False`` (no timing, no fences), ``"sample"`` (fence
    and time one call in :attr:`SAMPLE_EVERY`, the second of each window
    so the first call's builds stay out) or ``True`` (every call). A timed
    call first waits for the stage's earlier work, so it times its own.
    """

    SAMPLE_EVERY = 8

    def __init__(self, stage_id: int, model: Sequential, optimizer: Optimizer,
                 device: DeviceLike = None,
                 track_load: "bool | str" = False):
        if track_load not in (False, True, "sample"):
            raise ValueError("track_load must be False, True, or 'sample'")
        self.stage_id = stage_id
        self.model = model
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.track_load = track_load
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.done: Optional[torch.cuda.Event] = None  # after the last work
        self._generator = torch.Generator(device=self.device)
        self._fwd_calls = 0
        self._bwd_calls = 0
        self._last_out: Any = None
        self.opt_state: Any = None
        # per-microbatch autograd graphs: mb_id -> (input leaf, output)
        self._cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._grad_count = 0
        self.load = StageLoadTracker()
        # the latest microbatch (x, key, training): per-layer profiling
        # replays it (one activation kept alive)
        self._probe: Optional[Tuple[torch.Tensor, int, bool]] = None
        self._profiler = None

    # -- deployment --
    @classmethod
    def from_config(cls, stage_id: int, model_cfg: Dict, optimizer_cfg: Dict,
                    device: DeviceLike = None,
                    track_load: "bool | str" = False) -> "PipelineStage":
        """A stage built from its model's and optimizer's JSON configs,
        as a worker process builds one."""
        return cls(stage_id, Sequential.from_config(model_cfg),
                   OptimizerFactory.create_from_config(optimizer_cfg), device,
                   track_load=track_load)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The layer state: batchnorm running statistics."""
        return dict(self.model.named_buffers())

    def set_weights(self, params: Mapping[str, Any], state: Mapping[str, Any],
                    opt_state=None) -> None:
        """Install the stage's weights: ``params`` and ``state`` under the
        stage model's names (``Sequential.split_params``), every name and
        shape checked. ``opt_state=None`` starts a fresh optimizer state;
        a given one (a gathered or restored state) is installed as it is,
        so a repartition keeps momentum and Adam's moments."""
        self.model.init(generator=torch.Generator().manual_seed(0),
                        device=self.device)
        self.model.load_state_dict(
            {k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
             for k, v in {**params, **state}.items()}, strict=True)
        self.opt_state = (self.optimizer.init(self.params) if opt_state is None
                          else _to_device(opt_state, self.device))
        self.abort()

    # -- streams --
    @contextlib.contextmanager
    def running(self):
        """Queue work on this stage's stream (the current stream when it
        has none)."""
        if self.stream is None:
            yield
        else:
            with torch.cuda.stream(self.stream):
                yield

    def _record_done(self) -> None:
        self.done = None
        if self.stream is not None:
            self.done = torch.cuda.Event()
            self.done.record(self.stream)

    def _receive(self, t: torch.Tensor, ready) -> torch.Tensor:
        """``t`` on this stage's device and stream: the stream waits for
        ``ready`` (the producing stage's event; ``None``: the caller's
        current stream), and ``t`` is kept alive for it."""
        if self.stream is not None:
            if ready is None:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
            else:
                self.stream.wait_event(ready)
        with self.running():
            t = torch.as_tensor(t).to(self.device, non_blocking=True)
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(self.device))
        return t

    def _sample_now(self, calls: int) -> bool:
        return (self.track_load is True
                or (self.track_load == "sample"
                    and calls % self.SAMPLE_EVERY == 2 % self.SAMPLE_EVERY))

    # -- the device work (tests replace these to inject failures) --
    def _fwd(self, mb_id: int, x: torch.Tensor, key: int,
             training: bool) -> torch.Tensor:
        self.model.train(training)
        gen = self._generator.manual_seed(fold_in(key, self.stage_id))
        if not training:
            with torch.no_grad():
                return self.model(x, generator=gen)
        xin = x.detach().requires_grad_(x.is_floating_point())
        with torch.enable_grad():
            y = self.model(xin, generator=gen)
        self._cache[mb_id] = (xin, y)
        return y.detach()

    def _bwd(self, xin: torch.Tensor, y: torch.Tensor,
             g: torch.Tensor) -> Optional[torch.Tensor]:
        torch.autograd.backward(y, g)
        return xin.grad

    # -- forward and backward of one microbatch --
    def forward(self, mb_id: int, x, rng: Optional[int] = None,
                training: bool = True, ready=None) -> torch.Tensor:
        """Microbatch ``mb_id``'s forward through this stage; in training
        its graph is kept for :meth:`backward`. ``rng``: the microbatch's
        key (0 when None). ``ready``: the event after which ``x`` is
        valid (``None``: ``x`` comes from the caller's current stream)."""
        try:
            x = self._receive(x, ready)
            key = 0 if rng is None else int(rng)
            self._fwd_calls += 1
            sample = self._sample_now(self._fwd_calls)
            with self.running():
                if sample:  # this stage's earlier work, out of the timing
                    hard_fence((self._last_out, x))
                t0 = time.perf_counter()
                with get_tracer().span("pipe.fwd",
                                       track=f"stage{self.stage_id}",
                                       stage=self.stage_id, mb=mb_id,
                                       fenced=bool(sample)):
                    y = self._fwd(mb_id, x, key, training)
                    self._probe = (x, key, training)
                    self._last_out = y
                    if sample:
                        hard_fence(y)
                        self.load.forward_ms += (
                            (time.perf_counter() - t0) * 1e3)
                        self.load.forward_count += 1
                self._record_done()
            return y
        except PipelineError:
            raise
        except Exception as e:
            raise PipelineError(self.stage_id, "forward", mb_id, e) from e

    def backward(self, mb_id: int, grad, ready=None) -> Optional[torch.Tensor]:
        """Microbatch ``mb_id``'s backward from ``grad`` (the loss's
        gradient with respect to this stage's output): accumulates the
        parameters' gradients and returns the input's."""
        try:
            if mb_id not in self._cache:
                raise KeyError(f"stage {self.stage_id}: no forward cached for "
                               f"microbatch {mb_id}")
            grad = self._receive(grad, ready)
            xin, y = self._cache.pop(mb_id)
            self._bwd_calls += 1
            sample = self._sample_now(self._bwd_calls)
            with self.running():
                if sample:
                    hard_fence((self._last_out, grad))
                t0 = time.perf_counter()
                with get_tracer().span("pipe.bwd",
                                       track=f"stage{self.stage_id}",
                                       stage=self.stage_id, mb=mb_id,
                                       fenced=bool(sample)):
                    xgrad = self._bwd(xin, y, grad)
                    self._grad_count += 1
                    self._last_out = xgrad
                    if sample:
                        hard_fence(xgrad)
                        self.load.backward_ms += (
                            (time.perf_counter() - t0) * 1e3)
                        self.load.backward_count += 1
                self._record_done()
            return xgrad
        except PipelineError:
            raise
        except Exception as e:
            raise PipelineError(self.stage_id, "backward", mb_id, e) from e

    # -- batch state --
    def snapshot_state(self) -> Dict[str, torch.Tensor]:
        """A copy of the layer state (batchnorm statistics), taken at batch
        start so that an aborted batch can put it back."""
        with self.running():
            return {n: b.detach().clone()
                    for n, b in self.model.named_buffers()}

    def batch_open(self) -> bool:
        """Whether a batch is in flight on this stage (cached microbatch
        graphs or accumulated gradients)."""
        return bool(self._cache) or self._grad_count > 0

    def abort(self, state_snapshot: Any = _UNSET) -> None:
        """Back to a consistent idle state after a failed batch: caches
        and partial gradients dropped and, given the batch-start
        :meth:`snapshot_state`, the layer state put back."""
        self.clear_cache()
        self.reset_gradients()
        self._last_out = None
        if state_snapshot is not _UNSET:
            with self.running(), torch.no_grad():
                for n, b in self.model.named_buffers():
                    b.copy_(state_snapshot[n])

    def apply_updates(self, lr) -> None:
        """One optimizer step on the gradients accumulated since the last,
        scaled by ``1 / count`` (a parameter no microbatch reached steps on
        a zero gradient)."""
        if self._grad_count == 0:
            return
        scale = 1.0 / self._grad_count
        params = self.params
        if not params:  # a stage of stateless layers counts the step only
            self.optimizer.advance(self.opt_state)
        with self.running():
            if params:
                grads = {n: (p.grad * scale if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in params.items()}
                self.optimizer.update(grads, self.opt_state, params, lr)
            self._record_done()
        self.reset_gradients()

    # -- per-layer profiling --
    def collect_profile(self) -> Dict[str, Any]:
        """Per-layer forward and backward µs of this stage's partition,
        from a replay of the latest microbatch through
        :class:`~dcnn_tpu_torch.train.profiling.LayerProfiler` (buffers
        put back, so training moves not). Repeated calls accumulate;
        :meth:`clear_profile` resets. ``{"stage_id", "layers": [{"name",
        "fwd_us", "bwd_us", "calls"}, ...]}``, with no layers before the
        first microbatch."""
        if self._probe is None:
            return {"stage_id": self.stage_id, "layers": []}
        from ..train.profiling import LayerProfiler

        if self._profiler is None:
            self._profiler = LayerProfiler()
        x, key, training = self._probe
        prof = self._profiler
        with self.running():
            gen = self._generator.manual_seed(fold_in(key, self.stage_id))
            out = prof.profile_forward(self.model, x, training=training,
                                       generator=gen)
            gen.manual_seed(fold_in(key, self.stage_id))
            prof.profile_backward(self.model, x, torch.ones_like(out),
                                  training=training, generator=gen)
        layers = [{"name": l.name,
                   "fwd_us": round(prof.forward_us.get(l.name, 0.0), 1),
                   "bwd_us": round(prof.backward_us.get(l.name, 0.0), 1),
                   "calls": prof.counts.get(l.name, 0)}
                  for l in self.model.layers]
        return {"stage_id": self.stage_id, "layers": layers}

    def clear_profile(self) -> None:
        if self._profiler is not None:
            self._profiler.clear()

    def clear_cache(self) -> None:
        self._cache.clear()

    def reset_gradients(self) -> None:
        """Drop accumulated gradients (a failed batch must not leak partial
        gradients into the next update)."""
        for p in self.model.parameters():
            p.grad = None
        self._grad_count = 0


def split_microbatches(x, num_microbatches: int) -> List:
    """Batch -> list of microbatches along the leading axis; the remainder
    goes to the last microbatch."""
    n = x.shape[0]
    if num_microbatches > n:
        raise ValueError(f"more microbatches ({num_microbatches}) than "
                         f"samples ({n})")
    size = n // num_microbatches
    return [x[i * size:(i + 1) * size if i < num_microbatches - 1 else n]
            for i in range(num_microbatches)]


class InProcessPipelineCoordinator:
    """Owns the full model and the stage chain.

    :meth:`deploy_stages` splits the model with the partitioner and builds
    each stage from its JSON config (``PipelineStage.from_config``, the
    contract a worker process uses), then installs the full model's
    weights, split. ``devices``: one torch device a stage (all on the card
    by default); ``loss``: a ``LOSSES`` name.
    """

    def __init__(self, model: Sequential, optimizer: Optimizer, loss: str,
                 num_stages: int, partitioner: Optional[Partitioner] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 num_microbatches: int = 4,
                 track_load: "bool | str" = False):
        if track_load not in (False, True, "sample"):
            raise ValueError("track_load must be False, True, or 'sample'")
        self.track_load = track_load
        self.model = model
        self.optimizer = optimizer
        self.loss_name = loss
        self.loss_fn = get_loss(loss)
        self.num_stages = num_stages
        self.partitioner = partitioner or NaivePartitioner()
        self.num_microbatches = num_microbatches
        if devices is None:
            devices = [None] * num_stages
        if len(devices) != num_stages:
            raise ValueError("need one device per stage")
        self.devices = [resolve_device(d) for d in devices]
        self.partitions: List[Partition] = []
        self.stages: List[PipelineStage] = []
        self._join_executor = None

    def deploy_stages(self, generator: Optional[torch.Generator] = None
                      ) -> None:
        """Partition, build the stages and install the weights. The full
        model is initialised from ``generator`` first when one is given or
        it has no parameters yet, so the stages start from exactly the
        weights an unsplit run starts from."""
        self.partitions = self.partitioner.get_partitions(self.model,
                                                          self.num_stages)
        if generator is not None or next(self.model.parameters(),
                                         None) is None:
            self.model.init(generator=generator, device=self.devices[0])
        stage_models = self.model.split(self.partitions)
        sp = self.model.split_params(dict(self.model.named_parameters()),
                                     self.partitions)
        ss = self.model.split_params(dict(self.model.named_buffers()),
                                     self.partitions)
        self.stages = []
        for sid, (smodel, dev) in enumerate(zip(stage_models, self.devices)):
            stage = PipelineStage.from_config(
                sid, smodel.get_config(), self.optimizer.get_config(), dev,
                track_load=self.track_load)
            stage.set_weights(sp[sid], ss[sid])
            self.stages.append(stage)

    # -- schedules --
    def train_batch_sync(self, x, y, lr, rng: Optional[int] = None
                         ) -> Tuple[float, torch.Tensor]:
        """GPipe: every microbatch's forward, then every backward, then one
        update. Returns (mean loss, logits)."""
        return self._batch("sync", x, y, lr, rng)

    def train_batch_semi_async(self, x, y, lr, rng: Optional[int] = None
                               ) -> Tuple[float, torch.Tensor]:
        """Each microbatch's backward is queued as soon as its forward is:
        on the card, microbatch i + 1's forward on a stage's stream runs
        beside microbatch i's backward on another's."""
        return self._batch("semi_async", x, y, lr, rng)

    def _batch(self, schedule, x, y, lr, rng):
        snap = [s.snapshot_state() for s in self.stages]
        try:
            with get_tracer().span("pipe.batch", track="pipeline",
                                   schedule=schedule,
                                   microbatches=self.num_microbatches):
                return self._train_batch(schedule == "semi_async", x, y, lr,
                                         rng)
        except Exception:
            self.abort_batch(snap)
            raise

    def _forward_chain(self, i: int, x, rng: int):
        h, ready = x, None
        for stage in self.stages:
            h = stage.forward(i, h, fold_in(rng, i), ready=ready)
            ready = stage.done
        return h

    def _backward_chain(self, i: int, out, target, losses: list) -> None:
        last = self.stages[-1]
        with last.running():
            leaf = out.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = self.loss_fn(leaf, target)
            (g,) = torch.autograd.grad(loss, leaf)
            # a device scalar: a host read here would serialise the stages
            losses.append(loss.detach() * out.shape[0])
            last._record_done()
        ready = last.done
        for stage in reversed(self.stages):
            g = stage.backward(i, g, ready=ready)
            ready = stage.done

    def _train_batch(self, interleave: bool, x, y, lr, rng):
        x = torch.as_tensor(x)
        mb_x = split_microbatches(x.to(self.devices[0]), self.num_microbatches)
        mb_y = split_microbatches(
            self.stages[-1]._receive(torch.as_tensor(y), None),
            self.num_microbatches)
        rng = 0 if rng is None else int(rng)
        outputs: List[torch.Tensor] = []
        losses: List[torch.Tensor] = []
        for i, mx in enumerate(mb_x):
            outputs.append(self._forward_chain(i, mx, rng))
            if interleave:
                self._backward_chain(i, outputs[i], mb_y[i], losses)
        if not interleave:
            for i, (out, my) in enumerate(zip(outputs, mb_y)):
                self._backward_chain(i, out, my, losses)
        self.update_parameters(lr)
        self._wait_stages(outputs + losses)
        logits = torch.cat(outputs)
        total_loss = sum(torch.stack(losses).tolist())
        return total_loss / x.shape[0], logits

    def _wait_stages(self, tensors: Sequence[torch.Tensor] = ()) -> None:
        """The caller's current stream waits for every stage's stream;
        ``tensors`` (made on those streams) are kept alive for it."""
        for stage in self.stages:
            if stage.stream is not None:
                cur = torch.cuda.current_stream(stage.device)
                cur.wait_stream(stage.stream)
        for t in tensors:
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))

    # -- failure handling --
    def abort_batch(self, state_snapshots: Optional[List[Any]] = None
                    ) -> None:
        """Clear every stage's cached microbatches and partial gradients
        and, given the batch-start snapshots, put back the layer state the
        aborted batch's completed forwards moved. Schedules call it when
        they raise."""
        if state_snapshots is None:
            state_snapshots = [_UNSET] * len(self.stages)
        for stage, snap in zip(self.stages, state_snapshots):
            stage.abort(snap)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every stage's queued work has run (params, layer
        state, gradients and each stage's latest output). With a
        ``timeout`` (seconds), return False and warn when it expires
        instead of blocking."""
        trees = [(s.params, s.state,
                  [p.grad for p in s.model.parameters()], s._last_out)
                 for s in self.stages]
        if timeout is None:
            hard_fence(trees)
            return True
        from concurrent.futures import ThreadPoolExecutor
        from concurrent.futures import TimeoutError as FutureTimeout

        # one waiter thread a coordinator: a fence that timed out stays
        # queued on it instead of leaking a blocked thread a call
        if self._join_executor is None:
            self._join_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pipeline-join")
        fut = self._join_executor.submit(hard_fence, trees)
        try:
            fut.result(timeout=timeout)
            return True
        except FutureTimeout:
            warnings.warn(f"pipeline join timed out after {timeout}s "
                          f"(stages may still be executing)", stacklevel=2)
            return False

    def close(self) -> None:
        """Release the join-waiter thread (``wait=False``: a fence stuck on
        a hung device must not turn teardown into a hang)."""
        if self._join_executor is not None:
            self._join_executor.shutdown(wait=False)
            self._join_executor = None

    def __del__(self):
        with contextlib.suppress(Exception):
            self.close()

    def forward_only(self, x, training: bool = False) -> torch.Tensor:
        """The chained forward in eval mode, whatever ``training`` says
        (as in the JAX package): no graph kept, no statistics moved."""
        h, ready = torch.as_tensor(x), None
        for stage in self.stages:
            h = stage.forward(-1, h, training=False, ready=ready)
            ready = stage.done
        self._wait_stages([h])
        return h

    def update_parameters(self, lr) -> None:
        for stage in self.stages:
            stage.apply_updates(lr)

    def collect_load_reports(self) -> List[Dict[str, float]]:
        return [s.load.report() for s in self.stages]

    def collect_profiling(self) -> List[Dict[str, Any]]:
        return [s.collect_profile() for s in self.stages]

    def clear_profiling(self) -> None:
        for s in self.stages:
            s.clear_profile()

    def gathered_params(self) -> Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]:
        """The stages' params and layer state under the full model's names
        (``layers.<i>.…``), copied to the host (for a checkpoint, or eval
        on one device)."""
        self._wait_stages()

        def host(named):
            return {n: t.detach().cpu() for n, t in named.items()}

        return (merge_named([host(s.params) for s in self.stages],
                            self.partitions),
                merge_named([host(s.state) for s in self.stages],
                            self.partitions))


def format_profiling(tables: List[Dict[str, Any]]) -> str:
    """Render ``collect_profiling()``'s per-stage per-layer tables."""
    lines = [f"{'stage':>5} {'layer':<28} {'fwd µs':>12} {'bwd µs':>12} "
             f"{'calls':>7}"]
    for t in tables:
        sid = t.get("stage_id", -1)
        rows = t.get("layers", [])
        if not rows:
            lines.append(f"{sid:>5} (no microbatch processed yet)")
            continue
        for r in rows:
            lines.append(f"{sid:>5} {r['name']:<28} {r['fwd_us']:>12.1f} "
                         f"{r['bwd_us']:>12.1f} {r['calls']:>7}")
    return "\n".join(lines)


def train_pipeline_batch_sync(coord: InProcessPipelineCoordinator, x, y, lr,
                              rng=None):
    return coord.train_batch_sync(x, y, lr, rng)


def train_pipeline_epoch(coord: InProcessPipelineCoordinator, loader, lr,
                         rng: Optional[int] = None,
                         schedule: str = "semi_async") -> Tuple[float, float]:
    """One epoch over ``loader``'s ``(x, y)`` batches, batch ``bi`` drawn
    with ``fold_in(rng, bi)``. Returns (mean loss, accuracy)."""
    rng = 0 if rng is None else int(rng)
    fn = (coord.train_batch_semi_async if schedule == "semi_async"
          else coord.train_batch_sync)
    total_loss, total_correct, total_n = 0.0, 0, 0
    for bi, (x, y) in enumerate(loader):
        loss, logits = fn(x, y, lr, fold_in(rng, bi))
        total_loss += loss * x.shape[0]
        total_correct += int(correct_count(
            logits, torch.as_tensor(y).to(logits.device)))
        total_n += x.shape[0]
    return total_loss / max(total_n, 1), total_correct / max(total_n, 1)
