"""Compiled pipeline parallelism: a whole schedule's step as one CUDA graph
(counterpart of ``dcnn_tpu/parallel/compiled_pipeline.py``).

The JAX package runs a pipeline schedule inside one XLA program: stages
over a ``"stage"`` mesh axis, activations rotated with ``ppermute``,
heterogeneous stages packed into padded flat vectors picked by
``lax.switch``. On one card the port keeps the schedule and its numbers
and drops what XLA needed to express them: every microbatch's stage
forwards and backwards, the boundary casts to ``wire_dtype``, the
batchnorm updates in microbatch order and the optimizer update are
queued in schedule order on the card and captured once as a
:class:`~dcnn_tpu_torch.core.graphs.Session`, then replayed. The first
call of a shape (and precision mode) is the eager step and its warm-up;
the debug paths (anomaly mode, hooks: ``core.graphs.debug_eager``) run
eagerly; a capture that fails raises ``CaptureError`` and nothing falls
back to eager. On the CPU every call is the eager step.

- **Homogeneous** (:func:`make_compiled_pipeline_forward`,
  :func:`make_compiled_pipeline_train_step`): every stage is one
  ``stage_fn(stage_params, x)`` over params stacked on a leading stage
  axis (:func:`stack_stage_params`, :class:`SequentialStageStack`), the
  activation's shape unchanged.
- **Heterogeneous** (:class:`HeteroCompiledPipeline`): any
  ``Sequential.split`` partition, stages differing in params, activation
  shape and batchnorm state, under GPipe (:meth:`make_train_step`: every
  forward, then every backward) or 1F1B (:meth:`make_train_step_1f1b`,
  PipeDream-flush: stage ``s`` runs ``min(S - s, M)`` warm-up forwards,
  then alternates a forward and a backward, in the JAX engine's tick
  order). A stage application keeps its autograd graph from its forward
  to its backward (a recompute would move the in-place batchnorm
  statistics and redraw dropout), so GPipe holds M graphs a stage and
  1F1B at most S: 1F1B's memory law.

Gradients are the sum over microbatches of each microbatch loss's
gradient, scaled by ``1 / M`` (the gradient of the mean loss), accumulated
in microbatch order as the host-driven coordinator accumulates them, so
compiled GPipe and the coordinator's sync schedule run the same
arithmetic. Dropout in stage s for microbatch m draws from a generator
seeded ``stage_key(rng, m, s)``, as the coordinator's stage does; the
``M × S`` generators are registered with the graph and reseeded on the
host before each call.

Where the JAX function takes a ``mesh`` for its ``"stage"`` axis, the
port keeps every stage in the process, on ``device`` (or where its inputs
live). The homogeneous functions' ``data_axis=`` composes data
parallelism with the pipeline, as the JAX package's 2-D ``("data",
"stage")`` mesh does: each rank of ``mesh[data_axis]`` runs every stage on
its slice of the microbatch dim, and the train step averages the
gradients and the loss over the axis's group before the update (one
all-reduce, inside the step's graph under NCCL; eager under gloo).
``remat`` is taken by the homogeneous train step
(``torch.utils.checkpoint`` around each stage application; a stage there
has no state); the heterogeneous engine keeps whole graphs, as above.
Span: ``pipe.compiled.step`` (track ``pipeline``; attrs ``schedule``,
``stages``, ``microbatches``), one a step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, resolve_device
from ..core.graphs import GraphPool, Session, SessionCache
from ..core.keys import generators, reseed
from ..nn.layer import Layer
from ..nn.layers import DropoutLayer
from ..nn.sequential import Sequential, split_named
from ..obs.tracer import get_tracer
from ..optim.optimizers import Optimizer
from .partitioner import NaivePartitioner, Partitioner
from .pipeline import stage_key

Op = Tuple[str, int, int]  # ("F" or "B", stage, microbatch)


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class _Compiled:
    """A step function on the card as graphs, by the rule of
    :class:`~dcnn_tpu_torch.core.graphs.SessionCache`: per input shape and
    precision mode a warm eager call, then a capture bound to the addresses
    of ``bound`` (the tensors the step reads and writes in place; others
    capture again), then replays; eager while ``debug_eager(model)`` holds
    (``model`` None: anomaly mode and global hooks). The CPU, and
    ``jit=False``, call the function."""

    def __init__(self, name: str, jit: bool,
                 model: Optional[torch.nn.Module] = None):
        self.name = name
        self.jit = jit
        self.model = model
        self.pool: Optional[GraphPool] = None
        self.sessions = SessionCache()

    def __call__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 bound: Sequence[torch.Tensor],
                 gens: Sequence[torch.Generator] = ()):
        dev = inputs[0].device
        if not self.jit or dev.type != "cuda":
            return fn(*inputs)
        if self.pool is None:
            self.pool = GraphPool(dev)
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        bind = tuple(t.data_ptr() for t in bound)
        with self.pool.lock:
            s = self.sessions.lookup(
                key, bind, lambda: Session(self.name, fn, inputs,
                                           pool=self.pool, generators=gens),
                self.model)
            return fn(*inputs) if s is None else s(*inputs)

    def session(self) -> Optional[Session]:
        """The newest captured session (None before a capture)."""
        return self.sessions.latest()


# --------------------------------------------------------------- homogeneous

def stack_stage_params(per_stage_params: Sequence[Mapping[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack structurally identical stage params along a new leading stage
    axis (stage i is slice i), as leaves that take gradients."""
    return {n: torch.stack([p[n].detach() for p in per_stage_params])
            .requires_grad_(True) for n in per_stage_params[0]}


def _stage_slices(stacked: Mapping[str, torch.Tensor],
                  num_stages: int) -> List[Dict[str, torch.Tensor]]:
    return [{n: t[i] for n, t in stacked.items()} for i in range(num_stages)]


def shard_stacked(tree: Mapping[str, torch.Tensor], mesh=None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The stacked stage params on this rank's device (CUDA unless
    ``"cpu"``), as leaves that take gradients. The JAX package shards the
    leading stage axis over ``mesh``'s ``"stage"`` axis; the port keeps
    every stage in the process, so ``mesh`` exists for the JAX signature
    and has no effect: every rank holds the whole stack."""
    dev = resolve_device(device)
    return {n: t.detach().to(dev).requires_grad_(True)
            for n, t in tree.items()}


def _data_reduce(mesh, data_axis: Optional[str]):
    """The ``MeshReduce`` over ``mesh[data_axis]`` (None without a data
    axis), its group resolved now so that a bad axis fails here."""
    if data_axis is None:
        return None
    if mesh is None:
        raise ValueError(f"data_axis={data_axis!r} needs the mesh it names")
    from .data_parallel import MeshReduce

    reduce = MeshReduce(data_axis, mesh)
    reduce.group()
    return reduce


def _check_microbatches(mbs: torch.Tensor, num_microbatches: int) -> None:
    if mbs.shape[0] != num_microbatches:
        raise ValueError(
            f"microbatches leading dim {mbs.shape[0]} != num_microbatches "
            f"{num_microbatches} this pipeline was built for")


def make_compiled_pipeline_forward(stage_fn: Callable, num_stages: int,
                                   num_microbatches: int, jit: bool = True,
                                   mesh=None, data_axis: Optional[str] = None):
    """``forward(stacked_params, microbatches) -> outputs``: each of the
    ``(num_microbatches, mb, ...)`` microbatches through the
    ``num_stages`` stages, ``stage_fn(stage_params, x) -> y`` keeping the
    activation's shape; outputs are the last stage's, shaped like the
    input. No gradients; one graph a shape on the card. ``mesh`` and
    ``data_axis`` exist for the JAX signature and change nothing: each
    rank passes its own slice of the microbatch dim (JAX's ``P(None,
    data_axis)``) and the forward reduces nothing over the axis; they are
    only checked."""
    if num_microbatches < 1:
        raise ValueError("need at least one microbatch")
    _data_reduce(mesh, data_axis)
    compiled = _Compiled("pipe.compiled.forward", jit)

    def forward(stacked_params, mbs):
        _check_microbatches(mbs, num_microbatches)

        @torch.no_grad()
        def run(mbs_in):
            per_stage = _stage_slices(stacked_params, num_stages)
            outs = []
            for m in range(num_microbatches):
                h = mbs_in[m]
                for sp in per_stage:
                    h = stage_fn(sp, h)
                outs.append(h)
            return torch.stack(outs)

        return compiled(run, (mbs,), list(stacked_params.values()))

    return forward


def make_compiled_pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                                      optimizer: Optimizer, num_stages: int,
                                      num_microbatches: int,
                                      remat: bool = True, jit: bool = True,
                                      mesh=None,
                                      data_axis: Optional[str] = None):
    """One train step over the GPipe schedule of a homogeneous stack:
    ``step(stacked_params, opt_state, mb_x, mb_y, lr) -> (params,
    opt_state, loss, outputs)``. The loss is the mean of the microbatch
    losses; the optimizer updates ``stacked_params`` and ``opt_state`` in
    place (both returned), every stage's slice in one update. ``remat``
    recomputes each stage application in the backward instead of keeping
    its intermediates. On the card the whole step is one graph.

    ``data_axis`` (an axis of ``mesh``): data parallelism over the axis.
    ``mb_x``, ``mb_y`` and the outputs are this rank's slice of the
    microbatch dim (rows ``[i·mb/D, (i+1)·mb/D)`` of each microbatch);
    the gradients and the loss are summed over the axis's group in one
    all-reduce and divided by its size before the update, so with equal
    slices and a mean-reducing loss every rank applies the whole batch's
    gradient. Under NCCL the all-reduce is inside the step's graph; under
    gloo the step runs eagerly, its all-reduce staged through the host."""
    if num_microbatches < 1:
        raise ValueError("need at least one microbatch")
    reduce = _data_reduce(mesh, data_axis)
    if reduce is not None:
        jit = jit and reduce.capturable()
    compiled = _Compiled("pipe.compiled.step", jit)
    scalars: Dict[str, torch.Tensor] = {}

    def apply_stage(sp, h):
        if remat:
            return checkpoint(stage_fn, sp, h, use_reentrant=False,
                              preserve_rng_state=False)
        return stage_fn(sp, h)

    def step(stacked_params, opt_state, mb_x, mb_y, lr):
        _check_microbatches(mb_x, num_microbatches)
        dev = mb_x.device
        if not scalars:
            scalars.update(optimizer.scalars(dev))
        names = list(stacked_params)

        def run(xs, ys):
            per_stage = _stage_slices(stacked_params, num_stages)
            losses, outs = [], []
            with torch.enable_grad():
                for m in range(num_microbatches):
                    h = xs[m]
                    for sp in per_stage:
                        h = apply_stage(sp, h)
                    outs.append(h)
                    losses.append(loss_fn(h, ys[m]))
                loss = torch.stack(losses).mean()
                grads = torch.autograd.grad(
                    loss, [stacked_params[n] for n in names])
            if reduce is not None:
                loss = reduce.mean(grads, loss)
            optimizer.apply(dict(zip(names, grads)), opt_state,
                            stacked_params, scalars)
            return loss.detach(), torch.stack([o.detach() for o in outs])

        with get_tracer().span("pipe.compiled.step", track="pipeline",
                               schedule="gpipe", stages=num_stages,
                               microbatches=num_microbatches):
            optimizer.fill_scalars(scalars, opt_state, lr)
            bound = (list(stacked_params.values()) + _tensors(opt_state)
                     + list(scalars.values()))
            loss, outs = compiled(run, (mb_x, mb_y), bound)
            optimizer.advance(opt_state)
        return stacked_params, opt_state, loss, outs

    step.compiled = compiled
    return step


class SequentialStageStack:
    """``num_stages`` copies of one shape-preserving, stateless block
    ``Layer`` (a GroupNorm residual block, say) as a homogeneous stack:
    :meth:`init` gives the stacked params, :meth:`stage_fn` applies the
    block with one stage's slice."""

    def __init__(self, block: Layer, num_stages: int, input_shape):
        self.block = block
        self.num_stages = num_stages
        self.input_shape = tuple(input_shape)
        self._ready = False
        if block.output_shape(self.input_shape) != self.input_shape:
            raise ValueError(
                "compiled pipeline requires shape-preserving stages; "
                f"{block.name}: {self.input_shape} -> "
                f"{block.output_shape(self.input_shape)}")

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """Each stage's params drawn in turn from ``generator``, stacked,
        on ``device`` (CUDA unless ``"cpu"``)."""
        dev = resolve_device(device)
        per_stage = []
        for _ in range(self.num_stages):
            self.block.init(self.input_shape, generator=generator, device=dev)
            if next(self.block.buffers(), None) is not None:
                raise ValueError(
                    "compiled pipeline stages must be stateless (no BN "
                    "running stats); use GroupNorm blocks")
            per_stage.append({n: p.detach().clone()
                              for n, p in self.block.named_parameters()})
        self.block.train()
        self._ready = True
        return stack_stage_params(per_stage)

    def stage_fn(self, params: Mapping[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        if not self._ready:
            raise RuntimeError("call init() before stage_fn")
        return torch.func.functional_call(self.block, dict(params), (x,))


# ------------------------------------------------------------ heterogeneous

def gpipe_schedule(num_stages: int, num_microbatches: int) -> List[Op]:
    """Every microbatch's forward through every stage, then every
    microbatch's backward from the last stage to the first (the host-driven
    sync schedule's order)."""
    S, M = num_stages, num_microbatches
    return ([("F", s, m) for m in range(M) for s in range(S)]
            + [("B", s, m) for m in range(M) for s in reversed(range(S))])


def one_f_one_b_schedule(num_stages: int, num_microbatches: int) -> List[Op]:
    """The JAX engine's 1F1B ticks, each tick's stage work in stage order:
    stage s runs ``W = min(S - s, M)`` warm-up forwards at ticks ``s + m``,
    then ``F(s, m)`` at ``s + 2m`` and ``B(s, m)`` at ``2S - s + 2m - 1``,
    over ``2(M + S - 1)`` ticks."""
    S, M = num_stages, num_microbatches
    ops: List[Op] = []
    for t in range(2 * (M + S - 1)):
        for s in range(S):
            w = min(S - s, M)
            d = t - s
            if 0 <= d < w:
                ops.append(("F", s, d))
            elif d >= 2 * w and d % 2 == 0 and d // 2 < M:
                ops.append(("F", s, d // 2))
            else:
                num = t - 2 * S + s + 1
                if num >= 0 and num % 2 == 0 and num // 2 < M:
                    ops.append(("B", s, num // 2))
    return ops


class HeteroCompiledPipeline:
    """A compiled GPipe or 1F1B schedule over any ``Sequential.split``
    partition (``partitioner``, naive by default), on ``device`` (CUDA
    unless ``"cpu"``). ``wire_dtype`` (fp32 by default; bf16 halves the
    bytes a boundary hands on) is the dtype each stage's input, output and
    input gradient crosses a boundary in: the input microbatches, every
    stage's output (the logits included) and every gradient sent back are
    rounded to it, and a stage computes in fp32 from it.

    The stage models share the model's layer modules, so a step trains the
    model's own parameters and buffers: :meth:`init` returns them as
    ``(params, state)`` (``named_parameters``, ``named_buffers``), and
    :meth:`unpack_params` cuts a copy into the per-stage trees."""

    def __init__(self, model: Sequential, num_stages: int,
                 num_microbatches: int, device: DeviceLike = None,
                 partitioner: Optional[Partitioner] = None,
                 wire_dtype: Optional[torch.dtype] = None):
        if model.input_shape is None:
            raise ValueError("model needs a known input_shape")
        self.model = model
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.device = resolve_device(device)
        self.wire_dtype = wire_dtype or torch.float32
        self.partitions = (partitioner or NaivePartitioner()).get_partitions(
            model, num_stages)
        self.stage_models = model.split(self.partitions)
        self.in_shapes = [tuple(sm.input_shape) for sm in self.stage_models]
        self.out_shapes = [tuple(sm.output_shape())
                           for sm in self.stage_models]
        self.draws = any(isinstance(m, DropoutLayer) and m.rate > 0
                         for m in model.modules())

    def boundary_elems(self, mb: int) -> List[int]:
        """Elements of each stage-boundary activation (stage i -> i + 1) at
        microbatch size ``mb``: what each hop hands on."""
        return [mb * _prod(self.out_shapes[i])
                for i in range(self.num_stages - 1)]

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Initialise the full model once (the weights of an unsplit run
        from the same generator) on the device; returns its
        ``(params, state)``."""
        self.model.init(generator=generator, device=self.device)
        return (dict(self.model.named_parameters()),
                dict(self.model.named_buffers()))

    def unpack_params(self, params: Mapping[str, torch.Tensor],
                      state: Mapping[str, torch.Tensor]
                      ) -> Tuple[List[Dict[str, torch.Tensor]],
                                 List[Dict[str, torch.Tensor]]]:
        """Per-stage copies on the host, each under its stage model's
        names (for a checkpoint, or eval on one device)."""
        def host(named):
            return {n: t.detach().cpu().clone() for n, t in named.items()}

        return (split_named(host(params), self.partitions),
                split_named(host(state), self.partitions))

    def make_train_step(self, loss_fn: Callable, optimizer: Optimizer,
                        jit: bool = True) -> "ScheduledStep":
        """``step(params, opt_state, state, mb_x, mb_y, rng, lr) ->
        (params, opt_state, state, loss, logits)`` over the GPipe
        schedule. ``mb_x``: (M, mb, *input_shape); ``mb_y``: (M, mb, ...);
        ``rng``: an int key; ``lr``: a float or a 0-d tensor. Updates in
        place; ``loss`` is a device scalar, ``logits`` (M, mb, ...)."""
        return ScheduledStep(self, loss_fn, optimizer, "gpipe", jit)

    def make_train_step_1f1b(self, loss_fn: Callable, optimizer: Optimizer,
                             jit: bool = True) -> "ScheduledStep":
        """:meth:`make_train_step` over the 1F1B schedule: the same
        numbers, at most S stage graphs held a stage."""
        return ScheduledStep(self, loss_fn, optimizer, "1f1b", jit)


def _peak_stash(schedule: Sequence[Op], num_stages: int) -> List[int]:
    """The most forward graphs each stage holds at once under
    ``schedule``: an F stashes one, its B frees it."""
    held, peak = [0] * num_stages, [0] * num_stages
    for op, s, _ in schedule:
        held[s] += 1 if op == "F" else -1
        peak[s] = max(peak[s], held[s])
    return peak


class ScheduledStep:
    """The step :meth:`HeteroCompiledPipeline.make_train_step` and
    ``make_train_step_1f1b`` return. ``schedule`` is its list of ops;
    ``peak_stash[s]`` the most graphs stage s holds at once in a step, which
    the schedule decides."""

    def __init__(self, pipe: HeteroCompiledPipeline, loss_fn: Callable,
                 optimizer: Optimizer, schedule: str, jit: bool):
        self.pipe, self.loss_fn, self.optimizer = pipe, loss_fn, optimizer
        self.schedule_name = schedule
        S, M = pipe.num_stages, pipe.num_microbatches
        self.schedule = (gpipe_schedule(S, M) if schedule == "gpipe"
                         else one_f_one_b_schedule(S, M))
        self.compiled = _Compiled(f"pipe.compiled.{schedule}", jit,
                                  pipe.model)
        self.peak_stash = _peak_stash(self.schedule, S)
        self.scalars = optimizer.scalars(pipe.device)
        self._gens = (generators(S * M, pipe.device) if pipe.draws else [])
        self._live: tuple = ()

    def _bind(self) -> None:
        """Take the model's parameters and buffers as they are now (an
        ``init`` after this step was made replaces them), with a gradient
        accumulator for each parameter."""
        live = tuple(self.pipe.model.parameters())
        if len(live) == len(self._live) and all(
                a is b for a, b in zip(live, self._live)):
            return
        self._live = live
        model, stages = self.pipe.model, self.pipe.stage_models
        self._params = dict(model.named_parameters())
        self._state = dict(model.named_buffers())
        self._stage_params = [list(sm.parameters()) for sm in stages]
        self._names = [[n for n, _ in sm.named_parameters()] for sm in stages]
        self._gacc = {n: torch.zeros_like(p) for n, p in self._params.items()}

    # -- the device work (capturable: no host read) --
    def _run(self, mb_x: torch.Tensor, mb_y: torch.Tensor, opt_state):
        pipe = self.pipe
        S, M = pipe.num_stages, pipe.num_microbatches
        wire = pipe.wire_dtype
        for g in self._gacc.values():
            g.zero_()
        stage_gacc = split_named(self._gacc, pipe.partitions)
        stash: List[Dict[int, tuple]] = [{} for _ in range(S)]
        sent: Dict[Tuple[int, int], torch.Tensor] = {}  # (stage, m) -> out
        grads_back: Dict[Tuple[int, int], torch.Tensor] = {}
        losses: List[Optional[torch.Tensor]] = [None] * M
        logits: List[Optional[torch.Tensor]] = [None] * M
        for op, s, m in self.schedule:
            sm = pipe.stage_models[s]
            if op == "F":
                xw = (mb_x[m].to(wire) if s == 0
                      else sent.pop((s - 1, m)))
                xin = xw if s == 0 else xw.detach().requires_grad_(True)
                gen = self._gens[m * S + s] if self._gens else None
                with torch.enable_grad():
                    out = sm(xin.float(), generator=gen).to(wire)
                    root = None
                    if s == S - 1:
                        logits[m] = out.float()
                        root = self.loss_fn(logits[m], mb_y[m])
                        losses[m] = root.detach()
                        logits[m] = logits[m].detach()
                    else:
                        sent[(s, m)] = out.detach()
                stash[s][m] = (xin, out, root)
            else:
                xin, out, root = stash[s].pop(m)
                wrt = self._stage_params[s] + ([xin] if s > 0 else [])
                if s == S - 1:
                    grads = torch.autograd.grad(root, wrt, allow_unused=True)
                else:
                    grads = torch.autograd.grad(
                        out, wrt, grads_back.pop((s + 1, m)),
                        allow_unused=True)
                for n, g in zip(self._names[s], grads):
                    if g is not None:
                        stage_gacc[s][n].add_(g)
                if s > 0:
                    grads_back[(s, m)] = grads[-1]
        for g in self._gacc.values():
            g.mul_(1.0 / M)
        self.optimizer.apply(self._gacc, opt_state, self._params,
                             self.scalars)
        return torch.stack(losses).mean(), torch.stack(logits)

    # -- the host's part --
    def _adopt(self, given: Mapping[str, torch.Tensor],
               live: Mapping[str, torch.Tensor]) -> None:
        """Copy tensors that are not the model's own into it."""
        with torch.no_grad():
            for n, t in live.items():
                if given[n] is not t:
                    t.copy_(given[n])

    def __call__(self, params, opt_state, state, mb_x, mb_y, rng, lr):
        pipe = self.pipe
        S, M = pipe.num_stages, pipe.num_microbatches
        with get_tracer().span("pipe.compiled.step", track="pipeline",
                               schedule=self.schedule_name, stages=S,
                               microbatches=M):
            self._bind()
            self._adopt(params, self._params)
            self._adopt(state, self._state)
            mb_x = torch.as_tensor(mb_x).to(pipe.device)
            mb_y = torch.as_tensor(mb_y).to(pipe.device)
            _check_microbatches(mb_x, M)
            self.optimizer.fill_scalars(self.scalars, opt_state, lr)
            rng = 0 if rng is None else int(rng)
            if self._gens:
                reseed(self._gens, [stage_key(rng, m, s) for m in range(M)
                                    for s in range(S)])
            pipe.model.train()
            bound = (list(self._params.values()) + list(self._state.values())
                     + _tensors(opt_state) + list(self._gacc.values())
                     + list(self.scalars.values()))
            loss, logits = self.compiled(
                lambda xs, ys: self._run(xs, ys, opt_state), (mb_x, mb_y),
                bound, self._gens)
            self.optimizer.advance(opt_state)
        return self._params, opt_state, self._state, loss, logits

    def session(self) -> Optional[Session]:
        """The captured graph (None on the CPU or before the capture)."""
        return self.compiled.session()
