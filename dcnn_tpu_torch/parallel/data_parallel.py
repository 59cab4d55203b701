"""Data-parallel training over a mesh of processes (counterpart of
``dcnn_tpu/parallel/data_parallel.py``).

The JAX package shards the batch over a device mesh and lets GSPMD insert
the collectives. Here every rank is a process holding the whole model and
its own slice of the batch (:func:`shard_batch`), and the collectives are
explicit, over the mesh axis's process group:

- :func:`make_data_parallel_train_step`: the mesh step. Batchnorm's
  statistics are the *global* batch's (the per-rank one-pass sums go
  through an all-reduce that autograd sees, :class:`AllReduceSum`), as
  GSPMD computes them; after the backward the gradients and the loss are
  all-reduced and divided by the axis size. Each rank's local loss
  backpropagates through the statistics' all-reduce, whose backward
  all-reduces again, so the ranks' gradients add up to the gradient of the
  sum of the local losses, and their mean is the global batch's gradient.
- ``make_train_step(reduce_axis=)`` (:class:`MeshReduce` with
  ``global_bn=False``): per-shard statistics, then gradients, loss and the
  updated batchnorm statistics averaged over the axis (the JAX step's
  ``pmean``).
- :func:`make_elastic_grad_step` / :func:`make_elastic_apply_step`: the
  two halves of the elastic step (``parallel/elastic.py``), which
  exchanges over TCP between them.

The sequence-parallel paths (``parallel/sequence.py``) exchange over an
axis group with :func:`ring_shift` (send to the next rank, receive from
the previous) and :func:`all_to_all_tiled` (``AllToAll`` under autograd).

Collectives on CUDA tensors over a gloo group go through the host
explicitly (:func:`all_reduce_`): one copy to the host, gloo's all-reduce
there, one copy back, counted in :data:`HOST_STAGING`. A gloo collective
runs on the host and cannot sit in a CUDA graph, so under gloo the steps
run eagerly; under NCCL the whole step, collectives included, is one
graph, as ``make_train_step(jit=True)`` captures it.

``spatial_axis=`` shards dim 2 of the batch (H under NCHW, W under NHWC)
over a second mesh axis beside ``"data"``, as the JAX step does: rank
``(i, j)`` holds batch rows ``i`` and dim-2 slice ``j``
(:func:`shard_batch`). GSPMD inserts the halos there; here the step
enters a :class:`SpatialContext` for each forward and the ops exchange
them (:mod:`dcnn_tpu_torch.ops.spatial` says which op runs locally and
which gathers): :class:`HaloExchange` (point-to-point between the two
neighbours on the axis, zero or −inf rows at the global edges, its
backward sending the halo rows' gradients back to their owners, which add
them) and :class:`GatherDim` (an all-gather of dim 2 whose backward is its
transpose, an all-reduce of the gradient over the axis and this rank's
slice of it). Batchnorm on a sharded activation sums over the (data, sp)
plane, on a gathered one over ``"data"``; group norm's per-sample sums go
over the sp axis.

The gradient convention of the spatial step: the ``S`` ranks of one data
row gather the same logits and compute the same loss ``L_i``, and each
back-propagates ``L_i / S``, its share. With every collective's backward
its exact transpose (the all-reduces of batchnorm's sums add the
cotangents over the same plane, the gather's backward sums over the sp
axis before it slices, the halo's backward adds the neighbours' rows), the
ranks' parameter gradients add up to the gradient of ``Σ_i L_i``: partial
sums over each rank's rows for the layers before the gather, ``1/S`` each
of the replicated layers' after it. So the step sums the gradients over
the (data, sp) plane and divides by the data size ``D`` (summing ``L_i /
S`` likewise gives the mean loss): the gradients are summed over sp and
averaged over data, not averaged over the whole plane, which would be off
by ``S``. An sp axis of size 1 shards nothing: its ops run as without it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional

import torch

from ..core.graphs import GraphPool, Session, SessionCache, count_host
from ..core.keys import fold_in, generators, reseed
from ..core.mesh import DATA_AXIS, Mesh, active_mesh
from ..ops import norm as _norm
from ..ops import spatial as _spatial
from ..ops.losses import upcast_logits

# collectives of CUDA tensors staged through the host for a gloo group:
# how many, and the bytes copied each way
HOST_STAGING: Dict[str, int] = {"collectives": 0, "bytes": 0}
# the spatial step's halo exchanges (forward and backward): how many, and
# the bytes this process sent to its neighbours (through count_host, so a
# captured step's count at each replay)
HALO: Dict[str, int] = {"exchanges": 0, "bytes": 0}
_STAGING_LOCK = threading.Lock()


def _backend(group) -> str:
    import torch.distributed as dist

    return dist.get_backend(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through the host:
    a CUDA tensor over a gloo group. A staged route never runs under a
    CUDA graph capture: a step over a gloo group runs eagerly (the train
    step and the compiled pipeline capture only where
    ``reduce.capturable()``, an NCCL group), so its host copies and counts
    carry ``# dcnn: disable=TS01``/``TS05``."""
    return t.is_cuda and _backend(group) != "nccl"


def _count_staged(nbytes: int) -> None:
    # staged collectives run eagerly only (see _staged)
    with _STAGING_LOCK:
        HOST_STAGING["collectives"] += 1  # dcnn: disable=TS05
        HOST_STAGING["bytes"] += nbytes  # dcnn: disable=TS05


def _collective(op, t: torch.Tensor, group, **kw) -> torch.Tensor:
    """``op`` (a ``torch.distributed`` collective) on ``t`` in place; a
    CUDA tensor over a gloo group goes through the host, counted."""
    if _staged(t, group):
        host = t.cpu()  # dcnn: disable=TS01
        op(host, group=group, **kw)
        t.copy_(host)
        _count_staged(2 * t.numel() * t.element_size())
        return t
    op(t, group=group, **kw)
    return t


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place. A CUDA tensor over a gloo group
    is copied to the host, reduced there and copied back (counted in
    :data:`HOST_STAGING`); NCCL reduces it on the card."""
    import torch.distributed as dist

    return _collective(dist.all_reduce, t, group)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Broadcast ``t`` in place from global rank ``src`` (staged through
    the host as :func:`all_reduce_` is)."""
    import torch.distributed as dist

    return _collective(dist.broadcast, t, group, src=src)


def ring_shift(tensors, group):
    """Send each of ``tensors`` to the next rank of ``group``'s ring and
    receive the previous rank's in its place (``jax.lax.ppermute`` with
    ``d -> d + 1``): fresh tensors, in order, over one
    ``batch_isend_irecv``. A group of one returns ``tensors`` as they are.
    CUDA tensors over gloo go through the host (counted in
    :data:`HOST_STAGING`, one collective a call)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = _staged(tensors[0], group)
    send = [t.cpu() if staged else t.contiguous()  # dcnn: disable=TS01
            for t in tensors]
    recv = [torch.empty_like(s) for s in send]
    ops = []
    for i, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, nxt, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, r, prv, group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv = [r.to(t.device) for r, t in zip(recv, tensors)]
        _count_staged(2 * sum(t.numel() * t.element_size() for t in tensors))
    return recv


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis=split_dim,
    concat_axis=concat_dim, tiled=True)`` over ``group``: ``x`` cut into
    ``n`` equal pieces along ``split_dim``, piece ``j`` sent to rank ``j``,
    and the pieces received from ranks ``0 .. n-1`` concatenated along
    ``concat_dim``, over one ``all_to_all_single``. CUDA tensors over gloo
    go through the host (counted in :data:`HOST_STAGING`)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split {n} ways")
    inp = torch.stack(x.chunk(n, split_dim))
    staged = _staged(x, group)
    if staged:
        inp = inp.cpu()  # dcnn: disable=TS01
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    if staged:
        out = out.to(x.device)
        _count_staged(2 * x.numel() * x.element_size())
    return torch.cat(out.unbind(0), dim=concat_dim)


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all_tiled` whose backward is the reverse exchange
    (split ``concat_dim``, concatenate ``split_dim``), the transpose JAX
    takes of ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_tiled(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (all_to_all_tiled(grad.contiguous(), concat_dim, split_dim,
                                 ctx.group), None, None, None)


class AllReduceSum(torch.autograd.Function):
    """``y = Σ_ranks x`` whose backward is ``∂x = Σ_ranks ∂y``: every
    rank's loss depends on every rank's ``x`` through ``y``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def _neighbours(group):
    """(previous, next) global ranks of this rank on ``group``'s line;
    None past either edge (the line does not wrap)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    prv = dist.get_global_rank(group, me - 1) if me > 0 else None
    nxt = dist.get_global_rank(group, me + 1) if me < n - 1 else None
    return prv, nxt


def _swap_edges(to_prev, to_next, group, tags):
    """Send ``to_prev`` to the previous rank and ``to_next`` to the next
    (either may be None past an edge) and receive theirs: ``(from_prev,
    from_next)``, None past an edge, on the sent tensors' device. CUDA
    tensors over gloo go through the host (counted in
    :data:`HOST_STAGING`)."""
    import torch.distributed as dist

    prv, nxt = _neighbours(group)
    like = to_prev if to_prev is not None else to_next
    staged = _staged(like, group)
    ops, recv, sent = [], [None, None], 0
    for i, (peer, out) in enumerate(((prv, to_prev), (nxt, to_next))):
        if peer is None:
            continue
        s = out.cpu() if staged else out.contiguous()  # dcnn: disable=TS01
        recv[i] = torch.empty_like(s)
        # what goes up carries tags[0] and what goes down tags[1]: a rank
        # receives from its previous neighbour what that one sent down
        ops.append(dist.P2POp(dist.isend, s, peer, group, tag=tags[i]))
        ops.append(dist.P2POp(dist.irecv, recv[i], peer, group,
                              tag=tags[1 - i]))
        sent += s.numel() * s.element_size()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        recv = [None if r is None else r.to(like.device) for r in recv]
        _count_staged(2 * sent)
    # a captured step exchanges at each replay: counted there
    count_host(HALO, "exchanges")
    count_host(HALO, "bytes", sent)
    return recv


class HaloExchange(torch.autograd.Function):
    """``x`` (dim 2 sharded over ``group``'s line) with ``h`` rows of
    each neighbour on either side of dim 2: the previous rank's last ``h``
    rows above, the next rank's first ``h`` below, ``fill`` rows past the
    global edges. The backward sends the halo rows' gradients back to
    their owners, which add them to their own rows' (the fill rows'
    gradients are dropped)."""

    @staticmethod
    def forward(ctx, x, h, fill, group):
        ctx.h, ctx.group = h, group
        r = x.shape[2]
        top, bot = _swap_edges(x.narrow(2, 0, h), x.narrow(2, r - h, h),
                               group, (0, 1))
        edge = list(x.shape)
        edge[2] = h
        top = top if top is not None else x.new_full(edge, fill)
        bot = bot if bot is not None else x.new_full(edge, fill)
        return torch.cat([top, x, bot], dim=2)

    @staticmethod
    def backward(ctx, grad):
        h = ctx.h
        r = grad.shape[2] - 2 * h
        g = grad.narrow(2, h, r).clone()
        prv, nxt = _neighbours(ctx.group)
        from_prev, from_next = _swap_edges(
            grad.narrow(2, 0, h) if prv is not None else None,
            grad.narrow(2, h + r, h) if nxt is not None else None,
            ctx.group, (2, 3))
        if from_prev is not None:  # the previous rank's bottom halo: my top
            g.narrow(2, 0, h).add_(from_prev)
        if from_next is not None:
            g.narrow(2, r - h, h).add_(from_next)
        return g, None, None, None


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order (one ``all_gather``; CUDA tensors over gloo through the host,
    counted in :data:`HOST_STAGING`)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    staged = _staged(x, group)
    src = (x.detach().cpu() if staged  # dcnn: disable=TS01
           else x.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        _count_staged(2 * out.numel() * out.element_size())
        out = out.to(x.device)
    return out


class GatherDim(torch.autograd.Function):
    """:func:`all_gather_dim` under autograd. Its backward is the
    transpose: the gradient summed over ``group`` (every rank's loss
    depends on every rank's rows through the gathered tensor), then this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed as dist

        ctx.dim, ctx.group = dim, group
        ctx.rows, ctx.me = x.shape[dim], dist.get_rank(group)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce_(grad.contiguous().clone(), ctx.group)
        return (g.narrow(ctx.dim, ctx.me * ctx.rows, ctx.rows).contiguous(),
                None, None)


class SpatialContext:
    """One forward's dim-2 sharding, the object :mod:`..ops.spatial` hands
    the ops: the spatial axis's ``group``, this rank's ``coord`` and the
    axis ``size``, the (data, sp) plane's ``plane`` group, the global
    ``extent`` of dim 2 at the input, and ``sharded``, whether the
    activation is still sharded (an axis of size 1 never is)."""

    def __init__(self, group, plane, extent: Optional[int] = None):
        import torch.distributed as dist

        self.group, self.plane = group, plane
        self.size = dist.get_world_size(group)
        self.coord = dist.get_rank(group)
        self.plane_size = dist.get_world_size(plane)
        self.extent = extent
        self.sharded = self.size > 1

    def halo(self, x: torch.Tensor, h: int, fill: float) -> torch.Tensor:
        """``x`` with ``h`` neighbour rows either side of dim 2
        (:class:`HaloExchange`)."""
        return HaloExchange.apply(x, h, fill, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with dim 2 gathered (:class:`GatherDim`); what follows
        runs replicated."""
        self.sharded = False
        return GatherDim.apply(x, 2, self.group)

    def batch_stats(self, s1, s2, n):
        """Batchnorm's one-pass sums and count over the (data, sp) plane."""
        c = s1.shape[0]
        both = AllReduceSum.apply(torch.cat([s1, s2]), self.plane)
        return both[:c], both[c:], n * self.plane_size

    def axis_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the spatial axis, under autograd."""
        return AllReduceSum.apply(t, self.group)


def _float_buffers(model):
    return [b for b in model.buffers() if b.is_floating_point()]


def _resolve_group(axis, mesh: Optional[Mesh]):
    """The process group of ``axis``: a group itself, or an axis name of
    ``mesh`` (else of the active ``with mesh:`` one)."""
    if not isinstance(axis, str):
        return axis
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise ValueError(
            f"reduce axis {axis!r} names a mesh axis, but no mesh is "
            f"active: call the step inside `with mesh:` or pass a process "
            f"group")
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{tuple(mesh.shape)}")
    return mesh.get_group(axis)


class MeshReduce:
    """What a train step reduces over a mesh axis (``axis``: an axis name
    or a process group): after the backward, the gradients and the loss
    (and, unless ``global_bn``, the float buffers) summed over the axis in
    one collective and divided by its size; with ``global_bn`` the
    forward's batchnorm statistics summed over it too. Resolved at each
    call, so an axis name finds the mesh active then.

    ``spatial_axis`` (with ``global_bn``, the spatial mesh step): each
    forward runs in a :class:`SpatialContext` over that axis of ``mesh``,
    back-propagates ``loss / S`` and gathers a still-sharded output; the
    gradients and the loss are summed over the (``axis``, ``spatial_axis``)
    plane and divided by the ``axis`` size (the module docstring's
    convention)."""

    def __init__(self, axis: Any = DATA_AXIS, mesh: Optional[Mesh] = None,
                 global_bn: bool = False,
                 spatial_axis: Optional[str] = None):
        self.axis, self.mesh, self.global_bn = axis, mesh, global_bn
        self.spatial_axis = spatial_axis
        if spatial_axis is not None:
            # built now: every rank makes the step, and new_group is
            # collective
            self._plane = mesh.get_group((axis, spatial_axis))
            self._sp = mesh.get_group(spatial_axis)
            self._sp_size = mesh.shape[spatial_axis]
            self._data_size = mesh.shape[axis]

    def group(self):
        if self.spatial_axis is not None:
            return self._plane
        return _resolve_group(self.axis, self.mesh)

    def capturable(self) -> bool:
        """Whether a CUDA graph can hold the collectives (NCCL's)."""
        return _backend(self.group()) == "nccl"

    @property
    def loss_scale(self) -> float:
        """What each rank's loss is scaled by before its backward: its
        share ``1/S`` of the loss the sp ranks of its data row hold."""
        return 1.0 / self._sp_size if self.spatial_axis is not None else 1.0

    def forward(self, x: Optional[torch.Tensor] = None):
        """The context one forward and its backward run in (``x``, the
        forward's input, gives the spatial context its extent)."""
        if not self.global_bn:
            return contextlib.nullcontext()
        import torch.distributed as dist

        group = (_resolve_group(self.axis, self.mesh)
                 if self.spatial_axis is None
                 else self.mesh.get_group(self.axis))
        size = dist.get_world_size(group)

        def stats(s1, s2, n):
            c = s1.shape[0]
            both = AllReduceSum.apply(torch.cat([s1, s2]), group)
            return both[:c], both[c:], n * size

        if self.spatial_axis is None:
            return _norm.reduce_batch_stats(stats)
        stack = contextlib.ExitStack()
        stack.enter_context(_norm.reduce_batch_stats(stats))
        extent = None if x is None else int(x.shape[2]) * self._sp_size
        stack.enter_context(_spatial.activate(
            SpatialContext(self._sp, self._plane, extent)))
        return stack

    def output(self, out: torch.Tensor) -> torch.Tensor:
        """The forward's output, gathered over the spatial axis while it
        is still sharded (a model that ends on a sharded map)."""
        return _spatial.gather(out)

    def reduce(self, model, loss: torch.Tensor,
               grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Average ``grads`` (in place), the float buffers (unless
        ``global_bn``: the global statistics are already equal on every
        rank) and ``loss`` over the axis; returns the mean loss."""
        bufs = [] if self.global_bn else _float_buffers(model)
        return self.mean([*grads.values(), *bufs], loss)

    def mean(self, tensors, loss: torch.Tensor) -> torch.Tensor:
        """Average ``tensors`` (in place) and ``loss`` over the axis in one
        all-reduce of their flat concatenation (in the first tensor's
        dtype); returns the mean loss. Under ``spatial_axis``: summed over
        the plane, divided by the data size, the loss taken at its share
        ``1/S``."""
        import torch.distributed as dist

        group = self.group()
        dt = tensors[0].dtype if tensors else loss.dtype
        share = loss.detach().reshape(1).to(dt)
        if self.spatial_axis is not None and self._sp_size > 1:
            share = share / self._sp_size
        flat = torch.cat([t.reshape(-1).to(dt) for t in tensors] + [share])
        all_reduce_(flat, group)
        flat.div_(self._data_size if self.spatial_axis is not None
                  else dist.get_world_size(group))
        off = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        return flat[off].to(loss.dtype)


def replicate(obj, mesh: Mesh):
    """Broadcast ``obj`` (a ``TrainState``, a model, a dict or a tensor)
    from rank 0 of ``mesh`` to every rank, in place; returns it."""
    src = int(mesh.devices.reshape(-1)[0])

    def put(o):
        if isinstance(o, torch.Tensor):
            with torch.no_grad():
                broadcast_(o.data if isinstance(o, torch.nn.Parameter)
                           else o, src=src)
        elif isinstance(o, torch.nn.Module):
            for t in (*o.parameters(), *o.buffers()):
                put(t)
        elif isinstance(o, dict):
            for v in o.values():
                put(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                put(v)
        elif hasattr(o, "model") and hasattr(o, "opt_state"):
            put(o.model)
            put(o.opt_state)
        return o

    return put(obj)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS,
                spatial_axis: Optional[str] = None, spatial_dim: int = 2):
    """This rank's slice of the global batch (array(s) whose leading axis
    is the batch), contiguous along ``axis``: rank at coordinate ``i`` of
    ``n`` takes rows ``[i·B/n, (i+1)·B/n)``. With ``spatial_axis``, an
    array of more than ``spatial_dim`` dims is also cut along
    ``spatial_dim``: coordinate ``j`` of ``m`` on that axis takes slice
    ``[j·E/m, (j+1)·E/m)`` (the labels stay whole along it, as JAX's spec
    shards only arrays that have the dim). Either size that does not
    divide raises ``ValueError``. The spatial step
    (:func:`make_data_parallel_train_step`) takes dim-2 slices, the
    default."""
    n = mesh.shape[axis]
    i = mesh.coordinate(axis)
    if spatial_axis is not None:
        m = mesh.shape[spatial_axis]
        j = mesh.coordinate(spatial_axis)

    def take(x):
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows not divisible by the "
                             f"{n}-way {axis!r} axis")
        per = b // n
        x = x[i * per:(i + 1) * per]
        if spatial_axis is not None and x.ndim > spatial_dim:
            e = x.shape[spatial_dim]
            if e % m:
                raise ValueError(
                    f"dim {spatial_dim} of {e} not divisible by the "
                    f"{m}-way {spatial_axis!r} axis")
            x = x.narrow(spatial_dim, j * (e // m), e // m) \
                if isinstance(x, torch.Tensor) else \
                x[(slice(None),) * spatial_dim
                  + (slice(j * (e // m), (j + 1) * (e // m)),)]
        return x

    return take(batch)


def make_data_parallel_train_step(model, loss_fn: Callable, optimizer,
                                  mesh: Mesh, num_microbatches: int = 1,
                                  spatial_axis: Optional[str] = None,
                                  jit: bool = True):
    """The train step over ``mesh``'s data axis: ``step(ts, xs, ys, lr,
    generator=None) -> (loss, logits)`` with ``xs, ys = shard_batch((x,
    y), mesh)``, ``ts`` replicated (:func:`replicate`) and updated in
    place identically on every rank. ``loss`` is the global batch's mean;
    ``logits`` stay local to the shard.

    Batchnorm statistics are computed over the *global* batch, as GSPMD
    computes them in the JAX package, so the step matches the
    single-process step on the whole batch. With ``num_microbatches > 1``
    each rank splits its own shard, so a microbatch is the union of the
    ranks' i-th pieces (the same gradient as one process's contiguous
    microbatches for a model without batchnorm). Dropout draws from
    ``generator`` on each rank: pass each rank its own.

    ``spatial_axis``: dim 2 of the 4-D input is sharded over that mesh
    axis too (``xs, ys = shard_batch((x, y), mesh,
    spatial_axis=spatial_axis)``); the convs and pools exchange halos, the
    statistics are the global batch's over N and every row, and the step
    still equals the single-process step on the whole batch (the module
    docstring). The logits are the data shard's, gathered whole along
    dim 2 on every rank of the axis. A model whose input is not 4-D
    raises ``ValueError``, as in JAX. Give the ranks of one data row the
    same ``generator`` state: a dropout on a sharded map then draws the
    single process's mask and keeps its rows.

    On CUDA with an NCCL group the step is one CUDA graph
    (``make_train_step(jit=True)``'s capture, collectives included); over
    gloo it runs eagerly, its collectives staged through the host."""
    from ..train.trainer import TrainStep

    if spatial_axis is not None:
        x_rank = (len(model.input_shape) + 1
                  if model.input_shape is not None else 4)
        if x_rank != 4:
            raise ValueError("spatial_axis requires 4-D image input")
    return TrainStep(model, loss_fn, optimizer, num_microbatches, jit=jit,
                     reduce=MeshReduce(DATA_AXIS, mesh, global_bn=True,
                                       spatial_axis=spatial_axis))


# -- the elastic step's two halves ------------------------------------------

class ElasticGradStep:
    """The gradient half of the elastic step (see
    :func:`make_elastic_grad_step`)."""

    def __init__(self, model, loss_fn: Callable, num_microbatches: int,
                 jit: bool = True, pool: Optional[GraphPool] = None):
        self.model, self.loss_fn = model, loss_fn
        self.n_mb = int(num_microbatches)
        self.jit = bool(jit)
        self.pool = pool if jit else None
        self.gens = None
        self._sessions = SessionCache()
        # kernel launches of this step's replays, by wrapper name
        self.launches: Dict[str, int] = {}

    def _place(self, device) -> None:
        if self.gens is None:
            self.gens = generators(self.n_mb, device)
            if self.jit and self.pool is None and device.type == "cuda":
                self.pool = GraphPool(device)
            if self.pool is not None and not self.pool.cuda:
                self.pool = None  # on the CPU a session is the plain call

    def _body(self, x, y):
        """Forward and backward of every local microbatch, the buffers
        threaded through them; the packed ``grad_sum ‖ a·state ‖
        loss_sum`` vector."""
        model, a = self.model, self.n_mb
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss_sum = None
        for i, (xi, yi) in enumerate(zip(x.chunk(a), y.chunk(a))):
            logits = upcast_logits(model(xi, generator=self.gens[i]))
            loss = self.loss_fn(logits, yi)
            loss.backward()  # .grad sums the microbatches' mean gradients
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        dt = params[0].dtype
        return torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).to(dt) for p in params]
            + [(b.reshape(-1).to(dt) * a) for b in _float_buffers(model)]
            + [loss_sum.reshape(1).to(dt)])

    def binding(self) -> tuple:
        return tuple(t.data_ptr() for t in (*self.model.parameters(),
                                            *self.model.buffers()))

    def packed(self, ts, x, y, key: int, mb0: int) -> torch.Tensor:
        """The packed vector of this host's microbatches ``mb0 ..
        mb0+a-1`` (a fresh tensor, or on CUDA the graph's static output,
        valid until the next call)."""
        if x.shape[0] % self.n_mb:
            raise ValueError(
                f"host batch of {x.shape[0]} rows not divisible by "
                f"{self.n_mb} local microbatches — the global microbatch "
                f"grid must evenly tile every host share")
        self._place(x.device)
        # dropout keys by GLOBAL microbatch index: world-size independent
        reseed(self.gens, [fold_in(key, mb0 + i) for i in range(self.n_mb)])
        self.model.train()
        if self.pool is None:
            return self._body(x, y)
        with self.pool.lock:
            k = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
            sessions = self._sessions.lookup(
                k, self.binding(),
                lambda: (Session("elastic_grad_step", self._body, (x, y),
                                 pool=self.pool, generators=self.gens),),
                self.model)
            if sessions is None:
                return self._body(x, y)
            for name, d in sessions[0].launch_names().items():
                self.launches[name] = self.launches.get(name, 0) + d
            return sessions[0].replay(x, y)

    def unpack(self, flat: torch.Tensor):
        """``(grads, state, loss)`` views of a packed vector: ``grads`` by
        parameter name, ``state`` the float buffers' values by name."""
        names = [n for n, _ in self.model.named_parameters()]
        bnames = [n for n, b in self.model.named_buffers()
                  if b.is_floating_point()]
        params = dict(self.model.named_parameters())
        bufs = dict(self.model.named_buffers())
        grads, state, off = {}, {}, 0
        for n in names:
            k = params[n].numel()
            grads[n] = flat[off:off + k].view_as(params[n])
            off += k
        for n in bnames:
            k = bufs[n].numel()
            state[n] = flat[off:off + k].view_as(bufs[n])
            off += k
        return grads, state, flat[off]

    def __call__(self, ts, x, y, key: int, mb0: int):
        """``(grad_sum, state_final, loss_sum)``: ``state_final`` is the
        model's float buffers after the local microbatches (the JAX step
        returns them unscaled, and so does this)."""
        flat = self.packed(ts, x, y, key, mb0).clone()
        grads, state, loss = self.unpack(flat)
        state = {n: v / self.n_mb for n, v in state.items()}
        return grads, state, loss


def make_elastic_grad_step(model, loss_fn: Callable, num_microbatches: int,
                           jit: bool = True,
                           pool: Optional[GraphPool] = None
                           ) -> ElasticGradStep:
    """The gradient half of a host-level data-parallel step:
    ``gstep(ts, x, y, key, mb0) -> (grad_sum, state_final, loss_sum)``
    with NO optimizer update — the update happens after the cross-host
    exchange (``parallel/elastic.py``).

    ``x`` is this host's contiguous slice of the *global* microbatch grid:
    ``num_microbatches`` local microbatches whose global indices start at
    ``mb0``. Microbatch ``m``'s dropout draws come from
    ``generator(fold_in(key, m))`` — world-size independent, so the same
    global microbatch draws the same masks whichever host runs it.

    Returns **sums**, not means: ``grad_sum`` sums the per-microbatch mean
    gradients and ``loss_sum`` the per-microbatch mean losses, so the
    reduce side divides once by the global count K. ``state_final`` is the
    batchnorm state threaded through the local microbatches (in the
    model's buffers too). :meth:`ElasticGradStep.packed` gives the one
    vector the exchange ships, ``grad_sum ‖ a·state ‖ loss_sum``.

    ``jit=True`` on CUDA: a graph per input shape, captured at its second
    call (:class:`~dcnn_tpu_torch.core.graphs.SessionCache`); the
    controller keeps one such step a local microbatch count."""
    return ElasticGradStep(model, loss_fn, num_microbatches, jit, pool)


def make_elastic_apply_step(optimizer):
    """The update half: ``apply(params, opt_state, grads, lr) -> (params,
    opt_state)``, in place. Every surviving host applies it to the SAME
    broadcast gradient bytes, so the replicated params and optimizer state
    stay bit-identical across hosts without a parameter broadcast."""

    def apply(params: Dict[str, torch.Tensor], opt_state, grads, lr):
        with torch.no_grad():
            optimizer.update(grads, opt_state, params, lr)
        return params, opt_state

    return apply
