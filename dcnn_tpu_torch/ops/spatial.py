"""Spatial (dim-2) sharding of image activations: what the ops consult.

The JAX package shards dim 2 of a batch over a mesh axis
(``shard_batch(spatial_axis=)``) and GSPMD inserts the halo exchanges of
every conv and pool. Here the exchanges are explicit: the mesh step
(:func:`~dcnn_tpu_torch.parallel.make_data_parallel_train_step` with
``spatial_axis=``) enters a spatial context for each forward
(:class:`~dcnn_tpu_torch.parallel.data_parallel.SpatialContext`, which
holds the axis group, this rank's coordinate and the global extent), and
the ops ask :func:`current` for it. Outside a context :func:`current` is
None and every op runs as it always has; so does an axis of size 1, which
shards nothing.

Dim 2 is H under NCHW and W under NHWC (the JAX step shards ``x_spec[2]``
in either layout). Rank ``j`` of ``S`` holds rows ``[j·r, (j+1)·r)`` of
dim 2, ``r`` = global rows / ``S``. A window op (conv, max or average
pool) with kernel ``k``, stride ``s`` and padding ``p`` along dim 2 runs
on its local rows when :func:`local_window` holds: ``r`` divides by
``s``, ``p ≤ r`` (the halo fits in a neighbour's rows) and the local
output has exactly ``r/s`` rows. It then takes ``p`` rows from each
neighbour (the pad value at the global edges: 0 for a conv and an average
pool, −inf for a max pool) and runs with no padding on dim 2 and its own
on the other spatial dim. Otherwise the op gathers dim 2 first and runs
replicated from there on, as does every layer after it: that is what
GSPMD's reshard amounts to. ResNet-18's stride-2 3×3 convs and 1×1
projections stay sharded while the local rows are even; its
``avgpool2d(4, 1, 0)`` over the last 4 rows gathers, and ``flatten``
gathers whatever is still sharded.

The context tracks one flag, ``sharded``: a gather clears it, and a
residual block runs its two branches from the same state and gathers the
branch that is still sharded when the other is not, so that they add row
for row.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch

_STATE = threading.local()


def context():
    """The spatial context active on this thread (sharded or not)."""
    return getattr(_STATE, "ctx", None)


def current():
    """The active spatial context while the activation is sharded, else
    None."""
    ctx = getattr(_STATE, "ctx", None)
    return ctx if ctx is not None and ctx.sharded else None


@contextlib.contextmanager
def activate(ctx):
    """Make ``ctx`` this thread's spatial context for the block."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def local_window(rows: int, kernel: int, stride: int, pad: int) -> bool:
    """Whether a window op along dim 2 runs on ``rows`` local rows of an
    even shard: the rows divide by the stride, the halo (``pad`` rows a
    side) fits in a neighbour's rows, and the padded local rows give
    exactly ``rows / stride`` outputs (then the global output splits
    evenly too)."""
    return (rows % stride == 0 and pad <= rows
            and (rows + 2 * pad - kernel) // stride + 1 == rows // stride)


def prepare_window(x: torch.Tensor, kernel: Sequence[int],
                   stride: Sequence[int], padding: Sequence[int],
                   data_format: str, fill: float
                   ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``(x, padding)`` for a window op with (h, w) ``kernel``, ``stride``
    and ``padding`` on a logical ``data_format`` tensor: under a sharded
    context either ``x`` with its halos (``fill`` at the global edges)
    and no padding on the sharded dim, or ``x`` gathered with the padding
    as given; outside one, both as given."""
    ctx = current()
    if ctx is None:
        return x, tuple(padding)
    a = 0 if data_format == "NCHW" else 1  # dim 2's index in (h, w)
    k, s, p = int(kernel[a]), int(stride[a]), int(padding[a])
    if not local_window(int(x.shape[2]), k, s, p):
        return ctx.gather(x), tuple(padding)
    if p:
        x = ctx.halo(x, p, fill)
    pad = list(padding)
    pad[a] = 0
    return x, (int(pad[0]), int(pad[1]))


def gather(x: torch.Tensor) -> torch.Tensor:
    """``x`` with dim 2 gathered while sharded; else ``x``."""
    ctx = current()
    return x if ctx is None else ctx.gather(x)


def branches(x, *fns):
    """Run each of ``fns`` on ``x`` from the same sharding state and
    return their outputs aligned: where one branch ended sharded and
    another gathered, the sharded ones are gathered too."""
    ctx = context()
    if ctx is None:
        return [fn(x) for fn in fns]
    start, outs, states = ctx.sharded, [], []
    for fn in fns:
        ctx.sharded = start
        outs.append(fn(x))
        states.append(ctx.sharded)
    ctx.sharded = all(states)
    if ctx.sharded or not any(states):
        return outs
    # ctx.gather clears the flag, which stays cleared
    return [ctx.gather(o) if st else o for o, st in zip(outs, states)]


def dropout_keep(x: torch.Tensor, keep_prob: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """The keep mask of a dropout on ``x``. On a sharded activation a rank
    draws the mask of the whole (gathered) shape from its generator and
    keeps its own rows: with the same generator state on every rank of
    the axis, the masks are the single process's, sliced."""
    ctx = current()
    if ctx is None:
        return torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) < keep_prob
    r = x.shape[2]
    shape = list(x.shape)
    shape[2] = r * ctx.size
    u = torch.rand(shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    return u.narrow(2, ctx.coord * r, r) < keep_prob
