"""Sequence (context) parallelism: ring, zigzag-ring and Ulysses attention
over a mesh's ``"seq"`` axis (counterpart of
``dcnn_tpu/parallel/sequence.py``).

The sequence dim of (B, H, S, D) tensors is sharded over the axis: each
rank of the axis's process group holds a contiguous S/n slice
(:func:`shard_sequence`) and calls the function a ``make_*`` returns on it,
every rank alike (one process a rank, as the data-parallel step runs).

- **Ring** (:func:`make_ring_attention`): each rank keeps its Q block and
  passes K/V blocks around the ring (:func:`~.data_parallel.ring_shift`,
  ``d -> d + 1``), so after ``t`` rounds rank ``i`` holds the block of
  rank ``(i - t) mod n``. Causal mode skips every block pair that lies
  wholly above the diagonal, so rank ``i`` computes ``i + 1`` of its
  ``n`` rounds; the exchanges still run every round.
- **Zigzag** (:func:`make_zigzag_ring_attention`): causal only. The
  sequence is cut into ``2n`` blocks and rank ``i`` owns blocks ``i`` and
  ``2n-1-i`` (:func:`zigzag_permutation`, :func:`zigzag_shard`), so every
  rank computes ``2n + 1`` live block pairs over the ring: balanced.
- **Ulysses** (:func:`make_ulysses_attention`): an all-to-all swaps the
  sharded dim from sequence to heads, :func:`~..ops.attention.
  flash_attention` runs on the whole sequence for ``H/n`` heads, and an
  all-to-all swaps back. Needs ``H % n == 0``.

Ring and zigzag run each live (q block, kv block) pair through the flash
ops (``dcnn::flash_fwd``, ``dcnn::flash_bwd_dq``, ``dcnn::flash_bwd_dkv``:
the Hopper kernels on CUDA tensors, their plain versions on CPU tensors).
Block offsets are multiples of the block length, so a pair is fully
visible (``causal=False``), on the diagonal (``causal=True``, diagonal
offset 0) or fully masked and skipped. The partials merge by their
logsumexp in fp32 (``lse = logaddexp(lse_a, lse_b)``, ``O = e^(lse_a -
lse)·O_a + e^(lse_b - lse)·O_b``), cast to q's dtype once at the end. In
bf16 each block's O leaves the forward kernel rounded to bf16 before the
merge (the JAX package keeps fp32 across blocks), so a ring output is
within a few bf16 units of whole-sequence flash, not bit-equal.

The backward is a ``torch.autograd.Function`` (send and receive have no
autograd): each live pair's dQ, dK and dV come from the flash backward
with the rank's merged O and logsumexp, whose Δ = rowsum(dO∘O) is then the
global one, so the per-pair gradients add up exactly. dQ accumulates
locally in fp32; the dK/dV partials travel around the ring with their
K/V block and one last exchange hands them back to the block's owner (the
transpose of the forward's schedule). Ulysses' all-to-all is an autograd
Function whose backward is the reverse all-to-all, and the flash op's own
autograd gives the kernels' backward.

The JAX package's ``interpret=`` (the Pallas interpreter off the TPU) has
no meaning here and is not taken: a CPU tensor already runs the kernels'
plain versions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core.mesh import SEQ_AXIS, Mesh
from ..ops.attention import _flash_backward, _flash_forward, flash_attention
from .data_parallel import AllToAll, ring_shift


def _map(tree, fn):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def shard_sequence(tree, mesh: Mesh, axis: str = SEQ_AXIS, seq_dim: int = 2):
    """This rank's contiguous slice of the sequence dim ``seq_dim`` of
    every tensor in ``tree``: the rank at coordinate ``i`` of ``n`` along
    ``axis`` takes positions ``[i·S/n, (i+1)·S/n)``."""
    n = mesh.shape[axis]
    i = mesh.coordinate(axis)

    def take(x):
        s = x.shape[seq_dim]
        if s % n:
            raise ValueError(
                f"sequence length ({s}) is not divisible by mesh axis "
                f"{axis!r} size {n}; pad the sequence")
        per = s // n
        return x.narrow(seq_dim, i * per, per)

    return _map(tree, take)


def zigzag_permutation(seq_len: int, n: int) -> torch.Tensor:
    """Sequence-position permutation for zigzag ring attention: the
    sequence cut into ``2n`` blocks, rank ``i`` owning blocks ``i`` and
    ``2n-1-i``. ``x.index_select(2, perm)`` is in zigzag order (each
    rank's shard then the usual contiguous S/n slice); invert with
    ``torch.argsort(perm)``. A ``torch.long`` tensor on the CPU."""
    if seq_len % (2 * n):
        raise ValueError(f"zigzag needs seq_len ({seq_len}) divisible by "
                         f"2*n ({2 * n})")
    c = seq_len // (2 * n)
    blocks = []
    for i in range(n):
        blocks.append(torch.arange(i * c, (i + 1) * c))
        j = 2 * n - 1 - i
        blocks.append(torch.arange(j * c, (j + 1) * c))
    return torch.cat(blocks)


def zigzag_shard(tree, mesh: Mesh, axis: str = SEQ_AXIS, seq_dim: int = 2):
    """Permute the tensors of ``tree`` into zigzag order along ``seq_dim``
    and take this rank's slice (:func:`shard_sequence`). The paired
    :func:`make_zigzag_ring_attention` output is in the same order."""
    n = mesh.shape[axis]

    def put(x):
        perm = zigzag_permutation(x.shape[seq_dim], n).to(x.device)
        return x.index_select(seq_dim, perm)

    return shard_sequence(_map(tree, put), mesh, axis, seq_dim)


# -- the ring schedule ---------------------------------------------------------

class _Plan:
    """One call's ring: the axis's group, its size ``n``, this rank's
    index, the block layout (``zigzag``), causality and scale."""

    def __init__(self, group, n: int, idx: int, causal: bool, scale: float,
                 zigzag: bool):
        self.group, self.n, self.idx = group, n, idx
        self.causal, self.scale, self.zigzag = causal, scale, zigzag

    def blocks(self, rank: int) -> List[int]:
        """The global block offsets (in block lengths) of ``rank``'s
        chunks."""
        if self.zigzag:
            return [rank, 2 * self.n - 1 - rank]
        return [rank]

    def pairs(self, src: int):
        """``(i, j, diagonal)`` of every live (q chunk i, kv chunk j) pair
        with the kv block of rank ``src``."""
        for i, oq in enumerate(self.blocks(self.idx)):
            for j, ok in enumerate(self.blocks(src)):
                if not self.causal:
                    yield i, j, False
                elif ok <= oq:
                    yield i, j, ok == oq


def live_pairs(n: int, idx: int, *, causal: bool, zigzag: bool) -> int:
    """Live block pairs rank ``idx`` of ``n`` runs through the flash ops
    in one forward (and again in one backward): ring ``idx + 1`` causal
    and ``n`` not, zigzag ``2n + 1``."""
    plan = _Plan(None, n, idx, causal, 1.0, zigzag)
    return sum(1 for t in range(n) for _ in plan.pairs((idx - t) % n))


def _merge(state, o: torch.Tensor, lse: torch.Tensor):
    """Fold a block's (O, lse) into the running (O, lse) by logsumexp, in
    at least fp32. Rows with lse ≈ -1e30 on both sides stay 0 (the
    weights are finite)."""
    acc = torch.promote_types(o.dtype, torch.float32)
    o, lse = o.to(acc), lse.to(acc)
    if state is None:
        return o, lse
    o_a, lse_a = state
    new = torch.logaddexp(lse_a, lse)
    o = (torch.exp(lse_a - new)[..., None] * o_a
         + torch.exp(lse - new)[..., None] * o)
    return o, new


def _ring_forward(q, k, v, plan: _Plan):
    """(O in q's dtype, lse (B, H, S_local) in at least fp32)."""
    nb = 2 if plan.zigzag else 1
    qs = q.chunk(nb, 2)
    states = [None] * nb
    kv = [k, v]
    for t in range(plan.n):
        if t:
            kv = ring_shift(kv, plan.group)
        ks, vs = kv[0].chunk(nb, 2), kv[1].chunk(nb, 2)
        for i, j, diag in plan.pairs((plan.idx - t) % plan.n):
            o, lse = _flash_forward(qs[i], ks[j], vs[j], causal=diag,
                                    scale=plan.scale)
            states[i] = _merge(states[i], o, lse)
    out = torch.cat([s[0] for s in states], 2).to(q.dtype)
    return out, torch.cat([s[1] for s in states], 2)


def _ring_backward(q, k, v, out, lse, dout, plan: _Plan):
    nb = 2 if plan.zigzag else 1
    acc = torch.promote_types(q.dtype, torch.float32)
    qs, outs, lses, dos = (t.chunk(nb, 2) for t in (q, out, lse, dout))
    dq = [torch.zeros(c.shape, dtype=acc, device=q.device) for c in qs]
    cur = [k, v, torch.zeros(k.shape, dtype=acc, device=k.device),
           torch.zeros(v.shape, dtype=acc, device=v.device)]
    for t in range(plan.n):
        if t:
            cur = ring_shift(cur, plan.group)
        ks, vs, dks, dvs = (c.chunk(nb, 2) for c in cur)
        for i, j, diag in plan.pairs((plan.idx - t) % plan.n):
            dq_p, dk_p, dv_p = _flash_backward(
                qs[i], ks[j], vs[j], outs[i], lses[i], dos[i], causal=diag,
                scale=plan.scale)
            dq[i] += dq_p
            dks[j].add_(dk_p)  # views: accumulates into cur[2], cur[3]
            dvs[j].add_(dv_p)
    # after n - 1 shifts this rank holds rank idx+1's block: one more
    # shift returns every block's dK/dV to its owner
    dk, dv = ring_shift(cur[2:], plan.group)
    return (torch.cat(dq, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, plan):
        out, lse = _ring_forward(q, k, v, plan)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_backward(q, k, v, out, lse, dout.contiguous(),
                                ctx.plan), None)


def _axis(mesh: Mesh, axis: str):
    return mesh.get_group(axis), mesh.shape[axis], mesh.coordinate(axis)


def _check_lengths(q, k, v, what: str) -> None:
    if k.shape[2] != q.shape[2] or v.shape[2] != q.shape[2]:
        raise ValueError(
            f"{what} requires equal q/k/v sequence lengths, got "
            f"Sq={q.shape[2]} Sk={k.shape[2]} Sv={v.shape[2]} (global kv "
            f"positions are derived from the q shard length)")


def make_ring_attention(mesh: Mesh, *, axis: str = SEQ_AXIS,
                        causal: bool = False, scale: Optional[float] = None):
    """``f(q_local, k_local, v_local) -> out_local``: exact attention over
    the whole sequence, sharded over ``mesh[axis]`` (:func:`shard_sequence`
    gives each rank its slice; :func:`shard_sequence` refuses an S not
    divisible by the axis size). Differentiable. Causal mode skips the
    fully masked rounds (rank ``i`` computes ``i + 1`` of ``n``);
    :func:`make_zigzag_ring_attention` balances that skip."""
    group, n, idx = _axis(mesh, axis)

    def f(q, k, v):
        _check_lengths(q, k, v, "ring attention")
        s = q.shape[-1] ** -0.5 if scale is None else scale
        return _RingAttention.apply(
            q, k, v, _Plan(group, n, idx, causal, float(s), False))

    return f


def make_zigzag_ring_attention(mesh: Mesh, *, axis: str = SEQ_AXIS,
                               scale: Optional[float] = None):
    """Causal ring attention over zigzag-sharded sequences
    (:func:`zigzag_shard`): the numbers of :func:`make_ring_attention`
    (``causal=True``), the live block pairs balanced across the ring. The
    output is in zigzag order. Needs S divisible by ``2n``, so a shard of
    even length."""
    group, n, idx = _axis(mesh, axis)

    def f(q, k, v):
        _check_lengths(q, k, v, "zigzag ring")
        if q.shape[2] % 2:
            raise ValueError(
                f"zigzag ring needs sequence length ({q.shape[2] * n}) "
                f"divisible by 2*mesh axis size ({2 * n}); pad the "
                f"sequence")
        s = q.shape[-1] ** -0.5 if scale is None else scale
        return _RingAttention.apply(
            q, k, v, _Plan(group, n, idx, True, float(s), True))

    return f


def make_ulysses_attention(mesh: Mesh, *, axis: str = SEQ_AXIS,
                           causal: bool = False,
                           scale: Optional[float] = None):
    """Ulysses sequence parallelism over ``mesh[axis]``: ``f(q_local,
    k_local, v_local) -> out_local``, an all-to-all from sequence shards
    to head shards, :func:`~..ops.attention.flash_attention` over the
    whole sequence for ``H/n`` heads, and the all-to-all back.
    Differentiable. Needs the head count divisible by the axis size."""
    group, n, _ = _axis(mesh, axis)

    def f(q, k, v):
        if q.shape[1] % n:
            raise ValueError(
                f"ulysses needs heads ({q.shape[1]}) divisible by mesh axis "
                f"{axis!r} size {n}")
        s = q.shape[-1] ** -0.5 if scale is None else scale
        qh, kh, vh = (AllToAll.apply(t, 1, 2, group) for t in (q, k, v))
        out = flash_attention(qh, kh, vh, causal=causal, scale=s)
        return AllToAll.apply(out, 2, 1, group)

    return f


__all__: Tuple[str, ...] = (
    "shard_sequence", "zigzag_permutation", "zigzag_shard",
    "make_ring_attention", "make_zigzag_ring_attention",
    "make_ulysses_attention", "live_pairs",
)
