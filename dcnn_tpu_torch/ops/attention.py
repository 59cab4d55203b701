"""Scaled-dot-product attention ops (counterpart of ``dcnn_tpu/ops/attention.py``).

Shapes follow (B, H, S, D): batch, heads, sequence, head dim.

- :func:`attention`: the materialising version, the numerics oracle.
- :func:`blockwise_attention`: online softmax over K/V tiles in plain
  PyTorch, with arbitrary masks.
- :func:`flash_attention`: flash attention, differentiable. On CUDA
  tensors the forward launches the hand-written Hopper kernel
  (``csrc/flash_fwd.cu``) and the backward the dQ and dK/dV kernels
  (``csrc/flash_bwd.cu``), or they raise; on CPU tensors they run
  :func:`flash_forward_reference` and :func:`flash_backward_reference`, the
  kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels

NEG_INF = -1e30


def _check_mask_rank(mask: torch.Tensor) -> torch.Tensor:
    """Masks are 2-D (Sq, Sk) or 4-D (B|1, H|1, Sq, Sk), True = attend.
    3-D masks are rejected: a (B, Sq, Sk) key-padding mask would broadcast
    head-aligned, not batch-aligned; pass ``mask[:, None]``."""
    mask = torch.as_tensor(mask).bool()
    if mask.ndim == 3:
        raise ValueError(
            "3-D attention masks are ambiguous (batch- vs head-aligned); "
            "pass (Sq, Sk) or (B|1, H|1, Sq, Sk) — for a batch key-padding "
            "mask use mask[:, None].")
    if mask.ndim > 4:
        raise ValueError(
            f"attention mask rank {mask.ndim} > 4; expected (Sq, Sk) or "
            f"(B|1, H|1, Sq, Sk)")
    while mask.ndim < 4:
        mask = mask[None]
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Materialising attention ``softmax(q·kᵀ·scale)·v``; O(S²) memory.
    Fully-masked rows return 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    sq, sk = scores.shape[-2], scores.shape[-1]
    allowed = None
    if causal:
        allowed = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(sk - sq)
    if mask is not None:
        mask = _check_mask_rank(mask).to(q.device)
        allowed = mask if allowed is None else (allowed & mask)
    if allowed is not None:
        scores = scores.masked_fill(~allowed, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if allowed is not None:
        any_allowed = allowed.expand(scores.shape).any(-1, keepdim=True)
        weights = weights.masked_fill(~any_allowed, 0.0)
    return torch.matmul(weights, v)


def _online_softmax(q, k, v, *, causal: bool, block_kv: int, scale: float,
                    mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online softmax over K/V tiles of ``block_kv`` keys; never holds the
    (Sq, Sk) score matrix. Running state (acc, m, l) is at least fp32
    whatever the input dtype. P is rounded to V's dtype before P·V (l sums
    it before), as the JAX package's ``_online_block`` and the flash
    kernels do. Returns (O in q's dtype, logsumexp (B, H, Sq) in the state
    dtype). Fully-masked rows give O = 0."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc_dt), k.to(acc_dt), v.to(acc_dt)
    acc = torch.zeros(b, h, sq, d, dtype=acc_dt, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=acc_dt, device=q.device)
    l = torch.zeros(b, h, sq, dtype=acc_dt, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    for start in range(0, sk, block_kv):
        end = min(start + block_kv, sk)
        s = torch.matmul(qf, kf[:, :, start:end].transpose(-1, -2)) * scale
        allowed = None
        if causal:
            kv_pos = torch.arange(start, end, device=q.device)[None, :]
            allowed = kv_pos <= q_pos + (sk - sq)
        if mask is not None:
            blk = mask if mask.shape[-1] == 1 else mask[..., start:end]
            allowed = blk if allowed is None else (allowed & blk)
        if allowed is not None:
            s = s.masked_fill(~allowed, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # masked entries are zeroed explicitly: in a row masked so far,
        # exp(NEG_INF - NEG_INF) would be 1
        p = torch.exp(s - m_new[..., None])
        if allowed is not None:
            p = p.masked_fill(~allowed, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p_v = p.to(v.dtype).to(acc_dt)
        acc = acc * corr[..., None] + torch.matmul(p_v, vf[:, :, start:end])
        m = m_new
    l_fin = torch.clamp_min(l, 1e-30)
    return (acc / l_fin[..., None]).to(q.dtype), m + torch.log(l_fin)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, block_kv: int = 512,
                        scale: Optional[float] = None,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: online softmax over K/V
    blocks, exact. ``mask``: (Sq, Sk) or (B|1, H|1, Sq, Sk), True = attend.

    This is also where :func:`flash_attention` sends a call with a
    ``mask``; that path is not on the serving path and runs no kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sk = k.shape[2]
    if mask is not None:
        mask = _check_mask_rank(mask).to(q.device)
        if mask.shape[-1] not in (1, sk):
            raise ValueError(
                f"mask last dim {mask.shape[-1]} must be 1 or Sk={sk}")
    return _online_softmax(q, k, v, causal=causal, block_kv=block_kv,
                           scale=float(scale), mask=mask)[0]


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            scale: Optional[float] = None,
                            block_kv: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward kernel: the same online
    softmax over kv tiles, fp32 state, P rounded to V's dtype before P·V,
    returning (O, logsumexp (B, H, Sq) fp32). The CPU path and the tests
    use it; ``chip_smoke.py`` holds the kernel against it on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _online_softmax(q, k, v, causal=causal, block_kv=block_kv,
                           scale=float(scale), mask=None)


def _check_qkv(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention expects (B, H, S, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")


def _for_kernel(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as the flash kernels take it: contiguous, 16-byte aligned, its
    head dim ``width`` (zero columns added). Copies only where ``t`` is not
    so already."""
    if t.shape[-1] != width:
        return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if not t.is_contiguous():
        return t.contiguous()
    if t.data_ptr() % 16:
        return t.clone()
    return t


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, logsumexp (B, H, Sq) fp32). A CUDA tensor goes to the Hopper
    kernels (above head dim 256 the sliced one), which raise on what they
    cannot take (a dtype other than fp32 or bf16, a grid above 2^31
    blocks); strided or misaligned views are copied
    first, and a head dim whose rows are not whole 16-byte units is padded
    with zero columns, which add nothing to the scores, and cut off the
    output. A CPU tensor goes to the plain version. There is no other
    route."""
    _check_qkv(q, k, v)
    if q.device.type == "cuda":
        d = q.shape[-1]
        w = _kernels.flash_head_width(d, q.dtype)
        o, lse = _kernels.flash_fwd(*(_for_kernel(t, w) for t in (q, k, v)),
                                    causal=causal, scale=scale)
        return (o if w == d else o[..., :d]), lse
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal=causal, scale=scale)
    raise RuntimeError(f"flash_attention: no implementation for {q.device}")


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor, *,
                             causal: bool, scale: float, block_q: int = 64,
                             block_kv: int = 64
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of both flash backward kernels (FlashAttention-2
    math, no autograd): Δ = rowsum(dO·O) in fp32; per (q tile, kv tile) of
    the forward's ``live`` band, P = where(mask, exp(S − lse), 0) masked
    before the exponential (rows that saw no key carry lse ≈ −1e30), dP =
    dO·Vᵀ, dS = P∘(dP − Δ)·scale; dQ accumulates dS·K over kv tiles, dK
    dSᵀ·Q and dV Pᵀ·dO over q tiles, in fp32 (fp64 stays fp64). Under bf16
    dS and P are rounded to the input type before their products, as the
    kernels do. Returns (dQ, dK, dV) in q's dtype. The CPU path and the
    tests use it; ``chip_smoke.py`` holds the kernels against it."""
    _, _, sq, _ = q.shape
    sk = k.shape[2]
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, gf = (t.to(acc_dt) for t in (q, k, v, g))
    delta = (gf * o.to(acc_dt)).sum(-1)
    lse = lse.to(acc_dt)

    def as_input(t):  # the cast the kernels make before a product
        return t.to(q.dtype).to(acc_dt)

    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for qs in range(0, sq, block_q):
        qe = min(qs + block_q, sq)
        q_pos = torch.arange(qs, qe, device=q.device)[:, None]
        for ks in range(0, sk, block_kv):
            if causal and ks > qe - 1 + (sk - sq):
                break  # this and every later kv tile lie above the band
            ke = min(ks + block_kv, sk)
            s = torch.matmul(qf[..., qs:qe, :],
                             kf[..., ks:ke, :].transpose(-1, -2)) * scale
            s = s - lse[..., qs:qe, None]
            if causal:
                kv_pos = torch.arange(ks, ke, device=q.device)[None, :]
                s = s.masked_fill(kv_pos > q_pos + (sk - sq), -float("inf"))
            p = torch.exp(s)
            dp = torch.matmul(gf[..., qs:qe, :],
                              vf[..., ks:ke, :].transpose(-1, -2))
            ds = as_input(p * (dp - delta[..., qs:qe, None]) * scale)
            dq[..., qs:qe, :] += torch.matmul(ds, kf[..., ks:ke, :])
            dk[..., ks:ke, :] += torch.matmul(ds.transpose(-1, -2),
                                              qf[..., qs:qe, :])
            dv[..., ks:ke, :] += torch.matmul(as_input(p).transpose(-1, -2),
                                              gf[..., qs:qe, :])
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV). CUDA tensors go to the two Hopper kernels, which raise
    on what they cannot take, after the copies and padding of
    :func:`_flash_forward` (dO too); Δ = rowsum(dO·O) is computed here in
    fp32, as the JAX package computes it outside its kernels. CPU tensors
    go to the plain version. There is no other route."""
    _check_qkv(q, k, v)
    if q.device.type == "cuda":
        delta = (g.float() * o.float()).sum(-1)
        d = q.shape[-1]
        w = _kernels.flash_head_width(d, q.dtype)
        qc, kc, vc, gc = (_for_kernel(t, w) for t in (q, k, v, g))
        lse = lse.contiguous()
        dq = _kernels.flash_bwd_dq(qc, kc, vc, gc, lse, delta, causal=causal,
                                   scale=scale)
        dk, dv = _kernels.flash_bwd_dkv(qc, kc, vc, gc, lse, delta,
                                        causal=causal, scale=scale)
        if w != d:
            dq, dk, dv = (t[..., :d] for t in (dq, dk, dv))
        return dq, dk, dv
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, g, causal=causal,
                                        scale=scale)
    raise RuntimeError(f"flash_attention: no implementation for {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward through :func:`_flash_forward`, saving (q, k, v, O,
    logsumexp); backward through :func:`_flash_backward` from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # the head merge after the forward hands the cotangent back
        # transposed; both paths take it in contiguous rows
        grads = _flash_backward(q, k, v, o, lse, g.contiguous(),
                                causal=ctx.causal, scale=ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention: online softmax with fp32 state, causal masking with
    diagonal offset ``sk - sq``, fully-masked rows 0; differentiable.

    Without ``mask`` the forward and backward launch the Hopper kernels on
    CUDA tensors (or raise) and run their plain versions on CPU tensors.
    With ``mask`` it takes :func:`blockwise_attention`, as the JAX function
    does; that route runs no kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is not None:
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   mask=mask)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
