"""The host side of the tensor-core flash backward (``csrc/flash_bwd.cu``)
on the CPU: the plan that sizes both kernels' blocks, streamed tiles, stages
and shared memory; the register budget that picks the tiles; the tiles each
block visits, against the JAX package's ``_tile_geometry``; the head dim
padded to whole 128-byte chunks; and the op's copies for the kernels.

The kernels run only on the card (``tests/test_torch_cuda.py``); what they
are told to do is decided here, in Python, and the kernels refuse any other
plan.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.attention import _for_kernel

jax_attn = importlib.import_module("dcnn_tpu.ops.attention")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_smoke = importlib.import_module("chip_smoke")
# the cases with a backward: the fp32 backward takes D <= 128
FLASH_CASES = [c for c in _smoke.FLASH_CASES
               if not _smoke.bwd_refused(c[7], c[5])]

SHAPES = [(32, 32), (1, 1), (64, 64), (65, 65), (200, 10), (300, 429),
          (1000, 1000), (4096, 4096)]
HEAD_DIMS = list(range(1, 129))


def _parts(plan):
    return (("dq", plan.dq, True), ("dkv", plan.dkv, False))


@pytest.mark.parametrize("sq,sk", SHAPES, ids=lambda s: str(s))
@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
def test_flash_bwd_plan_fits_the_card_and_wgmma(dtype, d, sq, sk):
    """Both kernels: shared memory within a block's 232448 bytes; blocks of
    64 or 128 rows (one multiplying warpgroup each 64), 128 only where the
    block's own side exceeds 256; the streamed tile a power of two from 16
    to 128 (a whole number of wgmma N steps and K steps); stages from one
    up to FLASH_MAX_STAGES and the number of streamed tiles, as many as
    shared memory holds."""
    plan = _kernels.flash_bwd_plan(sq, sk, d, dtype)
    lay = _kernels._BwdLayout(_kernels.flash_head_class(d),
                              2 if dtype == torch.bfloat16 else 4)
    for name, part, dq in _parts(plan):
        own, other = (sq, sk) if dq else (sk, sq)
        assert part.smem <= _kernels.SMEM_MAX, name
        assert part.rows in (64, 128) and (part.rows == 64 or own > 256), name
        assert part.tile in (16, 32, 64, 128), name
        tiles = -(-other // part.tile)
        assert 1 <= part.stages <= min(_kernels.FLASH_MAX_STAGES, tiles), name
        assert part.smem == lay.smem(dq, part.rows, part.tile, part.stages)
        per_stage = (lay.smem(dq, part.rows, part.tile, part.stages + 1)
                     - part.smem)
        assert (part.stages in (_kernels.FLASH_MAX_STAGES, tiles)
                or part.smem + per_stage > _kernels.SMEM_MAX), name


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
def test_flash_bwd_tiles_follow_the_register_budget(dtype, d):
    """The streamed tile is the largest power of two up to 128 whose
    registers (accumulators, S and dP fragments, A operands) stay within
    FLASH_BWD_REG_BUDGET, halved further only while two stages would not
    fit beside a 64-row block."""
    plan = _kernels.flash_bwd_plan(4096, 4096, d, dtype)
    lay = _kernels._BwdLayout(d, 2 if dtype == torch.bfloat16 else 4)
    budget = _kernels.FLASH_BWD_REG_BUDGET
    for name, part, dq in _parts(plan):
        assert part.regs == lay.regs(dq, part.tile) <= budget, name
        reg_tile = lay.reg_tile(dq)
        assert reg_tile == 128 or lay.regs(dq, 2 * reg_tile) > budget, name
        assert part.tile <= reg_tile, name
        if part.tile < reg_tile:  # shrunk for two stages of shared memory
            assert lay.smem(dq, 64, 2 * part.tile, 2) > _kernels.SMEM_MAX
            assert lay.smem(dq, 64, part.tile, 2) <= _kernels.SMEM_MAX


def test_dkv_q_tile_shrinks_at_head_dim_128():
    """At D 128 two 64 x 128 fp32 accumulators (dK and dV) take 128 of a
    thread's registers: with the S^T and dP^T fragments of a 64-row q tile
    and its A operands that exceeds the budget in bf16, so the dK/dV
    kernel's q tile is 32 there, and 16 in fp32 (tf32 hi and lo operands);
    at D 64 it is 64 (bf16) and 32 (fp32); the dQ kernel, with one
    accumulator, keeps 64-key tiles in bf16."""
    bf, f32 = torch.bfloat16, torch.float32
    lay_bf = _kernels._BwdLayout(128, 2)
    assert lay_bf.regs(False, 64) > _kernels.FLASH_BWD_REG_BUDGET
    assert _kernels.flash_bwd_plan(4096, 4096, 128, bf).dkv.tile == 32
    assert _kernels.flash_bwd_plan(4096, 4096, 64, bf).dkv.tile == 64
    assert _kernels.flash_bwd_plan(4096, 4096, 128, f32).dkv.tile == 16
    assert _kernels.flash_bwd_plan(4096, 4096, 64, f32).dkv.tile == 32
    assert _kernels.flash_bwd_plan(4096, 4096, 128, bf).dq.tile == 64


@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
def test_every_head_dim_is_padded_to_whole_chunks(dtype):
    """Every D from 1 to 128 runs as its class (16, 32, 64 or 128), whose
    rows are whole 128-byte chunks in bf16 and whole 32-byte wgmma K steps
    in fp32 (classes 16 and 32 fill one chunk); the accumulators span the
    chunks; the op pads D to whole 16-byte units first (TMA's row rule);
    the forward's plan agrees on the chunks."""
    es = 2 if dtype == torch.bfloat16 else 4
    for d in HEAD_DIMS:
        dc = _kernels.flash_head_class(d)
        assert d <= dc and (dc == 16 or dc // 2 < d)
        plan = _kernels.flash_bwd_plan(100, 100, d, dtype)
        assert plan.chunks == -(-dc * es // _kernels.ROW_BYTES)
        assert plan.chunks * _kernels.ROW_BYTES >= d * es
        assert plan.padded == plan.chunks * _kernels.ROW_BYTES // es
        assert plan.chunks == _kernels.flash_plan(100, 100, d, dtype).chunks
        w = _kernels.flash_head_width(d, dtype)
        assert w * es % 16 == 0 and d <= w < d + 16 // es
        assert _kernels.flash_head_class(w) == dc
    with pytest.raises(ValueError, match="head dim 257"):
        _kernels.flash_head_class(257)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_bwd_live_tiles_are_the_tiles_with_an_allowed_pair(case):
    """At every geometry of chip_smoke.py's FLASH_CASES: the kv tiles the
    dQ kernel visits for a q block, and the q tiles the dK/dV kernel visits
    for a kv block, are exactly those holding at least one allowed (real q
    row, real key) pair, by a plain mask and by the JAX package's
    _tile_geometry, whose ``live`` they never exceed."""
    _, _, _, sq, sk, d, causal, dtn, _ = case
    plan = _kernels.flash_bwd_plan(sq, sk, d, getattr(torch, dtn))
    q_pos = np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    allowed = (k_pos <= q_pos + sk - sq) if causal else np.ones((sq, sk), bool)

    def jax_pairs(q0, bq, k0, bkv):
        live, mask = jax_attn._tile_geometry(q0, k0, bq, bkv, sk, sq, causal)
        real = np.asarray(mask) & (q0 + np.arange(bq) < sq)[:, None]
        if real.any():
            assert bool(live)
        return real.any()

    bq, bkv = plan.dq.rows, plan.dq.tile
    for qb in range(-(-sq // bq)):
        got = set(plan.kv_tiles(qb, sq, sk, causal))
        plain = {t for t in range(-(-sk // bkv)) if allowed[
            qb * bq:(qb + 1) * bq, t * bkv:(t + 1) * bkv].any()}
        assert got == plain, (qb, got, plain)
        assert got == {t for t in range(-(-sk // bkv))
                       if jax_pairs(qb * bq, bq, t * bkv, bkv)}
    bq, bkv = plan.dkv.tile, plan.dkv.rows
    for kb in range(-(-sk // bkv)):
        got = set(plan.q_tiles(kb, sq, sk, causal))
        plain = {t for t in range(-(-sq // bq)) if allowed[
            t * bq:(t + 1) * bq, kb * bkv:(kb + 1) * bkv].any()}
        assert got == plain, (kb, got, plain)
        assert got == {t for t in range(-(-sq // bq))
                         if jax_pairs(t * bq, bq, kb * bkv, bkv)}


@pytest.mark.parametrize("sq,sk", SHAPES, ids=lambda s: str(s))
def test_class_256_bwd_plans_fit_and_groups_cover_d(sq, sk):
    """bf16 at class 256: both kernels' plans within shared memory and the
    register budget; dQ in one group (a 32-key tile fits beside its 64 x
    256 accumulator), dK/dV in two groups of 128 columns (two 64 x 256
    accumulators alone would take 256 registers), which cover the padded
    head dim once; every D from 129 to 256 runs as the class."""
    lay = _kernels._BwdLayout(256, 2)
    for d in (136, 192, 200, 256):
        plan = _kernels.flash_bwd_plan(sq, sk, d, torch.bfloat16)
        assert (plan.chunks, plan.padded) == (4, 256)
        for name, part, dq in _parts(plan):
            assert part.smem <= _kernels.SMEM_MAX, name
            assert part.smem == lay.smem(dq, part.rows, part.tile,
                                         part.stages), name
            assert part.regs == lay.regs(dq, part.tile, part.groups) \
                <= _kernels.FLASH_BWD_REG_BUDGET, name
            cols = plan.padded // part.groups
            covered = sorted(c for g in range(part.groups)
                             for c in range(g * cols, (g + 1) * cols))
            assert covered == list(range(plan.padded)), name
        assert (plan.dq.groups, plan.dq.tile) == (1, 32)
        assert (plan.dkv.groups, plan.dkv.tile) == (2, 32)
        assert lay.regs(False, 16, 1) > _kernels.FLASH_BWD_REG_BUDGET


@pytest.mark.parametrize("d", [136, 256])
def test_fp32_bwd_above_class_128_is_refused(d):
    """fp32 at class 256: the fixed operands alone (Q and dO, or K and V,
    as tf32 hi and lo over 64 rows) fill 256 KB, above a block's shared
    memory, so there is no plan; the error names the limit."""
    lay = _kernels._BwdLayout(256, 4)
    assert lay.smem(True, 64, 16, 0) - 1024 - 256 == 4 * 64 * 1024
    with pytest.raises(ValueError, match="shared memory.*up to 128"):
        _kernels.flash_bwd_plan(100, 100, d, torch.float32)


def test_op_copies_only_what_the_kernels_cannot_take():
    """``_for_kernel``: a contiguous, aligned tensor of the kernels' width
    is passed as it is; a strided view is made contiguous, a view off
    16-byte alignment is copied, and a narrower head dim is padded with
    zero columns."""
    x = torch.randn(2, 3, 10, 8)
    assert _for_kernel(x, 8) is x
    t = x.transpose(1, 2)
    c = _for_kernel(t, 8)
    assert c.is_contiguous() and torch.equal(c, t)
    flat = torch.empty(x.numel() + 1)
    off = flat[1:].view(x.shape)
    off.copy_(x)
    assert off.data_ptr() % 16
    a = _for_kernel(off, 8)
    assert a.data_ptr() % 16 == 0 and torch.equal(a, x)
    p = _for_kernel(x[..., :5], 8)
    assert p.shape == (2, 3, 10, 8) and p.is_contiguous()
    assert torch.equal(p[..., :5], x[..., :5])
    assert torch.equal(p[..., 5:], torch.zeros(2, 3, 10, 3))
