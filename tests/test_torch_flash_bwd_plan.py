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
FLASH_CASES = list(_smoke.FLASH_CASES)

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
    the forward's plan agrees on the chunks. Above 256 a head dim runs as
    the next multiple of 128, the wide backward kernels' column groups."""
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
    assert [_kernels.flash_head_class(d) for d in (257, 320, 384, 1000)] == [
        384, 384, 384, 1024]
    with pytest.raises(ValueError, match="head dim 0"):
        _kernels.flash_head_class(0)


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


def _wide_dkv_smem(es, d, stages):
    """flash_bwd.cu ``WideBwd`` spelled out: 1024 bytes of alignment slack;
    K and V of 64 keys held where two stages fit beside them (bf16 only);
    per stage a slice (Q's and dO's q-tile rows of one or two 128-byte
    chunks, two where the chunks pair up, after K's and V's 64 rows where
    those stream; fp32: their tf32 lo) or a group unit (Q's and dO's 128
    group columns; fp32: Q^T and dO^T as tf32 hi and lo, a 128-byte row per
    column for each 32 q rows), whichever is larger, and its q tile's lse
    and delta; the exchanged S^T and dP^T fragments; 256 bytes of barriers.
    Returns (smem, held)."""
    f32 = es == 4
    tile, row = (16 if f32 else 32), _kernels.ROW_BYTES
    chunks = -(-d * es // row)
    sc = 1 if chunks % 2 else 2
    group = 2 * (128 * es // row) * tile * row + (
        4 * 128 * row if f32 else 0)

    def total(held, n):
        unit = (2 if f32 else 1) * sc * 2 * (tile + (0 if held else 64)) * row
        return (1024 + (2 * chunks * 64 * row if held else 0)
                + n * (max(unit, group) + 8 * tile) + 2 * 64 * tile * 4 + 256)

    held = not f32 and total(True, 2) <= _kernels.SMEM_MAX
    return total(held, stages), held


def _wide_dq_smem(es, d, stages):
    """flash_bwd.cu ``WideDq`` spelled out: 1024 bytes of alignment slack;
    Q and dO of 64 q rows held where two stages fit beside them (bf16
    only); per stage a slice (K's and V's kv-tile rows of one 128-byte
    chunk, after Q's and dO's 64 rows where those stream; fp32: their tf32
    lo) or a group unit (K's 128
    group columns; fp32: then K_g^T as tf32 hi and lo, a 128-byte row per
    column for each 32 keys), whichever is larger; the exchanged S and dP
    fragments; 256 bytes of barriers. kv tiles of 64 keys in bf16, 32 in
    fp32. Returns (smem, held)."""
    f32 = es == 4
    tile, row = (32 if f32 else 64), _kernels.ROW_BYTES
    chunks = -(-d * es // row)
    group = (128 * es // row) * tile * row + (2 * 128 * row if f32 else 0)

    def total(held, n):
        unit = (2 if f32 else 1) * 2 * (tile + (0 if held else 64)) * row
        return (1024 + (2 * chunks * 64 * row if held else 0)
                + n * max(unit, group) + 2 * 64 * tile * 4 + 256)

    held = not f32 and total(True, 2) <= _kernels.SMEM_MAX
    return total(held, stages), held


def _check_wide_dq(plan, es, d):
    """The wide dQ plan against its spelled-out layout: 64-row blocks, kv
    tiles of 64 keys (bf16) or 32 (fp32), a slice for every chunk, shared
    memory as ``WideDq`` lays it out and within a block's,
    two stages or more and as many as fit up to FLASH_MAX_STAGES, the
    registers (dQ's 64 x 128 fp32 group, the slice product, S and dP after
    the exchange, dS as A operand) within FLASH_BWD_REG_BUDGET, and groups
    of 128 columns covering d once. Returns whether Q and dO are held."""
    dq = plan.dq
    chunks = -(-d * es // 128)
    assert (dq.rows, dq.tile) == (64, 32 if es == 4 else 64)
    assert dq.slices == chunks
    smem, held = _wide_dq_smem(es, d, dq.stages)
    assert dq.smem == smem <= _kernels.SMEM_MAX
    assert 2 <= dq.stages <= _kernels.FLASH_MAX_STAGES
    assert (dq.stages == _kernels.FLASH_MAX_STAGES
            or _wide_dq_smem(es, d, dq.stages + 1)[0] > _kernels.SMEM_MAX)
    acc = 64 * 128 // 128  # dQ's group: 64 x 128 fp32, 128 threads
    frag = 64 * dq.tile // 128  # S or dP of a kv tile
    ops = dq.tile if es == 4 else dq.tile // 4  # dS (tf32 hi and lo)
    assert dq.regs == acc + 3 * frag + ops <= _kernels.FLASH_BWD_REG_BUDGET
    covered = sorted(c for g in range(dq.groups)
                     for c in range(g * 128, min(g * 128 + 128, d)))
    assert covered == list(range(d)) and dq.groups * 128 - d < 128
    return held


@pytest.mark.parametrize("d", [136, 256])
def test_fp32_bwd_above_class_128_is_refused(d):
    """fp32 at class 256: the wgmma kernels' fixed operands alone (Q and
    dO, or K and V, as tf32 hi and lo over 64 rows) fill 256 KB, above a
    block's shared memory, so that layout is refused and both kernels run
    their wide modes: dQ in 64-row blocks, 32-key tiles and two groups of
    128 columns, Q and dO streamed with every slice; dK/dV in 64-key
    blocks, 16-row q tiles and two groups, K and V streamed with every
    slice."""
    lay = _kernels._BwdLayout(256, 4)
    assert lay.smem(True, 64, 16, 0) - 1024 - 256 == 4 * 64 * 1024
    plan = _kernels.flash_bwd_plan(100, 100, d, torch.float32)
    assert (plan.chunks, plan.padded) == (8, 256)
    dq, dkv = plan.dq, plan.dkv
    assert dq.groups == 2 and not _check_wide_dq(plan, 4, d)
    chunks = -(-d * 4 // 128)
    assert (dkv.rows, dkv.tile, dkv.groups) == (64, 16, 2)
    assert dkv.slices == chunks // (1 if chunks % 2 else 2)
    assert dq.slices == chunks
    assert dkv.smem == _wide_dkv_smem(4, d, dkv.stages)[0] <= _kernels.SMEM_MAX
    assert not _wide_dkv_smem(4, d, dkv.stages)[1]


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


@pytest.mark.parametrize("d,dtype,n", [
    (192, torch.float32, 2), (320, torch.float32, 3),
    (320, torch.bfloat16, 3), (512, torch.float32, 4),
    (512, torch.bfloat16, 4), (1000, torch.float32, 8),
    (1000, torch.bfloat16, 8)])
def test_sliced_plans_fit_and_give_their_counts(d, dtype, n):
    """The plans the sliced dQ kernel once ran, now the wide modes (the
    fp32 backward at D 192; every kernel above 256): the class is the next multiple of 128; the dQ kernel's wide mode
    in n groups of 128 columns covering D once, 64-row blocks, a slice for
    every chunk, two stages or more, its shared memory and
    registers as its layout spells them; the dK/dV kernel's wide mode in n
    groups of 128 columns and a slice for every one or two chunks, two
    stages or more, its
    registers within the budget; the forward keeps its wgmma plan at D <=
    256 and takes its wide mode above."""
    dc = _kernels.flash_head_class(d)
    assert dc == n * _kernels.FLASH_GROUP and dc - 128 < d <= dc
    es = 4 if dtype == torch.float32 else 2
    bwd = _kernels.flash_bwd_plan(300, 200, d, dtype)
    assert bwd.padded == dc
    assert bwd.dq.groups == n
    _check_wide_dq(bwd, es, d)
    chunks = -(-d * es // 128)
    assert bwd.dq.slices == chunks
    assert bwd.dkv.groups == n and bwd.dkv.rows == 64
    assert bwd.dkv.slices == chunks // (1 if chunks % 2 else 2)
    assert 2 <= bwd.dkv.stages <= _kernels.FLASH_MAX_STAGES
    assert bwd.dkv.regs <= _kernels.FLASH_BWD_REG_BUDGET
    fwd = _kernels.flash_plan(300, 200, d, dtype)
    assert fwd.slices == (bwd.dkv.slices if d > 256 else 0)
    # the live tiles follow the same band rule: at offset sk - sq = -100,
    # q row 100 is the first that sees key 0
    t = bwd.dkv.tile
    assert list(bwd.kv_tiles(1, 300, 200, True)) == list(range(0, 1))
    assert list(bwd.q_tiles(0, 300, 200, True)) == list(range(
        100 // t, -(-300 // t)))


@pytest.mark.parametrize("d", [192, 256, 320, 512, 1000])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(2048, 2048), (300, 200), (40, 56)],
                         ids=str)
def test_wide_dkv_plans_fit_the_card(dtype, d, sq, sk):
    """The dK/dV kernel's wide mode where it runs (every D above 256, and
    fp32 above 128; bf16 at 192 and 256 keeps the class-256 kernel):
    shared memory as its layout spells it and within a block's, two stages
    or more and as many as fit up to FLASH_MAX_STAGES, registers (two
    64 x 128 fp32 accumulators, S^T and dP^T of a q tile, P^T and dS^T as
    A operands) within FLASH_BWD_REG_BUDGET, K and V held for the block
    exactly where two stages fit beside them (bf16 at D 320 and 512, not
    at 1000, never in fp32); the dQ part is the dQ kernel's wide mode."""
    es = 4 if dtype == torch.float32 else 2
    plan = _kernels.flash_bwd_plan(sq, sk, d, dtype)
    if d <= 256 and dtype == torch.bfloat16:
        assert (plan.dq.slices, plan.dkv.slices) == (0, 0)
        return
    dq, dkv = plan.dq, plan.dkv
    assert dq.slices > 0 and dq.groups == dkv.groups  # wide
    assert dkv.slices > 0 and (dkv.rows, dkv.tile) == (64, 16 if es == 4
                                                        else 32)
    smem, held = _wide_dkv_smem(es, d, dkv.stages)
    assert dkv.smem == smem <= _kernels.SMEM_MAX
    assert 2 <= dkv.stages <= _kernels.FLASH_MAX_STAGES
    assert (dkv.stages == _kernels.FLASH_MAX_STAGES
            or _wide_dkv_smem(es, d, dkv.stages + 1)[0] > _kernels.SMEM_MAX)
    assert held == (es == 2 and d in (320, 512))
    acc = 2 * 64 * 128 // 128  # dK and dV: 64 x 128 fp32 each, 128 threads
    frag = 2 * 64 * dkv.tile // 128  # S^T and dP^T
    ops = 2 * dkv.tile if es == 4 else dkv.tile // 2  # P^T, dS^T (tf32 hi, lo)
    assert dkv.regs == acc + frag + ops <= _kernels.FLASH_BWD_REG_BUDGET
    assert dkv.groups == -(-d // 128)


@pytest.mark.parametrize("d", [192, 256, 320, 512, 1000])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(2048, 2048), (300, 200), (40, 56)],
                         ids=str)
def test_wide_dq_plans_fit_the_card(dtype, d, sq, sk):
    """The dQ kernel's wide mode where it runs (every D above 256, and fp32
    above 128; bf16 at 192 and 256 keeps the class-256 kernel): shared
    memory as its layout spells it and within a block's, two stages or
    more and as many as fit up to FLASH_MAX_STAGES, registers within
    FLASH_BWD_REG_BUDGET, groups of 128 columns covering d once, Q and dO
    held for the block exactly where two stages fit beside them (bf16 at
    D 320 and 512, not at 1000, never in fp32); the plan does not depend
    on the sequence lengths."""
    es = 4 if dtype == torch.float32 else 2
    plan = _kernels.flash_bwd_plan(sq, sk, d, dtype)
    if d <= 256 and dtype == torch.bfloat16:
        assert plan.dq.slices == 0 and plan.dq.tile == 32
        return
    held = _check_wide_dq(plan, es, d)
    assert held == (es == 2 and d in (320, 512))
    assert plan.dq == _kernels.flash_bwd_plan(64, 64, d, dtype).dq


def _wide_dq_walk(q, k, v, o, lse, g, causal, scale, plan):
    """dQ as the wide dQ kernel computes it, walked in torch on the CPU from
    its plan: per 64-row q block the kv tiles of ``plan.dq.tile`` keys that
    ``plan.kv_tiles`` names; S and dP summed slice by slice over
    ``plan.dq.slices`` slices of d; P masked before the exponential; dS
    rounded to the input type per tile; dQ summed in fp32 in groups of 128
    columns and written once in the input type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    es = q.element_size()
    width = -(-d * es // 128) // plan.dq.slices * (128 // es)  # a slice
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    delta = (gf * o.float()).sum(-1)
    rows, tile = plan.dq.rows, plan.dq.tile
    dq = torch.zeros(b, h, sq, d)
    for qb in range(-(-sq // rows)):
        r0, r1 = qb * rows, min(qb * rows + rows, sq)
        for t in plan.kv_tiles(qb, sq, sk, causal):
            k0, k1 = t * tile, min(t * tile + tile, sk)
            s = torch.zeros(b, h, r1 - r0, k1 - k0)
            dp = torch.zeros_like(s)
            for c in range(plan.dq.slices):
                cols = slice(c * width, min(c * width + width, d))
                s += qf[..., r0:r1, cols] @ kf[..., k0:k1, cols].transpose(-1, -2)
                dp += gf[..., r0:r1, cols] @ vf[..., k0:k1, cols].transpose(-1, -2)
            s = s * scale - lse[..., r0:r1, None].float()
            if causal:
                allowed = (torch.arange(k0, k1)[None, :]
                           <= torch.arange(r0, r1)[:, None] + sk - sq)
                s = s.masked_fill(~allowed, -float("inf"))
            ds = (torch.exp(s) * (dp - delta[..., r0:r1, None]) * scale
                  ).to(q.dtype).float()
            for grp in range(plan.dq.groups):
                cols = slice(grp * 128, min(grp * 128 + 128, d))
                dq[..., r0:r1, cols] += ds @ kf[..., k0:k1, cols]
    return dq.to(q.dtype)


# the band edge of each type's kv tiles: the first q block's last row (63)
# sees exactly the first key of the third kv tile (offset sk - sq = tile + 1)
@pytest.mark.parametrize("d,dtype,sq,sk", [
    (320, torch.bfloat16, 100, 165), (192, torch.float32, 100, 133)],
    ids=["d320-bf16", "d192-fp32"])
def test_wide_dq_walk_matches_pallas_interpret(d, dtype, sq, sk):
    """The wide dQ plan walked in torch on the CPU (slices, kv tiles,
    groups) against the JAX package's ``_flash_backward`` dQ with its Pallas
    kernels in interpret mode, causal at the band edge of the plan's kv
    tiles; tolerances as tests/test_torch_flash_backward.py states them
    (fp32 1e-5: the same algorithm summed in another order; bf16 1e-2:
    both round dS and dQ to bf16)."""
    import jax.numpy as jnp

    plan = _kernels.flash_bwd_plan(sq, sk, d, dtype)
    assert plan.dq.slices and sk - sq == plan.dq.tile + 1
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rng = np.random.default_rng(d + sq + sk)
    q, k, v, g = (jnp.asarray(rng.normal(size=(1, 2, s, d)).astype(
        np.float32)).astype(jdt) for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    o, lse = jax_attn._flash_forward(q, k, v, causal=True, block_q=16,
                                     block_kv=16, scale=scale, interpret=True)
    want = jax_attn._flash_backward(q, k, v, o, lse, g, causal=True,
                                    block_q=16, block_kv=16, scale=scale,
                                    interpret=True)[0]

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                                ).to(dtype)

    lse = torch.from_numpy(np.array(lse[..., :sq], dtype=np.float32))
    got = _wide_dq_walk(t(q), t(k), t(v), t(o), lse, t(g), True, scale, plan)
    assert got.dtype == dtype
    tol = (dict(atol=1e-2, rtol=1e-2) if dtype == torch.bfloat16
           else dict(atol=1e-5, rtol=1e-5))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_grid_overflow_is_refused_naming_it():
    """Only a grid of 2^31 blocks or more is refused (B*H x 64-row tiles x
    128-column groups); the message names the product."""
    _kernels._check_grid("flash_fwd", 2 ** 20, 4096, 4096, 1000)
    with pytest.raises(ValueError, match="grid would overflow.*8 column groups"):
        _kernels._check_grid("flash_fwd", 2 ** 22, 8192, 8192, 1000)
