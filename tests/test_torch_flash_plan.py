"""The host side of the tensor-core flash forward (``csrc/flash_fwd.cu``)
on the CPU: the plan that sizes its blocks, kv tiles, stages and shared
memory, the kv tiles each q tile visits, and why fp32 takes three TF32
products for P·V.

The kernel runs only on the card (``tests/test_torch_cuda.py``); what it
is told to do is decided here, in Python. The live-tile check holds the
plan to the JAX package's ``_tile_geometry``, the mask its Pallas kernel
applies.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.ops import _kernels

jax_attn = importlib.import_module("dcnn_tpu.ops.attention")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLASH_CASES = importlib.import_module("chip_smoke").FLASH_CASES

SHAPES = [(32, 32), (1, 1), (64, 64), (65, 65), (100, 70), (77, 300),
          (200, 10), (1000, 1000), (4096, 4096), (300, 429)]


@pytest.mark.parametrize("sq,sk", SHAPES, ids=lambda s: str(s))
@pytest.mark.parametrize("d", _kernels.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
def test_flash_plan_fits_the_card_and_wgmma(dtype, d, sq, sk):
    """Shared memory within a block's 232448 bytes; q rows a multiple of
    64 (one multiplying warpgroup each); the kv tile a whole number of
    wgmma N steps (8) and K steps (16 keys bf16, 8 tf32) within N 256; two
    stages wherever there are two kv tiles (a pass holds the previous
    tile's stage while it waits for the next), except a serial plan: one
    stage of 64 rows, only where two stages do not fit beside 64 rows (fp32
    at class 256); O's columns in 1 or 2 groups of whole chunks."""
    plan = _kernels.flash_plan(sq, sk, d, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem <= _kernels.SMEM_MAX
    assert plan.q_rows in (64, 128) and plan.q_rows % 64 == 0
    assert plan.q_rows == 64 or sq > 64
    assert plan.kv_tile % 16 == 0 and 16 <= plan.kv_tile <= 256
    assert plan.chunks * _kernels.ROW_BYTES >= d * es
    assert plan.groups in (1, 2) and plan.chunks % plan.groups == 0
    tiles = -(-sk // plan.kv_tile)
    assert 1 <= plan.stages <= _kernels.FLASH_MAX_STAGES
    assert plan.stages <= tiles
    # the layout: Q (fp32: and its lo), then per stage K and the group's
    # columns of V as they land (fp32: K's lo, V^T as hi and lo, a 128-byte
    # row per column for each 32 keys), 1024 bytes of alignment slack and
    # 256 of barriers
    rows = plan.chunks * _kernels.ROW_BYTES
    f32 = dtype == torch.float32
    padded = plan.chunks * (_kernels.ROW_BYTES // es)
    stage = plan.kv_tile * rows * (2 if f32 else 1) + (
        plan.kv_tile * rows // plan.groups) + (
        2 * -(-plan.kv_tile // 32) * padded // plan.groups
        * _kernels.ROW_BYTES if f32 else 0)
    fixed = 1024 + plan.q_rows * rows * (2 if f32 else 1) + 256
    assert plan.smem == fixed + plan.stages * stage
    two_at_64 = 1024 + 64 * rows * (2 if f32 else 1) + 256 + 2 * stage
    assert plan.serial == (two_at_64 > _kernels.SMEM_MAX)
    if plan.serial:
        assert plan.stages == 1 and plan.q_rows == 64
    else:
        assert plan.stages >= min(2, tiles)
        # the largest block the card holds: one more stage would not fit,
        # or the ring is as deep as it goes
        assert (plan.stages in (_kernels.FLASH_MAX_STAGES, tiles)
                or plan.smem + stage > _kernels.SMEM_MAX)


@pytest.mark.parametrize("d", _kernels.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
def test_flash_groups_follow_registers_and_shared_memory(dtype, d):
    """O's columns in the fewest groups whose registers (O, S, P's A
    operand) stay within the budget and whose one stage fits beside 64 q
    rows: one group at every class up to 128, two at 256 (bf16 for the
    registers: O alone would take 128; fp32 for shared memory)."""
    plan = _kernels.flash_plan(4096, 4096, d, dtype)
    f32 = dtype == torch.float32
    padded = plan.chunks * _kernels.ROW_BYTES // (4 if f32 else 2)
    regs = _kernels.flash_fwd_regs(padded, plan.kv_tile, f32, plan.groups)
    assert regs <= _kernels.FLASH_BWD_REG_BUDGET
    assert plan.groups == (2 if d == 256 else 1)
    if dtype == torch.bfloat16 and d == 256:
        assert _kernels.flash_fwd_regs(padded, plan.kv_tile, False, 1) > \
            _kernels.FLASH_BWD_REG_BUDGET
    assert plan.serial == (f32 and d == 256)


def _wide_fwd_smem(es, d, q_rows, stages):
    """flash_fwd.cu ``Wide`` spelled out: 1024 bytes of alignment slack;
    per stage a slice unit (Q's q_rows rows and K's kv-tile keys of one or
    two 128-byte chunks, two where the head dim's chunks pair up; fp32:
    their tf32 lo) or a V unit (the group's 256 columns of V; fp32: then
    V^T as tf32 hi and lo, a 128-byte row per column for each 32 keys),
    whichever is larger; 256 bytes of barriers."""
    f32, row = es == 4, _kernels.ROW_BYTES
    kv = 32 if f32 else 64
    chunks = -(-d * es // row)
    sc = 1 if chunks % 2 else 2
    qk = (2 if f32 else 1) * sc * (q_rows + kv) * row
    v = 256 * es // row * kv * row + (2 * 256 * row if f32 else 0)
    return 1024 + stages * max(qk, v) + 256


@pytest.mark.parametrize("d", [264, 320, 512, 1000, 2048])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(2048, 2048), (300, 200), (40, 56),
                                   (64, 4096)], ids=str)
def test_wide_forward_plans_fit_the_card(dtype, d, sq, sk):
    """Above 256 the forward's wide mode: kv tiles of 64 keys (bf16) or 32
    (fp32), O in groups of 256 columns covering D once, S's contraction in
    one slice for every one or two chunks of D; shared memory as the layout
    spells it and within a block's; two stages or more, as many as fit up
    to FLASH_MAX_STAGES; 128 q rows a block above Sq 64; registers (O's
    group, S of a kv tile, P as the A operand) within
    FLASH_BWD_REG_BUDGET."""
    es = 4 if dtype == torch.float32 else 2
    plan = _kernels.flash_plan(sq, sk, d, dtype)
    chunks = -(-d * es // _kernels.ROW_BYTES)
    assert plan.kv_tile == (32 if es == 4 else 64) and not plan.serial
    assert plan.groups == -(-d // 256) and (plan.groups - 1) * 256 < d
    assert plan.slices == chunks // (1 if chunks % 2 else 2)
    assert plan.q_rows == (64 if sq <= 64 else 128)
    assert plan.smem == _wide_fwd_smem(es, d, plan.q_rows, plan.stages)
    assert plan.smem <= _kernels.SMEM_MAX
    assert 2 <= plan.stages <= _kernels.FLASH_MAX_STAGES
    assert (plan.stages == _kernels.FLASH_MAX_STAGES
            or _wide_fwd_smem(es, d, plan.q_rows, plan.stages + 1)
            > _kernels.SMEM_MAX)
    regs = 256 // 2 + plan.kv_tile // 2 + (
        plan.kv_tile if es == 4 else plan.kv_tile // 4)
    assert regs <= _kernels.FLASH_BWD_REG_BUDGET
    _kernels._check_grid("flash_fwd", 16, sq, sk, d)


# flash_plan and flash_bwd_plan as the previous head-dim classes' code gave
# them (q_rows, kv_tile, stages, smem, chunks | per backward kernel: rows,
# tile, stages, smem, regs): every D <= 128 keeps its plan
PARENT_PLANS = {
    ("fp32", 128, 4096, 4096): ((64, 32, 2, 230656, 4),
                                (64, 32, 1, 230656, 128),
                                (64, 16, 1, 230784, 176)),
    ("bf16", 128, 4096, 4096): ((128, 128, 3, 230656, 2),
                                (128, 64, 4, 197888, 144),
                                (128, 32, 4, 133376, 176)),
    ("bf16", 64, 4096, 4096): ((128, 128, 4, 148736, 1),
                               (128, 64, 4, 99584, 112),
                               (128, 64, 4, 101632, 160)),
    ("fp32", 64, 1000, 1000): ((128, 64, 2, 230656, 2),
                               (128, 32, 2, 230656, 96),
                               (64, 32, 2, 198400, 160)),
    ("fp32", 16, 32, 32): ((64, 64, 1, 58624, 1), (64, 64, 1, 83200, 144),
                           (64, 32, 1, 67072, 128)),
    ("bf16", 96, 300, 429): ((128, 128, 3, 230656, 2),
                             (128, 64, 4, 197888, 144),
                             (128, 32, 4, 133376, 176)),
    ("fp32", 48, 200, 10): ((128, 64, 1, 148736, 2), (64, 32, 1, 115968, 96),
                            (64, 32, 2, 198400, 160)),
    ("bf16", 8, 65, 65): ((128, 128, 1, 50432, 1), (64, 64, 2, 50432, 112),
                          (64, 64, 2, 51456, 160)),
}


@pytest.mark.parametrize("key", sorted(PARENT_PLANS), ids=str)
def test_plans_up_to_class_128_are_unchanged(key):
    dtn, d, sq, sk = key
    dt = torch.float32 if dtn == "fp32" else torch.bfloat16
    f, b = _kernels.flash_plan(sq, sk, d, dt), _kernels.flash_bwd_plan(
        sq, sk, d, dt)
    got = ((f.q_rows, f.kv_tile, f.stages, f.smem, f.chunks),
           *((p.rows, p.tile, p.stages, p.smem, p.regs) for p in (b.dq, b.dkv)))
    assert got == PARENT_PLANS[key]
    assert (f.groups, f.serial, b.dq.groups, b.dkv.groups) == (1, False, 1, 1)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_live_tiles_are_the_tiles_with_an_allowed_pair(case):
    """At every geometry of chip_smoke.py's FLASH_CASES, the kv tiles a q
    tile visits (FlashPlan.kv_tiles, what the kernel loops over) are
    exactly those holding at least one allowed (real q row, key) pair,
    by a plain mask and by the JAX package's _tile_geometry, whose
    ``live`` they never exceed."""
    _, _, _, sq, sk, d, causal, dtn, _ = case
    plan = _kernels.flash_plan(sq, sk, d, getattr(torch, dtn))
    bq, bkv = plan.q_rows, plan.kv_tile
    n_kv = -(-sk // bkv)
    q_pos = np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    allowed = (k_pos <= q_pos + sk - sq) if causal else np.ones((sq, sk), bool)
    for qt in range(-(-sq // bq)):
        got = set(plan.kv_tiles(qt, sq, sk, causal))
        plain = {t for t in range(n_kv)
                 if allowed[qt * bq:(qt + 1) * bq, t * bkv:(t + 1) * bkv].any()}
        assert got == plain, (qt, got, plain)
        jax_tiles = set()
        for t in range(n_kv):
            live, mask = jax_attn._tile_geometry(qt * bq, t * bkv, bq, bkv,
                                                 sk, sq, causal)
            real = np.asarray(mask) & (qt * bq + np.arange(bq) < sq)[:, None]
            if real.any():
                jax_tiles.add(t)
                assert bool(live)
        assert got == jax_tiles


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_fp32_pv_takes_three_tf32_products():
    """P·V as the fp32 kernel runs it: P in [0, 1] (after the softmax's
    exp) and V split into tf32 hi and lo, lo*hi + hi*lo + hi*hi over K =
    4096 keys, within 1e-5 of the fp64 product relative to its largest
    value; one TF32 product misses that by far."""
    rng = np.random.default_rng(11)
    p = rng.uniform(0, 1, size=(128, 4096)).astype(np.float32)
    v = rng.normal(size=(4096, 64)).astype(np.float32)
    ref = p.astype(np.float64) @ v.astype(np.float64)
    pt, vt = torch.from_numpy(p), torch.from_numpy(v)
    p_hi, v_hi = _tf32(pt), _tf32(vt)
    p_lo, v_lo = _tf32(pt - p_hi), _tf32(vt - v_hi)
    top = np.abs(ref).max()
    three = (p_lo @ v_hi + p_hi @ v_lo + p_hi @ v_hi).double().numpy()
    one = (p_hi @ v_hi).double().numpy()
    assert np.abs(three - ref).max() / top <= 1e-5
    assert np.abs(one - ref).max() / top > 1e-4
