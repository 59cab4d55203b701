"""The host side of the tensor-core conv kernel (``csrc/conv3x3_tc.cu``) on
the CPU: the plan that cuts each conv into tiles and K ranges, how the
input is staged, and why fp32 takes three TF32 products.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what it is told to do is decided here, in Python, and checked at every
ResNet-18 site, at the JAX conv bench's shapes and at the ragged shapes.
"""

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.ops import _kernels

# resnet18_tiny_imagenet's 3x3 stride-1 sites at B=32 (stem, layers 1-4),
# the JAX conv bench's shapes (benchmarks/bench_pallas_conv.py, B=256) and
# the ragged shapes of the card tests and chip_smoke.py
MODEL = [(32, 64, 64, 3, 32), (32, 32, 32, 32, 64), (32, 32, 32, 64, 64),
         (32, 16, 16, 128, 128), (32, 8, 8, 256, 256), (32, 4, 4, 512, 512)]
BENCH = [(256, 64, 64, 64, 64), (256, 32, 32, 128, 128),
         (256, 16, 16, 256, 256), (256, 8, 8, 512, 512)]
RAGGED = [(4, 8, 8, 8, 16), (4, 6, 10, 4, 8), (2, 5, 5, 3, 4), (3, 7, 9, 8, 8),
          (2, 16, 16, 70, 72), (2, 12, 20, 64, 64), (1, 4, 4, 512, 130),
          (1, 1, 1, 1, 1), (5, 3, 130, 16, 8)]
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("prologue", [False, True], ids=["conv", "bnrelu"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", MODEL + BENCH + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_pixel_and_unit_once(shape, dtype, prologue):
    n, h, w, cin, cout = shape
    plan = _kernels.conv_plan(n, h, w, cin, cout, dtype, prologue=prologue)
    # tiles: b x th x tw = 128 or (bf16 conv) 256 pixels, 64-row wgmma slabs
    wide = dtype == torch.bfloat16 and not prologue
    assert plan.mw in ((1, 2) if wide else (1,))
    assert plan.b * plan.th * plan.tw == _kernels.TILE_PIXELS * plan.mw
    assert (plan.b * plan.th * plan.tw) % 64 == 0
    assert plan.halo_rows == plan.b * (plan.th + 2) * (plan.tw + 2)
    assert plan.halo_rows <= _kernels.MAX_HALO_ROWS
    tb, ty, tx = (-(-n // plan.b), -(-h // plan.th), -(-w // plan.tw))
    assert plan.tiles_m == tb * ty * tx
    seen = np.zeros((n, h, w), dtype=np.int64)
    for b0 in range(0, tb * plan.b, plan.b):
        for y0 in range(0, ty * plan.th, plan.th):
            for x0 in range(0, tx * plan.tw, plan.tw):
                seen[b0:b0 + plan.b, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (seen == 1).all()
    # Cout tiles and the weight chunks
    assert plan.bn in (64, 128) and (plan.tiles_n - 1) * plan.bn < cout
    assert plan.tiles_n * plan.bn >= cout
    assert plan.chunk * (2 if dtype == torch.bfloat16 else 4) == 128
    assert plan.units == 9 * -(-cin // plan.chunk)
    # the K split: contiguous, non-empty ranges covering every (tap, chunk)
    ranges = plan.k_ranges()
    assert len(ranges) == plan.ksplit and 1 <= plan.ksplit <= plan.units
    units = [u for u0, u1 in ranges for u in range(u0, u1)]
    assert units == list(range(plan.units))
    assert all(u1 > u0 for u0, u1 in ranges)
    pairs = {(u % 9, u // 9) for u in units}
    assert len(pairs) == plan.units
    # one wave of work items where the tiles alone are fewer than the SMs
    tiles = plan.tiles_m * plan.tiles_n
    if tiles >= _kernels.CARD_SMS:
        assert plan.ksplit == 1
    else:
        assert tiles * plan.ksplit <= _kernels.CARD_SMS


def test_plan_shares_tiles_between_small_images_and_splits_layer4():
    """Layer4 at B=32: 4x4 images, 8 to a tile; 16 tiles of 132 SMs, so K
    is split 8 ways (128 work items)."""
    plan = _kernels.conv_plan(32, 4, 4, 512, 512, torch.bfloat16)
    assert (plan.b, plan.th, plan.tw, plan.mw) == (8, 4, 4, 1)
    assert (plan.tiles_m, plan.tiles_n, plan.ksplit) == (4, 4, 8)
    # B=256: 256-pixel tiles fill the card on their own
    big = _kernels.conv_plan(256, 64, 64, 64, 64, torch.bfloat16)
    assert (big.b, big.th, big.tw, big.mw, big.bn, big.ksplit) == (
        1, 16, 16, 2, 64, 1)
    assert _kernels.conv_plan(256, 64, 64, 64, 64, torch.float32).mw == 1
    # the BN prologue keeps 128-pixel tiles: its warps set the pace above
    assert _kernels.conv_plan(256, 64, 64, 64, 64, torch.bfloat16,
                              prologue=True).mw == 1


@pytest.mark.parametrize("cin,dtype,offset,unit", [
    (64, torch.bfloat16, 0, 0),    # 128-byte rows: TMA
    (8, torch.bfloat16, 0, 0),     # 16 bytes: TMA
    (4, torch.float32, 0, 0),
    (3, torch.float32, 0, 4),      # the stem: cp.async, 4-byte units
    (70, torch.float32, 0, 8),     # 280-byte rows
    (70, torch.bfloat16, 0, 4),    # 140-byte rows
    (4, torch.bfloat16, 0, 8),
    (3, torch.bfloat16, 0, 2),     # odd Cin in bf16: plain loads
    (64, torch.bfloat16, 1, 2),    # a view 2 bytes off: no TMA
    (64, torch.float32, 1, 4),
])
def test_copy_unit_picks_tma_where_the_layout_allows(cin, dtype, offset, unit):
    base = torch.zeros(2 * 3 * 3 * cin + offset, dtype=dtype)
    x = base[offset:].view(2, 3, 3, cin)
    assert _kernels._copy_unit(x) == unit


def test_plan_is_computed_once_per_shape():
    """A wrapper plans every call; the plan of a shape seen before comes
    from the cache."""
    plan = _kernels.conv_plan(32, 8, 8, 256, 256, torch.float32)
    hits = _kernels.conv_plan.cache_info().hits
    assert _kernels.conv_plan(32, 8, 8, 256, 256, torch.float32) is plan
    assert _kernels.conv_plan.cache_info().hits == hits + 1


def test_tile_format_reaches_the_kernel_build_from_one_place():
    """conv3x3_tc.cu takes the tile format the plan uses (TILE_FORMAT) from
    its build's -D flags and refuses to build without them; the diagnostic
    build adds its clock counters under a name and a library of its own,
    which the wrappers do not launch."""
    src = (_kernels.CSRC / "conv3x3_tc.cu").read_text()
    flags = _kernels._flags("conv3x3_tc.cu")
    for key, value in _kernels.TILE_FORMAT.items():
        assert f"-D{key}={value}" in flags
        assert f"defined({key})" in src
    assert (_kernels.TILE_PIXELS, _kernels.ROW_BYTES, _kernels.MAX_HALO_ROWS
            ) == tuple(_kernels.TILE_FORMAT.values())
    trace = _kernels._flags(_kernels.CONV_TC_TRACE)
    assert "-DCONV_TC_TRACE" in trace and "-DCONV_TC_TRACE" not in flags
    assert set(flags) < set(trace)
    assert _kernels.CONV_TC_TRACE not in _kernels.SOURCES
    assert (_kernels._lib_path(_kernels.CONV_TC_TRACE)
            != _kernels._lib_path("conv3x3_tc.cu"))


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_fp32_takes_three_tf32_products():
    """At a layer4 site (K = 9 x 512 = 4608) the kernel's fp32 split, hi =
    tf32(x), lo = tf32(x - hi), summed as lo*hi + hi*lo + hi*hi, stays
    within 1e-5 of the fp64 product (relative to its largest value); one
    TF32 product (what TF32 convolutions do) misses 1e-4, the card
    tolerance at parity precision."""
    rng = np.random.default_rng(7)
    a = np.maximum(rng.normal(size=(256, 4608)), 0).astype(np.float32)
    w = (rng.normal(size=(4608, 64)) / np.sqrt(4608)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    at, wt = torch.from_numpy(a), torch.from_numpy(w)
    a_hi, w_hi = _tf32(at), _tf32(wt)
    a_lo, w_lo = _tf32(at - a_hi), _tf32(wt - w_hi)
    assert (a_hi.view(torch.int32) & 0x1FFF).eq(0).all()  # 10 mantissa bits
    top = np.abs(ref).max()
    three = (a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi).double().numpy()
    one = (a_hi @ w_hi).double().numpy()
    assert np.abs(three - ref).max() / top <= 1e-5
    assert np.abs(one - ref).max() / top > 1e-4
