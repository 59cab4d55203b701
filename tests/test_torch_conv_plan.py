"""The host side of the tensor-core conv kernel (``csrc/conv3x3_tc.cu``) on
the CPU: the plan that cuts each conv (and its output-column-pair form)
into tiles and K ranges, how the input is staged, what the pairs form
gathers, and why fp32 takes three TF32 products.

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


def test_a_header_edit_changes_every_library_name(tmp_path, monkeypatch):
    """The sources include ``csrc/hopper.cuh``; a library's file name hashes
    every header of ``csrc/`` with its source, so an edited header is
    rebuilt, never loaded stale from ``_build/``."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    for name in ("conv3x3_tc.cu", "flash_fwd.cu"):
        assert '#include "hopper.cuh"' in (csrc / name).read_text()
    before = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert all(before[n] != after[n] for n in _kernels.SOURCES)
    assert "conv3x3.cu" not in _kernels.SOURCES  # the pairs form is a mode


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


# the pairs form's shapes (even W): layer1 of resnet18_tiny_imagenet, the
# bench's first shape, and the ragged ones, Cout 130 (260 lanes) among them
PAIRS = ([s for s in MODEL + BENCH if s[2] % 2 == 0 and s[4] <= 64]
         + [s for s in RAGGED if s[2] % 2 == 0] + [(3, 5, 6, 8, 130)])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", PAIRS, ids=lambda s: "x".join(map(str, s)))
def test_pairs_plan_covers_every_pair_and_unit_once(shape, dtype):
    """The pairs form's plan: 128-pair tiles (b × th × tp) whose halo box
    (b, th+2, 2·tp+2) stays within MAX_HALO_ROWS, tiles of the 2·Cout
    lanes, and K ranges over 12 taps × Cin chunks."""
    n, h, w, cin, cout = shape
    plan = _kernels.conv_plan(n, h, w, cin, cout, dtype, pairs=True)
    assert (plan.taps, plan.step, plan.mw) == (12, 2, 1)
    assert plan.b * plan.th * plan.tw == _kernels.TILE_PIXELS
    assert plan.halo_rows == plan.b * (plan.th + 2) * (2 * plan.tw + 2)
    assert plan.halo_rows <= _kernels.MAX_HALO_ROWS
    assert 2 * plan.tw + 2 <= 256  # a TMA box dimension
    tb, ty, tx = -(-n // plan.b), -(-h // plan.th), -(-(w // 2) // plan.tw)
    assert plan.tiles_m == tb * ty * tx
    seen = np.zeros((n, h, w // 2), dtype=np.int64)
    for b0 in range(0, tb * plan.b, plan.b):
        for y0 in range(0, ty * plan.th, plan.th):
            for x0 in range(0, tx * plan.tw, plan.tw):
                seen[b0:b0 + plan.b, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (seen == 1).all()
    lanes = 2 * cout
    assert plan.bn == (64 if lanes <= 64 else 128)
    assert (plan.tiles_n - 1) * plan.bn < lanes <= plan.tiles_n * plan.bn
    assert plan.units == 12 * -(-cin // plan.chunk)
    units = [u for u0, u1 in plan.k_ranges() for u in range(u0, u1)]
    assert units == list(range(plan.units))
    assert len({(u % 12, u // 12) for u in units}) == plan.units
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.ksplit == 1 if tiles >= _kernels.CARD_SMS else (
        tiles * plan.ksplit <= _kernels.CARD_SMS)


def _pairs_mirror(x, w2, plan):
    """What conv3x3_tc.cu computes in the pairs form, step by step in
    numpy (fp64): per tile and Cin chunk the halo box as staged (zero
    outside the image and beyond Cin; halo row (b·(th+2) + y)·hw + x,
    hw = 2·tp + 2), the weights packed K-major as (tap, lane, chunk) rows
    (tap = 4 r + j, zero beyond Cin and the lanes), and for unit (chunk,
    tap) the A row of pair p at tile row i of image b the halo row (b·(th
    + 2) + i + r)·hw + 2p + j; K ranges summed in split order; the (n, h,
    w/2, 2·Cout) result read as (n, h, w, Cout)."""
    n, h, w, cin = x.shape
    lanes = w2.shape[3]
    hw = 2 * plan.tw + 2
    ck = plan.chunk
    chunks = plan.units // 12
    kp = chunks * ck
    wpack = np.zeros((12, plan.tiles_n * plan.bn, kp))
    wpack[:, :lanes, :cin] = w2.reshape(12, cin, lanes).transpose(0, 2, 1)
    out = np.zeros((n, h, w // 2, lanes))
    tb, ty, tx = -(-n // plan.b), -(-h // plan.th), -(-(w // 2) // plan.tw)
    m = np.arange(plan.b * plan.th * plan.tw)
    tpix = plan.th * plan.tw
    img, row, col = m // tpix, (m % tpix) // plan.tw, m % plan.tw
    hrow0 = (img * (plan.th + 2) + row) * hw + 2 * col
    for bt in range(tb):
        for yt in range(ty):
            for xt in range(tx):
                halo = np.zeros((chunks, plan.b * (plan.th + 2) * hw, ck))
                for r in range(plan.b * (plan.th + 2) * hw):
                    bi = bt * plan.b + r // ((plan.th + 2) * hw)
                    iy = yt * plan.th + (r // hw) % (plan.th + 2) - 1
                    ix = xt * (hw - 2) + r % hw - 1
                    if bi < n and 0 <= iy < h and 0 <= ix < w:
                        for c in range(chunks):
                            v = x[bi, iy, ix, c * ck:(c + 1) * ck]
                            halo[c, r, :v.shape[0]] = v
                acc = np.zeros((len(m), plan.tiles_n * plan.bn))
                for u0, u1 in plan.k_ranges():
                    part = np.zeros_like(acc)
                    for u in range(u0, u1):
                        c, tap = u // 12, u % 12
                        a = halo[c, hrow0 + (tap // 4) * hw + tap % 4]
                        part += a @ wpack[tap, :, c * ck:(c + 1) * ck].T
                    acc += part
                ob, oy, ox = bt * plan.b + img, yt * plan.th + row, xt * plan.tw + col
                ok = (ob < n) & (oy < h) & (ox < w // 2)
                out[ob[ok], oy[ok], ox[ok]] = acc[ok, :lanes]
    return out.reshape(n, h, w, lanes // 2)


@pytest.mark.parametrize("shape", [(2, 5, 6, 3, 4), (3, 4, 18, 40, 9),
                                   (1, 3, 4, 70, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pairs_mirror_reproduces_the_plain_version(shape):
    """The A-row index and the weight packing of the pairs form, gathered
    with numpy, give conv3x3_pairs_reference for a random dense w2 (no
    zero blocks), with partial chunks, tiles and a K split."""
    from dcnn_tpu_torch.ops.pallas.conv import conv3x3_pairs_reference

    n, h, w, cin, cout = shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, h, w, cin))
    w2 = rng.normal(size=(3, 4, cin, 2 * cout))
    plan = _kernels.conv_plan(n, h, w, cin, cout, torch.float32, pairs=True)
    assert plan.ksplit > 1 or plan.units == 12
    got = _pairs_mirror(x, w2, plan)
    want = conv3x3_pairs_reference(torch.from_numpy(x),
                                   torch.from_numpy(w2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
