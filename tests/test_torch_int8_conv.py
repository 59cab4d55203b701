"""The int8 conv kernel's host side and the fused int8 conv layer on the
CPU: ``_kernels.conv_int8_plan`` (the tiling of ``csrc/conv_int8.cu``) at
every ResNet-18 Tiny-ImageNet conv site for B in {1, 8, 32, 256}, at the
ragged shapes ``chip_smoke.py`` runs and at the stem; the packed weight
layout; the halo boxes the kernel stages; a numpy mirror of the
kernel's quantize prologue (its fast path beside the division) against
``quantize_symmetric``; ``quant_conv2d_reference`` against the JAX layer
``QuantConv2DLayer.apply`` from the same numpy inputs; and the layer's
operands packed once.

Tolerances: the int8 inputs and the int32 sums are held bit for bit. The
float output within ``BIAS_ULP`` units in the last place of the larger of
the output and the product ``y_i32 · scale``: XLA contracts the
dequantize's ``y · scale + b`` into a fused multiply-add, which skips the
product's rounding (``tests/test_torch_quantize.py`` states the same
budget for the folded bias); bf16 outputs within one bf16 unit of that.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.nn.quantize import QuantConv2DLayer as JaxQuantConv
from dcnn_tpu.ops import conv2d_int8 as jax_conv2d_int8
from dcnn_tpu.ops import quant as jquant
from dcnn_tpu_torch.models import create_model
from dcnn_tpu_torch.nn import Conv2DLayer, QuantConv2DLayer
from dcnn_tpu_torch.ops import _kernels, quant
from dcnn_tpu_torch.ops.conv import conv2d_int8_reference

BIAS_ULP = 4
SMS = _kernels.CARD_SMS

# resnet18_tiny_imagenet's 21 conv sites at a 64x64 input, in forward
# order: (Cin, H, W, Cout, k, stride, pad) of each conv's input
RESNET18_SITES = [(3, 64, 64, 32, 3, 1, 1)]
for _cin, _cout, _hw, _s in ((32, 64, 32, 1), (64, 64, 32, 1),
                             (64, 128, 32, 2), (128, 128, 16, 1),
                             (128, 256, 16, 2), (256, 256, 8, 1),
                             (256, 512, 8, 2), (512, 512, 4, 1)):
    _out = _hw // _s
    RESNET18_SITES += [(_cin, _hw, _hw, _cout, 3, _s, 1),
                       (_cout, _out, _out, _cout, 3, 1, 1)]
    if _cin != _cout:
        RESNET18_SITES.append((_cin, _hw, _hw, _cout, 1, _s, 0))
# chip_smoke.py's INT8_RAGGED: (N, Cin, H, W, Cout, k, stride, pad)
RAGGED = [(3, 3, 13, 11, 70, 3, 1, 1), (2, 17, 9, 9, 33, 3, 2, 1),
          (5, 40, 7, 5, 9, 1, 2, 0), (1, 16, 28, 28, 8, 5, 1, 0),
          (2, 64, 12, 12, 130, 7, 2, 3), (4, 96, 6, 6, 64, 1, 1, 0)]


def test_sites_are_the_models_convs():
    """RESNET18_SITES are the zoo model's 21 convs in forward order."""
    model = create_model("resnet18_tiny_imagenet", "NHWC").init(
        generator=torch.Generator().manual_seed(0), device="cpu").eval()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(
            (args[0].shape[3], args[0].shape[1], args[0].shape[2],
             mod.out_channels, mod.kernel_size[0], mod.stride[0],
             mod.padding[0])))
        for m in model.modules() if isinstance(m, Conv2DLayer)]
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    for h in hooks:
        h.remove()
    assert seen == RESNET18_SITES


def _check_plan(plan, n, c, h, w, o, k, stride, pad, channels_last,
                dtype=torch.float32):
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    assert plan.smem == _kernels.int8_smem(plan.bn, plan.stages, plan.halo)
    assert plan.smem <= _kernels.SMEM_MAX
    assert 2 <= plan.stages <= _kernels.INT8_MAX_STAGES
    assert plan.bn == (64 if o <= 64 else 128)
    assert plan.tiles_m == -(-n * p * q // 128)
    assert plan.tiles_n == -(-o // plan.bn)
    cs = 128 if c > 128 and c % 128 == 0 else c
    assert plan.chunks == c // cs * -(-k * k * cs // 128)
    # the halo: for kernels of more than one tap whose every box fits
    need = _kernels.int8_halo_bytes(n, c, h, w, k, k, stride, pad)
    if k > 1 and need <= _kernels.INT8_HALO_MAX and dtype != torch.int8:
        assert need <= plan.halo <= _kernels.INT8_HALO_MAX
        # 2 stages for each copying warpgroup: a warpgroup's consecutive
        # fills never share a stage
        assert plan.halo % 1024 == 0 and plan.stages == 4
    else:
        assert plan.halo == 0
    tiles = plan.tiles_m * plan.tiles_n
    if tiles >= SMS:
        assert plan.ksplit == 1
    else:  # one wave, no empty range
        assert plan.works <= SMS and 1 <= plan.ksplit <= plan.chunks
    ranges = plan.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.chunks
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    # the 16-byte unit copies need 16 contiguous channels a unit
    assert plan.copy == ("vec" if channels_last and c % 16 == 0 else "gather")


@pytest.mark.parametrize("batch", [1, 8, 32, 256])
@pytest.mark.parametrize("site", range(len(RESNET18_SITES)))
def test_conv_int8_plan_at_resnet18_sites(site, batch):
    c, h, w, o, k, s, pad = RESNET18_SITES[site]
    plan = _kernels.conv_int8_plan(batch, c, h, w, o, k, k, s, pad,
                                   torch.float32)
    _check_plan(plan, batch, c, h, w, o, k, s, pad, True)


def test_conv_int8_plan_splits_the_deep_b32_sites():
    """At B=32 layer 4's 3x3 convs have 16 tiles of 128x128: K (36 chunks)
    is split 8 ways, 128 work items on 132 SMs; layer 1 is not split."""
    deep = _kernels.conv_int8_plan(32, 512, 4, 4, 512, 3, 3, 1, 1,
                                   torch.float32)
    assert (deep.tiles_m, deep.tiles_n, deep.chunks, deep.ksplit) == (
        4, 4, 36, 8)
    assert _kernels.conv_int8_plan(32, 64, 32, 32, 64, 3, 3, 1, 1,
                                   torch.float32).ksplit == 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", range(len(RAGGED)))
def test_conv_int8_plan_at_ragged_shapes(case, layout, dtype):
    n, c, h, w, o, k, s, pad = RAGGED[case]
    plan = _kernels.conv_int8_plan(n, c, h, w, o, k, k, (s, s), (pad, pad),
                                   dtype, channels_last=layout == "NHWC")
    _check_plan(plan, n, c, h, w, o, k, s, pad, layout == "NHWC", dtype)


def test_conv_int8_plan_stem_and_refusals():
    """The stem (C = 3, K = 27) is one chunk, padded with zeros, gathered;
    forced splits are taken as given and refused past the chunks."""
    stem = _kernels.conv_int8_plan(1, 3, 64, 64, 32, 3, 3, 1, 1,
                                   torch.float32)
    assert (stem.chunks, stem.ksplit, stem.copy, stem.bn) == (1, 1, "gather",
                                                              64)
    assert _kernels.conv_int8_plan(256, 512, 4, 4, 512, 3, 3, 1, 1,
                                   torch.int8, ksplit=36).ksplit == 36
    with pytest.raises(ValueError, match="split"):
        _kernels.conv_int8_plan(1, 3, 64, 64, 32, 3, 3, 1, 1, torch.float32,
                                ksplit=2)
    with pytest.raises(ValueError, match="empty"):
        _kernels.conv_int8_plan(1, 3, 2, 2, 32, 3, 3, 1, 0, torch.float32)
    with pytest.raises(TypeError):
        _kernels.conv_int8_plan(1, 3, 8, 8, 32, 3, 3, 1, 1, torch.float64)


@pytest.mark.parametrize("o,c,k", [(32, 3, 3), (64, 32, 1), (70, 17, 3),
                                   (130, 64, 7), (9, 40, 1), (512, 512, 3),
                                   (256, 256, 1), (8, 384, 3)])
def test_packed_weights_unpack_to_oihw_with_zero_tails(o, c, k):
    rng = np.random.default_rng(o + c + k)
    w = torch.from_numpy(rng.integers(-127, 128, (o, c, k, k), dtype=np.int8))
    wk = _kernels.pack_int8_weight(w)
    cs = _kernels.int8_slice(c)
    kslice = k * k * cs
    kpad = -(-kslice // 128) * 128
    bn = _kernels.int8_cout_tile(o)
    assert cs == (128 if c in (256, 384, 512) else c)
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert wk.shape == (-(-o // bn) * bn, c // cs * kpad)
    slices = wk.reshape(wk.shape[0], c // cs, kpad)
    assert torch.equal(slices[:o, :, :kslice].reshape(o, c // cs, k, k, cs)
                       .permute(0, 1, 4, 2, 3).reshape(o, c, k, k), w)
    assert not slices[:, :, kslice:].any() and not wk[o:].any()


def _halo_boxes(n, h, w, r, s, stride, pad):
    """Per 128-pixel tile, the box conv_int8.cu's halo_box stages: (first
    image, images, first input row, rows)."""
    p = (h + 2 * pad - r) // stride + 1
    q = (w + 2 * pad - s) // stride + 1
    m, pq = n * p * q, p * q
    for m0 in range(0, m, 128):
        m1 = min(m0 + 128, m) - 1
        n0, n1 = m0 // pq, m1 // pq
        lo, hi = -pad, (p - 1) * stride - pad + r - 1
        if n0 == n1:
            lo = (m0 - n0 * pq) // q * stride - pad
            hi = (m1 - n1 * pq) // q * stride - pad + r - 1
        lo, hi = max(lo, 0), min(hi, h - 1)
        yield m0, m1, n0, n1 - n0 + 1, lo, max(hi - lo + 1, 0)


@pytest.mark.parametrize("n,c,h,w,k,stride,pad", [
    (2, 16, 9, 7, 3, 1, 1), (3, 3, 13, 11, 3, 1, 1), (2, 17, 9, 9, 3, 2, 1),
    (2, 64, 12, 12, 7, 2, 3), (9, 32, 4, 4, 3, 1, 1), (1, 16, 28, 28, 5, 1, 0),
    (5, 16, 6, 6, 3, 2, 1)])
def test_halo_box_holds_every_input_a_tile_reads(n, c, h, w, k, stride, pad):
    """Every input pixel inside the image that a tile's rows read at any
    tap lies in the tile's box, and int8_halo_bytes is the largest box."""
    p = (h + 2 * pad - k) // stride + 1
    q = (w + 2 * pad - k) // stride + 1
    largest = 0
    for m0, m1, n0, imgs, lo, rows in _halo_boxes(n, h, w, k, k, stride, pad):
        largest = max(largest, imgs * rows * w)
        for m in range(m0, m1 + 1):
            img, pp, qq = m // (p * q), m % (p * q) // q, m % q
            for r in range(k):
                ih = pp * stride - pad + r
                if 0 <= ih < h and any(0 <= qq * stride - pad + s_ < w
                                       for s_ in range(k)):
                    assert n0 <= img < n0 + imgs and lo <= ih < lo + rows
    assert _kernels.int8_halo_bytes(n, c, h, w, k, k, stride, pad) == (
        largest * _kernels.int8_slice(c))


def _quant_mirror(x, s):
    """numpy mirror of conv_int8.cu's Quant: x times 1/s rounded down and
    up by 2^-20, each clamped to [-127, 127] and rounded half to even; the
    division only where the two disagree. Returns (q, divided)."""
    x, s = np.float32(x), np.float32(s)
    r = np.float32(1) / s
    lo = np.float32(r * np.float32(1 - 2 ** -20))
    hi = np.float32(r * np.float32(1 + 2 ** -20))
    a = np.rint(np.clip(x * lo, -127, 127))
    b = np.rint(np.clip(x * hi, -127, 127))
    div = a != b
    exact = np.rint(np.clip(x / s, -127, 127))
    return np.where(div, exact, a).astype(np.int8), div


@pytest.mark.parametrize("seed", range(4))
def test_kernel_quantize_fast_path_equals_quantize_symmetric(seed):
    """The prologue's fast path gives quantize_symmetric's int8 bit for
    bit: on values spread over the range and past the clamp, and on the
    hard ones, within a few ulps of every half-integer quotient (ties
    included), where it must fall back to the division."""
    rng = np.random.default_rng(seed)
    s = np.float32(rng.uniform(1e-3, 1.0) / 127)
    half = (np.arange(-130, 130, dtype=np.float32) + np.float32(0.5)) * s
    near = np.concatenate([np.nextafter(half, np.float32(np.inf)),
                           np.nextafter(half, np.float32(-np.inf)), half])
    for _ in range(3):
        near = np.concatenate([near, np.nextafter(near, np.float32(np.inf))])
    x = np.concatenate([rng.normal(0, 60 * s, 200_000).astype(np.float32),
                        near, np.float32([0, -0.0, 1e30, -1e30])])
    got, divided = _quant_mirror(x, s)
    want = quant.quantize_symmetric(torch.from_numpy(x),
                                    torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    assert divided[:200_000].mean() < 1e-3  # the fast path takes nearly all


def _layer_inputs(seed, n, cin, h, w, cout, k, layout):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, cin, h, w)).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return (x, np.float32(np.abs(x).max() / 127),
            rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8),
            rng.uniform(1e-3, 1e-2, cout).astype(np.float32),
            rng.normal(0, 1, cout).astype(np.float32))


GEOMETRIES = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (7, 2, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", GEOMETRIES)
def test_quant_conv2d_reference_equals_jax_layer(k, stride, pad, layout,
                                                 bias, dtype):
    x, xs, w, ws, b = _layer_inputs(k * 13 + stride, 2, 5, 11, 9, 7, k,
                                    layout)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    # the int8 input and the int32 sums, bit for bit
    xq = quant.quantize_symmetric(xt, torch.tensor(xs))
    xqj = jquant.quantize_symmetric(xj, jnp.float32(xs))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xqj))
    acc = conv2d_int8_reference(xq, torch.from_numpy(w), stride=stride,
                                padding=pad, data_format=layout)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax_conv2d_int8(
        xqj, jnp.asarray(w), stride=stride, padding=pad,
        data_format=layout)))
    # the layer's output
    got = quant.quant_conv2d_reference(
        xt, torch.tensor(xs), torch.from_numpy(w), torch.from_numpy(ws),
        torch.from_numpy(b) if bias else None, stride=stride, padding=pad,
        data_format=layout)
    layer = JaxQuantConv(7, k, stride, pad, use_bias=bias, in_channels=5,
                         data_format=layout)
    params = {"w_q": jnp.asarray(w), "w_scale": jnp.asarray(ws),
              "x_scale": jnp.float32(xs)}
    if bias:
        params["b"] = jnp.asarray(b)
    want, _ = layer.apply(params, {}, xj)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    ch = 1 if layout == "NCHW" else 3
    shape = [1] * 4
    shape[ch] = -1
    prod = np.abs(acc.numpy().astype(np.float32)
                  * (np.float32(xs) * ws).reshape(shape))
    tol = BIAS_ULP * np.spacing(np.maximum(np.abs(want), prod))
    if dtype == "bfloat16":
        tol = tol + np.abs(want) * 2.0 ** -7
    assert (np.abs(got - want) <= tol).all()


def _layer(layout="NHWC", seed=0):
    rng = np.random.default_rng(seed)
    layer = QuantConv2DLayer(8, 3, 1, 1, True, 4, layout)
    layer.init((6, 6, 4) if layout == "NHWC" else (4, 6, 6), device="cpu")
    layer.set_quantized(
        torch.from_numpy(rng.integers(-127, 128, (8, 4, 3, 3),
                                      dtype=np.int8)),
        torch.from_numpy(rng.uniform(1e-3, 1e-2, 8).astype(np.float32)),
        torch.tensor(0.02), torch.from_numpy(rng.normal(size=8)
                                             .astype(np.float32)))
    return layer


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_layer_packs_once_and_repacks_after_load(layout):
    """Two forwards make one pack; the state_dict keeps the JAX keys; a
    load_state_dict (in-place writes) makes the next forward repack, and
    the operands follow the new weights."""
    layer = _layer(layout)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 6, 6, 4) if layout == "NHWC" else (2, 4, 6, 6))
        .astype(np.float32))
    y1 = layer(x)
    layer(x)
    assert layer.packs == 1
    assert set(layer.state_dict()) == {"w_q", "w_scale", "x_scale", "b"}
    assert torch.equal(y1, quant.quant_conv2d_reference(
        x, layer.x_scale, layer.w_q, layer.w_scale, layer.b, stride=1,
        padding=1, data_format=layout))
    other = _layer(layout, seed=5)
    layer.load_state_dict(other.state_dict())
    y2 = layer(x)
    assert layer.packs == 2
    assert torch.equal(y2, other(x))
    wk, scale = layer.kernel_operands()
    assert layer.packs == 2
    assert torch.equal(wk, _kernels.pack_int8_weight(other.w_q))
    assert torch.equal(scale, other.x_scale * other.w_scale)


def test_quant_conv2d_on_cpu_is_the_plain_chain():
    """On a CPU tensor quant_conv2d is the plain version, given operands
    or not, and launches nothing."""
    x, xs, w, ws, b = _layer_inputs(3, 2, 4, 7, 7, 6, 3, "NHWC")
    args = (torch.from_numpy(x), torch.tensor(xs), torch.from_numpy(w),
            torch.from_numpy(ws), torch.from_numpy(b))
    before = (_kernels.conv_int8_fused.launches, _kernels.conv_int8.launches)
    want = quant.quant_conv2d_reference(*args, stride=2, padding=1,
                                        data_format="NHWC")
    for packed in (None, (_kernels.pack_int8_weight(args[2]),
                          args[1] * args[3])):
        got = quant.quant_conv2d(*args, stride=2, padding=1,
                                 data_format="NHWC", packed=packed)
        assert torch.equal(got, want)
    assert (_kernels.conv_int8_fused.launches,
            _kernels.conv_int8.launches) == before
    with pytest.raises(ValueError, match="data_format"):
        quant.quant_conv2d(*args, data_format="NWHC")
