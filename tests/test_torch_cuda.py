"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, and the training path run through the flash kernels.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the test). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without them; ``tests/conftest.py`` imports JAX, so
there run it without the conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: fp32 1e-4 (of the value, or of max |grad| for gradients, or
of max |output| for the convs): the same math summed in another order.
bf16 2e-2: outputs, and in the backward dS and P, are rounded to bf16's
8-bit mantissa. The scale/bias/ReLU kernel rounds as its plain version
does, so it is held to equality.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import ArrayDataLoader
from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
from dcnn_tpu_torch.nn import (
    DropoutLayer, MultiHeadAttentionLayer, SequentialBuilder,
)
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.attention import (
    flash_attention, flash_backward_reference, flash_forward_reference,
)
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.ops.pallas import conv as pconv
from dcnn_tpu_torch.ops.pallas import fused as pfused
from dcnn_tpu_torch.optim import SGD
from dcnn_tpu_torch.train import Trainer, create_train_state, make_train_step

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_smoke = importlib.import_module("chip_smoke")

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _launches():
    return (_kernels.flash_fwd.launches, _kernels.flash_bwd_dq.launches,
            _kernels.flash_bwd_dkv.launches)


def _arrays(seed, sq, sk, d, b=2, h=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk, sq))  # q, k, v, dO


def _flash_check(causal, sq, sk, d, dtype, b=2, h=3):
    """One forward launch against the plain version: O and logsumexp
    within TOL, fully-masked rows (causal, sq > sk) exactly 0 with
    logsumexp -1e30."""
    q, k, v, _ = (torch.from_numpy(a).to("cuda", dtype)
                  for a in _arrays(9, sq, sk, d, b, h))
    before = _kernels.flash_fwd.launches
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _kernels.flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b, h, sq)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]
    if causal and sq > sk:
        assert o[:, :, :sq - sk].abs().max().item() == 0.0
        assert (lse[:, :, :sq - sk] == -1e30).all()


@pytest.mark.parametrize("causal,sq,sk,d,dtype", [
    (False, 32, 32, 16, torch.float32),
    (True, 100, 70, 32, torch.float32),
    (True, 77, 300, 128, torch.float32),
    (True, 129, 129, 64, torch.bfloat16),
])
def test_flash_kernel_matches_plain_on_card(causal, sq, sk, d, dtype):
    """The forward kernel: O and logsumexp, one counted launch."""
    _flash_check(causal, sq, sk, d, dtype)


@pytest.mark.parametrize("d", _kernels.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,sq,sk", [
    (False, 200, 333),   # ragged: neither a multiple of the tiles
    (True, 150, 330),    # sq < sk
    (True, 300, 100),    # sq > sk: fully masked rows
    # band edges, diagonal offset = kv tile + 1: the first q tile's last
    # row sees exactly the first key of a kv tile (bf16, 128 rows and 128
    # keys: 127 + 129 = 256; fp32, 128 rows, 64 keys: 127 + 65 = 192; fp32
    # at D 128, 64 rows, 32 keys: 63 + 33 = 96)
    (True, 300, 429),
    (True, 300, 365),
    (True, 100, 133),
])
def test_flash_forward_every_head_dim_and_type(causal, sq, sk, d, dtype):
    _flash_check(causal, sq, sk, d, dtype, b=1, h=2)


def test_flash_forward_refuses_a_misaligned_view():
    """TMA reads 16-byte aligned rows: a contiguous view 4 bytes off is
    refused, not read wrong."""
    q, k, v, _ = (torch.from_numpy(a).cuda() for a in _arrays(2, 32, 32, 16))
    off = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    off.copy_(q)
    with pytest.raises(ValueError, match="q is not 16-byte aligned"):
        _kernels.flash_fwd(off, k, v, causal=False, scale=0.25)


def test_flash_forward_in_a_cuda_graph():
    """After its first call (which raises the shared-memory limit) the
    forward can be captured in a CUDA graph; replays give the eager
    answer."""
    q, k, v, _ = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                  for a in _arrays(11, 190, 190, 64))
    want, want_lse = _kernels.flash_fwd(q, k, v, causal=True, scale=0.125)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        o, lse = _kernels.flash_fwd(q, k, v, causal=True, scale=0.125)
    torch.cuda.current_stream().wait_stream(side)
    o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("causal,sq,sk,d,dtype", [
    (False, 32, 32, 16, torch.float32),
    (True, 100, 70, 32, torch.float32),
    (True, 100, 165, 32, torch.float32),  # band edge: diagonal offset 65
    (True, 77, 300, 128, torch.float32),
    (True, 129, 129, 64, torch.bfloat16),
])
def test_backward_kernels_match_plain_on_card(causal, sq, sk, d, dtype):
    """dQ and dK/dV kernels, one counted launch each; dQ of fully-masked
    rows exactly 0."""
    q, k, v, g = (torch.from_numpy(a).to("cuda", dtype)
                  for a in _arrays(9, sq, sk, d))
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale)
    delta = (g.float() * o.float()).sum(-1)
    before = _launches()
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal,
                               scale=scale)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal,
                                    scale=scale)
    torch.cuda.synchronize()
    assert _launches() == (before[0], before[1] + 1, before[2] + 1)
    want = flash_backward_reference(q, k, v, o, lse, g, causal=causal,
                                    scale=scale)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype] * ref.float().abs().max().item()
    if causal and sq > sk:
        assert dq[:, :, :sq - sk].abs().max().item() == 0.0


def test_pairs_kernel_reads_any_fused_weights():
    """A random dense w2 (3, 4, Cin, 2 Cout), no zero blocks: the kernel
    reads all 12 taps and all 2 Cout lanes as given, fp32 and bf16, with
    and without a K split (Cout 130: 260 lanes over three lane tiles)."""
    rng = np.random.default_rng(21)
    for n, h, w, cin, cout, dtype in [
            (2, 8, 16, 64, 64, torch.float32), (2, 8, 16, 64, 64, torch.bfloat16),
            (3, 5, 6, 8, 130, torch.float32), (2, 6, 10, 3, 4, torch.bfloat16),
            (32, 4, 4, 512, 64, torch.bfloat16)]:
        x = torch.from_numpy(rng.normal(size=(n, h, w, cin))).to("cuda", dtype)
        w2 = (torch.from_numpy(rng.normal(size=(3, 4, cin, 2 * cout)))
              / np.sqrt(12 * cin)).to("cuda", dtype)
        got = _kernels.conv3x3_s1_pairs(x, w2, out_dtype=dtype)
        want = pconv.conv3x3_pairs_reference(x, w2)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= TOL[dtype], (n, h, w, cin, cout, dtype)


def test_backward_kernels_refuse_what_they_cannot_take():
    q, k, v, g = (torch.from_numpy(a).cuda() for a in _arrays(1, 32, 32, 16))
    o, lse = _kernels.flash_fwd(q, k, v, causal=False, scale=0.25)
    delta = (g * o).sum(-1)
    with pytest.raises(ValueError, match="dO must be contiguous"):
        _kernels.flash_bwd_dq(q, k, v, g.transpose(2, 3).contiguous()
                              .transpose(2, 3), lse, delta, causal=False,
                              scale=0.25)
    with pytest.raises(ValueError, match="delta must be contiguous fp32"):
        _kernels.flash_bwd_dkv(q, k, v, g, lse, delta.double(), causal=False,
                               scale=0.25)
    with pytest.raises(ValueError, match="head dim 134"):
        wide = [torch.zeros(*t.shape[:3], 134, device="cuda")
                for t in (q, k, v, g)]
        _kernels.flash_bwd_dq(*wide, lse, delta, causal=False, scale=0.25)


def _backward_check(causal, sq, sk, d, dtype, b=2, h=3):
    """Both backward kernels at one shape against the plain version,
    relative to max |grad|; dQ of fully-masked rows exactly 0."""
    q, k, v, g = (torch.from_numpy(a).to("cuda", dtype)
                  for a in _arrays(9, sq, sk, d, b, h))
    scale = d ** -0.5
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=scale)
    delta = (g.float() * o.float()).sum(-1)
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal,
                               scale=scale)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal,
                                    scale=scale)
    torch.cuda.synchronize()
    want = flash_backward_reference(q, k, v, o, lse, g, causal=causal,
                                    scale=scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape, name
        assert _rel_err(got, ref) <= TOL[dtype], (name, _rel_err(got, ref))
    if causal and sq > sk:
        assert dq[:, :, :sq - sk].abs().max().item() == 0.0


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,sq,sk", [
    (False, 200, 333),   # ragged
    (True, 300, 100),    # sq > sk: fully masked rows
    (True, 150, 330),    # sq < sk
    (True, 300, 429),    # band edges of the forward's tiles
])
def test_backward_kernels_every_head_dim_and_type(causal, sq, sk, d, dtype):
    """Every head-dim class and type: each plan of flash_bwd_plan (the
    dK/dV q tile 16, 32 or 64, one to four stages) on the card."""
    _backward_check(causal, sq, sk, d, dtype, b=1, h=2)


@pytest.mark.parametrize("d", [8, 48, 96])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_take_any_head_dim(causal, d, dtype):
    """A head dim between the classes runs as its class, the columns
    beyond it the copy's zero fill: forward and both backward kernels."""
    _flash_check(causal, 150, 200, d, dtype, b=1, h=2)
    _backward_check(causal, 150, 200, d, dtype, b=1, h=2)


@pytest.mark.parametrize("d", [5, 8, 48, 96])
def test_flash_attention_any_head_dim_matches_cpu(d):
    """Through ``flash_attention``: a head dim whose rows are not whole
    16-byte units (5, fp32) is padded with zero columns before the launch
    and cut after; forward and gradients match the CPU's plain path."""
    q, k, v, w = _arrays(16, 40, 56, d, b=1, h=2)
    outs, grads = {}, {}
    for dev in ("cpu", "cuda"):
        qkv = [torch.from_numpy(a).to(dev).requires_grad_()
               for a in (q, k, v)]
        out = flash_attention(*qkv, causal=True)
        (out * torch.from_numpy(w).to(dev)).sum().backward()
        outs[dev], grads[dev] = out.detach().cpu(), [t.grad.cpu() for t in qkv]
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=1e-4,
                               rtol=1e-4)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_flash_attention_takes_strided_and_misaligned_views():
    """q, k and v as strided views (heads split out of a (B, S, H, D)
    tensor) and as a contiguous view 4 bytes off alignment: the op copies
    them for the kernels, which refuse such views themselves."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(3, 2, 48, 2, 32)).astype(
        np.float32))
    want = flash_attention(*(x[i].transpose(1, 2) for i in range(3)),
                           causal=True)
    xc = x.cuda()
    views = [xc[i].transpose(1, 2) for i in range(3)]
    assert not views[0].is_contiguous()
    with pytest.raises(ValueError, match="q must be contiguous"):
        _kernels.flash_fwd(*views, causal=True, scale=32 ** -0.5)
    torch.testing.assert_close(flash_attention(*views, causal=True).cpu(),
                               want, atol=1e-4, rtol=1e-4)
    flat = torch.empty(views[0].numel() + 1, device="cuda")
    off = flat[1:].view(views[0].shape)
    off.copy_(views[0])
    assert off.data_ptr() % 16
    torch.testing.assert_close(
        flash_attention(off, views[1].contiguous(), views[2].contiguous(),
                        causal=True).cpu(), want, atol=1e-4, rtol=1e-4)


def test_kernels_take_more_than_65535_heads():
    """B*H = 65537 at tiny S: the grid is 1-d, so every (batch*head)
    block runs; forward and both backward kernels against the plain
    version."""
    rng = np.random.default_rng(18)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(65537, 1, 8, 16)).astype(
        np.float32)).cuda() for _ in range(4))
    o, lse = _kernels.flash_fwd(q, k, v, causal=True, scale=0.25)
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True,
                                             scale=0.25)
    torch.cuda.synchronize()
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    delta = (g * o).sum(-1)
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=True,
                               scale=0.25)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True,
                                    scale=0.25)
    want = flash_backward_reference(q, k, v, o, lse, g, causal=True,
                                    scale=0.25)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("d", [136, 192, 200, 256])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,sq,sk", [
    (False, 200, 333),   # ragged
    (True, 150, 330),    # sq < sk
    (True, 300, 100),    # sq > sk: fully masked rows
])
def test_flash_head_dims_above_128(causal, sq, sk, d, dtype):
    """128 < D <= 256 runs as class 256: the forward in both types (O's
    columns in two groups; fp32 in serial passes of 16-key tiles)
    and both backward kernels in bf16 (dK/dV in two column groups), against
    the plain versions. The fp32 backward, whose fixed operands as tf32 hi
    and lo need more than a block's shared memory, runs the sliced kernels
    (two slices of 128 columns)."""
    _flash_check(causal, sq, sk, d, dtype, b=1, h=2)
    if dtype == torch.float32:
        assert _kernels.flash_bwd_plan(sq, sk, d, dtype).slices == 2
    _backward_check(causal, sq, sk, d, dtype, b=1, h=2)


def test_class_256_plans_as_launched():
    """The plans the kernels take at D 256, each launch counted once: bf16
    forward in 2 column groups of 64-row blocks and 2 stages of 128-key
    tiles; fp32 forward in 2 groups, serial (one stage of 16 keys); bf16 dQ in one
    group of 32-key tiles, dK/dV in 2 groups of 32-row q tiles."""
    fwd_bf = _kernels.flash_plan(1024, 1024, 256, torch.bfloat16)
    assert (fwd_bf.groups, fwd_bf.q_rows, fwd_bf.kv_tile, fwd_bf.stages,
            fwd_bf.serial) == (2, 64, 128, 2, False)
    fwd_32 = _kernels.flash_plan(1024, 1024, 256, torch.float32)
    assert (fwd_32.groups, fwd_32.q_rows, fwd_32.kv_tile, fwd_32.stages,
            fwd_32.serial) == (2, 64, 16, 1, True)
    bwd = _kernels.flash_bwd_plan(1024, 1024, 256, torch.bfloat16)
    assert (bwd.dq.groups, bwd.dq.tile, bwd.dkv.groups, bwd.dkv.tile) == (
        1, 32, 2, 32)
    before = _launches()
    _flash_check(True, 1024, 1024, 256, torch.float32, b=1, h=2)
    _backward_check(True, 1024, 1024, 256, torch.bfloat16, b=1, h=2)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 1, 1)


def test_flash_attention_d256_strided_views_match_plain():
    """Strided bf16 views (heads split out of a (B, S, H, D) tensor) at D
    256 through ``flash_attention``: the op copies them for the kernels;
    output and gradients against the plain versions on the same card."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(3, 2, 96, 2, 256)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(2, 2, 96, 256)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    views = [x[i].transpose(1, 2).requires_grad_() for i in range(3)]
    assert not views[0].is_contiguous()
    before = _launches()
    out = flash_attention(*views, causal=True)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 1)
    q, k, v = (t.detach().contiguous() for t in views)
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True)
    want = flash_backward_reference(q, k, v, o_ref, lse_ref, w, causal=True,
                                    scale=256 ** -0.5)
    assert _rel_err(out.detach(), o_ref) <= TOL[torch.bfloat16]
    for t, ref in zip(views, want):
        assert _rel_err(t.grad, ref) <= TOL[torch.bfloat16]


def test_kernels_take_more_than_65535_heads_at_d256():
    """B*H = 65537 at D 256 (bf16): every (q tile, column group,
    batch*head) block of the 1-d grid runs; forward and both backward
    kernels against the plain versions."""
    rng = np.random.default_rng(22)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(65537, 1, 8, 256)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(4))
    o, lse = _kernels.flash_fwd(q, k, v, causal=True, scale=0.0625)
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True,
                                             scale=0.0625)
    torch.cuda.synchronize()
    assert _rel_err(o, o_ref) <= TOL[torch.bfloat16]
    assert (lse - lse_ref).abs().max().item() <= TOL[torch.bfloat16]
    delta = (g.float() * o.float()).sum(-1)
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=True,
                               scale=0.0625)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True,
                                    scale=0.0625)
    want = flash_backward_reference(q, k, v, o, lse, g, causal=True,
                                    scale=0.0625)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= TOL[torch.bfloat16]


def test_head_dims_above_256_raise():
    """D 257 (padded to 264 in bf16) through ``flash_attention`` and 264
    straight to the kernel are no longer refused: both run the sliced
    kernels (3 slices and groups), one counted launch each, against the
    plain versions; only a grid of 2^31 blocks or more is refused, naming
    it."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.normal(size=(1, 2, 40, 257)).astype(
        np.float32)).to("cuda", torch.bfloat16).requires_grad_()
    before = _launches()
    out = flash_attention(q, q, q)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 1)
    o_ref, _ = flash_forward_reference(q.detach(), q.detach(), q.detach())
    assert _rel_err(out.detach(), o_ref) <= TOL[torch.bfloat16]
    assert _kernels.flash_plan(40, 40, 264, torch.bfloat16).slices == 3
    _flash_check(False, 40, 56, 264, torch.bfloat16, b=1, h=2)
    with pytest.raises(ValueError, match="grid would overflow"):
        _kernels._check_grid("flash_fwd", 2 ** 24, 8192, 8192, 264)


@pytest.mark.parametrize("d", [320, 512, 1000])
@pytest.mark.parametrize("dtype", _kernels.FLASH_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,sq,sk", [
    (False, 200, 333),   # ragged
    (True, 150, 330),    # sq < sk
    (True, 300, 100),    # sq > sk: fully masked rows
])
def test_flash_head_dims_above_256(causal, sq, sk, d, dtype):
    """D 320, 512 and 1000 run the sliced kernels (S and dP summed over
    slices of 128 columns, the outputs in groups of 128): forward and both
    backward kernels against the plain versions."""
    _flash_check(causal, sq, sk, d, dtype, b=1, h=2)
    _backward_check(causal, sq, sk, d, dtype, b=1, h=2)


@pytest.mark.parametrize("d,dtype,n", [
    (192, torch.float32, 2), (256, torch.float32, 2),
    (320, torch.bfloat16, 3), (512, torch.float32, 4),
    (1000, torch.bfloat16, 8)])
def test_sliced_plans_as_launched(d, dtype, n):
    """The sliced plans the kernels take, each launch counted once: n
    slices and n groups of 128 columns, 64-row tiles, one stage (the fp32
    backward at D 192 and 256; the forward only above 256)."""
    fwd, bwd = (_kernels.flash_plan(300, 200, d, dtype),
                _kernels.flash_bwd_plan(300, 200, d, dtype))
    assert (bwd.slices, bwd.dq.groups, bwd.dkv.groups) == (n, n, n)
    assert (bwd.dq.rows, bwd.dq.tile, bwd.dkv.rows, bwd.dkv.tile) == (
        64, 64, 64, 64)
    assert fwd.slices == (n if d > 256 else 0)
    before = _launches()
    _backward_check(True, 300, 200, d, dtype, b=1, h=2)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 1)


def test_backward_kernels_in_a_cuda_graph():
    """After their first calls the backward kernels can be captured in a
    CUDA graph; replays give the eager answers."""
    q, k, v, g = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                  for a in _arrays(19, 190, 190, 64))
    o, lse = _kernels.flash_fwd(q, k, v, causal=True, scale=0.125)
    delta = (g.float() * o.float()).sum(-1)

    def grads():
        return (_kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=True,
                                      scale=0.125),
                *_kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True,
                                        scale=0.125))

    want = grads()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        got = grads()
    torch.cuda.current_stream().wait_stream(side)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_attention_gradient_on_card_matches_cpu():
    """autograd through ``flash_attention`` on CUDA runs one forward, one
    dQ and one dK/dV launch (the cotangent arrives non-contiguous) and
    matches the CPU's plain path, which launches nothing."""
    q, k, v, w = _arrays(10, 48, 48, 16)
    grads = {}
    for dev in ("cpu", "cuda"):
        qkv = [torch.from_numpy(a).to(dev).requires_grad_()
               for a in (q, k, v)]
        before = _launches()
        out = flash_attention(*qkv, causal=True)
        (out.transpose(1, 2) * torch.from_numpy(w).to(dev).transpose(1, 2)
         ).sum().backward()
        got = tuple(n - b for n, b in zip(_launches(), before))
        assert got == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        grads[dev] = [t.grad.cpu() for t in qkv]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _narrow_weights():
    """mha_classifier's structure at E=32, 2 heads, S=16: its config and
    JAX-layout weights, from a seed."""
    m = (SequentialBuilder("narrow").input((16, 32))
         .residual([MultiHeadAttentionLayer(num_heads=2)])
         .residual([MultiHeadAttentionLayer(num_heads=2)])
         .flatten().dense(10).build())
    m.init(generator=torch.Generator().manual_seed(14), device="cpu")
    return m.get_config(), to_jax(m)


def test_trainer_on_card_tracks_cpu():
    """Two epochs of the narrow model through ``Trainer.fit`` on CUDA and
    on the CPU from the same weights and batches: the losses agree, and
    every CUDA step launches 2 forward, 2 dQ and 2 dK/dV kernels."""
    cfg, params = _narrow_weights()
    rng = np.random.default_rng(15)
    y_idx = rng.integers(0, 10, 64)
    x = rng.normal(0, 0.1, (64, 16, 32)).astype(np.float32)
    x[np.arange(64), y_idx, :8] += 2.5
    y = np.eye(10, dtype=np.float32)[y_idx]
    hist = {}
    for dev in ("cuda", "cpu"):
        tm = from_jax(cfg, params, device=dev)
        opt = SGD(0.05, momentum=0.9)
        tr = Trainer(tm, opt, "softmax_crossentropy", TrainingConfig(
            epochs=2, batch_size=16, snapshot_dir=None, progress_interval=0,
            device_type=dev))
        before = _launches()
        ts = tr.fit(create_train_state(tm, opt),
                    ArrayDataLoader(x, y, batch_size=16, seed=1))
        want = 2 * ts.step if dev == "cuda" else 0
        assert tuple(a - b for a, b in zip(_launches(), before)) == (want,) * 3
        hist[dev] = [h["train_loss"] for h in tr.history]
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-4)


def test_dropout_on_card_keep_fraction_and_scale():
    """Rate 0.3 over a million ones on CUDA, the mask drawn from a CUDA
    generator: the kept share is 0.7 within 0.003 (about six standard
    deviations), every kept value exactly 1/0.7, one generator state one
    mask; a generator on the CPU is refused."""
    x = torch.ones(1_000_000, device="cuda")
    layer = DropoutLayer(0.3).train()

    def gen():
        return torch.Generator(device="cuda").manual_seed(5)

    y = layer(x, generator=gen())
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.003
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, layer(x, generator=gen()))
    with pytest.raises(RuntimeError):
        layer(x, generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_cnn_train_step_on_card_tracks_cpu(df):
    """One SGD step (momentum 0.9) of a narrow residual CNN (conv + BN stem,
    a basic and a bottleneck block, groupnorm, pools, dense) on CUDA and on
    the CPU from the same weights and batch: loss and logits within 1e-4
    of the logit scale, every gradient within 1e-4 of its own largest
    value, the BN running statistics and the updated params within 1e-5
    (cuDNN's fp32 convs, TF32 off, summed in another order). A conv bias
    that feeds a BN has a gradient that is zero in exact arithmetic: on
    both devices it is held below 1e-3 of the model's largest gradient, as
    ``chip_smoke.py`` holds ResNet-18's."""
    shape = (3, 16, 16) if df == "NCHW" else (16, 16, 3)
    m = (SequentialBuilder("narrow_cnn", df).input(shape)
         .conv2d(8, 3, 1, 1, False, "stem").batchnorm(1e-3, 0.1, True, "bn")
         .activation("relu").maxpool2d(2, 2, 0)
         .basic_residual_block(8, 16, 2, "b1")
         .bottleneck_residual_block(16, 4, 16, 1, "bt1")
         .groupnorm(4).avgpool2d(2, 1, 0).flatten().dense(10).build())
    m.init(generator=torch.Generator().manual_seed(16), device="cpu")
    cfg, params, state = m.get_config(), to_jax(m), state_to_jax(m)
    rng = np.random.default_rng(17)
    x = rng.normal(size=(6, *shape)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    out = {}
    for dev in ("cuda", "cpu"):
        tm = from_jax(cfg, params, state, device=dev)
        opt = SGD(0.05, momentum=0.9)
        step = make_train_step(tm, get_loss("softmax_crossentropy"), opt)
        loss, logits = step(create_train_state(tm, opt),
                            torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev), 0.05)
        out[dev] = (loss.item(), logits.cpu(),
                    {n: p.grad.cpu() for n, p in tm.named_parameters()},
                    [b.cpu() for b in tm.buffers()],
                    [p.detach().cpu() for p in tm.parameters()])
    (lg, og, gg, bg, pg), (lc, oc, gc, bc, pc) = out["cuda"], out["cpu"]
    scale = oc.abs().max().item()
    assert abs(lg - lc) <= 1e-4 * scale
    assert (og - oc).abs().max().item() <= 1e-4 * scale
    noise = _smoke.bias_before_bn(tm)
    assert noise  # the basic block's convs
    g_top = max(g.abs().max().item() for g in gc.values())
    for n, b in gc.items():
        if n in noise:
            assert max(gg[n].abs().max().item(),
                       b.abs().max().item()) <= 1e-3 * g_top, n
        else:
            assert _rel_err(gg[n], b) <= 1e-4, n
    for a, b in zip(bg + pg, bc + pc):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _conv_inputs(seed, n, h, w, cin, cout, dtype):
    rng = np.random.default_rng(seed)
    x, wt = rng.normal(size=(n, h, w, cin)), rng.normal(size=(3, 3, cin, cout))
    sc, sh = rng.normal(size=cin), rng.normal(size=cin)
    return (torch.from_numpy(x).to("cuda", dtype),
            (torch.from_numpy(wt) * 0.1).to("cuda", dtype),
            torch.from_numpy(sc).float().cuda(),
            torch.from_numpy(sh).float().cuda())


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# How conv3x3_tc.cu stages each (its plan: _kernels.conv_plan; the copy
# unit: _kernels._copy_unit): cp.async where a row of Cin is not a multiple
# of 16 bytes, TMA elsewhere
_CONV_SHAPES = [
    (2, 5, 5, 3, 4, torch.float32, torch.float32),      # Cin 3: cp.async 4 B
    (2, 5, 5, 3, 4, torch.bfloat16, torch.bfloat16),    # Cin 3: plain loads
    (4, 6, 10, 4, 8, torch.float32, torch.float32),     # TMA, 16-byte rows
    (3, 7, 9, 8, 8, torch.bfloat16, torch.bfloat16),    # odd W
    (2, 16, 16, 70, 72, torch.float32, torch.float32),  # cp.async 8 B, partial chunks/tiles
    (2, 16, 16, 70, 72, torch.bfloat16, torch.float32),  # cp.async 4 B
    (2, 12, 20, 64, 64, torch.bfloat16, torch.float32),  # TMA, one Cin chunk
    (1, 4, 4, 512, 130, torch.float32, torch.bfloat16),  # TMA, Cout 130
    (2, 8, 8, 64, 130, torch.bfloat16, torch.bfloat16),  # Cout 130 in bf16
    # layer4 of resnet18_tiny_imagenet at B=32: 8 images per tile, K split 8
    (32, 4, 4, 512, 512, torch.bfloat16, torch.bfloat16),
    (32, 4, 4, 512, 512, torch.float32, torch.float32),
    # enough 256-pixel tiles to fill the card: two slabs per warpgroup
    (34, 32, 32, 64, 64, torch.bfloat16, torch.bfloat16),
    (36, 32, 32, 70, 130, torch.bfloat16, torch.float32),  # + cp.async, Cout 130
]


# the pairs formulation takes even W only
@pytest.mark.parametrize("kind,n,h,w,cin,cout,dtype,out_dtype", [
    (kind, *shape) for kind in ("conv", "bnrelu", "pairs")
    for shape in _CONV_SHAPES if kind != "pairs" or shape[2] % 2 == 0])
def test_conv_kernels_match_plain_on_card(kind, n, h, w, cin, cout, dtype,
                                          out_dtype):
    """Each conv kernel against its plain version, one counted launch, and
    a rerun bit-identical (the K split adds its partial sums in a fixed
    order)."""
    x, wt, sc, sh = _conv_inputs(3, n, h, w, cin, cout, dtype)
    if kind == "conv":
        counter = _kernels.conv3x3_s1
        got = pconv.conv3x3_s1(x, wt, out_dtype=out_dtype)
        want = pconv.conv3x3_reference(x, wt, out_dtype=out_dtype)
    elif kind == "bnrelu":
        counter = _kernels.conv3x3_s1_bnrelu_in
        got = pconv.conv3x3_s1_bnrelu_in(x, wt, sc, sh, out_dtype=out_dtype)
        want = pconv.conv3x3_reference(pconv.bnrelu_reference(x, sc, sh), wt,
                                       out_dtype=out_dtype)
    else:
        counter = _kernels.conv3x3_s1_pairs
        got = pconv.conv3x3_s1_pairs(x, wt, out_dtype=out_dtype)
        want = pconv.conv3x3_pairs_reference(x, pconv.fuse_pair_weights(wt),
                                             out_dtype=out_dtype)
    before = counter.launches
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, h, w, cout)
    assert _rel_err(got, want) <= TOL[out_dtype]
    again = {"conv": lambda: _kernels.conv3x3_s1(x, wt, out_dtype=out_dtype),
             "bnrelu": lambda: _kernels.conv3x3_s1_bnrelu_in(
                 x, wt, sc, sh, out_dtype=out_dtype),
             "pairs": lambda: _kernels.conv3x3_s1_pairs(
                 x, pconv.fuse_pair_weights(wt), out_dtype=out_dtype)}[kind]()
    assert counter.launches == before + 1
    assert torch.equal(again, got)  # deterministic


@pytest.mark.parametrize("shape,dtype", [((3, 700), torch.float32),
                                         ((4, 8, 8, 16), torch.float32),
                                         ((2, 5, 5, 3), torch.bfloat16),
                                         ((7, 33, 130), torch.bfloat16)])
def test_scale_bias_relu_kernel_matches_plain_on_card(shape, dtype):
    rng = np.random.default_rng(4)
    x, sc, b = (torch.from_numpy(rng.normal(size=s)).to("cuda", dtype)
                for s in (shape, shape[-1:], shape[-1:]))
    before = _kernels.fused_scale_bias_relu.launches
    got = pfused.fused_scale_bias_relu(x, sc, b)
    torch.cuda.synchronize()
    assert _kernels.fused_scale_bias_relu.launches == before + 1
    assert torch.equal(got, pfused.scale_bias_relu_reference(x, sc, b))


def test_conv_kernels_refuse_what_they_cannot_take():
    x, wt, sc, sh = _conv_inputs(5, 2, 6, 6, 4, 8, torch.float32)
    with pytest.raises(ValueError, match="x must be contiguous"):
        _kernels.conv3x3_s1(x.transpose(1, 2), wt, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="w is on cpu"):
        _kernels.conv3x3_s1(x, wt.cpu(), out_dtype=torch.float32)
    with pytest.raises(TypeError, match="w is torch.bfloat16"):
        _kernels.conv3x3_s1(x, wt.bfloat16(), out_dtype=torch.float32)
    with pytest.raises(TypeError, match="dtype torch.float64"):
        _kernels.conv3x3_s1(x.double(), wt.double(), out_dtype=torch.float64)
    with pytest.raises(ValueError, match="scale must be contiguous fp32"):
        _kernels.conv3x3_s1_bnrelu_in(x, wt, sc.double(), sh,
                                      out_dtype=torch.float32)
    with pytest.raises(ValueError, match="W=5 must be even"):
        _kernels.conv3x3_s1_pairs(x[:, :, :5].contiguous(),
                                  pconv.fuse_pair_weights(wt),
                                  out_dtype=torch.float32)
    with pytest.raises(ValueError, match="bias must be"):
        _kernels.fused_scale_bias_relu(x, sc[:4], sh[:3])
    with pytest.raises(ValueError, match="scale is on cpu"):
        _kernels.fused_scale_bias_relu(x, sc[:4].cpu(), sh[:4])


# -- checkpoints and the step guard on the card ------------------------------

def _small_cnn(name="ckpt_card"):
    return (SequentialBuilder(name).input((3, 8, 8))
            .conv2d(4, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(5).build())


def _cnn_state(seed=0):
    from dcnn_tpu_torch.optim import Adam

    model = _small_cnn()
    opt = Adam(1e-3)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(seed),
                            device="cuda")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(8, 3, 8, 8)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(np.eye(5, dtype=np.float32)[rng.integers(
        0, 5, 8)]).cuda()
    return model, opt, ts, x, y


def _host_arrays(model, opt_state):
    out = {f"p.{n}": t.detach().cpu() for n, t in model.named_parameters()}
    out.update({f"b.{n}": t.detach().cpu() for n, t in model.named_buffers()})
    for k, v in opt_state.items():
        if k == "t":
            out["t"] = int(v)
        else:
            out.update({f"{k}.{n}": t.detach().cpu() for n, t in v.items()})
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_checkpoint_saved_from_card_loads_on_cpu(tmp_path):
    """A checkpoint saved from CUDA tensors (after two Adam steps on the
    card) loads on the CPU with identical params, BN statistics and Adam
    state, and back onto the card."""
    from dcnn_tpu_torch.train import load_checkpoint, save_checkpoint

    model, opt, ts, x, y = _cnn_state()
    step = make_train_step(model, get_loss("softmax_crossentropy"), opt)
    for _ in range(2):
        step(ts, x, y, 1e-3)
    save_checkpoint(str(tmp_path), model, ts.opt_state, opt, {"epoch": 2})
    want = _host_arrays(model, ts.opt_state)
    cpu_model, cpu_state, _, md = load_checkpoint(str(tmp_path), device="cpu")
    assert md == {"epoch": 2} and next(cpu_model.parameters()).device.type \
        == "cpu"
    _assert_same(_host_arrays(cpu_model, cpu_state), want)
    card_model, card_state, _, _ = load_checkpoint(str(tmp_path),
                                                   device="cuda")
    assert next(card_model.parameters()).is_cuda
    _assert_same(_host_arrays(card_model, card_state), want)


def test_async_save_then_in_place_step_keeps_pre_step_values(tmp_path):
    """save_async queues its copies on the current stream and returns; an
    in-place Adam step right after it cannot reach them: the committed
    checkpoint holds the pre-step arrays."""
    from dcnn_tpu_torch.resilience import CheckpointManager

    model, opt, ts, x, y = _cnn_state(1)
    step = make_train_step(model, get_loss("softmax_crossentropy"), opt)
    step(ts, x, y, 1e-3)
    want = _host_arrays(model, ts.opt_state)
    with CheckpointManager(str(tmp_path), keep=1) as cm:
        cm.save_async(1, model, ts.opt_state, opt, {"epoch": 1})
        for _ in range(3):
            step(ts, x, y, 1e-3)       # in place, at once
        cm.wait(timeout=120)
        r = cm.restore_latest(device="cpu")
    _assert_same(_host_arrays(r.model, r.opt_state), want)
    assert not torch.equal(next(model.parameters()).cpu(),
                           next(r.model.parameters()))


def test_guarded_skip_on_card_is_bit_identical():
    """A NaN batch under the guard on the card: params, Adam's state, the
    step count and the BN running statistics (moved to NaN in place by the
    training forward, then put back) are bit-identical to before."""
    model, opt, ts, x, y = _cnn_state(2)
    step = make_train_step(model, get_loss("softmax_crossentropy"), opt,
                           guard=True)
    loss, _, bad = step(ts, x, y, 1e-3)
    assert not bad
    want, steps = _host_arrays(model, ts.opt_state), ts.step
    loss, _, bad = step(ts, torch.full_like(x, float("nan")), y, 1e-3)
    assert bad and not torch.isfinite(loss)
    _assert_same(_host_arrays(model, ts.opt_state), want)
    assert ts.step == steps
