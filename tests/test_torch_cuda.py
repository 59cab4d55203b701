"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, the training path run through the flash kernels, and the data feed
on the card (pinned buffers, side streams and events against the host
bytes, a worker pool built after CUDA init, the device augmentations and a
resident epoch against the CPU), the observability core on the card
(``sample_hbm``, ``LayerProfiler``'s CUDA events, a traced resident epoch
with no synchronisation, the telemetry server over an int8 engine), and
the compiled sessions (``core/graphs.py``): every engine bucket and decode
lattice point, and the per-step, guarded, chunked and resident train
steps, replayed from CUDA graphs bit for bit against the eager path (cuDNN
deterministic for training), the launch counters advanced by the captured
delta, a host read refused at capture, two threads on one engine, and a
rollback and a resume after capture; the router tier's and the
autoscaler's replicas (a scale-up builds and serves an engine replica, a
scale-down leaves its pool at 0 B).

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

import contextlib
import copy
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
    and lo need more than a block's shared memory, runs both kernels' wide
    modes (dQ in slices of one 32-column chunk, dK/dV of one or two; two
    groups of 128 columns)."""
    _flash_check(causal, sq, sk, d, dtype, b=1, h=2)
    if dtype == torch.float32:
        plan = _kernels.flash_bwd_plan(sq, sk, d, dtype)
        chunks = -(-d * 4 // 128)
        slices = chunks // (1 if chunks % 2 else 2)
        assert (plan.dq.slices, plan.dkv.slices) == (chunks, slices)
        assert plan.dq.groups == plan.dkv.groups == 2
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
    straight to the kernel are no longer refused: both run the wide
    forward (5 slices of one 64-column chunk, 2 groups of 256), the wide dQ
    and dK/dV, one counted launch each, against the plain versions;
    only a grid of 2^31 blocks or more is refused, naming it."""
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
    assert _kernels.flash_plan(40, 40, 264, torch.bfloat16).slices == 5
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
    """D 320, 512 and 1000 run every kernel's wide mode on wgmma (S and dP
    summed over slices streamed through the ring, the outputs in column
    groups): forward and both backward kernels against the plain
    versions."""
    _flash_check(causal, sq, sk, d, dtype, b=1, h=2)
    _backward_check(causal, sq, sk, d, dtype, b=1, h=2)


@pytest.mark.parametrize("d,dtype,n", [
    (192, torch.float32, 2), (256, torch.float32, 2),
    (320, torch.bfloat16, 3), (512, torch.float32, 4),
    (1000, torch.bfloat16, 8)])
def test_sliced_plans_as_launched(d, dtype, n):
    """The plans the sliced dQ kernel once ran, now the wide modes, as the
    kernels take them, each launch counted once: the dQ
    kernel's wide mode in n groups of 128 columns, 64-row blocks, kv tiles
    of 32 (fp32) or 64 (bf16) keys, a slice for each 128-byte chunk of D;
    the dK/dV kernel's in n groups, 64-key blocks, q tiles of 16 (fp32) or
    32 (bf16) rows, a slice for each two chunks (each one where their count
    is odd); both with two stages or more (the fp32 backward at D 192 and
    256 too); the forward's wide mode only above 256, in groups of 256
    columns and the dK/dV kernel's slices."""
    fwd, bwd = (_kernels.flash_plan(300, 200, d, dtype),
                _kernels.flash_bwd_plan(300, 200, d, dtype))
    es = 4 if dtype == torch.float32 else 2
    chunks = -(-d * es // 128)
    slices = chunks // (1 if chunks % 2 else 2)
    assert (bwd.dq.slices, bwd.dq.groups, bwd.dkv.groups) == (chunks, n, n)
    assert (bwd.dq.rows, bwd.dq.tile) == (64, 32 if es == 4 else 64)
    assert bwd.dq.stages >= 2
    assert bwd.dkv.slices == slices and bwd.dkv.rows == 64
    assert bwd.dkv.tile == (16 if es == 4 else 32) and bwd.dkv.stages >= 2
    assert fwd.slices == (slices if d > 256 else 0)
    assert fwd.groups == (-(-d // 256) if d > 256 else 2)
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


# -- the data feed on the card ---------------------------------------------------

def _u8(n=41, seed=0, shape=(3, 8, 8)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *shape), dtype=np.uint8),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("mode", ["chunks", "concat"])
@pytest.mark.parametrize("fence", [True, False])
def test_engine_delivers_host_bytes_on_card(mode, fence):
    """Chunks gathered into pinned buffers and copied on the engine's own
    streams, landed on the current stream by their events, equal the host
    rows; the source may be overwritten once a fenced call returns."""
    from dcnn_tpu_torch.data import TransferEngine
    from dcnn_tpu_torch.data.transfer import land

    x, y = _u8()
    sel = np.sort(np.random.default_rng(1).choice(41, 29, replace=False))
    with TransferEngine(num_chunks=3, num_threads=2, reassemble=mode,
                        fence=fence) as eng:
        assert eng.device.type == "cuda"
        for _ in range(3):
            dx, dy, stats = eng.put_shard(x, y, sel)
            assert stats["events"] and stats["inflight_max"] >= 1
            land(stats["events"], dx, dy)
            got = torch.cat(dx) if isinstance(dx, tuple) else dx
            assert got.is_cuda and dy.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(), x[sel])
            np.testing.assert_array_equal(dy.cpu().numpy(), y[sel])
        whole = eng.put_array(x)
        np.testing.assert_array_equal(whole.cpu().numpy(), x)


@pytest.mark.parametrize("chunk_bytes", [1000, 4096, 1 << 26])
def test_stage_array_through_reused_pinned_buffers(chunk_bytes):
    from dcnn_tpu_torch.data.transfer import stage_array

    x, y = _u8(n=37, seed=2)
    d = stage_array(x, "cuda", chunk_bytes=chunk_bytes)
    dy = stage_array(y, "cuda", chunk_bytes=chunk_bytes)
    np.testing.assert_array_equal(d.cpu().numpy(), x)
    np.testing.assert_array_equal(dy.cpu().numpy(), y)


def _serial_decoded(ld, epoch):
    from dcnn_tpu_torch.data import decode_host

    ld.shuffle(epoch)
    return [(decode_host(a, ld.scale), b) for a, b in ld]


@pytest.mark.parametrize("stage,engine", [(1, False), (2, False), (2, True)])
def test_prefetch_delivers_host_bytes_on_card(stage, engine):
    from dcnn_tpu_torch.data import PrefetchLoader, TransferEngine

    x, y = _u8(n=48, seed=3)
    ld = ArrayDataLoader(x, np.eye(10, dtype=np.float32)[y], batch_size=8,
                         seed=4)
    eng = TransferEngine(num_chunks=2, reassemble="concat") if engine \
        else None
    with PrefetchLoader(ld, stage_batches=stage, transfer_engine=eng) as pf:
        for epoch in (0, 1):
            pf.shuffle(epoch)
            got = list(pf)
            want = _serial_decoded(ld, epoch)
            flat = [(a, b) for gx, gy in got for a, b in
                    (zip(gx, gy) if stage > 1 else [(gx, gy)])]
            assert len(flat) == len(want)
            for (a, b), (wa, wb) in zip(flat, want):
                assert a.is_cuda
                np.testing.assert_array_equal(a.cpu().numpy(), wa)
                np.testing.assert_array_equal(b.cpu().numpy(), wb)
    if eng is not None:
        eng.close()


@pytest.mark.parametrize("mp_context", ["spawn", "fork"])
def test_pool_created_after_cuda_init_delivers_host_bytes(mp_context):
    """The 2-process pool built after CUDA is initialised (its children
    never touch CUDA): pooled batches through pinned buffers and a side
    stream equal the serial path's, epoch after epoch."""
    from dcnn_tpu_torch.data import FeedWorkerPool, PrefetchLoader

    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    x, y = _u8(n=64, seed=5)
    oh = np.eye(10, dtype=np.float32)[y]
    ld = ArrayDataLoader(x, oh, batch_size=8, seed=6)
    with FeedWorkerPool(x, oh, 16, num_workers=2, seed=6,
                        mp_context=mp_context, poll_s=0.05) as pool:
        pf = PrefetchLoader(ld, stage_batches=2, worker_pool=pool)
        for epoch in (0, 1):
            pf.shuffle(epoch)
            got = [(a, b) for gx, gy in pf for a, b in zip(gx, gy)]
            want = _serial_decoded(ld, epoch)
            assert len(got) == len(want)
            for (a, b), (wa, wb) in zip(got, want):
                np.testing.assert_array_equal(a.cpu().numpy(), wa)
                np.testing.assert_array_equal(b.cpu().numpy(), wb)
        assert pool.alive_workers() == 2


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_device_augment_ops_on_card_equal_cpu(fmt):
    """Each op's apply on CUDA equals its apply on the CPU given the same
    draws: exactly, but for rotation (1e-5: cos/sin and the weights in
    CUDA's arithmetic) and contrast (4 ulp of the data scale: the
    per-image mean is a reduction summed in another order)."""
    from dcnn_tpu_torch.data import augment_device as ad

    x = torch.rand((6, 3, 12, 10) if fmt == "NCHW" else (6, 12, 10, 3),
                   generator=torch.Generator().manual_seed(7))
    ops = [ad.brightness(), ad.contrast(), ad.cutout(4, 0.7, fmt),
           ad.gaussian_noise(), ad.horizontal_flip(0.5, fmt),
           ad.vertical_flip(0.5, fmt),
           ad.normalization([0.1, 0.2, 0.3], [0.5, 0.6, 0.7], fmt),
           ad.random_crop(3, 0.8, fmt), ad.rotation(30.0, 0.8, fmt)]
    eps = float(torch.finfo(torch.float32).eps)
    for i, op in enumerate(ops):
        draws = op.draw(x, torch.Generator().manual_seed(i))
        cpu = op.apply(x, draws)
        card = op.apply(x.cuda(), tuple(d.cuda() for d in draws)).cpu()
        name = type(op).__name__
        if name == "Rotation":
            torch.testing.assert_close(card, cpu, rtol=0, atol=1e-5)
        elif name == "Contrast":
            torch.testing.assert_close(card, cpu, rtol=0, atol=4 * eps)
        else:
            assert torch.equal(card, cpu), name
        # drawn on the card, from a generator on the card
        card_draws = op.draw(x.cuda(), torch.Generator(device="cuda")
                             .manual_seed(i))
        assert all(d.is_cuda for d in card_draws)


def _feed_cnn(device, seed=0):
    model = (SequentialBuilder("feed_cnn", data_format="NHWC")
             .input((8, 8, 1)).conv2d(8, 3, padding=1).batchnorm()
             .activation("relu").maxpool2d(2).flatten().dense(4).build())
    return model.init(generator=torch.Generator().manual_seed(seed),
                      device=device)


def test_resident_epoch_on_card_tracks_cpu_and_never_syncs():
    """A narrow resident epoch on CUDA against the same epoch on the CPU
    (one batch order, a per-batch lr vector, augmentation by the same
    draws is not possible across devices, so none): the losses and params
    within 1e-4 of their scale. Inside the epoch nothing waits for the
    card (``torch.cuda.set_sync_debug_mode("error")``); the mean loss is
    read after it. Resident eval on the card equals the host eval of the
    same split on the card, bit for bit."""
    from dcnn_tpu_torch.data import DeviceDataset, make_resident_epoch
    from dcnn_tpu_torch.train import evaluate_classification

    rng = np.random.default_rng(8)
    y = rng.integers(0, 4, 64)
    x = np.clip(y[:, None, None, None] * 50 + 20
                + rng.normal(0, 10, (64, 8, 8, 1)), 0, 255).astype(np.uint8)
    order = rng.permutation(64).reshape(8, 8)
    lrs = np.linspace(0.05, 0.01, 8).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        model = _feed_cnn(dev)
        opt = SGD(0.05, momentum=0.9)
        ds = DeviceDataset(x, y, 4, batch_size=8, device=dev)
        epoch = make_resident_epoch(model, get_loss("softmax_crossentropy"),
                                    opt, num_classes=4, batch_size=8)
        ts = create_train_state(model, opt)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                ts, mean = epoch(ts, ds.x, ds.y, 3, lrs, order=order)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            ts, mean = epoch(ts, ds.x, ds.y, 3, lrs, order=order)
        out[dev] = (float(mean), [p.detach().cpu() for p in
                                  model.parameters()])
        if dev == "cuda":
            host = ArrayDataLoader(x, np.eye(4, dtype=np.float32)[y],
                                   batch_size=8, shuffle=False,
                                   drop_last=False)
            loss = get_loss("softmax_crossentropy")
            assert evaluate_classification(model, loss, ds) \
                == evaluate_classification(model, loss, host)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


# ---------------------------------------------------------------- int8

INT8_GEOMETRIES = [(1, 1, 0), (1, 2, 0), (3, 1, 0), (3, 1, 1), (3, 2, 1),
                   (5, 1, 0), (7, 2, 3)]


def _int8_pair(seed, n, cin, h, w, cout, k, layout):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (n, cin, h, w), dtype=np.int8)
    wt = rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return torch.from_numpy(x), torch.from_numpy(wt)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", INT8_GEOMETRIES)
@pytest.mark.parametrize("cin,cout", [(3, 64), (16, 8), (17, 70), (64, 128)])
def test_conv_int8_kernel_equals_plain_on_card(k, stride, pad, layout, cin,
                                               cout):
    """Every conv geometry of the zoo, K tails (C_in 3 and 17: K not a
    multiple of 16 or 64), ragged M and N edges, both layouts: the int32
    result equals the plain version bit for bit."""
    from dcnn_tpu_torch.ops.conv import conv2d_int8, conv2d_int8_reference

    x, w = _int8_pair(k * 7 + cin, 3, cin, 13, 11, cout, k, layout)
    before = _kernels.conv_int8.launches
    got = conv2d_int8(x.cuda(), w.cuda(), stride=stride, padding=pad,
                      data_format=layout)
    torch.cuda.synchronize()
    assert _kernels.conv_int8.launches == before + 1
    want = conv2d_int8_reference(x, w, stride=stride, padding=pad,
                                 data_format=layout)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got.cpu(), want)


def test_conv_int8_kernel_takes_strided_views_and_extremes():
    """A non-contiguous channels-last view (the byte-gather path), and
    sums at the int8 extremes over K = 3*3*512."""
    from dcnn_tpu_torch.ops.conv import conv2d_int8, conv2d_int8_reference

    x, w = _int8_pair(5, 4, 32, 9, 9, 16, 3, "NHWC")
    xv = x.cuda()[1:, :, :, :]
    got = conv2d_int8(xv, w.cuda(), padding=1, data_format="NHWC")
    assert torch.equal(got.cpu(), conv2d_int8_reference(
        x[1:], w, padding=1, data_format="NHWC"))
    xe = torch.full((2, 6, 6, 512), 127, dtype=torch.int8)
    we = torch.full((130, 512, 3, 3), -127, dtype=torch.int8)
    got = conv2d_int8(xe.cuda(), we.cuda(), padding=0, data_format="NHWC")
    assert int(got.min()) == int(got.max()) == -4608 * 127 * 127


def test_conv_int8_kernel_refuses_what_it_cannot_take():
    x = torch.zeros(1, 4, 4, 4, dtype=torch.int8, device="cuda")
    w = torch.zeros(2, 4, 3, 3, dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):
        _kernels.conv_int8(x.float(), w, stride=(1, 1), padding=(0, 0),
                           data_format="NCHW")
    with pytest.raises(ValueError, match="input channels"):
        _kernels.conv_int8(x, w[:, :3], stride=(1, 1), padding=(0, 0),
                           data_format="NCHW")
    with pytest.raises(ValueError, match="not on"):
        _kernels.conv_int8(x, w.cpu(), stride=(1, 1), padding=(0, 0),
                           data_format="NCHW")
    with pytest.raises(ValueError, match="empty"):
        _kernels.conv_int8(x[:, :, :2, :2], w, stride=(1, 1),
                           padding=(0, 0), data_format="NCHW")


def _quant_layer_inputs(seed, n, cin, h, w, cout, k, layout, dtype):
    """Float x (in ``layout``, ``dtype``), its fp32 scale on the card,
    int8 OIHW weights, per-channel fp32 weight scales and bias, all on the
    card, from numpy seeds."""
    from dcnn_tpu_torch.ops import quant

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, cin, h, w)).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    xt = torch.from_numpy(x).to("cuda", dtype)
    wt = rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)
    w_scale = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    b = rng.normal(0, 1, cout).astype(np.float32)
    return (xt, quant.tensor_scale(xt).cuda(), torch.from_numpy(wt).cuda(),
            torch.from_numpy(w_scale).cuda(), torch.from_numpy(b).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", INT8_GEOMETRIES)
@pytest.mark.parametrize("cin,cout", [(3, 64), (16, 8), (17, 70), (64, 128)])
def test_conv_int8_fused_equals_unfused_chain_on_card(k, stride, pad, layout,
                                                      cin, cout, dtype):
    """The fused mode (quantize in the prologue, dequantize and bias in the
    epilogue) equals the unfused chain on the card (quantize_symmetric,
    the exact int8 conv, the dequantize) bit for bit, with and without a
    bias, in x's dtype and layout, one launch."""
    from dcnn_tpu_torch.ops import quant

    x, xs, w, ws, b = _quant_layer_inputs(k * 11 + cin, 3, cin, 13, 11, cout,
                                          k, layout, dtype)
    for bias in (b, None):
        before = _kernels.conv_int8_fused.launches
        got = quant.quant_conv2d(x, xs, w, ws, bias, stride=stride,
                                 padding=pad, data_format=layout)
        torch.cuda.synchronize()
        assert _kernels.conv_int8_fused.launches == before + 1
        want = quant.quant_conv2d_reference(x, xs, w, ws, bias, stride=stride,
                                            padding=pad, data_format=layout)
        assert got.dtype == dtype and got.is_contiguous()
        assert got.shape == want.shape
        assert torch.equal(got, want), float((got.float() - want.float())
                                             .abs().max())


# resnet18_tiny_imagenet's 21 convs at a 64x64 input: (Cin, H, W, Cout,
# k, stride, pad) of each conv's input
RESNET18_SITES = [(3, 64, 64, 32, 3, 1, 1)]
for _cin, _cout, _hw, _s in ((32, 64, 32, 1), (64, 64, 32, 1),
                             (64, 128, 32, 2), (128, 128, 16, 1),
                             (128, 256, 16, 2), (256, 256, 8, 1),
                             (256, 512, 8, 2), (512, 512, 4, 1)):
    RESNET18_SITES += [(_cin, _hw, _hw, _cout, 3, _s, 1),
                       (_cout, _hw // _s, _hw // _s, _cout, 3, 1, 1)]
    if _cin != _cout:
        RESNET18_SITES.append((_cin, _hw, _hw, _cout, 1, _s, 0))


@pytest.mark.parametrize("batch", [1, 3, 8, 32])
def test_conv_int8_fused_at_resnet18_sites_on_card(batch):
    """The fused mode at every ResNet-18 site, NHWC fp32, at batches whose
    plans differ (halo sizes, K splits, direct fallbacks): bit for bit
    the unfused chain on the card."""
    from dcnn_tpu_torch.ops import quant

    for i, (cin, h, w, cout, k, stride, pad) in enumerate(RESNET18_SITES):
        x, xs, wq, ws, b = _quant_layer_inputs(i, batch, cin, h, w, cout, k,
                                               "NHWC", torch.float32)
        got = quant.quant_conv2d(x, xs, wq, ws, b, stride=stride,
                                 padding=pad, data_format="NHWC")
        want = quant.quant_conv2d_reference(x, xs, wq, ws, b, stride=stride,
                                            padding=pad, data_format="NHWC")
        assert torch.equal(got, want), (i, batch)


@pytest.mark.parametrize("ksplit", [None, 1, 2])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("shape,halo", [((2, 384, 9, 9, 16, 3, 1, 1), True),
                                        ((1, 256, 20, 64, 8, 3, 2, 1), False),
                                        ((40, 512, 4, 4, 512, 3, 1, 1), True),
                                        ((8, 128, 16, 16, 64, 3, 2, 1), False),
                                        ((3, 256, 24, 16, 8, 3, 1, 1), True)])
def test_conv_int8_slices_halo_and_direct_on_card(shape, halo, layout,
                                                  ksplit):
    """K in slices of 128 channels (C 384, 256 and 512), from the halo
    and, where the box would not fit, straight from x; as planned, unsplit
    (every slice of a tile in one block, the copying warpgroups taking the
    slices in turn) and split in two: both modes bit for bit."""
    from dcnn_tpu_torch.ops import quant

    n, cin, h, w, cout, k, stride, pad = shape
    x, xs, wq, ws, b = _quant_layer_inputs(cin, n, cin, h, w, cout, k, layout,
                                           torch.float32)
    plan = _kernels.conv_int8_plan(n, cin, h, w, cout, k, k, stride, pad,
                                   torch.float32,
                                   channels_last=layout == "NHWC",
                                   ksplit=ksplit)
    assert bool(plan.halo) == halo and plan.chunks == cin // 128 * 9
    geo = dict(stride=(stride, stride), padding=(pad, pad),
               data_format=layout)
    got = _kernels.conv_int8_fused(x, xs, wq, (xs * ws).float(), b,
                                   ksplit=ksplit, **geo)
    assert torch.equal(got, quant.quant_conv2d_reference(
        x, xs, wq, ws, b, stride=stride, padding=pad, data_format=layout))
    x_q = quant.quantize_symmetric(x, xs)
    got = _kernels.conv_int8(x_q, wq, ksplit=ksplit, **geo)
    assert torch.equal(got, quant.conv2d_int8_reference(
        x_q, wq, stride=stride, padding=pad, data_format=layout))


@pytest.mark.parametrize("fused", [False, True])
def test_conv_int8_split_k_is_bit_identical_on_card(fused):
    """Forced K splits (2, 3 and 5 ranges of 5 chunks, one reduce launch
    each) give the unsplit result bit for bit, in both modes."""
    from dcnn_tpu_torch.ops import quant

    x, xs, w, ws, b = _quant_layer_inputs(3, 2, 64, 9, 9, 130, 3, "NHWC",
                                          torch.float32)
    x_q = quant.quantize_symmetric(x, xs)

    def run(split):
        if fused:
            return _kernels.conv_int8_fused(
                x, xs, w, (xs * ws).float(), b, stride=(1, 1),
                padding=(1, 1), data_format="NHWC", ksplit=split)
        return _kernels.conv_int8(x_q, w, stride=(1, 1), padding=(1, 1),
                                  data_format="NHWC", ksplit=split)

    ref = run(1)
    for split in (2, 3, 5):
        before = _kernels.conv_int8_reduce.launches
        got = run(split)
        torch.cuda.synchronize()
        assert _kernels.conv_int8_reduce.launches == before + 1
        assert torch.equal(got, ref)
    if not fused:
        assert torch.equal(ref.cpu(), quant.conv2d_int8_reference(
            x_q.cpu(), w.cpu(), padding=1, data_format="NHWC"))


def test_conv_int8_fused_refuses_what_it_cannot_take():
    x, xs, w, ws, b = _quant_layer_inputs(0, 1, 4, 4, 4, 2, 3, "NCHW",
                                          torch.float32)
    scale = (xs * ws).float()
    kw = dict(stride=(1, 1), padding=(1, 1), data_format="NCHW")
    with pytest.raises(TypeError):
        _kernels.conv_int8_fused(x.to(torch.int8), xs, w, scale, b, **kw)
    with pytest.raises(TypeError):
        _kernels.conv_int8_fused(x.double(), xs, w, scale, b, **kw)
    with pytest.raises(TypeError):
        _kernels.conv_int8_fused(x[0], xs, w, scale, b, **kw)
    with pytest.raises(ValueError):
        _kernels.conv_int8_fused(x.cpu(), xs, w, scale, b, **kw)
    with pytest.raises(ValueError, match="not on"):
        _kernels.conv_int8_fused(x, xs, w.cpu(), scale, b, **kw)
    with pytest.raises(ValueError, match="x_scale"):
        _kernels.conv_int8_fused(x, xs.cpu(), w, scale, b, **kw)
    with pytest.raises(ValueError, match="scale"):
        _kernels.conv_int8_fused(x, xs, w, scale[:1], b, **kw)
    with pytest.raises(ValueError, match="bias"):
        _kernels.conv_int8_fused(x, xs, w, scale, b.double(), **kw)
    with pytest.raises(ValueError, match="packed"):
        _kernels.conv_int8_fused(x, xs, w, scale, b, packed=w.reshape(2, -1),
                                 **kw)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (1, 64, 10), (16, 27, 3),
                                   (17, 8, 8), (5, 2048, 10), (33, 100, 13)])
def test_dense_int8_int_mm_equals_plain_on_card(m, k, n):
    """dense_int8 on torch._int_mm, with zero padding where its shape rules
    (more than 16 rows, K and N multiples of 8) refuse the shape."""
    from dcnn_tpu_torch.ops import quant

    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    got = quant.dense_int8(x.cuda(), w.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant.dense_int8_reference(x, w))
    x3 = x.reshape(1, m, k).cuda()
    assert torch.equal(quant.dense_int8(x3, w.cuda())[0].cpu(),
                       quant.dense_int8_reference(x, w))


def _int8_cnn(seed=0):
    m = (SequentialBuilder("q8", "NHWC").input((12, 12, 3))
         .conv2d(16, 3, 1, 1).batchnorm().activation("relu")
         .basic_residual_block(16, 32, 2, "block")
         .avgpool2d(6).flatten().dense(10).build())
    return m.init(generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("name", ["cnn", "mha_classifier"])
def test_int8_engine_bit_identical_across_buckets_on_card(name):
    """The int8 engine on the card: logits bit-identical at every bucket,
    within 1e-4 of the logit scale of the CPU int8 engine (the float glue
    sums in another order), the int8 kernels launched."""
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.serve import InferenceEngine

    model = (_int8_cnn() if name == "cnn" else create_model(
        "mha_classifier").init(generator=torch.Generator().manual_seed(0),
                               device="cpu"))
    rng = np.random.default_rng(1)
    calib = rng.normal(size=(16, *model.input_shape)).astype(np.float32)
    pool = rng.normal(size=(8, *model.input_shape)).astype(np.float32)
    cpu = InferenceEngine.from_model(model, int8_calib=calib, max_batch=8,
                                     device="cpu")
    card = InferenceEngine.from_model(model, int8_calib=calib, max_batch=8,
                                      device="cuda")
    assert card.batch_invariant
    before = (_kernels.conv_int8_fused.launches, _kernels.flash_fwd.launches,
              _kernels.conv_int8.launches)
    ref = card.infer(pool).cpu()
    after = (_kernels.conv_int8_fused.launches, _kernels.flash_fwd.launches,
             _kernels.conv_int8.launches)
    assert after[0 if name == "cnn" else 1] > before[0 if name == "cnn"
                                                     else 1]
    assert after[2] == before[2]  # the served convs are the fused kernel
    for i in range(8):
        assert torch.equal(card.infer(pool[i]).cpu(), ref[i])
    want = cpu.infer(pool)
    assert float((ref - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_decode_batcher_equals_reference_on_card():
    """Continuous batching of mha_decoder on the card: every sequence's
    tokens equal decode_reference on the card and on the CPU, staggered
    submissions, a starved pool that preempts."""
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.serve import (
        ContinuousBatcher, DecodeEngine, DecodeMetrics, decode_reference,
    )

    model = create_model("mha_decoder").init(
        generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, rng.integers(1, 9)).tolist()
               for _ in range(10)]
    cpu = DecodeEngine(model, max_slots=4, page_size=8, max_pages_per_seq=4)
    for num_pages in (None, 6):
        card = DecodeEngine(copy.deepcopy(model).to("cuda"), max_slots=4,
                            page_size=8,
                            max_pages_per_seq=4, num_pages=num_pages)
        metrics = DecodeMetrics()
        cb = ContinuousBatcher(card, start=False, metrics=metrics)
        futs = []
        for i, p in enumerate(prompts):
            futs.append(cb.submit(p, max_new_tokens=12))
            if i % 3 == 2:
                cb.step()
        cb.drain()
        for p, f in zip(prompts, futs):
            want = decode_reference(cpu, p, max_new_tokens=12)
            assert np.array_equal(f.result(0), want), (p, f.result(0), want)
            assert np.array_equal(
                decode_reference(card, p, max_new_tokens=12), want)
        if num_pages == 6:
            assert metrics.snapshot()["evictions"] > 0


def test_suggest_num_pages_reads_the_card():
    from dcnn_tpu_torch.serve import KVPagePool, suggest_num_pages

    page = KVPagePool(num_layers=2, embed_dim=64, page_size=8, num_pages=2,
                      device="cuda").page_bytes
    got = suggest_num_pages(page, fraction=0.5, cap=10 ** 9)
    free, _ = torch.cuda.mem_get_info()
    # free memory may move a little between the two reads
    assert abs(got - free * 0.5 // page) <= (64 << 20) // page
    # 20% of an H100's free memory is far more than 4096 pages of 8 KiB
    assert suggest_num_pages(page) == 4096


# ---------------------------------------------------------- observability

def test_sample_hbm_reads_the_card():
    """``sample_hbm`` on the card: the caching allocator's live bytes and
    peak, the card's capacity, a monotone watermark."""
    from dcnn_tpu_torch.obs import MetricsRegistry
    from dcnn_tpu_torch.obs import xla as obs_xla

    obs_xla._HBM_SUPPORTED = None
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    reg = MetricsRegistry()
    s = obs_xla.sample_hbm(reg)
    assert s is not None and obs_xla._HBM_SUPPORTED is True
    assert s["hbm_bytes_in_use"] >= keep.numel()
    assert s["hbm_peak_bytes"] >= s["hbm_bytes_in_use"]
    assert s["hbm_bytes_limit"] == torch.cuda.mem_get_info()[1]
    peak = s["hbm_peak_bytes"]
    del keep
    torch.cuda.empty_cache()
    assert obs_xla.sample_hbm(reg)["hbm_peak_bytes"] >= peak
    assert reg.gauge("hbm_peak_bytes").value >= peak


def test_layer_profiler_cuda_events_on_the_narrow_mha():
    """``LayerProfiler`` on the card times every layer of a narrow MHA with
    CUDA events, forward and backward, through the flash kernels, and puts
    the model back as it found it."""
    from dcnn_tpu_torch.core import ProfilerType
    from dcnn_tpu_torch.train.profiling import LayerProfiler

    model = (SequentialBuilder("prof_mha").input((16, 32))
             .residual([MultiHeadAttentionLayer(num_heads=2)])
             .residual([MultiHeadAttentionLayer(num_heads=2)])
             .flatten().dense(10).build()).init(
        generator=torch.Generator().manual_seed(0), device="cuda")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(8, 16, 32, device="cuda")
    prof = LayerProfiler(ProfilerType.NORMAL)
    f0, b0 = (_kernels.flash_fwd.launches, _kernels.flash_bwd_dq.launches)
    out = prof.profile_forward(model, x, training=True)
    g = prof.profile_backward(model, x, torch.ones_like(out))
    assert _kernels.flash_fwd.launches > f0
    assert _kernels.flash_bwd_dq.launches > b0
    names = [l.name for l in model.layers]
    assert list(prof.forward_us) == names
    assert all(prof.forward_us[n] > 0 and prof.backward_us[n] > 0
               for n in names)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    assert all(p.grad is None for p in model.parameters())
    assert "TOTAL" in prof.summary()


def test_traced_resident_epoch_adds_no_synchronisation():
    """A resident epoch on the card with the tracer on, inside the
    trainer's ``train.resident_epoch`` span: nothing waits for the card
    (``set_sync_debug_mode("error")``); the span and the loss read come
    after."""
    from dcnn_tpu_torch.data import DeviceDataset, make_resident_epoch
    from dcnn_tpu_torch.obs import configure

    rng = np.random.default_rng(8)
    y = rng.integers(0, 4, 64)
    x = np.clip(y[:, None, None, None] * 50 + 20
                + rng.normal(0, 10, (64, 8, 8, 1)), 0, 255).astype(np.uint8)
    model = _feed_cnn("cuda")
    opt = SGD(0.05, momentum=0.9)
    ds = DeviceDataset(x, y, 4, batch_size=8, device="cuda")
    epoch = make_resident_epoch(model, get_loss("softmax_crossentropy"),
                                opt, num_classes=4, batch_size=8)
    ts = create_train_state(model, opt)
    tracer = configure(enabled=True)
    tracer.clear()
    try:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with tracer.span("train.resident_epoch", track="train", epoch=1):
                with tracer.span("inner", track="train"):
                    ts, mean = epoch(ts, ds.x, ds.y, 3, 0.05)
                tracer.instant("issued", track="train")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert np.isfinite(float(mean))
        assert tracer.span_counts() == {"inner": 1, "issued": 1,
                                        "train.resident_epoch": 1}
    finally:
        configure(enabled=False)
        tracer.clear()


def test_telemetry_server_over_the_int8_engine():
    """``DynamicBatcher.start_telemetry`` over an int8 engine on the card:
    ``/metrics`` parses with the card's memory gauges non-zero, ``/healthz``
    200 then 503 after ``drain``, ``/snapshot`` with the serve, engine and
    tsdb blocks, the fused int8 conv launched, logits bit-identical to the
    same engine served with the tracer off."""
    import json
    import urllib.error
    import urllib.request

    from dcnn_tpu_torch.obs import configure
    from dcnn_tpu_torch.obs.exposition import parse_prometheus_text
    from dcnn_tpu_torch.serve import DynamicBatcher, InferenceEngine

    model = _int8_cnn()
    rng = np.random.default_rng(1)
    calib = rng.normal(size=(16, *model.input_shape)).astype(np.float32)
    pool = rng.normal(size=(6, *model.input_shape)).astype(np.float32)
    eng = InferenceEngine.from_model(model, int8_calib=calib, max_batch=8,
                                     device="cuda")
    plain = eng.infer(pool).cpu()

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    configure(enabled=True)
    b = DynamicBatcher(eng, start=False)
    srv = b.start_telemetry(port=0)
    try:
        before = _kernels.conv_int8_fused.launches
        futs = [b.submit(pool[i]) for i in range(6)]
        b.step()
        got = torch.from_numpy(np.stack([f.result(10) for f in futs]))
        assert _kernels.conv_int8_fused.launches > before
        assert torch.equal(got, plain)
        code, body = get(srv.url + "/metrics")
        fams = parse_prometheus_text(body.decode())
        assert code == 200
        assert fams["hbm_bytes_in_use"]["value"] > 0
        assert fams["hbm_peak_bytes"]["value"] > 0
        assert fams["serve_samples_completed_total"]["value"] == 6
        assert get(srv.url + "/healthz")[0] == 200
        snap = json.loads(get(srv.url + "/snapshot")[1])
        assert {"serve", "engine", "tsdb"} <= set(snap)
        b.drain()
        assert get(srv.url + "/healthz")[0] == 503
    finally:
        b.shutdown()
        configure(enabled=False)


# -- compiled sessions: CUDA graphs against the eager path ----------------------

def _narrow_mha(device, dropout=0.0, seed=14):
    b = (SequentialBuilder("narrow_g").input((16, 32))
         .residual([MultiHeadAttentionLayer(num_heads=2)])
         .residual([MultiHeadAttentionLayer(num_heads=2)]).flatten())
    if dropout:
        b = b.dropout(dropout)
    m = b.dense(10).build()
    return m.init(generator=torch.Generator().manual_seed(seed),
                  device=device)


def _narrow_cnn(seed=16):
    m = (SequentialBuilder("narrow_cnn_g", "NCHW").input((3, 16, 16))
         .conv2d(8, 3, 1, 1, False, "stem").batchnorm(1e-3, 0.1, True, "bn")
         .activation("relu").maxpool2d(2, 2, 0)
         .basic_residual_block(8, 16, 2, "b1").avgpool2d(4)
         .flatten().dense(10).build())
    return m.init(generator=torch.Generator().manual_seed(seed),
                  device="cpu")


@pytest.fixture
def _deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _engine(kind):
    from dcnn_tpu_torch.serve import InferenceEngine

    if kind == "mha":
        return InferenceEngine.from_model(_narrow_mha("cpu"), max_batch=8,
                                          device="cuda")
    model = _int8_cnn() if kind == "int8" else _narrow_cnn()
    calib = None
    if kind == "int8":
        calib = np.random.default_rng(1).normal(
            size=(16, *model.input_shape)).astype(np.float32)
    return InferenceEngine.from_model(model, fold=True, int8_calib=calib,
                                      max_batch=8, device="cuda")


@pytest.mark.parametrize("kind", ["mha", "cnn", "int8"])
def test_engine_replays_equal_eager_at_every_bucket(kind):
    """fp32 attention classifier, folded CNN and int8 CNN engines: every
    bucket is a captured graph whose replay equals the eager forward of
    the same input bit for bit, and each replay advances the launch
    counters by exactly the capture's delta (two flash forwards a batch
    for the attention classifier, the fused int8 conv for the int8
    engine)."""
    eng = _engine(kind)
    rng = np.random.default_rng(3)
    for b in eng.bucket_sizes:
        s = eng.sessions[(b, "parity")]
        assert s.graph is not None and eng.compile_stats[b]["capture_s"] > 0
        x = torch.from_numpy(rng.normal(size=(b, *eng.input_shape))
                             .astype(np.float32)).cuda()
        before = graphs_launches()
        got = eng.run_padded(x)
        moved = {k: v - before[k] for k, v in graphs_launches().items()
                 if v != before[k]}
        assert moved == s.launch_names()
        assert torch.equal(got, eng._forward(x))
        if kind == "mha":
            assert moved == {"flash_fwd": 2}
        elif kind == "int8":
            assert moved.get("conv_int8_fused", 0) >= 3
    assert eng.graphs.bytes() > 0


def graphs_launches():
    return {w.__name__: w.launches for w in _kernels.COUNTED}


def test_decode_replays_equal_eager_at_every_lattice_point():
    """``DecodeEngine`` on the card: at every (batch, pages) point the
    replayed step equals the eager step on a copy of the pool bit for bit:
    next tokens, logits and the pool's pages after the writes."""
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.serve import DecodeEngine

    model = create_model("mha_decoder").init(
        generator=torch.Generator().manual_seed(0), device="cuda")
    eng = DecodeEngine(model, max_slots=4, page_size=8, max_pages_per_seq=4,
                       num_pages=24)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        eng.pool.k.normal_()
        eng.pool.v.normal_()
    for (b, mp, _), s in sorted(eng.sessions.items()):
        assert s.graph is not None
        table = np.zeros((b, mp), np.int64)
        pos = np.full(b, -1, np.int64)
        for r in range(b - 1):  # the last row stays inactive
            pos[r] = rng.integers(0, mp * 8)
            table[r, :pos[r] // 8 + 1] = rng.choice(
                np.arange(1, 24), pos[r] // 8 + 1, replace=False)
        tok = rng.integers(0, 64, b)
        pk, pv = eng.pool.k.clone(), eng.pool.v.clone()
        nxt, logits, _, _ = eng.run_step(tok, pos, table, eng.pool.k,
                                         eng.pool.v)
        dev = [torch.from_numpy(a).cuda() for a in (tok, pos, table)]
        want_nxt, want_logits = eng._step(*dev, pk, pv)
        assert torch.equal(nxt, want_nxt) and torch.equal(logits, want_logits)
        assert torch.equal(eng.pool.k, pk) and torch.equal(eng.pool.v, pv)


def _train_pair(kind):
    """Two copies of one model on the card, its optimizer, and 6 batches
    (the fourth all NaN for the guarded kind)."""
    from dcnn_tpu_torch.optim import Adam, AdamW

    rng = np.random.default_rng(5)
    if kind == "cnn_bn":
        base = _narrow_cnn()
        xs = rng.normal(size=(6, 8, 3, 16, 16)).astype(np.float32)
        opt = AdamW(1e-3, weight_decay=1e-4)
    else:
        base = _narrow_mha("cpu", dropout=0.2 if kind == "mha_dropout"
                           else 0.0)
        xs = rng.normal(size=(6, 8, 16, 32)).astype(np.float32)
        opt = Adam(1e-3)
    if kind == "guarded":
        xs[3] = np.nan
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (6, 8))]
    return ([copy.deepcopy(base).to("cuda") for _ in range(2)], opt,
            [torch.from_numpy(a).cuda() for a in xs],
            [torch.from_numpy(a).cuda() for a in ys])


@pytest.mark.parametrize("kind", ["mha_dropout", "cnn_bn", "guarded"])
def test_replayed_train_steps_equal_eager_steps(kind, _deterministic_cudnn):
    """Six steps through ``make_train_step(jit=True)`` (the first eager, the
    second captured, then replays; the guarded kind as two graphs around
    the host's read) against six ``jit=False`` steps from the same weights,
    batches and generators: losses, logits, params, BN statistics, the
    optimizer's moments and step count equal bit for bit, the NaN batch
    skipped on both; the flash launches count two of each kernel a step."""
    models, opt, xs, ys = _train_pair(kind)
    out = []
    for model, jit in zip(models, (True, False)):
        ts = create_train_state(model, opt)
        step = make_train_step(model, get_loss("softmax_crossentropy"), opt,
                               guard=kind == "guarded", jit=jit)
        res = []
        for i, (x, y) in enumerate(zip(xs, ys)):
            before = _launches()
            r = step(ts, x, y, 1e-3,
                     torch.Generator(device="cuda").manual_seed(i))
            if kind != "cnn_bn":
                assert tuple(a - b for a, b in zip(_launches(), before)) \
                    == (2, 2, 2)
            res.append([t.cpu() for t in r[:2]] + list(r[2:]))
        if jit:
            assert step._sessions and all(
                s.graph is not None for _, ss in step._sessions.values()
                for s in ss)
        out.append((res, _host_arrays(model, ts.opt_state), ts.step))
    (rg, ag, ng), (re, ae, ne) = out
    for a, b in zip(rg, re):  # bit for bit, the NaN batch's NaNs too
        for u, v in zip(a[:2], b[:2]):
            torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)
        assert a[2:] == b[2:]
    _assert_same(ag, ae)
    assert ng == ne == (5 if kind == "guarded" else 6)
    if kind == "guarded":
        assert rg[3][2] is True


def test_chunked_and_resident_replays_equal_eager(_deterministic_cudnn):
    """``make_multi_step`` (two chunks of four steps) and a resident epoch
    of eight steps with device augmentation, each with ``jit=True`` against
    ``jit=False`` from the same weights: mean losses, params, BN statistics
    and optimizer state bit for bit; the resident epoch's steps after the
    first replay one graph of the whole body."""
    from dcnn_tpu_torch.data import DeviceAugmentBuilder, DeviceDataset
    from dcnn_tpu_torch.data import make_resident_epoch
    from dcnn_tpu_torch.optim import AdamW
    from dcnn_tpu_torch.train import make_multi_step

    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.normal(size=(2, 4, 8, 3, 16, 16))
                          .astype(np.float32)).cuda()
    ys = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (2, 4, 8))]).cuda()
    y = rng.integers(0, 4, 64)
    x = np.clip(y[:, None, None, None] * 50 + 20
                + rng.normal(0, 10, (64, 8, 8, 1)), 0, 255).astype(np.uint8)
    aug = DeviceAugmentBuilder("NHWC").random_crop(2).horizontal_flip(0.5) \
        .brightness(0.1).build()
    base = _narrow_cnn()
    out = []
    for jit in (True, False):
        model = copy.deepcopy(base).to("cuda")
        opt = AdamW(1e-3, weight_decay=1e-4)
        ts = create_train_state(model, opt)
        multi = make_multi_step(model, get_loss("softmax_crossentropy"), opt,
                                jit=jit)
        means = [float(multi(ts, xs[c], ys[c], 7 + c, 1e-3)[1])
                 for c in range(2)]
        feed = _feed_cnn("cuda")
        fopt = SGD(0.05, momentum=0.9)
        fts = create_train_state(feed, fopt)
        ds = DeviceDataset(x, y, 4, batch_size=8, augment=aug, device="cuda")
        epoch = make_resident_epoch(feed, get_loss("softmax_crossentropy"),
                                    fopt, num_classes=4, batch_size=8,
                                    augment=aug, jit=jit)
        fts, mean = epoch(fts, ds.x, ds.y, 3,
                          np.linspace(0.05, 0.01, 8).astype(np.float32))
        out.append((means, float(mean), _host_arrays(model, ts.opt_state),
                    _host_arrays(feed, fts.opt_state)))
        if jit:
            assert [s.graph is not None for _, s in
                    epoch.body._sessions.values()] == [True]
    assert out[0][:2] == out[1][:2]
    _assert_same(out[0][2], out[1][2])
    _assert_same(out[0][3], out[1][3])


def test_capture_with_a_host_read_raises_and_runs_nothing():
    """A loss that reads the card (``.item()``): the first call runs
    eagerly; the second's capture raises naming the step, updates nothing
    and does not fall back to eager. The card works on afterwards. A bare
    session over a host read raises the same way and leaves its in-place
    write undone."""
    from dcnn_tpu_torch.core.graphs import CaptureError, GraphPool, Session

    ce = get_loss("softmax_crossentropy")

    def reading_loss(logits, y):
        loss = ce(logits, y)
        if loss.item() < 0:  # a host read inside the step
            raise AssertionError
        return loss

    model = _narrow_mha("cuda")
    opt = SGD(0.05)
    ts = create_train_state(model, opt)
    step = make_train_step(model, reading_loss, opt)
    x, y = (torch.randn(4, 16, 32, device="cuda"),
            torch.eye(10, device="cuda")[:4])
    step(ts, x, y, 0.05)
    want = _host_arrays(model, ts.opt_state)
    with pytest.raises(CaptureError, match="train_step"):
        step(ts, x, y, 0.05)
    _assert_same(_host_arrays(model, ts.opt_state), want)
    assert ts.step == 1
    t = torch.zeros(3, device="cuda")

    def bad(a):
        t.add_(a)
        return float(t.sum())

    with pytest.raises(CaptureError, match="adder"):
        Session("adder", bad, (torch.ones(3, device="cuda"),),
                pool=GraphPool("cuda"))
    assert float(t.sum()) == 0.0
    assert float(torch.ones(4, device="cuda").sum()) == 4.0


def test_two_threads_replaying_one_engine_get_their_own_answers():
    """Two threads (and a short switch interval) replaying the same
    buckets of one engine 40 times each, each with its own inputs: every
    answer equals that input's single-threaded answer bit for bit."""
    import threading

    eng = _engine("mha")
    rng = np.random.default_rng(9)
    inputs = [rng.normal(size=(n, 16, 32)).astype(np.float32)
              for n in (3, 8)]
    want = [eng.infer(a).cpu() for a in inputs]
    errors = []

    def worker(i):
        try:
            for _ in range(40):
                if not torch.equal(eng.infer(inputs[i]).cpu(), want[i]):
                    errors.append(i)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []


def test_rollback_and_resume_after_capture_train_on_restored_state(tmp_path):
    """After the step's graph is captured, the trainer rolls back to epoch
    1's checkpoint (``_restore`` copies into the tensors the graph writes)
    and trains epoch 2 again; a new trainer resumes from the same
    checkpoint: both equal the uninterrupted run's epoch 2 bit for bit."""
    from dcnn_tpu_torch.optim import Adam

    cfg, params = _narrow_weights()
    rng = np.random.default_rng(15)
    y_idx = rng.integers(0, 10, 64)
    x = rng.normal(0, 0.1, (64, 16, 32)).astype(np.float32)
    x[np.arange(64), y_idx, :8] += 2.5
    y = np.eye(10, dtype=np.float32)[y_idx]

    def trainer(d, resume="never"):
        tm = from_jax(cfg, params, device="cuda")
        opt = Adam(1e-3)
        tr = Trainer(tm, opt, "softmax_crossentropy", TrainingConfig(
            epochs=2, batch_size=16, snapshot_dir=None, progress_interval=0,
            checkpoint_dir=d, checkpoint_every=1, checkpoint_async=False,
            resume=resume, device_type="cuda"))
        return tr, create_train_state(tm, opt)

    def loader():
        return ArrayDataLoader(x, y, batch_size=16, seed=1)

    ref, ts = trainer(str(tmp_path / "ref"))
    ts = ref.fit(ts, loader(), epochs=2)
    want = _host_arrays(ref.model, ts.opt_state)
    d = str(tmp_path / "run")
    tr, ts = trainer(d)
    ts = tr.fit(ts, loader(), epochs=1)
    ld = loader()
    ld.shuffle(2)
    tr.train_epoch(ts, ld, 2)
    assert tr.train_step._sessions  # captured before the rollback
    tr._restore(ts)
    ld.shuffle(2)
    tr.train_epoch(ts, ld, 2)
    _assert_same(_host_arrays(tr.model, ts.opt_state), want)
    res, rts = trainer(d, resume="auto")
    rts = res.fit(rts, loader(), epochs=2)
    _assert_same(_host_arrays(res.model, rts.opt_state), want)


@pytest.mark.parametrize("how", ["checks", "checked", "checked_after_capture"])
def test_debug_paths_run_eagerly_and_keep_their_checks(how):
    """Debug mode's ``checks=True`` (autograd anomaly mode, whose NaN check
    reads the card) and ``checked`` (forward hooks) run the step eagerly on
    the card: three steps raise no CaptureError and equal three
    ``jit=False`` steps bit for bit, and a NaN batch raises
    ``FloatingPointError``, also where ``checked`` wraps a step whose graph
    was captured before."""
    from dcnn_tpu_torch.core.debug import checked, debug_mode

    x = [torch.from_numpy(np.random.default_rng(i).normal(
        size=(4, 16, 32)).astype(np.float32)).cuda() for i in range(4)]
    y = torch.eye(10, device="cuda")[:4]
    base = _narrow_mha("cpu")
    out = []
    for jit in (True, False):
        model = copy.deepcopy(base).to("cuda")
        opt = SGD(0.05, momentum=0.9)
        ts = create_train_state(model, opt)
        inner = step = make_train_step(
            model, get_loss("softmax_crossentropy"), opt, jit=jit)
        if how == "checked_after_capture":
            for xi in x[:3]:
                step(ts, xi, y, 0.05)
            assert not jit or inner._sessions
        if how != "checks":
            step = checked(inner)
        ctx = (debug_mode(nans=False, checks=True) if how == "checks"
               else contextlib.nullcontext())
        with ctx:
            for xi in x[:3]:
                step(ts, xi, y, 0.05)
            if how != "checks":
                with pytest.raises(FloatingPointError, match="checked"):
                    step(ts, torch.full_like(x[3], float("nan")), y, 0.05)
        if how != "checked_after_capture":
            assert not inner._sessions  # nothing was captured
        out.append(_host_arrays(model, ts.opt_state))
    _assert_same(*out)


def test_engine_graphs_follow_the_precision_mode():
    """One engine called in parity mode, then bf16, then parity again: each
    call replays the graph of its mode (bf16's captured at its first use),
    equal bit for bit to the eager forward in that mode, and bf16's logits
    are not parity's."""
    from dcnn_tpu_torch.core import get_precision_mode, set_precision

    eng = _engine("mha")
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(8, *eng.input_shape)).astype(np.float32)).cuda()
    parity = eng.run_padded(x)
    assert get_precision_mode() == "parity"
    set_precision("bf16")
    try:
        first, again = eng.run_padded(x), eng.run_padded(x)
        want = eng._forward(x)
        assert eng.sessions[(8, "bf16")].graph is not None
    finally:
        set_precision("parity")
    assert torch.equal(first, want) and torch.equal(again, want)
    assert not torch.equal(want.float(), parity.float())
    assert torch.equal(eng.run_padded(x), parity)
    assert torch.equal(parity, eng._forward(x))


def test_captured_resident_epoch_refuses_a_host_augment():
    """A resident epoch on the card whose augment is a plain callable, not
    a DeviceAugment, raises rather than capture its draws into a graph;
    with ``jit=False`` it runs."""
    from dcnn_tpu_torch.data import DeviceDataset, make_resident_epoch

    rng = np.random.default_rng(13)
    y = rng.integers(0, 4, 32)
    x = rng.integers(0, 255, (32, 8, 8, 1)).astype(np.uint8)

    def host_augment(xb, key):
        return xb + float(np.random.default_rng(key).normal())

    for jit in (True, False):
        model = _feed_cnn("cuda")
        opt = SGD(0.05)
        ts = create_train_state(model, opt)
        ds = DeviceDataset(x, y, 4, batch_size=8, device="cuda")
        epoch = make_resident_epoch(model, get_loss("softmax_crossentropy"),
                                    opt, num_classes=4, batch_size=8,
                                    augment=host_augment, jit=jit)
        if jit:
            with pytest.raises(TypeError, match="DeviceAugment"):
                epoch(ts, ds.x, ds.y, 3, 0.05)
            assert ts.step == 0
        else:
            ts, mean = epoch(ts, ds.x, ds.y, 3, 0.05)
            assert np.isfinite(float(mean)) and ts.step == 4


def test_trainer_grads_survive_its_eval_graphs(_deterministic_cudnn):
    """A Trainer whose epochs end in a partial batch (its step shape
    captured in epoch 2, after the eval's graph) and whose validation
    replays after it: every parameter's ``.grad`` after ``fit`` equals the
    last step's gradients of an eager twin, bit for bit (the eval graphs
    have a pool of their own)."""
    cfg, params = _narrow_weights()
    rng = np.random.default_rng(16)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 40)]
    x = rng.normal(0, 1, (40, 16, 32)).astype(np.float32)
    grads = []
    for jit in (True, False):
        tm = from_jax(cfg, params, device="cuda")
        opt = SGD(0.05, momentum=0.9)
        tr = Trainer(tm, opt, "softmax_crossentropy", TrainingConfig(
            epochs=3, batch_size=16, snapshot_dir=None, progress_interval=0,
            device_type="cuda"))
        if not jit:
            tr.train_step = make_train_step(tm, tr.loss_fn, opt, jit=False)
        ts = create_train_state(tm, opt)
        tr.fit(ts, ArrayDataLoader(x, y, batch_size=16, seed=1,
                                   drop_last=False),
               ArrayDataLoader(x[:24], y[:24], batch_size=16, shuffle=False,
                               drop_last=False),
               epochs=3)
        grads.append({n: p.grad.cpu() for n, p in tm.named_parameters()})
        if jit:
            assert tr.eval_step.pool is not tr.train_step.pool
            assert len(tr.train_step._sessions) == 2
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


# -- the served program as an artifact, the AOT cache, the checkpoint pool ------

def _artifact_pair(kind):
    """(live engine, artifact engine) on the card: the int8 CNN (quantized
    once) or the fp32 narrow attention classifier, exported on the card."""
    from dcnn_tpu_torch.nn import export_inference, quantize_model
    from dcnn_tpu_torch.serve import InferenceEngine

    if kind == "int8":
        model = _int8_cnn()
        calib = np.random.default_rng(1).normal(
            size=(16, *model.input_shape)).astype(np.float32)
        model = quantize_model(model, calib)
    else:
        model = _narrow_mha("cpu")
    live = InferenceEngine.from_model(copy.deepcopy(model), fold=False,
                                      max_batch=8, device="cuda")
    blob = export_inference(copy.deepcopy(model), device="cuda")
    return live, InferenceEngine.from_artifact(blob, max_batch=8)


@pytest.mark.parametrize("kind", ["int8", "mha"])
def test_artifact_engine_equals_live_engine_at_every_bucket(kind):
    """The exported program served through ``from_artifact``: at every
    bucket its replay equals the live engine's bit for bit and launches
    the same kernels as many times (the fused int8 conv at each site, two
    flash forwards for the attention classifier), and no replay packs a
    weight."""
    live, art = _artifact_pair(kind)
    assert art.batch_invariant == (kind == "int8")
    rng = np.random.default_rng(4)
    for b in art.bucket_sizes:
        x = torch.from_numpy(rng.normal(size=(b, *art.input_shape))
                             .astype(np.float32)).cuda()
        moved = []
        for eng in (live, art):
            before = graphs_launches()
            packs = _kernels.pack_int8_weight.calls
            got = eng.run_padded(x)
            moved.append({k: v - before[k]
                          for k, v in graphs_launches().items()
                          if v != before[k]})
            assert _kernels.pack_int8_weight.calls == packs
            moved[-1]["out"] = got
        assert torch.equal(moved[0].pop("out"), moved[1].pop("out")), b
        assert moved[0] == moved[1]
        if kind == "mha":
            assert moved[1] == {"flash_fwd": 2}
        else:
            assert moved[1].get("conv_int8_fused", 0) >= 3


def _warm_entry(kind, cache):
    """Run ``kind``'s entry point with ``aot_cache=cache`` (False: off) and
    return what it computes, on the host."""
    from dcnn_tpu_torch.models import create_model
    from dcnn_tpu_torch.optim import Adam
    from dcnn_tpu_torch.serve import DecodeEngine, InferenceEngine

    if kind == "engine":
        model = _int8_cnn()
        calib = np.random.default_rng(1).normal(
            size=(16, *model.input_shape)).astype(np.float32)
        eng = InferenceEngine.from_model(model, int8_calib=calib,
                                         max_batch=4, device="cuda",
                                         aot_cache=cache)
        x = np.random.default_rng(2).normal(
            size=(3, *model.input_shape)).astype(np.float32)
        return eng.infer(x).cpu()
    if kind == "trainer":
        model = _narrow_mha("cuda")
        cfg = TrainingConfig(device_type="cuda", epochs=1, snapshot_dir=None,
                             progress_interval=0,
                             aot_cache_dir=cache or None)
        tr = Trainer(model, Adam(1e-3), "softmax_crossentropy", cfg)
        rng = np.random.default_rng(3)
        ld = ArrayDataLoader(
            rng.normal(size=(16, 16, 32)).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)],
            batch_size=8)
        tr.fit(create_train_state(model, tr.optimizer), ld)
        return torch.cat([p.detach().cpu().flatten()
                          for p in model.parameters()])
    model = create_model("mha_decoder").init(
        generator=torch.Generator().manual_seed(0), device="cuda")
    eng = DecodeEngine(model, max_slots=2, page_size=8, max_pages_per_seq=2,
                       aot_cache=cache)
    from dcnn_tpu_torch.serve import decode_reference
    return torch.tensor(decode_reference(eng, [1, 2, 3], max_new_tokens=6))


@pytest.mark.parametrize("kind", ["engine", "trainer", "decode"])
def test_warm_cache_restores_the_kernel_libraries(kind, tmp_path,
                                                  monkeypatch):
    """``InferenceEngine.from_model(aot_cache=)``,
    ``TrainingConfig.aot_cache_dir`` and ``DecodeEngine(aot_cache=)``: a
    cold process commits the kernel libraries it loaded; a warm one, with
    an empty build directory and ``nvcc`` unreachable, restores every
    library from the cache (the engine its program too) and computes bit
    for bit what an uncached run computes."""
    from dcnn_tpu_torch.aot import warm
    from dcnn_tpu_torch.obs.registry import MetricsRegistry
    from dcnn_tpu_torch.utils import compile_cache

    monkeypatch.delenv("AOT_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_SESSIONS", {})
    monkeypatch.setattr(warm, "_CACHES", {})
    plain = _warm_entry(kind, False)
    root = str(tmp_path / "root")
    reg = MetricsRegistry()
    warm.get_cache(root, registry=reg)
    monkeypatch.setattr(_kernels, "_libs", {})
    _warm_entry(kind, root)  # cold: the libraries of _build/ committed
    assert reg.snapshot().get("aot_commits_total", 0) >= len(_kernels.SOURCES)

    def unreachable():
        raise AssertionError("the warm start asked for nvcc")

    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "_nvcc", unreachable)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", os.path.dirname(sys.executable))
    monkeypatch.setenv("DCNN_COMPILE_CACHE", str(tmp_path / "build"))
    hits = reg.snapshot().get("aot_hits_total", 0)
    got = _warm_entry(kind, root)
    restored = reg.snapshot().get("aot_hits_total", 0) - hits
    assert restored == len(_kernels.SOURCES) + (kind == "engine")
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == \
        sorted(_kernels._lib_path(n).name for n in _kernels.SOURCES)
    assert torch.equal(got, plain)


def test_async_checkpoint_saves_reuse_two_pinned_sets(tmp_path):
    """Saves five times faster than the saver writes (each write sleeps):
    the third and later snapshots pin no new host memory (they wait for a
    released set instead), and every committed checkpoint holds the
    arrays of its own save."""
    import time

    from dcnn_tpu_torch.resilience.checkpoint import (CheckpointManager,
                                                      list_steps)
    from dcnn_tpu_torch.train.checkpoint import load_checkpoint

    def slow_write(path, data):
        time.sleep(0.25)
        with open(path, "wb") as f:
            f.write(data)

    model = _narrow_cnn().to("cuda")
    n_tensors = len(list(model.parameters())) + len(list(model.buffers()))
    mgr = CheckpointManager(str(tmp_path), keep=10, io_write=slow_write)
    pinned, want = [], {}
    for step in range(1, 6):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
        want[step] = {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}
        mgr.save_async(step, model)
        pinned.append(mgr.pinned.allocations)
        time.sleep(0.05)
    mgr.wait()
    mgr.close()
    assert pinned[1] == 2 * n_tensors
    assert pinned[2:] == [pinned[1]] * 3, pinned
    steps = list_steps(str(tmp_path))
    assert sorted(steps) == [1, 2, 3, 4, 5]
    for step, path in steps.items():
        got = load_checkpoint(path, device="cpu")[0]
        for k, v in got.state_dict().items():
            assert torch.equal(v, want[step][k]), (step, k)


# -- pipeline parallelism: per-stage streams and the compiled schedules --------

def _pipe_model(kind):
    """A model and a matching (x, y) of 16 samples: the narrow attention
    classifier (an attention block a stage in 2 stages) or the narrow CNN
    (BN, a residual block)."""
    rng = np.random.default_rng(21)
    if kind == "mha":
        model, shape = _narrow_mha("cpu"), (16, 32)
    else:
        model, shape = _narrow_cnn(), (3, 16, 16)
    x = rng.normal(size=(16, *shape)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    return model, x, y


def _pipe_coord(kind, stages):
    from dcnn_tpu_torch.parallel import (FlopBalancedPartitioner,
                                         InProcessPipelineCoordinator)

    model, x, y = _pipe_model(kind)
    coord = InProcessPipelineCoordinator(
        model, SGD(0.01), "softmax_crossentropy", num_stages=stages,
        partitioner=FlopBalancedPartitioner(), num_microbatches=4)
    coord.deploy_stages()
    return coord, x, y


@pytest.mark.parametrize("kind", ["mha", "cnn"])
def test_pipeline_stage_streams_equal_one_stream(kind, _deterministic_cudnn):
    """Every stage on its own CUDA stream, handing off through events, gives
    the losses, logits, params and BN statistics of the same pipeline on one
    stream, bit for bit, over 20 semi-async batches (a missing
    ``record_stream`` or wait shows as a wrong result under load)."""
    stages = 2 if kind == "mha" else 3
    runs = []
    for streams in (True, False):
        coord, x, y = _pipe_coord(kind, stages)
        if not streams:
            for s in coord.stages:
                s.stream = None
        else:
            assert len({s.stream for s in coord.stages}) == stages
        before = _launches()
        out = [coord.train_batch_semi_async(x, y, 0.01, i) for i in range(20)]
        launched = tuple(a - b for a, b in zip(_launches(), before))
        p, s = coord.gathered_params()
        runs.append(([l for l, _ in out], [g.cpu() for _, g in out],
                     {**p, **s}, launched))
    (la, ga, na, ka), (lb, gb, nb, kb) = runs
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(na[n], nb[n]) for n in na)
    if kind == "mha":  # one forward, dQ and dK/dV a stage and microbatch
        assert ka == kb == (2 * 4 * 20,) * 3


def _compiled_setup(kind, schedule, jit):
    """A compiled step over 2 FLOP-balanced stages and 4 microbatches of
    :func:`_pipe_model`, with its params, optimizer state, BN state and
    microbatched (x, y) on the card."""
    from dcnn_tpu_torch.parallel import (FlopBalancedPartitioner,
                                         HeteroCompiledPipeline)

    model, x, y = _pipe_model(kind)
    model = model.to("cuda")
    pipe = HeteroCompiledPipeline(model, 2, 4, device="cuda",
                                  partitioner=FlopBalancedPartitioner())
    params, state = (dict(model.named_parameters()),
                     dict(model.named_buffers()))
    opt = SGD(0.01, momentum=0.9)
    make = (pipe.make_train_step if schedule == "gpipe"
            else pipe.make_train_step_1f1b)
    step = make(get_loss("softmax_crossentropy"), opt, jit=jit)
    xs = torch.from_numpy(x.reshape(4, 4, *x.shape[1:])).cuda()
    ys = torch.from_numpy(y.reshape(4, 4, 10)).cuda()
    return step, params, opt.init(params), state, xs, ys


def _named_host(params, state):
    return {n: t.detach().cpu() for n, t in
            list(params.items()) + list(state.items())}


def _compiled_run(kind, schedule, jit, steps=3):
    step, params, ost, state, xs, ys = _compiled_setup(kind, schedule, jit)
    losses, logits = [], []
    for i in range(steps):
        before = _launches()
        params, ost, state, loss, lg = step(params, ost, state, xs, ys, 5,
                                            0.01)
        losses.append(float(loss))
        logits.append(lg.cpu())
        counted = tuple(a - b for a, b in zip(_launches(), before))
    return losses, logits, _named_host(params, state), step, counted


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("kind", ["mha", "cnn"])
def test_compiled_pipeline_replays_equal_eager(kind, schedule,
                                               _deterministic_cudnn):
    """The whole schedule's step as one CUDA graph (eager first step,
    captured second, replayed third) equals its eager twin bit for bit:
    losses, logits, params, BN statistics, optimizer state; a replay adds
    its capture's launches to the counters."""
    gl, glg, gn, gstep, counted = _compiled_run(kind, schedule, True)
    el, elg, en, _, _ = _compiled_run(kind, schedule, False)
    assert gstep.session() is not None and gstep.session().graph is not None
    assert gl == el
    assert all(torch.equal(a, b) for a, b in zip(glg, elg))
    assert all(torch.equal(gn[n], en[n]) for n in gn)
    if kind == "mha":  # 2 attention blocks x 4 microbatches a replay
        names = gstep.session().launch_names()
        assert {k: names[k] for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")} == dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 8)
        assert counted == (8, 8, 8)


@pytest.mark.parametrize("kind", ["mha", "cnn"])
def test_compiled_pipeline_graphs_follow_the_precision_mode(
        kind, _deterministic_cudnn):
    """A compiled GPipe step run three times in parity mode (eager, capture,
    replay), three in bf16 (its own warm-up, capture and replay) and three
    in parity again (the first graph) equals the same nine steps with
    ``jit=False`` bit for bit: a mode switch never replays the other
    mode's graph."""
    from dcnn_tpu_torch.core import set_precision

    def run(jit):
        step, params, ost, state, xs, ys = _compiled_setup(kind, "gpipe",
                                                           jit)
        losses = []
        for mode in ("parity", "bf16", "parity"):
            set_precision(mode)
            try:
                for _ in range(3):
                    params, ost, state, loss, _ = step(params, ost, state,
                                                       xs, ys, 5, 0.01)
                    losses.append(float(loss))
            finally:
                set_precision("parity")
        return losses, _named_host(params, state), step

    (gl, gn, gstep), (el, en, _) = run(True), run(False)
    assert sorted(k[-1] for k in gstep.compiled.sessions) == ["bf16",
                                                              "parity"]
    assert all(s.graph is not None
               for _, s in gstep.compiled.sessions.values())
    assert gl == el
    assert all(torch.equal(gn[n], en[n]) for n in gn)


@pytest.mark.parametrize("how", ["checks", "checked", "checked_after_capture"])
def test_compiled_pipeline_debug_paths_run_eagerly(how, _deterministic_cudnn):
    """Debug mode's ``checks=True`` and ``checked`` run the compiled
    pipeline's step eagerly: three steps raise no CaptureError and equal
    three ``jit=False`` steps bit for bit, nothing is captured under them,
    and a NaN batch raises ``FloatingPointError`` from ``checked``'s hooks,
    also where the step's graph was captured before."""
    from dcnn_tpu_torch.core.debug import checked, debug_mode

    out = []
    for jit in (True, False):
        step, params, ost, state, xs, ys = _compiled_setup("mha", "gpipe",
                                                           jit)
        live = [params, ost, state]

        def go(fn, x):
            got = fn(*live, x, ys, 5, 0.01)
            live[:] = got[:3]
            return float(got[3])

        if how == "checked_after_capture":
            for _ in range(3):
                go(step, xs)
            assert not jit or step.session().graph is not None
        fn = (step if how == "checks"
              else checked(step, model=step.pipe.model))
        ctx = (debug_mode(nans=False, checks=True) if how == "checks"
               else contextlib.nullcontext())
        with ctx:
            losses = [go(fn, xs) for _ in range(3)]
            if how != "checks":
                with pytest.raises(FloatingPointError, match="checked"):
                    go(fn, torch.full_like(xs, float("nan")))
        if how != "checked_after_capture":
            assert step.session() is None  # nothing was captured
        out.append((losses, _named_host(live[0], live[2])))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(out[0][1][n], out[1][1][n]) for n in out[0][1])


def test_compiled_pipeline_1f1b_peak_memory_below_gpipe(_deterministic_cudnn):
    """1F1B holds at most S stage graphs a stage, GPipe M: with M=8 and
    S=2 1F1B's peak device memory in an eager step is below GPipe's."""
    from dcnn_tpu_torch.nn import SequentialBuilder as Builder
    from dcnn_tpu_torch.parallel import HeteroCompiledPipeline

    peaks = {}
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(8, 16, 3, 32, 32))
                          .astype(np.float32)).cuda()
    ys = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (8, 16))]).cuda()
    for schedule in ("gpipe", "1f1b"):
        model = (Builder("mem").input((3, 32, 32))
                 .conv2d(32, 3, 1, 1).batchnorm().activation("relu")
                 .conv2d(32, 3, 1, 1).batchnorm().activation("relu")
                 .conv2d(32, 3, 1, 1).batchnorm().activation("relu")
                 .flatten().dense(10).build())
        pipe = HeteroCompiledPipeline(model, 2, 8, device="cuda")
        params, state = pipe.init(torch.Generator().manual_seed(0))
        opt = SGD(0.01)
        make = (pipe.make_train_step if schedule == "gpipe"
                else pipe.make_train_step_1f1b)
        step = make(get_loss("softmax_crossentropy"), opt, jit=False)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(params, opt.init(params), state, xs, ys, 0, 0.01)
        torch.cuda.synchronize()
        peaks[schedule] = torch.cuda.max_memory_allocated() - base
        assert step.peak_stash == ([8, 8] if schedule == "gpipe" else [2, 1])
    assert peaks["1f1b"] < peaks["gpipe"], peaks


def test_compiled_homogeneous_stack_replays_equal_eager():
    """The homogeneous stack's step (GroupNorm residual blocks, remat) as
    one graph equals its eager twin bit for bit."""
    from dcnn_tpu_torch.nn import Conv2DLayer, GroupNormLayer, ResidualBlock
    from dcnn_tpu_torch.parallel import (SequentialStageStack,
                                         make_compiled_pipeline_train_step)

    def run(jit):
        block = ResidualBlock(layers=[Conv2DLayer(8, 3, 1, 1),
                                      GroupNormLayer(2)])
        stack = SequentialStageStack(block, 4, (8, 8, 8))
        sp = stack.init(torch.Generator().manual_seed(0), device="cuda")
        opt = SGD(0.05)
        ost = opt.init(sp)
        step = make_compiled_pipeline_train_step(
            stack.stage_fn, lambda a, b: ((a - b) ** 2).mean(), opt, 4, 6,
            jit=jit)
        rng = np.random.default_rng(4)
        xs, ys = (torch.from_numpy(rng.normal(size=(6, 2, 8, 8, 8))
                                   .astype(np.float32)).cuda()
                  for _ in range(2))
        losses = [float(step(sp, ost, xs, ys, 0.05)[2]) for _ in range(3)]
        return losses, {n: t.detach().cpu() for n, t in sp.items()}

    (gl, gp), (el, ep) = run(True), run(False)
    assert gl == el
    assert all(torch.equal(gp[n], ep[n]) for n in gp)


def test_compiled_homogeneous_stack_runs_eagerly_in_anomaly_mode():
    """The homogeneous step, which has no model to look at, still runs
    eagerly while autograd's anomaly mode is on (debug mode's
    ``checks=True``): no CaptureError, nothing captured, and the numbers
    of ``jit=False`` bit for bit."""
    from dcnn_tpu_torch.core.debug import debug_mode
    from dcnn_tpu_torch.nn import Conv2DLayer, GroupNormLayer, ResidualBlock
    from dcnn_tpu_torch.parallel import (SequentialStageStack,
                                         make_compiled_pipeline_train_step)

    def run(jit):
        block = ResidualBlock(layers=[Conv2DLayer(8, 3, 1, 1),
                                      GroupNormLayer(2)])
        stack = SequentialStageStack(block, 4, (8, 8, 8))
        sp = stack.init(torch.Generator().manual_seed(0), device="cuda")
        opt = SGD(0.05)
        ost = opt.init(sp)
        step = make_compiled_pipeline_train_step(
            stack.stage_fn, lambda a, b: ((a - b) ** 2).mean(), opt, 4, 6,
            jit=jit)
        rng = np.random.default_rng(4)
        xs, ys = (torch.from_numpy(rng.normal(size=(6, 2, 8, 8, 8))
                                   .astype(np.float32)).cuda()
                  for _ in range(2))
        with debug_mode(nans=False, checks=True):
            losses = [float(step(sp, ost, xs, ys, 0.05)[2])
                      for _ in range(3)]
        assert not step.compiled.sessions
        return losses, {n: t.detach().cpu() for n, t in sp.items()}

    (gl, gp), (el, ep) = run(True), run(False)
    assert gl == el
    assert all(torch.equal(gp[n], ep[n]) for n in gp)


# -- the TCP pipeline: stage workers as processes of their own on the card --

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcp_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    env.update(extra)
    return env


def _tcp_workers(n, codec="raw"):
    """``n`` ``python -m dcnn_tpu_torch.parallel.worker --deterministic``
    processes on the card, on free ports."""
    return [_smoke.TcpWorker(p, codec) for p in _smoke.free_ports(n)]


def _tcp_coordinator(model, addrs, micro=2, **kw):
    from dcnn_tpu_torch.parallel import (
        DistributedPipelineCoordinator, PipelineTimeouts,
    )

    co = DistributedPipelineCoordinator(
        model, SGD(0.05, momentum=0.9), "softmax_crossentropy",
        addrs, num_microbatches=micro, device="cuda",
        timeouts=PipelineTimeouts(batch_s=300.0, heartbeat_s=1.0,
                                  connect_s=300.0), **kw)
    co.deploy_stages()
    return co


def _tcp_cnn():
    return (SequentialBuilder("tcp_cnn").input((3, 8, 8))
            .conv2d(8, 3, 1, 1).batchnorm().activation("relu")
            .conv2d(8, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(10).build())


def test_tcp_workers_on_card_equal_in_process(_deterministic_cudnn):
    """Two CUDA worker processes under both schedules: every loss, logit,
    parameter and BN statistic bit for bit the in-process coordinator's on
    the card (cuDNN deterministic on both sides)."""
    from dcnn_tpu_torch.parallel import InProcessPipelineCoordinator

    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(8, 3, 8, 8)).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)])
               for _ in range(3)]
    g = torch.Generator().manual_seed(0)
    workers = _tcp_workers(2, "shuffle-lz4")
    try:
        co = _tcp_coordinator(_tcp_cnn().init(generator=g, device="cuda"),
                              [w.addr for w in workers],
                              compress="shuffle-lz4")
        ref = InProcessPipelineCoordinator(
            _tcp_cnn().init(generator=torch.Generator().manual_seed(0),
                            device="cuda"),
            SGD(0.05, momentum=0.9), "softmax_crossentropy", 2,
            num_microbatches=2)
        ref.deploy_stages()
        for schedule in ("sync", "semi_async"):
            for b, (x, y) in enumerate(batches):
                got = getattr(co, f"train_batch_{schedule}")(x, y, 0.05, b)
                want = getattr(ref, f"train_batch_{schedule}")(x, y, 0.05, b)
                assert got[0] == want[0]
                assert torch.equal(got[1], want[1])
        p, s = co.gathered_params()
        rp, rs = ref.gathered_params()
        assert all(torch.equal(p[n], rp[n]) for n in rp)
        assert all(torch.equal(s[n], rs[n]) for n in rs)
        co.shutdown()
        lines = [w.result() for w in workers]
        assert all(l["device"] == torch.cuda.get_device_name(0)
                   for l in lines)
    finally:
        for w in workers:
            w.close()


def test_tcp_worker_shutdown_line_counts_flash():
    """A narrow mha classifier over 2 CUDA workers, an attention block in
    each stage: each worker's shutdown line counts one flash forward, dQ
    and dK/dV a microbatch it trained, and a forward-only call adds one
    forward."""
    from dcnn_tpu_torch.nn import ResidualBlock
    from dcnn_tpu_torch.parallel import Partitioner

    class OneBlockFirst(Partitioner):
        def get_partitions(self, model, num_stages):
            return [(0, 1), (1, 4)]

    def block(name):
        return ResidualBlock(layers=[MultiHeadAttentionLayer(
            num_heads=2, impl="flash", name=f"{name}_mha")], shortcut=[],
            activation="relu", name=name)

    model = (SequentialBuilder("tcp_mha").input((8, 16)).add_layer(block("a0"))
             .add_layer(block("a1")).flatten("flatten")
             .dense(10, True, "head").build())
    model.init(generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(1)
    workers = _tcp_workers(2)
    try:
        co = _tcp_coordinator(model, [w.addr for w in workers],
                              partitioner=OneBlockFirst())
        assert co.partitions == [(0, 1), (1, 4)]
        for b in range(3):
            x = rng.normal(size=(8, 8, 16)).astype(np.float32)
            y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
            co.train_batch_semi_async(x, y, 0.05, b)
        co.forward_only(x)
        co.shutdown()
        for w in workers:
            got = w.result()["launches"]
            assert (got["flash_fwd"], got["flash_bwd_dq"],
                    got["flash_bwd_dkv"]) == (3 * 2 + 1, 3 * 2, 3 * 2)
    finally:
        for w in workers:
            w.close()


def test_bf16_frame_roundtrips_from_cuda_tensor():
    """A bf16 activation made on a side stream goes out of a channel
    through one pinned copy on that stream and comes back bit for bit."""
    import socket
    import threading

    from dcnn_tpu_torch.parallel.comm import Channel

    a, b = socket.socketpair()
    tx, rx = Channel(a), Channel(b)
    side = torch.cuda.Stream()
    got = {}
    reader = threading.Thread(target=lambda: got.update(frame=rx.recv()))
    reader.start()
    try:
        with torch.cuda.stream(side):
            t = (torch.randn(64, 257, device="cuda") * 3).to(torch.bfloat16)
            t = t * 2  # queued work the send must wait for
            tx.send("ACT", {"mb_id": 0}, array=t)
        reader.join(30)
        cmd, meta, got = got["frame"]
        assert (cmd, meta) == ("ACT", {"mb_id": 0})
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert torch.equal(got, t.cpu())
    finally:
        tx.close()
        rx.close()


def test_four_workers_on_a_cold_kernel_cache_build_the_same_libraries(
        tmp_path):
    """Four processes building the kernels at once into one empty cache
    root (each its own ``nvcc`` runs, renamed into place): all end with the
    same libraries, loaded, and no temporary file is left."""
    import json
    import subprocess

    code = ("import json\n"
            "from dcnn_tpu_torch.ops import _kernels\n"
            "libs = _kernels.build()\n"
            "print(json.dumps(sorted(l._name for l in libs.values())))\n")
    env = _tcp_env(DCNN_COMPILE_CACHE=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=_ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=1800) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    libs = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert all(l == libs[0] for l in libs)
    assert len(libs[0]) == len(_kernels.SOURCES)
    names = sorted(os.path.basename(p) for p in libs[0])
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".so")) == \
        names
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_tcp_failed_kernel_launch_is_a_worker_error(monkeypatch):
    """A kernel that fails to launch in a worker (two worker threads on the
    card) surfaces at the coordinator as ``PipelineWorkerError`` with the
    launch's error, never as a run elsewhere; the next batch trains."""
    import threading

    from dcnn_tpu_torch.nn import ResidualBlock
    from dcnn_tpu_torch.parallel import PipelineWorkerError, StageWorker, comm

    def block(name):
        return ResidualBlock(layers=[MultiHeadAttentionLayer(
            num_heads=2, impl="flash", name=f"{name}_mha")], shortcut=[],
            activation="relu", name=name)

    model = (SequentialBuilder("tcp_fail").input((8, 16))
             .add_layer(block("a0")).add_layer(block("a1")).flatten("flatten")
             .dense(10, True, "head").build())
    model.init(generator=torch.Generator().manual_seed(0), device="cuda")
    socks = [comm.listen(0, host="127.0.0.1") for _ in range(2)]
    workers = [StageWorker(0, listen_sock=s, device="cuda") for s in socks]
    threads = [threading.Thread(target=w.serve, daemon=True) for w in workers]
    for t in threads:
        t.start()
    addrs = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 8, 16)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    try:
        co = _tcp_coordinator(model, addrs)

        def failing(*a, **k):
            raise RuntimeError("flash_fwd: CUDA error: injected launch failure")

        before = _launches()
        with monkeypatch.context() as m:
            m.setattr(_kernels, "flash_fwd", failing)
            with pytest.raises(PipelineWorkerError, match="injected launch"):
                co.train_batch_sync(x, y, 0.05, 0)
        assert _launches() == before  # nothing ran in its place
        loss, _ = co.train_batch_sync(x, y, 0.05, 1)
        assert np.isfinite(loss)
        co.shutdown()
    finally:
        for w in workers:
            w.stop()
        for t in threads:
            t.join(timeout=30)


# ------------------------------------------------------------- router tier

def _router_versions(tmp_path, seed=0):
    """A checkpoint root with v1 and v2 (v2 = v1 plus noise) of a small
    NHWC CNN, its calibration batch saved beside it, and a request pool."""
    from dcnn_tpu_torch.resilience.checkpoint import CheckpointManager

    model = (SequentialBuilder(name="rt", data_format="NHWC")
             .input((16, 16, 3)).conv2d(16, 3, padding=1).batchnorm()
             .activation("relu").maxpool2d(2).conv2d(32, 3, padding=1)
             .activation("relu").flatten().dense(10).build()).init(
        generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, keep=5)
    mgr.save(1, model)
    mgr.save(2, _smoke.perturbed(model, rng))
    mgr.close()
    calib = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    np.save(tmp_path / "calib.npy", calib)
    pool = rng.normal(size=(32, 16, 16, 3)).astype(np.float32)
    return root, calib, pool


def test_router_local_replica_swap_frees_the_old_pool(tmp_path):
    """Each hot swap gives the retired int8 engine's graph pool back (0 B)
    and ``memory_reserved`` stays within one engine's pool of where it
    started; the swapped replica answers bit for bit a fresh engine of its
    version."""
    from dcnn_tpu_torch.serve import EngineFactory, LocalReplica

    root, calib, pool = _router_versions(tmp_path)
    factory = EngineFactory(root, max_batch=8, int8_calib=calib)
    rep = LocalReplica(factory, 1, name="r0")
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_reserved()
        one_pool = rep._engine.graphs.bytes()
        assert one_pool > 0
        for v in (2, 1, 2):
            old = rep._engine.graphs
            rep.swap(v)
            assert rep.version == v
            assert old.bytes() == 0
            assert torch.cuda.memory_reserved() - base <= one_pool
        fresh = factory(2)
        for n in (1, 3, 8):
            got = rep.submit(pool[:n]).result(timeout=60)
            np.testing.assert_array_equal(got,
                                          fresh.infer(pool[:n]).cpu().numpy())
    finally:
        rep.close()


def test_router_capture_during_another_replicas_traffic(tmp_path):
    """Replica b swaps (its new engine's eager calls and captures, the old
    pool's release) while replica a's dispatcher replays on the same card:
    every one of a's answers is bit for bit v1's, and b then serves v2."""
    import threading

    from dcnn_tpu_torch.serve import EngineFactory, LocalReplica

    root, calib, pool = _router_versions(tmp_path)
    factory = EngineFactory(root, max_batch=8, int8_calib=calib)
    refs = {v: factory(v).infer(pool).cpu().numpy() for v in (1, 2)}
    a = LocalReplica(factory, 1, name="a")
    b = LocalReplica(factory, 1, name="b")
    stop, got, errors = threading.Event(), [], []

    def serve():
        i = 0
        while not stop.is_set():
            idx = (np.arange(1 + i % 8) + i) % len(pool)
            try:
                got.append((idx, a.submit(pool[idx]).result(timeout=60)))
            except Exception as e:  # noqa: BLE001 (asserted below)
                errors.append(e)
            i += 1

    t = threading.Thread(target=serve)
    t.start()
    try:
        for v in (2, 1, 2):
            b.swap(v)
    finally:
        stop.set()
        t.join()
        a.close()
    try:
        assert not errors, errors[:3]
        assert got
        for idx, y in got:
            np.testing.assert_array_equal(y, refs[1][idx])
        np.testing.assert_array_equal(b.submit(pool[:4]).result(timeout=60),
                                      refs[2][:4])
    finally:
        b.close()


def test_router_tcp_replica_over_a_child_process(tmp_path):
    """A ``ReplicaServer`` in a child process on the card (``python
    chip_smoke.py --replica-server``: its own CUDA context, the kernels
    this process built, int8 from the calibration batch saved beside the
    checkpoints) behind a ``TcpReplica`` and a ``Router``: its int8 logits
    bit for bit this process's engine of the same version, before and
    after a remote swap; its shutdown line counts ``conv_int8_fused`` at
    the model's 2 convs a replayed batch."""
    from dcnn_tpu_torch.serve import EngineFactory, Router, TcpReplica

    root, _, pool = _router_versions(tmp_path)
    calib_path = str(tmp_path / "calib.npy")
    factory = EngineFactory(root, max_batch=32,
                            int8_calib=np.load(calib_path))
    port = _smoke.free_ports(1)[0]
    child = _smoke.ReplicaChild(port, root, 1, "child", calib=calib_path)
    try:
        child.wait()
        cli = TcpReplica("127.0.0.1", port, name="child", timeout_s=30.0,
                         connect_timeout=60.0)
        router = Router([cli])
        for v in (1, 2):
            if v == 2:
                router.swap_replica("child", 2)
            want = factory(v).infer(pool).cpu().numpy()
            futs = [router.submit(pool[i]) for i in range(8)]
            futs.append(router.submit(pool[8:13]))
            for i, f in enumerate(futs[:8]):
                np.testing.assert_array_equal(f.result(timeout=60), want[i])
            np.testing.assert_array_equal(futs[8].result(timeout=60),
                                          want[8:13])
        router.shutdown()
        cli.close()
        line = child.result()
    finally:
        child.close()
    assert line["version"] == 2 and line["engines"] == 2
    assert line["batches"] > 0
    assert line["launches"]["conv_int8_fused"] == 2 * line["dispatched"]


# --------------------------------------------------------- autoscaling

def _autoscaled_fleet(tmp_path):
    """A ``Router`` over one int8 engine replica of v1 and an
    ``Autoscaler`` whose factory builds more from the same
    ``EngineFactory``; its scrape reads breach or idle text on demand."""
    from dcnn_tpu_torch.obs.exposition import render_scalar
    from dcnn_tpu_torch.serve import (Autoscaler, AutoscalerConfig,
                                      EngineFactory, LocalReplica, Router)

    root, calib, pool = _router_versions(tmp_path)
    engines = EngineFactory(root, max_batch=8, int8_calib=calib)
    made = []

    def factory(version):
        rep = LocalReplica(engines, version, name=f"as{len(made)}")
        made.append(rep)
        return rep

    router = Router([factory(1)])
    mode = {"depth": 30.0, "p99": 1000.0}

    def scrape(name, replica):
        return "\n".join(
            render_scalar("serve_queue_depth", "gauge", mode["depth"])
            + render_scalar("serve_latency_window_p99_ms", "gauge",
                            mode["p99"])) + "\n"

    scaler = Autoscaler(router, factory, scrape=scrape, config=
                        AutoscalerConfig(up_cooldown_s=0.0,
                                         down_cooldown_s=0.0,
                                         breach_ticks=1, idle_ticks=1,
                                         max_replicas=2))
    return router, scaler, made, mode, engines, pool


def test_autoscale_up_builds_an_engine_replica_that_serves(tmp_path):
    """A scale-up on a breach builds a real int8 engine replica (its
    buckets captured as graphs) while the first serves; requests routed
    to the new one answer bit for bit a fresh engine of the version."""
    router, scaler, made, _mode, engines, pool = _autoscaled_fleet(tmp_path)
    try:
        out = scaler.tick()
        assert out["action"] == "up" and len(made) == 2
        new = made[1]
        assert new._engine.graphs.bytes() > 0
        want = engines(1).infer(pool).cpu().numpy()
        got = new.submit(pool[:5]).result(timeout=60)
        np.testing.assert_array_equal(got, want[:5])
        futs = [router.submit(pool[i]) for i in range(16)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=60), want[i])
        assert new.metrics.snapshot()["requests_completed"] > 0
        snap = router.metrics.registry.snapshot()
        assert snap["autoscale_spinup_seconds"]["count"] == 1
    finally:
        router.shutdown()
        for r in made:
            r.close()


def test_autoscale_down_leaves_the_retired_pool_empty(tmp_path):
    """The scale-down drains and decommissions the replica the autoscaler
    built and closes it: its engine's graph pool reads 0 B, and the
    survivor still serves."""
    router, scaler, made, mode, engines, pool = _autoscaled_fleet(tmp_path)
    try:
        assert scaler.tick()["action"] == "up"
        victim = made[1]
        mode.update(depth=0.0, p99=1.0)
        out = scaler.tick()
        assert out["action"] == "down" and out["removed"] == victim.name
        assert out["drain"]["swept"] == 0
        assert victim._engine.graphs.bytes() == 0
        assert made[0]._engine.graphs.bytes() > 0
        want = engines(1).infer(pool[:3]).cpu().numpy()
        np.testing.assert_array_equal(
            router.submit(pool[:3]).result(timeout=60), want)
    finally:
        router.shutdown()
        for r in made:
            r.close()
    assert made[0]._engine.graphs.bytes() == 0


# ---------------------------------------------------------------------------
# data parallelism: the mesh step over NCCL, the elastic fit
# ---------------------------------------------------------------------------

@pytest.fixture
def _nccl_world_of_one():
    from dcnn_tpu_torch.parallel import multihost

    multihost.initialize(num_processes=1, backend="nccl")
    try:
        yield
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("kind", ["cnn_bn", "mha_dropout"])
def test_nccl_world_of_one_step_replays_bit_for_bit(kind, _nccl_world_of_one,
                                                    _deterministic_cudnn):
    """``make_data_parallel_train_step`` over a world of 1 on NCCL: the
    whole step (the BN sums', gradients' and loss's all-reduces included)
    captured as one graph and replayed, against the same step eager and
    against ``make_train_step``: losses, logits, params, BN statistics and
    the optimizer state equal bit for bit over six steps."""
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import (make_data_parallel_train_step,
                                         shard_batch)

    mesh = make_mesh()
    assert mesh.shape == {"data": 1}
    models, opt, xs, ys = _train_pair(kind)
    models.append(copy.deepcopy(models[0]))
    loss = get_loss("softmax_crossentropy")
    out = []
    for i, model in enumerate(models):
        ts = create_train_state(model, opt)
        step = (make_train_step(model, loss, opt, jit=False) if i == 2 else
                make_data_parallel_train_step(model, loss, opt, mesh,
                                              jit=i == 0))
        res = []
        for j, (x, y) in enumerate(zip(xs, ys)):
            x, y = shard_batch((x, y), mesh)
            lv, logits = step(ts, x, y, 1e-3,
                              torch.Generator(device="cuda").manual_seed(j))
            res.append((lv.cpu(), logits.cpu()))
        if i == 0:
            assert step._sessions.latest()[0].graph is not None
        out.append((res, [t.detach().cpu() for t in
                          (*model.parameters(), *model.buffers())],
                    ts.opt_state))
    for other in out[1:]:
        for (la, oa), (lb, ob) in zip(out[0][0], other[0]):
            assert torch.equal(la, lb) and torch.equal(oa, ob)
        for a, b in zip(out[0][1], other[1]):
            assert torch.equal(a, b)
        for n in out[0][2]["m"]:
            assert torch.equal(out[0][2]["m"][n], other[2]["m"][n])
            assert torch.equal(out[0][2]["v"][n], other[2]["v"][n])


def test_nccl_world_of_one_spatial_step_is_the_mesh_step(
        _nccl_world_of_one, _deterministic_cudnn):
    """``make_data_parallel_train_step(spatial_axis="sp")`` over a (data 1,
    sp 1) mesh on NCCL, replayed as one graph and eager, against the mesh
    step without ``spatial_axis``: losses, logits, params, BN statistics
    and the optimizer's moments equal bit for bit over six steps."""
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import (make_data_parallel_train_step,
                                         shard_batch)

    mesh = make_mesh((1, 1), ("data", "sp"))
    models, opt, xs, ys = _train_pair("cnn_bn")
    models.append(copy.deepcopy(models[0]))
    loss = get_loss("softmax_crossentropy")
    out = []
    for i, model in enumerate(models):
        ts = create_train_state(model, opt)
        spatial = "sp" if i < 2 else None
        step = make_data_parallel_train_step(model, loss, opt, mesh,
                                             spatial_axis=spatial,
                                             jit=i == 0)
        res = []
        for j, (x, y) in enumerate(zip(xs, ys)):
            x, y = shard_batch((x, y), mesh, spatial_axis=spatial)
            lv, logits = step(ts, x, y, 1e-3,
                              torch.Generator(device="cuda").manual_seed(j))
            res.append((lv.cpu(), logits.cpu()))
        if i == 0:
            assert step._sessions.latest()[0].graph is not None
        out.append((res, [t.detach().cpu() for t in
                          (*model.parameters(), *model.buffers())],
                    ts.opt_state))
    for other in out[1:]:
        for (la, oa), (lb, ob) in zip(out[0][0], other[0]):
            assert torch.equal(la, lb) and torch.equal(oa, ob)
        for a, b in zip(out[0][1], other[1]):
            assert torch.equal(a, b)
        for n in out[0][2]["m"]:
            assert torch.equal(out[0][2]["m"][n], other[2]["m"][n])
            assert torch.equal(out[0][2]["v"][n], other[2]["v"][n])


def test_metrics_port_fit_on_card_serves_goodput():
    """``Trainer.fit`` on the card with ``metrics_port=0`` and the tracer
    on: ``/goodput`` scraped mid-fit (gated on the loader, no sleeps)
    answers a window whose buckets and unattributed residue sum to its
    wall, and ``mfu_live`` is set on an H100 (the card's peak known)."""
    import json
    import threading
    import urllib.request

    from dcnn_tpu_torch.obs import configure

    model = _narrow_cnn().to("cuda")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 3, 16, 16)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    docs = []

    class Scraped(ArrayDataLoader):
        def __iter__(self):
            for i, b in enumerate(super().__iter__()):
                if i == 6:
                    srv = trainer.telemetry
                    trainer._tsdb.sample_once()  # a window now, no waiting
                    with urllib.request.urlopen(srv.url + "/goodput",
                                                timeout=10) as r:
                        docs.append(json.loads(r.read()))
                yield b

    old = os.environ.get("DCNN_GOODPUT_WINDOW")
    os.environ["DCNN_GOODPUT_WINDOW"] = "60"
    tracer = configure(enabled=True)
    try:
        trainer = Trainer(model, SGD(0.05), "softmax_crossentropy",
                          TrainingConfig(epochs=1, batch_size=8,
                                         metrics_port=0, snapshot_dir=None,
                                         progress_interval=0))
        trainer.fit(create_train_state(model, trainer.optimizer),
                    Scraped(x, y, batch_size=8, seed=3))
    finally:
        configure(enabled=False)
        tracer.clear()
        if old is None:
            os.environ.pop("DCNN_GOODPUT_WINDOW")
        else:
            os.environ["DCNN_GOODPUT_WINDOW"] = old
    assert docs and trainer.telemetry is None
    led = docs[0]["ledger"]
    assert led["wall_s"] > 0 and led["steps"] >= 5
    total = sum(led["buckets"].values()) + led["unattributed_s"]
    assert abs(total - led["wall_s"]) <= 1e-9 * led["wall_s"]
    if "H100" in torch.cuda.get_device_name(0):
        assert led["mfu_live"] is not None and led["mfu_live"] > 0


def test_elastic_solo_fit_on_card_matches_the_cpu():
    """``Trainer.fit`` with ``elastic=True`` alone (world 1, K=2, SGD: no
    Adam noise floor) on the card and on the CPU from the same weights
    and rows: the grad step's graph replays (its flash launches counted),
    the losses and final params agree to 1e-4 of their scale."""
    base = _narrow_mha("cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 16, 32)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        cfg = TrainingConfig(epochs=2, learning_rate=0.05, seed=3,
                             snapshot_dir=None, elastic=True, elastic_rank=0,
                             elastic_microbatches=2, elastic_heartbeat_s=0.0,
                             device_type=dev)
        trainer = Trainer(model, SGD(0.05), "softmax_crossentropy", cfg)
        ts = trainer.fit(create_train_state(model, trainer.optimizer),
                         ArrayDataLoader(x, y, batch_size=16, seed=3))
        out[dev] = (trainer.history, [p.detach().cpu()
                                      for p in ts.model.parameters()],
                    trainer.elastic)
    (hg, pg, cg), (hc, pc, _) = out["cuda"], out["cpu"]
    assert [h["world"] for h in hg] == [1, 1]
    for a, b in zip(hg, hc):
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-4 * abs(
            b["train_loss"])
    for a, b in zip(pg, pc):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            b.abs().max().item(), 1.0)
    replayed = {}
    for g in cg._grad_steps.values():
        for k, n in g.launches.items():
            replayed[k] = replayed.get(k, 0) + n
    assert all(replayed.get(k, 0) > 0
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


# ---------------------------------------------------------------------------
# sequence parallelism: ring, zigzag and Ulysses over NCCL at world 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,causal", [("ring", False), ("ring", True),
                                         ("zigzag", True),
                                         ("ulysses", False),
                                         ("ulysses", True)])
def test_sequence_ring_zigzag_ulysses_world_of_one(kind, causal, dtype,
                                                   _nccl_world_of_one):
    """Each sequence-parallel path over a ``"seq"`` axis of one NCCL rank
    against ``flash_attention`` on the whole sequence, on the card:
    output and dQ/dK/dV within ``TOL`` of their largest |value|, and the flash
    launches equal to the schedule's live block pairs (ring 1, zigzag 3,
    Ulysses 1) for the forward, dQ and dK/dV each."""
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.ops.attention import flash_attention
    from dcnn_tpu_torch.parallel import sequence

    mesh = make_mesh((1,), ("seq",))
    q, k, v, do = (torch.from_numpy(a).cuda().to(dtype)
                   for a in _arrays(11, 256, 256, 64, b=2, h=4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention(*leaves, causal=causal)
    ref.backward(do)
    want = [ref.detach()] + [t.grad for t in leaves]
    perm = (sequence.zigzag_permutation(256, 1).cuda() if kind == "zigzag"
            else torch.arange(256, device="cuda"))
    inv = torch.argsort(perm)
    if kind == "zigzag":
        f = sequence.make_zigzag_ring_attention(mesh)
    elif kind == "ring":
        f = sequence.make_ring_attention(mesh, causal=causal)
    else:
        f = sequence.make_ulysses_attention(mesh, causal=causal)
    local = [t.index_select(2, perm).requires_grad_(True) for t in (q, k, v)]
    before = _launches()
    out = f(*local)
    out.backward(do.index_select(2, perm))
    torch.cuda.synchronize()
    counts = [a - b for a, b in zip(_launches(), before)]
    live = {"ring": 1, "zigzag": 3, "ulysses": 1}[kind]
    assert counts == [live] * 3, counts
    got = [out.detach()] + [t.grad for t in local]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a = a.index_select(2, inv).float()
        scale = b.float().abs().max().item()
        err = (a - b.float()).abs().max().item()
        assert err <= TOL[dtype] * scale, (name, err, scale)


# ----------------------------------------------------- the example drivers

def test_device_manager_on_card():
    """The registry lists every CUDA device, then CPU:0; the default is
    CUDA:0; each device computes."""
    from dcnn_tpu_torch.core import (DeviceManager, default_device,
                                     device_count, local_devices)

    n = torch.cuda.device_count()
    dm = DeviceManager()
    assert [d.id for d in dm.all()] == [f"CUDA:{i}" for i in range(n)] + [
        "CPU:0"]
    assert dm.default().id == "CUDA:0" and dm.default().is_accelerator
    assert default_device() == torch.device("cuda", 0)
    assert device_count() == n
    assert local_devices() == [torch.device("cuda", i) for i in range(n)]
    assert [d.id for d in dm.accelerators()] == [f"CUDA:{i}"
                                                 for i in range(n)]
    for info in dm.all():
        y = torch.arange(8.0, device=info.device) * 2.0
        assert float(y.sum()) == 56.0


# the committed snapshot's conv sites (mnist_cnn_model, NCHW):
# (cin, h, w, cout, k, stride, pad) of conv1, conv2_1x1 and conv3
SNAPSHOT_SITES = [(1, 28, 28, 8, 5, 1, 0), (8, 8, 8, 16, 1, 1, 0),
                  (16, 8, 8, 48, 5, 1, 0)]


@pytest.mark.parametrize("batch", [1, 16, 256])
@pytest.mark.parametrize("site", range(len(SNAPSHOT_SITES)))
def test_conv_int8_at_snapshot_sites_on_card(site, batch):
    """Row 8 at the snapshot's sites (K = 25, 8 and 400; 28x28 and 8x8
    maps) and the eval and serving batches: the fused layer bit for bit
    the unfused chain, mode A bit for bit its int32 reference."""
    from dcnn_tpu_torch.ops import quant

    cin, h, w, cout, k, stride, pad = SNAPSHOT_SITES[site]
    x, xs, wq, ws, b = _quant_layer_inputs(site * 31 + batch, batch, cin, h,
                                           w, cout, k, "NCHW",
                                           torch.float32)
    before = _kernels.conv_int8_fused.launches
    got = quant.quant_conv2d(x, xs, wq, ws, b, stride=stride, padding=pad,
                             data_format="NCHW")
    torch.cuda.synchronize()
    assert _kernels.conv_int8_fused.launches > before
    assert torch.equal(got, quant.quant_conv2d_reference(
        x, xs, wq, ws, b, stride=stride, padding=pad, data_format="NCHW"))
    x_q = quant.quantize_symmetric(x, xs)
    got_a = _kernels.conv_int8(x_q, wq, stride=(stride, stride),
                               padding=(pad, pad), data_format="NCHW")
    assert torch.equal(got_a, quant.conv2d_int8_reference(
        x_q, wq, stride=stride, padding=pad, data_format="NCHW"))


def test_snapshot_int8_sites_on_card_equal_plain(tmp_path):
    """The committed snapshot quantized on the card, its three int8 conv
    sites fed the model's own activations of a 256-image batch of the
    digits28 test split: each kernel output bit for bit its plain
    version, and the int8 model's predictions equal the CPU int8 model's
    on that batch."""
    from dcnn_tpu_torch.data import MNISTDataLoader, decode_host
    from dcnn_tpu_torch.data.digits28 import ensure_digits28_csvs
    from dcnn_tpu_torch.nn import QuantConv2DLayer, quantize_model
    from dcnn_tpu_torch.ops import quant
    from dcnn_tpu_torch.train import load_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = ensure_digits28_csvs(str(tmp_path))
    ld = MNISTDataLoader(os.path.join(d, "test.csv"), batch_size=256,
                         shuffle=False, drop_last=False)
    ld.load_data()
    x = decode_host(np.asarray(next(iter(ld))[0]), ld.scale)
    snap = os.path.join(root, "model_snapshots", "mnist_cnn_model")
    preds = {}
    for dev in ("cuda", "cpu"):
        model = load_checkpoint(snap, device=dev)[0]
        qm = quantize_model(model, x)
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.append((mod, args[0])))
            for m in qm.modules() if isinstance(m, QuantConv2DLayer)]
        with torch.inference_mode():
            preds[dev] = qm(torch.from_numpy(x).to(dev)).argmax(-1).cpu()
        for h in hooks:
            h.remove()
        assert len(seen) == 3
        if dev == "cuda":
            for mod, xin in seen:
                (s, _), (p, _) = mod.stride, mod.padding
                got = quant.quant_conv2d(xin, mod.x_scale, mod.w_q,
                                         mod.w_scale, mod.b, stride=s,
                                         padding=p, data_format="NCHW")
                assert torch.equal(got, quant.quant_conv2d_reference(
                    xin, mod.x_scale, mod.w_q, mod.w_scale, mod.b, stride=s,
                    padding=p, data_format="NCHW")), mod.name
    assert int((preds["cuda"] != preds["cpu"]).sum()) <= 1


def test_flash_kernels_at_long_context_trainer_shape():
    """Rows 1-3 at the long-context driver's shape, B32 H2 S2048 D64 fp32
    causal: O and logsumexp within TOL, dQ, dK, dV within TOL of their
    largest |value|, one counted launch each."""
    b, h, s, d = 32, 2, 2048, 64
    q, k, v, g = (torch.from_numpy(a).cuda()
                  for a in _arrays(24, s, s, d, b=b, h=h))
    scale = d ** -0.5
    before = _launches()
    o, lse = _kernels.flash_fwd(q, k, v, causal=True, scale=scale)
    delta = (g * o).sum(-1)
    dq = _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=True,
                               scale=scale)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True,
                                    scale=scale)
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True)
    assert (o - o_ref).abs().max().item() <= TOL[torch.float32]
    assert (lse - lse_ref).abs().max().item() <= TOL[torch.float32]
    want = flash_backward_reference(q, k, v, o, lse, g, causal=True,
                                    scale=scale)
    for got, ref in zip((dq, dk, dv), want):
        err = (got - ref).abs().max().item()
        assert err <= TOL[torch.float32] * ref.abs().max().item()


def test_long_context_trainer_repeats_and_learns_as_blockwise(monkeypatch,
                                                              capsys):
    """``long_context_trainer`` at its defaults (B32 H2 S2048 D64 fp32, 8
    epochs of 60 steps), twice through the flash kernels and once with the
    layers' ``impl="blockwise"`` (plain online softmax), from one seed:
    the two flash runs equal to the bit (the kernels carry nothing between
    blocks: no atomics), and each run ends at a fresh-data accuracy of at
    least 0.9 (``chip_smoke.py``'s gate (d)). Prints the accuracies by
    epoch of both kinds and the first epoch at 0.9 or more."""
    from dcnn_tpu_torch.examples import long_context_trainer as lct

    monkeypatch.setenv("DEVICE_TYPE", "cuda")
    monkeypatch.setenv("ENV_FILE", os.devnull)
    flash = [lct.main(), lct.main()]
    layer = lct.MultiHeadAttentionLayer
    monkeypatch.setattr(lct, "MultiHeadAttentionLayer",
                        lambda **kw: layer(**{**kw, "impl": "blockwise"}))
    before = _launches()
    blockwise = lct.main()
    assert _launches() == before  # no flash kernel in the blockwise run
    epochs = {k: [(e["loss"], e["acc"]) for e in r["epochs"]]
              for k, r in (("flash", flash[0]), ("again", flash[1]),
                           ("blockwise", blockwise))}
    assert epochs["flash"] == epochs["again"]
    learnt = {k: next((i + 1 for i, (_, a) in enumerate(v) if a >= 0.9),
                      None) for k, v in epochs.items()}
    with capsys.disabled():
        for k, v in epochs.items():
            print(f"\nlong_context_trainer {k}: accuracy by epoch "
                  f"{[a for _, a in v]}, loss {[round(x, 4) for x, _ in v]}"
                  f", first at >= 0.9: epoch {learnt[k]}; on "
                  f"{torch.cuda.get_device_name(0)}")
    assert flash[0]["final_acc"] >= 0.9 and blockwise["final_acc"] >= 0.9


def test_capture_hazards_the_analysis_suite_names():
    """``chip_smoke.py`` phase 34: the port's static-analysis suite names
    TS01, TS03 and TS05 in its capture fixture and nothing in the clean
    and ``count_host`` functions; under ``Session`` the host read raises
    ``CaptureError``, the ``print`` and the ``append`` run at capture only,
    ``count_host`` counts every replay and the clean function replays bit
    for bit."""
    out = _smoke.phase_analysis(torch.cuda.get_device_name(0))
    assert out["findings"] == _smoke.ANALYSIS_EXPECTED
    assert out["after_capture"] == {"printer": 1, "impure": 1, "counted": 0}
    assert out["after_replays"] == {"printer": 1, "impure": 1,
                                    "counted": out["replays"]}

