"""The port's CUDA kernels on the card, each held against its plain PyTorch
version, and the training path run through them.

Every test here needs an NVIDIA GPU and skips without one (decided inside
the test). The file imports neither JAX nor the JAX package, so it also
runs on a GPU machine without them; ``tests/conftest.py`` imports JAX, so
there run it without the conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: fp32 1e-4 (of the value, or of max |grad| for gradients): the
same math summed in another order. bf16 2e-2: outputs, and in the backward
dS and P, are rounded to bf16's 8-bit mantissa.
"""

import numpy as np
import pytest
import torch

from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import ArrayDataLoader
from dcnn_tpu_torch.interop import from_jax, to_jax
from dcnn_tpu_torch.nn import MultiHeadAttentionLayer, SequentialBuilder
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.attention import (
    flash_attention, flash_backward_reference, flash_forward_reference,
)
from dcnn_tpu_torch.optim import SGD
from dcnn_tpu_torch.train import Trainer, create_train_state

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


@pytest.mark.parametrize("causal,sq,sk,d,dtype", [
    (False, 32, 32, 16, torch.float32),
    (True, 100, 70, 32, torch.float32),
    (True, 77, 300, 128, torch.float32),
    (True, 129, 129, 64, torch.bfloat16),
])
def test_flash_kernel_matches_plain_on_card(causal, sq, sk, d, dtype):
    """The forward kernel: O and logsumexp, one counted launch."""
    q, k, v, _ = (torch.from_numpy(a).to("cuda", dtype)
                  for a in _arrays(9, sq, sk, d))
    before = _kernels.flash_fwd.launches
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _kernels.flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]


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
    with pytest.raises(ValueError, match="head dim"):
        _kernels.flash_bwd_dq(*(t[..., :8].contiguous() for t in (q, k, v, g)),
                              lse, delta, causal=False, scale=0.25)


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
