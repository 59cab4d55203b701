"""The port's attention ops held against the JAX package.

Same numpy inputs (from a seed) go through ``dcnn_tpu.ops.attention`` and
``dcnn_tpu_torch.ops.attention``. The JAX flash forward runs its Pallas
kernel in interpret mode, as ``tests/test_attention.py`` runs it on the
CPU; the port's flash forward runs its plain version, which is what a CPU
tensor gets. fp32 tolerance 1e-5: the same exact algorithm, summed in
another order and over other tile sizes.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.attention import (
    attention, blockwise_attention, flash_attention, flash_forward_reference,
)

# the module, not the function of the same name that dcnn_tpu.ops exports
jax_attn = importlib.import_module("dcnn_tpu.ops.attention")
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b=2, h=2, sq=48, sk=48, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("causal,sq,sk,d", [
    (False, 48, 48, 16),
    (True, 48, 48, 16),
    (False, 40, 72, 64),    # ragged: neither length a multiple of the tile
    (True, 40, 72, 64),     # causal diagonal offset sk - sq > 0
    (True, 72, 40, 16),     # sq > sk: the first 32 rows are fully masked
])
def test_flash_plain_matches_pallas_interpret(causal, sq, sk, d):
    """O and the logsumexp of the port's plain flash forward against the
    JAX Pallas kernel (interpret mode, 16-row/16-key tiles)."""
    q, k, v = _qkv(1, sq=sq, sk=sk, d=d)
    scale = d ** -0.5
    o_j, lse_j = jax_attn._flash_forward(*_j(q, k, v), causal=causal,
                                         block_q=16, block_kv=16,
                                         scale=scale, interpret=True)
    o_t, lse_t = flash_forward_reference(*_t(q, k, v), causal=causal,
                                         scale=scale)
    assert lse_t.shape == (2, 2, sq) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    # the JAX lse is padded to the q tile; its first sq rows are the rows
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., :sq],
                               **TOL)
    if sq > sk and causal:
        np.testing.assert_array_equal(o_t[:, :, :sq - sk].numpy(), 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    """The public entry point, on CPU tensors, against the JAX kernel."""
    q, k, v = _qkv(2, sq=33, sk=33, d=32)
    ref = jax_attn.flash_attention(*_j(q, k, v), causal=causal, block_q=16,
                                   block_kv=16, interpret=True)
    out = flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(causal):
    q, k, v = _qkv(3, sq=24, sk=40)
    ref = jax_attn.attention(*_j(q, k, v), causal=causal)
    out = attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_attention_matches_jax(causal):
    """Key-padding masks: the naive op, the blockwise op and flash (which
    routes a mask to blockwise) against the JAX ops."""
    q, k, v = _qkv(4, sq=48, sk=48)
    kmask = np.ones((2, 1, 1, 48), bool)
    kmask[0, ..., 33:] = False
    ref = np.asarray(jax_attn.attention(*_j(q, k, v), causal=causal,
                                        mask=jnp.asarray(kmask)))
    m = torch.from_numpy(kmask)
    for out in (attention(*_t(q, k, v), causal=causal, mask=m),
                blockwise_attention(*_t(q, k, v), causal=causal,
                                    block_kv=16, mask=m),
                flash_attention(*_t(q, k, v), causal=causal, mask=m)):
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_fully_masked_rows_return_zero():
    q, k, v = _qkv(5, sq=32, sk=32)
    mask = np.ones((1, 1, 32, 32), bool)
    mask[..., 5, :] = False
    ref = np.asarray(jax_attn.attention(*_j(q, k, v), mask=jnp.asarray(mask)))
    for out in (attention(*_t(q, k, v), mask=torch.from_numpy(mask)),
                blockwise_attention(*_t(q, k, v), block_kv=16,
                                    mask=torch.from_numpy(mask))):
        np.testing.assert_array_equal(out[:, :, 5].numpy(), 0.0)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_mask_validation():
    q, k, v = _t(*_qkv(6, sq=32, sk=32))
    with pytest.raises(ValueError, match="mask last dim"):
        blockwise_attention(q, k, v, mask=torch.ones(1, 1, 32, 7, dtype=bool))
    with pytest.raises(ValueError, match="ambiguous"):
        attention(q, k, v, mask=torch.ones(2, 32, 32, dtype=bool))


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor runs the plain version and never counts a launch; the
    kernel wrapper itself refuses a CPU tensor instead of falling back."""
    q, k, v = _t(*_qkv(7))
    before = _kernels.flash_fwd.launches
    out = flash_attention(q, k, v)
    ref, _ = flash_forward_reference(q, k, v)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert _kernels.flash_fwd.launches == before
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_fwd(q, k, v, causal=False, scale=0.25)


def test_flash_gradient_on_cpu_matches_naive():
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(8, b=1, sq=20, sk=28,
                                                    d=16)))
    g_ref = torch.autograd.grad(attention(q, k, v, causal=True).square().sum(),
                                (q, k, v))
    g_fl = torch.autograd.grad(
        flash_attention(q, k, v, causal=True).square().sum(), (q, k, v))
    for a, b in zip(g_ref, g_fl):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,sq,sk,d,dtype", [
    (False, 32, 32, 16, torch.float32),
    (True, 100, 70, 32, torch.float32),
    (True, 77, 300, 128, torch.float32),
    (True, 129, 129, 64, torch.bfloat16),
])
def test_flash_kernel_matches_plain_on_card(causal, sq, sk, d, dtype):
    """The Hopper kernel against its plain version on the card (fp32 1e-4:
    another summation order; bf16 2e-2: the output is rounded to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, s, d)).astype(
        np.float32)).to("cuda", dtype) for s in (sq, sk, sk))
    before = _kernels.flash_fwd.launches
    o, lse = _kernels.flash_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _kernels.flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= tol
