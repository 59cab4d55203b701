"""The port's flash-attention backward held against the JAX package.

``flash_backward_reference`` (the plain version of the dQ and dK/dV
kernels) gets the same numpy inputs as the JAX ``_flash_backward``, whose
Pallas kernels run in interpret mode, with the O and logsumexp of the JAX
forward (16-row/16-key tiles). fp32 tolerance 1e-5: the same algorithm
summed in another order over other tile sizes. bf16 tolerance 1e-2 (about
two ulps of bf16's 8-bit mantissa at the gradients' scale): both round dS,
P and the outputs to bf16, so a rounding flip of one operand moves a
result by an ulp.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
version on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.ops.attention import (
    _flash_backward, flash_attention, flash_backward_reference,
    flash_forward_reference,
)

jax_attn = importlib.import_module("dcnn_tpu.ops.attention")
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _arrays(seed, sq, sk, d, b=2, h=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk, sq))  # q, k, v, dO


def _launches():
    return (_kernels.flash_fwd.launches, _kernels.flash_bwd_dq.launches,
            _kernels.flash_bwd_dkv.launches)


def _jax_backward(q, k, v, g, causal, dtype=jnp.float32):
    """JAX forward + backward in Pallas interpret mode; returns the JAX
    inputs in ``dtype``, O, the unpadded logsumexp and (dQ, dK, dV)."""
    d = q.shape[-1]
    qj, kj, vj, gj = (jnp.asarray(a).astype(dtype) for a in (q, k, v, g))
    o, lse = jax_attn._flash_forward(qj, kj, vj, causal=causal, block_q=16,
                                     block_kv=16, scale=d ** -0.5,
                                     interpret=True)
    grads = jax_attn._flash_backward(qj, kj, vj, o, lse, gj, causal=causal,
                                     block_q=16, block_kv=16, scale=d ** -0.5,
                                     interpret=True)
    # the JAX logsumexp is padded to the q tile; its first sq rows are the rows
    return (qj, kj, vj, gj), o, lse[..., :q.shape[2]], grads


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


# 8 and 48: between the classes; 192 and 256: class 256; 320 and 512: the
# kernels' wide modes
@pytest.mark.parametrize("d", [8, 16, 48, 64, 192, 256, 320, 512])
@pytest.mark.parametrize("causal,sq,sk", [
    (True, 40, 40),    # ragged: 40 is not a multiple of the 16-row tile
    (False, 24, 56),   # cross-attention, Sq != Sk
    (True, 48, 32),    # Sq > Sk: the first 16 rows are fully masked
])
def test_plain_backward_matches_pallas_interpret(causal, sq, sk, d):
    q, k, v, g = _arrays(sq * 7 + sk + d, sq, sk, d)
    ins, o, lse, want = _jax_backward(q, k, v, g, causal)
    got = flash_backward_reference(*map(_torch, ins[:3]), _torch(o),
                                   _torch(lse), _torch(ins[3]),
                                   causal=causal, scale=d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    if causal and sq > sk:
        np.testing.assert_array_equal(got[0][:, :, :sq - sk].numpy(), 0.0)


@pytest.mark.parametrize("block", [16, 64, 24])
def test_plain_backward_tiling_does_not_change_the_result(block):
    """Sq=40, Sk=57, causal: the diagonal offset 17 puts the last key a
    16-row q tile may see at the first key of a kv tile, so a band edge off
    by one drops that tile. The plain version at each tile size against the
    Pallas kernels at 16."""
    q, k, v, g = _arrays(4, 40, 57, 16)
    ins, o, lse, want = _jax_backward(q, k, v, g, True)
    got = flash_backward_reference(*map(_torch, ins[:3]), _torch(o),
                                   _torch(lse), _torch(ins[3]), causal=True,
                                   scale=0.25, block_q=block, block_kv=block)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_plain_backward_bf16_matches_pallas_interpret():
    q, k, v, g = _arrays(3, 40, 40, 16)
    ins, o, lse, want = _jax_backward(q, k, v, g, True, jnp.bfloat16)
    bf = torch.bfloat16
    got = flash_backward_reference(*(_torch(a, bf) for a in ins[:3]),
                                   _torch(o, bf), _torch(lse),
                                   _torch(ins[3], bf), causal=True,
                                   scale=16 ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   **BF16_TOL, err_msg=name)


@pytest.mark.parametrize("causal,sq,sk", [(False, 33, 33), (True, 40, 24)])
def test_flash_attention_gradient_matches_jax_grad(causal, sq, sk):
    """The port's differentiable entry point on CPU tensors against
    ``jax.grad`` of the JAX ``flash_attention`` in interpret mode; the CPU
    backward runs the plain version and launches no kernel."""
    q, k, v, _ = _arrays(11, sq, sk, 32)
    w = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_attn.flash_attention(
        *a, causal=causal, block_q=16, block_kv=16, interpret=True)
        * jnp.asarray(w)), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = _launches()
    (flash_attention(qt, kt, vt, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    assert _launches() == before
    for name, t, b in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_backward_takes_a_transposed_cotangent():
    """The head merge hands the cotangent back transposed; the backward
    makes it contiguous and gives what a contiguous one gives."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(5, 24, 24, 16))
    g_t = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not g_t.is_contiguous()
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention(*qkv, causal=True).backward(g_t)
    o, lse = flash_forward_reference(q, k, v, causal=True)
    want = flash_backward_reference(q, k, v, o, lse, g, causal=True,
                                    scale=16 ** -0.5)
    for t, w in zip(qkv, want):
        torch.testing.assert_close(t.grad, w, atol=0, rtol=0)


def test_cpu_dispatch_and_kernel_wrappers_refuse_cpu():
    """A CPU tensor takes the plain version through ``_flash_backward``;
    the kernel wrappers refuse it instead of falling back."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(6, 16, 16, 16))
    o, lse = flash_forward_reference(q, k, v)
    delta = (g * o).sum(-1)
    before = _launches()
    got = _flash_backward(q, k, v, o, lse, g, causal=False, scale=0.25)
    want = flash_backward_reference(q, k, v, o, lse, g, causal=False,
                                    scale=0.25)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _launches() == before
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_bwd_dq(q, k, v, g, lse, delta, causal=False,
                              scale=0.25)
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_bwd_dkv(q, k, v, g, lse, delta, causal=False,
                               scale=0.25)


def test_plain_backward_fp64_stays_fp64():
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _arrays(7, 20, 20, 16))
    o, lse = flash_forward_reference(q, k, v, causal=True)
    grads = flash_backward_reference(q, k, v, o, lse, g, causal=True,
                                     scale=0.25)
    assert all(t.dtype == torch.float64 for t in grads)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        flash_forward_reference(*qkv, causal=True, scale=0.25)[0], qkv, g)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)
