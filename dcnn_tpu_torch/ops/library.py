"""The hand-written kernels as ``torch.library`` custom ops (``dcnn::``).

The wrappers of :mod:`~dcnn_tpu_torch.ops._kernels` read ``data_ptr()`` to
plan a launch and hand raw pointers to ``ctypes``, which no tracer can see
through. Each wrapper is registered here as one custom op, so
``torch.export`` records the call as a single node and an exported program
replays it:

- ``dcnn::flash_fwd``, ``dcnn::flash_bwd_dq``, ``dcnn::flash_bwd_dkv``
  (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``); ``flash_fwd`` carries its
  backward (:func:`torch.library.register_autograd`), the two backward ops;
- ``dcnn::conv3x3_s1``, ``dcnn::conv3x3_s1_bnrelu_in``,
  ``dcnn::conv3x3_s1_pairs`` (``csrc/conv3x3_tc.cu``);
- ``dcnn::fused_scale_bias_relu`` (``csrc/fused.cu``);
- ``dcnn::conv_int8``, ``dcnn::conv_int8_fused`` (``csrc/conv_int8.cu``'s
  modes A and B) and ``dcnn::pack_int8_weight`` (its weight layout);
- ``dcnn::dense_int8``, not a hand-written kernel (``torch._int_mm``), an
  op so that its shape-dependent padding stays out of a trace.

Each op has two implementations. The CUDA one calls the wrapper, which
launches the kernel or raises; the CPU one calls the kernel's plain
version. No other device has one, so there is no other route. The
wrappers count their launches as before (``_kernels.COUNTED``), once per
launch, and the ops stay capturable in a CUDA graph: an implementation
allocates through PyTorch and launches on the current stream. Each op's
fake rule gives the output's shape and dtype only (contiguous, as both
implementations return it); the plan choices that read the card or the
pointers (``_card_sms``, ``_copy_unit``, the 16-byte alignment tests) stay
inside the CUDA implementation.

Importing this module registers the ops; the callers
(:mod:`~dcnn_tpu_torch.ops.attention`, :mod:`~dcnn_tpu_torch.ops.conv`,
:mod:`~dcnn_tpu_torch.ops.quant`, :mod:`~dcnn_tpu_torch.ops.pallas`) and a
process that loads an exported program
(:func:`~dcnn_tpu_torch.nn.export.load_inference`) import it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import _kernels

NAMESPACE = "dcnn"


def _op(name: str):
    """A custom op ``dcnn::name`` whose decorated function is its CPU
    implementation (the plain version)."""
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(),
                                   device_types="cpu")


# -- flash attention ----------------------------------------------------------

@_op("flash_fwd")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O like q, logsumexp (B, H, Sq) fp32) of flash attention over q (B,
    H, Sq, D), k and v (B, H, Sk, D)."""
    from .attention import flash_forward_reference

    o, lse = flash_forward_reference(q, k, v, causal=causal, scale=scale)
    return o.contiguous(), lse.contiguous()


@flash_fwd.register_kernel("cuda")
def _(q, k, v, causal, scale):
    # strided or misaligned views are copied, and a head dim whose rows
    # are not whole 16-byte units padded with zero columns (they add
    # nothing to the scores) and cut off the output
    from .attention import _for_kernel

    d = q.shape[-1]
    w = _kernels.flash_head_width(d, q.dtype)
    o, lse = _kernels.flash_fwd(*(_for_kernel(t, w) for t in (q, k, v)),
                                causal=causal, scale=scale)
    return (o if w == d else o[..., :d].contiguous()), lse


@flash_fwd.register_fake
def _(q, k, v, causal, scale):
    return q.new_empty(q.shape), q.new_empty(q.shape[:3],
                                             dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale
    # the logsumexp takes no gradient: leave it None instead of a zero
    # tensor filled on the card every step
    ctx.set_materialize_grads(False)


def _flash_grad(ctx, g, _g_lse):
    from .attention import _flash_backward

    if g is None:  # only the logsumexp was used
        return None, None, None, None, None
    q, k, v, o, lse = ctx.saved_tensors
    # the head merge after the forward hands the cotangent back
    # transposed; both routes take it in contiguous rows
    dq, dk, dv = _flash_backward(q, k, v, o, lse, g.contiguous(),
                                 causal=ctx.causal, scale=ctx.scale)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_flash_grad, setup_context=_flash_setup)


def _bwd_reference(q, k, v, do, lse, delta, causal, scale):
    from .attention import flash_backward_reference

    return flash_backward_reference(q, k, v, None, lse, do, causal=causal,
                                    scale=scale, delta=delta)


def _bwd_inputs(q, k, v, do):
    """(q, k, v, dO as the kernels take them, the head dim they run at)."""
    from .attention import _for_kernel

    w = _kernels.flash_head_width(q.shape[-1], q.dtype)
    return (*(_for_kernel(t, w) for t in (q, k, v, do)), w)


@_op("flash_bwd_dq")
def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, scale: float) -> torch.Tensor:
    """dQ of flash attention from the forward's logsumexp and ``delta`` =
    rowsum(dO·O), both (B, H, Sq)."""
    return _bwd_reference(q, k, v, do, lse, delta, causal,
                          scale)[0].contiguous()


@flash_bwd_dq.register_kernel("cuda")
def _(q, k, v, do, lse, delta, causal, scale):
    d = q.shape[-1]
    qc, kc, vc, gc, w = _bwd_inputs(q, k, v, do)
    dq = _kernels.flash_bwd_dq(qc, kc, vc, gc, lse.contiguous(),
                               delta.contiguous(), causal=causal,
                               scale=scale)
    return dq if w == d else dq[..., :d].contiguous()


@flash_bwd_dq.register_fake
def _(q, k, v, do, lse, delta, causal, scale):
    return q.new_empty(q.shape)


@_op("flash_bwd_dkv")
def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of flash attention; inputs as :func:`flash_bwd_dq`."""
    _, dk, dv = _bwd_reference(q, k, v, do, lse, delta, causal, scale)
    return dk.contiguous(), dv.contiguous()


@flash_bwd_dkv.register_kernel("cuda")
def _(q, k, v, do, lse, delta, causal, scale):
    d = q.shape[-1]
    qc, kc, vc, gc, w = _bwd_inputs(q, k, v, do)
    dk, dv = _kernels.flash_bwd_dkv(qc, kc, vc, gc, lse.contiguous(),
                                    delta.contiguous(), causal=causal,
                                    scale=scale)
    if w != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


@flash_bwd_dkv.register_fake
def _(q, k, v, do, lse, delta, causal, scale):
    return k.new_empty(k.shape), v.new_empty(v.shape)


# -- the 3x3 stride-1 convs and the scale/bias/ReLU ---------------------------

@_op("conv3x3_s1")
def conv3x3_s1(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NHWC x (N, H, W, Cin) with HWIO w (3, 3,
    Cin, Cout), as ``out_dtype``."""
    from .pallas.conv import conv3x3_reference

    return conv3x3_reference(x, w, out_dtype=out_dtype).contiguous()


@conv3x3_s1.register_kernel("cuda")
def _(x, w, out_dtype):
    return _kernels.conv3x3_s1(x, w, out_dtype=out_dtype)


@conv3x3_s1.register_fake
def _(x, w, out_dtype):
    return x.new_empty((*x.shape[:3], w.shape[3]), dtype=out_dtype)


@_op("conv3x3_s1_bnrelu_in")
def conv3x3_s1_bnrelu_in(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """:func:`conv3x3_s1` of ``relu(x·scale + shift)``, scale and shift
    (Cin,)."""
    from .pallas.conv import bnrelu_reference, conv3x3_reference

    return conv3x3_reference(bnrelu_reference(x, scale, shift), w,
                             out_dtype=out_dtype).contiguous()


@conv3x3_s1_bnrelu_in.register_kernel("cuda")
def _(x, w, scale, shift, out_dtype):
    # fp32 (and exact from bf16), as the Pallas kernel upcasts them
    return _kernels.conv3x3_s1_bnrelu_in(x, w, scale.float(), shift.float(),
                                         out_dtype=out_dtype)


@conv3x3_s1_bnrelu_in.register_fake
def _(x, w, scale, shift, out_dtype):
    return x.new_empty((*x.shape[:3], w.shape[3]), dtype=out_dtype)


@_op("conv3x3_s1_pairs")
def conv3x3_s1_pairs(x: torch.Tensor, w2: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The conv as output-column pairs against fused weights w2 (3, 4,
    Cin, 2·Cout); W even."""
    from .pallas.conv import conv3x3_pairs_reference

    return conv3x3_pairs_reference(x, w2, out_dtype=out_dtype).contiguous()


@conv3x3_s1_pairs.register_kernel("cuda")
def _(x, w2, out_dtype):
    return _kernels.conv3x3_s1_pairs(x, w2, out_dtype=out_dtype)


@conv3x3_s1_pairs.register_fake
def _(x, w2, out_dtype):
    return x.new_empty((*x.shape[:3], w2.shape[3] // 2), dtype=out_dtype)


@_op("fused_scale_bias_relu")
def fused_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``max(x·scale + bias, 0)`` over the last axis of x (..., C)."""
    from .pallas.fused import scale_bias_relu_reference

    return scale_bias_relu_reference(x, scale, bias).contiguous()


@fused_scale_bias_relu.register_kernel("cuda")
def _(x, scale, bias):
    return _kernels.fused_scale_bias_relu(x, scale, bias)


@fused_scale_bias_relu.register_fake
def _(x, scale, bias):
    return x.new_empty(x.shape)


# -- the int8 conv ------------------------------------------------------------

def int8_out_shape(x_shape: Sequence[int], w_shape: Sequence[int],
                   stride: Sequence[int], padding: Sequence[int],
                   data_format: str) -> Tuple[int, ...]:
    """The int8 conv's output shape, contiguous in ``data_format``."""
    if data_format == "NCHW":
        n, _, h, wd = x_shape
    else:
        n, h, wd, _ = x_shape
    o, _, r, s = w_shape
    p = (h + 2 * padding[0] - r) // stride[0] + 1
    q = (wd + 2 * padding[1] - s) // stride[1] + 1
    return (n, o, p, q) if data_format == "NCHW" else (n, p, q, o)


@_op("conv_int8")
def conv_int8(x: torch.Tensor, w: torch.Tensor, stride: List[int],
              padding: List[int], data_format: str,
              packed: Optional[torch.Tensor]) -> torch.Tensor:
    """int8 × int8 → int32 conv (mode A) of x (NCHW or NHWC) with OIHW w,
    contiguous in ``data_format``; ``packed``: w as
    :func:`pack_int8_weight` gives it, or None to pack at the launch."""
    from .conv import conv2d_int8_reference

    return conv2d_int8_reference(x, w, stride=tuple(stride),
                                 padding=tuple(padding),
                                 data_format=data_format).contiguous()


@conv_int8.register_kernel("cuda")
def _(x, w, stride, padding, data_format, packed):
    return _kernels.conv_int8(x, w, stride=tuple(stride),
                              padding=tuple(padding),
                              data_format=data_format, packed=packed)


@conv_int8.register_fake
def _(x, w, stride, padding, data_format, packed):
    return x.new_empty(int8_out_shape(x.shape, w.shape, stride, padding,
                                      data_format), dtype=torch.int32)


@_op("conv_int8_fused")
def conv_int8_fused(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    stride: List[int], padding: List[int], data_format: str,
                    packed: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 conv layer (mode B): float x quantized by ``x_scale``, the
    exact int8 products with OIHW int8 w, then ``acc · scale[o] +
    bias[o]`` (``scale`` = x_scale · w_scale in fp32) in x's dtype,
    contiguous in ``data_format``."""
    from .conv import conv2d_int8_reference
    from .quant import quantize_symmetric

    y = conv2d_int8_reference(quantize_symmetric(x, x_scale), w,
                              stride=tuple(stride), padding=tuple(padding),
                              data_format=data_format).contiguous()
    shape = [1] * 4
    shape[1 if data_format == "NCHW" else 3] = -1
    y = y.float() * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(x.dtype)


@conv_int8_fused.register_kernel("cuda")
def _(x, x_scale, w, scale, bias, stride, padding, data_format, packed):
    return _kernels.conv_int8_fused(x, x_scale, w, scale, bias,
                                    stride=tuple(stride),
                                    padding=tuple(padding),
                                    data_format=data_format, packed=packed)


@conv_int8_fused.register_fake
def _(x, x_scale, w, scale, bias, stride, padding, data_format, packed):
    return x.new_empty(int8_out_shape(x.shape, w.shape, stride, padding,
                                      data_format))


def packed_int8_shape(w_shape: Sequence[int]) -> Tuple[int, int]:
    """The shape :func:`pack_int8_weight` gives OIHW weights of
    ``w_shape``."""
    o, c, r, s = w_shape
    cs = _kernels.int8_slice(c)
    kpad = _kernels._cdiv(r * s * cs, _kernels.INT8_CHUNK) * _kernels.INT8_CHUNK
    tile = _kernels.int8_cout_tile(o)
    return _kernels._cdiv(o, tile) * tile, (c // cs) * kpad


@_op("pack_int8_weight")
def pack_int8_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW int8 weights in ``csrc/conv_int8.cu``'s layout
    (``_kernels.pack_int8_weight``)."""
    return _kernels.pack_int8_weight(w)


@pack_int8_weight.register_kernel("cuda")
def _(w):
    return _kernels.pack_int8_weight(w)


@pack_int8_weight.register_fake
def _(w):
    return w.new_empty(packed_int8_shape(w.shape))


# -- the int8 GEMM (a library call, made opaque) ------------------------------

@_op("dense_int8")
def dense_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 × int8 → int32 ``x · wᵀ`` over x's last axis, w (out, in).
    Not a hand-written kernel: the CUDA implementation is
    ``torch._int_mm`` with the zero padding its shape rules need, which
    reads sizes in Python; as an op its padding stays out of a trace, whose
    symbolic batch it would otherwise specialise."""
    from .quant import dense_int8_reference

    return dense_int8_reference(x, w).contiguous()


@dense_int8.register_kernel("cuda")
def _(x, w):
    from .quant import _int_mm_padded

    lead = x.shape[:-1]
    y = _int_mm_padded(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[0]).contiguous()


@dense_int8.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[0]), dtype=torch.int32)


# every op, for the tests and the export's op check
OPS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, conv3x3_s1,
       conv3x3_s1_bnrelu_in, conv3x3_s1_pairs, fused_scale_bias_relu,
       conv_int8, conv_int8_fused, pack_int8_weight, dense_int8)
