"""3×3 stride-1 SAME convolutions as implicit GEMMs (counterpart of
``dcnn_tpu/ops/pallas/conv.py``).

x is NHWC (N, H, W, Cin) and the weights HWIO (3, 3, Cin, Cout), as in the
JAX package; a layer's OIHW weight goes in as
``w.permute(2, 3, 1, 0).contiguous()``. On CUDA tensors each function
launches its hand-written Hopper kernel (or raises): all three the
tensor-core implicit GEMM of ``ops/csrc/conv3x3_tc.cu``, the pairs form as
its 12-tap mode. On CPU tensors it runs the kernel's plain version here.
There is no other route. Each goes through its ``dcnn::`` op
(:mod:`~dcnn_tpu_torch.ops.library`), so a tracer sees one node.

- :func:`conv3x3_s1`: the conv.
- :func:`conv3x3_s1_bnrelu_in`: the conv of ``relu(x·scale + shift)``, the
  per-Cin BN-apply and ReLU computed in fp32 at load and rounded to x's
  type before the products; the zero padding comes after it.
- :func:`conv3x3_s1_pairs`: the conv as the output-column-pair product
  against the block-sparse weights of :func:`fuse_pair_weights`; W even.

``batch_tile`` and ``h_tile`` are the TPU kernels' tilings. They are
validated as the JAX functions validate them; the tiling on the card is
the kernel's own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import library


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor by one on each side."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def bnrelu_reference(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """``relu(x·scale + shift)`` in fp32 (fp64 for fp64 x), rounded to x's
    type: the BN kernel's prologue."""
    acc = _acc_dtype(x)
    return torch.clamp_min(x.to(acc) * scale.to(acc) + shift.to(acc),
                           0.0).to(x.dtype)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, *,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version of the conv kernel, the Pallas body repeated: zero-pad
    H and W, then accumulate the 9 shifted (H·W, Cin)×(Cin, Cout) products
    in fp32 (bf16 inputs widened; fp64 stays fp64) and cast once."""
    n, h, ww, _ = x.shape
    acc_dt = _acc_dtype(x)
    xp, wf = _pad_hw(x.to(acc_dt)), w.to(acc_dt)
    acc = torch.zeros((n, h, ww, w.shape[3]), dtype=acc_dt, device=x.device)
    for kh in range(3):
        for kw in range(3):
            acc += torch.matmul(xp[:, kh:kh + h, kw:kw + ww], wf[kh, kw])
    return acc.to(out_dtype or x.dtype)


def conv3x3_pairs_reference(x: torch.Tensor, w2: torch.Tensor, *,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Plain version of the pairs kernel, the Pallas body repeated: output
    pair (2p, 2p+1) of a row is the sum over kh and j of padded input
    column 2p+j times ``w2[kh, j]`` (3×4 products with (Cin, 2·Cout)
    weights); lanes [0, Cout) are column 2p, [Cout, 2·Cout) column 2p+1."""
    n, h, ww, _ = x.shape
    half, cout2 = ww // 2, w2.shape[3]
    acc_dt = _acc_dtype(x)
    xp, wf = _pad_hw(x.to(acc_dt)), w2.to(acc_dt)
    acc = torch.zeros((n, h, half, cout2), dtype=acc_dt, device=x.device)
    for kh in range(3):
        for j in range(4):
            acc += torch.matmul(xp[:, kh:kh + h, j:j + 2 * half:2], wf[kh, j])
    # (H, W/2, 2·Cout) row-major is (H, W, Cout)
    return acc.reshape(n, h, ww, cout2 // 2).to(out_dtype or x.dtype)


def _shapes(fn: str, x: torch.Tensor, w: torch.Tensor, batch_tile: int,
            even_w: bool = False):
    n, h, ww, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if ((kh, kw) != (3, 3) or wcin != cin or n % batch_tile
            or (even_w and ww % 2)):
        raise ValueError(f"{fn}: bad shapes {tuple(x.shape)} "
                         f"{tuple(w.shape)} batch_tile={batch_tile}")
    return n, h, ww, cin, cout


def _route(fn: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{fn}: no implementation for {x.device}")


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor, *, batch_tile: int = 1,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3×3 stride-1 SAME conv, NHWC. ``x``: (N, H, W, Cin); ``w``: (3, 3,
    Cin, Cout). Returns (N, H, W, Cout) of ``out_dtype`` (x's by
    default)."""
    _shapes("conv3x3_s1", x, w, batch_tile)
    out_dtype = out_dtype or x.dtype
    _route("conv3x3_s1", x)
    return library.conv3x3_s1(x, w, out_dtype)


def conv3x3_s1_bnrelu_in(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, *,
                         batch_tile: int = 1,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """``conv3x3_s1(relu(x·scale + shift), w)`` with the per-channel
    BN-apply and ReLU fused into the kernel's input load. ``scale`` and
    ``shift``: (Cin,); the kernel reads them as fp32."""
    _shapes("conv3x3_s1_bnrelu_in", x, w, batch_tile)
    out_dtype = out_dtype or x.dtype
    _route("conv3x3_s1_bnrelu_in", x)
    return library.conv3x3_s1_bnrelu_in(x, w, scale, shift, out_dtype)


def fuse_pair_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, K) -> (3, 4, C, 2K) block-sparse fused weights for the
    output-column-pair kernel: window offset j carries kernel column j to
    the even output (first K lanes, j < 3) and kernel column j-1 to the odd
    output (last K lanes, j >= 1)."""
    _, _, c, k = w.shape
    w2 = torch.zeros((3, 4, c, 2 * k), dtype=w.dtype, device=w.device)
    for kw in range(3):
        w2[:, kw, :, :k] = w[:, kw]
        w2[:, kw + 1, :, k:] = w[:, kw]
    return w2


def conv3x3_s1_pairs(x: torch.Tensor, w: torch.Tensor, *, batch_tile: int = 1,
                     h_tile: Optional[int] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """3×3 stride-1 SAME conv through the output-column-pair formulation:
    the narrow-Cout specialization. Requires even W; ``h_tile`` (default
    min(H, 16)) must divide H, as in the JAX function."""
    _, h, _, _, _ = _shapes("conv3x3_s1_pairs", x, w, batch_tile, even_w=True)
    out_dtype = out_dtype or x.dtype
    th = h_tile or min(h, 16)
    if h % th:
        raise ValueError(f"h_tile {th} must divide H {h}")
    w2 = fuse_pair_weights(w)
    _route("conv3x3_s1_pairs", x)
    return library.conv3x3_s1_pairs(x, w2, out_dtype)
