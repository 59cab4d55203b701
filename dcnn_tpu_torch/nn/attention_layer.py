"""Multi-head self-attention layer (counterpart of
``dcnn_tpu/nn/attention_layer.py``). Per-sample shape ``(S, E)``; a batch
is ``(B, S, E)``. The single-token decode methods (:meth:`decode_qkv`,
:meth:`decode_attend`, :meth:`decode`) serve ``models/decoder.py`` and the
paged decode engine (``serve/decode.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.precision import cast_to_compute
from ..ops.attention import (
    NEG_INF, attention, blockwise_attention, flash_attention,
)
from . import initializers as init
from .factory import register_layer
from .layer import ParameterizedLayer
from .layers import linear

_WEIGHTS = ("wq", "wk", "wv", "wo")
_BIASES = ("bq", "bk", "bv", "bo")


@register_layer("multi_head_attention")
class MultiHeadAttentionLayer(ParameterizedLayer):
    """Self-attention: qkv projections -> scaled-dot-product -> out
    projection.

    ``impl``: ``"flash"`` (the Hopper kernel on CUDA, its plain version on
    the CPU; default), ``"blockwise"`` (plain online softmax) or
    ``"naive"`` (materialised scores). All exact.

    The projection weights are stored (out, in) for ``F.linear``; the JAX
    layer stores them (in, out) and computes ``x @ w``, so
    :func:`dcnn_tpu_torch.interop.from_jax` transposes them.
    """

    def __init__(self, num_heads: int, embed_dim: Optional[int] = None,
                 causal: bool = False, impl: str = "flash",
                 use_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        if impl not in ("flash", "blockwise", "naive"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads = int(num_heads)
        self.embed_dim = embed_dim
        self.causal = bool(causal)
        self.impl = impl
        self.use_bias = bool(use_bias)
        for n in _WEIGHTS + _BIASES:
            self.register_parameter(n, None)

    def _embed(self, input_shape) -> int:
        if len(input_shape) != 2:
            raise ValueError(f"{self.name}: attention expects (S, E) input, "
                             f"got {input_shape}")
        e = input_shape[1]
        if self.embed_dim is not None and self.embed_dim != e:
            raise ValueError(f"{self.name}: expected embed dim "
                             f"{self.embed_dim}, got {e}")
        if e % self.num_heads:
            raise ValueError(f"{self.name}: embed dim {e} not divisible by "
                             f"{self.num_heads} heads")
        return e

    def init(self, input_shape, *, generator=None, device=None):
        e = self._embed(input_shape)
        self.embed_dim = e
        names = _WEIGHTS + (_BIASES if self.use_bias else ())
        for n in names:
            shape = (e, e) if n.startswith("w") else (e,)
            setattr(self, n, nn.Parameter(init.kaiming_uniform(
                shape, e, generator=generator, device=device)))

    @staticmethod
    def _project(x, w, b):
        return linear(x, cast_to_compute(w), cast_to_compute(b))

    def _attend(self, q, k, v):
        """(B, S, E) projections -> heads (B, H, S, E/H) -> attention ->
        (B, S, E)."""
        b_, s, e = q.shape
        h, dh = self.num_heads, e // self.num_heads

        def heads(t):
            return t.reshape(b_, s, h, dh).transpose(1, 2).contiguous()

        q, k, v = heads(q), heads(k), heads(v)
        if self.impl == "naive":
            o = attention(q, k, v, causal=self.causal)
        elif self.impl == "blockwise":
            o = blockwise_attention(q, k, v, causal=self.causal)
        else:
            o = flash_attention(q, k, v, causal=self.causal)
        return o.transpose(1, 2).reshape(b_, s, e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self._project(x, self.wq, self.bq)
        k = self._project(x, self.wk, self.bk)
        v = self._project(x, self.wv, self.bv)
        return self._project(self._attend(q, k, v), self.wo, self.bo)

    # -- single-token decode path (serve/decode.py) --
    def decode_qkv(self, x_t: torch.Tensor):
        """Single-token projections: ``x_t (B, E)`` -> ``(q, k, v)``, each
        ``(B, E)``. ``k`` and ``v`` are what a decode step writes into its
        KV cache; ``q`` goes to :meth:`decode_attend`."""
        return (self._project(x_t, self.wq, self.bq),
                self._project(x_t, self.wk, self.bk),
                self._project(x_t, self.wv, self.bv))

    def decode_attend(self, q_t: torch.Tensor, k_ctx: torch.Tensor,
                      v_ctx: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """One causal decode step against a materialised KV context:
        ``q_t (B, E)`` attends to ``k_ctx``/``v_ctx (B, T, E)`` at
        ``positions (B,)``; key slot ``j`` takes part iff
        ``j <= position``. A row with ``position < 0`` is fully masked and
        its attention is exactly 0 (only the out projection's bias is
        left). Returns ``y_t (B, E)`` after the out projection."""
        b_, t, e = k_ctx.shape
        h, dh = self.num_heads, e // self.num_heads
        q = q_t.reshape(b_, h, 1, dh)
        k = k_ctx.reshape(b_, t, h, dh).transpose(1, 2)
        v = v_ctx.reshape(b_, t, h, dh).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2))[:, :, 0] * dh ** -0.5
        valid = (torch.arange(t, device=positions.device)[None, :]
                 <= positions[:, None].long())     # (B, T); all False if < 0
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        # zero fully-masked rows (softmax of all-NEG_INF is uniform 1/T)
        w = torch.softmax(s, dim=-1).masked_fill(~valid[:, None, :], 0.0)
        o = torch.matmul(w[:, :, None, :], v)[:, :, 0]
        return self._project(o.reshape(b_, e), self.wo, self.bo)

    def decode(self, x_t: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, positions: torch.Tensor):
        """Single-token decode through a dense KV cache: write this token's
        K/V rows at ``positions`` (clamped to 0, so an inactive row's write
        lands on slot 0 of a row nothing attends), attend over the prefix,
        return ``(y_t, k_cache, v_cache)`` with new caches. ``x_t (B, E)``;
        caches ``(B, T, E)``; ``positions (B,)``, ``-1`` = inactive."""
        q, k_t, v_t = self.decode_qkv(x_t)
        rows = torch.arange(x_t.shape[0], device=x_t.device)
        pos_c = torch.clamp_min(positions.long(), 0)
        k_cache = k_cache.index_put((rows, pos_c), k_t)
        v_cache = v_cache.index_put((rows, pos_c), v_t)
        return (self.decode_attend(q, k_cache, v_cache, positions),
                k_cache, v_cache)

    def output_shape(self, input_shape):
        return tuple(input_shape)

    def forward_complexity(self, input_shape):
        s, e = input_shape
        return 4 * 2 * s * e * e + 2 * 2 * s * s * e  # projections, scores·v

    def param_count(self, input_shape):
        e = input_shape[1]
        return 4 * e * e + (4 * e if self.use_bias else 0)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "num_heads": self.num_heads, "embed_dim": self.embed_dim,
                "causal": self.causal, "impl": self.impl,
                "use_bias": self.use_bias}
