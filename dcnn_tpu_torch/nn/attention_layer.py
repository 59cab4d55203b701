"""Multi-head self-attention layer (counterpart of
``dcnn_tpu/nn/attention_layer.py``). Per-sample shape ``(S, E)``; a batch
is ``(B, S, E)``. The single-token decode methods of the JAX layer come in
a later slice (ROADMAP.md)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.precision import cast_to_compute
from ..ops.attention import attention, blockwise_attention, flash_attention
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

    def output_shape(self, input_shape):
        return tuple(input_shape)

    def get_config(self):
        return {"type": self.type_name, "name": self.name,
                "num_heads": self.num_heads, "embed_dim": self.embed_dim,
                "causal": self.causal, "impl": self.impl,
                "use_bias": self.use_bias}
