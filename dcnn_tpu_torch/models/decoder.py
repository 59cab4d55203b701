"""Causal decoder model for generative serving (counterpart of
``dcnn_tpu/models/decoder.py``).

``mha_classifier``'s blocks grown one step: the same
``MultiHeadAttentionLayer`` with the same relu-residual wiring
(``out = relu(attn(x) + x)``), but causal, over a learned token embedding,
with a vocabulary head. Two forward paths over one set of parameters:

- :meth:`MHADecoder.forward` (the JAX model's ``apply``): the full causal
  forward, ``(B, S)`` tokens -> ``(B, S, V)`` logits through materialised
  (``impl="naive"``) attention, the oracle of the decode path;
- :meth:`MHADecoder.decode_dense`: one token per row against explicit
  per-layer K/V caches, the un-paged twin of the serving engine's step
  (``serve/decode.py``).

Parameters, in the JAX package's layout so they carry over untransposed
(the blocks' projections are transposed by
:func:`~dcnn_tpu_torch.interop.decoder_from_jax` as for every attention
layer): ``embed`` (V, E), ``head_w`` (E, V), ``head_b`` (V,) and
``blocks``. Kept out of ``Sequential``, as in the JAX package: integer
tokens and per-layer caches do not fit its ``(B, *input_shape)`` float
contract.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.precision import cast_to_compute
from ..nn import initializers as init
from ..nn.attention_layer import MultiHeadAttentionLayer


class MHADecoder(nn.Module):
    """Tiny causal transformer decoder: embed -> N x (causal MHA + relu
    residual) -> vocabulary head. Greedy decode over it is deterministic."""

    def __init__(self, vocab_size: int = 64, embed_dim: int = 64,
                 num_heads: int = 4, num_layers: int = 2,
                 max_seq_len: int = 64, use_bias: bool = True,
                 name: str = "mha_decoder"):
        super().__init__()
        if vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
        if embed_dim % num_heads:
            raise ValueError(f"embed dim {embed_dim} not divisible by "
                             f"{num_heads} heads")
        self.name = name
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.max_seq_len = int(max_seq_len)
        self.use_bias = bool(use_bias)
        self.blocks = nn.ModuleList(
            MultiHeadAttentionLayer(num_heads, embed_dim, causal=True,
                                    impl="naive", use_bias=use_bias,
                                    name=f"{name}_mha{i}")
            for i in range(num_layers))
        for n in ("embed", "head_w", "head_b"):
            self.register_parameter(n, None)

    def init(self, *, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> "MHADecoder":
        """Create the parameters on ``device`` (CUDA unless ``"cpu"``)."""
        dev = resolve_device(device)
        e, v = self.embed_dim, self.vocab_size
        self.embed = nn.Parameter(init.kaiming_uniform(
            (v, e), e, generator=generator, device=dev))
        self.head_w = nn.Parameter(init.kaiming_uniform(
            (e, v), e, generator=generator, device=dev))
        self.head_b = nn.Parameter(init.zeros((v,), device=dev))
        for blk in self.blocks:
            blk.init((self.max_seq_len, e), generator=generator, device=dev)
        return self

    # -- full-sequence oracle --
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full causal forward: ``tokens (B, S)`` -> logits ``(B, S, V)``."""
        x = self.embed_tokens(tokens)
        for blk in self.blocks:
            x = torch.relu(blk(x) + x)
        return self.head(x)

    # -- single-token serving path --
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (any shape) -> their embeddings (..., E)."""
        return cast_to_compute(self.embed)[tokens.long()]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden (..., E) -> logits (..., V): ``x · head_w +
        head_b``, the product rounded before the bias add, as the JAX
        head computes it."""
        return (torch.matmul(x, cast_to_compute(self.head_w))
                + cast_to_compute(self.head_b))

    def decode_dense(self, x_t: torch.Tensor,
                     k_caches: Sequence[torch.Tensor],
                     v_caches: Sequence[torch.Tensor],
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                List[torch.Tensor]]:
        """One token per row through per-layer dense caches (each
        ``(B, T, E)``): write this token's K/V at ``positions``, attend over
        the prefix (the current token included), relu residual, head.
        Returns ``(logits (B, V), k_caches, v_caches)`` with new caches."""
        x = x_t
        new_k: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        for blk, kc, vc in zip(self.blocks, k_caches, v_caches):
            y, kc, vc = blk.decode(x, kc, vc, positions)
            x = torch.relu(y + x)
            new_k.append(kc)
            new_v.append(vc)
        return self.head(x), new_k, new_v

    # -- config --
    def get_config(self) -> Dict[str, Any]:
        return {"type": "mha_decoder", "name": self.name,
                "vocab_size": self.vocab_size, "embed_dim": self.embed_dim,
                "num_heads": self.num_heads, "num_layers": self.num_layers,
                "max_seq_len": self.max_seq_len, "use_bias": self.use_bias}

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "MHADecoder":
        cfg = dict(cfg)
        cfg.pop("type", None)
        return cls(**cfg)

    def extra_repr(self) -> str:
        return (f"{self.name!r}, vocab={self.vocab_size}, "
                f"embed={self.embed_dim}, heads={self.num_heads}, "
                f"layers={self.num_layers}, max_seq={self.max_seq_len}")


def create_mha_decoder(data_format: str = "NCHW") -> MHADecoder:
    """Zoo factory for the default decoder (V=64, E=64, 4 heads, 2 layers,
    ``max_seq_len`` 64). ``data_format`` is accepted for the zoo's
    signature and ignored (token input)."""
    return MHADecoder()
