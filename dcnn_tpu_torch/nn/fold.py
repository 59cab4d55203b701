"""Inference-time BatchNorm folding (counterpart of ``dcnn_tpu/nn/fold.py``).

For a conv or dense layer followed directly by batchnorm,

    BN(conv(x, W, b)) = conv(x, W·s) + (b − mean)·s + beta,
    s = gamma / sqrt(running_var + eps),

so the BN layer leaves the inference graph. :func:`fold_batchnorm` walks a
:class:`Sequential`, recursing into the ``layers`` and ``shortcut`` of every
residual block, folds every (Conv2D|Dense)→BatchNorm adjacency, keeps a BN
that follows anything else, and returns a new model; the original is left
untouched. The folded layer always carries a bias. The result is for
inference only: it has no batch statistics left to update.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import torch
from torch import nn

from .factory import layer_from_config
from .layers import BatchNormLayer, Conv2DLayer, DenseLayer
from .residual import ResidualBlock
from .sequential import Sequential


def _fold_pair(layer, bn: BatchNormLayer):
    """The conv/dense ``layer`` with ``bn`` folded in, as a new layer."""
    with torch.no_grad():
        rm, rv = bn.running_mean.float(), bn.running_var.float()
        gamma = bn.gamma.float() if bn.affine else torch.ones_like(rm)
        beta = bn.beta.float() if bn.affine else torch.zeros_like(rm)
        s = gamma / torch.sqrt(rv + bn.epsilon)
        shift = beta - rm * s
        w = layer.w.float()
        new_w = (w * s.reshape((-1,) + (1,) * (w.ndim - 1))).to(layer.w.dtype)
        b = layer.b.float() if layer.b is not None else torch.zeros_like(s)
        new_b = (b * s + shift).to(new_w.dtype)
    cfg = layer.get_config()
    cfg["use_bias"] = True
    new = layer_from_config(cfg)
    new.w, new.b = nn.Parameter(new_w), nn.Parameter(new_b)
    return new


def _fold_list(layers: Sequence[nn.Module]) -> List[nn.Module]:
    out: List[nn.Module] = []
    i = 0
    while i < len(layers):
        layer = layers[i]
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if (isinstance(layer, (Conv2DLayer, DenseLayer))
                and isinstance(nxt, BatchNormLayer)):
            out.append(_fold_pair(layer, nxt))
            i += 2
        elif isinstance(layer, ResidualBlock):
            out.append(ResidualBlock(_fold_list(layer.layers),
                                     _fold_list(layer.shortcut),
                                     activation=layer.activation,
                                     name=layer.name))
            i += 1
        else:  # a copy, so the folded model shares no module with the original
            out.append(copy.deepcopy(layer))
            i += 1
    return out


def fold_batchnorm(model: Sequential) -> Sequential:
    """A new model with every (Conv2D|Dense)→BatchNorm pair collapsed into
    the linear layer, on the original's device, in eval mode. Its outputs
    match the original's eval-mode outputs to float tolerance."""
    folded = Sequential(_fold_list(list(model.layers)),
                        name=f"{model.name}_folded",
                        input_shape=model.input_shape)
    return folded.eval()
