"""Carry a model across from the JAX package.

:func:`from_jax` takes what the JAX package gives for a model — its
``get_config()`` dict and its params pytree, converted to numpy arrays — and
returns a port :class:`~dcnn_tpu_torch.nn.Sequential` that computes the same
function. It needs no JAX: the pytree is plain tuples, dicts and arrays.

This module is where the two packages' weight layouts meet:

- ``multi_head_attention``: JAX stores ``wq``/``wk``/``wv``/``wo`` as
  (E_in, E_out) and computes ``x @ w``; the port stores (out, in) for
  ``F.linear``, so these are transposed. Biases carry over as they are.
- ``dense``: both store ``w`` as (out, in); no transpose.
- ``residual_block``: params ``{"main": (...), "shortcut": (...)}``, one
  entry per nested layer.
- ``flatten`` / ``activation``: no params (``{}``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device
from .nn.sequential import Sequential

_MHA_WEIGHTS = ("wq", "wk", "wv", "wo")


def _layer_state(cfg: Dict[str, Any], p: Any, prefix: str,
                 out: Dict[str, np.ndarray]) -> None:
    ty = cfg["type"]
    if ty == "multi_head_attention":
        for name, a in p.items():
            a = np.asarray(a)
            out[prefix + name] = a.T if name in _MHA_WEIGHTS else a
    elif ty == "dense":
        for name, a in p.items():
            out[prefix + name] = np.asarray(a)
    elif ty == "residual_block":
        _layers_state(cfg["layers"], p["main"], prefix + "layers.", out)
        _layers_state(cfg.get("shortcut", []), p["shortcut"],
                      prefix + "shortcut.", out)
    elif ty in ("flatten", "activation"):
        if p:
            raise ValueError(f"{cfg.get('name')}: {ty} takes no params, "
                             f"got keys {sorted(p)}")
    else:  # a registered layer type whose weight layout has no rule here
        raise NotImplementedError(f"from_jax has no weight rule for {ty!r}")


def _layers_state(cfgs: Sequence[Dict[str, Any]], params: Sequence[Any],
                  prefix: str, out: Dict[str, np.ndarray]) -> None:
    if len(cfgs) != len(params):
        raise ValueError(f"{len(cfgs)} layer configs but {len(params)} param "
                         f"entries under {prefix!r}")
    for i, (cfg, p) in enumerate(zip(cfgs, params)):
        _layer_state(cfg, p, f"{prefix}{i}.", out)


def from_jax(config: Dict[str, Any], params_np: Sequence[Any], *,
             device: DeviceLike = None) -> Sequential:
    """Build the port's model from a JAX ``Sequential.get_config()`` dict
    and its params pytree as numpy arrays, on ``device`` (CUDA unless
    ``"cpu"``). Every weight is checked for name and shape against the
    port's parameters."""
    dev = resolve_device(device)
    model = Sequential.from_config(config)
    # parameters are created (and then overwritten) so that load_state_dict
    # can check every name and shape
    model.init(generator=torch.Generator().manual_seed(0), device=dev)
    flat: Dict[str, np.ndarray] = {}
    _layers_state(config["layers"], params_np, "layers.", flat)
    state = {k: torch.tensor(a) for k, a in flat.items()}
    model.load_state_dict(state, strict=True)
    return model
