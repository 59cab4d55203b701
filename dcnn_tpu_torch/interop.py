"""Carry a model and its training state across to and from the JAX package.

:func:`from_jax` takes what the JAX package gives for a model — its
``get_config()`` dict, its params pytree and, optionally, its state pytree
(batchnorm running statistics), converted to numpy arrays — and returns a
port :class:`~dcnn_tpu_torch.nn.Sequential` that computes the same
function. :func:`to_jax` and :func:`state_to_jax` are its exact inverses,
:func:`grads_to_jax` gives each ``param.grad`` in the same layout, and
:func:`opt_state_to_jax` /
:func:`opt_state_from_jax` carry an optimizer's state (SGD's ``velocity``,
Adam's ``m``, ``v``, ``t``), so both packages can step from the same state.
None of it needs JAX: a pytree is plain tuples, dicts and numpy arrays.

This module is where the two packages' weight layouts meet:

- ``multi_head_attention``: JAX stores ``wq``/``wk``/``wv``/``wo`` as
  (E_in, E_out) and computes ``x @ w``; the port stores (out, in) for
  ``F.linear``, so these are transposed. Biases carry over as they are.
- ``dense``: both store ``w`` as (out, in); ``conv2d``: both store ``w``
  as OIHW; no transpose.
- ``batchnorm`` / ``groupnorm``: ``gamma`` and ``beta``, only when
  ``affine``; batchnorm's state ``running_mean`` and ``running_var`` are the
  port's buffers of the same names.
- ``residual_block``: params and state ``{"main": (...), "shortcut":
  (...)}``, one entry per nested layer.
- ``flatten``, ``activation``, ``maxpool2d``, ``avgpool2d``, ``dropout``,
  ``log_softmax``: no params and no state (``{}``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device
from .nn.sequential import Sequential

_MHA_WEIGHTS = ("wq", "wk", "wv", "wo")
_AS_IS = ("dense", "conv2d", "batchnorm", "groupnorm")
_EMPTY = ("flatten", "activation", "maxpool2d", "avgpool2d", "dropout",
          "log_softmax")


def _layer_state(cfg: Dict[str, Any], p: Any, prefix: str,
                 out: Dict[str, np.ndarray]) -> None:
    ty = cfg["type"]
    if ty == "multi_head_attention":
        for name, a in p.items():
            a = np.asarray(a)
            out[prefix + name] = a.T if name in _MHA_WEIGHTS else a
    elif ty in _AS_IS:
        for name, a in p.items():
            out[prefix + name] = np.asarray(a)
    elif ty == "residual_block":
        _layers_state(cfg["layers"], p["main"], prefix + "layers.", out)
        _layers_state(cfg.get("shortcut", []), p["shortcut"],
                      prefix + "shortcut.", out)
    elif ty in _EMPTY:
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


def from_jax(config: Dict[str, Any], params_np: Sequence[Any],
             state_np: Optional[Sequence[Any]] = None, *,
             device: DeviceLike = None) -> Sequential:
    """Build the port's model from a JAX ``Sequential.get_config()`` dict,
    its params pytree and (optionally) its state pytree as numpy arrays, on
    ``device`` (CUDA unless ``"cpu"``). Without ``state_np`` the running
    statistics keep their initial values (mean 0, variance 1). Every array
    is checked for name and shape against the port's parameters and
    buffers."""
    dev = resolve_device(device)
    model = Sequential.from_config(config)
    # parameters and buffers are created (and then overwritten) so that
    # load_state_dict can check every name and shape
    model.init(generator=torch.Generator().manual_seed(0), device=dev)
    flat: Dict[str, np.ndarray] = {}
    _layers_state(config["layers"], params_np, "layers.", flat)
    if state_np is not None:
        _layers_state(config["layers"], state_np, "layers.", flat)
    sd = {n: b for n, b in model.named_buffers()}
    sd.update({k: torch.tensor(a) for k, a in flat.items()})
    model.load_state_dict(sd, strict=True)
    return model


def _layer_tree(cfg: Dict[str, Any], prefix: str,
                flat: Mapping[str, np.ndarray]) -> Any:
    """Inverse of :func:`_layer_state`: one layer's pytree entry from port
    names."""
    ty = cfg["type"]
    if ty == "multi_head_attention" or ty in _AS_IS:
        own = sorted(k[len(prefix):] for k in flat
                     if k.startswith(prefix) and "." not in k[len(prefix):])
        transpose = ty == "multi_head_attention"
        return {n: (np.ascontiguousarray(flat[prefix + n].T)
                    if transpose and n in _MHA_WEIGHTS else flat[prefix + n])
                for n in own}
    if ty == "residual_block":
        return {"main": _layers_tree(cfg["layers"], prefix + "layers.", flat),
                "shortcut": _layers_tree(cfg.get("shortcut", []),
                                         prefix + "shortcut.", flat)}
    if ty in _EMPTY:
        return {}
    raise NotImplementedError(f"to_jax has no weight rule for {ty!r}")


def _layers_tree(cfgs: Sequence[Dict[str, Any]], prefix: str,
                 flat: Mapping[str, np.ndarray]) -> tuple:
    return tuple(_layer_tree(cfg, f"{prefix}{i}.", flat)
                 for i, cfg in enumerate(cfgs))


def _tree(model: Sequential, named: Mapping[str, torch.Tensor]) -> tuple:
    flat = {n: t.detach().cpu().numpy() for n, t in named.items()}
    return tree_from_flat(model.get_config(), flat)


def tree_from_flat(config: Dict[str, Any],
                   flat: Mapping[str, np.ndarray]) -> tuple:
    """The JAX package's pytree for a model of ``config`` from numpy arrays
    under the port's parameter or buffer names (what :func:`to_jax` and
    :func:`state_to_jax` build from a live model)."""
    return _layers_tree(config["layers"], "layers.", flat)


def _flat(model: Sequential, tree: Sequence[Any],
          device: torch.device) -> Dict[str, torch.Tensor]:
    flat: Dict[str, np.ndarray] = {}
    _layers_state(model.get_config()["layers"], tree, "layers.", flat)
    return {n: torch.tensor(a, device=device) for n, a in flat.items()}


def to_jax(model: Sequential) -> tuple:
    """The model's params as the JAX package's pytree of numpy arrays: the
    exact inverse of :func:`from_jax` (MHA weights transposed back)."""
    return _tree(model, dict(model.named_parameters()))


def state_to_jax(model: Sequential) -> tuple:
    """The model's batchnorm running statistics as the JAX package's state
    pytree of numpy arrays: the inverse of ``from_jax``'s ``state_np``."""
    return _tree(model, dict(model.named_buffers()))


def grads_to_jax(model: Sequential) -> tuple:
    """Each parameter's ``.grad`` in the layout of :func:`to_jax`, as
    ``jax.grad`` would give it for the JAX model."""
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"no gradient for {missing}")
    return _tree(model, {n: p.grad for n, p in model.named_parameters()})


def opt_state_to_jax(model: Sequential, opt_state: Mapping[str, Any]
                     ) -> Dict[str, Any]:
    """A port optimizer's state in the JAX package's layout: every
    per-parameter entry (``velocity``, ``m``, ``v``) as a params-shaped
    pytree, the step ``t`` as an int32 scalar array."""
    return {k: (np.asarray(v, np.int32) if k == "t" else _tree(model, v))
            for k, v in opt_state.items()}


def opt_state_from_jax(model: Sequential, jax_state: Mapping[str, Any]
                       ) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_to_jax`, on the model's device."""
    dev = next(model.parameters()).device
    return {k: (int(np.asarray(v)) if k == "t" else _flat(model, v, dev))
            for k, v in jax_state.items()}
