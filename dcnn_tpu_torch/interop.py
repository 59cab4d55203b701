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
- the int8 twins (``quant_conv2d``, ``quant_dense``,
  ``quant_multi_head_attention``): int8 ``w_q`` (OIHW, or (out, in), the
  attention projections' ``wq_q`` ... ``wo_q`` too), fp32 per-channel and
  scalar scales, fp32 biases; the same layout in both packages, no
  transpose.
- ``batchnorm`` / ``groupnorm``: ``gamma`` and ``beta``, only when
  ``affine``; batchnorm's state ``running_mean`` and ``running_var`` are the
  port's buffers of the same names.
- ``residual_block``: params and state ``{"main": (...), "shortcut":
  (...)}``, one entry per nested layer.
- ``flatten``, ``activation``, ``maxpool2d``, ``avgpool2d``, ``dropout``,
  ``log_softmax``: no params and no state (``{}``).

:func:`pipeline_from_jax` / :func:`pipeline_to_jax` carry a JAX
pipeline's per-stage ``params``, ``state`` and ``opt_state`` onto the
port's :class:`~dcnn_tpu_torch.parallel.InProcessPipelineCoordinator`
stages and back, and :func:`compiled_from_jax` / :func:`compiled_to_jax`
the per-stage trees of ``HeteroCompiledPipeline.unpack_params`` (the JAX
engine's flat arrays, unpacked) onto the port's
:class:`~dcnn_tpu_torch.parallel.HeteroCompiledPipeline` and back; a
stage's trees follow its stage model's config, as a model's follow the
model's.

:func:`decoder_from_jax` and :func:`decoder_to_jax` do the same for
``mha_decoder`` (an ``MHADecoder``, not a ``Sequential``): ``embed``,
``head_w`` and ``head_b`` carry over as they are, each of ``blocks`` by the
attention layer's rule.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device
from .models.decoder import MHADecoder
from .nn.sequential import Sequential

_MHA_WEIGHTS = ("wq", "wk", "wv", "wo")
_AS_IS = ("dense", "conv2d", "batchnorm", "groupnorm", "quant_conv2d",
          "quant_dense", "quant_multi_head_attention")
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
             device: DeviceLike = None,
             dtype: Optional[torch.dtype] = None) -> Sequential:
    """Build the port's model from a JAX ``Sequential.get_config()`` dict,
    its params pytree and (optionally) its state pytree as numpy arrays, on
    ``device`` (CUDA unless ``"cpu"``). Without ``state_np`` the running
    statistics keep their initial values (mean 0, variance 1). Every array
    is checked for name and shape against the port's parameters and
    buffers. The model is fp32 unless ``dtype`` names another floating
    type, which it takes before the arrays load into it (fp64 arrays stay
    exact in an fp64 model)."""
    dev = resolve_device(device)
    model = Sequential.from_config(config)
    # parameters and buffers are created (and then overwritten) so that
    # load_state_dict can check every name and shape
    model.init(generator=torch.Generator().manual_seed(0), device=dev)
    if dtype is not None:
        model.to(dtype)
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


def pipeline_from_jax(coord, stage_params: Sequence[Any],
                      stage_states: Sequence[Any],
                      stage_opt_states: Optional[Sequence[Any]] = None
                      ) -> None:
    """Install a JAX pipeline's per-stage weights (each stage's ``params``
    and ``state`` pytrees as numpy arrays and, optionally, its optimizer
    state) on the deployed stages of the port's coordinator ``coord``."""
    for i, stage in enumerate(coord.stages):
        layers = stage.model.get_config()["layers"]
        flat_p: Dict[str, np.ndarray] = {}
        flat_s: Dict[str, np.ndarray] = {}
        _layers_state(layers, stage_params[i], "layers.", flat_p)
        _layers_state(layers, stage_states[i], "layers.", flat_s)
        stage.set_weights(flat_p, flat_s)
        if stage_opt_states is not None:
            stage.opt_state = opt_state_from_jax(stage.model,
                                                 stage_opt_states[i])


def pipeline_to_jax(coord) -> list:
    """The coordinator's stages as the JAX package's per-stage
    ``(params, state, opt_state)`` pytrees of numpy arrays."""
    coord.join()
    return [(to_jax(s.model), state_to_jax(s.model),
             opt_state_to_jax(s.model, s.opt_state)) for s in coord.stages]


def compiled_from_jax(pipe, stage_params: Sequence[Any],
                      stage_states: Sequence[Any]):
    """Load the per-stage trees of the JAX engine's ``unpack_params`` into
    the port's compiled pipeline ``pipe`` (its model initialised first
    when it has no parameters); returns ``(params, state)`` for its
    steps."""
    model = pipe.model
    if next(model.parameters(), None) is None:
        pipe.init(torch.Generator().manual_seed(0))
    dev = next(model.parameters()).device
    params = [layer for tree in stage_params for layer in tree]
    state = [layer for tree in stage_states for layer in tree]
    flat = _flat(model, params, dev)
    flat.update(_flat(model, state, dev))
    model.load_state_dict(flat, strict=True)
    return dict(model.named_parameters()), dict(model.named_buffers())


def compiled_to_jax(pipe, params: Mapping[str, torch.Tensor],
                    state: Mapping[str, torch.Tensor]) -> tuple:
    """The JAX engine's ``unpack_params`` output, ``(per-stage params,
    per-stage state)`` pytrees of numpy arrays, for the port's compiled
    pipeline's ``params`` and ``state``."""
    ps, ss = pipe.unpack_params(params, state)
    trees = []
    for per_stage in (ps, ss):
        trees.append([tree_from_flat(
            sm.get_config(), {n: t.numpy() for n, t in named.items()})
            for sm, named in zip(pipe.stage_models, per_stage)])
    return tuple(trees)


_DECODER_OWN = ("embed", "head_w", "head_b")


def decoder_from_jax(config: Dict[str, Any], params_np: Mapping[str, Any], *,
                     device: DeviceLike = None) -> MHADecoder:
    """The port's :class:`~dcnn_tpu_torch.models.decoder.MHADecoder` from
    the JAX decoder's ``get_config()`` and its params dict (``embed``,
    ``head_w``, ``head_b``, ``blocks``) as numpy arrays, on ``device``
    (CUDA unless ``"cpu"``), every array checked for name and shape."""
    model = MHADecoder.from_config(config).init(
        generator=torch.Generator().manual_seed(0), device=device)
    blocks = params_np["blocks"]
    if len(blocks) != model.num_layers:
        raise ValueError(f"{model.num_layers} blocks but {len(blocks)} param "
                         f"entries")
    flat = {n: np.asarray(params_np[n]) for n in _DECODER_OWN}
    for i, bp in enumerate(blocks):
        _layer_state({"type": "multi_head_attention"}, bp, f"blocks.{i}.",
                     flat)
    model.load_state_dict({k: torch.tensor(a) for k, a in flat.items()},
                          strict=True)
    return model


def decoder_to_jax(model: MHADecoder) -> Dict[str, Any]:
    """The inverse of :func:`decoder_from_jax`: the JAX decoder's params
    dict of numpy arrays."""
    flat = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    out: Dict[str, Any] = {n: flat[n] for n in _DECODER_OWN}
    out["blocks"] = [_layer_tree({"type": "multi_head_attention"},
                                 f"blocks.{i}.", flat)
                     for i in range(model.num_layers)]
    return out
