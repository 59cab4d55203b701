"""Optimizers (counterpart of ``dcnn_tpu/optim/optimizers.py``), with the
reference's update rules, which are not those of ``torch.optim``:

- SGD: ``p -= lr·g``; with momentum ``v = μ·v − lr·g; p += v`` (the velocity
  carries the lr; ``torch.optim.SGD`` keeps ``v = μ·v + g``).
- Adam: moments ``m``, ``v`` with bias correction by the integer step
  ``t``, ε added after the square root. Non-decoupled weight decay is added
  to the *update* (``torch.optim.Adam`` adds it to the gradient, where it
  reaches the moments); decoupled (AdamW) multiplies the params by
  ``(1 − wd·lr)`` first.

As in the JAX package, an optimizer is a stateless spec: ``init(params)``
makes the state and ``update(grads, opt_state, params, lr)`` applies one
step, with ``lr`` given per step by the trainer or a scheduler: a float,
or a 0-d tensor on the params' device (the resident and chunked epochs'
per-batch lr vectors stay on the card). ``params`` and ``grads`` map
parameter names (``model.named_parameters()``) to tensors.

A step's host scalars (the lr; Adam's bias corrections, from the integer
step ``t``) reach its kernels as 0-d fp32 tensors, not as constants, so
that a CUDA graph of the step reads each step's values:
:meth:`Optimizer.scalars` makes them once, :meth:`Optimizer.fill_scalars`
writes the next step's values into them (fills queued on the card, no
wait for it), :meth:`Optimizer.apply` is the step's device work
reading them, and :meth:`Optimizer.advance` moves ``t`` on the host.
``update`` is the four in a row. A float lr is rounded to fp32 in its
tensor, and ``wd·lr`` is the fp32 product of two fp32 factors, so a float
and a tensor lr give the same bits, as the JAX package's f32 lr does on
both of its paths. ``t`` stays a host int in the state (the JAX layout),
and the bias corrections stay the JAX package's fp32 values.

Unlike the JAX functions, ``update`` works in place: it overwrites the
params and the state's tensors and returns the state, which saves a copy of
every parameter and moment per step. The state keeps the JAX names
(``velocity``; ``m``, ``v``, ``t``), so :mod:`dcnn_tpu_torch.interop`
carries it across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..nn.sequential import merge_named, split_named

OptState = Dict[str, Any]
Tensors = Mapping[str, torch.Tensor]
Scalars = Dict[str, torch.Tensor]


def _zeros(params: Tensors) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, memory_format=torch.preserve_format)
            for n, p in params.items()}


class Optimizer:
    """Base: a stateless spec; all state is in the ``opt_state`` dict."""

    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = float(learning_rate)

    def init(self, params: Tensors) -> OptState:
        raise NotImplementedError

    def scalars(self, device) -> Scalars:
        """The step's host scalars as 0-d fp32 tensors on ``device``."""
        return {"lr": torch.zeros((), dtype=torch.float32, device=device)}

    def fill_scalars(self, scalars: Scalars, opt_state: OptState,
                     lr=None) -> None:
        """Write the values of the step after ``opt_state``'s into
        ``scalars``: ``lr`` (the default when None) as a float rounded to
        fp32 or a tensor copied on the card, never read on the host."""
        lr = self.learning_rate if lr is None else lr
        if isinstance(lr, torch.Tensor):
            scalars["lr"].copy_(lr.reshape(()))
        else:
            scalars["lr"].fill_(float(np.float32(lr)))

    def apply(self, grads: Tensors, opt_state: OptState, params: Tensors,
              scalars: Scalars) -> None:
        """The step's device work, in place, reading ``scalars``."""
        raise NotImplementedError

    def advance(self, opt_state: OptState) -> None:
        """Count the step on the host (Adam's ``t``)."""

    def update(self, grads: Tensors, opt_state: OptState, params: Tensors,
               lr=None) -> OptState:
        """One step in place: fill, apply, advance. Returns the state."""
        scalars = self.scalars(next(iter(params.values())).device)
        self.fill_scalars(scalars, opt_state, lr)
        self.apply(grads, opt_state, params, scalars)
        self.advance(opt_state)
        return opt_state

    def get_config(self) -> Dict[str, Any]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    # -- pipeline split/merge --
    #
    # The built-in optimizers' state is a dict whose values are either
    # per-parameter mappings under the model's names (SGD's velocity,
    # Adam's m and v), cut along layer ranges as ``Sequential.split_params``
    # cuts the params, or whole-run leaves that every stage holds alike
    # (Adam's step t; a 0-d tensor is copied): replicated on split, the
    # first stage's taken on merge. An optimizer whose state breaks this
    # convention overrides both methods.

    def split_state(self, opt_state: OptState,
                    partitions) -> List[OptState]:
        """One state per ``[start, end)`` layer range, each under its stage
        model's parameter names."""
        out: List[OptState] = [{} for _ in partitions]
        for k, v in opt_state.items():
            if isinstance(v, Mapping):
                for st, piece in zip(out, split_named(v, partitions)):
                    st[k] = piece
            else:
                for st in out:
                    st[k] = (v.clone() if isinstance(v, torch.Tensor)
                             else v)
        return out

    def merge_state(self, states, partitions) -> OptState:
        """The inverse of :meth:`split_state`, the stage states given in
        partition order."""
        return {k: (merge_named([st[k] for st in states], partitions)
                    if isinstance(v0, Mapping) else v0)
                for k, v0 in states[0].items()}


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0):
        super().__init__(learning_rate)
        self.momentum = float(momentum)

    def init(self, params):
        if self.momentum > 0.0:
            return {"velocity": _zeros(params)}
        return {}

    @torch.no_grad()
    def apply(self, grads, opt_state, params, scalars):
        lr = scalars["lr"]
        for n, p in params.items():
            g = grads[n]
            if self.momentum > 0.0:
                v = opt_state["velocity"][n]
                v.copy_(self.momentum * v - lr * g)
                p.add_(v)
            else:
                p.sub_(lr * g)

    def get_config(self):
        return {"type": "sgd", "learning_rate": self.learning_rate,
                "momentum": self.momentum}


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0,
                 decouple_weight_decay: bool = False):
        super().__init__(learning_rate)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
        self.weight_decay = float(weight_decay)
        self.decouple_weight_decay = bool(decouple_weight_decay)

    def init(self, params):
        return {"m": _zeros(params), "v": _zeros(params), "t": 0}

    def scalars(self, device):
        sc = super().scalars(device)
        sc["bc1"] = torch.ones((), dtype=torch.float32, device=device)
        sc["bc2"] = torch.ones((), dtype=torch.float32, device=device)
        return sc

    def fill_scalars(self, scalars, opt_state, lr=None):
        super().fill_scalars(scalars, opt_state, lr)
        t = np.float32(int(opt_state["t"]) + 1)
        # fp32 bias corrections, as the JAX package computes them from its
        # int32 step
        one = np.float32(1.0)
        scalars["bc1"].fill_(float(one - np.float32(self.beta1) ** t))
        scalars["bc2"].fill_(float(one - np.float32(self.beta2) ** t))

    @torch.no_grad()
    def apply(self, grads, opt_state, params, scalars):
        lr, bc1, bc2 = scalars["lr"], scalars["bc1"], scalars["bc2"]
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, self.weight_decay
        wd_lr = wd * lr if wd > 0.0 else None  # fp32 product, rounded once
        for n, p in params.items():
            g = grads[n]
            m, v = opt_state["m"][n], opt_state["v"][n]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            update = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd > 0.0:
                if self.decouple_weight_decay:
                    p.sub_(wd_lr * p)  # AdamW
                else:  # L2 in the update
                    update = update + wd_lr * p
            p.sub_(update)

    def advance(self, opt_state):
        opt_state["t"] = int(opt_state["t"]) + 1

    def name(self):
        return "AdamW" if self.decouple_weight_decay else "Adam"

    def get_config(self):
        return {"type": "adamw" if self.decouple_weight_decay else "adam",
                "learning_rate": self.learning_rate, "beta1": self.beta1,
                "beta2": self.beta2, "epsilon": self.epsilon,
                "weight_decay": self.weight_decay,
                "decouple_weight_decay": self.decouple_weight_decay}


def AdamW(learning_rate: float = 0.001, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-8,
          weight_decay: float = 0.01) -> Adam:
    """Adam with decoupled weight decay."""
    return Adam(learning_rate, beta1, beta2, epsilon, weight_decay,
                decouple_weight_decay=True)


class OptimizerFactory:
    """Construction from the JSON config ``get_config`` gives."""

    @staticmethod
    def create_from_config(cfg: Dict[str, Any]) -> Optimizer:
        ty = cfg.get("type", "sgd").lower()
        kw = {k: v for k, v in cfg.items() if k != "type"}
        if ty == "sgd":
            return SGD(**kw)
        if ty == "adam":
            return Adam(**kw)
        if ty == "adamw":
            kw.pop("decouple_weight_decay", None)
            return AdamW(**kw)
        raise ValueError(f"unknown optimizer type {ty!r}")
