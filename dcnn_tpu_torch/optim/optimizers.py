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
per-batch lr vectors stay on the card). Both give the same bits: a float
lr is rounded to fp32 and a product with it (``wd·lr``) is taken in fp32,
as the tensor lr's is and as the JAX package's f32 lr is, so a chunked
epoch equals the per-step loop. ``params``
and ``grads`` map parameter names (``model.named_parameters()``) to tensors.
Unlike the JAX functions, ``update`` works in place: it overwrites the
params and the state's tensors and returns the state, which saves a copy of
every parameter and moment per step. The state keeps the JAX names
(``velocity``; ``m``, ``v``, ``t``), so :mod:`dcnn_tpu_torch.interop`
carries it across.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

OptState = Dict[str, Any]
Tensors = Mapping[str, torch.Tensor]


def _lr(lr, default: float):
    """The step's lr: the default or a float, rounded to fp32, or a device
    tensor kept as it is (reading it would wait for the card)."""
    if lr is None:
        lr = default
    return lr if isinstance(lr, torch.Tensor) else float(np.float32(lr))


def _times_lr(c: float, lr):
    """``c·lr`` rounded as a tensor lr's product is: both factors in fp32,
    the product rounded once to fp32 (a float product in double would
    differ from it by an ulp for some lrs)."""
    if isinstance(lr, torch.Tensor):
        return c * lr
    return float(np.float32(c) * np.float32(lr))


def _zeros(params: Tensors) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros_like(p, memory_format=torch.preserve_format)
            for n, p in params.items()}


class Optimizer:
    """Base: a stateless spec; all state is in the ``opt_state`` dict."""

    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = float(learning_rate)

    def init(self, params: Tensors) -> OptState:
        raise NotImplementedError

    def update(self, grads: Tensors, opt_state: OptState, params: Tensors,
               lr: Optional[float] = None) -> OptState:
        raise NotImplementedError

    def get_config(self) -> Dict[str, Any]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0):
        super().__init__(learning_rate)
        self.momentum = float(momentum)

    def init(self, params):
        if self.momentum > 0.0:
            return {"velocity": _zeros(params)}
        return {}

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr=None):
        lr = _lr(lr, self.learning_rate)
        for n, p in params.items():
            g = grads[n]
            if self.momentum > 0.0:
                v = opt_state["velocity"][n]
                v.copy_(self.momentum * v - lr * g)
                p.add_(v)
            else:
                p.sub_(lr * g)
        return opt_state

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

    @torch.no_grad()
    def update(self, grads, opt_state, params, lr=None):
        lr = _lr(lr, self.learning_rate)
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, self.weight_decay
        t = int(opt_state["t"]) + 1
        # fp32 bias corrections, as the JAX package computes them from its
        # int32 step
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        for n, p in params.items():
            g = grads[n]
            m, v = opt_state["m"][n], opt_state["v"][n]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            update = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd > 0.0:
                if self.decouple_weight_decay:
                    p.sub_(_times_lr(wd, lr) * p)  # AdamW
                else:  # L2 in the update
                    update = update + _times_lr(wd, lr) * p
            p.sub_(update)
        opt_state["t"] = t
        return opt_state

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
