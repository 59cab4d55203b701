"""Learning-rate schedulers (counterpart of ``dcnn_tpu/optim/schedulers.py``,
whose pure-Python code this module repeats so that the port imports nothing
of the JAX package).

The ten families and the factory follow the reference's formulas, quirks
included: StepLR multiplies the *current* lr every ``step_size`` steps,
CosineAnnealingLR wraps with ``step % T_max``, OneCycleLR's down phase is
cosine.

Each scheduler is a small stateful object (``step() -> lr``); the trainer
passes the returned lr to the optimizer's ``update`` on every step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence


class Scheduler:
    """Base (reference ``Scheduler<T>``, schedulers.hpp:42): tracks a step
    counter and the current lr derived from ``base_lr``."""

    def __init__(self, base_lr: float):
        self.base_lr = float(base_lr)
        self.lr = float(base_lr)
        self.current_step = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.current_step += 1
        self.lr = self._compute_lr(metric)
        return self.lr

    def _compute_lr(self, metric: Optional[float]) -> float:
        return self.lr

    def get_lr(self) -> float:
        return self.lr

    def reset(self) -> None:
        self.current_step = 0
        self.lr = self.base_lr

    def name(self) -> str:
        return type(self).__name__

    def get_config(self) -> Dict[str, Any]:
        return {"type": "scheduler", "base_lr": self.base_lr}


class StepLR(Scheduler):
    """Multiply lr by gamma every ``step_size`` steps (schedulers.hpp:59-90)."""

    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def _compute_lr(self, metric):
        if self.current_step % self.step_size == 0:
            return self.lr * self.gamma
        return self.lr

    def get_config(self):
        return {"type": "step_lr", "base_lr": self.base_lr,
                "step_size": self.step_size, "gamma": self.gamma}


class MultiStepLR(Scheduler):
    """Multiply lr by gamma at each milestone (schedulers.hpp:96-137)."""

    def __init__(self, base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones: List[int] = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)
        self._idx = 0

    def _compute_lr(self, metric):
        if self._idx < len(self.milestones) and self.current_step >= self.milestones[self._idx]:
            self._idx += 1
            return self.lr * self.gamma
        return self.lr

    def reset(self):
        super().reset()
        self._idx = 0

    def get_config(self):
        return {"type": "multi_step_lr", "base_lr": self.base_lr,
                "milestones": self.milestones, "gamma": self.gamma}


class ExponentialLR(Scheduler):
    """lr *= gamma every step (schedulers.hpp:143-170)."""

    def __init__(self, base_lr: float, gamma: float = 0.95):
        super().__init__(base_lr)
        self.gamma = float(gamma)

    def _compute_lr(self, metric):
        return self.lr * self.gamma

    def get_config(self):
        return {"type": "exponential_lr", "base_lr": self.base_lr, "gamma": self.gamma}


class CosineAnnealingLR(Scheduler):
    """Cosine from base_lr to eta_min over T_max, wrapping (schedulers.hpp:176-208)."""

    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = int(T_max)
        self.eta_min = float(eta_min)

    def _compute_lr(self, metric):
        step = self.current_step % self.T_max
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1.0 + math.cos(math.pi * step / self.T_max)) / 2.0

    def get_config(self):
        return {"type": "cosine_annealing_lr", "base_lr": self.base_lr,
                "T_max": self.T_max, "eta_min": self.eta_min}


class CosineAnnealingWarmRestarts(Scheduler):
    """SGDR restarts: cycle length T_i starts at T_0 and multiplies by T_mult
    (schedulers.hpp:214-263)."""

    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_0 = int(T_0)
        self.T_mult = int(T_mult)
        self.eta_min = float(eta_min)
        self.T_cur = 0
        self.T_i = self.T_0

    def _compute_lr(self, metric):
        self.T_cur += 1
        if self.T_cur >= self.T_i:
            self.T_cur = 0
            self.T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1.0 + math.cos(math.pi * self.T_cur / self.T_i)) / 2.0

    def reset(self):
        super().reset()
        self.T_cur = 0
        self.T_i = self.T_0

    def get_config(self):
        return {"type": "cosine_annealing_warm_restarts", "base_lr": self.base_lr,
                "T_0": self.T_0, "T_mult": self.T_mult, "eta_min": self.eta_min}


class LinearWarmup(Scheduler):
    """Linear start_lr → base_lr over warmup_steps (schedulers.hpp:270-307)."""

    def __init__(self, base_lr: float, warmup_steps: int, start_lr: float = 0.0):
        super().__init__(base_lr)
        self.warmup_steps = int(warmup_steps)
        self.start_lr = float(start_lr)
        self.lr = self.start_lr

    def _compute_lr(self, metric):
        if self.current_step <= self.warmup_steps:
            progress = self.current_step / self.warmup_steps
            return self.start_lr + progress * (self.base_lr - self.start_lr)
        return self.lr

    def reset(self):
        super().reset()
        self.lr = self.start_lr

    def get_config(self):
        return {"type": "linear_warmup", "base_lr": self.base_lr,
                "warmup_steps": self.warmup_steps, "start_lr": self.start_lr}


class WarmupCosineAnnealing(Scheduler):
    """Linear warmup then cosine decay to eta_min (schedulers.hpp:313-410)."""

    def __init__(self, base_lr: float, warmup_steps: int, total_steps: int,
                 start_lr: float = 0.0, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.warmup_steps = int(warmup_steps)
        self.total_steps = int(total_steps)
        self.start_lr = float(start_lr)
        self.eta_min = float(eta_min)
        self.lr = self.start_lr

    def _compute_lr(self, metric):
        if self.current_step <= self.warmup_steps:
            progress = self.current_step / max(self.warmup_steps, 1)
            return self.start_lr + progress * (self.base_lr - self.start_lr)
        decay_steps = max(self.total_steps - self.warmup_steps, 1)
        cur = min(self.current_step - self.warmup_steps, decay_steps)
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1.0 + math.cos(math.pi * cur / decay_steps)) / 2.0

    def reset(self):
        super().reset()
        self.lr = self.start_lr

    def get_config(self):
        return {"type": "warmup_cosine_annealing", "base_lr": self.base_lr,
                "warmup_steps": self.warmup_steps, "total_steps": self.total_steps,
                "start_lr": self.start_lr, "eta_min": self.eta_min}


class ReduceLROnPlateau(Scheduler):
    """Multiply lr by ``factor`` after ``patience`` steps without metric
    improvement beyond ``threshold`` (schedulers.hpp:412-489)."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, min_lr: float = 0.0):
        super().__init__(base_lr)
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_lr = float(min_lr)
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0

    def _compute_lr(self, metric):
        if metric is None:
            return self.lr
        improved = (metric < self.best - self.threshold) if self.mode == "min" \
            else (metric > self.best + self.threshold)
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(self.lr * self.factor, self.min_lr)
        return self.lr

    def reset(self):
        super().reset()
        self.best = math.inf if self.mode == "min" else -math.inf
        self.bad_epochs = 0

    def get_config(self):
        return {"type": "reduce_lr_on_plateau", "base_lr": self.base_lr,
                "mode": self.mode, "factor": self.factor, "patience": self.patience,
                "threshold": self.threshold, "min_lr": self.min_lr}


class PolynomialLR(Scheduler):
    """(base−end)·(1−t/T)^power + end (schedulers.hpp:494-529)."""

    def __init__(self, base_lr: float, total_steps: int, power: float = 1.0,
                 end_lr: float = 0.0):
        super().__init__(base_lr)
        self.total_steps = int(total_steps)
        self.power = float(power)
        self.end_lr = float(end_lr)

    def _compute_lr(self, metric):
        progress = min(self.current_step / self.total_steps, 1.0)
        return (self.base_lr - self.end_lr) * (1.0 - progress) ** self.power + self.end_lr

    def get_config(self):
        return {"type": "polynomial_lr", "base_lr": self.base_lr,
                "total_steps": self.total_steps, "power": self.power,
                "end_lr": self.end_lr}


class OneCycleLR(Scheduler):
    """1cycle: linear up to max_lr for pct_start, cosine down to
    max_lr/div_factor/final_div_factor (schedulers.hpp:533-596)."""

    def __init__(self, max_lr: float, total_steps: int, pct_start: float = 0.3,
                 div_factor: float = 25.0, final_div_factor: float = 1e4):
        self.max_lr = float(max_lr)
        self.total_steps = int(total_steps)
        self.pct_start = float(pct_start)
        self.div_factor = float(div_factor)
        self.final_div_factor = float(final_div_factor)
        self.initial_lr = self.max_lr / self.div_factor
        self.min_lr = self.initial_lr / self.final_div_factor
        self.step_up = int(self.total_steps * self.pct_start)
        self.step_down = self.total_steps - self.step_up
        super().__init__(self.initial_lr)

    def _compute_lr(self, metric):
        if self.current_step <= self.step_up:
            progress = self.current_step / max(self.step_up, 1)
            return self.initial_lr + progress * (self.max_lr - self.initial_lr)
        progress = (self.current_step - self.step_up) / max(self.step_down, 1)
        return self.min_lr + (self.max_lr - self.min_lr) * \
            (1.0 + math.cos(math.pi * progress)) / 2.0

    def get_config(self):
        return {"type": "one_cycle_lr", "max_lr": self.max_lr,
                "total_steps": self.total_steps, "pct_start": self.pct_start,
                "div_factor": self.div_factor, "final_div_factor": self.final_div_factor}


class SchedulerFactory:
    """String/JSON construction (reference ``SchedulerFactory``,
    schedulers.hpp:598-698)."""

    _TYPES = {
        "step_lr": StepLR,
        "multi_step_lr": MultiStepLR,
        "exponential_lr": ExponentialLR,
        "cosine_annealing_lr": CosineAnnealingLR,
        "cosine_annealing_warm_restarts": CosineAnnealingWarmRestarts,
        "linear_warmup": LinearWarmup,
        "warmup_cosine_annealing": WarmupCosineAnnealing,
        "reduce_lr_on_plateau": ReduceLROnPlateau,
        "polynomial_lr": PolynomialLR,
        "one_cycle_lr": OneCycleLR,
    }

    @classmethod
    def create(cls, name: str, base_lr: float, **params) -> Scheduler:
        if name not in cls._TYPES:
            raise ValueError(f"Unknown scheduler type: {name}")
        if name == "one_cycle_lr":
            params.setdefault("max_lr", base_lr)
            return OneCycleLR(**params)
        return cls._TYPES[name](base_lr, **params)

    @classmethod
    def create_from_config(cls, cfg: Dict[str, Any]) -> Scheduler:
        cfg = dict(cfg)
        ty = cfg.pop("type")
        base_lr = cfg.pop("base_lr", None)
        if ty == "one_cycle_lr":
            return OneCycleLR(**cfg)
        return cls._TYPES[ty](base_lr, **cfg)
