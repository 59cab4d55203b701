"""The port's optimizers and learning-rate schedulers held against the JAX
package.

Optimizers: the same params, gradients and state (numpy, from a seed) go
through three ``update`` calls of each package; params and state must agree
to 1e-6 (fp32, the same formula evaluated in another order). Schedulers:
the lr sequences of 30 steps must be equal, since both run the same Python
arithmetic in doubles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.optim import optimizers as jax_opt
from dcnn_tpu.optim import schedulers as jax_sched
from dcnn_tpu_torch.optim import optimizers as opt
from dcnn_tpu_torch.optim import schedulers as sched

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"w": (4, 3), "b": (3,), "e": (2, 5)}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}


OPTIMIZERS = {
    "sgd": lambda m: m.SGD(0.1),
    "sgd_momentum": lambda m: m.SGD(0.1, momentum=0.9),
    "adam": lambda m: m.Adam(1e-2),
    "adam_l2": lambda m: m.Adam(1e-2, weight_decay=0.1),
    "adamw": lambda m: m.AdamW(1e-2, weight_decay=0.1),
}


def _state_np(state):
    """An optimizer state of either package as nested numpy."""
    return jax.tree_util.tree_map(
        lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        state)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_updates_match_jax(name):
    """Three updates from the same params, grads and state; the lr changes
    between steps, as a scheduler would change it."""
    p0 = _arrays(0)
    grads = [_arrays(s) for s in (1, 2, 3)]
    lrs = [0.1, 0.05, 0.02] if name.startswith("sgd") else [1e-2, 5e-3, 2e-3]

    jo = OPTIMIZERS[name](jax_opt)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jo.init(jp)
    to = OPTIMIZERS[name](opt)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    ts = to.init(tp)
    for g, lr in zip(grads, lrs):
        jp, js = jo.update({n: jnp.asarray(a) for n, a in g.items()}, js, jp,
                           lr)
        ts = to.update({n: torch.from_numpy(a) for n, a in g.items()}, ts,
                       tp, lr)
    for n in SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), **TOL,
                                   err_msg=n)
    js_np, ts_np = _state_np(js), _state_np(ts)
    assert sorted(ts_np) == sorted(js_np)
    for key in js_np:
        if key == "t":
            assert ts_np["t"] == int(js_np["t"]) == 3
            continue
        for n in SHAPES:
            np.testing.assert_allclose(ts_np[key][n], js_np[key][n], **TOL,
                                       err_msg=f"{key}/{n}")


def test_sgd_velocity_carries_the_lr():
    """``v = mu*v - lr*g; p += v``, not ``torch.optim.SGD``'s ``v = mu*v +
    g; p -= lr*v``: with an lr change the two differ."""
    p = {"w": torch.zeros(1)}
    o = opt.SGD(momentum=0.5)
    st = o.init(p)
    o.update({"w": torch.ones(1)}, st, p, 1.0)
    o.update({"w": torch.ones(1)}, st, p, 0.1)
    assert st["velocity"]["w"].item() == pytest.approx(-0.6)
    assert p["w"].item() == pytest.approx(-1.6)


def test_adam_l2_decay_skips_the_moments():
    """Non-decoupled weight decay goes into the update, not the gradient:
    with a zero gradient the moments stay 0 and the step is wd*lr*p."""
    p = {"w": torch.full((2,), 2.0)}
    o = opt.Adam(0.1, weight_decay=0.5)
    st = o.init(p)
    o.update({"w": torch.zeros(2)}, st, p)
    assert st["m"]["w"].abs().max() == 0 and st["v"]["w"].abs().max() == 0
    torch.testing.assert_close(p["w"], torch.full((2,), 2.0 - 0.5 * 0.1 * 2))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_config_matches_jax_and_round_trips(name):
    cfg = OPTIMIZERS[name](opt).get_config()
    assert cfg == OPTIMIZERS[name](jax_opt).get_config()
    again = opt.OptimizerFactory.create_from_config(cfg)
    assert again.get_config() == cfg
    assert again.name() == OPTIMIZERS[name](jax_opt).name()


SCHEDULERS = {
    "step_lr": dict(step_size=4, gamma=0.5),
    "multi_step_lr": dict(milestones=[3, 10, 20], gamma=0.3),
    "exponential_lr": dict(gamma=0.9),
    "cosine_annealing_lr": dict(T_max=12, eta_min=1e-4),
    "cosine_annealing_warm_restarts": dict(T_0=4, T_mult=2, eta_min=1e-4),
    "linear_warmup": dict(warmup_steps=10, start_lr=1e-4),
    "warmup_cosine_annealing": dict(warmup_steps=5, total_steps=25,
                                    start_lr=1e-4, eta_min=1e-5),
    "reduce_lr_on_plateau": dict(factor=0.5, patience=2, threshold=1e-3),
    "polynomial_lr": dict(total_steps=20, power=2.0, end_lr=1e-4),
    "one_cycle_lr": dict(total_steps=30, pct_start=0.25),
}
# falls, stalls, falls again, stalls: the plateau scheduler cuts the lr in
# the stalls
METRICS = [1.0, 0.8, 0.7, 0.7, 0.7, 0.7, 0.69, 0.5, 0.5, 0.5, 0.5, 0.5,
           0.4, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.2, 0.2, 0.2, 0.2, 0.2,
           0.1, 0.1, 0.1, 0.1, 0.1, 0.1]


def test_every_family_is_covered():
    assert sorted(SCHEDULERS) == sorted(jax_sched.SchedulerFactory._TYPES) \
        == sorted(sched.SchedulerFactory._TYPES)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    js = jax_sched.SchedulerFactory.create(name, 0.1, **SCHEDULERS[name])
    ts = sched.SchedulerFactory.create(name, 0.1, **SCHEDULERS[name])
    assert ts.get_lr() == js.get_lr()
    want = [js.step(m) for m in METRICS]
    got = [ts.step(m) for m in METRICS]
    assert got == want
    assert len(set(got)) > 1, "the schedule never moved the lr"
    ts.reset()
    js.reset()
    assert ts.get_lr() == js.get_lr() and ts.current_step == 0


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_config_round_trips(name):
    s = sched.SchedulerFactory.create(name, 0.1, **SCHEDULERS[name])
    cfg = s.get_config()
    assert cfg == jax_sched.SchedulerFactory.create(
        name, 0.1, **SCHEDULERS[name]).get_config()
    again = sched.SchedulerFactory.create_from_config(cfg)
    assert again.get_config() == cfg
    assert [again.step(0.5) for _ in range(8)] == [s.step(0.5)
                                                   for _ in range(8)]


def test_scheduler_quirks():
    """StepLR multiplies the current lr, CosineAnnealingLR wraps at T_max,
    OneCycleLR comes down on a cosine."""
    s = sched.StepLR(1.0, step_size=2, gamma=0.5)
    assert [s.step() for _ in range(4)] == [1.0, 0.5, 0.5, 0.25]
    c = sched.CosineAnnealingLR(1.0, T_max=4)
    lrs = [c.step() for _ in range(5)]
    assert lrs[3] == 1.0 and lrs[4] == lrs[0]
    o = sched.OneCycleLR(1.0, total_steps=10, pct_start=0.2)
    lrs = [o.step() for _ in range(10)]
    assert lrs[1] == 1.0
    mid = o.min_lr + (1.0 - o.min_lr) * 0.5  # cos(pi/2): half way down
    np.testing.assert_allclose(lrs[5], mid, rtol=1e-12)
