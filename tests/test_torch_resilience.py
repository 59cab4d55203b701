"""Fault tolerance in the port (``dcnn_tpu_torch/resilience``), the twins
of ``tests/test_resilience.py`` on the CPU, plus the port's own trouble
spots and a resume across packages.

- FaultPlan: arming at invocations and counts, the seeded bit flip.
- Checkpoints: a crash mid-save leaves the previous checkpoint loadable;
  the manager's round trip, manifest and retention; a crash at every trip
  point leaves a checksum-valid checkpoint; a bit-flipped checkpoint is
  skipped (and quarantined) for the newest valid one; async saves never
  block on a wedged writer, surface their failures, and hold the metadata
  and the arrays as they were at save time, although the port's step then
  updates the params in place.
- Guards: a skipped step leaves params, optimizer state, step count and
  batchnorm running statistics bit-identical; ``raise`` names the step;
  rollback after N consecutive bad steps; the watchdog with a fake clock;
  the guard changes nothing on a good step.
- Resume: crashed mid-epoch by a FaultPlan and resumed with
  ``resume="auto"``, a run is bit-identical to the uninterrupted one (loss
  per epoch, lr, params, optimizer state); a port run resumed from the JAX
  package's checkpoints tracks JAX's uninterrupted run (parity: 1e-5
  relative, the same SGD steps summed in another order).
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from dcnn_tpu.core.config import TrainingConfig as JaxConfig
from dcnn_tpu.data import SyntheticClassificationLoader as JaxSynthetic
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.optim import SGD as JaxSGD
from dcnn_tpu.train import trainer as jax_trainer
from dcnn_tpu_torch.core import TrainingConfig
from dcnn_tpu_torch.data import SyntheticClassificationLoader
from dcnn_tpu_torch.interop import to_jax
from dcnn_tpu_torch.nn import SequentialBuilder
from dcnn_tpu_torch.obs import MetricsRegistry, get_registry
from dcnn_tpu_torch.ops.losses import get_loss
from dcnn_tpu_torch.optim import SGD, Adam
from dcnn_tpu_torch.resilience import (
    CheckpointManager, FaultPlan, InjectedCrash, InjectedFault,
    NonFiniteError, StallWatchdog, StepGuard, faults, restore_latest,
    sweep_stale_tmp, write_file_atomic,
)
from dcnn_tpu_torch.train import (
    Trainer, create_train_state, load_checkpoint, make_train_step,
    save_checkpoint,
)

CE = get_loss("softmax_crossentropy")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.clear()  # a failing test must not leave a plan armed for others


def _model(name="rsl"):
    return (SequentialBuilder(name).input((1, 8, 8))
            .conv2d(2, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(4).build())


def _state(seed=0, opt=None):
    model = _model()
    opt = opt or Adam(1e-3)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(seed),
                            device="cpu")
    return model, opt, ts


def _batch(n=8, seed=0, poison=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 8, 8)).astype(np.float32)
    if poison:
        x[:] = np.nan
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return torch.from_numpy(x), torch.from_numpy(y)


def _copy(model, ts):
    """Every array a step may change, copied: params, buffers, optimizer
    state (Adam's t as an int)."""
    return {"p": {n: t.detach().clone() for n, t in model.named_parameters()},
            "b": {n: t.detach().clone() for n, t in model.named_buffers()},
            "o": {k: (int(v) if k == "t" else
                      {n: t.clone() for n, t in v.items()})
                  for k, v in ts.opt_state.items()}}


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def _restored(model, opt_state):
    return {"p": dict(model.named_parameters()),
            "b": dict(model.named_buffers()), "o": opt_state}


def _loader(n=32, seed=0):
    ld = SyntheticClassificationLoader(n, (1, 8, 8), 4, batch_size=8,
                                       seed=seed)
    ld.load_data()
    return ld


# -- FaultPlan ---------------------------------------------------------------

def test_fault_plan_arming_at_times_and_counts():
    plan = FaultPlan(seed=0)
    plan.arm("p", at=1, times=1)  # exactly the second invocation fires
    with plan:
        faults.trip("p")
        with pytest.raises(InjectedFault) as ei:
            faults.trip("p", step=7)
        assert ei.value.invocation == 1 and ei.value.context["step"] == 7
        faults.trip("p")         # times=1 consumed
    assert plan.count("p") == 3
    plan2 = FaultPlan().arm("q", times=2, exc=OSError)
    with plan2:
        for _ in range(2):
            with pytest.raises(OSError):
                faults.trip("q")
        faults.trip("q")         # disarmed
    faults.trip("p")             # cleared: no active plan


def test_fault_plan_bit_flip_is_seeded_and_corrupts(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(bytes(range(64)))
    off1 = FaultPlan(seed=5).bit_flip(str(p))
    p.write_bytes(bytes(range(64)))
    off2 = FaultPlan(seed=5).bit_flip(str(p))
    assert off1 == off2
    assert p.read_bytes() != bytes(range(64))


def test_atomic_write_and_stale_sweep(tmp_path):
    """A committed file holds its new bytes and no tmp sibling is left;
    the sweep removes staging and quarantine dirs only."""
    f = tmp_path / "a.bin"
    write_file_atomic(str(f), b"one")
    write_file_atomic(str(f), b"two")
    assert f.read_bytes() == b"two" and os.listdir(tmp_path) == ["a.bin"]
    for name in ("tmp-1", "corrupt-x", "ckpt-00000001"):
        (tmp_path / name).mkdir()
    assert sweep_stale_tmp(str(tmp_path), prefixes=("tmp-", "corrupt-")) == 2
    assert sorted(os.listdir(tmp_path)) == ["a.bin", "ckpt-00000001"]


def test_registry_counters_gauges_histograms():
    reg = MetricsRegistry(clock=lambda: 0.0)
    reg.counter("ckpt.saves_total").inc(2)
    assert reg.counter("ckpt_saves_total").value == 2   # dots map to _
    reg.gauge("g").set(1.5)
    h = reg.histogram("h", start=1.0, factor=2.0, buckets=3)
    for v in (0.5, 3.0, 100.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["g"] == 1.5 and snap["h"]["count"] == 3
    assert snap["h"]["overflow"] == 1 and snap["h"]["buckets"] == {
        1.0: 1, 4.0: 1}
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("ckpt_saves_total")
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("µs")
    with pytest.raises(ValueError, match="negative"):
        reg.counter("c").inc(-1)
    assert get_registry() is get_registry()


# -- checkpoints ----------------------------------------------------------

def test_crash_mid_save_leaves_previous_checkpoint_loadable(tmp_path):
    d = str(tmp_path / "ck")
    model, opt, ts = _state()
    save_checkpoint(d, model, ts.opt_state, opt, {"epoch": 1})
    ref = _copy(model, ts)
    step = make_train_step(model, CE, opt)
    step(ts, *_batch(), 1e-3)
    with FaultPlan().arm("ckpt.write", exc=InjectedCrash):
        with pytest.raises(InjectedCrash):
            save_checkpoint(d, model, ts.opt_state, opt, {"epoch": 2})
    m2, opt_state, _, md = load_checkpoint(d, device="cpu")
    _same(ref, _restored(m2, opt_state))
    assert md["epoch"] == 1
    assert sorted(os.listdir(d)) == ["arrays.msgpack", "model.json"]


def test_manager_roundtrip_manifest_and_retention(tmp_path):
    d = str(tmp_path)
    model, opt, ts = _state()
    with CheckpointManager(d, keep=2) as cm:
        for s in (1, 2, 3):
            cm.save(s, model, ts.opt_state, opt, {"epoch": s})
        assert sorted(os.listdir(d)) == ["ckpt-00000002", "ckpt-00000003"]
        r = cm.restore_latest(device="cpu")
    assert r.step == 3 and r.metadata == {"epoch": 3}
    _same(_copy(model, ts), _restored(r.model, r.opt_state))
    man = json.loads(open(os.path.join(r.path, "MANIFEST.json")).read())
    assert man["step"] == 3
    assert set(man["files"]) == {"model.json", "arrays.msgpack"}
    with CheckpointManager(d, keep=2) as cm2, pytest.raises(FileExistsError):
        cm2.save(3, model, ts.opt_state, opt)


@pytest.mark.parametrize("point,survivor", [
    ("ckpt.write", 1),          # crash mid-stage: files partial in tmp
    ("ckpt.before_rename", 1),  # staged + manifested, never committed
    ("ckpt.after_rename", 2),   # committed: the new checkpoint is the truth
])
def test_crash_recovery_invariant_every_crash_point(tmp_path, point,
                                                    survivor):
    d = str(tmp_path)
    model, opt, ts = _state()
    with CheckpointManager(d, keep=3) as cm:
        cm.save(1, model, ts.opt_state, opt, {"epoch": 1})
        with FaultPlan().arm(point, exc=InjectedCrash):
            with pytest.raises(InjectedCrash):
                cm.save(2, model, ts.opt_state, opt, {"epoch": 2})
    with CheckpointManager(d, keep=3) as cm2:
        r = cm2.restore_latest(device="cpu")
        assert r is not None and r.step == survivor
        assert not [f for f in os.listdir(d) if f.startswith("tmp-")]
    _same(_copy(model, ts), _restored(r.model, r.opt_state))


def test_restore_skips_bit_flipped_checkpoint_to_newest_valid(tmp_path):
    d = str(tmp_path)
    model, opt, ts = _state()
    reg = get_registry()
    before = reg.counter("ckpt_restore_skipped_total").value
    with CheckpointManager(d, keep=3) as cm:
        cm.save(1, model, ts.opt_state, opt)
        cm.save(2, model, ts.opt_state, opt)
        FaultPlan(seed=7).bit_flip(
            os.path.join(d, "ckpt-00000002", "arrays.msgpack"))
        with pytest.warns(UserWarning, match="torn/corrupt"):
            r = cm.restore_latest(device="cpu")
    assert r.step == 1
    assert reg.counter("ckpt_restore_skipped_total").value == before + 1
    FaultPlan(seed=8).bit_flip(os.path.join(d, "ckpt-00000001", "model.json"))
    with pytest.warns(UserWarning):
        assert restore_latest(d, device="cpu") is None


def test_corrupt_checkpoint_is_quarantined_not_blocking_resave(tmp_path):
    d = str(tmp_path)
    model, opt, ts = _state()
    with CheckpointManager(d, keep=3) as cm:
        cm.save(1, model, ts.opt_state, opt)
        cm.save(2, model, ts.opt_state, opt)
        FaultPlan(seed=9).bit_flip(
            os.path.join(d, "ckpt-00000002", "arrays.msgpack"))
        with pytest.warns(UserWarning, match="quarantined"):
            r = cm.restore_latest(device="cpu")
        assert r.step == 1
        assert any(n.startswith("corrupt-ckpt-00000002")
                   for n in os.listdir(d))
        cm.save(2, model, ts.opt_state, opt)
        assert cm.restore_latest(device="cpu").step == 2
    with CheckpointManager(d, keep=3):
        assert not [n for n in os.listdir(d) if n.startswith("corrupt-")]


def _gated(gate, wrote=None):
    def write(path, data):
        if not gate.wait(timeout=30):
            raise TimeoutError("test gate never released")
        if wrote is not None:
            wrote.append(os.path.basename(path))
        with open(path, "wb") as f:
            f.write(data)
    return write


def test_async_check_nonblocking_probe(tmp_path):
    model, opt, ts = _state()
    gate = threading.Event()

    def broken(path, data):
        if not gate.wait(timeout=30):
            raise TimeoutError("gate never released")
        raise OSError("quota exceeded")

    cm = CheckpointManager(str(tmp_path), keep=2, io_write=broken)
    fut = cm.save_async(1, model, ts.opt_state, opt)
    cm.check()   # still in flight: the probe keeps it, no raise
    assert cm.health() is None
    gate.set()
    assert isinstance(fut.exception(timeout=30), OSError)
    assert isinstance(cm.health(), OSError)
    with pytest.raises(OSError, match="quota"):
        cm.check()
    cm.check()   # inspected futures are dropped: no double raise
    cm.close()


def test_async_metadata_and_arrays_are_frozen_at_save_time(tmp_path):
    """The trainer appends to its history, and the port's step updates
    params, running statistics and Adam's moments in place, while the
    saver thread is parked: the checkpoint holds both as they were when
    save_async returned."""
    model, opt, ts = _state()
    step = make_train_step(model, CE, opt)
    step(ts, *_batch(seed=1), 1e-3)           # nonzero moments, t = 1
    gate = threading.Event()
    cm = CheckpointManager(str(tmp_path), keep=2, io_write=_gated(gate))
    history = [{"epoch": 1, "loss": 0.5}]
    ref = _copy(model, ts)
    cm.save_async(1, model, ts.opt_state, opt, {"history": history})
    history.append({"epoch": 2, "loss": 0.25})
    step(ts, *_batch(seed=2), 1e-3)           # in place, while parked
    after = _copy(model, ts)
    gate.set()
    cm.wait(timeout=30)
    cm.close()
    r = restore_latest(str(tmp_path), device="cpu")
    assert r.metadata["history"] == [{"epoch": 1, "loss": 0.5}]
    _same(ref, _restored(r.model, r.opt_state))
    assert not torch.equal(after["p"]["layers.0.w"], ref["p"]["layers.0.w"])


def test_restore_latest_empty_and_missing_dir(tmp_path):
    assert restore_latest(str(tmp_path), device="cpu") is None
    assert restore_latest(str(tmp_path / "never_made"), device="cpu") is None


def test_async_save_never_blocks_on_slow_filesystem(tmp_path):
    d = str(tmp_path)
    model, opt, ts = _state()
    gate = threading.Event()
    wrote = []
    cm = CheckpointManager(d, keep=2, io_write=_gated(gate, wrote))
    fut = cm.save_async(1, model, ts.opt_state, opt, {"epoch": 1})
    step = make_train_step(model, CE, opt)
    for i in range(3):
        loss, _ = step(ts, *_batch(seed=i), 1e-3)
        assert np.isfinite(float(loss))
    assert not fut.done()
    assert cm.latest_step() is None
    gate.set()
    cm.wait(timeout=30)
    assert fut.result(timeout=0).endswith("ckpt-00000001")
    assert cm.latest_step() == 1
    assert wrote[-1] == "MANIFEST.json"   # the manifest is written last
    cm.close()


def test_async_save_failure_surfaces_in_wait(tmp_path):
    model, opt, ts = _state()

    def broken_write(path, data):
        raise OSError("disk full")

    cm = CheckpointManager(str(tmp_path), keep=2, io_write=broken_write)
    cm.save_async(1, model, ts.opt_state, opt)
    with pytest.raises(OSError, match="disk full"):
        cm.wait(timeout=30)
    cm.close()
    assert cm.latest_step() is None
    assert not [f for f in os.listdir(str(tmp_path)) if f.startswith("tmp-")]


# -- guards -----------------------------------------------------------------

def test_guarded_step_skip_is_bit_identical_to_previous_step():
    """A NaN batch under the guard: params, Adam's state, the step count
    and the batchnorm running statistics (which the training forward moved
    to NaN in place) are bit-identical to before it."""
    model, opt, ts = _state()
    step = make_train_step(model, CE, opt, guard=True)
    loss, _, bad = step(ts, *_batch(), 1e-3)
    assert not bad and np.isfinite(float(loss))
    ref, step_before = _copy(model, ts), ts.step
    loss2, _, bad2 = step(ts, *_batch(poison=True), 1e-3)
    assert bad2 and not np.isfinite(float(loss2))
    _same(ref, _copy(model, ts))
    assert ts.step == step_before
    reg = get_registry()
    before = reg.counter("train_skipped_steps_total").value
    guard = StepGuard("skip_step")
    with pytest.warns(UserWarning, match="skipped"):
        assert guard.observe(7, True) == "skipped"
    assert reg.counter("train_skipped_steps_total").value == before + 1
    assert guard.observe(8, False) == "ok"
    assert guard.consecutive_bad == 0


def test_guard_changes_nothing_on_a_good_step():
    """The guarded and the unguarded step from the same state and batch:
    the same loss and bit-identical params, statistics and moments; the
    unguarded step returns (loss, logits) as before."""
    outs = []
    for guard in (False, True):
        model, opt, ts = _state()
        step = make_train_step(model, CE, opt, guard=guard)
        out = step(ts, *_batch(), 1e-3)
        assert len(out) == (3 if guard else 2)
        outs.append((float(out[0]), _copy(model, ts), ts.step))
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2] == 1
    _same(outs[0][1], outs[1][1])


def test_guard_raise_policy_names_the_step():
    guard = StepGuard("raise")
    with pytest.raises(NonFiniteError, match="step 41"):
        guard.observe(41, True, loss=float("nan"))


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_guard_rollback_after_n_consecutive():
    guard = StepGuard("rollback", rollback_after=3)
    assert guard.observe(1, True) == "skipped"
    assert guard.observe(2, True) == "skipped"
    assert guard.observe(3, True) == "rollback"
    assert guard.consecutive_bad == 0
    assert guard.observe(4, True) == "skipped"
    guard.observe(5, False)
    assert guard.observe(6, True) == "skipped"


def test_step_guard_validation():
    with pytest.raises(ValueError, match="nonfinite_policy"):
        StepGuard("explode")
    with pytest.raises(ValueError, match="rollback_after"):
        StepGuard("rollback", rollback_after=0)


def test_stall_watchdog_flags_via_registry_sleep_free():
    t = [0.0]
    reg = get_registry()
    wd = StallWatchdog(10.0, clock=lambda: t[0], registry=reg)
    before = reg.counter("train_stall_flags_total").value
    assert not wd.check()
    t[0] = 9.0
    assert not wd.check()
    t[0] = 11.0
    with pytest.warns(UserWarning, match="stalled"):
        assert wd.check()
    assert wd.check()                        # still stalled, flagged once
    assert reg.counter("train_stall_flags_total").value == before + 1
    assert reg.gauge("train_stalled").value == 1
    t[0] = 12.0
    wd.beat()
    assert reg.gauge("train_stalled").value == 0
    assert not wd.check()


def test_rollback_policy_requires_checkpoint_dir():
    cfg = TrainingConfig(device_type="cpu", nonfinite_policy="rollback",
                         checkpoint_dir=None)
    with pytest.raises(ValueError, match="rollback.*checkpoint_dir"):
        Trainer(_model("nodir"), Adam(1e-3), "softmax_crossentropy",
                config=cfg)


def _trainer(cfg, name, opt=None):
    model = _model(name)
    opt = opt or Adam(1e-3)
    trainer = Trainer(model, opt, "softmax_crossentropy", config=cfg)
    ts = create_train_state(model, opt, torch.Generator().manual_seed(0),
                            device="cpu")
    return trainer, ts


def test_trainer_skip_step_policy_survives_injected_nan():
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-3,
                         snapshot_dir=None, nonfinite_policy="skip_step",
                         progress_interval=0, stall_timeout_s=60.0)
    trainer, ts = _trainer(cfg, "guarded")
    reg = get_registry()
    before = reg.counter("train_skipped_steps_total").value
    with FaultPlan().arm("train.nonfinite_input", at=2, times=1):
        with pytest.warns(UserWarning, match="skipped"):
            ts = trainer.fit(ts, _loader(), epochs=1)
    assert reg.counter("train_skipped_steps_total").value == before + 1
    assert trainer.guard.total_skipped == 1 and ts.step == 3
    assert np.isfinite(trainer.history[-1]["train_loss"])
    for t in [*trainer.model.parameters(), *trainer.model.buffers()]:
        assert torch.isfinite(t).all()
    assert trainer.watchdog is None          # stopped at the end of fit


def test_trainer_raise_policy_aborts_naming_step():
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-3,
                         snapshot_dir=None, nonfinite_policy="raise",
                         progress_interval=0)
    trainer, ts = _trainer(cfg, "raising")
    with FaultPlan().arm("train.nonfinite_input", at=1, times=1):
        with pytest.raises(NonFiniteError, match="step 2"):
            trainer.fit(ts, _loader(), epochs=1)


def test_trainer_rollback_policy_restores_checkpoint(tmp_path):
    """4 steps an epoch; epoch 1 commits ckpt-00000001, then steps 5 and 6
    are poisoned: the second pushes the guard past rollback_after=2 and
    the trainer restores epoch 1's checkpoint into the model."""
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-3,
                         snapshot_dir=None, nonfinite_policy="rollback",
                         rollback_after=2, checkpoint_dir=str(tmp_path),
                         checkpoint_every=1, checkpoint_async=False,
                         progress_interval=0)
    trainer, ts = _trainer(cfg, "rollback")
    reg = get_registry()
    before = reg.counter("train_rollbacks_total").value
    restored = []
    real = trainer._restore
    trainer._restore = lambda t: restored.append(_copy(trainer.model, t)) or \
        real(t)
    with FaultPlan().arm("train.nonfinite_input", at=4, times=2):
        with pytest.warns(UserWarning, match="skipped"):
            ts = trainer.fit(ts, _loader(), epochs=2)
    assert reg.counter("train_rollbacks_total").value == before + 1
    assert trainer.guard.total_skipped == 2 and len(restored) == 1
    # after the rollback the run went on from epoch 1's state: step count
    # 4 (restored) + 2 (steps 7, 8)
    assert ts.step == 6
    for t in trainer.model.parameters():
        assert torch.isfinite(t).all()


# -- resume -----------------------------------------------------------------

def _run(name, d, epochs, resume="never", plan=None, **kw):
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-2,
                         lr_decay_factor=0.5, snapshot_dir=None,
                         checkpoint_dir=d, checkpoint_every=1, resume=resume,
                         progress_interval=0, seed=5, **kw)
    tr, ts = _trainer(cfg, name, SGD(1e-2, momentum=0.9))
    if plan is not None:
        with plan:
            ts = tr.fit(ts, _loader(64, seed=2), epochs=epochs)
    else:
        ts = tr.fit(ts, _loader(64, seed=2), epochs=epochs)
    return tr, ts


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_resume_auto_restores_lr_history_and_epoch(tmp_path, asynchronous):
    """Killed mid-epoch 2 (8 steps an epoch; the trip point armed as a
    crash at invocation 13, epoch 2's sixth step), then resumed: per-epoch
    train loss float-equal, lr decay continued, params and optimizer state
    bit-identical to the uninterrupted run; resuming a finished run trains
    nothing."""
    ref_dir, crash_dir = str(tmp_path / "ref"), str(tmp_path / "crash")
    kw = {"checkpoint_async": asynchronous}
    ref_tr, ref_ts = _run("rs_ref", ref_dir, 4, **kw)
    plan = FaultPlan().arm("train.nonfinite_input", at=13, exc=InjectedCrash)
    with pytest.raises(InjectedCrash):
        _run("rs_kill", crash_dir, 4, plan=plan, **kw)
    res_tr, res_ts = _run("rs_res", crash_dir, 4, resume="auto", **kw)
    assert len(res_tr.history) == len(ref_tr.history) == 4
    for hr, hc in zip(ref_tr.history, res_tr.history):
        assert hr["train_loss"] == hc["train_loss"]
        assert hr["lr"] == hc["lr"]
    _same(_copy(ref_tr.model, ref_ts), _copy(res_tr.model, res_ts))
    assert res_ts.step == ref_ts.step == 32
    res2, _ = _run("rs_noop", crash_dir, 4, resume="auto", **kw)
    assert [h["epoch"] for h in res2.history] == [1, 2, 3, 4]


def _jax_model(name):
    return (JaxBuilder(name).input((1, 8, 8))
            .conv2d(2, 3, 1, 1).batchnorm().activation("relu")
            .flatten().dense(4).build())


def _jax_run(d, epochs):
    cfg = JaxConfig(learning_rate=1e-2, lr_decay_factor=0.5,
                    snapshot_dir=None, checkpoint_dir=d, checkpoint_every=1,
                    checkpoint_async=False, progress_interval=0, seed=5)
    model, opt = _jax_model("xp"), JaxSGD(1e-2, momentum=0.9)
    tr = jax_trainer.Trainer(model, opt, "softmax_crossentropy", config=cfg)
    ts = jax_trainer.create_train_state(model, opt, jax.random.PRNGKey(5))
    ld = JaxSynthetic(64, (1, 8, 8), 4, batch_size=8, seed=2)
    ld.load_data()
    return tr, tr.fit(ts, ld, epochs=epochs)


def test_port_resumes_jax_checkpoints_and_tracks_jax(tmp_path):
    """The JAX package trains 2 epochs with checkpoint_dir; the port
    resumes from that directory and trains 2 more. Against JAX's
    uninterrupted 4 epochs: the restored history and lr as JAX wrote them,
    epochs 3-4's train loss and the final params within 1e-5 relative."""
    ref_tr, ref_ts = _jax_run(str(tmp_path / "ref"), 4)
    _jax_run(str(tmp_path / "half"), 2)
    cfg = TrainingConfig(device_type="cpu", learning_rate=1e-2,
                         lr_decay_factor=0.5, snapshot_dir=None,
                         checkpoint_dir=str(tmp_path / "half"),
                         checkpoint_every=1, resume="auto",
                         progress_interval=0, seed=5)
    tr, ts = _trainer(cfg, "xp", SGD(1e-2, momentum=0.9))
    ts = tr.fit(ts, _loader(64, seed=2), epochs=4)
    assert [h["epoch"] for h in tr.history] == [1, 2, 3, 4]
    def timeless(h):
        return [{k: v for k, v in e.items() if k != "seconds"} for e in h]

    assert timeless(tr.history[:2]) == timeless(ref_tr.history[:2])
    for hr, hc in zip(ref_tr.history[2:], tr.history[2:]):
        assert hr["lr"] == hc["lr"]
        assert abs(hr["train_loss"] - hc["train_loss"]) <= 1e-5 * abs(
            hr["train_loss"])
    got = jax.tree_util.tree_leaves(to_jax(tr.model))
    want = jax.tree_util.tree_leaves(ref_ts.params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    assert ts.step == 32
