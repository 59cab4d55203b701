"""The port's continuous-batching decode (``dcnn_tpu_torch/serve/decode.py``,
``serve/kvcache.py``, ``models/decoder.py`` and the attention layer's
decode methods), held against the JAX package: the twins of
``tests/test_decode.py`` on the CPU, with its fixture (V=13, E=16, 2 heads,
2 layers, 4 slots x 4 pages of 4, and a starved twin with 8 pages), the
weights carried from the JAX decoder by ``interop.decoder_from_jax``.

Contracts: the paged reference and the dense decode path give the
full-forward oracle's greedy tokens; inactive rows are exact zeros; the
continuous batcher gives every sequence the reference's tokens under any
interleaving and under preemption; and the tokens equal the JAX
``DecodeEngine``'s for the same weights and prompts. Float logits are not
compared bit for bit across buckets (a GEMM may sum in another order at
another shape, in either package); the full forward's logits are held to
JAX's at 1e-5.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.models import MHADecoder as JaxDecoder
from dcnn_tpu.obs.registry import MetricsRegistry as JaxRegistry
from dcnn_tpu.serve import DecodeEngine as JaxDecodeEngine
from dcnn_tpu.serve import decode_reference as jax_decode_reference
from dcnn_tpu_torch.interop import decoder_from_jax, decoder_to_jax
from dcnn_tpu_torch.models import MHADecoder, create_model
from dcnn_tpu_torch.resilience import FaultPlan
from dcnn_tpu_torch.resilience.faults import InjectedCrash, InjectedFault
from dcnn_tpu_torch.serve import (
    ContinuousBatcher, DecodeEngine, DecodeMetrics, DrainingError,
    KVPagePool, OutOfPagesError, QueueFullError, ShutdownError,
    decode_reference, suggest_num_pages,
)

PROMPTS = [[1, 5, 2], [3, 3], [7, 1, 2, 4], [2], [9, 8, 7, 1, 2], [4, 6]]
LOGIT_TOL = 1e-5  # fp32, the same products summed in another order


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def jax_pair():
    jm = JaxDecoder(vocab_size=13, embed_dim=16, num_heads=2, num_layers=2,
                    max_seq_len=32)
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(jax_pair):
    jm, jp = jax_pair
    return decoder_from_jax(jm.get_config(),
                            jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    return DecodeEngine(model, max_slots=4, page_size=4, max_pages_per_seq=4)


@pytest.fixture(scope="module")
def starved_engine(model):
    """4 slots that cannot all hold full-length sequences (7 usable pages
    for up to 16 demanded): forces preempt-and-recompute."""
    return DecodeEngine(model, max_slots=4, page_size=4, max_pages_per_seq=4,
                        num_pages=8, warmup=False)


def greedy_oracle(model, prompt, max_new):
    """Greedy decode through the full causal forward."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(max_new):
            logits = model(torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
    return np.asarray(toks[len(prompt):], np.int32)


# ------------------------------------------------------------ model

def test_decoder_interop_and_full_forward_match_jax(jax_pair, model):
    jm, jp = jax_pair
    back = decoder_to_jax(model)
    for k in ("embed", "head_w", "head_b"):
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))
    for bp, jbp in zip(back["blocks"], jp["blocks"]):
        assert set(bp) == set(jbp)
        for k in bp:
            np.testing.assert_array_equal(bp[k], np.asarray(jbp[k]))
    toks = np.random.default_rng(0).integers(0, 13, (3, 9)).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert MHADecoder.from_config(model.get_config()).get_config() == \
        jm.get_config()


def test_zoo_decoder_is_the_jax_default():
    m = create_model("mha_decoder")
    assert isinstance(m, MHADecoder)
    assert m.get_config() == JaxDecoder().get_config()


# ------------------------------------------------------------ oracle

def test_reference_matches_full_forward_oracle(model, engine):
    for prompt in PROMPTS[:3]:
        want = greedy_oracle(model, prompt, 6)
        got = decode_reference(engine, prompt, max_new_tokens=6)
        assert np.array_equal(got, want), (prompt, got, want)


def test_decode_dense_matches_oracle(model):
    prompt = [1, 5, 2, 9]
    t, e = 16, model.embed_dim
    k = [torch.zeros(1, t, e) for _ in range(model.num_layers)]
    v = [torch.zeros(1, t, e) for _ in range(model.num_layers)]
    toks, generated = list(prompt), []
    with torch.no_grad():
        for pos in range(len(prompt) + 5 - 1):
            x_t = model.embed_tokens(torch.tensor([toks[pos]]))
            logits, k, v = model.decode_dense(x_t, k, v, torch.tensor([pos]))
            if pos == len(toks) - 1:
                nxt = int(torch.argmax(logits[0]))
                toks.append(nxt)
                generated.append(nxt)
    assert np.array_equal(np.asarray(generated, np.int32),
                          greedy_oracle(model, prompt, 5))


def test_decode_attend_matches_jax(jax_pair, model):
    """One attention layer's decode_attend against JAX's on the same q and
    context, live rows and inactive rows (position -1)."""
    jm, jp = jax_pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    ctx = rng.normal(size=(3, 8, 16)).astype(np.float32)
    pos = np.asarray([5, -1, 0], np.int32)
    jblk, jbp = jm.blocks[0], jp["blocks"][0]
    jq, _, _ = jblk.decode_qkv(jbp, jnp.asarray(x))
    want = np.asarray(jblk.decode_attend(jbp, jq, jnp.asarray(ctx),
                                         jnp.asarray(ctx), jnp.asarray(pos)))
    with torch.no_grad():
        q, _, _ = model.blocks[0].decode_qkv(torch.from_numpy(x))
        got = model.blocks[0].decode_attend(
            q, torch.from_numpy(ctx), torch.from_numpy(ctx),
            torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_inactive_rows_fully_masked(model):
    """Position -1 marks an inactive row: its attention is exactly zero, so
    only the out projection's bias is left, whatever the context holds."""
    blk = model.blocks[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, model.embed_dim, generator=g)
    ctx = torch.randn(2, 8, model.embed_dim, generator=g)
    pos = torch.tensor([-1, -1])
    with torch.no_grad():
        q, _, _ = blk.decode_qkv(x)
        out = blk.decode_attend(q, ctx, ctx, pos)
        out2 = blk.decode_attend(q, ctx * 100.0, ctx * -3.0, pos)
    assert torch.equal(out, out2)
    assert torch.equal(out, blk.bo.detach().expand(2, -1))


def test_tokens_equal_jax_decode_engine(jax_pair, engine):
    """The same weights and prompts through the JAX DecodeEngine's
    reference and the port's: the same tokens."""
    jm, jp = jax_pair
    jeng = JaxDecodeEngine(jm, jp, max_slots=1, page_size=4,
                           max_pages_per_seq=4, aot_cache=False,
                           warmup=False, registry=JaxRegistry())
    for prompt in PROMPTS:
        want = jax_decode_reference(jeng, prompt, max_new_tokens=6)
        got = decode_reference(engine, prompt, max_new_tokens=6)
        assert np.array_equal(got, want), (prompt, got, want)


# ------------------------------------------------- continuous batching

def _run_continuous(engine, submit_plan, max_new=5, **kw):
    """Drive a sync-mode batcher through ``submit_plan``: (step_at,
    prompt) pairs, each prompt submitted once ``step_at`` scheduler steps
    have run. Returns {prompt index: tokens}."""
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock(), **kw)
    futs = {}
    plan = sorted(range(len(submit_plan)), key=lambda i: submit_plan[i][0])
    steps = 0
    while plan or cb.active_slots or cb.queue_depth:
        while plan and submit_plan[plan[0]][0] <= steps:
            i = plan.pop(0)
            futs[i] = cb.submit(submit_plan[i][1], max_new_tokens=max_new)
        if cb.step() == 0 and not plan:
            break
        steps += 1
    return {i: f.result(timeout=5) for i, f in futs.items()}


@pytest.mark.parametrize("plan", [
    [(0, p) for p in PROMPTS],
    [(0, PROMPTS[0]), (0, PROMPTS[1]), (2, PROMPTS[2]), (3, PROMPTS[3]),
     (5, PROMPTS[4]), (7, PROMPTS[5])],
], ids=["upfront", "staggered"])
def test_continuous_tokens_equal_reference(engine, plan):
    got = _run_continuous(engine, plan)
    for i, (_, p) in enumerate(plan):
        want = decode_reference(engine, p, max_new_tokens=5)
        assert np.array_equal(got[i], want), (i, got[i], want)


def test_preemption_recompute_same_tokens(starved_engine):
    metrics = DecodeMetrics(clock=FakeClock())
    prompts = [[1, 5, 2, 4, 6], [3, 3, 1, 1], [7, 1, 2, 4, 5, 6],
               [2, 9, 8, 4], [9, 8, 7, 1, 2]]
    got = _run_continuous(starved_engine, [(0, p) for p in prompts],
                          max_new=8, metrics=metrics)
    for i, p in enumerate(prompts):
        want = decode_reference(starved_engine, p, max_new_tokens=8)
        assert np.array_equal(got[i], want), (i, got[i], want)
    s = metrics.snapshot()
    assert s["evictions"] > 0, "the starved pool must have preempted"
    assert s["completions"] == len(prompts)


def test_eos_stops_decode(engine):
    ref = decode_reference(engine, [1, 5, 2], max_new_tokens=8)
    eos = int(ref[0])
    assert np.array_equal(decode_reference(engine, [1, 5, 2],
                                           max_new_tokens=8, eos_id=eos),
                          ref[:1])
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock())
    fut = cb.submit([1, 5, 2], max_new_tokens=8, eos_id=eos)
    while cb.step():
        pass
    assert np.array_equal(fut.result(timeout=5), ref[:1])
    assert np.array_equal(_run_continuous(engine, [(0, [1, 5, 2])],
                                          max_new=8)[0], ref)


def test_admission_stays_on_the_lattice(engine):
    """Admitting into a running batch dispatches only lattice points built
    (and warmed) at construction, batch sizes 1..4 and growing tables."""
    lattice = set(engine.compile_stats)
    engine.step_counts.clear()
    plan = [(0, PROMPTS[0]), (1, PROMPTS[1]), (2, PROMPTS[2]),
            (3, PROMPTS[3]), (4, PROMPTS[4]), (6, PROMPTS[5])]
    assert len(_run_continuous(engine, plan, max_new=7)) == len(plan)
    used = set(engine.step_counts)
    assert used <= lattice and len(used) > 2, used
    assert set(engine.compile_stats) == lattice


# ------------------------------------------------- fault injection

def test_injected_crash_mid_step_fails_all_typed(engine):
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock(),
                           max_slots=2)
    futs = [cb.submit(p, max_new_tokens=5) for p in PROMPTS[:4]]
    assert cb.step() > 0
    with FaultPlan().arm("decode.step", exc=InjectedCrash):
        with pytest.raises(InjectedCrash):
            cb.step()
    for fut in futs:  # active (2) and queued (2): all resolved, typed
        assert fut.done()
        with pytest.raises(InjectedCrash):
            fut.result(timeout=0)
    assert cb.engine.pool.pages_in_use == 0
    assert cb.health_reason() is not None
    with pytest.raises(DrainingError):
        cb.submit([1, 2], max_new_tokens=2)


def test_injected_fault_at_admit_fails_one_sequence(engine):
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock())
    with FaultPlan().arm("decode.admit", at=1, times=1):
        futs = [cb.submit(p, max_new_tokens=4) for p in PROMPTS[:3]]
        while cb.step():
            pass
    with pytest.raises(InjectedFault):
        futs[1].result(timeout=5)
    for i in (0, 2):
        want = decode_reference(engine, PROMPTS[i], max_new_tokens=4)
        assert np.array_equal(futs[i].result(timeout=5), want)


# ------------------------------------------------- intake contract

def test_submit_validation(engine):
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock())
    with pytest.raises(ValueError):
        cb.submit([], max_new_tokens=2)
    with pytest.raises(ValueError):
        cb.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError):
        cb.submit([99], max_new_tokens=2)
    with pytest.raises(ValueError):
        cb.submit([1] * 10, max_new_tokens=engine.max_context)


def test_queue_full_sheds_typed(engine):
    metrics = DecodeMetrics(clock=FakeClock())
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock(),
                           queue_capacity=2, metrics=metrics)
    cb.submit([1], max_new_tokens=2)
    cb.submit([2], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        cb.submit([3], max_new_tokens=2)
    assert metrics.snapshot()["sequences_shed"] == 1
    while cb.step():
        pass


def test_shutdown_without_drain_fails_pending(engine):
    cb = ContinuousBatcher(engine, start=False, clock=FakeClock())
    futs = [cb.submit(p, max_new_tokens=4) for p in PROMPTS[:3]]
    cb.shutdown(drain=False)
    for fut in futs:
        with pytest.raises(ShutdownError):
            fut.result(timeout=0)
    with pytest.raises(DrainingError):
        cb.submit([1], max_new_tokens=2)
    assert engine.pool.pages_in_use == 0


def test_threaded_drain_completes_everything(engine):
    cb = ContinuousBatcher(engine, queue_capacity=8)
    futs = [cb.submit(p, max_new_tokens=4) for p in PROMPTS[:4]]
    cb.drain()
    for p, fut in zip(PROMPTS, futs):
        want = decode_reference(engine, p, max_new_tokens=4)
        assert np.array_equal(fut.result(timeout=0), want)
    assert cb.health_reason() is not None
    assert not any(t.name.startswith("dcnn-decode-batcher")
                   for t in threading.enumerate())


# ------------------------------------------------- page pool

def test_page_pool_geometry_and_allocation():
    pool = KVPagePool(num_layers=2, embed_dim=8, page_size=4, num_pages=6,
                      device="cpu")
    assert pool.pages_for(0) == 0
    assert pool.pages_for(1) == 1
    assert pool.pages_for(4) == 1
    assert pool.pages_for(5) == 2
    assert pool.page_bytes == 2 * 2 * 4 * 8 * 4
    assert pool.pool_bytes == 6 * pool.page_bytes
    assert pool.k.shape == (2, 6, 4, 8) and pool.k.dtype == torch.float32
    assert pool.ensure("a", 3) == 1
    assert pool.ensure("a", 3) == 1
    assert pool.ensure("a", 9) == 3
    assert pool.pages_in_use == 3 and pool.pages_free == 2
    t = pool.table("a", 4)
    assert t.dtype == np.int32 and t.shape == (4,)
    assert 0 not in t[:3]
    assert t[3] == 0
    with pytest.raises(ValueError):
        pool.table("a", 2)


def test_page_pool_all_or_nothing_and_recycle():
    pool = KVPagePool(num_layers=1, embed_dim=4, page_size=2, num_pages=4,
                      device="cpu")
    pool.ensure("a", 4)
    with pytest.raises(OutOfPagesError):
        pool.ensure("b", 4)
    assert pool.num_seq_pages("b") == 0
    assert pool.pages_free == 1
    assert pool.release("a") == 2
    assert pool.release("a") == 0
    assert pool.ensure("b", 4) == 2
    snap = pool.snapshot()
    assert snap["pages_in_use"] == 2 and snap["sequences"] == 1


def test_suggest_num_pages_defaults_on_cpu():
    assert suggest_num_pages(1024, default=37, device="cpu") == 37
    with pytest.raises(ValueError):
        suggest_num_pages(0, device="cpu")
    with pytest.raises(ValueError):
        suggest_num_pages(1024, fraction=0.0, device="cpu")


# ------------------------------------------------- metrics

def test_decode_metrics_none_until_data():
    s = DecodeMetrics(clock=FakeClock()).snapshot()
    assert s["ttft_p50_ms"] is None and s["slot_occupancy"] is None
    assert s["tokens"] == 0 and s["completions"] == 0


def test_decode_metrics_exact_under_fake_clock():
    clk = FakeClock()
    m = DecodeMetrics(clock=clk)
    m.record_submit()
    m.record_admit()
    clk.advance(0.25)
    m.record_ttft(0.25)
    for _ in range(4):
        m.record_token()
    m.record_step(2, 4)
    m.record_step(4, 4)
    m.record_pages(6)
    clk.advance(0.75)
    s = m.snapshot()
    assert s["ttft_p50_ms"] == 250.0 and s["ttft_p99_ms"] == 250.0
    assert s["slot_occupancy"] == 0.75
    assert s["tokens_per_sec"] == 4.0
    assert s["pages_in_use"] == 6
    reg = m.registry.snapshot()
    assert reg["decode_tokens_total"] == 4
    assert reg["decode_steps_total"] == 2
    assert reg["decode_ttft_seconds"]["count"] == 1
    m.reset()
    assert m.snapshot()["tokens"] == 0
    assert m.registry.snapshot()["decode_tokens_total"] == 0


# ------------------------------------------------- engine surface

def test_engine_bucket_math(engine):
    assert engine.bucket_sizes == [1, 2, 4]
    assert engine.page_buckets == [1, 2, 4]
    assert engine.bucket_for(3) == 4
    assert engine.page_bucket_for(0) == 1
    assert engine.page_bucket_for(3) == 4
    with pytest.raises(ValueError):
        engine.bucket_for(5)
    with pytest.raises(ValueError):
        engine.page_bucket_for(5)
    with pytest.raises(ValueError, match="lattice"):
        engine.run_step(np.zeros(3, np.int32), np.zeros(3, np.int32),
                        np.zeros((3, 1), np.int32), engine.pool.k,
                        engine.pool.v)


def test_engine_rejects_context_beyond_model_and_aot(model, tmp_path):
    """A context beyond the model is refused; ``aot_cache=`` is accepted
    (it caches the kernel libraries, which the CPU does not build) and the
    engine decodes as an uncached one does."""
    with pytest.raises(ValueError):
        DecodeEngine(model, max_slots=1, page_size=32, max_pages_per_seq=2)
    cached = DecodeEngine(model, max_slots=1, aot_cache=str(tmp_path),
                          warmup=False)
    plain = DecodeEngine(model, max_slots=1, aot_cache=False, warmup=False)
    assert cached.bucket_sizes == plain.bucket_sizes
    assert not (tmp_path / "aot").exists()  # nothing was built to cache


def test_engine_warms_the_whole_lattice(model, engine):
    assert set(engine.compile_stats) == {
        (b, mp) for b in engine.bucket_sizes for mp in engine.page_buckets}
    assert all(st["warmup_s"] >= 0 for st in engine.compile_stats.values())
    assert engine.pool.num_pages == 1 + 4 * 4
    fresh = DecodeEngine(model, max_slots=2, page_size=4, max_pages_per_seq=2)
    assert set(fresh.compile_stats) == {(1, 1), (1, 2), (2, 1), (2, 2)}
    # the warm-up's inactive rows wrote the null page and nothing else
    assert fresh.pool.k[:, 0].any()
    assert not fresh.pool.k[:, 1:].any() and not fresh.pool.v[:, 1:].any()
