"""Continuous-batching greedy decode over a paged KV cache (counterpart of
``dcnn_tpu/serve/decode.py``).

- :class:`DecodeEngine`: one fixed-shape decode step (embed -> per layer:
  scatter this token's K/V into its page, gather each row's pages, causal
  attend -> relu residual -> head -> greedy argmax) at every point of a
  (batch bucket x page bucket) lattice, each warmed at construction with
  every row inactive, so that only the null page is written;
- :class:`~dcnn_tpu_torch.serve.kvcache.KVPagePool`: paged K/V memory with
  a free list, so the number of slots is bounded by the working set, not
  the longest possible sequence;
- :class:`ContinuousBatcher`: the scheduler. It admits pending sequences
  into free slots at step boundaries, retires each sequence the step it
  completes, and on page exhaustion preempts the sequence admitted last
  back to the queue, which recomputes it on readmission. Bounded intake
  (``QueueFullError``), typed refusal while draining, an accepted-futures
  ledger that leaves no future unresolved, a sleep-free ``start=False``
  mode, and the ``decode.step`` / ``decode.admit`` trip points
  (``resilience/faults.py``).

On CUDA a lattice point is a CUDA graph of the step at that shape
(:mod:`~dcnn_tpu_torch.core.graphs`; its static inputs the tokens,
positions and page table, the pools written in place at fixed addresses),
captured at construction after one eager idle step, all in one memory
pool, the counterpart of the JAX engine's compiled executables; on the CPU
it is the plain step. The step writes the pool in place (the JAX step
returns new pools), so a graph is bound to the engine's pool: another pool
(:func:`decode_reference`'s private one) runs the plain step, the
reference the graphs are held to. A graph computes in the precision mode
of its capture, so sessions are keyed by (batch, pages, mode), another
mode's captured at its first use after one eager idle step.

Determinism: a row's tokens depend only on its own token, position, page
table and pages; padding rows ride the null page and are masked to exact
zeros. Per-row float logits are not bit-stable across batch or page
buckets (a GEMM may sum in another order at another shape, on the CPU and
on the card alike, as in JAX), so the contract is on tokens: every
sequence's greedy tokens equal :func:`decode_reference` and the
full-forward oracle under any interleaving, unless a near-tie of two
logits flips.

Spans (the JAX package's names, tracks and attributes): per lattice
point a ``serve.compile`` span over the first, FLOP-counted step (its
FLOPs in ``compile_stats``) and a ``serve.warmup`` span over a warm one,
at construction; a ``decode.step`` span (track ``decode``) per batcher
step, which ends once its tokens are on the host. The compile counters and
the card's memory gauges go on ``registry`` (the process-global one by
default). ``aot_cache=`` (None follows ``AOT_CACHE``, False is off, a
directory) restores the kernel libraries from the AOT cache
(:mod:`~dcnn_tpu_torch.aot`) and commits fresh builds to it; that is all it
holds here. The JAX engine caches its compiled decode step, which the port
does not have: the lattice's CUDA graphs cannot be serialized and are
captured again in every process.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..aot import warm as aot_warm
from ..core.graphs import GraphPool, Session
from ..core.precision import cast_to_compute, get_precision_mode
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..obs.xla import jit_cost, record_compile, sample_hbm
from ..ops import _kernels
from ..resilience import faults
from ..resilience.faults import InjectedCrash
from .batcher import DrainingError, QueueFullError, ShutdownError
from .engine import _sync, serve_buckets
from .kvcache import KVPagePool, OutOfPagesError, suggest_num_pages
from .metrics import DecodeMetrics


class DecodeEngine:
    """Bucketed, warmed, paged decode steps over one
    :class:`~dcnn_tpu_torch.models.decoder.MHADecoder`, on the model's
    device.

    Batch buckets are :func:`~dcnn_tpu_torch.serve.engine.serve_buckets`
    of ``max_slots``, page buckets the same ladder over
    ``max_pages_per_seq`` (a context grows through wider page tables).
    ``num_pages=None`` sizes the pool from the card's free memory
    (:func:`~dcnn_tpu_torch.serve.kvcache.suggest_num_pages`), and never
    below every slot at full context plus the null page, which is also the
    CPU's size."""

    def __init__(self, model, *, max_slots: int = 4, page_size: int = 8,
                 max_pages_per_seq: int = 4, num_pages: Optional[int] = None,
                 warmup: bool = True, name: str = "decode",
                 aot_cache: Any = None, registry=None):
        self.model = model.eval()
        self.name = name
        self.registry = registry if registry is not None else get_registry()
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            # the kernel libraries from the AOT cache (None follows
            # AOT_CACHE, False is off), before the first eager step
            cache = aot_warm.resolve(aot_cache, registry=self.registry)
            if cache is not None:
                _kernels.build(cache=cache)
        self.bucket_sizes = serve_buckets(max_slots)
        self.max_slots = self.bucket_sizes[-1]
        self.page_buckets = serve_buckets(max_pages_per_seq)
        self.max_pages_per_seq = self.page_buckets[-1]
        self.page_size = int(page_size)
        self.max_context = self.max_pages_per_seq * self.page_size
        if self.max_context > model.max_seq_len:
            raise ValueError(
                f"max context {self.max_context} "
                f"({self.max_pages_per_seq} pages x {self.page_size}) "
                f"exceeds model max_seq_len {model.max_seq_len}")
        # the pool holds K/V in the compute dtype of construction time
        dtype = cast_to_compute(model.embed).dtype
        if num_pages is None:
            floor = 1 + self.max_slots * self.max_pages_per_seq
            probe = KVPagePool(num_layers=model.num_layers,
                               embed_dim=model.embed_dim,
                               page_size=self.page_size, num_pages=2,
                               dtype=dtype, device="cpu")
            num_pages = max(floor, suggest_num_pages(
                probe.page_bytes, default=floor, device=self.device))
        self.pool = KVPagePool(num_layers=model.num_layers,
                               embed_dim=model.embed_dim,
                               page_size=self.page_size, num_pages=num_pages,
                               dtype=dtype, device=self.device)
        # steps of :meth:`step` per lattice point (the batcher's dispatches)
        self.step_counts: Dict[Tuple[int, int], int] = {}
        self.compile_stats: Dict[Tuple[int, int], Dict[str, float]] = {}
        self.graphs = GraphPool(self.device)
        # {(b, mp, precision mode): session} over the engine's pool
        self.sessions: Dict[Tuple[int, int, str], Session] = {}
        tracer = get_tracer()
        # largest first: the smaller points' graphs fit in what it freed
        for b in reversed(self.bucket_sizes):
            for mp in reversed(self.page_buckets):
                t0 = time.perf_counter()
                cost = None
                with tracer.span("serve.compile", track="serve",
                                 engine=name, bucket=b, pages=mp):
                    if warmup:  # the first, eager, FLOP-counted call
                        cost = jit_cost(self._idle_step, b, mp)
                compile_s = time.perf_counter() - t0
                record_compile(compile_s, what="decode",
                               registry=self.registry)
                capture_s = 0.0
                t0 = time.perf_counter()
                if warmup:
                    s = self._capture(b, mp)
                    capture_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    with tracer.span("serve.warmup", track="serve",
                                     engine=name, bucket=b, pages=mp):
                        s(*self._idle_inputs(b, mp))
                        _sync(self.device)
                st = {"compile_s": round(compile_s, 4),
                      "capture_s": round(capture_s, 4),
                      "warmup_s": time.perf_counter() - t0}
                if cost is not None:
                    st["flops"] = cost["flops"]
                self.compile_stats[(b, mp)] = st
        # the post-construction memory watermark (pool and workspaces)
        sample_hbm(self.registry)

    def _idle_inputs(self, b: int, mp: int):
        """Tokens, positions and page table of a step at lattice point (b,
        mp) with every row inactive: its writes touch only the null
        page."""
        return (torch.zeros(b, dtype=torch.long, device=self.device),
                torch.full((b,), -1, dtype=torch.long, device=self.device),
                torch.zeros((b, mp), dtype=torch.long, device=self.device))

    def _idle_step(self, b: int, mp: int):
        """The idle step on the engine's pool."""
        return self._step(*self._idle_inputs(b, mp), self.pool.k,
                          self.pool.v)

    def _capture(self, b: int, mp: int) -> Session:
        mode = get_precision_mode()
        pool_k, pool_v = self.pool.k, self.pool.v
        s = self.sessions[(b, mp, mode)] = Session(
            f"{self.name} step {b}x{mp} ({mode})",
            lambda t, p, pt: self._step(t, p, pt, pool_k, pool_v),
            self._idle_inputs(b, mp), pool=self.graphs)
        return s

    def _session(self, b: int, mp: int) -> Session:
        """The session of lattice point (b, mp) in the current precision
        mode; where there is none yet (no warm-up at construction, or
        another mode), an eager idle step and the capture."""
        with self.graphs.lock:
            s = self.sessions.get((b, mp, get_precision_mode()))
            if s is None:
                self._idle_step(b, mp)
                s = self._capture(b, mp)
            return s

    # -- the step --
    def _step(self, tokens: torch.Tensor, positions: torch.Tensor,
              page_table: torch.Tensor, pool_k: torch.Tensor,
              pool_v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step on device tensors (``tokens``, ``positions``
        (b,) and ``page_table`` (b, mp), all int64), writing ``pool_k`` and
        ``pool_v`` in place. Returns (next tokens int32, logits)."""
        model, ps = self.model, self.page_size
        b, mp = page_table.shape
        with torch.no_grad():
            x = model.embed_tokens(tokens)
            active = positions >= 0
            pos_c = torch.clamp_min(positions, 0)
            pg, slot = pos_c // ps, pos_c % ps
            rows = torch.arange(b, device=tokens.device)
            # inactive rows write onto the null page, which nothing reads
            phys = torch.where(active, page_table[rows, pg], 0)
            for li, blk in enumerate(model.blocks):
                q, k_t, v_t = blk.decode_qkv(x)
                pool_k[li].index_put_((phys, slot), k_t)
                pool_v[li].index_put_((phys, slot), v_t)
                # each row's pages as one (b, mp * page_size, E) context;
                # table padding gathers the null page, masked to exact 0
                ctx_k = pool_k[li][page_table].reshape(b, mp * ps, -1)
                ctx_v = pool_v[li][page_table].reshape(b, mp * ps, -1)
                y = blk.decode_attend(q, ctx_k, ctx_v, positions)
                x = torch.relu(y + x)
            logits = model.head(x)
            return torch.argmax(logits, dim=-1).to(torch.int32), logits

    # -- bucket math --
    def bucket_for(self, n: int) -> int:
        """Smallest batch bucket >= n active slots."""
        if not 1 <= n <= self.max_slots:
            raise ValueError(f"active count {n} outside [1, "
                             f"{self.max_slots}]")
        return next(b for b in self.bucket_sizes if b >= n)

    def page_bucket_for(self, pages: int) -> int:
        """Smallest page-table width >= pages (at least 1: an empty table
        dispatches at width 1, all null page)."""
        pages = max(pages, 1)
        if pages > self.max_pages_per_seq:
            raise ValueError(f"{pages} pages exceeds max_pages_per_seq "
                             f"{self.max_pages_per_seq}")
        return next(mp for mp in self.page_buckets if mp >= pages)

    # -- dispatch --
    def run_step(self, tokens, positions, page_table, pool_k: torch.Tensor,
                 pool_v: torch.Tensor):
        """One step at a lattice point: ``tokens`` and ``positions`` (b,),
        ``page_table`` (b, mp) (arrays or tensors) must be exact buckets.
        Writes ``pool_k``/``pool_v`` in place and returns
        ``(next_tokens, logits, pool_k, pool_v)`` on the device. The
        engine's own pool (:meth:`step`'s) replays the lattice point's
        graph on CUDA; any other (:func:`decode_reference`'s private one)
        runs the plain step."""
        b = np.shape(tokens)[0]
        key = (b, np.shape(page_table)[1])
        if key not in self.compile_stats:
            raise ValueError(f"no lattice point (batch, pages)={key}; have "
                             f"{sorted(self.compile_stats)}")
        if np.shape(positions) != (b,) or np.shape(page_table)[0] != b:
            raise ValueError(f"tokens {np.shape(tokens)}, positions "
                             f"{np.shape(positions)} and page table "
                             f"{np.shape(page_table)} disagree on the batch")

        def dev(a):
            t = (a if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.asarray(a)))
            return t.to(self.device, torch.long)

        args = (dev(tokens), dev(positions), dev(page_table))
        if self.graphs.cuda and pool_k is self.pool.k \
                and pool_v is self.pool.v:
            nxt, logits = self._session(*key)(*args)
        else:
            nxt, logits = self._step(*args, pool_k, pool_v)
        return nxt, logits, pool_k, pool_v

    def step(self, tokens, positions, page_table):
        """One step against the engine's own pool. Returns
        ``(next_tokens, logits)``: the tokens as an int32 numpy array (the
        step's one read back to the host), the logits on the device."""
        nxt, logits, _, _ = self.run_step(tokens, positions, page_table,
                                          self.pool.k, self.pool.v)
        # the pool's one writer (the step loop) is this counter's too
        key = (len(tokens), np.shape(page_table)[1])
        self.step_counts[key] = self.step_counts.get(key, 0) + 1
        return nxt.cpu().numpy(), logits

    def __repr__(self) -> str:
        return (f"DecodeEngine({self.name!r}, slots={self.bucket_sizes}, "
                f"page_buckets={self.page_buckets}, "
                f"page_size={self.page_size}, "
                f"pool_pages={self.pool.num_pages}, device={self.device})")


def decode_reference(engine: DecodeEngine, prompt: Sequence[int], *,
                     max_new_tokens: int = 16,
                     eos_id: Optional[int] = None) -> np.ndarray:
    """Batch-of-one greedy decode of ``prompt`` through the engine's plain
    step, never a graph (batch bucket 1, the page bucket of the sequence's
    own length) on a private zeroed pool; the engine's pool and allocator
    are untouched.
    The per-sequence oracle the continuous batcher is held to."""
    prompt = [int(t) for t in prompt]
    if not prompt:
        raise ValueError("empty prompt")
    if len(prompt) + max_new_tokens > engine.max_context:
        raise ValueError(f"prompt {len(prompt)} + max_new {max_new_tokens} "
                         f"exceeds max context {engine.max_context}")
    pool_k = torch.zeros_like(engine.pool.k)
    pool_v = torch.zeros_like(engine.pool.v)
    ps = engine.page_size
    tokens = list(prompt)
    generated: List[int] = []
    pos = 0
    while True:
        npages = -(-(pos + 1) // ps)
        table = np.zeros((1, engine.page_bucket_for(npages)), np.int32)
        table[0, :npages] = np.arange(1, npages + 1)
        nxt, _, pool_k, pool_v = engine.run_step(
            np.asarray([tokens[pos]], np.int32),
            np.asarray([pos], np.int32), table, pool_k, pool_v)
        emit = pos == len(tokens) - 1
        pos += 1
        if emit:
            tok = int(nxt[0])
            tokens.append(tok)
            generated.append(tok)
            if len(generated) >= max_new_tokens or tok == eos_id:
                return np.asarray(generated, np.int32)


class _Seq:
    """One accepted decode request and its slot-resident state."""

    __slots__ = ("seq_id", "tokens", "prompt_len", "max_new_tokens",
                 "eos_id", "future", "t_submit", "first_emit",
                 "generated", "pos")

    def __init__(self, seq_id, prompt, max_new_tokens, eos_id, future,
                 t_submit):
        self.seq_id = seq_id
        self.tokens: List[int] = list(prompt)
        self.prompt_len = len(prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.future = future
        self.t_submit = t_submit
        self.first_emit = False
        self.generated: List[int] = []
        self.pos = 0  # tokens consumed; a step emits iff pos == len(tokens)-1


class ContinuousBatcher:
    """Iteration-level scheduler over a :class:`DecodeEngine`.

    Each :meth:`step` (one engine dispatch): admit pending sequences into
    free slots (trip point ``decode.admit``), extend page allocations
    (preempting the sequence admitted last on ``OutOfPagesError``; it goes
    back to the front of the queue and recomputes), dispatch at the
    smallest (batch, page) lattice point covering the active set (trip
    point ``decode.step``), read the new tokens back once, retire the
    sequences that completed.

    Every accepted future is resolved: with its tokens, with
    ``ShutdownError`` on teardown, or with the step's exception. A crash
    mid-step fails every pending and active sequence before it propagates.
    ``start=False`` runs no thread: the caller drives :meth:`step`, with an
    injected ``clock``, sleep-free."""

    def __init__(self, engine: DecodeEngine, *,
                 max_slots: Optional[int] = None,
                 queue_capacity: int = 64,
                 metrics: Optional[DecodeMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, "
                             f"got {queue_capacity}")
        self.engine = engine
        self.max_slots = min(max_slots or engine.max_slots,
                             engine.max_slots)
        self.queue_capacity = queue_capacity
        self.metrics = metrics if metrics is not None else DecodeMetrics(
            clock=clock)
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._active: List[_Seq] = []
        self._accepted: set = set()  # every accepted, unresolved future
        self._closing = False
        self._steps = 0
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"dcnn-decode-batcher-{engine.name}")
            self._thread.start()

    # -- intake --
    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Future:
        """Enqueue one greedy-decode request; the future resolves to the
        generated token ids as an int32 array (the EOS token included when
        it fired). Raises ``QueueFullError`` at capacity and
        ``DrainingError`` after :meth:`drain` or :meth:`shutdown`."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        vocab = self.engine.model.vocab_size
        if any(not 0 <= t < vocab for t in prompt):
            raise ValueError(f"prompt tokens outside [0, {vocab})")
        if len(prompt) + max_new_tokens > self.engine.max_context:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds engine max context {self.engine.max_context}")
        fut: Future = Future()
        with self._cond:
            if self._closing:
                raise DrainingError(
                    "decode batcher is draining or shut down")
            if len(self._pending) >= self.queue_capacity:
                self.metrics.record_shed()
                raise QueueFullError(
                    f"decode queue at capacity ({len(self._pending)}/"
                    f"{self.queue_capacity} sequences)")
            seq = _Seq(self._next_id, prompt, max_new_tokens, eos_id, fut,
                       self._clock())
            self._next_id += 1
            self._pending.append(seq)
            self._accepted.add(fut)
            self.metrics.record_submit()
            self.metrics.record_queue_depth(len(self._pending))
            self._cond.notify_all()
        return fut

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def active_slots(self) -> int:
        with self._cond:
            return len(self._active)

    def health_reason(self) -> Optional[str]:
        """None while accepting traffic, else why not."""
        with self._cond:
            closing = self._closing
        if closing:
            return "draining or shut down: not accepting sequences"
        if self._thread is not None and not self._thread.is_alive():
            return "decode scheduler thread dead"
        return None

    # -- scheduling core --
    def _admit(self) -> None:
        """Move pending sequences into free slots, at a step boundary. An
        ``InjectedFault`` at ``decode.admit`` fails just that sequence; a
        crash propagates to :meth:`step`'s handler."""
        with self._cond:
            while self._pending and len(self._active) < self.max_slots:
                seq = self._pending[0]
                try:
                    faults.trip("decode.admit", seq=seq.seq_id)
                except InjectedCrash:
                    raise
                except Exception as e:
                    self._pending.popleft()
                    self._accepted.discard(seq.future)
                    try:
                        seq.future.set_exception(e)
                    except InvalidStateError:
                        pass
                    continue
                try:
                    self.engine.pool.ensure(seq.seq_id, 1)
                except OutOfPagesError:
                    break  # no room for even one page: admit next step
                self._pending.popleft()
                self._active.append(seq)
                self.metrics.record_admit()
            self.metrics.record_queue_depth(len(self._pending))

    def _preempt_last(self) -> bool:
        """Release the most recently admitted active sequence's pages and
        put it back at the front of the queue (it replays its prompt and
        the tokens it generated). False when nothing is active."""
        with self._cond:
            if not self._active:
                return False
            victim = self._active.pop()
            self.engine.pool.release(victim.seq_id)
            victim.pos = 0
            self._pending.appendleft(victim)
            self.metrics.record_evict()
            self.metrics.record_queue_depth(len(self._pending))
        return True

    def _fail_all(self, exc: BaseException) -> int:
        """Fail every accepted, unresolved future with ``exc`` and release
        every page. Returns how many futures this call failed."""
        with self._cond:
            seqs = list(self._active) + list(self._pending)
            self._active.clear()
            self._pending.clear()
            pending = set(self._accepted)
            self._accepted.clear()
            self.metrics.record_queue_depth(0)
        for s in seqs:
            self.engine.pool.release(s.seq_id)
        failed = 0
        for fut in pending:
            try:
                fut.set_exception(exc if isinstance(exc, Exception)
                                  else ShutdownError(str(exc)))
                failed += 1
            except InvalidStateError:
                pass
        return failed

    def step(self) -> int:
        """One scheduler iteration: admit, allocate, dispatch one engine
        step, retire completions. Returns the number of sequences stepped
        (0 = nothing to do). A dispatch exception, an injected crash
        included, fails every accepted sequence and then propagates."""
        self._admit()
        with self._cond:
            active = list(self._active)
        if not active:
            return 0
        try:
            # pages for this step's positions, preempting the newest
            # sequence (perhaps the grower itself) until they fit
            i = 0
            while i < len(active):
                try:
                    self.engine.pool.ensure(active[i].seq_id,
                                            active[i].pos + 1)
                    i += 1
                except OutOfPagesError:
                    if not self._preempt_last():
                        raise
                    with self._cond:
                        active = [s for s in active if s in self._active]
                    i = min(i, len(active))
            if not active:
                return 0
            b = self.engine.bucket_for(len(active))
            mp = self.engine.page_bucket_for(max(
                self.engine.pool.num_seq_pages(s.seq_id) for s in active))
            tokens = np.zeros(b, np.int32)
            positions = np.full(b, -1, np.int32)
            table = np.zeros((b, mp), np.int32)
            for i, seq in enumerate(active):
                tokens[i] = seq.tokens[seq.pos]
                positions[i] = seq.pos
                table[i] = self.engine.pool.table(seq.seq_id, mp)
            faults.trip("decode.step", step=self._steps)
            with get_tracer().span("decode.step", track="decode",
                                   active=len(active), bucket=b, pages=mp):
                nxt, _ = self.engine.step(tokens, positions, table)
        except BaseException as e:
            with self._cond:
                self._closing = True
            self._fail_all(e)
            raise
        self._steps += 1
        now = self._clock()
        done: List[_Seq] = []
        for i, seq in enumerate(active):
            emit = seq.pos == len(seq.tokens) - 1
            seq.pos += 1
            if not emit:
                # prefill, or a replay after preemption: K/V written, the
                # output already known
                self.metrics.record_prefill()
                continue
            tok = int(nxt[i])
            seq.tokens.append(tok)
            seq.generated.append(tok)
            self.metrics.record_token()
            if not seq.first_emit:
                seq.first_emit = True
                self.metrics.record_ttft(max(now - seq.t_submit, 0.0))
            if (len(seq.generated) >= seq.max_new_tokens
                    or tok == seq.eos_id):
                done.append(seq)
        for seq in done:
            self.engine.pool.release(seq.seq_id)
            with self._cond:
                if seq in self._active:
                    self._active.remove(seq)
                self._accepted.discard(seq.future)
            try:
                seq.future.set_result(np.asarray(seq.generated, np.int32))
            except InvalidStateError:
                pass  # failed by a timed-out drain racing this step
            self.metrics.record_complete()
        self.metrics.record_step(len(active), self.max_slots)
        self.metrics.record_pages(self.engine.pool.pages_in_use)
        return len(active)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._pending and not self._active
                       and not self._closing):
                    self._cond.wait()
                if self._closing and not self._pending and not self._active:
                    return
            try:
                self.step()
            except Exception:
                # step() failed every accepted future already; a dead
                # scheduler thread shows in health_reason
                return

    # -- teardown --
    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop intake and decode everything accepted to completion. If
        ``timeout`` trips, the unfinished futures fail with
        ``ShutdownError`` and ``TimeoutError`` raises."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                n = self._fail_all(ShutdownError(
                    f"decode drain timed out after {timeout}s"))
                raise TimeoutError(
                    f"decode drain did not finish in {timeout}s "
                    f"({n} pending sequence(s) failed with ShutdownError)")
            self._thread = None
        else:
            while self.step():
                pass

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """``drain=True``: :meth:`drain`. ``drain=False``: fail every
        accepted, unfinished sequence with ``ShutdownError``."""
        if drain:
            self.drain(timeout)
            return
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._fail_all(ShutdownError("decode batcher shut down without "
                                     "drain"))

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    def __repr__(self) -> str:
        return (f"ContinuousBatcher(engine={self.engine.name!r}, "
                f"max_slots={self.max_slots}, "
                f"capacity={self.queue_capacity})")
