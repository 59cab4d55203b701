"""Bucketed inference engine (counterpart of ``dcnn_tpu/serve/engine.py``).

Three sources, as in the JAX package: a live model (:meth:`from_model`), a
checkpoint (:meth:`from_checkpoint`) and an exported program
(:meth:`from_artifact`, the bytes or file of
:func:`~dcnn_tpu_torch.nn.export.export_inference`), which serves without
the model class, the layer registry or a checkpoint.

One session per batch bucket (powers of two up to ``max_batch``), with
zero-pad-to-bucket dispatch. On CUDA a session is a CUDA graph of the
model's forward at that batch size (:mod:`~dcnn_tpu_torch.core.graphs`),
the counterpart of the JAX engine's compiled, warmed executable: built at
construction after one eager call, largest bucket first, all in one memory
pool, so the first real request pays no first-call cost (kernel build,
int8 weight packing, allocator growth, cuDNN plans) and each batch is one
graph launch. A call copies the rows into the bucket's static input,
replays and returns a copy of the logits; a lock serialises the replays of
the batcher's dispatcher and of other callers. A graph computes in the
precision mode of its capture, so sessions are keyed by (bucket, mode): a
call in another mode (``set_precision``) runs that mode's graph, captured
at its first use after one eager call, as the CPU engine computes in the
mode of the call. :meth:`InferenceEngine.warm`
replays every bucket on the calling thread (``DynamicBatcher`` calls it on
its dispatcher). On the CPU a session is the plain forward.

Padding is row-exact within a bucket: zero rows ride along and are sliced
off. Float results are allclose, not bit-identical, across buckets (a GEMM
or conv may sum in another order at another batch size). An int8 engine
(``from_model(..., int8_calib=...)``, or any model whose every conv, dense
and attention layer is an int8 twin) is ``batch_invariant``: its convs and
GEMMs are exact integer sums, and everything else a sample computes is its
own, so its logits are bit-identical at every bucket.

Construction records, per bucket, a ``serve.compile`` span over the first
call (kernel builds; its FLOPs counted by ``FlopCounterMode``,
:mod:`~dcnn_tpu_torch.obs.xla`, into ``compile_stats``), counted on
``compile_total`` / ``compile_serve_seconds_total``, then the capture
(``capture_s`` in ``compile_stats``) and a ``serve.warmup`` span over a
replay; the per-sample FLOPs gauge and the card's memory gauges go on
``registry`` (the process-global one by default). With ``warmup=False`` a
bucket is called, captured and replayed at its first use.

The AOT cache (:mod:`~dcnn_tpu_torch.aot`; ``aot_cache=``: None follows
``AOT_CACHE``, False is off, a directory or an ``ExecutableCache``) holds
two things here: the kernel libraries, restored before the first call so a
warm start runs no ``nvcc``, and, for :meth:`from_model`, the exported
program, keyed by the model's structure, weights and transform
(``aot_config``): on a hit the engine loads the program and builds, folds,
calibrates and traces nothing. The CUDA graphs are captured again in every
process; they cannot be serialized. An engine handed a cache without an
``aot_config`` digest runs uncached, as the JAX engine does. Buffer
donation has no counterpart here.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..aot import warm as aot_warm
from ..core.device import DeviceLike, resolve_device
from ..core.graphs import GraphPool, Session
from ..core.precision import get_precision_mode, set_precision
from ..nn.export import InferenceProgram, export_inference
from ..ops import _kernels
from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..obs.xla import jit_cost, record_compile, sample_hbm
from ..nn.fold import fold_batchnorm
from ..nn.quantize import is_int8, quantize_model


def serve_buckets(max_batch: int) -> List[int]:
    """Powers of two up to ``max_batch``, with ``max_batch`` itself always
    the last bucket: 32 -> [1,2,4,8,16,32], 6 -> [1,2,4,6]."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _sync(device: torch.device) -> None:
    # the calling thread's stream, where its replays ran: a device-wide
    # synchronise would also wait on (and may break) another replica's
    # capture in flight on its own stream
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@contextlib.contextmanager
def _in_mode(mode: str):
    """Run under precision mode ``mode`` (its TF32 switches are read when a
    graph is captured), then put the caller's back."""
    old = get_precision_mode()
    if mode == old:
        yield
        return
    set_precision(mode)
    try:
        yield
    finally:
        set_precision(old)


def _resolve_aot(aot_cache: Any, aot_config: Optional[str], registry):
    """``aot_cache`` as a cache, or None: off, unusable, or without a
    weights digest (refused with a warning: a key that does not cover the
    weights could serve another checkpoint's program)."""
    aot = aot_warm.resolve(aot_cache, registry=registry)
    if aot is not None and not aot_config:
        warnings.warn(
            "InferenceEngine: aot_cache set but no aot_config digest; the "
            "cache is off for this engine (a key that does not cover the "
            "weights could serve another checkpoint's program). Build "
            "engines through from_model/from_checkpoint/from_artifact to "
            "get the digest computed.", stacklevel=3)
        return None
    return aot


class InferenceEngine:
    """Warm, bucketed inference over ``apply_fn(x) -> logits`` on one
    device (CUDA unless ``device="cpu"``). Build one from a live model with
    :meth:`from_model`, from a checkpoint with :meth:`from_checkpoint`, or
    from an exported program with :meth:`from_artifact`. Over a loaded
    program (an :class:`~dcnn_tpu_torch.nn.export.InferenceProgram`) the
    sessions run in the program's precision mode (:attr:`precision`),
    whatever the caller's; otherwise in the caller's."""

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 input_shape: Sequence[int], *, max_batch: int = 32,
                 input_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, warmup: bool = True,
                 batch_invariant: bool = False, name: str = "engine",
                 version: Optional[Any] = None, registry=None,
                 aot_cache: Any = None, aot_config: Optional[str] = None):
        self.name = name
        # model-version identity (the CheckpointManager step for engines
        # built by serve/swap.py's EngineFactory; None for ad-hoc engines),
        # which the router tier routes and reports on
        self.version = version
        self.batch_invariant = bool(batch_invariant)
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else get_registry()
        self.input_shape = tuple(int(d) for d in input_shape)
        self.input_dtype = input_dtype
        self.bucket_sizes = serve_buckets(max_batch)
        self.max_batch = self.bucket_sizes[-1]
        self._apply = apply_fn
        self.precision = (apply_fn.precision
                          if isinstance(apply_fn, InferenceProgram) else None)
        self.aot = _resolve_aot(aot_cache, aot_config, self.registry)
        # {"program": warm_or_compile's info} where from_model used the cache
        self.aot_info: Dict[str, Any] = {}
        if self.aot is not None and self.device.type == "cuda":
            # the kernel libraries, restored (or built and committed)
            # before the first call
            _kernels.build(cache=self.aot)
        self.graphs = GraphPool(self.device)
        # {(bucket, precision mode): session}
        self.sessions: Dict[Tuple[int, str], Session] = {}
        self.compile_stats: Dict[int, Dict[str, float]] = {}
        tracer = get_tracer()
        # largest first: the smaller buckets' graphs fit in what it freed
        for b in reversed(self.bucket_sizes):
            t0 = time.perf_counter()
            cost = None
            with tracer.span("serve.compile", track="serve",
                             engine=name, bucket=b):
                if warmup:
                    # the first call, eager and FLOP-counted: it builds the
                    # kernels, packs the int8 weights and picks the cuDNN
                    # plans, none of which may happen inside a capture
                    with _in_mode(self._mode()):
                        cost = jit_cost(self._forward, self._zeros(b))
            compile_s = time.perf_counter() - t0
            if self.precision is None:  # a loaded program compiles nothing
                record_compile(compile_s, what="serve",
                               registry=self.registry)
            st = {"compile_s": round(compile_s, 4), "capture_s": 0.0,
                  "warmup_s": 0.0}
            if warmup:
                t0 = time.perf_counter()
                self._capture(b)
                st["capture_s"] = round(time.perf_counter() - t0, 4)
                st["warmup_s"] = round(self._warm_bucket(b), 4)
            if cost is not None:
                st["flops"] = cost["flops"]
            self.compile_stats[b] = st
        self._export_cost_gauges(self.registry)
        # the post-construction memory watermark
        sample_hbm(self.registry)

    def _zeros(self, b: int) -> torch.Tensor:
        return torch.zeros((b, *self.input_shape), dtype=self.input_dtype,
                           device=self.device)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._apply(x)

    def _mode(self) -> str:
        """The precision mode the sessions run in: a loaded program's own,
        else the caller's."""
        return self.precision or get_precision_mode()

    def _capture(self, b: int) -> Session:
        mode = self._mode()
        with _in_mode(mode):
            s = self.sessions[(b, mode)] = Session(
                f"{self.name} bucket {b} ({mode})", self._forward,
                (self._zeros(b),), pool=self.graphs)
        return s

    def _session(self, b: int) -> Session:
        """Bucket ``b``'s session in its precision mode (:meth:`_mode`); at
        its first use (no warm-up at construction, or another mode), an
        eager call and the capture."""
        key = (b, self._mode())
        s = self.sessions.get(key)
        if s is None:
            with self.graphs.lock:
                s = self.sessions.get(key)
                if s is None:
                    with _in_mode(key[1]):
                        self._forward(self._zeros(b))
                    s = self._capture(b)
        return s

    def _warm_bucket(self, b: int) -> float:
        t0 = time.perf_counter()
        with get_tracer().span("serve.warmup", track="serve",
                               engine=self.name, bucket=b):
            self.run_padded(self._zeros(b))
            _sync(self.device)
        return time.perf_counter() - t0

    def _release(self) -> None:
        """Destroy every session's graph and give the pool's device
        memory back (:meth:`GraphPool.release`); a later call captures
        again. ``LocalReplica.swap`` calls it on the engine it retired,
        once that engine's batcher has drained."""
        with self.graphs.lock:
            sessions = list(self.sessions.values())
            self.sessions.clear()
            self.graphs.release(sessions)

    def warm(self) -> Dict[int, float]:
        """Run every bucket once on zeros, on the calling thread, and wait
        for the device (a ``serve.warmup`` span each): on CUDA a replay of
        each graph, captured first where construction did not. Returns
        {bucket: seconds}."""
        return {b: self._warm_bucket(b) for b in self.bucket_sizes}

    def _export_cost_gauges(self, registry) -> None:
        """Set the per-sample FLOPs gauge on ``registry`` (construction does
        it for :attr:`registry`; ``start_telemetry`` repeats it for the
        batcher's scrape registry). FLOPs are the aten ops'
        (:mod:`~dcnn_tpu_torch.obs.xla`); no bytes are counted, so the
        byte/FLOP gauge stays unset."""
        top = self.compile_stats.get(self.max_batch, {})
        if top.get("flops"):
            registry.gauge(
                "serve_flops_per_sample",
                "XLA cost-analysis FLOPs per sample at the largest "
                "serve bucket").set(top["flops"] / self.max_batch)
            if top.get("bytes_per_flop") is not None:
                registry.gauge(
                    "serve_bytes_per_flop",
                    "roofline byte/FLOP ratio of the largest serve "
                    "bucket executable").set(top["bytes_per_flop"])

    @classmethod
    def from_model(cls, model, *, fold: bool = True,
                   int8_calib: Optional[Any] = None,
                   act_quantile: Optional[float] = None,
                   device: DeviceLike = None, aot_cache: Any = None,
                   aot_config: Optional[str] = None,
                   **kw) -> "InferenceEngine":
        """Engine over a live :class:`~dcnn_tpu_torch.nn.Sequential` in
        eval mode on ``device``, for inputs of its ``input_shape`` in
        whatever layout the model was built for (an image as (C, H, W) or
        (H, W, C)).

        ``fold=True`` serves :func:`~dcnn_tpu_torch.nn.fold.fold_batchnorm`
        of the model, a new model, and leaves the original untouched;
        ``fold=False`` moves the model itself. A calibration batch as
        ``int8_calib`` serves :func:`~dcnn_tpu_torch.nn.quantize_model` of
        the model instead (folded first unless ``fold=False``, activation
        scales at ``act_quantile`` of ``|x|`` when given, else absmax),
        calibrated where the model lies and then moved; that engine is
        ``batch_invariant`` (module docstring), as is one over a model
        that is int8 already.

        With the AOT cache on (``aot_cache``, module docstring) the engine
        serves the exported program of the transformed model, keyed by
        ``aot_config`` (computed here where not given: the digest of the
        model's config, its weights and the transform): a hit loads it
        and leaves the model untouched; a miss transforms, exports,
        loads the program back and commits it. An export that fails is
        counted as a fallback and the transformed model served."""
        if model.input_shape is None:
            raise ValueError("model has no input_shape; build it through "
                             "SequentialBuilder.input or set input_shape")
        dev = resolve_device(device)
        kw.setdefault("name", model.name)
        registry = kw.get("registry")
        aot = aot_warm.resolve(aot_cache, registry=registry)
        if aot is not None:
            if not aot_config:
                from ..aot.keys import digest, digest_arrays

                aot_config = digest({
                    "model": model.get_config(),
                    "weights": digest_arrays(model.state_dict()),
                    "transform": {
                        "fold": bool(fold), "act_quantile": act_quantile,
                        "int8_calib": None if int8_calib is None
                        else digest_arrays(int8_calib)}})
            return cls._from_model_cached(model, fold, int8_calib,
                                          act_quantile, dev, aot,
                                          aot_config, kw)
        model = cls._transform(model, fold, int8_calib, act_quantile, dev)
        return cls(model, model.input_shape, device=dev,
                   batch_invariant=is_int8(model), aot_cache=False, **kw)

    @staticmethod
    def _transform(model, fold, int8_calib, act_quantile, dev):
        if int8_calib is not None:
            model = quantize_model(model, int8_calib, fold_bn=fold,
                                   act_quantile=act_quantile)
        elif fold:
            model = fold_batchnorm(model)
        return model.to(dev).eval()

    @classmethod
    def _from_model_cached(cls, model, fold, int8_calib, act_quantile, dev,
                           aot, aot_config, kw) -> "InferenceEngine":
        """:meth:`from_model` over the cache: the exported program, loaded
        from it or exported and committed."""
        from ..aot.keys import TensorSpec

        made = []  # the transformed model, where a miss made it

        def export(spec):
            made.append(cls._transform(model, fold, int8_calib,
                                       act_quantile, dev))
            return export_inference(made[0], device=dev)

        registry = kw.get("registry")
        if dev.type == "cuda":
            _kernels.build(cache=aot)  # before the export's first call
        try:
            program, info = aot_warm.warm_or_compile(
                export, TensorSpec(("batch", *model.input_shape),
                                   torch.float32),
                cache=aot, load=InferenceProgram, what="serve",
                config=aot_config, extra={"device": dev.type},
                registry=registry)
        except Exception as e:
            if not made:
                raise  # the transform itself failed: not the cache's fault
            from ..obs.xla import record_aot

            warnings.warn(f"InferenceEngine: the export for the AOT cache "
                          f"failed ({type(e).__name__}: {e}); serving the "
                          f"transformed model uncached", stacklevel=3)
            record_aot("fallback", registry=registry)
            tm = made[0]
            return cls(tm, tm.input_shape, device=dev,
                       batch_invariant=is_int8(tm), aot_cache=aot,
                       aot_config=aot_config, **kw)
        engine = cls(program, program.input_shape, device=dev,
                     input_dtype=program.input_dtype,
                     batch_invariant=program.meta["int8"], aot_cache=aot,
                     aot_config=aot_config, **kw)
        engine.aot_info["program"] = info
        for st in engine.compile_stats.values():
            st["aot_hit"] = info["hit"]
            if "load_s" in info:
                st["load_s"] = info["load_s"]
        return engine

    @classmethod
    def from_checkpoint(cls, path: str, *, device: DeviceLike = None,
                        **kw) -> "InferenceEngine":
        """Engine from a checkpoint directory in the JAX package's format
        (``model.json`` + ``arrays.msgpack``, written by either package;
        the committed ``model_snapshots/mnist_cnn_model`` layout), the
        model loaded onto ``device`` (CUDA unless ``"cpu"``). Other
        arguments as in :meth:`from_model` (``fold=True`` by default)."""
        from ..train.checkpoint import load_checkpoint

        model, _, _, _ = load_checkpoint(path, device=device)
        return cls.from_model(model, device=device, **kw)

    @classmethod
    def from_artifact(cls, blob_or_path, **kw) -> "InferenceEngine":
        """Engine over an exported program
        (:func:`~dcnn_tpu_torch.nn.export.export_inference`'s bytes or a
        file of them): its input shape and dtype, its precision mode and
        its int8-ness (``batch_invariant``) come from the artifact, which
        must have a symbolic batch (a pinned one runs one shape only,
        which defeats the buckets) and lie on the engine's device. Loading
        needs neither the model class, the layer registry nor a
        checkpoint. The artifact's hash is its ``aot_config``: with the AOT
        cache on, the kernel libraries come from it."""
        if isinstance(blob_or_path, (str, os.PathLike)):
            with open(blob_or_path, "rb") as f:
                blob = f.read()
        else:
            blob = bytes(blob_or_path)
        program = InferenceProgram(blob)
        if program.batch_size is not None:
            raise ValueError(
                f"artifact has a pinned batch dimension "
                f"({program.batch_size}); serve needs a batch-polymorphic "
                f"export (export_inference with batch_size=None, the "
                f"default)")
        dev = resolve_device(kw.pop("device", None))
        if program.meta["device"] != dev.type:
            raise ValueError(
                f"artifact was exported on {program.meta['device']}; it "
                f"serves there, not on {dev}")
        kw.setdefault("name", program.name)
        kw.setdefault("aot_config",
                      "artifact-" + hashlib.sha256(blob).hexdigest())
        return cls(program, program.input_shape, device=dev,
                   input_dtype=program.input_dtype,
                   batch_invariant=program.meta["int8"], **kw)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"batch of {n} outside [1, {self.max_batch}]")
        for b in self.bucket_sizes:
            if b >= n:
                return b
        raise AssertionError("unreachable: last bucket is max_batch")

    def pad_to_bucket(self, x) -> Tuple[torch.Tensor, int]:
        """Zero-pad ``(n, *input_shape)`` rows (array or tensor) up to the
        nearest bucket. Returns ``(padded, n)``; ``padded`` is always a
        fresh tensor on the engine's device."""
        x = torch.as_tensor(x, dtype=self.input_dtype)
        n = x.shape[0]
        b = self.bucket_for(n)
        out = torch.zeros((b, *self.input_shape), dtype=self.input_dtype,
                          device=self.device)
        out[:n] = x.to(self.device)
        return out, n

    def run_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Run one bucket; ``x.shape[0]`` must be a bucket size. Returns
        the logits on the engine's device (asynchronously on CUDA)."""
        b = x.shape[0]
        if b not in self.bucket_sizes:
            raise ValueError(f"no session for batch {b}; buckets are "
                             f"{self.bucket_sizes}")
        x = x.to(self.device, self.input_dtype)
        if not self.graphs.cuda:
            return self._forward(x)
        return self._session(b)(x)

    def infer(self, x) -> torch.Tensor:
        """Run ``x`` — one sample ``input_shape`` or a batch
        ``(n, *input_shape)`` of any size — through the buckets; batches
        beyond ``max_batch`` are chunked. Same leading-dim convention out
        as in."""
        x = torch.as_tensor(x)
        single = tuple(x.shape) == self.input_shape
        if single:
            x = x[None]
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(f"expected trailing dims {self.input_shape}, "
                             f"got array of shape {tuple(x.shape)}")
        outs = []
        for lo in range(0, x.shape[0], self.max_batch):
            padded, n = self.pad_to_bucket(x[lo:lo + self.max_batch])
            outs.append(self.run_padded(padded)[:n])
        y = outs[0] if len(outs) == 1 else torch.cat(outs)
        return y[0] if single else y

    def __repr__(self) -> str:
        return (f"InferenceEngine({self.name!r}, input={self.input_shape}, "
                f"buckets={self.bucket_sizes}, device={self.device}, "
                f"batch_invariant={self.batch_invariant})")
