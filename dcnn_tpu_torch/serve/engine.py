"""Bucketed inference engine (counterpart of ``dcnn_tpu/serve/engine.py``).

One session per batch bucket (powers of two up to ``max_batch``), each
warmed once at construction so the first real request pays no first-call
cost (kernel build, allocator growth, cuDNN plans), with
zero-pad-to-bucket dispatch. :meth:`InferenceEngine.warm` repeats the
warm-up on another thread (``DynamicBatcher`` calls it on its dispatcher).
PyTorch runs eagerly, so a session is the model's forward at that batch
size. Buckets still bound the shapes the kernels see to
``log2(max_batch)+1``.

Padding is row-exact within a bucket: zero rows ride along and are sliced
off. Float results are allclose, not bit-identical, across buckets.
JAX's AOT executable cache, XLA cost gauges and buffer donation have no
counterpart here.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.device import DeviceLike, resolve_device
from ..nn.fold import fold_batchnorm


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
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InferenceEngine:
    """Warm, bucketed inference over ``apply_fn(x) -> logits`` on one
    device (CUDA unless ``device="cpu"``). Build one from a live model with
    :meth:`from_model`, or from a checkpoint with :meth:`from_checkpoint`."""

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 input_shape: Sequence[int], *, max_batch: int = 32,
                 device: DeviceLike = None, warmup: bool = True,
                 name: str = "engine"):
        self.name = name
        self.device = resolve_device(device)
        self.input_shape = tuple(int(d) for d in input_shape)
        self.input_dtype = torch.float32
        self.bucket_sizes = serve_buckets(max_batch)
        self.max_batch = self.bucket_sizes[-1]
        self._apply = apply_fn
        self.compile_stats: Dict[int, Dict[str, float]] = {
            b: {"warmup_s": 0.0} for b in self.bucket_sizes}
        if warmup:
            for b, s in self.warm().items():
                self.compile_stats[b]["warmup_s"] = s

    def warm(self) -> Dict[int, float]:
        """Run every bucket once on zeros, on the calling thread, and wait
        for the device. Returns {bucket: seconds}. PyTorch keeps cuDNN's
        handles and execution-plan cache per thread, so a thread that will
        serve (the batcher's dispatcher) warms for itself."""
        out = {}
        for b in self.bucket_sizes:
            t0 = time.perf_counter()
            self.run_padded(torch.zeros((b, *self.input_shape),
                                        dtype=self.input_dtype,
                                        device=self.device))
            _sync(self.device)
            out[b] = time.perf_counter() - t0
        return out

    @classmethod
    def from_model(cls, model, *, fold: bool = True,
                   int8_calib: Optional[Any] = None,
                   device: DeviceLike = None, **kw) -> "InferenceEngine":
        """Engine over a live :class:`~dcnn_tpu_torch.nn.Sequential` in
        eval mode on ``device``, for inputs of its ``input_shape`` in
        whatever layout the model was built for (an image as (C, H, W) or
        (H, W, C)).

        ``fold=True`` serves :func:`~dcnn_tpu_torch.nn.fold.fold_batchnorm`
        of the model, a new model, and leaves the original untouched;
        ``fold=False`` moves the model itself. ``int8_calib`` raises until
        ``nn/quantize.py`` is ported."""
        if int8_calib is not None:
            raise NotImplementedError(
                "int8 serving needs nn/quantize.py, which is not ported to "
                "dcnn_tpu_torch yet (see ROADMAP.md)")
        if model.input_shape is None:
            raise ValueError("model has no input_shape; build it through "
                             "SequentialBuilder.input or set input_shape")
        dev = resolve_device(device)
        if fold:
            model = fold_batchnorm(model)
        model = model.to(dev).eval()
        kw.setdefault("name", model.name)
        return cls(model, model.input_shape, device=dev, **kw)

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
        with torch.inference_mode():
            return self._apply(x.to(self.device, self.input_dtype))

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
                f"buckets={self.bucket_sizes}, device={self.device})")
