"""Checkpoint save and load in the JAX package's own format (counterpart of
``dcnn_tpu/train/checkpoint.py``).

A checkpoint is a directory holding ``model.json`` (the model's config, the
optimizer's config, user metadata, ``has_opt_state``) and
``arrays.msgpack`` (``{"params", "state", "opt_state"}`` as
``flax.serialization.to_bytes`` writes them). The arrays go to disk in the
JAX layout (:func:`~dcnn_tpu_torch.interop.to_jax`, ``state_to_jax``,
``opt_state_to_jax``), written by the port's own codec (:mod:`._msgpack`),
so either package reads what the other wrote. The model holds its params
and batchnorm statistics, so a save takes the model and the optimizer
state, and a load returns a model built from the config on the device
asked for.

Durability: each file is committed atomically (``resilience/atomic.py``),
arrays before the config that describes them; the trip point
``ckpt.write`` fires before either. Step history, checksums, retention and
async saves are ``resilience.CheckpointManager``'s.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import interop
from ..core.device import DeviceLike
from ..nn.sequential import Sequential
from ..optim.optimizers import Optimizer, OptimizerFactory
from ..resilience import faults as _faults
from ..resilience.atomic import write_file_atomic
from . import _msgpack

ARRAYS = "arrays.msgpack"
MODEL = "model.json"


def checkpoint_manifest(model: Sequential, optimizer: Optional[Optimizer],
                        metadata: Optional[Dict[str, Any]],
                        has_opt_state: bool) -> Dict[str, Any]:
    """``model.json``'s content. The metadata goes through a JSON round
    trip: a copy of it as it is now, whatever the caller changes later."""
    return {
        "model": model.get_config(),
        "optimizer": optimizer.get_config() if optimizer is not None
        else None,
        "metadata": json.loads(json.dumps(metadata or {})),
        "has_opt_state": has_opt_state,
    }


class PinnedPool:
    """Pinned host buffers for ``sets`` snapshots in flight, reused from
    one snapshot to the next (a set is {tensor name: buffer}).
    :meth:`acquire` hands out a free set, or waits until a snapshot
    releases one: the saver's backpressure, so a training thread that
    saves faster than the saver writes waits instead of pinning more
    memory. A buffer is made in every set at once, the first time a
    snapshot asks for it, so all the pinned memory is made by the first
    save (and again only for a tensor of a new shape). ``allocations``
    counts the pinned buffers ever made."""

    def __init__(self, sets: int = 2):
        if sets < 1:
            raise ValueError(f"sets must be >= 1, got {sets}")
        self.allocations = 0
        self._sets = [{} for _ in range(sets)]
        self._free = list(self._sets)
        self._cond = threading.Condition()

    def acquire(self) -> Dict[str, torch.Tensor]:
        with self._cond:
            while not self._free:
                self._cond.wait()
            return self._free.pop()

    def release(self, buffers: Dict[str, torch.Tensor]) -> None:
        with self._cond:
            self._free.append(buffers)
            self._cond.notify()

    def buffer(self, buffers: Dict[str, torch.Tensor], name: str,
               like: torch.Tensor) -> torch.Tensor:
        """``buffers[name]``, pinned, of ``like``'s shape and dtype; made in
        every set (and counted) where ``buffers`` has none that fits."""
        host = buffers.get(name)
        if host is None or host.shape != like.shape \
                or host.dtype != like.dtype:
            with self._cond:
                for s in self._sets:
                    s[name] = torch.empty(like.shape, dtype=like.dtype,
                                          pin_memory=True)
                    self.allocations += 1
            host = buffers[name]
        return host


class HostSnapshot:
    """Host copies of a model's params and buffers and an optimizer state,
    taken on the calling thread, so a step that then updates them in place
    cannot reach the copies. CUDA tensors are copied on the current stream
    into pinned host buffers and an event is recorded after the copies:
    the caller goes on at once, and :meth:`tree` waits for the event. CPU
    tensors are cloned. With ``pool`` (a :class:`PinnedPool`) the pinned
    buffers are a set of the pool's, given back by :meth:`release`; without
    it they are made for this snapshot."""

    def __init__(self, model: Sequential, opt_state: Optional[Mapping[str, Any]],
                 pool: Optional[PinnedPool] = None):
        self.config = model.get_config()
        self.event = None
        self._pool = pool
        self._set: Optional[Dict[str, torch.Tensor]] = None
        self.params = self._copy("p", dict(model.named_parameters()))
        self.buffers = self._copy("b", dict(model.named_buffers()))
        self.opt_state = None if opt_state is None else {
            k: (int(v) if k == "t" else self._copy(f"o.{k}", v))
            for k, v in opt_state.items()}
        if self.event is not None:
            self.event.record()

    def _pinned(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if self._pool is None:
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if self._set is None:
            self._set = self._pool.acquire()
        return self._pool.buffer(self._set, name, t)

    def _copy(self, group: str, named: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        out = {}
        for n, t in named.items():
            t = t.detach()
            if t.device.type == "cuda":
                host = self._pinned(f"{group}.{n}", t)
                host.copy_(t, non_blocking=True)
                if self.event is None:
                    self.event = torch.cuda.Event()
                out[n] = host
            else:
                out[n] = t.clone()
        return out

    def release(self) -> None:
        """Drop the host copies: a pool's set goes back to the pool (after
        the copies into it are done), other pinned buffers to PyTorch's
        caching host allocator. Idempotent."""
        self.params = self.buffers = self.opt_state = None
        if self._set is not None:
            if self.event is not None:
                self.event.synchronize()
            self._pool.release(self._set)
            self._set = None

    def tree(self) -> Dict[str, Any]:
        """The arrays in the JAX layout, as numpy: ``{"params", "state"}``
        and, with an optimizer state, ``"opt_state"`` (``t`` as an int32
        0-d array, as ``jnp.zeros((), jnp.int32)`` writes it). Waits for
        the copies first."""
        if self.event is not None:
            self.event.synchronize()

        def layout(named):
            return interop.tree_from_flat(
                self.config, {n: t.numpy() for n, t in named.items()})

        out: Dict[str, Any] = {"params": layout(self.params),
                               "state": layout(self.buffers)}
        if self.opt_state is not None:
            out["opt_state"] = {k: (np.asarray(v, np.int32) if k == "t"
                                    else layout(v))
                                for k, v in self.opt_state.items()}
        return out


def save_checkpoint(path: str, model: Sequential,
                    opt_state: Optional[Mapping[str, Any]] = None,
                    optimizer: Optional[Optimizer] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path/arrays.msgpack`` and then ``path/model.json``, each
    atomically, in the JAX package's format."""
    os.makedirs(path, exist_ok=True)
    manifest = checkpoint_manifest(model, optimizer, metadata,
                                   opt_state is not None)
    array_bytes = _msgpack.to_bytes(HostSnapshot(model, opt_state).tree())
    # a crash here models dying mid-save, before anything replaced the
    # previous checkpoint's files
    _faults.trip("ckpt.write", path=path)
    write_file_atomic(os.path.join(path, ARRAYS), array_bytes)
    write_file_atomic(os.path.join(path, MODEL),
                      json.dumps(manifest, indent=2).encode("utf-8"))


def _tuples(tree: Any) -> Any:
    """A state dict's indexed dicts (``{"0": ..., "1": ...}``) as tuples,
    which :mod:`~dcnn_tpu_torch.interop` walks beside the layer configs; an
    empty dict (an empty tuple or a layer without arrays) stays empty."""
    if isinstance(tree, dict):
        if tree and set(tree) == {str(i) for i in range(len(tree))}:
            return tuple(_tuples(tree[str(i)]) for i in range(len(tree)))
        return {k: _tuples(v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, (dict, tuple, list)):
        for t in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(t)
    else:
        yield tree


def restore_arrays(manifest: Dict[str, Any], array_bytes: bytes,
                   device: DeviceLike = None
                   ) -> Tuple[Sequential, Any, Optional[Optimizer]]:
    """(model, opt_state, optimizer) from ``model.json``'s content and
    ``arrays.msgpack``'s bytes: the model built from its config on
    ``device`` (CUDA unless ``"cpu"``) with every param and buffer checked
    for name and shape, the optimizer state on the model's device with the
    model's parameter names and shapes. A model whose every param was
    saved in fp64 comes back in fp64."""
    tree = _tuples(_msgpack.msgpack_restore(array_bytes))
    dtypes = {np.asarray(a).dtype for a in _leaves(tree["params"])}
    model = interop.from_jax(
        manifest["model"], tree["params"], tree["state"], device=device,
        dtype=torch.float64 if dtypes == {np.dtype(np.float64)} else None)
    if model.input_shape is None:
        raise ValueError("checkpoint model config lacks input_shape")
    optimizer = (OptimizerFactory.create_from_config(manifest["optimizer"])
                 if manifest.get("optimizer") else None)
    opt_state = None
    if manifest.get("has_opt_state"):
        if optimizer is None:
            raise ValueError("checkpoint has optimizer state but no optimizer "
                             "config")
        opt_state = interop.opt_state_from_jax(model, tree["opt_state"])
        want = optimizer.init(dict(model.named_parameters()))
        for k, v in want.items():
            got = opt_state.get(k)
            if k == "t":
                ok = got is not None
            else:
                ok = isinstance(got, dict) and set(got) == set(v) and all(
                    got[n].shape == v[n].shape for n in v)
            if not ok:
                raise ValueError(f"checkpoint optimizer state {k!r} does not "
                                 f"fit the model's parameters")
    return model, opt_state, optimizer


def load_checkpoint(path: str, *, device: DeviceLike = None
                    ) -> Tuple[Sequential, Any, Optional[Optimizer],
                               Dict[str, Any]]:
    """(model, opt_state, optimizer, metadata) from a checkpoint directory
    that either package wrote, the model on ``device`` (CUDA unless
    ``"cpu"``)."""
    with open(os.path.join(path, MODEL), "r", encoding="utf-8") as f:
        manifest = json.load(f)
    with open(os.path.join(path, ARRAYS), "rb") as f:
        array_bytes = f.read()
    model, opt_state, optimizer = restore_arrays(manifest, array_bytes, device)
    return model, opt_state, optimizer, manifest.get("metadata", {})
