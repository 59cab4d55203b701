"""Integer keys for the port's random draws, in the role of a JAX PRNG key.

A key is a non-negative int below 2**63. :func:`fold_in` derives a key
from a key and an int through numpy's ``SeedSequence``, as
``jax.random.fold_in`` derives one from a key and an int; :func:`generator`
turns a key into a ``torch.Generator`` on a device, from which a draw
takes its random numbers. Keys are folded on the host, so a loop that
derives a key per step or per op adds no work on the card and waits for
nothing there. The draws are PyTorch's, not ``jax.random``'s bits: one
key gives the same draws run after run, not the JAX package's draws.

A CUDA graph draws only from generators registered with it at capture
(:mod:`~dcnn_tpu_torch.core.graphs`), so a graph's draws come from a fixed
set of :func:`generators` that :func:`reseed` seeds on the host before each
replay: a generator reseeded with ``key`` draws exactly what a fresh
``generator(key)`` draws.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

KEY_BITS = 63


def fold_in(key: int, data: int) -> int:
    """The key derived from ``key`` and the int ``data``."""
    state = np.random.SeedSequence([int(key), int(data) & (2 ** 64 - 1)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def split(key: int, num: int = 2) -> List[int]:
    """``num`` keys derived from ``key`` (``fold_in(key, i)``)."""
    return [fold_in(key, i) for i in range(num)]


def generator(key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``key``."""
    return torch.Generator(device=device).manual_seed(int(key))


def generators(n: int, device) -> List[torch.Generator]:
    """``n`` generators on ``device``, to be seeded by :func:`reseed`."""
    return [torch.Generator(device=device) for _ in range(n)]


def reseed(gens: Sequence[torch.Generator], keys: Sequence[int]) -> None:
    """Seed ``gens[i]`` with ``keys[i]``, on the host."""
    if len(gens) != len(keys):
        raise ValueError(f"{len(keys)} keys for {len(gens)} generators")
    for g, k in zip(gens, keys):
        g.manual_seed(int(k))


def to_device(values, device, dtype=None) -> torch.Tensor:
    """A small host array (an lr vector, per-channel constants) on
    ``device`` through pinned memory and a non-blocking copy: a copy from
    pageable memory would wait for the work queued on the card."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
