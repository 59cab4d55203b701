"""Paged KV cache: a fixed pool of pages and per-sequence page tables
(counterpart of ``dcnn_tpu/serve/kvcache.py``).

A dense per-slot cache must be sized for the longest possible sequence;
paging sizes it for the working set. The cache is one pool of fixed-size
pages (``page_size`` token slots per page, per layer); a sequence owns
only the pages its length needs, pages go back to a free list the moment a
sequence completes or is preempted, and a sequence's logical positions map
to physical slots through its page table, the indirection the decode
step's scatter and gather read (``serve/decode.py``).

Layout: ``k`` and ``v`` are ``(num_layers, num_pages, page_size,
embed_dim)`` tensors on the pool's device. **Page 0 is the null page**:
never allocated, the target of every padded page-table entry and of every
inactive batch row's write. No active sequence reads it (the decode mask
stops at a sequence's own position), so colliding writes there, in
whatever order the device makes them, are never observed.

Sizing: :func:`suggest_num_pages` turns the card's free memory
(``torch.cuda.mem_get_info``) into a page budget; on the CPU it returns
the caller's ``default``.

Thread safety: the allocator's bookkeeping (free list, tables) is guarded
by one lock. ``k`` and ``v`` belong to the engine's step loop (one
writer).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device


class OutOfPagesError(RuntimeError):
    """The page pool is exhausted: a typed allocation failure, so the
    scheduler can preempt and recompute instead of failing the step."""


class KVPagePool:
    """Fixed page pool, free list and per-sequence page tables.

    ``pages_for(length)`` pages hold a ``length``-token sequence;
    :meth:`ensure` grows a sequence's table to cover a length and raises
    :class:`OutOfPagesError`, allocating nothing, when the free list
    cannot; :meth:`release` returns a sequence's pages; :meth:`table`
    renders a table padded with the null page to a bucket's width."""

    def __init__(self, *, num_layers: int, embed_dim: int,
                 page_size: int = 8, num_pages: int = 64,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the null "
                             f"page), got {num_pages}")
        self.num_layers = int(num_layers)
        self.embed_dim = int(embed_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.embed_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._lock = threading.Lock()
        # page 0 excluded: it is the null page
        self._free: deque = deque(range(1, self.num_pages))  # dcnn: guarded_by=_lock
        self._tables: Dict[Any, List[int]] = {}  # dcnn: guarded_by=_lock

    # -- geometry --
    def pages_for(self, length: int) -> int:
        """Pages a ``length``-token sequence occupies (0 for length 0)."""
        return -(-int(length) // self.page_size)

    @property
    def page_bytes(self) -> int:
        """Device bytes of one page across K and V and every layer: the
        unit :func:`suggest_num_pages` budgets in."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.page_size * self.embed_dim * itemsize

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the whole pool (the null page included)."""
        return self.num_pages * self.page_bytes

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return (self.num_pages - 1) - len(self._free)

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def num_seq_pages(self, seq_id: Any) -> int:
        with self._lock:
            return len(self._tables.get(seq_id, ()))

    # -- allocation --
    def ensure(self, seq_id: Any, length: int) -> int:
        """Grow ``seq_id``'s table until it covers ``length`` tokens and
        return its page count. All or nothing: raises
        :class:`OutOfPagesError` without allocating when the free list
        cannot cover the growth."""
        need = self.pages_for(length)
        with self._lock:
            table = self._tables.setdefault(seq_id, [])
            grow = need - len(table)
            if grow <= 0:
                return len(table)
            if grow > len(self._free):
                raise OutOfPagesError(
                    f"sequence {seq_id!r} needs {grow} more page(s) for "
                    f"length {length}; only {len(self._free)} of "
                    f"{self.num_pages - 1} allocatable pages free")
            table.extend(self._free.popleft() for _ in range(grow))
            return len(table)

    def release(self, seq_id: Any) -> int:
        """Return ``seq_id``'s pages to the free list; an unknown id is a
        no-op. Returns the pages freed."""
        with self._lock:
            table = self._tables.pop(seq_id, [])
            self._free.extend(table)
            return len(table)

    def table(self, seq_id: Any, width: int) -> np.ndarray:
        """``seq_id``'s page table as int32, padded with the null page to
        ``width`` entries; a table longer than ``width`` raises."""
        with self._lock:
            table = list(self._tables.get(seq_id, ()))
        if len(table) > width:
            raise ValueError(f"sequence {seq_id!r} holds {len(table)} "
                             f"pages > table width {width}")
        out = np.zeros(width, np.int32)
        out[:len(table)] = table
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            in_use = (self.num_pages - 1) - len(self._free)
            seqs = len(self._tables)
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "pages_in_use": in_use,
                "pages_free": (self.num_pages - 1) - in_use,
                "sequences": seqs, "page_bytes": self.page_bytes,
                "pool_bytes": self.pool_bytes}

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"KVPagePool(layers={self.num_layers}, "
                f"pages={self.num_pages}x{self.page_size}, "
                f"embed={self.embed_dim}, in_use={s['pages_in_use']}, "
                f"device={self.device})")


def suggest_num_pages(page_bytes: int, *, fraction: float = 0.2,
                      default: int = 64, cap: int = 4096,
                      device: DeviceLike = None) -> int:
    """A page budget: ``fraction`` of the free memory of ``device`` (CUDA
    unless ``"cpu"``; ``torch.cuda.mem_get_info``) in units of
    ``page_bytes`` (:attr:`KVPagePool.page_bytes`), clamped to
    ``[2, cap]``. On the CPU, which reports no such headroom,
    ``default``."""
    if page_bytes < 1:
        raise ValueError(f"page_bytes must be >= 1, got {page_bytes}")
    if not 0 < fraction <= 1:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return default
    free, _ = torch.cuda.mem_get_info(dev)
    return int(min(max(free * fraction // page_bytes, 2), cap))
