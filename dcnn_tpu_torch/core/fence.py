"""Hard device fences for wall-clock measurement (counterpart of
``dcnn_tpu/core/fence.py``).

A launch on the card returns before the kernel runs, so a wall clock read
right after it measures the host's issue time. :func:`hard_fence` waits
for the work that produced a tensor: it synchronises the tensor's device
and reads one element of it to the host, which cannot complete before the
bytes exist. On the CPU, where every op has finished when it returns, it
does nothing.
"""

from __future__ import annotations

from typing import Iterator

import torch


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def hard_fence(tree) -> None:
    """Block until every CUDA tensor leaf of ``tree`` (a tensor, or dicts,
    lists and tuples of them) has been computed: each leaf's device is
    synchronised once, and one element of every non-empty leaf is read to
    the host. CPU leaves and other objects are ignored."""
    leaves = [t for t in _leaves(tree) if t.is_cuda]
    for dev in {t.device for t in leaves}:
        torch.cuda.synchronize(dev)
    for t in leaves:
        if t.numel():
            t.detach().reshape(-1)[:1].cpu()
