"""Model partitioners for pipeline parallelism (counterpart of
``dcnn_tpu/parallel/partitioner.py``).

A partitioner turns a ``Sequential`` and a stage count into ``[start,
end)`` layer ranges, which ``Sequential.split`` turns into stage models:

- :class:`NaivePartitioner`: an even layer-count split, the first ``rem``
  stages one layer longer;
- :class:`FlopBalancedPartitioner`: a greedy prefix walk over each layer's
  ``forward_complexity + backward_complexity`` towards equal cumulative
  slices (a residual block is one layer, never split);
- :class:`MeasuredPartitioner`: the same walk over measured per-stage
  walls spread over each stage's layers by their FLOP weights, so a stage
  that ran slow sheds layers.

The partitions are the JAX package's for the same model and stage count.
"""

from __future__ import annotations

from typing import List, Sequence

from ..nn.sequential import Partition, Sequential


class Partitioner:
    def get_partitions(self, model: Sequential,
                       num_stages: int) -> List[Partition]:
        raise NotImplementedError

    @staticmethod
    def _validate(model: Sequential, num_stages: int) -> None:
        if num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        if num_stages > len(model.layers):
            raise ValueError(f"cannot split {len(model.layers)} layers into "
                             f"{num_stages} stages")


class NaivePartitioner(Partitioner):
    """Even layer-count split: the first ``rem`` stages get one extra
    layer."""

    def get_partitions(self, model, num_stages):
        self._validate(model, num_stages)
        base, rem = divmod(len(model.layers), num_stages)
        parts: List[Partition] = []
        start = 0
        for s in range(num_stages):
            size = base + (1 if s < rem else 0)
            parts.append((start, start + size))
            start += size
        return parts


def _layer_flops(model: Sequential) -> List[int]:
    """Per-layer ``forward + backward`` complexity (+1, so that a layer of
    no cost still takes a place in the walk)."""
    return [layer.forward_complexity(shape)
            + layer.backward_complexity(shape) + 1
            for layer, shape in zip(model.layers, model.layer_shapes())]


def _greedy_walk(costs: Sequence[float], num_stages: int) -> List[Partition]:
    """Each stage extends while that lands closer to its equal-share
    cumulative target than stopping would, leaving a layer for every stage
    after it; the last stage takes what remains."""
    total = sum(costs)
    n = len(costs)
    parts: List[Partition] = []
    start = 0
    acc = 0.0
    for s in range(num_stages):
        target = total * (s + 1) / num_stages
        end = start + 1  # at least one layer per stage
        acc += costs[start]
        while end < n - (num_stages - s - 1):
            next_acc = acc + costs[end]
            if abs(next_acc - target) <= abs(acc - target):
                acc = next_acc
                end += 1
            else:
                break
        parts.append((start, end))
        start = end
    if parts[-1][1] != n:
        parts[-1] = (parts[-1][0], n)
    return parts


class FlopBalancedPartitioner(Partitioner):
    """Split by per-layer ``forward_complexity + backward_complexity``."""

    def get_partitions(self, model, num_stages):
        self._validate(model, num_stages)
        return _greedy_walk(_layer_flops(model), num_stages)


class MeasuredPartitioner(Partitioner):
    """Split by measured per-stage walls (``collect_load_reports``): each
    current stage's wall is spread over its layers in proportion to their
    FLOP estimates and the greedy walk runs over those costs. A stage
    without a measurement (wall ``<= 0``) keeps its FLOP costs, so with no
    reports the split is :class:`FlopBalancedPartitioner`'s."""

    def __init__(self, partitions: Sequence[Partition],
                 stage_walls: Sequence[float]):
        if len(partitions) != len(stage_walls):
            raise ValueError(f"{len(partitions)} partitions vs "
                             f"{len(stage_walls)} walls")
        self.partitions = [tuple(p) for p in partitions]
        self.stage_walls = [float(w) for w in stage_walls]

    def get_partitions(self, model, num_stages):
        self._validate(model, num_stages)
        flops = _layer_flops(model)
        costs = [float(c) for c in flops]
        for (start, end), wall in zip(self.partitions, self.stage_walls):
            stage_flops = sum(flops[start:end])
            if wall <= 0.0 or stage_flops <= 0:
                continue
            for i in range(start, end):
                costs[i] = wall * flops[i] / stage_flops
        return _greedy_walk(costs, num_stages)
