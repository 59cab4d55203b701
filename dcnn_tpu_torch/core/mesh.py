"""Device meshes over the process group (counterpart of
``dcnn_tpu/core/mesh.py``).

The port's parallelism is torch's own: one process a rank, the same
program on every rank, and explicit collectives over a
``torch.distributed`` process group. A :class:`Mesh` lays the initialised
world's ranks out on named axes, as the JAX package's ``Mesh`` lays out
devices, over a ``torch.distributed.device_mesh.DeviceMesh`` that holds a
process group an axis. The canonical axis names are the JAX package's:

- ``"data"``  — batch (data parallel) axis; gradients are all-reduced over
  its group.
- ``"stage"`` — pipeline-stage axis.
- ``"model"`` — reserved for tensor parallelism of wide layers.
- ``"seq"``   — sequence/context parallelism.

``mesh.shape`` maps axis names to sizes, as JAX's does, so callers keep
``mesh.shape[DATA_AXIS]``. ``mesh.get_group(("data", "sp"))`` is the
group of this rank's plane over several axes (the spatial step reduces
its batchnorm sums and gradients over one). A mesh is also a context
manager: inside ``with mesh:``, ``make_train_step(reduce_axis="data")``
resolves the axis name against it, as a JAX axis name resolves inside
``shard_map``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

_ACTIVE = threading.local()


def mesh_axes() -> Tuple[str, ...]:
    return (DATA_AXIS, STAGE_AXIS, MODEL_AXIS, SEQ_AXIS)


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group: call dcnn_tpu_torch.parallel.multihost."
            "initialize() (or torch.distributed.init_process_group) first")
    return dist


class Mesh:
    """The ranks of ``devices`` (an array of global ranks, shaped like the
    mesh) on the axes ``axis_names``, over ``device_mesh``."""

    def __init__(self, device_mesh, devices: np.ndarray,
                 axis_names: Tuple[str, ...]):
        self.device_mesh = device_mesh
        self.devices = devices
        self.axis_names = axis_names
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def get_group(self, axis):
        """The process group of this rank's line along ``axis``, or, for a
        tuple of axis names, of its plane over those axes. A tuple's
        groups are built at its first call, which every rank of the world
        makes alike (``new_group`` is collective)."""
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        axes = tuple(axis)
        if axes not in self._groups:
            missing = [a for a in axes if a not in self.axis_names]
            if missing or len(set(axes)) != len(axes):
                raise ValueError(f"axes {axes} are not distinct axes of "
                                 f"{self.axis_names}")
            self._groups[axes] = self._new_plane_group(axes)
        return self._groups[axes]

    def _new_plane_group(self, axes: Tuple[str, ...]):
        """Every plane's group over ``axes`` (one a coordinate of the other
        axes, each built by every rank, in order); returns this rank's."""
        dist = _dist()
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in keep]
        planes = np.transpose(self.devices, rest + keep).reshape(
            -1, int(np.prod([self.devices.shape[i] for i in keep])))
        me, mine = dist.get_rank(), None
        for ranks in planes:
            g = dist.new_group([int(r) for r in ranks])
            if me in ranks:
                mine = g
        return mine

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def __enter__(self) -> "Mesh":
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.stack.pop()


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the ranks ``devices`` (default: the whole initialised
    world). Every rank of the world calls it alike (building an axis's
    groups is collective).

    ``make_mesh()`` → 1-D data mesh over every rank.
    ``make_mesh((4, 2), ("data", "stage"))`` → 4-way DP × 2-stage pipeline.
    """
    dist = _dist()
    from torch.distributed.device_mesh import DeviceMesh

    ranks = (list(devices) if devices is not None
             else list(range(dist.get_world_size())))
    if shape is None:
        shape = (len(ranks),)
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(
            f"mesh shape {tuple(shape)} does not cover {len(ranks)} devices")
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names rank mismatch")
    arr = np.asarray(ranks, dtype=np.int64).reshape(tuple(shape))
    # the mesh's device type follows the world's backend: gloo's groups
    # are host groups, nccl's card groups
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(dev_type, torch.as_tensor(arr),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(dm, arr, tuple(axis_names))


def single_device_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """1-rank mesh — lets sharded code paths run unmodified in a world of
    one process."""
    dist = _dist()
    if dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh needs a world of 1 process, not "
            f"{dist.get_world_size()}: use make_mesh")
    return make_mesh((1,), (axis_name,))
