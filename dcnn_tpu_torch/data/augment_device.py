"""On-device data augmentations (counterpart of
``dcnn_tpu/data/augment_device.py``).

The nine host augmentations of :mod:`.augment` as batch ops on tensors on
the batch's own device, in NCHW or NHWC, with static shapes: they run
inside the resident and streaming feeds' train steps, so augmentation
costs no host work and no host-to-device traffic.

Each op is split into a *draw* (its masks, offsets, angles or noise, taken
from a ``torch.Generator`` on the batch's device) and an *apply* (the
arithmetic on the batch given the draws). ``op(x, key)`` draws from
:func:`~dcnn_tpu_torch.core.keys.generator` of the int ``key`` and
applies; :class:`DeviceAugment` gives op ``i`` the key ``fold_in(key,
i)``, as the JAX pipeline gives it ``jax.random.fold_in(key, i)``, so one
(key, op list) gives one batch. The draws are PyTorch's, not
``jax.random``'s; the apply is the JAX op's arithmetic, so JAX's draws fed
to ``apply`` give the JAX op's output. A per-sample "apply with probability
p" is a uniform draw below ``p``. ``op.run(x, gen)`` and
``DeviceAugment.run(batch, gens)`` draw from generators the caller seeds
(with ``DeviceAugment.keys(key)``: a CUDA graph's fixed generators,
:func:`~dcnn_tpu_torch.core.keys.reseed`), giving what ``op(x, key)`` and
``aug(batch, key)`` give.

Rotation is the bilinear, edge-clamped resample of
``map_coordinates(order=1, mode="nearest")``, written out over the four
neighbours of each source point.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.keys import fold_in, generator, to_device


def _hw_axes(data_format: str) -> Tuple[int, int]:
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return (2, 3) if data_format == "NCHW" else (1, 2)


def _bshape(x: torch.Tensor) -> Tuple[int, ...]:
    """[N, 1, 1, ...]: the broadcast shape of a per-sample scalar."""
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def _mask(gen: torch.Generator, n: int, p: float, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) < p


def _uniform(gen, n, lo, hi, dtype, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device, dtype=dtype)
    return u * (hi - lo) + lo


class DeviceOp:
    """One augmentation: ``op(x, key) == op.run(x, gen) == op.apply(x,
    op.draw(x, gen))`` with ``gen = generator(key, x.device)``."""

    def draw(self, x: torch.Tensor, gen: torch.Generator) -> tuple:
        return ()

    def apply(self, x: torch.Tensor, draws: tuple) -> torch.Tensor:
        raise NotImplementedError

    def run(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return self.apply(x, self.draw(x, gen))

    def __call__(self, x: torch.Tensor, key: int) -> torch.Tensor:
        return self.run(x, generator(key, x.device))


class Brightness(DeviceOp):
    """Additive shift in [-delta, delta] per sample. Draws: (mask [N] bool,
    shift [N])."""

    def __init__(self, delta: float = 0.2, p: float = 0.5):
        self.delta, self.p = float(delta), float(p)

    def draw(self, x, gen):
        n = x.shape[0]
        return (_mask(gen, n, self.p, x.device),
                _uniform(gen, n, -self.delta, self.delta, x.dtype, x.device))

    def apply(self, x, draws):
        m, shift = draws
        return x + torch.where(m, shift, 0).reshape(_bshape(x))


class Contrast(DeviceOp):
    """Scale about the per-image mean by a factor in [lower, upper]. Draws:
    (mask, factor [N])."""

    def __init__(self, lower: float = 0.8, upper: float = 1.2, p: float = 0.5):
        self.lower, self.upper, self.p = float(lower), float(upper), float(p)

    def draw(self, x, gen):
        n = x.shape[0]
        return (_mask(gen, n, self.p, x.device),
                _uniform(gen, n, self.lower, self.upper, x.dtype, x.device))

    def apply(self, x, draws):
        m, f = draws
        f = torch.where(m, f, 1).reshape(_bshape(x))
        mean = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
        return (x - mean) * f + mean


class Cutout(DeviceOp):
    """Zero a size x size box centred at a random pixel. Draws: (mask,
    centre row [N], centre column [N])."""

    def __init__(self, size: int = 8, p: float = 0.5,
                 data_format: str = "NHWC"):
        self.size, self.p = int(size), float(p)
        self.data_format = data_format
        self.axes = _hw_axes(data_format)

    def draw(self, x, gen):
        n, (ha, wa) = x.shape[0], self.axes
        return (_mask(gen, n, self.p, x.device),
                torch.randint(0, x.shape[ha], (n,), generator=gen,
                              device=x.device),
                torch.randint(0, x.shape[wa], (n,), generator=gen,
                              device=x.device))

    def apply(self, x, draws):
        m, cy, cx = draws
        ha, wa = self.axes
        half = self.size // 2
        iy = torch.arange(x.shape[ha], device=x.device)
        ix = torch.arange(x.shape[wa], device=x.device)
        in_y = (iy[None] >= (cy - half)[:, None]) & (iy[None] < (cy + half)[:, None])
        in_x = (ix[None] >= (cx - half)[:, None]) & (ix[None] < (cx + half)[:, None])
        box = in_y[:, :, None] & in_x[:, None, :] & m[:, None, None]
        box = box.unsqueeze(1 if self.data_format == "NCHW" else 3)
        return torch.where(box, torch.zeros((), dtype=x.dtype,
                                            device=x.device), x)


class GaussianNoise(DeviceOp):
    """Add std * N(0, 1) noise per sample. Draws: (mask, standard normal of
    the batch's shape)."""

    def __init__(self, std: float = 0.05, p: float = 0.5):
        self.std, self.p = float(std), float(p)

    def draw(self, x, gen):
        return (_mask(gen, x.shape[0], self.p, x.device),
                torch.randn(x.shape, generator=gen, device=x.device,
                            dtype=x.dtype))

    def apply(self, x, draws):
        m, z = draws
        return x + torch.where(m.reshape(_bshape(x)), self.std * z, 0)


class _Flip(DeviceOp):
    """Flip along one spatial axis per sample. Draws: (mask,)."""

    def __init__(self, p: float = 0.5, data_format: str = "NHWC"):
        self.p = float(p)
        self.axis = _hw_axes(data_format)[self._which]

    def draw(self, x, gen):
        return (_mask(gen, x.shape[0], self.p, x.device),)

    def apply(self, x, draws):
        (m,) = draws
        return torch.where(m.reshape(_bshape(x)), torch.flip(x, (self.axis,)),
                           x)


class HorizontalFlip(_Flip):
    _which = 1


class VerticalFlip(_Flip):
    _which = 0


class Normalization(DeviceOp):
    """Per-channel (x - mean) / std, always applied; no draws. The
    constants reach the device once per (device, dtype)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 data_format: str = "NHWC"):
        self.mean, self.std = list(mean), list(std)
        self.data_format = data_format
        _hw_axes(data_format)
        self._consts = {}

    def apply(self, x, draws):
        k = (x.device, x.dtype)
        if k not in self._consts:
            self._consts[k] = (to_device(self.mean, x.device, x.dtype),
                               to_device(self.std, x.device, x.dtype))
        mean, std = self._consts[k]
        if self.data_format == "NCHW":
            return (x - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)
        return (x - mean) / std


class RandomCrop(DeviceOp):
    """Zero-pad by ``padding``, then crop back at a random offset per
    sample (the centre where the mask is off). Draws: (mask, row offset
    [N], column offset [N]), offsets in [0, 2 padding]."""

    def __init__(self, padding: int = 4, p: float = 1.0,
                 data_format: str = "NHWC"):
        self.padding, self.p = int(padding), float(p)
        self.data_format = data_format
        self.axes = _hw_axes(data_format)

    def draw(self, x, gen):
        n, hi = x.shape[0], 2 * self.padding + 1
        return (_mask(gen, n, self.p, x.device),
                torch.randint(0, hi, (n,), generator=gen, device=x.device),
                torch.randint(0, hi, (n,), generator=gen, device=x.device))

    def apply(self, x, draws):
        m, oy, ox = draws
        pad = self.padding
        oy = torch.where(m, oy, pad)
        ox = torch.where(m, ox, pad)
        nhwc = x if self.data_format == "NHWC" else x.permute(0, 2, 3, 1)
        n, h, w = nhwc.shape[:3]
        padded = torch.nn.functional.pad(nhwc, (0, 0, pad, pad, pad, pad))
        rows = oy[:, None] + torch.arange(h, device=x.device)
        cols = ox[:, None] + torch.arange(w, device=x.device)
        out = padded[torch.arange(n, device=x.device)[:, None, None],
                     rows[:, :, None], cols[:, None, :]]
        if self.data_format == "NCHW":
            out = out.permute(0, 3, 1, 2)
        return out.contiguous()


class Rotation(DeviceOp):
    """Rotate each sample about its centre by an angle in [-max_degrees,
    max_degrees]: output (y, x) samples the input at R(-theta) (y - c, x -
    c) + c, clamped to the edges, bilinear. Draws: (mask, degrees [N],
    float32)."""

    def __init__(self, max_degrees: float = 15.0, p: float = 0.5,
                 data_format: str = "NHWC"):
        self.max_degrees, self.p = float(max_degrees), float(p)
        self.data_format = data_format
        self.axes = _hw_axes(data_format)

    def draw(self, x, gen):
        n = x.shape[0]
        return (_mask(gen, n, self.p, x.device),
                _uniform(gen, n, -self.max_degrees, self.max_degrees,
                         torch.float32, x.device))

    def apply(self, x, draws):
        m, deg = draws
        ha, wa = self.axes
        h, w = x.shape[ha], x.shape[wa]
        theta = torch.where(m, deg, 0.0) * (math.pi / 180.0)
        cos = torch.cos(theta)[:, None, None]
        sin = torch.sin(theta)[:, None, None]
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
        xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
        sy = (cos * (yy - cy) - sin * (xx - cx) + cy).clamp(0.0, h - 1)
        sx = (sin * (yy - cy) + cos * (xx - cx) + cx).clamp(0.0, w - 1)
        # the four neighbours of each source point, clamped to the edges
        # (mode "nearest"), weighted by the distance to the lower one
        y0f, x0f = torch.floor(sy), torch.floor(sx)
        wy1, wx1 = sy - y0f, sx - x0f
        wy0, wx0 = 1.0 - wy1, 1.0 - wx1
        y0 = y0f.long().clamp(0, h - 1)
        x0 = x0f.long().clamp(0, w - 1)
        y1 = (y0f.long() + 1).clamp(0, h - 1)
        x1 = (x0f.long() + 1).clamp(0, w - 1)
        # planes as [N, C, H*W] in float32
        planes = x if self.data_format == "NCHW" else x.permute(0, 3, 1, 2)
        n, c = planes.shape[:2]
        flat = planes.reshape(n, c, h * w).float()

        def at(iy, ix):
            idx = (iy * w + ix).reshape(n, 1, h * w).expand(n, c, h * w)
            return torch.gather(flat, 2, idx).reshape(n, c, h, w)

        def wt(a, b):
            return (a * b)[:, None]

        out = (wt(wy0, wx0) * at(y0, x0) + wt(wy0, wx1) * at(y0, x1)
               + wt(wy1, wx0) * at(y1, x0) + wt(wy1, wx1) * at(y1, x1))
        out = out.to(x.dtype)
        if self.data_format == "NHWC":
            out = out.permute(0, 2, 3, 1)
        return out.contiguous()


def brightness(delta: float = 0.2, p: float = 0.5) -> Brightness:
    return Brightness(delta, p)


def contrast(lower: float = 0.8, upper: float = 1.2,
             p: float = 0.5) -> Contrast:
    return Contrast(lower, upper, p)


def cutout(size: int = 8, p: float = 0.5, data_format: str = "NHWC") -> Cutout:
    return Cutout(size, p, data_format)


def gaussian_noise(std: float = 0.05, p: float = 0.5) -> GaussianNoise:
    return GaussianNoise(std, p)


def horizontal_flip(p: float = 0.5,
                    data_format: str = "NHWC") -> HorizontalFlip:
    return HorizontalFlip(p, data_format)


def vertical_flip(p: float = 0.5, data_format: str = "NHWC") -> VerticalFlip:
    return VerticalFlip(p, data_format)


def normalization(mean: Sequence[float], std: Sequence[float],
                  data_format: str = "NHWC") -> Normalization:
    return Normalization(mean, std, data_format)


def random_crop(padding: int = 4, p: float = 1.0,
                data_format: str = "NHWC") -> RandomCrop:
    return RandomCrop(padding, p, data_format)


def rotation(max_degrees: float = 15.0, p: float = 0.5,
             data_format: str = "NHWC") -> Rotation:
    return Rotation(max_degrees, p, data_format)


class DeviceAugment:
    """Ordered augmentation pipeline: ``aug(batch, key)`` applies op ``i``
    with the key ``fold_in(key, i)``. Device twin of the host
    ``AugmentationStrategy``."""

    def __init__(self, ops: Optional[List[DeviceOp]] = None):
        self.ops: List[DeviceOp] = list(ops or [])

    def add(self, op: DeviceOp) -> "DeviceAugment":
        self.ops.append(op)
        return self

    def keys(self, key: int) -> List[int]:
        """Op ``i``'s key, ``fold_in(key, i)``, for every op."""
        return [fold_in(key, i) for i in range(len(self.ops))]

    def run(self, batch: torch.Tensor,
            gens: Sequence[torch.Generator]) -> torch.Tensor:
        """The ops in order, op ``i`` drawing from ``gens[i]``."""
        if len(gens) != len(self.ops):
            raise ValueError(f"{len(gens)} generators for {len(self.ops)} "
                             f"ops")
        for op, gen in zip(self.ops, gens):
            batch = op.run(batch, gen)
        return batch

    def __call__(self, batch: torch.Tensor, key: int) -> torch.Tensor:
        return self.run(batch, [generator(k, batch.device)
                                for k in self.keys(key)])


class DeviceAugmentBuilder:
    """Fluent construction, mirroring the host ``AugmentationBuilder``."""

    def __init__(self, data_format: str = "NHWC"):
        self._aug = DeviceAugment()
        self.data_format = data_format

    def brightness(self, delta: float = 0.2, p: float = 0.5):
        self._aug.add(Brightness(delta, p))
        return self

    def contrast(self, lower: float = 0.8, upper: float = 1.2, p: float = 0.5):
        self._aug.add(Contrast(lower, upper, p))
        return self

    def cutout(self, size: int = 8, p: float = 0.5):
        self._aug.add(Cutout(size, p, self.data_format))
        return self

    def gaussian_noise(self, std: float = 0.05, p: float = 0.5):
        self._aug.add(GaussianNoise(std, p))
        return self

    def horizontal_flip(self, p: float = 0.5):
        self._aug.add(HorizontalFlip(p, self.data_format))
        return self

    def vertical_flip(self, p: float = 0.5):
        self._aug.add(VerticalFlip(p, self.data_format))
        return self

    def normalization(self, mean: Sequence[float], std: Sequence[float]):
        self._aug.add(Normalization(mean, std, self.data_format))
        return self

    def random_crop(self, padding: int = 4, p: float = 1.0):
        self._aug.add(RandomCrop(padding, p, self.data_format))
        return self

    def rotation(self, max_degrees: float = 15.0, p: float = 0.5):
        self._aug.add(Rotation(max_degrees, p, self.data_format))
        return self

    def build(self) -> DeviceAugment:
        return self._aug
