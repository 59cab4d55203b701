"""Host data augmentation (counterpart of ``dcnn_tpu/data/augment.py``).

The nine batch transforms (brightness, contrast, cutout, Gaussian noise,
horizontal and vertical flip, normalization, random crop, rotation), the
``AugmentationStrategy`` pipeline and the ``AugmentationBuilder`` fluent
API, as vectorized numpy over NCHW or NHWC float32 batches. A loader runs
them per batch through its ``augmentation`` hook, continuing the epoch's
generator after the shuffle (``data/loader.py``); on a uint8 loader the
hook's output is requantized (clip, round half to even, cast).

Each op draws from its ``np.random.Generator`` in the JAX op's order and
computes what it computes, so the same generator state gives the JAX
package's batch bit for bit. An op never writes into the caller's batch: it
returns the input itself when no sample is selected and a new array
otherwise. Ops are module-level classes, so a strategy pickles.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

BatchFn = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def _hw_axes(data_format: str) -> Tuple[int, int]:
    return (2, 3) if data_format == "NCHW" else (1, 2)


def _mask(rng: np.random.Generator, n: int, p: float) -> np.ndarray:
    return rng.random(n) < p


def _per_sample(v: np.ndarray, ndim: int) -> np.ndarray:
    return v.reshape(-1, *([1] * (ndim - 1)))


class Brightness:
    """Add a shift in [-delta, delta] to each selected image. Draws: the
    mask, then one shift per image."""

    def __init__(self, delta: float = 0.2, p: float = 0.5):
        self.delta = float(delta)
        self.p = float(p)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        m = _mask(rng, len(x), self.p)
        shifts = rng.uniform(-self.delta, self.delta,
                             size=(len(x),)).astype(np.float32)
        return x + _per_sample(np.where(m, shifts, 0.0), x.ndim)


class Contrast:
    """Scale each selected image around its mean by a factor in [lower,
    upper]. Draws: the mask, then one factor per image."""

    def __init__(self, lower: float = 0.8, upper: float = 1.2, p: float = 0.5,
                 data_format: str = "NCHW"):
        self.lower = float(lower)
        self.upper = float(upper)
        self.p = float(p)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        m = _mask(rng, len(x), self.p)
        factors = rng.uniform(self.lower, self.upper,
                              size=(len(x),)).astype(np.float32)
        factors = _per_sample(np.where(m, factors, 1.0), x.ndim)
        mean = x.mean(axis=tuple(range(1, x.ndim)), keepdims=True)
        return (x - mean) * factors + mean


class Cutout:
    """Zero a size×size square around a random center of each selected
    image. Draws per image: a gate, then (gate passed) the center row and
    column."""

    def __init__(self, size: int = 8, p: float = 0.5,
                 data_format: str = "NCHW"):
        self.size = int(size)
        self.p = float(p)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        ha, wa = _hw_axes(self.data_format)
        h, w = x.shape[ha], x.shape[wa]
        half = self.size // 2
        out = None
        for i in range(len(x)):
            if rng.random() >= self.p:
                continue
            if out is None:
                out = x.copy()
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            rows = slice(max(0, cy - half), min(h, cy + half))
            cols = slice(max(0, cx - half), min(w, cx + half))
            if self.data_format == "NCHW":
                out[i, :, rows, cols] = 0.0
            else:
                out[i, rows, cols, :] = 0.0
        return x if out is None else out


class GaussianNoise:
    """Add N(0, std) noise to each selected image. Draws: the mask, then the
    noise of the whole batch."""

    def __init__(self, std: float = 0.05, p: float = 0.5):
        self.std = float(std)
        self.p = float(p)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        m = _per_sample(_mask(rng, len(x), self.p), x.ndim)
        noise = rng.normal(0.0, self.std, size=x.shape).astype(np.float32)
        return x + np.where(m, noise, 0.0)


class _Flip:
    """Mirror each selected image along one spatial axis. Draws: the mask."""

    vertical = False

    def __init__(self, p: float = 0.5, data_format: str = "NCHW"):
        self.p = float(p)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        axis = _hw_axes(self.data_format)[0 if self.vertical else 1]
        m = _mask(rng, len(x), self.p)
        if not m.any():
            return x
        out = x.copy()
        out[m] = np.flip(x[m], axis=axis)
        return out


class HorizontalFlip(_Flip):
    """Mirror left to right."""


class VerticalFlip(_Flip):
    """Mirror top to bottom."""

    vertical = True


class Normalization:
    """(x - mean) / std per channel, always applied; draws nothing."""

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 data_format: str = "NCHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.data_format == "NCHW":
            return ((x - self.mean.reshape(1, -1, 1, 1))
                    / self.std.reshape(1, -1, 1, 1))
        return (x - self.mean) / self.std


class RandomCrop:
    """Zero-pad by ``padding`` and crop back at a random offset. Draws: the
    mask, the row offsets, the column offsets (one batched draw each); the
    windows are gathered in one indexing of a sliding-window view."""

    def __init__(self, padding: int = 4, p: float = 1.0,
                 data_format: str = "NCHW"):
        self.padding = int(padding)
        self.p = float(p)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        ha, wa = _hw_axes(self.data_format)
        h, w = x.shape[ha], x.shape[wa]
        n, pad = len(x), self.padding
        m = _mask(rng, n, self.p)
        oy = rng.integers(0, 2 * pad + 1, size=n)
        ox = rng.integers(0, 2 * pad + 1, size=n)
        if not m.any():
            return x
        pad_spec = [(0, 0)] * x.ndim
        pad_spec[ha] = pad_spec[wa] = (pad, pad)
        win = np.lib.stride_tricks.sliding_window_view(
            np.pad(x, pad_spec), (h, w), axis=(ha, wa))
        idx = np.arange(n)
        if self.data_format == "NCHW":
            crops = win[idx, :, oy, ox]                       # (n, C, h, w)
        else:
            crops = np.moveaxis(win[idx, oy, ox], 1, -1)      # (n, h, w, C)
        out = x.copy()
        out[m] = crops[m]
        return out


class Rotation:
    """Rotate each selected image by an angle in [-max, max] degrees
    (bilinear, edges repeated; ``scipy.ndimage``). Draws per image: a gate,
    then (gate passed) the angle."""

    def __init__(self, max_degrees: float = 15.0, p: float = 0.5,
                 data_format: str = "NCHW"):
        self.max_degrees = float(max_degrees)
        self.p = float(p)
        self.data_format = data_format

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        from scipy import ndimage
        ha, wa = _hw_axes(self.data_format)
        out = None
        for i in range(len(x)):
            if rng.random() >= self.p:
                continue
            if out is None:
                out = x.copy()
            deg = float(rng.uniform(-self.max_degrees, self.max_degrees))
            out[i] = ndimage.rotate(x[i], deg, axes=(ha - 1, wa - 1),
                                    reshape=False, order=1, mode="nearest")
        return x if out is None else out


brightness = Brightness
contrast = Contrast
cutout = Cutout
gaussian_noise = GaussianNoise
horizontal_flip = HorizontalFlip
vertical_flip = VerticalFlip
normalization = Normalization
random_crop = RandomCrop
rotation = Rotation


class AugmentationStrategy:
    """Ordered pipeline of batch transforms, each continuing one
    generator."""

    def __init__(self, ops: Optional[List[BatchFn]] = None):
        self.ops: List[BatchFn] = list(ops or [])

    def add(self, op: BatchFn) -> "AugmentationStrategy":
        self.ops.append(op)
        return self

    def __call__(self, batch: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        for op in self.ops:
            batch = op(batch, rng)
        return batch


class AugmentationBuilder:
    """Fluent construction of an :class:`AugmentationStrategy`; the image
    ops take the builder's ``data_format``."""

    def __init__(self, data_format: str = "NCHW"):
        self._strategy = AugmentationStrategy()
        self.data_format = data_format

    def _add(self, op: BatchFn) -> "AugmentationBuilder":
        self._strategy.add(op)
        return self

    def brightness(self, delta: float = 0.2, p: float = 0.5):
        return self._add(Brightness(delta, p))

    def contrast(self, lower: float = 0.8, upper: float = 1.2, p: float = 0.5):
        return self._add(Contrast(lower, upper, p, self.data_format))

    def cutout(self, size: int = 8, p: float = 0.5):
        return self._add(Cutout(size, p, self.data_format))

    def gaussian_noise(self, std: float = 0.05, p: float = 0.5):
        return self._add(GaussianNoise(std, p))

    def horizontal_flip(self, p: float = 0.5):
        return self._add(HorizontalFlip(p, self.data_format))

    def vertical_flip(self, p: float = 0.5):
        return self._add(VerticalFlip(p, self.data_format))

    def normalization(self, mean: Sequence[float], std: Sequence[float]):
        return self._add(Normalization(mean, std, self.data_format))

    def random_crop(self, padding: int = 4, p: float = 1.0):
        return self._add(RandomCrop(padding, p, self.data_format))

    def rotation(self, max_degrees: float = 15.0, p: float = 0.5):
        return self._add(Rotation(max_degrees, p, self.data_format))

    def build(self) -> AugmentationStrategy:
        return self._strategy
