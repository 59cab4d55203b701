"""The host data path of the CNN trainers, held against the JAX package:
the synthetic loader, the nine augmentations and their builder, and the
MNIST, CIFAR and Tiny-ImageNet readers.

No dataset is in the repository, so each reader test writes its own small
files (a CSV, CIFAR ``.bin`` records, a two-class Tiny-ImageNet tree of
PNGs) under pytest's ``tmp_path``. Every comparison is exact: the same seed
and epoch give the same batches, bit for bit, from both packages.
"""

import numpy as np
import pytest

from dcnn_tpu.data import augment as jaug
from dcnn_tpu.data import (
    CIFAR10DataLoader as JaxCIFAR10, CIFAR100DataLoader as JaxCIFAR100,
    MNISTDataLoader as JaxMNIST, SyntheticClassificationLoader as JaxSynth,
    TinyImageNetDataLoader as JaxTiny,
)
from dcnn_tpu.data.loader import ArrayDataLoader as JaxArrayLoader
from dcnn_tpu_torch.data import (
    ArrayDataLoader, AugmentationBuilder, CIFAR10DataLoader,
    CIFAR100DataLoader, MNISTDataLoader, SyntheticClassificationLoader,
    TinyImageNetDataLoader,
)
from dcnn_tpu_torch.data import augment as aug

LAYOUTS = ("NCHW", "NHWC")


def _epochs(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.shuffle(e)
        out += [(x.copy(), y.copy()) for x, y in loader]
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _recipe(builder_cls, df):
    """The Tiny-ImageNet trainer's recipe."""
    return builder_cls(df).random_crop(4).horizontal_flip(0.5).build()


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("augmented", [False, True])
def test_synthetic_loader_matches_jax(df, augmented):
    """Same seed, same epochs: the same batches, with and without the
    trainer's augmentation recipe attached through the loader's hook."""
    shape = (3, 16, 16) if df == "NCHW" else (16, 16, 3)
    kw = dict(batch_size=8, seed=4)
    got = SyntheticClassificationLoader(
        40, shape, 7, augmentation=_recipe(AugmentationBuilder, df)
        if augmented else None, **kw)
    want = JaxSynth(40, shape, 7, augmentation=_recipe(
        jaug.AugmentationBuilder, df) if augmented else None, **kw)
    _same_batches(_epochs(got), _epochs(want))


def _ops(mod, df):
    return [mod.Brightness(0.3, 0.6), mod.Contrast(0.7, 1.3, 0.6, df),
            mod.Cutout(5, 0.6, df), mod.GaussianNoise(0.1, 0.6),
            mod.HorizontalFlip(0.5, df), mod.VerticalFlip(0.5, df),
            mod.Normalization([0.1, -0.2, 0.3], [1.5, 0.5, 2.0], df),
            mod.RandomCrop(3, 0.7, df), mod.Rotation(20.0, 0.6, df)]


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("i", range(9), ids=[
    "brightness", "contrast", "cutout", "gaussian_noise", "horizontal_flip",
    "vertical_flip", "normalization", "random_crop", "rotation"])
def test_each_augmentation_matches_jax(i, df):
    """Each op on the same batch from the same generator state: the same
    output and the same generator state after; the caller's batch is not
    written."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 3, 10, 12)).astype(np.float32)
    if df == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    x0 = x.copy()
    g_got, g_want = np.random.default_rng(12), np.random.default_rng(12)
    got = _ops(aug, df)[i](x, g_got)
    want = _ops(jaug, df)[i](x.copy(), g_want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x, x0)
    assert g_got.random() == g_want.random()


@pytest.mark.parametrize("df", LAYOUTS)
def test_builder_and_uint8_requantize_match_jax(df):
    """A uint8 loader with every builder op: augmented in float32 0..255,
    requantized (clip, round half to even) to uint8 by the loader, as the
    JAX loader does."""
    rng = np.random.default_rng(13)
    shape = (24, 3, 8, 8) if df == "NCHW" else (24, 8, 8, 3)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 24)]

    def recipe(b):
        return (b.brightness(20.0, 0.5).contrast(0.8, 1.2, 0.5).cutout(3, 0.5)
                .gaussian_noise(5.0, 0.5).horizontal_flip(0.5)
                .vertical_flip(0.5).normalization([1.0, 2.0, 3.0],
                                                  [1.0, 1.0, 1.0])
                .random_crop(2).rotation(10.0, 0.5).build())

    got = ArrayDataLoader(x, y, batch_size=8, seed=2,
                          augmentation=recipe(AugmentationBuilder(df)))
    want = JaxArrayLoader(x, y, batch_size=8, seed=2,
                          augmentation=recipe(jaug.AugmentationBuilder(df)))
    batches = _epochs(got)
    assert all(b.dtype == np.uint8 for b, _ in batches)
    _same_batches(batches, _epochs(want))


def _write_mnist(path, rng, n, fractional=False):
    labels = rng.integers(0, 10, n)
    pix = rng.integers(0, 256, size=(n, 784))
    with open(path, "w") as f:
        f.write("label," + ",".join(f"pixel{i}" for i in range(784)) + "\n")
        for lb, row in zip(labels, pix):
            vals = ([f"{v / 2:.1f}" for v in row] if fractional
                    else [str(v) for v in row])
            f.write(f"{lb}," + ",".join(vals) + "\n")


@pytest.mark.parametrize("df", LAYOUTS)
@pytest.mark.parametrize("fractional", [False, True])
def test_mnist_reader_matches_jax(tmp_path, df, fractional):
    """Integer pixels load as uint8 (scale 1/255), fractional ones as
    float32 times 1/255 (scale 1); the batches, augmented or not, equal the
    JAX reader's."""
    path = tmp_path / "mnist.csv"
    _write_mnist(path, np.random.default_rng(14), 20, fractional)
    for augmented in (False, True):
        def make(cls, builder):
            return cls(str(path), df, batch_size=6, seed=1, augmentation=(
                _recipe(builder, df) if augmented else None))
        got = make(MNISTDataLoader, AugmentationBuilder)
        want = make(JaxMNIST, jaug.AugmentationBuilder)
        _same_batches(_epochs(got), _epochs(want))
        assert got.wire_dtype == (np.float32 if fractional else np.uint8)
        assert got.scale == want.scale


def _write_cifar(path, rng, n, label_bytes):
    """Records of ``label_bytes`` labels (each below 10) and 3072 pixels."""
    labels = rng.integers(0, 10, size=(n, label_bytes), dtype=np.uint8)
    pix = rng.integers(0, 256, size=(n, 3072), dtype=np.uint8)
    np.concatenate([labels, pix], axis=1).tofile(path)


@pytest.mark.parametrize("df", LAYOUTS)
def test_cifar_readers_match_jax(tmp_path, df):
    """CIFAR-10 over two files, CIFAR-100 with fine and coarse labels: the
    same uint8 batches, augmented and not, as the JAX readers; a file that
    is not whole records is refused."""
    rng = np.random.default_rng(15)
    files10 = [str(tmp_path / f"data_batch_{i}.bin") for i in (1, 2)]
    for f in files10:
        _write_cifar(f, rng, 9, 1)
    f100 = str(tmp_path / "train.bin")
    _write_cifar(f100, rng, 14, 2)
    cases = [(CIFAR10DataLoader, JaxCIFAR10, files10, {}),
             (CIFAR100DataLoader, JaxCIFAR100, f100, {"label_mode": "fine"}),
             (CIFAR100DataLoader, JaxCIFAR100, f100,
              {"label_mode": "coarse"})]
    for cls, jcls, files, extra in cases:
        for augmented in (False, True):
            def make(c, builder):
                return c(files, df, batch_size=4, seed=3, augmentation=(
                    _recipe(builder, df) if augmented else None), **extra)
            got = make(cls, AugmentationBuilder)
            _same_batches(_epochs(got),
                          _epochs(make(jcls, jaug.AugmentationBuilder)))
            assert got.NUM_CLASSES == make(jcls, jaug.AugmentationBuilder
                                           ).NUM_CLASSES
    bad = tmp_path / "bad.bin"
    np.zeros(3073 + 5, np.uint8).tofile(bad)
    with pytest.raises(ValueError, match="not a multiple"):
        CIFAR10DataLoader(str(bad)).load_data()


def _write_tiny(root, rng):
    """A two-class Tiny-ImageNet tree: 5 and 4 train PNGs, 3 val PNGs."""
    from PIL import Image

    wnids = ["n02", "n01"]
    (root / "wnids.txt").write_text("\n".join(wnids) + "\n")
    (root / "words.txt").write_text("n01\tcat\nn02\tdog\n")
    for wnid, n in zip(wnids, (5, 4)):
        d = root / "train" / wnid / "images"
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
                d / f"{wnid}_{i}.png")
    vd = root / "val" / "images"
    vd.mkdir(parents=True)
    lines = []
    for i, wnid in enumerate(("n01", "n02", "n01")):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
            vd / f"val_{i}.png")
        lines.append(f"val_{i}.png\t{wnid}\t0\t0\t63\t63")
    (root / "val" / "val_annotations.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("df", LAYOUTS)
def test_tiny_imagenet_reader_matches_jax(tmp_path, df):
    """Train and val splits of a written tree: the same uint8 batches as
    the JAX reader, augmented and not; the port's cache (``.npz`` beside
    the data) is written once and gives the same batches when read back."""
    root = tmp_path / "tiny"
    root.mkdir()
    _write_tiny(root, np.random.default_rng(16))
    for split in ("train", "val"):
        for augmented in (False, True):
            def make(cls, builder, cache):
                return cls(str(root), split, df, cache=cache, batch_size=2,
                           seed=5, augmentation=(_recipe(builder, df)
                                                 if augmented else None))
            want = _epochs(make(JaxTiny, jaug.AugmentationBuilder, False))
            got = make(TinyImageNetDataLoader, AugmentationBuilder, True)
            _same_batches(_epochs(got), want)
            assert got.wire_dtype == np.uint8 and got.scale == 1 / 255
            cached = make(TinyImageNetDataLoader, AugmentationBuilder, True)
            _same_batches(_epochs(cached), want)
        assert (root / f"_dcnn_cache_{split}.npz").is_file()
    fresh = TinyImageNetDataLoader(str(root), "train", cache=False)
    fresh.load_data()
    assert fresh.class_names == {"n01": "cat", "n02": "dog"}
    assert fresh.wnid_to_idx == {"n01": 0, "n02": 1}
