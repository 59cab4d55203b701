"""Host data loading, augmentation and the uint8 wire decode (counterpart of
``dcnn_tpu/data``): the array and synthetic loaders, the MNIST, CIFAR and
Tiny-ImageNet readers, the digits28 CSVs, and the host augmentations."""

from .augment import (
    AugmentationBuilder, AugmentationStrategy, brightness, contrast, cutout,
    gaussian_noise, horizontal_flip, normalization, random_crop, rotation,
    vertical_flip,
)
from .cifar import CIFAR10DataLoader, CIFAR100DataLoader
from .digits28 import ensure_digits28_csvs
from .loader import ArrayDataLoader, BaseDataLoader, one_hot
from .mnist import MNISTDataLoader
from .synthetic import SyntheticClassificationLoader
from .tiny_imagenet import TinyImageNetDataLoader
from .wire import WIRE_SCALE_U8, decode_batch, wire_scale

__all__ = ["BaseDataLoader", "ArrayDataLoader", "one_hot",
           "SyntheticClassificationLoader", "MNISTDataLoader",
           "CIFAR10DataLoader", "CIFAR100DataLoader",
           "TinyImageNetDataLoader", "ensure_digits28_csvs",
           "AugmentationStrategy", "AugmentationBuilder", "brightness",
           "contrast", "cutout", "gaussian_noise", "horizontal_flip",
           "vertical_flip", "normalization", "random_crop", "rotation",
           "WIRE_SCALE_U8", "decode_batch", "wire_scale"]
