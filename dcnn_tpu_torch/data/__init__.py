"""Data loading, augmentation, the uint8 wire decode and the device feeds
(counterpart of ``dcnn_tpu/data``): the array, synthetic, regression and
WiFi loaders, the MNIST, CIFAR and Tiny-ImageNet readers, the digits28
CSVs, the host and device augmentations, the device-resident dataset,
``PrefetchLoader``, the transfer engine, the streaming feed and the feed
worker pool, and the data-parallel resident feed
(``ShardedDeviceDataset``, ``make_resident_epoch_dp``,
``resident_epoch_dp``, ``stage_sharded``)."""

from .augment import (
    AugmentationBuilder, AugmentationStrategy, brightness, contrast, cutout,
    gaussian_noise, horizontal_flip, normalization, random_crop, rotation,
    vertical_flip,
)
from .augment_device import DeviceAugment, DeviceAugmentBuilder
from .cifar import CIFAR10DataLoader, CIFAR100DataLoader
from .device_dataset import (
    DeviceDataset, ShardedDeviceDataset, make_resident_epoch,
    make_resident_epoch_dp, make_resident_eval, resident_epoch,
    resident_epoch_dp, resident_eval, stage_sharded,
)
from .digits28 import ensure_digits28_csvs
from .loader import ArrayDataLoader, BaseDataLoader, one_hot
from .mnist import MNISTDataLoader
from .prefetch import PrefetchLoader
from .regression import RegressionDataLoader
from .streaming import (
    StreamingDeviceDataset, make_shard_step, train_streaming_epoch,
)
from .synthetic import SyntheticClassificationLoader
from .tiny_imagenet import TinyImageNetDataLoader
from .transfer import TransferEngine, chunk_bounds, max_inflight
from .wifi import UJIWiFiDataLoader
from .wire import (
    WIRE_SCALE_U8, decode_batch, decode_host, default_decode_transform,
    wire_scale,
)
from .workers import (
    FeedWorkerPool, LocalSlots, PreparedShard, ShmSlots, prepare_shard,
    serial_shards, shard_rng,
)

__all__ = [
    "BaseDataLoader", "ArrayDataLoader", "one_hot",
    "MNISTDataLoader", "CIFAR10DataLoader", "CIFAR100DataLoader",
    "TinyImageNetDataLoader", "RegressionDataLoader", "UJIWiFiDataLoader",
    "SyntheticClassificationLoader", "ensure_digits28_csvs",
    "PrefetchLoader",
    "WIRE_SCALE_U8", "decode_batch", "decode_host",
    "default_decode_transform", "wire_scale",
    "StreamingDeviceDataset", "make_shard_step", "train_streaming_epoch",
    "TransferEngine", "chunk_bounds", "max_inflight",
    "FeedWorkerPool", "LocalSlots", "PreparedShard", "ShmSlots",
    "prepare_shard", "serial_shards", "shard_rng",
    "AugmentationStrategy", "AugmentationBuilder",
    "brightness", "contrast", "cutout", "gaussian_noise", "horizontal_flip",
    "vertical_flip", "normalization", "random_crop", "rotation",
    "DeviceAugment", "DeviceAugmentBuilder",
    "DeviceDataset", "ShardedDeviceDataset", "make_resident_epoch",
    "make_resident_epoch_dp", "make_resident_eval", "resident_epoch",
    "resident_epoch_dp", "resident_eval", "stage_sharded",
]
