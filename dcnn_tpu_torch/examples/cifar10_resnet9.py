"""CIFAR-10 ResNet-9 trainer (counterpart of ``examples/cifar10_resnet9.py``)
with random crop, horizontal flip and cutout, AdamW-style Adam and
OneCycleLR. Falls back to synthetic data when the dataset is absent.

    python -m dcnn_tpu_torch.examples.cifar10_resnet9
"""

from ..data import AugmentationBuilder, CIFAR10DataLoader, DeviceAugmentBuilder
from ..models import create_resnet9_cifar10
from ..optim import Adam, OneCycleLR
from ..train import train_classification_model
from ..utils.env import get_env
from .common import loader_or_synthetic, prepare_input, setup


def main():
    cfg = setup("cifar10_resnet9")
    aug = (AugmentationBuilder()
           .random_crop(4)
           .horizontal_flip(0.5)
           .cutout(8, 0.5)
           .build())

    def real():
        root = get_env("CIFAR10_DIR", "data/cifar-10-batches-bin")
        train = CIFAR10DataLoader(
            [f"{root}/data_batch_{i}.bin" for i in range(1, 6)],
            batch_size=cfg.batch_size, seed=cfg.seed, augmentation=aug)
        val = CIFAR10DataLoader(f"{root}/test_batch.bin",
                                batch_size=cfg.batch_size, shuffle=False)
        train.load_data()
        val.load_data()
        return train, val

    train_loader, val_loader = loader_or_synthetic(real, (3, 32, 32), 10, cfg)
    # RESIDENT=1: the crop/flip/cutout recipe as device ops
    dev_aug = (DeviceAugmentBuilder("NCHW")
               .random_crop(4).horizontal_flip(0.5).cutout(8, 0.5).build())
    train_loader, val_loader = prepare_input(
        train_loader, val_loader, 10, cfg, device_augment=dev_aug)
    model = create_resnet9_cifar10()
    print(model.summary())
    # the cycle in epochs (SCHEDULER_STEP=epoch, the default) or batches
    total = (cfg.epochs if cfg.scheduler_step == "epoch"
             else cfg.epochs * max(len(train_loader), 1))
    sched = OneCycleLR(max_lr=cfg.learning_rate, total_steps=total)
    _, trainer = train_classification_model(
        model, Adam(cfg.learning_rate, weight_decay=1e-4,
                    decouple_weight_decay=True),
        "softmax_crossentropy", train_loader, val_loader, config=cfg,
        scheduler=sched)
    return trainer.history


if __name__ == "__main__":
    main()
