"""Tiny-ImageNet trainers (counterpart of
``examples/tiny_imagenet_trainer.py``): MODEL=resnet18|resnet34|resnet50|
resnet9|cnn picks the model, TINY_IMAGENET_DIR the dataset root; AdamW
under a warm-up cosine schedule. Falls back to synthetic data at 64x64
when the dataset is absent.

    python -m dcnn_tpu_torch.examples.tiny_imagenet_trainer
"""

from ..data import (AugmentationBuilder, DeviceAugmentBuilder,
                    TinyImageNetDataLoader)
from ..models import create_model
from ..optim import AdamW, WarmupCosineAnnealing
from ..train import train_classification_model
from ..utils.env import get_env
from .common import loader_or_synthetic, prepare_input, setup


def main():
    cfg = setup("tiny_imagenet_trainer")
    depth = get_env("MODEL", "resnet18")
    model_name = (f"{depth}_tiny_imagenet" if not depth.startswith("cnn")
                  else "cnn_tiny_imagenet")
    aug = (AugmentationBuilder()
           .random_crop(4)
           .horizontal_flip(0.5)
           .build())

    def real():
        root = get_env("TINY_IMAGENET_DIR", "data/tiny-imagenet-200")
        train = TinyImageNetDataLoader(root, "train",
                                       batch_size=cfg.batch_size,
                                       seed=cfg.seed, augmentation=aug)
        val = TinyImageNetDataLoader(root, "val", batch_size=cfg.batch_size,
                                     shuffle=False)
        train.load_data()
        val.load_data()
        return train, val

    train_loader, val_loader = loader_or_synthetic(real, (3, 64, 64), 200,
                                                   cfg)
    # RESIDENT=1: the whole split on the device, the same crop/flip there
    dev_aug = (DeviceAugmentBuilder("NCHW")
               .random_crop(4).horizontal_flip(0.5).build())
    train_loader, val_loader = prepare_input(train_loader, val_loader, 200,
                                             cfg, device_augment=dev_aug)
    model = create_model(model_name)
    print(model.summary())
    sched = WarmupCosineAnnealing(cfg.learning_rate, warmup_steps=2,
                                  total_steps=cfg.epochs)
    _, trainer = train_classification_model(
        model, AdamW(cfg.learning_rate, weight_decay=1e-4),
        "softmax_crossentropy", train_loader, val_loader, config=cfg,
        scheduler=sched)
    return trainer.history


if __name__ == "__main__":
    main()
