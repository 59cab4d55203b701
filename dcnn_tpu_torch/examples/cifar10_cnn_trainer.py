"""CIFAR-10 VGG-style CNN trainer (counterpart of
``examples/cifar10_cnn_trainer.py``): ``cifar10_cnn_classifier_v2`` with
rotation, brightness, contrast, gaussian noise and random crop, Adam and
softmax cross-entropy. Falls back to synthetic data when the dataset is
absent.

    python -m dcnn_tpu_torch.examples.cifar10_cnn_trainer
"""

from ..data import AugmentationBuilder, CIFAR10DataLoader, DeviceAugmentBuilder
from ..models import create_cifar10_trainer_v2
from ..optim import Adam
from ..train import train_classification_model
from ..utils.env import get_env
from .common import loader_or_synthetic, prepare_input, setup


def main():
    cfg = setup("cifar10_cnn")
    aug = (AugmentationBuilder()
           .rotation(10.0, 0.3)
           .brightness(0.15, 0.3)
           .contrast(0.85, 1.15, 0.3)
           .gaussian_noise(0.05, 0.3)
           .random_crop(4, 0.4)
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
    # RESIDENT=1: the same recipe as device ops (rotation has none)
    dev_aug = (DeviceAugmentBuilder("NCHW")
               .brightness(0.15, 0.3).contrast(0.85, 1.15, 0.3)
               .gaussian_noise(0.05, 0.3).random_crop(4, 0.4).build())
    train_loader, val_loader = prepare_input(
        train_loader, val_loader, 10, cfg, device_augment=dev_aug)
    model = create_cifar10_trainer_v2()
    print(model.summary())
    _, trainer = train_classification_model(
        model, Adam(cfg.learning_rate), "softmax_crossentropy", train_loader,
        val_loader, config=cfg)
    return trainer.history


if __name__ == "__main__":
    main()
