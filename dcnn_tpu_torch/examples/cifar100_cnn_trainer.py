"""CIFAR-100 CNN trainer (counterpart of
``examples/cifar100_cnn_trainer.py``): the VGG-style CNN on the fine
labels, Adam, softmax cross-entropy, the best-val snapshot. Falls back to
synthetic data when the dataset is absent (fetch it with ``python -m
dcnn_tpu_torch.data.download --root data cifar100``).

    python -m dcnn_tpu_torch.examples.cifar100_cnn_trainer
"""

from ..data import CIFAR100DataLoader
from ..models import create_cnn_cifar100
from ..optim import Adam
from ..train import train_classification_model
from ..utils.env import get_env
from .common import loader_or_synthetic, prepare_input, setup


def main():
    cfg = setup("cifar100_cnn")

    def real():
        root = get_env("CIFAR100_DIR", "data/cifar-100-binary")
        train = CIFAR100DataLoader(f"{root}/train.bin", label_mode="fine",
                                   batch_size=cfg.batch_size, seed=cfg.seed)
        val = CIFAR100DataLoader(f"{root}/test.bin", label_mode="fine",
                                 batch_size=cfg.batch_size, shuffle=False)
        train.load_data()
        val.load_data()
        return train, val

    train_loader, val_loader = loader_or_synthetic(real, (3, 32, 32), 100,
                                                   cfg)
    train_loader, val_loader = prepare_input(
        train_loader, val_loader, 100, cfg)
    model = create_cnn_cifar100()
    print(model.summary())
    _, trainer = train_classification_model(
        model, Adam(cfg.learning_rate), "softmax_crossentropy", train_loader,
        val_loader, config=cfg)
    return trainer.history


if __name__ == "__main__":
    main()
