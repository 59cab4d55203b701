"""MNIST CNN trainer (counterpart of ``examples/mnist_cnn_trainer.py``).

Env: MNIST_TRAIN_CSV / MNIST_TEST_CSV point at the CSV files; every
TrainingConfig variable (EPOCHS, BATCH_SIZE, DEVICE_TYPE, ...) is honoured.
Falls back to synthetic data when the dataset is absent.

    python -m dcnn_tpu_torch.examples.mnist_cnn_trainer
"""

from ..data import MNISTDataLoader
from ..models import create_mnist_trainer
from ..optim import Adam
from ..train import train_classification_model
from ..utils.env import get_env
from .common import loader_or_synthetic, prepare_input, setup


def main():
    cfg = setup("mnist_cnn_trainer")

    def real():
        train = MNISTDataLoader(get_env("MNIST_TRAIN_CSV",
                                        "data/mnist/train.csv"),
                                batch_size=cfg.batch_size, seed=cfg.seed)
        val = MNISTDataLoader(get_env("MNIST_TEST_CSV", "data/mnist/test.csv"),
                              batch_size=cfg.batch_size, shuffle=False)
        train.load_data()
        val.load_data()
        return train, val

    train_loader, val_loader = loader_or_synthetic(real, (1, 28, 28), 10, cfg)
    # RESIDENT=1 stages the split on the device (an epoch a resident loop)
    train_loader, val_loader = prepare_input(
        train_loader, val_loader, 10, cfg)
    model = create_mnist_trainer()
    print(model.summary())
    _, trainer = train_classification_model(
        model, Adam(cfg.learning_rate), "softmax_crossentropy", train_loader,
        val_loader, config=cfg)
    return trainer.history


if __name__ == "__main__":
    main()
