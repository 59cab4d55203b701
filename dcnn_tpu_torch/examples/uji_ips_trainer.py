"""UJI indoor-positioning regression trainer (counterpart of
``examples/uji_ips_trainer.py``): an MLP over the WiFi RSSI features to
longitude and latitude, Huber loss. Falls back to synthetic RSSI data when
the dataset is absent.

    python -m dcnn_tpu_torch.examples.uji_ips_trainer
"""

import numpy as np

from ..data import UJIWiFiDataLoader
from ..data.loader import ArrayDataLoader
from ..nn import SequentialBuilder
from ..optim import Adam
from ..train import train_regression_model
from ..utils.env import get_env
from .common import setup


def build_model(num_features: int, num_outputs: int = 2):
    return (SequentialBuilder("uji_ips_mlp")
            .input((num_features,))
            .dense(512).activation("relu").dropout(0.2)
            .dense(256).activation("relu").dropout(0.2)
            .dense(128).activation("relu")
            .dense(num_outputs)
            .build())


def main():
    cfg = setup("uji_ips_trainer")
    path = get_env("UJI_CSV", "data/uji/trainingData.csv")
    try:
        loader = UJIWiFiDataLoader(path, batch_size=cfg.batch_size,
                                   seed=cfg.seed)
        loader.load_data()
        x, y = loader._x, loader._y
    except (FileNotFoundError, OSError):
        print("dataset unavailable; using synthetic RSSI data")
        rng = np.random.default_rng(cfg.seed)
        x = rng.random((2048, 520)).astype(np.float32)
        w = rng.normal(size=(520, 2)).astype(np.float32)
        y = (x @ w + rng.normal(scale=0.01, size=(2048, 2))).astype(np.float32)
        y = (y - y.mean(0)) / (y.std(0) + 1e-8)

    n = len(x)
    split = int(n * 0.9)
    train = ArrayDataLoader(x[:split], y[:split], batch_size=cfg.batch_size,
                            seed=cfg.seed)
    val = ArrayDataLoader(x[split:], y[split:], batch_size=cfg.batch_size,
                          shuffle=False, drop_last=False)
    model = build_model(x.shape[1], y.shape[1])
    print(model.summary())
    _, history = train_regression_model(model, Adam(cfg.learning_rate),
                                        "huber", train, val, config=cfg)
    return history


if __name__ == "__main__":
    main()
