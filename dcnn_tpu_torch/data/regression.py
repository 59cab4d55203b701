"""Dataset-agnostic regression loader (counterpart of
``dcnn_tpu/data/regression.py``), numpy only.

Reference equivalent: ``RegressionDataLoader``
(``include/data_loading/regression_data_loader.hpp:14``) — the specialized
base for continuous-target datasets: feature/output counts, normalization
state, and per-column feature/target mean/std statistics. Here it is also a
concrete loader: it ingests in-memory arrays or a generic numeric CSV whose
trailing ``num_targets`` columns are the regression targets, which covers the
"any tabular regression set" role the reference leaves to subclasses.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .loader import BaseDataLoader


class RegressionDataLoader(BaseDataLoader):
    """Batches of (features f32 [N,F], targets f32 [N,T]) with optional
    per-column z-normalization of either side; stats are kept for
    de-normalization (reference ``get_feature_means/stds``,
    ``get_target_means/stds``)."""

    def __init__(self, features: Optional[np.ndarray] = None,
                 targets: Optional[np.ndarray] = None,
                 csv_path: Optional[str] = None, num_targets: int = 1,
                 normalize_features: bool = False,
                 normalize_targets: bool = True,
                 skip_header: Optional[bool] = None,
                 **kw):
        kw.setdefault("drop_last", False)
        super().__init__(**kw)
        if (features is None) == (csv_path is None):
            raise ValueError("pass exactly one of (features, targets) arrays "
                             "or csv_path")
        if features is not None and targets is None:
            raise ValueError("targets required when features are given")
        self._features_in = features
        self._targets_in = targets
        self.csv_path = csv_path
        self.skip_header = skip_header  # None = auto-sniff the first row
        self.num_targets = int(num_targets)
        self.normalize_features = bool(normalize_features)
        self.normalize_targets = bool(normalize_targets)
        self.feature_means: Optional[np.ndarray] = None
        self.feature_stds: Optional[np.ndarray] = None
        self.target_means: Optional[np.ndarray] = None
        self.target_stds: Optional[np.ndarray] = None

    # -- reference accessor surface (regression_data_loader.hpp:20-43) --
    @property
    def num_features(self) -> int:
        self._ensure_loaded()
        return self._x.shape[1]

    @property
    def num_outputs(self) -> int:
        self._ensure_loaded()
        return self._y.shape[1]

    @property
    def is_normalized(self) -> bool:
        return self.target_means is not None or self.feature_means is not None

    def load_data(self) -> None:
        if self._features_in is not None:
            x = np.asarray(self._features_in, np.float32)
            y = np.asarray(self._targets_in, np.float32)
        else:
            x, y = self._load_csv()
        if y.ndim == 1:
            y = y[:, None]
        if x.ndim != 2 or len(x) != len(y):
            raise ValueError(f"bad regression shapes {x.shape} / {y.shape}")
        self._finalize(x, y)

    def _load_csv(self):
        if not os.path.isfile(self.csv_path):
            raise FileNotFoundError(self.csv_path)
        skip = (self._csv_has_header() if self.skip_header is None
                else self.skip_header)
        data = np.genfromtxt(self.csv_path, delimiter=",",
                             skip_header=1 if skip else 0,
                             dtype=np.float32)
        if data.ndim == 1:
            data = data[None, :]
        if data.shape[1] <= self.num_targets:
            raise ValueError(f"{self.csv_path}: {data.shape[1]} columns cannot "
                             f"hold {self.num_targets} trailing targets")
        data = np.nan_to_num(data, nan=0.0)
        return data[:, :-self.num_targets], data[:, -self.num_targets:]

    def _csv_has_header(self) -> bool:
        with open(self.csv_path, "r", encoding="utf-8") as f:
            first = f.readline()
        try:
            [float(t) for t in first.strip().split(",") if t != ""]
            return False
        except ValueError:
            return True

    def _finalize(self, x: np.ndarray, y: np.ndarray) -> None:
        """Apply configured normalizations, record stats, publish arrays.
        Subclasses (e.g. the UJI WiFi loader) call this after their own
        feature construction."""
        if self.normalize_features:
            self.feature_means = x.mean(axis=0)
            self.feature_stds = x.std(axis=0) + 1e-8
            x = (x - self.feature_means) / self.feature_stds
        if self.normalize_targets:
            self.target_means = y.mean(axis=0)
            self.target_stds = y.std(axis=0) + 1e-8
            y = (y - self.target_means) / self.target_stds
        self._x = np.ascontiguousarray(x, np.float32)
        self._y = np.ascontiguousarray(y, np.float32)

    def denormalize_targets(self, y: np.ndarray) -> np.ndarray:
        if self.target_means is None:
            return y
        return y * self.target_stds + self.target_means

    def denormalize_features(self, x: np.ndarray) -> np.ndarray:
        if self.feature_means is None:
            return x
        return x * self.feature_stds + self.feature_means
