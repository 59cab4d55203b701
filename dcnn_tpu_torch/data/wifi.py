"""UJIIndoorLoc WiFi RSSI regression loader (counterpart of
``dcnn_tpu/data/wifi.py``), numpy only.

Reference equivalent: the UJI indoor-positioning CSV loader
(``include/data_loading/wifi_data_loader.hpp:27-461``): RSSI feature columns
where the sentinel 100 (and raw 0) means "not detected" and is remapped to
−100 dBm (:107-112), regression targets are the trailing longitude/latitude
columns (:92-98), with per-column target mean/std normalization stored for
de-normalization (:43-44).
"""

from __future__ import annotations

import csv
import os
import numpy as np

from .regression import RegressionDataLoader

NOT_DETECTED = -100.0


class UJIWiFiDataLoader(RegressionDataLoader):
    """WiFi RSSI → position; extends the generic RegressionDataLoader the
    same way the reference's WifiDataLoader extends RegressionDataLoader
    (``regression_data_loader.hpp:14`` → ``wifi_data_loader.hpp:27``)."""

    def __init__(self, csv_path: str, num_targets: int = 2,
                 normalize_targets: bool = True, **kw):
        super().__init__(csv_path=csv_path, num_targets=num_targets,
                         normalize_targets=normalize_targets, **kw)

    def load_data(self) -> None:
        if not os.path.isfile(self.csv_path):
            raise FileNotFoundError(self.csv_path)
        rows = []
        with open(self.csv_path, "r", encoding="utf-8") as f:
            reader = csv.reader(f)
            header = next(reader, None)
            for row in reader:
                if row:
                    rows.append(row)
        if not rows:
            raise ValueError(f"{self.csv_path}: empty")
        ncols = len(rows[0])
        feat_end = ncols - self.num_targets

        feats = np.empty((len(rows), feat_end), np.float32)
        targets = np.empty((len(rows), self.num_targets), np.float32)
        for i, row in enumerate(rows):
            for j in range(feat_end):
                try:
                    v = float(row[j])
                except ValueError:
                    v = NOT_DETECTED
                # sentinel remap (wifi_data_loader.hpp:107-112)
                if v == 100.0 or v == 0.0:
                    v = NOT_DETECTED
                feats[i, j] = v
            for j in range(self.num_targets):
                try:
                    targets[i, j] = float(row[feat_end + j])
                except ValueError:
                    targets[i, j] = 0.0

        # scale RSSI into [0,1]-ish range: (-100..0 dBm) → (0..1)
        feats = (feats - NOT_DETECTED) / (-NOT_DETECTED)
        self._finalize(feats, targets)
