"""Tiny-ImageNet-200 reader (counterpart of
``dcnn_tpu/data/tiny_imagenet.py``).

``wnids.txt`` names the classes (sorted, index = label), ``words.txt`` their
names; the train split is ``train/<wnid>/images/*``, the val split
``val/images`` labelled by ``val/val_annotations.txt``. Images decode with
PIL (imported when first needed) to RGB uint8 3×64×64, the wire dtype: the
consumer decodes with the loader's ``scale`` (1/255). The decoded split can
be kept as an ``.npz`` beside the dataset (``cache``) so a later run skips
the decode.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .loader import BaseDataLoader, one_hot


def _decode_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)  # HWC


def _decode_many(paths: List[str]) -> List[np.ndarray]:
    """Decode in order, on a thread pool for many images (the decoder
    releases the GIL)."""
    if len(paths) < 64:
        return [_decode_image(p) for p in paths]
    workers = min(32, max(2, os.cpu_count() or 2))
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_decode_image, paths))


class TinyImageNetDataLoader(BaseDataLoader):
    NUM_CLASSES = 200

    def __init__(self, root: str, split: str = "train",
                 data_format: str = "NCHW", cache: bool = True,
                 max_per_class: Optional[int] = None, **kw):
        super().__init__(**kw)
        if split not in ("train", "val"):
            raise ValueError("split must be 'train' or 'val'")
        self.root = root
        self.split = split
        self.data_format = data_format
        self.cache = cache
        self.max_per_class = max_per_class
        self.wnid_to_idx: Dict[str, int] = {}
        self.class_names: Dict[str, str] = {}

    def _load_wnids(self) -> None:
        with open(os.path.join(self.root, "wnids.txt"), encoding="utf-8") as f:
            wnids = [line.strip() for line in f if line.strip()]
        self.wnid_to_idx = {w: i for i, w in enumerate(sorted(wnids))}
        words = os.path.join(self.root, "words.txt")
        if os.path.isfile(words):
            with open(words, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2 and parts[0] in self.wnid_to_idx:
                        self.class_names[parts[0]] = parts[1]

    def _cache_path(self) -> str:
        suffix = f"_{self.max_per_class}" if self.max_per_class else ""
        return os.path.join(self.root,
                            f"_dcnn_cache_{self.split}{suffix}.npz")

    def load_data(self) -> None:
        cache_path = self._cache_path()
        if self.cache and os.path.isfile(cache_path):
            with np.load(cache_path) as blob:
                x, labels = blob["x"], blob["labels"]
        else:
            self._load_wnids()
            x, labels = (self._load_train() if self.split == "train"
                         else self._load_val())
            if self.cache:
                self._save_cache(cache_path, x, labels)
        x = np.transpose(x, (0, 3, 1, 2))  # HWC -> CHW
        if self.data_format == "NHWC":
            x = np.transpose(x, (0, 2, 3, 1))
        self._x = np.ascontiguousarray(x)
        self._y = one_hot(labels, self.NUM_CLASSES)

    @staticmethod
    def _save_cache(path: str, x: np.ndarray, labels: np.ndarray) -> None:
        # written beside and renamed, so a run cut off mid-save never leaves
        # a torn cache for the next run to load
        tmp = f"{path}.tmp-{os.getpid()}.npz"
        try:
            np.savez(tmp, x=x, labels=labels)
            os.replace(tmp, path)
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _load_train(self) -> Tuple[np.ndarray, np.ndarray]:
        paths: List[str] = []
        labels: List[int] = []
        train_dir = os.path.join(self.root, "train")
        for wnid, idx in sorted(self.wnid_to_idx.items(), key=lambda kv: kv[1]):
            img_dir = os.path.join(train_dir, wnid, "images")
            if not os.path.isdir(img_dir):
                continue
            files = sorted(os.listdir(img_dir))[:self.max_per_class or None]
            paths += [os.path.join(img_dir, fn) for fn in files]
            labels += [idx] * len(files)
        if not paths:
            raise FileNotFoundError(f"no training images under {train_dir}")
        return np.stack(_decode_many(paths)), np.asarray(labels, np.int64)

    def _load_val(self) -> Tuple[np.ndarray, np.ndarray]:
        """``val/val_annotations.txt``: ``filename<TAB>wnid<TAB>...``."""
        val_dir = os.path.join(self.root, "val")
        paths, labels = [], []
        with open(os.path.join(val_dir, "val_annotations.txt"),
                  encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                path = os.path.join(val_dir, "images", parts[0])
                if parts[1] in self.wnid_to_idx and os.path.isfile(path):
                    paths.append(path)
                    labels.append(self.wnid_to_idx[parts[1]])
        if not paths:
            raise FileNotFoundError(f"no validation images under {val_dir}")
        return np.stack(_decode_many(paths)), np.asarray(labels, np.int64)
