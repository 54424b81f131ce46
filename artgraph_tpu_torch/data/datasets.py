"""Map-style image datasets over the ArtGraph manifests.

Port of artgraph_tpu/data/datasets.py, the single-task part: `_ImageDataset`
and `ArtGraphSingleTask` (ref: src/data/data.py:81-102). Items are (uint8
NHWC image, int label); `get_batch` assembles a whole batch with one label
gather. Normalization runs on the device (ops/preprocess.py).
"""
from __future__ import annotations

import os

import numpy as np
import pandas as pd

from artgraph_tpu_torch.data.transforms import decode_resize_uint8


class _ImageDataset:
    """Shared base: image decode from a manifest dataframe whose column
    order is significant (iloc-positional access, ref: src/data/data.py)."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 transform_type: str = "resnet"):
        if transform_type not in ("resnet", "vit"):
            raise ValueError(f"unknown transform_type {transform_type!r}")
        self.image_dir = image_dir
        self.dataset = df_image_label
        self.transform_type = transform_type
        self._col_arrays: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.dataset)

    def _image(self, idx: int) -> np.ndarray:
        return decode_resize_uint8(
            os.path.join(self.image_dir, self.dataset.iloc[idx, 0]))

    def _images_batch(self, idx: np.ndarray) -> np.ndarray:
        return np.stack([self._image(int(i)) for i in idx])

    def _col_i32(self, col: int) -> np.ndarray:
        arr = self._col_arrays.get(col)
        if arr is None:
            arr = self._col_arrays[col] = \
                self.dataset.iloc[:, col].to_numpy(np.int32)
        return arr


class ArtGraphSingleTask(_ImageDataset):
    """(image, label) items; df columns ['image', <label>], in that order."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 transform_type: str = "resnet"):
        if "image" not in df_image_label.columns:
            raise ValueError("the manifest needs an 'image' column")
        super().__init__(image_dir, df_image_label, transform_type)

    def __getitem__(self, idx: int):
        return self._image(idx), int(self.dataset.iloc[idx, 1])

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        return self._images_batch(idx), self._col_i32(1)[idx]
