"""Map-style image datasets over the ArtGraph manifests.

Port of artgraph_tpu/data/datasets.py: `_ImageDataset`, the image-only
`ArtGraphSingleTask` and `ArtGraphMultiTask` (ref: src/data/data.py:53-102),
the ContextNet / MultiModal, fusion and projector datasets (ref:
src/data/data_kg.py:58-180) and `Subset`. Items are (uint8 NHWC image,
..., label(s)); `get_batch` assembles a whole batch with one gather per
component, the same arrays as the JAX package's; with a complete decoded
cache (data/cache.py) the images are one slice of its memmap. Normalization
runs on the device (ops/preprocess.py).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import pandas as pd

from artgraph_tpu_torch import config
from artgraph_tpu_torch.data.transforms import decode_resize_uint8


class _ImageDataset:
    """Shared base: image decode from a manifest dataframe whose column
    order is significant (iloc-positional access, ref: src/data/data.py)."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 transform_type: str = "resnet"):
        if transform_type not in ("resnet", "vit", "swin"):
            raise ValueError(f"unknown transform_type {transform_type!r}")
        self.image_dir = image_dir
        self.dataset = df_image_label
        self.transform_type = transform_type
        self._col_arrays: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def image_size(self) -> int:
        """The side images are decoded at: 384 for swin, else 224."""
        return config.image_size(self.transform_type)

    def _image(self, idx: int) -> np.ndarray:
        path = os.path.join(self.image_dir, self.dataset.iloc[idx, 0])
        # at 224 the call stays decode(path), the one-argument signature of
        # the decode stand-ins in the tests and the benchmark's faults
        if self.image_size == config.IMAGE_SIZE:
            return decode_resize_uint8(path)
        return decode_resize_uint8(path, self.image_size)

    def _images_batch(self, idx: np.ndarray) -> np.ndarray:
        cache = getattr(self, "_decoded_cache", None)
        if cache is not None and cache.valid[idx].all():
            return cache.data[idx]   # one gather from the memmap (a copy)
        return np.stack([self._image(int(i)) for i in idx])

    def _col_i32(self, col: int) -> np.ndarray:
        arr = self._col_arrays.get(col)
        if arr is None:
            arr = self._col_arrays[col] = \
                self.dataset.iloc[:, col].to_numpy(np.int32)
        return arr

    def _labels_2(self, idx: np.ndarray) -> np.ndarray:
        """[len(idx), 2] int32: columns 1 and 2 (style, genre)."""
        return np.stack((self._col_i32(1)[idx], self._col_i32(2)[idx]),
                        axis=1)


def _require_columns(df: pd.DataFrame, *names: str) -> None:
    if not set(names) <= set(df.columns):
        raise ValueError(f"the manifest needs the columns {names}, has "
                         f"{tuple(df.columns)}")


class ArtGraphSingleTask(_ImageDataset):
    """(image, label) items; df columns ['image', <label>], in that order."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 transform_type: str = "resnet"):
        _require_columns(df_image_label, "image")
        super().__init__(image_dir, df_image_label, transform_type)

    def __getitem__(self, idx: int):
        return self._image(idx), int(self.dataset.iloc[idx, 1])

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        return self._images_batch(idx), self._col_i32(1)[idx]


class ArtGraphMultiTask(_ImageDataset):
    """(image, [style, genre]) items; df columns ['image', 'style',
    'genre'], in that order. A batch's labels are [B, 2] int32."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 transform_type: str = "resnet"):
        _require_columns(df_image_label, "image", "style", "genre")
        super().__init__(image_dir, df_image_label, transform_type)

    def __getitem__(self, idx: int):
        return self._image(idx), [int(self.dataset.iloc[idx, 1]),
                                  int(self.dataset.iloc[idx, 2])]

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        return self._images_batch(idx), self._labels_2(idx)


class MultiModalArtgraphSingleTask(_ImageDataset):
    """(image, embedding, label) items with three embedding-indexing modes
    (ref: src/data/data_kg.py:82-108):

      * type=='train' and emb_type=='artwork'  -> embeddings[row idx]
      * type=='train' and emb_type!='artwork'  -> embeddings[label id]
      * type!='train' (valid/test, projected)  -> embeddings[row idx]
    """

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 embeddings: np.ndarray, type: str = "train",
                 emb_type: str = "artwork", transform_type: str = "resnet"):
        _require_columns(df_image_label, "image")
        super().__init__(image_dir, df_image_label, transform_type)
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        self.by_label = type == "train" and emb_type != "artwork"

    def __getitem__(self, idx: int):
        label_id = int(self.dataset.iloc[idx, 1])
        row = label_id if self.by_label else idx
        return self._image(idx), self.embeddings[row], label_id

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        labels = self._col_i32(1)[idx]
        emb = self.embeddings[labels if self.by_label else idx]
        return self._images_batch(idx), emb, labels


class MultiModalArtgraphMultiTask(_ImageDataset):
    """(image, embedding, [style, genre]) items of the ContextNet and
    MultiModal multitask trainers (ref: src/data/data_kg.py:58-79): the
    embeddings by row, so the table must have a row per manifest row."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 embeddings: np.ndarray, transform_type: str = "resnet"):
        _require_columns(df_image_label, "image", "style", "genre")
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if len(df_image_label) != embeddings.shape[0]:
            raise ValueError(
                f"the embedding table has {embeddings.shape[0]} rows for "
                f"{len(df_image_label)} manifest rows")
        super().__init__(image_dir, df_image_label, transform_type)
        self.embeddings = embeddings

    def __getitem__(self, idx: int):
        return (self._image(idx), self.embeddings[idx],
                [int(self.dataset.iloc[idx, 1]),
                 int(self.dataset.iloc[idx, 2])])

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        return (self._images_batch(idx), self.embeddings[idx],
                self._labels_2(idx))


class LabelProjectionDataset(_ImageDataset):
    """(image, embedding) regression pairs for the projector
    (ref: src/data/data_kg.py:110-129). df columns ['image', 'style',
    'genre']; emb_type=='artwork' indexes by row, otherwise by the label in
    column 1."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 embeddings: np.ndarray, emb_type: str,
                 transform_type: str = "resnet"):
        super().__init__(image_dir, df_image_label, transform_type)
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        self.by_label = emb_type != "artwork"

    def __getitem__(self, idx: int):
        row = int(self.dataset.iloc[idx, 1]) if self.by_label else idx
        return self._image(idx), self.embeddings[row]

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        rows = self._col_i32(1)[idx] if self.by_label else idx
        return self._images_batch(idx), self.embeddings[rows]


class NewMultiModalArtgraphMultiTask(_ImageDataset):
    """(image, emb_style, emb_genre, [style, genre]) items
    (ref: src/data/data_kg.py:131-180). Training feeds the TRUE KG
    embeddings (by row for emb_type=='artwork', else by each task's label
    id); valid/test feed the PROJECTED ones by row."""

    def __init__(self, image_dir: str, df_image_label: pd.DataFrame,
                 embedding_style: np.ndarray, embedding_genre: np.ndarray,
                 type: str = "train", emb_type: str = "artwork",
                 transform_type: str = "resnet"):
        _require_columns(df_image_label, "image", "style", "genre")
        super().__init__(image_dir, df_image_label, transform_type)
        self.embedding_style = np.asarray(embedding_style, dtype=np.float32)
        self.embedding_genre = np.asarray(embedding_genre, dtype=np.float32)
        self.by_label = type == "train" and emb_type != "artwork"

    def __getitem__(self, idx: int):
        style_id = int(self.dataset.iloc[idx, 1])
        genre_id = int(self.dataset.iloc[idx, 2])
        rows = (style_id, genre_id) if self.by_label else (idx, idx)
        return (self._image(idx), self.embedding_style[rows[0]],
                self.embedding_genre[rows[1]], [style_id, genre_id])

    def get_batch(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        styles, genres = self._col_i32(1)[idx], self._col_i32(2)[idx]
        rows = (styles, genres) if self.by_label else (idx, idx)
        return (self._images_batch(idx), self.embedding_style[rows[0]],
                self.embedding_genre[rows[1]],
                np.stack((styles, genres), axis=1))


class Subset:
    """Index-remapped view over a dataset (torch.utils.data.Subset analog,
    used by the seeded projector split, ref: src/utils.py:215-221); nests."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[int(self.indices[idx])]

    def get_batch(self, indices):
        return self.dataset.get_batch(
            self.indices[np.asarray(indices, dtype=np.int64)])

    @property
    def transform_type(self) -> str:
        return self.dataset.transform_type
