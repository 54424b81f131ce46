"""Decoded-image cache: a memory-mapped [N, size, size, 3] uint8 file per
split, filled as images are first decoded; later epochs read it at memory
rate.

Port of artgraph_tpu/data/cache.py (`DecodedImageCache`, `wrap_with_cache`)
with its file names (`{name}_{size}.u8` and the validity byte-map
`{name}_{size}.valid`) and layout, so a cache written by either package
reads in the other. A partly built cache is safe to resume: only rows whose
validity byte is set are read. With every row of a batch valid,
`_ImageDataset._images_batch` (data/datasets.py) takes the batch as one
slice of the memmap and decodes nothing.
"""
from __future__ import annotations

import os
import types

import numpy as np

from artgraph_tpu_torch import config


class DecodedImageCache:
    def __init__(self, cache_dir: str, name: str, n: int,
                 size: int = config.IMAGE_SIZE):
        os.makedirs(cache_dir, exist_ok=True)
        self.data_path = os.path.join(cache_dir, f"{name}_{size}.u8")
        self.valid_path = os.path.join(cache_dir, f"{name}_{size}.valid")
        mode = "r+" if os.path.exists(self.data_path) else "w+"
        self.data = np.memmap(self.data_path, dtype=np.uint8, mode=mode,
                              shape=(n, size, size, 3))
        vmode = "r+" if os.path.exists(self.valid_path) else "w+"
        self.valid = np.memmap(self.valid_path, dtype=np.uint8, mode=vmode,
                               shape=(n,))

    def get(self, idx: int, decode_fn):
        """Row idx, decoded by decode_fn(idx) and stored on first use."""
        if not self.valid[idx]:
            image = decode_fn(idx)
            self.data[idx] = image
            self.valid[idx] = 1
            return image
        return np.asarray(self.data[idx])

    @property
    def complete(self) -> bool:
        return bool(self.valid.all())


def wrap_with_cache(dataset, cache_dir: str, name: str):
    """Route a dataset's `_image(idx)` through a persistent decoded cache;
    the dataset is modified in place and returned.

    A `Subset` (the projector's split) has no rows of its own: its base
    dataset is wrapped, under `name` unless an earlier split already did,
    and every subset of that base shares the one cache.
    """
    base = dataset
    while not hasattr(base, "_image") and hasattr(base, "indices"):
        base = base.dataset
    if not hasattr(base, "_image"):
        raise TypeError(f"{type(dataset).__name__} loads no images through "
                        f"_image(idx); it cannot be cached")
    if getattr(base, "_decoded_cache", None) is not None:
        return dataset
    cache = DecodedImageCache(cache_dir, name, len(base),
                              getattr(base, "image_size", config.IMAGE_SIZE))
    original = base._image

    def cached_image(self, idx: int):
        return cache.get(idx, original)

    base._image = types.MethodType(cached_image, base)
    base._decoded_cache = cache
    return dataset
