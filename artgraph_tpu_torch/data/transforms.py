"""Host half of the image preprocessing: decode and resize to uint8.

Port of artgraph_tpu/data/transforms.py:decode_resize_uint8, its PIL path
(the JAX package's native decoder is bit-exact with PIL). The reference
(src/data/data.py:11-49) opens the file, forces RGB and resizes bilinearly to
224x224 before ToTensor/Normalize; the normalize half runs on the device
(ops/preprocess.py). PIL is imported where it is used.
"""
from __future__ import annotations

import numpy as np

from artgraph_tpu_torch import config


def decode_resize_uint8(path: str, size: int = config.IMAGE_SIZE
                        ) -> np.ndarray:
    """Open, force RGB, bilinear-resize: uint8 [size, size, 3]."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # as the reference loader does
    with Image.open(path) as image:
        if image.mode != "RGB":
            image = image.convert("RGB")
        return np.asarray(image.resize((size, size), Image.BILINEAR),
                          dtype=np.uint8)
