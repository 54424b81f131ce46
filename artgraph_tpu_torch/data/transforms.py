"""Host half of the image preprocessing: decode and resize to uint8.

Port of artgraph_tpu/data/transforms.py:decode_resize_uint8. The reference
(src/data/data.py:11-49) opens the file, forces RGB and resizes bilinearly
to 224x224 before ToTensor/Normalize; the normalize half runs on the device
(ops/preprocess.py). As in the JAX package, a JPEG goes through the native
runtime (runtime/image_cpp.py: libjpeg and a PIL-exact resize) and PIL
takes what it returns None for: other formats (PNG), JPEGs libjpeg cannot
turn into RGB (CMYK), and every file where the library is unavailable. PIL
is imported where it is used.
"""
from __future__ import annotations

import numpy as np

from artgraph_tpu_torch import config
from artgraph_tpu_torch.runtime import decode_resize_native


def decode_resize_uint8(path: str, size: int = config.IMAGE_SIZE
                        ) -> np.ndarray:
    """Open, force RGB, bilinear-resize: uint8 [size, size, 3]."""
    native = decode_resize_native(path, size)
    if native is not None:
        return native
    return decode_resize_pil(path, size)


def decode_resize_pil(path: str, size: int = config.IMAGE_SIZE
                      ) -> np.ndarray:
    """The PIL path of `decode_resize_uint8`."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # as the reference loader does
    with Image.open(path) as image:
        if image.mode != "RGB":
            image = image.convert("RGB")
        return np.asarray(image.resize((size, size), Image.BILINEAR),
                          dtype=np.uint8)
