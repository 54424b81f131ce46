"""The native JPEG decode and resize runtime (csrc/artdata.cpp, built with
g++ at first use); port of artgraph_tpu/runtime."""
from artgraph_tpu_torch.runtime.image_cpp import (decode_batch_native,
                                                  decode_resize_native,
                                                  native_available,
                                                  native_reason,
                                                  resize_native)

__all__ = ["native_available", "native_reason", "decode_resize_native",
           "resize_native", "decode_batch_native"]
