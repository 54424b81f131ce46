"""uint8 NHWC image batch -> normalized f32 NHWC, on the device.

Port of artgraph_tpu/ops/preprocess.py. The JAX serving step leaves this to
XLA, which fuses it into the patch embedding; eager PyTorch has no such
fusion, so on a CUDA tensor it runs as its own kernel (csrc/normalize.cu, the
counterpart of the Pallas `normalize_images_pallas`). Both forms compute
x * alpha + beta per channel with alpha = 1/(255 std), beta = -mean/std, the
multiply and the add rounded separately: the kernel is bit-identical to
`normalize_images_plain`.
"""
from __future__ import annotations

import functools

import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.ops import _build, launches


@functools.lru_cache(maxsize=None)
def norm_coefficients(transform_type: str
                      ) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(alpha, beta) per channel, computed in f32 as the JAX package does and
    returned as Python floats (exact f32 values), once per statistics set."""
    if transform_type not in config.NORM_STATS:
        raise ValueError(f"unknown transform_type: {transform_type!r}")
    mean, std = config.NORM_STATS[transform_type]
    mean = torch.tensor(mean, dtype=torch.float32)
    std = torch.tensor(std, dtype=torch.float32)
    return (tuple((1.0 / (255.0 * std)).tolist()),
            tuple((-mean / std).tolist()))


def normalize_images_plain(images_u8: torch.Tensor,
                           transform_type: str = "resnet") -> torch.Tensor:
    """The plain PyTorch version: images_u8.float() * alpha + beta."""
    alpha, beta = (torch.tensor(c, dtype=torch.float32,
                                device=images_u8.device)
                   for c in norm_coefficients(transform_type))
    return images_u8.to(torch.float32) * alpha + beta


def normalize_images(images_u8: torch.Tensor,
                     transform_type: str = "resnet") -> torch.Tensor:
    """uint8 [B, H, W, 3] -> f32 [B, H, W, 3].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if images_u8.device.type == "cpu":
        return normalize_images_plain(images_u8, transform_type)
    if images_u8.device.type != "cuda":
        raise ValueError(f"normalize_images: unsupported device "
                         f"{images_u8.device}")
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_images: expected uint8, got "
                        f"{images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_images: expected [B, H, W, 3], got "
                         f"{tuple(images_u8.shape)}")
    if not images_u8.is_contiguous() or images_u8.data_ptr() % 16:
        raise ValueError("normalize_images: input must be contiguous and "
                         "16-byte aligned")
    n = images_u8.numel()
    if n >= 2**31:
        raise ValueError(f"normalize_images: {n} elements exceed int32")
    alpha, beta = norm_coefficients(transform_type)
    out = torch.empty(images_u8.shape, dtype=torch.float32,
                      device=images_u8.device)
    rc = _build.lib().ag_normalize_u8(
        images_u8.data_ptr(), out.data_ptr(), n, *alpha, *beta,
        _build.stream_ptr(images_u8))
    _build.check(rc, "ag_normalize_u8")
    launches.count("normalize_images")
    return out
