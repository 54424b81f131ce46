"""The ViT block's MLP half, x + fc2(GELU_erf(fc1(LayerNorm(x)))), in one call.

Port of artgraph_tpu/ops/mlp.py:fused_block_mlp (forward, `_mlp_fwd_kernel`).
On a CUDA tensor it runs three hand-written launches from csrc/block_gemm.cu
on PyTorch's current stream:

  (a) row LayerNorm -> bf16 y
  (b) act = bf16(GELU_erf(bf16(y . W1^T + b1)))     (GELU epilogue)
  (c) out = x + bf16(act . W2^T + b2)               (residual epilogue)

The [B, N, 4C] hidden tensor reaches device memory once, in bf16, between (b)
and (c); the Pallas kernel keeps it in VMEM. GELU is the exact erf form with
CUDA's `erff`; the Pallas kernel needs the A&S 7.1.26 approximation
(|error| <= 1.5e-7) only because Mosaic has no erf.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch.ops.attention import (EPI_BIAS_GELU,
                                              EPI_BIAS_RESIDUAL,
                                              check_block_operands,
                                              gemm_nt_cuda, layernorm_cuda,
                                              linear_plain, ln_rows_plain)

# Launches of the CUDA kernel by `fused_block_mlp` since the last reset.
LAUNCHES = 0

_INV_SQRT2 = 0.7071067811865476


def gelu_plain(h: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32, in the kernel's order of operations."""
    h = h.to(torch.float32)
    return 0.5 * h * (1.0 + torch.erf(h * _INV_SQRT2))


def block_mlp_plain(x, gamma, beta, w1, b1, w2, b2,
                    eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of `fused_block_mlp`."""
    y = ln_rows_plain(x, gamma, beta, eps)
    act = gelu_plain(linear_plain(y, w1, b1)).to(x.dtype)
    return x + linear_plain(act, w2, b2)


def fused_block_mlp(x, gamma, beta, w1, b1, w2, b2,
                    eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu_erf(fc1(LayerNorm(x)))).

    x: [B, N, C] residual stream; gamma, beta: [C]; w1: [Hd, C], b1: [Hd],
    w2: [C, Hd], b2: [C] (nn.Linear layout). A CPU tensor takes the plain
    version (any float dtype); a CUDA tensor launches the kernel (bf16 x,
    f32 params).
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return block_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps)
    C, Hd = x.shape[-1], w1.shape[0]
    check_block_operands("fused_block_mlp", x, {
        "gamma": (gamma, (C,)), "beta": (beta, (C,)),
        "w1": (w1, (Hd, C)), "b1": (b1, (Hd,)),
        "w2": (w2, (C, Hd)), "b2": (b2, (C,))})
    B, N, _ = x.shape
    x2d = x.view(B * N, C)
    y = layernorm_cuda(x2d, gamma, beta, eps)
    act = gemm_nt_cuda(y, w1, b1, EPI_BIAS_GELU)
    out = gemm_nt_cuda(act, w2, b2, EPI_BIAS_RESIDUAL, residual=x2d)
    LAUNCHES += 1
    return out.view(B, N, C)
