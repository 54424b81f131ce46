"""The ViT block's MLP half, x + fc2(GELU_erf(fc1(LayerNorm(x)))), both
directions.

Port of artgraph_tpu/ops/mlp.py:fused_block_mlp, a `jax.custom_vjp` over two
Pallas kernels (`_mlp_fwd_kernel`, `_mlp_bwd_kernel`), here a
`torch.autograd.Function` over hand-written launches from csrc/ on PyTorch's
current stream. Forward:

  (a) row LayerNorm -> bf16 y                       (block_gemm.cu)
  (b) act = bf16(GELU_erf(bf16(y . W1^T + b1)))     (NT, GELU epilogue)
  (c) out = x + bf16(act . W2^T + b2)               (NT, residual epilogue)

The Function saves only x and the parameters, and the backward recomputes:

  (a) y, then h = bf16(y . W1^T + b1) and act = bf16(GELU(h)) in one GEMM
      (NT, epilogue writing both; GELU' needs h)
  (d) dh = bf16((do . W2) * GELU'(h))               (NN, dGELU epilogue)
  (e) dy = dh . W1, f32                             (NN, f32 out)
  (f) dx = bf16(do + LN'(dy)), dgamma, dbeta and db2 = the column sums of
      do, in one pass over the rows                 (block_norm_bwd.cu)
  (g) dW1 = dh^T . y, dW2 = do^T . act              (TN, f32 out)
  (h) db1: the column sums of dh in f32             (block_norm_bwd.cu)

The [B, N, 4C] hidden tensors reach device memory in bf16 (the Pallas kernels
keep them in VMEM). GELU is the exact erf form; the CUDA epilogues evaluate
erf as the Pallas kernels do, by the A&S 7.1.26 approximation (|error| <=
1.5e-7; branch-free, one exponential shared with GELU's density, and no
register spill where CUDA's `erff` had one), the plain twins with
torch.erf. Parameter gradients come back in f32, dx in x's dtype.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch.ops.attention import (
    EPI_BIAS_GELU, EPI_BIAS_GELU_AUX, EPI_BIAS_RESIDUAL, EPI_DGELU, EPI_F32,
    LAYOUT_NN, LAYOUT_TN, at_least_f32, bf16_contiguous, check_block_operands,
    colsum_cuda, gemm_cuda, gemm_nt_cuda, layernorm_bwd_cuda, layernorm_cuda,
    linear_plain, ln_bwd_plain, ln_rows_plain, rows_t_dot, weight_bf16,
    weight_f32)

# Launches of the CUDA forward / backward by `fused_block_mlp` since the last
# reset (one per call of the block, however many kernels it runs).
LAUNCHES = 0
LAUNCHES_BWD = 0

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def gelu_plain(h: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32 (f64 for f64 h), in the kernel's order of
    operations."""
    h = h.to(at_least_f32(h.dtype))
    return 0.5 * h * (1.0 + torch.erf(h * _INV_SQRT2))


def gelu_grad_plain(h: torch.Tensor) -> torch.Tensor:
    """d gelu(h) / dh in f32 (f64 for f64 h): Phi(h) + h * phi(h)."""
    h = h.to(at_least_f32(h.dtype))
    cdf = 0.5 * (1.0 + torch.erf(h * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * h * h)
    return cdf + h * pdf


def block_mlp_plain(x, gamma, beta, w1, b1, w2, b2,
                    eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of `fused_block_mlp`'s forward."""
    y = ln_rows_plain(x, gamma, beta, eps)
    act = gelu_plain(linear_plain(y, w1, b1)).to(x.dtype)
    return x + linear_plain(act, w2, b2)


def block_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, dout,
                        eps: float = 1e-6):
    """The plain PyTorch version of the backward, `_mlp_bwd_kernel` line by
    line: (dx, dgamma, dbeta, dw1, db1, dw2, db2), dx in x.dtype, the rest
    f32, weights in [out, in] layout."""
    dt = x.dtype
    y = ln_rows_plain(x, gamma, beta, eps)
    h = linear_plain(y, w1, b1)
    act = gelu_plain(h).to(dt)
    do = dout.to(dt)
    # fc2 backward: block out = x + fc2(act) => d(fc2 out) == do
    acc_t = at_least_f32(dt)
    dact = do.to(acc_t) @ weight_f32(w2, dt)
    dh = (dact * gelu_grad_plain(h)).to(dt)
    dy = dh.to(acc_t) @ weight_f32(w1, dt)              # [B, N, C] f32
    dx, dgamma, dbeta, db2 = ln_bwd_plain(x, gamma, dy, do, eps)
    rows = tuple(range(x.dim() - 1))
    return (dx, dgamma, dbeta, rows_t_dot(dh, y), dh.to(acc_t).sum(rows),
            rows_t_dot(do, act), db2)


def _check_mlp(x, gamma, beta, w1, b1, w2, b2) -> None:
    C, Hd = x.shape[-1], w1.shape[0]
    check_block_operands("fused_block_mlp", x, {
        "gamma": (gamma, (C,)), "beta": (beta, (C,)),
        "w1": (w1, (Hd, C)), "b1": (b1, (Hd,)),
        "w2": (w2, (C, Hd)), "b2": (b2, (C,))})


def block_mlp_cuda(x, gamma, beta, w1, b1, w2, b2,
                   eps: float) -> torch.Tensor:
    """The forward kernels on a CUDA tensor (checks, then launches)."""
    _check_mlp(x, gamma, beta, w1, b1, w2, b2)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    y = layernorm_cuda(x2d, gamma, beta, eps)
    act = gemm_nt_cuda(y, w1, b1, EPI_BIAS_GELU)
    return gemm_nt_cuda(act, w2, b2, EPI_BIAS_RESIDUAL,
                        residual=x2d).view(B, N, C)


def block_mlp_bwd_cuda(x, gamma, beta, w1, b1, w2, b2, dout, eps: float):
    """The backward kernels on CUDA tensors: the gradients in the order and
    dtypes of `block_mlp_bwd_plain`."""
    _check_mlp(x, gamma, beta, w1, b1, w2, b2)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    do = bf16_contiguous(dout).view(B * N, C)
    y = layernorm_cuda(x2d, gamma, beta, eps)
    h, act = gemm_nt_cuda(y, w1, b1, EPI_BIAS_GELU_AUX)
    dh = gemm_cuda(do, weight_bf16(w2), LAYOUT_NN, EPI_DGELU, aux=h)
    dy = gemm_cuda(dh, weight_bf16(w1), LAYOUT_NN, EPI_F32)
    dx, dgamma, dbeta, db2 = layernorm_bwd_cuda(x2d, gamma, dy, do, eps)
    return (dx.view(B, N, C), dgamma, dbeta,
            gemm_cuda(dh, y, LAYOUT_TN, EPI_F32), colsum_cuda(dh),
            gemm_cuda(do, act, LAYOUT_TN, EPI_F32), db2)


class _FusedBlockMlp(torch.autograd.Function):
    """Saves x and the parameters only; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        global LAUNCHES
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps = eps
        if x.device.type == "cpu":
            return block_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps)
        out = block_mlp_cuda(x, gamma, beta, w1, b1, w2, b2, eps)
        LAUNCHES += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_BWD
        x, gamma, beta, w1, b1, w2, b2 = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = block_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, dout,
                                        ctx.eps)
        else:
            grads = block_mlp_bwd_cuda(x, gamma, beta, w1, b1, w2, b2, dout,
                                       ctx.eps)
            LAUNCHES_BWD += 1
        return (*grads, None)


def fused_block_mlp(x, gamma, beta, w1, b1, w2, b2,
                    eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu_erf(fc1(LayerNorm(x)))), differentiable.

    x: [B, N, C] residual stream; gamma, beta: [C]; w1: [Hd, C], b1: [Hd],
    w2: [C, Hd], b2: [C] (nn.Linear layout). A CPU tensor takes the plain
    versions (any float dtype); a CUDA tensor launches the kernels (bf16 x,
    f32 params).
    """
    return _FusedBlockMlp.apply(x, gamma, beta, w1, b1, w2, b2, eps)
