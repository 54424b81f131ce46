"""The ViT block's attention half, x + proj(MHA(LayerNorm(x))), in one call.

Port of artgraph_tpu/ops/attention.py:fused_block_attention (forward,
`_block_fwd_kernel`). On a CUDA tensor it runs four hand-written launches
from csrc/ on PyTorch's current stream:

  (a) row LayerNorm -> bf16 y                     (block_gemm.cu)
  (b) qkv = y . W_qkv^T + b_qkv, bf16              (block_gemm.cu, bias
                                                    epilogue)
  (c) per (batch, head, 64-query tile) softmax attention core
                                                   (block_attention.cu)
  (d) out = x + (attn . W_proj^T + b_proj), bf16   (block_gemm.cu, residual
                                                    epilogue)

The qkv tensor and the attention output are the only intermediates that
reach device memory (the Pallas kernel keeps them in VMEM; fusing them here
is later work). Rounding points are the Pallas kernel's, so the kernel and
`block_attention_plain` differ only in accumulation order.

Weights keep nn.Linear's [out, in] layout. As `_block_operands` does, the
wrapper casts the f32 weights and biases to bf16 and keeps gamma/beta f32.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch.ops import _build

# Launches of the CUDA kernel by `fused_block_attention` since the last reset.
LAUNCHES = 0

# GEMM epilogues of csrc/block_gemm.cu (enum Epilogue)
EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL = 0, 1, 2


# --- plain PyTorch pieces, shared with ops/mlp.py ---------------------------

def ln_rows_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """flax-style LayerNorm in f32 (uncentered variance clipped at 0), cast
    back to x.dtype: `_ln_rows` and the `y = ...` line of the Pallas kernel."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    xhat = (xf - mean) * torch.rsqrt(var + eps)
    return (xhat * gamma.to(torch.float32)
            + beta.to(torch.float32)).to(x.dtype)


def linear_plain(a: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x.dtype(f32(a . w^T) + f32(x.dtype(b))), w in [out, in] layout.

    The f32 upcast before the product is exact for bf16 operands, so this is
    a bf16 product with f32 accumulation, as the Pallas kernel's jnp.dot.
    """
    dt = a.dtype
    acc = a.to(torch.float32) @ w.to(dt).to(torch.float32).t()
    return (acc + b.to(dt).to(torch.float32)).to(dt)


def block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of `fused_block_attention`."""
    B, N, C = x.shape
    D = C // num_heads
    y = ln_rows_plain(x, gamma, beta, eps)
    qkv = linear_plain(y, w_qkv, b_qkv)                  # [B, N, 3C]
    q, k, v = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        * (D ** -0.5)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(x.dtype)
    o = (p.to(torch.float32) @ v.to(torch.float32)).to(x.dtype)
    attn = o.transpose(1, 2).reshape(B, N, C)
    return x + linear_plain(attn, w_proj, b_proj)


# --- CUDA launches, shared with ops/mlp.py ----------------------------------

def check_block_operands(name: str, x: torch.Tensor,
                         params: dict[str, tuple[torch.Tensor, tuple]]
                         ) -> None:
    """Raise unless x is a contiguous, aligned bf16 [B, N, C] CUDA tensor and
    each parameter is an f32 tensor of the expected shape on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned "
                         f"[B, N, C] tensor, got {tuple(x.shape)}")
    for pname, (t, shape) in params.items():
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: {pname} must be float32 on {x.device}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {pname} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def layernorm_cuda(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float) -> torch.Tensor:
    rows, cols = x2d.shape
    y = torch.empty_like(x2d)
    rc = _build.lib().ag_layernorm_bf16(
        x2d.data_ptr(), gamma.contiguous().data_ptr(),
        beta.contiguous().data_ptr(), y.data_ptr(), rows, cols, eps,
        _build.stream_ptr(x2d))
    _build.check(rc, "ag_layernorm_bf16")
    return y


def gemm_nt_cuda(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 epilogue: int, residual: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """epilogue(a . w^T + b) with a [M, K] bf16 and f32 w [N, K], b [N]."""
    M, K = a.shape
    N = w.shape[0]
    if K % 32:
        raise ValueError(f"gemm_nt_cuda: K={K} must be a multiple of 32")
    wc = w.to(torch.bfloat16).contiguous()
    bc = b.to(torch.bfloat16).contiguous()
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    rc = _build.lib().ag_gemm_nt_bf16(
        a.data_ptr(), wc.data_ptr(), bc.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        M, N, K, epilogue, _build.stream_ptr(a))
    _build.check(rc, "ag_gemm_nt_bf16")
    return out


def attention_core_cuda(qkv: torch.Tensor, B: int, N: int,
                        num_heads: int) -> torch.Tensor:
    C = qkv.shape[1] // 3
    D = C // num_heads
    lib = _build.lib()
    smem = lib.ag_attention_smem_bytes(N, D)
    limit = torch.cuda.get_device_properties(qkv.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"attention_core_cuda: N={N} needs {smem} bytes of "
                         f"shared memory, the card allows {limit}")
    out = torch.empty((B * N, C), dtype=torch.bfloat16, device=qkv.device)
    rc = lib.ag_attention_core_bf16(qkv.data_ptr(), out.data_ptr(), B, N,
                                    num_heads, D, D ** -0.5,
                                    _build.stream_ptr(qkv))
    _build.check(rc, "ag_attention_core_bf16")
    return out


def fused_block_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """x + proj(attention(LayerNorm(x))).

    x: [B, N, C] residual stream; gamma, beta: [C]; w_qkv: [3C, C],
    b_qkv: [3C] (timm fused-qkv layout, rows ordered qkv-slot, head, dim);
    w_proj: [C, C], b_proj: [C]. A CPU tensor takes the plain version (any
    float dtype); a CUDA tensor launches the kernel (bf16 x, f32 params).
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                     b_proj, num_heads, eps)
    C = x.shape[-1]
    check_block_operands("fused_block_attention", x, {
        "gamma": (gamma, (C,)), "beta": (beta, (C,)),
        "w_qkv": (w_qkv, (3 * C, C)), "b_qkv": (b_qkv, (3 * C,)),
        "w_proj": (w_proj, (C, C)), "b_proj": (b_proj, (C,))})
    if C != 64 * num_heads:
        raise ValueError(f"fused_block_attention: head dim {C}/{num_heads} "
                         f"must be 64, the one the kernel is built for")
    B, N, _ = x.shape
    x2d = x.view(B * N, C)
    y = layernorm_cuda(x2d, gamma, beta, eps)
    qkv = gemm_nt_cuda(y, w_qkv, b_qkv, EPI_BIAS)
    attn = attention_core_cuda(qkv, B, N, num_heads)
    out = gemm_nt_cuda(attn, w_proj, b_proj, EPI_BIAS_RESIDUAL,
                       residual=x2d)
    LAUNCHES += 1
    return out.view(B, N, C)
