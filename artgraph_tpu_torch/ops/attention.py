"""Multi-head attention ops, both directions: the ViT block's attention half
x + proj(MHA(LayerNorm(x))), and the two attention ops of the unfused paths.

`fused_block_attention` is the port of artgraph_tpu/ops/attention.py:
fused_block_attention, a
`jax.custom_vjp` over two Pallas kernels (`_block_fwd_kernel`,
`_block_bwd_kernel`), here a `torch.autograd.Function` over hand-written
launches from csrc/ on PyTorch's current stream. Forward:

  (a) row LayerNorm -> bf16 y                     (block_gemm.cu)
  (b) qkv = y . W_qkv^T + b_qkv, bf16              (block_gemm.cu, NT, bias)
  (c) per (batch, head, 64-query tile) softmax attention core
                                                   (block_attention.cu)
  (d) out = x + (attn . W_proj^T + b_proj), bf16   (block_gemm.cu, NT,
                                                    residual)

As the Pallas VJP does, the Function saves only x and the parameters, and the
backward recomputes (a)-(c) with the same launches, then:

  (e) do_attn = bf16(do . W_proj)                  (block_gemm.cu, NN)
  (f) dqkv in three phases (row statistics; dK, dV per key tile; dQ per
      query tile), bf16                            (block_attention_bwd.cu)
  (g) dy = dqkv . W_qkv, f32                       (block_gemm.cu, NN, f32)
  (h) dx = bf16(do + LN'(dy)), dgamma, dbeta and db_proj = the column sums
      of do, in one pass over the rows             (block_norm_bwd.cu)
  (i) dW_qkv = dqkv^T . y, dW_proj = do^T . attn   (block_gemm.cu, TN, f32)
  (j) db_qkv: the column sums of dqkv in f32       (block_norm_bwd.cu)

Parameter gradients come back in f32 and dx in x's dtype, as
`_fused_block_bwd` returns them. The intermediates that the Pallas kernels
keep in VMEM (qkv, attn, dqkv, dy) pass through device memory here; fusing
them is later work. Rounding points are the Pallas kernels', so the kernels
and `block_attention_plain` / `block_attention_bwd_plain` differ only in
accumulation order.

Weights keep nn.Linear's [out, in] layout. As `_block_operands` does, the
wrappers cast the f32 weights and biases to bf16 and keep gamma/beta f32;
the weights' casts go through `cast_weight`, which counts their bytes.

`fused_attention` (port of the JAX `fused_attention`, Pallas `_fwd_kernel`
and `_bwd_kernel`) takes q, k, v as [B, N, H, D] tensors, in the model
strided views of one [B, N, 3, H, D] qkv tensor, which the kernels read in
place through their row strides (block_attention.cu, block_attention_bwd.cu,
strided instantiations). `fused_qkv_attention` (port of the JAX
`fused_qkv_attention`, `_qkv_fwd_kernel` and `_qkv_bwd_kernel`) runs the qkv
product first (block_gemm.cu, NT with bias) and the same attention core on
the packed qkv tensor; its backward recomputes qkv, runs the backward core
into a packed dqkv and then dx = dqkv . W_qkv (NN), dW_qkv = dqkv^T . x (TN,
f32) and the column sums of dqkv (block_norm_bwd.cu), as the JAX VJP
computes those three outside its kernel. Both save the forward's bf16 output
as the Pallas VJPs do, and both backwards read it for d_row = sum(do * o)
instead of recomputing o.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch import profiling
from artgraph_tpu_torch.ops import _build

# Launches of the CUDA forward / backward by `fused_block_attention` since the
# last reset (one per call of the block, however many kernels it runs).
LAUNCHES = 0
LAUNCHES_BWD = 0
# The same for `fused_attention` and `fused_qkv_attention` (one per call).
LAUNCHES_ATTENTION = 0
LAUNCHES_ATTENTION_BWD = 0
LAUNCHES_QKV = 0
LAUNCHES_QKV_BWD = 0

# GEMM operand layouts and epilogues of csrc/block_gemm.cu (enums Layout,
# Epilogue)
LAYOUT_NT, LAYOUT_NN, LAYOUT_TN = 0, 1, 2
(EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL, EPI_BIAS_GELU_AUX, EPI_NONE,
 EPI_F32, EPI_DGELU) = range(7)

# csrc/block_norm_bwd.cu: the LayerNorm backward's rows in flight a block
# (LNB_WARPS, one warp a row) and its widest row (LNB_MAX_CHUNKS 16-byte
# loads a lane); a column-sum block's columns and row lanes (COLSUM_COLS,
# COLSUM_Y)
NORM_WARPS, NORM_MAX_COLS = 4, 1024
COLSUM_COLS, COLSUM_LANES = 256, 8
# blocks that fill the card (132 SMs): two LayerNorm-backward blocks an SM
# (its registers allow three; at ViT-B/16's 6304 rows the third's gain is
# lost to the second pass over more partial rows), four column-sum blocks
NORM_BLOCKS, COLSUM_BLOCKS = 264, 528

_F32 = torch.float32


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """f32, or wider if the compute dtype already is: the plain versions'
    accumulation type, f64 for f64 inputs (the f64 trajectory tests'
    path), as the JAX package's at_least_f32."""
    return torch.promote_types(dtype, _F32)


# --- plain PyTorch pieces, shared with ops/mlp.py ---------------------------

def ln_stats_plain(x: torch.Tensor, eps: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xhat, rstd) in f32 (f64 for f64 x): flax-style statistics,
    uncentered variance clipped at 0 (`_ln_rows`)."""
    xf = x.to(at_least_f32(x.dtype))
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def ln_rows_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """LayerNorm in f32 cast back to x.dtype: the `y = ...` line of the
    Pallas kernels."""
    xhat, _ = ln_stats_plain(x, eps)
    return (xhat * gamma.to(xhat.dtype) + beta.to(xhat.dtype)).to(x.dtype)


def ln_bwd_plain(x, gamma, dy, dres, eps: float):
    """(dx, dgamma, dbeta, db_res) of y = xhat * gamma + beta plus the
    residual gradient dres, as the Pallas backward kernels write them: dy
    f32, dx rounded once after adding dres in f32; db_res, the f32 column
    sums of dres, is the gradient of the residual branch's bias."""
    xhat, rstd = ln_stats_plain(x, eps)
    dyg = dy * gamma.to(xhat.dtype)
    mean_dyg = dyg.mean(-1, keepdim=True)
    mean_dyg_xhat = (dyg * xhat).mean(-1, keepdim=True)
    dx_ln = rstd * (dyg - mean_dyg - xhat * mean_dyg_xhat)
    dx = (dres.to(xhat.dtype) + dx_ln).to(x.dtype)
    rows = tuple(range(dy.dim() - 1))
    return (dx, (dy * xhat).sum(rows), dy.sum(rows),
            dres.to(xhat.dtype).sum(rows))


def linear_plain(a: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x.dtype(f32(a . w^T) + f32(x.dtype(b))), w in [out, in] layout.

    The f32 upcast before the product is exact for bf16 operands, so this is
    a bf16 product with f32 accumulation, as the Pallas kernel's jnp.dot.
    """
    dt, acc_t = a.dtype, at_least_f32(a.dtype)
    acc = a.to(acc_t) @ cast_weight(w, dt).to(acc_t).t()
    return (acc + b.to(dt).to(acc_t)).to(dt)


def gemm_plain(a: torch.Tensor, b: torch.Tensor, layout: int, epilogue: int,
               bias: torch.Tensor | None = None,
               aux: torch.Tensor | None = None) -> torch.Tensor | tuple:
    """The plain PyTorch version of `gemm_cuda`: the same operand layouts,
    epilogues and rounding points, the product in f32."""
    from artgraph_tpu_torch.ops.mlp import gelu_grad_plain, gelu_plain

    bf = torch.bfloat16
    acc = ((a.to(_F32).t() if layout == LAYOUT_TN else a.to(_F32))
           @ (b.to(_F32).t() if layout == LAYOUT_NT else b.to(_F32)))
    if epilogue == EPI_F32:
        return acc
    if epilogue == EPI_NONE:
        return acc.to(bf)
    if epilogue == EPI_DGELU:
        return (acc * gelu_grad_plain(aux)).to(bf)
    v = (acc + bias.to(bf).to(_F32)).to(bf)
    if epilogue == EPI_BIAS:
        return v
    if epilogue == EPI_BIAS_RESIDUAL:
        return (aux.to(_F32) + v.to(_F32)).to(bf)
    act = gelu_plain(v).to(bf)
    return act if epilogue == EPI_BIAS_GELU else (v, act)


def weight_f32(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The weight as the kernels read it (rounded to dt), in f32 (f64 for
    dt f64)."""
    return cast_weight(w, dt).to(at_least_f32(dt))


def rows_t_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 (f64 for f64 a) a^T . b over all leading (row) dimensions: a
    weight gradient in [out, in] layout."""
    acc_t = at_least_f32(a.dtype)
    return a.reshape(-1, a.shape[-1]).to(acc_t).t() @ \
        b.reshape(-1, b.shape[-1]).to(acc_t)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = t.shape
    return t.view(B, N, num_heads, C // num_heads).transpose(1, 2)


def _exp_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(e, l) of q, k [..., N, D]: s = f32(q . k^T) * scale, e = exp(s -
    rowmax(s)) and its row sums l, all f32 (f64 for f64 q)."""
    acc_t = at_least_f32(q.dtype)
    s = (q.to(acc_t) @ k.to(acc_t).transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


def core_plain(q, k, v, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The block path's attention core on [..., N, D] heads in any float
    dtype: (p, o) with p = dtype(e / l) and o = f32(p . v), unrounded."""
    e, l = _exp_scores(q, k, scale)
    p = (e / l).to(q.dtype)
    return p, p.to(e.dtype) @ v.to(e.dtype)


def core_bwd_plain(q, k, v, p, o, do, scale: float):
    """The core's backward, the Pallas backward kernels line by line: (dq,
    dk, dv) in f32 from the rounded probabilities p and the output o that
    d_row reads (the f32 o of `core_plain` on the block path, the saved
    output on the fused_attention path); inputs [..., N, D], rounded at
    q.dtype."""
    acc_t = at_least_f32(q.dtype)
    qf, kf, vf, pf, dof = (t.to(acc_t) for t in (q, k, v, p, do))
    dv = pf.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    d_row = (dof * o.to(acc_t)).sum(-1, keepdim=True)
    ds = (pf * (dp - d_row) * scale).to(q.dtype).to(acc_t)
    return ds @ kf, ds.transpose(-1, -2) @ qf, dv


def _attention_plain(x, gamma, beta, w_qkv, b_qkv, num_heads: int,
                     eps: float):
    """Forward up to the attention output: (y, q, k, v, p, o f32, attn)."""
    B, N, C = x.shape
    D = C // num_heads
    y = ln_rows_plain(x, gamma, beta, eps)
    qkv = linear_plain(y, w_qkv, b_qkv)                  # [B, N, 3C]
    q, k, v = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    p, o = core_plain(q, k, v, D ** -0.5)
    attn = o.to(x.dtype).transpose(1, 2).reshape(B, N, C)
    return y, q, k, v, p, o, attn


def block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version of `fused_block_attention`'s forward."""
    attn = _attention_plain(x, gamma, beta, w_qkv, b_qkv, num_heads, eps)[-1]
    return x + linear_plain(attn, w_proj, b_proj)


def block_attention_bwd_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, dout,
                              num_heads: int, eps: float = 1e-6):
    """The plain PyTorch version of the backward, `_block_bwd_kernel` line
    by line: (dx, dgamma, dbeta, dw_qkv, db_qkv, dw_proj, db_proj), dx in
    x.dtype, the rest f32, weights in [out, in] layout."""
    B, N, C = x.shape
    D = C // num_heads
    dt = x.dtype
    y, q, k, v, p, o, attn = _attention_plain(x, gamma, beta, w_qkv, b_qkv,
                                              num_heads, eps)
    do = dout.to(dt)
    # proj backward: dp == do
    acc_t = at_least_f32(dt)
    do_attn = (do.to(acc_t) @ weight_f32(w_proj, dt)).to(dt)
    grads = core_bwd_plain(q, k, v, p, o, _heads(do_attn, num_heads),
                           D ** -0.5)
    # [3, B, H, N, D] -> [B, N, 3, H, D]: the qkv column order
    dqkv = torch.stack(grads).to(dt).permute(1, 3, 0, 2, 4) \
        .reshape(B, N, 3 * C)
    dy = dqkv.to(acc_t) @ weight_f32(w_qkv, dt)         # [B, N, C] f32
    dx, dgamma, dbeta, db_proj = ln_bwd_plain(x, gamma, dy, do, eps)
    return (dx, dgamma, dbeta, rows_t_dot(dqkv, y),
            dqkv.to(acc_t).sum((0, 1)), rows_t_dot(do, attn), db_proj)


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
        if t.device != x.device or t.dtype != _F32:
            raise TypeError(f"{name}: {pname} must be float32 on {x.device}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {pname} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def bf16_contiguous(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous, 16-byte aligned bf16 tensor (a copy where it is
    not one)."""
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def cast_weight(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """A weight matrix in `dtype` (w itself if it is in it already). The
    copy's bytes are counted under profiling's `weight_cast_bytes`: eager
    work only, since a copy made while a CUDA graph is captured launches
    nothing and a replay's copies are kernels of its graph, which no host
    code runs."""
    out = w.to(dtype)
    if out is not w and profiling.recording() and not (
            out.is_cuda and torch.cuda.is_current_stream_capturing()):
        profiling.count("weight_cast_bytes", out.numel() * out.element_size())
    return out


def weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """An f32 weight as the kernels' bf16 operand, its cast counted."""
    return bf16_contiguous(cast_weight(w))


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


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, layout: int, epilogue: int,
              bias: torch.Tensor | None = None,
              aux: torch.Tensor | None = None) -> torch.Tensor | tuple:
    """epilogue(A . B) on bf16 operands (csrc/block_gemm.cu:ag_gemm_bf16).

    NT: a [M, K], b [N, K]; NN: a [M, K], b [K, N]; TN: a [K, M], b [K, N].
    bias [N] for the EPI_BIAS* epilogues; aux [M, N] bf16 is the residual
    (EPI_BIAS_RESIDUAL) or the fc1 output h (EPI_DGELU). Returns the f32
    (EPI_F32) or bf16 output, and for EPI_BIAS_GELU_AUX the pair (h, gelu(h)).
    Raises ValueError on a shape the kernel does not take: N, and the rows
    of the operands it reads by TMA (K for NT and NN, M for TN), multiples
    of 8 elements.
    """
    for name, t in (("a", a), ("b", b), ("aux", aux)):
        if t is not None and (t.dtype != torch.bfloat16
                              or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"gemm_cuda: {name} must be a contiguous, "
                             f"16-byte aligned bf16 tensor")
    if layout == LAYOUT_TN:
        K, M = a.shape
    else:
        M, K = a.shape
    N = b.shape[0] if layout == LAYOUT_NT else b.shape[1]
    if (b.shape[1] if layout == LAYOUT_NT else b.shape[0]) != K:
        raise ValueError(f"gemm_cuda: inner dimensions {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ (layout {layout})")
    lib = _build.lib()
    splits = lib.ag_gemm_splits(M, N, K, layout)
    if splits == 0:
        raise ValueError(f"gemm_cuda: M={M}, N={N}, K={K} (layout {layout}) "
                         f"is not a shape the kernel takes: N, and K for NT "
                         f"and NN or M for TN, must be multiples of 8")
    out = torch.empty((M, N), device=a.device,
                      dtype=_F32 if epilogue == EPI_F32 else torch.bfloat16)
    out2 = torch.empty_like(out) if epilogue == EPI_BIAS_GELU_AUX else None
    if splits > 1:          # TN: the f32 partials of its chunks of K
        out2 = torch.empty((splits, M, N), device=a.device, dtype=_F32)
    bias = None if bias is None else bf16_contiguous(bias)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.ag_gemm_bf16(
        a.data_ptr(), b.data_ptr(), ptr(bias), ptr(aux), out.data_ptr(),
        ptr(out2), M, N, K, layout, epilogue, _build.stream_ptr(a))
    _build.check(rc, "ag_gemm_bf16")
    return out if epilogue != EPI_BIAS_GELU_AUX else (out, out2)


def gemm_nt_cuda(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 epilogue: int, residual: torch.Tensor | None = None):
    """epilogue(a . w^T + b) with a [M, K] bf16 and f32 w [N, K], b [N]."""
    return gemm_cuda(a, weight_bf16(w), LAYOUT_NT, epilogue, bias=b, aux=residual)


def norm_groups(rows: int) -> tuple[int, int]:
    """(rows per block, blocks) of the LayerNorm backward: runs of whole
    NORM_WARPS rows, about NORM_BLOCKS of them where the rows allow. The
    blocks' partial sums are added in block order, so the split, a function
    of the shape only, fixes the result bit for bit."""
    per = NORM_WARPS * -(-rows // (NORM_BLOCKS * NORM_WARPS))
    return per, -(-rows // per)


def colsum_groups(rows: int, cols: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of a column sum: runs of whole COLSUM_LANES
    rows, so that about COLSUM_BLOCKS blocks of COLSUM_COLS columns fill
    the card where the rows allow; a function of the shape only, as
    norm_groups."""
    want = max(1, COLSUM_BLOCKS // -(-cols // COLSUM_COLS))
    per = COLSUM_LANES * -(-rows // (want * COLSUM_LANES))
    return per, -(-rows // per)


def _check_rows(name: str, cols: int, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor is contiguous and 16-byte aligned and the
    rows hold whole 16-byte loads (cols a multiple of 8)."""
    if cols % 8:
        raise ValueError(f"{name}: {cols} columns, not a multiple of 8")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous and 16-byte "
                         f"aligned")


def layernorm_bwd_cuda(x2d, gamma, dy, dres, eps: float):
    """(dx bf16, dgamma, dbeta, db_res f32) (csrc/block_norm_bwd.cu): x2d,
    dres bf16 and dy f32 [rows, cols], cols a multiple of 8 and at most
    NORM_MAX_COLS."""
    rows, cols = x2d.shape
    if cols > NORM_MAX_COLS:
        raise ValueError(f"layernorm_bwd_cuda: {cols} columns; the kernel "
                         f"holds a row in registers, at most {NORM_MAX_COLS}")
    gamma = gamma.contiguous()
    _check_rows("layernorm_bwd_cuda", cols, x2d, gamma, dy, dres)
    per, groups = norm_groups(rows)
    dx = torch.empty_like(x2d)
    sums = torch.empty((3, cols), device=x2d.device, dtype=_F32)
    scratch = torch.empty((groups, 3 * cols), device=x2d.device, dtype=_F32)
    rc = _build.lib().ag_layernorm_bwd_bf16(
        x2d.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dres.data_ptr(),
        dx.data_ptr(), scratch.data_ptr(), sums.data_ptr(), rows, cols, eps,
        per, groups, _build.stream_ptr(x2d))
    _build.check(rc, "ag_layernorm_bwd_bf16")
    return (dx, *sums)


def colsum_cuda(t: torch.Tensor) -> torch.Tensor:
    """f32 column sums of a contiguous, 16-byte aligned bf16 [rows, cols]
    tensor, cols a multiple of 8."""
    rows, cols = t.shape
    _check_rows("colsum_cuda", cols, t)
    per, chunks = colsum_groups(rows, cols)
    scratch = torch.empty((chunks, cols), device=t.device, dtype=_F32)
    out = torch.empty(cols, device=t.device, dtype=_F32)
    rc = _build.lib().ag_colsum_bf16(t.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr(), rows, cols, per, chunks,
                                     _build.stream_ptr(t))
    _build.check(rc, "ag_colsum_bf16")
    return out


def attention_core_cuda(qkv: torch.Tensor, B: int, N: int,
                        num_heads: int) -> torch.Tensor:
    C = qkv.shape[1] // 3
    D = C // num_heads
    out = torch.empty((B * N, C), dtype=torch.bfloat16, device=qkv.device)
    rc = _build.lib().ag_attention_core_bf16(
        qkv.data_ptr(), out.data_ptr(), B, N, num_heads, D, D ** -0.5,
        _build.stream_ptr(qkv))
    _build.check(rc, "ag_attention_core_bf16")
    return out


def _row_stats(B: int, N: int, H: int, device) -> torch.Tensor:
    """The backward cores' f32 scratch: each query row's max m, sum l and
    d_row, written by their first phase and read by the dK/dV phase."""
    return torch.empty((3, B, H, N), dtype=_F32, device=device)


def attention_core_bwd_cuda(qkv: torch.Tensor, do_attn: torch.Tensor, B: int,
                            N: int, num_heads: int) -> torch.Tensor:
    C = qkv.shape[1] // 3
    D = C // num_heads
    dqkv = torch.empty_like(qkv)
    stats = _row_stats(B, N, num_heads, qkv.device)
    rc = _build.lib().ag_attention_core_bwd_bf16(
        qkv.data_ptr(), do_attn.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        B, N, num_heads, D, D ** -0.5, _build.stream_ptr(qkv))
    _build.check(rc, "ag_attention_core_bwd_bf16")
    return dqkv


def _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int) -> None:
    C = x.shape[-1]
    check_block_operands("fused_block_attention", x, {
        "gamma": (gamma, (C,)), "beta": (beta, (C,)),
        "w_qkv": (w_qkv, (3 * C, C)), "b_qkv": (b_qkv, (3 * C,)),
        "w_proj": (w_proj, (C, C)), "b_proj": (b_proj, (C,))})
    if C != 64 * num_heads:
        raise ValueError(f"fused_block_attention: head dim {C}/{num_heads} "
                         f"must be 64, the one the kernel is built for")


def _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv, B: int, N: int,
                              num_heads: int, eps: float):
    y = layernorm_cuda(x2d, gamma, beta, eps)
    qkv = gemm_nt_cuda(y, w_qkv, b_qkv, EPI_BIAS)
    return y, qkv, attention_core_cuda(qkv, B, N, num_heads)


def block_attention_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                         num_heads: int, eps: float) -> torch.Tensor:
    """The forward kernels on a CUDA tensor (checks, then launches)."""
    _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    _, _, attn = _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv, B,
                                           N, num_heads, eps)
    return gemm_nt_cuda(attn, w_proj, b_proj, EPI_BIAS_RESIDUAL,
                        residual=x2d).view(B, N, C)


def block_attention_bwd_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                             dout, num_heads: int, eps: float):
    """The backward kernels on CUDA tensors: the gradients in the order and
    dtypes of `block_attention_bwd_plain`."""
    _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    do = bf16_contiguous(dout).view(B * N, C)
    y, qkv, attn = _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv,
                                             B, N, num_heads, eps)
    do_attn = gemm_cuda(do, weight_bf16(w_proj), LAYOUT_NN, EPI_NONE)
    dqkv = attention_core_bwd_cuda(qkv, do_attn, B, N, num_heads)
    dy = gemm_cuda(dqkv, weight_bf16(w_qkv), LAYOUT_NN, EPI_F32)
    dx, dgamma, dbeta, db_proj = layernorm_bwd_cuda(x2d, gamma, dy, do, eps)
    return (dx.view(B, N, C), dgamma, dbeta,
            gemm_cuda(dqkv, y, LAYOUT_TN, EPI_F32), colsum_cuda(dqkv),
            gemm_cuda(do, attn, LAYOUT_TN, EPI_F32), db_proj)


class _FusedBlockAttention(torch.autograd.Function):
    """Saves x and the parameters only; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                num_heads, eps):
        global LAUNCHES
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj)
        ctx.num_heads, ctx.eps = num_heads, eps
        if x.device.type == "cpu":
            return block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                         b_proj, num_heads, eps)
        out = block_attention_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                   b_proj, num_heads, eps)
        LAUNCHES += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_BWD
        x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = block_attention_bwd_plain(x, gamma, beta, w_qkv, b_qkv,
                                              w_proj, dout, ctx.num_heads,
                                              ctx.eps)
        else:
            grads = block_attention_bwd_cuda(x, gamma, beta, w_qkv, b_qkv,
                                             w_proj, b_proj, dout,
                                             ctx.num_heads, ctx.eps)
            LAUNCHES_BWD += 1
        return (*grads, None, None)


def fused_block_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """x + proj(attention(LayerNorm(x))), differentiable.

    x: [B, N, C] residual stream; gamma, beta: [C]; w_qkv: [3C, C],
    b_qkv: [3C] (timm fused-qkv layout, rows ordered qkv-slot, head, dim);
    w_proj: [C, C], b_proj: [C]. A CPU tensor takes the plain versions (any
    float dtype); a CUDA tensor launches the kernels (bf16 x, f32 params).
    """
    return _FusedBlockAttention.apply(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                      b_proj, num_heads, eps)


# --- fused_attention and fused_qkv_attention ---------------------------------

def _scale(D: int, scale: float | None) -> float:
    return D ** -0.5 if scale is None else scale


def fused_attention_plain(q, k, v, scale: float | None = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of `fused_attention`'s forward, the Pallas
    `_fwd_kernel` line by line: q, k, v [B, N, H, D] in any float dtype,
    o = dtype(f32(dtype(e) . v) / l), divided after the product. Returns
    [B, N, H, D] in q.dtype."""
    dt, acc_t = q.dtype, at_least_f32(q.dtype)
    heads = lambda t: t.to(acc_t).transpose(1, 2)       # [B, H, N, D]
    e, l = _exp_scores(heads(q), heads(k), _scale(q.shape[-1], scale))
    o = (e.to(dt).to(acc_t) @ heads(v)) / l
    return o.to(dt).transpose(1, 2).contiguous()


def fused_attention_bwd_plain(q, k, v, o, do, scale: float | None = None):
    """The plain PyTorch version of the backward, the Pallas `_bwd_kernel`
    line by line: (dq, dk, dv) [B, N, H, D] in q.dtype, d_row from the saved
    output o (not recomputed)."""
    dt = q.dtype
    scale = _scale(q.shape[-1], scale)
    heads = lambda t: t.to(dt).transpose(1, 2)          # [B, H, N, D]
    q, k, v, o, do = map(heads, (q, k, v, o, do))
    e, l = _exp_scores(q, k, scale)
    grads = core_bwd_plain(q, k, v, (e / l).to(dt), o, do, scale)
    return tuple(g.to(dt).transpose(1, 2).contiguous() for g in grads)


def _row_stride(name: str, t: torch.Tensor, shape: tuple) -> int:
    """The row stride of a bf16 CUDA [B, N, H, D] tensor read as [B*N, ld]
    rows with head h at column h*D: the layouts the strided kernels take
    (a contiguous tensor, or a q/k/v view of a [B, N, 3, H, D] one)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    B, N, H, D = shape
    sb, sn, sh, sd = t.stride()
    if not ((sd == 1 or D == 1) and (sh == D or H == 1)
            and (sb == N * sn or B == 1) and sn % 8 == 0
            and t.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: strides {t.stride()} are not [B*N, ld] "
                         f"rows (ld a multiple of 8) of [H, D] heads, or the "
                         f"data is not 16-byte aligned")
    return sn


def _row_strides(name: str, tensors: dict[str, torch.Tensor]) -> list[int]:
    """Each tensor's row stride (all of q's [B, N, H, D] shape); raises
    unless the head dim is 64, the one the kernels are built for."""
    shape = tuple(tensors["q"].shape)
    lds = [_row_stride(f"{name}: {n}", t, shape) for n, t in tensors.items()]
    if shape[3] != 64:
        raise ValueError(f"{name}: head dim {shape[3]} is not 64, the one "
                         f"the kernel is built for")
    return lds


def _attention_bwd_launch(q, k, v, o, do, dq, dk, dv, scale: float) -> None:
    """dq, dk, dv of `fused_attention_cuda` through the strided backward
    core, which reads the saved output o."""
    lds = _row_strides("fused_attention_bwd",
                       {"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq,
                        "dk": dk, "dv": dv})
    B, N, H, D = q.shape
    stats = _row_stats(B, N, H, q.device)
    rc = _build.lib().ag_attention_bwd_bf16(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv)),
        stats.data_ptr(), B, N, H, D, *lds, scale, _build.stream_ptr(q))
    _build.check(rc, "ag_attention_bwd_bf16")


def fused_attention_cuda(q, k, v, scale: float | None = None
                         ) -> torch.Tensor:
    """The forward kernel on CUDA tensors: a new contiguous [B, N, H, D]
    output; q, k and v are read in place, strided views included (see
    _row_stride)."""
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lds = _row_strides("fused_attention",
                       {"q": q, "k": k, "v": v, "out": out})
    B, N, H, D = q.shape
    rc = _build.lib().ag_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
        *lds, _scale(D, scale), _build.stream_ptr(q))
    _build.check(rc, "ag_attention_bf16")
    return out


def fused_attention_bwd_cuda(q, k, v, o, do, scale: float | None = None):
    """The backward kernel on CUDA tensors: (dq, dk, dv), each a new
    contiguous bf16 [B, N, H, D] tensor."""
    grads = [torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
             for _ in range(3)]
    _attention_bwd_launch(q, k, v, o, do, *grads, _scale(q.shape[-1], scale))
    return tuple(grads)


class _FusedAttention(torch.autograd.Function):
    """Saves q, k, v and the output, as the Pallas VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        global LAUNCHES_ATTENTION
        if q.device.type == "cpu":
            out = fused_attention_plain(q, k, v, scale)
        else:
            out = fused_attention_cuda(q, k, v, scale)
            LAUNCHES_ATTENTION += 1
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_ATTENTION_BWD
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = fused_attention_bwd_plain(q, k, v, out, dout, ctx.scale)
        else:
            grads = fused_attention_bwd_cuda(
                q, k, v, out, dout.to(q.dtype).contiguous(), ctx.scale)
            LAUNCHES_ATTENTION_BWD += 1
        return (*grads, None)


def fused_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per (batch, head), differentiable.

    q, k, v: [B, N, H, D] (on CUDA: bf16, D = 64, each a view of [B*N, ld]
    rows with the heads side by side, e.g. a slot of a [B, N, 3, H, D] qkv
    tensor; no copy is made). scale defaults to D^-1/2. Returns [B, N, H, D]
    in q's dtype. A CPU tensor takes the plain versions (any float dtype); a
    CUDA tensor launches the kernels or raises.
    """
    return _FusedAttention.apply(q, k, v, scale)


def fused_qkv_attention_plain(x, w_qkv, b_qkv, num_heads: int,
                              scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of `fused_qkv_attention`'s forward, the
    Pallas `_qkv_fwd_kernel` line by line: qkv = dtype(f32(x . W^T) +
    f32(dtype(b))), then the attention of `fused_attention_plain`. Returns
    the head-merged [B, N, C] in x.dtype."""
    B, N, C = x.shape
    qkv = linear_plain(x, w_qkv, b_qkv).view(B, N, 3, num_heads,
                                             C // num_heads)
    return fused_attention_plain(*qkv.unbind(2), scale).view(B, N, C)


def fused_qkv_attention_bwd_plain(x, w_qkv, b_qkv, out, dout,
                                  num_heads: int,
                                  scale: float | None = None):
    """The plain PyTorch version of the backward (`_qkv_bwd_kernel` and the
    three contractions of `_fused_qkv_bwd`): (dx in x.dtype, dw_qkv [3C, C]
    f32, db_qkv [3C] f32), d_row from the saved output."""
    B, N, C = x.shape
    dt = x.dtype
    heads = (B, N, num_heads, C // num_heads)
    qkv = linear_plain(x, w_qkv, b_qkv).view(B, N, 3, *heads[2:])
    grads = fused_attention_bwd_plain(*qkv.unbind(2), out.reshape(heads),
                                      dout.reshape(heads), scale)
    dqkv = torch.stack(grads, 2).reshape(B, N, 3 * C)   # qkv column order
    acc_t = at_least_f32(dt)
    dx = (dqkv.to(acc_t) @ weight_f32(w_qkv, dt)).to(dt)
    return dx, rows_t_dot(dqkv, x), dqkv.to(acc_t).sum((0, 1))


def _check_qkv(x, w_qkv, b_qkv, num_heads: int) -> None:
    C = x.shape[-1]
    check_block_operands("fused_qkv_attention", x, {
        "w_qkv": (w_qkv, (3 * C, C)), "b_qkv": (b_qkv, (3 * C,))})
    if C != 64 * num_heads:
        raise ValueError(f"fused_qkv_attention: head dim {C}/{num_heads} "
                         f"must be 64, the one the kernel is built for")


def _qkv_heads(x, w_qkv, b_qkv, num_heads: int):
    """The qkv GEMM (NT, bias) and its q, k, v views [B, N, H, D]."""
    B, N, C = x.shape
    qkv = gemm_nt_cuda(x.view(B * N, C), w_qkv, b_qkv, EPI_BIAS)
    return qkv, qkv.view(B, N, 3, num_heads, C // num_heads).unbind(2)


def fused_qkv_attention_cuda(x, w_qkv, b_qkv, num_heads: int,
                             scale: float | None = None) -> torch.Tensor:
    """The forward kernels on CUDA tensors (checks, then launches)."""
    _check_qkv(x, w_qkv, b_qkv, num_heads)
    B, N, C = x.shape
    _, (q, k, v) = _qkv_heads(x, w_qkv, b_qkv, num_heads)
    return fused_attention_cuda(q, k, v, scale).view(B, N, C)


def fused_qkv_attention_bwd_cuda(x, w_qkv, b_qkv, out, dout, num_heads: int,
                                 scale: float | None = None):
    """The backward kernels on CUDA tensors: the gradients in the order and
    dtypes of `fused_qkv_attention_bwd_plain`."""
    _check_qkv(x, w_qkv, b_qkv, num_heads)
    B, N, C = x.shape
    qkv, (q, k, v) = _qkv_heads(x, w_qkv, b_qkv, num_heads)
    dqkv = torch.empty_like(qkv)
    heads = (B, N, num_heads, C // num_heads)
    _attention_bwd_launch(q, k, v, out.view(heads), dout.view(heads),
                          *dqkv.view(B, N, 3, *heads[2:]).unbind(2),
                          _scale(heads[3], scale))
    dx = gemm_cuda(dqkv, weight_bf16(w_qkv), LAYOUT_NN, EPI_NONE)
    return (dx.view(B, N, C), gemm_cuda(dqkv, x.view(B * N, C), LAYOUT_TN,
                                        EPI_F32), colsum_cuda(dqkv))


class _FusedQKVAttention(torch.autograd.Function):
    """Saves x, the parameters and the output, as the Pallas VJP does."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, num_heads, scale):
        global LAUNCHES_QKV
        if x.device.type == "cpu":
            out = fused_qkv_attention_plain(x, w_qkv, b_qkv, num_heads, scale)
        else:
            out = fused_qkv_attention_cuda(x, w_qkv, b_qkv, num_heads, scale)
            LAUNCHES_QKV += 1
        ctx.save_for_backward(x, w_qkv, b_qkv, out)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        global LAUNCHES_QKV_BWD
        x, w_qkv, b_qkv, out = ctx.saved_tensors
        dout = dout.to(x.dtype)
        if x.device.type == "cpu":
            grads = fused_qkv_attention_bwd_plain(x, w_qkv, b_qkv, out, dout,
                                                  ctx.num_heads, ctx.scale)
        else:
            grads = fused_qkv_attention_bwd_cuda(
                x, w_qkv, b_qkv, out, dout.contiguous(), ctx.num_heads,
                ctx.scale)
            LAUNCHES_QKV_BWD += 1
        return (*grads, None, None)


def fused_qkv_attention(x, w_qkv, b_qkv, num_heads: int,
                        scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with (q, k, v) = x . W_qkv^T + b_qkv, heads
    merged, differentiable.

    x: [B, N, C]; w_qkv: [3C, C], b_qkv: [3C] (timm fused-qkv layout, rows
    ordered qkv-slot, head, dim). Returns [B, N, C] in x's dtype, ready for
    the output projection; the backward gives dx in x's dtype and f32 dw, db.
    A CPU tensor takes the plain versions (any float dtype); a CUDA tensor
    launches the kernels (bf16 x, f32 params, head dim 64) or raises.
    """
    return _FusedQKVAttention.apply(x, w_qkv, b_qkv, num_heads, scale)
