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

Windows (Swin's blocks): x is [B*nW, N, C], each window one "image" of N
tokens, and two optional inputs join the scores before the softmax: `bias`,
an f32 [H, N, N] (the relative-position bias gathered from its table),
differentiable, and `regions`, the int32 [nW, N] shift region of each token
of window b mod nW, from which the shift mask adds MASKED (-100, timm's)
between tokens of different regions (`region_mask`), not learned: s =
((f32(q . k) * scale) + bias) + mask. At head dim WINDOW_D = 32 (c) and
(f) are the windowed cores (`ag_window_attention_bf16`,
`ag_window_attention_bwd_bf16`, for windows of at most WINDOW_MAX_N
tokens: a block of ceil(N/16) warps walks a run of whole windows of one
head), with or without either input, whose backward also returns dBias =
the sum over the windows of dS in f32, summed in a fixed order; they count
as window_attention_core / window_attention_core_bwd (ops/launches.py). At
D = 64 (ViT) the block runs the kernels above, which take neither input.

Weights keep nn.Linear's [out, in] layout. As `_block_operands` does, the
wrappers cast the f32 weights and biases to bf16 and keep gamma/beta f32;
the weights' casts go through `cast_weight` (ops/block_gemm.py, with the
GEMM, LayerNorm and column-sum launches the block runs), which counts their
bytes.

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

from artgraph_tpu_torch.ops import _build, launches
from artgraph_tpu_torch.ops.block_gemm import (
    EPI_BIAS, EPI_BIAS_RESIDUAL, EPI_F32, EPI_NONE, LAYOUT_NN, LAYOUT_TN,
    at_least_f32, bf16_contiguous, check_block_operands, colsum_cuda,
    gemm_cuda, gemm_nt_cuda, layernorm_bwd_cuda, layernorm_cuda, linear_plain,
    ln_bwd_plain, ln_rows_plain, rows_t_dot, weight_bf16, weight_f32)

# csrc/block_attention_bwd.cu, windowed: the blocks of (run of windows,
# head) that fill the card, one an SM (WIN_BLOCKS, csrc/attention_tiles.cuh:
# a block holds more than half an SM's shared memory); phases 1 and 3 sum
# each run's dS on chip into the run's dBias partial
WINDOW_BLOCKS = 132
# the windowed cores' one head dim (WIN_D, csrc/attention_tiles.cuh:
# Swin's) and their windows of at most 160 tokens (WIN_MAX_N; Swin's 12x12
# windows are 144): a block holds a window's keys
WINDOW_D, WINDOW_MAX_N = 32, 160
HEAD_DIMS = (64, WINDOW_D)

_F32 = torch.float32


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = t.shape
    return t.view(B, N, num_heads, C // num_heads).transpose(1, 2)


MASKED = -100.0   # the shift mask's score between regions (timm's)


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """[nW, N, N] f32: 0 where query i's and key j's shift regions agree,
    MASKED where they differ: timm's attn_mask from its region ids."""
    diff = regions[:, :, None] != regions[:, None, :]
    return torch.where(diff, MASKED, 0.0).to(torch.float32)


def add_scores_plain(s: torch.Tensor, bias: torch.Tensor | None = None,
                     regions: torch.Tensor | None = None) -> torch.Tensor:
    """((s + bias) + mask) on scores s [B, H, N, N] in s's dtype: bias
    [H, N, N], mask the region_mask of regions [nW, N], taken by window b
    as row b mod nW (B a multiple of nW); either may be None."""
    if bias is not None:
        s = s + bias.to(s.dtype)
    if regions is not None:
        B, H, N, _ = s.shape
        nW = regions.shape[0]
        s = (s.view(B // nW, nW, H, N, N)
             + region_mask(regions).to(s.dtype)[:, None]).view(B, H, N, N)
    return s


def _exp_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                bias: torch.Tensor | None = None,
                regions: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(e, l) of q, k [..., N, D]: s = f32(q . k^T) * scale (plus the
    windows' bias and mask, `add_scores_plain`), e = exp(s - rowmax(s)) and
    its row sums l, all f32 (f64 for f64 q)."""
    acc_t = at_least_f32(q.dtype)
    s = (q.to(acc_t) @ k.to(acc_t).transpose(-1, -2)) * scale
    if bias is not None or regions is not None:
        s = add_scores_plain(s, bias, regions)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True)


def core_plain(q, k, v, scale: float, bias: torch.Tensor | None = None,
               regions: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block path's attention core on [B, H, N, D] heads in any float
    dtype: (p, o) with p = dtype(e / l) and o = f32(p . v), unrounded; the
    windows' bias [H, N, N] and the mask of regions [nW, N] join the scaled
    scores."""
    e, l = _exp_scores(q, k, scale, bias, regions)
    p = (e / l).to(q.dtype)
    return p, p.to(e.dtype) @ v.to(e.dtype)


def core_bwd_plain(q, k, v, p, o, do, scale: float, bias_grad: bool = False):
    """The core's backward, the Pallas backward kernels line by line: (dq,
    dk, dv) in f32 from the rounded probabilities p and the output o that
    d_row reads (the f32 o of `core_plain` on the block path, the saved
    output on the fused_attention path); inputs [..., N, D], rounded at
    q.dtype. `bias_grad` appends dBias = the sum over dim 0 (the windows)
    of p (dp - d_row), f32 and unrounded: the scores' gradient before the
    scale."""
    acc_t = at_least_f32(q.dtype)
    qf, kf, vf, pf, dof = (t.to(acc_t) for t in (q, k, v, p, do))
    dv = pf.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    d_row = (dof * o.to(acc_t)).sum(-1, keepdim=True)
    g = pf * (dp - d_row)
    ds = (g * scale).to(q.dtype).to(acc_t)
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, dv)
    return (*grads, g.sum(0)) if bias_grad else grads


def _attention_plain(x, gamma, beta, w_qkv, b_qkv, num_heads: int,
                     eps: float, bias=None, regions=None):
    """Forward up to the attention output: (y, q, k, v, p, o f32, attn)."""
    B, N, C = x.shape
    D = C // num_heads
    y = ln_rows_plain(x, gamma, beta, eps)
    qkv = linear_plain(y, w_qkv, b_qkv)                  # [B, N, 3C]
    q, k, v = qkv.view(B, N, 3, num_heads, D).permute(2, 0, 3, 1, 4)
    p, o = core_plain(q, k, v, D ** -0.5, bias, regions)
    attn = o.to(x.dtype).transpose(1, 2).reshape(B, N, C)
    return y, q, k, v, p, o, attn


def block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6, bias=None,
                          regions=None) -> torch.Tensor:
    """The plain PyTorch version of `fused_block_attention`'s forward."""
    attn = _attention_plain(x, gamma, beta, w_qkv, b_qkv, num_heads, eps,
                            bias, regions)[-1]
    return x + linear_plain(attn, w_proj, b_proj)


def block_attention_bwd_plain(x, gamma, beta, w_qkv, b_qkv, w_proj, dout,
                              num_heads: int, eps: float = 1e-6, bias=None,
                              regions=None):
    """The plain PyTorch version of the backward, `_block_bwd_kernel` line
    by line: (dx, dgamma, dbeta, dw_qkv, db_qkv, dw_proj, db_proj), dx in
    x.dtype, the rest f32, weights in [out, in] layout; with a bias, its
    f32 gradient dBias [H, N, N] last."""
    B, N, C = x.shape
    D = C // num_heads
    dt = x.dtype
    y, q, k, v, p, o, attn = _attention_plain(x, gamma, beta, w_qkv, b_qkv,
                                              num_heads, eps, bias, regions)
    do = dout.to(dt)
    # proj backward: dp == do
    acc_t = at_least_f32(dt)
    do_attn = (do.to(acc_t) @ weight_f32(w_proj, dt)).to(dt)
    grads = core_bwd_plain(q, k, v, p, o, _heads(do_attn, num_heads),
                           D ** -0.5, bias_grad=bias is not None)
    # [3, B, H, N, D] -> [B, N, 3, H, D]: the qkv column order
    dqkv = torch.stack(grads[:3]).to(dt).permute(1, 3, 0, 2, 4) \
        .reshape(B, N, 3 * C)
    dy = dqkv.to(acc_t) @ weight_f32(w_qkv, dt)         # [B, N, C] f32
    dx, dgamma, dbeta, db_proj = ln_bwd_plain(x, gamma, dy, do, eps)
    return (dx, dgamma, dbeta, rows_t_dot(dqkv, y),
            dqkv.to(acc_t).sum((0, 1)), rows_t_dot(do, attn), db_proj,
            *grads[3:])


def windowed(C: int, num_heads: int) -> bool:
    """Whether a block takes the windowed cores: head dim WINDOW_D."""
    return C == WINDOW_D * num_heads


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _n_windows(regions: torch.Tensor | None) -> int:
    return 1 if regions is None else regions.shape[0]


def attention_core_cuda(qkv: torch.Tensor, B: int, N: int, num_heads: int,
                        bias: torch.Tensor | None = None,
                        regions: torch.Tensor | None = None) -> torch.Tensor:
    C = qkv.shape[1] // 3
    D = C // num_heads
    out = torch.empty((B * N, C), dtype=torch.bfloat16, device=qkv.device)
    lib, stream = _build.lib(), _build.stream_ptr(qkv)
    if windowed(C, num_heads):
        rc = lib.ag_window_attention_bf16(
            qkv.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(regions),
            _n_windows(regions), B, N, num_heads, D, D ** -0.5, stream)
        _build.check(rc, "ag_window_attention_bf16")
        return out
    rc = lib.ag_attention_core_bf16(
        qkv.data_ptr(), out.data_ptr(), B, N, num_heads, D, D ** -0.5, stream)
    _build.check(rc, "ag_attention_core_bf16")
    return out


def _row_stats(B: int, N: int, H: int, device) -> torch.Tensor:
    """The backward cores' f32 scratch: each query row's max m, sum l and
    d_row, written by their first phase and read by the dK/dV phase."""
    return torch.empty((3, B, H, N), dtype=_F32, device=device)


def window_runs(B: int, num_heads: int) -> tuple[int, int]:
    """(windows a run, runs) of the windowed backward: about WINDOW_BLOCKS
    blocks of (run, head), as the forward's win_per_run. The runs' dBias
    partials are added in run order, so the split, a function of the shape
    only, fixes dBias bit for bit."""
    per = max(1, -(-B * num_heads // WINDOW_BLOCKS))
    return per, -(-B // per)


def attention_core_bwd_cuda(qkv: torch.Tensor, do_attn: torch.Tensor, B: int,
                            N: int, num_heads: int,
                            bias: torch.Tensor | None = None,
                            regions: torch.Tensor | None = None):
    """(dqkv, dBias): dBias f32 [H, N, N] on the windowed path with a
    bias, else None."""
    C = qkv.shape[1] // 3
    D = C // num_heads
    dqkv = torch.empty_like(qkv)
    stats = _row_stats(B, N, num_heads, qkv.device)
    lib, stream = _build.lib(), _build.stream_ptr(qkv)
    if not windowed(C, num_heads):
        rc = lib.ag_attention_core_bwd_bf16(
            qkv.data_ptr(), do_attn.data_ptr(), dqkv.data_ptr(),
            stats.data_ptr(), B, N, num_heads, D, D ** -0.5, stream)
        _build.check(rc, "ag_attention_core_bwd_bf16")
        return dqkv, None
    per, runs = window_runs(B, num_heads)
    dbias = part = bias_t = None
    if bias is not None:
        # key-major, so that phase 2 (K Q^T) reads the bias in pairs too
        bias_t = bias.transpose(1, 2).contiguous()
        dbias = torch.empty((num_heads, N, N), dtype=_F32, device=qkv.device)
        part = torch.empty((runs, num_heads, N, N), dtype=_F32,
                           device=qkv.device)
    rc = lib.ag_window_attention_bwd_bf16(
        qkv.data_ptr(), do_attn.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        _ptr(bias), _ptr(bias_t), _ptr(regions), _n_windows(regions),
        _ptr(part), _ptr(dbias),
        per, B, N, num_heads, D, D ** -0.5, stream)
    _build.check(rc, "ag_window_attention_bwd_bf16")
    return dqkv, dbias


def _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, bias=None, regions=None) -> None:
    B, N, C = x.shape
    check_block_operands("fused_block_attention", x, {
        "gamma": (gamma, (C,)), "beta": (beta, (C,)),
        "w_qkv": (w_qkv, (3 * C, C)), "b_qkv": (b_qkv, (3 * C,)),
        "w_proj": (w_proj, (C, C)), "b_proj": (b_proj, (C,))})
    if C not in tuple(d * num_heads for d in HEAD_DIMS):
        raise ValueError(f"fused_block_attention: head dim {C}/{num_heads} "
                         f"must be one the kernels are built for, "
                         f"{HEAD_DIMS}")
    for name, t, dtype, shape in (
            ("bias", bias, _F32, (num_heads, N, N)),
            ("regions", regions, torch.int32,
             (None if regions is None else regions.shape[0], N))):
        if t is not None and (t.device != x.device or t.dtype != dtype
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"fused_block_attention: {name} must be a "
                             f"contiguous {dtype} {list(shape)} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not windowed(C, num_heads) and (bias is not None
                                       or regions is not None):
        raise ValueError(f"fused_block_attention: a bias or shift regions "
                         f"at head dim {C // num_heads}; only the windowed "
                         f"cores, at head dim {WINDOW_D}, take them")
    if windowed(C, num_heads) and N > WINDOW_MAX_N:
        raise ValueError(f"fused_block_attention: windows of {N} tokens; "
                         f"the windowed cores take at most {WINDOW_MAX_N}")
    if regions is not None and B % regions.shape[0]:
        raise ValueError(f"fused_block_attention: {B} windows are not whole "
                         f"groups of the regions' {regions.shape[0]}")


def _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv, B: int, N: int,
                              num_heads: int, eps: float, bias=None,
                              regions=None):
    y = layernorm_cuda(x2d, gamma, beta, eps)
    qkv = gemm_nt_cuda(y, w_qkv, b_qkv, EPI_BIAS)
    return y, qkv, attention_core_cuda(qkv, B, N, num_heads, bias, regions)


def block_attention_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                         num_heads: int, eps: float, bias=None,
                         regions=None) -> torch.Tensor:
    """The forward kernels on a CUDA tensor (checks, then launches)."""
    _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                     bias, regions)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    _, _, attn = _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv, B,
                                           N, num_heads, eps, bias, regions)
    return gemm_nt_cuda(attn, w_proj, b_proj, EPI_BIAS_RESIDUAL,
                        residual=x2d).view(B, N, C)


def block_attention_bwd_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                             dout, num_heads: int, eps: float, bias=None,
                             regions=None):
    """The backward kernels on CUDA tensors: the gradients in the order and
    dtypes of `block_attention_bwd_plain`."""
    _check_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, num_heads,
                     bias, regions)
    B, N, C = x.shape
    x2d = x.view(B * N, C)
    do = bf16_contiguous(dout).view(B * N, C)
    y, qkv, attn = _recompute_attention_cuda(x2d, gamma, beta, w_qkv, b_qkv,
                                             B, N, num_heads, eps, bias,
                                             regions)
    do_attn = gemm_cuda(do, weight_bf16(w_proj), LAYOUT_NN, EPI_NONE)
    dqkv, dbias = attention_core_bwd_cuda(qkv, do_attn, B, N, num_heads,
                                          bias, regions)
    dy = gemm_cuda(dqkv, weight_bf16(w_qkv), LAYOUT_NN, EPI_F32)
    dx, dgamma, dbeta, db_proj = layernorm_bwd_cuda(x2d, gamma, dy, do, eps)
    return (dx.view(B, N, C), dgamma, dbeta,
            gemm_cuda(dqkv, y, LAYOUT_TN, EPI_F32), colsum_cuda(dqkv),
            gemm_cuda(do, attn, LAYOUT_TN, EPI_F32), db_proj,
            *(() if dbias is None else (dbias,)))


class _FusedBlockAttention(torch.autograd.Function):
    """Saves x and the parameters (and the bias and regions) only; the
    backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, bias,
                regions, num_heads, eps):
        ctx.save_for_backward(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                              bias, regions)
        ctx.num_heads, ctx.eps = num_heads, eps
        if x.device.type == "cpu":
            return block_attention_plain(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                         b_proj, num_heads, eps, bias, regions)
        out = block_attention_cuda(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                   b_proj, num_heads, eps, bias, regions)
        launches.count("window_attention_core"
                       if windowed(x.shape[-1], num_heads)
                       else "fused_block_attention")
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj, bias, regions = \
            ctx.saved_tensors
        if x.device.type == "cpu":
            grads = block_attention_bwd_plain(x, gamma, beta, w_qkv, b_qkv,
                                              w_proj, dout, ctx.num_heads,
                                              ctx.eps, bias, regions)
        else:
            grads = block_attention_bwd_cuda(x, gamma, beta, w_qkv, b_qkv,
                                             w_proj, b_proj, dout,
                                             ctx.num_heads, ctx.eps, bias,
                                             regions)
            launches.count("window_attention_core_bwd"
                           if windowed(x.shape[-1], ctx.num_heads)
                           else "fused_block_attention_bwd")
        dbias = grads[7] if bias is not None else None
        return (*grads[:7], dbias, None, None, None)


def fused_block_attention(x, gamma, beta, w_qkv, b_qkv, w_proj, b_proj,
                          num_heads: int, eps: float = 1e-6,
                          bias: torch.Tensor | None = None,
                          regions: torch.Tensor | None = None) -> torch.Tensor:
    """x + proj(attention(LayerNorm(x))), differentiable.

    x: [B, N, C] residual stream; gamma, beta: [C]; w_qkv: [3C, C],
    b_qkv: [3C] (timm fused-qkv layout, rows ordered qkv-slot, head, dim);
    w_proj: [C, C], b_proj: [C]. Windows: x [B*nW, N, C]; bias [H, N, N]
    f32 added to the scaled scores (differentiable); regions [nW, N] int32,
    the shift region of each token of window b mod nW, MASKED added between
    regions (not learned). A CPU tensor takes the plain versions (any float
    dtype); a CUDA tensor launches the kernels (bf16 x, f32 params, head dim
    64 without a bias or regions, or WINDOW_D in windows of at most
    WINDOW_MAX_N tokens).
    """
    return _FusedBlockAttention.apply(x, gamma, beta, w_qkv, b_qkv, w_proj,
                                      b_proj, bias, regions, num_heads, eps)


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
        if q.device.type == "cpu":
            out = fused_attention_plain(q, k, v, scale)
        else:
            out = fused_attention_cuda(q, k, v, scale)
            launches.count("fused_attention")
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = fused_attention_bwd_plain(q, k, v, out, dout, ctx.scale)
        else:
            grads = fused_attention_bwd_cuda(
                q, k, v, out, dout.to(q.dtype).contiguous(), ctx.scale)
            launches.count("fused_attention_bwd")
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
        if x.device.type == "cpu":
            out = fused_qkv_attention_plain(x, w_qkv, b_qkv, num_heads, scale)
        else:
            out = fused_qkv_attention_cuda(x, w_qkv, b_qkv, num_heads, scale)
            launches.count("fused_qkv_attention")
        ctx.save_for_backward(x, w_qkv, b_qkv, out)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w_qkv, b_qkv, out = ctx.saved_tensors
        dout = dout.to(x.dtype)
        if x.device.type == "cpu":
            grads = fused_qkv_attention_bwd_plain(x, w_qkv, b_qkv, out, dout,
                                                  ctx.num_heads, ctx.scale)
        else:
            grads = fused_qkv_attention_bwd_cuda(
                x, w_qkv, b_qkv, out, dout.contiguous(), ctx.num_heads,
                ctx.scale)
            launches.count("fused_qkv_attention_bwd")
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
