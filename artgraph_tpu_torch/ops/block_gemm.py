"""The layer under both ViT block ops (ops/attention.py, ops/mlp.py): the
bf16 GEMM with its operand layouts and epilogues (csrc/block_gemm.cu), the
row LayerNorm, its backward and the column sums (csrc/block_norm_bwd.cu),
the weights' casts to the kernels' bf16 operands, and the plain PyTorch
pieces the block ops' twins are built from (LayerNorm, linear, GELU, GEMM).

A GEMM computes epilogue(A . B) in f32 on bf16 operands, A and B in one of
three layouts (NT: a [M, K], b [N, K]; NN: a [M, K], b [K, N]; TN: a [K, M],
b [K, N]), and rounds where the Pallas kernels round; `gemm_plain` is its
plain version at the same rounding points. `cast_weight` counts the bytes of
each weight it copies under profiling's `weight_cast_bytes`.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch import profiling
from artgraph_tpu_torch.ops import _build

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


# --- plain PyTorch pieces -------------------------------------------------

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


# --- CUDA launches --------------------------------------------------------

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
