"""The fused 1x1-conv + BatchNorm-statistics unit of the ResNet bottleneck,
both directions.

Port of artgraph_tpu/ops/conv_bn.py:conv1x1_bn_stats, a `jax.custom_vjp` over
two Pallas kernels (`_fwd_kernel`, `_bwd_kernel`), here a
`torch.autograd.Function` over hand-written launches from csrc/conv_bn.cu on
PyTorch's current stream. Per 1x1 conv over the rows x [M, K] of an NHWC
activation (M = B*H*W):

    z    = bf16(max(f32(x) * f32(a) + f32(b), 0))   (optional prologue: the
                                                      previous BN's apply +
                                                      ReLU, rounded once)
    y    = bf16(z . W^T)                             (f32 accumulation)
    s1   = sum_rows f32(y),  s2 = sum_rows f32(y)^2  (from the ROUNDED y)

and the single-pass backward from the cotangents (dy, ds1, ds2):

    dyt  = bf16(f32(dy) + ds1 + 2 f32(y) ds2)
    dz   = dyt . W                                   (f32)
    dx   = bf16(where(zf > 0, dz, 0) * a)            (bf16(dz) without the
                                                      prologue)
    da   = sum_rows where(zf > 0, dz, 0) * f32(x),  db = sum_rows of the same
                                                     without x (0 without
                                                      the prologue)
    dW   = dyt^T . z                                 (f32)

The BatchNorm chain stays outside the unit (models/resnet.py:MixedBatchNorm
takes the raw moments), as in the JAX package. The weight is the conv's
OIHW [N, K, 1, 1] viewed as [N, K] (the JAX unit takes [K, N]); dW comes back
in that layout, in the weight's dtype, da and db in those of a and b.

`conv1x1_bn_stats_plain` and `conv1x1_bn_stats_bwd_plain` follow the Pallas
kernels' rounding points, so kernel and plain versions differ only in the
order of accumulation. A CPU tensor runs them; a CUDA tensor launches the
kernels (bf16 x, K and N multiples of 32) or raises.
"""
from __future__ import annotations

import torch

from artgraph_tpu_torch.ops import _build

# Launches of the CUDA forward / backward by `conv1x1_bn_stats` since the last
# reset (one per call of the unit, however many kernels it runs).
LAUNCHES = 0
LAUNCHES_BWD = 0

# rows of one GEMM block tile (csrc/conv_bn.cu BM): one f32 row of partial
# column sums per tile of rows
ROW_TILE = 128
# the card's block slots for the unit's products (132 SMs, two blocks each):
# the weight gradient splits its M rows, and the input gradient (where its
# grid is smaller) its N columns, into chunks of a multiple of the k step
SPLIT_STEP = 32
TARGET_BLOCKS = 264
DW_MIN_CHUNK = 256
DZ_MIN_CHUNK = 512

_F32 = torch.float32


def _prologue_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(zf f32, z in x.dtype): the scale-shift in f32 from the x.dtype-rounded
    a and b, then ReLU, rounded once."""
    dt = x.dtype
    zf = x.to(_F32) * a.to(dt).to(_F32) + b.to(dt).to(_F32)
    return zf, torch.clamp(zf, min=0.0).to(dt)


def conv1x1_bn_stats_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           w: torch.Tensor, prologue: bool):
    """The plain PyTorch version of the forward: (y in x.dtype, s1, s2 f32)."""
    dt = x.dtype
    z = _prologue_plain(x, a, b)[1] if prologue else x
    y = (z.to(_F32) @ w.to(dt).to(_F32).t()).to(dt)
    yf = y.to(_F32)
    return y, yf.sum(0), (yf * yf).sum(0)


def conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy, ds1, ds2, prologue: bool):
    """The plain PyTorch version of the backward, `_bwd_kernel` line by line:
    (dx in x.dtype, da, db in a's and b's dtypes, dw [N, K] in w's dtype)."""
    dt = x.dtype
    dyt = (dy.to(_F32) + ds1.to(_F32) + 2.0 * y.to(_F32) * ds2.to(_F32)) \
        .to(dt).to(_F32)
    dz = dyt @ w.to(dt).to(_F32)                          # [M, K] f32
    if prologue:
        zf, z = _prologue_plain(x, a, b)
        dzf = torch.where(zf > 0, dz, 0.0)
        dx = (dzf * a.to(dt).to(_F32)).to(dt)
        da, db = (dzf * x.to(_F32)).sum(0), dzf.sum(0)
    else:
        z, dx = x, dz.to(dt)
        da = db = torch.zeros(x.shape[1], dtype=_F32, device=x.device)
    dw = dyt.t() @ z.to(_F32)                             # [N, K] f32
    return dx, da.to(a.dtype), db.to(b.dtype), dw.to(w.dtype)


# --- CUDA launches -----------------------------------------------------------

def _bf16_aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           w: torch.Tensor) -> tuple[int, int, int]:
    """(M, K, N), or raise on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"conv1x1_bn_stats: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv1x1_bn_stats: the CUDA kernels take bfloat16 "
                        f"x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"conv1x1_bn_stats: x must be a contiguous, 16-byte "
                         f"aligned [M, K] tensor, got {tuple(x.shape)}")
    M, K = x.shape
    if w.dim() != 2 or w.shape[1] != K:
        raise ValueError(f"conv1x1_bn_stats: w must be [N, {K}], got "
                         f"{tuple(w.shape)}")
    N = w.shape[0]
    if M < 1 or K % 32 or N % 32 or K < 32 or N < 32:
        raise ValueError(f"conv1x1_bn_stats: needs M >= 1 and K, N positive "
                         f"multiples of 32, got M={M}, K={K}, N={N}")
    for name, t in (("a", a), ("b", b), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"conv1x1_bn_stats: {name} is on {t.device}, x "
                             f"on {x.device}")
    if tuple(a.shape) != (K,) or tuple(b.shape) != (K,):
        raise ValueError(f"conv1x1_bn_stats: a and b must be [{K}]")
    return M, K, N


def _split(inner: int, tiles: int, min_chunk: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of a product's inner dimension: enough chunks
    that `tiles` output tiles fill the card, each a multiple of the k step
    and at least `min_chunk` rows."""
    want = max(1, min(-(-TARGET_BLOCKS // tiles), inner // min_chunk))
    chunk = -(-inner // want)
    chunk = -(-chunk // SPLIT_STEP) * SPLIT_STEP
    return chunk, -(-inner // chunk)


def dw_split(M: int, N: int, K: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of the weight gradient's split over M: its
    [N, K] output's 128x128 tiles."""
    return _split(M, -(-N // ROW_TILE) * -(-K // ROW_TILE), DW_MIN_CHUNK)


def dz_split(M: int, N: int, K: int) -> tuple[int, int]:
    """(columns per chunk, chunks) of the input gradient's split over N: its
    [M, K] output's 128x128 tiles (one chunk wherever they fill the card)."""
    return _split(N, -(-M // ROW_TILE) * -(-K // ROW_TILE), DZ_MIN_CHUNK)


def conv1x1_bn_stats_cuda(x, a, b, w, prologue: bool):
    """The forward kernels on a CUDA tensor (checks, then launches)."""
    M, K, N = _check(x, a, b, w)
    ac, bc, wc = (_bf16_aligned(t) for t in (a, b, w))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((-(-M // ROW_TILE), 2 * N), dtype=_F32, device=x.device)
    s1 = torch.empty(N, dtype=_F32, device=x.device)
    s2 = torch.empty_like(s1)
    rc = _build.lib().ag_conv_bn_fwd_bf16(
        x.data_ptr(), ac.data_ptr(), bc.data_ptr(), wc.data_ptr(),
        y.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(), M, K, N,
        int(prologue), _build.stream_ptr(x))
    _build.check(rc, "ag_conv_bn_fwd_bf16")
    return y, s1, s2


def conv1x1_bn_stats_bwd_cuda(x, a, b, w, y, dy, ds1, ds2, prologue: bool):
    """The backward kernels on CUDA tensors: the gradients in the order and
    dtypes of `conv1x1_bn_stats_bwd_plain`."""
    M, K, N = _check(x, a, b, w)
    if y.shape != (M, N) or dy.shape != (M, N):
        raise ValueError(f"conv1x1_bn_stats: y and dy must be [{M}, {N}]")
    ac, bc, wc = (_bf16_aligned(t) for t in (a, b, w))
    yc, dyc = _bf16_aligned(y), _bf16_aligned(dy)
    ds1c, ds2c = (t.to(_F32).contiguous() for t in (ds1, ds2))
    dev = x.device
    dyt = torch.empty_like(yc)
    dx = torch.empty_like(x)
    part = torch.empty((-(-M // ROW_TILE), 2 * K), dtype=_F32, device=dev)
    da = torch.empty(K, dtype=_F32, device=dev)
    db = torch.empty_like(da)
    chunk, splits = dw_split(M, N, K)
    dz_chunk, dz_splits = dz_split(M, N, K)
    scratch = lambda n, *shape: (torch.empty((n, *shape), dtype=_F32,
                                             device=dev) if n > 1 else None)
    dz_part, dw_part = scratch(dz_splits, M, K), scratch(splits, N, K)
    dw = torch.empty((N, K), dtype=_F32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.lib().ag_conv_bn_bwd_bf16(
        x.data_ptr(), ac.data_ptr(), bc.data_ptr(), wc.data_ptr(),
        yc.data_ptr(), dyc.data_ptr(), ds1c.data_ptr(), ds2c.data_ptr(),
        dyt.data_ptr(), dx.data_ptr(), part.data_ptr(), da.data_ptr(),
        db.data_ptr(), ptr(dz_part), ptr(dw_part), dw.data_ptr(), M, K, N,
        int(prologue), chunk, splits, dz_chunk, dz_splits,
        _build.stream_ptr(x))
    _build.check(rc, "ag_conv_bn_bwd_bf16")
    return dx, da.to(a.dtype), db.to(b.dtype), dw.to(w.dtype)


class _Conv1x1BnStats(torch.autograd.Function):
    """Saves x, a, b, w and y; the backward recomputes z from x."""

    @staticmethod
    def forward(ctx, x, a, b, w, prologue):
        global LAUNCHES
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, s1, s2 = conv1x1_bn_stats_plain(x, a, b, w, prologue)
        else:
            y, s1, s2 = conv1x1_bn_stats_cuda(x, a, b, w, prologue)
            LAUNCHES += 1
        ctx.save_for_backward(x, a, b, w, y)
        ctx.prologue = prologue
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        global LAUNCHES_BWD
        x, a, b, w, y = ctx.saved_tensors
        # a cotangent autograd leaves undefined counts as zeros
        if dy is None:
            dy = torch.zeros_like(y)
        zeros = lambda: torch.zeros(y.shape[1], dtype=_F32, device=y.device)
        ds1 = zeros() if ds1 is None else ds1
        ds2 = zeros() if ds2 is None else ds2
        if x.device.type == "cpu":
            grads = conv1x1_bn_stats_bwd_plain(x, a, b, w, y, dy, ds1, ds2,
                                               ctx.prologue)
        else:
            grads = conv1x1_bn_stats_bwd_cuda(x, a, b, w, y, dy, ds1, ds2,
                                              ctx.prologue)
            LAUNCHES_BWD += 1
        return (*grads, None)


def conv1x1_bn_stats(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     w: torch.Tensor, prologue: bool = False):
    """relu(a*x+b) (if prologue) -> x . w^T -> (y, s1, s2), differentiable.

    x: [M, K] rows (flattened NHWC); a, b: [K] scale and shift of the
    previous BatchNorm (read only with the prologue: pass zeros otherwise);
    w: [N, K] (the 1x1 conv's weight). Returns y [M, N] in x.dtype and the
    f32 per-channel raw moment sums s1, s2 [N].
    """
    return _Conv1x1BnStats.apply(x, a, b, w, prologue)
