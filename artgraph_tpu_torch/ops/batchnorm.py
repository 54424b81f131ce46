"""MixedBatchNorm's chain on hand-written kernels, train and eval, both
directions (csrc/batchnorm.cu).

models/resnet.py:MixedBatchNorm normalizes with f32 one-pass statistics and
applies bf16 coefficients; its bottleneck adds the residual in f32 and
rounds once after the ReLU. The JAX package leaves that chain to XLA, which
fuses it; PyTorch ran it as ~20 elementwise and reduce kernels a layer in
each direction. Here it runs as:

    statistics  part = (sum_rows f32(x), sum_rows f32(x)^2) per run of rows
    finishing   a, b [bf16], the running statistics (train) from the merged
                sums, or a, b from the running statistics (eval)
    apply       y = bf16(bf16(x a) + b) [ReLU]; the bottleneck's tail
                bf16(relu(f32(bn3(y3)) + f32(bnd(yd) or the identity)))

and backward, from the output's gradient g (gm: masked by the saved
output's ReLU):

    column sums  sum_rows bf16(gm x), sum_rows gm (each branch of the tail)
    finishing    da = bf16(sum), db = bf16(sum) -> dgamma, dbeta and the
                 statistics' c1 = dmean / n, c2 = dmsq / n
    dx           bf16(bf16(gm a) + bf16(c1 + c2 (2 x))); the identity's
                 gradient gm (autograd adds it to the block input's)

Each step rounds where MixedBatchNorm's expressions round under autograd,
so kernel and plain path differ only in the order of the sums. The
statistics of a layer whose sums come from its producer (the conv + BN
unit's raw moments) are its inputs s1, s2, and their gradients its outputs
ds1 = c1, ds2 = c2. Under a data-parallel step (`reduce`: a sum over the
ranks) the merged sums and n are summed between the statistics and the
finishing, and (c1, c2) between the backward's finishing and dx, as
`psum`'s forward and backward do on the plain path.

`takes(x)` is the condition on the input: a CUDA bf16 [B, C, H, W]
tensor, channels-last and dense, 16-byte aligned, C a multiple of 8. The
module's weight, bias and running statistics must be f32 [C], as
MixedBatchNorm keeps them: any other raises (a checkpoint's f32
num_batches_tracked is counted by its own add_; the kernel counts an int64
one). The plain twins below (`*_plain`) follow the kernels launch by
launch; a CPU tensor runs them, a CUDA tensor launches the kernels or
raises.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from artgraph_tpu_torch.ops import _build, launches

# csrc/batchnorm.cu: a streaming block covers up to 8 * MAX_LANES channels
# of a run of rows; the grid aims at TARGET_BLOCKS blocks (132 SMs, two
# each) of at least MIN_ROWS rows, so that a run's partial sums stay small
# beside the rows they sum
MAX_LANES = 32
TARGET_BLOCKS = 264
MIN_ROWS = 64
# the finishing merges a channel's run partials in MERGE_LANES lanes, each
# adding every MERGE_LANES-th run in order, then adds the lanes in order
MERGE_LANES = 16
FIN_MERGE, FIN_TRAIN, FIN_EVAL = 0, 1, 2

_F32 = torch.float32
_BF16 = torch.bfloat16


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take x as a BatchNorm's input: a CUDA bf16
    [B, C, H, W] tensor, channels-last and dense, 16-byte aligned, C a
    multiple of 8."""
    return (x.is_cuda and x.dtype == _BF16 and x.dim() == 4
            and x.shape[1] % 8 == 0 and x.numel() > 0
            and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0)


def row_chunks(M: int, C: int) -> tuple[int, int]:
    """(rows per run, runs) of an [M, C] launch: enough runs that the
    channel tiles x runs fill TARGET_BLOCKS, each at least MIN_ROWS rows."""
    tiles = -(-C // (8 * MAX_LANES))
    runs = max(1, min(M // MIN_ROWS, TARGET_BLOCKS // tiles))
    per = -(-M // runs)
    return per, -(-M // per)


def as_rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> its [B*H*W, C] rows, a view."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def as_nchw(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B*H*W, C] rows -> NCHW of like's batch and spatial size, in the
    channels_last layout, a view."""
    B, _, H, W = like.shape
    return rows.view(B, H, W, -1).permute(0, 3, 1, 2)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, back in f32."""
    return t.to(_BF16).to(_F32)


# --- plain twins, launch by launch (rows [M, C]) -----------------------------

def per_row(t: torch.Tensor, n) -> torch.Tensor:
    """t / n as PyTorch divides on the card: by a host number as t * (1 / n)
    (the f32 reciprocal; MixedBatchNorm's mean and its gradients), by a
    tensor exactly (the count summed over the ranks)."""
    if isinstance(n, torch.Tensor):
        return t / n
    return t * float(np.float32(1.0) / np.float32(n))


def merge_plain(p: torch.Tensor) -> torch.Tensor:
    """[C] f32: the runs' partial sums p [runs, C] added in the finishing
    kernel's order, so bit for bit its sum."""
    lanes = []
    for lane in range(MERGE_LANES):
        acc = torch.zeros_like(p[0])
        for g in range(lane, p.shape[0], MERGE_LANES):
            acc = acc + p[g]
        lanes.append(acc)
    total = torch.zeros_like(p[0])
    for acc in lanes:
        total = total + acc
    return total


def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[1, 2C] f32: (sum x, sum x^2) over the rows."""
    xf = x.to(_F32)
    return torch.cat([xf.sum(0), (xf * xf).sum(0)]).view(1, -1)


def finish_plain(s1, s2, n, bn, w, bias, train: bool):
    """(a, b [C] bf16, saved [3, C] f32 = mean, rstd, s2 / n - mean^2) from
    the sums over n rows, the running statistics of `bn` updated in place;
    eval (train False): from the running statistics."""
    if train:
        mean = per_row(s1, n)
        diff = per_row(s2, n) - mean * mean
        var = torch.clamp(diff, min=0.0)
        with torch.no_grad():
            nd = float(n)
            unbiased = var * (nd / max(nd - 1.0, 1.0))
            keep = 1.0 - bn.momentum
            bn.running_mean.copy_(keep * bn.running_mean + bn.momentum * mean)
            bn.running_var.copy_(keep * bn.running_var
                                 + bn.momentum * unbiased)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
        diff = torch.zeros_like(mean)
    rstd = torch.rsqrt(var + bn.eps)
    a = (w * rstd).to(_BF16)
    b = (bias - mean * w * rstd).to(_BF16)
    return a, b, torch.stack([mean, rstd, diff])


def _coef_out(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return _bf(_bf(x.to(_F32) * a.to(_F32)) + b.to(_F32))


def apply_plain(xs, coefs, ident, relu: bool) -> torch.Tensor:
    """bf16(bf16(x0 a0) + b0) [+ the second branch or the identity in f32]
    [ReLU], rounded to bf16; coefs: (a, b) a branch."""
    y = _coef_out(xs[0], *coefs[0])
    if len(xs) == 2:
        y = y + _coef_out(xs[1], *coefs[1])
    elif ident is not None:
        y = y + ident.to(_F32)
    if relu:
        y = torch.where(y <= 0, 0.0, y)
    return y.to(_BF16)


def _masked(g: torch.Tensor, o: Optional[torch.Tensor]) -> torch.Tensor:
    gm = g.to(_F32)
    return gm if o is None else torch.where(o <= 0, 0.0, gm)


def colsum_plain(g, o, xs) -> torch.Tensor:
    """[1, (len(xs) + 1) C] f32: sum bf16(gm x) for each x, then sum gm."""
    gm = _masked(g, o)
    sums = [_bf(gm * x.to(_F32)).sum(0) for x in xs] + [gm.sum(0)]
    return torch.cat(sums).view(1, -1)


def finish_bwd_plain(da, db, saved, w, n, train: bool):
    """(dgamma, dbeta, cs [2, C] or None) from the f32 values of the bf16
    da, db: autograd's backward of finish_plain's expressions."""
    mean, rstd, diff = saved
    du = -db * rstd
    drstd = -db * (mean * w) + da * w
    dw = du * mean + da * rstd
    if not train:
        return dw, db, None
    dvar = (-0.5 * drstd) * (rstd * rstd * rstd)
    ddiff = torch.where(diff >= 0, dvar, 0.0)
    dmean = du * w + (-ddiff) * (2.0 * mean)
    return dw, db, torch.stack([per_row(dmean, n), per_row(ddiff, n)])


def dx_plain(g, o, xs, coefs_a, css, want_identity: bool):
    """([dx per branch], did): bf16(bf16(gm a) + bf16(c1 + c2 (2 x))), the
    first term gm where a is None, the second left out where cs is None;
    did = gm (None unless wanted); g None counts as zero."""
    if g is None:
        g = torch.zeros(xs[0].shape, dtype=_BF16, device=xs[0].device)
    gm = _masked(g, o)
    out = []
    for x, a, cs in zip(xs, coefs_a, css):
        d = gm if a is None else _bf(gm * a.to(_F32))
        if cs is not None:
            d = _bf(d + _bf(cs[0] + cs[1] * (2.0 * x.to(_F32))))
        out.append(d.to(_BF16))
    return out, (gm.to(_BF16) if want_identity else None)


# --- the launches: a CUDA tensor launches, a CPU tensor runs the twin --------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_vector(name: str, t: torch.Tensor, C: int, dtype, device) -> None:
    if (t.dtype != dtype or t.shape != (C,) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"batchnorm: {name} must be a contiguous {dtype} "
                         f"[{C}] tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _stats(x: torch.Tensor) -> torch.Tensor:
    """x [M, C] rows -> partial sums [runs, 2C]."""
    if not x.is_cuda:
        return stats_plain(x)
    M, C = x.shape
    per, runs = row_chunks(M, C)
    part = torch.empty((runs, 2 * C), dtype=_F32, device=x.device)
    _build.check(_build.lib().ag_bn_stats_bf16(
        x.data_ptr(), part.data_ptr(), M, C, per, runs,
        _build.stream_ptr(x)), "ag_bn_stats_bf16")
    launches.count("batchnorm_stats")
    return part


def _finish(mode: int, bn, p1, p2, n: float, n_dev):
    """FIN_MERGE: the sums [2C + 1] = (s1, s2, n); FIN_TRAIN, FIN_EVAL:
    (a, b, saved). p1, p2: [groups, C] views of the sums to merge, one row
    stride."""
    w = bn.weight
    C = w.shape[0]
    if not w.is_cuda:
        if mode == FIN_EVAL:
            return finish_plain(None, None, n, bn, w, bn.bias, False)
        s1, s2 = merge_plain(p1), merge_plain(p2)
        if mode == FIN_MERGE:
            return torch.cat([s1, s2, s1.new_full((1,), n)])
        nn = n if n_dev is None else n_dev[0]
        return finish_plain(s1, s2, nn, bn, w, bn.bias, True)
    dev = w.device
    if mode != FIN_EVAL and (p1.stride(1) != 1 or p2.stride(1) != 1
                             or p1.stride(0) != p2.stride(0)):
        raise ValueError("batchnorm: the sums must share one row stride")
    groups, stride = (0, C) if mode == FIN_EVAL else (p1.shape[0],
                                                      p1.stride(0))
    sums = a = b = saved = nbt = None
    # the kernel adds to an int64 count; any other (a checkpoint's f32) the
    # module's own add_ below, as the plain path does
    count = bn.num_batches_tracked
    counted = (count.dtype == torch.long and count.device == dev
               and count.numel() == 1)
    if mode == FIN_TRAIN and counted:
        nbt = count
    if mode == FIN_MERGE:
        sums = torch.empty(2 * C + 1, dtype=_F32, device=dev)
    else:
        a = torch.empty(C, dtype=_BF16, device=dev)
        b = torch.empty_like(a)
        saved = torch.empty((3, C), dtype=_F32, device=dev)
    _build.check(_build.lib().ag_bn_finish(
        _ptr(p1), _ptr(p2), groups, stride, _ptr(n_dev), n, w.data_ptr(),
        bn.bias.data_ptr(), bn.running_mean.data_ptr(),
        bn.running_var.data_ptr(), _ptr(nbt), _ptr(a), _ptr(b), _ptr(saved),
        _ptr(sums), C, mode, bn.eps, bn.momentum, 1.0 - bn.momentum,
        _build.stream_ptr(w)), "ag_bn_finish")
    # under a data-parallel reduce, the merge and the finishing count once
    if mode != FIN_MERGE:
        launches.count("batchnorm_finish")
    if mode == FIN_TRAIN and not counted:
        count.add_(1)
    return sums if mode == FIN_MERGE else (a, b, saved)


def _apply(xs, coefs, ident, relu: bool) -> torch.Tensor:
    x0 = xs[0]
    if not x0.is_cuda:
        return apply_plain(xs, coefs, ident, relu)
    M, C = x0.shape
    per, runs = row_chunks(M, C)
    out = torch.empty_like(x0)
    (a0, b0), (x1, a1, b1) = coefs[0], ((xs[1], *coefs[1]) if len(xs) == 2
                                        else (None, None, None))
    _build.check(_build.lib().ag_bn_apply_bf16(
        x0.data_ptr(), a0.data_ptr(), b0.data_ptr(), _ptr(x1), _ptr(a1),
        _ptr(b1), _ptr(ident), out.data_ptr(), M, C, int(relu), per, runs,
        _build.stream_ptr(x0)), "ag_bn_apply_bf16")
    launches.count("batchnorm_apply")
    return out


def _colsum(g, o, xs) -> torch.Tensor:
    if not g.is_cuda:
        return colsum_plain(g, o, xs)
    M, C = g.shape
    per, runs = row_chunks(M, C)
    part = torch.empty((runs, (len(xs) + 1) * C), dtype=_F32,
                       device=g.device)
    _build.check(_build.lib().ag_bn_colsum_bf16(
        g.data_ptr(), _ptr(o), xs[0].data_ptr(),
        _ptr(xs[1] if len(xs) == 2 else None), part.data_ptr(), M, C, per,
        runs, _build.stream_ptr(g)), "ag_bn_colsum_bf16")
    launches.count("batchnorm_colsum")
    return part


def _finish_bwd(p1, p2, da, db, saved, w, n: float, n_dev, train: bool):
    """(dgamma, dbeta, cs or None) from the partial sums p1, p2 ([groups,
    C] views, one row stride) or the bf16 da, db."""
    C = w.shape[0]
    if not w.is_cuda:
        if da is None:
            da, db = _bf(merge_plain(p1)), _bf(merge_plain(p2))
        nn = n if n_dev is None else n_dev[0]
        return finish_bwd_plain(da.to(_F32), db.to(_F32), saved, w, nn,
                                train)
    groups, stride = (0, C) if da is not None else (p1.shape[0],
                                                    p1.stride(0))
    dw = torch.empty(C, dtype=_F32, device=w.device)
    dbias = torch.empty_like(dw)
    cs = torch.empty((2, C), dtype=_F32, device=w.device) if train else None
    _build.check(_build.lib().ag_bn_finish_bwd(
        _ptr(p1), _ptr(p2), groups, stride, _ptr(da), _ptr(db),
        saved.data_ptr(), w.data_ptr(), _ptr(n_dev), n, dw.data_ptr(),
        dbias.data_ptr(), _ptr(cs), C, int(train), _build.stream_ptr(w)),
        "ag_bn_finish_bwd")
    launches.count("batchnorm_finish_bwd")
    return dw, dbias, cs


def _dx(g, o, xs, coefs_a, css, want_identity: bool):
    x0 = xs[0]
    if not x0.is_cuda:
        return dx_plain(g, o, xs, coefs_a, css, want_identity)
    M, C = x0.shape
    per, runs = row_chunks(M, C)
    dxs = [torch.empty_like(x) for x in xs]
    did = torch.empty_like(x0) if want_identity else None
    second = lambda seq: seq[1] if len(xs) == 2 else None
    _build.check(_build.lib().ag_bn_dx_bf16(
        _ptr(g), _ptr(o), x0.data_ptr(), _ptr(coefs_a[0]), _ptr(css[0]),
        _ptr(second(xs)), _ptr(second(coefs_a)), _ptr(second(css)),
        dxs[0].data_ptr(), _ptr(second(dxs)), _ptr(did), M, C, per, runs,
        _build.stream_ptr(x0)), "ag_bn_dx_bf16")
    launches.count("batchnorm_dx")
    return dxs, did


# --- the autograd Functions ---------------------------------------------------

class _Coefs(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    saved: torch.Tensor
    n: float
    n_dev: Optional[torch.Tensor]   # the all-reduced count (data parallel)


def _coefficients(bn, x, sums, n: float, reduce) -> _Coefs:
    """A BatchNorm's coefficients: in train mode from the sums (its
    producer's raw (s1, s2), or the statistics of x [M, C]) over n rows,
    summed over the ranks by `reduce` where given; in eval mode from the
    running statistics."""
    if not bn.training:
        return _Coefs(*_finish(FIN_EVAL, bn, None, None, n, None), n, None)
    C = bn.weight.shape[0]
    if sums is None:
        part = _stats(x)
        p1, p2 = part[:, :C], part[:, C:]
    else:
        p1, p2 = sums[0].reshape(1, C), sums[1].reshape(1, C)
    n_dev = None
    if reduce is not None:
        tot = reduce(_finish(FIN_MERGE, bn, p1, p2, n, None))
        p1, p2, n_dev = tot[:C].view(1, C), tot[C:2 * C].view(1, C), \
            tot[2 * C:]
    return _Coefs(*_finish(FIN_TRAIN, bn, p1, p2, n, n_dev), n, n_dev)


def _reduced(cs: torch.Tensor, reduce) -> torch.Tensor:
    """(c1, c2) summed over the ranks, in the buffer layout of the forward's
    (s1, s2, n) sum (the count's own gradient left at zero)."""
    C = cs.shape[1]
    flat = torch.cat([cs.reshape(-1), cs.new_zeros(1)])
    return reduce(flat)[:2 * C].view(2, C)


class _Spec(NamedTuple):
    bns: tuple                      # the branches' BatchNorm modules
    ns: tuple                       # rows each branch's statistics cover
    raw: bool                       # branch 0's sums come from its producer
    relu: bool
    reduce: Optional[Callable]      # sum over the ranks (data parallel)


class _Norm(torch.autograd.Function):
    """One or two BatchNorms applied and added (with an identity where
    given), then ReLU; saves the inputs, the output and the coefficients."""

    @staticmethod
    def forward(ctx, spec, x0, s1, s2, w0, b0, x1, w1, b1, ident):
        ctx.set_materialize_grads(False)
        xs = [x0] if x1 is None else [x0, x1]
        rows = [as_rows(x) for x in xs]
        coefs = [_coefficients(bn, r, (s1, s2) if i == 0 and spec.raw
                               else None, n, spec.reduce)
                 for i, (bn, r, n) in enumerate(zip(spec.bns, rows,
                                                    spec.ns))]
        out = _apply(rows, [(c.a, c.b) for c in coefs],
                     None if ident is None else as_rows(ident), spec.relu)
        out = as_nchw(out, x0)
        ctx.spec, ctx.coefs = spec, coefs
        ctx.has_ident = ident is not None
        ctx.save_for_backward(out if spec.relu else None, *xs)
        return out

    @staticmethod
    def backward(ctx, g):
        spec, coefs = ctx.spec, ctx.coefs
        nb = len(coefs)
        if g is None:
            return (None,) * 10
        out, *xs = ctx.saved_tensors
        train = spec.bns[0].training
        rows = [as_rows(x) for x in xs]
        C = rows[0].shape[1]
        o = None if out is None else as_rows(out)
        gr = as_rows(g.contiguous(memory_format=torch.channels_last))
        part = _colsum(gr, o, rows)
        grads = []
        for i, (c, bn) in enumerate(zip(coefs, spec.bns)):
            dw, db, cs = _finish_bwd(part[:, i * C:(i + 1) * C],
                                     part[:, nb * C:], None, None, c.saved,
                                     bn.weight, c.n, c.n_dev, train)
            if cs is not None and spec.reduce is not None:
                cs = _reduced(cs, spec.reduce)
            grads.append((dw, db, cs))
        own = [None if (i == 0 and spec.raw) else cs
               for i, (_, _, cs) in enumerate(grads)]
        dxs, did = _dx(gr, o, rows, [c.a for c in coefs], own,
                       ctx.has_ident)
        dxs = [as_nchw(d, x) for d, x in zip(dxs, xs)]
        if did is not None:
            did = as_nchw(did, xs[0])
        cs0 = grads[0][2] if spec.raw else None
        second = ((dxs[1], *grads[1][:2]) if nb == 2
                  else (None, None, None))
        return (None, dxs[0], None if cs0 is None else cs0[0],
                None if cs0 is None else cs0[1], *grads[0][:2], *second, did)


class _Scale(torch.autograd.Function):
    """A BatchNorm's coefficients alone, for a consumer that applies them
    (the unit's prologue): (x, a, b), x passed through so that the
    statistics' gradient joins the consumer's in one pass."""

    @staticmethod
    def forward(ctx, bn, n, reduce, x, w, b):
        ctx.set_materialize_grads(False)
        coefs = _coefficients(bn, as_rows(x), None, n, reduce)
        # a and b are outputs: kept on ctx they would hold their own graph
        ctx.bn, ctx.coefs, ctx.reduce = bn, coefs._replace(a=None,
                                                           b=None), reduce
        ctx.save_for_backward(x)
        return x, coefs.a, coefs.b

    @staticmethod
    def backward(ctx, gx, da, db):
        (x,) = ctx.saved_tensors
        bn, c = ctx.bn, ctx.coefs
        if gx is None and da is None and db is None:
            return (None,) * 6
        zeros = lambda: torch.zeros(x.shape[1], dtype=_BF16,
                                    device=x.device)
        da = zeros() if da is None else da.to(_BF16).contiguous()
        db = zeros() if db is None else db.to(_BF16).contiguous()
        train = bn.training
        dw, dbias, cs = _finish_bwd(None, None, da, db, c.saved, bn.weight,
                                    c.n, c.n_dev, train)
        if cs is not None and ctx.reduce is not None:
            cs = _reduced(cs, ctx.reduce)
        g = None if gx is None else as_rows(
            gx.contiguous(memory_format=torch.channels_last))
        (dx,), _ = _dx(g, None, [as_rows(x)], [None], [cs], False)
        return None, None, None, as_nchw(dx, x), dw, dbias


def _branch(bn, x: torch.Tensor, raw):
    """(n, s1, s2): the rows x's statistics cover and, in train mode, its
    producer's sums where given (else None); the operands checked on the
    card."""
    C = x.shape[1]
    if x.is_cuda and not takes(x):
        raise ValueError(f"batchnorm: x must be a CUDA bf16 channels-last "
                         f"[B, C, H, W] tensor, C a multiple of 8; got "
                         f"{x.dtype} {tuple(x.shape)}")
    for name in ("weight", "bias", "running_mean", "running_var"):
        # MixedBatchNorm keeps these in f32; a module cast to another dtype
        # has no kernel to run on
        _check_vector(name, getattr(bn, name), C, _F32, x.device)
    if raw is None or not bn.training:
        return float(x.shape[0] * x.shape[2] * x.shape[3]), None, None
    s1, s2, n = raw
    if x.is_cuda:
        _check_vector("s1", s1, C, _F32, x.device)
        _check_vector("s2", s2, C, _F32, x.device)
    return float(n), s1, s2


def batch_norm(bn, x: torch.Tensor, raw=None, relu: bool = False,
               reduce: Optional[Callable] = None) -> torch.Tensor:
    """bn(x) [ReLU] for a BatchNorm module with MixedBatchNorm's fields, in
    its mode; raw = (s1, s2, n): x's sums from its producer."""
    n, s1, s2 = _branch(bn, x, raw)
    spec = _Spec((bn,), (n,), s1 is not None, relu, reduce)
    return _Norm.apply(spec, x, s1, s2, bn.weight, bn.bias, None, None, None,
                       None)


def bottleneck_tail(bn3, y3: torch.Tensor, raw3, identity=None, bnd=None,
                    yd: Optional[torch.Tensor] = None,
                    reduce: Optional[Callable] = None) -> torch.Tensor:
    """bf16(relu(f32(bn3(y3)) + f32(bnd(yd) or identity))): the
    bottleneck's last BatchNorm, its downsample's (or the identity), the
    residual add and the ReLU in one pass."""
    n3, s1, s2 = _branch(bn3, y3, raw3)
    second = identity if yd is None else yd
    if second.shape != y3.shape or (y3.is_cuda and not takes(second)):
        raise ValueError(f"batchnorm: the tail's second term must be a "
                         f"tensor like y3 {tuple(y3.shape)}, got "
                         f"{second.dtype} {tuple(second.shape)}")
    if yd is None:
        spec = _Spec((bn3,), (n3,), s1 is not None, True, reduce)
        return _Norm.apply(spec, y3, s1, s2, bn3.weight, bn3.bias, None,
                           None, None, identity)
    spec = _Spec((bn3, bnd), (n3, _branch(bnd, yd, None)[0]),
                 s1 is not None, True, reduce)
    return _Norm.apply(spec, y3, s1, s2, bn3.weight, bn3.bias, yd,
                       bnd.weight, bnd.bias, None)


def scale_shift(bn, x: torch.Tensor, reduce: Optional[Callable] = None):
    """(x, a, b): bn's train-mode coefficients from x's statistics, x passed
    through (apply them through the returned x, whose gradient then carries
    the statistics' own)."""
    return _Scale.apply(bn, _branch(bn, x, None)[0], reduce, x, bn.weight,
                        bn.bias)
