"""CSR-sorted segment reductions for GNN message passing, both directions.

Port of artgraph_tpu/ops/csr_segment.py. The KG topology is static, so each
relation's edges are sorted by destination once, on the host, and the
metadata (`CSR`, `EdgeCSR`) lives as tensors on the device for the whole
run. Every scatter of message passing then becomes a read of contiguous edge
rows:

  C entry (csrc/csr_segment.cu)  Pallas kernel   public ops
  ag_csr_sum_f32                 _sum_kernel      csr_segment_sum,
                                                  csr_segment_mean,
                                                  csr_gather backward (2-D)
  ag_csr_weighted_sum_f32        _weighted_kernel csr_weighted_segment_sum
  ag_csr_softmax_f32             _softmax_kernel  csr_attention_aggregate
  ag_csr_scalar_sum_f32          _scalar_kernel   csr_scalar_segment_sum,
                                                  csr_gather backward (1-D)

All four run over a chunk plan built with the metadata (`_plan`): one warp
(for the scalar sum, a group of `scalar_lanes` lanes) per chunk of at most
CHUNK edges, and a second, fixed-order pass that merges the chunks of the
hub segments. Each kernel has a plain PyTorch twin here (`*_plain`:
`index_add_` in the sorted order; `scatter_reduce` amax and `exp` for the
softmax). A CPU tensor takes the twin; a CUDA tensor launches the kernel or
raises. The public ops are `torch.autograd.Function`s whose backwards
restate the JAX VJPs: a gather of the output cotangent back to the edges,
the `src_perm` reorder for the source side, and a detached softmax max.
The kernels' own backwards are gathers in JAX too, so they stay torch
indexing here.

With `axis_name` (the edge-sharded GNN, parallel/gnn_parallel.py) each rank
reduces its own edge shard with the kernels and the partials combine over
the ranks of that mesh axis: sums and in-degree counts by a sum all-reduce;
the attention aggregate by a max all-reduce of the detached segment maxima,
each shard's numerator and denominator rescaled by exp(m - m_global) and
summed. The port's shards carry no padding edges (gnn_parallel strips them
before building each shard's metadata), so no sentinel ids reach here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from artgraph_tpu_torch.ops import _build
from artgraph_tpu_torch.parallel.mesh import pmax, psum

# Launches of each CUDA kernel since the last reset.
LAUNCHES_SUM = 0
LAUNCHES_WEIGHTED = 0
LAUNCHES_SOFTMAX = 0
LAUNCHES_SCALAR = 0

_F32 = torch.float32
CHUNK = 256   # most edges one warp of the kernels reduces (see _plan)
# the scalar sum's group widths (lanes a chunk) and the loads a lane issues
# in one round (kScalarLoads in csrc/csr_segment.cu)
SCALAR_LANES, SCALAR_LOADS = (4, 16, 32), 8


@dataclasses.dataclass
class CSR:
    """Sorted-edge metadata of one relation direction, on one device."""

    row_ptr: torch.Tensor     # [S+1] int32: edge offset of each segment
    dst_sorted: torch.Tensor  # [E] int64: segment id of each (sorted) edge
    counts: torch.Tensor      # [S] f32 in-degree (for the mean)
    num_segments: int
    num_edges: int
    plan: torch.Tensor        # int32: the kernels' chunk plan (_plan)
    num_chunks: int
    num_merge: int            # segments of more than one chunk
    num_slots: int            # their chunks: the partials to merge
    scalar_lanes: int         # the scalar sum's lanes a chunk (scalar_lanes)


def _plan(row_ptr: np.ndarray) -> tuple[np.ndarray, int, int, int]:
    """Cut every segment into chunks of at most CHUNK edges (an empty
    segment into one empty chunk) for the kernels of csr_segment.cu: one
    warp (or lane group) reduces one chunk; a segment of one chunk is
    written to the output directly, a longer one (a hub) through one
    partial per chunk, merged in chunk order by a second kernel. Returns
    (plan, C, M, slots), plan = [chunk_edge (C+1) | chunk_seg (C) |
    chunk_slot (C) | merge_seg (M) | merge_ptr (M+1)] as one int32
    array."""
    counts = np.diff(row_ptr.astype(np.int64))
    n_chunks = np.maximum(1, -(-counts // CHUNK))
    first = np.cumsum(n_chunks) - n_chunks
    chunk_seg = np.repeat(np.arange(counts.size), n_chunks)
    k = np.arange(chunk_seg.size) - first[chunk_seg]
    chunk_edge = np.append(row_ptr[chunk_seg] + k * CHUNK, row_ptr[-1])
    multi = n_chunks > 1
    in_multi = multi[chunk_seg]
    chunk_slot = np.where(in_multi, np.cumsum(in_multi) - 1, -1)
    merge_seg = np.flatnonzero(multi)
    merge_ptr = np.append(0, np.cumsum(n_chunks[multi]))
    plan = np.concatenate([chunk_edge, chunk_seg, chunk_slot, merge_seg,
                           merge_ptr]).astype(np.int32)
    return plan, int(chunk_seg.size), int(merge_seg.size), int(merge_ptr[-1])


def scalar_lanes(num_edges: int, num_chunks: int) -> int:
    """The scalar kernel's group width for a CSR: the fewest SCALAR_LANES
    whose one round of SCALAR_LOADS loads a lane covers the mean chunk (a
    full warp for the hubs' 256-edge chunks, 4 lanes for ~10-edge
    segments). A function of the shape, so the order of the adds is too."""
    return next(g for g in SCALAR_LANES
                if g == SCALAR_LANES[-1]
                or num_edges <= SCALAR_LOADS * g * num_chunks)


def _csr_from_sorted(ids: np.ndarray, num_segments: int,
                     device: str | torch.device) -> CSR:
    """Metadata for a nondecreasing array of segment ids in [0, S)."""
    ids = np.asarray(ids, np.int64)
    if ids.size >= 2**31:
        raise ValueError(f"{ids.size} edges exceed the kernels' int32 offsets")
    if ids.size and (ids[0] < 0 or ids[-1] >= num_segments
                     or np.any(ids[1:] < ids[:-1])):
        raise ValueError("segment ids must be sorted and in "
                         f"[0, {num_segments})")
    row_ptr = np.searchsorted(ids, np.arange(num_segments + 1),
                              side="left").astype(np.int32)
    plan, n_chunks, n_merge, n_slots = _plan(row_ptr)
    return CSR(row_ptr=torch.from_numpy(row_ptr).to(device),
               dst_sorted=torch.from_numpy(ids).to(device),
               counts=torch.from_numpy(
                   np.diff(row_ptr).astype(np.float32)).to(device),
               num_segments=int(num_segments), num_edges=int(ids.size),
               plan=torch.from_numpy(plan).to(device), num_chunks=n_chunks,
               num_merge=n_merge, num_slots=n_slots,
               scalar_lanes=scalar_lanes(ids.size, n_chunks))


def build_csr(edge_index: np.ndarray, num_segments: int,
              device: str | torch.device = "cpu") -> Tuple[np.ndarray, CSR]:
    """Sort edges by dst (stably) and build the metadata on `device`.

    Returns (sorted_edge_index [2, E] int32, csr); the caller uses the sorted
    edge_index with the csr."""
    edge_index = np.asarray(edge_index)
    order = np.argsort(edge_index[1], kind="stable")
    sorted_edges = np.ascontiguousarray(edge_index[:, order]).astype(np.int32)
    return sorted_edges, _csr_from_sorted(sorted_edges[1], num_segments,
                                          device)


@dataclasses.dataclass
class EdgeCSR:
    """Both directions of one relation: `dst` drives the forward reductions;
    `src` and `src_perm` drive the backward of the h_src[src] gathers."""

    dst: CSR
    src: CSR
    src_perm: torch.Tensor  # [E] int64: dst-order edge position per src rank
    src_ids: torch.Tensor   # [E] int64: src node of each dst-ordered edge


def build_edge_csr(edge_index: np.ndarray, num_src: int, num_dst: int,
                   device: str | torch.device = "cpu"
                   ) -> Tuple[np.ndarray, EdgeCSR]:
    sorted_edges, dst_csr = build_csr(edge_index, num_dst, device)
    src_ids = sorted_edges[0].astype(np.int64)
    order = np.argsort(src_ids, kind="stable")
    return sorted_edges, EdgeCSR(
        dst=dst_csr,
        src=_csr_from_sorted(src_ids[order], num_src, device),
        src_perm=torch.from_numpy(order.astype(np.int64)).to(device),
        src_ids=torch.from_numpy(src_ids).to(device))


def build_csr_dict(edges: Dict, num_nodes: Dict,
                   device: str | torch.device = "cpu"
                   ) -> Tuple[Dict, Dict]:
    """Sort every relation's edges and build its EdgeCSR on `device`.
    Returns (sorted_edges_dict, csr_dict), keyed by (src, rel, dst)."""
    sorted_edges, csrs = {}, {}
    for (s, r, t), ei in edges.items():
        sorted_edges[(s, r, t)], csrs[(s, r, t)] = build_edge_csr(
            ei, num_nodes[s], num_nodes[t], device)
    return sorted_edges, csrs


# ---------------------------------------------------------------------------
# The plain twins
# ---------------------------------------------------------------------------

def segment_sum_plain(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    """[E, F] edge rows -> [S, F] per-segment sums."""
    out = data.new_zeros((csr.num_segments, *data.shape[1:]))
    return out.index_add_(0, csr.dst_sorted, data)


def weighted_segment_sum_plain(data: torch.Tensor, w: torch.Tensor,
                               csr: CSR) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of w * data, sum of w) per segment."""
    return (segment_sum_plain(w[:, None] * data, csr),
            segment_sum_plain(w, csr))


def softmax_aggregate_plain(data: torch.Tensor, logits: torch.Tensor,
                            csr: CSR):
    """(numerator [S, F], max m [S], denominator [S]) of the per-segment
    softmax aggregation, shifted by each segment's own max."""
    m = logits.new_full((csr.num_segments,), -torch.inf).scatter_reduce(
        0, csr.dst_sorted, logits, "amax")
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(torch.clamp_max(logits - m_safe[csr.dst_sorted], 0.0))
    num, den = weighted_segment_sum_plain(data, w, csr)
    return num, m, den


def scalar_segment_sum_plain(w: torch.Tensor, csr: CSR) -> torch.Tensor:
    """[E] -> [S] per-segment sums."""
    return segment_sum_plain(w, csr)


# ---------------------------------------------------------------------------
# The CUDA wrappers
# ---------------------------------------------------------------------------

def _check(name: str, csr: CSR, rows: torch.Tensor, *edge_arrays) -> None:
    """Raise unless every operand is a contiguous f32 tensor on the metadata's
    CUDA device with one row per edge of csr."""
    if rows.device.type != "cuda" or csr.row_ptr.device != rows.device:
        raise ValueError(f"{name}: operands on {rows.device}, metadata on "
                         f"{csr.row_ptr.device}; both must be one CUDA device")
    for i, t in enumerate((rows, *edge_arrays)):
        if t.dtype != _F32:
            raise TypeError(f"{name}: operand {i} must be float32, got "
                            f"{t.dtype}")
        if t.device != rows.device or not t.is_contiguous() \
                or t.shape[0] != csr.num_edges:
            raise ValueError(f"{name}: operand {i} must be contiguous on "
                             f"{rows.device} with {csr.num_edges} rows, got "
                             f"{tuple(t.shape)} on {t.device}")
    if rows.dim() == 2 and rows.shape[1] == 0:
        raise ValueError(f"{name}: zero features")


def _scratch(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    """The row kernels' partials: slots * (F + 2) floats (the partial rows,
    then their m, then their den)."""
    return torch.empty((csr.num_slots * (data.shape[1] + 2),), dtype=_F32,
                       device=data.device)


def _plan_args(csr: CSR, scratch: torch.Tensor) -> tuple:
    """The plan and scratch arguments of the kernels' C entries."""
    return (csr.plan.data_ptr(), csr.num_chunks, csr.num_merge,
            csr.num_slots, scratch.data_ptr())


def _vec(data: torch.Tensor) -> int:
    """1 when the rows can be read as float4: F % 4 == 0, 16-byte aligned."""
    return int(data.shape[1] % 4 == 0 and data.data_ptr() % 16 == 0)


def segment_sum_cuda(data: torch.Tensor, csr: CSR) -> torch.Tensor:
    global LAUNCHES_SUM
    _check("csr_segment_sum", csr, data)
    if data.dim() != 2:
        raise ValueError(f"csr_segment_sum: data must be [E, F], got "
                         f"{tuple(data.shape)}")
    S, F = csr.num_segments, data.shape[1]
    out = torch.empty((S, F), dtype=_F32, device=data.device)
    scratch = _scratch(data, csr)
    _build.check(_build.lib().ag_csr_sum_f32(
        data.data_ptr(), *_plan_args(csr, scratch), out.data_ptr(), F,
        _vec(data), _build.stream_ptr(data)), "ag_csr_sum_f32")
    LAUNCHES_SUM += 1
    return out


def weighted_segment_sum_cuda(data: torch.Tensor, w: torch.Tensor,
                              csr: CSR) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES_WEIGHTED
    _check("csr_weighted_segment_sum", csr, data, w)
    if data.dim() != 2 or w.dim() != 1:
        raise ValueError(f"csr_weighted_segment_sum: expected [E, F] and "
                         f"[E], got {tuple(data.shape)}, {tuple(w.shape)}")
    S, F = csr.num_segments, data.shape[1]
    out = torch.empty((S, F), dtype=_F32, device=data.device)
    den = torch.empty((S,), dtype=_F32, device=data.device)
    scratch = _scratch(data, csr)
    _build.check(_build.lib().ag_csr_weighted_sum_f32(
        data.data_ptr(), w.data_ptr(), *_plan_args(csr, scratch),
        out.data_ptr(), den.data_ptr(), F, _vec(data),
        _build.stream_ptr(data)), "ag_csr_weighted_sum_f32")
    LAUNCHES_WEIGHTED += 1
    return out, den


def softmax_aggregate_cuda(data: torch.Tensor, logits: torch.Tensor,
                           csr: CSR):
    global LAUNCHES_SOFTMAX
    _check("csr_attention_aggregate", csr, data, logits)
    if data.dim() != 2 or logits.dim() != 1:
        raise ValueError(f"csr_attention_aggregate: expected [E, F] and [E], "
                         f"got {tuple(data.shape)}, {tuple(logits.shape)}")
    S, F = csr.num_segments, data.shape[1]
    num = torch.empty((S, F), dtype=_F32, device=data.device)
    m = torch.empty((S,), dtype=_F32, device=data.device)
    den = torch.empty((S,), dtype=_F32, device=data.device)
    scratch = _scratch(data, csr)
    _build.check(_build.lib().ag_csr_softmax_f32(
        data.data_ptr(), logits.data_ptr(), *_plan_args(csr, scratch),
        num.data_ptr(), m.data_ptr(), den.data_ptr(), F, _vec(data),
        _build.stream_ptr(data)), "ag_csr_softmax_f32")
    LAUNCHES_SOFTMAX += 1
    return num, m, den


def scalar_segment_sum_cuda(w: torch.Tensor, csr: CSR) -> torch.Tensor:
    global LAUNCHES_SCALAR
    _check("csr_scalar_segment_sum", csr, w)
    if w.dim() != 1:
        raise ValueError(f"csr_scalar_segment_sum: w must be [E], got "
                         f"{tuple(w.shape)}")
    out = torch.empty((csr.num_segments,), dtype=_F32, device=w.device)
    scratch = torch.empty((csr.num_slots,), dtype=_F32, device=w.device)
    _build.check(_build.lib().ag_csr_scalar_sum_f32(
        w.data_ptr(), *_plan_args(csr, scratch), out.data_ptr(),
        csr.scalar_lanes, _build.stream_ptr(w)), "ag_csr_scalar_sum_f32")
    LAUNCHES_SCALAR += 1
    return out


def _run(plain, cuda, first: torch.Tensor, *args):
    """The plain twin on a CPU tensor, the kernel on a CUDA one."""
    if first.device.type == "cpu":
        return plain(first, *args)
    if first.device.type == "cuda":
        return cuda(first, *args)
    raise ValueError(f"unsupported device {first.device}")


# ---------------------------------------------------------------------------
# Differentiable public API
# ---------------------------------------------------------------------------

def _edge_cotangent(g: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Gather per-segment cotangents back to the (sorted) edges."""
    return g.index_select(0, csr.dst_sorted)


class _SegmentSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, csr):
        ctx.csr = csr
        return _run(segment_sum_plain, segment_sum_cuda, data, csr)

    @staticmethod
    def backward(ctx, g):
        return _edge_cotangent(g, ctx.csr), None


class _ScalarSegmentSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, csr):
        ctx.csr = csr
        return _run(scalar_segment_sum_plain, scalar_segment_sum_cuda, w, csr)

    @staticmethod
    def backward(ctx, g):
        return _edge_cotangent(g, ctx.csr), None


class _WeightedSegmentSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, w, csr):
        ctx.csr = csr
        ctx.save_for_backward(data, w)
        return _run(weighted_segment_sum_plain, weighted_segment_sum_cuda,
                    data, w, csr)

    @staticmethod
    def backward(ctx, g_out, g_w):
        data, w = ctx.saved_tensors
        g_edge = _edge_cotangent(g_out, ctx.csr)
        d_w = (data * g_edge).sum(-1) + _edge_cotangent(g_w, ctx.csr)
        return w[:, None] * g_edge, d_w, None


class _SoftmaxRaw(torch.autograd.Function):
    """(numerator, max m, denominator); m's cotangent is discarded (the
    shift is detached, as torch_geometric's softmax does)."""

    @staticmethod
    def forward(ctx, messages, logits, csr):
        num, m, den = _run(softmax_aggregate_plain, softmax_aggregate_cuda,
                           messages, logits, csr)
        ctx.csr = csr
        ctx.save_for_backward(messages, logits, m)
        ctx.mark_non_differentiable(m)
        return num, m, den

    @staticmethod
    def backward(ctx, g_num, _g_m, g_den):
        messages, logits, m = ctx.saved_tensors
        csr = ctx.csr
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        w = torch.exp(torch.clamp_max(
            logits - m_safe.index_select(0, csr.dst_sorted), 0.0))
        gn_e = _edge_cotangent(g_num, csr)
        d_logits = w * ((messages * gn_e).sum(-1)
                        + _edge_cotangent(g_den, csr))
        return w[:, None] * gn_e, d_logits, None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ecsr, axis):
        ctx.ecsr, ctx.axis, ctx.n = ecsr, axis, x.shape[0]
        ids = ecsr.src_ids if axis == "src" else ecsr.dst.dst_sorted
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        ecsr = ctx.ecsr
        if ctx.axis == "src":
            # reorder the cotangents into src-sorted order
            g, csr = g.index_select(0, ecsr.src_perm), ecsr.src
        else:
            g, csr = g.contiguous(), ecsr.dst
        if g.dim() == 1:
            d_x = _run(scalar_segment_sum_plain, scalar_segment_sum_cuda, g,
                       csr)
        else:
            d_x = _run(segment_sum_plain, segment_sum_cuda, g, csr)
        return d_x[:ctx.n], None, None


def csr_segment_sum(data: torch.Tensor, csr: CSR,
                    axis_name: Optional[str] = None) -> torch.Tensor:
    """Sum of data rows per segment: [E, F] in the csr's sorted order ->
    [num_segments, F]; with axis_name summed over the ranks."""
    out = _SegmentSum.apply(data, csr)
    return out if axis_name is None else psum(out, axis_name)


def csr_segment_mean(data: torch.Tensor, csr: CSR,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """Per-segment mean; empty segments give 0. With axis_name the sums and
    the in-degree counts are summed over the ranks first, so the mean is
    over all of a node's incoming edges."""
    counts = csr.counts
    if axis_name is not None:
        counts = psum(counts, axis_name)
    return (csr_segment_sum(data, csr, axis_name)
            / counts.clamp_min(1.0)[:, None])


def csr_scalar_segment_sum(w: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Per-segment sum of a scalar edge array, [E] -> [num_segments]."""
    return _ScalarSegmentSum.apply(w, csr)


def csr_weighted_segment_sum(data: torch.Tensor, w: torch.Tensor, csr: CSR
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of w * data per segment, sum of w per segment)."""
    return _WeightedSegmentSum.apply(data, w, csr)


def csr_gather(x: torch.Tensor, ecsr: EdgeCSR, axis: str) -> torch.Tensor:
    """x[edge endpoint ids] (axis 'src' or 'dst', edges in dst order). The
    backward is a segment sum by that endpoint: the src-sorted CSR after the
    `src_perm` reorder, or the dst-sorted one."""
    if axis not in ("src", "dst"):
        raise ValueError(f"csr_gather: axis must be 'src' or 'dst', got "
                         f"{axis!r}")
    return _Gather.apply(x, ecsr, axis)


def csr_attention_aggregate(messages: torch.Tensor, logits: torch.Tensor,
                            csr: CSR, eps: float = 1e-16,
                            axis_name: Optional[str] = None) -> torch.Tensor:
    """GAT aggregation: out[s] = sum_e w_e m_e / sum_e w_e with
    w_e = exp(logit_e - max of segment s's logits), the exact per-segment
    shift, computed online in one pass (a global shift would underflow the
    exp of cold segments to zero). With axis_name the shards' maxima take a
    max all-reduce, each shard's numerator and denominator are rescaled by
    exp(m - m_global) (0 where the shard has no edge into the segment) and
    summed over the ranks."""
    num, m, den = _SoftmaxRaw.apply(messages, logits, csr)
    if axis_name is not None:
        m_g = pmax(m, axis_name)
        r = torch.where(torch.isfinite(m),
                        torch.exp(m - torch.where(torch.isfinite(m_g), m_g,
                                                  0.0)), 0.0)
        num = psum(num * r[:, None], axis_name)
        den = psum(den * r, axis_name)
    return num / den.clamp_min(eps)[:, None]
