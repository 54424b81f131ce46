"""Segment reductions over unsorted segment ids: the no-CSR path.

Port of artgraph_tpu/ops/segment.py. The GNN convs take it when they get no
CSR metadata, and `GCNConv` always does: its self-loops change the edge
set. `index_add_` and `scatter_reduce` are differentiable, so autograd gives
the backward.

Every helper takes an optional `axis_name`: on an edge shard of the
edge-sharded GNN (parallel/gnn_parallel.py) the local reductions combine
over the ranks of that mesh axis, a sum (or max) all-reduce
(parallel.mesh.psum / pmax), while node tensors stay whole on every rank.
The port's shards hold no padding edges, so every id is in range.
"""
from __future__ import annotations

from typing import Optional

import torch

from artgraph_tpu_torch.parallel.mesh import pmax, psum


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                axis_name: Optional[str] = None) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    out = out.index_add(0, segment_ids, data)
    return out if axis_name is None else psum(out, axis_name)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 axis_name: Optional[str] = None) -> torch.Tensor:
    totals = segment_sum(data, segment_ids, num_segments, axis_name)
    counts = segment_sum(data.new_ones((data.shape[0],)), segment_ids,
                         num_segments, axis_name)
    return totals / counts.clamp_min(1.0)[:, None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                axis_name: Optional[str] = None) -> torch.Tensor:
    """Per-segment max; -inf for an empty segment, as jax.ops.segment_max.
    With axis_name the max over the ranks, of the detached values."""
    index = segment_ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = data.new_full((num_segments, *data.shape[1:]), -torch.inf)
    out = out.scatter_reduce(0, index, data, "amax")
    return out if axis_name is None else pmax(out, axis_name)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    axis_name: Optional[str] = None) -> torch.Tensor:
    """Softmax over edges grouped by destination (the GAT attention
    normalization, torch_geometric.utils.softmax), shifted by each segment's
    max; the shift is detached. With axis_name the maxima and exp-sums
    combine over the ranks, so the attention normalizes over every incoming
    edge; the weights stay the shard's."""
    maxes = segment_max(logits.detach(), segment_ids, num_segments,
                        axis_name)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    safe_ids = segment_ids.clamp_max(num_segments - 1)
    exp = torch.exp(logits - maxes[safe_ids])
    denom = segment_sum(exp, segment_ids, num_segments, axis_name)
    return exp / denom[safe_ids].clamp_min(1e-16)
