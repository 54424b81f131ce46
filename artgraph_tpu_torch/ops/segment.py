"""Segment reductions over unsorted segment ids: the no-CSR path.

Port of artgraph_tpu/ops/segment.py (without the `axis_name` branches).
The GNN convs take it when they get no CSR metadata, and `GCNConv` always
does: its self-loops change the edge set. `index_add_` and `scatter_reduce`
are differentiable, so autograd gives the backward.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(data.new_ones((data.shape[0],)), segment_ids,
                         num_segments)
    return totals / counts.clamp_min(1.0)[:, None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; -inf for an empty segment, as jax.ops.segment_max."""
    index = segment_ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = data.new_full((num_segments, *data.shape[1:]), -torch.inf)
    return out.scatter_reduce(0, index, data, "amax")


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over edges grouped by destination (the GAT attention
    normalization, torch_geometric.utils.softmax), shifted by each segment's
    max; the shift is detached."""
    maxes = segment_max(logits.detach(), segment_ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    safe_ids = segment_ids.clamp_max(num_segments - 1)
    exp = torch.exp(logits - maxes[safe_ids])
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / denom[safe_ids].clamp_min(1e-16)
