"""Heterogeneous GNN over the ArtGraph KG, on the CSR segment kernels.

Port of artgraph_tpu/models/gnn.py (`TypedLinear`, the five conv operators,
`HeteroSGNN`, and the variants no reference script uses: `HeteroMGNN`,
`HomoGNN` and `HomoSGNN`), the reference's PyG HeteroGNN under
`to_hetero(..., aggr='sum')` (ref: src/models/models_graph.py:5-106):

  * one conv per relation, summed per destination type (`aggr` also takes
    mean | max | min | mul); a type no relation targets gets zeros;
  * one-hot node features stay symbolic (`OneHot`): `TypedLinear` returns
    its kernel for them, never an n x n product;
  * given CSR metadata (ops.csr_segment), the convs run the kernels: the
    gathers' backwards are sorted segment sums, and GAT's softmax numerator
    and denominator come from one online pass. Without it (and always for
    `GCNConv`, whose self-loops change the edge set) they take the
    `index_add_` path of ops.segment;
  * the reference forward quirk: the next layer consumes the post-BN
    PRE-activation x; activation and dropout feed only the output conv, and
    the returned embedding is the last post-BN x (ref: models_graph.py:25-39);
  * `axis_name` (a mesh axis, parallel/mesh.py) runs a model on one edge
    shard of the edge-sharded GNN (parallel/gnn_parallel.py): every
    reduction over edges combines over the ranks, so node tensors, the
    outputs and the BatchNorm statistics are whole and the same on every
    rank. The dropout masks are too when every rank passes a generator in
    the same state.

PyG's lazy (-1, -1) shapes become explicit input widths: `HeteroSGNN` and
`HeteroMGNN` take `in_channels` per node type (`feature_dims` of a graph's
features), `HomoGNN` one width. The
parameters keep the JAX package's names and layouts (kernels [in, out]),
under ModuleDicts keyed by the flax module names, so
checkpointing.gnn_state_from_flax maps them one to one. Training and eval
follow the module's mode (`.train()` / `.eval()`): BatchNorm1d with
momentum 0.1 and eps 1e-5 is torch's own semantics (the unbiased running
variance MixedBatchNorm re-creates), and dropout draws from an explicit
`torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from artgraph_tpu_torch.data.artgraph import OneHot
from artgraph_tpu_torch.ops.csr_segment import (csr_attention_aggregate,
                                                csr_gather, csr_segment_mean,
                                                csr_segment_sum)
from artgraph_tpu_torch.ops.segment import (segment_mean, segment_softmax,
                                            segment_sum)
from artgraph_tpu_torch.parallel.mesh import axis_mesh

_F32 = torch.float32


def lecun_normal_(t: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal: a normal of variance 1/fan_in truncated at two
    standard deviations (the std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std)


def _rows(x) -> int:
    return x.num if isinstance(x, OneHot) else x.shape[0]


def feature_dims(node_features: Dict) -> Dict[str, int]:
    """Input width per node type: n for OneHot(n), else the column count."""
    return {t: (f.num if isinstance(f, OneHot) else int(f.shape[1]))
            for t, f in node_features.items()}


def graph_tensors(graph, device: str | torch.device):
    """(x_dict, edge_dict) as the model takes them on `device`: artwork
    features as f32 tensors, OneHot kept symbolic, edges as int64 [2, E]."""
    x = {t: f if isinstance(f, OneHot)
         else torch.from_numpy(np.asarray(f, np.float32)).to(device)
         for t, f in graph.node_features.items()}
    edges = {k: torch.from_numpy(np.asarray(e, np.int64)).to(device)
             for k, e in graph.edges.items()}
    return x, edges


class TypedLinear(nn.Module):
    """Dense layer that treats OneHot(n) inputs as a symbolic eye(n): the
    projection of the identity is the kernel itself. kernel is [in, out]."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        lecun_normal_(self.kernel, in_features)

    def forward(self, x):
        if isinstance(x, OneHot):
            if x.num != self.kernel.shape[0]:
                raise ValueError(f"OneHot({x.num}) into a TypedLinear of "
                                 f"{self.kernel.shape[0]} inputs")
            out = self.kernel
        else:
            out = x.to(torch.promote_types(x.dtype, _F32)) @ self.kernel
        return out if self.bias is None else out + self.bias


class SAGEConv(nn.Module):
    """PyG SAGEConv defaults: out = lin_l(mean_j x_src[j]) + bias
    + lin_r(x_dst), projected first (linear commutes with the mean)."""

    def __init__(self, in_src: int, in_dst: int, features: int,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.lin_l = TypedLinear(in_src, features, use_bias=False)
        self.lin_r = TypedLinear(in_dst, features, use_bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x_src, x_dst, edge_index, num_dst: int, csr=None):
        h = self.lin_l(x_src)
        if csr is not None:
            agg = csr_segment_mean(csr_gather(h, csr, "src"), csr.dst,
                                   self.axis_name)
        else:
            agg = segment_mean(h[edge_index[0]], edge_index[1], num_dst,
                               self.axis_name)
        return agg + self.bias + self.lin_r(x_dst)


class GraphConv(nn.Module):
    """PyG GraphConv: out = lin_rel(sum_j x_src[j]) + bias
    + lin_root(x_dst)."""

    def __init__(self, in_src: int, in_dst: int, features: int,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.lin_rel = TypedLinear(in_src, features, use_bias=False)
        self.lin_root = TypedLinear(in_dst, features, use_bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x_src, x_dst, edge_index, num_dst: int, csr=None):
        h = self.lin_rel(x_src)
        if csr is not None:
            agg = csr_segment_sum(csr_gather(h, csr, "src"), csr.dst,
                                  self.axis_name)
        else:
            agg = segment_sum(h[edge_index[0]], edge_index[1], num_dst,
                              self.axis_name)
        return agg + self.bias + self.lin_root(x_dst)


class GATConv(nn.Module):
    """PyG GATConv, heads=1, bipartite projections, LeakyReLU(0.2) logits,
    per-destination softmax."""

    def __init__(self, in_src: int, in_dst: int, features: int,
                 negative_slope: float = 0.2,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.axis_name = axis_name
        self.lin_src = TypedLinear(in_src, features, use_bias=False)
        self.lin_dst = TypedLinear(in_dst, features, use_bias=False)
        self.att_src = nn.Parameter(lecun_normal_(
            torch.empty(features, 1), features))
        self.att_dst = nn.Parameter(lecun_normal_(
            torch.empty(features, 1), features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x_src, x_dst, edge_index, num_dst: int, csr=None):
        h_src = self.lin_src(x_src)
        h_dst = self.lin_dst(x_dst)
        alpha_dst = (h_dst @ self.att_dst)[:, 0]
        if csr is not None:
            # kernel path: the gathers' backwards are sorted segment sums,
            # and the src attention term is taken on the gathered messages
            # ((h @ a)[src] == h[src] @ a), so its gradient rides the
            # message gather's backward
            msgs = csr_gather(h_src, csr, "src")
            a_dst = csr_gather(alpha_dst, csr, "dst")
            logits = F.leaky_relu((msgs @ self.att_src)[:, 0] + a_dst,
                                  self.negative_slope)
            out = csr_attention_aggregate(msgs, logits, csr.dst,
                                          axis_name=self.axis_name)
        else:
            src, dst = edge_index[0], edge_index[1]
            alpha_src = (h_src @ self.att_src)[:, 0]
            logits = F.leaky_relu(
                alpha_src[src] + alpha_dst[dst.clamp_max(num_dst - 1)],
                self.negative_slope)
            att = segment_softmax(logits, dst, num_dst, self.axis_name)
            out = segment_sum(att[:, None] * h_src[src], dst, num_dst,
                              self.axis_name)
        return out + self.bias


class GCNConv(nn.Module):
    """PyG GCNConv (homogeneous only): symmetric-normalized aggregation with
    self-loops; raises on bipartite use, as PyG does. Ignores csr. On an
    edge shard (axis_name) the degrees and the aggregate are summed over the
    ranks, and rank 0 alone adds the self-loops."""

    def __init__(self, in_src: int, in_dst: int, features: int,
                 add_self_loops: bool = True,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.add_self_loops = add_self_loops
        self.axis_name = axis_name
        self.lin = TypedLinear(in_src, features, use_bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x_src, x_dst, edge_index, num_dst: int, csr=None):
        if isinstance(x_src, OneHot) or isinstance(x_dst, OneHot) or \
                _rows(x_src) != num_dst:
            raise ValueError("GCNConv supports homogeneous graphs only "
                             "(PyG GCNConv has no bipartite mode)")
        src, dst = edge_index[0], edge_index[1]
        axis = self.axis_name
        if self.add_self_loops and (axis is None
                                    or axis_mesh(axis).rank == 0):
            loops = torch.arange(num_dst, dtype=src.dtype, device=src.device)
            src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
        h = self.lin(x_src)
        deg = segment_sum(torch.ones(src.shape[0], dtype=_F32,
                                     device=src.device), dst, num_dst, axis)
        inv_sqrt = torch.where(deg > 0, deg.rsqrt(), 0.0)
        norm = inv_sqrt[src] * inv_sqrt[dst]
        return segment_sum(norm[:, None] * h[src], dst, num_dst,
                           axis) + self.bias


class GINConv(nn.Module):
    """GIN with an internal dense update:
    out = update((1 + eps) * lin_dst(x_dst) + sum_j lin_src(x_src[j]))."""

    def __init__(self, in_src: int, in_dst: int, features: int,
                 eps: float = 0.0, axis_name: Optional[str] = None):
        super().__init__()
        self.eps = eps
        self.axis_name = axis_name
        self.lin_src = TypedLinear(in_src, features, use_bias=False)
        self.lin_dst = TypedLinear(in_dst, features, use_bias=False)
        self.update = TypedLinear(features, features)

    def forward(self, x_src, x_dst, edge_index, num_dst: int, csr=None):
        h_src = self.lin_src(x_src)
        h_dst = self.lin_dst(x_dst)
        if csr is not None:
            agg = csr_segment_sum(csr_gather(h_src, csr, "src"), csr.dst,
                                  self.axis_name)
        else:
            agg = segment_sum(h_src[edge_index[0]], edge_index[1], num_dst,
                              self.axis_name)
        return self.update((1.0 + self.eps) * h_dst + agg)


OPERATORS = {
    "SAGEConv": SAGEConv,
    "GraphConv": GraphConv,
    "GATConv": GATConv,
    "GCNConv": GCNConv,
    "GINConv": GINConv,
}

_COMBINE = {
    "sum": torch.add,
    "mean": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
    "mul": torch.mul,
}


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Inverted dropout, flax's form: keep with probability 1 - rate and
    scale by 1 / (1 - rate); the mask comes from `generator`."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class HeteroSGNN(nn.Module):
    """to_hetero(HeteroGNN) (ref: models_graph.py:41-49): forward(x_dict,
    edge_dict, csr=None, generator=None) -> (x dict, [log_softmax dict]),
    the reference's (emb, [out_soft]). x_dict maps node type -> features
    (tensor or OneHot); edge_dict maps (src, rel, dst) -> [2, E] int64;
    csr maps the same keys to EdgeCSR metadata (then the kernels run).
    skip adds a per-type linear of the layer's input (`lin{layer}__{type}`)
    to each conv's output, before the BatchNorm, which bn=False leaves out.
    axis_name: the mesh axis of an edge-sharded run (edge_dict and csr then
    hold this rank's shard)."""

    def __init__(self, metadata: Tuple, in_channels: Dict[str, int],
                 operator: str = "GATConv", activation: str = "relu",
                 aggr: str = "sum", hidden_channels: int = 128,
                 out_channels: int = 32, n_layers: int = 2,
                 dropout: float = 0.4, bn: bool = True, skip: bool = False,
                 axis_name: Optional[str] = None):
        super().__init__()
        if operator not in OPERATORS:
            raise ValueError(f"unknown operator {operator!r}")
        if activation not in ("relu", "prelu") or aggr not in _COMBINE:
            raise ValueError(f"activation {activation!r} / aggr {aggr!r}")
        node_types, edge_types = metadata
        self.metadata = (tuple(node_types), tuple(edge_types))
        self.activation, self.aggr = activation, aggr
        self.hidden_channels, self.out_channels = hidden_channels, out_channels
        self.n_layers, self.dropout = n_layers, dropout
        self.bn, self.skip = bn, skip
        self.axis_name = axis_name
        conv_cls = OPERATORS[operator]
        self.convs = nn.ModuleDict()
        self.lins = nn.ModuleDict()
        self.bns = nn.ModuleDict()
        self.prelu = nn.ParameterDict()
        dims = dict(in_channels)
        for layer in range(n_layers + 1):
            name = f"conv{layer}" if layer < n_layers else "conv_out"
            width = hidden_channels if layer < n_layers else out_channels
            for (s, r, t) in edge_types:
                self.convs[f"{name}__{s}__{r}__{t}"] = conv_cls(
                    dims[s], dims[t], width, axis_name=axis_name)
            if layer == n_layers:
                break
            for t in node_types:
                if skip:
                    self.lins[f"lin{layer}__{t}"] = TypedLinear(dims[t], width)
                if bn:
                    self.bns[f"bn{layer}__{t}"] = nn.BatchNorm1d(
                        width, eps=1e-5, momentum=0.1)
            if activation == "prelu":
                self.prelu[f"prelu{layer}"] = nn.Parameter(
                    torch.full((1,), 0.25))
            dims = dict.fromkeys(node_types, hidden_channels)

    def _hetero_conv(self, name: str, features: int, x: Dict, edges: Dict,
                     csr: Optional[Dict]) -> Dict[str, torch.Tensor]:
        """One to_hetero layer: per-relation convs combined per dst type."""
        node_types, edge_types = self.metadata
        out: Dict[str, list] = {t: [] for t in node_types}
        for (s, r, t) in edge_types:
            conv = self.convs[f"{name}__{s}__{r}__{t}"]
            out[t].append(conv(x[s], x[t], edges[(s, r, t)],
                               num_dst=_rows(x[t]),
                               csr=None if csr is None else csr[(s, r, t)]))
        combine = _COMBINE[self.aggr]
        result = {}
        for t in node_types:
            if out[t]:
                acc = out[t][0]
                for m in out[t][1:]:
                    acc = combine(acc, m)
                result[t] = acc / len(out[t]) if self.aggr == "mean" else acc
            else:
                # PyG drops never-targeted types; zeros keep shapes total
                # (in the parameters' type, as a OneHot input's projection)
                p = next(self.parameters())
                result[t] = torch.zeros((_rows(x[t]), features),
                                        dtype=p.dtype, device=p.device)
        return result

    def forward(self, x_dict: Dict, edge_dict: Dict,
                csr: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None):
        node_types, _ = self.metadata
        x = dict(x_dict)
        x_emb = x
        for layer in range(self.n_layers):
            new_x = self._hetero_conv(f"conv{layer}", self.hidden_channels, x,
                                      edge_dict, csr)
            for t in node_types:
                if self.skip:
                    new_x[t] = new_x[t] + self.lins[f"lin{layer}__{t}"](x[t])
                if self.bn:
                    new_x[t] = self.bns[f"bn{layer}__{t}"](new_x[t])
            x = new_x  # the next layer consumes PRE-activation (ref quirk)
            x_emb = {}
            for t in node_types:
                if self.activation == "prelu":
                    alpha = self.prelu[f"prelu{layer}"]
                    h = torch.where(x[t] >= 0, x[t], alpha * x[t])
                else:
                    h = torch.relu(x[t])
                if self.training:
                    h = dropout(h, self.dropout, generator)
                x_emb[t] = h
        x_out = self._hetero_conv("conv_out", self.out_channels, x_emb,
                                  edge_dict, csr)
        out_soft = {t: torch.log_softmax(v, dim=1) for t, v in x_out.items()}
        return x, [out_soft]


class HeteroMGNN(nn.Module):
    """Three parallel HeteroSGNN heads, `gnn_artist`, `gnn_style` and
    `gnn_genre` (ref: models_graph.py:51-64, which no reference script
    uses), with `out_channels` a dict by task. As the JAX module does, it
    passes no CSR metadata, so the convs take the `index_add_` path of
    ops.segment. forward -> [(emb, [out_soft]) for each task]."""

    TASKS = ("artist", "style", "genre")

    def __init__(self, metadata: Tuple, in_channels: Dict[str, int],
                 out_channels: Dict[str, int], operator: str = "GATConv",
                 activation: str = "relu", aggr: str = "sum",
                 hidden_channels: int = 128, n_layers: int = 2,
                 dropout: float = 0.4, bn: bool = True, skip: bool = False):
        super().__init__()
        for task in self.TASKS:
            self.add_module(f"gnn_{task}", HeteroSGNN(
                metadata, in_channels, operator=operator,
                activation=activation, aggr=aggr,
                hidden_channels=hidden_channels,
                out_channels=out_channels[task], n_layers=n_layers,
                dropout=dropout, bn=bn, skip=skip))

    def forward(self, x_dict: Dict, edge_dict: Dict,
                generator: Optional[torch.Generator] = None) -> list:
        return [getattr(self, f"gnn_{task}")(x_dict, edge_dict,
                                             generator=generator)
                for task in self.TASKS]


class HomoGNN(nn.Module):
    """The homogeneous variant (ref: models_graph.py:66-97), as the JAX
    module computes it: each layer is conv{i}, plus lin{i}(x) when skip,
    then BatchNorm bn{i} always (the reference applies it whatever `bn`
    says), and feeds the next; then conv_out and log_softmax. No activation
    and no dropout run, although the JAX docstring speaks of dropout:
    `activation`, `dropout` and `bn` are accepted and unused, as there.
    forward(x [n, in_channels], edge_index [2, E]) -> (x, log_softmax)."""

    def __init__(self, in_channels: int, operator: str = "GCNConv",
                 activation: str = "relu", hidden_channels: int = 16,
                 out_channels: int = 300, n_layers: int = 1,
                 dropout: float = 0.5, bn: bool = False, skip: bool = False):
        super().__init__()
        if operator not in OPERATORS:
            raise ValueError(f"unknown operator {operator!r}")
        conv_cls = OPERATORS[operator]
        self.n_layers, self.skip = n_layers, skip
        dim = in_channels
        for layer in range(n_layers):
            self.add_module(f"conv{layer}",
                            conv_cls(dim, dim, hidden_channels))
            if skip:
                self.add_module(f"lin{layer}",
                                TypedLinear(dim, hidden_channels))
            self.add_module(f"bn{layer}", nn.BatchNorm1d(
                hidden_channels, eps=1e-5, momentum=0.1))
            dim = hidden_channels
        self.conv_out = conv_cls(dim, dim, out_channels)

    def forward(self, x, edge_index):
        n = _rows(x)
        for layer in range(self.n_layers):
            h = getattr(self, f"conv{layer}")(x, x, edge_index, num_dst=n)
            if self.skip:
                h = h + getattr(self, f"lin{layer}")(x)
            x = getattr(self, f"bn{layer}")(h)
        x_out = self.conv_out(x, x, edge_index, num_dst=n)
        return x, torch.log_softmax(x_out, dim=1)


class HomoSGNN(nn.Module):
    """HomoGNN as `gnn`, returning (emb, [out_soft])
    (ref: models_graph.py:99-106)."""

    def __init__(self, in_channels: int, operator: str = "GCNConv",
                 activation: str = "relu", hidden_channels: int = 16,
                 out_channels: int = 300, n_layers: int = 1,
                 dropout: float = 0.5, bn: bool = False, skip: bool = False):
        super().__init__()
        self.gnn = HomoGNN(in_channels, operator=operator,
                           activation=activation,
                           hidden_channels=hidden_channels,
                           out_channels=out_channels, n_layers=n_layers,
                           dropout=dropout, bn=bn, skip=skip)

    def forward(self, x, edge_index):
        emb, out_soft = self.gnn(x, edge_index)
        return emb, [out_soft]
