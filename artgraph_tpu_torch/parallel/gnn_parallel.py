"""Edge-sharded full-graph GNN over the data mesh.

Port of artgraph_tpu/parallel/gnn_parallel.py. Every relation's edge array
is zero-padded to a multiple of the mesh size and cut into contiguous
shards, JAX's split exactly; rank k holds shard k. Node tensors (features,
parameters, BatchNorm state) stay whole on every rank. Each rank reduces its
own edges (with the CSR kernels, given its shard's metadata) and the partial
aggregates combine over the ranks (the `axis_name` branches of
ops/segment.py and ops/csr_segment.py), so the model's outputs are the same
on every rank: the `out_specs=P()` of JAX's shard_map.

JAX's padding edges carry dst = num_dst, which its scatters drop and its
CSR metadata marks as sentinels. PyTorch needs no equal shard shapes, so
here each shard drops its padding edges before its metadata is built
(`_csr_from_sorted` takes ids in [0, S) only); the shard boundaries stay
JAX's.

The model is `HeteroSGNN(axis_name="data")`. A training step's backward
through the all-reduces leaves on each rank N times its share of the
gradient, and parallel.mesh.sync_grads makes that the global gradient (the
convention of parallel/mesh.py). Every rank must draw the same dropout
masks: pass each a generator in the same state (the CLI seeds them alike).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from artgraph_tpu_torch.data.artgraph import HeteroGraph
from artgraph_tpu_torch.models.gnn import graph_tensors
from artgraph_tpu_torch.ops.csr_segment import build_edge_csr
from artgraph_tpu_torch.parallel.mesh import AXIS, DataMesh, replicated


def pad_and_shard_edges(graph: HeteroGraph, num_shards: int) -> Dict:
    """Every relation's [2, E] edges padded to a multiple of num_shards
    with (src 0, dst num_dst) edges, as the JAX function pads them."""
    edges = {}
    for (src_t, rel, dst_t), edge_index in graph.edges.items():
        e = edge_index.shape[1]
        padded = (e + num_shards - 1) // num_shards * num_shards
        if padded != e:
            pad = np.zeros((2, padded - e), dtype=edge_index.dtype)
            pad[1, :] = graph.num_nodes[dst_t]
            edge_index = np.concatenate([edge_index, pad], axis=1)
        edges[(src_t, rel, dst_t)] = edge_index
    return edges


def _shard(padded: np.ndarray, k: int, num_shards: int,
           num_dst: int) -> np.ndarray:
    """Shard k of a padded edge array, its padding edges removed."""
    sz = padded.shape[1] // num_shards
    chunk = padded[:, k * sz:(k + 1) * sz]
    return np.ascontiguousarray(chunk[:, chunk[1] < num_dst])


def shard_edges(graph: HeteroGraph, num_shards: int, k: int) -> Dict:
    """Shard k of every relation (the unpadded edges of JAX's shard k)."""
    return {key: _shard(e, k, num_shards, graph.num_nodes[key[2]])
            for key, e in pad_and_shard_edges(graph, num_shards).items()}


def shard_graph_csr(graph: HeteroGraph, num_shards: int,
                    device: str | torch.device = "cpu"
                    ) -> Tuple[Dict[tuple, List[np.ndarray]],
                               Dict[tuple, list]]:
    """Every shard's dst-sorted edges and EdgeCSR metadata (on `device`):
    ({relation: [sorted [2, e_k] per shard]}, {relation: [EdgeCSR per
    shard]}). JAX's shard k, sorted, is the port's shard k followed by its
    sentinel edges."""
    out_edges: Dict[tuple, list] = {}
    out_csrs: Dict[tuple, list] = {}
    for key in graph.edges:
        out_edges[key], out_csrs[key] = [], []
    for k in range(num_shards):
        for key, ei in shard_edges(graph, num_shards, k).items():
            src_t, _, dst_t = key
            sorted_ei, ecsr = build_edge_csr(
                ei, graph.num_nodes[src_t], graph.num_nodes[dst_t], device)
            out_edges[key].append(sorted_ei)
            out_csrs[key].append(ecsr)
    return out_edges, out_csrs


def init_variables(model: torch.nn.Module, mesh: DataMesh
                   ) -> torch.nn.Module:
    """Rank 0's initial parameters and buffers on every rank (JAX
    initializes once outside shard_map and replicates)."""
    return replicated(model, mesh)


def make_sharded_forward(model: torch.nn.Module, mesh: DataMesh,
                         axis: str = AXIS):
    """forward(x_dict, edges, train=False, generator=None, csr=None) of a
    model built with axis_name=axis, on this rank's edge shard (and its CSR
    metadata): outputs whole on every rank, differentiable."""
    if getattr(model, "axis_name", None) != axis:
        raise ValueError(f"make_sharded_forward: the model must be built "
                         f"with axis_name={axis!r}")
    if mesh.axis_name != axis:
        raise ValueError(f"mesh axis {mesh.axis_name!r} != {axis!r}")

    def forward(x_dict, edges, train: bool = False, generator=None,
                csr=None):
        model.train(train)
        return model(x_dict, edges, csr=csr, generator=generator)

    return forward


def _edge_tensors(edges: Dict, device) -> Dict:
    return {k: torch.from_numpy(np.asarray(e, np.int64)).to(device)
            for k, e in edges.items()}


def device_put_graph(graph: HeteroGraph, mesh: DataMesh):
    """(node features on this rank's device, this rank's edge shard as
    int64 tensors)."""
    x, _ = graph_tensors(graph, mesh.device)
    edges = shard_edges(graph, mesh.size, mesh.rank)
    return x, _edge_tensors(edges, mesh.device)


def device_put_graph_csr(graph: HeteroGraph, mesh: DataMesh):
    """device_put_graph for the kernel path: (node features, this rank's
    dst-sorted edge shard, its EdgeCSR metadata), all on the rank's
    device; feed both to the forward of make_sharded_forward."""
    x, _ = graph_tensors(graph, mesh.device)
    edges, csrs = {}, {}
    for key, ei in shard_edges(graph, mesh.size, mesh.rank).items():
        src_t, _, dst_t = key
        edges[key], csrs[key] = build_edge_csr(
            ei, graph.num_nodes[src_t], graph.num_nodes[dst_t], mesh.device)
    return x, _edge_tensors(edges, mesh.device), csrs
