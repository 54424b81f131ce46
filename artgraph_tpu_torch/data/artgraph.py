"""ArtGraph heterogeneous knowledge-graph container.

Port of artgraph_tpu/data/artgraph.py (the reference's PyG InMemoryDataset,
ref: src/data/artgraph.py:10-128) over numpy and pandas only:

  * artwork nodes carry the 128-dim visual features of node-feat.csv and the
    y_style / y_genre labels;
  * the 8 other node types get 'one-hot' / 'constant' / featureless init.
    One-hot features stay symbolic, `OneHot(n)`: a Linear over eye(n) is its
    weight matrix, so the GNN's first layer never materialises n x n;
  * the 9 relations load from relations/<h>___<r>___<t>/edge.csv, renamed
    '<r>_rel';
  * `to_undirected` is PyG's T.ToUndirected(); `gat_self_loops` the pyg
    2.0.2 GATConv self-loops (PARITY.md deviation 5); `with_csr` sorts every
    relation by destination and builds the kernels' metadata on a device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple, Union

import numpy as np
import pandas as pd

EdgeType = Tuple[str, str, str]

NODE_TYPES_ONE_HOT = (
    "artist", "gallery", "style", "genre", "tag", "media", "field", "movement")

EDGE_TYPES = (
    ("artist", "field", "field"),
    ("artist", "movement", "movement"),
    ("artist", "teacher", "artist"),
    ("artwork", "media", "media"),
    ("artwork", "about", "tag"),
    ("artwork", "genre", "genre"),
    ("artwork", "style", "style"),
    ("artwork", "author", "artist"),
    ("artwork", "locatedin", "gallery"),
)


@dataclasses.dataclass(frozen=True)
class OneHot:
    """Symbolic identity feature matrix eye(num) (never materialized)."""

    num: int

    @property
    def shape(self):
        return (self.num, self.num)


Features = Union[np.ndarray, OneHot]


@dataclasses.dataclass
class HeteroGraph:
    node_features: Dict[str, Features]
    num_nodes: Dict[str, int]
    edges: Dict[EdgeType, np.ndarray]  # [2, E] int32, row 0 = src, row 1 = dst
    labels: Dict[str, np.ndarray]      # 'y_style', 'y_genre' over artwork nodes

    @property
    def metadata(self):
        return (tuple(self.num_nodes.keys()), tuple(self.edges.keys()))

    @property
    def num_classes(self) -> Dict[str, int]:
        return {"style": self.num_nodes["style"],
                "genre": self.num_nodes["genre"]}

    @property
    def num_features(self) -> int:
        return self.node_features["artwork"].shape[1]


class ArtGraph:
    """Loader with the reference's constructor surface (root, preprocess,
    features, type); index [0] returns the HeteroGraph."""

    def __init__(self, root: str, preprocess: str = "one-hot", transform=None,
                 pre_transform=None, features: bool = True, type: str = "train"):
        preprocess = None if preprocess is None else preprocess.lower()
        assert preprocess in [None, "constant", "one-hot"]
        assert type in ["train", "validation", "test"]
        self.root = root
        self.preprocess = preprocess
        self.features = features
        self.type = type
        self._graph = self._process()
        if pre_transform is not None:
            self._graph = pre_transform(self._graph)
        self._transform = transform

    @property
    def raw_dir(self) -> str:
        return os.path.join(self.root, "raw")

    def _process(self) -> HeteroGraph:
        node_features: Dict[str, Features] = {}
        num_nodes: Dict[str, int] = {}
        labels: Dict[str, np.ndarray] = {}

        num_nodes_df = pd.read_csv(os.path.join(self.raw_dir, "num-node-dict.csv"))

        if self.features:
            path = os.path.join(self.raw_dir, "node-feat", "artwork", "node-feat.csv")
            x_artwork = pd.read_csv(path, header=None, dtype=np.float32).values
            node_features["artwork"] = x_artwork
            num_nodes["artwork"] = x_artwork.shape[0]
        else:
            num_nodes["artwork"] = int(num_nodes_df["artwork"].tolist()[0])

        for label in ("style", "genre"):
            path = os.path.join(self.raw_dir, "node-label", "artwork",
                                f"node-label-{label}.csv")
            y = pd.read_csv(path, header=None, dtype=np.float32).values.flatten()
            labels[f"y_{label}"] = y.astype(np.int32)

        for node_type in NODE_TYPES_ONE_HOT:
            n = int(num_nodes_df[node_type].tolist()[0])
            num_nodes[node_type] = n
            if self.preprocess == "constant":
                node_features[node_type] = np.arange(
                    n, dtype=np.float32).reshape(-1, 1)
            elif self.preprocess == "one-hot":
                node_features[node_type] = OneHot(n)

        edges: Dict[EdgeType, np.ndarray] = {}
        for edge_type in EDGE_TYPES:
            f = "___".join(edge_type)
            path = os.path.join(self.raw_dir, "relations", f, "edge.csv")
            edge_index = pd.read_csv(path, header=None, dtype=np.int64).values
            h, r, t = edge_type
            edges[(h, f"{r}_rel", t)] = np.ascontiguousarray(
                edge_index.T.astype(np.int32))

        return HeteroGraph(node_features=node_features, num_nodes=num_nodes,
                           edges=edges, labels=labels)

    def __getitem__(self, idx: int) -> HeteroGraph:
        assert idx == 0
        graph = self._graph
        if self._transform is not None:
            graph = self._transform(graph)
        return graph

    @property
    def num_classes(self) -> Dict[str, int]:
        return self._graph.num_classes

    @property
    def num_features(self) -> int:
        return self._graph.num_features


def gat_self_loops(graph: HeteroGraph) -> HeteroGraph:
    """pyg 2.0.2 GATConv(add_self_loops=True) under to_hetero, per relation,
    bipartite ones included: (1) remove existing (i, i) index-equal edges;
    (2) append (i, i) for i < min(N_src, N_dst). The reference's published
    embeddings were trained with these edges (PARITY.md deviation 5)."""
    edges: Dict[EdgeType, np.ndarray] = {}
    for (h, r, t), ei in graph.edges.items():
        keep = ei[:, ei[0] != ei[1]]
        n = min(graph.num_nodes[h], graph.num_nodes[t])
        loops = np.tile(np.arange(n, dtype=ei.dtype), (2, 1))
        edges[(h, r, t)] = np.ascontiguousarray(
            np.concatenate([keep, loops], axis=1))
    return HeteroGraph(node_features=graph.node_features,
                       num_nodes=graph.num_nodes, edges=edges,
                       labels=graph.labels)


def with_csr(graph: HeteroGraph, device="cpu"):
    """Sort every relation's edges by destination and build the CSR metadata
    (ops.csr_segment) on `device` (a torch device or its name), once: the
    topology is static. Returns (graph_sorted, csr_dict); the sort is a
    permutation, so every reduction is unchanged up to f32 summation
    order."""
    from artgraph_tpu_torch.ops.csr_segment import build_csr_dict

    sorted_edges, csrs = build_csr_dict(graph.edges, graph.num_nodes, device)
    g = HeteroGraph(node_features=graph.node_features,
                    num_nodes=graph.num_nodes, edges=sorted_edges,
                    labels=graph.labels)
    return g, csrs


def to_undirected(graph: HeteroGraph) -> HeteroGraph:
    """PyG T.ToUndirected(): same-type relations get the reversed edges
    appended; cross-type relations get a new (dst, 'rev_<rel>', src)."""
    edges: Dict[EdgeType, np.ndarray] = {}
    for (h, r, t), edge_index in graph.edges.items():
        edges[(h, r, t)] = edge_index
    for (h, r, t), edge_index in graph.edges.items():
        reversed_index = edge_index[::-1].copy()
        if h == t:
            edges[(h, r, t)] = np.concatenate(
                [edges[(h, r, t)], reversed_index], axis=1)
        else:
            edges[(t, f"rev_{r}", h)] = reversed_index
    return HeteroGraph(node_features=graph.node_features,
                       num_nodes=graph.num_nodes, edges=edges,
                       labels=graph.labels)

