"""The GNN variants no reference script uses (artgraph_tpu_torch.models.gnn:
HeteroSGNN's `skip` and `bn=False`, HeteroMGNN, HomoGNN / HomoSGNN) and
data.artgraph.del_some_nodes against the JAX package, on the CPU.

The weights move from the JAX modules' variables to the port through
checkpointing.gnn_state_from_flax (its `lin<i>__<type>`, `gnn_<task>/` and
HomoGNN names), loaded strict. The hetero models run on `variant_kg` (3
node types of at least 8 nodes, 3 relations after to_undirected, one of
them same-type: few modules, so the JAX side compiles fast), the
homogeneous ones on a seeded graph of 24 nodes and 80 edges,
at hidden 8 and 1 layer for the hetero models, as test_gnn.py:175-210 runs
the JAX modules, and 2 layers for the homogeneous ones. For the hetero
models every operator that runs on a bipartite KG (GCNConv, as in PyG,
does not), for HeteroSGNN on both the CSR kernel path and the `index_add_`
path (HeteroMGNN passes no CSR, as the JAX module does); for HomoSGNN
GCNConv, its default, and SAGEConv, with and without skip: the embeddings and
log-softmax, and the gradients of one train-mode step's NLL loss (dropout
0, BatchNorm on batch statistics). Tolerances, test_torch_gnn.py's: a
forward without BatchNorm's batch statistics (eval mode, or HeteroSGNN
with bn=False) at rtol = 1e-4, atol = 1e-5 (summation order only);
gradients and train-mode forwards through BatchNorm at rtol = 2e-3, atol =
2e-4. A parameter with no path to the loss has no gradient in the port and
exact zeros in JAX.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artgraph_tpu.data import artgraph as jax_kg
from artgraph_tpu.models import gnn as jax_gnn
from artgraph_tpu.train import nll_loss as jax_nll_loss
from artgraph_tpu_torch.checkpointing import gnn_state_from_flax
from artgraph_tpu_torch import models
from artgraph_tpu_torch.data import artgraph as kg
from artgraph_tpu_torch.models import gnn
from artgraph_tpu_torch.train import nll_loss
from test_torch_gnn import FWD, GRAD, build_pair

torch.set_num_threads(2)

HETERO_OPS = ("SAGEConv", "GraphConv", "GATConv", "GINConv")
HOMO_OPS = ("GCNConv", "SAGEConv")


def _state(variables) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in gnn_state_from_flax(variables).items()}


def _assert_grads(model, jax_grads):
    want = gnn_state_from_flax({"params": jax_grads})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for k, g in want.items():
        if named[k].grad is None:
            np.testing.assert_array_equal(g, 0.0, err_msg=k)
            continue
        np.testing.assert_allclose(named[k].grad.numpy(), g, **GRAD,
                                   err_msg=k)


def variant_kg(seed: int = 4):
    """The same KG in both packages, small so that the JAX modules compile
    fast: artwork (24 nodes, 8-d features), style and artist (8 each,
    one-hot); artwork style_rel style and artist teacher_rel artist of 40
    edges, to_undirected (3 relations, one same-type), gat_self_loops."""
    rng = np.random.default_rng(seed)
    num = {"artwork": 24, "style": 8, "artist": 8}
    rels = [("artwork", "style_rel", "style"),
            ("artist", "teacher_rel", "artist")]
    edges = {(h, r, t): np.stack([rng.integers(0, num[h], 40),
                                  rng.integers(0, num[t], 40)])
             .astype(np.int32) for h, r, t in rels}
    x = rng.normal(size=(num["artwork"], 8)).astype(np.float32)
    labels = {"y_style": rng.integers(0, num["style"], num["artwork"])
              .astype(np.int32)}
    out = []
    for pkg in (jax_kg, kg):
        feats = {t: x if t == "artwork" else pkg.OneHot(n)
                 for t, n in num.items()}
        g = pkg.HeteroGraph(node_features=feats, num_nodes=dict(num),
                            edges=dict(edges), labels=labels)
        out.append(pkg.gat_self_loops(pkg.to_undirected(g)))
    return tuple(out)


@pytest.fixture(scope="module")
def kg_graphs():
    return variant_kg()


def _outputs_and_grads(loss_and_outputs, params):
    """The JAX outputs and the gradients of one train-mode loss, one
    compile."""
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss_and_outputs, has_aux=True))(params)
    return outs, grads


def _assert_outputs(emb_t, soft_t, emb_j, soft_j, tol, what=""):
    for t, e in emb_j.items():
        np.testing.assert_allclose(emb_t[t].detach().numpy(), np.asarray(e),
                                   **tol, err_msg=f"{what} {t}")
        np.testing.assert_allclose(soft_t[t].detach().numpy(),
                                   np.asarray(soft_j[t]), **tol,
                                   err_msg=f"{what} {t}")


@pytest.mark.parametrize("path", ["csr", "segment"])
@pytest.mark.parametrize("op", HETERO_OPS)
def test_heterosgnn_skip_without_bn_matches_jax(kg_graphs, op, path):
    """Without BatchNorm and at dropout 0 the train-mode forward is the
    eval one: the forward at FWD, its gradients at GRAD."""
    p = build_pair(kg_graphs, operator=op, skip=True, bn=False, n_layers=1)
    assert "batch_stats" not in p["variables"]
    assert sorted(k for k in p["variables"]["params"]
                  if k.startswith("lin")) == sorted(
        f"lin0__{t}" for t in kg_graphs[1].num_nodes)
    csr_j = p["csr_j"] if path == "csr" else None
    csr_t = p["csr_t"] if path == "csr" else None
    y = jnp.asarray(p["y"])

    def loss_j(params):
        emb, outs = p["model_j"].apply({"params": params}, p["feats"],
                                       p["edges_j"], train=True, csr=csr_j)
        return jax_nll_loss(outs[0]["artwork"], y), (emb, outs[0])

    (emb_j, soft_j), grads = _outputs_and_grads(loss_j,
                                                p["variables"]["params"])
    model = p["model_t"]()
    assert not any(k.startswith("bns.") for k in model.state_dict())
    emb_t, outs = model.train()(p["x_t"], p["edges_t"], csr=csr_t)
    _assert_outputs(emb_t, outs[0], emb_j, soft_j, FWD)
    nll_loss(outs[0]["artwork"], torch.from_numpy(p["y"].astype(np.int64))
             ).backward()
    _assert_grads(model, grads)


def test_heterosgnn_defaults_keep_the_state_dict(kg_graphs):
    """bn=True, skip=False (train_gnn_embeddings' model): no `lins.`
    entries, a BatchNorm per layer and type, as before the options."""
    _, gt = kg_graphs
    model = gnn.HeteroSGNN(gt.metadata, gnn.feature_dims(gt.node_features),
                           hidden_channels=8, out_channels=4)
    keys = list(model.state_dict())
    assert not any(k.startswith("lins.") for k in keys)
    assert {k.split(".")[1] for k in keys if k.startswith("bns.")} == {
        f"bn{i}__{t}" for i in range(2) for t in gt.num_nodes}


MGNN_OUT = {"artist": 9, "style": 8, "genre": 10}


@pytest.mark.parametrize("op", HETERO_OPS)
def test_heteromgnn_matches_jax(kg_graphs, op):
    """Skip and BatchNorm on: the train-mode forward (batch statistics)
    and its gradients, both at GRAD."""
    gj, gt = kg_graphs
    kw = dict(operator=op, hidden_channels=8, out_channels=MGNN_OUT,
              n_layers=1, dropout=0.0, skip=True)
    model_j = jax_gnn.HeteroMGNN(metadata=gj.metadata, **kw)
    variables = jax.jit(lambda key: model_j.init(
        key, gj.node_features, gj.edges))(jax.random.PRNGKey(1))
    model = gnn.HeteroMGNN(gt.metadata, gnn.feature_dims(gt.node_features),
                           **kw)
    model.load_state_dict(_state(variables), strict=True)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "gnn_artist", "gnn_style", "gnn_genre"}
    x_t, edges_t = gnn.graph_tensors(gt, "cpu")
    y = gj.labels["y_style"]

    def loss_j(params):
        outs, _ = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            gj.node_features, gj.edges, train=True, mutable=["batch_stats"])
        return sum(jax_nll_loss(o[1][0]["artwork"], jnp.asarray(y))
                   for o in outs), outs

    outs_j, grads = _outputs_and_grads(loss_j, variables["params"])
    outs_t = model.train()(x_t, edges_t)
    assert len(outs_t) == len(outs_j) == 3
    for task, (emb_t, soft_t), (emb_j, soft_j) in zip(
            gnn.HeteroMGNN.TASKS, outs_t, outs_j):
        assert soft_t[0]["artwork"].shape == (24, MGNN_OUT[task])
        _assert_outputs(emb_t, soft_t[0], emb_j, soft_j[0], GRAD, task)
    yt = torch.from_numpy(y.astype(np.int64))
    sum(nll_loss(o[1][0]["artwork"], yt) for o in outs_t).backward()
    _assert_grads(model, grads)


def _homo_graph(seed: int = 2):
    rng = np.random.default_rng(seed)
    n = 24
    x = rng.normal(size=(n, 6)).astype(np.float32)
    ei = rng.integers(0, n, (2, 80)).astype(np.int32)
    y = rng.integers(0, 5, n).astype(np.int32)
    return x, ei, y


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("op", HOMO_OPS)
def test_homosgnn_matches_jax(op, skip):
    x, ei, y = _homo_graph()
    kw = dict(operator=op, hidden_channels=8, out_channels=5, n_layers=2,
              skip=skip)
    model_j = jax_gnn.HomoSGNN(**kw)
    variables = model_j.init(jax.random.PRNGKey(2), x, ei)
    model = gnn.HomoSGNN(x.shape[1], **kw)
    model.load_state_dict(_state(variables), strict=True)
    assert ("gnn.lin0.kernel" in model.state_dict()) == skip
    xt = torch.from_numpy(x)
    eit = torch.from_numpy(ei.astype(np.int64))

    emb_j, outs_j = model_j.apply(variables, x, ei)
    with torch.no_grad():
        emb_t, outs_t = model.eval()(xt, eit)
    assert emb_t.shape == (24, 8) and outs_t[0].shape == (24, 5)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), **FWD)
    np.testing.assert_allclose(outs_t[0].numpy(), np.asarray(outs_j[0]),
                               **FWD)

    def loss_j(params):
        (_, outs), _ = model_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, ei, train=True, mutable=["batch_stats"])
        return jax_nll_loss(outs[0], jnp.asarray(y))

    grads = jax.jit(jax.grad(loss_j))(variables["params"])
    _, outs = model.train()(xt, eit)
    nll_loss(outs[0], torch.from_numpy(y.astype(np.int64))).backward()
    _assert_grads(model, grads)


def test_homognn_defaults_match_jax():
    """The JAX defaults: GCNConv, hidden 16, out 300, one layer; BatchNorm
    whatever `bn` says, and no activation or dropout (eval output the same
    with dropout 0.5 as the JAX module's)."""
    x, ei, _ = _homo_graph(3)
    model_j = jax_gnn.HomoGNN()
    variables = model_j.init(jax.random.PRNGKey(3), x, ei)
    model = models.HomoGNN(x.shape[1])
    assert models.HomoGNN is gnn.HomoGNN
    model.load_state_dict(_state(variables), strict=True)
    assert sorted(k.split(".")[0] for k in model.state_dict()) == sorted(
        ["bn0"] * 5 + ["conv0"] * 2 + ["conv_out"] * 2)
    emb_j, soft_j = model_j.apply(variables, x, ei)
    with torch.no_grad():
        emb_t, soft_t = model.eval()(torch.from_numpy(x),
                                     torch.from_numpy(ei.astype(np.int64)))
    assert soft_t.shape == (24, 300)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), **FWD)
    np.testing.assert_allclose(soft_t.numpy(), np.asarray(soft_j), **FWD)


@pytest.mark.parametrize("undirected", [False, True])
def test_del_some_nodes_matches_jax(synthetic_graph, undirected):
    path = os.path.join(synthetic_graph["root"], "train")
    gj = jax_kg.ArtGraph(path)[0]
    gt = kg.ArtGraph(path)[0]
    if undirected:
        gj, gt = jax_kg.to_undirected(gj), kg.to_undirected(gt)
    rj, rt = jax_kg.del_some_nodes(gj), kg.del_some_nodes(gt)
    assert set(rt.num_nodes) == {"artwork", "artist", "style", "tag",
                                 "media"}
    assert rt.num_nodes == rj.num_nodes and rt.metadata == rj.metadata
    assert ("artist", "teacher_rel", "artist") not in rt.edges
    assert list(rt.edges) == list(rj.edges)
    for k, e in rj.edges.items():
        np.testing.assert_array_equal(rt.edges[k], e)
    for t, f in rj.node_features.items():
        if isinstance(f, jax_kg.OneHot):
            assert rt.node_features[t] == kg.OneHot(f.num)
        else:
            np.testing.assert_array_equal(rt.node_features[t], f)
    assert rt.labels is gt.labels
