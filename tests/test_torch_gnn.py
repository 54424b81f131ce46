"""The port's GNN stage (artgraph_tpu_torch: the KG container, the five conv
operators, HeteroSGNN and cli.train_gnn_embeddings) against the JAX package,
on the CPU.

The weights move from the JAX modules' variables to the port through
checkpointing.gnn_state_from_flax. The KG container, the conv operators and
the CLI run on the `synthetic_graph` fixture's ArtGraph tree. HeteroSGNN
runs on `small_kg`: the ArtGraph schema cut to 5 node types and 4 relations
(7 after to_undirected, one of them same-type, and one node type no relation
targets), with at least 8 nodes a type. The fixture's types of 2 nodes make a
train-mode BatchNorm ill-conditioned: there the JAX BatchNorm's one-pass
variance (E[x^2] - E[x]^2 in f32) moves gradients past the tolerance below
against an f64 run, while the port's two-pass one stays inside it. The JAX side
runs its Pallas CSR kernels in interpret mode, the port its plain twins.
Tolerances: forwards at rtol = 1e-4, atol = 1e-5 (summation order only); a
train-mode step's embeddings, parameter gradients and BN running statistics
at rtol = 2e-3, atol = 2e-4, the CSR-vs-XLA gradient bound of
tests/test_csr_segment.py:165. The multi-step test uses SGD, per ROADMAP's
rule for the parity tests.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from artgraph_tpu import config as jax_config
from artgraph_tpu.cli import train_gnn_embeddings as jax_cli
from artgraph_tpu.data import artgraph as jax_kg
from artgraph_tpu.models import gnn as jax_gnn
from artgraph_tpu.ops.csr_segment import build_edge_csr as jax_build_edge_csr
from artgraph_tpu.train import nll_loss as jax_nll_loss
from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import gnn_state_from_flax
from artgraph_tpu_torch.cli import train_gnn_embeddings
from artgraph_tpu_torch.data import artgraph as kg
from artgraph_tpu_torch.data.embeddings import load_embedding
from artgraph_tpu_torch.models import gnn
from artgraph_tpu_torch.ops.csr_segment import build_edge_csr
from artgraph_tpu_torch.train import nll_loss

torch.set_num_threads(2)

VARIANTS = ("train", "train_train", "train_validation", "train_test")
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def load_both(root: str, variant: str = "train"):
    """The variant through both packages: ArtGraph, to_undirected,
    gat_self_loops."""
    split = {"train": "train", "train_train": "train",
             "train_validation": "validation", "train_test": "test"}[variant]
    path = os.path.join(root, variant)
    gj = jax_kg.gat_self_loops(jax_kg.to_undirected(
        jax_kg.ArtGraph(path, type=split)[0]))
    gt = kg.gat_self_loops(kg.to_undirected(kg.ArtGraph(path, type=split)[0]))
    return gj, gt


def as_torch_state(variables: dict, prefix: str = "") -> dict:
    sd = gnn_state_from_flax(variables)
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_kg_container_matches_jax(synthetic_graph, variant):
    gj, gt = load_both(synthetic_graph["root"], variant)
    assert gt.metadata == gj.metadata and gt.num_nodes == gj.num_nodes
    assert len(gt.edges) == 17
    for t, fj in gj.node_features.items():
        ft = gt.node_features[t]
        if isinstance(fj, jax_kg.OneHot):
            assert isinstance(ft, kg.OneHot) and ft.num == fj.num
        else:
            np.testing.assert_array_equal(ft, fj)
    for k, ej in gj.edges.items():
        np.testing.assert_array_equal(gt.edges[k], ej)
    for k, yj in gj.labels.items():
        np.testing.assert_array_equal(gt.labels[k], yj)
    sorted_j, _ = jax_kg.with_csr(gj)
    sorted_t, csrs = kg.with_csr(gt)
    for k, ej in sorted_j.edges.items():
        np.testing.assert_array_equal(sorted_t.edges[k], ej)
        assert csrs[k].dst.num_edges == ej.shape[1]


def _relation(synthetic_graph):
    """artwork -> style of the 'train' variant: dense src features, OneHot
    destinations."""
    _, gt = load_both(synthetic_graph["root"])
    return (gt.node_features["artwork"], gt.num_nodes["style"],
            gt.edges[("artwork", "style_rel", "style")])


@pytest.mark.parametrize("path", ["csr", "segment"])
@pytest.mark.parametrize("op", ["SAGEConv", "GraphConv", "GATConv",
                                "GINConv"])
def test_conv_forward_matches_jax(synthetic_graph, op, path):
    x_src, n_dst, ei = _relation(synthetic_graph)
    n_src = x_src.shape[0]
    F = 8
    if path == "csr":
        ei, csr_j = jax_build_edge_csr(ei, n_src, n_dst)
        _, csr_t = build_edge_csr(ei, n_src, n_dst)
    else:
        csr_j = csr_t = None
    conv_j = jax_gnn.OPERATORS[op](F)
    variables = conv_j.init(jax.random.PRNGKey(3), x_src,
                            jax_kg.OneHot(n_dst), ei, n_dst)
    ref = conv_j.apply(variables, x_src, jax_kg.OneHot(n_dst), ei, n_dst,
                       csr=csr_j)
    conv_t = gnn.OPERATORS[op](x_src.shape[1], n_dst, F)
    name = "conv0__artwork__style_rel__style"
    conv_t.load_state_dict(as_torch_state(
        {"params": {name: variables["params"]}}, f"convs.{name}."),
        strict=True)
    out = conv_t(torch.from_numpy(x_src), kg.OneHot(n_dst),
                 torch.from_numpy(ei.astype(np.int64)), n_dst, csr=csr_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)


def test_gcn_conv_forward_matches_jax():
    """GCN on a homogeneous graph (it has no bipartite mode)."""
    rng = np.random.default_rng(5)
    n, F = 10, 4
    x = rng.normal(size=(n, 6)).astype(np.float32)
    ei = rng.integers(0, n, (2, 30)).astype(np.int32)
    conv_j = jax_gnn.GCNConv(F)
    variables = conv_j.init(jax.random.PRNGKey(4), x, x, ei, n)
    ref = conv_j.apply(variables, x, x, ei, n)
    conv_t = gnn.GCNConv(6, 6, F)
    name = "conv0__a__r__a"
    conv_t.load_state_dict(as_torch_state(
        {"params": {name: variables["params"]}}, f"convs.{name}."),
        strict=True)
    xt = torch.from_numpy(x)
    out = conv_t(xt, xt, torch.from_numpy(ei.astype(np.int64)), n)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    with pytest.raises(ValueError, match="homogeneous"):
        conv_t(xt, kg.OneHot(n), torch.from_numpy(ei.astype(np.int64)), n)


def small_kg(seed: int = 1):
    """The same small KG in both packages (see the module docstring):
    artwork (24 nodes, 8-d features), artist, style and tag (8 each,
    one-hot) joined by 4 relations of 40 edges, and gallery (8, one-hot),
    which no relation targets; to_undirected, then gat_self_loops."""
    rng = np.random.default_rng(seed)
    num = {"artwork": 24, "artist": 8, "style": 8, "tag": 8, "gallery": 8}
    rels = [("artwork", "style_rel", "style"),
            ("artwork", "author_rel", "artist"),
            ("artwork", "about_rel", "tag"),
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


def build_pair(graphs, hidden: int = 16, out: int = 8, **model_kw):
    """A JAX HeteroSGNN (GATConv unless model_kw says otherwise) with its
    variables, dropout 0, on (JAX graph, port graph) with both packages' CSR
    metadata, and a factory of the port's model with the same weights."""
    gj, gt = graphs
    gj_sorted, csr_j = jax_kg.with_csr(gj)
    gt_sorted, csr_t = kg.with_csr(gt)
    kw = dict(hidden_channels=hidden, out_channels=out, dropout=0.0,
              **model_kw)
    model_j = jax_gnn.HeteroSGNN(metadata=gj.metadata, **kw)
    variables = jax.jit(lambda key: model_j.init(
        key, gj.node_features, gj.edges, train=False))(jax.random.PRNGKey(0))

    def model_t():
        model = gnn.HeteroSGNN(gt.metadata,
                               gnn.feature_dims(gt.node_features), **kw)
        model.load_state_dict(as_torch_state(variables), strict=True)
        return model

    x_t, edges_t = gnn.graph_tensors(gt_sorted, "cpu")
    return dict(model_j=model_j, variables=variables, feats=gj.node_features,
                edges_j=gj_sorted.edges, csr_j=csr_j, model_t=model_t,
                x_t=x_t, edges_t=edges_t, csr_t=csr_t,
                y=gj.labels.get("y_style"))


@pytest.fixture(scope="module")
def gat_pair():
    return build_pair(small_kg())


@pytest.mark.parametrize("path", ["csr", "segment"])
def test_heterosgnn_eval_matches_jax(gat_pair, path):
    p = gat_pair
    csr = path == "csr"
    emb_j, outs_j = jax.jit(lambda v: p["model_j"].apply(
        v, p["feats"], p["edges_j"], train=False,
        csr=p["csr_j"] if csr else None))(p["variables"])
    model = p["model_t"]().eval()
    with torch.no_grad():
        emb_t, outs_t = model(p["x_t"], p["edges_t"],
                              csr=p["csr_t"] if csr else None)
    for t, e in emb_j.items():
        np.testing.assert_allclose(emb_t[t].numpy(), np.asarray(e), **FWD,
                                   err_msg=t)
        np.testing.assert_allclose(outs_t[0][t].numpy(),
                                   np.asarray(outs_j[0][t]), **FWD, err_msg=t)
    assert emb_t["artwork"].shape == (p["y"].shape[0], 16)


@pytest.mark.parametrize("aggr", ["mean", "max"])
def test_heterosgnn_aggr_modes_match_jax(aggr):
    """Across-relation aggregation modes (segment path, one GraphConv
    layer, BatchNorm on as the CLI builds it)."""
    p = build_pair(small_kg(), operator="GraphConv", n_layers=1, aggr=aggr)
    emb_j, _ = p["model_j"].apply(p["variables"], p["feats"], p["edges_j"])
    with torch.no_grad():
        emb_t, _ = p["model_t"]().eval()(p["x_t"], p["edges_t"])
    for t, e in emb_j.items():
        np.testing.assert_allclose(emb_t[t].numpy(), np.asarray(e), **FWD)


def test_heterosgnn_prelu_matches_jax():
    """--activation prelu (one alpha per layer, shared by the node types),
    eval on the CSR path. On a graph of one node type:
    the JAX HeteroSGNN creates its `prelu<layer>` parameter once per node
    type, which flax refuses (NameInUseError) as soon as there are two."""
    rng = np.random.default_rng(3)
    n = 16
    ei = rng.integers(0, n, (2, 50)).astype(np.int32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    graphs = tuple(pkg.gat_self_loops(pkg.to_undirected(pkg.HeteroGraph(
        node_features={"artist": x}, num_nodes={"artist": n},
        edges={("artist", "teacher_rel", "artist"): ei}, labels={})))
        for pkg in (jax_kg, kg))
    p = build_pair(graphs, activation="prelu")
    # a slope other than the init's 0.25, on both sides; it reaches only the
    # output conv's input, so the log-probs show it
    p["variables"]["params"]["prelu1"] = jnp.full((1,), -0.5, jnp.float32)
    emb_j, outs_j = p["model_j"].apply(p["variables"], p["feats"],
                                       p["edges_j"], csr=p["csr_j"])
    with torch.no_grad():
        emb_t, outs_t = p["model_t"]().eval()(p["x_t"], p["edges_t"],
                                              csr=p["csr_t"])
    np.testing.assert_allclose(emb_t["artist"].numpy(),
                               np.asarray(emb_j["artist"]), **FWD)
    np.testing.assert_allclose(outs_t[0]["artist"].numpy(),
                               np.asarray(outs_j[0]["artist"]), **FWD)


@pytest.fixture(scope="module")
def jax_sgd_run(gat_pair):
    """Five train-mode SGD(1e-2) steps of the JAX model on the CSR path:
    per step the loss, the first step's embeddings, gradients and BN
    statistics, and the final variables."""
    p = gat_pair

    def loss_fn(params, stats):
        (emb, outs), mut = p["model_j"].apply(
            {"params": params, "batch_stats": stats}, p["feats"],
            p["edges_j"], train=True, csr=p["csr_j"],
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return (jax_nll_loss(outs[0]["artwork"], jnp.asarray(p["y"])),
                (emb["artwork"], mut["batch_stats"]))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = optax.sgd(1e-2)
    params, stats = p["variables"]["params"], p["variables"]["batch_stats"]
    opt_state = tx.init(params)
    run = {"losses": []}
    for i in range(5):
        (loss, (emb, new_stats)), grads = grad_fn(params, stats)
        if i == 0:
            run.update(emb=np.asarray(emb), grads=grads, stats=new_stats)
        updates, opt_state = tx.update(grads, opt_state, params)
        params, stats = optax.apply_updates(params, updates), new_stats
        run["losses"].append(float(loss))
    run["final"] = {"params": params, "batch_stats": stats}
    return run


def _torch_loss(p, model):
    model.train()
    emb, outs = model(p["x_t"], p["edges_t"], csr=p["csr_t"])
    y = torch.from_numpy(p["y"].astype(np.int64))
    return nll_loss(outs[0]["artwork"], y), emb


def test_heterosgnn_train_step_matches_jax(gat_pair, jax_sgd_run):
    """One train-mode step on the CSR path: loss, embeddings, every parameter
    gradient and the BN running statistics."""
    model = gat_pair["model_t"]()
    loss, emb = _torch_loss(gat_pair, model)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_sgd_run["losses"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(emb["artwork"].detach().numpy(),
                               jax_sgd_run["emb"], **GRAD)
    want = gnn_state_from_flax({"params": jax_sgd_run["grads"]})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for k, g in want.items():
        if named[k].grad is None:
            # no path to the loss (a conv_out relation into a type other than
            # artwork): autograd never reaches it, JAX gives exact zeros
            np.testing.assert_array_equal(g, 0.0, err_msg=k)
            continue
        np.testing.assert_allclose(named[k].grad.numpy(), g, **GRAD,
                                   err_msg=k)
    stats = gnn_state_from_flax({"params": {},
                                 "batch_stats": jax_sgd_run["stats"]})
    buffers = model.state_dict()
    for k, v in stats.items():
        if "num_batches" in k:      # torch's own counter; flax keeps none
            assert int(buffers[k]) == 1
            continue
        np.testing.assert_allclose(buffers[k].numpy(), v, **GRAD, err_msg=k)


def test_heterosgnn_train_forward_matches_f64(gat_pair):
    """The port's train-mode forward in f32 on the CSR path against its own
    segment path in f64: every node type's embedding within 1e-4."""
    p = gat_pair
    _, emb = _torch_loss(p, p["model_t"]())
    model64 = p["model_t"]().double().train()
    x64 = {t: v.double() if isinstance(v, torch.Tensor) else v
           for t, v in p["x_t"].items()}
    with torch.no_grad():
        emb64, _ = model64(x64, p["edges_t"])
    for t, e in emb64.items():
        np.testing.assert_allclose(emb[t].detach().numpy(), e.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=t)


def test_heterosgnn_five_sgd_steps_match_jax(gat_pair, jax_sgd_run):
    model = gat_pair["model_t"]()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    for loss_j in jax_sgd_run["losses"]:
        opt.zero_grad()
        loss, _ = _torch_loss(gat_pair, model)
        loss.backward()
        opt.step()
        np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-4)
    got = model.state_dict()
    for k, v in gnn_state_from_flax(jax_sgd_run["final"]).items():
        if "num_batches" not in k:
            np.testing.assert_allclose(got[k].numpy(), v, **GRAD, err_msg=k)


@pytest.fixture()
def kg_dirs(synthetic_graph, monkeypatch, tmp_path):
    """Both CLIs read the synthetic KG and write embeddings under tmp_path."""
    for mod in (config, jax_config):
        monkeypatch.setattr(mod, "DATASET_DIR", synthetic_graph["root"])
    monkeypatch.setattr(config, "EMBEDDINGS_DIR", str(tmp_path / "torch"))
    monkeypatch.setattr(jax_config, "EMBEDDINGS_DIR", str(tmp_path / "jax"))
    return tmp_path


def _keys(text: str) -> list:
    return [line.split(" ")[0] for line in text.splitlines()]


def test_cli_cpu_prints_the_jax_lines_and_saves_embeddings(
        synthetic_graph, kg_dirs, capsys, monkeypatch):
    # the JAX CLI on its XLA segment path (no CSR metadata) with GraphConv:
    # the lines it prints do not depend on either, and it compiles in half
    # the time of GATConv, without the interpret-mode kernels
    monkeypatch.setattr(jax_kg, "with_csr", lambda g: (g, None))
    jax_cli.main(["--epochs", "6", "--no_epoch_scan", "--operator",
                  "GraphConv"])
    jax_out = capsys.readouterr().out
    train_gnn_embeddings.main(["--epochs", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _keys(out) == _keys(jax_out)
    assert out.count("style_val_loss") == 3      # epochs 0 and 5, final
    n = synthetic_graph["counts"]["artwork"]
    for stem in ("test_gnn_artwork_style_embs", "test_gnn_style_embs"):
        emb = load_embedding(str(kg_dirs / "torch" / f"{stem}.pt"))
        assert emb.shape == (n, 128) and np.isfinite(emb).all()
        ref = load_embedding(str(kg_dirs / "jax" / f"{stem}.pt"))
        assert ref.shape == emb.shape


def test_cli_refuses_what_is_not_ported(kg_dirs, monkeypatch):
    # --data_parallel is ported (tests/test_torch_gnn_parallel.py): more
    # ranks than visible CUDA devices are refused before any rank starts
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="visible CUDA devices"):
            train_gnn_embeddings.main(["--data_parallel", "2"])
    # --resume is ported (tests/test_torch_runcontrol.py): on cuda without a
    # card it raises instead of training on the CPU, and saves nothing
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_gnn_embeddings.main(["--resume", str(kg_dirs / "resume")])
    assert not (kg_dirs / "resume").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_gnn_embeddings.main(["--epochs", "1"])
