"""The port's edge-sharded GNN (artgraph_tpu_torch/parallel/gnn_parallel.py,
the `axis_name` branches of ops/segment.py, ops/csr_segment.py and
models/gnn.py, `train_gnn_embeddings --data_parallel`) against the JAX
package's make_sharded_forward and against the port's own single process,
on the CPU.

The ranks are gloo processes from parallel.mesh.spawn (one thread each, a
`file://` rendezvous under tmp_path, a join timeout); their body lives in
this module, which imports torch and numpy only at module level, and writes
.npz files. One spawn a world size (2 and 4) runs every case: GATConv and
SAGEConv, each on the CSR kernel path (their plain twins on the CPU) and the
segment path, at dropout 0 (against JAX), and GATConv's CSR path at 0.4
(every rank draws the same masks from a generator in the same state, so the
single process with that generator is the reference). Each case: the eval
forward, a train-mode forward, the NLL loss on the artwork nodes, its
gradients after sync_grads, and one SGD step. The graph is `small_kg`: the ArtGraph schema
cut to 4 node types of at least 8 nodes and 3 relations, with one hidden
layer (the JAX side's interpret-mode CSR kernels take ~20 s to compile a
GAT step of test_torch_gnn's 7 relations at two layers).

Tolerances: against the port's single process rtol 1e-4, atol 1e-5 for
outputs, gradients, parameters and BN statistics (f32, the order of the
sums only); against JAX, the forwards at test_torch_gnn's FWD
(rtol 1e-4, atol 1e-5) and the gradients and running statistics at its
GRAD (rtol 2e-3, atol 2e-4, the CSR-vs-XLA bound of
tests/test_csr_segment.py).
"""
import os
import re

import numpy as np
import pytest
import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.data import artgraph as kg
from artgraph_tpu_torch.data.embeddings import load_embedding
from artgraph_tpu_torch.models import gnn
from artgraph_tpu_torch.parallel.gnn_parallel import (device_put_graph,
                                                      device_put_graph_csr,
                                                      init_variables,
                                                      make_sharded_forward,
                                                      pad_and_shard_edges,
                                                      shard_graph_csr)
from artgraph_tpu_torch.parallel.mesh import spawn, sync_grads
from artgraph_tpu_torch.train import nll_loss

HIDDEN, OUT, LAYERS = 16, 8, 1
LR = 0.1
TIMEOUT = 120.0
OPERATORS = ("GATConv", "SAGEConv")
NEAR = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)


def run_case(graph, state: dict, operator: str, path: str, rate: float,
             mesh=None) -> dict:
    """Eval forward, train forward + loss + gradients (averaged over the
    ranks) and one SGD step of a HeteroSGNN from `state`; on this rank's
    edge shard over a mesh."""
    model = gnn.HeteroSGNN(graph.metadata, gnn.feature_dims(
        graph.node_features), operator=operator, hidden_channels=HIDDEN,
        out_channels=OUT, n_layers=LAYERS, dropout=rate,
        axis_name=None if mesh is None else mesh.axis_name)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    if mesh is not None:
        init_variables(model, mesh)
        x, edges, csr = (device_put_graph_csr(graph, mesh) if path == "csr"
                         else (*device_put_graph(graph, mesh), None))
        forward = make_sharded_forward(model, mesh)
    else:
        g, csr = kg.with_csr(graph) if path == "csr" else (graph, None)
        x, edges = gnn.graph_tensors(g, "cpu")

        def forward(x, edges, train=False, generator=None, csr=None):
            model.train(train)
            return model(x, edges, csr=csr, generator=generator)

    out = {}
    with torch.no_grad():
        emb, outs = forward(x, edges, train=False, csr=csr)
    out["eval_emb"] = emb["artwork"].numpy()
    out["eval_logp"] = outs[0]["artwork"].numpy()
    generator = torch.Generator().manual_seed(config.GLOBAL_SEED)
    emb, outs = forward(x, edges, train=True, generator=generator, csr=csr)
    y = torch.from_numpy(graph.labels["y_style"].astype(np.int64))
    loss = nll_loss(outs[0]["artwork"], y)
    loss.backward()
    if mesh is not None:
        sync_grads(model.parameters(), mesh)
    out["train_emb"] = emb["artwork"].detach().numpy()
    out["loss"] = loss.detach().numpy()
    for k, p in model.named_parameters():
        out[f"grad/{k}"] = (p.grad.numpy().copy() if p.grad is not None
                            else np.zeros_like(p.detach().numpy()))
    torch.optim.SGD(model.parameters(), lr=LR).step()
    for k, v in model.state_dict().items():
        out[f"state/{k}"] = v.numpy().copy()
    return out


# (operator, path, dropout): every operator on both paths at dropout 0, and
# GATConv's kernel path under dropout
CASES = [(op, path, 0.0) for op in OPERATORS for path in ("csr", "segment")]
CASES.append(("GATConv", "csr", 0.4))


def _case_key(op, path, rate) -> str:
    return f"{op}/{path}/{rate}"


def _gnn_rank(mesh, out_dir: str, graph, states: dict) -> None:
    results = {}
    for op, path, rate in CASES:
        for k, v in run_case(graph, states[op], op, path, rate,
                             mesh).items():
            results[f"{_case_key(op, path, rate)}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **results)


def small_kg(pkg, seed: int = 1):
    """A small KG in the package `pkg` (the port's or the JAX package's
    data.artgraph), the schema of test_torch_gnn's small_kg cut to two
    relations: artwork (24 nodes, 8-d features), style and artist (8 each,
    one-hot) joined by artwork -> style and artist -> artist (40 edges
    each), and gallery (8, one-hot), which no relation targets;
    to_undirected (3 relations: one reversed, one same-type doubled), then
    gat_self_loops."""
    rng = np.random.default_rng(seed)
    num = {"artwork": 24, "artist": 8, "style": 8, "gallery": 8}
    rels = [("artwork", "style_rel", "style"),
            ("artist", "teacher_rel", "artist")]
    edges = {(h, r, t): np.stack([rng.integers(0, num[h], 40),
                                  rng.integers(0, num[t], 40)])
             .astype(np.int32) for h, r, t in rels}
    x = rng.normal(size=(num["artwork"], 8)).astype(np.float32)
    labels = {"y_style": rng.integers(0, num["style"], num["artwork"])
              .astype(np.int32)}
    feats = {t: x if t == "artwork" else pkg.OneHot(n)
             for t, n in num.items()}
    g = pkg.HeteroGraph(node_features=feats, num_nodes=dict(num),
                        edges=dict(edges), labels=labels)
    return pkg.gat_self_loops(pkg.to_undirected(g))


def _jax_pair():
    """(JAX graph, port graph) of small_kg, and per operator the JAX model
    (axis_name='data', dropout 0), its variables and their port state."""
    import jax

    from artgraph_tpu.data import artgraph as jax_kg
    from artgraph_tpu.models import gnn as jax_gnn
    from artgraph_tpu_torch.checkpointing import gnn_state_from_flax

    gj, gt = small_kg(jax_kg), small_kg(kg)
    models = {}
    for op in OPERATORS:
        kw = dict(operator=op, hidden_channels=HIDDEN, out_channels=OUT,
                  n_layers=LAYERS, dropout=0.0)
        single = jax_gnn.HeteroSGNN(metadata=gj.metadata, **kw)
        variables = jax.jit(lambda key: single.init(
            key, gj.node_features, gj.edges, train=False))(
                jax.random.PRNGKey(0))
        models[op] = (jax_gnn.HeteroSGNN(metadata=gj.metadata,
                                         axis_name="data", **kw),
                      variables, gnn_state_from_flax(variables))
    return gj, gt, models


@pytest.fixture(scope="module")
def pair():
    return _jax_pair()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def sharded(request, pair, tmp_path_factory):
    world = request.param
    _, gt, models = pair
    out = tmp_path_factory.mktemp(f"gnn{world}")
    states = {op: m[2] for op, m in models.items()}
    spawn(_gnn_rank, world, "gloo", init_file=str(out / "rendezvous"),
          timeout=TIMEOUT, args=(str(out), gt, states), threads=1)
    return world, [dict(np.load(out / f"rank{r}.npz"))
                   for r in range(world)]


def test_sharded_ranks_hold_the_same_outputs(sharded):
    """Outputs, gradients and the stepped state are the same on every rank
    (dropout 0.4 included: the masks are drawn alike)."""
    _, ranks = sharded
    for other in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=lambda c: _case_key(*c))
def test_sharded_matches_single_process(sharded, pair, case):
    _, gt, models = pair
    _, ranks = sharded
    op, path, rate = case
    want = run_case(gt, models[op][2], op, path, rate)
    prefix = _case_key(*case) + "/"
    for k, w in want.items():
        np.testing.assert_allclose(ranks[0][prefix + k], w, err_msg=k,
                                   **NEAR)


# the JAX mesh each operator's reference runs on; both of the port's world
# sizes are held to it (the sharded function does not depend on the size)
JAX_MESH = {"GATConv": 2, "SAGEConv": 4}


@pytest.fixture(scope="module")
def jax_sharded(pair):
    """Per operator, JAX's make_sharded_forward over device_put_graph_csr on
    a JAX_MESH-device mesh, dropout 0: the eval outputs, the train forward's
    embeddings, the loss, the gradients and the BatchNorm running
    statistics, as the port's names."""
    import jax

    from artgraph_tpu.parallel.gnn_parallel import (device_put_graph_csr as
                                                    jax_put_csr,
                                                    make_sharded_forward as
                                                    jax_sharded_forward)
    from artgraph_tpu.parallel.mesh import create_mesh
    from artgraph_tpu.train import nll_loss as jax_nll
    from artgraph_tpu_torch.checkpointing import gnn_state_from_flax

    gj, _, models = pair
    y = gj.labels["y_style"]
    refs = {}
    for op, world in JAX_MESH.items():
        model_j, variables, _ = models[op]
        mesh = create_mesh(data=world, model=1,
                           devices=jax.devices()[:world])
        feats, edges, csr = jax_put_csr(gj, mesh)
        forward = jax_sharded_forward(model_j, mesh)

        @jax.jit
        def run(variables):
            emb, outs = forward(variables, feats, edges, csr=csr)

            def loss_fn(params):
                (temb, touts), mut = forward(
                    {**variables, "params": params}, feats, edges,
                    train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                    csr=csr)
                return jax_nll(touts[0]["artwork"], y), (temb, mut)

            (loss, (temb, mut)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(variables["params"])
            return (emb["artwork"], outs[0]["artwork"], temb["artwork"],
                    loss, grads, mut["batch_stats"])

        emb, logp, temb, loss, grads, stats = jax.device_get(run(variables))
        ref = {"eval_emb": emb, "eval_logp": logp, "train_emb": temb,
               "loss": loss}
        ref.update({f"grad/{k}": g for k, g in
                    gnn_state_from_flax({"params": grads}).items()})
        ref.update({f"state/{k}": v for k, v in gnn_state_from_flax(
            {"params": variables["params"], "batch_stats": stats}).items()
            if "running" in k})
        refs[op] = ref
    return refs


@pytest.mark.parametrize("op", OPERATORS)
def test_sharded_matches_jax_make_sharded_forward(sharded, jax_sharded, op):
    """The port's ranks (CSR path, dropout 0) against JAX's
    make_sharded_forward over device_put_graph_csr: forwards at FWD, the
    gradients and running statistics at GRAD."""
    _, ranks = sharded
    prefix = _case_key(op, "csr", 0.0) + "/"
    for k, w in jax_sharded[op].items():
        tol = FWD if "/" not in k else GRAD
        np.testing.assert_allclose(ranks[0][prefix + k], w, err_msg=k,
                                   **tol)


def test_pad_and_shard_edges_match_jax(pair):
    from artgraph_tpu.parallel.gnn_parallel import \
        pad_and_shard_edges as jax_pad

    gj, gt, _ = pair
    for world in (2, 4, 8):
        want = jax_pad(gj, world)
        got = pad_and_shard_edges(gt, world)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_graph_csr_matches_jax_shard_for_shard(pair, world):
    """Each port shard is the JAX shard (dst-sorted) without its sentinel
    edges, with the same in-degree counts; the shards together hold every
    edge once."""
    from artgraph_tpu.parallel.gnn_parallel import \
        shard_graph_csr as jax_shard

    gj, gt, _ = pair
    want_edges, want_csrs = jax_shard(gj, world)
    got_edges, got_csrs = shard_graph_csr(gt, world)
    for key, w in want_edges.items():
        num_dst = gt.num_nodes[key[2]]
        sz = w.shape[1] // world
        for k in range(world):
            jshard = w[:, k * sz:(k + 1) * sz]
            np.testing.assert_array_equal(
                got_edges[key][k], jshard[:, jshard[1] < num_dst],
                err_msg=str(key))
            np.testing.assert_array_equal(
                got_csrs[key][k].dst.counts.numpy(),
                np.asarray(want_csrs[key].dst.counts[k]), err_msg=str(key))
        joined = np.concatenate(got_edges[key], axis=1)
        assert sorted(map(tuple, joined.T)) == \
            sorted(map(tuple, gt.edges[key].T))


def _lines(text: str):
    number = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    lines = [ln for ln in text.splitlines() if ln.startswith("style_")]
    return ([re.sub(number, "#", ln) for ln in lines],
            [float(x) for ln in lines for x in re.findall(number, ln)])


def test_cli_data_parallel_matches_single(synthetic_graph, tmp_path,
                                          monkeypatch, capfd):
    """train_gnn_embeddings --data_parallel 2 --device cpu --epochs 1 (the
    CLI starts its two gloo ranks; they read the KG and write the
    embeddings where the environment says) against the one-process run:
    the same printed lines (the numbers within 1e-3), embeddings (rtol
    1e-4, atol 1e-5), one pair of embedding files. At --lr 0: Adam's first
    step turns the last-bit noise in the gradients of the conv biases that
    feed BatchNorm (zero in exact arithmetic) into steps of +-lr, which
    moves this KG's validation loss by ~0.4% between two thread counts of
    the one-process run alone; the gradients are held above."""
    from artgraph_tpu_torch.cli import train_gnn_embeddings

    monkeypatch.setattr(config, "DATASET_DIR", synthetic_graph["root"])
    monkeypatch.setattr(config, "EMBEDDINGS_DIR", str(tmp_path / "single"))
    argv = ["--epochs", "1", "--lr", "0", "--device", "cpu"]
    train_gnn_embeddings.main(argv)
    single = capfd.readouterr().out
    monkeypatch.setenv("ARTGRAPH_DATASET_DIR", synthetic_graph["root"])
    monkeypatch.setenv("ARTGRAPH_EMBEDDINGS_DIR", str(tmp_path / "dp"))
    train_gnn_embeddings.main(argv + ["--data_parallel", "2"])
    dp = capfd.readouterr().out
    w1, n1 = _lines(single)
    w2, n2 = _lines(dp)
    assert w1 == w2 and len(w1) == 10
    np.testing.assert_allclose(n2, n1, rtol=0, atol=1e-3)
    assert dp.count("Saved.") == 1
    assert sorted(os.listdir(tmp_path / "dp")) == \
        sorted(os.listdir(tmp_path / "single"))
    for name in os.listdir(tmp_path / "dp"):
        np.testing.assert_allclose(
            load_embedding(str(tmp_path / "dp" / name)),
            load_embedding(str(tmp_path / "single" / name)), **NEAR)
