"""KG node-embedding producer (pipeline stage 1) on the GPU: full-batch
transductive hetero-GNN training.

Port of artgraph_tpu/cli/train_gnn_embeddings.py (ref:
src/train_gnn_embeddings.py). It loads the 4 graph variants (train,
train_train, train_validation, train_test) from config.DATASET_DIR, applies
ToUndirected and, for GATConv, the pyg 2.0.2 self-loops, sorts every
relation by destination once (`with_csr`, metadata on the device), trains a
2-layer HeteroSGNN (hidden 128, sum aggregation, BN, dropout 0.4) with NLL on
the artwork nodes and Adam, prints the metrics every 5 epochs, then saves
the 128-dim artwork hidden states of an eval forward on the full train graph
under the reference's two file names in config.EMBEDDINGS_DIR:

    python -m artgraph_tpu_torch.cli.train_gnn_embeddings --label style

Same flags and defaults as the JAX CLI, plus `--device` (default `cuda`). On
`cuda` every GATConv runs the CSR softmax kernel forward and the segment-sum
and scalar-sum kernels in its backward. `--no_epoch_scan` is accepted and
changes nothing: the port dispatches one step per epoch either way, which is
what the JAX CLI's epoch chunks compute. `--resume <dir>` saves the model,
Adam's state, the dropout generator's state and the epoch to
`<dir>/state.pt` (with `meta.json` beside it) after every epoch with
`epoch % 5 == 0`, as epoch + 1, and at the end, as the JAX CLI does, and a
restart continues from the saved epoch with the same dropout masks.

`--data_parallel N` (N > 0) runs the edge-sharded GNN of JAX's mesh path
(parallel/gnn_parallel.py): the CLI starts N ranks of itself (NCCL on
`cuda:rank`, gloo under `--device cpu`), each holds every relation's shard
of the edges (JAX's contiguous split of the padded edge array) with its own
CSR metadata and the whole node features, model and optimizer; the
reductions over edges combine over the ranks, every rank draws the same
dropout masks from a generator seeded alike, and the gradients are averaged
after the backward (parallel/mesh.py). Rank 0 alone prints and writes the
embeddings and the resume state; every rank reads a resume state.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from artgraph_tpu_torch import config
from artgraph_tpu_torch.cli._common import (is_rank0, launch_ranks,
                                            load_resume_payload, make_mesh,
                                            needs_launch, resolve_device,
                                            save_resume_payload)
from artgraph_tpu_torch.data.artgraph import (ArtGraph, gat_self_loops,
                                              to_undirected, with_csr)
from artgraph_tpu_torch.data.embeddings import save_embedding
from artgraph_tpu_torch.models.gnn import (HeteroSGNN, feature_dims,
                                          graph_tensors)
from artgraph_tpu_torch.parallel.gnn_parallel import (device_put_graph_csr,
                                                      init_variables)
from artgraph_tpu_torch.parallel.mesh import sync_grads
from artgraph_tpu_torch.train import adam, nll_loss


def get_accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> float:
    return float((log_probs.argmax(1) == labels).float().mean())


def load_graphs(dataset_dir: str, operator: str, self_loops: bool,
                device: torch.device, mesh=None) -> dict:
    """The 4 graph variants, undirected, with GAT self-loops when asked, as
    (graph, x_dict, edge_dict, csr_dict, labels) on `device`; over a mesh
    the edges and CSR metadata of this rank's shard."""
    graphs = {}
    for name, split in (("train", "train"), ("train_train", "train"),
                        ("train_validation", "validation"),
                        ("train_test", "test")):
        g = to_undirected(ArtGraph(os.path.join(dataset_dir, name),
                                   preprocess='one-hot', features=True,
                                   type=split)[0])
        if operator == 'GATConv' and self_loops:
            g = gat_self_loops(g)
        if mesh is not None:
            x, edges, csr = device_put_graph_csr(g, mesh)
        else:
            g, csr = with_csr(g, device)
            x, edges = graph_tensors(g, device)
        labels = {k: torch.from_numpy(v.astype(np.int64)).to(device)
                  for k, v in g.labels.items()}
        graphs[name] = (g, x, edges, csr, labels)
    return graphs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--label', type=str, default='style',
                        help='Label to predict (style|genre).')
    parser.add_argument('--operator', type=str, default='GATConv',
                        help='GCN operator.')
    parser.add_argument('--lr', type=float, default=0.01, help='Learning rate.')
    parser.add_argument('--epochs', type=int, default=50, help='Epochs.')
    parser.add_argument('--activation', type=str, default='relu',
                        help='Activation (relu|prelu).')
    parser.add_argument('--data_parallel', type=int, default=0,
                        help='Devices for edge-sharded message passing '
                             '(0 = single device).')
    parser.add_argument('--no_self_loops', action='store_true',
                        help='Disable the PyG GATConv add_self_loops=True '
                             'semantics (reference default adds min(N_src, '
                             'N_dst) self-loops per relation).')
    parser.add_argument('--resume', type=str, default=None,
                        help='Checkpoint directory for crash recovery: full '
                             'train state saved every 5 epochs; training '
                             'continues from it when present.')
    parser.add_argument('--no_epoch_scan', action='store_true',
                        help='Accepted for the JAX CLI\'s surface; the port '
                             'runs one step per epoch either way.')
    parser.add_argument('--device', type=str, default='cuda',
                        help='Torch device to train on (cuda, cuda:N or cpu).')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if needs_launch(args):
        return launch_ranks(args, main, argv)
    mesh = make_mesh(args)
    if mesh is not None:
        device = mesh.device

    graphs = load_graphs(config.DATASET_DIR, args.operator,
                         not args.no_self_loops, device, mesh)
    label = args.label
    g_train = graphs["train_train"][0]
    torch.manual_seed(config.GLOBAL_SEED)   # as the reference, before init
    model = HeteroSGNN(metadata=g_train.metadata,
                       in_channels=feature_dims(g_train.node_features),
                       operator=args.operator, activation=args.activation,
                       aggr='sum', hidden_channels=128,
                       out_channels=config.NUM_CLASSES[label], n_layers=2,
                       dropout=0.4,
                       axis_name=None if mesh is None else mesh.axis_name
                       ).to(device)
    if mesh is not None:
        init_variables(model, mesh)
    optimizer = adam(args.lr)(model.parameters())
    # the same state on every rank: the replicated node tensors' masks
    generator = torch.Generator(device).manual_seed(config.GLOBAL_SEED)

    def save_resume(epoch: int) -> None:
        if not is_rank0():
            return
        save_resume_payload(args.resume, {
            "epoch": epoch, "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "generator": generator.get_state()}, {"epoch": epoch})

    start_epoch = 0
    payload = load_resume_payload(args.resume) if args.resume else None
    if payload is not None:
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        generator.set_state(payload["generator"])
        start_epoch = int(payload["epoch"])
        print(f"resumed from {args.resume}: epoch {start_epoch}")

    def forward(name: str, train: bool):
        _, x, edges, csr, labels = graphs[name]
        model.train(train)
        emb, outs = model(x, edges, csr=csr, generator=generator)
        logp = outs[0]["artwork"]
        return nll_loss(logp, labels[f"y_{label}"]), logp, emb["artwork"]

    @torch.no_grad()
    def evaluate(name: str):
        loss, logp, emb = forward(name, train=False)
        return float(loss), get_accuracy(
            logp, graphs[name][4][f"y_{label}"]), emb

    def print_metrics(train_loss, train_acc, val_loss, val_acc):
        print(f'{label}_train_loss', round(train_loss, 4))
        print(f'{label}_train_accuracy', round(train_acc, 2) * 100)
        print(f'{label}_val_loss', round(val_loss, 4))
        print(f'{label}_val_accuracy', round(val_acc, 2) * 100)

    train_loss = train_acc = 0.0
    for epoch in range(start_epoch, args.epochs):
        loss, logp, _ = forward("train_train", train=True)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            sync_grads(model.parameters(), mesh)
        optimizer.step()
        train_loss = loss.item()
        train_acc = get_accuracy(logp.detach(),
                                 graphs["train_train"][4][f"y_{label}"])
        if epoch % 5 == 0:
            val_loss, val_acc, _ = evaluate("train_validation")
            print_metrics(train_loss, train_acc, val_loss, val_acc)
            if args.resume:
                save_resume(epoch + 1)
    if args.resume:
        save_resume(args.epochs)

    val_loss, val_acc, _ = evaluate("train_validation")
    test_loss, test_acc, _ = evaluate("train_test")
    print_metrics(train_loss, train_acc, val_loss, val_acc)
    print(f'{label}_test_loss', round(test_loss, 4))
    print(f'{label}_test_accuracy', round(test_acc, 2) * 100)

    # save_embeddings (ref :82-93): eval forward on the FULL train graph; the
    # artwork embedding is the post-BN pre-activation hidden state
    print('Saving embeddings...')
    _, _, emb = evaluate("train")
    if is_rank0():
        os.makedirs(config.EMBEDDINGS_DIR, exist_ok=True)
        for stem in (f"test_gnn_artwork_{label}_embs",
                     f"test_gnn_{label}_embs"):
            save_embedding(os.path.join(config.EMBEDDINGS_DIR,
                                        f"{stem}.pt"), emb)
    print('Saved.')


if __name__ == '__main__':
    main()
