"""Driver entry points of the PyTorch/CUDA port (artgraph_tpu_torch), the
counterpart of __graft_entry__.py.

entry(device)               — the flagship fusion model's forward
                              (NewMultiModalMultiTask at full ResNet50 width)
                              from uint8 images, on one device.
dryrun_multichip(n, device) — n ranks in one spawn (NCCL, one card a rank;
                              gloo on the CPU with device="cpu"): a full
                              training step (forward, backward, Adam, the BN
                              updates) over a `data` x `model` mesh with the
                              batch split over `data` and the classifier
                              heads over `model`, then the five dry runs of
                              the JAX file over a `data` mesh: the Trainer's
                              ViT step, the fused-block ViT step and the
                              conv + BN unit's bottleneck step each against
                              one device, the sharded resident epoch and the
                              edge-sharded CSR GNN step.

Both default to the card and raise without one. On the CPU the block ops,
the conv + BN unit, the normalize and the CSR ops run their plain twins; on
the card their CUDA kernels, which take bf16 activations: the tiny models
of the dry runs are bf16 there and f32 on the CPU, as the JAX dry runs
are, and their widths are ones the kernels take (head dim 64; the unit's
channels multiples of 32).

    python -c "import __graft_entry_torch__ as e; e.dryrun_multichip(4, device='cpu')"
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

EMB = 128
NUM_CLASSES = {"style": 32, "genre": 18}
REL = dict(rtol=1e-5, atol=1e-6)        # __graft_entry__.py's own bounds


def _need_cuda(device: torch.device, what: str) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device {device} requested but CUDA is "
                           f"not available (device='cpu' runs the plain "
                           f"twins)")


def entry(device: str | torch.device = "cuda"):
    """(forward, args): forward(model, images_u8, emb_style, emb_genre)
    normalizes the uint8 images (the normalize kernel on the card) and
    applies NewMultiModalMultiTask(128, {style: 32, genre: 18}, dropout 0.4)
    in eval mode; args are the model (seeded by torch.manual_seed(0), in
    its bf16 default), a seeded batch of 8 uint8 [224, 224, 3] images and
    zero [8, 128] embeddings, all on `device`."""
    from artgraph_tpu_torch.models import NewMultiModalMultiTask
    from artgraph_tpu_torch.ops import normalize_images

    device = torch.device(device)
    _need_cuda(device, "entry")
    torch.manual_seed(0)
    model = NewMultiModalMultiTask(emb_size=EMB, num_classes=NUM_CLASSES,
                                   dropout=0.4).to(device).eval()
    batch = 8
    images_u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, 224, 224, 3), dtype=np.uint8)).to(device)
    emb = torch.zeros((batch, EMB), device=device)

    @torch.no_grad()
    def forward(model, images_u8, emb_style, emb_genre):
        images = normalize_images(images_u8, "resnet")
        return model(images, emb_style, emb_genre)

    return forward, (model, images_u8, emb, emb)


def head_param_rules(name: str, tensor: torch.Tensor):
    """__graft_entry__.py's param_rules in torch's layout: the classifier
    heads' Linears split on their output dimension over `model` (the flax
    kernel's P(None, "model") is the [out, in] weight's ("model", None),
    the bias's P("model") is ("model",)); everything else replicated."""
    if name.startswith(("class_style.", "class_genre.")):
        if name.endswith(".weight") and tensor.dim() == 2:
            return ("model", None)
        if name.endswith(".bias"):
            return ("model",)
    return None


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"
                     ) -> dict:
    """The six dry runs in n_devices ranks of one spawn, each printing its
    OK line (rank 0); raises if a rank fails or a check does not hold.
    Returns rank 0's kernel launches over the six runs, keyed by counter
    name (ops/launches.py)."""
    from artgraph_tpu_torch.parallel.mesh import spawn

    device = torch.device(device)
    if device.type == "cuda":
        _need_cuda(device, "dryrun_multichip")
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): {have} CUDA device(s) "
                f"visible; each rank takes a card of its own "
                f"(device='cpu' runs the ranks on gloo)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    return spawn(_dryrun_rank, n_devices, backend, device=device,
                 timeout=900.0, args=(n_devices,))


def _dryrun_rank(mesh, n_devices: int) -> dict:
    from artgraph_tpu_torch.ops import launches

    before = launches.snapshot()
    device = mesh.device
    _tp_step(n_devices, device)
    for run in (_vit_dp_step, _fused_block_step, _conv_bn_step,
                _sharded_resident_epoch, _edge_sharded_gnn_step):
        run(n_devices, device)
    return launches.since(before)


def _say(line: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(line, flush=True)


def _dtype(device: torch.device) -> torch.dtype:
    """The tiny models' dtype: the kernels' bf16 on the card, f32 on the
    CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _seeded(make):
    torch.manual_seed(0)
    return make()


def _tp_step(n: int, device: torch.device) -> None:
    """__graft_entry__.py:44-183: the flagship model's step with the batch
    over `data` and the heads over `model` (2 when n is even and at least
    4), batch 2n of 64 px in f32, Adam(3e-4), 0.5 CE(style) + 0.5
    CE(genre), through the Trainer."""
    from artgraph_tpu_torch.cli._common import multi_task_loss
    from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
        image_and_embeddings
    from artgraph_tpu_torch.models import NewMultiModalMultiTask
    from artgraph_tpu_torch.parallel.mesh import (batch_sharding, create_mesh,
                                                  shard_params)
    from artgraph_tpu_torch.train.trainer import Trainer, adam

    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = create_mesh(n // model_axis, model_axis, device=device)
    model = _seeded(lambda: NewMultiModalMultiTask(
        emb_size=EMB, num_classes=NUM_CLASSES, dropout=0.4,
        dtype=torch.float32))
    shard_params(model.to(device), mesh, head_param_rules)
    batch, size = 2 * n, 64
    images_u8 = np.random.default_rng(0).integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)
    emb = np.zeros((batch, EMB), np.float32)
    labels = np.random.default_rng(1).integers(
        0, 18, (batch, 2)).astype(np.int32)
    trainer = Trainer(model, adam(3e-4),
                      multi_task_loss(None, None, 0.5, 0.5, device),
                      transform_type="resnet", device=device, mesh=mesh,
                      forward_inputs=image_and_embeddings)
    local = batch_sharding(mesh, (images_u8, emb, emb, labels,
                                  np.ones(batch, np.float32)))
    loss, _ = trainer.train_step(trainer.to_device(local))
    loss = float(loss)
    if not np.isfinite(loss):
        raise FloatingPointError("non-finite loss in multichip dry-run")
    _say(f"dryrun_multichip OK: mesh=data:{mesh.size}xmodel:{model_axis} "
         f"loss={loss:.4f}")


def _image_batch(batch: int, px: int, classes: int):
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (batch, px, px, 3), dtype=np.uint8),
            rng.integers(0, classes, (batch,)).astype(np.int32),
            np.ones((batch,), np.float32))


def _vit_dp_step(n: int, device: torch.device) -> None:
    """__graft_entry__.py:186: one step of the Trainer's data-parallel path
    on ViTSingleTask (ViT-B/16, 64 px: the position embedding sized for
    its 17 tokens, as the JAX module sizes it from its init batch)."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.models import ViT, ViTSingleTask
    from artgraph_tpu_torch.parallel.mesh import batch_sharding, create_mesh
    from artgraph_tpu_torch.train.trainer import Trainer, adam

    mesh = create_mesh(n, device=device)
    dt = _dtype(device)

    def make():
        model = ViTSingleTask(num_class=5, dropout=0.4, dtype=dt)
        trunk = ViT(img_size=64, dtype=dt)
        trunk.head = model.vit.head
        model.vit = trunk
        return model

    trainer = Trainer(_seeded(make), adam(3e-4), single_task_loss(None,
                                                                  device),
                      transform_type="vit", device=device, mesh=mesh)
    batch = batch_sharding(mesh, _image_batch(2 * n, 64, 5))
    loss = float(trainer.train_step(trainer.to_device(batch))[0])
    if not np.isfinite(loss):
        raise FloatingPointError("non-finite loss in the ViT DP dry-run")
    _say(f"dryrun shard_map ViT DP step OK: data:{n} loss={loss:.4f}")


def _against_one_device(n: int, device: torch.device, make, px: int,
                        transform: str, what: str, counters: tuple):
    """One SGD-with-momentum(1e-2) step of make()'s model over a `data`
    mesh against the same step on one device from the same weights, on a
    batch of 2n: the losses and every parameter and buffer at REL. On the
    card the kernels behind `counters` (ops/launches.py names) must have
    launched in the mesh's step. Returns the mesh's loss."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.ops import launches
    from artgraph_tpu_torch.parallel.mesh import batch_sharding, create_mesh
    from artgraph_tpu_torch.train.trainer import Trainer, sgd_momentum

    mesh = create_mesh(n, device=device)
    src = _seeded(make)

    def trainer(m):
        return Trainer(copy.deepcopy(src), sgd_momentum(1e-2),
                       single_task_loss(None, device),
                       transform_type=transform, device=device, mesh=m)

    single, sharded = trainer(None), trainer(mesh)
    batch = _image_batch(2 * n, px, 5)
    loss_s = float(single.train_step(single.to_device(batch))[0])
    before = launches.snapshot()
    loss_m = float(sharded.train_step(
        sharded.to_device(batch_sharding(mesh, batch)))[0])
    ran = launches.since(before)
    missing = [c for c in counters if not ran.get(c)]
    if device.type == "cuda" and missing:
        raise AssertionError(f"{what}: no launch of {missing} in the "
                             f"sharded step")
    if not np.isfinite(loss_m):
        raise FloatingPointError(f"non-finite loss in the {what} dry-run")
    if abs(loss_m - loss_s) > REL["rtol"] * max(1.0, abs(loss_s)):
        raise AssertionError(f"{what}: sharded loss {loss_m} != one-device "
                             f"{loss_s}")
    want = single.model.state_dict()
    for k, v in sharded.model.state_dict().items():
        np.testing.assert_allclose(
            v.detach().double().cpu().numpy(),
            want[k].detach().double().cpu().numpy(),
            err_msg=f"{what}: {k}", **REL)
    return loss_m


class _TinyViT(torch.nn.Module):
    """The JAX dry run's _TinyViT (patch 8, depth 2, MLP ratio 2, a dense
    head) at a width the block kernels take: 128 wide, 2 heads of 64."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        from artgraph_tpu_torch.models import ViT

        self.vit = ViT(img_size=16, patch_size=8, embed_dim=128, depth=2,
                       num_heads=2, mlp_ratio=2.0, dtype=dtype)
        self.head = torch.nn.Linear(128, 5)

    def forward(self, x):
        return self.head(self.vit(x))


def _fused_block_step(n: int, device: torch.device) -> None:
    """__graft_entry__.py:225: the fused-block ViT step (both block ops,
    the kernels on the card) over the mesh against one device."""
    loss = _against_one_device(
        n, device, lambda: _TinyViT(_dtype(device)), 16, "vit",
        "the fused-block ViT step",
        ("fused_block_attention", "fused_block_mlp",
         "fused_block_attention_bwd", "fused_block_mlp_bwd"))
    _say(f"dryrun shard_map ViT DP step (fused kernels) OK: data:{n} "
         f"loss={loss:.4f} (matches single-device)")


class _TinyBottleneck(torch.nn.Module):
    """The JAX dry run's _TinyBottleneck (a 3x3 stem, one downsampling
    Bottleneck, a dense head on the spatial mean) at widths the unit takes:
    stem 64, bottleneck width 32."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        from artgraph_tpu_torch.models.resnet import Bottleneck

        self.dtype = dtype
        self.stem = torch.nn.Conv2d(3, 64, 3, padding=1, bias=False)
        self.block = Bottleneck(64, 32, 1, True, dtype)
        self.head = torch.nn.Linear(128, 5)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        x = torch.nn.functional.conv2d(x, self.stem.weight.to(self.dtype),
                                       padding=1)
        return self.head(self.block(x).float().mean((2, 3)))


def _conv_bn_step(n: int, device: torch.device) -> None:
    """__graft_entry__.py:298: the bottleneck step with the fused 1x1-conv
    + BN-statistics unit on (ARTGRAPH_CONVBN=1) over the mesh against one
    device, BN running statistics included."""
    old = os.environ.get("ARTGRAPH_CONVBN")
    os.environ["ARTGRAPH_CONVBN"] = "1"
    try:
        loss = _against_one_device(
            n, device, lambda: _TinyBottleneck(_dtype(device)), 8, "resnet",
            "the conv-bn bottleneck step",
            ("conv1x1_bn_stats", "conv1x1_bn_stats_bwd"))
    finally:
        if old is None:
            os.environ.pop("ARTGRAPH_CONVBN")
        else:
            os.environ["ARTGRAPH_CONVBN"] = old
    _say(f"dryrun shard_map conv-bn bottleneck step OK: data:{n} "
         f"loss={loss:.4f} (matches single-device incl. BN stats)")


class _TinyBN(torch.nn.Module):
    """The JAX dry run's _TinyBN: a 3x3 conv, MixedBatchNorm, ReLU, the
    spatial mean, a dense head."""

    def __init__(self):
        super().__init__()
        from artgraph_tpu_torch.models.resnet import MixedBatchNorm

        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn = MixedBatchNorm(8, apply_dtype=torch.float32)
        self.fc = torch.nn.Linear(8, 5)

    def forward(self, x):
        x = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return self.fc(torch.relu(x).mean((2, 3)))


class _Rows:
    def __init__(self, n: int):
        rng = np.random.default_rng(0)
        self.images = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
        self.labels = (np.arange(n) % 5).astype(np.int32)

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.labels[idx]


def _sharded_resident_epoch(n: int, device: torch.device) -> None:
    """__graft_entry__.py:374: one epoch of 3 batches from a sharded
    ResidentLoader (each rank holds its rows) through the Trainer's
    resident epoch."""
    from artgraph_tpu_torch.cli._common import single_task_loss
    from artgraph_tpu_torch.data.resident import ResidentLoader
    from artgraph_tpu_torch.parallel.mesh import create_mesh
    from artgraph_tpu_torch.train.trainer import Trainer, adam

    mesh = create_mesh(n, device=device)
    batch = 2 * n
    loader = ResidentLoader(_Rows(3 * batch), batch_size=batch, shuffle=True,
                            mesh=mesh, device=device)
    trainer = Trainer(_seeded(_TinyBN), adam(1e-2),
                      single_task_loss(None, device), device=device,
                      mesh=mesh)
    if not trainer._use_epoch_scan(loader):
        raise AssertionError("the resident epoch path was not selected")
    loss = trainer.train_epoch(loader)["loss"]
    if not np.isfinite(loss):
        raise FloatingPointError("non-finite loss in the resident epoch "
                                 "dry-run")
    _say(f"dryrun sharded epoch-scan OK: data:{n} 3-batch epoch "
         f"loss={loss:.4f}")


def _edge_sharded_gnn_step(n: int, device: torch.device) -> None:
    """__graft_entry__.py:431: one Adam step of the hetero-GAT on this
    rank's edge shard, the CSR ops (the kernels on the card) merged over
    the ranks."""
    from artgraph_tpu_torch.data.artgraph import HeteroGraph, OneHot
    from artgraph_tpu_torch.models import gnn
    from artgraph_tpu_torch.parallel.gnn_parallel import (
        device_put_graph_csr, init_variables, make_sharded_forward)
    from artgraph_tpu_torch.parallel.mesh import create_mesh, sync_grads
    from artgraph_tpu_torch.train import nll_loss

    mesh = create_mesh(n, device=device)
    rng = np.random.default_rng(0)
    feats = {"artwork": rng.normal(size=(60, 16)).astype(np.float32),
             "style": OneHot(5)}
    e = np.stack([rng.integers(0, 60, 200),
                  rng.integers(0, 5, 200)]).astype(np.int32)
    graph = HeteroGraph(
        node_features=feats, num_nodes={"artwork": 60, "style": 5},
        edges={("artwork", "style_rel", "style"): e,
               ("style", "rev_style_rel", "artwork"): e[::-1].copy()},
        labels={"y": rng.integers(0, 5, 60).astype(np.int32)})
    model = _seeded(lambda: gnn.HeteroSGNN(
        graph.metadata, gnn.feature_dims(graph.node_features),
        operator="GATConv", hidden_channels=16, out_channels=5, n_layers=2,
        dropout=0.0, bn=True, axis_name=mesh.axis_name)).to(device)
    init_variables(model, mesh)
    x, edges, csr = device_put_graph_csr(graph, mesh)
    forward = make_sharded_forward(model, mesh)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    y = torch.from_numpy(graph.labels["y"].astype(np.int64)).to(device)
    _, outs = forward(x, edges, train=True, csr=csr)
    loss = nll_loss(outs[0]["artwork"], y)
    loss.backward()
    sync_grads(model.parameters(), mesh)
    opt.step()
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise FloatingPointError("non-finite loss in the edge-sharded GNN "
                                 "dry-run")
    _say(f"dryrun edge-sharded CSR GNN step OK: data:{n} loss={loss:.4f}")
