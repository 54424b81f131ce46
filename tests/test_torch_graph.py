"""The Trainer's graphed step (one CUDA graph a step) against its eager
step, on the card.

Marked `cuda`; without an NVIDIA GPU every test skips. The module imports
no jax, so it runs on a GPU host without the JAX package:

    python -m pytest --noconftest tests/test_torch_graph.py -q

At dropout 0 with cuDNN's deterministic algorithms, a graph replays the
eager step's kernels on the same inputs, so the checks are equality:
  * a small ViT (the block kernels) and a ResNet50 of stage sizes
    (1, 1, 1, 1) with ARTGRAPH_CONVBN=1 (the conv + BN unit), four full
    batches and a ragged one through train_epoch (the first batch the
    eager warm-up, the full ones replays, the ragged one a replay for the
    ViT and an eager masked step for the ResNet) against train_step on the
    same batches from the same weights: every epoch loss, parameter and BN
    buffer equal, and the launch counters equal;
  * the mixed sequence (full, full, ragged, full) in one epoch against the
    all-eager steps, equal;
  * eval_epoch with collect_outputs against the eager forward, equal;
  * a ResidentLoader on the card, epoch_arrays and device_iter, against the
    host loader with prefetch: equal epoch losses and weights.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.data.loader import DataLoader
from artgraph_tpu_torch.data.resident import ResidentLoader
from artgraph_tpu_torch.models import ResNet50, ViT, heads
from artgraph_tpu_torch.ops import launches
from artgraph_tpu_torch.train import Trainer, adam

SMALL_VIT = dict(img_size=64, patch_size=16, embed_dim=128, depth=2,
                 num_heads=2, mlp_ratio=4.0)
B, NUM_CLASS = 8, 5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _model(arch, monkeypatch):
    monkeypatch.setattr(heads, "ViT", functools.partial(ViT, **SMALL_VIT))
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        ResNet50, stage_sizes=(1, 1, 1, 1)))
    if arch == "resnet":
        monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
        return heads.ResnetSingleTask(NUM_CLASS, dropout=0.0)
    return heads.ViTSingleTask(NUM_CLASS, dropout=0.0)


def _batches(seed, ragged_at):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        mask = np.ones(B, np.float32)
        if i == ragged_at:
            mask[B // 2 + 1:] = 0.0
        out.append((rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
                    rng.integers(0, NUM_CLASS, B).astype(np.int32), mask))
    return out


def _pair(arch, monkeypatch):
    torch.manual_seed(0)
    src = _model(arch, monkeypatch)
    trainers = []
    for _ in range(2):
        model = _model(arch, monkeypatch)
        model.load_state_dict(src.state_dict())
        trainers.append(Trainer(model, adam(1e-3), single_task_loss(None,
                                                                    "cuda"),
                                transform_type=arch, device="cuda"))
    return trainers


def _eager_epoch(trainer, batches):
    """The synchronous reference: train_step on each batch, the same
    totals."""
    trainer.model.train()
    totals, examples = {}, 0.0
    for batch in batches:
        dev = trainer.to_device(batch)
        n = float(batch[-1].sum())
        loss, metrics = trainer.train_step(dev, ragged=n < B)
        trainer._accumulate(totals, loss, metrics, dev[-1])
        examples += n
    return trainer._read(totals, examples)


def _assert_same_state(a, b):
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["vit", "resnet"])
def test_graphed_steps_equal_eager(arch, monkeypatch):
    _need_cuda()
    graphed, eager = _pair(arch, monkeypatch)
    with _deterministic():
        for batch in _batches(1, ragged_at=4):
            before = launches.snapshot()
            got = graphed.train_epoch([batch])
            counts = launches.since(before)
            before = launches.snapshot()
            want = _eager_epoch(eager, [batch])
            assert got == want
            assert counts == launches.since(before)
    torch.cuda.synchronize()
    _assert_same_state(graphed, eager)
    assert len(graphed.graphs) == 1 and graphed.host_step == 5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["vit", "resnet"])
def test_mixed_eager_and_replayed_steps(arch, monkeypatch):
    """full, full, ragged, full in one epoch (for the ResNet an eager
    masked step between replays) against all-eager steps."""
    _need_cuda()
    graphed, eager = _pair(arch, monkeypatch)
    batches = _batches(2, ragged_at=2)[:4]
    with _deterministic():
        got = graphed.train_epoch(batches)
        want = _eager_epoch(eager, batches)
        assert got == want
        _assert_same_state(graphed, eager)
        # a second epoch replays the captured graph only
        assert graphed.train_epoch(batches) == _eager_epoch(eager, batches)
    _assert_same_state(graphed, eager)
    evals = graphed.eval_epoch(batches, collect_outputs=True)
    eager.model.eval()
    with torch.no_grad():
        for (out, rest), batch in zip(evals[1], batches):
            k = int(batch[-1].sum())
            ref = eager._outputs(eager.to_device(batch))
            assert np.array_equal(out, ref[:k].cpu().numpy())
            assert np.array_equal(rest[0], batch[1][:k])


@pytest.mark.cuda
@pytest.mark.parametrize("epoch_scan", [True, False])
def test_resident_epoch_on_the_card(epoch_scan, monkeypatch):
    _need_cuda()
    graphed, host = _pair("resnet", monkeypatch)
    rng = np.random.default_rng(3)
    n = 37
    images = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASS, n).astype(np.int32)

    class Rows:
        def __len__(self):
            return n

        def get_batch(self, idx):
            return images[idx], labels[idx]

    resident = ResidentLoader(Rows(), B, shuffle=True, seed=4,
                              epoch_scan=epoch_scan, device="cuda")
    loader = DataLoader(Rows(), B, shuffle=True, seed=4, num_workers=2)
    with _deterministic():
        for _ in range(2):
            assert graphed.train_epoch(resident) == host.train_epoch(loader)
        _assert_same_state(graphed, host)
        assert graphed.eval_epoch(resident) == host.eval_epoch(loader)
