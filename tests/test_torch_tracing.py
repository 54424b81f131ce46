"""The port's spans and counters (artgraph_tpu_torch/profiling.py).

On the CPU:
  * with no profiler recording, `annotate` hands back one shared no-op and
    creates no record_function, and no counter moves;
  * under `profiling.trace`, `infer` writes one `ag.predict.infer` span of
    cat user_annotation with the model's aten ops inside it, and the bf16
    copies of its weight matrices are counted;
  * a Trainer epoch over a host DataLoader gives an `ag.trainer.eager_step`
    span a batch and an `ag.trainer.wait_batch` span a batch (and one more
    for the queue's end); over a ResidentLoader, an eager step a batch and
    no wait;
  * a thread the profiler does not record emits no span and counts
    nothing, and does not raise;
  * `cast_weight` counts the bytes of a copy and nothing for a tensor
    already in the dtype.

Marked `cuda` (skip without a card): a graphed epoch's replay and capture
spans, and one traced ViT-B/16 fusion `infer` counting the bytes of its
weight matrices' bf16 copies. The module imports no jax, so on a GPU host:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""
import functools
import json
import threading

import numpy as np
import pytest
import torch

from artgraph_tpu_torch import profiling
from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.cli.predict import infer
from artgraph_tpu_torch.data.loader import DataLoader
from artgraph_tpu_torch.data.resident import ResidentLoader
from artgraph_tpu_torch.models import ViT, heads
from artgraph_tpu_torch.ops.attention import cast_weight
from artgraph_tpu_torch.train import Trainer, adam

TINY_VIT = dict(img_size=32, patch_size=16, embed_dim=128, depth=1,
                num_heads=2)
CAST = "weight_cast_bytes"


def _spans(logdir, name):
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("name") == name
            and e.get("cat") == "user_annotation"], events


def _cast_bytes():
    return profiling.counters().get(CAST, 0)


def test_off_annotate_is_one_noop_and_counts_nothing(monkeypatch):
    assert not profiling.recording()

    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    before = profiling.counters()
    first = profiling.annotate("ag.a")
    assert profiling.annotate("ag.b") is first
    with first:
        with profiling.annotate("ag.c"):
            cast_weight(torch.ones(4, 4))
    profiling.count(CAST, 7)
    assert profiling.counters() == before


def test_infer_span_holds_the_model(tmp_path):
    torch.manual_seed(0)
    model = ViT(**TINY_VIT, dtype=torch.bfloat16).eval()
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    before = _cast_bytes()
    with profiling.trace(str(tmp_path)):
        infer(model, images, transform_type="vit")
    (span,), events = _spans(tmp_path, "ag.predict.infer")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::conv2d", "aten::layer_norm")]
    assert {e["name"] for e in ops} == {"aten::conv2d", "aten::layer_norm"}
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in ops)
    # the patch embedding's and the blocks' (their plain versions here)
    # weight matrices, each copied once to bf16
    assert _cast_bytes() - before == sum(
        2 * p.numel() for n, p in model.named_parameters()
        if n.startswith(("patch_embed.", "blocks.")) and p.dim() > 1)


def _tiny_trainer(monkeypatch, device="cpu"):
    monkeypatch.setattr(heads, "ViT", functools.partial(ViT, **TINY_VIT))
    torch.manual_seed(0)
    return Trainer(heads.ViTSingleTask(5, dropout=0.0), adam(1e-3),
                   single_task_loss(None, device), transform_type="vit",
                   device=device)


class _Rows:
    def __init__(self, n, seed=3):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 5, n).astype(np.int32)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


@pytest.mark.parametrize("kind", ["host", "resident"])
def test_trainer_spans_a_batch(kind, monkeypatch, tmp_path):
    trainer = _tiny_trainer(monkeypatch)
    rows = _Rows(10)
    loader = (DataLoader(rows, 4, num_workers=2) if kind == "host"
              else ResidentLoader(rows, 4, device="cpu"))
    batches = len(loader)
    with profiling.trace(str(tmp_path)):
        trainer.train_epoch(loader)
    steps, _ = _spans(tmp_path, "ag.trainer.eager_step")
    waits, _ = _spans(tmp_path, "ag.trainer.wait_batch")
    assert len(steps) == batches == 3
    # the host queue: a wait for each batch and one for its end
    assert len(waits) == (batches + 1 if kind == "host" else 0)
    for name in ("ag.trainer.replay", "ag.trainer.capture"):
        assert not _spans(tmp_path, name)[0]


def test_unrecorded_thread_emits_nothing(tmp_path):
    seen, errors = [], []

    def elsewhere():
        try:
            with profiling.annotate("ag.elsewhere"):
                torch.ones(4).sum()
            profiling.count("ag.elsewhere", 1)
            seen.append(profiling.recording())
        except Exception as e:       # raised again in the test's thread
            errors.append(e)

    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ag.here"):
            thread = threading.Thread(target=elsewhere)
            thread.start()
            thread.join(timeout=30)
    assert not thread.is_alive() and not errors and seen == [False]
    assert len(_spans(tmp_path, "ag.here")[0]) == 1
    assert not _spans(tmp_path, "ag.elsewhere")[0]
    assert "ag.elsewhere" not in profiling.counters()


@pytest.mark.parametrize("src, dst, copied", [
    (torch.float32, torch.bfloat16, True),
    (torch.bfloat16, torch.bfloat16, False),
    (torch.float32, torch.float32, False),
])
def test_cast_weight_counts_a_copys_bytes(src, dst, copied):
    w = torch.ones(3, 5, dtype=src)
    before = _cast_bytes()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = cast_weight(w, dst)
    assert out.dtype == dst and (out is not w) == copied
    assert _cast_bytes() - before == (15 * 2 if copied else 0)


# --- on the card ------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have "
                    "no CPU mode")


@pytest.mark.cuda
def test_graphed_epoch_spans(monkeypatch, tmp_path):
    _need_cuda()
    trainer = _tiny_trainer(monkeypatch, "cuda")
    loader = DataLoader(_Rows(32), 8, num_workers=2)
    counts = []
    for epoch in range(2):
        logdir = tmp_path / str(epoch)
        with profiling.trace(str(logdir)):
            trainer.train_epoch(loader)
        counts.append([len(_spans(logdir, f"ag.trainer.{name}")[0])
                       for name in ("capture", "replay", "eager_step",
                                    "wait_batch")])
    # the first epoch captures its key on its first batch, then replays
    assert counts == [[1, 3, 0, 5], [0, 4, 0, 5]]


@pytest.mark.cuda
def test_vit_fusion_infer_counts_its_weights():
    _need_cuda()
    from artgraph_tpu_torch.models import NewMultiModalMultiTaskViT
    with torch.device("cuda"):
        model = NewMultiModalMultiTaskViT(
            emb_size=128, num_classes={"style": 32, "genre": 18},
            dropout=0.4).eval()
    weights = [p for n, p in model.vit.named_parameters()
               if n.startswith(("patch_embed.", "blocks.")) and p.dim() > 1]
    expected = sum(2 * p.numel() for p in weights)
    assert len(weights) == 1 + 12 * 4 and expected == 171_048_960
    images = torch.randint(0, 256, (32, 224, 224, 3), dtype=torch.uint8,
                           device="cuda")
    embs = [torch.randn(32, 128, device="cuda") for _ in range(2)]
    infer(model, images, *embs)                  # builds the kernels
    before = _cast_bytes()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        infer(model, images, *embs)
        torch.cuda.synchronize()
    assert _cast_bytes() - before == expected
