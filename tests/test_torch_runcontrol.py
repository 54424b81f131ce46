"""The port's run control against the JAX package, on the CPU: the
trainers' --resume, --init_checkpoint and -t/--tracking, EarlyStopping's
legacy_counter_bug, and the small modules (tracking, cli/test.py, utils.py,
artifacts.py, profiling.py).

  * EarlyStopping with legacy_counter_bug False and True over the loss
    sequences of tests/test_early_stopping.py: best_loss, wait, stop and the
    saves equal to the JAX class's after every call;
  * --resume: cli.train_baseline --device cpu, a tiny ViT and a ResNet50 of
    stage sizes (1, 1, 1, 1) with ARTGRAPH_CONVBN=1, host and resident
    loaders, at the CLI's dropout (0.4): a 1-epoch run and its 3-epoch
    restart equal an uninterrupted 3-epoch run bit for bit (the final
    payload's parameters, BN buffers, Adam state, host step and early-stop
    state, the best checkpoint, the four results CSVs, the epochs' printed
    lines and the test accuracy); meta.json holds the JAX keys with the
    payload's values; the restart prints the JAX line `resumed from <dir>:
    epoch E`;
  * cli.train_gnn_embeddings --resume: 6 epochs, then a restart to 8,
    writes the embeddings of an uninterrupted 8-epoch run bit for bit;
  * --init_checkpoint: a full reference .pt (and one whose head has another
    class count), a raw torchvision ResNet50 (tests/_torch_oracles.py), a
    raw timm ViT and a foreign model's .pt sharing the trunk: the port's
    state dict after the overlay equals state_dict_from_flax of the JAX
    apply_init_checkpoint on the same file from the same fresh weights,
    and both print the same report (scope, imported and fresh counts and
    modules);
  * the tracking file store: the port and the JAX adapter under one mlruns
    root write the same layout, params and metric values and steps
    (timestamps and run ids aside); cli.test runs, and with -t writes it;
  * artifacts: pointers byte-identical, a push by one package pulls in the
    other;
  * utils.__all__ equal to JAX's; profiling.trace writes a Chrome trace
    (the port's spans and counters: tests/test_torch_tracing.py);
  * a --resume or --init_checkpoint run on --device cuda without a card
    raises.

Run alone: python -m pytest tests/test_torch_runcontrol.py -q
"""
import argparse
import contextlib
import functools
import io
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import artgraph_tpu.checkpointing.torch_interop as jax_interop
import artgraph_tpu.models.heads as jax_heads
from artgraph_tpu import artifacts as jax_artifacts
from artgraph_tpu import utils as jax_utils
from artgraph_tpu.cli._common import (
    apply_init_checkpoint as jax_apply_init_checkpoint)
from artgraph_tpu.models.vit import ViT as JaxViT
from artgraph_tpu.tracking import mlflow_adapter as jax_tracking
from artgraph_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from artgraph_tpu.train.losses import cross_entropy as jax_cross_entropy
from artgraph_tpu.train.trainer import Trainer as JaxTrainer
from artgraph_tpu_torch import artifacts, config, profiling, utils
from artgraph_tpu_torch.checkpointing import (save_reference_checkpoint,
                                              state_dict_from_flax)
from artgraph_tpu_torch.cli import test as cli_test
from artgraph_tpu_torch.cli import train_baseline, train_gnn_embeddings
from artgraph_tpu_torch.cli._common import (apply_init_checkpoint,
                                            single_task_loss)
from artgraph_tpu_torch.data.embeddings import load_embedding
from artgraph_tpu_torch.models import ResNet50, ViT, heads, init_random_
from artgraph_tpu_torch.tracking import mlflow_adapter as tracking
from artgraph_tpu_torch.train import EarlyStopping, Trainer, adam
from _torch_oracles import ResNet50Oracle
from test_torch_vit import TINY

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# EarlyStopping
# --------------------------------------------------------------------------

# (patience, losses) of tests/test_early_stopping.py, and one long sequence
SEQUENCES = [(2, [1.0, 0.5, 0.6]), (2, [1.0, 1.1, 1.2]),
             (3, [1.0, 1.1, 0.5]), (3, [1.0, 1.1, 0.5, 0.7, 0.8, 0.9, 0.4]),
             (5, [1.0, 0.9995])]


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("patience,losses", SEQUENCES)
def test_early_stopping_matches_jax(patience, losses, legacy):
    saves = {"ours": [], "jax": []}
    ours, ref = (cls(patience=patience, min_delta=0.001, checkpoint_path="x",
                     save_fn=lambda state, path, k=k: saves[k].append(state),
                     legacy_counter_bug=legacy)
                 for cls, k in ((EarlyStopping, "ours"),
                                (JaxEarlyStopping, "jax")))
    for i, loss in enumerate(losses):
        ours(loss, i)
        ref(loss, i)
        assert (ours.best_loss, ours.wait, ours.stop) == \
            (ref.best_loss, ref.wait, ref.stop)
    assert saves["ours"] == saves["jax"]


# --------------------------------------------------------------------------
# --resume
# --------------------------------------------------------------------------

@pytest.fixture()
def tiny_models(monkeypatch):
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, **dict(TINY, patch_size=16)))
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        ResNet50, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")


def _baseline(synthetic_dataset, root, monkeypatch, arch, epochs, resume,
              *extra):
    """train_baseline --device cpu, checkpoints and results under root;
    (test accuracy, printed output)."""
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(root / "ckpt"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc = train_baseline.main([
            "--dataset_path", synthetic_dataset["dataset_dir"],
            "--image_path", synthetic_dataset["image_dir"],
            "--architecture", arch, "--label", "style", "--batch", "10",
            "--num_workers", "2", "--epochs", str(epochs), "--device", "cpu",
            "--results_dir", str(root / "results"), "--resume", str(resume),
            *extra])
    return acc, out.getvalue()


def _epoch_lines(text: str) -> list:
    return [ln for ln in text.splitlines()
            if ln.startswith(("Train loss", "Validation loss", "EarlyStop",
                              "Validation loss decreased"))]


def _assert_trees_equal(a, b, path="payload"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("loader", ["host", "resident"])
@pytest.mark.parametrize("arch", ["vit", "resnet"])
def test_resume_equals_an_uninterrupted_run(synthetic_dataset, tiny_models,
                                            tmp_path, monkeypatch, arch,
                                            loader):
    assert synthetic_dataset["counts"]["train"] % 10   # a ragged last batch
    extra = ["--resident_data"] if loader == "resident" else []
    acc_a, out_a = _baseline(synthetic_dataset, tmp_path / "a", monkeypatch,
                             arch, 3, tmp_path / "resume_a", *extra)
    _, out_b1 = _baseline(synthetic_dataset, tmp_path / "b", monkeypatch,
                          arch, 1, tmp_path / "resume_b", *extra)
    acc_b, out_b2 = _baseline(synthetic_dataset, tmp_path / "b", monkeypatch,
                              arch, 3, tmp_path / "resume_b", *extra)

    # the JAX restart's line (tests/test_resume.py:37), and the step
    assert f"resumed from {tmp_path / 'resume_b'}: epoch 1, step 3" in out_b2
    assert "resumed from" not in out_a + out_b1
    assert _epoch_lines(out_b1) + _epoch_lines(out_b2) == _epoch_lines(out_a)
    assert out_a.count("Train loss") == 3
    assert acc_b == acc_a

    payload = {k: torch.load(tmp_path / d / "state.pt", weights_only=True)
               for k, d in (("a", "resume_a"), ("b", "resume_b"))}
    _assert_trees_equal(payload["b"], payload["a"])
    assert payload["a"]["epoch"] == 3 and payload["a"]["host_step"] == 9
    if arch == "resnet":   # the BN buffers are in the compared state
        assert any(k.endswith("running_var") for k in payload["a"]["model"])
    meta = json.loads((tmp_path / "resume_b" / "meta.json").read_text())
    assert meta == {"epoch": 3, **payload["a"]["early_stop"]}
    assert sorted(meta) == ["best_loss", "epoch", "stop", "wait"]

    name = f"style_{arch}_baseline_single-task_checkpoint.pt"
    _assert_trees_equal(
        torch.load(tmp_path / "b" / "ckpt" / name, weights_only=True),
        torch.load(tmp_path / "a" / "ckpt" / name, weights_only=True))
    csvs = sorted(os.listdir(tmp_path / "a" / "results"))
    assert len(csvs) == 4 and csvs == sorted(os.listdir(tmp_path / "b" /
                                                        "results"))
    for f in csvs:
        assert (tmp_path / "a" / "results" / f).read_bytes() == \
            (tmp_path / "b" / "results" / f).read_bytes(), f


def test_gnn_resume_equals_an_uninterrupted_run(synthetic_graph, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.setattr(config, "DATASET_DIR", synthetic_graph["root"])
    resume = tmp_path / "resume_gnn"
    embs = {}
    for tag, runs in (("resumed", (6, 8)), ("straight", (8,))):
        monkeypatch.setattr(config, "EMBEDDINGS_DIR", str(tmp_path / tag))
        for epochs in runs:
            train_gnn_embeddings.main(
                ["--device", "cpu", "--epochs", str(epochs)]
                + (["--resume", str(resume)] if tag == "resumed" else []))
        embs[tag] = load_embedding(
            str(tmp_path / tag / "test_gnn_artwork_style_embs.pt"))
    out = capsys.readouterr().out
    assert f"resumed from {resume}: epoch 6" in out
    assert out.count("resumed from") == 1
    assert np.array_equal(embs["resumed"], embs["straight"])
    payload = torch.load(resume / "state.pt", weights_only=True)
    assert payload["epoch"] == 8
    assert json.loads((resume / "meta.json").read_text()) == {"epoch": 8}


# --------------------------------------------------------------------------
# --init_checkpoint
# --------------------------------------------------------------------------

WARM_VIT = dict(TINY, patch_size=16)


def _jax_model(name: str, num_class: int):
    cls = getattr(jax_heads, name)
    if name == "ViTSingleTask":
        return cls(num_class=num_class, dropout=0.4)
    if name == "ContextNetSingleTask":
        return cls(emb_size=config.EMB_SIZE, num_class=num_class)
    return cls(num_class=num_class, dropout=0.4)


def _port_model(name: str, num_class: int):
    if name == "ContextNetSingleTask":
        return heads.ContextNetSingleTask(config.EMB_SIZE, num_class,
                                          dtype=torch.float32)
    return getattr(heads, name)(num_class, 0.4, dtype=torch.float32)


def _jax_fresh(name: str, num_class: int):
    """A JAX Trainer over model name and its fresh state."""
    def loss_fn(outputs, batch):
        out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
        return jax_cross_entropy(out, batch[-2], mask=batch[-1]), {}

    size = 224 if name.startswith("ViT") else 64
    trainer = JaxTrainer(_jax_model(name, num_class), optax.adam(1e-3),
                         lambda img, b: (img,), loss_fn,
                         transform_type="vit" if size == 224 else "resnet")
    batch = (np.zeros((1, size, size, 3), np.uint8), np.zeros(1, np.int32),
             np.ones(1, np.float32))
    return trainer, trainer.init(batch)


def _write_source(case: str, path, seed: int) -> None:
    """The warm-start file of each case, from seeded port weights."""
    gen = torch.Generator().manual_seed(seed)
    if case == "torchvision":
        torch.manual_seed(seed)
        torch.save(ResNet50Oracle().state_dict(), path)
        return
    if case == "timm":
        vit = init_random_(heads.ViTSingleTask(32, dtype=torch.float32), gen)
        sd = {k[len("vit."):]: v for k, v in vit.state_dict().items()
              if not k.startswith("vit.head.")}
        sd["head.weight"] = torch.zeros(1000, WARM_VIT["embed_dim"])
        sd["head.bias"] = torch.zeros(1000)
        torch.save(sd, path)
        return
    name = "ViTSingleTask" if case == "full_vit" else "ResnetSingleTask"
    model = _port_model(name, 32)
    model = init_random_(model, gen) if name == "ViTSingleTask" else model
    save_reference_checkpoint(model, path)


# case -> (source, destination model, its class count)
WARM_CASES = {
    "full_vit": ("full_vit", "ViTSingleTask", 32),
    "full_resnet_other_head": ("full_resnet", "ResnetSingleTask", 18),
    "torchvision": ("torchvision", "ResnetSingleTask", 32),
    "timm": ("timm", "ViTSingleTask", 32),
    "foreign_model": ("full_resnet", "ContextNetSingleTask", 18),
}


@pytest.mark.parametrize("case", sorted(WARM_CASES))
def test_init_checkpoint_matches_jax(case, tmp_path, monkeypatch, capsys):
    source, name, num_class = WARM_CASES[case]
    monkeypatch.setattr(heads, "ViT", functools.partial(ViT, **WARM_VIT))
    monkeypatch.setattr(jax_heads, "ViT", functools.partial(JaxViT,
                                                            **WARM_VIT))
    monkeypatch.setattr(jax_interop, "VIT_DEPTH", WARM_VIT["depth"])
    path = str(tmp_path / "warm.pt")
    _write_source(source, path, seed=3)

    jax_trainer, fresh = _jax_fresh(name, num_class)
    fresh_vars = jax.device_get(jax_trainer.variables(fresh))
    capsys.readouterr()
    warm = jax_apply_init_checkpoint(jax_trainer, fresh, name, path)
    jax_line = capsys.readouterr().out.strip()
    want = state_dict_from_flax(
        name, jax.device_get(jax_trainer.variables(warm)))

    model = _port_model(name, num_class)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           state_dict_from_flax(name, fresh_vars).items()})
    trainer = Trainer(model, adam(1e-3), single_task_loss(None),
                      device="cpu")
    imported, fresh_keys = apply_init_checkpoint(trainer, name, path)
    assert capsys.readouterr().out.strip() == jax_line
    assert jax_line.startswith(f"init_checkpoint {path}: ")
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert imported and all(k in got for k in imported)
    if case == "full_vit":
        assert fresh_keys == []
    else:                        # the heads, and only they, stay fresh
        assert fresh_keys and not [k for k in fresh_keys
                                   if k.startswith(("vit.", "resnet."))
                                   and not k.startswith("vit.head.")]


# --------------------------------------------------------------------------
# tracking, cli/test.py
# --------------------------------------------------------------------------

def _read_run(root):
    """{relative path: content} of the one run under root/<exp>, with the
    metric lines' timestamps and meta.yaml's run id and time dropped."""
    (exp,) = os.listdir(root)
    (run_id,) = os.listdir(os.path.join(root, exp))
    run = os.path.join(root, exp, run_id)
    out = {}
    for sub in ("params", "metrics"):
        for f in sorted(os.listdir(os.path.join(run, sub))):
            text = open(os.path.join(run, sub, f)).read()
            if sub == "metrics":
                text = [ln.split(" ", 1)[1] for ln in text.splitlines()]
            out[f"{sub}/{f}"] = text
    meta = open(os.path.join(run, "meta.yaml")).read().splitlines()
    out["meta.yaml"] = [ln.split(":")[0] + ("" if ln.startswith(
        ("run_id", "start_time")) else ln.split(":", 1)[1]) for ln in meta]
    return exp, out


def test_file_store_matches_jax(tmp_path, monkeypatch):
    assert tracking._mlflow is None and jax_tracking._mlflow is None
    args = argparse.Namespace(exp="runcontrol", epochs=3, lr=3e-4,
                              tracking=True, resume=None)
    runs = {}
    # values exact in f32, so the port's tensors and JAX's floats agree
    for label, mod, as_value in (
            ("ours", tracking, torch.tensor),   # 0-d tensors, read by .item()
            ("jax", jax_tracking, float)):
        root = str(tmp_path / label)
        monkeypatch.setattr(mod, "_store", mod._FileStore(root))
        mod.track_params(args)

        @mod.tracker(True, "train")
        def train(epoch):
            return as_value(1.5 / (epoch + 1)), as_value(0.25 * epoch), epoch

        @mod.tracker_multitask(True, "valid")
        def valid(epoch):
            return 2.0 / (epoch + 1), as_value(0.125 * epoch), 0.5, epoch

        for epoch in range(3):
            train(epoch)
            valid(epoch)
        mod.log_metric("test acc", as_value(0.75))
        runs[label] = _read_run(root)
    assert runs["ours"] == runs["jax"]
    exp, files = runs["ours"]
    assert exp == "runcontrol"
    assert files["metrics/train loss"] == [f"{1.5 / (e + 1)} {e}"
                                           for e in range(3)]
    assert files["params/lr"] == "0.0003"


def test_cli_test_runs_and_tracks(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tracking, "_store",
                        tracking._FileStore(str(tmp_path / "mlruns")))
    cli_test.main([])
    assert not (tmp_path / "mlruns").exists()
    cli_test.main(["-t", "--exp", "smoke"])
    assert capsys.readouterr().out.count("epoch 4: loss=") == 2
    exp, files = _read_run(str(tmp_path / "mlruns"))
    assert exp == "smoke"
    assert sorted(files) == ["meta.yaml", "metrics/train acc",
                             "metrics/train loss", "params/exp",
                             "params/tracking"]
    assert [ln.split()[1] for ln in files["metrics/train loss"]] == \
        ["0", "1", "2", "3", "4"]


def test_train_baseline_tracks_the_printed_values(synthetic_dataset,
                                                  tiny_models, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(tracking, "_store",
                        tracking._FileStore(str(tmp_path / "mlruns")))
    acc, out = _baseline(synthetic_dataset, tmp_path, monkeypatch, "vit", 2,
                         tmp_path / "resume", "-t", "--exp", "tracked")
    exp, files = _read_run(str(tmp_path / "mlruns"))
    assert exp == "tracked"
    printed = {"train": [], "valid": []}
    for ln in out.splitlines():
        if ln.startswith("Train loss: "):
            printed["train"].append(ln[len("Train loss: "):].split("; "))
        elif ln.startswith("Validation loss: "):
            printed["valid"].append(ln[len("Validation loss: "):].split("; "))
    for split, rows in printed.items():
        assert files[f"metrics/{split} loss"] == [
            f"{float(r[0])} {e}" for e, r in enumerate(rows)]
        assert files[f"metrics/{split} acc"] == [
            f"{float(r[1].split(': ')[1])} {e}" for e, r in enumerate(rows)]
    assert files["metrics/test acc"] == [f"{acc} 0"]
    assert files["params/device"] == "cpu"


# --------------------------------------------------------------------------
# artifacts, profiling, utils
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pusher", ["ours", "jax"])
def test_artifacts_read_across_packages(pusher, tmp_path):
    mods = {"ours": artifacts, "jax": jax_artifacts}
    pulls = mods["jax" if pusher == "ours" else "ours"]
    data = {}
    for label in mods:
        (tmp_path / label).mkdir()
        data[label] = tmp_path / label / "model.pt"
        data[label].write_bytes(b"weights" * 1000)
        mods[label].track(str(data[label]))
    assert (tmp_path / "ours" / "model.pt.artifact").read_bytes() == \
        (tmp_path / "jax" / "model.pt.artifact").read_bytes()
    assert artifacts.pointer_path("x") == jax_artifacts.pointer_path("x")

    remote = str(tmp_path / "remote")
    blob = mods[pusher].push(str(data[pusher]), remote)
    other = data["jax" if pusher == "ours" else "ours"]
    other.unlink()
    pulls.pull(str(other), remote)
    assert other.read_bytes() == b"weights" * 1000
    assert os.path.exists(blob)
    for mod in mods.values():
        assert mod.status(str(other), remote) == {
            "tracked": True, "local": True, "in_remote": True,
            "dirty": False}
    other.write_bytes(b"changed")
    assert artifacts.status(str(other)) == jax_artifacts.status(str(other))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("runcontrol_region"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "runcontrol_region" in names


def test_utils_surface_matches_jax():
    assert utils.__all__ == jax_utils.__all__
    for name in utils.__all__:
        assert callable(getattr(utils, name)), name
    assert utils.tracker is tracking.tracker


# --------------------------------------------------------------------------
# no fallback from cuda
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--resume", "--init_checkpoint"])
def test_run_control_on_cuda_without_a_card_raises(flag, synthetic_dataset,
                                                   tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_baseline.main([
            "--dataset_path", synthetic_dataset["dataset_dir"],
            "--image_path", synthetic_dataset["image_dir"],
            "--device", "cuda", flag, str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
