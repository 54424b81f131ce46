"""The port's four-stage pipeline (artgraph_tpu_torch.cli: train_gnn_embeddings
-> train_projector -> generate_projections -> train_new_multimodal_multitask,
and train_new_multimodal) against the JAX package, on the CPU.

  * a projector .pt the port writes loads strict in the JAX package's
    load_reference_checkpoint, and the JAX package's export of it loads
    strict back into the port with the same tensors, for LabelProjector
    (full ResNet50) and LabelProjectorVit (full ViT-B/16);
  * generate_projections of the two packages on the same projector .pt
    (f32, ResNet50 of stage sizes (1, 1, 1, 1)): the same row-aligned
    [N, 128] files within atol 1e-4 (order of accumulation only);
  * the four port CLIs end to end with --device cpu on the synthetic image
    tree and KG, on tiny trunks (the TINY ViT of test_torch_vit.py at patch
    16, ResNet50 of stage sizes (1, 1, 1, 1), ARTGRAPH_CONVBN=1): each
    stage's prints, the checkpoints reloaded strict, the projection files,
    results_style*.csv and results_genre*.csv; train_new_multimodal's early
    stopping fed the negative validation accuracy; a ViT projector in a
    directory of its own;
  * the parsers of these four CLIs and of train_baseline_multitask,
    train_baseline_context and train_baseline_context_multitask refuse the
    JAX CLIs' TPU extras that the port lacks (the mesh, warm start, resume,
    tracking) and, but for generate_projections, parse the decoded cache's
    and the resident data's flags (--image_cache, --resident_data,
    --no_epoch_scan); their default --device cuda raises without a card.
"""
import functools
import os
import re
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import artgraph_tpu.checkpointing.torch_interop as jax_interop
import artgraph_tpu.models.heads as jax_heads
from artgraph_tpu import config as jax_config
from artgraph_tpu.checkpointing import (
    load_reference_checkpoint as jax_load_checkpoint,
    save_reference_checkpoint as jax_save_checkpoint)
from artgraph_tpu.cli import generate_projections as jax_generate
from artgraph_tpu.models.resnet import ResNet50 as JaxResNet50
from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import (load_reference_checkpoint,
                                              save_reference_checkpoint)
from artgraph_tpu_torch.cli import (generate_projections,
                                    train_baseline_context,
                                    train_baseline_context_multitask,
                                    train_baseline_multitask,
                                    train_gnn_embeddings,
                                    train_new_multimodal,
                                    train_new_multimodal_multitask,
                                    train_projector)
from artgraph_tpu_torch.cli.predict import infer
from artgraph_tpu_torch.data.embeddings import load_embedding, save_embedding
from artgraph_tpu_torch.data.transforms import decode_resize_uint8
from artgraph_tpu_torch.models import ResNet50, ViT, heads, init_random_
from artgraph_tpu_torch.ops import conv_bn
from artgraph_tpu_torch.train import EarlyStopping
from test_torch_resnet import STAGES
from test_torch_vit import TINY

torch.set_num_threads(2)

EMB = config.EMB_SIZE
PROJECTORS = {"LabelProjector": heads.LabelProjector,
              "LabelProjectorVit": heads.LabelProjectorVit}


@pytest.mark.parametrize("name", sorted(PROJECTORS))
def test_projector_checkpoint_round_trip_with_jax(name, tmp_path):
    model = init_random_(PROJECTORS[name](EMB, dtype=torch.float32),
                         torch.Generator().manual_seed(3))
    ours = tmp_path / "ours.pt"
    save_reference_checkpoint(model, str(ours))
    variables = jax_load_checkpoint(name, str(ours))   # raises on a missing key
    back = tmp_path / "back.pt"
    jax_save_checkpoint(name, variables, str(back))
    loaded = load_reference_checkpoint(name, str(back), "cpu",
                                       dtype=torch.float32)
    sd = model.state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):     # the JAX export writes 0
            continue
        if k.startswith("vit.head."):             # timm's unused head: zeros
            assert not got[k].any(), k
            continue
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.fixture()
def image_tree(synthetic_dataset, tmp_path):
    """A private copy of the synthetic image tree (the stages write
    embedding files into it)."""
    root = tmp_path / "artgraph"
    shutil.copytree(synthetic_dataset["root"], root)
    return {"ds": str(root / "dataset"), "img": str(root / "images"),
            "counts": synthetic_dataset["counts"]}


def test_generate_projections_matches_jax(image_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(jax_heads, "ResNet50",
                        functools.partial(JaxResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(jax_interop, "RESNET_STAGES", STAGES)
    # both packages in f32 (their CLIs run the bf16 trunk)
    monkeypatch.setattr(jax_generate, "LabelProjector", functools.partial(
        jax_heads.LabelProjector, dtype=jnp.float32))
    monkeypatch.setattr(generate_projections, "load_reference_checkpoint",
                        functools.partial(load_reference_checkpoint,
                                          dtype=torch.float32))
    proj = tmp_path / "proj"
    proj.mkdir()
    model = init_random_(heads.LabelProjector(EMB, dtype=torch.float32),
                         torch.Generator().manual_seed(4))
    save_reference_checkpoint(model, str(proj / "p.pt"))
    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, "PROJECTIONS_DIR", str(proj))
        monkeypatch.setattr(cfg, "DATASET_DIR", image_tree["ds"])
        monkeypatch.setattr(cfg, "IMAGE_DIR", image_tree["img"])

    files = {}
    for label, run in (("ours", lambda: generate_projections.generate(
                            batch_size=3, num_workers=2, device="cpu")),
                       ("ref", lambda: jax_generate.generate(
                            batch_size=3, num_workers=2))):
        run()
        files[label] = {
            split: load_embedding(os.path.join(image_tree["ds"], split,
                                               "embeddings", "p.pt"))
            for split in ("validation", "test")}
    for split in ("validation", "test"):
        ours, ref = files["ours"][split], files["ref"][split]
        assert ours.shape == ref.shape == \
            (image_tree["counts"][split], EMB)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4,
                                   err_msg=split)
    # row-aligned: the rows are distinct projections of distinct images
    assert len(np.unique(files["ours"]["test"].round(4), axis=0)) == \
        image_tree["counts"]["test"]


@pytest.fixture()
def pipeline(image_tree, synthetic_graph, tmp_path, monkeypatch):
    """Tiny trunks, the unit's gate open, and config pointed at tmp dirs."""
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, **dict(TINY, patch_size=16)))
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    emb = os.path.join(image_tree["ds"], "train", "embeddings")
    dirs = {"emb": emb, "proj": str(tmp_path / "proj"),
            "ck": str(tmp_path / "ckpt"), "graph": synthetic_graph["root"]}
    os.makedirs(dirs["proj"])
    monkeypatch.setattr(config, "EMBEDDINGS_DIR", emb)
    monkeypatch.setattr(config, "PROJECTIONS_DIR", dirs["proj"])
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", dirs["ck"])
    monkeypatch.setattr(config, "DATASET_DIR", image_tree["ds"])
    monkeypatch.setattr(config, "IMAGE_DIR", image_tree["img"])
    return {**image_tree, **dirs}


def _out(capsys) -> str:
    return capsys.readouterr().out


def _data(env, *extra):
    return ["--dataset_path", env["ds"], "--image_path", env["img"],
            "--device", "cpu", "--num_workers", "2", *extra]


def test_four_stage_pipeline_cli_cpu(pipeline, tmp_path, monkeypatch,
                                     capsys):
    env = pipeline
    # stage 1: KG embeddings of the toy graph
    monkeypatch.setattr(config, "DATASET_DIR", env["graph"])
    train_gnn_embeddings.main(["--label", "style", "--epochs", "3",
                               "--device", "cpu"])
    monkeypatch.setattr(config, "DATASET_DIR", env["ds"])
    assert "Saved." in _out(capsys)
    emb = load_embedding(os.path.join(env["emb"],
                                      "test_gnn_artwork_style_embs.pt"))
    assert emb.shape == (12, EMB)
    # the image tree has 24 train rows: the table tiled to them, as
    # tests/test_pipeline_e2e.py does
    n_train = env["counts"]["train"]
    table = np.tile(emb, (2, 1))[:n_train]
    for name in ("gnn_style_embs_graph.pt", "gnn_genre_embs_graph.pt"):
        save_embedding(os.path.join(env["emb"], name), table)

    # stage 2: the ResNet projector on the seeded split, the unit's plain
    # twin on full batches only
    calls = []
    plain = conv_bn.conv1x1_bn_stats_plain
    monkeypatch.setattr(conv_bn, "conv1x1_bn_stats_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    batch = 4
    loss = train_projector.main(_data(
        env, "--exp", "e2e", "--node_embedding", "gnn_style_embs_graph.pt",
        "--emb_type", "artwork", "--epochs", "2", "--batch", str(batch)))
    out = _out(capsys)
    assert out.count("Train loss: ") == out.count("Validation loss: ") == 2
    assert f"Test loss: {loss}" in out and np.isfinite(loss)
    n_proj_train = n_train - int(np.ceil(0.2 * n_train))
    assert len(calls) == 2 * len(STAGES) * 2 * (n_proj_train // batch)
    ckpt = os.path.join(env["proj"], "e2e_checkpoint_projector.pt")
    projector = load_reference_checkpoint("LabelProjector", ckpt, "cpu",
                                          dtype=torch.float32)

    # stage 3: order-preserving projections of valid and test
    generate_projections.main(["--device", "cpu"])
    assert _out(capsys).count("Generating projections for") == 2
    for split in ("validation", "test"):
        p = load_embedding(os.path.join(env["ds"], split, "embeddings",
                                        "e2e_checkpoint_projector.pt"))
        assert p.shape == (env["counts"][split], EMB)
        assert np.isfinite(p).all()
    # row 0 of the test file is the projector's output on test image 0
    name0 = pd.read_csv(os.path.join(env["ds"], "test", "mapping",
                                     "artwork_entidx2name.csv"),
                        header=None).iloc[0, 1]
    img0 = decode_resize_uint8(os.path.join(env["img"], name0))
    with torch.no_grad():
        direct = infer(projector, torch.from_numpy(img0[None].copy()),
                       transform_type="resnet")[0].numpy()
    ref = load_embedding(os.path.join(env["ds"], "test", "embeddings",
                                      "e2e_checkpoint_projector.pt"))[0]
    rel = np.linalg.norm(ref - direct) / np.linalg.norm(direct)
    assert rel < 5e-2, rel     # the CLI's bf16 trunk against f32

    # stage 4: the best model, the fusion ViT
    results = tmp_path / "results"
    files = ["--emb_train_style", "gnn_style_embs_graph.pt",
             "--emb_train_genre", "gnn_genre_embs_graph.pt",
             "--emb_valid_style", "e2e_checkpoint_projector.pt",
             "--emb_valid_genre", "e2e_checkpoint_projector.pt",
             "--emb_test_style", "e2e_checkpoint_projector.pt",
             "--emb_test_genre", "e2e_checkpoint_projector.pt"]
    style_acc, genre_acc = train_new_multimodal_multitask.main(_data(
        env, "--emb_type", "artwork", "--epochs", "2", "--batch", "8",
        "--lr", "1e-3", "--results_dir", str(results), *files))
    out = _out(capsys)
    assert out.count("Train loss: ") == out.count("Validation loss: ") == 2
    assert "train style accuracy: " in out and "train genre accuracy " in out
    assert (f"Test style accuracy: {style_acc}; test genre accuracy: "
            f"{genre_acc}") in out
    model = load_reference_checkpoint(
        "NewMultiModalMultiTaskViT",
        os.path.join(env["ck"], "new-multimodal_multi-task_checkpoint.pt"),
        "cpu")
    assert model.class_style[1].out_features == config.NUM_CLASSES["style"]
    for task, acc in (("style", style_acc), ("genre", genre_acc)):
        table = pd.read_csv(results / f"results_{task}.csv", index_col=0)
        assert table.loc["accuracy", "0"] == acc
        for stem in ("precisions_recalls", "confusion_matrix", "true_preds"):
            assert (results / f"{stem}_{task}.csv").exists()
        preds = pd.read_csv(results / f"true_preds_{task}.csv")
        assert len(preds) == env["counts"]["test"]
        assert preds["prediction"].max() < config.NUM_CLASSES[task]

    # stage 4, single task: NewMultiModalSingleTask on the same files, its
    # early stopping fed the negative validation accuracy
    seen = []

    class Recording(EarlyStopping):
        def __call__(self, current_loss, model_state):
            seen.append(current_loss)
            super().__call__(current_loss, model_state)

    monkeypatch.setattr(train_new_multimodal, "EarlyStopping", Recording)
    acc = train_new_multimodal.main(_data(
        env, "--label", "genre", "--emb_type", "artwork", "--epochs", "2",
        "--batch", "8", "--emb_train", "gnn_genre_embs_graph.pt",
        "--emb_valid", "e2e_checkpoint_projector.pt",
        "--emb_test", "e2e_checkpoint_projector.pt"))
    out = _out(capsys)
    valid_acc = [float(v) for v in
                 re.findall(r"validation accuracy: ([0-9.eE+-]+)", out)]
    assert len(valid_acc) == 2 and seen == [-v for v in valid_acc]
    assert f"Test accuracy: {acc}" in out
    model = load_reference_checkpoint(
        "NewMultiModalSingleTask",
        os.path.join(env["ck"], "genre_new-multimodal_single-task_checkpoint.pt"),
        "cpu")
    assert model.classifier[1].in_features == 2048 + EMB


def test_vit_projector_in_its_own_directory(pipeline, tmp_path, monkeypatch,
                                            capsys):
    env = pipeline
    rng = np.random.default_rng(5)
    save_embedding(os.path.join(env["emb"], "style.pt"),
                   rng.normal(size=(4, EMB)).astype(np.float32))
    vit_dir = tmp_path / "proj_vit"
    monkeypatch.setattr(config, "PROJECTIONS_DIR", str(vit_dir))
    train_projector.main(_data(
        env, "--exp", "vit", "--architecture", "vit", "--node_embedding",
        "style.pt", "--emb_type", "style", "--epochs", "1", "--batch", "8"))
    assert "Test loss: " in _out(capsys)
    model = load_reference_checkpoint(
        "LabelProjectorVit", str(vit_dir / "vit_checkpoint_projector.pt"),
        "cpu")
    assert model.encoder.out_features == EMB
    assert os.listdir(env["proj"]) == []


CLIS = {
    "train_projector": train_projector.main,
    "generate_projections": generate_projections.main,
    "train_new_multimodal": train_new_multimodal.main,
    "train_new_multimodal_multitask": train_new_multimodal_multitask.main,
    "train_baseline_multitask": train_baseline_multitask.main,
    "train_baseline_context": train_baseline_context.main,
    "train_baseline_context_multitask": train_baseline_context_multitask.main,
}


# the JAX CLIs' flags that the image CLIs of the port now take
PORTED_EXTRAS = ("--resident_data", "--no_epoch_scan", "--image_cache",
                 "--init_checkpoint", "--tracking", "--resume",
                 "--data_parallel")


class _Parsed(Exception):
    """Raised in place of resolve_device: the arguments parsed."""


@pytest.mark.parametrize("extra", [
    ["--resident_data"], ["--data_parallel", "2"], ["--no_epoch_scan"],
    ["--image_cache", "c"], ["--init_checkpoint", "c.pt"],
    ["--resume", "r"], ["--tracking"]])
@pytest.mark.parametrize("cli", sorted(CLIS))
def test_clis_refuse_the_tpu_extras(cli, extra, monkeypatch):
    """Every TPU extra is ported: the flags parse (the CLI stops at
    resolve_device, right after parsing, before --data_parallel would start
    its ranks), except in generate_projections, which takes --device only,
    and --resume in train_projector, which has no resumable loop and says
    so."""
    def parsed(name):
        raise _Parsed(name)

    monkeypatch.setattr(sys.modules[CLIS[cli].__module__], "resolve_device",
                        parsed)
    ported = (extra[0] in PORTED_EXTRAS and cli != "generate_projections"
              and (cli, extra[0]) != ("train_projector", "--resume"))
    with pytest.raises(_Parsed if ported else SystemExit):
        CLIS[cli](["--device", "cpu", *extra])


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_clis_default_to_cuda_and_never_fall_back(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIS[cli]([])
