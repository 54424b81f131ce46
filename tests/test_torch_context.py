"""The port's context trainers' pieces (artgraph_tpu_torch: the multitask
image-only and ContextNet / MultiModal datasets and factories, mse, the four
context models and their checkpoint keys, the Trainer with an eval loss of
its own, and the three CLIs train_baseline_multitask,
train_baseline_context and train_baseline_context_multitask) against the
JAX package, on the CPU.

  * ArtGraphMultiTask, MultiModalArtgraphMultiTask and both modes of
    load_dataset and load_dataset_multimodal on the synthetic tree: every
    split's type, get_batch and items bit-exact;
  * mse, masked and unmasked, at rtol 1e-6;
  * ContextNetSingleTask, ContextNetlMultiTask, MultiModalSingleTask and
    MultiModalMultiTask on the tiny ResNet50 trunk (stage sizes (1, 1, 1, 1)
    at full widths), weights carried over by state_dict_from_flax: the f32
    eval forward (logits and graph_proj) at rtol = atol = 1e-5; the key set
    and values equal to the JAX package's export_model_state (MultiModal
    with torchvision's named `resnet.conv1.*` keys, ContextNet with the
    indexed `resnet.0.*` ones); JAX -> port -> JAX through
    import_model_state; a .pt reloaded strict by load_reference_checkpoint;
  * three SGD-with-momentum steps (sgd_momentum, the ContextNet recipe's
    optimizer) of ContextNetlMultiTask (SmoothL1, lamb 0.9) and of
    MultiModalSingleTask (MSE, lamb 0.6, head dropout 0 on both sides)
    through the port's Trainer against the JAX Trainer with the JAX CLIs'
    train and eval losses, the second batch ragged, both models in f64
    (jax.enable_x64): loss and correct counts each step at rtol 1e-5; after
    step 3 every parameter and running statistic at rtol = atol = 1e-5 and
    every parameter's update at relative L2 1e-4 (the fusion ViT's step
    test in tests/test_torch_multimodal.py); then one image-only ragged
    eval batch: the eval loss, the correct counts and the collected
    outputs, trimmed and nested, at rtol = atol = 1e-5. In f64 because a BatchNorm ResNet's f32 step is
    ill-conditioned (tests/test_torch_resnet.py): in f32 the two packages'
    trunk updates drift apart by ~7e-3 a step, 6-7% after three, while in
    f64 they agree within 5e-7 (the JAX losses round to f32 inside);
  * the three CLIs end to end with --device cpu on the synthetic tree and
    an embedding table written beside it, tiny trunks, ARTGRAPH_CONVBN=1
    (the unit's plain twin on full train batches only): prints,
    checkpoints reloaded strict, results CSVs.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import artgraph_tpu.checkpointing.torch_interop as jax_interop
import artgraph_tpu.models.heads as jax_heads
from artgraph_tpu.cli._common import multi_task_loss as jax_multi_task_loss
from artgraph_tpu.data.factories import (
    load_dataset as jax_load_dataset,
    load_dataset_multimodal as jax_load_dataset_multimodal)
from artgraph_tpu.models.resnet import ResNet50 as JaxResNet50
from artgraph_tpu.train.losses import (cross_entropy as jax_cross_entropy,
                                       mse as jax_mse,
                                       smooth_l1 as jax_smooth_l1)
from artgraph_tpu.train.trainer import (Trainer as JaxTrainer,
                                        accuracy_metrics as jax_accuracy,
                                        sgd_momentum as jax_sgd_momentum)
from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import torch_interop
from artgraph_tpu_torch.checkpointing import (load_reference_checkpoint,
                                              save_reference_checkpoint,
                                              state_dict_from_flax)
from artgraph_tpu_torch.cli import (train_baseline_context,
                                    train_baseline_context_multitask,
                                    train_baseline_multitask)
from artgraph_tpu_torch.cli._common import (joint_loss, logits_loss,
                                            multi_task_loss,
                                            single_task_loss)
from artgraph_tpu_torch.data import datasets
from artgraph_tpu_torch.data.embeddings import save_embedding
from artgraph_tpu_torch.data.factories import (load_dataset,
                                               load_dataset_multimodal)
from artgraph_tpu_torch.models import ResNet50, ViT, heads
from artgraph_tpu_torch.ops import conv_bn
from artgraph_tpu_torch.train import Trainer, mse, sgd_momentum, smooth_l1
from test_torch_resnet import STAGES, seeded_variables
from test_torch_vit import TINY

torch.set_num_threads(2)

EMB = config.EMB_SIZE
NC = config.NUM_CLASSES


@pytest.fixture()
def image_tree(synthetic_dataset, tmp_path):
    """A private copy of the synthetic image tree with a train embedding
    table `emb.pt` of a row per train image (which also covers the
    by-label modes' label ids)."""
    root = tmp_path / "artgraph"
    shutil.copytree(synthetic_dataset["root"], root)
    ds = root / "dataset"
    n_train = synthetic_dataset["counts"]["train"]
    rng = np.random.default_rng(0)
    save_embedding(str(ds / "train" / "embeddings" / "emb.pt"),
                   rng.normal(size=(n_train, EMB)).astype(np.float32))
    return {"ds": str(ds), "img": str(root / "images"),
            "counts": synthetic_dataset["counts"]}


def _assert_same(ours, ref):
    """Two dataset items or batches: the same arrays, dtypes and lists."""
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        if isinstance(r, list):
            assert o == r
            continue
        o, r = np.asarray(o), np.asarray(r)
        assert o.dtype == r.dtype and o.shape == r.shape
        assert np.array_equal(o, r)


def _assert_same_splits(ours, ref):
    assert [type(d).__name__ for d in ours] == \
        [type(d).__name__ for d in ref]
    for o, r in zip(ours, ref):
        assert len(o) == len(r) and o.transform_type == r.transform_type
        idx = np.array([5, 0, 3, 7])
        _assert_same(o.get_batch(idx), r.get_batch(idx))
        for i in idx[:2]:
            _assert_same(o[int(i)], r[int(i)])


@pytest.mark.parametrize("transform", ["resnet", "vit"])
def test_multitask_image_datasets_match_jax(image_tree, transform):
    args = (image_tree["ds"], image_tree["img"], "multi_task")
    ours = load_dataset(*args, transform_type=transform)
    ref = jax_load_dataset(*args, transform_type=transform)
    assert [type(d) for d in ours] == [datasets.ArtGraphMultiTask] * 3
    _assert_same_splits(ours, ref)
    labels = ours[0].get_batch([0, 1])[1]
    assert labels.dtype == np.int32 and labels.shape == (2, 2)


@pytest.mark.parametrize("mode,label,emb_type", [
    ("single_task", "style", "artwork"), ("single_task", "genre", "genre"),
    ("single_task", "style", "style"), ("multi_task", None, "artwork")])
def test_context_datasets_match_jax(image_tree, mode, label, emb_type):
    args = (image_tree["ds"], image_tree["img"], mode)
    kw = dict(label=label, emb_type=emb_type, emb_train="emb.pt")
    ours = load_dataset_multimodal(*args, **kw)
    ref = jax_load_dataset_multimodal(*args, **kw)
    _assert_same_splits(ours, ref)
    # training batches carry the embedding, valid and test are image-only
    assert [len(d.get_batch([0])) for d in ours] == [3, 2, 2]


def test_multitask_context_dataset_checks_row_alignment(image_tree):
    df = pd.DataFrame({"image": ["a.jpg", "b.jpg"], "style": [0, 1],
                       "genre": [1, 0]})
    with pytest.raises(ValueError, match="rows"):
        datasets.MultiModalArtgraphMultiTask(
            image_tree["img"], df, np.zeros((3, EMB), np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_mse_matches_jax(masked):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(6, EMB)).astype(np.float32) * 1.5
    target = rng.normal(size=(6, EMB)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    opt = lambda a, f: None if a is None else f(a)
    ref = jax_mse(jnp.asarray(pred), jnp.asarray(target),
                  opt(mask, jnp.asarray))
    ours = mse(torch.from_numpy(pred), torch.from_numpy(target),
               opt(mask, torch.from_numpy))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
    if masked:    # the mean over the valid rows' elements only
        keep = mask > 0
        np.testing.assert_allclose(
            ours.item(), np.mean((pred[keep] - target[keep]) ** 2),
            rtol=1e-6)


@pytest.fixture()
def tiny(monkeypatch):
    """Both packages' ResNet heads on the (1, 1, 1, 1) trunk at full widths
    (and the JAX export's block list cut to it)."""
    monkeypatch.setattr(jax_heads, "ResNet50",
                        functools.partial(JaxResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(jax_interop, "RESNET_STAGES", STAGES)


# name -> (JAX model, port model, single task)
MODELS = {
    "ContextNetSingleTask": (
        lambda: jax_heads.ContextNetSingleTask(EMB, NC["genre"],
                                               dtype=jnp.float32),
        lambda: heads.ContextNetSingleTask(EMB, NC["genre"],
                                           dtype=torch.float32), True),
    "ContextNetlMultiTask": (
        lambda: jax_heads.ContextNetlMultiTask(EMB, NC, dtype=jnp.float32),
        lambda: heads.ContextNetlMultiTask(EMB, NC, dtype=torch.float32),
        False),
    "MultiModalSingleTask": (
        lambda: jax_heads.MultiModalSingleTask(EMB, NC["style"],
                                               dtype=jnp.float32),
        lambda: heads.MultiModalSingleTask(EMB, NC["style"],
                                           dtype=torch.float32), True),
    "MultiModalMultiTask": (
        lambda: jax_heads.MultiModalMultiTask(EMB, NC, dtype=jnp.float32),
        lambda: heads.MultiModalMultiTask(EMB, NC, dtype=torch.float32),
        False),
}


def _jax_variables(name, images, seed):
    jmodel = MODELS[name][0]()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images))
    return jmodel, seeded_variables(variables, seed)


def _port_model(name, variables):
    model = MODELS[name][1]()
    sd = state_dict_from_flax(name, variables)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model, sd


def _flat(out):
    """(logits, graph_proj) or ([style, genre], graph_proj) -> a flat list."""
    logits, graph_proj = out
    return [*(logits if isinstance(logits, list) else [logits]), graph_proj]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_context_model_forward_and_keys_match_jax(name, tiny, tmp_path):
    images = np.random.default_rng(6).normal(
        size=(3, 64, 64, 3)).astype(np.float32)
    jmodel, variables = _jax_variables(name, images, seed=7)
    ref = jmodel.apply(variables, jnp.asarray(images), train=False)
    model, sd = _port_model(name, variables)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(images))
    assert isinstance(ours, tuple) and len(ours) == 2
    assert isinstance(ours[0], list) == (not MODELS[name][2])
    for o, r in zip(_flat(ours), _flat(ref)):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)

    # the reference's keys: the JAX export's key set and values
    exported = jax_interop.export_model_state(name, variables)
    assert sorted(model.state_dict()) == sorted(exported) == sorted(sd)
    named = name.startswith("MultiModal")
    assert ("resnet.conv1.weight" in sd) == named
    assert ("resnet.0.weight" in sd) == (not named)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)

    # JAX -> port -> JAX
    back = jax_interop.import_model_state(
        name, {k: v.numpy() for k, v in model.state_dict().items()})
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (path, b), (_, r) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(b, np.asarray(r), err_msg=str(path))

    # a reference .pt of the model reloads strict, sized from its heads
    path = tmp_path / f"{name}.pt"
    save_reference_checkpoint(model, str(path))
    loaded = load_reference_checkpoint(name, str(path), "cpu",
                                       dtype=torch.float32)
    assert type(loaded) is type(model)
    got = loaded.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in model.state_dict().items():   # the .pt holds f32 tensors
        assert torch.equal(got[k].to(v.dtype), v), k


def _jax_context_losses(single: bool, encoder_criterion, lamb: float):
    """The JAX CLIs' train_loss and eval_loss
    (artgraph_tpu/cli/train_baseline_context{,_multitask}.py)."""
    if single:
        def class_losses(out, labels, mask):
            return (jax_cross_entropy(out, labels, mask=mask),
                    jax_accuracy(out, labels, mask))
    else:
        class_losses = lambda outs, labels, mask: jax_multi_task_loss(
            None, None, 0.5, 0.5)(outs, (None, labels, mask))

    def train_loss(outputs, batch):
        out, graph_proj = outputs
        _, embeddings, labels, mask = batch
        cls_loss, metrics = class_losses(out, labels, mask)
        encoder_loss = encoder_criterion(graph_proj, embeddings, mask=mask)
        return lamb * cls_loss + (1 - lamb) * encoder_loss, metrics

    def eval_loss(outputs, batch):
        return class_losses(outputs[0], batch[-2], batch[-1])

    return train_loss, eval_loss


def _context_batches(single: bool, B: int = 8):
    rng = np.random.default_rng(8)

    def labels(n):
        if single:
            return rng.integers(0, NC["style"], n).astype(np.int32)
        return np.stack([rng.integers(0, NC["style"], n),
                         rng.integers(0, NC["genre"], n)], 1).astype(np.int32)

    train = []
    for step in range(3):
        mask = np.ones(B, np.float32)
        if step == 1:
            mask[6:] = 0.0                          # a ragged batch
        train.append((rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
                      rng.normal(size=(B, EMB)).astype(np.float32),
                      labels(B), mask))
    mask = np.ones(B, np.float32)
    mask[5:] = 0.0
    evaluation = (rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
                  labels(B), mask)
    return train, evaluation


STEP_CASES = {
    # name -> (encoder criterion JAX / port, lamb)
    "ContextNetlMultiTask": (jax_smooth_l1, smooth_l1, 0.9),
    "MultiModalSingleTask": (jax_mse, mse, 0.6),
}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_context_steps_match_jax_trainer(name, tiny, monkeypatch):
    lr = 0.01
    jcrit, crit, lamb = STEP_CASES[name]
    single = MODELS[name][2]
    nc = NC["style"] if single else NC
    batches, eval_batch = _context_batches(single)
    # the MultiModal heads' fixed dropout 0.2 off on the JAX side
    head = jax_heads._Head
    monkeypatch.setattr(jax_heads, "_Head", lambda n, _p, dtype, name: head(
        n, 0.0, dtype=dtype, name=name))
    train_loss, eval_loss = _jax_context_losses(single, jcrit, lamb)
    with jax.enable_x64(True):
        jt = JaxTrainer(getattr(jax_heads, name)(EMB, nc, dtype=jnp.float64),
                        jax_sgd_momentum(lr),
                        forward_inputs=lambda img, b: (img,),
                        compute_loss=train_loss, eval_compute_loss=eval_loss,
                        transform_type="resnet", seed=1)
        state = jt.init(batches[0])
        v0 = seeded_variables(jt.variables(state), seed=12)
        state = jt.state_from_variables(_f64(v0))
        jms = []
        for batch in batches:
            state, jm = jt.train_epoch(state, [batch])
            jms.append(jm)
        jeval, jcollected = jt.eval_epoch(state, [eval_batch],
                                          collect_outputs=True)
        variables = jax.tree_util.tree_map(np.asarray, jt.variables(state))

    model = getattr(heads, name)(EMB, nc, dtype=torch.float64)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(name, v0).items()},
                          strict=True)
    model.double()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    class_loss = (single_task_loss(None) if single
                  else multi_task_loss(None, None, 0.5, 0.5))
    trainer = Trainer(model, sgd_momentum(lr),
                      compute_loss=joint_loss(class_loss, crit, lamb),
                      eval_compute_loss=logits_loss(class_loss),
                      transform_type="resnet", device="cpu")
    keys = ["loss"] + (["correct"] if single
                       else ["style_correct", "genre_correct"])
    for step, (batch, jm) in enumerate(zip(batches, jms)):
        tm = trainer.train_epoch([batch])
        assert tm["examples"] == jm["examples"] == batch[-1].sum(), step
        for k in keys:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                       err_msg=f"{k} at step {step}")

    # both states in f64 (state_dict_from_flax rounds to f32 by default)
    monkeypatch.setattr(torch_interop, "_f32", lambda a: np.ascontiguousarray(
        np.asarray(a, np.float64)))
    ref = state_dict_from_flax(name, variables)
    sd0 = state_dict_from_flax(name, v0)
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert ours[k].item() == 3, k
            continue
        o = ours[k].numpy()
        assert o.dtype == np.float64, k
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=k)
        if "running" not in k:
            d_ref, d_ours = r - sd0[k], o - sd0[k]
            assert np.any(d_ref), k
            assert np.linalg.norm(d_ours - d_ref) <= \
                1e-4 * np.linalg.norm(d_ref), k

    # an image-only ragged eval batch: the class loss alone, the outputs
    # cut to the valid rows tree-wise
    tev, collected = trainer.eval_epoch([eval_batch], collect_outputs=True)
    for k in keys:
        np.testing.assert_allclose(tev[k], jeval[k], rtol=1e-5, err_msg=k)
    (out, rest), = collected
    (jout, jrest), = jcollected
    assert len(rest) == len(jrest) == 1
    np.testing.assert_array_equal(rest[0], jrest[0])
    assert type(out) is tuple and isinstance(out[0], list) == (not single)
    for o, r in zip(_flat(out), _flat(jout)):
        assert o.shape == np.asarray(r).shape and o.shape[0] == 5
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.fixture()
def cli_env(image_tree, tmp_path, monkeypatch):
    """Tiny trunks, the unit's gate open with its plain twin's calls
    recorded, and the checkpoints in a tmp dir."""
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, **dict(TINY, patch_size=16)))
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    calls = []
    plain = conv_bn.conv1x1_bn_stats_plain
    monkeypatch.setattr(conv_bn, "conv1x1_bn_stats_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    ck = tmp_path / "ckpt"
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(ck))
    return {**image_tree, "ck": ck, "calls": calls,
            "results": tmp_path / "results"}


def _args(env, *extra, batch=10):
    return ["--dataset_path", env["ds"], "--image_path", env["img"],
            "--device", "cpu", "--num_workers", "2", "--batch", str(batch),
            "--results_dir", str(env["results"]), *extra]


def _check_run(env, capsys, out_lines, ckpt, model_name, tasks,
               resnet=True):
    out = capsys.readouterr().out
    for line in out_lines:
        assert line in out, line
    assert out.count("Train loss: ") == out.count("Validation loss: ") == 1
    model = load_reference_checkpoint(model_name, str(env["ck"] / ckpt),
                                      "cpu")
    assert type(model).__name__ == model_name
    n_test = env["counts"]["test"]
    for suffix in tasks:
        table = pd.read_csv(env["results"] / f"results{suffix}.csv",
                            index_col=0)
        assert 0.0 <= table.loc["accuracy", "0"] <= 1.0
        preds = pd.read_csv(env["results"] / f"true_preds{suffix}.csv")
        assert len(preds) == n_test
    # the fused unit's plain twin on the full train batches only: two units
    # a bottleneck, one bottleneck a stage
    full = env["counts"]["train"] // 10
    assert len(env["calls"]) == (2 * len(STAGES) * full if resnet else 0)
    env["calls"].clear()
    shutil.rmtree(env["results"], ignore_errors=True)
    return model


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_train_baseline_multitask_cli_cpu(cli_env, capsys, arch):
    style_acc, genre_acc = train_baseline_multitask.main(
        _args(cli_env, "--architecture", arch))
    model = _check_run(
        cli_env, capsys,
        ["train style accuracy: ", "train genre accuracy ",
         "validation style accuracy: ",
         f"Test style accuracy: {style_acc}; test genre accuracy: "
         f"{genre_acc}"],
        f"{arch}_baseline_single-task_checkpoint.pt",
        {"resnet": "ResnetMultiTask", "vit": "ViTMultiTask"}[arch],
        ["_style", "_genre"], resnet=arch == "resnet")
    assert model.style_classifier[1].out_features == NC["style"]


@pytest.mark.parametrize("net", ["context-net", "multi-modal"])
def test_train_baseline_context_cli_cpu(cli_env, capsys, net):
    acc = train_baseline_context.main(_args(
        cli_env, "--net", net, "--label", "style", "--emb_train", "emb.pt"))
    model = _check_run(
        cli_env, capsys,
        ["Train loss: ", "train accuracy: ", "validation accuracy: ",
         f"Test accuracy: {acc}"],
        f"style_{net}_single-task_checkpoint.pt",
        {"context-net": "ContextNetSingleTask",
         "multi-modal": "MultiModalSingleTask"}[net], [""])
    assert model.encoder.state_dict().keys() == (
        {"weight", "bias"} if net == "context-net"
        else {"0.weight", "0.bias", "2.weight", "2.bias"})


@pytest.mark.parametrize("net", ["context-net", "multi-modal"])
def test_train_baseline_context_multitask_cli_cpu(cli_env, capsys, net):
    style_acc, genre_acc = train_baseline_context_multitask.main(
        _args(cli_env, "--net", net, "--emb_train", "emb.pt"))
    model = _check_run(
        cli_env, capsys,
        ["train style accuracy: ", "validation genre accuracy ",
         f"Test style accuracy: {style_acc}; test genre accuracy: "
         f"{genre_acc}"],
        f"{net}_multi-task_checkpoint.pt",
        {"context-net": "ContextNetlMultiTask",
         "multi-modal": "MultiModalMultiTask"}[net], ["_style", "_genre"])
    assert model.encoder is not None


def test_context_clis_refuse_an_unknown_net(cli_env):
    for main in (train_baseline_context.main,
                 train_baseline_context_multitask.main):
        with pytest.raises(SystemExit):
            main(_args(cli_env, "--net", "sansaro"))
