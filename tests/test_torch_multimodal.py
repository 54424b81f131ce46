"""The port's fusion-pipeline pieces (artgraph_tpu_torch: the fusion and
projector datasets, the projector split, smooth_l1 and the multi-task loss,
the projector and fusion models, the Trainer with forward_inputs) against
the JAX package, on the CPU.

  * each new dataset's get_batch and __getitem__, in every
    embedding-indexing mode, and nested Subsets, bit-exact;
  * load_dataset_projection's train / valid / test index lists against the
    JAX package's (scikit-learn's train_test_split) at n = 7, 24 and 101;
  * smooth_l1 (masked and unmasked, two betas) and multi_task_loss (with
    and without class weights) at rtol 1e-6;
  * LabelProjector, LabelProjectorVit, NewMultiModalMultiTaskViT and
    NewMultiModalSingleTask on tiny trunks (the TINY ViT of
    test_torch_vit.py, ResNet50 of stage sizes (1, 1, 1, 1) at full
    widths), weights carried over by state_dict_from_flax: the f32 eval
    forward at rtol = atol = 1e-5;
  * three SGD steps of NewMultiModalMultiTaskViT through the port's Trainer
    (forward_inputs = image and both embeddings) against the JAX Trainer
    under force_pallas_kernels(), dropout 0, the second batch ragged: loss
    and both correct counts each step at rtol 1e-5, every parameter after
    step 3 at rtol = atol = 1e-5 and its update at relative L2 1e-4. SGD,
    not Adam: the K third of the qkv bias has an exactly-zero gradient;
  * one SGD step of the ResNet LabelProjector with smooth_l1: loss at rtol
    1e-5, running statistics at rtol = atol = 1e-4, each parameter's update
    at relative L2 2e-2 (the f32 gradient of this trunk is ill-conditioned:
    tests/test_torch_resnet.py).
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import artgraph_tpu.models.heads as jax_heads
from artgraph_tpu import config as jax_config
from artgraph_tpu.cli._common import multi_task_loss as jax_multi_task_loss
from artgraph_tpu.data import datasets as jax_datasets
from artgraph_tpu.data.factories import \
    load_dataset_projection as jax_load_dataset_projection
from artgraph_tpu.data.manifest import prepare_raw_dataset as jax_manifest
from artgraph_tpu.models.resnet import ResNet50 as JaxResNet50
from artgraph_tpu.models.vit import ViT as JaxViT, force_pallas_kernels
from artgraph_tpu.train.losses import smooth_l1 as jax_smooth_l1
from artgraph_tpu.train.trainer import Trainer as JaxTrainer
from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import state_dict_from_flax
from artgraph_tpu_torch.cli._common import multi_task_loss
from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
    image_and_embeddings
from artgraph_tpu_torch.cli.train_projector import projection_loss
from artgraph_tpu_torch.data import datasets
from artgraph_tpu_torch.data.embeddings import save_embedding
from artgraph_tpu_torch.data.factories import load_dataset_projection
from artgraph_tpu_torch.data.manifest import prepare_raw_dataset
from artgraph_tpu_torch.models import ResNet50, ViT, heads
from artgraph_tpu_torch.train import Trainer, smooth_l1
from test_torch_resnet import STAGES, seeded_variables
from test_torch_vit import TINY, seeded_params

torch.set_num_threads(2)

EMB = config.EMB_SIZE
NC = config.NUM_CLASSES


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


def _dataset_pairs(synthetic_dataset):
    """(name, port dataset, JAX dataset) for every indexing mode."""
    ds, img = synthetic_dataset["dataset_dir"], synthetic_dataset["image_dir"]
    rng = np.random.default_rng(0)
    table = rng.normal(size=(24, EMB)).astype(np.float32)
    table2 = rng.normal(size=(24, EMB)).astype(np.float32)
    pairs = []
    for split in ("train", "validation"):
        ours_df = prepare_raw_dataset(ds, split)
        ref_df = jax_manifest(ds, split)
        for emb_type in ("artwork", "style"):
            pairs.append((
                f"single-{split}-{emb_type}",
                datasets.MultiModalArtgraphSingleTask(
                    img, ours_df[["image", "style"]], table, split, emb_type),
                jax_datasets.MultiModalArtgraphSingleTask(
                    img, ref_df[["image", "style"]], table, split, emb_type)))
        cols = ["image", "style", "genre"]
        for emb_type in ("artwork", "genre"):
            kind = "train" if split == "train" else "valid"
            pairs.append((
                f"multi-{kind}-{emb_type}",
                datasets.NewMultiModalArtgraphMultiTask(
                    img, ours_df[cols], table, table2, kind, emb_type),
                jax_datasets.NewMultiModalArtgraphMultiTask(
                    img, ref_df[cols], table, table2, kind, emb_type)))
    df, rdf = (prepare_raw_dataset(ds, "train")[["image", "style", "genre"]],
               jax_manifest(ds, "train")[["image", "style", "genre"]])
    for emb_type in ("artwork", "style"):
        ours = datasets.LabelProjectionDataset(img, df, table, emb_type)
        ref = jax_datasets.LabelProjectionDataset(img, rdf, table, emb_type)
        pairs.append((f"projection-{emb_type}", ours, ref))
        outer = [5, 0, 17, 3, 11, 2, 20]
        pairs.append((
            f"subset-of-subset-{emb_type}",
            datasets.Subset(datasets.Subset(ours, outer), [4, 1, 6]),
            jax_datasets.Subset(jax_datasets.Subset(ref, outer), [4, 1, 6])))
    return pairs


def test_datasets_match_jax(synthetic_dataset):
    pairs = _dataset_pairs(synthetic_dataset)
    assert len(pairs) == 12
    for name, ours, ref in pairs:
        assert len(ours) == len(ref), name
        idx = np.array([2, 0, 1]) if len(ours) < 8 else np.array([7, 0, 3, 6])
        _assert_same(ours.get_batch(idx), ref.get_batch(idx))
        for i in idx[:2]:
            _assert_same(ours[int(i)], ref[int(i)])


@pytest.mark.parametrize("n", [7, 24, 101])
def test_projection_split_matches_sklearn(n, tmp_path, monkeypatch):
    split = tmp_path / "dataset" / "train"
    (split / "mapping").mkdir(parents=True)
    labels = split / "raw" / "node-label" / "artwork"
    labels.mkdir(parents=True)
    pd.DataFrame({"idx": range(n), "image": [f"{i}.jpg" for i in range(n)]}
                 ).to_csv(split / "mapping" / "artwork_entidx2name.csv",
                          header=False, index=False)
    for label in ("style", "genre"):
        pd.Series(np.arange(n) % 3).to_csv(
            labels / f"node-label-{label}.csv", header=False, index=False)
    emb_dir = tmp_path / "emb"
    save_embedding(str(emb_dir / "e.pt"),
                   np.arange(n * 2, dtype=np.float32).reshape(n, 2))
    monkeypatch.setattr(config, "EMBEDDINGS_DIR", str(emb_dir))
    monkeypatch.setattr(jax_config, "EMBEDDINGS_DIR", str(emb_dir))
    args = (str(tmp_path / "dataset"), str(tmp_path), "e.pt", "artwork")
    ours, ref = load_dataset_projection(*args), \
        jax_load_dataset_projection(*args)

    def flat(subset):   # indices into the full train set
        idx = np.asarray(subset.indices)
        while isinstance(subset.dataset, (datasets.Subset,
                                          jax_datasets.Subset)):
            subset = subset.dataset
            idx = np.asarray(subset.indices)[idx]
        return idx.tolist()

    assert [flat(s) for s in ours] == [flat(s) for s in ref]
    assert [len(s) for s in ours] == [len(s) for s in ref]
    # valid and test nest in the held-out fifth, as in the reference
    assert ours[1].dataset is ours[2].dataset
    assert sorted(sum((flat(s) for s in ours), [])) == list(range(n))


@pytest.mark.parametrize("beta", [1.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_smooth_l1_matches_jax(masked, beta):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(6, EMB)).astype(np.float32) * 1.5
    target = rng.normal(size=(6, EMB)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    opt = lambda a, f: None if a is None else f(a)
    ref = jax_smooth_l1(jnp.asarray(pred), jnp.asarray(target),
                        opt(mask, jnp.asarray), beta)
    ours = smooth_l1(torch.from_numpy(pred), torch.from_numpy(target),
                     opt(mask, torch.from_numpy), beta)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_task_loss_matches_jax(weighted):
    rng = np.random.default_rng(3)
    B = 6
    outputs = [rng.normal(size=(B, NC[t])).astype(np.float32) * 3
               for t in ("style", "genre")]
    labels = np.stack([rng.integers(0, NC["style"], B),
                       rng.integers(0, NC["genre"], B)], 1).astype(np.int32)
    labels[0] = outputs[0][0].argmax(), outputs[1][0].argmax()
    mask = np.array([1, 1, 1, 1, 0, 1], np.float32)
    cw = [rng.uniform(0.2, 2.0, NC[t]).astype(np.float32)
          for t in ("style", "genre")] if weighted else [None, None]
    ref_loss, ref_m = jax_multi_task_loss(*cw, 0.5, 0.5)(
        [jnp.asarray(o) for o in outputs],
        (None, jnp.asarray(labels), jnp.asarray(mask)))
    loss, m = multi_task_loss(*cw, 0.5, 0.5)(
        [torch.from_numpy(o) for o in outputs],
        (None, torch.from_numpy(labels), torch.from_numpy(mask)))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    assert sorted(m) == sorted(ref_m) == ["genre_correct", "style_correct"]
    for k in m:
        assert m[k].item() == float(ref_m[k]) >= 1.0, k


@pytest.fixture()
def tiny(monkeypatch):
    """Both packages' heads on tiny trunks: the TINY ViT (16x16 images) and
    ResNet50 of stage sizes (1, 1, 1, 1) at full widths."""
    monkeypatch.setattr(jax_heads, "ViT", functools.partial(JaxViT, **TINY))
    monkeypatch.setattr(jax_heads, "ResNet50",
                        functools.partial(JaxResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(heads, "ViT", functools.partial(ViT, img_size=16,
                                                        **TINY))
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))


# name -> (JAX model, port model, image side, number of embedding inputs)
MODELS = {
    "LabelProjector": (
        lambda: jax_heads.LabelProjector(EMB, dtype=jnp.float32),
        lambda: heads.LabelProjector(EMB, dtype=torch.float32), 64, 0),
    "LabelProjectorVit": (
        lambda: jax_heads.LabelProjectorVit(EMB, dtype=jnp.float32),
        lambda: heads.LabelProjectorVit(EMB, dtype=torch.float32), 16, 0),
    "NewMultiModalMultiTaskViT": (
        lambda: jax_heads.NewMultiModalMultiTaskViT(EMB, NC, 0.0,
                                                    dtype=jnp.float32),
        lambda: heads.NewMultiModalMultiTaskViT(EMB, NC, 0.0,
                                                dtype=torch.float32), 16, 2),
    "NewMultiModalSingleTask": (
        lambda: jax_heads.NewMultiModalSingleTask(EMB, NC["genre"], 0.0,
                                                  dtype=jnp.float32),
        lambda: heads.NewMultiModalSingleTask(EMB, NC["genre"], 0.0,
                                              dtype=torch.float32), 64, 1),
}


def _init_jax(model, inputs, seed):
    import jax

    variables = model.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    if "batch_stats" in variables:
        return seeded_variables(variables, seed)
    return {"params": seeded_params(variables["params"], seed)}


def _port_model(ctor, name, variables):
    model = ctor()
    sd = state_dict_from_flax(name, variables)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model, sd


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_matches_jax(name, tiny):
    jctor, ctor, side, n_emb = MODELS[name]
    rng = np.random.default_rng(6)
    inputs = [rng.normal(size=(3, side, side, 3)).astype(np.float32),
              *[rng.normal(size=(3, EMB)).astype(np.float32)
                for _ in range(n_emb)]]
    jmodel = jctor()
    variables = _init_jax(jmodel, inputs, seed=7)
    ref = jmodel.apply(variables, *map(jnp.asarray, inputs), train=False)
    model, _ = _port_model(ctor, name, variables)
    with torch.no_grad():
        ours = model.eval()(*map(torch.from_numpy, inputs))
    ours, ref = (ours, ref) if isinstance(ours, list) else ([ours], [ref])
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32 and o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _fusion_batches():
    rng = np.random.default_rng(8)
    B = 4
    out = []
    for step in range(3):
        mask = np.ones(B, np.float32)
        if step == 1:
            mask[3] = 0.0                          # a ragged batch
        out.append((
            rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
            rng.normal(size=(B, EMB)).astype(np.float32),
            rng.normal(size=(B, EMB)).astype(np.float32),
            np.stack([rng.integers(0, NC["style"], B),
                      rng.integers(0, NC["genre"], B)], 1).astype(np.int32),
            mask))
    return out


def test_three_sgd_steps_of_the_fusion_vit_match_jax_trainer(tiny):
    lr = 0.1
    name = "NewMultiModalMultiTaskViT"
    jctor, ctor, _, _ = MODELS[name]
    batches = _fusion_batches()
    jt = JaxTrainer(jctor(), optax.sgd(lr),
                    forward_inputs=lambda img, b: (img, b[1], b[2]),
                    compute_loss=jax_multi_task_loss(None, None, 0.5, 0.5),
                    transform_type="vit", seed=1)
    jms = []
    with force_pallas_kernels():
        state = jt.init(batches[0])
        params0 = seeded_params(state.params, seed=9)
        state = jt.state_from_variables({"params": params0})
        for batch in batches:
            state, jm = jt.train_epoch(state, [batch])
            jms.append(jm)

    model, sd0 = _port_model(ctor, name, {"params": params0})
    trainer = Trainer(model, lambda p: torch.optim.SGD(p, lr=lr),
                      compute_loss=multi_task_loss(None, None, 0.5, 0.5),
                      transform_type="vit", device="cpu",
                      forward_inputs=image_and_embeddings)
    for step, (batch, jm) in enumerate(zip(batches, jms)):
        tm = trainer.train_epoch([batch])
        assert tm["examples"] == jm["examples"] == batch[-1].sum(), step
        for k in ("loss", "style_correct", "genre_correct"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                       err_msg=f"{k} at step {step}")
    ref = state_dict_from_flax(name, {"params": state.params})
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    moved = 0
    for k, r in ref.items():
        o = ours[k].numpy()
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=k)
        d_ref, d_ours = r - sd0[k], o - sd0[k]
        assert np.linalg.norm(d_ours - d_ref) <= \
            1e-4 * np.linalg.norm(d_ref) + 1e-7, k
        moved += bool(np.any(d_ref))
    # everything but timm's unused head (and the exactly-zero K bias third,
    # inside qkv.bias) moved
    assert moved == len(ref) - 2


def test_one_sgd_step_of_the_resnet_projector_matches_jax_trainer(tiny):
    lr = 0.01
    name = "LabelProjector"
    jctor, ctor, _, _ = MODELS[name]
    rng = np.random.default_rng(10)
    B = 8
    batch = (rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
             rng.normal(size=(B, EMB)).astype(np.float32),
             np.ones(B, np.float32))
    jt = JaxTrainer(jctor(), optax.sgd(lr),
                    forward_inputs=lambda img, b: (img,),
                    compute_loss=lambda out, b: (
                        jax_smooth_l1(out, b[1], mask=b[-1]), {}),
                    transform_type="resnet", seed=1)
    state = jt.init(batch)
    v0 = seeded_variables(jt.variables(state), seed=12)
    state = jt.state_from_variables(v0)
    state, jm = jt.train_epoch(state, [batch])

    model, sd0 = _port_model(ctor, name, v0)
    trainer = Trainer(model, lambda p: torch.optim.SGD(p, lr=lr),
                      compute_loss=projection_loss, transform_type="resnet",
                      device="cpu")
    tm = trainer.train_epoch([batch])
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    ref = state_dict_from_flax(name, jt.variables(state))
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert ours[k].item() == 1, k
            continue
        o = ours[k].numpy()
        if "running" in k:
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=k)
            continue
        d_ref, d_ours = r - sd0[k], o - sd0[k]
        assert np.linalg.norm(d_ours - d_ref) <= \
            2e-2 * np.linalg.norm(d_ref) + 1e-7, k
