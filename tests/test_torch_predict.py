"""The port's serving path against the JAX package: weight carry-over,
reference checkpoints, `infer`, and the predict CLI.

  * state_dict_from_flax equals the JAX package's export_model_state, key
    for key and value for value, for the eight models (four ViT, four
    ResNet50);
  * a .pt written by the JAX package's save_reference_checkpoint loads
    strict=True into the port;
  * the port's `infer` (normalize -> model) against the JAX serving step
    (normalize_images then model.apply, the closure of
    artgraph_tpu/cli/predict.py) at full ViT-B/16 width, batch 2, on the same
    weights and images: f32 at rtol 1e-4, atol 1e-4 on the logits (order of
    accumulation only); bf16 at relative L2 error 3e-2 (measured 1.1e-2; the
    two bf16 paths round at different points: flax's unfused Dense rounds
    before its bias add, the fused kernels after it);
  * the port CLI on `--device cpu` writes the JAX CLI's CSV columns in the
    same row order; for each of the four ResNet models its top-k agree
    with the port's `infer` on the same padded batches, whose bf16 logits
    lie within relative L2 3e-2 of the JAX model's (bf16, same weights and
    images; measured 2.1e-3 to 2.5e-3 on two of them);
  * importing the port loads no jax, flax, triton, PIL or pandas.

Weights are seeded numpy values on the JAX models' own parameter trees
(shapes from jax.eval_shape, so no full-width init runs).
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from artgraph_tpu import config
from artgraph_tpu import models as jax_models
from artgraph_tpu.checkpointing import (export_model_state,
                                        save_reference_checkpoint)
from artgraph_tpu.ops.preprocess import normalize_images as jax_normalize
from artgraph_tpu_torch.checkpointing import (load_reference_checkpoint,
                                              resnet_state_from_flax,
                                              state_dict_from_flax)
from artgraph_tpu_torch.cli import predict
from test_torch_resnet import seeded_batch_stats
from test_torch_vit import seeded_params

torch.set_num_threads(2)

EMB = config.EMB_SIZE
NC = config.NUM_CLASSES
# name -> (JAX constructor taking dtype, number of embedding inputs)
MODELS = {
    "ViTSingleTask": (
        lambda dt: jax_models.ViTSingleTask(NC["style"], dtype=dt), 0),
    "ViTMultiTask": (lambda dt: jax_models.ViTMultiTask(NC, dtype=dt), 0),
    "NewMultiModalSingleTaskVit": (
        lambda dt: jax_models.NewMultiModalSingleTaskVit(EMB, NC["genre"],
                                                         dtype=dt), 1),
    "NewMultiModalMultiTaskViT": (
        lambda dt: jax_models.NewMultiModalMultiTaskViT(EMB, NC, dtype=dt), 2),
}
RESNET_MODELS = {
    "ResnetSingleTask": (
        lambda dt: jax_models.ResnetSingleTask(NC["style"], dtype=dt), 0),
    "ResnetMultiTask": (lambda dt: jax_models.ResnetMultiTask(NC, dtype=dt),
                        0),
    "NewMultiModalSingleTask": (
        lambda dt: jax_models.NewMultiModalSingleTask(EMB, NC["genre"],
                                                      dtype=dt), 1),
    "NewMultiModalMultiTask": (
        lambda dt: jax_models.NewMultiModalMultiTask(EMB, NC, dtype=dt), 2),
}
ALL_MODELS = {**MODELS, **RESNET_MODELS}


def _seed(name):
    if name in MODELS:
        return sorted(MODELS).index(name)
    return len(MODELS) + sorted(RESNET_MODELS).index(name)


def _variables(name, seed):
    """Seeded random variables on the JAX model's parameter tree (and its
    BatchNorm statistics)."""
    ctor, n_emb = ALL_MODELS[name]
    args = [jnp.zeros((1, 224, 224, 3), jnp.float32)]
    args += [jnp.zeros((1, EMB), jnp.float32)] * n_emb
    shapes = jax.eval_shape(
        lambda *a: ctor(jnp.bfloat16).init(jax.random.PRNGKey(0), *a,
                                           train=False), *args)
    out = {"params": seeded_params(shapes["params"], seed)}
    if "batch_stats" in shapes:
        out["batch_stats"] = seeded_batch_stats(shapes["batch_stats"],
                                                seed + 1000)
    return out


def _inputs(n_emb, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    embs = [rng.normal(size=(batch, EMB)).astype(np.float32)
            for _ in range(n_emb)]
    return images, embs


@pytest.fixture(scope="module")
def model_variables():
    """name -> seeded variables, built once per name for this module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _variables(name, seed=_seed(name))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def checkpoints(model_variables, tmp_path_factory):
    """name -> (variables, .pt path) for the two models served end to end."""
    out = {}
    for name in ("ViTSingleTask", "NewMultiModalMultiTaskViT"):
        variables = model_variables(name)
        path = str(tmp_path_factory.mktemp("ckpt") / f"{name}.pt")
        save_reference_checkpoint(name, variables, path)
        out[name] = (variables, path)
    return out


@pytest.mark.parametrize("name", sorted(ALL_MODELS))
def test_state_dict_from_flax_matches_export(model_variables, name):
    variables = model_variables(name)
    ours = state_dict_from_flax(name, variables)
    ref = export_model_state(name, variables)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        # f32 tensors and BatchNorm's int64 num_batches_tracked
        assert ours[k].dtype == v.dtype and ours[k].flags.c_contiguous
        assert np.array_equal(ours[k], v), k


@pytest.mark.parametrize("seq", [True, False])
def test_resnet_state_from_flax_matches_resnet_to_torch(model_variables, seq):
    """Index-prefixed (`resnet.4.0.conv1.weight`) and named
    (`resnet.layer1.0.conv1.weight`, the MultiModal models') trunk keys."""
    from artgraph_tpu.checkpointing.torch_interop import resnet_to_torch

    variables = model_variables("ResnetSingleTask")
    args = (variables["params"]["resnet"], variables["batch_stats"]["resnet"],
            "resnet", seq)
    ours, ref = resnet_state_from_flax(*args), resnet_to_torch(*args)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


@pytest.mark.parametrize("name", ["ViTSingleTask",
                                  "NewMultiModalMultiTaskViT"])
def test_reference_checkpoint_loads_strict(checkpoints, name):
    variables, path = checkpoints[name]
    model = load_reference_checkpoint(name, path, "cpu")
    assert not model.training
    expect = state_dict_from_flax(name, variables)
    got = model.state_dict()
    assert sorted(got) == sorted(expect)
    for k, v in expect.items():
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ViTSingleTask",
                                  "NewMultiModalMultiTaskViT"])
def test_infer_matches_jax_serving(checkpoints, name, dtype):
    variables, path = checkpoints[name]
    ctor, n_emb = MODELS[name]
    images, embs = _inputs(n_emb)
    jax_model = ctor(getattr(jnp, dtype))

    @jax.jit
    def jax_infer(variables, images_u8, *embs):
        return jax_model.apply(variables, jax_normalize(images_u8, "vit"),
                               *embs, train=False)

    ref = jax_infer(variables, jnp.asarray(images), *map(jnp.asarray, embs))
    model = load_reference_checkpoint(name, path, "cpu",
                                      dtype=getattr(torch, dtype))
    ours = predict.infer(model, torch.from_numpy(images),
                         *map(torch.from_numpy, embs))
    refs = ref if isinstance(ref, list) else [ref]
    ours = ours if isinstance(ours, list) else [ours]
    assert len(ours) == len(refs)
    for o, r in zip(ours, refs):
        r = np.asarray(r, np.float32)
        assert o.dtype == torch.float32 and o.shape == r.shape
        o = o.numpy()
        if dtype == "float32":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
        else:
            assert np.linalg.norm(o - r) <= 3e-2 * np.linalg.norm(r)


@pytest.fixture()
def image_dir(synthetic_dataset, tmp_path):
    """5 fixture images: --batch 4 forces a padded second batch."""
    d = tmp_path / "imgs"
    d.mkdir()
    src = synthetic_dataset["image_dir"]
    for name in sorted(os.listdir(src))[:5]:
        shutil.copy(os.path.join(src, name), d / name)
    return str(d)


def test_cli_csv_matches_jax_schema(checkpoints, image_dir, tmp_path):
    from artgraph_tpu.data.transforms import decode_resize_uint8

    _, path = checkpoints["ViTSingleTask"]
    out_csv = str(tmp_path / "preds.csv")
    rc = predict.main([
        "--checkpoint", path, "--model", "ViTSingleTask", "--label", "style",
        "--images", image_dir, "--batch", "4", "--top_k", "2",
        "--output", out_csv, "--device", "cpu"])
    assert rc == 0

    files = [os.path.join(image_dir, f) for f in sorted(os.listdir(image_dir))]
    df = pd.read_csv(out_csv)
    assert list(df.columns) == ["image", "style_top2", "style_pred"]
    assert list(df["image"]) == files

    # the same padded batches through infer
    model = load_reference_checkpoint("ViTSingleTask", path, "cpu")
    images = np.zeros((8, 224, 224, 3), np.uint8)
    images[:5] = np.stack([decode_resize_uint8(f) for f in files])
    logits = torch.cat([predict.infer(model, torch.from_numpy(images[s:s + 4]))
                        for s in (0, 4)]).numpy()
    top2 = np.argsort(-logits, axis=1)[:5, :2]
    for i in range(len(files)):
        assert json.loads(df["style_top2"][i]) == top2[i].tolist()
        assert df["style_pred"][i] == top2[i, 0]


def test_cli_argument_errors(checkpoints, image_dir):
    _, path = checkpoints["NewMultiModalMultiTaskViT"]
    with pytest.raises(SystemExit):   # fusion model without embeddings
        predict.main(["--checkpoint", path, "--model",
                      "NewMultiModalMultiTaskViT", "--images", image_dir,
                      "--device", "cpu"])
    with pytest.raises(SystemExit):   # a model the CLI does not know
        predict.main(["--checkpoint", path, "--model", "ResNet101",
                      "--images", image_dir, "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(RESNET_MODELS))
def test_resnet_cli_matches_jax_logits(model_variables, image_dir, tmp_path,
                                       name):
    from artgraph_tpu.data.transforms import decode_resize_uint8

    variables = model_variables(name)
    path = str(tmp_path / f"{name}.pt")
    save_reference_checkpoint(name, variables, path)
    ctor, n_emb = RESNET_MODELS[name]
    files = [os.path.join(image_dir, f) for f in sorted(os.listdir(image_dir))]
    embs = [np.random.default_rng(9 + i).normal(size=(len(files), EMB))
            .astype(np.float32) for i in range(n_emb)]
    emb_args = []
    for flag, e in zip(("--emb_style", "--emb_genre"), embs):
        np.save(tmp_path / f"{flag[2:]}.npy", e)
        emb_args += [flag, str(tmp_path / f"{flag[2:]}.npy")]
    out_csv = str(tmp_path / "preds.csv")
    rc = predict.main([
        "--checkpoint", path, "--model", name, "--label", "style",
        "--images", image_dir, "--batch", "4", "--top_k", "2",
        "--output", out_csv, "--device", "cpu", *emb_args])
    assert rc == 0
    tasks = ["style", "genre"] if predict.MODELS[name][2] else ["style"]
    df = pd.read_csv(out_csv)
    assert list(df.columns) == ["image"] + [f"{t}_{c}" for t in tasks
                                            for c in ("top2", "pred")]
    assert list(df["image"]) == files

    # the CLI's padded batches through the port's infer
    images = np.zeros((8, 224, 224, 3), np.uint8)
    images[:5] = np.stack([decode_resize_uint8(f) for f in files])
    padded = [np.concatenate([e, np.zeros((3, EMB), np.float32)])
              for e in embs]
    model = load_reference_checkpoint(name, path, "cpu")
    outs = [predict.infer(model, torch.from_numpy(images[s:s + 4]),
                          *[torch.from_numpy(e[s:s + 4]) for e in padded],
                          transform_type="resnet") for s in (0, 4)]
    outs = [o if isinstance(o, list) else [o] for o in outs]
    ours = [torch.cat([o[t] for o in outs])[:5].numpy()
            for t in range(len(tasks))]
    for task, logits in zip(tasks, ours):
        top2 = np.argsort(-logits, axis=1)[:, :2]
        for i in range(len(files)):
            assert json.loads(df[f"{task}_top2"][i]) == top2[i].tolist()
            assert df[f"{task}_pred"][i] == top2[i, 0]

    ref = jax.jit(lambda v, x, *e: ctor(jnp.bfloat16).apply(
        v, jax_normalize(x, "resnet"), *e, train=False))(
            variables, jnp.asarray(images[:5]), *map(jnp.asarray, embs))
    refs = ref if isinstance(ref, list) else [ref]
    for o, r in zip(ours, refs):
        r = np.asarray(r, np.float32)
        assert np.linalg.norm(o - r) <= 3e-2 * np.linalg.norm(r)


def test_cli_cuda_without_gpu_raises(checkpoints, image_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, path = checkpoints["ViTSingleTask"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--checkpoint", path, "--model", "ViTSingleTask",
                      "--images", image_dir])


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import artgraph_tpu_torch, artgraph_tpu_torch.ops, "
            "artgraph_tpu_torch.models, artgraph_tpu_torch.checkpointing, "
            "artgraph_tpu_torch.cli.predict\n"
            "bad = [m for m in ('jax', 'flax', 'triton', 'PIL', 'pandas') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
