"""The port's training slice (artgraph_tpu_torch: the block ops' backward,
losses, the Trainer, the data path and cli.train_baseline) against the JAX
package, on the CPU.

  * the plain backward twins (block_attention_bwd_plain,
    block_mlp_bwd_plain) against jax.vjp of the Pallas custom VJPs
    (interpret mode, as the JAX package's own tests run them), on the
    fixtures' inputs and a seeded cotangent: f32 at rtol = atol = 1e-4
    (accumulation order only); bf16 at max|a-b| / mean|a| < 0.2, the JAX
    tests' bf16 gradient bound (tests/test_mlp_kernel.py);
  * the autograd Functions on CPU tensors give exactly the plain backward;
  * one SGD step of a tiny ViTSingleTask (the TINY trunk of
    test_torch_vit.py plus its Dropout(0) -> Linear head) against the JAX
    Trainer with optax.sgd under force_pallas_kernels(), f32: loss and
    correct count at rtol 1e-5, every updated parameter at rtol = atol =
    1e-5 and every update (new - old) at relative L2 1e-4. SGD, not Adam:
    the K third of the qkv bias has an exactly-zero gradient whose noise
    Adam would amplify;
  * adam() against optax.adam over 3 steps of fixed gradients;
  * the masked, class-weighted cross-entropy and the padded loader against
    the JAX ones;
  * the dataset factory and class weights against the JAX ones;
  * cli.train_baseline end to end on --device cpu with the trunk cut to
    TINY widths (patch 16, so 197 tokens), and with --architecture resnet on
    a ResNet50 of stage sizes (1, 1, 1, 1) at full widths, ARTGRAPH_CONVBN=1
    and a ragged last training batch: the fused unit's plain twin runs on
    the full batches only.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from artgraph_tpu.data.factories import (get_class_weights as jax_weights,
                                         load_dataset as jax_load_dataset)
from artgraph_tpu.data.loader import DataLoader as JaxDataLoader
from artgraph_tpu.models.heads import _Head
from artgraph_tpu.models.vit import ViT as JaxViT, force_pallas_kernels
from artgraph_tpu.ops.attention import fused_block_attention as jax_block_attn
from artgraph_tpu.ops.mlp import fused_block_mlp as jax_block_mlp
from artgraph_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from artgraph_tpu.train.losses import cross_entropy as jax_cross_entropy
from artgraph_tpu.train.trainer import (Trainer as JaxTrainer,
                                        accuracy_metrics as jax_accuracy,
                                        adam as jax_adam)
from artgraph_tpu_torch import config
from artgraph_tpu_torch.checkpointing import (load_reference_checkpoint,
                                              state_dict_from_flax)
from artgraph_tpu_torch.cli import train_baseline
from artgraph_tpu_torch.cli._common import single_task_loss
from artgraph_tpu_torch.data.datasets import ArtGraphSingleTask
from artgraph_tpu_torch.data.factories import get_class_weights, load_dataset
from artgraph_tpu_torch.data.loader import DataLoader
from artgraph_tpu_torch.models import ResNet50, ViT, ViTSingleTask, heads
from artgraph_tpu_torch.ops import (block_attention_bwd_plain, conv_bn,
                                    block_mlp_bwd_plain, fused_block_attention,
                                    fused_block_mlp, launches)
from artgraph_tpu_torch.train import (EarlyStopping, Trainer, adam,
                                      cross_entropy)
from test_torch_cuda import block_inputs, torch_args
from test_torch_vit import TINY, seeded_params

torch.set_num_threads(2)

GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NUM_CLASS = 5


def _block_case(kind, N, dtype):
    """(jax fn, plain bwd, port op, extra args, numpy inputs, cotangent)."""
    B, C, H, Hd = 2, 64, 4, 128
    if kind == "attention":
        inputs = block_inputs(B, N, C, ((C, 3 * C), (C, C)), seed=N)
        jfn = lambda *a: jax_block_attn(*a, H)
        plain, op, extra = block_attention_bwd_plain, fused_block_attention, (H,)
    else:
        inputs = block_inputs(B, N, C, ((C, Hd), (Hd, C)), seed=100 + N)
        jfn, plain, op, extra = jax_block_mlp, block_mlp_bwd_plain, \
            fused_block_mlp, ()
    do = np.random.default_rng(7 + N).normal(size=(B, N, C)) \
        .astype(np.float32)
    return jfn, plain, op, extra, inputs, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [17, 197])
@pytest.mark.parametrize("kind", ["attention", "mlp"])
def test_plain_backward_matches_jax_vjp(kind, N, dtype):
    jfn, plain, _, extra, (x, gamma, beta, lin), do = _block_case(kind, N,
                                                                  dtype)
    jdt, tdt = DTYPES[dtype]
    args = (jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta),
            *map(jnp.asarray, lin))
    _, vjp = jax.vjp(jfn, *args)
    ref = vjp(jnp.asarray(do, jdt))
    tx, params = torch_args(x, gamma, beta, lin, tdt)
    ours = plain(tx, *params[:5], torch.from_numpy(do).to(tdt), *extra)
    for name, o, r in zip(GRAD_NAMES, ours, ref):
        assert o.dtype == (tdt if name == "dx" else torch.float32), name
        r = np.asarray(r, np.float32)
        if r.ndim == 2:               # flax [in, out] -> torch [out, in]
            r = r.T
        o = o.to(torch.float32).numpy()
        assert o.shape == r.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            assert np.abs(o - r).max() / np.abs(r).mean() < 0.2, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["attention", "mlp"])
def test_autograd_function_gives_plain_backward(kind, dtype):
    """backward() through the op on CPU tensors == the plain backward called
    directly; parameter grads f32, dx in x's dtype; no kernel launched."""
    _, plain, op, extra, (x, gamma, beta, lin), do = _block_case(kind, 17,
                                                                 dtype)
    tdt = DTYPES[dtype][1]
    tx, params = torch_args(x, gamma, beta, lin, tdt)
    tdo = torch.from_numpy(do).to(tdt)
    ref = plain(tx, *params[:5], tdo, *extra)
    bwd = ("fused_block_attention_bwd", "fused_block_mlp_bwd")
    counts = tuple(launches.COUNTS[k] for k in bwd)
    tx.requires_grad_()
    for p in params:
        p.requires_grad_()
    out = op(tx, *params, *extra)
    out.backward(tdo)
    assert tuple(launches.COUNTS[k] for k in bwd) == counts
    for name, t, r in zip(GRAD_NAMES, (tx, *params), ref):
        assert t.grad.dtype == r.dtype, name
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0, msg=name)


class _TinyJaxSingleTask(fnn.Module):
    """The JAX ViTSingleTask's structure on the TINY trunk: ViT -> _Head."""
    num_class: int

    @fnn.compact
    def __call__(self, img, train: bool = False):
        feat = JaxViT(dtype=jnp.float32, name="vit", **TINY)(img, train=train)
        return _Head(self.num_class, 0.0, dtype=jnp.float32,
                     name="head")(feat, train)


def _jax_loss(outputs, batch):
    labels, mask = batch[-2], batch[-1]
    return (jax_cross_entropy(outputs, labels, mask=mask),
            jax_accuracy(outputs, labels, mask))


def test_one_sgd_step_matches_jax_trainer(monkeypatch):
    lr = 0.5
    rng = np.random.default_rng(3)
    B = 4
    batch = (rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
             rng.integers(0, NUM_CLASS, B).astype(np.int32),
             np.array([1, 1, 1, 0], np.float32))           # a ragged batch
    jt = JaxTrainer(_TinyJaxSingleTask(NUM_CLASS), optax.sgd(lr),
                    forward_inputs=lambda img, b: (img,),
                    compute_loss=_jax_loss, transform_type="vit", seed=1)
    with force_pallas_kernels():
        state = jt.init(batch)
        params0 = seeded_params(state.params, seed=5)
        state = jt.state_from_variables({"params": params0})
        state, jm = jt.train_epoch(state, [batch])

    monkeypatch.setattr(heads, "ViT", functools.partial(ViT, img_size=16,
                                                        **TINY))
    model = ViTSingleTask(NUM_CLASS, dropout=0.0, dtype=torch.float32)
    sd0 = state_dict_from_flax("ViTSingleTask", {"params": params0})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd0.items()},
                          strict=True)
    trainer = Trainer(model, lambda p: torch.optim.SGD(p, lr=lr),
                      compute_loss=single_task_loss(None),
                      transform_type="vit", device="cpu")
    tm = trainer.train_epoch([batch])

    assert tm["examples"] == jm["examples"] == 3.0
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert tm["correct"] == jm["correct"]
    ref = state_dict_from_flax("ViTSingleTask", {"params": state.params})
    ours = model.state_dict()
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        o = ours[k].numpy()
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=k)
        d_ref, d_ours = r - sd0[k], o - sd0[k]
        assert np.linalg.norm(d_ours - d_ref) <= \
            1e-4 * np.linalg.norm(d_ref) + 1e-7, k


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    tx = jax_adam(3e-4)
    jp = jnp.asarray(p0)
    opt_state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = adam(3e-4)([tp])
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(weighted, masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, NUM_CLASS)).astype(np.float32) * 3
    labels = rng.integers(0, NUM_CLASS, 6).astype(np.int32)
    cw = rng.uniform(0.2, 2.0, NUM_CLASS).astype(np.float32) \
        if weighted else None
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    opt = lambda a, f: None if a is None else f(a)
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            opt(cw, jnp.asarray), opt(mask, jnp.asarray))
    ours = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         opt(cw, torch.from_numpy), opt(mask, torch.from_numpy))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)


class _ArrayDataset:
    def __init__(self, n):
        rng = np.random.default_rng(n)
        self.images = rng.integers(0, 256, (n, 2, 2, 3), dtype=np.uint8)
        self.labels = rng.integers(0, 4, n)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(drop_last):
    """Same shuffle order, padding and f32 mask as the JAX loader, over two
    epochs of a 10-row dataset in batches of 4."""
    ds = _ArrayDataset(10)
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, num_workers=2,
              seed=1)
    ours_loader, ref_loader = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
    for _ in range(2):
        ours, ref = list(ours_loader), list(ref_loader)
        assert len(ours) == len(ref) == len(ours_loader)
        for o, r in zip(ours, ref):
            assert len(o) == len(r) == 3
            for a, b in zip(o, r):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    if not drop_last:
        assert ours[-1][-1].tolist() == [1, 1, 0, 0]


def test_datasets_and_class_weights_match_jax(synthetic_dataset):
    args = (synthetic_dataset["dataset_dir"], synthetic_dataset["image_dir"])
    ours = load_dataset(*args, mode="single_task", label="style",
                        transform_type="vit")
    ref = jax_load_dataset(*args, mode="single_task", label="style",
                           transform_type="vit")
    for o, r in zip(ours, ref):
        assert isinstance(o, ArtGraphSingleTask)
        pd.testing.assert_frame_equal(o.dataset, r.dataset)
        idx = np.array([0, 3, 1])
        for a, b in zip(o.get_batch(idx), r.get_batch(idx)):
            assert np.array_equal(a, b)
    np.testing.assert_array_equal(
        get_class_weights(ours[0], 4, "style"),
        jax_weights(ref[0], 4, "style"))
    # the multitask mode (the refusal before the multitask trainers came):
    # [B, 2] labels and each task's class weights, as the JAX package's
    ours = load_dataset(*args, mode="multi_task")
    ref = jax_load_dataset(*args, mode="multi_task")
    for o, r in zip(ours, ref):
        pd.testing.assert_frame_equal(o.dataset, r.dataset)
        for a, b in zip(o.get_batch(np.array([2, 0])),
                        r.get_batch(np.array([2, 0]))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for task, n in (("style", 4), ("genre", 3)):
        np.testing.assert_array_equal(get_class_weights(ours[0], n, task),
                                      jax_weights(ref[0], n, task))
    with pytest.raises(ValueError, match="mode"):
        load_dataset(*args, mode="three_task")


def test_early_stopping_matches_jax():
    saves = {"ours": [], "ref": []}
    ours = EarlyStopping(patience=2, min_delta=0.01,
                         save_fn=lambda s, p: saves["ours"].append(s))
    ref = JaxEarlyStopping(patience=2, min_delta=0.01,
                           save_fn=lambda s, p: saves["ref"].append(s))
    for epoch, loss in enumerate([1.0, 0.995, 0.9, 0.95, 0.91, 0.92]):
        ours(loss, epoch)
        ref(loss, epoch)
        assert (ours.best_loss, ours.wait, ours.stop) == \
            (ref.best_loss, ref.wait, ref.stop)
    assert saves["ours"] == saves["ref"] == [0, 2]


@pytest.fixture()
def tiny_trunk(monkeypatch, tmp_path):
    """ViTSingleTask on a TINY-width trunk with patch 16 (197 tokens at
    224x224), checkpoints under tmp_path."""
    monkeypatch.setattr(heads, "ViT", functools.partial(
        ViT, **dict(TINY, patch_size=16)))
    monkeypatch.setattr(config, "CHECKPOINTS_DIR", str(tmp_path / "ckpt"))
    return tmp_path


def _cli_args(synthetic_dataset, *extra):
    return ["--dataset_path", synthetic_dataset["dataset_dir"],
            "--image_path", synthetic_dataset["image_dir"],
            "--architecture", "vit", "--label", "style", "--batch", "8",
            "--num_workers", "2", *extra]


def test_train_baseline_cli_cpu(synthetic_dataset, tiny_trunk, capsys):
    results = tiny_trunk / "results"
    acc = train_baseline.main(_cli_args(
        synthetic_dataset, "--epochs", "2", "--lr", "1e-3", "--device", "cpu",
        "--results_dir", str(results)))
    out = capsys.readouterr().out
    assert out.count("Train loss: ") == 2
    assert out.count("Validation loss: ") == 2
    assert f"Test accuracy: {acc}" in out
    path = tiny_trunk / "ckpt" / "style_vit_baseline_single-task_checkpoint.pt"
    assert path.exists()
    model = load_reference_checkpoint("ViTSingleTask", str(path), "cpu")
    assert model.vit.head[1].out_features == config.NUM_CLASSES["style"]
    table = pd.read_csv(results / "results.csv", index_col=0)
    assert list(table.index) == ["accuracy", "top-2-accuracy", "macro-f1",
                                 "macro-precision", "macro-recall"]
    assert table.loc["accuracy", "0"] == acc
    for name in ("precisions_recalls", "confusion_matrix", "true_preds"):
        assert (results / f"{name}.csv").exists()


def test_train_baseline_resnet_cli_cpu(synthetic_dataset, tiny_trunk,
                                       monkeypatch, capsys):
    monkeypatch.setattr(heads, "ResNet50", functools.partial(
        ResNet50, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setenv("ARTGRAPH_CONVBN", "1")
    calls = []
    plain = conv_bn.conv1x1_bn_stats_plain
    monkeypatch.setattr(conv_bn, "conv1x1_bn_stats_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    n_train = synthetic_dataset["counts"]["train"]
    batch = 10
    assert n_train % batch
    acc = train_baseline.main(_cli_args(
        synthetic_dataset, "--architecture", "resnet", "--epochs", "1",
        "--batch", str(batch), "--device", "cpu"))
    out = capsys.readouterr().out
    assert out.count("Train loss: ") == 1
    assert out.count("Validation loss: ") == 1
    assert f"Test accuracy: {acc}" in out
    # two units a bottleneck, four bottlenecks, on the full batches only
    assert len(calls) == 2 * 4 * (n_train // batch)
    path = (tiny_trunk / "ckpt" /
            "style_resnet_baseline_single-task_checkpoint.pt")
    model = load_reference_checkpoint("ResnetSingleTask", str(path), "cpu")
    assert model.classifier[1].out_features == config.NUM_CLASSES["style"]
    assert model.resnet[1].num_batches_tracked.item() == -(-n_train // batch)


def test_train_baseline_cli_refuses_what_is_not_ported(synthetic_dataset,
                                                       tiny_trunk):
    # --data_parallel is ported (tests/test_torch_parallel.py); ranks that
    # do not divide --batch 8 are refused before any rank starts
    with pytest.raises(ValueError, match="not divisible"):
        train_baseline.main(_cli_args(synthetic_dataset, "--device", "cpu",
                                      "--data_parallel", "3"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_baseline.main(_cli_args(synthetic_dataset))
