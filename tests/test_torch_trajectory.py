"""Five-step training trajectories of the port's Trainer against the JAX
Trainer, in f64: the port's counterpart of tests/test_train_trajectory.py's
Adam cases (:190-312), with the port in the torch oracle's place.

Both Trainers take the same seeded uint8 batches (the JAX Trainer's with
the port's normalized images beside, below) and run 5 Adam(1e-3) steps (`train_epoch` on one batch a step, so the
epoch's loss is the step's), dropout 0, in f64: the JAX Trainer under
`jax.enable_x64` on a dtype=float64 model, the port's on a dtype=float64
model whose parameters are cast to f64 (the block ops' plain versions and
the trunks keep f64 where production keeps f32). Why f64: in f32 the two
frameworks' summation orders flip ReLU masks and Adam's sign-like update
amplifies them (the JAX file's docstring); in f64 a real semantic mismatch
(Adam's eps, BN momentum or unbiased variance, the CE reduction) still
shows at first order.

The initial weights are the JAX file's: the torch oracles' init under its
seeds (torchvision's ResNet50 init with random BatchNorm running
statistics, timm's ViT), into the JAX Trainer through the JAX package's
`import_model_state`, and from its variables into the port through
`state_dict_from_flax`.

Bounds, the JAX file's own: the per-step losses at rtol 1e-6; every final
parameter and BatchNorm buffer at rtol 1e-5 / atol 5e-6, with its outlier
rule (a few elements per million whose gradient sits at the f64 noise
floor may take a full Adam step either way, each at most 2 * STEPS * LR
off).

The JAX Trainer's model takes the images as the port normalizes them
(its `forward_inputs` reads them from the batch), not as its compiled step
normalizes them: compiled whole by XLA:CPU, the step's f32 normalize
(uint8 * alpha + beta) rounds differently from its eager form and the
port's (an f32 ulp; a contracted multiply-add the likely cause). Through
its own normalize an f64 ResNet50's first loss is 1.99270874641 where the
eager JAX step and the port give 1.99270876361; Adam then flips the
update of the elements whose gradients sit near zero (27 of the stem
conv's 9,408 after one step, each 2 * LR off), and the losses part by
5e-4 at step 2 (ROADMAP §3). Given the same f32 images, the compiled and
eager losses agree to 1e-15.

Models, at that file's sizes but for the ResNet50's depth:
  ResnetSingleTask        ResNet50 at full widths cut to one bottleneck a
                          stage (STAGES, the oracle's first block of each
                          layer), [4, 64, 64, 3], 7 classes
  ViTSingleTask           depth 12 at 96 px (36 patches), batch 2
  NewMultiModalMultiTask  the same cut ResNet50 with two 16-d embeddings,
                          7 style and 5 genre classes, summed CE
The cut: at full depth the file passes in 97 s serially on a 4-core host
(80 s in the tests), past the ~90 s a Tier-1 file may add; at one block
a stage it takes 67 s (51 s in the tests).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import artgraph_tpu.models.heads as jax_heads
import artgraph_tpu.checkpointing.torch_interop as jax_interop
from artgraph_tpu.checkpointing.torch_interop import import_model_state
from artgraph_tpu.models.resnet import ResNet50 as JaxResNet50
from artgraph_tpu.cli._common import multi_task_loss as jax_multi_task_loss
from artgraph_tpu.train.trainer import Trainer as JaxTrainer, adam as jax_adam
from artgraph_tpu_torch.checkpointing import torch_interop
from artgraph_tpu_torch.checkpointing import state_dict_from_flax
from artgraph_tpu_torch.cli._common import multi_task_loss, single_task_loss
from artgraph_tpu_torch.cli.train_new_multimodal_multitask import \
    image_and_embeddings
from artgraph_tpu_torch.models import ResNet50, ViT, heads
from artgraph_tpu_torch.ops import normalize_images
from artgraph_tpu_torch.train import Trainer, adam
from artgraph_tpu_torch.train.trainer import image_only
from test_torch_resnet import STAGES
from test_torch_train import _jax_loss
from _torch_oracles import ResNet50Oracle, ViTOracle, randomize_bn_stats

torch.set_num_threads(2)

LR = 1e-3
STEPS = 5
EMB = 16
VIT_PX = 96


def _images(rng, b, px):
    return rng.integers(0, 256, (b, px, px, 3), dtype=np.uint8)


def _single_batches(seed, b, px, n_class):
    rng = np.random.default_rng(seed)
    return [(_images(rng, b, px),
             rng.integers(0, n_class, b).astype(np.int32),
             np.ones(b, np.float32)) for _ in range(STEPS)]


def _fusion_batches(seed, b=4, px=64):
    rng = np.random.default_rng(seed)
    return [(_images(rng, b, px),
             rng.normal(size=(b, EMB)).astype(np.float32),
             rng.normal(size=(b, EMB)).astype(np.float32),
             np.stack([rng.integers(0, 7, b), rng.integers(0, 5, b)],
                      1).astype(np.int32),
             np.ones(b, np.float32)) for _ in range(STEPS)]


def _np_sd(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _resnet_trunk(bn_seed: int) -> torch.nn.Sequential:
    """The JAX file's init: a torchvision-init ResNet50 with random
    BatchNorm running statistics, in the reference's Sequential(*children
    [:-1]) layout (`resnet.0` ... `resnet.7`), cut to the first block of
    each stage (STAGES)."""
    o = ResNet50Oracle()
    randomize_bn_stats(o, seed=bn_seed)
    return torch.nn.Sequential(o.conv1, o.bn1, o.relu, o.maxpool,
                               o.layer1[:1], o.layer2[:1], o.layer3[:1],
                               o.layer4[:1], o.avgpool)


def _head(n_in: int, n_out: int) -> torch.nn.Sequential:
    return torch.nn.Sequential(torch.nn.Dropout(0.0),
                               torch.nn.Linear(n_in, n_out))


def _resnet_init() -> dict:
    torch.manual_seed(0)
    return _np_sd(torch.nn.ModuleDict({"resnet": _resnet_trunk(3),
                                       "classifier": _head(2048, 7)}))


def _vit_init() -> dict:
    torch.manual_seed(1)
    vit = ViTOracle(depth=12, img=VIT_PX)
    vit.head = _head(768, 7)
    return _np_sd(torch.nn.ModuleDict({"vit": vit}))


def _fusion_init() -> dict:
    torch.manual_seed(2)
    return _np_sd(torch.nn.ModuleDict({
        "resnet": _resnet_trunk(5), "class_style": _head(2048 + EMB, 7),
        "class_genre": _head(2048 + EMB, 5)}))


CASES = {
    # name -> (JAX model, port model, transform, the port's forward_inputs,
    # losses (JAX, port), batches, the reference-keyed init)
    "ResnetSingleTask": (
        lambda: jax_heads.ResnetSingleTask(7, 0.0, dtype=jnp.float64),
        lambda: heads.ResnetSingleTask(7, 0.0, dtype=torch.float64),
        "resnet", None, (_jax_loss, single_task_loss(None)),
        lambda: _single_batches(0, 4, 64, 7), _resnet_init),
    "ViTSingleTask": (
        lambda: jax_heads.ViTSingleTask(7, 0.0, dtype=jnp.float64),
        lambda: heads.ViTSingleTask(7, 0.0, dtype=torch.float64),
        "vit", None, (_jax_loss, single_task_loss(None)),
        lambda: _single_batches(1, 2, VIT_PX, 7), _vit_init),
    "NewMultiModalMultiTask": (
        lambda: jax_heads.NewMultiModalMultiTask(
            EMB, {"style": 7, "genre": 5}, 0.0, dtype=jnp.float64),
        lambda: heads.NewMultiModalMultiTask(
            EMB, {"style": 7, "genre": 5}, 0.0, dtype=torch.float64),
        "resnet", image_and_embeddings,
        (jax_multi_task_loss(None, None, 1.0, 1.0),
         multi_task_loss(None, None, 1.0, 1.0)),
        lambda: _fusion_batches(2), _fusion_init),
}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def _compare_state(ref: dict, ours: dict, rtol=1e-5, atol=5e-6):
    """tests/test_train_trajectory.py:_compare_state: every tensor within
    rtol / atol but for at most max(8, 5e-6 * size) elements, each within
    the largest drift Adam can make, 2 * STEPS * LR."""
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(ours[k]) == STEPS, k
            continue
        o = ours[k].numpy()
        assert o.dtype == np.float64, k
        diff = np.abs(o - r)
        bad = diff > atol + rtol * np.abs(r)
        n_bad = int(bad.sum())
        assert n_bad <= max(8, int(5e-6 * r.size)), (
            f"{k}: {n_bad}/{r.size} elements beyond rtol={rtol}/atol={atol} "
            f"(max diff {diff.max():.3e})")
        if n_bad:
            assert float(diff[bad].max()) <= 2 * STEPS * LR, k


@pytest.mark.parametrize("name", sorted(CASES))
def test_five_adam_steps_in_f64_match_jax_trainer(name, monkeypatch):
    jctor, ctor, transform, fwd, (jloss, loss), make_batches, init = \
        CASES[name]
    # the ViT at 96 px: the port's position embedding is sized at build
    # time, the JAX one from the input
    monkeypatch.setattr(heads, "ViT", functools.partial(ViT,
                                                        img_size=VIT_PX))
    # the ResNet50s cut to one block a stage, at full widths
    monkeypatch.setattr(jax_heads, "ResNet50",
                        functools.partial(JaxResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(heads, "ResNet50",
                        functools.partial(ResNet50, stage_sizes=STAGES))
    monkeypatch.setattr(jax_interop, "RESNET_STAGES", STAGES)
    batches = make_batches()
    pfwd = fwd or image_only
    # the JAX Trainer's model takes the images as the port normalizes them
    # (module docstring): batches (uint8, normalized f32, the rest)
    jbatches = [(b[0], normalize_images(torch.from_numpy(b[0]),
                                        transform).numpy(), *b[1:])
                for b in batches]
    with jax.enable_x64(True):
        jt = JaxTrainer(jctor(), jax_adam(LR), compute_loss=jloss,
                        forward_inputs=lambda img, b: (b[1], *b[2:-2]),
                        transform_type=transform, seed=1)
        v0 = import_model_state(name, init())
        state = jt.state_from_variables(_f64(v0))
        j_losses = []
        for batch in jbatches:
            state, jm = jt.train_epoch(state, [batch])
            j_losses.append(jm["loss"])
        final = jax.tree_util.tree_map(np.asarray, jt.variables(state))

    model = ctor()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(name, v0).items()},
                          strict=True)
    model.double()
    trainer = Trainer(model, adam(LR), compute_loss=loss,
                      transform_type=transform, device="cpu",
                      forward_inputs=pfwd)
    losses = [trainer.train_epoch([batch])["loss"] for batch in batches]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-6)
    assert losses[-1] != losses[0]

    # the JAX state in f64 (state_dict_from_flax rounds to f32 by default)
    monkeypatch.setattr(torch_interop, "_f32", lambda a: np.ascontiguousarray(
        np.asarray(a, np.float64)))
    _compare_state(state_dict_from_flax(name, final), model.state_dict())
